"""Training observability: per-episode YAML logs + tensorboard scalars
(port of ``safelife_tpu.metrics.logging``; no torch needed but for the
optional tensorboard writer).

Capability parity with the reference's logging (``env_wrappers.py:195-231``:
YAML episode records appended to ``training.yaml`` plus tensorboard
scalars; ``training/ppo.py:307-324``: training internals), adapted to the
batched world: episode records arrive as (T, B) arrays of pre-reset stats
from the rollout and are flushed to host logs once per report.  The
records are written as text: no YAML library is needed.
"""

import json
import os
import time
from typing import Optional

import numpy as np


class EpisodeLogger:
    """Appends one YAML record per finished episode, reference-style."""

    def __init__(self, logfile: Optional[str] = None, summary_writer=None,
                 tag="episodes"):
        self.logfile = logfile
        self.summary_writer = summary_writer
        self.tag = tag
        self.num_episodes = 0
        self._fh = None
        if logfile:
            os.makedirs(os.path.dirname(os.path.abspath(logfile)),
                        exist_ok=True)
            self._fh = open(logfile, "a")

    def log_batch(self, epstats, global_step=None, level_names=None):
        """epstats: dict of (T, B) host arrays from the PPO rollout."""
        stats = {k: np.asarray(v) for k, v in epstats.items()}
        done = stats["done"]
        idx = np.argwhere(done)
        records = []
        for t, b in idx:
            lvl = int(stats["level_idx"][t, b])
            possible = max(int(stats["perf_possible"][t, b]), 1)
            rec = {
                "name": (level_names[lvl] if level_names else f"level-{lvl}"),
                "length": int(stats["episode_length"][t, b]),
                "reward": round(float(stats["episode_reward"][t, b]), 3),
                "completed": int(stats["perf_completed"][t, b]),
                "possible": int(stats["perf_possible"][t, b]),
                "performance": round(
                    float(stats["perf_completed"][t, b]) / possible, 4),
                "times_up": bool(stats["times_up"][t, b]),
            }
            if "side_effects" in stats:
                rec["side_effects"] = int(stats["side_effects"][t, b])
            records.append(rec)
        self.num_episodes += len(records)
        if self._fh and records:
            for rec in records:
                # YAML flow-style record, one per line (matches the
                # reference's human-greppable training.yaml).
                items = ", ".join(f"{k}: {v}" for k, v in rec.items())
                self._fh.write(f"- {{{items}}}\n")
            self._fh.flush()
        if self.summary_writer and records:
            step = int(global_step) if global_step is not None else \
                self.num_episodes
            mean = lambda k: float(np.mean([r[k] for r in records]))
            self.summary_writer.add_scalar(
                f"{self.tag}/length", mean("length"), step)
            self.summary_writer.add_scalar(
                f"{self.tag}/reward", mean("reward"), step)
            self.summary_writer.add_scalar(
                f"{self.tag}/performance", mean("performance"), step)
            if "side_effects" in records[0]:
                self.summary_writer.add_scalar(
                    f"{self.tag}/side_effects", mean("side_effects"), step)
        return records

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class JsonlSummaryWriter:
    """Minimal tensorboard-API-compatible fallback: JSONL scalar stream."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._fh = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._fh.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._fh.flush()

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


def make_summary_writer(logdir):
    """Real tensorboard writer when available, JSONL fallback otherwise."""
    if logdir is None:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except ImportError:  # no tensorboard installed
        return JsonlSummaryWriter(logdir)


def log_training_metrics(writer, metrics, step, prefix="training"):
    """Flush the scalar training metrics from ``PPO.train_batch``
    (host numbers or arrays)."""
    if writer is None:
        return
    for key, val in metrics.items():
        if key == "episodes":
            continue
        arr = np.asarray(val)
        if arr.ndim == 0:
            writer.add_scalar(f"{prefix}/{key}", float(arr), step)
        elif arr.ndim == 1:  # per-gamma vectors
            for i, v in enumerate(arr):
                writer.add_scalar(f"{prefix}/{key}_g{i}", float(v), step)
