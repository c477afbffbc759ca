"""The PyTorch port imports nothing of JAX or of the JAX package (nor, at
import, the optional imageio, PIL, pyglet or gymnasium, which the card
lacks), and its entry points do not fall back to the CPU when no device
is named."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "safelife_tpu",
          "imageio", "PIL", "pyglet", "gymnasium")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import safelife_torch
names = [m.name for m in pkgutil.walk_packages(
    safelife_torch.__path__, "safelife_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED
                and sys.modules[m] is not None)
assert not loaded, loaded
print(" ".join(names))
"""

# Modules the import check must reach (the level supply, the parallel
# modules, the ports of the JAX round's scripts and the launch tooling
# among them).
REQUIRED = ("safelife_torch.procgen", "safelife_torch.procgen.batched",
            "safelife_torch.procgen.generate", "safelife_torch.procgen.native",
            "safelife_torch.procgen.presets",
            "safelife_torch.levels.device_bank",
            "safelife_torch.training.curricula",
            "safelife_torch.parallel", "safelife_torch.parallel.mesh",
            "safelife_torch.parallel.distributed",
            "safelife_torch.parallel.halo",
            "safelife_torch.utils.profiling",
            "safelife_torch.scripts.microbench",
            "safelife_torch.scripts.validate_sinkhorn",
            "safelife_torch.scripts.cpu_verify_finals",
            "safelife_torch.scripts.eval_backend_diff",
            "safelife_torch.scripts.scaling_report",
            "safelife_torch.scripts.level_archives",
            "safelife_torch.scripts.make_levels",
            "safelife_torch.scripts.make_puzzles",
            "safelife_torch.scripts.make_v01_levels",
            "safelife_torch.scripts.launch",
            "safelife_torch.scripts.remote_job",
            "safelife_torch.scripts.run_tb",
            "safelife_torch.scripts.summarize_runs",
            "safelife_torch.scripts.sweep")


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 66, proc.stdout
    assert set(REQUIRED) <= set(names), set(REQUIRED) - set(names)


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch, tmp_path):
    from safelife_torch.env.env import BatchedSafeLifeEnv
    from safelife_torch.levels import loader
    from safelife_torch.training.driver import (Trainer, TrainerConfig,
                                                load_policy)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_bank("benchmarks/v1.0/append-still")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedSafeLifeEnv()
    assert BatchedSafeLifeEnv(device="cpu").device.type == "cpu"
    cfg = TrainerConfig(num_envs=4, view_shape=(17, 17), record_videos=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_policy(str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    assert next(trainer.net.parameters()).device.type == "cpu"
    from safelife_torch.__main__ import main
    for argv in (["train", str(tmp_path / "run")], ["bench"], ["selftest"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not os.path.exists(tmp_path / "run")


def test_summarize_runs_parses_the_port_eval_line(tmp_path, caplog):
    """``scripts/summarize_runs.py`` needs no port: its ``LINE`` parses the
    ``eval @ N`` line the port's ``Trainer.evaluate`` logs (its side-effect
    field included), as ``parse_log`` reads it from a training log."""
    import importlib.util
    import logging

    import numpy as np

    from safelife_torch.levels import loader, synth
    from safelife_torch.training.driver import Trainer, TrainerConfig
    from safelife_torch.training.ppo import PPOConfig

    spec = importlib.util.spec_from_file_location(
        "summarize_runs", os.path.join(ROOT, "scripts", "summarize_runs.py"))
    summarize_runs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize_runs)

    suite = tmp_path / "small.npz"
    np.savez(suite, levels=np.load(os.path.join(
        loader.PACKAGED_LEVELS, "benchmarks", "v1.0",
        "append-still.npz"))["levels"][:8])
    torch.set_num_threads(1)
    trainer = Trainer(
        TrainerConfig(num_envs=4, view_shape=(17, 17), time_limit=5,
                      record_videos=False, eval_suite=str(suite),
                      eval_side_effect_samples=4),
        PPOConfig(steps_per_env=2, num_minibatches=1, epochs_per_batch=1),
        bank=synth.synth_bank(2, h=13, w=13, device="cpu"), device="cpu")
    with caplog.at_level(logging.INFO, logger="safelife_torch"):
        results = trainer.evaluate()
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("eval @")]
    assert len(lines) == 1, lines
    log = tmp_path / "train.log"
    log.write_text("INFO " + lines[0] + "\n")
    (row,) = summarize_runs.parse_log(str(log))
    assert row["step"] == trainer.global_step()
    assert row["mean_perf"] == round(float(np.mean(results["performance"])), 3)
    assert row["mean_length"] == round(float(np.mean(results["length"])), 1)
    assert row["side_effects"] == round(
        float(np.mean(results["side_effects"])), 3)
    assert summarize_runs.LINE.search(lines[0]).group(2) == "8"
