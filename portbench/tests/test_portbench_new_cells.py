"""The GTrXL cell and the four-rank cell at a size the CPU holds: their
entries and references agree on a float32 net (the GTrXL core cut to 2
layers of 32 over a memory of 8, shorter than the 20-step segment); a
program that keeps the memory across an episode's end, or replays its
segments one slot off, comes out not correct; the four ranks run as gloo
processes under a deadline.  And the GTrXL reference's imports, and the
core's counts on a hand-worked shape."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, small_context
from portbench.harness import common
from portbench.harness import gtrxl as HG

SMALL = dict(layers=2, d_model=32, heads=2, head_dim=16, mlp=64, memory=8)


def _small_gtrxl(**traffic):
    ctx = small_context("gtrxl-train-append-still-2048", **traffic)
    cfg = ctx.config = copy.deepcopy(ctx.config)
    cfg["trunk_dtype"] = "float32"
    cfg["core"].update(SMALL)
    for layer in cfg["layers"]:
        if layer["name"] == "embed":
            layer["out"] = SMALL["d_model"]
        elif layer["name"] in ("policy", "value"):
            layer["in"] = SMALL["d_model"]
    return ctx


def _run(ctx):
    common.load_module(f"portbench/entries/{ctx.traffic['entry']}.py").run(
        ctx)
    return dict((n, v) for n, v, _ in ctx.checks)


def test_gtrxl_cell_replays_with_resets():
    """Episodes of 7 steps end inside every segment; a report every
    batch, as at the cell's size, brings the memory's fill back."""
    ctx = _small_gtrxl(time_limit=7, report_every=1)
    got = _run(ctx)
    assert ctx.correct and got["env_mismatches"] == 0, got
    assert set(got) >= {"grad_gap", "logit_gap", "replay_gap"}
    assert max(got.values()) < 1e-4, got
    assert ctx.e2e["train_env_steps_per_s"] > 0
    assert 0 < ctx.raw["memory_fill_pct"] <= 100


def test_gtrxl_memory_kept_across_an_episode_end(monkeypatch):
    from safelife_torch.training import gtrxl
    real = gtrxl.GTrXL.reset_carry

    def keep(self, carry, done):
        real(self, carry, torch.zeros_like(done))
        return carry
    monkeypatch.setattr(gtrxl.GTrXL, "reset_carry", keep)
    ctx = _small_gtrxl(time_limit=7)
    got = _run(ctx)
    assert not ctx.correct and got["logit_gap"] > 0.05, got


def test_gtrxl_segment_replayed_one_slot_off(monkeypatch):
    from safelife_torch.training import gtrxl
    real = gtrxl.GTrXL.segment

    def off(self, x, done, carry0):
        *rings, length, head = carry0
        return real(self, x, done, (*rings, length, head + 1))
    monkeypatch.setattr(gtrxl.GTrXL, "segment", off)
    ctx = _small_gtrxl()
    got = _run(ctx)
    assert not ctx.correct and got["replay_gap"] > 0.05, got


DP4 = r'''
import copy, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench/tests"]
from conftest import small_context
from portbench.harness import common
ctx = small_context("cnn-train-append-still-dp4")
ctx.config = copy.deepcopy(ctx.config)
ctx.config["trunk_dtype"] = "float32"
entry = common.load_module("portbench/entries/train_dp4.py")
entry.DEADLINE_S = 240
entry.run(ctx)
print(json.dumps(dict(correct=ctx.correct, count=ctx.device["count"],
                      rate=ctx.e2e["train_env_steps_per_s"],
                      checks={n: v for n, v, _ in ctx.checks})))
'''


def test_dp4_cell_on_four_gloo_ranks():
    """Four ranks of 8 environments, gloo on the CPU, in a process of
    their own (a rank that fails, or the deadline of four minutes past the
    window, ends that process); the reference replays the four shards."""
    out = subprocess.run([sys.executable, "-c", DP4, ROOT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    checks = got["checks"]
    assert got["correct"] and checks["env_mismatches"] == 0, got
    assert checks["loss_gap"] < 1e-4 and checks["grad_gap"] < 1e-3, got
    assert got["count"] == 4 and got["rate"] > 0


DP4_FAULTS = r'''
import copy, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench/tests"]
from conftest import small_context
from portbench import control_more
from portbench.entries import train_dp4
ctx = small_context("cnn-train-append-still-dp4")
ctx.config = copy.deepcopy(ctx.config)
ctx.config["trunk_dtype"] = "float32"
train_dp4.DEADLINE_S = 240
out = control_more.dp4_readings(ctx, True)
print(json.dumps({k: {n: v for n, v in r.items() if not n.endswith("leaves")}
                  for k, r in out.items()}))
'''


def test_dp4_faults_fail_the_cells_limits():
    """The four gloo ranks' check batches against the reference, and the
    reference with the gradient exchange left out (rank 0's shard alone
    makes each step) or half the batch in the program's place: the sound
    run meets every limit of the cell, each fault fails one."""
    out = subprocess.run([sys.executable, "-c", DP4_FAULTS, ROOT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    limits = common.load_json(
        "portbench/limits/cnn-train-append-still-dp4.json")

    def fails(readings):
        return [n for n, lim in limits.items() if not readings[n] <= lim]
    assert fails(got["program"]) == [], got["program"]
    for fault in ("no_exchange", "half_batch"):
        assert fails(got[fault]), (fault, got[fault])


def test_the_new_references_load_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.reference import gtrxl, follow, sharded\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {\n"
            "    'safelife_torch', 'jax', 'jaxlib', 'flax', 'safelife_tpu'})\n"
            "print(bad)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _hand_config():
    cfg = copy.deepcopy(common.load_json(
        "portbench/configs/safelife-gtrxl.json"))
    cfg["core"].update(layers=1, d_model=4, heads=1, head_dim=2, mlp=8,
                       memory=3)
    cfg["ppo"].update(steps_per_env=2, epochs_per_batch=3)
    return cfg


def test_core_counts_on_a_hand_worked_shape():
    """d 4, one head of 2, MLP 8, memory 3, one layer, 2 envs, 2 steps.
    A query: q 4x2 and output 2x4 projections, two gates of 3 + 2 + 1
    products of 4x4, the MLP 4x8 and 8x4, and 3 products of 2 against
    each of its 4 keys: 16 + 192 + 64 + 24 = 296 multiply-adds.  A key: k
    and v, 4x2 each: 16.  The core's parameters: u, v 2 + 2, two layer
    norms 16, q, k, v, r, o 8 + 16 + 8 + 8, the MLP 32 + 8 + 32 + 4, two
    gates 4 + 48 + 32 + 16 each: 336."""
    cfg = _hand_config()
    assert HG.query_flops(cfg) == 2 * 296
    assert HG.key_flops(cfg) == 2 * 16
    flops, nbytes = HG.rollout_step(cfg, 2)
    assert flops == 2 * (592 + 32)
    assert nbytes == 2 * (2 * 3 * 4 + 336)
    assert HG.update_forward(cfg, 2, 2) == 2 * (2 * 592 + 5 * 32)
    assert HG.update_backward(cfg, 2, 2) == 2 * (4 * 592 + 7 * 32)
    least = 3 * max(1248 / 989e12, 720 / 3.35e12) + 3 * 2688 / 989e12
    assert abs(HG.core_least_seconds(cfg, 2) - least) < 1e-20


def test_the_core_readers():
    roof = common.load_module("portbench/metrics/core_roofline_pct.train.py")
    core = common.load_module("portbench/metrics/core_ms.train.py")
    fill = common.load_module("portbench/metrics/memory_fill_pct.train.py")
    ar = common.load_module("portbench/metrics/allreduce_ms.train.py")
    ops = [("gemm", 0, 3000, "portbench.gtrxl_core", "kernel"),
           ("sdpa", 5000, 6000, "portbench.gtrxl_core", "kernel"),
           ("nccl", 7000, 9000, "portbench.allreduce", "kernel"),
           ("step", 9000, 9500, "portbench.env_step", "kernel")]
    raw = {"kind": "train", "core_least_seconds": 1e-6,
           "memory_fill_pct": 42.0,
           "profile": {"device": ops, "units": 2, "window": (0, 10000),
                       "spans": []}}
    assert core.read(raw) == pytest.approx(2e-3)
    assert roof.read(raw) == pytest.approx(50.0)
    assert ar.read(raw) == pytest.approx(1e-3)
    assert fill.read(raw) == 42.0
    assert core.read({"kind": "train"}) is None
    assert roof.read(dict(raw, core_least_seconds=None)) is None
    assert fill.read({"kind": "eval"}) is None
