"""The plain reference against the port's plain path at a tiny size: a few
batches at B = 8 on each training cell's bank and net, a short suite on
the eval cell's.  On a float32 trunk the learner agrees to rounding."""

import copy

import torch

from conftest import small_context
from portbench import control


def _float32(ctx):
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["trunk_dtype"] = "float32"
    return ctx


def test_cnn_training_replays():
    out = control.train_readings(
        _float32(small_context("cnn-train-append-still-4096")), False)
    r = out["program"]
    assert r["env_mismatches"] == 0
    assert r["loss_gap"] < 1e-4 and r["grad_gap"] < 1e-3
    assert r["change_gap"] < 1e-3, r


def test_lstm_training_replays():
    out = control.train_readings(
        _float32(small_context("lstm-train-append-still-4096")), False)
    r = out["program"]
    assert r["env_mismatches"] == 0
    assert r["loss_gap"] < 1e-4 and r["grad_gap"] < 1e-3
    assert r["change_gap"] < 1e-3, r


def test_eval_replays_with_spawns():
    out = control.eval_readings(small_context("cnn-eval-prune-spawn"), True)
    r = out["program"]
    assert r["level_mismatches"] == 0 and r["side_effect_gap"] < 1e-5
    assert r["action_gap"] < 1e-3
    assert out["control"]["level_mismatches"] == 0
