"""The port's device-integrity guard (``safelife_torch/utils/integrity.py``)
on the CPU, mirroring ``tests/test_integrity.py``: the check passes, the
incident's signature and a flipped CA bit-plane raise naming the field,
the kill switch works, the bank reset gather passes, and the fixture's
goldens equal the JAX package's bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from safelife_torch.levels import loader
from safelife_torch.ops import life_kernels, rng
from safelife_torch.utils import integrity
from safelife_tpu.utils import integrity as jintegrity

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _corrupting(monkeypatch, corrupt):
    real = integrity._device_outputs

    def corrupted(*args):
        return corrupt(dict(real(*args)))
    monkeypatch.setattr(integrity, "_device_outputs", corrupted)


def test_integrity_passes_on_the_cpu():
    assert integrity.check_device_integrity(CPU)


def test_integrity_detects_corrupted_scores(monkeypatch):
    """The observed failure: the score chain silently zeroed."""
    def zero_scores(out):
        out["points"] = out["points"] * 0
        out["completed"] = out["completed"] * 0
        return out
    _corrupting(monkeypatch, zero_scores)
    with pytest.raises(integrity.DeviceIntegrityError) as err:
        integrity.check_device_integrity(CPU)
    assert "points" in str(err.value) and "completed" in str(err.value)
    assert "cpu" in str(err.value)
    assert integrity.check_device_integrity(CPU, raise_on_fail=False) is False


def test_integrity_detects_ca_corruption(monkeypatch):
    def flip(out):
        out["adv"] = (out["adv"].to(torch.int32) ^ 1).to(torch.uint16)
        return out
    _corrupting(monkeypatch, flip)
    with pytest.raises(integrity.DeviceIntegrityError, match="adv"):
        integrity.check_device_integrity(CPU)


def test_integrity_kill_switch(monkeypatch):
    monkeypatch.setenv("SAFELIFE_INTEGRITY", "0")
    monkeypatch.setattr(integrity, "_device_outputs",
                        lambda *a: (_ for _ in ()).throw(AssertionError))
    assert integrity.check_device_integrity(CPU)
    assert integrity.check_bank_reset_integrity(None)


def test_bank_reset_integrity(monkeypatch):
    bank = loader.load_bank("benchmarks/v1.0/append-still", device="cpu")
    assert integrity.check_bank_reset_integrity(bank)
    real = type(bank).take

    def lossy(self, idx):
        out = real(self, idx)
        board = (out.board.to(torch.int32) & ~1).to(torch.uint16)
        return dataclasses.replace(out, board=board)
    monkeypatch.setattr(type(bank), "take", lossy)
    with pytest.raises(integrity.DeviceIntegrityError, match="board"):
        integrity.check_bank_reset_integrity(bank)


def test_fixture_goldens_equal_the_jax_guard():
    ours = integrity._build_fixture()
    theirs = jintegrity._build_fixture()
    for k in ("board", "goals", "init_board", "baseline", "gather_src",
              "gather_idx"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert set(theirs["expected"]) < set(ours["expected"])
    for k, want in theirs["expected"].items():
        np.testing.assert_array_equal(ours["expected"][k], want, err_msg=k)


def test_kernel_goldens_on_the_fixture():
    """The goldens that K4 and T1 are held to on the card: K4's plain
    version (the fixture has PRESERVING and INHIBITING cells, no spawner)
    gives the CA golden, and T1's plain version, ``spawn_words`` as int32,
    gives the numpy Philox twin's probe."""
    fx = integrity._build_fixture()
    board = torch.as_tensor(fx["board"])
    np.testing.assert_array_equal(
        life_kernels.advance_spawnless_plain(board).numpy(),
        fx["expected"]["adv"])
    seed = torch.tensor([integrity.PROBE_SEED], dtype=torch.int32)
    words = rng.philox_words(seed, integrity.PROBE_SHAPE)
    np.testing.assert_array_equal(words.numpy(), fx["expected"]["philox"])
    want = rng.spawn_words(seed, integrity.PROBE_SHAPE, CPU)
    assert torch.equal(words.to(torch.int64) & rng.MASK32, want)
    assert int(rng.philox_words(torch.tensor([0], dtype=torch.int32),
                                (1, 1, 1))) & rng.MASK32 == 0x6627E8D5
