"""The port's bench at a tiny size on the CPU: its selftest passes, its
timing loop steps and counts as it should, and its entry point refuses to
measure without a CUDA device."""

import pytest
import torch

from safelife_torch import bench

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def banks():
    return bench.load_banks(torch.device("cpu"))


def test_selftest_passes(banks):
    bench.selftest(banks, batch=32)


@pytest.mark.parametrize("name", bench.CONFIGS)
def test_time_env_steps(banks, name):
    rate, state = bench.time_env(banks[name], batch=16, steps=20, repeats=1)
    assert rate > 0
    assert int(state.num_steps) == 16 * 20
    assert state.board.shape == (26, 26, 16)


def test_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()
