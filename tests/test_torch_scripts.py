"""The port's measurement entry points (``safelife_torch/scripts``) at a
tiny size on the CPU: every row runs its chained loop through the plain
versions, and ``main()`` refuses to measure without a CUDA device."""

import pytest
import torch

import safelife_torch.scripts as scripts
from safelife_torch.ops import env_step_kernels
from safelife_torch.scripts import (ablock_bench, obs_micro, stepbench,
                                    stress_micro)

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

ENTRY_POINTS = {
    "stepbench": (stepbench, dict(B=64, STEPS=4, ROLLOUT=2), 9),
    "ablock_bench": (ablock_bench, dict(B=64, STEPS=3),
                     len(env_step_kernels.ACTION_BLOCKS)),
    "obs_micro": (obs_micro, dict(B=64, STEPS=3, ROLLOUT=3), 11),
    "stress_micro": (stress_micro, dict(B=64, STEPS=4, ROLLOUT=2), 5),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_cpu(monkeypatch, capsys, name):
    module, sizes, rows = ENTRY_POINTS[name]
    for key, value in sizes.items():
        monkeypatch.setattr(module, key, value)
    monkeypatch.setattr(scripts, "REPEATS", 1)
    got = module.main(device="cpu")
    assert len(got) == rows and all(us > 0 for us in got.values())
    printed = capsys.readouterr().out
    assert all(str(row) in printed for row in got), printed


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_needs_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name][0].main()
