"""Helpers of the benchmark's tests.  Run with
``python -m pytest portbench/tests -q`` from the checkout's root; the tests
marked ``card`` need an NVIDIA card and skip without one."""

import os
import sys
import time
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    """Skips the test where no card is present (decided here, when the
    test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True)
def _threads():
    import torch
    torch.set_num_threads(2)


def small_context(cell, seed=2**31 + 17, place="cpu", envs=8, **traffic):
    """A run's context for ``cell`` at a size the CPU holds: ``envs``
    environments, or an eval's short episodes."""
    from portbench.harness import common
    bench = common.load_bench()
    w = common.find(bench["workloads"], cell, "workload")
    config = common.load_json(common.find(bench["configs"], w["config"],
                                          "config")["file"])
    tr = dict(common.load_json(f"portbench/traffic/{w['traffic']}.json"))
    if tr["entry"] == "eval":
        tr.update(time_limit=30, side_effect_samples=4, warmup_time_limit=8)
    else:
        tr["envs"] = envs
    tr.update(traffic)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.5,
                                 trace=0)
    t0 = time.perf_counter()
    return common.Context(args=args, bench=bench, cell=w, config=config,
                          traffic=tr, place=place,
                          setup_clock=lambda: time.perf_counter() - t0)
