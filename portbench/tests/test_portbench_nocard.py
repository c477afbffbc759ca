"""Without a card, or without the program, a run fails and prints no
result: there is no CPU fallback."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def _run(root, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cnn-train-append-still-4096", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
        text=True, timeout=300, env=env)


def _printed_result(out):
    for line in out.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0 and not _printed_result(out)
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and not _printed_result(out)


def test_measuring_code_raises_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench.harness import common
    ctx = common.Context(args=None, bench={}, cell={}, config={},
                         traffic={}, setup_clock=lambda: 0.0)
    with pytest.raises((RuntimeError, AssertionError)):
        ctx.torch_device()
