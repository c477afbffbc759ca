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

# Modules the import check must reach (the level supply among them).
REQUIRED = ("safelife_torch.procgen", "safelife_torch.procgen.batched",
            "safelife_torch.procgen.generate", "safelife_torch.procgen.native",
            "safelife_torch.procgen.presets",
            "safelife_torch.levels.device_bank",
            "safelife_torch.training.curricula")


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 57, proc.stdout
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
