"""``safelife_torch.scripts.scaling_report`` on gloo ranks on the CPU: the
machine-independent facts behind data-parallel scaling, as
``tests/test_scaling.py`` checks them for the JAX package, counted while
one ``train_batch`` runs on each rank (sizes 1 and 2, 16 environments a
rank; the JAX test compiles 1 and 8 devices, and two ranks keep this
test's time down):

1. per-rank FLOPs stay flat from 1 to 2 ranks;
2. the only traffic is the gradient all-reduce (parameter-sized, per
   sync), for the CNN and the recurrent learner;
3. the efficiency model at 8 ranks and 2048 environments a rank clears
   0.8.

Every rank has a deadline, and ``profiles`` kills what it started.
"""

import concurrent.futures
import importlib.util
import os

import pytest
import torch

from safelife_torch.parallel.distributed import dp_efficiency_model
from safelife_torch.scripts import scaling_report as sr
from safelife_torch.training.ppo import PPOConfig

# One thread keeps torch from leaving an OpenMP pool in the test process
# that slows the JAX tests run after it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = 16
DEADLINE_S = 240
SYNCS = PPOConfig().epochs_per_batch * PPOConfig().num_minibatches


@pytest.fixture(scope="module")
def profiles():
    """Each rank's counts at 1 rank (CNN) and 2 ranks (CNN and LSTM), the
    two jobs at once."""
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")  # each rank's thread pool
        one = pool.submit(sr.profiles, 1, ENVS, "cpu", kinds=("cnn",),
                          timeout=DEADLINE_S)
        two = pool.submit(sr.profiles, 2, ENVS, "cpu", timeout=DEADLINE_S)
        one, two = one.result(), two.result()
    return {1: one["cnn"], 2: two["cnn"], "lstm": two["lstm"]}


def test_per_rank_work_is_flat(profiles):
    f1 = profiles[1][0]["flops"]
    assert f1 > 0
    for r in profiles[2]:
        assert r["flops"] == pytest.approx(f1, rel=0.10), (
            f"per-rank flops changed 1 -> 2 ranks: {f1:.3e} -> "
            f"{r['flops']:.3e}; the batch sharding is not dividing the work")


@pytest.mark.parametrize("kind", [2, "lstm"])
def test_only_gradients_cross_ranks(profiles, kind):
    for r in profiles[kind]:
        param_bytes = 4 * r["n_params"]
        moved = r["collective_bytes"]
        per_sync = moved.get("all-reduce", 0) / SYNCS
        assert 0 < per_sync <= 1.5 * param_bytes, (
            f"all-reduce moves {per_sync} bytes a sync vs {param_bytes} "
            f"parameter bytes: trajectory data crosses ranks")
        # The gradient and the loss's four float32 means, each sync.
        assert per_sync == param_bytes + 16
        other = sum(v for k, v in moved.items() if k != "all-reduce")
        assert other < 100_000, f"non-gradient collectives: {moved}"


@pytest.mark.parametrize("kind", [2, "lstm"])
def test_efficiency_model_clears_target(profiles, kind):
    cfg = PPOConfig()
    flops = sr.train_batch_flops_per_device(
        cfg, sr.PROD_ENVS_PER_DEVICE, sr.fwd_flops_per_obs())
    ar = profiles[kind][0]["collective_bytes"]["all-reduce"]
    eff = dp_efficiency_model(8, flops, ar)
    assert eff >= 0.8, (
        f"modeled weak-scaling efficiency {eff:.3f} < 0.8 at "
        f"{sr.PROD_ENVS_PER_DEVICE} envs/rank")


def test_forward_flops_against_xla():
    """The port counts the convolutions' and dense layers' multiply-adds
    (2 FLOPs each), exactly; XLA's cost analysis, which the JAX script
    reads, adds the elementwise work (input conversion, biases,
    activations): 5,889,288 against 5,089,216 at 25x25, 15.7% more.  The
    bound: the JAX count at least the port's and at most 1.2 times it."""
    got = sr.fwd_flops_per_obs()
    # (output cells x kernel volume) x 2 for the trunk's three VALID
    # convolutions at 25x25 -> 11x11x32, 5x5x64, 3x3x64, then the dense
    # layer (576 -> 512) and the two heads (512 -> 9, 512 -> 1).
    macs = (11 * 11 * 32 * 5 * 5 * 15 + 5 * 5 * 64 * 3 * 3 * 32
            + 3 * 3 * 64 * 3 * 3 * 64 + 576 * 512 + 512 * 9 + 512)
    assert got == 2 * macs
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_report", os.path.join(ROOT, "scripts",
                                           "scaling_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    xla = module.fwd_flops_per_obs()
    assert got <= xla <= 1.2 * got, (got, xla)


def test_main_writes_the_report(tmp_path, monkeypatch):
    """``main`` writes the JAX script's fields where ``out`` points (the
    ranks replaced by a stand-in: the profile itself is tested above)."""
    counts = {"flops": 1e9, "collective_bytes": {"all-reduce": 12 * 1016},
              "n_params": 250}
    monkeypatch.setattr(sr, "build", lambda n, envs, device=None: [
        dict(counts, rank=r) for r in range(n)])
    out = tmp_path / "scaling.json"
    report = sr.main((1, 2), device="cpu", out=str(out))
    assert out.exists()
    assert {"param_bytes", "grad_syncs_per_batch", "envs_per_device",
            "prod_envs_per_device", "note", "sizes"} <= set(report)
    assert report["param_bytes"] == 1000
    for row, n in zip(report["sizes"], (1, 2)):
        assert {"devices", "hlo_flops_per_device", "collective_bytes",
                "allreduce_bytes_per_sync", "model_efficiency_small",
                "model_efficiency_prod"} <= set(row)
        assert row["devices"] == n and row["allreduce_bytes_per_sync"] == 1016


def test_scaling_report_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr.main((1,))
