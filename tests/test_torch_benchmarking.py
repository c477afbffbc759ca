"""The port's suite evaluation against the JAX package on the CPU:
``run_benchmark`` on spawnless banks (a synthetic bank and the first
levels of the packaged append-still) with a deterministic policy that both
packages compute exactly, so the actions, and with them every per-level
record, must be equal; the side-effect scores within the Sinkhorn
tolerance (rtol 1e-4, atol 1e-6: 200 float32 iterations on both sides,
summed in other orders).  Also the YAML log against the JAX package's text
and through ``load_benchmarks``, ``summarize``, a recurrent policy on the
same path, lane padding and the random policy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch import benchmarking as TB
from safelife_torch.levels import loader as tloader
from safelife_torch.levels import synth as tsynth
from safelife_torch.training import driver as tdriver
from safelife_torch.training import model as tmodel
from safelife_tpu import benchmarking as JB
from safelife_tpu.levels import loader as jloader
from safelife_tpu.levels import synth as jsynth

torch.set_num_threads(1)

SINKHORN_TOL = dict(rtol=1e-4, atol=1e-6)
RECORDS = ("length", "reward", "completed", "possible", "performance")
# (levels, view, time limit, chunk, side-effect samples) of each bank.
CASES = {"synth": (6, (9, 9), 30, 16, 8),
         "append-still": (8, (25, 25), 20, 8, 6)}


def jax_policy(obs, key):
    c = obs.shape[-1]
    return (obs.astype(jnp.int32) * (1 + jnp.arange(c))).sum((1, 2, 3)) % 9


def hash_policy(obs, generator=None):
    """The same deterministic function of the observation as
    :func:`jax_policy`."""
    c = obs.shape[-1]
    weights = 1 + torch.arange(c, dtype=torch.int32, device=obs.device)
    return (obs.to(torch.int32) * weights).sum((1, 2, 3)) % 9


def _banks(name):
    n = CASES[name][0]
    if name == "synth":
        return (jsynth.synth_bank(n, h=13, w=13),
                tsynth.synth_bank(n, h=13, w=13, device="cpu"))
    path = "benchmarks/v1.0/append-still"
    return (jloader.build_bank(jloader.load_levels(path)[:n]),
            tloader.build_bank(tloader.load_levels(path)[:n], device="cpu"))


def _kw(name, side_effects=True):
    _, view, time_limit, chunk, samples = CASES[name]
    return dict(view_shape=view, time_limit=time_limit, chunk=chunk,
                side_effect_samples=samples if side_effects else 0)


@functools.lru_cache(maxsize=None)
def _jax_results(name, side_effects=True, logfile=None):
    return JB.run_benchmark(_banks(name)[0], jax_policy, logfile=logfile,
                            **_kw(name, side_effects))


@pytest.mark.parametrize("name", list(CASES))
def test_run_benchmark_matches_jax(name):
    want = _jax_results(name)
    got = TB.run_benchmark(_banks(name)[1], hash_policy, **_kw(name))
    for k in RECORDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["length"] > 0).all()
    for k in ("side_effects", "side_effect_mass"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **SINKHORN_TOL)
    assert got["side_effects_by_type"].keys() == \
        want["side_effects_by_type"].keys()
    for kind, (s, m) in want["side_effects_by_type"].items():
        np.testing.assert_allclose(got["side_effects_by_type"][kind][0], s,
                                   err_msg=kind, **SINKHORN_TOL)
        np.testing.assert_allclose(got["side_effects_by_type"][kind][1], m,
                                   err_msg=kind, **SINKHORN_TOL)
    assert all(t >= 0 for t in got["side_effect_time"])


def test_log_matches_jax_text_and_round_trips(tmp_path, capsys):
    want_log = tmp_path / "jax.yaml"
    _jax_results("synth", False, str(want_log))
    log = tmp_path / "sub" / "bench.yaml"
    got = TB.run_benchmark(_banks("synth")[1], hash_policy, logfile=str(log),
                           **_kw("synth", False))
    assert log.read_text() == want_log.read_text()
    loaded = TB.load_benchmarks(str(log))
    for k in RECORDS:
        np.testing.assert_allclose(loaded[k], got[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert list(loaded["name"]) == got["name"]
    # With side effects: the per-type pairs of the reference's YAML form.
    log2 = tmp_path / "se.yaml"
    got = TB.run_benchmark(_banks("synth")[1], hash_policy,
                           logfile=str(log2), **_kw("synth"))
    loaded = TB.load_benchmarks(str(log2))
    np.testing.assert_allclose(loaded["side_effects"], got["side_effects"],
                               atol=5e-4)
    assert all(isinstance(v, list) and len(v) == 2
               for r in loaded["side_effects_by_type"] for v in r.values())
    line = TB.summarize(got)
    print(line)
    assert line == JB.summarize(got)
    assert "mean_perf" in capsys.readouterr().out


def test_recurrent_policy_takes_the_same_path():
    """A recurrent policy gets its carry from ``init_carry`` and back each
    step; one that ignores it acts as its feed-forward twin."""
    bank = _banks("synth")[1]
    seen = []

    def policy(obs, carry, generator=None):
        seen.append(int(carry[0, 0]))
        return hash_policy(obs), carry + 1
    policy.recurrent = True
    policy.init_carry = lambda b: torch.zeros((b, 1), dtype=torch.int32)
    got = TB.run_benchmark(bank, policy, **_kw("synth"))
    want = TB.run_benchmark(bank, hash_policy, **_kw("synth"))
    for k in RECORDS + ("side_effects",):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert seen == list(range(len(seen))) and len(seen) % 16 == 0

    # The LSTM net's sampling policy drives it too.
    net = tmodel.SafeLifeLSTMNet(view_shape=(17, 17),
                                 generator=torch.Generator().manual_seed(0))
    lstm = tdriver._sampling_policy(net)
    out = TB.run_benchmark(bank, lstm, view_shape=(17, 17), time_limit=10,
                           chunk=4, side_effect_samples=2)
    assert np.isfinite(out["reward"]).all()
    assert np.isfinite(out["side_effects"]).all()


def test_lane_padding_and_random_policy():
    bank = tsynth.synth_bank(5, h=10, w=10, device="cpu")
    kw = dict(view_shape=(9, 9), time_limit=20, chunk=8)
    base = TB.run_benchmark(bank, hash_policy, **kw)
    padded = TB.run_benchmark(bank, hash_policy, pad_to_lanes=True, **kw)
    for k in RECORDS:
        np.testing.assert_array_equal(base[k], padded[k], err_msg=k)
        assert len(padded[k]) == 5
    rand = TB.run_benchmark(bank, TB.random_policy(), **kw)
    assert ((rand["length"] > 0) & (rand["length"] <= 21)).all()
    assert np.isfinite(rand["reward"]).all()


def test_run_benchmark_by_name_on_the_cpu(monkeypatch):
    """A suite name loads the packaged bank and its level names; without a
    device named and no CUDA, it refuses to start."""
    names = tloader.level_names("benchmarks/v1.0/append-still")
    assert len(names) == 100 and names[0].startswith("append-still/")
    assert names == jloader.level_names("benchmarks/v1.0/append-still")
    got = TB.run_benchmark("append-still", hash_policy, device="cpu",
                           time_limit=4, chunk=4)
    assert got["name"] == names and (got["length"] == 5).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.run_benchmark("append-still", hash_policy)
