"""``safelife_torch.scripts.microbench`` on the CPU: every row runs at B =
64, STEPS = 4 through the plain versions, ``main()`` and ``op_bench()``
refuse to measure without CUDA, and the deterministic rows (the CA advance
with the fixed field, the six ``ops`` rows given the JAX row's actions)
equal what ``scripts/microbench.py`` computes, bit for bit."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import safelife_torch.scripts as scripts
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.scripts import microbench

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 64, 4
JAX_ROWS = ("CA advance (fixed spawn field)",) + tuple(microbench.OP_ROUTES)


@pytest.fixture(scope="module")
def jax_rows():
    """What ``scripts/microbench.py``'s ``timeit`` receives for the
    deterministic rows at B = 64, STEPS = 4: name -> (the row's output,
    its inputs), each loop run once."""
    spec = importlib.util.spec_from_file_location(
        "jax_microbench", os.path.join(ROOT, "scripts", "microbench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.B, module.STEPS = B, STEPS
    got = {}

    def record(name, fn, *args):
        if name in JAX_ROWS:
            got[name] = (np.asarray(fn(*args)), [np.asarray(a) for a in args])
    module.timeit = record
    module.main()
    module.op_bench()
    assert set(got) == set(JAX_ROWS)
    return got


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setattr(microbench, "B", B)
    monkeypatch.setattr(microbench, "STEPS", STEPS)
    monkeypatch.setattr(scripts, "REPEATS", 1)
    return microbench


def test_ca_fixed_field_row_matches_jax(port, jax_rows):
    bank, lv = port.load(torch.device("cpu"))
    out, (board,) = jax_rows["CA advance (fixed spawn field)"]
    np.testing.assert_array_equal(lv.board.numpy(), board)
    spawn = torch.zeros(lv.board.shape, dtype=torch.bool)
    for plain in (False, True):
        got = port.ca_fixed(spawn, plain=plain)(lv.board)
        np.testing.assert_array_equal(got.numpy(), out)


@pytest.mark.parametrize("plain", [False, True])
def test_ops_rows_match_jax(port, jax_rows, plain):
    bank, lv = port.load(torch.device("cpu"))
    action = torch.as_tensor(np.array(
        jax.random.randint(jax.random.PRNGKey(0), (B,), 0, 9)))
    agents = port.op_inputs(lv)[:3]
    loops = port.op_loops(bank, lv.goals, *agents, action, plain=plain)
    assert set(loops) == set(port.OP_ROUTES)
    for name, run in loops.items():
        out, (x,) = jax_rows[name]
        got = run(torch.as_tensor(x.astype(np.int32) if name == "bank.take"
                                  else x))
        assert got.dtype == (torch.int32 if name == "bank.take"
                             else torch.uint16), name
        np.testing.assert_array_equal(got.numpy().astype(out.dtype), out,
                                      err_msg=name)


def test_uniform_row_with_given_fields_is_the_plain_loop(port):
    bank, lv = port.load(torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    fields = torch.rand((STEPS,) + tuple(lv.board.shape),
                        generator=gen) < port.SPAWN_RATE
    got = port.ca_uniform(fields)(lv.board)
    want = lv.board
    for f in fields:
        want = port.life.advance_board(want, f)
    assert torch.equal(got, want)


def test_env_rows_run_both_ways(port):
    bank, _ = port.load(torch.device("cpu"))
    for name, cfg in port.ENV_ROWS:
        env = BatchedSafeLifeEnv(EnvConfig(**cfg), device="cpu")
        state = env.reset_all(bank, B, torch.Generator().manual_seed(0))
        for plain in (False, True):
            out, obs = port.env_steps(env, bank, torch.Generator().manual_seed(
                2), plain=plain)(state)
            assert int(out.episode_length.min()) >= STEPS or cfg["auto_reset"]
            assert (obs is None) == (not cfg.get("view_shape")), name


def test_every_row_runs_on_the_cpu(port, capsys):
    rows = port.main(device="cpu")
    rows.update(port.op_bench(device="cpu"))
    names = [n for n, _ in port.ENV_ROWS] + list(port.OP_ROUTES)
    assert set(names) <= set(rows) and len(rows) == len(names) + 2
    assert all(us > 0 for us in rows.values())
    printed = capsys.readouterr().out
    for name in rows:
        assert name in printed
    for name, route in port.OP_ROUTES.items():
        assert f"[{route}]" in printed


@pytest.mark.parametrize("entry", ["main", "op_bench"])
def test_microbench_needs_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(microbench, entry)()
