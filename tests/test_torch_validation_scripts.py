"""The port's research scripts on the CPU: ``validate_sinkhorn`` (its scoring
half against the calls ``scripts/validate_sinkhorn.py`` makes, composed
here from ``safelife_tpu.side_effects``), ``cpu_verify_finals`` and
``eval_backend_diff``.

The JAX scripts themselves are not imported: both re-exec the process at
import unless the JAX platform is pinned to the CPU
(``validate_sinkhorn.py:33-37``, ``cpu_verify_finals.py:26-30``), which
would restart the test worker.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.benchmarking import run_benchmark
from safelife_torch.levels import loader, synth
from safelife_torch.metrics.logging import JsonlSummaryWriter
from safelife_torch.scripts import (cpu_verify_finals, eval_backend_diff,
                                    validate_sinkhorn as vs)
from safelife_torch.training import driver, ppo
from safelife_tpu import side_effects as jse
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

SUITE = "benchmarks/v1.0/append-still.npz"
LEVELS, STEPS, SAMPLES = 8, 20, vs.SAMPLES
CHILD_DEADLINE_S = 120
# The CPU evals' episodes, cut from the eval's 1000 steps.
EVAL_STEPS = 100


# ---------------------------------------------------------------------------
# validate_sinkhorn: the scoring half against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def episodes():
    """8 append-still levels rolled 20 steps with numpy-seeded actions by
    the JAX env (``use_pallas=False``, the script's step) and by the
    port's ``validate_sinkhorn.rollout``."""
    actions = np.random.RandomState(7).randint(0, 9, (STEPS, LEVELS))
    jbank = jloader.build_bank(jloader.load_levels(SUITE)[:LEVELS])
    env = JaxEnv(JaxConfig(use_pallas=False, auto_reset=False,
                           time_limit=STEPS, compute_obs=False))
    state = env.reset_to_levels(jbank, jnp.arange(LEVELS))
    step = jax.jit(lambda s, a, k: env.step(s, jbank, a, k))
    key = jax.random.PRNGKey(0)
    done = np.zeros(LEVELS, bool)
    for t in range(STEPS):
        key, k_env = jax.random.split(key)
        state, ts = step(state, jnp.asarray(actions[t]), k_env)
        done |= np.asarray(ts.done)
        if done.all():
            break
    want = {k: np.asarray(getattr(state, k)) for k in
            ("init_board", "board", "spawn_prob", "episode_length")}

    bank = loader.build_bank(loader.load_levels(SUITE)[:LEVELS], device="cpu")
    given = iter(torch.as_tensor(actions))
    port = vs.rollout(bank, STEPS, policy=lambda obs, generator=None:
                      next(given))
    got = {k: getattr(port, k) for k in want}
    return want, got


@pytest.fixture(scope="module")
def distributions(episodes):
    want, got = episodes
    jact, jinact = jse.accumulate_distributions(
        want["init_board"], want["board"], want["spawn_prob"],
        want["episode_length"], SAMPLES, jax.random.PRNGKey(1),
        jse.DEFAULT_TRACKED, catch_up_steps=STEPS)
    act, inact = vs.se.accumulate_distributions(
        got["init_board"], got["board"], got["spawn_prob"],
        got["episode_length"], SAMPLES, torch.Generator().manual_seed(1),
        vs.se.DEFAULT_TRACKED, catch_up_steps=STEPS)
    return (np.asarray(jact), np.asarray(jinact)), (act, inact)


def test_rollout_matches_the_jax_step(episodes):
    want, got = episodes
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_occupancy_distributions_equal(distributions):
    (jact, jinact), (act, inact) = distributions
    assert jact.any() and jinact.any()
    np.testing.assert_array_equal(act.numpy(), jact)
    np.testing.assert_array_equal(inact.numpy(), jinact)


def test_sinkhorn_exact_and_report_match_the_script(episodes,
                                                    distributions):
    (jact, jinact), (act, inact) = distributions
    k = len(jse.DEFAULT_TRACKED)
    h, w, n = jact.shape[1:]
    # validate_sinkhorn.py:104-131, the scoring the script does.
    jsink = np.asarray(jse.sinkhorn_emd(
        jnp.asarray(jinact).reshape(k, h * w, n).transpose(0, 2, 1),
        jnp.asarray(jact).reshape(k, h * w, n).transpose(0, 2, 1),
        jnp.asarray(jse.torus_distances((h, w)), jnp.float32),
        eps=vs.EPS, iters=vs.ITERS))
    jexact = np.zeros_like(jsink)
    jpairs = 0
    for kk in range(k):
        for b in range(n):
            a2, b2 = jinact[kk, :, :, b], jact[kk, :, :, b]
            if a2.max() == 0 and b2.max() == 0:
                continue
            jexact[kk, b] = jse.earth_mover_distance(a2, b2)
            jpairs += 1

    sink = vs.sinkhorn_scores(act, inact)
    exact, pairs = vs.exact_scores(act, inact)
    np.testing.assert_allclose(sink, jsink, rtol=1e-5, atol=0)
    np.testing.assert_allclose(exact, jexact, rtol=0, atol=1e-9)
    assert pairs == jpairs > 0

    tot_sink, tot_exact = jsink.sum(0), jexact.sum(0)
    nz = tot_exact > 1e-6
    rel = np.abs(tot_sink[nz] - tot_exact[nz]) / tot_exact[nz]
    want = dict(episodes=n, scored_pairs=jpairs,
                mean_exact=tot_exact.mean(), mean_sinkhorn=tot_sink.mean(),
                mean_rel_err=rel.mean(), p95_rel_err=np.percentile(rel, 95),
                max_rel_err=rel.max(), episodes_with_effects=nz.sum())
    got = vs.report(sink, exact, pairs)
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key] == pytest.approx(float(v), rel=1e-5, abs=1e-7), key

    _, ep = episodes
    assert vs.score_episodes(
        ep["init_board"], ep["board"], ep["spawn_prob"],
        ep["episode_length"], torch.Generator().manual_seed(1),
        catch_up_steps=STEPS) == got


@pytest.fixture(scope="module")
def small_suite(tmp_path_factory):
    """A suite ``small`` of the first 8 append-still levels, found through
    SAFELIFE_LEVELS (by this process and the subprocesses it starts)."""
    levels = tmp_path_factory.mktemp("levels")
    os.makedirs(levels / "benchmarks" / "v1.0")
    np.savez(levels / "benchmarks" / "v1.0" / "small.npz", levels=np.load(
        os.path.join(loader.PACKAGED_LEVELS, SUITE))["levels"][:LEVELS])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SAFELIFE_LEVELS", str(levels) + os.pathsep
                  + os.environ.get("SAFELIFE_LEVELS", ""))
        yield "small"


def test_main_writes_the_scripts_keys(small_suite, tmp_path, monkeypatch):
    """``main([suite])`` end to end at the script's time limit, resumable."""
    out = tmp_path / "sinkhorn_validation.json"
    got = vs.main([small_suite], out=str(out), device="cpu")
    written = json.loads(out.read_text())
    assert list(written) == [small_suite] and written == got
    assert set(written[small_suite]) == {
        "suite", "episodes", "scored_pairs", "mean_exact", "mean_sinkhorn",
        "mean_rel_err", "p95_rel_err", "max_rel_err",
        "episodes_with_effects"}
    assert written[small_suite]["episodes"] == LEVELS
    monkeypatch.setattr(vs, "validate_suite", lambda *a, **k: None)
    assert vs.main([small_suite], out=str(out), device="cpu") == written


# ---------------------------------------------------------------------------
# cpu_verify_finals and eval_backend_diff on a tiny finished run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory, small_suite):
    """A run directory: ``small-s0`` (a tiny CPU Trainer run, with its
    ``.done`` marker) and ``small-s1`` (the same checkpoint, no marker:
    still training); both evaluate on the suite ``small``."""
    root = tmp_path_factory.mktemp("runs")
    logdir = root / "small-s0"
    with pytest.MonkeyPatch.context() as mp:
        # The writer's JSONL form keeps TensorFlow's import (about 7 s
        # here, through tensorboard) out of the test.
        mp.setattr(driver, "make_summary_writer", JsonlSummaryWriter)
        trainer = driver.Trainer(
            driver.TrainerConfig(num_envs=8, view_shape=(17, 17),
                                 record_videos=False, logdir=str(logdir)),
            ppo.PPOConfig(steps_per_env=4, num_minibatches=2,
                          epochs_per_batch=2),
            bank=synth.synth_bank(4, h=13, w=13, device="cpu"),
            device="cpu")
    trainer.train(total_steps=64)
    trainer.writer.close()
    (root / "small-s0.done").touch()
    shutil.copytree(logdir, root / "small-s1")
    return root


def test_cpu_verify_finals(runs, monkeypatch):
    finals = cpu_verify_finals.main(str(runs), time_limit=EVAL_STEPS)
    assert list(finals) == ["small-s0"]
    policy, view = driver.load_policy(str(runs / "small-s0"), "cpu")
    res = run_benchmark("small", policy, view_shape=view,
                        time_limit=EVAL_STEPS, device="cpu",
                        use_kernels=False)
    assert finals["small-s0"] == {
        "mean_perf": round(float(res["performance"].mean()), 4),
        "mean_reward": round(float(res["reward"].mean()), 3),
        "mean_length": round(float(res["length"].mean()), 1)}
    path = runs / "cpu_finals.json"
    assert json.loads(path.read_text()) == finals
    # A rerun keeps the entry it has and evaluates nothing.
    monkeypatch.setattr(cpu_verify_finals, "run_benchmark", None)
    assert cpu_verify_finals.main(str(runs)) == finals


def test_validate_sinkhorn_main_runs(runs, tmp_path, monkeypatch):
    """``main_runs`` replays each finished run's suite with its policy and
    view (the validation itself replaced by a stand-in: it is tested
    above), keyed by run name, resumable."""
    seen = []

    def validate(suite, time_limit=1000, policy=None, view_shape=None,
                 device=None):
        seen.append((suite, view_shape, device, callable(policy)))
        return dict(suite=suite, episodes=100, episodes_with_effects=100,
                    scored_pairs=1, mean_exact=1.0, mean_sinkhorn=1.0,
                    mean_rel_err=0.0, p95_rel_err=0.0, max_rel_err=0.0)
    monkeypatch.setattr(vs, "validate_suite", validate)
    out = str(tmp_path / "trained.json")
    got = vs.main_runs(str(runs), out=out, device="cpu")
    assert seen == [("small", (17, 17), "cpu", True)]
    assert list(got) == ["small-s0"]
    assert got["small-s0"]["run"] == "small-s0"
    assert vs.main_runs(str(runs), out=out, device="cpu") == got
    assert len(seen) == 1


@pytest.mark.parametrize("run", ["append-dynamic-s2",
                                 "append-still+penalty0.5-s1",
                                 "navigation+lstm-s0"])
def test_run_name_parsing(run):
    # eval_backend_diff.py:86-97's regex.
    want = re.match(r"(.+?)(\+.*)?-s\d+$", run).group(1)
    assert eval_backend_diff.suite_of(run) == want
    assert want in ("append-dynamic", "append-still", "navigation")


def test_eval_backend_diff_cpu_config_repeats(runs, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each child's thread pool
    logdir = str(runs / "small-s0")
    got = [eval_backend_diff.run_eval(logdir, "small", "cpu f32", 0,
                                      time_limit=EVAL_STEPS,
                                      timeout=CHILD_DEADLINE_S)
           for _ in range(2)]
    assert got[0] == got[1]
    assert len(got[0]["perf"]) == LEVELS
    assert set(got[0]) == {"mean_perf", "mean_length", "mean_reward", "perf"}


def test_eval_backend_diff_main(runs, tmp_path, monkeypatch):
    """``main`` end to end, its configurations all moved to the CPU (the
    card ones raise here): every row, the summary and the JSON report."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(eval_backend_diff, "CONFIGS", {
        name: ("cpu", f32, False, pad) for name, (_, f32, _, pad)
        in eval_backend_diff.CONFIGS.items()})
    out = tmp_path / "diff.json"
    report = eval_backend_diff.main(str(runs / "small-s0"), keys=1,
                                    out=str(out), time_limit=EVAL_STEPS)
    assert json.loads(out.read_text()) == report
    assert report["suite"] == "small"
    assert [r["config"] for r in report["rows"]] == list(
        eval_backend_diff.CONFIGS)
    rows = {r["config"]: r for r in report["rows"]}
    assert rows["card plain path"]["perf"] == rows["card default"]["perf"]
    assert set(report["summary"]) == set(eval_backend_diff.CONFIGS)


@pytest.mark.parametrize("config", [c for c, v in
                                    eval_backend_diff.CONFIGS.items()
                                    if v[0] == "cuda"])
def test_eval_backend_diff_card_configs_need_cuda(runs, monkeypatch, config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_backend_diff.run_eval(str(runs / "small-s0"), "small", config,
                                   0)
