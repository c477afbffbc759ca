"""The frozen-suite eval's step graph (``BatchedSafeLifeEnv.graphed``):
where it applies, and on the card ``play_suite`` through replays of one
CUDA graph of the env step against an eager loop of ``env.step`` on
ordinary states, bit for bit: every step's observation, the records, the
final state, the generator's state after the suite and ``run_benchmark``'s
side-effect scores, also under a profile.  On the CPU the graph never
applies and ``play_suite`` is the eager loop.

The tests marked ``card`` need an NVIDIA card and skip without one.  This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_eval_graph.py
"""

import numpy as np
import pytest
import torch

from safelife_torch import benchmarking as TB
from safelife_torch.env import env as tenv
from safelife_torch.levels import loader
from safelife_torch.ops import _build
from safelife_torch.training import driver, model

torch.set_num_threads(1)

# (device, use_kernels, auto_reset, can_toggle_powers) -> whether the
# step's graph applies.
PICKS = {
    "card-kernels-no-reset": ("cuda:0", True, False, False, True),
    "cpu": ("cpu", True, False, False, False),
    "card-plain-step": ("cuda:0", False, False, False, False),
    "card-auto-reset": ("cuda:0", True, True, False, False),
    "card-toggles": ("cuda:0", True, False, True, False),
}
SUITES = ("prune-spawn", "append-still")
POLICIES = ("cnn", "random", "lstm")
VIEW = (33, 33)
TIME_LIMIT = 1000
SAMPLES = 8


@pytest.fixture
def card():
    """Skips the test where no card is present (decided here, when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


def make_policy(kind, view, device):
    if kind == "random":
        return TB.random_policy()
    net = {"cnn": model.SafeLifeCNN, "lstm": model.SafeLifeLSTMNet}[kind](
        view_shape=view, generator=torch.Generator().manual_seed(0))
    return driver._sampling_policy(net.to(device))


class Watched:
    """``policy`` with each call's observation compared to the one the
    eager loop saw at that call (``want``) or, without it, kept."""

    def __init__(self, policy, want=None):
        self.policy = policy
        self.recurrent = bool(getattr(policy, "recurrent", False))
        self.init_carry = getattr(policy, "init_carry", None)
        self.want = want
        self.seen = []
        self.mismatches = None

    def __call__(self, obs, *args, **kw):
        if self.want is None:
            self.seen.append(obs.clone())
        else:
            bad = (obs != self.want[len(self.seen)]).sum()
            self.seen.append(None)
            self.mismatches = bad if self.mismatches is None \
                else self.mismatches + bad
        return self.policy(obs, *args, **kw)


def eager_suite(env, bank, policy, batch, generator, chunk=64):
    """``play_suite``'s loop on ordinary states, written out: ``env.step``
    on the kernels, or the plain step with the kernels' spawn fields."""
    dev = env.device
    state = env.reset_to_levels(
        bank, torch.arange(batch, device=dev) % bank.num_levels)
    obs = env.observe(state)
    carry = policy.init_carry(batch) if policy.recurrent else None
    i32 = dict(dtype=torch.int32, device=dev)
    rec = dict(done=torch.zeros(batch, dtype=torch.bool, device=dev),
               length=torch.zeros(batch, **i32),
               reward=torch.zeros(batch, dtype=torch.float32, device=dev),
               completed=torch.zeros(batch, **i32),
               possible=torch.zeros(batch, **i32))
    fields = dict(length="episode_length", reward="episode_reward",
                  completed="perf_completed", possible="perf_possible")
    for _ in range(0, env.config.time_limit + chunk, chunk):
        for _ in range(chunk):
            if policy.recurrent:
                action, carry = policy(obs, carry, generator=generator)
            else:
                action = policy(obs, generator=generator)
            if env.uses_kernels():
                state, ts = env.step(state, bank, action, generator)
            else:
                board, goals = env.kernel_spawn_fields(
                    state, bank, env.step_seed(generator))
                state, ts = env.step(state, bank, action, spawn_board=board,
                                     spawn_goals=goals)
            newly = ts.done & ~rec["done"]
            for key, name in fields.items():
                rec[key] = torch.where(newly, getattr(ts, name), rec[key])
            rec["done"] = rec["done"] | ts.done
            obs = ts.obs
        if bool(rec["done"].all()):
            break
    return rec, state


def assert_same_suite(got, want):
    (rec, state), (rec0, state0) = got, want
    assert rec.keys() == rec0.keys()
    for k in rec0:
        assert torch.equal(rec[k], rec0[k]), k
    for name, leaf in state0.to_numpy().items():
        np.testing.assert_array_equal(state.to_numpy()[name], leaf,
                                      err_msg=name)


def play_both(env, bank, kind, seed, run=None):
    """The eager loop, then ``play_suite`` (through ``run``, a wrapper of
    the call) with the same policy and generator seed: ``(eager, played,
    the two generators' states, the graphed run's policy)``."""
    dev = env.device
    eager = Watched(make_policy(kind, env.config.view_shape, dev))
    gen = torch.Generator(dev).manual_seed(seed)
    want = eager_suite(env, bank, eager, bank.num_levels, gen)
    gen_want = gen.get_state()
    graphed = Watched(eager.policy, want=eager.seen)
    gen = torch.Generator(dev).manual_seed(seed)
    call = lambda: TB.play_suite(env, bank, graphed,  # noqa: E731
                                 bank.num_levels, gen)
    got = run(call) if run else call()
    assert len(graphed.seen) == len(eager.seen)
    return want, got, (gen.get_state(), gen_want), graphed


@pytest.mark.parametrize("case", list(PICKS))
def test_step_graph_is_picked_only_where_it_applies(case):
    device, kernels, auto_reset, toggles, want = PICKS[case]
    env = tenv.BatchedSafeLifeEnv(tenv.EnvConfig(
        use_kernels=kernels, auto_reset=auto_reset,
        can_toggle_powers=toggles), device=device)
    assert env.uses_graph() is want


@pytest.mark.parametrize("kind", POLICIES)
def test_play_suite_on_the_cpu_is_the_eager_loop(kind):
    """On the CPU the state stays an ordinary one and ``play_suite`` is
    the eager loop: the same observations, records, final state and
    generator state; no graph is captured or replayed."""
    bank = loader.build_bank(
        loader.load_levels("benchmarks/v1.0/prune-spawn")[:6], device="cpu")
    env = tenv.BatchedSafeLifeEnv(tenv.EnvConfig(
        view_shape=(17, 17), time_limit=30, auto_reset=False), device="cpu")
    state = env.reset_to_levels(bank, torch.arange(6))
    assert env.graphed(state, bank) is state
    before = dict(_build.LAUNCHES)
    want, got, (gen, gen_want), graphed = play_both(env, bank, kind, 7)
    assert_same_suite(got, want)
    assert int(graphed.mismatches) == 0
    assert torch.equal(gen, gen_want)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.card
@pytest.mark.parametrize("suite", SUITES)
@pytest.mark.parametrize("kind", POLICIES)
def test_graphed_suite_is_the_eager_suite(card, suite, kind):
    """One replay a step (the first step's warm-up run dropped, that step
    replayed too), one capture a suite, and everything the eager loop
    gives, bit for bit."""
    bank = loader.load_bank(f"benchmarks/v1.0/{suite}", device=card)
    env = tenv.BatchedSafeLifeEnv(tenv.EnvConfig(
        view_shape=VIEW, time_limit=TIME_LIMIT, auto_reset=False),
        device=card)
    assert env.uses_graph()
    before = dict(_build.LAUNCHES)
    want, got, (gen, gen_want), graphed = play_both(env, bank, kind, 11)
    assert_same_suite(got, want)
    assert int(graphed.mismatches) == 0
    assert torch.equal(gen, gen_want)
    steps = len(graphed.seen)
    assert steps == 1024  # 16 chunks of 64: the time limit ends the last
    counted = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()}
    assert counted[tenv.GRAPH_REPLAY] == steps
    assert counted[tenv.GRAPH_CAPTURE] == 1
    # The warm-up run and the capture; the eager loop's steps besides.
    assert counted["K1_action"] == steps + 2


@pytest.mark.card
@pytest.mark.parametrize("suite", SUITES)
def test_graphed_run_benchmark_scores_as_the_eager_one(card, suite,
                                                       monkeypatch):
    bank = loader.load_bank(f"benchmarks/v1.0/{suite}", device=card)

    def run():
        return TB.run_benchmark(
            bank, make_policy("cnn", VIEW, card),
            generator=torch.Generator(card).manual_seed(5), view_shape=VIEW,
            time_limit=TIME_LIMIT, side_effect_samples=SAMPLES)

    before = _build.LAUNCHES[tenv.GRAPH_REPLAY]
    got = run()
    assert _build.LAUNCHES[tenv.GRAPH_REPLAY] - before == 1024
    monkeypatch.setattr(tenv.BatchedSafeLifeEnv, "uses_graph",
                        lambda self: False)
    want = run()
    for k in TB.RECORDS + ("performance", "side_effects",
                           "side_effect_mass"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for kind, (s, m) in want["side_effects_by_type"].items():
        np.testing.assert_array_equal(got["side_effects_by_type"][kind][0],
                                      s, err_msg=kind)
        np.testing.assert_array_equal(got["side_effects_by_type"][kind][1],
                                      m, err_msg=kind)


@pytest.mark.card
def test_graphed_suite_under_a_profile(card):
    """Captured and replayed under ``torch.profiler``, as the benchmark's
    traced run profiles a suite: the same suite as the eager loop's, and
    the profile holds the replayed kernels as device ops linked to the
    replays' ``cudaGraphLaunch``."""
    from torch.profiler import ProfilerActivity, profile
    bank = loader.load_bank("benchmarks/v1.0/prune-spawn", device=card)
    env = tenv.BatchedSafeLifeEnv(tenv.EnvConfig(
        view_shape=VIEW, time_limit=TIME_LIMIT, auto_reset=False),
        device=card)
    before = dict(_build.LAUNCHES)

    def profiled(call):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize(card)
        profiled.prof = prof
        return out

    want, got, (gen, gen_want), graphed = play_both(env, bank, "cnn", 13,
                                                    profiled)
    assert_same_suite(got, want)
    assert int(graphed.mismatches) == 0
    assert torch.equal(gen, gen_want)
    counted = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()}
    assert counted[tenv.GRAPH_REPLAY] == 1024
    assert counted[tenv.GRAPH_CAPTURE] == 1
    launches, kernels = set(), []
    for e in profiled.prof.profiler.kineto_results.events():
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if not on_device and e.name() == "cudaGraphLaunch":
            launches.add(e.correlation_id())
        elif on_device and "action_kernel" in e.name():
            kernels.append(e.correlation_id())
    assert len(launches) == 1024
    # K1 once a replay, each linked to its replay's launch.
    assert sum(c in launches for c in kernels) == 1024
