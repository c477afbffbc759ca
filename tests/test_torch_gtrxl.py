"""``SafeLifeGTrXLNet`` (the port's GTrXL policy) against the benchmark's
plain float32 reference (``portbench/reference/gtrxl.py``, written apart
from it: a time-ordered window where the port keeps a ring) on seeded
random weights, at a small size on the CPU: 2 layers, d_model 32, 2
heads, a memory of 8, segments of 5 steps, 3 environments.

Tolerances: float32 on both sides 1e-5 (the same sums in other orders);
the port's bfloat16 products against the float32 reference rtol 5e-2,
atol 2e-2 on the logits (8 significant bits at each product's output,
through two layers, and the memory rounded once where it is written).
"""

import copy
import os
import pickle
import sys
import weakref

import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import synth
from safelife_torch.training import ppo as P
from safelife_torch.training.gtrxl import GTrXL
from safelife_torch.training.model import SafeLifeGTrXLNet
from safelife_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from portbench.harness import common  # noqa: E402
from portbench.harness import gtrxl as HG  # noqa: E402
from portbench.reference import gtrxl as RG  # noqa: E402

torch.set_num_threads(1)

VIEW, B, T = (17, 17), 3, 5
SMALL = dict(layers=2, d_model=32, heads=2, head_dim=16, mlp=128, memory=8)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)


def _config():
    cfg = copy.deepcopy(common.load_json("portbench/configs/"
                                         "safelife-gtrxl.json"))
    cfg["view_shape"] = list(VIEW)
    cfg["core"].update(SMALL)
    for layer in cfg["layers"]:
        if layer["name"] == "embed":
            layer["in"], layer["out"] = 64, SMALL["d_model"]
        elif layer["name"] in ("policy", "value"):
            layer["in"] = SMALL["d_model"]
    return cfg


def _weights(cfg, seed=7):
    """The harness's weights, with ``u``, ``v`` and the gates' biases
    drawn too, so that every term of the score and gate counts."""
    w = HG.make(cfg, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    for k in w:
        if k.endswith((".u", ".v")):
            w[k] = torch.randn(w[k].shape, generator=gen) * 0.5
        elif k.endswith("gate1.bias") or k.endswith("gate2.bias"):
            w[k] = w[k] + torch.randn(w[k].shape, generator=gen) * 0.5
        elif k.endswith((".ln1.bias", ".ln2.bias")):
            w[k] = torch.randn(w[k].shape, generator=gen) * 0.1
    return w


def _pair(dtype=torch.float32):
    cfg = _config()
    w = _weights(cfg)
    net = SafeLifeGTrXLNet(view_shape=VIEW, compute_dtype=dtype, **SMALL)
    net.load_state_dict(w)
    ref = RG.GTrXLNet(cfg, {k: v.clone() for k, v in w.items()})
    return net, ref


def _obs(steps, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((steps, B) + VIEW + (15,), generator=gen)
            < 0.15).to(torch.uint8)


def _done(steps):
    done = torch.zeros(max(steps, 4 * T), B, dtype=torch.bool)
    done[6, 0] = done[12, 1] = done[13, 1] = done[17, 2] = True
    return done[:steps]


def _segments(net, ref, count):
    """Both nets stepped through ``count`` segments of ``T`` steps with
    ``_done``'s resets, a bootstrap step after each, as the rollout runs
    them.  Yields each segment's observations, ``done``, the two sides'
    logits and carries at its start; the caller replays a segment before
    the next one runs, as the update does (the rollout after it writes
    into the ring the segment's replay reads)."""
    obs, done = _obs(count * T + 1), _done(count * T)
    carry, rcarry = net.initial_carry(B, T), ref.initial_carry(B, "cpu")
    for s in range(count):
        start, out, rout = (carry, rcarry), [], []
        with torch.no_grad():
            for t in range(s * T, (s + 1) * T):
                carry, (logits, _) = net(obs[t], carry)
                (rlogits, _), rcarry = ref.forward(obs[t], rcarry)
                carry = P.mask_carry(carry, done[t], net)
                rcarry = ref.reset(rcarry, done[t])
                out.append(logits)
                rout.append(rlogits)
            net(obs[(s + 1) * T], carry)
        seg = slice(s * T, (s + 1) * T)
        yield obs[seg], done[seg], torch.stack(out), torch.stack(rout), start


def test_one_step_matches_the_reference():
    net, ref = _pair()
    obs = _obs(1)[0]
    with torch.no_grad():
        carry, (logits, values) = net(obs, net.initial_carry(B))
        (rlogits, rvalues), _ = ref.forward(obs, ref.initial_carry(B, "cpu"))
    torch.testing.assert_close(logits, rlogits, **F32)
    torch.testing.assert_close(values, rvalues, **F32)
    assert carry[-2].tolist() == [1] * B and carry[-1].tolist() == [1] * B


def test_rollout_with_resets_and_a_wrapped_ring_matches_the_reference():
    """20 steps through a ring of 14 slots (memory 8 + segment 5 + 1),
    an episode ending in each environment, one twice in a row."""
    net, ref = _pair()
    for _, _, out, rout, _ in _segments(net, ref, 4):
        torch.testing.assert_close(out, rout, **F32)


def test_a_ring_without_room_for_a_segment_steps_as_the_reference():
    """The carry an eval makes (``initial_carry(B)``: memory + 1 slots)
    steps 12 times, wrapping its 9-slot ring, with ``_done``'s resets."""
    net, ref = _pair()
    obs, done = _obs(12), _done(12)
    carry, rcarry = net.initial_carry(B), ref.initial_carry(B, "cpu")
    assert carry[0].shape[1] == SMALL["memory"] + 1
    with torch.no_grad():
        for t in range(12):
            carry, (logits, _) = net(obs[t], carry)
            (rlogits, _), rcarry = ref.forward(obs[t], rcarry)
            torch.testing.assert_close(logits, rlogits, **F32)
            carry = P.mask_carry(carry, done[t], net)
            rcarry = ref.reset(rcarry, done[t])


def test_segment_replay_reproduces_the_rollout():
    """Each segment replayed from the carry it started from gives the
    rollout's logits, the reference's replay too, with the rows of a
    minibatch taken as ``RecurrentPPO`` takes them."""
    net, ref = _pair()
    rows = torch.tensor([2, 0])
    for obs, done, out, _, (carry0, rcarry0) in _segments(net, ref, 4):
        logits, _ = P.recurrent_forward(net, obs[:, rows], done[:, rows],
                                        tuple(c[rows] for c in carry0))
        rlogits, _ = ref.replay(obs[:, rows], done[:, rows],
                                tuple(c[rows] for c in rcarry0))
        torch.testing.assert_close(logits, out[:, rows], **F32)
        torch.testing.assert_close(rlogits, out[:, rows], **F32)


def test_segment_gradients_match_the_reference():
    net, ref = _pair()
    gen = torch.Generator().manual_seed(5)
    wl = torch.randn(T, B, 9, generator=gen)
    for s, (obs, done, _, _, (carry0, rcarry0)) in enumerate(
            _segments(net, ref, 3)):
        if s == 2:
            break
    logits, values = P.recurrent_forward(net, obs, done, carry0)
    ((logits * wl).sum() + values.square().sum()).backward()
    params = {k: v.requires_grad_() for k, v in ref.p.items()}
    rlogits, rvalues = ref.replay(obs, done, rcarry0)
    ((rlogits * wl).sum() + rvalues.square().sum()).backward()
    grads = dict(net.named_parameters())
    for k, p in params.items():
        torch.testing.assert_close(grads[k].grad, p.grad, rtol=1e-4,
                                   atol=1e-6, msg=k)


def test_slots_from_before_an_episode_start_do_not_count():
    """After a reset, overwriting every slot the ring held changes
    nothing; before it, it does."""
    net, _ = _pair()
    obs = _obs(4)
    carry = net.initial_carry(B)
    with torch.no_grad():
        for t in range(3):
            carry, _ = net(obs[t], carry)
        done = torch.tensor([True, False, False])
        carry = net.reset_carry(carry, done)
        garbled = tuple(torch.randn_like(c) if c.is_floating_point() else c
                        for c in carry)
        _, (a, _) = net(obs[3], carry)
        _, (b, _) = net(obs[3], garbled)
    assert torch.equal(a[0], b[0])
    assert not torch.allclose(a[1:], b[1:])


def test_the_memory_fill_counter():
    net, _ = _pair()
    carry = net.initial_carry(B)
    obs = _obs(3)
    with torch.no_grad():
        for t in range(3):
            carry, _ = net(obs[t], carry)
            carry = net.reset_carry(carry, torch.tensor([t == 1, False,
                                                         False]))
    # lengths before each reset: 1, 2 (env 0 reset to 0), then 1, 3, 3
    want = ((1 + 1 + 1) + (2 + 2 + 2) + (1 + 3 + 3)) / 3 / 3 / 8
    assert abs(float(net.take_memory_fill()) - want) < 1e-6
    assert net.take_memory_fill() is None


def test_train_batch_first_minibatch_reproduces_the_rollout():
    """``RecurrentPPO.train_batch`` at 8 envs: the loss of the first
    minibatch sees the rollout's own probabilities (``a_pi == old_pi``)
    before any Adam step, and the batch reports the memory's fill."""
    bank = synth.synth_bank(2, h=13, w=13, device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW, time_limit=7),
                             device="cpu")
    cfg = P.PPOConfig(steps_per_env=T, num_minibatches=2, epochs_per_batch=1)
    gen = torch.Generator().manual_seed(0)
    net = SafeLifeGTrXLNet(view_shape=VIEW, compute_dtype=torch.float32,
                           generator=gen, **SMALL)
    ts = P.init_train_state(cfg, net)
    state = env.reset_all(bank, 8, gen)
    obs = env.observe(state)
    carry = net.initial_carry(8, T)
    ppo = P.RecurrentPPO(cfg, env)
    seen = []
    real = P._loss_terms

    def spy(cfg_, logits, value, spe, action, old_pi, *rest, **kw):
        probs = torch.softmax(logits, -1)
        a_pi = probs.gather(-1, action[..., None])[..., 0]
        seen.append((a_pi.detach() - old_pi).abs().max().item())
        return real(cfg_, logits, value, spe, action, old_pi, *rest, **kw)
    P._loss_terms = spy
    try:
        for _ in range(2):
            state, obs, carry, metrics = ppo.train_batch(
                ts, state, obs, carry, bank, gen)
            assert 0 < float(metrics["memory_fill"]) <= 1
    finally:
        P._loss_terms = real
    assert seen[0] < 1e-6 and seen[2] < 1e-6, seen
    assert max(seen[1], seen[3]) > 1e-6  # after an Adam step they part
    assert ts.update_step == 2


def test_bfloat16_products_against_the_float32_reference():
    net, ref = _pair(torch.bfloat16)
    for _, _, out, rout, _ in _segments(net, ref, 2):
        torch.testing.assert_close(out, rout, **BF16)


def _refreshes(spans):
    return [s for s in spans if s.name == "gtrxl.kv_refresh"]


def _features(steps, seed=11):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(steps, B, SMALL["d_model"], generator=gen)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
def test_cached_steps_match_the_projecting_path(dtype, tol):
    """The rollout's steps (no grad: keys and values from the cache, one
    refresh) against the same core's steps with grad (the whole ring
    projected each step), 3 segments and their bootstrap steps through a
    14-slot ring with ``_done``'s resets: the same outputs and rings.
    The single slot's projection may round apart from the whole ring's
    (float32 sums in another order), so bfloat16 compares at ``BF16``."""
    net, _ = _pair(dtype)
    cached, projecting = net.core, copy.deepcopy(net.core)
    x, done = _features(3 * (T + 1)), _done(3 * T)
    carry, pcarry = cached.initial_carry(B, T), projecting.initial_carry(B, T)
    profiling.clear()
    with profiling.recording():
        for s in range(3):
            for t in range(s * (T + 1), (s + 1) * (T + 1)):
                with torch.no_grad():
                    out_carry, out = cached.step(x[t], carry)
                pout_carry, pout = projecting.step(x[t], pcarry)
                torch.testing.assert_close(out, pout.detach(), **tol)
                if t < (s + 1) * (T + 1) - 1:  # not the bootstrap step
                    d = done[t - s]
                    carry = cached.reset_carry(out_carry, d)
                    pcarry = projecting.reset_carry(pout_carry, d)
    spans = profiling.spans()
    profiling.clear()
    assert len(_refreshes(spans)) == 1
    assert all(s.parent == "gtrxl.core" for s in _refreshes(spans))
    for ring, pring in zip(carry[:-2], pcarry[:-2]):
        torch.testing.assert_close(ring, pring, **tol)


def _optimizer_step(core, make):
    gen = torch.Generator().manual_seed(1)
    opt = make(list(core.parameters()))
    for p in core.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()


def _write_ring(core, carry):
    carry[0][:, :4] += 1.0
    return carry


STALE = {
    "program_optimizer": lambda core, carry: _optimizer_step(
        core, lambda params: P.make_optimizer(P.PPOConfig(), params)),
    "adam_foreach": lambda core, carry: _optimizer_step(
        core, lambda params: torch.optim.Adam(params, lr=1e-2,
                                              foreach=True)),
    "new_carry": lambda core, carry: core.initial_carry(B, T),
    "ring_written": _write_ring,
}


@pytest.mark.parametrize("change", sorted(STALE))
def test_the_cache_is_refreshed_where_it_could_be_stale(change):
    """After 4 cached steps, an optimizer's step on the parameters, a new
    carry, or a write into a ring from outside the step: the next 3
    cached steps give, bit for bit, what a copy of the core (which starts
    with no cache) gives on a copy of the carry, and refresh once."""
    net, _ = _pair()
    core, x = net.core, _features(7)
    carry = core.initial_carry(B, T)
    with torch.no_grad():
        for t in range(4):
            carry, _ = core.step(x[t], carry)
    with torch.enable_grad():
        carry = STALE[change](core, carry) or carry
    fresh = copy.deepcopy(core)
    fcarry = tuple(c.clone() for c in carry)
    profiling.clear()
    with profiling.recording(), torch.no_grad():
        for t in range(4, 7):
            carry, out = core.step(x[t], carry)
            fcarry, want = fresh.step(x[t], fcarry)
            assert torch.equal(out, want), t
    refreshes = len(_refreshes(profiling.spans()))
    profiling.clear()
    assert refreshes == 2  # the core's and the copy's, each once


def test_the_cache_stays_out_of_the_state_dict_and_copies():
    net, _ = _pair()
    keys = set(net.state_dict())
    with torch.no_grad():
        net(_obs(1)[0], net.initial_carry(B, T))
    assert net.core._kv is not None
    assert set(net.state_dict()) == keys
    assert copy.deepcopy(net).core._kv is None
    assert pickle.loads(pickle.dumps(net)).core._kv is None
    held = weakref.ref(net.core._kv.kv[0])
    del net  # the cache goes with the net
    assert held() is None


def test_a_rollout_refreshes_the_cache_once_a_batch():
    """Three ``RecurrentPPO.train_batch`` calls of 20 steps (21 with the
    bootstrap): one refresh each, at the rollout's first step, where the
    update before it changed the parameters; the update holds no cache."""
    bank = synth.synth_bank(2, h=13, w=13, device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW, time_limit=9),
                             device="cpu")
    cfg = P.PPOConfig(steps_per_env=20, num_minibatches=2,
                      epochs_per_batch=1)
    gen = torch.Generator().manual_seed(0)
    net = SafeLifeGTrXLNet(view_shape=VIEW, compute_dtype=torch.float32,
                           generator=gen, **SMALL)
    ts = P.init_train_state(cfg, net)
    state = env.reset_all(bank, 4, gen)
    obs = env.observe(state)
    carry = net.initial_carry(4, cfg.steps_per_env)
    ppo = P.RecurrentPPO(cfg, env)
    profiling.clear()
    with profiling.recording():
        for _ in range(3):
            state, obs, carry, _ = ppo.train_batch(ts, state, obs, carry,
                                                   bank, gen)
    spans = profiling.spans()
    profiling.clear()
    rollouts = [s for s in spans if s.name == "ppo.rollout"]
    steps = [s for s in spans if s.name == "gtrxl.core"
             and any(r.start_ns <= s.start_ns <= r.end_ns for r in rollouts)]
    refreshes = _refreshes(spans)
    assert len(rollouts) == 3 and len(steps) == 3 * 21
    assert len(refreshes) == 3
    for r, first in zip(refreshes, steps[::21]):
        assert first.start_ns <= r.start_ns <= r.end_ns <= first.end_ns
    assert net.core._kv is None  # the update's replay let it go


@pytest.fixture
def card():
    """Skips the test where no card is present (decided here, when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
@pytest.mark.parametrize("size", ["small", "full"])
def test_the_cached_steps_graph_replays_the_eager_step(card, size):
    """On the card, two batches of 21 cached steps with ``_done``'s
    resets, the update's replay and a change of the weights between them:
    the steps that replay the cache's CUDA graph give, bit for bit, what a
    copy of the core kept on the eager path gives.  ``small`` wraps its
    14-slot ring; ``full`` is the configuration's core at 64 envs."""
    kw, n = (SMALL, B) if size == "small" else ({}, 64)
    core = GTrXL(**kw, generator=torch.Generator().manual_seed(0)).to(card)
    eager = copy.deepcopy(core)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2 * (T + 1), n, core.d_model, generator=gen).to(card)
    done = torch.rand(2 * (T + 1), n, generator=gen).lt(0.1).to(card)
    carry, ecarry = core.initial_carry(n, T), eager.initial_carry(n, T)
    with torch.no_grad():
        for t in range(2 * (T + 1)):
            carry, out = core.step(x[t], carry)
            ecarry, want = eager.step(x[t], ecarry)
            eager._kv.steps = 0  # its next step runs eagerly again
            assert torch.equal(out, want), t
            carry = core.reset_carry(carry, done[t])
            ecarry = eager.reset_carry(ecarry, done[t])
            if t == T:  # the update: a replay, then new weights
                assert core._kv.graph is not None
                for c, cc in ((core, carry), (eager, ecarry)):
                    c.segment(x[:1, :2], done[:1, :2],
                              tuple(v[:2] for v in cc))
                    for p in c.parameters():
                        p.mul_(1.01)
    for ring, ering in zip(carry, ecarry):
        assert torch.equal(ring, ering)
    assert eager._kv.graph is None


def test_the_harness_weights_are_the_nets_state_dict():
    cfg = common.load_json("portbench/configs/safelife-gtrxl.json")
    net = SafeLifeGTrXLNet(layers=1)
    one = copy.deepcopy(cfg)
    one["core"]["layers"] = 1
    made = HG.make(one, 2**31 + 3, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in made.items()} == {
        k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert float(made["core.layers.0.gate2.bias"].min()) == 2.0


@pytest.mark.parametrize("bad", ["SafeLifeCNN", "SafeLifeGTrXLNet"])
def test_net_names_are_checked_against_recurrent(bad):
    from safelife_torch.training.driver import TrainerConfig, net_name
    with pytest.raises(ValueError):
        net_name(TrainerConfig(recurrent=bad == "SafeLifeCNN", net=bad))
    assert net_name(TrainerConfig(recurrent=True, net="SafeLifeGTrXLNet")) \
        == "SafeLifeGTrXLNet"
