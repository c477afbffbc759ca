"""Drive the PyTorch port of SafeLife on one CUDA card and hold its
hand-written kernels to their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each an assertion that ends the run on failure:

1. build every kernel from ``safelife_torch/csrc`` (one ``nvcc`` each, in
   parallel);
2. print the card's name and power limit (``nvidia-smi``);
3. each kernel against its plain version on the card, bit for bit: K4 on
   spawnless soups, K1 on random states and all nine actions, K2 (fold and
   view) and K3 (no reset) along rollouts on append-still and prune-still
   with resets;
4. a 12-step rollout through the kernels against the plain env path;
5. the main path: the append-still bank loaded on the card and 65536
   environments stepped 160 times (fresh levels every 20 steps, the
   observation consumed every step), then the evaluation path (no
   auto-reset) for 20 steps, each with the launch counts read around it;
6. each kernel's time at the main path's shapes beside its bound and its
   plain version's time, and a profile of 20 main-path steps (device time
   by kernel, idle share);
7. one JSON line listing the kernels, and last the result line.

Exits nonzero, printing no result, when no CUDA device is present.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from safelife_torch import cells as C
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader
from safelife_torch.ops import _build, env_step_kernels as esk, life_kernels

MAIN_BATCH = 65536
MAIN_STEPS = 160
EVAL_STEPS = 20
ROLLOUT = 20
VIEW = (15, 15)
SUITE = "benchmarks/v1.0/append-still"
# 32-bit operations outside the tensor cores, H100 SXM data sheet.
PEAK_OPS = 67e12
# Integer operations per board cell, counted from the kernel sources (a
# lower bound: loads, stores and loop control are left out).
OPS_PER_CELL = {"K1_action": 6, "K2_advance_fold": 75,
                "K3_advance_noreset": 70, "K4_advance_spawnless": 40}
KERNELS = {
    "K1_action": ("safelife_torch/csrc/env_step_kernels.cu",
                  "safelife_tpu/ops/env_step_pallas.py:177"),
    "K2_advance_fold": ("safelife_torch/csrc/env_step_kernels.cu",
                        "safelife_tpu/ops/env_step_pallas.py:250"),
    "K3_advance_noreset": ("safelife_torch/csrc/env_step_kernels.cu",
                           "safelife_tpu/ops/env_step_pallas.py:250"),
    "K4_advance_spawnless": ("safelife_torch/csrc/life_kernels.cu",
                             "safelife_tpu/ops/life_pallas.py:489"),
}


def memory_rate(name):
    """The card's memory bandwidth in bytes/s, from its data sheet."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


def max_abs_err(got, want):
    """Largest absolute difference over matching tensors (0 = bit-equal)."""
    err = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        err = max(err, (g.to(torch.float64) - w.to(torch.float64)).abs()
                  .max().item() if g.numel() else 0)
    return err


def assert_bit_equal(got, want, what):
    err = max_abs_err(got, want)
    assert err == 0, f"{what}: kernel differs from plain (max abs err {err})"
    return err


def soup(rng, shape, flags, density=0.15):
    board = np.zeros(shape, np.uint16)
    for f in flags:
        board |= np.uint16(f) * (rng.random(shape) < density).astype(np.uint16)
    return board


SPAWNLESS_FLAGS = (C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
                   C.PRESERVING, C.INHIBITING, C.EXIT, C.COLOR_R, C.COLOR_G,
                   C.COLOR_B, C.PULLABLE)


def action_inputs(rng, shape, dev):
    """A random board with an agent on every board, and si rows 0-5."""
    h, w, b = shape
    board = soup(rng, shape, SPAWNLESS_FLAGS + (C.SPAWNING,))
    ar = rng.randint(0, h, b)
    ac = rng.randint(0, w, b)
    board[ar, ac, np.arange(b)] = C.PLAYER | C.COLOR_G
    rows = [np.arange(b) % 9, ar, ac, rng.randint(0, 4, b),
            rng.random(b) < 0.1, rng.random(b) < 0.5]
    si = np.concatenate([np.stack(rows), np.zeros((3, b))]).astype(np.int32)
    return (torch.as_tensor(si, device=dev),
            torch.as_tensor(board, device=dev))


def flatten(prefix, obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten(f"{prefix}{f.name}.", v))
        elif v is not None:
            out[prefix + f.name] = v
    return out


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version.
# ---------------------------------------------------------------------------

def check_k4(dev):
    rng = np.random.RandomState(1)
    for shape, steps in (((26, 26, 4096), 6), ((7, 3, 300), 4)):
        board = torch.as_tensor(soup(rng, shape, SPAWNLESS_FLAGS), device=dev)
        for step in range(steps):
            got = life_kernels.advance_spawnless(board)
            assert_bit_equal([got], [life_kernels.advance_spawnless_plain(
                board)], f"K4 {shape} step {step}")
            board = got
    print(f"K4 advance_spawnless == plain: (26,26,4096) x 6 steps, "
          f"(7,3,300) x 4 steps")


def check_k1(dev):
    rng = np.random.RandomState(2)
    for shape in ((26, 26, 4096), (3, 5, 1001)):
        for trial in range(3):
            si, board = action_inputs(rng, shape, dev)
            assert_bit_equal(esk.apply_action(si, board),
                             esk.action_plain(si, board),
                             f"K1 {shape} trial {trial}")
    print("K1 action == plain: random states, all nine actions, "
          "(26,26,4096) and (3,5,1001)")


def check_k2_k3(dev):
    gen = torch.Generator(device=dev)
    for suite in ("append-still", "prune-still"):
        bank = loader.load_bank(f"benchmarks/v1.0/{suite}", device=dev)
        for b, cfg in ((4096, dict(time_limit=6, view_shape=VIEW)),
                       (4096, dict(time_limit=6, view_shape=(33, 33))),
                       (4096, dict(time_limit=6, compute_obs=False)),
                       (4096, dict(time_limit=6, auto_reset=False)),
                       (1001, dict(time_limit=6, view_shape=(9, 40)))):
            env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
            gen.manual_seed(3)
            state = env.reset_all(bank, b, gen)
            fresh = env.sample_fresh_levels(bank, b, gen)
            resets = 0
            for step in range(10):
                action = torch.randint(0, 9, (b,), generator=gen,
                                       device=dev, dtype=torch.int32)
                kw = env.fused_inputs(state, bank, action,
                                      fresh[1] if env.config.auto_reset
                                      else None)
                assert_bit_equal(esk.fused_step(**kw),
                                 esk.fused_step_plain(**kw),
                                 f"K1+K2/K3 {suite} {cfg} step {step}")
                state, ts = env.step(state, bank, action, fresh_levels=fresh)
                resets += int(ts.done.sum())
            assert resets > 0
            print(f"K2/K3 advance == plain: {suite} B={b} {cfg}, 10 steps, "
                  f"{resets} resets")


# ---------------------------------------------------------------------------
# Phase 4: kernel rollout against the plain rollout.
# ---------------------------------------------------------------------------

def rollout(env, bank, actions, dev):
    b = actions.shape[1]
    state = env.reset_to_levels(bank, torch.arange(b, device=dev)
                                % bank.num_levels)
    fresh = env.fresh_levels(bank, (torch.arange(b, device=dev) * 7 + 3)
                             % bank.num_levels)
    trace = []
    for t in range(actions.shape[0]):
        state, ts = env.step(state, bank, actions[t], fresh_levels=fresh)
        trace.append((state, ts))
    return trace


def check_rollouts(dev):
    b = 256
    actions = torch.as_tensor(
        np.random.RandomState(9).randint(0, 9, (12, b)), device=dev)
    for suite in ("append-still", "prune-still"):
        bank = loader.load_bank(f"benchmarks/v1.0/{suite}", device=dev)
        for cfg in (dict(time_limit=6, auto_reset=True),
                    dict(time_limit=20, auto_reset=False)):
            kern = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
            plain = BatchedSafeLifeEnv(EnvConfig(use_kernels=False, **cfg),
                                       device=dev)
            assert kern.uses_kernels() and not plain.uses_kernels()
            for t, ((ks, kt), (ps, pt)) in enumerate(zip(
                    rollout(kern, bank, actions, dev),
                    rollout(plain, bank, actions, dev))):
                got = {**flatten("state.", ks), **flatten("ts.", kt)}
                want = {**flatten("state.", ps), **flatten("ts.", pt)}
                assert got.keys() == want.keys()
                for name in want:
                    g, w = got[name], want[name]
                    if cfg["auto_reset"] and name in (
                            "ts.state_before_reset.board",
                            "ts.state_before_reset.goals"):
                        # The kernel path folds the reset into these two.
                        g, w = (x.to(torch.int32)[..., ~pt.done]
                                for x in (g, w))
                    assert_bit_equal([g], [w],
                                     f"{suite} {cfg} step {t} {name}")
            print(f"rollout kernels == plain: {suite} B={b} {cfg}, 12 steps")


# ---------------------------------------------------------------------------
# Phase 5: the main path and the evaluation path.
# ---------------------------------------------------------------------------

def main_path(dev):
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    bank = loader.load_bank(SUITE, device=dev)
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_all(bank, MAIN_BATCH, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(MAIN_STEPS // ROLLOUT):
        fresh = env.sample_fresh_levels(bank, MAIN_BATCH, gen)
        for _ in range(ROLLOUT):
            action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen,
                                   device=dev, dtype=torch.int32)
            state, ts = env.step(state, bank, action, fresh_levels=fresh)
            # Consume the observation: the value of obs.to(int32).sum().
            total += ts.obs.sum(dtype=torch.int32) + ts.reward.sum()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    steps = MAIN_STEPS * MAIN_BATCH

    assert ts.obs.shape == (MAIN_BATCH, *VIEW, 15)
    assert ts.obs.dtype == torch.uint8 and int(ts.obs.max()) <= 1
    assert torch.isfinite(ts.reward).all() and torch.isfinite(total)
    assert int(state.num_steps) > 0
    assert int(state.episodes_started) >= MAIN_BATCH
    assert launches.get("K1_action") == MAIN_STEPS, launches
    assert launches.get("K2_advance_fold") == MAIN_STEPS, launches
    assert launches.get("K4_advance_spawnless", 0) >= 1, launches
    print(f"main path: {SUITE} B={MAIN_BATCH} view={VIEW} {MAIN_STEPS} "
          f"steps: load+reset {t1 - t0:.3f} s, steps {t2 - t1:.3f} s "
          f"({(t2 - t1) / MAIN_STEPS * 1e3:.3f} ms/step), "
          f"{steps / (t2 - t1):.0f} env-steps/s; launches {launches}; "
          f"episodes completed {int(state.episodes_completed)}")

    _build.LAUNCHES.clear()
    eval_env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=VIEW, auto_reset=False, sequential_levels=True),
        device=dev)
    eval_state = eval_env.reset_all(bank, MAIN_BATCH)
    for _ in range(EVAL_STEPS):
        action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen,
                               device=dev, dtype=torch.int32)
        eval_state, eval_ts = eval_env.step(eval_state, bank, action)
        assert eval_ts.obs.shape == (MAIN_BATCH, *VIEW, 15)
    torch.cuda.synchronize()
    eval_launches = dict(_build.LAUNCHES)
    assert eval_launches.get("K3_advance_noreset") == EVAL_STEPS, eval_launches
    print(f"evaluation path (no auto-reset): B={MAIN_BATCH} {EVAL_STEPS} "
          f"steps; launches {eval_launches}")
    launches["K3_advance_noreset"] = eval_launches["K3_advance_noreset"]
    return bank, env, state, fresh, gen, steps / (t2 - t1), launches


# ---------------------------------------------------------------------------
# Phase 6: kernel timings at the main path's shapes.
# ---------------------------------------------------------------------------

def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_timings(bank, env, state, fresh, gen, rate):
    """{kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    dev = state.board.device
    h, w, b = state.board.shape
    cells = h * w * b
    action = torch.randint(0, 9, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    fold = esk.kernel_args(**env.fused_inputs(state, bank, action, fresh[1]))
    noreset = esk.kernel_args(**dict(env.fused_inputs(state, bank, action),
                                     time_limit=0, obs_view=None))
    si, board = fold["si"], fold["board"]
    board1, act_i = esk.apply_action(si, board)

    def adv(args, fn):
        return lambda: fn(args["si"], args["sf"], act_i, args["obs_i"],
                          board1, args["goals"], args["init_board"],
                          args["fresh"], args["time_limit"], args["obs_view"],
                          args["remove_white_goals"])

    done = ((si[7] + 1 > fold["time_limit"]) | (si[4] != 0) | (act_i[3] != 0))
    n_done = int(done.sum())
    fold_out = adv(fold, esk.advance)()
    noreset_out = adv(noreset, esk.advance)()
    runs = {
        "K1_action": (lambda: esk.apply_action(si, board),
                      lambda: esk.action_plain(si, board),
                      nbytes(board, si, board1, act_i)),
        "K2_advance_fold": (
            adv(fold, esk.advance), adv(fold, esk.advance_plain),
            nbytes(fold["si"], fold["sf"], act_i, fold["obs_i"], board1,
                   fold["goals"], fold["init_board"], *fold_out)
            + 3 * h * w * n_done * 2),
        "K3_advance_noreset": (
            adv(noreset, esk.advance), adv(noreset, esk.advance_plain),
            nbytes(noreset["si"], noreset["sf"], board1, noreset["goals"],
                   noreset["init_board"], *noreset_out)),
        "K4_advance_spawnless": (
            lambda: life_kernels.advance_spawnless(board1),
            lambda: life_kernels.advance_spawnless_plain(board1),
            2 * nbytes(board1)),
    }
    out = {}
    for name, (kernel, plain, moved) in runs.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = assert_bit_equal(got, want, f"{name} at the main shapes")
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 5)
        bytes_ms = moved / rate * 1e3
        ops_ms = OPS_PER_CELL[name] * cells / PEAK_OPS * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        out[name] = (err, ms, plain_ms, max(bytes_ms, ops_ms), bound_by)
        print(f"timing {name}: max abs err {err} vs plain; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"bound {max(bytes_ms, ops_ms):.4f} ms by {bound_by} "
              f"({moved / 1e6:.1f} MB), {bytes_ms / ms:.1%} of the "
              f"memory rate; (H,W,B)=({h},{w},{b}), {n_done} resetting")
    return out


def profile_main_path(env, bank, state, gen, steps=ROLLOUT):
    """Device time by kernel over ``steps`` main-path steps, and the share
    of the host-clock wall time in which the device ran no kernel."""
    from torch.profiler import ProfilerActivity, profile
    b = state.batch_size
    fresh = env.sample_fresh_levels(bank, b, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            action = torch.randint(0, 9, (b,), generator=gen,
                                   device=state.device, dtype=torch.int32)
            state, ts = env.step(state, bank, action, fresh_levels=fresh)
            ts.obs.sum(dtype=torch.int32) + ts.reward.sum()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not busy_ms:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile: {steps} main-path steps, wall {wall_ms:.3f} ms "
          f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.1%}")
    print("  by kernel:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {name[:90]}")
    print("  by the torch op that launched it:")
    ops = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    for ms, name in sorted(ops, reverse=True)[:10]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {name}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} "
          f"libraries (one nvcc each, in parallel)")
    for name, (path, log) in built.items():
        print(f"  {name}: {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    rate = memory_rate(kind)

    print("kernels against their plain versions: tolerance 0, bit for bit "
          "(integer state; the reward is a float32 difference of integers)")
    check_k4(dev)
    check_k1(dev)
    check_k2_k3(dev)
    check_rollouts(dev)
    bank, env, state, fresh, gen, steps_per_s, launches = main_path(dev)
    print(f"env-steps/s {steps_per_s:.0f} on {smi}")
    timings = kernel_timings(bank, env, state, fresh, gen, rate)
    profile_main_path(env, bank, state, gen)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0), max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
