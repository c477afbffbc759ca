"""Micro-benchmarks of the env step's components on the card (the port of
``scripts/microbench.py``).

    python -m safelife_torch.scripts.microbench        # CA and env rows
    python -m safelife_torch.scripts.microbench ops    # the ops rows

At B = 4096 on append-still, each row a chained loop of STEPS = 64
iterations (every output feeds the next), captured in one CUDA graph and
timed between CUDA events (``scripts.best_of``):

* the CA advance with a fixed spawn field (all False) and with a uniform
  field drawn on the device each iteration (``rand < 0.3`` from the
  default generator, inside the graph): kernel K5
  (``life_kernels.advance_with_field``);
* ``BatchedSafeLifeEnv.step`` without obs or reset (K1 + K3), without obs
  with auto reset (K1 + K2 with the fold) and with the 15x15 obs (K1 + K2
  with the fold and view, then the view kernel's UNPACK);
* ``ops``: what the port's step runs for six functions of the JAX
  package's step: the kernel where there is one (the action is K1; the
  observation's unpack is UNPACK), else the plain PyTorch code.  Each
  row's line names its route.

Each row's body takes its inputs, so a test can feed it the JAX script's
arrays; ``plain=True`` runs the same loop through the kernels' plain
versions (on a CUDA tensor too).
"""

import collections
import sys

import torch

from .. import resolve_device
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..env.state import find_exits
from ..levels import loader
from ..ops import _build, life, life_kernels, scoring
from ..ops import env_step_kernels as esk
from ..ops import obs as obs_ops
from . import ROW_LAUNCHES, add_u16, best_of

B = 4096
STEPS = 64
SPAWN_RATE = 0.3
VIEW = (15, 15)
CHANNELS = tuple(range(15))
ENV_ROWS = (
    ("env step (no obs, no reset)",
     dict(compute_obs=False, auto_reset=False)),
    ("env step (no obs, auto reset)",
     dict(compute_obs=False, auto_reset=True)),
    ("env step (obs 15x15, auto reset)",
     dict(view_shape=VIEW, auto_reset=True)),
)
# Each ops row's route on a CUDA tensor.
OP_ROUTES = {"current_points": "plain", "performance_score": "plain",
             "execute_action": "K1", "find_exits": "plain",
             "bank.take": "plain", "observe 15x15": "plain + UNPACK"}


def timeit(name, device, fn, *args, route=None):
    """Print and return the microseconds per step of the chained loop
    ``fn(*args)`` (STEPS iterations of B environments), in the JAX
    script's columns; records the row's launches in ``ROW_LAUNCHES``."""
    before = collections.Counter(_build.LAUNCHES)
    best = best_of(device, fn, *args)
    ROW_LAUNCHES[name] = dict(collections.Counter(_build.LAUNCHES) - before)
    via = f"  [{route}]" if route else ""
    print(f"{name:34s} {best * 1e3:9.2f} ms total  "
          f"{best / STEPS * 1e6:9.1f} us/step  "
          f"{B * STEPS / best / 1e6:8.2f} M env-steps/s{via}", flush=True)
    return best / STEPS * 1e6


def _advance(plain):
    return life.advance_board if plain else life_kernels.advance_with_field


def ca_fixed(spawn, plain=False):
    """The CA advance with the given spawn field, chained."""
    advance = _advance(plain)

    def run(board):
        for _ in range(STEPS):
            board = advance(board, spawn)
        return board
    return run


def ca_uniform(fields=None, generator=None, plain=False):
    """The CA advance, each iteration's spawn field ``rand < 0.3`` drawn
    on the board's device (or ``fields[i]``, drawn before), chained."""
    advance = _advance(plain)

    def run(board):
        for i in range(STEPS):
            field = fields[i] if fields is not None else torch.rand(
                board.shape, generator=generator,
                device=board.device) < SPAWN_RATE
            board = advance(board, field)
        return board
    return run


def env_steps(env, bank, generator=None, plain=False):
    """STEPS env steps of random actions from ``generator`` (fresh levels
    drawn each step under auto reset, as the JAX env's step does); the
    plain path takes the spawn fields the kernels draw from the same
    seed.  ``run(state) -> (state, last obs)``."""
    auto_reset = env.config.auto_reset

    def run(state):
        obs = None
        for _ in range(STEPS):
            action = torch.randint(0, 9, (state.batch_size,),
                                   generator=generator, device=env.device,
                                   dtype=torch.int32)
            fresh = (env.sample_fresh_levels(bank, state.batch_size,
                                             generator)
                     if auto_reset else None)
            if plain:
                board, goals = env.kernel_spawn_fields(
                    state, bank, env.step_seed(generator))
                state, ts = env.step(state, bank, action, spawn_board=board,
                                     spawn_goals=goals, fresh_levels=fresh)
            else:
                state, ts = env.step(state, bank, action, generator,
                                     fresh_levels=fresh)
            obs = ts.obs
        return state, obs
    return run


def observe(board, goals, agent_row, agent_col, plain=False):
    """``ops/obs.observe`` without exits at the 15x15 view: the plain crop,
    then UNPACK (its plain version with ``plain``)."""
    view = obs_ops.recenter(obs_ops.combine_board_goals(board, goals),
                            agent_row, agent_col, VIEW)
    unpack = (obs_ops.unpack_channels_plain if plain
              else obs_ops.unpack_channels)
    return unpack(view, CHANNELS)


def op_loops(bank, goals, agent_row, agent_col, orientation, action,
             plain=False):
    """The six ops rows: name -> chained ``run(x)``, each as the JAX
    script's ``op_bench`` body (a board fed back through the function's
    output, uint16 arithmetic wrapping; ``bank.take`` feeds its indices
    back)."""
    b = action.shape[0]
    dev = action.device
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    # K1's rows: action, agent row, col, orientation, game over, can exit.
    si = torch.stack([action.to(torch.int32), agent_row.to(torch.int32),
                      agent_col.to(torch.int32), orientation.to(torch.int32),
                      zeros, zeros + 1])
    apply_action = esk.action_plain if plain else esk.apply_action

    def chain(step):
        def run(x):
            for _ in range(STEPS):
                x = step(x)
            return x
        return run

    return {
        "current_points": chain(
            lambda x: add_u16(x, scoring.current_points(x, goals))),
        "performance_score": chain(
            lambda x: add_u16(x, scoring.performance_score(x, goals))),
        "execute_action": chain(lambda x: apply_action(si, x)[0]),
        "find_exits": chain(
            lambda x: add_u16(x, find_exits(x, 4)[0].sum(dtype=torch.int32))),
        "bank.take": chain(
            lambda i: (i + bank.take(i).board.to(torch.int32).sum(
                (0, 1), dtype=torch.int32)) % 100),
        "observe 15x15": chain(lambda x: add_u16(x, observe(
            x, goals, agent_row, agent_col, plain).sum(
                (1, 2, 3), dtype=torch.int32))),
    }


def load(dev):
    """append-still and its levels 0, 1, ... tiled to B environments."""
    bank = loader.load_bank("benchmarks/v1.0/append-still", device=dev)
    return bank, bank.take(torch.arange(B, device=dev) % bank.num_levels)


def op_inputs(lv, generator=None):
    """The ops rows' agents (int32) and random actions."""
    i32 = torch.int32
    dev = lv.board.device
    return (lv.agent_row.to(i32), lv.agent_col.to(i32),
            lv.orientation.to(i32),
            torch.randint(0, 9, (B,), generator=generator, device=dev,
                          dtype=i32))


def main(device=None):
    dev = resolve_device(device)
    bank, lv = load(dev)
    # A CUDA graph captures draws from the device's default generator only.
    gen = None if dev.type == "cuda" else torch.Generator().manual_seed(0)
    rows = {}
    spawn = torch.zeros(lv.board.shape, dtype=torch.bool, device=dev)
    rows["CA advance (fixed spawn field)"] = timeit(
        "CA advance (fixed spawn field)", dev, ca_fixed(spawn), lv.board)
    rows["CA advance + uniform field"] = timeit(
        "CA advance + uniform field", dev, ca_uniform(generator=gen),
        lv.board)
    for name, cfg in ENV_ROWS:
        env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
        state = env.reset_all(bank, B, torch.Generator(dev).manual_seed(0))
        rows[name] = timeit(name, dev, env_steps(env, bank, gen), state)
    return rows


def op_bench(device=None):
    dev = resolve_device(device)
    bank, lv = load(dev)
    gen = torch.Generator(dev).manual_seed(0)
    loops = op_loops(bank, lv.goals, *op_inputs(lv, gen))
    rows = {}
    for name, run in loops.items():
        x = (torch.arange(B, dtype=torch.int32, device=dev) % 100
             if name == "bank.take" else lv.board)
        rows[name] = timeit(name, dev, run, x, route=OP_ROUTES[name])
    return rows


if __name__ == "__main__":
    if sys.argv[1:2] == ["ops"]:
        op_bench()
    else:
        main()
