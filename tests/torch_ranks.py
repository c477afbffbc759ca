"""Two-rank runs of the port's data-parallel code for the CPU tests.

As a module: :func:`run_ranks` starts ``world`` worker processes of this
file joined over gloo through ``safelife_torch.parallel.distributed.
initialize`` and the SAFELIFE_* variables (as a launcher sets them), waits
for them with a deadline, kills what is left in any case, and returns each
rank's results.

As a script (``python tests/torch_ranks.py <scenario> <outdir>``): one rank
of that job.  It runs the scenario's cases, saves its results to
``<outdir>/rank<r>.pt`` with ``torch.save`` and leaves the group.  Every
collective fails after ``GROUP_TIMEOUT_S`` instead of waiting forever.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
RUN_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(scenario, world, outdir):
    port = _free_port()
    procs = []
    env = dict(os.environ, SAFELIFE_COORDINATOR=f"127.0.0.1:{port}",
               SAFELIFE_NUM_PROCS=str(world),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), scenario, outdir],
                env=dict(env, SAFELIFE_PROC_ID=str(rank)), cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs], [
            p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run_ranks(scenario, outdir, world=2):
    """Run ``scenario`` on ``world`` gloo ranks; returns [rank 0's results,
    rank 1's, ...].  A port taken between choosing and binding it gets one
    retry on a fresh port."""
    for attempt in range(2):
        outs, rcs = _launch(scenario, world, str(outdir))
        if all(rc == 0 for rc in rcs):
            break
        clash = any("EADDRINUSE" in o or "Address already in use" in o
                    for o in outs)
        if not clash or attempt:
            raise AssertionError("a rank failed:\n" + "\n".join(
                f"--- rank {r} (rc {rc}) ---\n{o[-4000:]}"
                for r, (o, rc) in enumerate(zip(outs, rcs))))
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

# The trainer scenario: a 13x13 synth bank, 16 environments, 2 batches.
TRAIN_ENVS, TRAIN_BATCHES = 16, 2


def trainer_configs(logdir=None):
    from safelife_torch.training import driver, ppo
    tc = driver.TrainerConfig(
        num_envs=TRAIN_ENVS, view_shape=(17, 17), time_limit=5,
        report_every=32, save_every=64, record_videos=False, seed=3,
        logdir=logdir)
    pc = ppo.PPOConfig(steps_per_env=4, num_minibatches=2,
                       epochs_per_batch=2, data_shards=2)
    return tc, pc


def trainer_net():
    """The trainer scenario's net: float32 throughout, so that one process
    and two ranks differ only by float32 summation order (the default
    bfloat16 trunk rounds its gradients to 8 bits, which Adam then
    amplifies)."""
    from safelife_torch.training import model
    return model.SafeLifeCNN(view_shape=(17, 17), compute_dtype=torch.float32,
                             generator=torch.Generator().manual_seed(3))


ROLLOUT_ENVS = 16


def rollout_case(spawners, env, actions_seed=5, steps=6):
    """A rollout of ``env``'s share of ROLLOUT_ENVS environments on a
    13x13 synth bank (with spawners or without) from a reset of seed 2,
    with injected actions; returns its env-side fields and the net's
    outputs."""
    from safelife_torch.env import wrappers
    from safelife_torch.levels import synth
    from safelife_torch.training import model, ppo
    index, count = wrappers.unwrap_env(env).shard
    bank = synth.synth_bank(4, h=13, w=13, spawners=spawners, device="cpu")
    gen = torch.Generator().manual_seed(2)
    cfg = ppo.PPOConfig(steps_per_env=steps)
    local = ROLLOUT_ENVS // count
    state = env.reset_all(bank, local, gen)
    actions = torch.as_tensor(np.random.RandomState(actions_seed).randint(
        0, 9, (steps, ROLLOUT_ENVS)))[:, index * local:(index + 1) * local]
    net = model.SafeLifeCNN(view_shape=(17, 17), compute_dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0))
    _, obs, traj, eps = ppo.rollout(cfg, net, env, bank, state,
                                    env.observe(state), gen, actions=actions)
    return dict(obs=traj.obs, reward=traj.reward, done=traj.done,
                final_obs=obs, old_pi=traj.old_pi, value=traj.value,
                level0=wrappers.unwrap(state).level_idx,
                **{f"eps.{k}": v for k, v in eps.items()})


def curriculum_factory(rank):
    """A bank factory seeded by ``rank``: each call builds 4 fresh 13x13
    synth levels of the next seeds its rank draws."""
    from safelife_torch.levels import loader, synth
    seeds = np.random.RandomState(10 + rank)

    def factory():
        return loader.build_bank(
            [synth.simple_level(13, 13, seed=int(s))
             for s in seeds.randint(0, 10**6, 4)], device="cpu")
    return factory


def curriculum_case(mesh, bank):
    """A Trainer(mesh=) on ``bank`` (rank 0's) whose schedule switches to
    its rank's ``curriculum_factory`` after batch 1 and refreshes from it
    every 2 batches (rank 0's thread starts after batch 2 and the fresh
    bank is swapped in at batch 3's report; each rank joins its thread,
    if any, between the batches).  Returns each batch's bank arrays,
    parameters and global step."""
    from safelife_torch.training import driver
    tc, pc = trainer_configs()
    batch = TRAIN_ENVS * pc.steps_per_env
    tr = driver.Trainer(
        dataclasses.replace(tc, fresh_levels_every=2 * batch), pc,
        bank=bank if mesh.rank == 0 else None, mesh=mesh, net=trainer_net(),
        bank_schedule=[(batch, curriculum_factory(mesh.rank))])
    stages = []
    for k in range(1, 4):
        tr.train(total_steps=k * batch)
        stages.append(dict(
            bank=tr.bank.to_numpy(), step=tr.global_step(),
            params={k: v.clone() for k, v in tr.net.state_dict().items()},
            refreshing=tr._refresher is not None))
        if tr._refresher is not None:
            tr._refresher[0].join(timeout=GROUP_TIMEOUT_S)
    return stages


class GivenNet(torch.nn.Module):
    """A stand-in policy whose outputs are its parameters: ``net(rows)``
    returns the logits and values of the (T, M) global rows ``rows``, so
    the loss's gradient reaches them directly."""

    def __init__(self, logits, values):
        super().__init__()
        self.logits = torch.nn.Parameter(torch.as_tensor(logits))
        self.values = torch.nn.Parameter(torch.as_tensor(values))

    def forward(self, rows):
        t = torch.arange(rows.shape[0])[:, None]
        return self.logits[t, rows], self.values[t, rows]


# Loss cases of the global-mean test: option sets under which a rank's own
# mean and the global mean give different gradients.  The first rank's rows
# have peaked policies (pseudo-entropy about 0.2), the second's nearly
# uniform ones (about 0.88): an entropy clip of 0.6 lies between them.
MEAN_CASES = {
    "clip-straddle": dict(entropy_grad=True, entropy_clip=0.6),
    "per-batch": dict(value_grad_rescaling="per_batch"),
    "per-batch-entropy-grad": dict(value_grad_rescaling="per_batch",
                                   entropy_grad=True, entropy_clip=0.6),
}
MEAN_T, MEAN_B, MEAN_MB = 4, 16, 2


def mean_case_data(seed=0):
    """Logits, values and a batch (T, B) for the global-mean test, and the
    per-shard permutations of its one minibatch step."""
    rng = np.random.RandomState(seed)
    t, b = MEAN_T, MEAN_B
    scale = np.where(np.arange(b) < b // 2, 6.0, 0.1)[None, :, None]
    logits = (rng.normal(size=(t, b, 9)) * scale).astype(np.float32)
    values = rng.normal(size=(t, b, 1)).astype(np.float32)
    batch = dict(
        rows=np.broadcast_to(np.arange(b), (t, b)).copy(),
        action=rng.randint(0, 9, (t, b)),
        old_pi=rng.uniform(0.05, 0.5, (t, b)).astype(np.float32),
        old_value=rng.normal(0, 0.2, (t, b, 1)).astype(np.float32),
        returns=rng.normal(size=(t, b, 1)).astype(np.float32),
        advantages=rng.normal(size=(t, b, 1)).astype(np.float32))
    perms = np.stack([rng.permutation(b // 2) for _ in range(2)])
    return logits, values, batch, perms


def mean_case_grads(case, rows, mesh):
    """(loss, gradients of logits, values and spe) of the minibatch
    ``rows`` (global indices) under ``case``; with a ``mesh`` the loss
    takes the global means and the gradients are averaged over it."""
    from safelife_torch.training import ppo
    logits, values, batch, _ = mean_case_data()
    cfg = ppo.PPOConfig(**MEAN_CASES[case])
    net = GivenNet(logits, values)
    spe = torch.nn.Parameter(torch.tensor(0.7))
    data = [torch.as_tensor(batch[k])[:, rows] for k in (
        "rows", "action", "old_pi", "old_value", "returns", "advantages")]
    loss, _ = ppo.ppo_loss(cfg, net, spe, *data, mesh=mesh)
    loss.backward()
    params = [net.logits, net.values, spe]
    if mesh is not None:
        mesh.average_gradients(params)
    return loss.detach(), [p.grad for p in params]


def scenario_train(mesh, outdir):
    """The global-mean gradients, a Trainer of 2 batches with a checkpoint
    and its restore, a recurrent one, one with a bank switch and a
    refresh, the sharded rollouts, collective_stats of one update, and the
    halo exchange."""
    from safelife_torch.levels import synth
    from safelife_torch.training import driver
    r, world = mesh.rank, mesh.world_size
    out = {"rank": r, "world": world}

    _, _, _, perms = mean_case_data()
    own = perms[r, :MEAN_B // 2 // MEAN_MB] + r * (MEAN_B // 2)
    for case in MEAN_CASES:
        out[f"mean.{case}"] = mean_case_grads(case, own, mesh)
        out[f"naive.{case}"] = mean_case_grads(case, own, None)

    # The trainer, through the SAFELIFE_* launch; no tensorboard writer
    # (its import alone takes seconds), the YAML log and checkpoints kept.
    driver.make_summary_writer = lambda logdir: None
    tc, pc = trainer_configs(os.path.join(outdir, "run"))
    bank = synth.synth_bank(4, h=13, w=13, device="cpu")
    # Rank 0 evaluates on the bank at steps 64 and 128; the others wait.
    tc = dataclasses.replace(tc, eval_suite=bank, eval_every=64,
                             eval_side_effect_samples=2)
    tr = driver.Trainer(tc, pc, bank=bank if r == 0 else None, mesh=mesh,
                        net=trainer_net())
    out["level0"] = driver.W.unwrap(tr.env_state).level_idx.clone()
    reports = []
    tr.train(total_steps=TRAIN_BATCHES * TRAIN_ENVS * pc.steps_per_env,
             progress_fn=lambda step, m: reports.append((step, m)))
    out["board_shape"] = tuple(driver.W.unwrap(tr.env_state).board.shape)
    out["global_step"] = tr.global_step()
    out["params"] = {k: v.clone() for k, v in tr.net.state_dict().items()}
    out["spe"] = tr.train_state.spe.detach().clone()
    out["reports"] = reports
    out["checkpoints"] = sorted(os.listdir(os.path.join(outdir, "run",
                                                        "checkpoints")))
    with open(os.path.join(outdir, "run", "eval.yaml")) as fh:
        out["eval_records"] = sum(line.startswith("- {") for line in fh)
    again = driver.Trainer(tc, pc, bank=bank if r == 0 else None, mesh=mesh,
                           net=trainer_net())
    out["restored"] = again.restore_checkpoint()
    out["restored_params"] = dict(again.net.state_dict())
    out["restored_step"] = again.global_step()

    # The recurrent trainer: one batch.
    recurrent = driver.Trainer(
        dataclasses.replace(tc, logdir=None, recurrent=True), pc, bank=bank,
        mesh=mesh)
    recurrent.train(total_steps=TRAIN_ENVS * pc.steps_per_env)
    out["recurrent_params"] = dict(recurrent.net.state_dict())
    out["recurrent_carry"] = recurrent.carry[0].shape
    out["curriculum"] = curriculum_case(mesh, bank)

    # Each rank's shard of a rollout with injected actions.
    for spawners in (False, True):
        env = driver.make_training_env(tc, "cpu", shard=(r, world))
        out[f"rollout.{spawners}"] = rollout_case(spawners, env)
    # collective_stats of one update (one epoch of one minibatch) at
    # TRAIN_ENVS environments a rank.
    out["stats"] = update_stats(mesh, TRAIN_ENVS * world)
    out["n_params"] = sum(p.numel() for p in tr.train_state.optimizer.params)
    before = mesh.collective_bytes.copy()
    out["halo"] = halo_case(mesh)
    out["halo"]["bytes"] = dict(mesh.collective_bytes - before)
    return out


def update_stats(mesh, num_envs):
    """collective_stats of one PPO update (one Adam step on one minibatch)
    of a Trainer of ``num_envs`` environments on ``mesh``."""
    from safelife_torch.levels import synth
    from safelife_torch.parallel import distributed
    from safelife_torch.training import driver, ppo
    world = mesh.world_size
    tc = driver.TrainerConfig(num_envs=num_envs, view_shape=(17, 17),
                              record_videos=False)
    pc = ppo.PPOConfig(steps_per_env=4, num_minibatches=1,
                       epochs_per_batch=1, data_shards=world)
    bank = synth.synth_bank(4, h=13, w=13, device="cpu")
    tr = driver.Trainer(tc, pc, bank=bank, mesh=mesh, device="cpu")
    _, _, traj, _ = ppo.rollout(pc, tr.net, tr.env, tr.bank, tr.env_state,
                                tr.obs, tr.generator)
    ret, adv = ppo.compute_gae(pc, traj.reward, traj.done, traj.value)
    stats = distributed.collective_stats(
        lambda: tr.ppo.update(tr.train_state, traj, ret, adv, tr.generator),
        mesh)
    del stats["result"]
    return stats


def halo_case(mesh):
    """advance_board_sharded on each rank's rows: a 64x32 soup with
    spawners near the shard borders and a spawn field, one step; and two
    blinkers across the borders of a 32x16 board, 4 steps."""
    from safelife_torch.parallel import halo
    board, spawn = halo_soup()
    out = {"soup": halo.gather_rows(halo.advance_board_sharded(
        halo.shard_rows(board, mesh), halo.shard_rows(spawn, mesh), mesh),
        mesh)}
    block = halo.shard_rows(blinkers(), mesh)
    none = torch.zeros_like(block, dtype=torch.bool)
    for _ in range(4):
        block = halo.advance_board_sharded(block, none, mesh)
    out["blinkers"] = halo.gather_rows(block, mesh)
    return out


def halo_soup(h=64, w=32, seed=0):
    """``tests/test_halo.py``'s soup: life, walls, trees and spawners, and
    a spawn field of rate 0.2, as uint16 and bool tensors."""
    from safelife_torch import cells as C
    rng = np.random.RandomState(seed)
    board = np.zeros((h, w), np.uint16)
    board[rng.rand(h, w) < 0.3] = C.LIFE | C.COLOR_G
    board[rng.rand(h, w) < 0.05] = C.WALL
    board[rng.rand(h, w) < 0.03] = C.TREE
    board[rng.rand(h, w) < 0.02] = C.SPAWNER
    spawn = rng.rand(h, w) < 0.2
    return torch.as_tensor(board), torch.as_tensor(spawn)


def blinkers(h=32, w=16):
    """``tests/test_halo.py``'s two blinkers, across shard borders."""
    from safelife_torch import cells as C
    board = np.zeros((h, w), np.uint16)
    board[3, 4:7] = C.LIFE
    board[15:18, 8] = C.LIFE
    return torch.as_tensor(board)


SCENARIOS = {"train": scenario_train}


def main():
    torch.set_num_threads(1)
    scenario, outdir = sys.argv[1:]
    from safelife_torch.parallel import distributed
    assert distributed.initialize(device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        mesh = distributed.make_global_mesh(device="cpu")
        out = SCENARIOS[scenario](mesh, outdir)
        torch.save(out, os.path.join(outdir, f"rank{mesh.rank}.pt"))
        mesh.barrier()
    finally:
        distributed.shutdown()
    print("OK")


if __name__ == "__main__":
    main()
