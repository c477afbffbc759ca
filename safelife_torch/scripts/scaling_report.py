"""Data-parallel scaling profile of the full PPO train batch (the port of
``scripts/scaling_report.py``).

    python -m safelife_torch.scripts.scaling_report [--sizes 1 2 4 8]
        [--device cpu] [--out results/torch/scaling.json]

For each size n, n ranks (processes joined through
``parallel.distributed.initialize``) each run one ``PPO.train_batch`` of
``ENVS_PER_DEVICE`` environments under
``parallel.distributed.collective_stats`` and report:

* each rank's FLOPs (``FlopCounterMode``: the matrix products and
  convolutions, forward and backward), which must stay flat in n (the
  sharding divides the work);
* the bytes each kind of collective delivered to the rank in the batch:
  the gradient all-reduce, 12 syncs of (parameters + 16 bytes of the
  loss's four means), and nothing else;
* the weak-scaling efficiency model ``dp_efficiency_model`` (H100
  defaults) at the compile size and at the production 2048 environments
  a device.

Ranks run gloo on the CPU (``--device cpu``); on a card, one NCCL rank at
n = 1, else gloo ranks sharing it.  Wall-clock weak scaling needs n real
cards: ``parallel.distributed.scaling_report`` measures it there.

Two counts differ from the JAX script's: XLA's cost analysis counts
elementwise work, which ``FlopCounterMode`` does not (``fwd_flops_per_obs``
is lower here); and the JAX script read one all-reduce from the static
rolled program (one sync), where this counts the bytes one batch moves
(``allreduce_bytes_per_batch``; ``allreduce_bytes_per_sync`` is that over
the 12 syncs).  The report keeps the JAX script's fields
(``hlo_flops_per_device`` holds the counted FLOPs) and goes to
``results/torch/scaling.json``, never to the JAX round's ``SCALING.json``.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch

from .. import resolve_device
from . import RESULTS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VIEW = (25, 25)
ENVS_PER_DEVICE = 32         # the JAX script's compile size
PROD_ENVS_PER_DEVICE = 2048  # production envs/device for the efficiency gate
# Every collective of a rank's group fails after GROUP_TIMEOUT_S; the
# ranks of one size are killed after RANKS_TIMEOUT_S.
GROUP_TIMEOUT_S = 300
RANKS_TIMEOUT_S = 600


def _train_batch_stats(mesh, envs, recurrent):
    """``collective_stats`` of one ``train_batch`` of ``envs``
    environments on this rank of ``mesh``."""
    from ..env.env import BatchedSafeLifeEnv, EnvConfig
    from ..levels import synth
    from ..parallel import distributed
    from ..training import model, ppo

    device, world = mesh.device, mesh.world_size
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW, time_limit=200),
                             device=device, shard=(mesh.rank, world))
    bank = synth.synth_bank(8, h=26, w=26, spawners=True, device=device)
    cfg = ppo.PPOConfig(data_shards=world)
    net_class = model.SafeLifeLSTMNet if recurrent else model.SafeLifeCNN
    # Every rank makes the same parameters from the same seed.
    net = net_class(view_shape=VIEW, n_gamma=cfg.n_gamma,
                    generator=torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator(device).manual_seed(0)
    state = env.reset_all(bank, envs, gen)
    obs = env.observe(state)
    ts = ppo.init_train_state(cfg, net)
    if recurrent:
        learner = ppo.RecurrentPPO(cfg, env, mesh=mesh)
        carry = net.initial_carry(envs)
        stats = distributed.collective_stats(lambda: learner.train_batch(
            ts, state, obs, carry, bank, gen), mesh)
    else:
        learner = ppo.PPO(cfg, env, mesh=mesh)
        stats = distributed.collective_stats(lambda: learner.train_batch(
            ts, state, obs, bank, gen), mesh)
    return dict(rank=mesh.rank, flops=stats["flops"],
                collective_bytes=stats["collective_bytes"],
                n_params=sum(p.numel() for p in ts.optimizer.params))


def rank_profile(cfg):
    """One rank (in its own process): join the group, then profile one
    ``train_batch`` of each learner in ``cfg["kinds"]`` (``"cnn"``,
    ``"lstm"``); returns kind -> its counts."""
    from ..parallel import distributed

    device = torch.device(cfg["device"])
    distributed.initialize(
        f"127.0.0.1:{cfg['port']}", cfg["world"], cfg["rank"],
        backend=cfg["backend"], device=device, timeout=GROUP_TIMEOUT_S)
    try:
        mesh = distributed.make_global_mesh(device=device)
        out = {kind: _train_batch_stats(mesh, cfg["envs"], kind == "lstm")
               for kind in cfg["kinds"]}
        mesh.barrier()
        return out
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, envs, kinds, device, outdir, timeout):
    port = _free_port()
    backend = "nccl" if device == "cuda" and world == 1 else "gloo"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for rank in range(world):
            cfg = dict(world=world, rank=rank, port=port, envs=envs,
                       kinds=kinds, backend=backend,
                       device="cuda:0" if device == "cuda" else device,
                       out=os.path.join(outdir, f"rank{rank}.json"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "safelife_torch.scripts.scaling_report",
                 "--rank", json.dumps(cfg)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        return logs, [p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def profiles(n, envs_per_device=ENVS_PER_DEVICE, device=None,
             kinds=("cnn", "lstm"), timeout=RANKS_TIMEOUT_S):
    """One ``train_batch`` of each learner in ``kinds`` (``"cnn"``:
    ``SafeLifeCNN`` and ``PPO``; ``"lstm"``: ``SafeLifeLSTMNet`` and
    ``RecurrentPPO``) on each of ``n`` ranks, one launch of the ranks;
    returns kind -> each rank's FLOPs, collective bytes by kind and
    parameter count, rank 0 first.  A port taken between choosing and
    binding it gets one retry."""
    device = resolve_device(device).type
    with tempfile.TemporaryDirectory() as outdir:
        for attempt in range(2):
            logs, rcs = _launch(n, envs_per_device, list(kinds), device,
                                outdir, timeout)
            if all(rc == 0 for rc in rcs):
                break
            clash = any("EADDRINUSE" in log or "Address already in use" in log
                        for log in logs)
            if not clash or attempt:
                raise RuntimeError("a rank failed:\n" + "\n".join(
                    f"--- rank {r} (rc {rc}) ---\n{log[-4000:]}"
                    for r, (log, rc) in enumerate(zip(logs, rcs))))
        ranks = []
        for r in range(n):
            with open(os.path.join(outdir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    return {kind: [r[kind] for r in ranks] for kind in kinds}


def build(n, envs_per_device=ENVS_PER_DEVICE, device=None,
          timeout=RANKS_TIMEOUT_S):
    """The ``PPO.train_batch`` profile on ``n`` ranks (:func:`profiles`)."""
    return profiles(n, envs_per_device, device, ("cnn",), timeout)["cnn"]


def build_recurrent(n, envs_per_device=ENVS_PER_DEVICE, device=None,
                    timeout=RANKS_TIMEOUT_S):
    """The ``RecurrentPPO.train_batch`` profile on ``n`` ranks: its
    minibatches shuffle whole environments within a shard, so it too must
    move nothing but gradients."""
    return profiles(n, envs_per_device, device, ("lstm",), timeout)["lstm"]


def fwd_flops_per_obs(view=VIEW):
    """Forward FLOPs of ``SafeLifeCNN`` per observation: one forward at
    (1, *view, 15) under ``FlopCounterMode`` (its convolutions and dense
    layers; XLA's count, the JAX script's, adds the elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..training.model import SafeLifeCNN

    net = SafeLifeCNN(view_shape=tuple(view), n_gamma=1,
                      generator=torch.Generator().manual_seed(0))
    obs = torch.zeros((1,) + tuple(view) + (15,), dtype=torch.uint8)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(obs)
    return float(counter.get_total_flops())


def train_batch_flops_per_device(cfg, envs_per_device, f_fwd):
    """Analytic per-device FLOPs of one train_batch: rollout forwards +
    epochs x minibatch forward/backward (bwd ~ 2x fwd)."""
    rollout = cfg.steps_per_env * envs_per_device * f_fwd
    learner_obs = cfg.epochs_per_batch * envs_per_device * cfg.steps_per_env
    return rollout + learner_obs * 3.0 * f_fwd


def main(sizes=(1, 2, 4, 8), device=None, out=None):
    """The profile at each of ``sizes``; returns the report written to
    ``out`` (default ``results/torch/scaling.json``)."""
    from ..parallel.distributed import dp_efficiency_model
    from ..training.ppo import PPOConfig

    dev = resolve_device(device)
    cfg = PPOConfig()
    n_grad_syncs = cfg.epochs_per_batch * cfg.num_minibatches
    f_fwd = fwd_flops_per_obs()
    print(f"forward flops/obs: {f_fwd:.3e}")
    rows = []
    n_params = None
    for n in sizes:
        ranks = build(n, ENVS_PER_DEVICE, device=dev)
        n_params = ranks[0]["n_params"]
        moved = ranks[0]["collective_bytes"]
        ar_batch = moved.get("all-reduce", 0)
        eff = {label: dp_efficiency_model(
            n, train_batch_flops_per_device(cfg, envs, f_fwd), ar_batch)
            for label, envs in (("small", ENVS_PER_DEVICE),
                                ("prod", PROD_ENVS_PER_DEVICE))}
        rows.append(dict(
            devices=n,
            hlo_flops_per_device=ranks[0]["flops"],
            flops_per_rank=[r["flops"] for r in ranks],
            collective_bytes=moved,
            allreduce_bytes_per_batch=ar_batch,
            allreduce_bytes_per_sync=ar_batch / n_grad_syncs,
            model_efficiency_small=round(eff["small"], 4),
            model_efficiency_prod=round(eff["prod"], 4),
        ))
        print(f"n={n}: flops/device={ranks[0]['flops']:.3e} "
              f"allreduce/sync={ar_batch / n_grad_syncs / 1e6:.2f} MB "
              f"eff@{ENVS_PER_DEVICE}env={eff['small']:.3f} "
              f"eff@{PROD_ENVS_PER_DEVICE}env={eff['prod']:.3f}", flush=True)

    report = dict(
        device=str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
        param_bytes=int(n_params * 4),
        grad_syncs_per_batch=n_grad_syncs,
        envs_per_device=ENVS_PER_DEVICE,
        prod_envs_per_device=PROD_ENVS_PER_DEVICE,
        forward_flops_per_obs=f_fwd,
        note=("per-rank FLOPs (FlopCounterMode: matrix products and "
              "convolutions, no elementwise work) and collective bytes of "
              "one train_batch on each of n ranks, counted while it runs "
              "(allreduce_bytes_per_sync = per batch / grad_syncs_per_batch);"
              " efficiency = dp_efficiency_model (H100 SXM defaults).  "
              "Ranks sharing one card or the CPU measure no wall-clock "
              "scaling: parallel.distributed.scaling_report does, on n "
              "cards."),
        sizes=rows,
    )
    out = out or os.path.join(RESULTS, "scaling.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    print("wrote", out)
    return report


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_cfg = json.loads(sys.argv[2])
        result = rank_profile(rank_cfg)
        with open(rank_cfg["out"], "w") as fh:
            json.dump(result, fh)
    else:
        parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
        parser.add_argument("--sizes", type=int, nargs="+",
                            default=[1, 2, 4, 8])
        parser.add_argument("--device", help="cuda (default) or cpu")
        parser.add_argument("--out", help="the report file")
        args = parser.parse_args()
        main(tuple(args.sizes), args.device, args.out)
