"""Launch ``python -m safelife_torch train`` as one data-parallel job (the
port of ``scripts/launch-pod``).

    python -m safelife_torch.scripts.launch local [--nproc N] [--device cpu]
        [--port P] [--timeout S] LOGDIR [-- train args...]
    python -m safelife_torch.scripts.launch pod HOST[,HOST...] ZONE LOGDIR
        [--gpus-per-host G] [--port P] [--dry-run] [-- train args...]

PyTorch runs one process per card, so a job is one rank per card, joined
by ``torch.distributed`` through the SAFELIFE_* variables that
``safelife_torch.parallel.distributed.initialize`` reads
(``SAFELIFE_COORDINATOR``, rank 0's ``host:port``; ``SAFELIFE_NUM_PROCS``;
``SAFELIFE_PROC_ID``).  With them set, ``train`` joins the group and trains
its shard of ``--num-envs`` (``PPOConfig.data_shards`` is the world size,
so the job trains as one process with that many shards would); rank ``i``
takes card ``i`` of its host, and rank 0 writes the logs, checkpoints,
evaluations and videos.

``local`` starts the ranks on this host, one per visible card unless
``--nproc`` says fewer (``--device cpu``: gloo ranks on the CPU, for
tests), waits for them, and kills the others as soon as one fails or the
``--timeout`` passes; it exits with the failing rank's code (124 at the
timeout).  More ranks than cards is an error: ranks never share a card and
never fall back to the CPU.

``pod`` does for GPU VMs what ``scripts/launch-pod`` does for a TPU slice:
``gcloud compute scp --recurse`` of the repository to every host, then one
``gcloud compute ssh --command`` a host that starts its G ranks under
``nohup``, each logging to ``train-<host>-<rank>.log`` in the copy.  The
coordinator is the first host (its name must resolve on the others and
``--port`` be open between them); ranks are numbered host by host.
LOGDIR is a local path on each host, not a ``gs://`` bucket: the port's
logger writes files, so the run lands on the first host, and a relaunch
into the same LOGDIR resumes every rank from rank 0's checkpoint.
``--dry-run`` prints the commands and runs nothing.
"""

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
REMOTE_DIR = "~/safelife_torch_job"
DEFAULT_PORT = 29500
# How often a waiting launcher looks at its ranks.
POLL_S = 0.2
# Seconds a stopped process has to exit on SIGTERM before SIGKILL.
STOP_GRACE_S = 10


def rank_env(coordinator, world, rank):
    """The SAFELIFE_* variables of one rank."""
    return {"SAFELIFE_COORDINATOR": coordinator,
            "SAFELIFE_NUM_PROCS": str(world), "SAFELIFE_PROC_ID": str(rank)}


def train_command(logdir, train_args, python=sys.executable):
    return [python, "-m", "safelife_torch", "train", logdir, *train_args]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_cards():
    import torch
    return torch.cuda.device_count()


def wait_all(procs, timeout=None):
    """Wait for every process; returns 0 when all exited 0, else the code
    of the first seen to fail, or 124 once ``timeout`` seconds pass.  The
    caller kills what is left."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            return failed[0]
        if all(c == 0 for c in codes):
            return 0
        if deadline is not None and time.monotonic() > deadline:
            return 124
        time.sleep(POLL_S)


def local(logdir, train_args=(), nproc=None, device=None, port=None,
          timeout=None):
    """Run ``nproc`` ranks of ``train LOGDIR train_args`` on this host (one
    a visible card by default; ``device="cpu"``: gloo ranks on the CPU, one
    by default), their output in this process's, and wait for them;
    returns the job's exit code."""
    if device is None:
        cards = visible_cards()
        nproc = cards if nproc is None else nproc
        if not 1 <= nproc <= cards:
            raise ValueError(f"{nproc} ranks on {cards} visible cards: a "
                             f"rank needs a card of its own")
    elif device == "cpu":
        nproc = 1 if nproc is None else nproc
        train_args = [*train_args, "--device", "cpu"]
    else:
        raise ValueError(f"device {device!r}: the ranks take the cards, or "
                         f"'cpu' for gloo ranks")
    coordinator = f"127.0.0.1:{port or _free_port()}"
    return run_processes(
        train_command(logdir, train_args),
        [rank_env(coordinator, nproc, rank) for rank in range(nproc)],
        timeout)


def run_processes(cmd, envs, timeout=None, stdout=None):
    """Run ``cmd`` once an entry of ``envs`` (variables on top of this
    process's, with the repository on PYTHONPATH), output to ``stdout`` (a
    file) or this process's own; wait for all (:func:`wait_all`) and stop
    what is left: SIGTERM (a launcher then stops its own ranks), SIGKILL
    after :data:`STOP_GRACE_S`.  Returns their exit code."""
    path = os.environ.get("PYTHONPATH")
    base = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path
                                               else ""))
    procs = []
    try:
        for env in envs:
            procs.append(subprocess.Popen(
                cmd, env=dict(base, **env), stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None))
        return wait_all(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(STOP_GRACE_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def pod_commands(hosts, zone, logdir, train_args=(), gpus_per_host=1,
                 port=DEFAULT_PORT):
    """The argv of each command ``pod`` runs, in order: one sync a host,
    then one start a host."""
    world = len(hosts) * gpus_per_host
    coordinator = f"{hosts[0]}:{port}"
    train = " ".join(shlex.quote(a) for a in train_command(
        logdir, train_args, python="python"))
    cmds = [["gcloud", "compute", "scp", "--recurse", f"--zone={zone}", REPO,
             f"{host}:{REMOTE_DIR}"] for host in hosts]
    for h, host in enumerate(hosts):
        starts = []
        for rank in range(h * gpus_per_host, (h + 1) * gpus_per_host):
            env = " ".join(f"{k}={v}" for k, v in rank_env(
                coordinator, world, rank).items())
            starts.append(f"{env} nohup {train} > train-{host}-{rank}.log "
                          f"2>&1 &")
        cmds.append(["gcloud", "compute", "ssh", host, f"--zone={zone}",
                     f"--command=cd {REMOTE_DIR} && {' '.join(starts)} "
                     f"echo started"])
    return cmds


def pod(hosts, zone, logdir, train_args=(), gpus_per_host=1,
        port=DEFAULT_PORT, dry_run=False):
    for cmd in pod_commands(hosts, zone, logdir, train_args, gpus_per_host,
                            port):
        print("+", " ".join(map(shlex.quote, cmd)), flush=True)
        if not dry_run:
            subprocess.run(cmd, check=True)
    if not dry_run:
        print(f"Done. Logs: {REMOTE_DIR}/train-<host>-<rank>.log on each "
              f"host; the run: {logdir} on {hosts[0]}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    train_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, train_args = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(
        prog="python -m safelife_torch.scripts.launch",
        description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    lo = sub.add_parser("local", help="N ranks on this host")
    lo.add_argument("logdir")
    lo.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: the visible cards)")
    lo.add_argument("--device", choices=("cpu",), default=None,
                    help="gloo ranks on the CPU (tests)")
    lo.add_argument("--port", type=int, default=None,
                    help="rank 0's port (default: a free one)")
    lo.add_argument("--timeout", type=float, default=None,
                    help="seconds before every rank is killed")
    po = sub.add_parser("pod", help="G ranks on each of several GPU VMs")
    po.add_argument("hosts", help="HOST[,HOST...]; the first coordinates")
    po.add_argument("zone")
    po.add_argument("logdir", help="a local path on each host")
    po.add_argument("--gpus-per-host", type=int, default=1)
    po.add_argument("--port", type=int, default=DEFAULT_PORT)
    po.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "pod":
        return pod(args.hosts.split(","), args.zone, args.logdir, train_args,
                   args.gpus_per_host, args.port, args.dry_run)
    # A SIGTERM ends the launcher through its cleanup: no rank outlives it.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return local(args.logdir, train_args, args.nproc, args.device, args.port,
                 args.timeout)


if __name__ == "__main__":
    sys.exit(main())
