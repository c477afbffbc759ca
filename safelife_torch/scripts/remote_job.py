"""Single-VM remote training workflow: start / resume / ssh (the port of
``scripts/remote-job``).

Workflow parity with the reference's gcloud tooling
(``gcloud/start-remote-job``, ``gcloud/resume``, ``gcloud/ssh``): rsync
the source tree to a remote instance, run training inside a tmux session
named after the job, and port-forward tensorboard back to the local
machine, so a dropped ssh connection never kills the run and ``resume``
reattaches to it.  (Jobs over several VMs use
``python -m safelife_torch.scripts.launch pod``.)

Usage::

    python -m safelife_torch.scripts.remote_job start INSTANCE JOB_NAME
        [--port 6006] [--zone Z] [--shutdown] [--nproc N] [--dry-run]
        [-- train args...]
    python -m safelife_torch.scripts.remote_job resume INSTANCE [JOB_NAME]
        [--port 6006] [--zone Z] [--dry-run]
    python -m safelife_torch.scripts.remote_job ssh [--zone Z] [--dry-run]
        INSTANCE [CMD...]

``start`` runs ``python -m safelife_torch train ~/JOB_NAME/data/JOB_NAME``
with any arguments after ``--`` forwarded to ``train``; ``--nproc N``
runs it as N ranks, one a card of the instance, through ``launch local``.
The trainer's ``active_job.txt`` marker (written in the data dir, as the
reference's ``start-training:53-66`` does) lets a crashed instance
identify and restart its run on boot.  ``--shutdown`` powers the instance
off 10 minutes after training exits (abort with ``sudo shutdown -c``),
matching ``start-training --shutdown``.  ``--dry-run`` prints each
command and runs none.  ``ssh`` passes everything after INSTANCE to the
remote shell, so its options come before INSTANCE.
"""

import argparse
import os
import shlex
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RSYNC_EXCLUDES = ["__pycache__", "*.so", ".git", "results", "tests/golden",
                  "*.egg-info", ".pytest_cache"]


def gcloud_ssh(instance, zone, command=None, extra=()):
    cmd = ["gcloud", "compute", "ssh", instance]
    if zone:
        cmd += ["--zone", zone]
    if extra:
        cmd += ["--"] + list(extra)
    elif command:
        cmd += ["--", command]
    return cmd


def run(cmd, dry_run, check=False):
    """Print ``cmd`` and run it (not under ``dry_run``); its exit code."""
    print("+", " ".join(map(shlex.quote, cmd)), flush=True)
    if dry_run:
        return 0
    return subprocess.run(cmd, check=check).returncode


def cmd_start(args, train_args):
    remote = f"~/{args.job_name}"
    data_dir = f"{remote}/data/{args.job_name}"
    # 1. rsync the source tree (reference start-remote-job:42-70).
    scp = ["gcloud", "compute", "scp", "--recurse"] \
        + (["--zone", args.zone] if args.zone else [])
    sync_cmd = (["rsync", "-az", "--delete"]
                + [f"--exclude={e}" for e in RSYNC_EXCLUDES]
                + ["-e", "gcloud compute ssh" + (
                    f" --zone {args.zone}" if args.zone else "") + " --",
                   REPO + "/", f"{args.instance}:{remote}/src/"])
    if run(sync_cmd, args.dry_run) != 0:
        # Fall back to gcloud scp when plain rsync-over-gcloud is blocked.
        print("rsync failed; falling back to gcloud scp", file=sys.stderr)
        run(scp + [REPO, f"{args.instance}:{remote}/src"], args.dry_run,
            check=True)

    # 2. tmux session named after the job; training inside it (as N ranks
    #    with --nproc); optional delayed shutdown (reference
    #    start-training:247-252).
    launcher = (f"safelife_torch.scripts.launch local --nproc {args.nproc} "
                f"{data_dir} --" if args.nproc
                else f"safelife_torch train {data_dir}")
    train = (f"cd {remote}/src && python -m {launcher} "
             + " ".join(map(shlex.quote, train_args)))
    if args.shutdown:
        train += "; sudo shutdown -P +10"
    inner = (f"mkdir -p {data_dir} && "
             f"tmux new-session -d -s {shlex.quote(args.job_name)} "
             f"{shlex.quote(train)} && "
             f"tmux new-window -t {shlex.quote(args.job_name)} "
             f"'tensorboard --logdir {remote}/data --port 6006' && "
             f"echo started {args.job_name}")
    run(gcloud_ssh(args.instance, args.zone, inner), args.dry_run,
        check=True)
    # 3. Attach with tensorboard port-forwarded locally.
    return attach(args.instance, args.zone, args.job_name, args.port,
                  args.dry_run)


def attach(instance, zone, job_name, port, dry_run=False):
    tmux = f"tmux attach -t {shlex.quote(job_name)}" if job_name \
        else "tmux attach"
    return run(gcloud_ssh(instance, zone,
                          extra=["-L", f"{port}:localhost:6006", tmux]),
               dry_run)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    train_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, train_args = argv[:i], argv[i + 1:]

    p = argparse.ArgumentParser(prog="python -m safelife_torch.scripts."
                                     "remote_job")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("start")
    s.add_argument("instance")
    s.add_argument("job_name")
    s.add_argument("--port", default="6006")
    s.add_argument("--zone", default=None)
    s.add_argument("--shutdown", action="store_true")
    s.add_argument("--nproc", type=int, default=None,
                   help="train as N ranks, one a card (launch local)")
    r = sub.add_parser("resume")
    r.add_argument("instance")
    r.add_argument("job_name", nargs="?")
    r.add_argument("--port", default="6006")
    r.add_argument("--zone", default=None)
    h = sub.add_parser("ssh")
    h.add_argument("instance")
    h.add_argument("rest", nargs=argparse.REMAINDER)
    h.add_argument("--zone", default=None)
    for sp in (s, r, h):
        sp.add_argument("--dry-run", action="store_true",
                        help="print the commands, run none")
    args = p.parse_args(argv)

    if args.cmd == "start":
        return cmd_start(args, train_args)
    if args.cmd == "resume":
        return attach(args.instance, args.zone, args.job_name, args.port,
                      args.dry_run)
    return run(gcloud_ssh(args.instance, args.zone, extra=args.rest or None),
               args.dry_run)


if __name__ == "__main__":
    sys.exit(main())
