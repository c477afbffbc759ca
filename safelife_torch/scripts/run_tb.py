"""Launch tensorboard over training run directories (the port of
``scripts/run-tb``).

    python -m safelife_torch.scripts.run_tb [RUN_DIR ...] [--port 6006]

Capability parity with the reference's ``run-tb`` (tensorboard over
``./data/run-*``), pointed at the port's logdirs.  Where tensorboard is not
installed the trainer's logger writes a ``scalars.jsonl`` stream instead
(``safelife_torch.metrics.logging.JsonlSummaryWriter``), and this script
then prints each run's last value of every tag.
"""

import argparse
import glob
import json
import os
import subprocess
import sys


def summarize(dirs):
    """The last value of each tag of each run's ``scalars.jsonl``, as the
    lines this script prints (runs without one are left out)."""
    lines = []
    for d in dirs:
        path = os.path.join(d, "scalars.jsonl")
        if not os.path.exists(path):
            continue
        last = {}
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                last[rec["tag"]] = (rec["value"], rec["step"])
        lines.append(f"\n{d}:")
        for tag, (val, step) in sorted(last.items()):
            lines.append(f"  {tag:40s} {val:12.4f}  (step {step})")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m safelife_torch.scripts.run_tb")
    p.add_argument("logdirs", nargs="*", default=["./data"],
                   help="run directories (globs ok)")
    p.add_argument("--port", type=int, default=6006)
    args = p.parse_args(argv)

    dirs = []
    for pattern in args.logdirs:
        dirs.extend(sorted(glob.glob(pattern)))
    dirs = [d for d in dirs if os.path.isdir(d)] or args.logdirs

    try:
        subprocess.run(
            ["tensorboard", f"--port={args.port}",
             "--logdir_spec=" + ",".join(
                 f"{os.path.basename(d)}:{d}" for d in dirs)],
            check=True)
    except FileNotFoundError:
        print("tensorboard not installed; summarizing scalars.jsonl instead")
        for line in summarize(dirs):
            print(line)


if __name__ == "__main__":
    sys.exit(main())
