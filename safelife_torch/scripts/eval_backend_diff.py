"""Split a card-vs-CPU final-eval gap into its causes (the port of
``scripts/eval_backend_diff.py``).

    python -m safelife_torch.scripts.eval_backend_diff <logdir> [--keys 3]
        [--time-limit 1000] [--out PATH]

Replays one checkpoint's frozen-suite eval (``run_benchmark``) under
controlled configurations, ``--keys`` generator seeds each, every eval in
a subprocess of its own with a deadline, five at once:

* **card default**: the kernels, the policy's bfloat16 trunk;
* **cpu f32**: the plain path on the CPU, a float32 trunk;
* **card f32 trunk**: the net's ``compute_dtype`` float32 and TF32 off,
  which isolates the policy's precision (the JAX script's matmul probe);
* **card plain path** (``use_kernels=False``): the plain step on the card
  with the kernels' draws, which must give the default's result key for
  key; and **card padded** (``pad_to_lanes=True``): the batch tiled to a
  multiple of 128, which re-keys the policy's draws (the JAX script's
  unpadded probe, whose two effects the port takes apart).

K different keys on one configuration measure the sampling noise a
single eval carries.  A card configuration raises without CUDA; nothing
falls back to the CPU.  The run's suite comes from its name
(``<task>[+mods]-s<seed>``).  Results go to
``results/torch/eval_backend_diff_<run>.json`` (or ``--out``) and a
summary table to stdout.
"""

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys

import numpy as np

from .. import resolve_device
from . import RESULTS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Configuration -> (device, float32 trunk, kernels, padded).
CONFIGS = {
    "card default": ("cuda", False, True, False),
    "cpu f32": ("cpu", True, False, False),
    "card f32 trunk": ("cuda", True, True, False),
    "card plain path": ("cuda", False, False, False),
    "card padded": ("cuda", False, True, True),
}
DEADLINE_S = 3600


def suite_of(run):
    """The suite a run named ``<task>[+mods]-s<seed>`` evaluates on."""
    suite = run.split("+")[0].rsplit("-s", 1)[0] \
        if "-s" in run else run.split("+")[0]
    m = re.match(r"(.+?)(\+.*)?-s\d+$", run)
    if m:
        suite = m.group(1)
    return suite


def child(cfg):
    """One eval (in its own process): returns the RESULT line's dict."""
    import torch

    from ..benchmarking import run_benchmark
    from ..training.driver import load_policy

    device, f32, kernels, pad = cfg["settings"]
    device = resolve_device(None if device == "cuda" else device)
    policy, view = load_policy(cfg["logdir"], device=device)
    if f32:
        policy.net.compute_dtype = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = run_benchmark(
        cfg["suite"], policy, view_shape=view,
        generator=torch.Generator(device).manual_seed(cfg["key"]),
        time_limit=cfg["time_limit"], pad_to_lanes=pad, device=device,
        use_kernels=kernels)
    return dict(mean_perf=float(np.mean(res["performance"])),
                mean_length=float(np.mean(res["length"])),
                mean_reward=float(np.mean(res["reward"])),
                perf=[round(float(p), 4) for p in res["performance"]])


def run_eval(logdir, suite, config, key, time_limit=1000,
             timeout=DEADLINE_S):
    """The eval of ``config`` with generator seed ``key`` in a subprocess
    (killed at ``timeout`` seconds); a card configuration raises here
    without CUDA."""
    if CONFIGS[config][0] == "cuda":
        resolve_device(None)
    cfg = dict(logdir=os.path.abspath(logdir), suite=suite,
               settings=CONFIGS[config], key=key, time_limit=time_limit)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "safelife_torch.scripts.eval_backend_diff",
         "--child", json.dumps(cfg)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(
        f"eval child failed ({config}, key={key}):\n"
        + proc.stdout[-2000:] + proc.stderr[-2000:])


def main(logdir, keys=3, out=None, time_limit=1000):
    """Every configuration at keys 0 .. ``keys - 1``; returns the
    report written to ``out``."""
    run = os.path.basename(logdir.rstrip("/"))
    suite = suite_of(run)
    print(f"run={run} suite={suite} keys={keys}", flush=True)
    # Five evals at once, each a process of its own (the card takes
    # several; each eval's result does not depend on its neighbours).
    with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
        jobs = [(config, k, pool.submit(run_eval, logdir, suite, config, k,
                                        time_limit))
                for config in CONFIGS for k in range(keys)]
        rows = [(config, k, job.result()) for config, k, job in jobs]
    for config, k, r in rows:
        print(f"  {config} key={k}: {r['mean_perf']:.4f}", flush=True)

    report = {"run": run, "suite": suite, "rows": [
        dict(config=c, key=k, **r) for c, k, r in rows]}
    by_cfg = {}
    for c, k, r in rows:
        by_cfg.setdefault(c, []).append(r["mean_perf"])
    print("\n| config | mean_perf over keys | spread (max-min) |")
    print("|---|---|---|")
    for c, v in by_cfg.items():
        print(f"| {c} | {np.mean(v):.4f} "
              f"({', '.join(f'{x:.4f}' for x in v)}) "
              f"| {max(v) - min(v):.4f} |")
    report["summary"] = {c: dict(mean=float(np.mean(v)),
                                 spread=float(max(v) - min(v)))
                         for c, v in by_cfg.items()}
    out = out or os.path.join(RESULTS, f"eval_backend_diff_{run}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", out)
    return report


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print("RESULT " + json.dumps(child(json.loads(sys.argv[2]))))
    else:
        parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
        parser.add_argument("logdir")
        parser.add_argument("--keys", type=int, default=3)
        parser.add_argument("--out", help="the report file")
        parser.add_argument("--time-limit", type=int, default=1000)
        args = parser.parse_args()
        main(args.logdir, args.keys, args.out, args.time_limit)
