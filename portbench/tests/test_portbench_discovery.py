"""A traffic mix and a per-layer metric are found by name: added as files
and BENCHMARK.json entries alone, in a copy of the checkout."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

PROBE = r'''
import json, sys, types
sys.path.insert(0, sys.argv[1])
from portbench.harness import common
assert common.ROOT == sys.argv[1], common.ROOT
b = common.load_bench()
cell = common.find(b["workloads"], "cnn-train-probe", "workload")
tr = common.load_json(f"portbench/traffic/{cell['traffic']}.json")
ctx = common.Context(args=types.SimpleNamespace(trace=1), bench=b,
                     cell=cell, config={}, traffic=tr,
                     setup_clock=lambda: 0.0)
ctx.raw = {"kind": "train", "probe": 21.0}
print(json.dumps({"envs": tr["envs"],
                  "metrics": common.result_line(ctx)["metrics"]}))
'''


def test_a_new_traffic_and_metric_need_no_edit(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "traffic", "train-probe.json"), "w") as fh:
        json.dump({"entry": "train", "envs": 64}, fh)
    with open(os.path.join(pb, "metrics", "probe_ms.train.py"), "w") as fh:
        fh.write('def read(raw):\n    return raw.get("probe")\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({
        "name": "cnn-train-probe", "config": "safelife-cnn",
        "traffic": "train-probe", "chips": 1, "why": "a probe"})
    bench["per_layer"].append({
        "name": "probe_ms.train", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "PPO update",
        "moves": "train_env_steps_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_env_steps_per_s":
            m["workloads"].append("cnn-train-probe")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    out = subprocess.run([sys.executable, "-c", PROBE, root], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["envs"] == 64
    assert got["metrics"] == {"probe_ms.train": {"value": 21.0,
                                                 "unit": "ms"}}
