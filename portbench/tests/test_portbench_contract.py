"""BENCHMARK.json against the benchmark's contract, and the result line's
schema."""

import json
import os
import re
import types

from conftest import ROOT
from portbench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return common.load_bench()


def test_keys_names_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert common.load_json(c["file"])["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "limits", w["name"] + ".json"))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"train_env_steps_per_s", "train_batch_ms_p90",
                        "eval_levels_per_s", "setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in [x["name"] for x in
                                  common.metrics_of(b, cell, "end_to_end")]
    for cell in cells:
        reported = [m["name"] for m in common.metrics_of(b, cell,
                                                         "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert common.metrics_of(b, cell, "per_layer")


def _ctx(trace):
    b = bench()
    cell = b["workloads"][0]
    ctx = common.Context(
        args=types.SimpleNamespace(trace=trace), bench=b, cell=cell,
        config={}, traffic={}, setup_clock=lambda: 0.0)
    ctx.correct, ctx.attempted = True, 12
    ctx.e2e = {m["name"]: 1.5 for m in b["end_to_end"]}
    ctx.device = {"platform": "gpu", "kind": "x", "count": 1,
                  "memory_peak_bytes": 1}
    ctx.checks = [("env_mismatches", 0, 0)]
    return ctx


def test_result_line_schema():
    line = common.result_line(_ctx(0))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"train_env_steps_per_s",
                                    "train_batch_ms_p90", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    json.dumps(line)


def test_traced_line_leaves_out_what_no_reader_found():
    ctx = _ctx(1)
    ctx.raw = {"kind": "train", "spans": {"rollout": [0.1, 0.1]},
               "window": {"units": 2, "seconds": 1.0, "least_seconds": 0.01}}
    line = common.result_line(ctx)
    assert set(line["metrics"]) == {"rollout_ms.train", "mfu_pct.train"}
    assert abs(line["metrics"]["rollout_ms.train"]["value"] - 100.0) < 1e-9
    assert abs(line["metrics"]["mfu_pct.train"]["value"] - 2.0) < 1e-9
