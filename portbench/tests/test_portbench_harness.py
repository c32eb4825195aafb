"""The harness against the benchmark's contract, on the CPU at small
sizes: the result line, the files found by name, and the metric
declarations."""
import io
import json
import math
import os
import re
import shutil
import statistics
from contextlib import redirect_stdout

import pytest
import torch

from portbench import harness, run, traffic
from portbench.drivers import serve
from portbench.tests import small

ROOT = harness.ROOT
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line_of(cell, trace, override=small.shrink):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "2147483659",
                       "--seconds", "2.0", "--trace", str(trace)],
                      device=torch.device("cpu"), override=override)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_prints_the_contract_keys(cell, trace):
    r = line_of(cell, trace)
    want = {"correct", "attempted", "failed", "metrics", "device", "card",
            "checks"}
    assert set(r) == want | ({"breakdown"} if trace else set())
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(r["device"])
    e2e, layer = harness.metrics_of(BENCH, cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["metrics"]) <= set(layer)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert list(r["metrics"]) == e2e
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.load_json(harness.HERE, "workloads",
                                 f"{w['name']}.json")
        assert cell["config"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
    assert cells <= 24
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    for cell in m["workloads"]:
        e2e, layer = harness.metrics_of(BENCH, cell)
        assert m["moves"] in e2e and metric in layer
    mod = harness.reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        m["layer"], m["unit"], m["moves"], m["source"])
    assert UNIT.match(m["unit"]) and "\n" not in m["layer"]


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e, layer = harness.metrics_of(BENCH, cell)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric
    as new files and new entries: nothing that is there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.load(open(root / "portbench/configs/gpt3-1.3b.json"))
    cfg["name"] = "gpt-new"
    (root / "portbench/configs/gpt-new.json").write_text(json.dumps(cfg))
    cell = json.load(open(root / "portbench/workloads/"
                               "gpt3-1.3b.serve-chat64.json"))
    cell.update(name="gpt-new.serve-x", config="gpt-new")
    cell["traffic"]["name"] = "x"
    (root / "portbench/workloads/gpt-new.serve-x.json").write_text(
        json.dumps(cell))
    (root / "portbench/metrics/steps_seen.serve.py").write_text(
        'LAYER = "scheduler (serving/engine.py)"\nUNIT = "steps"\n'
        'MOVES = "serve_tokens_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def read(ctx, out):\n'
        '    c0, c1 = out["run"]["counters"]\n'
        '    return c1["steps"] - c0["steps"]\n')
    bench["configs"].append(dict(bench["configs"][0], name="gpt-new",
                                 file="portbench/configs/gpt-new.json"))
    bench["workloads"].append({"name": "gpt-new.serve-x",
                               "config": "gpt-new", "traffic": "x",
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "gpt3-1.3b.serve-chat64" in m["workloads"]:
            m["workloads"].append("gpt-new.serve-x")
    bench["per_layer"].append({"name": "steps_seen.serve", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler (serving/engine.py)",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["gpt-new.serve-x"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell("gpt-new.serve-x", 7, 2.0, 1, torch.device("cpu"),
                         0.0, root=str(root), override=small.shrink)
    assert r["metrics"]["steps_seen.serve"]["value"] > 0
    r = harness.run_cell("gpt-new.serve-x", 7, 2.0, 0, torch.device("cpu"),
                         0.0, root=str(root), override=small.shrink)
    assert set(r["metrics"]) == {"serve_tokens_per_s", "ttft_p95_ms",
                                 "itl_p95_ms", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data


def test_step_rows_add_up_to_the_engines_counters(monkeypatch):
    """The rows the driver reads off the requests, step by step, give the
    prompt tokens the engine says it prefilled and the tokens it says it
    generated."""
    seen = {}
    window = serve.window

    def spy(ctx):
        result, sample = window(ctx)
        seen.update(result["run"])
        return result, sample

    monkeypatch.setattr(serve, "window", spy)
    small.run("gpt3-1.3b.serve-chat64", seconds=2.0, trace=1)
    c0, c1 = seen["counters"]
    assert len(seen["rows"]) == c1["steps"] - c0["steps"]
    rows = [r for step in seen["rows"] for r in step]
    assert sum(q for q, _, prefill in rows if prefill) == \
        c1["prefill"] - c0["prefill"]
    decode = sum(1 for _, _, prefill in rows if not prefill)
    assert 0 < decode <= c1["generated"] - c0["generated"]
    assert all(0 < q <= ctx for q, ctx, _ in rows)


def test_same_seed_same_requests_and_every_seed_the_same_sizes():
    cell = harness.load_json(harness.HERE, "workloads",
                             "gpt3-1.3b.serve-chat64.json")
    t = cell["traffic"]
    a, b = traffic.Requests(t, 5), traffic.Requests(t, 5)
    assert all(a(k) == b(k) for k in range(50))
    c = traffic.Requests(t, 2**31 + 11)
    n = t["pool"]
    for tab in ("user", "out", "system"):
        assert sorted(getattr(a, tab)) == sorted(getattr(c, tab))
    assert statistics.median(a.user) == pytest.approx(
        t["user_len"]["median"], rel=0.01)
    lens = [len(a(k)[0]) for k in range(n)]
    assert min(lens) >= t["system_len"] + t["user_len"]["min"]
    assert max(lens) + t["output_len"]["max"] <= 2048
