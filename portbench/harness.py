"""One run of one cell, found by name.

``BENCHMARK.json`` names the cells and the metrics.  Everything that
belongs to one cell, configuration or per-layer metric is a file of its
own, found by its name: ``workloads/<cell>.json`` (its configuration,
driver, traffic, settings and limits), ``configs/<config>.json`` (the
sizes as run), ``metrics/<metric>.py`` (a reader) and
``drivers/<driver>.py`` (the window's loop, one per kind of cell).  A
cell, configuration or metric is added by adding its file and its
entry, with no file edited.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time

from . import compare, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(root, "BENCHMARK.json")


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def reader(name, here=HERE):
    """The per-layer metric ``name``'s reader module."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench, name):
    """(end-to-end metric names, per-layer metric names) the cell
    reports: each end-to-end metric with no ``workloads`` list or one
    that lists the cell, and each per-layer metric whose ``workloads``
    (which every per-layer entry has) lists the cell."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m["name"] for m in bench["per_layer"] if name in m["workloads"]]
    return e2e, layer


class Ctx:
    """What a driver is handed: the cell, its configuration, the run's
    arguments and device, and the set-up clock."""

    def __init__(self, name, cell, config, seed, seconds, trace_on, device,
                 t_start):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace_on)
        self.device, self.t_start = device, t_start
        self.setup_s = None
        self.memory_peak = 0

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory(self):
        if self.device.type == "cuda":
            import torch

            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


def run_cell(name, seed, seconds, trace_on, device, t_start, root=ROOT,
             override=None):
    """The run's result, as ``run.py`` prints it.  ``override(cell,
    config)`` may change both before the run (the CPU tests' small
    sizes)."""
    bench = benchmark(root)
    entry = cell_entry(bench, name)
    here = os.path.join(root, "portbench")
    cell = load_json(here, "workloads", f"{name}.json")
    config = load_json(here, "configs", f"{entry['config']}.json")
    if cell["config"] != entry["config"] or cell["traffic"]["name"] != \
            entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with its entry "
                         f"in BENCHMARK.json")
    if override is not None:
        override(cell, config)
    ctx = Ctx(name, cell, config, seed, seconds, trace_on, device, t_start)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    out = driver.run(ctx)
    e2e, layer = metrics_of(bench, name)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    values = dict(out["metrics"], setup_s=ctx.setup_s)
    if trace_on:
        values = {}
        for m in layer:
            v = reader(m, here).read(ctx, out)
            if v is not None:
                values[m] = v
    else:
        missing = [m for m in e2e if m not in values]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        values = {m: values[m] for m in e2e}
    correct, checks = compare.judge(out["readings"], cell["limits"])
    device_block = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": _device_kind(device), "count": entry["chips"],
                    "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": device_block}
    if trace_on and out["trace"] is not None:
        device_block["busy_s"] = out["trace"]["busy_s"]
        device_block["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = trace.breakdown(out["trace"])
    result["check_s"] = out["check_s"]
    result["checks"] = checks
    return result


def _device_kind(device):
    if device.type != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(device)
