"""The port's metric exposition, cross-rank aggregation and chrome export
against the JAX package's: ``MetricsRegistry.expose_prometheus`` gives the
JAX text byte for byte for the same series (labels, histogram buckets,
``+Inf``, exemplars, scrape collectors); ``RankMetricsPublisher`` /
``ClusterAggregator`` over the port's ``TCPStore`` give the JAX merged
snapshot and merged text for the same published payloads (stale and
missing ranks, the skew gauge); ``traces_to_chrome_events`` gives the JAX
events for the same traces on the same clock."""
import json

import numpy as np
import pytest

from paddle_tpu.distributed.store import TCPStore as JTCPStore
from paddle_tpu.observability import MetricsRegistry as JRegistry
from paddle_tpu.observability import Tracer as JTracer
from paddle_tpu.observability.aggregate import \
    ClusterAggregator as JAggregator
from paddle_tpu.observability.aggregate import \
    RankMetricsPublisher as JPublisher
from paddle_tpu.observability.tracing import \
    traces_to_chrome_events as jtraces_to_chrome_events
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import (ClusterAggregator,
                                            MetricsRegistry,
                                            RankMetricsPublisher, Tracer,
                                            export_traces_chrome,
                                            traces_to_chrome_events)


def _fill(reg, seed=0, rank=0):
    """The same series in either package's registry, from a seed."""
    rng = np.random.RandomState(seed + rank)
    reg.counter("requests_total", "requests served").inc(3 + rank)
    fam = reg.counter("collective_ops_total", "calls",
                      labelnames=("op", "group"))
    fam.labels(op="all_reduce", group="dp").inc(5)
    fam.labels(op="barrier", group="world").inc(1)
    g = reg.gauge("queue_depth", "rows waiting")
    g.set(4.0 + rank)
    g.set(2.0)
    h = reg.histogram("training_step_seconds", "step time",
                      start=1e-3, factor=2.0, count=8)
    for i, v in enumerate(rng.exponential(0.02 * (1 + rank), 40)):
        h.observe(float(v), exemplar=f"t{i}" if i % 7 == 0 else None)
    lh = reg.histogram("latency_seconds", "latency", labelnames=("kind",),
                       start=1e-4, factor=4.0, count=5)
    lh.labels(kind="decode").observe(0.003, exemplar="abc")
    lh.labels(kind="prefill").observe(2.5)
    reg.gauge("empty_gauge", "")


def test_expose_prometheus_equals_jax_text():
    port, jax_ = MetricsRegistry(), JRegistry()
    for reg in (port, jax_):
        _fill(reg)
        reg.add_collector(lambda reg=reg: reg.gauge(
            "collected", "set at scrape").set(7.5))
    text = port.expose_prometheus()
    assert text == jax_.expose_prometheus()
    assert 'le="+Inf"' in text and '# {trace_id="abc"}' in text
    assert "collected 7.5" in text


def test_snapshot_equals_jax_snapshot():
    port, jax_ = MetricsRegistry(), JRegistry()
    _fill(port)
    _fill(jax_)
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(jax_.snapshot(), sort_keys=True)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("world", [4, 3])
def test_cluster_aggregator_equals_jax(world):
    """Ranks 0..world-2 publish (rank 1 long ago, so it ages out), the
    last rank never does: the merged view and text equal the JAX
    aggregator's for the same payloads, every series carries its rank,
    and the fleet gauges report the skew and the stale ranks."""
    out = []
    for pkg in ("port", "jax"):
        Store, Reg, Pub, Agg = (
            (TCPStore, MetricsRegistry, RankMetricsPublisher,
             ClusterAggregator) if pkg == "port" else
            (JTCPStore, JRegistry, JPublisher, JAggregator))
        store = Store(is_master=True, world_size=world)
        clock = _Clock()
        for r in range(world - 1):
            reg = Reg()
            _fill(reg, rank=r)
            clock.t = 900.0 if r == 1 else 1000.0
            Pub(store, r, registry=reg, clock=clock).publish()
        clock.t = 1001.0
        local = Reg()
        agg = Agg(store, world, stale_after_s=30.0, registry=local,
                  clock=clock)
        snap = agg.merged_snapshot()
        text = agg.expose_prometheus()
        out.append((json.dumps(snap, sort_keys=True), text,
                    json.dumps(local.snapshot(), sort_keys=True)))
    assert out[0] == out[1]
    snap = json.loads(out[0][0])
    assert snap["stale_ranks"] == [1]
    assert snap["missing_ranks"] == [world - 1]
    assert sorted(snap["ranks"]) == [str(r) for r in range(world - 1)
                                     if r != 1]
    text = out[0][1]
    for line in text.splitlines():
        if line.startswith("#") or line.startswith(
                ("training_step_time_skew", "cluster_ranks")):
            continue
        assert 'rank="' in line, line
    if world == 4:
        assert snap["step_time_skew_seconds"] > 0
        assert "training_step_time_skew_seconds " in text
    assert f"cluster_ranks_stale 2" in text


def test_publisher_thread_publishes_and_stops():
    store = TCPStore(is_master=True, world_size=1)
    reg = MetricsRegistry()
    reg.counter("beats").inc()
    pub = RankMetricsPublisher(store, 0, registry=reg)
    with pub:
        pub.publish()
    assert not pub.running and pub.published >= 1
    payload = json.loads(store.get("metrics/rank_0"))
    assert payload["rank"] == 0 and payload["metrics"]["beats"]["value"] == 1


def test_chrome_events_equal_jax(tmp_path):
    """The same spans on the same manual clock lower to the same chrome
    events and track names, merged fleet sources included."""
    traces = []
    for T in (Tracer, JTracer):
        clock = _Clock(10.0)
        tr = T(clock=clock)
        with tr.trace("hapi::step", {"step": 0}) as root:
            clock.t = 10.5
            with tr.span("collective::all_reduce", root):
                clock.t = 10.75
            clock.t = 11.0
        root2 = tr.start_trace("request", start_s=12.0)
        root2.end(end_s=12.25)
        traces.append(tr.traces())
    ptr, jtr = traces
    ptr[0]["spans"][0]["source"] = jtr[0]["spans"][0]["source"] = "rank0"
    assert traces_to_chrome_events(ptr) == jtraces_to_chrome_events(jtr)
    path = export_traces_chrome(ptr, str(tmp_path / "c.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert "rank0: hapi::step" in names
    assert "collective::all_reduce" in names
