"""The port's store-plane gossip — prefix summaries, trace rings, SLO
statuses — and its ``ReplicaServer``, against the JAX package's.

Mirrors ``tests/test_distributed_tracing.py::TestTraceGossip``,
``tests/test_profiling.py::TestFleetSLOGossip`` and the
``ReplicaServer`` / ``PrefixSummaryPublisher`` tests of
``tests/test_autoscaler.py`` and ``tests/test_fleet.py``.  Payloads are
compared exactly (JSON on the wire, no tolerance): a port engine and a
JAX engine (``tiny`` fp32, the JAX ``gpt_init`` parameters carried
across with ``params_from_jax``) serving the same prompts publish the
same prefix summary, and the trace merge and ``merge_fleet_slo`` give
equal results on equal inputs.  The stores are the port's
``TCPStore`` on port 0 or an in-memory stand-in with ``set``/``mget``."""
import dataclasses
import json
import types
import urllib.error
import urllib.request

import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.slo as jax_slo
import paddle_tpu.observability.slo_gossip as jax_slo_gossip
import paddle_tpu.observability.timeseries as jax_timeseries
import paddle_tpu.observability.trace_gossip as jax_trace_gossip
import paddle_tpu.observability.tracing as jax_tracing
import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.observability.slo as port_slo
import paddle_tpu_torch.observability.slo_gossip as port_slo_gossip
import paddle_tpu_torch.observability.timeseries as port_timeseries
import paddle_tpu_torch.observability.trace_gossip as port_trace_gossip
import paddle_tpu_torch.observability.tracing as port_tracing
import paddle_tpu_torch.serving as port_serving
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax
from paddle_tpu_torch.observability import start_telemetry_server
from paddle_tpu_torch.observability.tracing import export_traces_chrome

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    serving=jax_serving, metrics=jax_metrics, slo=jax_slo,
    timeseries=jax_timeseries, tracing=jax_tracing,
    trace_gossip=jax_trace_gossip, slo_gossip=jax_slo_gossip)
PORT = types.SimpleNamespace(
    serving=port_serving, metrics=port_metrics, slo=port_slo,
    timeseries=port_timeseries, tracing=port_tracing,
    trace_gossip=port_trace_gossip, slo_gossip=port_slo_gossip)


class _ManualClock:
    def __init__(self, t=0.0, auto=0.0):
        self.t = t
        self.auto = auto

    def __call__(self):
        self.t += self.auto
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class _FakeStore:
    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value

    def mget(self, keys):
        return [self.kv.get(k) for k in keys]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def store():
    return TCPStore(is_master=True, world_size=1)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, params_from_jax(jparams, device="cpu"), jcfg, jparams


def _engines(tiny_model, **kw):
    cfg, params, jcfg, jparams = tiny_model
    kw = dict(dict(page_size=8, num_pages=64, max_batch_size=2,
                   chunk_len=8), **kw)
    return (jax_serving.Engine(jcfg, jparams, **kw),
            port_serving.Engine(cfg, params, device="cpu", **kw))


# ------------------------------------------------------- prefix gossip


class TestPrefixGossip:
    def test_engines_publish_equal_summaries(self, tiny_model):
        """The same prompts through a JAX and a port engine: the
        published payloads (chain hashes, depths, hit stats) are equal."""
        cfg = tiny_model[0]
        g = torch.Generator().manual_seed(5)
        system = torch.randint(0, cfg.vocab_size, (24,), generator=g)
        prompts = [system.tolist() + torch.randint(
            0, cfg.vocab_size, (n,), generator=g).tolist()
            for n in (3, 9, 5)]
        payloads = []
        for eng, pkg in zip(_engines(tiny_model), (JAX, PORT)):
            sink = _FakeStore()
            eng.generate(prompts,
                         pkg.serving.SamplingParams(max_new_tokens=3))
            pub = pkg.serving.PrefixSummaryPublisher(
                eng, 4, sink, max_entries=8, clock=lambda: 50.0)
            pub.publish()
            payloads.append(json.loads(sink.kv["prefix/replica_4"]))
        assert payloads[1] == payloads[0]
        assert payloads[1]["summary"]["stats"]["cached_pages"] > 0

    def test_gossip_rides_tcpstore(self, tiny_model, store):
        """The cross-process path on the port: each engine publishes
        through the store, the router scores from a one-mget collector
        and routes the shared-prefix request warm."""
        cfg, params = tiny_model[:2]
        g = torch.Generator().manual_seed(79)
        system = torch.randint(0, cfg.vocab_size, (32,),
                               generator=g).tolist()
        prompt = system + torch.randint(0, cfg.vocab_size, (5,),
                                        generator=g).tolist()

        def make():
            return port_serving.Engine(cfg, params, page_size=8,
                                       num_pages=64, max_batch_size=2,
                                       chunk_len=8, device="cpu")

        router = port_serving.FleetRouter(
            [make, make], registry=port_metrics.MetricsRegistry(),
            prefix_summary_source=lambda:
            port_serving.collect_prefix_summaries(
                store, [0, 1], key_prefix="gossip_rides"))
        pubs = [port_serving.PrefixSummaryPublisher(
            rep.engine, rep.replica_id, store, key_prefix="gossip_rides")
            for rep in router.replicas]
        router.replicas[1].engine.generate(
            [system], port_serving.SamplingParams(max_new_tokens=2))
        for pub in pubs:
            pub.publish()
        req = router.submit(prompt,
                            port_serving.SamplingParams(max_new_tokens=4))
        router.step()
        assert req.replica_id == 1
        assert router.metrics.snapshot()["cache_aware_dispatches"] == 1
        got = port_serving.collect_prefix_summaries(
            store, [0, 1], key_prefix="gossip_rides")
        assert set(got) == {0, 1}
        assert got[1]["stats"]["cached_pages"] > 0
        assert got[0]["stats"]["cached_pages"] == 0

    def test_garbled_and_stale_summaries_absent(self):
        def scenario(pkg):
            sink = _FakeStore()
            sink.set("prefix/replica_0", "}{ not json")

            class _Eng:
                def prefix_summary(self, max_entries=32):
                    return {"entries": {"h": 8}, "stats": {}}

            pkg.serving.PrefixSummaryPublisher(
                _Eng(), 1, sink, clock=lambda: 100.0).publish()
            collect = pkg.serving.collect_prefix_summaries
            return (collect(sink, [0, 1, 2]),
                    collect(sink, [0, 1], stale_after_s=5.0,
                            clock=lambda: 200.0),
                    collect(sink, [0, 1], stale_after_s=5.0,
                            clock=lambda: 101.0))

        port, ref = scenario(PORT), scenario(JAX)
        assert port == ref
        assert list(port[0]) == [1] and port[1] == {} and list(port[2]) == [1]


# ------------------------------------------------------ trace gossip


def _split_fleet_traces(pkg):
    """Router + two replica tracers, one request failed over across
    both replicas — the split-ring topology of a per-process fleet."""
    Tracer = pkg.tracing.Tracer
    router_tr = Tracer(clock=_ManualClock(auto=1.0))
    reps = [Tracer(clock=_ManualClock(auto=1.0)) for _ in range(2)]
    root = router_tr.start_trace("fleet#0")
    d0 = router_tr.start_span("router::dispatch", root)
    seg0 = reps[0].start_trace("request#0", context=d0.context())
    seg0.set_attribute("state", "evacuated")
    seg0.end()
    d0.end()
    router_tr.start_span("router::failover", root).end()
    d1 = router_tr.start_span("router::dispatch", root)
    reps[1].start_trace("request#0", context=d1.context()).end()
    d1.end()
    root.end()
    return router_tr, reps


def _strip_ids(merged):
    """The merged view without its ids: each package's tracer prefixes
    ids with its own process nonce."""
    out = []
    for m in merged:
        m = dict(m, trace_id=None)
        m["spans"] = [dict(s, trace_id=None, span_id=None, parent_id=None)
                      for s in m["spans"]]
        out.append(m)
    return out


class TestTraceGossip:
    def test_publish_collect_merge_round_trip(self, tmp_path, store):
        merged_by_pkg = []
        for pkg, tag in ((JAX, "jt"), (PORT, "pt")):
            router_tr, reps = _split_fleet_traces(pkg)
            for rid, tr in enumerate(reps):
                port_trace_gossip.TraceRingPublisher(
                    tr, rid, store, key_prefix=tag).publish()
            rings = pkg.trace_gossip.collect_trace_rings(
                store, [0, 1, 2], key_prefix=tag)
            assert [src for src, _ in rings] == ["replica0", "replica1"]
            merged_by_pkg.append(pkg.trace_gossip.collect_fleet_traces(
                store, [0, 1], key_prefix=tag,
                extra_rings=[("router", router_tr.traces())]))
        assert _strip_ids(merged_by_pkg[1]) == _strip_ids(merged_by_pkg[0])
        (m,) = merged_by_pkg[1]
        assert len(m["segments"]) == 3
        assert m["name"] == "fleet#0"
        assert m["retained"] == "failover"
        assert {s["source"] for s in m["spans"]} == \
            {"router", "replica0", "replica1"}
        path = str(tmp_path / "fleet.json")
        export_traces_chrome(merged_by_pkg[1], path)
        with open(path) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        assert all(isinstance(e["tid"], int) for e in xs)
        assert any(e["name"] == "replica1: request#0" for e in xs)
        assert any(e["name"] == "router: router::failover" for e in xs)

    def test_merge_equal_on_equal_rings(self):
        """Both packages' ``merge_traces`` over the same ring dicts."""
        router_tr, reps = _split_fleet_traces(PORT)
        rings = [("router", router_tr.traces())] + [
            (f"replica{i}", tr.traces()) for i, tr in enumerate(reps)]
        want = jax_tracing.merge_traces(json.loads(json.dumps(rings)))
        got = port_tracing.merge_traces(json.loads(json.dumps(rings)))
        assert got == want

    def test_garbled_and_stale_rings_absent(self, store):
        store.set("garbled/replica_0", "}{ not json")
        tr = port_tracing.Tracer(clock=_ManualClock(auto=1.0))
        tr.start_trace("op").end()
        port_trace_gossip.TraceRingPublisher(
            tr, 1, store, key_prefix="garbled",
            clock=lambda: 100.0).publish()
        collect = port_trace_gossip.collect_trace_rings
        assert [s for s, _ in collect(store, [0, 1],
                                      key_prefix="garbled")] == ["replica1"]
        assert collect(store, [0, 1], key_prefix="garbled",
                       stale_after_s=5.0, clock=lambda: 200.0) == []
        assert [s for s, _ in collect(
            store, [0, 1], key_prefix="garbled", stale_after_s=5.0,
            clock=lambda: 101.0)] == ["replica1"]

    def test_publisher_payload_bounds_and_stamps(self):
        tr = port_tracing.Tracer(clock=_ManualClock(auto=1.0))
        for i in range(10):
            tr.start_trace(f"t{i}").end()
        sink = _FakeStore()
        pub = port_trace_gossip.TraceRingPublisher(tr, 3, sink,
                                                   max_traces=4)
        payload = pub.publish()
        assert payload["replica"] == 3
        assert [t["name"] for t in payload["traces"]] == \
            ["t6", "t7", "t8", "t9"]
        assert "clock_offset_s" in payload
        assert json.loads(sink.kv["traces/replica_3"])["replica"] == 3


# --------------------------------------------------------- SLO gossip


def _mini_engine(pkg, clock, bad_frac):
    """One availability SLO with a tight page over 12 half-second beats
    of ``bad_frac`` bad traffic (the JAX profiling test's engine)."""
    reg = pkg.metrics.MetricsRegistry()
    req, bad = reg.counter("req_total"), reg.counter("bad_total")
    store = pkg.timeseries.TimeSeriesStore(registry=reg, clock=clock)
    slo = pkg.slo.SLO(
        "availability", target=0.9, bad="bad_total", total="req_total",
        alerts=(pkg.slo.BurnRateAlert(
            "page", burn_rate_threshold=5.0, long_window_seconds=4.0,
            short_window_seconds=1.0, clear_after_seconds=1.0),),
        budget_window_seconds=60.0)
    engine = pkg.slo.SLOEngine(store, [slo], registry=reg, clock=clock)
    for _ in range(12):
        clock.advance(0.5)
        req.inc(10)
        bad.inc(int(10 * bad_frac))
        store.scrape_once()
        engine.evaluate()
    return engine


class TestFleetSLOGossip:
    def test_publish_collect_merge_round_trip(self, store):
        healthy = _mini_engine(PORT, _ManualClock(), 0.0)
        burning = _mini_engine(PORT, _ManualClock(), 1.0)
        port_slo_gossip.SLOStatusPublisher(healthy, 0, store,
                                           key_prefix="slo_rt").publish()
        port_slo_gossip.SLOStatusPublisher(burning, 1, store,
                                           key_prefix="slo_rt").publish()
        statuses = port_slo_gossip.collect_slo_statuses(
            store, [0, 1, 2], key_prefix="slo_rt")
        assert [src for src, _ in statuses] == ["replica0", "replica1"]
        fleet = port_slo_gossip.collect_fleet_slo(store, [0, 1],
                                                  key_prefix="slo_rt")
        assert fleet == jax_slo_gossip.merge_fleet_slo(statuses)
        assert fleet["fleet"] is True and fleet["page_active"] is True
        assert fleet["replicas"]["replica0"]["page_active"] is False
        assert fleet["replicas"]["replica1"]["page_active"] is True
        obj = fleet["slos"]["availability"]
        assert obj["error_budget_ratio"] == \
            obj["replicas"]["replica1"]["error_budget_ratio"]
        assert obj["error_budget_ratio"] < \
            obj["replicas"]["replica0"]["error_budget_ratio"]
        (alert,) = obj["alerts_active"]
        assert (alert["replica"], alert["severity"]) == ("replica1", "page")
        times = [tr["time"] for tr in fleet["transitions"]]
        assert times == sorted(times)

    def test_merge_equal_on_equal_statuses(self):
        """Both packages' engines on equal histories give equal statuses,
        and both merges of them are equal."""
        statuses = {}
        for pkg, name in ((JAX, "jax"), (PORT, "port")):
            statuses[name] = [
                (f"replica{i}", _mini_engine(pkg, _ManualClock(t=i),
                                             frac).status())
                for i, frac in enumerate((0.0, 1.0, 0.5))]
        assert statuses["port"] == statuses["jax"]
        assert port_slo_gossip.merge_fleet_slo(statuses["port"]) == \
            jax_slo_gossip.merge_fleet_slo(statuses["jax"])

    def test_garbled_and_stale_statuses_absent(self, store):
        store.set("slo_gs/replica_0", "}{ not json")
        engine = _mini_engine(PORT, _ManualClock(), 0.0)
        port_slo_gossip.SLOStatusPublisher(
            engine, 1, store, key_prefix="slo_gs",
            clock=lambda: 100.0).publish()
        collect = port_slo_gossip.collect_slo_statuses
        assert [s for s, _ in collect(store, [0, 1],
                                      key_prefix="slo_gs")] == ["replica1"]
        assert collect(store, [0, 1], key_prefix="slo_gs",
                       stale_after_s=5.0, clock=lambda: 200.0) == []
        assert [s for s, _ in collect(
            store, [0, 1], key_prefix="slo_gs", stale_after_s=5.0,
            clock=lambda: 101.0)] == ["replica1"]

    def test_fleet_endpoint_and_404_without_source(self, store):
        engine = _mini_engine(PORT, _ManualClock(), 1.0)
        port_slo_gossip.SLOStatusPublisher(engine, 0, store,
                                           key_prefix="slo_ep").publish()
        reg = port_metrics.MetricsRegistry()
        server = start_telemetry_server(
            port=0, registry=reg, slo=engine,
            fleet_slo=lambda: port_slo_gossip.collect_fleet_slo(
                store, [0], key_prefix="slo_ep"))
        try:
            status, body = _get(server.url + "/slo?fleet=1")
            assert status == 200
            fleet = json.loads(body)
            assert fleet["fleet"] is True and fleet["page_active"]
            status, body = _get(server.url + "/slo")
            assert status == 200 and "fleet" not in json.loads(body)
        finally:
            server.stop()
        server = start_telemetry_server(port=0, registry=reg, slo=engine)
        try:
            status, body = _get(server.url + "/slo?fleet=1")
            assert status == 404 and "fleet" in json.loads(body)["error"]
        finally:
            server.stop()


# ------------------------------------------------------ replica server


class _StubReq:
    def __init__(self, prompt, sampling):
        self.prompt = list(prompt)
        self.sampling = sampling
        self.state = "queued"
        self.tokens = list(prompt)
        self.finish_reason = None
        self.retry_after_s = None

    @property
    def output(self):
        return self.tokens[len(self.prompt):]


class _StubEngine:
    """Engine-shaped stub (the JAX autoscaler suite's): ``summary`` is
    the radix payload, request states are the strings both packages
    use."""

    def __init__(self, summary=None, drain=0.0):
        self.summary = summary
        self.drain = drain
        self.reqs = []

    def health(self):
        return {"healthy": True, "queue_depth": 0,
                "running": len(self.reqs), "page_occupancy": 0.0,
                "estimated_drain_s": self.drain,
                "decode_rate_tok_s": 120.0,
                "prefix_cache": {"enabled": True}}

    def add_request(self, prompt, sampling, trace_context=None):
        req = _StubReq(prompt, sampling)
        self.reqs.append(req)
        return req

    def has_work(self):
        return bool(self.reqs)

    def step(self):
        for req in self.reqs:
            req.tokens.append(1)
            if len(req.output) >= req.sampling.max_new_tokens:
                req.state = "finished"
        self.reqs = [r for r in self.reqs if r.state != "finished"]

    def evacuate(self):
        self.reqs = []

    def prefix_summary(self, max_entries=32):
        return self.summary

    def warmup(self):
        return self


def _summary(entries):
    return {"page_size": 8, "enabled": True, "entries": entries,
            "stats": {"cached_pages": len(entries)}}


class TestReplicaServer:
    def test_replica_server_hosts_gossip_publisher(self):
        def scenario(pkg):
            sink = _FakeStore()
            eng = _StubEngine(summary=_summary({"x": 24}))
            eng.add_request([1, 2, 3],
                            pkg.serving.SamplingParams(max_new_tokens=2))
            srv = pkg.serving.ReplicaServer(eng, 7, store=sink,
                                            gossip_interval_s=0.01)
            served = srv.serve(should_stop=lambda: not eng.has_work())
            payload = json.loads(sink.kv["prefix/replica_7"])
            return (served, eng.has_work(), payload["replica"],
                    payload["summary"],
                    pkg.serving.collect_prefix_summaries(sink, [7]),
                    srv.publisher.running, srv.trace_publisher)

        got = scenario(PORT)
        assert got == scenario(JAX)
        served, work, rid, summary, collected, running, tp = got
        assert served == 2 and not work and rid == 7
        assert summary["entries"] == {"x": 24}
        assert collected[7]["entries"] == {"x": 24}
        assert running is False and tp is None

    def test_serve_needs_a_bound(self):
        eng = _StubEngine()
        srv = port_serving.ReplicaServer(eng, 0)
        with pytest.raises(ValueError):
            srv.serve()
        eng.add_request([1], port_serving.SamplingParams(max_new_tokens=5))
        assert srv.serve(max_steps=2) == 2 and srv.steps == 2
        assert eng.has_work()

    def test_warmth_scores_over_store_gossip(self):
        """The autoscaler's victim selection reads the collected
        summaries: the coldest replica (1) is the one drained, in both
        packages."""
        def scenario(pkg):
            sink = _FakeStore()
            clock = _ManualClock()
            engines = [_StubEngine(summary=_summary({"a": 64})),
                       _StubEngine(summary=_summary({})),
                       _StubEngine(summary=_summary({"b": 128}))]
            for rid, eng in enumerate(engines):
                pkg.serving.PrefixSummaryPublisher(eng, rid, sink).publish()
            reg = pkg.metrics.MetricsRegistry()
            router = pkg.serving.FleetRouter(
                engines, clock=clock, registry=reg,
                prefix_summary_source=lambda:
                pkg.serving.collect_prefix_summaries(sink, range(3)))
            scaler = pkg.serving.Autoscaler(
                router, lambda: _StubEngine(summary=_summary({})),
                clock=clock, registry=reg, min_replicas=1, max_replicas=4,
                scale_up_cooldown_s=5.0, scale_down_cooldown_s=10.0)
            clock.advance(60.0)
            act = scaler.tick()
            return act, [rep.state for rep in router.replicas]

        got = scenario(PORT)
        assert got == scenario(JAX)
        act, states = got
        assert act == ("down", "idle")
        assert states[1] != "healthy"
        assert states[0] == states[2] == "healthy"

    def test_real_engine_publishes_summary_and_trace_ring(self, tiny_model,
                                                          store):
        """A port engine under a ReplicaServer over the TCPStore: the
        serve loop's final publish leaves its summary and its trace
        ring; the fleet collector merges the ring by trace_id."""
        cfg, params = tiny_model[:2]
        tracer = port_tracing.Tracer()
        srv = port_serving.ReplicaServer(
            lambda: port_serving.Engine(
                cfg, params, page_size=8, num_pages=64, max_batch_size=2,
                chunk_len=8, tracer=tracer, device="cpu"),
            3, store=store, key_prefix="rs_prefix",
            trace_key_prefix="rs_traces", gossip_interval_s=0.05)
        req = srv.engine.add_request(
            list(range(1, 20)), port_serving.SamplingParams(max_new_tokens=3))
        served = srv.serve(should_stop=lambda: not srv.engine.has_work())
        assert served >= 3 and req.state == "finished"
        got = port_serving.collect_prefix_summaries(
            store, [3], key_prefix="rs_prefix")
        assert got[3]["stats"]["cached_pages"] > 0
        merged = port_trace_gossip.collect_fleet_traces(
            store, [3], key_prefix="rs_traces")
        ids = [m["trace_id"] for m in merged]
        assert len(ids) == len(set(ids))
        assert any(m["spans"] and all(s["source"] == "replica3"
                                      for s in m["spans"])
                   for m in merged)
        assert not srv.publisher.running
        assert not srv.trace_publisher.running
