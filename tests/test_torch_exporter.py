"""The port's telemetry server and resource sampler against the JAX
package's, mirroring ``tests/test_flight_recorder.py``
(``TestResourceSampler``, ``TestTelemetryServerE2E``,
``TestImportPurity``) and ``tests/test_fleet.py::TestHealthzFleetFold``.

- Every one of the server's endpoints answers over live HTTP on port 0,
  and an endpoint whose source is not attached answers 404.
- ``/healthz`` folds its five legs — the serving leg (router, engine or
  the serving gauges), ``training_healthy``, the hang watchdog, the
  integrity divergence and the SLO page — exactly as JAX
  ``TelemetryServer.healthz`` does: the two servers are held equal over
  every combination of attached objects, gauges and absent signals.
- ``/metrics`` is byte-equal to the JAX server's for equal registries.
- Importing the package and the exporter starts no thread and opens no
  socket (checked in a fresh subprocess).

Every test passes its own ``MetricsRegistry``: the process-wide default
carries other tests' gauges (a ``training_healthy`` left at 0 turns
``/healthz`` to 503)."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.observability.exporter as jax_exporter
import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.tracing as jax_tracing
import paddle_tpu_torch.observability.exporter as port_exporter
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.observability.tracing as port_tracing
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax
from paddle_tpu_torch.observability import (ClusterAggregator,
                                            FlightRecorder,
                                            RankMetricsPublisher,
                                            StackSampler, TimeSeriesStore)
from paddle_tpu_torch.observability.slo import SLO, BurnRateAlert, SLOEngine
from paddle_tpu_torch.serving import Engine, FleetRouter, SamplingParams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), \
                r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, params_from_jax(jparams, device="cpu")


def _engine(tiny_model, **kw):
    cfg, params = tiny_model
    kw = dict(dict(page_size=8, num_pages=64, max_batch_size=2,
                   chunk_len=8, tracer=port_tracing.Tracer()), **kw)
    return Engine(cfg, params, device="cpu", **kw)


# ------------------------------------------------------ resource sampler


class TestResourceSampler:
    def test_sample_once_populates_gauges(self):
        reg = port_metrics.MetricsRegistry()
        sample = port_exporter.ResourceSampler(registry=reg).sample_once()
        snap = reg.snapshot()
        assert sample["rss_bytes"] > 0 and sample["open_fds"] > 0
        assert snap["process_rss_bytes"]["value"]["current"] > 0
        assert snap["process_open_fds"]["value"]["current"] > 0
        assert "0" in sample["gc_collections"]
        # no card here: the device gauge is unread, and the sampler did
        # not initialize CUDA itself
        assert sample["torch_cuda_allocated_bytes"] is None
        assert not torch.cuda.is_initialized()
        assert "torch_cuda_allocated_bytes" in snap
        assert "jax_live_buffer_bytes" in \
            reg.get("torch_cuda_allocated_bytes").help
        json.dumps(sample)

    def test_same_gauges_as_jax_but_the_device_one(self):
        port, ref = port_metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
        port_exporter.ResourceSampler(registry=port).sample_once()
        jax_exporter.ResourceSampler(registry=ref).sample_once()
        names = {m.name for m in port.metrics()}
        assert names - {"torch_cuda_allocated_bytes"} == \
            {m.name for m in ref.metrics()} - {"jax_live_buffer_bytes"}

    def test_thread_start_stop(self):
        reg = port_metrics.MetricsRegistry()
        before = {t.name for t in threading.enumerate()}
        with port_exporter.ResourceSampler(interval_s=0.01,
                                           registry=reg) as s:
            for _ in range(200):
                if s.last_sample is not None:
                    break
                threading.Event().wait(0.01)
            assert s.last_sample is not None
        assert {t.name for t in threading.enumerate()} == before


# ---------------------------------------------------------- /healthz fold


class _Router:
    def __init__(self, healthy):
        self.healthy = healthy

    def fleet_health(self):
        return {"healthy": self.healthy, "replicas_admittable":
                int(self.healthy)}


class _Engine:
    def __init__(self, healthy):
        self.healthy = healthy

    def health(self):
        return {"healthy": self.healthy, "queue_depth": 3}


class _Hang:
    def __init__(self, active):
        self.hang_active = active


class _Integrity:
    def __init__(self, active):
        self.divergence_active = active


class _SLO:
    def __init__(self, page):
        self.page = page

    def page_active(self):
        return self.page


# the serving leg's sources, and each other leg's: absent, a gauge at 0
# or 1, or an attached object reporting False or True
_SERVING = [("router", True), ("router", False), ("engine", True),
            ("engine", False), ("gauge", None), ("gauge", 0), ("gauge", 1)]
_LEGS = [("absent", None), ("gauge", 0), ("gauge", 1),
         ("object", False), ("object", True)]


def _configure(srv, metrics, serving, training, hang, integrity, slo):
    reg = metrics.MetricsRegistry()
    srv.registry = reg
    kind, v = serving
    srv.router = _Router(v) if kind == "router" else None
    srv.engine = _Engine(v) if kind == "engine" else None
    if kind == "gauge" and v is not None:
        reg.gauge("serving_engine_healthy").set(v)
        reg.gauge("serving_queue_depth").set(2)
    if training[0] == "gauge":
        reg.gauge("training_healthy").set(training[1])
    for (kind, v), attr, gauge, cls in (
            (hang, "hang", "hang_watchdog_active", _Hang),
            (integrity, "integrity", "integrity_divergence_active",
             _Integrity),
            (slo, "slo", "slo_page_active", _SLO)):
        setattr(srv, attr, cls(v) if kind == "object" else None)
        if kind == "gauge":
            reg.gauge(gauge).set(v)


class TestHealthzFold:
    def test_every_leg_combination_equals_jax(self):
        """7 serving sources × training {absent, 0, 1} × hang,
        integrity and SLO legs {absent, gauge 0/1, object False/True}:
        2625 combinations, each answered alike by both servers."""
        port = port_exporter.start_telemetry_server(
            port=0, registry=port_metrics.MetricsRegistry(),
            tracer=port_tracing.Tracer())
        ref = jax_exporter.start_telemetry_server(
            port=0, registry=jax_metrics.MetricsRegistry(),
            tracer=jax_tracing.Tracer())
        try:
            n, verdicts = 0, set()
            for combo in itertools.product(_SERVING, _LEGS[:3], _LEGS,
                                           _LEGS, _LEGS):
                _configure(port, port_metrics, *combo)
                _configure(ref, jax_metrics, *combo)
                got, want = port.healthz(), ref.healthz()
                assert got == want, combo
                verdicts.add(got["healthy"])
                n += 1
            assert n == 2625 and verdicts == {True, False}
        finally:
            port.stop()
            ref.stop()

    @pytest.mark.parametrize("leg", ["serving", "training", "hang",
                                     "integrity", "slo"])
    def test_each_leg_alone_turns_http_503(self, leg):
        """Over live HTTP: all legs healthy → 200; the one leg bad →
        503 with that leg named in the payload."""
        srv = port_exporter.start_telemetry_server(
            port=0, registry=port_metrics.MetricsRegistry(),
            tracer=port_tracing.Tracer())
        try:
            good = dict(serving=("router", True), training=("gauge", 1),
                        hang=("object", False), integrity=("object", False),
                        slo=("object", False))
            _configure(srv, port_metrics, **good)
            code, _, body = _get(srv.url + "/healthz")
            assert code == 200 and json.loads(body)["healthy"] is True
            bad = dict(good, **{leg: {"serving": ("router", False),
                                      "training": ("gauge", 0)}.get(
                leg, ("object", True))})
            _configure(srv, port_metrics, **bad)
            code, _, body = _get(srv.url + "/healthz")
            health = json.loads(body)
            assert code == 503 and health["healthy"] is False
            key = {"training": "training_healthy",
                   "hang": "hang_active",
                   "integrity": "integrity_divergence_active",
                   "slo": "slo_page_active"}.get(leg)
            if key is not None:
                assert health[key] is (leg != "training")
        finally:
            srv.stop()

    def test_fleet_fold_on_a_real_router(self, tiny_model):
        """``TestHealthzFleetFold``'s contract on the port: 503 only when
        no replica can admit."""
        reg = port_metrics.MetricsRegistry()
        router = FleetRouter([lambda: _engine(tiny_model)] * 2,
                             registry=reg)
        with port_exporter.start_telemetry_server(
                port=0, router=router, registry=reg) as srv:
            code, _, body = _get(srv.url + "/healthz")
            assert code == 200
            assert json.loads(body)["replicas_admittable"] == 2
            router.kill_replica(0)
            router.step()
            code, _, body = _get(srv.url + "/healthz")
            assert code == 200
            assert json.loads(body)["replicas_admittable"] == 1
            router.drain(1, deadline_s=1e6)
            code, _, body = _get(srv.url + "/healthz")
            assert code == 503
            assert json.loads(body)["replicas_admittable"] == 0
            router.restart_replica(0)
            assert _get(srv.url + "/healthz")[0] == 200


# ------------------------------------------------------------- /metrics


def _fill(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("replica",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", start=0.01, factor=2.0,
                      count=6)
    hl = reg.histogram("ttft_seconds", "ttft", labelnames=("route",),
                       start=0.001, factor=4.0, count=5)
    for i in range(40):
        c.labels(replica=str(i % 3)).inc(i % 5)
        g.set(float(i % 7))
        h.observe(0.003 * (i + 1))
        hl.labels(route="a" if i % 2 else "b").observe(0.0007 * i)
    reg.counter("empty_total", "never incremented")
    reg.histogram("cold_seconds", "never observed")
    return reg


class TestMetricsExposition:
    def test_metrics_byte_equal_to_jax_for_equal_registries(self):
        bodies = []
        for exporter, metrics, tracing in (
                (jax_exporter, jax_metrics, jax_tracing),
                (port_exporter, port_metrics, port_tracing)):
            srv = exporter.start_telemetry_server(
                port=0, registry=_fill(metrics), tracer=tracing.Tracer())
            try:
                code, ctype, body = _get(srv.url + "/metrics")
            finally:
                srv.stop()
            assert code == 200 and ctype.startswith("text/plain")
            bodies.append(body.encode())
        assert bodies[1] == bodies[0]
        assert b"lat_seconds_bucket" in bodies[1]

    def test_aggregator_switches_metrics_to_the_merged_text(self):
        store = TCPStore(is_master=True, world_size=1)
        regs = [_fill(port_metrics) for _ in range(2)]
        for rank, reg in enumerate(regs):
            RankMetricsPublisher(store, rank, registry=reg,
                                 key_prefix="agg_exp").publish()
        local = port_metrics.MetricsRegistry()
        agg = ClusterAggregator(store, 2, registry=local,
                                key_prefix="agg_exp")
        with port_exporter.start_telemetry_server(
                port=0, registry=local, aggregator=agg,
                tracer=port_tracing.Tracer()) as srv:
            _, _, body = _get(srv.url + "/metrics")
            _, _, varz = _get(srv.url + "/varz")
        assert 'req_total{rank="1",replica="0"}' in body
        assert "cluster_ranks_reporting 2" in body
        assert set(json.loads(varz)["cluster"]["ranks"]) == {"0", "1"}


# ----------------------------------------------------------- endpoints


class TestEndpoints:
    def test_every_endpoint_over_http(self, tiny_model):
        reg = port_metrics.MetricsRegistry()
        tracer = port_tracing.Tracer()
        router = FleetRouter([lambda: _engine(tiny_model)] * 2,
                             registry=reg, tracer=tracer)
        clock = [0.0]
        store = TimeSeriesStore(registry=reg, clock=lambda: clock[0])
        slo = SLOEngine(store, [SLO(
            "goodput", target=0.9,
            good=("router_requests_finished_total",),
            total=("router_dispatches_total",),
            alerts=(BurnRateAlert("page", burn_rate_threshold=5.0,
                                  long_window_seconds=4.0,
                                  short_window_seconds=1.0),))],
            registry=reg, tracer=tracer, clock=lambda: clock[0])
        profiler = StackSampler(registry=reg, tracer=tracer)
        flight = FlightRecorder(registry=reg, tracer=tracer)
        with flight.record("soak::kill", group="chaos"):
            pass
        integrity = type("_Sentinel", (), {
            "divergence_active": False,
            "report": lambda self: {"checks": 3, "divergences": 0}})()
        hang = type("_Hang", (), {"hang_active": False, "fired": 0,
                                  "last_desync": None, "bundles": []})()
        srv = port_exporter.start_telemetry_server(
            port=0, registry=reg, tracer=tracer, router=router,
            flight=flight, hang=hang, integrity=integrity, slo=slo,
            timeseries=store, profiler=profiler,
            fleet_slo=lambda: {"fleet": True, "slos": {}})
        try:
            router.generate([[1, 2, 3, 4], [5, 6, 7]],
                            SamplingParams(max_new_tokens=3))
            for _ in range(3):
                clock[0] += 0.5
                store.scrape_once()
                slo.evaluate()
                profiler.sample_once()
            expect = {
                "/metrics": ("router_dispatches_total", "text/plain"),
                "/varz": ("router_dispatches_total", "application/json"),
                "/healthz": ('"healthy": true', "application/json"),
                "/traces": ("router::dispatch", "application/json"),
                "/traces?fleet=1": ("request#", "application/json"),
                "/traces?limit=1": ("traces", "application/json"),
                "/flight": ("soak::kill", "application/json"),
                "/fleet": ("counters", "application/json"),
                "/integrity": ('"checks": 3', "application/json"),
                "/slo": ("goodput", "application/json"),
                "/slo?fleet=1": ('"fleet": true', "application/json"),
                "/profilez": ("by_phase", "application/json"),
                "/profilez?format=collapsed": ("", "text/plain"),
                "/timeseries": ("router_dispatches_total",
                                "application/json"),
                "/timeseries?name=router_dispatches_total&window_seconds=5":
                    ('"kind": "counter"', "application/json"),
            }
            for path, (needle, ctype) in expect.items():
                code, got_ctype, body = _get(srv.url + path)
                assert code == 200, (path, body)
                assert got_ctype.startswith(ctype), (path, got_ctype)
                assert needle in body, (path, body[:300])
            traces = json.loads(_get(srv.url + "/traces?fleet=1")[2])
            ids = [t["trace_id"] for t in traces["traces"]]
            assert len(ids) == len(set(ids)) and ids
            flight_payload = json.loads(_get(srv.url + "/flight")[2])
            assert flight_payload["hang"]["active"] is False
            assert _get(srv.url + "/nope")[0] == 404
        finally:
            srv.stop()

    def test_unattached_sources_answer_404(self):
        with port_exporter.start_telemetry_server(
                port=0, registry=port_metrics.MetricsRegistry(),
                tracer=port_tracing.Tracer()) as srv:
            for path in ("/fleet", "/integrity", "/slo", "/slo?fleet=1",
                         "/profilez", "/timeseries", "/traces?fleet=1"):
                code, _, body = _get(srv.url + path)
                assert code == 404, path
                assert "error" in json.loads(body)
            for path in ("/metrics", "/varz", "/healthz", "/traces",
                         "/flight"):
                assert _get(srv.url + path)[0] == 200, path

    def test_healthz_503_while_shedding(self, tiny_model):
        eng = _engine(tiny_model, shed_queue_high=1)
        with port_exporter.start_telemetry_server(
                port=0, engine=eng,
                registry=port_metrics.MetricsRegistry()) as srv:
            eng.add_request([1, 2], SamplingParams(max_new_tokens=4))
            assert eng._update_shedding()
            code, _, body = _get(srv.url + "/healthz")
            assert code == 503 and json.loads(body)["healthy"] is False

    def test_engine_traces_during_generation(self, tiny_model):
        eng = _engine(tiny_model)
        with port_exporter.start_telemetry_server(
                port=0, engine=eng,
                registry=port_metrics.MetricsRegistry()) as srv:
            assert srv.port > 0
            eng.generate([[1, 2, 3], [4, 5]],
                         SamplingParams(max_new_tokens=3))
            traces = json.loads(_get(srv.url + "/traces")[2])["traces"]
            assert len(traces) == 2
            for t in traces:
                names = [s["name"] for s in t["spans"]]
                assert names[0].startswith("request#")
                assert "chunk[0]" in names
            health = json.loads(_get(srv.url + "/healthz")[2])
            assert set(health) >= {"queue_depth", "page_occupancy",
                                   "estimated_drain_s",
                                   "decode_rate_tok_s"}


# --------------------------------------------------------- import purity


class TestImportPurity:
    def test_import_spawns_no_threads_or_sockets(self):
        script = (
            "import json, os, threading\n"
            "def socket_fds():\n"
            "    out = []\n"
            "    for fd in os.listdir('/proc/self/fd'):\n"
            "        try:\n"
            "            t = os.readlink(f'/proc/self/fd/{fd}')\n"
            "        except OSError:\n"
            "            continue\n"
            "        if t.startswith('socket:'):\n"
            "            out.append(fd)\n"
            "    return out\n"
            "before_t = {t.name for t in threading.enumerate()}\n"
            "before_s = socket_fds()\n"
            "import paddle_tpu_torch\n"
            "import paddle_tpu_torch.observability.exporter\n"
            "import paddle_tpu_torch.serving.soak\n"
            "import paddle_tpu_torch.serving.replica\n"
            "after_t = {t.name for t in threading.enumerate()}\n"
            "after_s = socket_fds()\n"
            "print(json.dumps({'new_threads': sorted(after_t - before_t),"
            " 'new_sockets': sorted(set(after_s) - set(before_s))}))\n")
        out = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0, out.stderr[-2000:]
        diff = json.loads(out.stdout.strip().splitlines()[-1])
        assert diff == {"new_threads": [], "new_sockets": []}, diff
