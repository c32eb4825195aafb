"""Live telemetry endpoints + resource sampler — the flight recorder's
ops surface (the port of ``paddle_tpu/observability/exporter.py``).

Two strictly opt-in components (importing this module — or
``paddle_tpu_torch`` — starts no thread and opens no socket; a tier-1
test enforces that):

- :func:`start_telemetry_server` — a stdlib ``http.server`` daemon
  thread a fleet scheduler / Prometheus can scrape while the process
  trains or serves:

  ===========  ========================================================
  ``/metrics``  Prometheus text exposition of the MetricsRegistry; with
                an ``aggregator`` attached (rank 0 of a fleet), the
                merged cross-rank exposition instead — every series
                labelled ``rank="<r>"``, one scrape for the whole job
  ``/varz``     JSON registry snapshot + compile-watchdog report (plus
                the fleet ``cluster`` view when aggregating)
  ``/healthz``  one probe for BOTH serving and training liveness:
                serving shedding state (queue depth, page occupancy,
                ``estimated_drain_s``), the ``training_healthy`` gauge
                and the hang-watchdog state — HTTP 503 while shedding,
                while training is anomalous, or during an active
                cross-rank hang (load balancers and fleet supervisors
                eject on status alone)
  ``/traces``   recent completed traces from the Tracer (``?limit=N``);
                ``?fleet=1`` serves the merged fleet view instead —
                per-replica rings joined by trace_id (the attached
                router's ``collect_traces()`` or a configured
                ``fleet_traces`` store-plane collector), so a
                failed-over request reads as ONE trace — 404 when
                neither source is attached
  ``/flight``   the distributed flight recorder: collective-ring
                summary + newest records, in-flight collectives, and
                the hang watchdog's last desync report / bundle paths
  ``/fleet``    the serving fleet router: per-replica state (breaker,
                drain, backpressure window, canary reservation, live
                engine health, prefix-cache state — hit/eviction
                counters, cached pages and the gossiped radix-summary
                size steering cache-aware dispatch), the blast-radius
                fold (``quarantined`` count, ``suspects``,
                ``cascade_breaker_open``) and the ``router_*`` counters
                — 404 when no router is attached
  ``/integrity``  the silent-corruption sentinel: fingerprint/replay
                check counts, last cross-rank-verified step, active
                divergence state and recent events — 404 when no
                sentinel is attached
  ``/slo``      the SLO engine: per-objective spec, live burn rates,
                remaining error budget, per-alert state and the recent
                fire/clear transition log — 404 when no engine is
                attached; a firing fast-burn *page* also folds into
                ``/healthz`` (503 — someone must look NOW).
                ``?fleet=1`` serves the merged fleet view instead — a
                configured ``fleet_slo`` collector (the store-plane
                ``collect_fleet_slo`` closure) folds every replica's
                objectives into one payload — 404 when none is attached
  ``/profilez``  the continuous sampling profiler: collapsed-stack
                profile with per-phase CPU slices, finished
                anomaly-triggered captures and sampler self-stats
                (``?window_seconds=`` trailing window, ``?phase=``
                slice filter, ``?format=collapsed`` for flamegraph
                text) — 404 when no sampler is attached
  ``/timeseries``  the in-process time-series store: budget/usage
                summary, or with ``?name=<series>`` (plus optional
                ``window_seconds=`` and label params) the windowed
                rate/delta/avg/slope/quantile answers — "when did
                memory start growing" — 404 when no store is attached
  ===========  ========================================================

  ``port=0`` binds an ephemeral port (read it back from
  ``server.port``) — tests and multi-process launches never fight over
  a fixed port.

- :class:`ResourceSampler` — a periodic daemon thread polling process
  RSS, open-fd count, per-generation GC collections and the bytes
  live tensors hold on the card into registry gauges
  (``process_rss_bytes`` & co.), so memory leaks and fd leaks show up
  on ``/metrics`` long before the OOM killer explains them
  post-mortem.  ``sample_once()`` works without
  the thread (the soak harness takes one synchronous sample a scrape).
"""
from __future__ import annotations

import gc
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .metrics import default_registry
from .tracing import default_tracer

__all__ = ["ResourceSampler", "TelemetryServer", "start_telemetry_server"]


# --------------------------------------------------------------- sampler


def _read_rss_bytes():
    """Resident set size.  /proc is authoritative on Linux; the
    getrusage fallback (peak, kilobytes) keeps macOS dev boxes working."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def _count_open_fds():
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def _cuda_allocated_bytes():
    """Bytes held by live tensors on the current card
    (``torch.cuda.memory_allocated()``).  Only consulted when torch is
    already imported and its CUDA context is initialized — the sampler
    thread must never be the one that initializes CUDA."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.memory_allocated())
    except Exception:
        return None


class ResourceSampler:
    """Poll process resources into registry gauges every ``interval_s``.

    Opt-in: nothing happens until :meth:`start` (daemon thread) or
    :meth:`sample_once` (synchronous).  Gauges — ``process_rss_bytes``,
    ``process_open_fds``, ``python_gc_collections{gen=...}``,
    ``torch_cuda_allocated_bytes`` — are registered lazily on the first
    sample so constructing a sampler doesn't yet touch the registry.
    """

    def __init__(self, interval_s=5.0, registry=None):
        self.interval_s = float(interval_s)
        self.registry = registry or default_registry()
        # the sampler thread and synchronous sample_once() callers race
        # on the lazy gauge build and the published sample
        self._lock = threading.Lock()
        self._gauges = None     # guarded-by: self._lock
        self._thread = None
        self._stop = threading.Event()
        self._last = None       # guarded-by: self._lock

    def _ensure_gauges(self):
        with self._lock:
            return self._ensure_gauges_locked()

    def _ensure_gauges_locked(self):
        if self._gauges is None:
            reg = self.registry
            self._gauges = {
                "rss": reg.gauge("process_rss_bytes",
                                 "resident set size of this process"),
                "fds": reg.gauge("process_open_fds",
                                 "open file descriptors"),
                "gc": reg.gauge("python_gc_collections",
                                "cumulative GC runs per generation",
                                labelnames=("gen",)),
                "cuda": reg.gauge(
                    "torch_cuda_allocated_bytes",
                    "bytes held by live tensors on the current card "
                    "(torch.cuda.memory_allocated; stands for the JAX "
                    "package's jax_live_buffer_bytes)"),
            }
        return self._gauges

    def sample_once(self):
        """Take one sample, update the gauges, return it as a dict
        (``None`` fields = unavailable on this platform)."""
        g = self._ensure_gauges()
        rss = _read_rss_bytes()
        fds = _count_open_fds()
        cuda_bytes = _cuda_allocated_bytes()
        gc_counts = {str(i): s.get("collections", 0)
                     for i, s in enumerate(gc.get_stats())}
        if rss is not None:
            g["rss"].set(rss)
        if fds is not None:
            g["fds"].set(fds)
        if cuda_bytes is not None:
            g["cuda"].set(cuda_bytes)
        for gen, n in gc_counts.items():
            g["gc"].labels(gen=gen).set(n)
        sample = {"rss_bytes": rss, "open_fds": fds,
                  "gc_collections": gc_counts,
                  "torch_cuda_allocated_bytes": cuda_bytes}
        with self._lock:
            self._last = sample
        return sample

    @property
    def last_sample(self):
        with self._lock:
            return self._last

    # ---- thread ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="resource-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:
                pass    # silent-ok: sampling must never kill the process
            self._stop.wait(self.interval_s)

    def stop(self):
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------------- server


class _TelemetryHandler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-telemetry"

    def log_message(self, *args):           # keep scrapes off stderr
        pass

    def _send(self, code, body, ctype="application/json"):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype + "; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):                       # noqa: N802 (stdlib API)
        srv = self.server
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                body = (srv.aggregator.expose_prometheus()
                        if srv.aggregator is not None
                        else srv.registry.expose_prometheus())
                self._send(200, body, ctype="text/plain; version=0.0.4")
            elif url.path == "/varz":
                self._send(200, json.dumps(srv.varz()))
            elif url.path == "/healthz":
                health = srv.healthz()
                code = 200 if health.get("healthy", True) else 503
                self._send(code, json.dumps(health))
            elif url.path == "/traces":
                q = parse_qs(url.query)
                limit = int(q["limit"][0]) if "limit" in q else None
                if q.get("fleet", ["0"])[0] not in ("0", "", "false"):
                    merged = srv.fleet_traces(limit=limit)
                    if merged is None:
                        self._send(404, json.dumps(
                            {"error": "no fleet trace source attached"}))
                    else:
                        self._send(200, json.dumps(
                            {"fleet": True, "traces": merged}))
                else:
                    self._send(200, json.dumps(
                        {"traces": srv.tracer.traces(limit=limit)}))
            elif url.path == "/flight":
                self._send(200, json.dumps(srv.flightz(), default=str))
            elif url.path == "/fleet":
                if srv.router is None:
                    self._send(404, json.dumps(
                        {"error": "no fleet router attached"}))
                else:
                    self._send(200, json.dumps(srv.router.fleet_status(),
                                               default=str))
            elif url.path == "/integrity":
                if srv.integrity is None:
                    self._send(404, json.dumps(
                        {"error": "no integrity sentinel attached"}))
                else:
                    self._send(200, json.dumps(srv.integrity.report(),
                                               default=str))
            elif url.path == "/slo":
                q = parse_qs(url.query)
                if q.get("fleet", ["0"])[0] not in ("0", "", "false"):
                    merged = srv.fleet_slo()
                    if merged is None:
                        self._send(404, json.dumps(
                            {"error": "no fleet slo source attached"}))
                    else:
                        self._send(200, json.dumps(merged, default=str))
                elif srv.slo is None:
                    self._send(404, json.dumps(
                        {"error": "no slo engine attached"}))
                else:
                    self._send(200, json.dumps(srv.slo.status(),
                                               default=str))
            elif url.path == "/profilez":
                if srv.profiler is None:
                    self._send(404, json.dumps(
                        {"error": "no stack sampler attached"}))
                else:
                    q = parse_qs(url.query)
                    window = (float(q["window_seconds"][0])
                              if "window_seconds" in q else None)
                    ph = q.get("phase", [None])[0]
                    if q.get("format", ["json"])[0] == "collapsed":
                        self._send(200, srv.profiler.flamegraph(
                            window_seconds=window, phase=ph),
                            ctype="text/plain")
                    else:
                        self._send(200, json.dumps(srv.profiler.profile(
                            window_seconds=window, phase=ph),
                            default=str))
            elif url.path == "/timeseries":
                if srv.timeseries is None:
                    self._send(404, json.dumps(
                        {"error": "no time-series store attached"}))
                else:
                    q = parse_qs(url.query)
                    if "name" in q:
                        window = float(q.pop("window_seconds",
                                             ["60"])[0])
                        name = q.pop("name")[0]
                        labels = {k: v[0] for k, v in q.items()} or None
                        self._send(200, json.dumps(
                            srv.timeseries.query(name, labels, window)))
                    else:
                        self._send(200, json.dumps(
                            srv.timeseries.stats()))
            else:
                self._send(404, json.dumps({"error": "not found",
                                            "path": url.path}))
        except Exception as e:              # a broken page must not wedge
            self._send(500, json.dumps({"error": repr(e)}))


class TelemetryServer(ThreadingHTTPServer):
    """The bound-and-running telemetry endpoint set.

    Constructed by :func:`start_telemetry_server`; ``port`` is the bound
    port (meaningful with ``port=0``), ``url`` a convenience base, and
    ``stop()`` shuts the daemon thread down.  Works as a context
    manager."""

    daemon_threads = True

    def __init__(self, addr, registry, tracer, engine, watchdog,
                 aggregator=None, flight=None, hang=None, router=None,
                 integrity=None, fleet_traces=None, slo=None,
                 timeseries=None, profiler=None, fleet_slo=None):
        super().__init__(addr, _TelemetryHandler)
        self.registry = registry
        self.tracer = tracer
        self.engine = engine
        self.watchdog = watchdog
        self.aggregator = aggregator
        self.flight = flight
        self.hang = hang
        self.router = router
        self.integrity = integrity
        self.slo = slo
        self.timeseries = timeseries
        self.profiler = profiler
        self._fleet_traces = fleet_traces
        self._fleet_slo = fleet_slo
        self._serve_thread = None

    def fleet_traces(self, limit=None):
        """The merged fleet trace view behind ``/traces?fleet=1``: the
        configured ``fleet_traces`` callable (a store-plane
        ``collect_fleet_traces`` closure) when one was given, else the
        attached router's in-process :meth:`collect_traces`.  None when
        neither source exists (the endpoint 404s)."""
        source = self._fleet_traces
        if source is None and self.router is not None:
            source = getattr(self.router, "collect_traces", None)
        if source is None:
            return None
        merged = source()
        if limit is not None:
            merged = merged[-int(limit):]
        return merged

    def fleet_slo(self):
        """The merged fleet SLO view behind ``/slo?fleet=1``: the
        configured ``fleet_slo`` callable (a store-plane
        ``collect_fleet_slo`` closure).  None when no source exists
        (the endpoint 404s)."""
        source = self._fleet_slo
        if source is None:
            return None
        return source()

    # ---- payloads ------------------------------------------------------
    def varz(self):
        wd = self.watchdog
        if wd is None:
            from .compile_watchdog import default_watchdog

            wd = default_watchdog()
        out = {"pid": os.getpid(),
               "metrics": self.registry.snapshot(),
               "jit": wd.report()}
        if self.aggregator is not None:
            out["cluster"] = self.aggregator.merged_snapshot()
        return out

    def healthz(self):
        """Live health — ONE probe for serving and training.  The
        serving leg: with a fleet router attached its
        ``fleet_health()`` is authoritative — 503 only when NO replica
        can admit (all breakers open or draining); one replica merely
        shedding is soft backpressure, not an outage, and the cascade
        breaker being open with admittable replicas left is likewise
        soft (the payload carries ``cascade_breaker_open`` and the
        ``quarantined`` count for supervisors that care).  Otherwise an
        attached engine's ``health()``, else the serving gauges in the
        registry.  Folded on top: the ``training_healthy`` gauge
        (HealthMonitor) and the hang-watchdog state (attached
        watchdog, else the ``hang_watchdog_active`` gauge).  An absent
        signal (no trainer in this process, no watchdog) reads as
        healthy — the probe degrades to exactly what the process
        actually runs."""
        def gauge_value(name):
            m = self.registry.get(name)
            return m.value if m is not None and m.kind == "gauge" else None

        if self.router is not None:
            out = dict(self.router.fleet_health())
        elif self.engine is not None:
            out = dict(self.engine.health())
        else:
            healthy = gauge_value("serving_engine_healthy")
            out = {"healthy": bool(healthy) if healthy is not None
                   else True,
                   "queue_depth": gauge_value("serving_queue_depth"),
                   "page_occupancy":
                       gauge_value("serving_page_occupancy"),
                   "estimated_drain_s":
                       gauge_value("serving_estimated_drain_seconds"),
                   "prefix_cache_pages":
                       gauge_value("serving_prefix_cache_pages")}
        training = gauge_value("training_healthy")
        training = bool(training) if training is not None else None
        if self.hang is not None:
            hang_active = bool(self.hang.hang_active)
        else:
            g = gauge_value("hang_watchdog_active")
            hang_active = bool(g) if g is not None else None
        # integrity fold: 503 while a CONFIRMED state divergence on
        # this rank is unrepaired (the sentinel clears it once a later
        # cross-rank compare matches again); absent signal = healthy
        if self.integrity is not None:
            divergence = bool(self.integrity.divergence_active)
        else:
            g = gauge_value("integrity_divergence_active")
            divergence = bool(g) if g is not None else None
        # SLO fold: 503 while a fast-burn *page* alert is firing — the
        # error budget is emptying faster than a human response time,
        # which is exactly what a page means.  A slow-burn ticket stays
        # soft (visible on /slo, not an outage).  Without an attached
        # engine the slo_page_active gauge is folded instead; absent
        # signal = healthy, like every other leg.
        if self.slo is not None:
            slo_page = bool(self.slo.page_active())
        else:
            g = gauge_value("slo_page_active")
            slo_page = bool(g) if g is not None else None
        out["training_healthy"] = training
        out["hang_active"] = hang_active
        out["integrity_divergence_active"] = divergence
        out["slo_page_active"] = slo_page
        out["healthy"] = (bool(out.get("healthy", True))
                          and training is not False
                          and not hang_active
                          and not divergence
                          and not slo_page)
        return out

    def flightz(self):
        """The ``/flight`` payload: collective-ring summary + newest
        records and, with a hang watchdog attached, its state and last
        desync report."""
        from .flight import default_flight_recorder

        rec = self.flight if self.flight is not None \
            else default_flight_recorder()
        out = {"summary": rec.summary(),
               "records": rec.records(limit=64),
               "inflight": rec.inflight()}
        if self.hang is not None:
            out["hang"] = {"active": bool(self.hang.hang_active),
                           "fired": self.hang.fired,
                           "desync": self.hang.last_desync,
                           "bundles": [os.fspath(p)
                                       for p in self.hang.bundles]}
        return out

    # ---- lifecycle ------------------------------------------------------
    @property
    def port(self):
        return self.server_address[1]

    @property
    def url(self):
        return f"http://{self.server_address[0]}:{self.port}"

    def _start(self):
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="telemetry-server",
            daemon=True)
        self._serve_thread.start()
        return self

    def stop(self):
        t, self._serve_thread = self._serve_thread, None
        if t is not None:
            self.shutdown()
            t.join(timeout=5.0)
        self.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def start_telemetry_server(port=0, host="127.0.0.1", registry=None,
                           tracer=None, engine=None, watchdog=None,
                           aggregator=None, flight=None, hang=None,
                           router=None, integrity=None,
                           fleet_traces=None, slo=None,
                           timeseries=None, profiler=None,
                           fleet_slo=None):
    """Bind and start the telemetry endpoints on a daemon thread.

    ``port=0`` picks an ephemeral port (``server.port`` tells you which).
    ``engine`` (a ``serving.Engine``) makes ``/healthz`` live — queue
    depth, occupancy and ``estimated_drain_s`` straight from the
    scheduler; without it the serving gauges in ``registry`` are used.
    ``tracer`` defaults to the engine's tracer when one is attached,
    else the process-wide :func:`default_tracer`.  ``aggregator`` (an
    :class:`~paddle_tpu_torch.observability.aggregate.ClusterAggregator`,
    rank-0 only) switches ``/metrics`` to the merged fleet exposition
    and embeds the ``cluster`` view in ``/varz``.  ``flight`` (a
    :class:`~paddle_tpu_torch.observability.flight.FlightRecorder`, default:
    the process-wide one) backs ``/flight``; ``hang`` (a
    :class:`~paddle_tpu_torch.observability.flight.HangWatchdog`) adds its
    desync/bundle state there and makes ``/healthz`` go 503 during an
    active cross-rank hang.  ``router`` (a
    :class:`~paddle_tpu_torch.serving.FleetRouter`) serves ``/fleet`` and
    switches the ``/healthz`` serving leg to the fleet fold: 503 only
    when no replica can admit.  ``integrity`` (a
    :class:`~paddle_tpu_torch.resilience.integrity.IntegrityCallback`)
    serves ``/integrity`` and makes ``/healthz`` go 503 while a
    confirmed state divergence is unrepaired (without one the
    ``integrity_divergence_active`` gauge is folded instead).
    ``fleet_traces`` (a zero-arg callable returning a merged trace
    list, e.g. a ``collect_fleet_traces(store, ids)`` closure) backs
    ``/traces?fleet=1``; without it the attached router's
    ``collect_traces()`` is used, and with neither the fleet view
    404s.  ``slo`` (an :class:`~paddle_tpu_torch.observability.slo.SLOEngine`)
    serves ``/slo`` and makes ``/healthz`` go 503 while a fast-burn
    page alert is firing (without one the ``slo_page_active`` gauge is
    folded instead); ``timeseries`` (a
    :class:`~paddle_tpu_torch.observability.timeseries.TimeSeriesStore`)
    serves ``/timeseries``.  ``profiler`` (a
    :class:`~paddle_tpu_torch.observability.profiling.StackSampler`) serves
    ``/profilez``; ``fleet_slo`` (a zero-arg callable returning the
    merged fleet objective view, e.g. a
    ``collect_fleet_slo(store, ids)`` closure) backs ``/slo?fleet=1``.
    Never called on import anywhere in the framework — telemetry is
    strictly opt-in.
    """
    if tracer is None:
        if engine is not None and getattr(engine, "tracer", None):
            tracer = engine.tracer
        elif router is not None and getattr(router, "tracer", None):
            tracer = router.tracer
        else:
            tracer = default_tracer()
    srv = TelemetryServer((host, int(port)),
                          registry or default_registry(), tracer,
                          engine, watchdog, aggregator=aggregator,
                          flight=flight, hang=hang, router=router,
                          integrity=integrity, fleet_traces=fleet_traces,
                          slo=slo, timeseries=timeseries,
                          profiler=profiler, fleet_slo=fleet_slo)
    return srv._start()
