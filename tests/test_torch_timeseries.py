"""The port's ``TimeSeriesStore`` against the JAX package's, mirroring
``tests/test_timeseries.py`` test for test.

Every scenario is written once against a package namespace and run
twice on the same scripted history of counter, gauge and histogram
writes, each package's registry and store on its own manual clock
advanced alike: every query (``delta``, ``rate``, ``avg``, ``slope``,
``latest``, ``quantile``, ``good_below``, ``query``, ``stats``) must
return the same numbers in both — exactly, with no tolerance: the two
stores run the same float arithmetic in the same order.  The JAX test's
hand-computed values are then asserted on the port's result."""
import threading
import time
import types

import pytest

import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.timeseries as jax_timeseries
import paddle_tpu.serving.metrics as jax_serving_metrics
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.observability.timeseries as port_timeseries
import paddle_tpu_torch.serving.metrics as port_serving_metrics

JAX = types.SimpleNamespace(
    metrics=jax_metrics, TimeSeriesStore=jax_timeseries.TimeSeriesStore,
    ServingMetrics=jax_serving_metrics.ServingMetrics)
PORT = types.SimpleNamespace(
    metrics=port_metrics, TimeSeriesStore=port_timeseries.TimeSeriesStore,
    ServingMetrics=port_serving_metrics.ServingMetrics)


class _ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _store(pkg, **kw):
    clock = _ManualClock()
    reg = pkg.metrics.MetricsRegistry()
    return reg, clock, pkg.TimeSeriesStore(registry=reg, clock=clock, **kw)


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages; equal results required
    (exceptions are compared by type)."""
    out = []
    for pkg in (JAX, PORT):
        try:
            out.append(scenario(pkg))
        except Exception as e:      # noqa: BLE001 - compared below
            out.append(("raised", type(e).__name__))
    assert out[1] == out[0]
    return out[1]


def _stats(store):
    """``stats()`` with its timestamps (manual clock: equal anyway)."""
    return store.stats()


# ------------------------------------------------------ budget & hygiene


class TestBudgetAndHygiene:
    def test_nothing_starts_on_construction(self):
        before = {t.name for t in threading.enumerate()}
        _, _, store = _store(PORT)
        after = {t.name for t in threading.enumerate()}
        assert store._thread is None
        assert after == before

    def test_max_points_ring_bounded(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg, max_points=16)
            c = reg.counter("beats_total")
            for _ in range(50):
                clock.advance(1.0)
                c.inc()
                store.scrape_once()
            return _stats(store), store.delta("beats_total", window_s=10.0)

        stats, delta = _both(scenario)
        assert stats["points"] == 16 and stats["scrapes"] == 50
        assert delta == 10.0

    def test_retention_drops_old_points(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg, retention_s=5.0)
            g = reg.gauge("level")
            for i in range(20):
                clock.advance(1.0)
                g.set(float(i))
                store.scrape_once()
            return _stats(store), clock.t

        stats, now = _both(scenario)
        (entry,) = stats["names"]
        assert entry["first_t"] >= now - 5.0
        assert entry["points"] <= 6

    def test_max_series_budget_is_fixed(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg, max_series=2)
            reg.counter("a_total"), reg.counter("b_total")
            clock.advance(1.0)
            store.scrape_once()
            reg.counter("c_total").inc()
            clock.advance(1.0)
            store.scrape_once()
            return _stats(store), store.delta("c_total", window_s=60.0)

        stats, delta = _both(scenario)
        assert stats["series"] == 2 and stats["dropped_series"] >= 1
        assert delta is None

    def test_optin_thread_scrapes_then_stops(self):
        reg = port_metrics.MetricsRegistry()
        reg.counter("beats_total").inc()
        store = port_timeseries.TimeSeriesStore(registry=reg)
        store.start(interval_s=0.005)
        deadline = time.monotonic() + 5.0
        while store.stats()["scrapes"] == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        store.stop()
        assert store.stats()["scrapes"] > 0
        assert store._thread is None


# ----------------------------------------------------- windowed queries


class TestWindowedQueries:
    def test_rate_and_delta_hand_computed(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            c = reg.counter("req_total")
            for _ in range(8):
                clock.advance(1.0)
                c.inc(10)
                store.scrape_once()
            return (store.delta("req_total", window_s=4.0),
                    store.rate("req_total", window_s=4.0),
                    store.latest("req_total"))

        delta, rate, latest = _both(scenario)
        assert delta == 40.0 and rate == pytest.approx(10.0)
        assert latest == 80.0

    def test_delta_none_until_two_points_in_window(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            c = reg.counter("req_total")
            out = [store.delta("req_total", window_s=60.0)]
            clock.advance(1.0)
            c.inc()
            store.scrape_once()
            out.append(store.delta("req_total", window_s=60.0))
            clock.advance(1.0)
            store.scrape_once()
            out.append(store.delta("req_total", window_s=60.0))
            return out

        assert _both(scenario) == [None, None, 0.0]

    def test_family_delta_sums_children_and_labels_select(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            c = reg.counter("dispatch_total", labelnames=("replica",))
            for _ in range(3):
                clock.advance(1.0)
                c.labels(replica="a").inc(2)
                c.labels(replica="b").inc(5)
                store.scrape_once()
            return (store.delta("dispatch_total", window_s=10.0),
                    store.delta("dispatch_total", labels={"replica": "b"},
                                window_s=10.0),
                    store.rate("dispatch_total", window_s=10.0))

        total, b, rate = _both(scenario)
        assert total == 14.0 and b == 10.0 and rate == pytest.approx(7.0)

        def wrong(pkg):
            reg, clock, store = _store(pkg)
            reg.counter("dispatch_total", labelnames=("replica",)).labels(
                replica="a").inc()
            store.scrape_once()
            return store.delta("dispatch_total", labels={"wrong": "x"})

        assert _both(wrong) == ("raised", "ValueError")

    def test_gauge_avg_and_slope_hand_computed(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            g = reg.gauge("mem_bytes")
            for i in range(8):
                clock.advance(1.0)
                g.set(500.0 + 100.0 * i)
                store.scrape_once()
            return (store.avg("mem_bytes", window_s=4.0),
                    store.slope("mem_bytes", window_s=8.0),
                    store.latest("mem_bytes"))

        avg, slope, latest = _both(scenario)
        assert avg == pytest.approx(1000.0)
        assert slope == pytest.approx(100.0)
        assert latest == 1200.0

    def test_avg_ambiguous_across_family_raises(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            g = reg.gauge("depth", labelnames=("q",))
            clock.advance(1.0)
            g.labels(q="a").set(1.0)
            g.labels(q="b").set(2.0)
            store.scrape_once()
            try:
                store.avg("depth")
                ambiguous = False
            except ValueError:
                ambiguous = True
            return ambiguous, store.avg("depth", labels={"q": "b"})

        assert _both(scenario) == (True, 2.0)

    def test_slope_none_without_two_distinct_times(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            g = reg.gauge("level")
            clock.advance(1.0)
            g.set(5.0)
            store.scrape_once()
            return store.slope("level", window_s=60.0)

        assert _both(scenario) is None

    def test_quantile_hand_computed_interpolation(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            h = reg.histogram("lat_seconds", start=1.0, factor=2.0,
                              count=4)
            clock.advance(1.0)
            store.scrape_once()
            for v in (1.5, 1.5, 3.0, 7.0):
                h.observe(v)
            clock.advance(1.0)
            store.scrape_once()
            out = [store.quantile("lat_seconds", p, window_s=5.0)
                   for p in (0, 25, 50, 90, 99, 100)]
            clock.advance(100.0)
            store.scrape_once()
            out.append(store.quantile("lat_seconds", 99, window_s=5.0))
            return out

        got = _both(scenario)
        assert got[2] == pytest.approx(2.0)
        assert got[4] == pytest.approx(7.84)
        assert got[-1] is None

    def test_good_below_snaps_threshold_down(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            h = reg.histogram("lat_seconds", start=1.0, factor=2.0,
                              count=4)
            clock.advance(1.0)
            store.scrape_once()
            for v in (1.5, 1.5, 3.0, 7.0):
                h.observe(v)
            clock.advance(1.0)
            store.scrape_once()
            return [store.good_below("lat_seconds", thr, window_s=5.0)
                    for thr in (2.0, 3.9, 4.0, 100.0)]

        assert _both(scenario) == [(2.0, 4.0), (2.0, 4.0), (3.0, 4.0),
                                   (4.0, 4.0)]

    def test_query_payload_shapes(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            reg.counter("req_total")
            reg.gauge("mem_bytes")
            reg.histogram("lat_seconds")
            for i in range(3):
                clock.advance(1.0)
                reg.counter("req_total").inc(i + 1)
                reg.gauge("mem_bytes").set(float(i))
                reg.histogram("lat_seconds").observe(0.01 * (i + 1))
                store.scrape_once()
            return [store.query(n, window_s=10.0) for n in
                    ("req_total", "mem_bytes", "lat_seconds",
                     "never_registered")]

        counter, gauge, hist, missing = _both(scenario)
        assert counter["kind"] == "counter"
        assert {"latest", "delta", "rate_per_s"} <= set(counter)
        assert gauge["kind"] == "gauge"
        assert {"latest", "avg", "slope_per_s"} <= set(gauge)
        assert hist["kind"] == "histogram"
        assert {"count_delta", "p50", "p99"} <= set(hist)
        assert missing["kind"] is None


# ------------------------------------------------------- counter resets


class TestCounterReset:
    def test_reset_folds_previous_value_into_offset(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            c = reg.counter("req_total")
            for _ in range(5):
                clock.advance(1.0)
                c.inc(10)
                store.scrape_once()
            c2 = pkg.metrics.Counter("req_total")
            reg.register(c2, replace=True)
            clock.advance(1.0)
            c2.inc(3)
            store.scrape_once()
            return (store.delta("req_total", window_s=4.0),
                    _stats(store)["resets"], store.latest("req_total"))

        assert _both(scenario) == (33.0, 1, 53.0)

    def test_real_serving_metrics_rebuild_mid_soak(self):
        def scenario(pkg):
            reg = pkg.metrics.MetricsRegistry()
            clock = _ManualClock()
            store = pkg.TimeSeriesStore(registry=reg, clock=clock)
            sm = pkg.ServingMetrics(registry=reg)
            for _ in range(4):
                clock.advance(1.0)
                sm.requests_submitted.inc(5)
                store.scrape_once()
            sm2 = pkg.ServingMetrics(registry=reg)
            for _ in range(2):
                clock.advance(1.0)
                sm2.requests_submitted.inc(2)
                store.scrape_once()
            return (store.delta("serving_requests_submitted_total",
                                window_s=100.0), _stats(store))

        d, stats = _both(scenario)
        assert d == 19.0 and stats["resets"] >= 1

    def test_histogram_reset_keeps_window_quantiles_sane(self):
        def scenario(pkg):
            reg, clock, store = _store(pkg)
            h = reg.histogram("lat_seconds", start=1.0, factor=2.0,
                              count=4)
            clock.advance(1.0)
            store.scrape_once()
            h.observe(1.5)
            h.observe(1.5)
            clock.advance(1.0)
            store.scrape_once()
            h2 = pkg.metrics.Histogram("lat_seconds", start=1.0,
                                       factor=2.0, count=4)
            reg.register(h2, replace=True)
            h2.observe(7.0)
            clock.advance(1.0)
            store.scrape_once()
            return (store.delta("lat_seconds", window_s=10.0),
                    store.quantile("lat_seconds", 99, window_s=10.0),
                    _stats(store)["resets"])

        delta, p99, resets = _both(scenario)
        assert delta == 3.0 and p99 > 4.0 and resets == 1
