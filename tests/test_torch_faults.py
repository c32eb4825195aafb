"""The port's fault injection, retry, metrics and tracing pieces against the
JAX package's.

The same ``FaultSpec`` schedule fires at the same occurrences in both
packages; a bitflip on a torch tensor flips the byte and bit the JAX kind
flips on an equal numpy array (compared bitwise through an integer view);
``poison_request`` matches on content; ``backoff_delays`` and ``retry``
draw the same delays from the same seed; ``merge_traces`` of equivalent
rings gives the same structure (ids differ by their per-tracer nonce)."""
import importlib
import itertools
import random

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.tracing as jax_tracing
import paddle_tpu.resilience.faults as jax_faults
import paddle_tpu.serving.metrics as jax_serving_metrics
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.observability.tracing as port_tracing
import paddle_tpu_torch.resilience.faults as port_faults
import paddle_tpu_torch.serving.metrics as port_serving_metrics

# each package's ``resilience`` exports a ``retry`` function that shadows
# its ``retry`` module as an attribute
jax_retry = importlib.import_module("paddle_tpu.resilience.retry")
port_retry = importlib.import_module("paddle_tpu_torch.resilience.retry")

PACKAGES = {"jax": (jax_faults, jax_retry, jax_tracing, jax_metrics,
                    jax_serving_metrics),
            "port": (port_faults, port_retry, port_tracing, port_metrics,
                     port_serving_metrics)}


def _both(fn):
    a, b = fn("jax"), fn("port")
    assert b == a
    return b


# ------------------------------------------------------------- faults


def _schedule(pkg):
    faults = PACKAGES[pkg][0]
    specs = [faults.FaultSpec("a.site", "io_error", occurrence=2),
             faults.FaultSpec("a.site", "stall", occurrence=3,
                              stall_s=0.001),
             faults.FaultSpec("b.site", "kill", occurrence=2),
             faults.FaultSpec("a.site", "io_error", occurrence=5)]
    seen = []
    with faults.injected_faults(*specs, seed=3) as inj:
        for site in ["a.site", "b.site"] * 3 + ["a.site"] * 3:
            try:
                faults.fault_point(site)
                seen.append(None)
            except OSError as e:
                seen.append(("OSError", str(e)))
            except faults.SimulatedCrash as e:
                seen.append(("SimulatedCrash", e.site, e.occurrence))
        hits = (inj.hits("a.site"), inj.hits("b.site"))
        fired = inj.fired
    assert faults.current_injector() is None
    return {"seen": seen, "hits": hits, "fired": fired}


def test_schedule_fires_at_the_same_occurrences():
    got = _both(_schedule)
    assert got["hits"] == (6, 3)
    assert [f[1:] for f in got["fired"]] == [
        ("io_error", 2), ("kill", 2), ("stall", 3), ("io_error", 5)]


def _env(pkg, monkeypatch):
    faults = PACKAGES[pkg][0]
    monkeypatch.setenv("PADDLE_TPU_FAULTS",
                       "serving.step:io_error:3, serving.admit:stall")
    monkeypatch.setenv("PADDLE_TPU_FAULTS_SEED", "7")
    try:
        inj = faults.install_from_env()
        return (inj.seed, [(s.site, s.kind, s.occurrence)
                           for s in inj.specs])
    finally:
        faults.uninstall()


def test_env_gate_parses_alike(monkeypatch):
    got = _both(lambda pkg: _env(pkg, monkeypatch))
    assert got == (7, [("serving.step", "io_error", 3),
                       ("serving.admit", "stall", 1)])


def _flip_numpy(leaves, seed, **spec_kw):
    """The JAX kind on a tree of jax arrays: returns the tree after."""
    tree = {k: jnp.asarray(v) for k, v in leaves.items()}
    with jax_faults.injected_faults(jax_faults.FaultSpec(
            "x", "bitflip", **spec_kw), seed=seed):
        jax_faults.fault_point("x", tree=tree)
    return {k: np.asarray(v) for k, v in tree.items()}


def _flip_torch(leaves, seed, **spec_kw):
    tree = {k: torch.from_numpy(np.array(v, copy=True).view(
        _INT[v.dtype.itemsize])).view(_TORCH[v.dtype])
        for k, v in leaves.items()}
    before = {k: t.data_ptr() for k, t in tree.items()}
    with port_faults.injected_faults(port_faults.FaultSpec(
            "x", "bitflip", **spec_kw), seed=seed):
        port_faults.fault_point("x", tree=tree)
    # in place: the leaves are the very tensors that went in
    assert {k: t.data_ptr() for k, t in tree.items()} == before
    return {k: t.view(_TORCH_INT[t.element_size()]).numpy()
            for k, t in tree.items()}


_INT = {2: np.int16, 4: np.int32}
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(ml_dtypes.bfloat16): torch.bfloat16}
_TORCH_INT = {2: torch.int16, 4: torch.int32}


@pytest.mark.faultinject
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("seed", [0, 1, 5, 11])
def test_bitflip_flips_the_same_bit_as_jax(seed, dtype):
    rng = np.random.RandomState(seed)
    leaves = {"k_pages": rng.standard_normal((2, 3, 4, 2, 5)).astype(dtype),
              "v_pages": rng.standard_normal((2, 3, 4, 2, 5)).astype(dtype)}
    ints = {k: v.view(_INT[v.dtype.itemsize]).copy()
            for k, v in leaves.items()}
    jax_after = {k: v.view(_INT[v.dtype.itemsize])
                 for k, v in _flip_numpy(leaves, seed).items()}
    port_after = _flip_torch(leaves, seed)
    for k in leaves:
        np.testing.assert_array_equal(port_after[k], jax_after[k])
    # exactly one bit of one leaf changed
    diff = sum(int(np.unpackbits((a ^ ints[k]).view(np.uint8)).sum())
               for k, a in port_after.items())
    assert diff == 1


@pytest.mark.faultinject
def test_bitflip_pinned_leaf_and_bit():
    leaves = {"k_pages": np.arange(12, dtype=np.float32),
              "v_pages": np.ones(12, np.float32)}
    kw = dict(leaf="v_pages", bit=8 * 4 * 3 + 30)   # element 3, bit 30
    jax_after = _flip_numpy(leaves, 0, **kw)
    port_after = _flip_torch(leaves, 0, **kw)
    np.testing.assert_array_equal(port_after["v_pages"],
                                  jax_after["v_pages"].view(np.int32))
    assert port_after["v_pages"][3] == np.float32(1).view(np.int32) ^ \
        (1 << 30)
    with pytest.raises(KeyError):
        _flip_torch(leaves, 0, leaf="q_pages")


def _poison(pkg):
    faults = PACKAGES[pkg][0]
    out = []
    with faults.injected_faults(
            faults.FaultSpec("serving.step", "poison_request",
                             pattern=(7, 8, 9)),
            faults.FaultSpec("other", "poison_request"), seed=4) as inj:
        for streams in ([[1, 2, 7, 8]], [[5, 7, 8, 9, 1]], [[7, 8], [9]],
                        [[0, 7, 8, 9]]):
            try:
                faults.fault_point("serving.step", tokens=streams)
                out.append(None)
            except faults.PoisonRequestError as e:
                out.append((e.pattern, e.occurrence, str(e)))
        seeded = inj._poison_pattern(inj.specs[1])
        fired = inj.fired
    return {"out": out, "seeded": seeded, "fired": fired}


@pytest.mark.faultinject
def test_poison_request_matches_on_content():
    got = _both(_poison)
    assert [o is not None for o in got["out"]] == [False, True, False, True]
    assert isinstance(port_faults.PoisonRequestError("s", (1,), 1), OSError)
    assert len(got["seeded"]) == 3


# -------------------------------------------------------------- retry


def _delays(pkg):
    retry = PACKAGES[pkg][1]
    out = {}
    for seed in (0, 1, 2):
        out[seed] = list(itertools.islice(retry.backoff_delays(
            base=0.05, cap=2.0, rng=random.Random(seed)), 12))
    out["plain"] = list(itertools.islice(retry.backoff_delays(
        base=0.01, factor=3.0, cap=0.5, jitter=False), 6))
    return out


def test_backoff_delays_equal_jax():
    got = _both(_delays)
    assert got["plain"] == [0.01, 0.03, 0.09, 0.27, 0.5, 0.5]


def _retry(pkg):
    retry = PACKAGES[pkg][1]
    calls = []

    @retry.retry(max_attempts=3, base=1e-4, cap=1e-4,
                 rng=random.Random(0), name="flaky")
    def flaky(n_fail):
        calls.append(n_fail)
        if len(calls) <= n_fail:
            raise OSError("transient")
        return len(calls)

    ok = flaky(2)
    calls.clear()
    with pytest.raises(retry.RetryError) as exc:
        flaky(5)
    dl = retry.Deadline(None)
    gone = retry.Deadline(0.0)
    return {"ok": ok, "attempts": exc.value.attempts,
            "last": repr(exc.value.last), "inf": dl.remaining(),
            "expired": (dl.expired(), gone.expired(), gone.sleep(1.0)),
            "repr": repr(dl)}


def test_retry_and_deadline_equal_jax():
    got = _both(_retry)
    assert got["ok"] == 3 and got["attempts"] == 3
    assert got["expired"] == (False, True, 0.0)


# ----------------------------------------------------- metrics, traces


def _router_metrics(pkg):
    metrics, serving_metrics = PACKAGES[pkg][3], PACKAGES[pkg][4]
    reg = metrics.MetricsRegistry()
    m = serving_metrics.RouterMetrics(registry=reg)
    m.dispatches.labels(replica="0").inc()
    m.dispatches.labels(replica="1").inc(2)
    m.failovers.labels(replica="1", reason="io_error").inc()
    m.breaker_open.labels(replica="1").set(1)
    m.ttft.observe(0.25)
    m.ttft.observe(0.5)
    a = serving_metrics.AutoscalerMetrics(registry=reg)
    a.scale_events.labels(direction="up", reason="pressure").inc()
    g = reg.gauge("g")
    g.inc(3)
    g.dec()
    h = reg.histogram("h", labelnames=("k",)).labels(k="x")
    for v in (1.0, 2.0, 4.0):
        h.observe(v)
    with pytest.raises(ValueError):
        m.dispatches.inc()
    return {"router": m.snapshot(), "autoscaler": a.snapshot(),
            "registry": reg.snapshot(), "gauge": (g.value, g.peak),
            "hist": (h.mean, h.percentile(50), h.percentile(99)),
            "get": reg.get("g") is g}


def test_router_metric_facades_equal_jax():
    got = _both(_router_metrics)
    assert got["router"]["dispatches"] == {"0": 1, "1": 2}
    assert got["router"]["failovers"] == {"1,io_error": 1}
    assert got["gauge"] == (2.0, 3.0) and got["get"]


def _trace_shape(merged):
    shape = []
    for tr in merged:
        names = {s["span_id"]: s["name"] for s in tr["spans"]}
        shape.append({
            "name": tr["name"], "retained": tr["retained"],
            "window": (tr["start_s"], tr["end_s"], tr["duration_s"]),
            "segments": [(g["source"], g["name"], g["root_local"],
                          g["n_spans"]) for g in tr["segments"]],
            "spans": [(s["source"], s["name"], names.get(s["parent_id"]),
                       s["start_s"], s["end_s"], s["attributes"])
                      for s in tr["spans"]]})
    return shape


def _rings(pkg):
    tracing = PACKAGES[pkg][2]
    clock = [0.0]
    router = tracing.Tracer(clock=lambda: clock[0])
    replica = tracing.Tracer(clock=lambda: clock[0])
    root = router.start_trace("fleet#0", attributes={"request_id": 0})
    d = router.start_span("router::dispatch", root)
    with tracing.activate(d):
        assert tracing.active_span() is d
        seg = replica.start_trace("request#0", context=d.context())
    clock[0] = 1.0
    replica.start_span("decode[0]", seg).end(1.5)
    d.end(0.5)
    seg.set_attributes({"state": "evacuated"}).end(2.0)
    router.start_span("router::failover", root, start_s=2.0).end(2.0)
    live = [s["name"] for s in router.live_spans()]
    root.set_attribute("redispatches", 1).end(3.0)
    boring = router.start_trace("fleet#1")
    boring.end(3.5)
    ctx = tracing.TraceContext.from_dict(d.context().to_dict())
    return {"merged": _trace_shape(tracing.merge_traces(
        [("router", router.traces()), ("replica0", replica.traces())])),
        "live": live, "summary": router.summary(),
        "ctx_ok": ctx == d.context(), "null": tracing.Tracer(
            enabled=False).start_trace("x").context()}


def test_merge_traces_same_structure_as_jax():
    got = _both(_rings)
    fleet = got["merged"][0]
    assert fleet["name"] == "fleet#0" and fleet["retained"] == "failover"
    assert [g[0] for g in fleet["segments"]] == ["router", "replica0"]
    assert ("replica0", "request#0", "router::dispatch") in [
        s[:3] for s in fleet["spans"]]
    assert got["live"] == ["fleet#0"] and got["ctx_ok"]
    assert got["null"] is None


def test_tail_retention_classifies_alike():
    entries = [{"spans": [{"attributes": a}], "duration_s": d}
               for a, d in (({}, 0.1), ({"error": "x"}, 0.1),
                            ({"faults": [1]}, 0.1), ({"state": "failed"},
                                                     0.1),
                            ({"redispatches": 2}, 0.1),
                            ({"finish_reason": "deadline"}, 0.1),
                            ({}, 9.0))]
    for cls_j, cls_p in ((jax_tracing.TailRetention,
                          port_tracing.TailRetention),):
        j, p = cls_j(slow_threshold_s=1.0, sample_rate=0.5, seed=3), \
            cls_p(slow_threshold_s=1.0, sample_rate=0.5, seed=3)
        assert [p.classify(e) for e in entries] == \
            [j.classify(e) for e in entries]
        assert [p.sample() for _ in range(20)] == \
            [j.sample() for _ in range(20)]
