"""The port's autoscaler against the JAX package's, on the same stub fleets.

The scenarios of ``tests/test_autoscaler.py`` (engine-shaped stubs with
hand-set drain, decode rate and radix summary; a manual clock) run once
through ``paddle_tpu.serving`` and once through ``paddle_tpu_torch.
serving``.  Every tick's decision, the scale-event log (time, direction,
reason, replica, pressure), the target and ready counts and the replica
states must be equal exactly.  One scenario uses real engines: the
drain floor surviving ``Engine.warmup()`` on a port engine and a JAX
engine built alike."""
import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.resilience as jax_resilience
import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.resilience as port_resilience
import paddle_tpu_torch.serving as port_serving
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax

torch.set_num_threads(1)

STACKS = {
    "jax": (jax_serving, jax_metrics, jax_resilience),
    "port": (port_serving, port_metrics, port_resilience),
}


class _ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


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
    """Engine-shaped stub with hand-set router signals (the JAX suite's):
    ``drain`` is the advertised estimate, ``rate=None`` means warming,
    ``summary`` the radix payload.  Request states are the strings both
    packages' ``RequestState`` use."""

    def __init__(self, rate=120.0, drain=0.0, summary=None):
        self.rate = rate
        self.drain = drain
        self.summary = summary if summary is not None else {
            "page_size": 8, "enabled": True, "entries": {}, "stats": {}}
        self.reqs = []
        self.warmed = 0

    def health(self):
        return {"healthy": True, "queue_depth": 0,
                "running": len(self.reqs), "page_occupancy": 0.0,
                "estimated_drain_s": self.drain,
                "decode_rate_tok_s": self.rate,
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
                req.finish_reason = "length"
        self.reqs = [r for r in self.reqs if r.state != "finished"]

    def evacuate(self):
        for req in self.reqs:
            req.state = "evacuated"
        self.reqs = []

    def prefix_summary(self, max_entries=32):
        return self.summary

    def warmup(self):
        self.warmed += 1
        return self


def _stub_factory(**kw):
    return lambda: _StubEngine(**kw)


def _summary(entries):
    return {"page_size": 8, "enabled": True, "entries": entries,
            "stats": {"cached_pages": len(entries)}}


class _Run:
    """One scenario on one package: its router and autoscaler, and the
    log every tick appends to."""

    def __init__(self, pkg, engines, *, factory=None, scaler_kw=None,
                 **router_kw):
        serving, metrics, resilience = STACKS[pkg]
        self.serving = serving
        self.RS = serving.ReplicaState
        self.FaultSpec = resilience.FaultSpec
        self.faults = resilience.injected_faults
        self.clock = _ManualClock()
        registry = metrics.MetricsRegistry()
        self.router = serving.FleetRouter(engines, clock=self.clock,
                                          registry=registry, **router_kw)
        kw = dict(min_replicas=1, max_replicas=4, up_pressure_s=2.0,
                  down_pressure_s=0.25, up_pending_depth=6,
                  scale_up_cooldown_s=5.0, scale_down_cooldown_s=10.0,
                  spawn_backoff_base_s=0.001, spawn_backoff_cap_s=0.002)
        kw.update(scaler_kw or {})
        self.scaler = serving.Autoscaler(
            self.router, factory or _stub_factory(), clock=self.clock,
            registry=registry, **kw)
        self.log = []

    def tick(self):
        decision = self.scaler.tick()
        st = self.scaler.status()
        sig = st["last_signals"] or {}
        self.log.append({
            "decision": decision, "target": st["target_replicas"],
            "ready": sig.get("ready"), "healthy": sig.get("healthy"),
            "warming": sig.get("warming"),
            "pressure": sig.get("pressure_s"),
            "cascade": sig.get("cascade_open"),
            "states": [rep.state for rep in self.router.replicas]})
        return decision

    def result(self):
        st = self.scaler.status()
        return {"log": self.log, "events": st["events"],
                "scale_events": st["scale_events"],
                "spawn_failures": st["spawn_failures"],
                "target": st["target_replicas"],
                "metrics": self.scaler.metrics.snapshot(),
                "states": [rep.state for rep in self.router.replicas]}


def _both(scenario):
    jax_out = scenario("jax")
    port_out = scenario("port")
    assert port_out == jax_out
    return port_out


# ---------------------------------------------------------- scenarios


def _boundary_oscillation(pkg):
    stubs = [_StubEngine(), _StubEngine()]
    run = _Run(pkg, stubs)
    for i in range(40):
        drain = (run.scaler.up_pressure_s if i % 2 == 0
                 else run.scaler.down_pressure_s)
        for stub in stubs:
            stub.drain = drain
        run.clock.advance(30.0)
        run.tick()
    return run.result()


def _above_then_below(pkg):
    stub = _StubEngine()
    run = _Run(pkg, [stub])
    stub.drain = run.scaler.up_pressure_s + 0.01
    run.tick()
    stub.drain = run.scaler.down_pressure_s - 0.01
    run.router.replicas[1].engine.rate = 100.0
    run.clock.advance(run.scaler.scale_down_cooldown_s + 0.1)
    run.tick()
    return run.result()


def _burst_then_cooldown_down(pkg):
    stub = _StubEngine()
    run = _Run(pkg, [stub], factory=_stub_factory(rate=100.0))
    stub.drain = 5.0
    run.tick()
    stub.drain = 0.0
    for _ in range(9):
        run.clock.advance(1.0)
        run.tick()
    run.clock.advance(1.5)
    run.tick()
    return run.result()


def _warming_not_capacity(pkg):
    run = _Run(pkg, [_StubEngine(drain=3.0)],
               factory=_stub_factory(rate=None, drain=0.5),
               scaler_kw={"max_replicas": 2})
    run.tick()
    run.clock.advance(1.0)
    run.tick()
    run.router.replicas[1].engine.rate = 80.0
    run.clock.advance(1.0)
    run.tick()
    return run.result()


def _spawn_gets_router_warmup(pkg):
    warmed = []
    run = _Run(pkg, [_StubEngine(drain=5.0)],
               factory=_stub_factory(rate=None),
               warmup=lambda eng: warmed.append(eng.warmup()))
    run.tick()
    out = run.result()
    out["warmed"] = [w.warmed for w in warmed]
    out["warmed_is_new"] = warmed[0] is run.router.replicas[1].engine
    return out


def _coldest_first(pkg):
    run = _Run(pkg, [_StubEngine(summary=_summary({"a": 64, "b": 32})),
                     _StubEngine(summary=_summary({})),
                     _StubEngine(summary=_summary({"c": 16}))])
    run.clock.advance(60.0)
    run.tick()
    return run.result()


def _tie_youngest(pkg):
    run = _Run(pkg, [_StubEngine(summary=_summary({})) for _ in range(3)])
    run.clock.advance(60.0)
    run.tick()
    return run.result()


def _spawn_retry(pkg):
    run = _Run(pkg, [_StubEngine(drain=5.0)],
               factory=_stub_factory(rate=100.0),
               scaler_kw={"spawn_max_retries": 2})
    with run.faults(run.FaultSpec("autoscaler.scale_up", "io_error",
                                  occurrence=1)) as inj:
        run.tick()
        fired = inj.fired
    out = run.result()
    out["fired"] = fired
    return out


def _spawn_budget(pkg):
    run = _Run(pkg, [_StubEngine(drain=5.0)],
               scaler_kw={"spawn_max_retries": 1})
    with run.faults(*[run.FaultSpec("autoscaler.scale_up", "io_error",
                                    occurrence=i) for i in (1, 2)]) as inj:
        run.tick()
        fired = inj.fired
    out = run.result()
    out["fired"] = fired
    out["events"] = [{k: v for k, v in e.items() if k != "error"}
                     for e in out["events"]]
    return out


def _dead_fleet_revive(pkg):
    run = _Run(pkg, [_stub_factory(rate=50.0)])
    run.router.kill_replica(0)
    run.router.step()
    run.router.step()
    run.clock.advance(0.1)
    run.tick()
    return run.result()


def _storm(pkg):
    run = _Run(pkg, [_stub_factory() for _ in range(3)],
               factory=_stub_factory(), cascade_threshold=2,
               cascade_window_s=50.0)
    run.router.kill_replica(0)
    run.router.kill_replica(1)
    for _ in range(2):
        run.router.step()
    return run


def _breaker_vetoes_up(pkg):
    run = _storm(pkg)
    run.router.replicas[2].engine.drain = run.scaler.up_pressure_s * 10
    for _ in range(6):
        run.clock.advance(5.0)
        run.router.step()
        run.tick()
    out = run.result()
    out["cascade_open"] = run.router.cascade_open()
    return out


def _burst_after_breaker_closes(pkg):
    run = _storm(pkg)
    run.router.replicas[2].engine.drain = run.scaler.up_pressure_s * 10
    run.clock.advance(1.0)
    run.router.step()
    run.tick()
    run.clock.advance(60.0)
    run.router.step()
    closed = not run.router.cascade_open()
    run.tick()
    out = run.result()
    out["closed"] = closed
    return out


def _zero_healthy_recovery(pkg):
    run = _Run(pkg, [_stub_factory(), _stub_factory()],
               factory=_stub_factory(), cascade_threshold=2,
               cascade_window_s=50.0)
    run.router.kill_replica(0)
    run.router.kill_replica(1)
    for _ in range(2):
        run.router.step()
    run.clock.advance(0.1)
    run.tick()
    out = run.result()
    out["cascade_open"] = run.router.cascade_open()
    return out


def _status_block(pkg):
    run = _Run(pkg, [_StubEngine(drain=5.0)],
               factory=_stub_factory(rate=100.0))
    run.tick()
    block = run.router.fleet_status()["autoscaler"]
    out = run.result()
    out["block"] = block
    out["traces"] = [t["name"] for t in run.scaler.tracer.traces()]
    return out


SCENARIOS = {
    "boundary_oscillation": (_boundary_oscillation, lambda r: (
        r["scale_events"] == {"up": 0, "down": 0}
        and r["metrics"]["scale_events"] == {}
        and len(r["states"]) == 2)),
    "above_then_below": (_above_then_below, lambda r: [
        e["decision"] for e in r["log"]] == [("up", "pressure"),
                                             ("down", "idle")]),
    "burst_then_cooldown_down": (_burst_then_cooldown_down, lambda r: (
        [e["decision"] for e in r["log"]]
        == [("up", "pressure")] + [None] * 9 + [("down", "idle")]
        and r["events"][-1]["time"] - r["events"][0]["time"] >= 10.0
        and r["states"].count("healthy") == 1)),
    "warming_not_capacity": (_warming_not_capacity, lambda r: (
        r["log"][1]["ready"] == 1 and r["log"][1]["warming"] == [1]
        and r["log"][1]["pressure"] == pytest.approx(3.0)
        and r["log"][2]["ready"] == 2
        and r["log"][2]["pressure"] == pytest.approx(1.75))),
    "spawn_gets_router_warmup": (_spawn_gets_router_warmup, lambda r: (
        r["warmed"] == [1] and r["warmed_is_new"])),
    "coldest_first": (_coldest_first, lambda r: (
        r["events"][-1]["replica"] == 1
        and r["events"][-1]["victim_warm_tokens"] == 0
        and r["states"][0] == r["states"][2] == "healthy")),
    "tie_youngest": (_tie_youngest, lambda r: (
        r["events"][-1]["replica"] == 2)),
    "spawn_retry": (_spawn_retry, lambda r: (
        len(r["states"]) == 2 and r["spawn_failures"] == 0
        and r["scale_events"] == {"up": 1, "down": 0}
        and len(r["fired"]) == 1)),
    "spawn_budget": (_spawn_budget, lambda r: (
        len(r["states"]) == 1 and r["spawn_failures"] == 1
        and r["scale_events"] == {"up": 0, "down": 0}
        and r["metrics"]["spawn_failures"] == 1)),
    "dead_fleet_revive": (_dead_fleet_revive, lambda r: (
        r["log"][-1]["decision"] == ("up", "no_capacity")
        and r["states"] == ["healthy"])),
    "breaker_vetoes_up": (_breaker_vetoes_up, lambda r: (
        r["scale_events"] == {"up": 0, "down": 0} and r["cascade_open"]
        and all(e["cascade"] for e in r["log"]) and len(r["states"]) == 3)),
    "burst_after_breaker_closes": (_burst_after_breaker_closes, lambda r: (
        [e["decision"] for e in r["log"]] == [None, ("up", "pressure")]
        and r["closed"] and len(r["states"]) == 3)),
    "zero_healthy_recovery": (_zero_healthy_recovery, lambda r: (
        r["log"][-1]["decision"] == ("up", "no_capacity")
        and r["cascade_open"] and r["states"].count("healthy") == 1)),
    "status_block": (_status_block, lambda r: (
        r["block"]["scale_events"] == {"up": 1, "down": 0}
        and r["block"]["target_replicas"] == 2
        and r["block"]["events"][-1]["reason"] == "pressure"
        and "autoscaler::scale" in r["traces"])),
}


@pytest.mark.faultinject
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_autoscaler_matches_jax(name):
    scenario, check = SCENARIOS[name]
    assert check(_both(scenario))


def _engine_floor(pkg):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    kw = dict(page_size=8, num_pages=64, max_batch_size=2, chunk_len=8)
    if pkg == "jax":
        eng = jax_serving.Engine(jcfg, jparams, **kw)
    else:
        cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
        eng = port_serving.Engine(cfg, params_from_jax(jparams, "cpu"),
                                  device="cpu", **kw)
    serving = STACKS[pkg][0]
    eng.warmup()
    after_warmup = (eng.has_work(), eng.decode_rate(),
                    eng.health()["decode_rate_tok_s"],
                    eng.estimated_drain_s() >= eng.drain_floor_s)
    out = eng.generate([[5, 6, 7]], serving.SamplingParams(
        max_new_tokens=3))
    return {"after_warmup": after_warmup, "out": out,
            "measured": eng.decode_rate() is not None,
            "drain": eng.estimated_drain_s()}


def test_drain_floor_survives_warmup_on_a_real_engine():
    """warmup() runs a real request, then resets the decode EWMA: the
    engine advertises its drain floor (decode rate None) until a real
    decode step measures the rate, in both packages."""
    got = _both(_engine_floor)
    assert got["after_warmup"] == (False, None, None, True)
    assert got["measured"] and got["drain"] == 0.0


def test_slo_hooks_wait_for_their_slice():
    """slo=, timeseries= and burn_feedback= came with the observability/
    SLO slice: the port takes them as the JAX package does — the
    autoscaler reads the engine's alerts and budget into its signals,
    and the traffic hook's live factor equals the JAX generator's for
    the same burn (the trace itself is untouched)."""
    from paddle_tpu_torch.observability.timeseries import TimeSeriesStore

    class _SLO:
        def alerts_active(self):
            return [("availability", "ticket")]

        def min_budget_ratio(self):
            return 0.5

    reg = port_metrics.MetricsRegistry()
    router = port_serving.FleetRouter([_StubEngine()], registry=reg)
    scaler = port_serving.Autoscaler(
        router, slo=_SLO(), timeseries=TimeSeriesStore(registry=reg),
        registry=reg)
    scaler.tick()
    sig = scaler.status()["last_signals"]
    assert sig["slo_alerts"] == [("availability", "ticket")]
    assert sig["slo_min_budget"] == 0.5 and sig["slo_page"] is False
    for burn in (0.5, 4.0, 50.0):
        port = port_serving.TrafficGenerator(burn_feedback=lambda: burn)
        ref = jax_serving.TrafficGenerator(burn_feedback=lambda: burn)
        assert port.live_factor() == ref.live_factor()
        assert [dataclasses.asdict(a) for a in port.trace(5.0)] == \
            [dataclasses.asdict(a) for a in ref.trace(5.0)]
