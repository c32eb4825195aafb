"""The port's compressed chaos soak, mirroring ``tests/test_soak.py``'s
``TestCompressedSoak``: a seeded diurnal/bursty trace through an
autoscaled fleet of port ``Engine``s (``tiny`` fp32 on the CPU, the JAX
``gpt_init`` parameters carried across with ``params_from_jax``) while
the chaos timeline fires kills, admission and control-loop stalls, a
spawn io_error, a KV-page bitflip and a poison storm.

The soak replays arrivals in wall time, so only its input is
deterministic: each test first holds the port's
``TrafficGenerator.trace`` equal to the JAX generator's for the same
seed (every arrival's time, prompt, decode budget and thinning uniform
``u``), then runs the port's ``run_soak`` and asserts the JAX test's
invariants on the report: ``lost_requests == 0``, bounded TTFT p99,
scale events both ways, every chaos event on the live-scraped
``/flight``, one trace per failed-over request on ``/traces?fleet=1``,
poison containment with innocents token-identical to the JAX greedy
oracle, the availability page firing and clearing on ``/slo``, and the
page's profile capture linked to its ``slo::`` trace on ``/profilez``."""
import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.serving as jax_serving
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_forward as jax_gpt_forward
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.slo import SLO, BurnRateAlert
from paddle_tpu_torch.serving import (ChaosEvent, Engine, TrafficGenerator,
                                      run_soak)

torch.set_num_threads(1)

_SCALER_KW = dict(min_replicas=1, max_replicas=3, up_pressure_s=1.0,
                  down_pressure_s=0.15, up_pending_depth=4,
                  scale_up_cooldown_s=1.5, scale_down_cooldown_s=2.0,
                  spawn_max_retries=2, spawn_backoff_base_s=0.01,
                  spawn_backoff_cap_s=0.05)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, params_from_jax(jparams, device="cpu"), jcfg, jparams


_ORACLE_FWD = {}


def jax_greedy(jcfg, jparams, prompt, n_new):
    """The JAX package's greedy tokens for one prompt alone — the
    poison-free oracle of ``tests/test_soak.py``."""
    fwd = _ORACLE_FWD.get(id(jcfg))
    if fwd is None:
        fwd = _ORACLE_FWD.setdefault(
            id(jcfg), jax.jit(lambda p, t: jax_gpt_forward(jcfg, p, t)))
    toks = list(prompt)
    for _ in range(n_new):
        logits = fwd(jparams, jnp.asarray([toks], jnp.int32))
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _engine_factory(tiny_model):
    cfg, params = tiny_model[:2]

    def factory():
        # a small queue watermark so the burst actually sheds — the
        # RETRY_AFTER signal is one of the scale-up triggers under test
        return Engine(cfg, params, page_size=8, num_pages=64,
                      max_batch_size=2, chunk_len=8, shed_queue_high=4,
                      shed_queue_low=1, device="cpu")
    return factory


def _traffic(horizon_s, **kw):
    """The port's generator, after holding its trace equal to the JAX
    generator's for the same arguments (exactly: times, prompts, decode
    budgets and the thinning uniforms)."""
    port = TrafficGenerator(**kw)
    ref = jax_serving.TrafficGenerator(**kw)
    got = [dataclasses.asdict(a) for a in port.trace(horizon_s)]
    want = [dataclasses.asdict(a) for a in ref.trace(horizon_s)]
    assert got == want
    assert port.summary(horizon_s) == ref.summary(horizon_s)
    return port


def _availability(long_s, short_s):
    return (SLO("fleet_availability", target=0.99,
                bad=("router_replica_failure_events_total",
                     "router_requests_lost_total"),
                total=("router_dispatches_total",),
                alerts=(BurnRateAlert("page", burn_rate_threshold=2.0,
                                      long_window_seconds=long_s,
                                      short_window_seconds=short_s,
                                      clear_after_seconds=0.75),),
                budget_window_seconds=30.0),)


@pytest.mark.faultinject
class TestCompressedSoak:
    def test_chaos_soak_invariants(self, tiny_model):
        traffic = _traffic(
            8.0, base_rate_per_s=6.0, diurnal_amplitude=0.9,
            day_period_s=8.0, phase_s=0.0, bursts=((1.0, 2.0, 4.0),),
            n_cohorts=2, cohort_prefix_len=16, cohort_fraction=0.6,
            prompt_len=(8, 24), max_new_tokens=(4, 6),
            vocab_size=tiny_model[0].vocab_size, seed=1234)
        chaos = [ChaosEvent(t=0.5, action="spawn_io_error"),
                 ChaosEvent(t=1.5, action="stall_admit", stall_s=0.4),
                 ChaosEvent(t=2.5, action="kill"),
                 ChaosEvent(t=3.0, action="stall_poll", stall_s=0.3),
                 ChaosEvent(t=3.5, action="bitflip")]
        report = run_soak(
            _engine_factory(tiny_model), traffic, horizon_s=8.0,
            initial_replicas=2, chaos=chaos, registry=MetricsRegistry(),
            scaler_kw=dict(_SCALER_KW), deadline_s=40.0, grace_s=8.0,
            min_down_events=1, ttft_bound_s=25.0)

        assert not report["timed_out"], report
        assert report["requests_submitted"] > 20
        assert report["lost_requests"] == 0, report
        assert report["requests_finished"] == report["requests_submitted"]
        assert report["ttft_p99_s"] is not None
        assert report["ttft_p99_ok"], report["ttft_p99_s"]

        events = report["scale_events"]
        assert events.get("up", 0) >= 1, events
        assert events.get("down", 0) >= 1, events

        assert [ev["action"] for ev in report["chaos"]] == [
            "spawn_io_error", "stall_admit", "kill", "stall_poll",
            "bitflip"]
        fired_sites = {f["site"] for f in report["injector_fired"]}
        assert {"serving.admit", "autoscaler.poll", "autoscaler.scale_up",
                "serving.step"} <= fired_sites
        assert report["requests_quarantined"] == []
        assert report["fleet"]["cascade_breaker_open"] is False
        assert report["loop"]["beats"] > 0
        assert 0.0 < report["loop"]["observe_s"] < report["wall_s"]

        scraped = report["scraped"]
        fleet = scraped["fleet"]
        assert fleet["autoscaler"]["scale_events"]["up"] >= 1
        assert fleet["autoscaler"]["scale_events"]["down"] >= 1
        assert fleet["counters"]["lost"] == 0
        flight = scraped["flight"]
        flight_ops = {rec["op"] for rec in flight["records"]}
        flight_ops |= set(flight["summary"]["by_op"])
        assert {"soak::kill", "soak::stall_admit", "soak::stall_poll",
                "soak::spawn_io_error", "soak::bitflip"} <= flight_ops, \
            flight_ops

        q = scraped["timeseries_query"]
        assert q["kind"] == "counter" and q["delta"] > 0, q
        assert "process_rss_bytes " in scraped["metrics"]

        traces = scraped["traces"]
        assert traces["fleet"] is True
        tids = [t["trace_id"] for t in traces["traces"]]
        assert len(tids) == len(set(tids)), "trace split across entries"
        if report["redispatched"]:
            failed_over = [t for t in traces["traces"]
                           if any(s["name"] == "router::failover"
                                  for s in t["spans"])]
            assert failed_over, "redispatches left no failover trace"
            for t in failed_over:
                names = [s["name"] for s in t["spans"]]
                assert names.count("router::dispatch") >= 2, names
                assert t["retained"] != "sampled", t["retained"]

    def test_poison_storm_containment(self, tiny_model):
        cfg, _, jcfg, jparams = tiny_model
        pattern = (7, 8, 9)
        traffic = _traffic(
            6.0, base_rate_per_s=4.0, diurnal_amplitude=0.5,
            day_period_s=6.0, phase_s=0.0, bursts=(), n_cohorts=2,
            cohort_prefix_len=8, cohort_fraction=0.4, prompt_len=(8, 20),
            max_new_tokens=(4, 6), vocab_size=cfg.vocab_size, seed=99)
        chaos = [ChaosEvent(t=1.0, action="poison_storm",
                            pattern=pattern, count=3, max_new_tokens=6)]
        report = run_soak(
            _engine_factory(tiny_model), traffic, horizon_s=6.0,
            initial_replicas=3, chaos=chaos, registry=MetricsRegistry(),
            router_kw=dict(canary_threshold=2, cascade_threshold=2,
                           cascade_window_s=2.0),
            scaler_kw=dict(_SCALER_KW), deadline_s=40.0, grace_s=8.0,
            min_down_events=0, ttft_bound_s=25.0)

        assert not report["timed_out"], report
        storm_ids = set(report["chaos"][0]["detail"]["request_ids"])
        assert len(storm_ids) == 3
        assert set(report["requests_quarantined"]) == storm_ids
        assert report["lost_requests"] == 0, report
        assert report["requests_failed"] == []

        counters = report["fleet"]["counters"]
        assert counters["failure_events"] <= 3, counters
        assert counters["canary_deaths"] >= 1
        assert counters["quarantined"] == 3
        assert counters["cascade_breaker_opens"] >= 1

        innocents = [r for r in report["requests"]
                     if r["id"] not in storm_ids]
        assert innocents
        assert all(r["state"] == "finished" for r in innocents)
        assert report["requests_finished"] == len(innocents)
        for r in innocents[:6]:
            assert r["output"] == jax_greedy(jcfg, jparams, r["prompt"],
                                             len(r["output"]))

        scraped = report["scraped"]
        assert scraped["fleet"]["quarantined"] == 3
        assert scraped["fleet"]["counters"]["quarantined"] == 3
        retained = [t for t in scraped["traces"]["traces"]
                    if t.get("retained") == "quarantined"]
        assert retained, [t.get("retained")
                          for t in scraped["traces"]["traces"]]
        assert any(s["name"] == "router::quarantine"
                   for t in retained for s in t["spans"])

    def test_kill_storm_fires_and_clears_availability_page(
            self, tiny_model):
        traffic = _traffic(
            6.0, base_rate_per_s=6.0, diurnal_amplitude=0.3,
            day_period_s=8.0, phase_s=0.0, bursts=(), n_cohorts=2,
            cohort_prefix_len=8, cohort_fraction=0.4, prompt_len=(8, 16),
            max_new_tokens=(4, 6), vocab_size=tiny_model[0].vocab_size,
            seed=4321)
        chaos = [ChaosEvent(t=1.5, action="kill"),
                 ChaosEvent(t=2.4, action="kill")]
        report = run_soak(
            _engine_factory(tiny_model), traffic, horizon_s=6.0,
            initial_replicas=2, chaos=chaos, registry=MetricsRegistry(),
            slos=_availability(3.0, 1.0), scaler_kw=dict(_SCALER_KW),
            deadline_s=40.0, grace_s=8.0, min_down_events=0,
            ttft_bound_s=25.0, rss_slope_bound_bytes_per_s=256e6)

        assert not report["timed_out"], report
        assert report["lost_requests"] == 0, report
        slo_report = report["slo"]
        kinds = [t["transition"] for t in slo_report["transitions"]
                 if t["slo"] == "fleet_availability"]
        assert kinds and kinds[0] == "fire" and kinds[-1] == "clear", \
            slo_report
        (alert,) = slo_report["slos"]["fleet_availability"]["alerts"]
        assert alert["fired"] >= 1 and alert["active"] is False
        assert slo_report["page_active"] is False

        scraped = report["scraped"]
        scraped_kinds = [t["transition"]
                         for t in scraped["slo"]["transitions"]]
        assert "fire" in scraped_kinds and "clear" in scraped_kinds
        assert scraped["slo"]["page_active"] is False
        assert scraped["healthz"]["slo_page_active"] is False

        slo_traces = [t for t in scraped["traces"]["traces"]
                      if t["name"] == "slo::fleet_availability"]
        assert {"fire", "clear"} <= {
            t["spans"][0]["attributes"]["transition"] for t in slo_traces}
        assert all(t["retained"] == "flagged" for t in slo_traces)

        assert report["timeseries"]["scrapes"] > 10
        assert report["rss_slope_bytes_per_s"] is not None
        assert report["rss_slope_ok"] is True, \
            report["rss_slope_bytes_per_s"]
        assert scraped["timeseries"]["series"] > 0

    def test_page_arms_profile_capture_and_load_backs_off(
            self, tiny_model):
        traffic = _traffic(
            6.0, base_rate_per_s=6.0, diurnal_amplitude=0.3,
            day_period_s=8.0, phase_s=0.0, bursts=(), n_cohorts=2,
            cohort_prefix_len=8, cohort_fraction=0.4, prompt_len=(8, 16),
            max_new_tokens=(4, 6), vocab_size=tiny_model[0].vocab_size,
            seed=4321)
        chaos = [ChaosEvent(t=1.5, action="kill"),
                 ChaosEvent(t=2.4, action="kill")]
        report = run_soak(
            _engine_factory(tiny_model), traffic, horizon_s=6.0,
            initial_replicas=2, chaos=chaos, registry=MetricsRegistry(),
            slos=_availability(4.0, 2.0), burn_feedback=True,
            scaler_kw=dict(_SCALER_KW), deadline_s=40.0, grace_s=8.0,
            min_down_events=0, ttft_bound_s=25.0)

        assert not report["timed_out"], report
        assert report["lost_requests"] == 0, report
        kinds = [t["transition"] for t in report["slo"]["transitions"]
                 if t["slo"] == "fleet_availability"]
        assert "fire" in kinds, report["slo"]

        prof = report["profiling"]
        assert prof["stats"]["lifetime_samples"] > 0
        caps = [c for c in prof["captures"] if c["trigger"] == "slo_page"]
        assert caps, prof
        cap = caps[0]
        assert cap["detail"] == "fleet_availability"
        assert cap["samples"] > 0 and cap["hot"], cap

        scraped = report["scraped"]
        linked = [t for t in scraped["traces"]["traces"]
                  if t["trace_id"] == cap["trace_id"]]
        assert len(linked) == 1, "capture span missing from the ring"
        span_names = [s["name"] for s in linked[0]["spans"]]
        assert "profiling::capture" in span_names
        assert "slo::fleet_availability" in span_names, span_names
        assert linked[0]["retained"] == "flagged"

        pz = scraped["profilez"]
        assert pz["samples"] > 0
        assert abs(sum(v["seconds"] for v in pz["by_phase"].values())
                   - pz["sampled_seconds"]) < 1e-6
        assert any(c["trigger"] == "slo_page" for c in pz["captures"])

        bf = report["burn_feedback"]
        assert bf["enabled"] is True
        assert bf["dropped"] >= bf["dropped_while_page"] >= 1, bf
