"""The port's serving fleet against the JAX package's, scenario by scenario.

Every scenario is written once and run twice from the same seeds: through
``paddle_tpu.serving.FleetRouter`` over JAX ``Engine``s and through
``paddle_tpu_torch.serving.FleetRouter`` over port ``Engine``s on the
CPU, both on ``tiny`` at fp32 with the JAX ``gpt_init`` parameters
(carried across with ``params_from_jax``), each on its own manual clock
(advanced alike) and a router ``rng`` seeded alike.  Tokens, final
states, router metric counts, fault audit logs and event sequences must
be equal exactly; outputs must also equal a single port engine's (the
oracle).  The fleet tests of the JAX package (``tests/test_fleet.py``,
``tests/test_containment.py``) are the scenarios' source."""
import dataclasses
import gc
import random
import weakref

import numpy as np
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
from paddle_tpu_torch.serving.router import _DeadEngine

torch.set_num_threads(1)


class _ManualClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


class _Stack:
    """One package's fleet API plus its model: the scenario functions
    below are written once against this surface."""

    def __init__(self, name, serving, metrics, resilience, cfg, params,
                 engine_kw):
        self.name = name
        self.serving = serving
        self.Engine = serving.Engine
        self.SP = serving.SamplingParams
        self.FRS = serving.FleetRequestState
        self.RS = serving.ReplicaState
        self.ERS = serving.RequestState
        self.registry = metrics.MetricsRegistry
        self.FaultSpec = resilience.FaultSpec
        self.faults = resilience.injected_faults
        self.cfg = cfg
        self.params = params
        self.engine_kw = engine_kw

    def factory(self, clock, **kw):
        for k, v in (("page_size", 8), ("num_pages", 64),
                     ("max_batch_size", 2), ("chunk_len", 8)):
            kw.setdefault(k, v)

        def make():
            return self.Engine(self.cfg, self.params, clock=clock,
                               **self.engine_kw, **kw)

        return make

    def router(self, n=2, engine_kw=None, clock=None, **kw):
        clock = clock or _ManualClock()
        kw.setdefault("registry", self.registry())
        kw.setdefault("rng", random.Random(0))
        router = self.serving.FleetRouter(
            [self.factory(clock, **(engine_kw or {}))] * n, clock=clock,
            **kw)
        return router, clock


@pytest.fixture(scope="module")
def stacks():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    params = params_from_jax(jparams, device="cpu")
    return (_Stack("jax", jax_serving, jax_metrics, jax_resilience, jcfg,
                   jparams, {}),
            _Stack("port", port_serving, port_metrics, port_resilience,
                   cfg, params, {"device": "cpu"}))


@pytest.fixture(scope="module")
def oracle(stacks):
    """Greedy tokens of one port engine serving each prompt alone."""
    port = stacks[1]
    eng = port.factory(_ManualClock(), num_pages=128)()
    memo = {}

    def run(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in memo:
            memo[key] = eng.generate([list(prompt)], port.SP(
                max_new_tokens=n))[0]
        return memo[key]

    return run


def _both(stacks, scenario, *args, **kw):
    """Run ``scenario`` through both stacks; the results must be equal."""
    jax_out = scenario(stacks[0], *args, **kw)
    port_out = scenario(stacks[1], *args, **kw)
    assert port_out == jax_out
    return port_out


def _prompts(cfg, lens, seed):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
            for n in lens]


def _counts(router):
    """RouterMetrics.snapshot() less the TTFT exemplars (trace ids carry
    a per-tracer nonce, so they differ between any two runs)."""
    snap = router.metrics.snapshot()
    snap["ttft_s"] = {k: v for k, v in snap["ttft_s"].items()
                      if k != "exemplars"}
    return snap


def _settle(router, ticks=400):
    for i in range(ticks):
        if not router.has_work():
            return i
        router.step()
    raise AssertionError(f"fleet did not settle in {ticks} ticks")


def _outcome(router, reqs):
    return {"outputs": [r.output for r in reqs],
            "states": [r.state for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "replicas": [r.replica_id for r in reqs],
            "redispatches": [r.redispatches for r in reqs],
            "dispatches": [r.dispatches for r in reqs],
            "replica_states": [rep.state for rep in router.replicas],
            # what the last dispatch admitted: prompt + the tokens
            # harvested before it (exactly-once in numbers, where a
            # random tiny model's repeated tokens would hide a duplicate)
            "admitted": [len(r._engine_req.prompt)
                         if r._engine_req is not None else None
                         for r in reqs],
            "counts": _counts(router)}


# ------------------------------------------------------------ basics


def _generate(S):
    router, _ = S.router(n=3)
    prompts = _prompts(S.cfg, (5, 9, 7, 11, 3), seed=0)
    outs = router.generate(prompts, S.SP(max_new_tokens=6))
    return {"outs": outs, "counts": _counts(router)}


def test_multireplica_generate_matches_jax_and_oracle(stacks, oracle):
    got = _both(stacks, _generate)
    prompts = _prompts(stacks[1].cfg, (5, 9, 7, 11, 3), seed=0)
    assert got["outs"] == [oracle(p, 6) for p in prompts]
    assert got["counts"]["lost"] == 0
    assert len(got["counts"]["dispatches"]) >= 2
    assert sum(got["counts"]["dispatches"].values()) == len(prompts)


def _lowest_drain(S):
    router, _ = S.router(n=2, engine_kw={"drain_floor_s": 0.0})
    busy = router.replicas[0].engine
    for _ in range(3):
        busy.add_request(list(range(6)), S.SP(max_new_tokens=40))
    for _ in range(3):
        busy.step()
    req = router.submit(list(range(5)), S.SP(max_new_tokens=2))
    router.step()
    return {"replica": req.replica_id, "drain": busy.estimated_drain_s()}


def test_dispatch_prefers_lowest_drain(stacks):
    got = _both(stacks, _lowest_drain)
    assert got["drain"] > 0
    assert got["replica"] == 1


def _infeasible(S):
    router, _ = S.router(n=2)
    req = router.submit(list(range(S.cfg.max_seq_len)),
                        S.SP(max_new_tokens=8))
    router.step()
    return {"state": req.state, "reason": req.finish_reason,
            "redispatches": req.redispatches, "counts": _counts(router)}


def test_infeasible_request_rejected_hard(stacks):
    got = _both(stacks, _infeasible)
    assert got["state"] == stacks[1].FRS.REJECTED
    assert got["redispatches"] == 0


# ------------------------------------------------------- kill matrix

KILL_LENS, KILL_NEW = (5, 9, 7, 12, 4), 8


def _kill(S, mode):
    stall_kw = {"stall_timeout_s": 0.05} if mode == "stall" else {}
    router, clock = S.router(n=3, **stall_kw)
    prompts = _prompts(S.cfg, KILL_LENS, seed=3)
    sp = S.SP(max_new_tokens=KILL_NEW)
    reqs = [router.submit(p, sp) for p in prompts]
    for _ in range(3):
        clock.advance(0.01)
        router.step()
    engines = [rep.engine for rep in router.replicas]
    with S.faults(*{
            "io_error": [S.FaultSpec("serving.step", "io_error",
                                     occurrence=1)],
            "stall": [S.FaultSpec("serving.admit", "stall", occurrence=1,
                                  stall_s=0.25)],
            "drop": [], "second": []}[mode]) as inj:
        if mode == "stall":
            reqs.append(router.submit(_prompts(S.cfg, (6,), seed=9)[0],
                                      sp))
        if mode in ("drop", "second"):
            router.kill_replica(0)
        clock.advance(0.01)
        router.step()
        if mode == "second":
            router.kill_replica(1)
        fired = inj.fired
    # what each request had when its replica died: a failure's reclaim
    # re-admits within its tick, and nothing re-admitted steps before the
    # next one (the second kill is found at the next tick's start)
    harvested = {r.id: list(r.tokens_out) for r in reqs}
    dead = [rep.replica_id for rep in router.replicas
            if rep.state == S.RS.DEAD]
    # what each moved request had when its replica died: its output must
    # begin with exactly these tokens
    moved = {r.id: harvested[r.id] for r in reqs
             if r.redispatches and r.id in harvested}
    while router.has_work():
        clock.advance(0.01)
        router.step()
    out = _outcome(router, reqs)
    out["fired"] = fired
    out["dead"] = dead
    out["prefix_kept"] = all(
        r.output[:len(moved[r.id])] == moved[r.id]
        and len(r._engine_req.prompt) == len(r.prompt) + len(moved[r.id])
        for r in reqs if r.id in moved)
    # every engine's pool is whole again, but a hard-killed one's: a
    # SIGKILLed process frees nothing, its pages die with it
    killed = {"drop": {0}, "second": {0, 1}}.get(mode, set())
    out["pools_freed"] = [e.cache.num_free_pages == e.cache.num_pages
                          for i, e in enumerate(engines) if i not in killed]
    return out, engines


def _kill_result(S, mode):
    out, _ = _kill(S, mode)
    return out


@pytest.mark.faultinject
@pytest.mark.parametrize("mode", ["io_error", "stall", "drop", "second"])
def test_kill_matrix_matches_jax(stacks, oracle, mode):
    """io_error at serving.step, an admission stall at serving.admit, a
    hard engine drop, and a second death after the first: the same
    outputs, final states, metric counts and fired faults as the JAX
    fleet, token-identical to the oracle, exactly-once re-dispatch, the
    dead pool freed and lost == 0."""
    got = _both(stacks, _kill_result, mode)
    S = stacks[1]
    prompts = _prompts(S.cfg, KILL_LENS, seed=3)
    if mode == "stall":
        prompts.append(_prompts(S.cfg, (6,), seed=9)[0])
    assert got["outputs"] == [oracle(p, KILL_NEW) for p in prompts]
    assert got["states"] == [S.FRS.FINISHED] * len(prompts)
    assert got["counts"]["lost"] == 0
    assert got["counts"]["redispatched"] == sum(got["redispatches"])
    assert got["prefix_kept"]
    assert all(got["pools_freed"])
    if mode == "second":
        assert all(n <= 2 for n in got["redispatches"])
        assert got["dead"] == [0]
    else:
        assert all(n <= 1 for n in got["redispatches"])
        assert any(n == 1 for n in got["redispatches"])
        assert len(got["dead"]) == 1
        rid = got["dead"][0]
        reason = {"io_error": "io_error", "stall": "stall",
                  "drop": "crash"}[mode]
        assert got["counts"]["failovers"] == {f"{rid},{reason}": 1}
        assert got["counts"]["breaker_open"][str(rid)]["current"] == 1


@pytest.mark.faultinject
def test_port_releases_the_dead_engine(stacks):
    """The port lets a replica's engine go the moment it leaves rotation
    (its pool is gigabytes on the card): after an io_error failover and a
    hard kill, nothing keeps either old engine alive, and a restart
    builds a fresh pool."""
    S = stacks[1]
    router, clock = S.router(n=3)
    reqs = [router.submit(p, S.SP(max_new_tokens=KILL_NEW))
            for p in _prompts(S.cfg, KILL_LENS, seed=3)]
    for _ in range(3):
        router.step()
    refs = [weakref.ref(rep.engine) for rep in router.replicas[:2]]
    with S.faults(S.FaultSpec("serving.step", "io_error", occurrence=1)):
        router.step()                    # replica 0's step raises
    router.kill_replica(1)
    _settle(router)
    assert all(r.state == S.FRS.FINISHED for r in reqs)
    assert [ref() for ref in refs] == [None, None]
    assert all(isinstance(rep.engine, _DeadEngine)
               for rep in router.replicas[:2])
    # the io_error replica's ring stays readable, the killed one's not
    assert router.replicas[0].engine.tracer is not None
    with pytest.raises(OSError):
        router.replicas[1].engine.tracer
    router.restart_replica(0)
    eng = router.replicas[0].engine
    assert eng.cache.num_free_pages == eng.cache.num_pages


def _probe(S):
    class _HealthlessEngine:
        def has_work(self):
            return False

        def health(self):
            raise OSError("health RPC refused")

    clock = _ManualClock()
    router = S.serving.FleetRouter(
        [S.factory(clock), _HealthlessEngine()], clock=clock,
        probe_miss_threshold=2, registry=S.registry(),
        rng=random.Random(0))
    router.step()
    first = (router.replicas[1].probe_misses, router.replicas[1].state)
    router.step()
    with pytest.raises(ValueError, match="cannot\\s+restart"):
        router.restart_replica(1)
    return {"first": first, "state": router.replicas[1].state,
            "counts": _counts(router)}


def test_probe_misses_open_the_breaker(stacks):
    got = _both(stacks, _probe)
    assert got["first"] == (1, stacks[1].RS.HEALTHY)
    assert got["state"] == stacks[1].RS.DEAD
    assert got["counts"]["failovers"] == {"1,probe": 1}


# ------------------------------------------------ cache-aware routing


def _shared(S, seed, sys_len=24, tail_len=5, n=3):
    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(0, S.cfg.vocab_size, sys_len)]
    return system, [system + [int(t) for t in rng.randint(
        0, S.cfg.vocab_size, tail_len)] for _ in range(n)]


def _warm_wins(S):
    router, _ = S.router(n=2)
    system, prompts = _shared(S, seed=71)
    router.replicas[1].engine.generate([system], S.SP(max_new_tokens=2))
    req = router.submit(prompts[0], S.SP(max_new_tokens=4))
    router.step()
    router.step()
    return {"replica": req.replica_id,
            "hits": router.replicas[1].engine.cache.prefix_stats()["hits"],
            "counts": _counts(router)}


def _backlogged_warm_loses(S):
    router, _ = S.router(n=2, engine_kw={"drain_floor_s": 0.0})
    system, prompts = _shared(S, seed=73)
    warm = router.replicas[0].engine
    warm.generate([system], S.SP(max_new_tokens=2))
    for _ in range(3):
        warm.add_request(list(range(6)), S.SP(max_new_tokens=60))
    for _ in range(3):
        warm.step()
    req = router.submit(prompts[0], S.SP(max_new_tokens=2))
    router.step()
    return {"replica": req.replica_id, "drain": warm.estimated_drain_s(),
            "credit": len(system) * router.cache_hit_token_s}


def _hit_then_failover(S):
    router, _ = S.router(n=2)
    system, prompts = _shared(S, seed=83)
    for rep in router.replicas:
        rep.engine.generate([system], S.SP(max_new_tokens=2))
    reqs = [router.submit(p, S.SP(max_new_tokens=8)) for p in prompts]
    for _ in range(3):
        router.step()
    victim = reqs[0].replica_id
    survivor = router.replicas[1 - victim].engine
    router.kill_replica(victim)
    _settle(router)
    out = _outcome(router, reqs)
    out["victim"] = victim
    out["survivor_hits"] = survivor.cache.prefix_stats()["hits"]
    return out


def test_warm_replica_wins_dispatch(stacks):
    """Equal drain, one warm cache: the request goes to the replica that
    holds its system prompt, and the engine's radix walk then hits."""
    got = _both(stacks, _warm_wins)
    assert got["replica"] == 1 and got["hits"] == 1
    assert got["counts"]["cache_aware_dispatches"] == 1


def test_backlogged_warm_replica_loses_to_idle_cold_peer(stacks):
    got = _both(stacks, _backlogged_warm_loses)
    assert got["drain"] > got["credit"] and got["replica"] == 1


@pytest.mark.faultinject
def test_cache_hit_then_failover_token_identical(stacks, oracle):
    got = _both(stacks, _hit_then_failover)
    _, prompts = _shared(stacks[1], seed=83)
    assert got["outputs"] == [oracle(p, 8) for p in prompts]
    assert all(n <= 1 for n in got["redispatches"])
    assert any(n == 1 for n in got["redispatches"])
    assert got["counts"]["lost"] == 0 and got["survivor_hits"] >= 1

# --------------------------------------------------- rolling restart


def _graceful_drain(S):
    warmed = []
    router, _ = S.router(n=2, drain_deadline_s=1e6, warmup=warmed.append)
    prompts = _prompts(S.cfg, (5, 9, 7), seed=5)
    reqs = [router.submit(p, S.SP(max_new_tokens=6)) for p in prompts]
    for _ in range(2):
        router.step()
    rid = reqs[0].replica_id
    old = router.replicas[rid].engine
    router.drain(rid)
    draining = router.replicas[rid].state
    extra = router.submit(prompts[0], S.SP(max_new_tokens=6))
    router.step()
    extra_rid = extra.replica_id
    _settle(router)
    out = _outcome(router, reqs + [extra])
    out.update(rid=rid, draining=draining, extra_rid=extra_rid,
               rebuilt=router.replicas[rid].engine is not old,
               warmed_new=warmed == [router.replicas[rid].engine])
    return out


def _drain_deadline(S):
    router, _ = S.router(n=2)
    prompts = _prompts(S.cfg, (5, 9, 7), seed=7)
    reqs = [router.submit(p, S.SP(max_new_tokens=16)) for p in prompts]
    for _ in range(2):
        router.step()
    rid = reqs[0].replica_id
    stragglers = [r.id for r in reqs if r.replica_id == rid]
    router.drain(rid, deadline_s=0.0)
    router.step()
    moved = [r.redispatches for r in reqs if r.id in stragglers]
    state = router.replicas[rid].state
    _settle(router)
    out = _outcome(router, reqs)
    out.update(moved=moved, state_after=state)
    return out


def _drain_needs_factory(S):
    clock = _ManualClock()
    eng = S.factory(clock)()
    router = S.serving.FleetRouter([eng], clock=clock,
                                   registry=S.registry(),
                                   rng=random.Random(0))
    with pytest.raises(ValueError, match="no factory"):
        router.drain(0)
    router.drain(0, deadline_s=0.0, restart=False)
    router.step()
    return {"state": router.replicas[0].state,
            "healthy": router.fleet_health()["healthy"]}


def test_graceful_drain_finishes_then_restarts(stacks, oracle):
    """drain() stops admissions, in-flight work finishes in place, then
    the engine is rebuilt from its factory and warmed up."""
    S = stacks[1]
    got = _both(stacks, _graceful_drain)
    prompts = _prompts(S.cfg, (5, 9, 7), seed=5)
    assert got["draining"] == S.RS.DRAINING
    assert got["extra_rid"] not in (None, got["rid"])
    assert got["redispatches"] == [0, 0, 0, 0]
    assert got["outputs"] == [oracle(p, 6) for p in prompts + prompts[:1]]
    assert got["rebuilt"] and got["warmed_new"]
    assert got["replica_states"][got["rid"]] == S.RS.HEALTHY
    assert got["counts"]["drains"] == {str(got["rid"]): 1}
    assert got["counts"]["restarts"] == {str(got["rid"]): 1}


def test_drain_deadline_redispatches_stragglers(stacks, oracle):
    S = stacks[1]
    got = _both(stacks, _drain_deadline)
    assert got["moved"] and all(n == 1 for n in got["moved"])
    assert got["state_after"] == S.RS.HEALTHY
    prompts = _prompts(S.cfg, (5, 9, 7), seed=7)
    assert got["outputs"] == [oracle(p, 16) for p in prompts]
    assert got["counts"]["lost"] == 0


def test_drain_restart_requires_factory(stacks):
    got = _both(stacks, _drain_needs_factory)
    assert got == {"state": stacks[1].RS.DEAD, "healthy": False}

# ------------------------------------------------------ backpressure


def _backpressure(S):
    router, clock = S.router(
        n=1, engine_kw={"shed_queue_high": 2, "shed_queue_low": 0,
                        "max_batch_size": 1, "drain_floor_s": 0.01},
        backoff_base_s=0.001, backoff_cap_s=0.02)
    prompts = _prompts(S.cfg, (4, 4, 4, 4, 4), seed=11)
    reqs = [router.submit(p, S.SP(max_new_tokens=3)) for p in prompts]
    while router.has_work():
        clock.advance(0.005)
        router.step()
    return _outcome(router, reqs)


def _window(S):
    router, clock = S.router(n=1, backoff_cap_s=2.0)
    rep = router.replicas[0]
    delay = router._backpressure(rep, 1.25, clock())
    opens_at = rep.not_before
    closed = router._can_admit(rep, clock())
    clock.advance(2.5)
    reopened = router._can_admit(rep, clock())
    big = router._backpressure(rep, 60.0, clock())
    return {"delay": delay, "opens_at": opens_at, "closed": closed,
            "reopened": reopened, "big": big}


def _ttl(S):
    router, clock = S.router(n=1)
    router.kill_replica(0)
    router.step()
    req = router.submit(list(range(4)), S.SP(max_new_tokens=4, ttl_s=5.0))
    clock.advance(10.0)
    router.restart_replica(0)
    router.step()
    return {"state": req.state, "reason": req.finish_reason}


def test_retry_after_defers_with_bounded_backoff(stacks, oracle):
    """A shedding replica is backed off by its hint, never hammered, and
    everything finishes once it drains."""
    S = stacks[1]
    got = _both(stacks, _backpressure)
    prompts = _prompts(S.cfg, (4, 4, 4, 4, 4), seed=11)
    assert got["outputs"] == [oracle(p, 3) for p in prompts]
    assert got["counts"]["backpressure_retries"].get("0", 0) > 0
    assert got["counts"]["lost"] == 0


def test_backpressure_window_uses_hint_and_cap(stacks):
    got = _both(stacks, _window)
    assert 1.25 <= got["delay"] <= 2.0 and got["opens_at"] == got["delay"]
    assert not got["closed"] and got["reopened"] and got["big"] == 2.0


def test_fleet_ttl_expires_while_pending(stacks):
    got = _both(stacks, _ttl)
    assert got == {"state": stacks[1].FRS.EVICTED, "reason": "deadline"}

# ------------------------------------------------------- containment

POISON = [7, 8, 9, 10]


def _containment_router(S, n=3, **kw):
    kw.setdefault("canary_threshold", 2)
    kw.setdefault("cascade_threshold", 2)
    kw.setdefault("cascade_window_s", 3.0)
    return S.router(n=n, **kw)


def _poison(S):
    router, clock = _containment_router(S)
    innocents = _prompts(S.cfg, (5, 9, 7, 11), seed=0)
    sp = S.SP(max_new_tokens=6)
    with S.faults(S.FaultSpec("serving.step", "poison_request",
                              pattern=(7, 8, 9))) as inj:
        reqs = [router.submit(p, sp) for p in innocents[:2]]
        preq = router.submit(POISON, sp)
        reqs += [router.submit(p, sp) for p in innocents[2:]]
        _settle(router)
        sibling = router.submit(list(POISON), sp)
        _settle(router)
        fired = inj.fired
    out = _outcome(router, reqs + [preq, sibling])
    out.update(evidence=preq.quarantine_evidence, fired=fired,
               sibling=sibling.quarantine_evidence["convicted_sibling"],
               retained=sorted(t["retained"] for t in router.tracer.traces()
                               if t["retained"] == "quarantined"))
    return out


def _canary_alone(S):
    router, _ = _containment_router(S, n=2)
    sp = S.SP(max_new_tokens=6)
    rng = np.random.RandomState(9)
    suspect = router.submit(
        [int(t) for t in rng.randint(0, S.cfg.vocab_size, 8)], sp)
    router._suspects[suspect._prompt_key] = {1, 2}
    others = [router.submit([int(t) for t in rng.randint(
        0, S.cfg.vocab_size, 6)], sp) for _ in range(3)]
    router.step()
    canaries = [rep.replica_id for rep in router.replicas
                if rep.canary_for == suspect.id]
    aboard = sorted(router._assigned[canaries[0]]) if canaries else None
    _settle(router)
    out = _outcome(router, [suspect] + others)
    out.update(canaries=canaries, aboard=aboard)
    return out


def _benign_suspect(S):
    router, _ = _containment_router(S, n=2)
    prompt = _prompts(S.cfg, (8,), seed=5)[0]
    with S.faults(S.FaultSpec("router.canary_dispatch", "io_error",
                              occurrence=1)) as inj:
        req = router.submit(prompt, S.SP(max_new_tokens=5))
        router._suspects[req._prompt_key] = {1, 2}
        router.step()
        first = req.state
        _settle(router)
        fired = inj.fired
    out = _outcome(router, [req])
    out.update(first=first, fired=fired,
               exonerated=req._prompt_key not in router._suspects)
    return out


def _reenqueue_order(S):
    router, _ = _containment_router(S, n=2,
                                    engine_kw={"max_batch_size": 4})
    sp = S.SP(max_new_tokens=12)
    reqs = [router.submit(p, sp)
            for p in _prompts(S.cfg, (6,) * 6, seed=2)]
    router.step()
    victim = router.replicas[0]
    aboard = sorted(router._assigned[0])
    table = router._assigned[0]
    items = list(table.items())[::-1]       # scramble insertion order
    table.clear()
    table.update(items)
    router.kill_replica(0)
    router._on_replica_failure(victim, "killed",
                               OSError("replica 0 process is dead"))
    moved = [f.id for f in router._pending if f.id in set(aboard)]
    _settle(router)
    out = _outcome(router, reqs)
    out.update(aboard=aboard, moved=moved)
    return out


def _cascade(S):
    router, clock = _containment_router(S, cascade_window_s=2.0)
    sp = S.SP(max_new_tokens=6)
    with S.faults(S.FaultSpec("serving.step", "poison_request",
                              pattern=(7, 8, 9))):
        preq = router.submit(list(POISON), sp)
        for _ in range(400):
            if not router.has_work():
                break
            clock.advance(0.01)
            router.step()
    open_after = router.cascade_open()
    clock.advance(5.0)
    router.step()
    cascade = [t for t in router.tracer.traces()
               if t["name"] == "router::cascade"]
    return {"state": preq.state, "open_after": open_after,
            "closed": not router.cascade_open(),
            "tally": cascade[0]["spans"][0]["attributes"][
                "quarantined_total"] if cascade else None,
            "counts": _counts(router)}


@pytest.mark.faultinject
def test_poison_request_quarantined_innocents_token_identical(stacks,
                                                               oracle):
    """A poison request is quarantined after canary_threshold uncontrolled
    kills and one canary death, innocents token-identical; a sibling of
    the same content is quarantined at admission."""
    S = stacks[1]
    got = _both(stacks, _poison)
    innocents = _prompts(S.cfg, (5, 9, 7, 11), seed=0)
    assert got["states"] == [S.FRS.FINISHED] * 4 + [S.FRS.QUARANTINED] * 2
    assert got["outputs"][:4] == [oracle(p, 6) for p in innocents]
    assert got["evidence"]["suspicion"] >= 2
    assert got["sibling"] is True and got["retained"]
    c = got["counts"]
    assert c["failure_events"] <= 3 and c["canary_deaths"] == 1
    assert c["quarantined"] == 2 and c["cascade_breaker_opens"] == 1
    assert c["lost"] == 0


def test_canary_runs_suspect_alone(stacks):
    S = stacks[1]
    got = _both(stacks, _canary_alone)
    assert len(got["canaries"]) == 1 and got["aboard"] == [0]
    assert got["states"] == [S.FRS.FINISHED] * 4
    assert all(r != got["canaries"][0] for r in got["replicas"][1:])


@pytest.mark.faultinject
def test_benign_suspect_survives_canary_trial_and_is_exonerated(stacks,
                                                                 oracle):
    """After a transient io_error at router.canary_dispatch, the suspect
    runs alone, finishes token-identical and its suspicion is dropped."""
    S = stacks[1]
    got = _both(stacks, _benign_suspect)
    assert got["first"] == S.FRS.PENDING and got["exonerated"]
    assert got["outputs"] == [oracle(_prompts(S.cfg, (8,), seed=5)[0], 5)]
    assert got["counts"]["canary_dispatches"] == 1
    assert got["counts"]["canary_deaths"] == 0


@pytest.mark.faultinject
def test_reclaim_re_enqueues_in_admission_order(stacks):
    S = stacks[1]
    got = _both(stacks, _reenqueue_order)
    assert len(got["aboard"]) >= 2 and got["moved"] == got["aboard"]
    assert got["states"] == [S.FRS.FINISHED] * 6


@pytest.mark.faultinject
def test_cascade_breaker_closes_when_window_drains(stacks):
    """The breaker opens in the poison storm and closes once its window
    holds no failure, with the quarantine tally on its trace."""
    got = _both(stacks, _cascade)
    assert got["state"] == stacks[1].FRS.QUARANTINED
    assert got["open_after"] and got["closed"] and got["tally"] == 1
    assert got["counts"]["cascade_breaker_opens"] == 1

# ---------------------------------------- the engine's fleet surface


def _engine_surface(S):
    eng = S.factory(_ManualClock(), num_pages=32)()
    sp = S.SP(max_new_tokens=6)
    prompts = _prompts(S.cfg, (20, 9, 30, 5), seed=17)
    eng.generate([prompts[0]], S.SP(max_new_tokens=2))   # warm the cache
    reqs = [eng.add_request(p, sp) for p in prompts]
    for _ in range(3):
        eng.step()
    before = (eng.health(), eng.prefix_summary(), eng.decode_rate())
    moved = eng.evacuate()
    return {"before": before,
            "moved": [(r.id, r.state, r.finish_reason, r.output)
                      for r in moved],
            "states": [r.state for r in reqs],
            "after": (eng.health(), eng.prefix_summary()),
            "free": eng.cache.num_free_pages == eng.cache.num_pages,
            "has_work": eng.has_work()}


def test_engine_health_summary_evacuate_match_jax(stacks):
    """health(), prefix_summary() and evacuate() on the same request mix
    (a warm prefix, a chunked prompt, requests queued behind a full
    batch): equal payloads, the same requests leaving EVACUATED in
    admission order with their tokens, every page back in the pool."""
    got = _both(stacks, _engine_surface)
    assert got["before"][0]["running"] == 2
    assert got["before"][0]["queue_depth"] == 2
    assert got["before"][1]["entries"]
    assert [m[1] for m in got["moved"]] == ["evacuated"] * 4
    assert got["free"] and not got["has_work"]


def _traced_failover(S):
    router, clock = S.router(n=2)
    prompts = _prompts(S.cfg, (5, 9), seed=3)
    reqs = [router.submit(p, S.SP(max_new_tokens=6)) for p in prompts]
    for _ in range(2):
        router.step()
    victim = reqs[0].replica_id
    with S.faults(S.FaultSpec("serving.step", "io_error", occurrence=1)):
        while router.replicas[victim].state != S.RS.DEAD:
            router.step()
    _settle(router)
    merged = router.collect_traces()
    shape = []
    for tr in merged:
        ids = {s["span_id"]: s["name"] for s in tr["spans"]}
        shape.append((tr["name"], tr["retained"], sorted(
            (s["name"], ids.get(s["parent_id"])) for s in tr["spans"])))
    return sorted(shape, key=repr)


def test_fleet_trace_view_matches_jax(stacks):
    """router.collect_traces() after an io_error failover: the merged
    fleet view has the same traces, span names, parent links and
    retention reasons in both packages (ids differ by nonce)."""
    shape = _both(stacks, _traced_failover)
    fleet = [s for s in shape if s[0].startswith("fleet#")]
    assert len(fleet) == 2
    assert any(r == "failover" for _, r, _ in fleet)


def test_gc_collects_nothing_of_a_dropped_fleet(stacks):
    """A fleet of port engines holds no reference cycle through its
    engines: dropping the router frees every engine by reference count,
    with the garbage collector off."""
    S = stacks[1]
    router, _ = S.router(n=2)
    router.generate(_prompts(S.cfg, (5, 9), seed=1),
                    S.SP(max_new_tokens=3))
    refs = [weakref.ref(rep.engine) for rep in router.replicas]
    gc.disable()
    try:
        del router
        assert [ref() for ref in refs] == [None, None]
    finally:
        gc.enable()
