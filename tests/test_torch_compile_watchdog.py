"""The port's compile watchdog (``observability/compile_watchdog.py``)
against the JAX package's, mirroring ``tests/test_observability.py``
``TestCompileWatchdog`` on a port function: a rebuild after warmup is
flagged once with its per-argument shape diff, a disabled watchdog is
silent, the counters land in the registry under the JAX names, and the
wrapper forwards attributes.  A build here is a first-seen argument
signature; for the serving engine it is the capture of its step, which
on the CPU runs eagerly through the same watched call, so the CPU
engine reports ``serving::unified_step`` with one build over a run of
mixed chunk and decode steps, as the JAX engine does."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.observability import CompileWatchdog as JaxWatchdog
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import default_watchdog as jax_default
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
from paddle_tpu_torch.observability import (CompileWatchdog,
                                            MetricsRegistry,
                                            default_watchdog,
                                            watchdog_enabled)
from paddle_tpu_torch.serving import Engine, SamplingParams

torch.set_num_threads(1)

LOGGER = "paddle_tpu_torch.observability"


@pytest.fixture(autouse=True)
def _clean_watchdog():
    wd = default_watchdog()
    prev = wd.enabled
    wd.reset()
    yield
    wd.enabled = prev
    wd.reset()


@pytest.fixture
def obs_caplog(caplog):
    """caplog on the port's observability logger (its records reach
    caplog's root handler by propagation)."""
    yield caplog


def _step(x, y):
    return (x * y).sum()


class TestCompileWatchdog:
    def test_recompile_flagged_once_with_shape_diff(self, obs_caplog):
        wd = CompileWatchdog(registry=MetricsRegistry())
        wd.enable()
        f = wd.watch(_step, name="test::step")
        x4 = torch.ones((4, 2))
        with obs_caplog.at_level(logging.WARNING, logger=LOGGER):
            for _ in range(3):
                f(x4, x4)                    # warmup + repeats
            assert obs_caplog.records == []
            f(torch.ones((8, 2)), torch.ones((8, 2)))   # ragged batch
        warnings = [r for r in obs_caplog.records
                    if r.levelno == logging.WARNING]
        assert len(warnings) == 1
        msg = warnings[0].getMessage()
        assert "test::step" in msg
        assert "f32[4,2] -> f32[8,2]" in msg
        rep = wd.report()["test::step"]
        assert rep["calls"] == 4
        assert rep["compiles"] == 2
        assert rep["recompiles"] == 1
        assert rep["compile_time_s"] > 0
        assert "cost_analysis" not in rep    # no HLO: no cost reported

    def test_silent_when_disabled_and_counters_in_registry(self,
                                                           obs_caplog):
        reg = MetricsRegistry()
        wd = CompileWatchdog(registry=reg)
        f = wd.watch(_step, name="test::step")    # disabled: pass-through
        with obs_caplog.at_level(logging.WARNING, logger=LOGGER):
            f(torch.ones((2, 2)), torch.ones((2, 2)))
            f(torch.ones((5, 2)), torch.ones((5, 2)))
        assert obs_caplog.records == []
        assert wd.report() == {}

        wd.enable()
        f(torch.ones((3, 2)), torch.ones((3, 2)))
        f(torch.ones((6, 2)), torch.ones((6, 2)))
        snap = reg.snapshot()
        series = {s["labels"]["fn"]: s["value"]
                  for s in snap["jit_compiles_total"]["series"]}
        assert series["test::step"] == 2
        recs = {s["labels"]["fn"]: s["value"]
                for s in snap["jit_recompiles_total"]["series"]}
        assert recs["test::step"] == 1

    def test_proxy_forwards_attrs(self):
        def fn(x):
            return x + 1

        fn.launches = 7
        wd = CompileWatchdog(registry=MetricsRegistry())
        f = wd.watch(fn, name="fwd")
        assert f.launches == 7               # attributes forward
        assert f.__wrapped__ is fn
        assert wd.watch(f) is f              # never wrapped twice
        assert torch.equal(f(torch.zeros(2)), torch.ones(2))

    def test_signature_renders_dtype_shape_and_static_values(self):
        from paddle_tpu_torch.observability.compile_watchdog import \
            _signature

        sig = dict(_signature(({"w": torch.zeros(2, 3,
                                                 dtype=torch.bfloat16)},
                               np.zeros((4,), np.int32)),
                              {"storage": "ab12"}))
        assert sig == {"[0]['w']": "bf16[2,3]", "[1]": "i32[4]",
                       "['storage']": "'ab12'"}

    def test_each_wrapper_builds_once_per_signature(self):
        """Two wrappers of one name (two engines' steps) each build once:
        two compiles, no recompile, no warning."""
        wd = CompileWatchdog(registry=MetricsRegistry())
        wd.enable()
        a, b = (wd.watch(_step, name="serving::unified_step")
                for _ in range(2))
        x = torch.ones(3)
        for f in (a, b, a, b):
            f(x, x)
        rep = wd.report()["serving::unified_step"]
        assert (rep["calls"], rep["compiles"], rep["recompiles"]) == \
            (4, 2, 0)


def _drive(wd, mk, x, ragged, name):
    """One sequence through a watchdog: warmup, repeats, a ragged call,
    a return to the warm shape."""
    f = wd.watch(mk(), name=name)
    for _ in range(3):
        f(x, x)
    f(ragged, ragged)
    f(x, x)
    rep = dict(wd.report()[name])
    rep.pop("compile_time_s")
    return rep


def test_counts_as_jax():
    """The same calls through the JAX watchdog (over ``jax.jit``) and
    the port's (over a torch function) count alike."""
    jwd = JaxWatchdog(registry=JaxRegistry(), cost_analysis=False).enable()
    twd = CompileWatchdog(registry=MetricsRegistry()).enable()
    j = _drive(jwd, lambda: jax.jit(_step), jnp.ones((4, 2)),
               jnp.ones((8, 2)), "n")
    t = _drive(twd, lambda: _step, torch.ones((4, 2)),
               torch.ones((8, 2)), "n")
    assert t == j == {"calls": 5, "compiles": 2, "recompiles": 1}


# ------------------------------------------------------------- the engine


def _serve(eng, SP):
    """Ragged prompts, one long enough to span several chunks, and an
    admission while the others decode."""
    rng = np.random.RandomState(2)
    sp = SP(max_new_tokens=5)
    reqs = [eng.add_request([int(t) for t in rng.randint(1, 1000, n)], sp)
            for n in (3, 2, 40)]
    for _ in range(4):
        eng.step()
    reqs.append(eng.add_request([5, 6, 7, 8], sp))
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


def test_cpu_engine_builds_its_step_once(obs_caplog):
    cfg = GPT_CONFIGS["tiny"]
    kw = dict(page_size=4, num_pages=64, max_batch_size=2, chunk_len=16)
    with obs_caplog.at_level(logging.WARNING, logger=LOGGER), \
            watchdog_enabled() as wd:
        eng = Engine(cfg, gpt_init(cfg, device="cpu"), device="cpu", **kw)
        _serve(eng, SamplingParams)
        eng.cache.defrag()
        _serve(eng, SamplingParams)
        rep = wd.report()["serving::unified_step"]
    assert rep["compiles"] == 1 and rep["recompiles"] == 0
    assert rep["calls"] == eng.steps > 10
    assert eng.captures == 0                 # no CUDA graph on the CPU
    assert not [r for r in obs_caplog.records
                if r.levelno >= logging.WARNING]


def test_replaced_params_show_as_a_rebuild(obs_caplog):
    """A step whose static inputs change (here the parameter tree gains a
    leaf, an untied head) is a new signature: the watchdog flags it."""
    cfg = GPT_CONFIGS["tiny"]
    with obs_caplog.at_level(logging.WARNING, logger=LOGGER), \
            watchdog_enabled() as wd:
        eng = Engine(cfg, gpt_init(cfg, device="cpu"), device="cpu",
                     page_size=4, num_pages=32, max_batch_size=2,
                     chunk_len=8)
        eng.generate([[1, 2, 3]], SamplingParams(max_new_tokens=2))
        eng.cfg = dataclasses.replace(cfg, tie_embeddings=False)
        eng._step_fn.__wrapped__.cfg = eng.cfg
        eng.params = dict(eng.params, lm_head=eng.params["wte"].t().clone())
        eng.generate([[4, 5, 6]], SamplingParams(max_new_tokens=2))
        rep = wd.report()["serving::unified_step"]
    assert rep["compiles"] == 2 and rep["recompiles"] == 1
    msg = [r.getMessage() for r in obs_caplog.records
           if r.levelno == logging.WARNING]
    assert len(msg) == 1 and "(new) bf16[128,1024]" in msg[0]


def test_engine_counts_as_jax():
    """The JAX engine and the port's, driven alike, report one build of
    ``serving::unified_step`` and the same number of calls."""
    jcfg, cfg = JAX_CONFIGS["tiny"], GPT_CONFIGS["tiny"]
    kw = dict(page_size=4, num_pages=64, max_batch_size=2, chunk_len=16)
    jwd = jax_default()
    prev = jwd.enabled
    jwd.reset()
    try:
        with watchdog_enabled(jwd):
            je = JaxEngine(jcfg, **kw)
            _serve(je, JaxSampling)
            jrep = jwd.report()["serving::unified_step"]
    finally:
        jwd.enabled = prev
        jwd.reset()
    with watchdog_enabled() as wd:
        te = Engine(cfg, gpt_init(cfg, device="cpu"), device="cpu", **kw)
        _serve(te, SamplingParams)
        trep = wd.report()["serving::unified_step"]
    for rep in (jrep, trep):
        rep.pop("compile_time_s")
        rep.pop("cost_analysis", None)
    assert trep == jrep
    assert trep["calls"] == te.steps
