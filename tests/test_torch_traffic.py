"""The port's traffic generator against the JAX package's, and the JAX
suite's determinism, rate-shape and cohort cases on the port's.

For the same configuration and seed the two generators must give the
same trace exactly: arrival times, prompts, ``max_new_tokens``, cohorts
and the closed-loop thinning uniforms."""
import math

import pytest

from paddle_tpu.serving import TrafficGenerator as JaxTraffic
from paddle_tpu_torch.serving import TrafficGenerator

CONFIGS = {
    "default": dict(base_rate_per_s=15.0),
    "burst": dict(base_rate_per_s=8.0, diurnal_amplitude=0.3,
                  day_period_s=30.0, bursts=((4.0, 3.0, 4.0),),
                  n_cohorts=3, cohort_prefix_len=32,
                  cohort_fraction=0.5, prompt_len=(40, 120),
                  max_new_tokens=(8, 8), vocab_size=50304),
    "cohorts_only": dict(base_rate_per_s=25.0, n_cohorts=2,
                         cohort_prefix_len=12, cohort_fraction=1.0),
}


def _trace(cls, cfg, seed, horizon=20.0):
    return [(a.t, list(a.prompt), a.max_new_tokens, a.cohort, a.u)
            for a in cls(seed=seed, **CONFIGS[cfg]).trace(horizon)]


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_equals_jax(cfg, seed):
    port = _trace(TrafficGenerator, cfg, seed)
    assert port and port == _trace(JaxTraffic, cfg, seed)
    gen = TrafficGenerator(seed=seed, **CONFIGS[cfg])
    ref = JaxTraffic(seed=seed, **CONFIGS[cfg])
    assert gen.cohort_prefixes == ref.cohort_prefixes
    assert gen.summary(20.0) == ref.summary(20.0)
    for t in (0.0, 3.3, 5.0, 17.5):
        assert gen.rate_at(t) == ref.rate_at(t)
    for burn in (None, 0.5, 1.0, 4.0, 100.0):
        assert gen.feedback_factor(burn) == ref.feedback_factor(burn)


# ---- the JAX suite's cases (tests/test_traffic.py) on the port


def test_same_seed_same_trace():
    gen = TrafficGenerator(base_rate_per_s=15.0, seed=7)
    a, b = gen.trace(20.0), gen.trace(20.0)
    assert len(a) == len(b) > 0
    assert [(x.t, x.prompt, x.max_new_tokens, x.cohort) for x in a] == \
        [(y.t, y.prompt, y.max_new_tokens, y.cohort) for y in b]


def test_different_seed_different_trace():
    a = TrafficGenerator(base_rate_per_s=15.0, seed=1).trace(20.0)
    b = TrafficGenerator(base_rate_per_s=15.0, seed=2).trace(20.0)
    assert [x.t for x in a] != [y.t for y in b]


def test_diurnal_curve_and_burst_windows():
    gen = TrafficGenerator(base_rate_per_s=10.0, diurnal_amplitude=0.8,
                           day_period_s=40.0, seed=0)
    assert gen.rate_at(10.0) == pytest.approx(18.0)
    assert gen.rate_at(30.0) == pytest.approx(2.0)
    assert gen.rate_at(0.0) == pytest.approx(10.0)
    assert gen.peak_rate() >= gen.rate_at(10.0)
    gen = TrafficGenerator(base_rate_per_s=10.0, diurnal_amplitude=0.0,
                           bursts=((5.0, 2.0, 3.0),), seed=0)
    assert gen.rate_at(4.9) == pytest.approx(10.0)
    assert gen.rate_at(6.0) == pytest.approx(30.0)
    assert gen.rate_at(7.1) == pytest.approx(10.0)
    assert gen.peak_rate() == pytest.approx(30.0)


def test_arrival_density_follows_rate():
    arrivals = TrafficGenerator(base_rate_per_s=30.0,
                                diurnal_amplitude=0.9, day_period_s=40.0,
                                seed=3).trace(40.0)
    high = sum(1 for a in arrivals if 0.0 <= a.t < 20.0)
    low = sum(1 for a in arrivals if 20.0 <= a.t < 40.0)
    assert high > 2 * low > 0
    assert all(arrivals[i].t <= arrivals[i + 1].t
               for i in range(len(arrivals) - 1))


def test_validation():
    with pytest.raises(ValueError):
        TrafficGenerator(diurnal_amplitude=1.5)
    with pytest.raises(ValueError):
        TrafficGenerator(prompt_len=(24, 8))


def test_cohorts_share_prefix_and_bounds_hold():
    arrivals = TrafficGenerator(**CONFIGS["cohorts_only"],
                                seed=5).trace(10.0)
    prefixes = {}
    for a in arrivals:
        assert a.cohort in (0, 1)
        prefixes.setdefault(a.cohort, set()).add(tuple(a.prompt[:12]))
    assert all(len(ps) == 1 for ps in prefixes.values())
    arrivals = TrafficGenerator(base_rate_per_s=25.0, cohort_fraction=0.0,
                                seed=5).trace(10.0)
    assert all(a.cohort is None for a in arrivals)
    assert len({tuple(a.prompt) for a in arrivals}) == len(arrivals)
    arrivals = TrafficGenerator(base_rate_per_s=25.0, prompt_len=(8, 24),
                                max_new_tokens=(4, 8), vocab_size=512,
                                seed=9).trace(10.0)
    assert arrivals
    for a in arrivals:
        assert 8 <= len(a.prompt) <= 24 and 4 <= a.max_new_tokens <= 8
        assert all(0 <= tok < 512 for tok in a.prompt)


def test_summary_shape():
    gen = TrafficGenerator(base_rate_per_s=10.0, seed=0,
                           bursts=((2.0, 4.0, 2.0),))
    s = gen.summary(20.0)
    assert s["base_rate_per_s"] == 10.0 and s["seed"] == 0
    assert s["rate_max"] <= gen.peak_rate()
    assert 0.0 <= s["rate_min"] <= s["rate_mean"] <= s["rate_max"]
    assert math.isfinite(s["rate_mean"])
