"""Seeded deterministic traffic generation — the fleet's load (the port
of ``paddle_tpu/serving/traffic.py``).

A serving fleet's hard problems are shaped by *when* requests arrive
and *what* they share, not just how many there are.  This module
models both, deterministically from one seed:

- **arrival process** — a Poisson process whose instantaneous rate is
  the ``base_rate_per_s`` modulated by a **diurnal curve** (a sinusoid
  with ``diurnal_amplitude`` over ``day_period_s`` — the day/night
  swing that makes a fixed-size fleet either over-provisioned or
  shedding) and by **burst episodes** (``(start_s, duration_s,
  multiplier)`` windows — the traffic spike that forces a scale-up
  mid-trace).  Sampling is Poisson thinning at the peak rate, so the
  trace is exact for the time-varying intensity, not a per-bin
  approximation.
- **prompt mix with shared-prefix cohorts** — a ``cohort_fraction`` of
  requests draw a cohort id and start with that cohort's fixed prefix
  (the shared-system-prompt population the radix prefix cache and the
  router's cache-aware placement exist for); the rest are unique
  prompts.  Cohort prefixes are generated once at construction, so the
  same seed replays byte-identical traffic.

Everything is pure after construction: :meth:`trace` re-seeds its own
``numpy`` generator from ``seed`` on every call (two calls return
identical traces), :meth:`rate_at` is a pure function of time, and no
method mutates the generator — there is no shared mutable state, so
the object needs no lock and may be read from any thread.

Closed-loop load: the optional ``burn_feedback=`` hook (a zero-arg
callable returning the live SLO burn rate, e.g.
``engine.max_burn_rate``) lets a *caller* thin the precomputed trace
at submission time — each :class:`Arrival` carries a pre-drawn
uniform ``u`` from a **separate** seeded stream, and the caller keeps
the arrival iff ``u < feedback_factor(burn)``.  The trace itself stays
equal to the JAX package's draw for draw (the replay contract is
untouched); only the live keep/drop decision varies with the burn the
run actually produced.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Arrival", "TrafficGenerator"]


@dataclasses.dataclass
class Arrival:
    """One request in a generated trace: when it lands, what it asks.

    ``cohort`` is the shared-prefix cohort id (None for a unique
    prompt) — the soak report groups cache-hit expectations by it.
    ``u`` is the pre-drawn closed-loop thinning uniform: a driver with
    burn feedback submits the arrival iff
    ``u < feedback_factor(burn)``, so backoff is deterministic given
    the burn sequence."""

    t: float
    prompt: list
    max_new_tokens: int
    cohort: int = None
    u: float = 0.0


class TrafficGenerator:
    """Deterministic diurnal + bursty Poisson traffic with a shared-
    prefix prompt mix.

    ``base_rate_per_s`` is the mean arrival rate; the diurnal curve
    multiplies it by ``1 + diurnal_amplitude·sin(2π(t+phase_s)/
    day_period_s)`` and each ``(start_s, duration_s, multiplier)`` in
    ``bursts`` multiplies it again inside its window.  ``prompt_len``
    and ``max_new_tokens`` are inclusive ``(lo, hi)`` ranges; callers
    must keep ``hi + hi`` within the serving model's ``max_seq_len``.
    ``cohort_fraction`` of arrivals share one of ``n_cohorts`` fixed
    ``cohort_prefix_len``-token prefixes.  Identical seeds produce
    identical traces — the soak's replay/repro contract."""

    def __init__(self, base_rate_per_s=20.0, *, diurnal_amplitude=0.6,
                 day_period_s=60.0, phase_s=0.0, bursts=(),
                 n_cohorts=3, cohort_prefix_len=16, cohort_fraction=0.5,
                 prompt_len=(8, 24), max_new_tokens=(4, 8),
                 vocab_size=1024, seed=0, burn_feedback=None,
                 feedback_floor=0.1):
        if not 0.0 <= float(diurnal_amplitude) <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1] "
                             "(>1 would drive the rate negative)")
        if prompt_len[0] < 1 or prompt_len[1] < prompt_len[0]:
            raise ValueError(f"bad prompt_len range {prompt_len!r}")
        self.base_rate_per_s = float(base_rate_per_s)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.day_period_s = float(day_period_s)
        self.phase_s = float(phase_s)
        self.bursts = tuple((float(s), float(d), float(m))
                            for s, d, m in bursts)
        self.n_cohorts = int(n_cohorts)
        self.cohort_fraction = float(cohort_fraction)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new_tokens = (int(max_new_tokens[0]),
                               int(max_new_tokens[1]))
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.burn_feedback = burn_feedback
        self.feedback_floor = float(feedback_floor)
        # cohort prefixes are fixed at construction (and derived from
        # the seed alone) so every trace of this generator — and every
        # generator built with the same seed — shares them
        prefix_rng = np.random.default_rng((self.seed, 0xC0))
        self.cohort_prefixes = tuple(
            tuple(int(x) for x in prefix_rng.integers(
                0, self.vocab_size, int(cohort_prefix_len)))
            for _ in range(max(self.n_cohorts, 0)))

    # ----------------------------------------------------------- intensity
    def rate_at(self, t):
        """Instantaneous arrival intensity (requests/s) at ``t``."""
        rate = self.base_rate_per_s * (
            1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * (t + self.phase_s) / self.day_period_s))
        for start, dur, mult in self.bursts:
            if start <= t < start + dur:
                rate *= mult
        return max(0.0, rate)

    def peak_rate(self):
        """An upper bound on :meth:`rate_at` — the thinning envelope."""
        peak = self.base_rate_per_s * (1.0 + self.diurnal_amplitude)
        worst = 1.0
        for _, _, mult in self.bursts:
            worst = max(worst, mult)
        return peak * worst

    # --------------------------------------------------------------- trace
    def _arrival(self, t, rng):
        lo, hi = self.prompt_len
        total_len = int(rng.integers(lo, hi + 1))
        cohort = None
        prompt = []
        if self.cohort_prefixes and \
                rng.uniform() < self.cohort_fraction:
            cohort = int(rng.integers(len(self.cohort_prefixes)))
            prompt = list(self.cohort_prefixes[cohort])
        suffix = max(1, total_len - len(prompt))
        prompt = prompt + [int(x) for x in
                           rng.integers(0, self.vocab_size, suffix)]
        mlo, mhi = self.max_new_tokens
        return Arrival(t=float(t), prompt=prompt,
                       max_new_tokens=int(rng.integers(mlo, mhi + 1)),
                       cohort=cohort)

    def trace(self, horizon_s):
        """The full arrival list over ``[0, horizon_s)``, time-sorted.
        Poisson thinning: candidates at the constant peak rate, each
        kept with probability ``rate_at(t)/peak`` — an exact sample of
        the inhomogeneous process.  Re-seeds from ``self.seed``:
        calling twice returns identical traces (the replay contract)."""
        rng = np.random.default_rng((self.seed, 0xA1))
        fb_rng = np.random.default_rng((self.seed, 0xFB))
        peak = self.peak_rate()
        out = []
        if peak <= 0.0:
            return out
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= horizon_s:
                return out
            keep = rng.uniform()     # drawn unconditionally: the kept/
            # dropped decision must not perturb downstream draws' order
            if keep * peak <= self.rate_at(t):
                arr = self._arrival(t, rng)
                # closed-loop thinning uniform from a SEPARATE stream,
                # drawn per kept arrival: the main stream's draw order
                # — and therefore the trace — is unchanged whether or
                # not a driver uses burn feedback
                arr.u = float(fb_rng.uniform())
                out.append(arr)

    # --------------------------------------------------- closed-loop load
    def feedback_factor(self, burn):
        """Keep-probability for one arrival given a live burn rate — a
        pure function: 1.0 at or below burn 1 (the budget refills as
        fast as it spends — full load), ``1/burn`` above it, floored at
        ``feedback_floor`` so the fleet still sees *some* traffic and
        the alert can observe recovery."""
        if burn is None or burn != burn or burn <= 1.0:
            return 1.0
        return max(self.feedback_floor, 1.0 / float(burn))

    def live_factor(self):
        """:meth:`feedback_factor` of the ``burn_feedback`` hook's
        current value — 1.0 without a hook, and 1.0 on a hook error
        (feedback must never stall submission)."""
        if self.burn_feedback is None:
            return 1.0
        try:
            return self.feedback_factor(float(self.burn_feedback()))
        except Exception:
            return 1.0      # silent-ok: a broken hook means open loop

    def summary(self, horizon_s, samples=64):
        """Telemetry-shaped description of the configured load: rate
        envelope over the horizon plus the mix knobs (what the soak
        report embeds so a run is interpretable without the code)."""
        ts = [horizon_s * i / max(samples - 1, 1) for i in range(samples)]
        rates = [self.rate_at(t) for t in ts]
        return {
            "base_rate_per_s": self.base_rate_per_s,
            "diurnal_amplitude": self.diurnal_amplitude,
            "day_period_s": self.day_period_s,
            "bursts": list(self.bursts),
            "n_cohorts": len(self.cohort_prefixes),
            "cohort_fraction": self.cohort_fraction,
            "rate_min": min(rates), "rate_max": max(rates),
            "rate_mean": sum(rates) / len(rates),
            "seed": self.seed,
        }
