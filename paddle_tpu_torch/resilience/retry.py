"""Jittered exponential backoff + deadlines (a copy of
``paddle_tpu/resilience/retry.py``).

The two primitives every blocking edge of the system shares:

- :class:`Deadline` — an absolute time budget carried through nested
  waits (connect → request → poll), so layered timeouts can't stack
  into multiples of the user's budget.
- :func:`retry` — a decorator re-running a callable on transient
  failure with capped exponential backoff and full jitter (the AWS
  architecture-blog scheme: ``sleep = uniform(0, min(cap, base·2^k))``
  decorrelates a thundering herd of reconnecting hosts).
- :func:`backoff_delays` — the underlying delay generator, used
  directly by polling loops (``TCPStore.get``) that aren't shaped like
  a retryable function call.

Retries are visible in telemetry: every backed-off attempt counts into
``retry_attempts_total{name=...}`` in the default metrics registry.
"""
from __future__ import annotations

import functools
import random
import time

__all__ = ["Deadline", "backoff_delays", "retry", "RetryError"]


class RetryError(RuntimeError):
    """All attempts exhausted; ``last`` is the final exception."""

    def __init__(self, name, attempts, last):
        super().__init__(f"{name}: {attempts} attempts failed; "
                         f"last error: {last!r}")
        self.attempts = attempts
        self.last = last


class Deadline:
    """An absolute time budget (monotonic clock).

    ``Deadline(5.0)`` expires 5s from construction; ``Deadline(None)``
    never expires.  ``remaining()`` clamps at 0; ``sleep(dt)`` never
    sleeps past the deadline."""

    def __init__(self, timeout_s):
        self._end = None if timeout_s is None else \
            time.monotonic() + float(timeout_s)

    @classmethod
    def after(cls, timeout_s):
        return cls(timeout_s)

    def remaining(self):
        if self._end is None:
            return float("inf")
        return max(0.0, self._end - time.monotonic())

    def expired(self):
        return self.remaining() <= 0.0

    def sleep(self, dt):
        """Sleep min(dt, remaining); returns the time actually slept."""
        dt = min(float(dt), self.remaining())
        if dt > 0:
            time.sleep(dt)
        return dt

    def __repr__(self):
        if self._end is None:
            return "Deadline(∞)"
        return f"Deadline(remaining={self.remaining():.3f}s)"


def backoff_delays(base=0.001, factor=2.0, cap=0.25, jitter=True, rng=None):
    """Yield successive backoff delays: ``min(cap, base·factor^k)``,
    full-jittered (uniform in (0, d]) unless ``jitter=False``.
    Infinite — the consumer owns the stop condition (attempt count or
    Deadline)."""
    rng = rng or random
    d = float(base)
    while True:
        yield rng.uniform(0.0, d) if jitter else d
        d = min(float(cap), d * factor)


def retry(exceptions=(OSError, TimeoutError), max_attempts=5, base=0.01,
          factor=2.0, cap=1.0, jitter=True, deadline=None, name=None,
          rng=None):
    """Decorator (or ``retry(...)(fn)`` wrapper) with capped, jittered
    exponential backoff.

    Stops on whichever comes first: ``max_attempts`` exhausted
    (raises :class:`RetryError` chaining the last failure) or the
    optional ``deadline`` (a :class:`Deadline` or float seconds per
    *call*) expiring — then the last exception re-raises as-is, since
    a deadline miss is the caller's timeout, not a retry failure.
    """
    excs = tuple(exceptions) if isinstance(exceptions, (tuple, list)) \
        else (exceptions,)

    def deco(fn):
        label = name or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dl = deadline if isinstance(deadline, Deadline) else \
                Deadline(deadline)
            delays = backoff_delays(base=base, factor=factor, cap=cap,
                                    jitter=jitter, rng=rng)
            last = None
            for attempt in range(1, max_attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except excs as e:
                    last = e
                    from ..observability.metrics import default_registry

                    default_registry().counter(
                        "retry_attempts_total",
                        help="failed attempts retried with backoff",
                        labelnames=("name",)).labels(name=label).inc()
                    if attempt >= max_attempts:
                        raise RetryError(label, attempt, e) from e
                    if dl.sleep(next(delays)) <= 0 and dl.expired():
                        raise
            raise RetryError(label, max_attempts, last)  # pragma: no cover

        return wrapper

    return deco
