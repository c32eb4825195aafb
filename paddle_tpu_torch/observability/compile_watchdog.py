"""Compile watchdog — the static-shape regression detector (the port of
``paddle_tpu/observability/compile_watchdog.py``).

A step that should be built once and run many times can quietly be
built again: a ragged batch, an un-padded prompt, a dtype drift.  In the
JAX package the build is an XLA compile of a ``jax.jit`` program; here
it is whatever the watched callable does on a signature it has not seen
— for the serving engine's unified step, the capture of its CUDA graph
(``serving/engine.py``).  The watchdog wraps such entry points and

- counts builds and calls per function (labelled counters
  ``jit_compiles_total{fn=...}`` / ``jit_recompiles_total{fn=...}`` in
  the default :class:`~.metrics.MetricsRegistry`, the JAX package's
  names),
- records the build's wall time per function (``compile_time_s``),
- logs a WARNING with the per-argument shape/dtype **diff** whenever a
  function builds again after warmup (the first build of a function is
  warmup and logs nothing; repeated same-signature calls log nothing).

Opt-in: wrapping is always installed but dormant — a disabled watchdog
adds one attribute check per call.  Enable per process with
:func:`enable_compile_watchdog` (or ``PADDLE_TPU_COMPILE_WATCHDOG=1`` in
the environment), scoped with ``with watchdog_enabled(): ...``.

A *build* is a first-seen argument signature: the nested arguments'
tensor shapes, dtypes and devices (CPU tensors render as ``f32[4,2]``,
others add ``@cuda:0``) and the repr of every other value (static
values).  Each :class:`WatchedFunction` keeps the signatures it has
seen, as each ``jax.jit`` object keeps its own executable cache, and
the statistics add up by name: two engines that each capture their
step once report ``compiles == 2, recompiles == 0`` under
``serving::unified_step``.  The build's wall time is the first call's
(capture and the run around it).

What the JAX watchdog reports beside that and this one does not: the
XLA cost analysis (flops, bytes accessed) of the compiled program.
There is no HLO here, so the port reports no cost rather than an
estimate.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

__all__ = ["CompileWatchdog", "WatchedFunction", "watch",
           "default_watchdog", "enable_compile_watchdog",
           "disable_compile_watchdog", "watchdog_enabled"]

logger = logging.getLogger("paddle_tpu_torch.observability")

_SHORT = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
          "float16": "f16", "int32": "i32", "int64": "i64", "int8": "i8",
          "uint8": "u8", "uint32": "u32", "bool": "pred"}


def _aval_str(leaf):
    """``f32[8,128]``-style rendering of one signature leaf: a tensor's
    (or array's) dtype and shape, ``@device`` for a tensor off the CPU;
    the repr of anything else."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return repr(leaf)
    name = str(dtype).replace("torch.", "")
    out = f"{_SHORT.get(name, name)}[{','.join(str(d) for d in shape)}]"
    device = getattr(leaf, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        out += f"@{device}"
    return out


def _flatten(tree, path, out):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _flatten(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out.append((path, _aval_str(tree)))


def _signature(args, kwargs):
    """((path, aval-string), ...) over the nested call operands — the
    build key rendered human-readably, so the stored signature IS the
    diffable artifact."""
    out = []
    _flatten(args, "", out)
    _flatten(kwargs, "", out)
    return tuple(out)


def _sig_diff(old, new):
    """Human-readable per-argument diff between two signatures."""
    old_d, new_d = dict(old), dict(new)
    lines = []
    for path, aval in new_d.items():
        prev = old_d.get(path)
        if prev is None:
            lines.append(f"  {path}: (new) {aval}")
        elif prev != aval:
            lines.append(f"  {path}: {prev} -> {aval}")
    for path, aval in old_d.items():
        if path not in new_d:
            lines.append(f"  {path}: {aval} -> (gone)")
    if not lines:
        lines.append("  (argument structure changed)")
    return "\n".join(lines)


class _FnStats:
    __slots__ = ("name", "calls", "compiles", "recompiles",
                 "compile_time_s")

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.recompiles = 0
        self.compile_time_s = 0.0

    def as_dict(self):
        return {"calls": self.calls, "compiles": self.compiles,
                "recompiles": self.recompiles,
                "compile_time_s": self.compile_time_s}


class WatchedFunction:
    """Callable proxy over a watched function.  Unknown attributes
    forward to the wrapped function, and ``__wrapped__`` exposes it.
    It holds the signatures it has seen (its build cache's keys)."""

    def __init__(self, fn, name, watchdog):
        self.__wrapped__ = fn
        self._name = name
        self._watchdog = watchdog
        self._signatures = set()     # guarded-by: watchdog._lock
        self._last_signature = None  # guarded-by: watchdog._lock

    def __call__(self, *args, **kwargs):
        wd = self._watchdog
        if not wd.enabled:
            return self.__wrapped__(*args, **kwargs)
        return wd._record_call(self, args, kwargs)

    def __getattr__(self, attr):
        return getattr(self.__wrapped__, attr)


class CompileWatchdog:
    """Per-process build telemetry over any number of watched functions.
    ``report()`` returns {fn_name: {calls, compiles, recompiles,
    compile_time_s}}."""

    def __init__(self, registry=None):
        self.enabled = os.environ.get(
            "PADDLE_TPU_COMPILE_WATCHDOG", "") not in ("", "0", "false")
        self._registry = registry
        self._stats = {}        # guarded-by: self._lock
        self._lock = threading.Lock()

    # ---- lifecycle ------------------------------------------------------
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        """Drop the statistics.  Each wrapper keeps the signatures it has
        built, as a jitted function keeps its cache."""
        with self._lock:
            self._stats.clear()

    def registry(self):
        if self._registry is None:
            from .metrics import default_registry

            self._registry = default_registry()
        return self._registry

    # ---- wrapping -------------------------------------------------------
    def watch(self, fn, name=None):
        """Wrap a callable; returns a transparent proxy."""
        if isinstance(fn, WatchedFunction):
            return fn
        name = name or getattr(fn, "__name__", repr(fn))
        return WatchedFunction(fn, name, self)

    def _record_call(self, watched, args, kwargs):
        sig = _signature(args, kwargs)
        with self._lock:
            st = self._stats.setdefault(
                watched._name, _FnStats(watched._name))
            st.calls += 1
            is_new = sig not in watched._signatures
            prev_sig = watched._last_signature
            n_prior = len(watched._signatures)
            if is_new:
                watched._signatures.add(sig)
            watched._last_signature = sig
        if not is_new:
            return watched.__wrapped__(*args, **kwargs)

        t0 = time.perf_counter()
        out = watched.__wrapped__(*args, **kwargs)
        dt = time.perf_counter() - t0
        reg = self.registry()
        reg.counter("jit_compiles_total",
                    "builds (compiles, graph captures) per watched "
                    "function", labelnames=("fn",)) \
            .labels(fn=watched._name).inc()
        with self._lock:
            st.compiles += 1
            st.compile_time_s += dt
        if n_prior > 0:                       # rebuild after warmup
            with self._lock:
                st.recompiles += 1
            reg.counter("jit_recompiles_total",
                        "post-warmup rebuilds (shape/dtype drift)",
                        labelnames=("fn",)) \
                .labels(fn=watched._name).inc()
            logger.warning(
                "recompilation #%d of %s (%.2fs): argument "
                "signature changed\n%s",
                n_prior, watched._name, dt, _sig_diff(prev_sig, sig))
        else:
            logger.debug("first compile of %s: %.2fs", watched._name, dt)
        return out

    # ---- reporting ------------------------------------------------------
    def report(self):
        with self._lock:
            return {name: st.as_dict() for name, st in self._stats.items()}


_default = CompileWatchdog()


def default_watchdog() -> CompileWatchdog:
    return _default


def watch(fn, name=None):
    """Wrap ``fn`` under the default watchdog (dormant until enabled)."""
    return _default.watch(fn, name)


def enable_compile_watchdog():
    return _default.enable()


def disable_compile_watchdog():
    return _default.disable()


@contextlib.contextmanager
def watchdog_enabled(watchdog=None):
    wd = watchdog or _default
    prev = wd.enabled
    wd.enable()
    try:
        yield wd
    finally:
        wd.enabled = prev
