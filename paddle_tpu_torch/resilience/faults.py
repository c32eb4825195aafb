"""Deterministic fault injection — the crash-consistency test driver (the
port of ``paddle_tpu/resilience/faults.py``).

Production TPU fleets treat preemption as routine (the reference's
elastic manager relaunches on ``ELASTIC_EXIT_CODE=101``); the only way
to know recovery works is to kill the process at every interesting
boundary and check what restore finds.  This module provides *named
fault sites* threaded through the I/O and checkpoint paths — each site
calls :func:`fault_point` with its name, and an installed
:class:`FaultInjector` decides (deterministically) whether to fire.

Fault kinds:

``kill``
    Raise :class:`SimulatedCrash` (a ``BaseException`` so ordinary
    ``except Exception`` recovery code can't swallow it — exactly like
    a SIGKILL, nothing downstream of the site runs).
``torn_write``
    Truncate the file named by the site's ``path`` (for a directory
    site, a seed-chosen file under it) to a seed-chosen fraction of
    its bytes, then crash — a torn write only matters when the process
    dies before completing it.
``io_error``
    Raise a transient ``OSError`` (recoverable: retry decorators and
    callers see a plain failure, the process survives).
``stall``
    Sleep ``stall_s`` seconds — an artificial host hiccup for deadline
    and watchdog paths.
``bitflip``
    Flip ONE seed-chosen bit and keep running — the silent-data-
    corruption fault (a cosmic ray, a marginal HBM cell, a desynced
    replica).  At a site passing ``tree=`` (a mutable ``{name: array}``
    dict), a seed-chosen leaf (or ``FaultSpec(leaf=...)``) is replaced
    with a one-bit-flipped copy; at a site passing ``path=``, one bit
    of the file (for a directory, of a seed-chosen file under it) is
    flipped in place.  A ``torch.Tensor`` leaf (the serving engine's
    KV page pool) is flipped in place where it lives — one byte XORed
    through a ``uint8`` view on its device, never a host copy of the
    pool — at the same seed-chosen byte and bit a numpy leaf of equal
    shape and dtype gets.  Nothing is raised: detection is the integrity
    sentinel's job (``resilience.integrity``), not the injector's.
``poison_request``
    The query-of-death fault: at a site passing ``tokens=`` (an
    iterable of token-ID streams — the serving engine passes every
    in-flight request's tokens at ``serving.step``), raise
    :class:`PoisonRequestError` whenever any stream contains the
    spec's ``pattern`` as a contiguous subsequence (seed-chosen when
    unset).  Unlike every other kind it matches on *content*, not
    occurrence: the same poisoned prompt keeps killing every replica
    it is re-dispatched to, which is exactly the cascade the router's
    suspect-tracker / canary / quarantine machinery must contain.
    ``PoisonRequestError`` is deliberately an ``OSError``: from the
    fleet router's point of view a poisoned request crashes its
    replica the way a dead RPC peer does — attribution is the
    *router's* job (suspicion points, canary dispatch), never the
    dying engine's.

Everything is **off by default**: with no injector installed,
``fault_point`` is a dict lookup and a return.  Installation is
programmatic (:func:`install` / :func:`uninstall`, or the
:func:`injected_faults` context manager tests use) or via the
``PADDLE_TPU_FAULTS`` env var (``site:kind:occurrence[,...]``), read
once by :func:`install_from_env`.

Every fired fault increments ``faults_injected_total{site=,kind=}`` in
the default metrics registry, so a fault-injection run's telemetry
shows exactly what was injected where.  A fired fault also records a
``{site, kind, occurrence, seed}`` event on the **active span** (the
thread's ambient :func:`~paddle_tpu_torch.observability.tracing.active_span`,
or an explicit ``fault_point(..., span=...)``) — a chaos-soak trace
shows *where* the fault landed inline, no cross-referencing the
counter; and the tracer's tail-retention policy pins every
fault-carrying trace in the ring.

Control-plane sites: the serving stack's data-plane sites
(``serving.admit``, ``serving.step``) are joined by the autoscaler's
control loop — ``autoscaler.poll`` fires at the top of every
:meth:`~paddle_tpu_torch.serving.Autoscaler.tick` (a ``stall`` there is the
control loop hiccuping: scaling is delayed, never wrong) and
``autoscaler.scale_up`` fires before every spawn attempt (an
``io_error`` is a spawn that died mid-flight, retried with bounded
jittered backoff — the supervisor's spawn discipline).  The port's
chaos soak harness is a later slice; ``chip_smoke.py`` phase 11 fires
a step io_error, a hard kill and a drain at a fleet on the card.
"""
from __future__ import annotations

import contextlib
import os
import time

__all__ = ["SimulatedCrash", "PoisonRequestError", "FAULT_KINDS",
           "FaultSpec", "FaultInjector", "fault_point",
           "install", "uninstall", "current_injector", "injected_faults",
           "install_from_env"]

#: every fault kind a FaultSpec may carry — tools/analysis's
#: fault-sites pass reads this tuple (by AST, not import) and requires
#: each kind to be exercised by at least one test
FAULT_KINDS = ("kill", "torn_write", "io_error", "stall", "bitflip",
               "poison_request")


class SimulatedCrash(BaseException):
    """An injected process death.  Deliberately NOT an ``Exception``:
    recovery code that catches ``Exception`` must not be able to
    "survive" a simulated SIGKILL."""

    def __init__(self, site, occurrence):
        super().__init__(f"simulated crash at fault site {site!r} "
                         f"(occurrence {occurrence})")
        self.site = site
        self.occurrence = occurrence


class PoisonRequestError(OSError):
    """A poison request killed the engine it was running on.

    Deliberately an ``OSError``: the fleet router's failure path treats
    it exactly like a crashed replica RPC, so attribution (suspicion
    points keyed by prompt hash, canary dispatch, quarantine) stays
    where the evidence is — above the replica that just died."""

    def __init__(self, site, pattern, occurrence):
        super().__init__(
            f"poison request at fault site {site!r}: token pattern "
            f"{tuple(pattern)!r} is aboard (occurrence {occurrence})")
        self.site = site
        self.pattern = tuple(pattern)
        self.occurrence = occurrence


class FaultSpec:
    """Fire ``kind`` at the ``occurrence``-th hit (1-based) of ``site``.

    ``torn_frac`` overrides the seed-derived truncation fraction for
    ``torn_write``; ``stall_s`` sets the ``stall`` duration; ``leaf``
    pins a ``bitflip`` to a named tree leaf and ``bit`` to an exact bit
    index (both seed-chosen when unset).  ``pattern`` (a token-ID
    tuple, seed-chosen when unset) is the ``poison_request`` trigger:
    that kind ignores ``occurrence`` and fires at EVERY hit of the
    site whose ``tokens=`` payload contains the pattern — a poisoned
    prompt is poisonous on every replica it reaches."""

    def __init__(self, site, kind="kill", occurrence=1, torn_frac=None,
                 stall_s=0.05, leaf=None, bit=None, pattern=None):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.site = site
        self.kind = kind
        self.occurrence = int(occurrence)
        self.torn_frac = torn_frac
        self.stall_s = stall_s
        self.leaf = leaf
        self.bit = bit
        self.pattern = None if pattern is None else tuple(
            int(t) for t in pattern)

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, {self.kind!r}, "
                f"occurrence={self.occurrence})")


class FaultInjector:
    """Seed-driven injector: hit counts per site + the spec table.

    The seed drives only *fault shape* (torn-write truncation point),
    never *whether* a fault fires — firing is exact (site, occurrence)
    matching so a failing kill point reproduces from its test id alone.
    """

    def __init__(self, specs=(), seed=0):
        import numpy as np

        self.specs = list(specs)
        self.seed = int(seed)    # echoed into span fault events
        self._rng = np.random.default_rng(seed)
        self._hits = {}          # site -> total hits
        self._fired = []         # [(site, kind, occurrence)] audit log

    # ------------------------------------------------------------ counters
    def hits(self, site):
        return self._hits.get(site, 0)

    @property
    def fired(self):
        return list(self._fired)

    # ------------------------------------------------------------- firing
    def _record(self, site, kind, occ, span=None):
        self._fired.append((site, kind, occ))
        # lazy import: faults must be importable before the
        # observability stack (and from tools that never touch it)
        from ..observability.metrics import default_registry
        from ..observability.tracing import active_span

        default_registry().counter(
            "faults_injected_total",
            help="faults fired by the resilience fault injector",
            labelnames=("site", "kind")).labels(site=site, kind=kind).inc()
        target = span if span is not None else active_span()
        if target is not None:
            # the trace-side audit record: retention classifies any
            # fault-carrying trace as always-keep
            target.attributes.setdefault("faults", []).append(
                {"site": site, "kind": kind, "occurrence": occ,
                 "seed": self.seed})

    def _file_of(self, path):
        """The file a path-targeted fault mutates: the path itself, or
        a seed-chosen file under a directory site (checkpoint commit
        sites pass the committed directory)."""
        if path is None or not os.path.exists(path):
            return None
        if not os.path.isdir(path):
            return path
        files = []
        for dirpath, _, names in os.walk(path):
            files.extend(os.path.join(dirpath, n) for n in sorted(names))
        files = sorted(f for f in files if os.path.getsize(f) > 0)
        if not files:
            return None
        return files[int(self._rng.integers(len(files)))]

    def _bitflip(self, spec, path=None, tree=None):
        import numpy as np
        import torch

        if tree is not None:
            names = sorted(k for k, v in tree.items() if _nbytes(v))
            if spec.leaf is not None and spec.leaf not in names:
                raise KeyError(f"bitflip leaf {spec.leaf!r} not in tree "
                               f"({names})")
            if not names:
                return
            name = spec.leaf if spec.leaf is not None else \
                names[int(self._rng.integers(len(names)))]
            leaf = tree[name]
            bit = (spec.bit if spec.bit is not None
                   else int(self._rng.integers(_nbytes(leaf) * 8)))
            if isinstance(leaf, torch.Tensor):
                # in place on the leaf's device: the pool is gigabytes
                # on the card, and only one byte of it changes
                if not leaf.is_contiguous():
                    leaf = tree[name] = leaf.contiguous()
                raw = leaf.reshape(-1).view(torch.uint8)
                raw[bit // 8].bitwise_xor_(1 << (bit % 8))
                return
            arr = np.array(leaf, copy=True)             # host, writable
            flat = arr.reshape(-1).view(np.uint8)
            flat[bit // 8] ^= np.uint8(1 << (bit % 8))
            tree[name] = arr
            return
        target = self._file_of(path)
        if target is None:
            return
        size = os.path.getsize(target)
        bit = (spec.bit if spec.bit is not None
               else int(self._rng.integers(size * 8)))
        with open(target, "r+b") as f:
            f.seek(bit // 8)
            b = f.read(1)
            f.seek(bit // 8)
            f.write(bytes([b[0] ^ (1 << (bit % 8))]))

    def _poison_pattern(self, spec):
        """The spec's trigger pattern, seed-chosen (and cached on the
        spec) when the caller didn't pin one."""
        if spec.pattern is None:
            spec.pattern = tuple(
                int(t) for t in self._rng.integers(1, 1 << 15, size=3))
        return spec.pattern

    @staticmethod
    def _contains(stream, pattern):
        """Contiguous-subsequence match of ``pattern`` in ``stream``."""
        n, m = len(stream), len(pattern)
        if m == 0 or n < m:
            return False
        first = pattern[0]
        for i in range(n - m + 1):
            if stream[i] == first and \
                    tuple(stream[i:i + m]) == pattern:
                return True
        return False

    def on_fault_point(self, site, path=None, tree=None, span=None,
                       tokens=None):
        occ = self._hits.get(site, 0) + 1
        self._hits[site] = occ
        # poison_request matches on CONTENT, not occurrence: the same
        # poisoned token pattern fires at every hit of the site it is
        # aboard — re-dispatching the request to a fresh replica
        # re-arms the fault, which is the whole cascade
        if tokens is not None:
            for spec in self.specs:
                if spec.site != site or spec.kind != "poison_request":
                    continue
                pattern = self._poison_pattern(spec)
                if any(self._contains(list(stream), pattern)
                       for stream in tokens):
                    self._record(site, spec.kind, occ, span=span)
                    raise PoisonRequestError(site, pattern, occ)
        for spec in self.specs:
            if spec.site != site or spec.occurrence != occ \
                    or spec.kind == "poison_request":
                continue
            self._record(site, spec.kind, occ, span=span)
            if spec.kind == "kill":
                raise SimulatedCrash(site, occ)
            if spec.kind == "torn_write":
                target = self._file_of(path)
                if target is not None:
                    size = os.path.getsize(target)
                    frac = (spec.torn_frac if spec.torn_frac is not None
                            else float(self._rng.uniform(0.1, 0.9)))
                    with open(target, "r+b") as f:
                        f.truncate(max(0, int(size * frac)))
                raise SimulatedCrash(site, occ)
            if spec.kind == "io_error":
                raise OSError(f"injected transient I/O error at {site!r} "
                              f"(occurrence {occ})")
            if spec.kind == "stall":
                time.sleep(spec.stall_s)
            if spec.kind == "bitflip":
                self._bitflip(spec, path=path, tree=tree)


def _nbytes(leaf):
    """Bytes of a tree leaf: a torch tensor's storage, else a numpy
    array's (0 for anything without data)."""
    if hasattr(leaf, "element_size"):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


_injector: FaultInjector | None = None


def install(injector: FaultInjector):
    global _injector
    _injector = injector
    return injector


def uninstall():
    global _injector
    _injector = None


def current_injector():
    return _injector


@contextlib.contextmanager
def injected_faults(*specs, seed=0):
    """``with injected_faults(FaultSpec(...)):`` — install for a block,
    always uninstall (even when the block dies of SimulatedCrash)."""
    inj = install(FaultInjector(specs, seed=seed))
    try:
        yield inj
    finally:
        uninstall()


def fault_point(site, path=None, tree=None, span=None, tokens=None):
    """Declare a named fault site.  No-op unless an injector is
    installed AND a spec matches this site at the current hit count.
    ``tree`` (a mutable ``{name: array}`` dict) exposes live state to
    the ``bitflip`` kind — the caller must write replaced leaves back.
    ``tokens`` (an iterable of token-ID streams) exposes in-flight
    request content to the ``poison_request`` kind, which fires on a
    pattern match at EVERY hit, not a counted occurrence.  ``span``
    pins the fired-fault event to a specific span instead of the
    thread's ambient :func:`active_span`."""
    if _injector is not None:
        _injector.on_fault_point(site, path=path, tree=tree, span=span,
                                 tokens=tokens)


def install_from_env(var="PADDLE_TPU_FAULTS"):
    """Parse ``site:kind:occurrence[,site:kind:occurrence...]`` from the
    environment and install an injector; returns it (None if unset).
    Seed comes from ``PADDLE_TPU_FAULTS_SEED`` (default 0)."""
    raw = os.environ.get(var, "").strip()
    if not raw:
        return None
    specs = []
    for item in raw.split(","):
        parts = item.strip().split(":")
        site = parts[0]
        kind = parts[1] if len(parts) > 1 else "kill"
        occ = int(parts[2]) if len(parts) > 2 else 1
        specs.append(FaultSpec(site, kind, occurrence=occ))
    seed = int(os.environ.get(var + "_SEED", "0"))
    return install(FaultInjector(specs, seed=seed))
