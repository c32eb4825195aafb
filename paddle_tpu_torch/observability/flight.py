"""Distributed flight recorder — per-collective accounting + hang
watchdog (the port of ``paddle_tpu/observability/flight.py``).

The failure a world of ranks hits first: one rank stalls inside a
collective and the whole job hangs silently, with no record of who was
where.  Three pieces close that gap:

- :class:`FlightRecorder` — a bounded per-process ring of
  :class:`CollectiveRecord`\\ s.  Every public op in
  ``distributed/collective.py`` routes through the
  :func:`record_collective` decorator (``tests/test_torch_flight.py``
  lints it), and the differentiable all-to-all and the pipeline's p2p
  ticks record through :meth:`FlightRecorder.record`: each call gets a
  monotonic sequence number (global + per-group), op kind, group,
  tensor shapes/dtypes/byte counts, start/end stamps on the injectable
  clock, and the caller site.  Completed records land in the ring, feed
  ``collective_ops_total{op,group}`` / ``collective_bytes_total`` /
  ``collective_latency_seconds`` in the registry, and emit
  ``collective::<op>`` spans on the Tracer so collectives sit on the
  chrome timeline next to ``hapi::step``.
- :class:`HangWatchdog` — a per-rank daemon thread (built on
  :class:`~paddle_tpu_torch.observability.aggregate.StorePublisher`,
  over the world's ``TCPStore``): each rank publishes ``(last_seq,
  last_op, inflight, step, wall)`` heartbeats; every watchdog reads all
  ranks' heartbeats and, when a lagging rank's sequence number stays
  frozen past ``stall_timeout_s`` while peers have moved on, fires
  ONCE: a cross-rank **desync report** naming the lagging rank and the
  first seq/op where ranks diverge, plus (with ``bundle_dir`` set) a
  **debug bundle** — the last-N collective records, live thread stacks
  (``sys._current_frames``), the registry snapshot and the tracer's
  in-flight spans — written atomically via
  :func:`~paddle_tpu_torch.resilience.atomic.atomic_write`.  Lag-change
  times are tracked on the local monotonic clock, so detection is
  clock-skew free; the wall stamp in heartbeats is informational.
  ``rank=None`` is observer mode (the ``TrainingSupervisor``'s
  parent-side view): monitor every rank's heartbeat, publish nothing.
- thread-local recorder scoping (:func:`use_flight_recorder`) so tests
  and multi-engine processes can give each logical rank its own ring;
  :func:`default_flight_recorder` falls back to the process-wide one.

Hang reproduction rides the fault injector: the
``collective.all_reduce`` / ``collective.barrier`` sites in
``distributed/collective.py`` take ``kind="stall"`` specs, freezing a
rank mid-collective with the record in flight — exactly what the
watchdog must localize.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import sys
import threading
import time
import traceback

from .aggregate import StorePublisher, _rank_key
from .metrics import default_registry
from .tracing import default_tracer

__all__ = ["CollectiveRecord", "FlightRecorder", "HangWatchdog",
           "default_flight_recorder", "use_flight_recorder",
           "record_collective", "thread_stacks"]

logger = logging.getLogger("paddle_tpu_torch.observability")


def _caller_site(depth=2):
    """``file.py:lineno`` of the frame ``depth`` levels up (cheap: one
    ``sys._getframe``, no stack walk)."""
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except (ValueError, AttributeError):
        return None


def _tensor_stats(args, max_leaves=8):
    """(shapes, dtypes, nbytes) over the tensor leaves of ``args`` (one
    list/tuple level deep, capped at ``max_leaves`` — the recorder must
    stay O(1) per collective, not O(tree))."""
    shapes, dtypes, nbytes = [], [], 0
    leaves = []
    for a in args:
        if isinstance(a, (list, tuple)):
            leaves.extend(a[:max_leaves])
        else:
            leaves.append(a)
    for x in leaves[:max_leaves]:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is None or dtype is None:
            continue
        try:
            shape = tuple(int(d) for d in shape)
        except (TypeError, ValueError):
            continue
        shapes.append(shape)
        dtypes.append(str(dtype).replace("torch.", ""))
        size = getattr(x, "element_size", None)
        if size is not None:
            nbytes += int(size()) * int(math.prod(shape))
            continue
        try:
            import numpy as np

            nbytes += int(np.dtype(str(dtype)).itemsize) * \
                int(math.prod(shape))
        except (TypeError, ValueError):
            pass
    return shapes, dtypes, nbytes


def _group_label(group):
    """Stable label for a collective group: the mesh axis name (tuple
    axes joined), else the group id, else ``world``."""
    if group is None:
        return "world"
    axis = getattr(group, "axis_name", None)
    if axis is not None:
        return ",".join(axis) if isinstance(axis, (tuple, list)) else \
            str(axis)
    gid = getattr(group, "id", None)
    return f"gid{gid}" if gid is not None else "world"


class CollectiveRecord:
    """One collective call: sequence numbers, shape/byte accounting and
    timing.  Mutated only by its :class:`FlightRecorder`."""

    __slots__ = ("seq", "group_seq", "op", "group", "shapes", "dtypes",
                 "nbytes", "start_s", "end_s", "caller", "step", "error",
                 "thread", "wire_s")

    def __init__(self, seq, group_seq, op, group, shapes, dtypes, nbytes,
                 start_s, caller, step):
        self.seq = seq
        self.group_seq = group_seq
        self.op = op
        self.group = group
        self.shapes = shapes
        self.dtypes = dtypes
        self.nbytes = nbytes
        self.start_s = start_s
        self.end_s = None
        self.caller = caller
        self.step = step
        self.error = None
        self.thread = threading.get_ident()
        self.wire_s = None      # when the call reached the transport

    @property
    def ended(self):
        return self.end_s is not None

    def to_dict(self):
        return {"seq": self.seq, "group_seq": self.group_seq,
                "op": self.op, "group": self.group,
                "shapes": [list(s) for s in self.shapes],
                "dtypes": list(self.dtypes), "nbytes": self.nbytes,
                "start_s": self.start_s, "end_s": self.end_s,
                "caller": self.caller, "step": self.step,
                "error": self.error}

    def __repr__(self):
        state = "done" if self.ended else "inflight"
        return (f"CollectiveRecord(seq={self.seq}, op={self.op!r}, "
                f"group={self.group!r}, {state})")


class FlightRecorder:
    """Bounded ring of collective records + the metrics/span fan-out.

    ``capacity`` bounds the completed-record ring (a pod-scale run
    issuing millions of collectives holds a constant-size record);
    ``clock`` is the injectable timebase (``time.perf_counter`` — the
    tracer/profiler timebase — by default).  Thread-safe: collectives
    from the serving thread and an operator snapshotting the ring take
    the same lock.  ``note_step`` is the hapi step-progress heartbeat:
    ``Model.fit`` stamps (epoch, step) each batch so heartbeats and
    bundles say *where in training* each rank was, not just which
    collective."""

    def __init__(self, capacity=512, registry=None, tracer=None,
                 clock=None, emit_spans=True):
        self.capacity = int(capacity)
        self.enabled = True
        self.emit_spans = emit_spans
        self._registry = registry
        self._tracer = tracer
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._ring = []            # oldest first; guarded-by: self._lock
        self._inflight = []        # unfinished; guarded-by: self._lock
        self._seq = 0              # global monotonic; guarded-by: self._lock
        self._group_seq = {}       # per-group seq; guarded-by: self._lock
        self._last_done_seq = 0    # last COMPLETED; guarded-by: self._lock
        self._last_op = None       # guarded-by: self._lock
        self._completed = 0        # lifetime count; guarded-by: self._lock
        self.step = None           # guarded-by: self._lock
        self.epoch = None          # guarded-by: self._lock

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            self._registry = default_registry()
        return self._registry

    def tracer(self):
        if self._tracer is None:
            self._tracer = default_tracer()
        return self._tracer

    # ---- progress -------------------------------------------------------
    def note_step(self, step, epoch=None):
        """Training-step progress heartbeat (``Model.fit`` calls this
        once per batch); rides the hang watchdog's heartbeat payload.
        Locked so a heartbeat reader never sees a new step paired with
        a stale epoch (the pair is written between two batches)."""
        with self._lock:
            self.step = int(step)
            if epoch is not None:
                self.epoch = int(epoch)

    def progress(self):
        """``(step, epoch)`` read under the lock — external readers
        (the hang watchdog's heartbeat/bundle) must not see a torn
        step/epoch pair mid-:meth:`note_step`."""
        with self._lock:
            return self.step, self.epoch

    # ---- record lifecycle -----------------------------------------------
    def start(self, op, group=None, tensors=(), caller=None):
        """Open a record for one collective call (marks it in flight)."""
        glabel = _group_label(group)
        shapes, dtypes, nbytes = _tensor_stats(tensors)
        with self._lock:
            self._seq += 1
            gseq = self._group_seq.get(glabel, 0) + 1
            self._group_seq[glabel] = gseq
            rec = CollectiveRecord(self._seq, gseq, op, glabel, shapes,
                                   dtypes, nbytes, self.clock(), caller,
                                   self.step)
            self._inflight.append(rec)
        return rec

    def finish(self, rec, error=None):
        """Close a record: ring it, bump the metrics, emit the span."""
        with self._lock:
            rec.end_s = self.clock()
            rec.error = error
            try:
                self._inflight.remove(rec)
            except ValueError:
                pass
            self._ring.append(rec)
            self._completed += 1
            if rec.seq > self._last_done_seq:
                self._last_done_seq = rec.seq
                self._last_op = rec.op
            if len(self._ring) > self.capacity:
                del self._ring[:len(self._ring) - self.capacity]
        reg = self.registry()
        reg.counter(
            "collective_ops_total", "collective calls by op and group",
            labelnames=("op", "group")).labels(
                op=rec.op, group=rec.group).inc()
        if rec.nbytes:
            reg.counter(
                "collective_bytes_total",
                "payload bytes through collectives",
                labelnames=("op", "group")).labels(
                    op=rec.op, group=rec.group).inc(rec.nbytes)
        reg.histogram(
            "collective_latency_seconds",
            "wall time inside collective calls",
            labelnames=("op", "group")).labels(
                op=rec.op, group=rec.group).observe(
                    rec.end_s - rec.start_s)
        if self.emit_spans:
            attrs = {"seq": rec.seq, "group": rec.group,
                     "bytes": rec.nbytes, "caller": rec.caller}
            if rec.step is not None:
                attrs["step"] = rec.step
            if error is not None:
                attrs["error"] = error
            span = self.tracer().start_trace(
                f"collective::{rec.op}", attributes=attrs,
                start_s=rec.start_s)
            span.end(end_s=rec.end_s)
        return rec

    @contextlib.contextmanager
    def record(self, op, group=None, tensors=()):
        """``with recorder.record("all_reduce", group, (x,)):`` — the
        manual form of what :func:`record_collective` does."""
        rec = self.start(op, group=group, tensors=tensors,
                         caller=_caller_site(3))
        try:
            yield rec
        except BaseException as e:
            self.finish(rec, error=repr(e))
            raise
        else:
            self.finish(rec)

    def mark_wire(self):
        """Stamp this thread's newest in-flight record as handed to the
        transport (``distributed/collective.py`` calls it where a call
        reaches the wire).  Ranks blocked in a collective whose peer
        never arrived are on the wire; the peer is not — the heartbeat's
        ``wire`` field is how the watchdog tells them apart when every
        rank sits at the same sequence number."""
        me = threading.get_ident()
        with self._lock:
            for rec in reversed(self._inflight):
                if rec.thread == me:
                    if rec.wire_s is None:
                        rec.wire_s = self.clock()
                    return

    @property
    def wire_seq(self):
        """Seq of the oldest in-flight record that reached the transport
        (None when no call is waiting on the wire)."""
        with self._lock:
            for rec in self._inflight:
                if rec.wire_s is not None:
                    return rec.seq
            return None

    # ---- readers --------------------------------------------------------
    @property
    def last_seq(self):
        """Last COMPLETED global sequence number (the heartbeat value —
        a rank stuck inside seq N reports N-1)."""
        with self._lock:
            return self._last_done_seq

    @property
    def last_op(self):
        with self._lock:
            return self._last_op

    def records(self, limit=None):
        """Completed records (oldest → newest) as JSON-able dicts."""
        with self._lock:
            out = list(self._ring)
        if limit is not None:
            out = out[-int(limit):]
        return [r.to_dict() for r in out]

    def inflight(self):
        """Started-but-unfinished records — where a hung rank IS."""
        with self._lock:
            return [r.to_dict() for r in self._inflight]

    def inflight_brief(self):
        """``{"seq", "op", "group"}`` of the oldest in-flight record
        (None when idle) — the heartbeat's hang-site field."""
        with self._lock:
            if not self._inflight:
                return None
            r = self._inflight[0]
            return {"seq": r.seq, "op": r.op, "group": r.group}

    def summary(self):
        """Ring digest: lifetime counts, per-op totals, in-flight state
        (the ``/flight`` endpoint's headline)."""
        with self._lock:
            ring = list(self._ring)
            completed, last_seq = self._completed, self._last_done_seq
            inflight = [{"seq": r.seq, "op": r.op, "group": r.group}
                        for r in self._inflight]
            step, epoch = self.step, self.epoch
        by_op = {}
        for r in ring:
            cnt, byt = by_op.get(r.op, (0, 0))
            by_op[r.op] = (cnt + 1, byt + r.nbytes)
        return {"completed": completed, "buffered": len(ring),
                "capacity": self.capacity, "last_seq": last_seq,
                "inflight": inflight, "step": step, "epoch": epoch,
                "by_op": {op: {"count": c, "bytes": b}
                          for op, (c, b) in sorted(by_op.items())}}

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._inflight.clear()
            self._seq = 0
            self._group_seq.clear()
            self._last_done_seq = 0
            self._last_op = None
            self._completed = 0
            self.step = self.epoch = None


# ---------------------------------------------------- recorder scoping

_DEFAULT = FlightRecorder()
_tls = threading.local()


def default_flight_recorder() -> FlightRecorder:
    """The active recorder: a thread-local override installed by
    :func:`use_flight_recorder` (per-rank rings in tests and
    multi-engine processes), else the process-wide one."""
    return getattr(_tls, "recorder", None) or _DEFAULT


@contextlib.contextmanager
def use_flight_recorder(recorder):
    """Scope ``recorder`` as this THREAD's flight recorder — collectives
    issued inside the block record there instead of the process ring."""
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = recorder
    try:
        yield recorder
    finally:
        _tls.recorder = prev


def record_collective(op_name):
    """Decorator instrumenting one public collective op: every call
    opens/closes a :class:`CollectiveRecord` on the active recorder
    (errors are recorded, then re-raised — a failing collective is a
    record, not a blind spot).  The un-instrumented callable stays
    reachable as ``fn.__wrapped__`` (the bench's bare baseline)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = default_flight_recorder()
            if not rec.enabled:
                return fn(*args, **kwargs)
            group = kwargs.get("group")
            if group is None:       # positional Group (duck-typed)
                for a in args:
                    if hasattr(a, "axis_name") and hasattr(a, "nranks"):
                        group = a
                        break
            r = rec.start(op_name, group=group, tensors=args,
                          caller=_caller_site(2))
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:
                rec.finish(r, error=repr(e))
                raise
            rec.finish(r)
            return out
        return wrapper
    return deco


# -------------------------------------------------------- hang watchdog


def thread_stacks():
    """``{thread_name-tid: [frames...]}`` for every live thread — the
    in-process equivalent of ``faulthandler.dump_traceback`` that a
    debug bundle can carry as JSON."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, 'unknown')}-{tid}"
        out[key] = [line.rstrip("\n")
                    for line in traceback.format_stack(frame)]
    return out


class HangWatchdog(StorePublisher):
    """Cross-rank hang detection over TCPStore heartbeats.

    Each rank runs one (``start(interval_s)`` or explicit
    :meth:`poll`): a beat publishes this rank's heartbeat (observer
    mode ``rank=None`` skips that), fetches every rank's, and evaluates
    progress.  A rank is *stalled* when its progress is behind the
    fleet max AND neither that lag nor its progress nor the collective
    it has in flight has changed for ``stall_timeout_s`` on the local
    monotonic clock.  Progress is the last completed seq, plus one half
    while the next collective waits on the transport (the heartbeat's
    ``wire``): the JAX watchdog's test is the seq alone, which cannot
    tell ranks apart in a world of blocking collectives, where the
    peers of a stalled rank wait inside the same collective at the same
    seq.  A rank that lags only by that half is named only while it
    sits inside a collective that has not reached the transport (an
    in-flight record, not on the wire); with nothing in flight it is
    computing or writing (a checkpoint while its peers wait in a
    barrier), not hung in a collective.  A rank behind in completed
    seqs is named as the JAX watchdog names it.  First detection fires
    once (sticky
    ``hang_active`` until the fleet re-converges): the desync report
    lands in ``last_desync``, ``hang_watchdog_fired_total`` /
    ``hang_watchdog_active`` move, a ``flight::hang`` span is emitted,
    and — with ``bundle_dir`` — :meth:`write_bundle` dumps this rank's
    evidence atomically.
    """

    def __init__(self, store, rank=None, world_size=1, recorder=None,
                 stall_timeout_s=5.0, interval_s=None, bundle_dir=None,
                 bundle_records=128, registry=None, tracer=None,
                 key_prefix="flight", clock=None, wall_clock=None,
                 profiler=None):
        key = (_rank_key(f"{key_prefix}/hb", rank)
               if rank is not None else None)
        super().__init__(store, key, clock=wall_clock)
        self.rank = rank
        self.world_size = int(world_size)
        self.recorder = recorder
        self.stall_timeout_s = float(stall_timeout_s)
        self.interval_s = (float(interval_s) if interval_s is not None
                           else max(0.05, self.stall_timeout_s / 5.0))
        self.bundle_dir = bundle_dir
        self.bundle_records = int(bundle_records)
        self._registry = registry
        self._tracer = tracer
        self.profiler = profiler
        self.key_prefix = key_prefix
        self._mono = clock or time.monotonic
        # rank -> ((progress, in-flight seq), mono time it last changed):
        # a rank that enters a collective starts its stall clock there
        self._seen = {}            # guarded-by: self._plock
        # rank -> (fleet max, mono time the rank was first seen behind
        # it): a rank whose beat is old when its peers move on is not
        # stalled yet
        self._lag_since = {}       # guarded-by: self._plock
        self._plock = threading.Lock()
        # sticky detection state: written only under _plock (poll /
        # reset); lock-free reads by the exporter and supervisor are
        # intentional — each is a single-attribute snapshot
        self.hang_active = False
        self.fired = 0
        self.last_desync = None
        self.bundles = []
        self.thread_name = f"hang-watchdog-{rank}"

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            self._registry = default_registry()
        return self._registry

    def tracer(self):
        if self._tracer is None:
            self._tracer = default_tracer()
        return self._tracer

    def _active_gauge(self):
        return self.registry().gauge(
            "hang_watchdog_active",
            "1 while a cross-rank collective hang is detected")

    # ---- heartbeats -----------------------------------------------------
    def payload(self):
        rec = self.recorder
        return {"rank": self.rank,
                "seq": rec.last_seq if rec is not None else 0,
                "op": rec.last_op if rec is not None else None,
                "inflight": (rec.inflight_brief()
                             if rec is not None else None),
                "step": (rec.progress()[0]
                         if rec is not None else None),
                "wire": rec.wire_seq if rec is not None else None,
                "wall": self._clock()}

    def heartbeats(self):
        """``{rank: heartbeat}`` of every rank that has published."""
        keys = self._beat_keys()
        if hasattr(self.store, "mget"):
            raw = self.store.mget(keys, value_size_hint=512)
        else:
            raw = []
            for k in keys:
                try:
                    raw.append(self.store.get(k, blocking=False))
                except KeyError:
                    raw.append(None)
        out = {}
        for r, blob in enumerate(raw):
            if blob is None:
                continue
            try:
                hb = json.loads(blob)
            except ValueError:
                continue
            out[r] = hb
        return out

    # ---- detection ------------------------------------------------------
    def tick(self):
        self.poll()

    def check(self):
        """Supervisor-facing probe: with the thread running, read the
        sticky flag; otherwise run one poll inline."""
        if self.running:
            return self.hang_active
        return self.poll()

    def poll(self):
        """One beat: publish own heartbeat, read all, evaluate.  Returns
        ``hang_active``.  Store errors are swallowed — a flaky store is
        not a hang."""
        with self._plock:
            if self.key is not None and self.recorder is not None:
                try:
                    self.publish()
                except Exception:
                    pass    # silent-ok: a flaky store is not a hang
            try:
                hbs = self.heartbeats()
            except Exception:
                return self.hang_active
            self._evaluate_locked(hbs)
            return self.hang_active

    @staticmethod
    def _progress(hb):
        """A rank's progress: its last completed seq, plus one half when
        its next collective (seq + 1) already waits on the wire — so in a
        world where every rank sits at one seq, the rank that never
        reached the transport lags the ones blocked inside it."""
        seq = int(hb.get("seq", 0))
        wire = hb.get("wire")
        return seq + (0.5 if wire is not None and int(wire) == seq + 1
                      else 0.0)

    @staticmethod
    def _hung_at(hb, top):
        """Whether a lagging rank may be named: behind the fleet in
        completed seqs (the JAX rule), or inside a collective that has
        not reached the wire while its peers wait on it."""
        seq = int(hb.get("seq", 0))
        if seq < int(top):
            return True
        wire = hb.get("wire")
        return bool(hb.get("inflight")) and \
            (wire is None or int(wire) != seq + 1)

    def _evaluate_locked(self, hbs):
        # caller holds self._plock (the _locked suffix is the contract)
        now = self._mono()
        prog = {r: self._progress(hb) for r, hb in hbs.items()}
        for r, p in prog.items():
            state = (p, (hbs[r].get("inflight") or {}).get("seq"))
            prev = self._seen.get(r)
            if prev is None or prev[0] != state:
                self._seen[r] = (state, now)
        if len(hbs) < 2:
            return
        top = max(prog.values())
        lagging = [r for r, p in prog.items() if p < top]
        lag = self._lag_since
        self._lag_since = {r: lag[r] if lag.get(r, (None,))[0] == top
                           else (top, now) for r in lagging}
        if not lagging:
            if self.hang_active:       # fleet re-converged
                self.hang_active = False
                self._active_gauge().set(0)
                logger.warning("hang watchdog (rank %s): fleet "
                               "re-converged at seq %d", self.rank,
                               int(top))
            return
        stalled = [r for r in lagging
                   if now - max(self._seen[r][1], self._lag_since[r][1])
                   >= self.stall_timeout_s and self._hung_at(hbs[r], top)]
        if stalled and not self.hang_active:
            self._fire_locked(stalled, prog, hbs)

    def _fire_locked(self, stalled, prog, hbs):
        self.hang_active = True
        self.fired += 1
        seqs = {r: int(hb.get("seq", 0)) for r, hb in hbs.items()}
        lag = min(stalled, key=lambda r: prog[r])
        div_seq = seqs[lag] + 1
        op = None
        inflight = hbs.get(lag, {}).get("inflight")
        if inflight:                   # the lagging rank IS inside an op
            div_seq = int(inflight.get("seq", div_seq))
            op = inflight.get("op")
        else:                          # infer from a rank exactly there
            for r, s in seqs.items():
                if s == div_seq:
                    op = hbs[r].get("op")
                    break
                inf = hbs[r].get("inflight")
                if inf and int(inf.get("seq", 0)) == div_seq:
                    op = inf.get("op")
                    break
        self.last_desync = {
            "detected_by": self.rank,
            "wall": self._clock(),
            "stalled_ranks": sorted(stalled),
            "lagging_rank": lag,
            "divergent_seq": div_seq,
            "op": op,
            "seqs": {str(r): s for r, s in sorted(seqs.items())},
            "steps": {str(r): hb.get("step")
                      for r, hb in sorted(hbs.items())},
            "heartbeats": {str(r): hb for r, hb in sorted(hbs.items())},
        }
        reg = self.registry()
        reg.counter("hang_watchdog_fired_total",
                    "cross-rank hangs detected by the watchdog").inc()
        self._active_gauge().set(1)
        span = self.tracer().start_trace(
            "flight::hang",
            attributes={"lagging_rank": lag, "divergent_seq": div_seq,
                        "op": op, "stalled": sorted(stalled)})
        span.end()
        if self.profiler is not None:
            try:
                # a hang is the best moment for a high-rate stack look:
                # the capture continues the flight::hang span's trace
                self.profiler.trigger_capture("hang", detail=op,
                                              context=span.context())
            except Exception:
                pass    # silent-ok: escalation must not mask the hang
        logger.error(
            "hang watchdog (rank %s): rank %s stalled at seq %d "
            "(fleet max %d), diverging at seq %d op=%s",
            self.rank, lag, seqs[lag], max(seqs.values()), div_seq, op)
        if self.bundle_dir is not None:
            try:
                self.write_bundle(reason="hang")
            except Exception:
                logger.exception("hang watchdog (rank %s): bundle "
                                 "write failed", self.rank)

    # ---- bundles --------------------------------------------------------
    def write_bundle(self, reason="hang"):
        """Dump this rank's evidence as one atomic JSON file: the
        collective ring, in-flight records, live thread stacks, the
        registry snapshot, the tracer's open spans, and the latest
        desync report.  Returns the bundle path."""
        from ..resilience.atomic import atomic_write

        tag = self.rank if self.rank is not None else "observer"
        path = os.path.join(
            os.fspath(self.bundle_dir),
            f"flight_bundle_rank{tag}_{len(self.bundles) + 1:03d}.json")
        rec = self.recorder
        payload = {
            "rank": self.rank,
            "reason": reason,
            "wall": self._clock(),
            "step": rec.progress()[0] if rec is not None else None,
            "desync": self.last_desync,
            "records": (rec.records(limit=self.bundle_records)
                        if rec is not None else []),
            "inflight": rec.inflight() if rec is not None else [],
            "threads": thread_stacks(),
            "metrics": self.registry().snapshot(),
            "live_spans": self.tracer().live_spans(),
            # the profiler's last high-rate capture + self-stats: where
            # the CPU went in the seconds around the anomaly
            "profile": ({"last_capture": self.profiler.last_capture(),
                         "stats": self.profiler.stats()}
                        if self.profiler is not None else None),
        }
        with atomic_write(path, "w") as f:
            f.write(json.dumps(payload, indent=1, default=str))
        self.bundles.append(path)
        self.registry().counter(
            "flight_bundles_written_total",
            "debug bundles dumped by the hang watchdog").inc()
        logger.warning("hang watchdog (rank %s): wrote debug bundle %s",
                       self.rank, path)
        return path

    def _beat_keys(self):
        return [_rank_key(f"{self.key_prefix}/hb", r)
                for r in range(self.world_size)]

    def reset(self):
        """Forget observed progress and delete every rank's heartbeat
        from the store (the supervisor calls this after it ended a
        world: the relaunched world re-baselines, and its first beats
        are the only ones read, not the dead world's last)."""
        with self._plock:
            self._seen.clear()
            self._lag_since.clear()
            for k in self._beat_keys():
                try:
                    self.store.delete_key(k)
                except (KeyError, OSError, RuntimeError):
                    pass    # silent-ok: a missing beat is what we want
            if self.hang_active:
                self.hang_active = False
                self._active_gauge().set(0)
