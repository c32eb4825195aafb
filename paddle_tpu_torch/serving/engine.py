"""Continuous-batching generation engine — unified-step scheduler (the port
of ``paddle_tpu/serving/engine.py``).

Requests enter a FIFO admission queue and ONE step function
(``gpt_ragged_step``) advances every in-flight request each step —
whether it is mid-prefill or decoding.  A prompt is split into
bounded-size *chunks* (``chunk_len`` tokens) that run as ordinary rows
of the ragged batch next to decode rows, so one long prompt never
stalls the decoding requests sharing the batch.

Per ``step()``:
  1. evict — drop every request (running or queued) past its deadline.
  2. admit — pop the queue head while a batch slot AND pages for its
     *first chunk* exist.
  3. unified step — plan the ragged batch under ``token_budget`` packed
     query tokens (every decode row gets its one token, mid-prefill rows
     split the rest fairly), write the chunk K/V into the paged pool,
     sample the first token of a prompt-completing row (TTFT) and the
     next token of each decode row.
  4. gauges — page-pool occupancy into the metrics registry.

Admission control rejects requests that can never fit (REJECTED);
watermark load shedding answers RETRY_AFTER with a drain-time hint;
deadlines evict; a sequence that outgrows the pool preempts the youngest
running request back to the queue (recomputed later, token-identical);
an exception pinned to one row fails that request only.  Prefix reuse
(``prefix_cache=True``) maps the longest cached page-aligned prompt
prefix in read-only at admission and inserts completed prompts back.
Sampling is host-side (greedy / temperature / top-k / top-p) with a
per-request numpy Generator seeded at submit.

Fleet surface, as in the JAX engine: ``add_request(trace_context=)``
continues a router's trace; ``health()``, ``decode_rate()`` and
``prefix_summary()`` are the signals the fleet router and autoscaler
poll; ``evacuate()`` pulls every in-flight request off the engine
(state ``EVACUATED``, pages freed, sampled tokens kept) for a failover
or a drain.  The fault sites ``serving.admit`` (top of ``add_request``)
and ``serving.step`` (top of ``step``, before any request state changes
and before any device work is queued; the KV pool is exposed to the
``bitflip`` kind and every in-flight token stream to
``poison_request``) fire through ``paddle_tpu_torch.resilience``.

A MoE model (``cfg.moe_experts > 0``) serves through the MoE branch of
``gpt_ragged_step``: every packed token of the ``token_budget``, the
padding slots included, is routed in packing order as the JAX step
routes it, so padding takes expert capacity there as here.

The step is the port's ``watch(jax.jit(_step))``: every step has the
same static shapes (``token_budget`` packed tokens, ``max_batch_size``
rows), so on CUDA the engine captures ``gpt_ragged_step`` once as a
``torch.cuda.CUDAGraph`` and replays it every step after that.  Each
step copies its host arrays, through one pinned buffer, into static
device buffers the graph reads, replays the graph, and reads the
logits back into one pinned buffer with one sync (JAX's
``np.asarray(logits)``); sampling stays on the host.  The first step
runs the step eagerly on a side stream (its result is that step's; the
kernel builds and the libraries set up there), then captures on that
stream; the graph's private memory pool (``graph_pool_bytes``: the
step's activations and the kernel's split scratch) stays with the
engine (the capture is ``_captured.CapturedStep``, which the training
steps share).  The capture is watched by the compile watchdog under
``serving::unified_step`` (``observability/compile_watchdog.py``): one
build per engine.  The graph holds the addresses of the parameters and
the page pool; the pool never moves (``PagedKVCache`` writes in place,
defrag included, and the ``serving.step`` fault site's tree is written
back in place), and if the parameters or the pool are ever replaced the
engine captures again, which the watchdog reports as a recompile.  A
failed capture raises: nothing falls back to the eager step.  On the
CPU (``device="cpu"``) the same static-shape step runs eagerly through
the same watched call.  The ragged kernel's launch count
(``ragged_paged_attention.launches``) gains the graph's captured calls
at every replay.

Admission runs under ``profiling_phase("admission")`` and the step under
``profiling_phase("prefill_chunk" | "decode")`` and
``RecordEvent("serving::unified_step")``, as in the JAX engine.  The
page pool is updated in place where JAX donates buffers.  Admission is
host-only: ``add_request`` never waits on the device, so a router's
wall-clock stall detection reads only real admission wedges.

``Engine(mesh=)`` serves over the mesh's mp group, one process a rank
(the JAX engine's GSPMD serving): the params follow the GPT rule table
(``distributed.mesh.shard_params``: qkv and up split by column, proj and
down by row, the embedding by vocabulary), the page pool ``[L, P + 1,
ps, H/mp, hd]`` holds this rank's heads, so each rank runs the ragged
kernel on its own heads' pages and its page writes stay local, an
all-reduce follows each row product, and the logits are all-gathered
whole on every rank (``gpt_ragged_step(mp_group=)``).  Every rank of the
group is handed the same requests and makes the same scheduling
decisions (the scheduler is deterministic in them); each step checks
that by broadcasting mp rank 0's packed inputs and raises where a rank's
differ, and every rank samples the same tokens from the same logits.  A
dp axis of the mesh replicates the engine: each dp row is an mp group
serving its own requests.  The mesh step runs eagerly (a host-side
transport cannot sit inside a CUDA graph); MoE models do not serve over
mp.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from .._captured import CapturedStep, storage_tag
from .._device import resolve_device
from ..models.gpt import GPTConfig, gpt_init, gpt_ragged_step
from ..observability.compile_watchdog import watch
from ..observability.profiling import phase as profiling_phase
from ..observability.tracing import Tracer, default_tracer
from ..profiler.profiler import RecordEvent
from ..resilience.faults import fault_point
from .kv_cache import PagedKVCache
from .metrics import ServingMetrics

__all__ = ["SamplingParams", "Request", "RequestState", "Engine"]


class RequestState:
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"      # hard: can never be served (infeasible)
    RETRY_AFTER = "retry_after"  # soft: shed under load, resubmit later
    EVICTED = "evicted"        # deadline/TTL passed before completion
    EVACUATED = "evacuated"    # pulled off a failed/draining replica; the
    #                            fleet router re-enqueues it elsewhere
    FAILED = "failed"          # a row-attributable exception: THIS request
    #                            broke, its pages are freed, the engine
    #                            (and every co-batched request) lives on


@dataclasses.dataclass
class SamplingParams:
    """temperature == 0 is greedy (argmax); top_k/top_p only apply when
    sampling.  stop_token_ids end generation (the stop token is kept in
    the output, reason "stop"); max_new_tokens caps it (reason "length").
    ttl_s bounds submit→finish wall time (reason "deadline")."""
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: tuple = ()
    ttl_s: float = None


@dataclasses.dataclass
class Request:
    id: int
    prompt: list
    sampling: SamplingParams
    state: str = RequestState.QUEUED
    tokens: list = dataclasses.field(default_factory=list)  # prompt + output
    finish_reason: str = None
    t_submit: float = 0.0
    t_admitted: float = None
    t_first_token: float = None
    t_finished: float = None
    deadline: float = None     # absolute engine-clock time, None = no TTL
    retry_after_s: float = None  # drain-estimate hint on RETRY_AFTER
    prompt_pos: int = 0        # prompt tokens already written to pages
    _chunks_done: int = 0      # prefill chunks completed (span index)
    _rng: object = None
    _span: object = None       # root trace span (one per request)
    _phase: object = None      # current lifecycle child span

    @property
    def output(self):
        return self.tokens[len(self.prompt):]

    def _reset_for_recompute(self):
        """Preemption rewinds to the prompt; the reseeded rng replays the
        same draws, so the final output equals the uninterrupted one."""
        self.tokens = list(self.prompt)
        self.prompt_pos = 0
        self._chunks_done = 0
        self.state = RequestState.QUEUED
        self._rng = np.random.default_rng(self.sampling.seed)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


class _RaggedStep(CapturedStep):
    """The engine's unified step over its static buffers,
    ``gpt_ragged_step`` captured once and replayed (logits [B, V] fp32).
    It holds no reference to its engine, so an engine dropped by its
    owner frees its pool and graph at once, without waiting for a
    garbage collection."""

    def __init__(self, cfg, max_q, device):
        super().__init__(None, device)
        self.cfg, self.max_q = cfg, max_q

    def body(self, params, k_pages, v_pages, inputs):
        tokens, rows, slots, qlens, ctxs, tables = inputs
        logits, _, _ = gpt_ragged_step(
            self.cfg, params, tokens, rows, slots, qlens, ctxs, k_pages,
            v_pages, tables, max_q=self.max_q)
        return logits.float()


def _mesh_step(cfg, max_q, group):
    """The unified step over an mp group (eager): ``gpt_ragged_step`` on
    this rank's shards and heads, the logits whole."""

    def step(params, k_pages, v_pages, inputs, storage=None):
        tokens, rows, slots, qlens, ctxs, tables = inputs
        logits, _, _ = gpt_ragged_step(
            cfg, params, tokens, rows, slots, qlens, ctxs, k_pages,
            v_pages, tables, max_q=max_q, mp_group=group)
        return logits.float()

    return step


class Engine:
    """Continuous-batching generation over a paged KV cache with a
    unified (chunked-prefill) step scheduler.

    cfg/params: the GPT model (params default to the port's ``gpt_init``
    on ``device``; given params must already live there).
    ``device``: where the pool and the step run — None means CUDA, and
    raises when CUDA is missing; pass ``device="cpu"`` for the CPU.
    page_size/num_pages size the KV pool; max_batch_size fixes the
    in-flight row count.  ``chunk_len`` bounds the prompt tokens a row
    contributes per step (``prefill_len`` is a legacy alias);
    ``token_budget`` is the packed query-token width of one step
    (default chunk_len + max_batch_size - 1).

    Robustness knobs: ``default_ttl_s`` (per-request deadline default),
    ``shed_occupancy_high/low`` and ``shed_queue_high/low`` (watermark
    load shedding; lows default to 3/4 of their high),
    ``drain_floor_s`` (cold-start floor of the drain estimate).
    ``clock`` replaces time.perf_counter; ``tracer`` overrides the
    flight recorder (default: the process-wide tracer, or a private one
    on an injected clock).  ``mesh``: a ``distributed.mesh.Mesh`` to
    serve over its mp group (the module docstring; ``params`` the full
    tree, cut to this rank's shards; the device defaults to the rank's).
    """

    #: assumed decode throughput (tok/s) until the first decode step has
    #: measured the real EWMA rate
    ASSUMED_DECODE_RATE = 100.0

    #: default cold-start floor (seconds) on the drain estimate
    DRAIN_FLOOR_S = 0.5

    def __init__(self, cfg: GPTConfig, params=None, *, page_size=16,
                 num_pages=256, max_batch_size=4, chunk_len=None,
                 token_budget=None, prefill_len=None,
                 default_ttl_s=None, shed_occupancy_high=None,
                 shed_occupancy_low=None, shed_queue_high=None,
                 shed_queue_low=None, drain_floor_s=None,
                 prefix_cache=True, clock=None, tracer=None, device=None,
                 mesh=None):
        self.cfg = cfg
        if mesh is not None and device is None:
            from ..distributed.env import current_device

            device = current_device()
        self.device = resolve_device(device)
        self._clock = clock or time.perf_counter
        if tracer is None:
            tracer = (default_tracer() if clock is None
                      else Tracer(clock=self._clock))
        self.tracer = tracer
        self._decode_rate_ewma = None     # tok/s, None until first decode
        self._ewma_alpha = 0.25
        self.default_ttl_s = default_ttl_s
        self.drain_floor_s = (self.DRAIN_FLOOR_S if drain_floor_s is None
                              else float(drain_floor_s))
        self.shed_occupancy_high = shed_occupancy_high
        self.shed_occupancy_low = (
            shed_occupancy_low if shed_occupancy_low is not None
            else (None if shed_occupancy_high is None
                  else 0.75 * shed_occupancy_high))
        self.shed_queue_high = shed_queue_high
        self.shed_queue_low = (
            shed_queue_low if shed_queue_low is not None
            else (None if shed_queue_high is None
                  else max(0, int(0.75 * shed_queue_high))))
        self._shedding = False
        self.params = (params if params is not None
                       else gpt_init(cfg, device=self.device))
        self.mesh, self._mp = mesh, None
        heads = cfg.num_heads
        if mesh is not None:
            from ..distributed import mesh as mesh_mod

            mp = mesh_mod.mesh_axis(mesh, "mp")
            if cfg.moe_experts and mp > 1:
                raise ValueError("Engine(mesh=) splits the dense FFN over "
                                 "mp: a MoE model serves at mp = 1")
            if cfg.num_heads % mp:
                raise ValueError(f"num_heads {cfg.num_heads} must divide "
                                 f"mp {mp}")
            self.params = mesh_mod.shard_params(self.params, mesh)
            heads //= mp
            if mp > 1:
                self._mp = mesh.group("mp")
        self.page_size = page_size
        self.max_batch_size = max_batch_size
        self.chunk_len = max(1, min(chunk_len or prefill_len or 64,
                                    cfg.max_seq_len))
        self.token_budget = max(
            token_budget or (self.chunk_len + max_batch_size - 1),
            max_batch_size)
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_heads=heads,
            head_dim=cfg.head_dim, num_pages=num_pages, page_size=page_size,
            max_seq_len=cfg.max_seq_len, dtype=cfg.torch_dtype(),
            device=self.device)
        self.prefix_cache = bool(prefix_cache)
        self._prefix_seen = {"hits": 0, "hit_tokens": 0, "evictions": 0}
        self.metrics = ServingMetrics()
        self._queue = deque()
        self._slots = [None] * max_batch_size
        self._just_finished = []
        self._admit_seq = 0                 # admission order, for preemption
        self._next_id = 0
        self.steps = 0                      # unified steps run
        # the step's static inputs, one int32 buffer (page tables first):
        # filled on the host, copied to the device in one transfer
        B, T = max_batch_size, self.token_budget
        M = self.cache.max_pages_per_seq
        cuda = self.device.type == "cuda"
        n = B * M + 2 * B + 3 * T
        self._in_host = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
        self._in_dev = (torch.zeros(n, dtype=torch.int32, device=self.device)
                        if cuda else self._in_host)
        cut = np.cumsum([B * M, B, B, T, T])
        tables, qlens, ctxs, tokens, rows, slots = \
            self._in_dev.tensor_split(cut.tolist())
        self._inputs = (tokens, rows, slots, qlens, ctxs, tables.view(B, M))
        self._in_views = self._in_host.numpy()
        self._in_cut = cut
        self._logits_host = (torch.empty((B, cfg.vocab_size),
                                         dtype=torch.float32,
                                         pin_memory=True) if cuda else None)
        # the watched step: one capture per engine (CUDA), the port's
        # watch(jax.jit(_step), name="serving::unified_step"); over mp
        # ranks the same step, eager
        if self._mp is None:
            step = _RaggedStep(cfg, self.chunk_len, self.device)
        else:
            step = _mesh_step(cfg, self.chunk_len, self._mp)
        self._step_fn = watch(step, name="serving::unified_step")

    @property
    def captures(self):
        """CUDA graphs this engine has captured (0 on the CPU and over mp
        ranks)."""
        return getattr(self._step_fn, "captures", 0)

    @property
    def graph_pool_bytes(self):
        """Device memory the captured graph's private pool holds: the
        step's activations and the ragged kernel's split scratch, for the
        engine's life (0 before the capture, on the CPU and over mp
        ranks)."""
        return getattr(self._step_fn, "pool_bytes", 0)

    def _storage(self):
        """The addresses a captured step reads: the parameters and the
        page pool, as a short tag (a static argument of the watched step,
        so a replaced tensor shows as a recompile)."""
        return storage_tag([*_leaves(self.params), self.cache.k_pages,
                            self.cache.v_pages])

    # ------------------------------------------------------------- submit
    def add_request(self, prompt, sampling: SamplingParams = None, *,
                    trace_context=None):
        """Queue a prompt (list of token ids).  Returns the Request;
        state is REJECTED immediately when it can never be served, and
        a shed request carries ``retry_after_s``.  ``trace_context`` (a
        ``TraceContext`` or its dict form) continues a caller's trace:
        the router hands its dispatch span's context over, so the
        request's engine lifecycle records under the fleet trace."""
        # fault site: a stall here is an admission wedge, an io_error the
        # transport refusing the request; the fleet router detects both
        fault_point("serving.admit")
        sampling = sampling or SamplingParams()
        req = Request(id=self._next_id, prompt=list(prompt),
                      sampling=sampling, t_submit=self._clock())
        self._next_id += 1
        req.tokens = list(req.prompt)
        req._rng = np.random.default_rng(sampling.seed)
        ttl = sampling.ttl_s if sampling.ttl_s is not None \
            else self.default_ttl_s
        if ttl is not None:
            req.deadline = req.t_submit + float(ttl)
        self.metrics.requests_submitted.inc()
        req._span = self.tracer.start_trace(
            f"request#{req.id}", start_s=req.t_submit,
            attributes={"request_id": req.id,
                        "prompt_len": len(req.prompt),
                        "max_new_tokens": sampling.max_new_tokens},
            context=trace_context)

        total = len(req.prompt) + sampling.max_new_tokens
        reason = None
        if not req.prompt:
            reason = "empty prompt"
        elif total > self.cfg.max_seq_len:
            reason = (f"prompt + max_new_tokens = {total} exceeds "
                      f"max_seq_len {self.cfg.max_seq_len}")
        elif self.cache.pages_for(total) > self.cache.num_pages:
            reason = (f"{total} tokens need "
                      f"{self.cache.pages_for(total)} pages; the pool has "
                      f"{self.cache.num_pages} — page pool exhausted")
        if reason is not None:
            req.state = RequestState.REJECTED
            req.finish_reason = reason
            self.metrics.requests_rejected.inc()
            self._end_trace(req)
            return req
        if self._update_shedding():
            req.state = RequestState.RETRY_AFTER
            req.retry_after_s = self._retry_after()
            req.finish_reason = (
                f"load shed: occupancy {self.cache.occupancy():.2f}, "
                f"queue depth {len(self._queue)} — retry in "
                f"{req.retry_after_s:.3f}s")
            self.metrics.requests_shed.inc()
            self.metrics.estimated_drain_s.set(req.retry_after_s)
            self._end_trace(req)
            return req
        self._queue.append(req)
        req._phase = self.tracer.start_span("queued", req._span,
                                            start_s=req.t_submit)
        self.metrics.queue_depth.set(len(self._queue))
        self._update_shedding()
        return req

    # ----------------------------------------------------- flight recorder
    def _end_phase(self, req, end_s=None, **attrs):
        if req._phase is not None:
            req._phase.set_attributes(attrs)
            req._phase.end(end_s)
            req._phase = None

    def _end_trace(self, req, end_s=None):
        """Close the open phase and the request root, stamping the final
        state / reason / output size and the pool occupancy."""
        self._end_phase(req, end_s)
        req._span.set_attributes({
            "state": req.state, "finish_reason": req.finish_reason,
            "tokens_out": len(req.output),
            "page_occupancy": round(self.cache.occupancy(), 4)})
        if req.retry_after_s is not None:
            req._span.set_attribute("retry_after_s", req.retry_after_s)
        req._span.end(end_s)

    # ------------------------------------------------------ drain estimate
    def pending_decode_tokens(self):
        owed = sum(r.sampling.max_new_tokens - len(r.output)
                   for r in self._queue)
        owed += sum(max(0, r.sampling.max_new_tokens - len(r.output))
                    for r in self._running())
        return owed

    def decode_rate(self):
        """EWMA decode throughput in tok/s (None before the first
        decode step)."""
        return self._decode_rate_ewma

    def estimated_drain_s(self):
        """Seconds to decode the current backlog at the measured rate;
        never below ``drain_floor_s`` before the first measurement."""
        tokens = self.pending_decode_tokens()
        if self._decode_rate_ewma is None:
            assumed = tokens / self.ASSUMED_DECODE_RATE
            return max(assumed, self.drain_floor_s)
        if tokens <= 0:
            return 0.0
        return tokens / max(self._decode_rate_ewma, 1e-9)

    def _retry_after(self):
        rate = self._decode_rate_ewma or self.ASSUMED_DECODE_RATE
        return max(self.estimated_drain_s(), 1.0 / max(rate, 1e-9))

    # ----------------------------------------------------- load shedding
    def _update_shedding(self):
        """High/low-watermark hysteresis over occupancy and queue depth;
        returns the current shedding state."""
        occ, q = self.cache.occupancy(), len(self._queue)
        high = ((self.shed_occupancy_high is not None
                 and occ >= self.shed_occupancy_high)
                or (self.shed_queue_high is not None
                    and q >= self.shed_queue_high))
        low = ((self.shed_occupancy_low is None
                or occ <= self.shed_occupancy_low)
               and (self.shed_queue_low is None
                    or q <= self.shed_queue_low))
        if not self._shedding and high:
            self._shedding = True
        elif self._shedding and low and not high:
            self._shedding = False
        self.metrics.engine_healthy.set(0 if self._shedding else 1)
        return self._shedding

    # -------------------------------------------------- deadline eviction
    def _evict(self, req, now):
        if req in self._slots:
            self.cache.free(req.id)
            self._slots[self._slots.index(req)] = None
        req.state = RequestState.EVICTED
        req.finish_reason = "deadline"
        req.t_finished = now
        self.metrics.deadline_evictions.inc()
        self._end_trace(req, end_s=now)
        self._just_finished.append(req)

    def _fail(self, req, exc):
        """Per-row failure isolation: the row retires FAILED with its
        pages freed; every co-batched request keeps running."""
        if req in self._slots:
            self.cache.free(req.id)
            self._slots[self._slots.index(req)] = None
        req.state = RequestState.FAILED
        req.finish_reason = f"row failure: {exc!r}"
        req.t_finished = self._clock()
        self.metrics.requests_failed.inc()
        req._span.set_attribute("error", repr(exc))
        self._end_trace(req, end_s=req.t_finished)
        self._just_finished.append(req)

    def _evict_expired(self):
        now = self._clock()
        for req in self._running():
            if req.deadline is not None and now > req.deadline:
                self._evict(req, now)
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        for req in expired:
            self._queue.remove(req)
            self._evict(req, now)

    # -------------------------------------------------------------- admit
    def _free_slot(self):
        for i, r in enumerate(self._slots):
            if r is None:
                return i
        return None

    def _try_admit(self):
        with profiling_phase("admission"):
            self._try_admit_inner()

    def _try_admit_inner(self):
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._queue[0]
            # pages for the FIRST chunk only; with the prefix cache on,
            # the longest cached prefix is mapped in read-only here
            if self.prefix_cache:
                matched = self.cache.allocate_prefixed(
                    req.id, req.prompt, self.chunk_len)
                if matched is None:
                    return                   # FIFO: no queue-jumping
            else:
                matched = 0
                first = min(self.chunk_len, len(req.prompt))
                if not self.cache.allocate(req.id, first):
                    return                   # FIFO: no queue-jumping
            req.prompt_pos = matched
            self._queue.popleft()
            now = self._clock()
            req.state = RequestState.RUNNING
            req.t_admitted = now
            req._admit_seq = self._admit_seq
            self._admit_seq += 1
            self._slots[slot] = req
            self.metrics.requests_admitted.inc()
            self.metrics.queue_wait.observe(now - req.t_submit)
            self._end_phase(req, end_s=now)      # queued → admitted
            req._span.set_attributes({
                "batch_slot": slot, "prefix_hit_tokens": matched,
                "occupancy_at_admit": round(self.cache.occupancy(), 4)})

    # -------------------------------------------------------- unified step
    def _running(self):
        return [r for r in self._slots if r is not None]

    def _preempt(self, req):
        """Free req's pages and push it back to the queue head for
        recompute (memory pressure, never an error)."""
        self.cache.free(req.id)
        self._slots[self._slots.index(req)] = None
        req._reset_for_recompute()
        self._queue.appendleft(req)
        self.metrics.requests_preempted.inc()
        self._end_phase(req, preempted=True)
        req._span.attributes["preemptions"] = \
            req._span.attributes.get("preemptions", 0) + 1
        req._phase = self.tracer.start_span("queued", req._span)

    def _plan_rows(self):
        """{batch slot: query tokens this step} under token_budget:
        decode rows get their one token, mid-prefill rows then split the
        remaining budget fairly (ceil-share, admission order)."""
        plan = {}
        budget = self.token_budget
        chunkers = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.prompt_pos >= len(req.prompt):
                plan[i] = 1
                budget -= 1
            else:
                chunkers.append(i)
        chunkers.sort(key=lambda i: self._slots[i]._admit_seq)
        for n, i in enumerate(chunkers):
            if budget <= 0:
                break
            req = self._slots[i]
            fair = -(-budget // (len(chunkers) - n))          # ceil share
            q = min(self.chunk_len, len(req.prompt) - req.prompt_pos,
                    fair)
            if q > 0:
                plan[i] = q
                budget -= q
        return plan

    def _ensure_capacity(self):
        """Pages for every planned row's post-step context; preempt
        youngest-first when the pool runs dry.  Returns the final plan."""
        while True:
            plan = self._plan_rows()
            stable = True
            for i in sorted(plan, key=lambda i: self._slots[i]._admit_seq
                            if self._slots[i] is not None else 0):
                req = self._slots[i]
                if req is None:
                    continue                 # preempted earlier this pass
                if req.prompt_pos < len(req.prompt):
                    target = req.prompt_pos + plan[i]
                else:
                    target = len(req.tokens)
                while req in self._slots and \
                        not self.cache.extend(req.id, target):
                    victim = max(self._running(),
                                 key=lambda r: r._admit_seq)
                    self._preempt(victim)
                    stable = False
                    if victim is req:
                        break
            if stable:
                return plan

    def _run_step(self, tokens, rows, slots, qlens, ctxs, tables):
        """The one step over the device: the host arrays into the static
        input buffer (one pinned host-to-device copy), the watched step
        (the graph's replay on CUDA; pages written in place), the logits
        into the pinned host buffer with one sync.  Returns the logits
        [B, V] fp32 as numpy, valid until the next step."""
        parts = np.split(self._in_views, self._in_cut)
        for dst, src in zip(parts, (tables.reshape(-1), qlens, ctxs, tokens,
                                    rows, slots)):
            dst[:] = src
        if self._mp is not None:
            self._same_plan()
        kw = {}
        if self._logits_host is not None:
            self._in_dev.copy_(self._in_host, non_blocking=True)
            kw["storage"] = self._storage()
        logits = self._step_fn(self.params, self.cache.k_pages,
                               self.cache.v_pages, self._inputs, **kw)
        self.steps += 1
        if self._logits_host is None:
            return logits.numpy()
        self._logits_host.copy_(logits, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._logits_host.numpy()

    def _same_plan(self):
        """Raise unless every mp rank packed the same step: mp rank 0's
        inputs broadcast and compared with this rank's."""
        from ..distributed import collective

        ref = self._in_host.clone()
        collective.broadcast(ref, src=0, group=self._mp)
        if not torch.equal(ref, self._in_host):
            raise RuntimeError(
                f"mp rank {self._mp.rank} planned another step than mp "
                f"rank 0: the ranks of Engine(mesh=) must be handed the "
                f"same requests in the same order")

    def _unified_step_once(self, plan):
        """Run the step over the planned ragged batch and fold the
        results back into each request's lifecycle."""
        if not plan:
            return
        B, T = self.max_batch_size, self.token_budget
        tokens = np.zeros((T,), np.int32)
        rows = np.full((T,), B, np.int32)        # B marks padding slots
        slots = np.zeros((T,), np.int32)
        qlens = np.zeros((B,), np.int32)
        ctxs = np.zeros((B,), np.int32)
        tables = np.zeros((B, self.cache.max_pages_per_seq), np.int32)
        sched = []                               # (slot, req, q, new ctx)
        off = 0
        for i in range(B):                       # packing is row-major
            req = self._slots[i]
            q = plan.get(i, 0)
            if req is None or q <= 0:
                continue
            try:
                if req.prompt_pos < len(req.prompt):
                    chunk = req.prompt[req.prompt_pos:req.prompt_pos + q]
                    ctx = req.prompt_pos + q
                else:
                    chunk = req.tokens[-1:]
                    ctx = len(req.tokens)
                table = self.cache.page_table(req.id)
            except Exception as e:
                # row-attributable plan failure: THIS row dies, the
                # batch (arrays untouched for it) runs without it
                self._fail(req, e)
                continue
            tokens[off:off + q] = chunk
            rows[off:off + q] = i
            slots[off:off + q] = np.arange(q)
            qlens[i], ctxs[i] = q, ctx
            tables[i] = table
            sched.append((i, req, q, ctx))
            off += q
        if not sched:
            return
        # phase attribution for the sampling profiler: a step with any
        # mid-prefill row is a prefill chunk, else pure decode
        step_phase = "prefill_chunk" if any(
            req.prompt_pos < len(req.prompt)
            for _, req, _, _ in sched) else "decode"
        t0 = self._clock()
        with profiling_phase(step_phase), \
                RecordEvent("serving::unified_step"):
            logits = self._run_step(tokens, rows, slots, qlens, ctxs,
                                    tables)
        t1 = self._clock()
        dt = t1 - t0
        occ = round(self.cache.occupancy(), 4)
        n_rows = len(sched)
        sampled = 0
        for i, req, q, ctx in sched:
            # per-row commit isolation: what this row's sampling or
            # bookkeeping raises is ITS failure
            try:
                mid_prefill = req.prompt_pos < len(req.prompt)
                if mid_prefill:
                    req.prompt_pos = ctx
                    self.metrics.prefill_tokens.inc(q)
                    self.metrics.prefill_chunks.inc()
                    self.tracer.start_span(
                        f"chunk[{req._chunks_done}]", req._span,
                        start_s=t0,
                        attributes={"tokens": q, "prefilled": ctx,
                                    "batch_slot": i, "batch_size": n_rows,
                                    "page_occupancy": occ}).end(t1)
                    req._chunks_done += 1
                    if ctx < len(req.prompt):
                        continue             # more chunks to go
                    # prompt complete: its FULL pages become reusable K/V
                    if self.prefix_cache:
                        self.cache.insert_prefix(req.id, req.prompt)
                tok = self._sample_token(logits[i], req)
                req.tokens.append(tok)
                sampled += 1
                self.metrics.tokens_generated.inc()
                if req.t_first_token is None:
                    req.t_first_token = t1
                    self.metrics.ttft.observe(
                        t1 - req.t_submit,
                        exemplar=req._span.trace_id)
                if not mid_prefill:
                    self.metrics.decode_token.observe(dt / n_rows)
                    self.tracer.start_span(
                        f"decode[{len(req.output) - 1}]", req._span,
                        start_s=t0,
                        attributes={"batch_slot": i, "batch_size": n_rows,
                                    "page_occupancy": occ}).end(t1)
                self._maybe_finish(req)
            except Exception as e:
                self._fail(req, e)
        if dt > 0 and sampled:
            inst = sampled / dt
            a = self._ewma_alpha
            self._decode_rate_ewma = (
                inst if self._decode_rate_ewma is None
                else a * inst + (1 - a) * self._decode_rate_ewma)

    # ------------------------------------------------------------ sampling
    def _sample_token(self, logits_row, req):
        sp = req.sampling
        logits = np.asarray(logits_row, np.float64)
        if sp.temperature <= 0.0:
            return int(np.argmax(logits))
        logits = logits / sp.temperature
        if sp.top_k and sp.top_k < logits.size:
            kth = np.partition(logits, -sp.top_k)[-sp.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        probs = np.exp(logits - np.max(logits))
        probs = probs / probs.sum()
        if sp.top_p < 1.0:
            order = np.argsort(-probs)
            cum = np.cumsum(probs[order])
            cut = int(np.searchsorted(cum, sp.top_p)) + 1
            mask = np.zeros_like(probs)
            mask[order[:cut]] = 1.0
            probs = probs * mask
            probs = probs / probs.sum()
        return int(req._rng.choice(probs.size, p=probs))

    # ------------------------------------------------------------- finish
    def _maybe_finish(self, req):
        sp = req.sampling
        reason = None
        if req.tokens[-1] in sp.stop_token_ids:
            reason = "stop"
        elif len(req.output) >= sp.max_new_tokens:
            reason = "length"
        elif len(req.tokens) >= self.cfg.max_seq_len:
            reason = "length"
        if reason is None:
            return
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.t_finished = self._clock()
        self.cache.free(req.id)
        if req in self._slots:
            self._slots[self._slots.index(req)] = None
        self.metrics.requests_finished.inc()
        self._end_trace(req, end_s=req.t_finished)
        self._just_finished.append(req)

    # --------------------------------------------------------------- drive
    def has_work(self):
        return bool(self._queue) or any(r is not None for r in self._slots)

    def step(self):
        """One scheduler iteration: evict past-deadline requests, admit,
        run the unified ragged step, update gauges.  Returns requests
        that finished (or were evicted) this step."""
        # fault site: an io_error here is the whole step failing the way
        # a crashed replica's RPC would — before any request state
        # changes and before any device work is queued, so a router can
        # re-dispatch losslessly.  tree= exposes the KV pool to bitflip
        # (flipped in place on its device), tokens= every in-flight
        # stream to poison_request.  A kind that hands a new tensor back
        # is written into the pool in place: the captured step reads the
        # pool's storage
        kv = {"k_pages": self.cache.k_pages, "v_pages": self.cache.v_pages}
        fault_point("serving.step", tree=kv,
                    tokens=[r.tokens for r in self._running()]
                    + [r.tokens for r in self._queue])
        for name in kv:
            pool = getattr(self.cache, name)
            if kv[name] is not pool:
                pool.copy_(kv[name])
        self._evict_expired()
        self._try_admit()
        self._unified_step_once(self._ensure_capacity())
        self._update_shedding()
        self.metrics.page_occupancy.set(self.cache.occupancy())
        self.metrics.queue_depth.set(len(self._queue))
        self.metrics.estimated_drain_s.set(self.estimated_drain_s())
        self._sync_prefix_metrics()
        done, self._just_finished = self._just_finished, []
        return done

    def _sync_prefix_metrics(self):
        """Fold the cache's monotonic prefix counters into the
        serving_prefix_* series (delta sync)."""
        stats = self.cache.prefix_stats()
        m = self.metrics
        for key, counter in (("hits", m.prefix_cache_hits),
                             ("hit_tokens", m.prefix_hit_tokens),
                             ("evictions", m.prefix_cache_evictions)):
            delta = stats[key] - self._prefix_seen[key]
            if delta:
                counter.inc(delta)
                self._prefix_seen[key] = stats[key]
        m.prefix_cache_pages.set(stats["cached_pages"])

    def prefix_summary(self, max_entries=32):
        """Bounded radix-tree summary for cache-aware routing (root
        hashes + hit stats); see ``PagedKVCache.prefix_summary``."""
        out = self.cache.prefix_summary(max_entries=max_entries)
        out["enabled"] = self.prefix_cache
        return out

    def evacuate(self):
        """Pull EVERY in-flight request off this engine — running
        (mid-prefill or decoding) and queued — free their pages, and
        return them with their sampled tokens intact, in admission
        order (running first, then the queue).

        The fleet router's failover/drain primitive: the caller
        re-enqueues each request elsewhere as an ordinary admission
        (prompt + already-sampled tokens), so this engine's KV pool is
        never trusted again.  Each request leaves in state ``EVACUATED``
        with its trace closed; it holds tokens and spans, no tensor."""
        now = self._clock()
        running = sorted(self._running(), key=lambda r: r._admit_seq)
        for req in running:
            self.cache.free(req.id)
            self._slots[self._slots.index(req)] = None
        queued = list(self._queue)
        self._queue.clear()
        out = running + queued
        for req in out:
            req.state = RequestState.EVACUATED
            req.finish_reason = "evacuated"
            self._end_trace(req, end_s=now)
        self.metrics.queue_depth.set(0)
        self.metrics.page_occupancy.set(self.cache.occupancy())
        return out

    def health(self):
        """Live scheduler health: shedding flag, queue depth, in-flight
        batch, pool occupancy, and the drain estimate a cooperating
        front-end should back off by.  Host bookkeeping only."""
        return {"healthy": not self._shedding,
                "queue_depth": len(self._queue),
                "running": len(self._running()),
                "page_occupancy": self.cache.occupancy(),
                "estimated_drain_s": self.estimated_drain_s(),
                "decode_rate_tok_s": self._decode_rate_ewma,
                "prefix_cache": {"enabled": self.prefix_cache,
                                 **self.cache.prefix_stats()}}

    def generate(self, prompts, sampling=None):
        """Submit all prompts, drive the scheduler to completion, return
        each request's generated tokens (submit order; rejected requests
        yield [])."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        reqs = [self.add_request(p, s) for p, s in zip(prompts, sampling)]
        while self.has_work():
            self.step()
        return [r.output for r in reqs]

    def warmup(self, prompt_len=4, max_new_tokens=2):
        """Run one tiny request end to end (first-use kernel build, CUDA
        context and allocator warm-up happen now, not on the first real
        request), then reset the decode-rate EWMA its steps polluted."""
        n = max(1, min(int(prompt_len), self.cfg.max_seq_len // 2))
        prompt = list(range(1, n + 1))
        self.generate([prompt],
                      SamplingParams(max_new_tokens=int(max_new_tokens)))
        self._decode_rate_ewma = None
        return self
