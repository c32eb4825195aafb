"""The training engine (the port of ``paddle_tpu/distributed/engine.py``):
one GPU, or a world of ranks, one process a rank.

``HybridEngine(cfg).step`` is the JAX package's ``_step_local``,
written eagerly:

  tokens [B, S] → embedding → blocks in a Python loop, each under the
  ``cfg.remat`` checkpoint policy → final LN + tied-vocab CE in
  sequence chunks (+ ``moe_aux_weight`` × the per-layer mean MoE aux
  loss for a MoE model) → grads (``torch.autograd.grad``), accumulated
  in fp32 over ``accum_steps`` micro-batches → global-norm clip → Adam
  with bias correction and decoupled weight decay, in windows of at most
  ``opt_update_window`` elements, in place.

**One GPU** (every axis 1, or ``sep > 1`` with ``cfg.seq_parallel ==
"ring"`` in one process).  The ring runs every sep rank's shard on the
one device: each block's attention is ``ring_attention`` over ``sep``
contiguous shards, dropout draws its mask per shard with the shard index
folded into the seed, and a MoE block gates each shard on its own
(capacity from the shard's tokens, aux loss averaged over the shards),
as the JAX engine's sep ranks do.  The step is the port's
``watch(jax.jit(step), name="hybrid_engine::step")``: on CUDA the body
runs eagerly on the first call (a real step), is captured then as one
CUDA graph (``_captured.CapturedStep``) and replayed on every later
call, under ``RecordEvent("hybrid_engine::step")``.  What the graph
reads lives at fixed addresses: the params and the slots (written in
place), ``tokens``/``labels`` (copied into static device buffers through
pinned host buffers), and three 0-d device scalars written before each
call — the learning rate (fp32), the step (fp32, filled from the Python
int ``opt_state["step"]`` + 1; Adam's bias corrections are computed from
it on the device) and the dropout key (int64: ``dropout_seed`` folded
with the step; every further fold and each mask is computed on the
device from it, ``models/gpt.py``).  Passing other params or state
tensors, or a batch of another shape, captures again, which the compile
watchdog reports as a rebuild; a failed capture raises.

**A world of ranks** (``init_parallel_env`` first; the grid ``dp·pp·
sharding·sep·ep·mp`` laid over the world's first ranks or ``ranks=``,
``topology.HybridCommunicateGroup``).  Every rank passes the GLOBAL
batch and takes its rows (over ``("dp", "sharding", "ep")``) and its
sequence slice (over ``sep``), as the JAX ``batch_spec`` does.  Params
are this rank's shards by ``param_specs`` (``init``, ``shard_params``;
``gather_params`` puts the full tree together on every rank):

- mp: the vocab-split embedding and CE, and Megatron's column/row split
  of each block with two all-reduces a block (``mp_layers``);
- sep: Ulysses all-to-alls around flash attention, or the ring across
  ranks (``ring_attention`` over the sep group: K/V and, backward, their
  dK/dV sums pass to the next rank);
- ep: each rank holds E/ep experts; a balanced all-to-all takes the
  tokens to their experts' owners and back (``moe.moe_layer``);
- dp and ZeRO-2 ``sharding``: the loss is this rank's share of the
  global mean, gradients are summed over the axes their param is
  replicated on (a reduce-scatter over ``sharding`` into this rank's
  flat chunk of each leaf, then an all-reduce over dp, sep and — for a
  leaf not split over ep — ep), the global-norm clip sums each disjoint
  shard once (an mp-replicated leaf is not summed over mp), Adam
  updates the rank's chunk and the params are all-gathered over
  ``sharding``;
- pp: each pp rank holds ``L/pp`` layers (the stacked layer axis split
  over "pp") and runs its stage of the pipeline; activations ``[mb, s,
  D]`` pass rank to rank over the pp group (``collective`` point-to-point,
  one ``batch_isend_irecv`` a tick, posted only where the schedule says
  the sender is live).  ``pipeline_schedule="gpipe"`` runs every
  microbatch forward (``num_microbatches + pp - 1`` ticks; stage 0 embeds
  the whole batch once) and then backward in reverse, autograd through
  each stage's saved graph: activation memory grows with the
  microbatches.  ``"1f1b"`` (tied dense models; MoE and untied heads take
  GPipe, as ``_use_1f1b`` says) runs the static tick grid of
  ``_1f1b_schedule``: a forward tick runs the stage without a graph and
  keeps its input in a ring of at most ``pp - i`` entries, a backward tick
  runs it again from the saved input and backpropagates the arrived
  cotangent; the last stage's forward and backward of a microbatch share
  one tick.  The CE denominator is summed over the data group before the
  loop, so the head's seed is ``1/denom``.  Tied and replicated leaves
  (``wte`` on the first and last stage, ``wpe``, the final norm) have
  their gradients summed over pp;
- ZeRO-3 (``zero_stage >= 3`` at sharding > 1): each matrix leaf is
  held as this rank's ``1/zr`` slice of its free dimension (the JAX
  specs' ``z``); a block gathers its leaves just in time inside its
  recompute (``_ZeroGather``: all-gather forward, reduce-scatter of the
  gradient backward), so the backward gathers again instead of keeping
  whole weights; Adam updates the slice and nothing is gathered after
  the step.  Small vectors stay replicated and ZeRO-2-chunked.

The dropout key is folded with the dp, sharding, ep and sep coordinates
and never with mp or pp (a block folds its global layer index; in a
pipeline the microbatch index is folded first).  The step runs eagerly (a
host-side transport cannot sit inside a CUDA graph), under the same
watched name.  Optimizer slots are param-shaped (the JAX engine's
canonical, topology-neutral form) except for the leaves chunked over
``sharding`` (ZeRO-2, and the replicated vectors at ZeRO-3), where each
rank keeps the flat chunk it updates.  ``shard_views`` and
``state_windows`` name each local tensor's window of the global array:
what ``checkpoint.save_sharded`` writes (each window once) and what
``integrity.shard_fingerprint`` digests.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch
from torch.profiler import record_function

from .._captured import CapturedStep, StaticInputs, storage_tag
from .._device import resolve_device
from ..models.gpt import (_default_attention, _dropout, _fold, _flat_items,
                          run_blocks)
from ..observability.compile_watchdog import watch
from ..observability.flight import default_flight_recorder
from ..optimizer.optimizer import bias_correction, device_scalar
from ..profiler.profiler import RecordEvent
from . import collective
from . import mesh as _mesh
from .env import current_device, get_rank, get_world_size
from .mesh import _names, local_shard
from .model_adapter import GPTAdapter, ModelAdapter
from .topology import HybridCommunicateGroup

__all__ = ["HybridEngine", "EngineConfig"]

#: the six axes of the grid, in the JAX mesh's order
ALL_AXES = ("dp", "pp", "sharding", "sep", "ep", "mp")

#: the axes that split the batch, in the JAX ``batch_spec``'s order
DATA_AXES = ("dp", "sharding", "ep")
#: every axis that holds other tokens: the loss is summed over them
_LOSS_AXES = ("dp", "sharding", "sep", "ep")


def _1f1b_schedule(pp, num_micro):
    """The static 1F1B tick grid (the JAX engine's, copied): ``(fwd,
    bwd)``, int32 arrays ``[T, pp]`` where ``fwd[t, i]`` is the
    microbatch stage i runs forward at tick t (-1 = idle), and the same
    for the backward.  Stage i never holds more than ``pp - i``
    microbatches in flight; a dependency is met in a strictly earlier
    tick, except the last stage, whose backward takes its own same-tick
    forward (forward runs before backward inside a tick)."""
    M = num_micro
    fwd_done = [[False] * M for _ in range(pp)]
    bwd_done = [[False] * M for _ in range(pp)]
    fwd_next = [0] * pp
    bwd_next = [0] * pp
    fwd_rows, bwd_rows = [], []
    for _ in range(4 * (M + pp) + 8):
        if all(b >= M for b in bwd_next):
            break
        fwd_t = [-1] * pp
        bwd_t = [-1] * pp
        for i in range(pp):
            m = fwd_next[i]
            if m < M and (m - bwd_next[i]) < (pp - i) and \
                    (i == 0 or fwd_done[i - 1][m]):
                fwd_t[i] = m
        for i in range(pp):
            m = bwd_next[i]
            if m < M:
                if i == pp - 1:
                    ok = fwd_done[i][m] or fwd_t[i] == m
                else:
                    ok = bwd_done[i + 1][m]
                if ok:
                    bwd_t[i] = m
        for i in range(pp):
            if fwd_t[i] >= 0:
                fwd_done[i][fwd_t[i]] = True
                fwd_next[i] += 1
            if bwd_t[i] >= 0:
                bwd_done[i][bwd_t[i]] = True
                bwd_next[i] += 1
        fwd_rows.append(fwd_t)
        bwd_rows.append(bwd_t)
    else:  # pragma: no cover
        raise AssertionError(f"1f1b schedule did not converge pp={pp} M={M}")
    fwd = np.asarray(fwd_rows, np.int32)
    bwd = np.asarray(bwd_rows, np.int32)
    _check_mailboxes(pp, fwd, bwd)
    return fwd, bwd


def _check_mailboxes(pp, fwd, bwd):
    """Each stage has ONE sticky mailbox per direction (a message sent at
    tick t is held from t+1 until the sender sends again).  Assert the
    schedule never needs more: a second send must not arrive before the
    first was consumed."""
    T = fwd.shape[0]
    for arr, src_of, dst_of in ((fwd, lambda i: i - 1, lambda i: i + 1),
                                (bwd, lambda i: i + 1, lambda i: i - 1)):
        for i in range(pp):
            j = dst_of(i)
            if not (0 <= j < pp):
                continue
            pending = None   # micro sent by i, not yet consumed by j
            for t in range(T):
                if pending is not None and arr[t][j] == pending[0] \
                        and t > pending[1]:
                    pending = None
                if arr[t][i] >= 0:
                    assert pending is None, (
                        f"mailbox overflow: stage {i} sends micro "
                        f"{arr[t][i]} at tick {t} before stage {j} "
                        f"consumed micro {pending[0]}")
                    pending = (arr[t][i], t)


def pp_hop(group, sends, recvs, device):
    """One tick's point-to-point messages on the pp ``group``: ``sends``
    ``[(tensor, member)]``, ``recvs`` ``[(shape, dtype, member)]``;
    returns the received tensors.  Both directions go in one batch, in
    one order on every rank."""
    outs = [torch.empty(shape, dtype=dt, device=device)
            for shape, dt, _ in recvs]
    ops = [("send", t.detach().contiguous(), j, f"s{j}") for t, j in sends]
    ops += [("recv", o, j, f"r{j}") for o, (_, _, j) in zip(outs, recvs)]
    if ops:
        with default_flight_recorder().record(
                "pipeline_p2p", group, [t for t, _ in sends]):
            collective._p2p(ops, group, [t for t, _ in sends], outs,
                            "pipeline_p2p")
    return outs


def gpipe(group, stage, pp, num_micro, forward, backward, in_meta,
          out_meta, device):
    """The GPipe fill-drain of one stage over the pp ``group``: ``M +
    pp - 1`` forward ticks (stage i holds microbatch ``t - i`` at tick
    t), then the same ticks in reverse for the backward.
    ``forward(m, x)`` runs microbatch m on the activation ``x`` received
    from the stage before (None on stage 0) and returns ``(saved, y)``,
    ``y`` sent to the next stage; ``backward(m, saved, ct)`` takes the
    cotangent ``ct`` received from the next stage (None on the last) and
    returns the input's gradient, sent to the stage before.  ``in_meta``
    / ``out_meta``: ``(shape, dtype)`` of the activation entering and
    leaving this stage.  Returns the most microbatches held at once."""
    M, i = num_micro, stage
    first, last = i == 0, i == pp - 1
    saved, inbox, peak = {}, None, 0
    for t in range(M + pp - 1):
        m = t - i
        y = None
        if 0 <= m < M:
            saved[m], y = forward(m, inbox)
            peak = max(peak, len(saved))
        sends = [(y, i + 1)] if (y is not None and not last) else []
        recvs = ([tuple(in_meta) + (i - 1,)]
                 if not first and 0 <= t - (i - 1) < M else [])
        got = pp_hop(group, sends, recvs, device)
        if got:
            inbox = got[0]
    ct = None
    for t in reversed(range(M + pp - 1)):
        m = t - i
        dx = None
        if 0 <= m < M:
            dx = backward(m, saved.pop(m), ct)
        sends = [(dx, i - 1)] if (dx is not None and not first) else []
        recvs = ([tuple(out_meta) + (i + 1,)]
                 if not last and 0 <= t - (i + 1) < M else [])
        got = pp_hop(group, sends, recvs, device)
        if got:
            ct = got[0]
    return peak


class _ZeroGather(torch.autograd.Function):
    """ZeRO-3's just-in-time gather of one leaf: all-gather of the
    sharding group's slices along ``dim`` forward; backward, the
    gradient reduce-scattered back (summed over the group, this rank's
    slice kept)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return collective.all_gather(x.contiguous(), group=group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


def _scatter_sum(g, group, dim):
    """This rank's slice along ``dim`` of the group's sum of ``g``."""
    red = collective.reduce_scatter(g.movedim(dim, 0).contiguous(),
                                    group=group)
    return red.movedim(0, dim).contiguous()


@dataclasses.dataclass
class EngineConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    num_microbatches: int = 1       # pipeline microbatches (must be >= pp)
    # ZeRO stage over the "sharding" axis (multi-GPU slice; inert at
    # sharding == 1, kept so configs carry over)
    zero_stage: int = 2
    # gradient accumulation (reference: gradient_merge_optimizer): split
    #   the batch into accum_steps micro-batches, run fwd/bwd per chunk,
    #   average the fp32 grads, then apply ONE optimizer step
    accum_steps: int = 1
    # optimizer slot dtype: "float32" keeps a full-precision master +
    # moments (the reference Adam's multi_precision=True); "bfloat16"
    # stores master/m/v in bf16 (multi_precision=False parity) — update
    # math still runs in fp32
    opt_dtype: str = "float32"
    # keep a separate master-weight slot (the reference Adam's
    # multi_precision).  None = auto: a master is stored only when
    # opt_dtype differs from the model dtype — when they match, the param
    # IS the master bit-for-bit and a second copy buys nothing
    master_weights: bool = None
    # fp32 working-set bound (in elements) for the optimizer update:
    # leaves larger than this update window by window, in place, so the
    # fp32 temporaries stay O(window) instead of O(largest leaf)
    opt_update_window: int = 1 << 27
    # fp32 logits-block budget (elements) for the tied-vocab CE head:
    # above it the head runs in sequence chunks, each under a
    # checkpoint, so the [b, s, V] fp32 logits never fully materialize
    ce_block_elems: int = 1 << 29
    # pipeline schedule (multi-GPU slice; inert at pp == 1)
    pipeline_schedule: str = "1f1b"

    def __post_init__(self):
        if self.opt_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"opt_dtype must be 'float32' or 'bfloat16', got "
                f"{self.opt_dtype!r}")
        if self.pipeline_schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"pipeline_schedule must be '1f1b' or 'gpipe', got "
                f"{self.pipeline_schedule!r}")


class HybridEngine:
    def __init__(self, cfg, dp=1, pp=1, sharding=1, sep=1, mp=1, ep=1,
                 engine_cfg: EngineConfig = None, device=None, ranks=None):
        """``cfg``: a model config (GPTConfig trains through GPTAdapter)
        or a ``ModelAdapter`` (``BertAdapter(BertConfig)`` for BERT).
        Entry point: runs on CUDA unless ``device`` says otherwise (in a
        world, on the rank's device of ``init_parallel_env``).  A grid of
        more than one rank needs the world; ``sep > 1`` with
        ``cfg.seq_parallel == "ring"`` alone trains on this one device
        when there is none."""
        self.model = cfg if isinstance(cfg, ModelAdapter) else GPTAdapter(cfg)
        self.cfg = self.model.cfg
        if self.cfg.seq_parallel not in ("ulysses", "ring"):
            raise ValueError(
                f"unknown seq_parallel {self.cfg.seq_parallel!r}")
        self.dp, self.pp, self.zr, self.sep, self.mp, self.ep = \
            dp, pp, sharding, sep, mp, ep
        self.sizes = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep,
                      "ep": ep, "mp": mp}
        self.ec = engine_cfg or EngineConfig()
        if self.ec.zero_stage >= 3 and sharding > 1:
            if self.cfg.hidden % sharding:
                raise ValueError("ZeRO-3 shards the hidden dim: hidden % "
                                 "sharding must be 0")
            if self.cfg.moe_experts and self.cfg.ffn_hidden % sharding:
                raise ValueError("ZeRO-3 MoE shards ffn_hidden over "
                                 "'sharding'")
        n = dp * pp * sharding * sep * mp * ep
        one_gpu_ring = (n == sep and self.cfg.seq_parallel == "ring"
                        and get_world_size() == 1)
        self.distributed = n > 1 and not one_gpu_ring
        # the sequence shards this process runs side by side (the ring on
        # one device); 1 in a world, where each sep rank holds its own
        self.local_sep = sep if one_gpu_ring else 1
        self.model.validate(self)
        if self.distributed and get_world_size() < n:
            raise NotImplementedError(
                f"a grid of {self.sizes} needs {n} ranks and the world has "
                f"{get_world_size()}: the multi-GPU path runs one process a "
                f"rank (python -m paddle_tpu_torch.distributed.launch "
                f"--nproc_per_node {n}, then init_parallel_env())")
        if pp > 1 and self.ec.num_microbatches < pp:
            raise ValueError(
                f"the pipeline needs num_microbatches >= pp ({pp}), got "
                f"{self.ec.num_microbatches}")
        if self.distributed:
            self.hcg = HybridCommunicateGroup(
                dp_degree=dp, pp_degree=pp, sharding_degree=sharding,
                sep_degree=sep, ep_degree=ep, mp_degree=mp, ranks=ranks)
            if not self.hcg.member:
                raise ValueError(
                    f"rank {get_rank()} is not on the grid's ranks "
                    f"{self.hcg.ranks}")
            self.coords = self.hcg.coords
            self.group = {a: self.hcg.group_over((a,)) for a in ALL_AXES}
            self.device = resolve_device(
                device if device is not None else current_device())
        else:
            self.hcg = None
            self.coords = {a: 0 for a in self.sizes}
            self.group = {}
            self.device = resolve_device(device)
        # the step's static inputs and device scalars, and the watched
        # step: one capture per engine (CUDA, one process)
        self._inputs = StaticInputs(self.device, torch.long)
        self._lr = device_scalar(0.0, self.device)
        self._step = device_scalar(0, self.device)
        self._key = torch.zeros((), dtype=torch.long, device=self.device)
        body = weakref.WeakMethod(self._step_body)
        if self.distributed:
            self._step_fn = watch(lambda *a, storage=None: body()(*a),
                                  name="hybrid_engine::step")
        else:
            self._step_fn = watch(
                CapturedStep(lambda *a: body()(*a), self.device,
                             empty_cache=True),
                name="hybrid_engine::step")

    def param_specs(self):
        """The model adapter's layout of every leaf over the grid's axes
        (``mesh.PartitionSpec`` per leaf, the JAX engine's specs)."""
        return self.model.param_specs(self)

    def _spec(self, path):
        """The spec of the leaf at ``path`` (``blocks/qkv_w``)."""
        if not hasattr(self, "_specs"):
            self._specs = dict(_mesh._leaf_paths(self.param_specs()))
        return self._specs[path]

    def _axes_of(self, path):
        """The live axes that split the leaf at ``path``."""
        return tuple(a for e in self._spec(path) for a in _names(e)
                     if self._live_group(a) is not None)

    def _z3(self):
        return self.distributed and self.ec.zero_stage >= 3 and self.zr > 1

    def _z3_leaf(self, path):
        """True where the leaf at ``path`` is held as a ZeRO-3 slice."""
        return self._z3() and "sharding" in self._axes_of(path)

    def _chunked(self, path):
        """True where the leaf's optimizer state is a flat ZeRO chunk
        (sharding > 1, the leaf not already a ZeRO-3 slice)."""
        return self._zero2() and not self._z3_leaf(path)

    def _use_1f1b(self):
        """The hand-scheduled 1F1B serves pp > 1 tied dense models; MoE
        and untied heads take the GPipe loop (the JAX ``_use_1f1b``)."""
        return (self.pp > 1 and self.ec.pipeline_schedule == "1f1b"
                and not self.cfg.moe_experts
                and getattr(self.cfg, "tie_embeddings", True))

    def _window(self, path, shape):
        """``[(start, stop)]`` of this rank's shard of the leaf at
        ``path`` (global shape ``shape``) in the global array."""
        return _mesh.window_of(self._spec(path), shape, self.sizes,
                               self.coords)

    def _writer(self, split):
        """True on the one rank that writes a window split over the axes
        ``split``: coordinate 0 on every other axis of the grid."""
        return not self.distributed or all(
            self.coords[a] == 0 for a in ALL_AXES if a not in split)

    def shard_views(self, params):
        """Each leaf of ``params`` (this rank's shards) as a
        ``mesh.Shard``: the local tensor and its window of the global
        array (what ``shard_fingerprint`` digests as
        ``leaf@start:stop,...``)."""
        full = self._full_shapes()
        return _mesh._map(params, lambda path, t: _mesh.Shard(
            t.detach(), full[path], self._window(path, full[path]),
            self._writer(self._axes_of(path))))

    def _full_shapes(self):
        if not hasattr(self, "_shapes"):
            tmpl, _ = self.state_template()
            self._shapes = {p: tuple(t.shape)
                            for p, t in _mesh._leaf_paths(tmpl)}
        return self._shapes

    def state_windows(self, params, opt_state):
        """``{"params", "opt"}`` as ``save_engine_state`` writes them in a
        world: every leaf a ``mesh.Shard`` whose ``owner`` flag is set on
        exactly one rank of the ranks that hold the window (coordinate 0
        on the axes that do not split it).  The optimizer is the
        canonical, param-shaped form; where a leaf's state is a flat ZeRO
        chunk that is also a block of whole rows of the rank's shard
        (``rows % sharding == 0``), each sharding rank writes its chunk
        as that block (no gather), else the chunks are gathered and the
        sharding rank 0 writes the shard."""
        full = self._full_shapes()
        views = {"params": self.shard_views(params), "opt": {}}
        odt = self._opt_dtype()
        has_master = self._has_master()
        for name in ("m", "v", "master"):
            def leaf(path, p, name=name):
                slot = _mesh._spec_at(opt_state["slots"], path)
                shape = full[path]
                win = self._window(path, shape)
                split = self._axes_of(path)
                src = slot.get(name) if (name != "master" or has_master) \
                    else None
                if src is None:
                    src = p.detach().to(odt)
                    if self._chunked(path):
                        src = self._own_chunk(src)
                if not self._chunked(path):
                    return _mesh.Shard(src.detach().view(p.shape), shape,
                                       win, self._writer(split))
                rows = p.shape[0] if p.dim() else 0
                if rows and rows % self.zr == 0:
                    r = rows // self.zr
                    i = self.coords["sharding"]
                    a, _ = win[0]
                    blk = src.detach().view((r,) + tuple(p.shape[1:]))
                    win = [(a + i * r, a + (i + 1) * r)] + win[1:]
                    return _mesh.Shard(blk, shape, win,
                                       self._writer(split + ("sharding",)))
                whole = collective.all_gather(
                    src.detach().contiguous(),
                    group=self.group["sharding"])[:p.numel()].view(p.shape)
                return _mesh.Shard(whole, shape, win, self._writer(split))

            views["opt"][name] = _mesh._map(params, leaf)
        return views

    def _live_group(self, axis):
        """This rank's group along ``axis`` where the axis spans more than
        one rank of a world, else None."""
        if self.distributed and self.sizes[axis] > 1:
            return self.group[axis]
        return None

    @property
    def captures(self):
        """CUDA graphs this engine has captured (0 on the CPU and in a
        world, whose step runs eagerly)."""
        return getattr(self._step_fn, "captures", 0)

    @property
    def graph_pool_bytes(self):
        """Device memory the captured step's private pool holds (its
        activations and gradients; 0 before the capture, on the CPU and
        in a world)."""
        return getattr(self._step_fn, "pool_bytes", 0)

    # ---------------------------------------------------------------- init
    def _opt_dtype(self):
        return (torch.bfloat16 if self.ec.opt_dtype == "bfloat16"
                else torch.float32)

    def _has_master(self):
        if self.ec.master_weights is not None:
            return self.ec.master_weights
        return self.ec.opt_dtype != self.cfg.dtype

    def init(self, seed=0):
        """Random params from ``seed`` (a ``torch.Generator`` on the
        engine's device; the draws differ from ``jax.random``'s) and the
        optimizer state for them.  In a world every rank draws the same
        full tree and keeps its shards (``shard_params``)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(g, self.device)
        if self.distributed:
            params = self.shard_params(params)
        return params, self.init_opt(params)

    def shard_params(self, full):
        """This rank's shards of a full params tree (e.g.
        ``params_from_jax`` of the JAX engine's ``gather_params``) under
        ``param_specs``, as contiguous copies on the engine's device; the
        whole tree in one process."""
        specs = self.param_specs()

        def cut(node, spec):
            if isinstance(node, dict):
                return {k: cut(node[k], spec[k]) for k in node}
            t = node.to(self.device)
            if self.distributed:
                t = local_shard(t, spec, self.sizes, self.coords)
            return t.detach().contiguous().clone()

        return cut(full, specs)

    @torch.no_grad()
    def gather_params(self, params):
        """The full params tree on every rank, detached copies
        (all-gathered along each dimension a spec splits over a world's
        axis)."""
        specs = self.param_specs()

        def full(node, spec):
            if isinstance(node, dict):
                return {k: full(node[k], spec[k]) for k in node}
            x = node.detach().clone()
            for dim in reversed(range(len(spec))):
                for a in reversed(_names(spec[dim])):
                    if self._live_group(a) is not None:
                        x = collective.all_gather(
                            x.contiguous(), group=self.group[a], axis=dim)
            return x

        return full(params, specs)

    # ZeRO-2: at sharding > 1 a leaf of n elements is flattened, padded
    # to zr·c (c = ⌈n / zr⌉) and rank i of the sharding group keeps
    # elements [i·c, (i+1)·c): its gradient sum, its slots, its update
    def _chunk(self, n):
        return -(-n // self.zr)

    def _own_chunk(self, t):
        """This rank's flat chunk of ``t`` (a copy)."""
        flat = t.reshape(-1)
        c = self._chunk(flat.numel())
        flat = torch.nn.functional.pad(flat, (0, self.zr * c - flat.numel()))
        i = self.coords["sharding"]
        return flat[i * c:(i + 1) * c].clone()

    def _zero2(self):
        return self.distributed and self.zr > 1

    def init_opt(self, params):
        """Zero moments and (when kept) a master copy per leaf, in
        ``opt_dtype``; ``step`` is a Python int.  A leaf chunked over
        sharding keeps this rank's flat chunk; a ZeRO-3 slice keeps
        slots of the slice's shape."""
        odt = self._opt_dtype()
        has_master = self._has_master()

        def build(path, node):
            p = node.detach()
            if self._chunked(path):
                p = self._own_chunk(p)
            slot = {"m": torch.zeros_like(p, dtype=odt),
                    "v": torch.zeros_like(p, dtype=odt)}
            if has_master:
                slot["master"] = p.to(odt, copy=True)
            return slot

        return {"step": 0, "slots": _mesh._map(params, build)}

    def opt_canonical(self, opt_state, params):
        """``{"m", "v", "master"}`` trees of param-shaped tensors — the
        JAX engine's ``opt_canonical`` form (this rank's param shards in a
        world; the flat chunks gathered back over sharding).  Without a
        master slot the param is the master and is returned cast to
        ``opt_dtype``."""
        odt = self._opt_dtype()

        def pick(name):
            def leaf(path, p):
                slots = _mesh._spec_at(opt_state["slots"], path)
                if name == "master" and "master" not in slots:
                    return p.detach().to(odt)
                x = slots[name]
                if not self._chunked(path):
                    return x
                full = collective.all_gather(x.contiguous(),
                                             group=self.group["sharding"])
                return full[:p.numel()].view(p.shape)

            return _mesh._map(params, leaf)

        return {name: pick(name) for name in ("m", "v", "master")}

    def opt_from_canonical(self, canon, step=0):
        """Inverse of ``opt_canonical``: an optimizer state whose slots
        are copies of the canonical trees (cast to ``opt_dtype``; this
        rank's chunks where a leaf is chunked over sharding), at step
        ``step`` (so a state carried over from JAX resumes with the bias
        correction of its next step)."""
        odt = self._opt_dtype()
        has_master = self._has_master()

        def build(path, m):
            def conv(t):
                t = t.to(self.device, odt, copy=True)
                return self._own_chunk(t) if self._chunked(path) else t

            slot = {"m": conv(m), "v": conv(_mesh._spec_at(canon["v"],
                                                           path))}
            if has_master:
                slot["master"] = conv(_mesh._spec_at(canon["master"], path))
            return slot

        return {"step": int(step), "slots": _mesh._map(canon["m"], build)}

    def state_template(self):
        """Shape, dtype and device of every leaf of ``(params, canonical
        optimizer state)`` (``opt_canonical``'s ``m``, ``v``, ``master``),
        allocating nothing (the params are drawn on the meta device): the
        restore target of ``checkpoint.load_engine_state``."""
        import types

        shapes = self.model.init(torch.Generator(), torch.device("meta"))
        odt = self._opt_dtype()

        def tmpl(node, dtype=None):
            if isinstance(node, dict):
                return {k: tmpl(v, dtype) for k, v in node.items()}
            return types.SimpleNamespace(shape=tuple(node.shape),
                                         dtype=dtype or node.dtype,
                                         device=self.device)

        return tmpl(shapes), {name: tmpl(shapes, odt)
                              for name in ("m", "v", "master")}

    # ------------------------------------------------------- forward pieces
    def _attention(self, q, k, v, causal=True):
        """Attention of one block on q/k/v ``[B, H_local, s, hd]``: over
        the sep group as the ring (K/V passed round the ranks) or Ulysses
        (all-to-all to the whole sequence on H/sep heads, flash, and
        back); on one device the ring over ``local_sep`` shards of the
        whole sequence; else flash where its gate allows, the naive route
        otherwise."""
        sep = self._live_group("sep")
        if self.cfg.seq_parallel == "ring" and (sep or self.local_sep > 1):
            from ..kernels.ring_attention import ring_attention

            return ring_attention(q, k, v, sep or self.local_sep,
                                  causal=causal)
        if sep is not None:
            q, k, v = (collective.AllToAll.apply(t, sep, 1, 2)
                       for t in (q, k, v))
            out = _default_attention(self.cfg, q, k, v, causal=causal)
            return collective.AllToAll.apply(out, sep, 2, 1)
        return _default_attention(self.cfg, q, k, v, causal=causal)

    def _dropout(self, x, rate, seed):
        """Dropout on ``x [B, S, ...]``; on the one-device ring each of
        the ``local_sep`` sequence shards draws its own mask, with its
        index folded into ``seed`` (a sep rank of a world has its
        coordinate folded into the step's key instead)."""
        if self.local_sep == 1 or seed is None or rate <= 0.0:
            return _dropout(x, rate, seed)
        return torch.cat([_dropout(c, rate, _fold(seed, i))
                          for i, c in enumerate(x.chunk(self.local_sep,
                                                        dim=1))], dim=1)

    def _moe(self, bp, h):
        """The MoE FFN of one block: ``(y, aux)``.  Each sequence shard is
        gated on its own (its capacity from its own tokens) and the aux
        losses averaged over the shards, as the JAX engine's sep ranks
        do; over the ep group the experts are this rank's E/ep."""
        from .moe import moe_layer

        cfg = self.cfg
        p = {k: bp[k] for k in ("gate_w", "up_w", "up_b", "down_w",
                                "down_b")}
        ep = self._live_group("ep")
        parts = h.chunk(self.local_sep, dim=1) if self.local_sep > 1 \
            else (h,)
        outs, auxes = zip(*(moe_layer(
            p, x, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, ep_axis=ep)
            for x in parts))
        if len(parts) == 1:
            return outs[0], auxes[0]
        return torch.cat(outs, dim=1), sum(auxes) / len(parts)

    def _embed_core(self, wte, wpe, tokens):
        """Embedding + position embedding, cast to the working dtype: in a
        world the vocab-split lookup summed over mp and the positions of
        this rank's sequence slice."""
        s = tokens.shape[1]
        if not self.distributed:
            return (wte[tokens] + wpe[:s]).to(self.cfg.torch_dtype())
        from .mp_layers import vocab_parallel_embed

        emb = vocab_parallel_embed(tokens, wte, self._live_group("mp"))
        s0 = self.coords["sep"] * s
        return (emb + wpe[s0:s0 + s]).to(self.cfg.torch_dtype())

    def tied_vocab_ce(self, x, wte, labels):
        """CE against the tied embedding, in sequence chunks.
        x ``[b, s, D]``; wte ``[V/mp, D]``; labels ``[b, s]`` with -100 =
        ignore.  Returns (sum_loss, count), this rank's.

        The number of chunks doubles while a chunk's fp32 logits exceed
        ``ce_block_elems`` and S still splits; each chunk runs under a
        checkpoint, so backward re-runs its head matmul instead of
        keeping its fp32 softmax alive.  The logits matmul runs in the
        working dtype and is cast to fp32 after, as in JAX; at mp > 1 it
        is this rank's vocab columns and the CE is ``mp_layers``'
        ``parallel_cross_entropy``."""
        mp = self._live_group("mp")
        if mp is not None:
            from .mp_layers import copy_to_group, parallel_cross_entropy

            x = copy_to_group(x, mp)

        def ce_chunk(xc, lc):
            logits = (xc @ wte.t()).float()
            if mp is not None:
                loss_tok = parallel_cross_entropy(logits, lc, mp_axis=mp)
            else:
                logp = torch.log_softmax(logits, dim=-1)
                loss_tok = -logp.gather(-1, lc.clamp(min=0)[..., None])[
                    ..., 0]
            mask = (lc != -100).float()
            return (loss_tok * mask).sum(), mask.sum()

        b, s, _ = x.shape
        nchunk = 1
        while (b * s * wte.shape[0]) // nchunk > self.ec.ce_block_elems \
                and s % (2 * nchunk) == 0:
            nchunk *= 2
        if nchunk == 1:
            return ce_chunk(x, labels)
        from torch.utils.checkpoint import checkpoint

        sc = s // nchunk
        s_sum = c_sum = 0.0
        for i in range(nchunk):
            sl = slice(i * sc, (i + 1) * sc)
            # ce_chunk draws no random numbers (recompute.py)
            s_i, c_i = checkpoint(ce_chunk, x[:, sl], labels[:, sl],
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            s_sum, c_sum = s_sum + s_i, c_sum + c_i
        return s_sum, c_sum

    def _data_shards(self):
        """Ranks holding other tokens of the global batch: the sizes of
        dp, sharding, ep and sep (the JAX ``_aux_mean`` denominator)."""
        return self.dp * self.zr * self.ep * self.sep

    # ------------------------------------------------- ZeRO-3 gathering
    def _z3_gather(self, t, path, skip_leading=0):
        """The whole leaf (over sharding) of a ZeRO-3 slice ``t``, through
        ``_ZeroGather``; any other leaf as it is.  ``skip_leading`` drops
        leading spec entries already consumed (a block's layer axis)."""
        if not self._z3_leaf(path):
            return t
        spec = self._spec(path)[skip_leading:]
        dim = next(d for d, e in enumerate(spec) if "sharding" in _names(e))
        return _ZeroGather.apply(t, self.group["sharding"], dim)

    def _z3_gather_block(self, bp):
        """One block's leaves gathered just in time (inside the block's
        recompute, so the backward gathers again)."""
        if not self._z3():
            return bp
        return {k: self._z3_gather(v, f"blocks/{k}", skip_leading=1)
                for k, v in bp.items()}

    def _aux_gathered(self, aux):
        """The non-block params with their ZeRO-3 slices gathered."""
        if not self._z3():
            return aux
        return {k: self._z3_gather(v, k) for k, v in aux.items()}

    def _block_fn(self, bp, x, s):
        return self.model.block(self, self._z3_gather_block(bp), x, s)

    def _stage(self, blocks, x, seed):
        """This rank's blocks (its ``L/pp`` layers) on ``x``: ``(y,
        aux_sum)``; block l's dropout seed is ``seed`` folded with its
        GLOBAL layer index."""
        first = self.coords["pp"] * (self.cfg.num_layers // self.pp)
        return run_blocks(self._block_fn, blocks, x, self.cfg.remat, seed,
                          first_layer=first)

    def _local_loss(self, params, tokens, labels, seed=None):
        """This rank's share of the global mean CE of one micro-batch:
        its CE sum over the global count of labelled tokens, plus
        ``moe_aux_weight`` × its aux loss over the data shards and the
        layers (so the sum over the data group is the JAX step's loss
        with ``_aux_mean``).  ``seed``: the dropout seed, already folded
        with the step, the micro-batch and the rank's data coordinates
        (None: no dropout)."""
        cfg = self.cfg
        aux = self._aux_gathered(
            {k: v for k, v in params.items() if k != "blocks"})
        x = self.model.embed(self, aux, tokens)
        if seed is not None:
            x = self._dropout(x, cfg.dropout, _fold(seed, 999983))
        out, moe_aux = self._stage(params["blocks"], x, seed)
        s, c = self.model.head_loss(self, aux, out, labels)
        if self.distributed:
            c = collective.all_reduce(c.detach().clone(),
                                      group=self._loss_group())
        loss = s / torch.clamp(c, min=1.0)
        if cfg.moe_experts:
            loss = loss + cfg.moe_aux_weight * moe_aux / (
                cfg.num_layers * (self._data_shards() if self.distributed
                                  else 1))
        return loss

    def _loss_group(self):
        return self.hcg.group_over(_LOSS_AXES)

    # -------------------------------------------------------- the pipeline
    def _denominator(self, labels):
        """The global count of labelled tokens (over the data group), at
        least 1: every pp rank knows it before the loop."""
        c = (labels != -100).sum().float()
        return torch.clamp(collective.all_reduce(c, group=self._loss_group()),
                           min=1.0)

    def _aux_leaves(self, paths, leaves):
        """The non-block leaves as the stages use them (ZeRO-3 slices
        gathered, detached): each a leaf whose gradient the loop sums;
        ``({name: leaf}, [its index into leaves])``."""
        aux, idx = {}, []
        for i, (path, t) in enumerate(zip(paths, leaves)):
            if path.startswith("blocks/"):
                continue
            if self._z3_leaf(path):
                t = self._z3_gather(t.detach(), path).requires_grad_(True)
            aux[path] = t
            idx.append(i)
        return aux, idx

    def _pipeline(self, params, paths, leaves, tokens, labels, key):
        """``(loss share, grads)`` of one micro-batch group through the
        pipeline (GPipe or 1F1B); the grads line up with ``leaves`` (in
        each leaf's dtype; a stage that does not use a leaf gives zeros)
        and the loss share sums over pp and the data group to the loss."""
        cfg, M = self.cfg, self.ec.num_microbatches
        b = tokens.shape[0]
        if b % M:
            raise ValueError(f"local batch {b} must divide "
                             f"num_microbatches {M}")
        blk = [i for i, p in enumerate(paths) if p.startswith("blocks/")]
        aux, aux_idx = self._aux_leaves(paths, leaves)
        run = self._run_1f1b if self._use_1f1b() else self._run_gpipe
        loss, blk_grads, aux_grads = run(
            params, aux, [leaves[i] for i in blk], tokens, labels, key,
            b // M)
        got = dict(zip(blk, blk_grads))
        for i, g in zip(aux_idx, aux_grads):
            if g is not None and self._z3_leaf(paths[i]):
                dim = next(d for d, e in enumerate(self._spec(paths[i]))
                           if "sharding" in _names(e))
                g = _scatter_sum(g.to(leaves[i].dtype),
                                 self.group["sharding"], dim)
            got[i] = g
        return loss, [torch.zeros_like(t) if got[i] is None else
                      got[i].to(t.dtype) for i, t in enumerate(leaves)]

    def _run_gpipe(self, params, aux, blk_leaves, tokens, labels, key, mb):
        """The GPipe loop (:func:`gpipe`), each stage's graph kept from
        its forward tick to its backward tick.  Stage 0 embeds the whole
        batch once (its dropout folded with 999983) and takes the
        embedding's gradient at the end."""
        cfg, pp, M = self.cfg, self.pp, self.ec.num_microbatches
        i = self.coords["pp"]
        first, last = i == 0, i == pp - 1
        S, D, dt = tokens.shape[1], cfg.hidden, cfg.torch_dtype()
        denom = self._denominator(labels)
        moe_w = (cfg.moe_aux_weight / (M * cfg.num_layers *
                                       self._data_shards())
                 if cfg.moe_experts else 0.0)
        aux_in = list(aux.values())
        x_full = None
        if first:
            x_full = self.model.embed(self, aux, tokens)
            if key is not None:
                x_full = self._dropout(x_full, cfg.dropout,
                                       _fold(key, 999983))
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        dx_full = torch.zeros_like(x_full) if first else None
        aux_acc = [None] * len(aux_in)
        blk_acc = [None] * len(blk_leaves)

        def forward(m, inbox):
            nonlocal loss
            rows = slice(m * mb, (m + 1) * mb)
            x_in = (x_full[rows] if first else inbox).detach()
            x_in.requires_grad_(True)
            k = _fold(key, m) if key is not None else None
            y, a = self._stage(params["blocks"], x_in, k)
            s = None
            if last:
                sm, _ = self.model.head_loss(self, aux, y, labels[rows])
                s = sm / denom
                loss = loss + s.detach()
            if moe_w:
                loss = loss + moe_w * a.detach()
            return (x_in, y, s, a), y

        def backward(m, saved, ct):
            x_in, y, s, a = saved
            outs, gouts = ([s], [torch.ones_like(s)]) if last else \
                ([y], [ct])
            if moe_w:
                outs.append(a)
                gouts.append(torch.full_like(a, moe_w))
            ins = blk_leaves + [x_in] + (aux_in if last else [])
            gs = torch.autograd.grad(outs, ins, gouts, allow_unused=True)
            n = len(blk_leaves)
            _sum_into(blk_acc, gs[:n])
            if last:
                _sum_into(aux_acc, gs[n + 1:])
            if first:
                dx_full[m * mb:(m + 1) * mb] = gs[n]
            return gs[n]

        meta = ((mb, S, D), dt)
        peak = gpipe(self.group["pp"], i, pp, M, forward, backward, meta,
                     meta, self.device)
        if first:
            _sum_into(aux_acc, torch.autograd.grad(
                [x_full], aux_in, [dx_full], allow_unused=True))
        self.pipeline_stats = {"live_peak": peak, "ticks": M + pp - 1,
                               "schedule": "gpipe"}
        return loss, blk_acc, aux_acc

    def _run_1f1b(self, params, aux, blk_leaves, tokens, labels, key, mb):
        """The 1F1B loop over ``_1f1b_schedule``'s ticks.  A forward tick
        runs the stage without a graph and keeps its input in the ring
        (at most ``pp - i`` entries); a backward tick runs the stage again
        from the saved input and backpropagates the arrived cotangent
        (stage 0 also re-runs its embedding, the last stage runs its
        forward and backward of a microbatch in the one tick, through the
        head seeded with ``1/denom``).  Sends are posted where this stage
        is live, receives where the schedule says the sender is: each
        direction's message waits in its one-slot mailbox until used."""
        cfg, pp, M = self.cfg, self.pp, self.ec.num_microbatches
        i = self.coords["pp"]
        first, last = i == 0, i == pp - 1
        S, D, dt = tokens.shape[1], cfg.hidden, cfg.torch_dtype()
        fwd, bwd = _1f1b_schedule(pp, M)
        denom = self._denominator(labels)
        aux_in = list(aux.values())
        aux_acc = [None] * len(aux_in)
        blk_acc = [None] * len(blk_leaves)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        ring, x_box, ct_box = {}, None, None
        peak = 0

        def seeds(m):
            k = _fold(key, m) if key is not None else None
            return k, (_fold(k, 999983) if k is not None else None)

        def embed(m, k_emb):
            x = self.model.embed(self, aux, tokens[m * mb:(m + 1) * mb])
            if k_emb is not None:
                x = self._dropout(x, cfg.dropout, k_emb)
            return x

        for t in range(fwd.shape[0]):
            mf, mbk = int(fwd[t, i]), int(bwd[t, i])
            y_send = dx_send = None
            if mf >= 0:
                k, k_emb = seeds(mf)
                if first:
                    with torch.no_grad():
                        x0 = embed(mf, k_emb)
                else:
                    x0, x_box = x_box, None
                ring[mf] = x0.detach()
                peak = max(peak, len(ring))
                if not (last and mbk == mf):
                    with torch.no_grad():
                        y_send, _ = self._stage(params["blocks"], x0, k)
            if mbk >= 0:
                k, k_emb = seeds(mbk)
                rows = slice(mbk * mb, (mbk + 1) * mb)
                x0 = ring.pop(mbk).requires_grad_(True)
                y, _ = self._stage(params["blocks"], x0, k)
                if last:
                    sm, _ = self.model.head_loss(self, aux, y,
                                                 labels[rows])
                    loss = loss + (sm / denom).detach()
                    outs, gouts = [sm], [1.0 / denom]
                else:
                    outs, gouts = [y], [ct_box]
                    ct_box = None
                ins = blk_leaves + [x0] + (aux_in if last else [])
                gs = torch.autograd.grad(outs, ins, gouts,
                                         allow_unused=True)
                n = len(blk_leaves)
                _sum_into(blk_acc, gs[:n])
                dx = gs[n]
                if last:
                    _sum_into(aux_acc, gs[n + 1:])
                if first:
                    e = embed(mbk, k_emb)
                    _sum_into(aux_acc, torch.autograd.grad(
                        [e], aux_in, [dx], allow_unused=True))
                else:
                    dx_send = dx
            sends = []
            if y_send is not None and not last:
                sends.append((y_send, i + 1))
            if dx_send is not None:
                sends.append((dx_send, i - 1))
            recvs = []
            if not first and fwd[t, i - 1] >= 0:
                recvs.append(((mb, S, D), dt, i - 1))
            if not last and bwd[t, i + 1] >= 0:
                recvs.append(((mb, S, D), dt, i + 1))
            got = iter(pp_hop(self.group["pp"], sends, recvs,
                                 self.device))
            if not first and fwd[t, i - 1] >= 0:
                x_box = next(got)
            if not last and bwd[t, i + 1] >= 0:
                ct_box = next(got)
        self.pipeline_stats = {"live_peak": peak, "ticks": fwd.shape[0],
                               "schedule": "1f1b"}
        return loss, blk_acc, aux_acc

    def _windows(self, n):
        w = max(1, int(self.ec.opt_update_window))
        return [slice(lo, min(n, lo + w)) for lo in range(0, n, w)]

    def step(self, params, opt_state, tokens, labels, lr=None,
             dropout_seed=0):
        """One train step; returns ``(params, opt_state, loss)``.

        Where the JAX step donates its inputs and returns new arrays,
        this one updates ``params`` and ``opt_state`` in place and
        returns the same dicts, so the call reads like its counterpart;
        ``loss`` is a new 0-d fp32 tensor (the global batch's, on every
        rank of a world).  ``tokens``/``labels`` are the global batch.
        Param leaves are made to require grad.  ``dropout_seed`` varies
        the dropout masks per step (ignored when cfg.dropout == 0); the
        step counter is folded in as in JAX.  The optimizer update is the
        ``torch.profiler`` range ``engine::optimizer`` (visible on the
        eager route: a replayed graph records no ranges)."""
        if self.distributed:
            tokens, labels = self._local_batch(tokens), \
                self._local_batch(labels)
        else:
            tokens, labels = self._inputs(tokens, labels)
        S = tokens.shape[1]
        if self.local_sep > 1 and S % (self.local_sep * 128):
            raise ValueError(
                f"ring sequence parallelism splits S={S} into sep="
                f"{self.local_sep} shards of a multiple of 128 tokens "
                f"each; S % (sep * 128) must be 0")
        for _, t in _flat_items(params):
            if not t.requires_grad:
                t.requires_grad_(True)
        step = opt_state["step"] + 1
        self._step.fill_(step)
        self._lr.fill_(self.ec.lr if lr is None else lr)
        if self.cfg.dropout > 0.0:
            key = _fold(dropout_seed, opt_state["step"])
            # distinct masks per data shard, the same across mp
            for ax in ("dp", "sharding", "ep", "sep"):
                if self._live_group(ax) is not None:
                    key = _fold(key, self.coords[ax])
            self._key.fill_(key)
        args = (params, opt_state["slots"], self._step, tokens, labels,
                self._lr, self._key)
        with RecordEvent("hybrid_engine::step"):
            loss = self._run(args)
        opt_state["step"] = step
        return params, opt_state, loss

    def _local_batch(self, x):
        """This rank's rows (over dp, sharding, ep, in that order) and
        sequence slice (over sep) of the global batch ``x [B, S]``, as an
        int64 tensor on the engine's device."""
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.asarray(x))
        B, S = t.shape
        nd = self.dp * self.zr * self.ep
        if B % nd or S % self.sep:
            raise ValueError(
                f"the global batch [{B}, {S}] must split into {nd} row "
                f"blocks (dp·sharding·ep) and {self.sep} sequence slices")
        c = self.coords
        d = (c["dp"] * self.zr + c["sharding"]) * self.ep + c["ep"]
        b, s = B // nd, S // self.sep
        t = t[d * b:(d + 1) * b, c["sep"] * s:(c["sep"] + 1) * s]
        return t.to(self.device, torch.long)

    def _run(self, args):
        """The watched step (the graph's replay on CUDA in one process);
        the loss is copied out of the graph's static output."""
        params, slots, *rest = args
        tag = storage_tag([t for tree in (params, slots)
                           for _, t in _flat_items(tree)] + rest)
        return self._step_fn(*args, storage=tag).clone()

    def _step_body(self, params, slots, step, tokens, labels, lr, key):
        """Grads, clip and the update: the captured step.  Reads every
        per-call value from a device tensor (``step``, ``lr``, ``key``)
        and writes params and slots in place; no host sync in one
        process.  In a world the loss is summed over the data group (and
        over pp) and the gradients reduced (``_reduce_grads``) first."""
        items = list(_flat_items(params))
        paths = [p for p, _ in items]
        leaves = [t for _, t in items]
        key = key if self.cfg.dropout > 0.0 else None
        loss, grads = self._grads(params, paths, leaves, tokens, labels,
                                  key)
        with torch.no_grad(), record_function("engine::optimizer"):
            if self.distributed:
                loss = collective.all_reduce(loss.clone(),
                                             group=self._loss_group())
                if self.pp > 1:
                    loss = collective.all_reduce(loss, group=self.group["pp"])
                grads = self._reduce_grads(paths, grads)
            self._apply(paths, leaves, grads, slots, step, lr)
        return loss

    def _loss_grads(self, params, paths, leaves, tokens, labels, key):
        """(loss share, grads) of one micro-batch: through the pipeline
        at pp > 1, else one backward pass (grads in their param's
        dtype)."""
        if self.pp > 1:
            return self._pipeline(params, paths, leaves, tokens, labels,
                                  key)
        loss = self._local_loss(params, tokens, labels, key)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def _grads(self, params, paths, leaves, tokens, labels, key):
        """(mean loss, grads): one pass, or ``accum_steps`` micro-batches
        with the grads summed in fp32 and averaged."""
        accum = self.ec.accum_steps
        if accum == 1:
            return self._loss_grads(params, paths, leaves, tokens, labels,
                                    key)
        b = tokens.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} must divide accum_steps {accum}")
        mb = b // accum
        grads = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            k = _fold(key, i) if key is not None else None
            l, gs = self._loss_grads(params, paths, leaves, tokens[rows],
                                     labels[rows], k)
            for acc, g in zip(grads, gs):
                acc.add_(g.float())
            loss = loss + l
        return loss / accum, [g / accum for g in grads]

    def _reduce_grads(self, paths, grads):
        """Each gradient summed over the ranks whose tokens reach it: the
        axes its leaf is replicated on among dp, sharding, sep, ep and pp
        (an mp-replicated leaf's gradient is already whole on every mp
        rank, summed in the tensor-parallel pair's backward).  A leaf
        chunked over sharding gets a reduce-scatter (this rank's flat
        chunk of the sum); a ZeRO-3 slice's gradient arrives summed over
        sharding already (``_ZeroGather``'s backward).  Leaves of one
        dtype and kind go in buckets of about ``_BUCKET_ELEMS``, one
        collective (or two) a bucket."""
        out = list(grads)
        axes = [self._axes_of(p) for p in paths]
        for ep_split in (False, True):
            rest = ("dp", "sep") if ep_split else ("dp", "sep", "ep")
            for kind in ("whole", "chunk", "slice"):
                group = self.hcg.group_over(
                    rest + ("sharding",) if kind == "whole" else rest)
                for dtype in sorted({g.dtype for g in grads}, key=str):
                    ids = [i for i, g in enumerate(grads)
                           if ("ep" in axes[i]) == ep_split
                           and g.dtype == dtype
                           and self._grad_kind(paths[i]) == kind]
                    size = (lambda i: self._chunk(grads[i].numel())) \
                        if kind == "chunk" else (lambda i: grads[i].numel())
                    for bucket in _buckets(ids, size):
                        if kind == "chunk":
                            self._reduce_scatter_bucket(bucket, grads, out,
                                                        group)
                        else:
                            self._all_reduce_bucket(bucket, grads, out,
                                                    group)
        if self.pp > 1:
            # leaves every stage holds (the tied embedding, the norms):
            # each stage's part summed over pp
            for dtype in sorted({g.dtype for g in out}, key=str):
                ids = [i for i, g in enumerate(out)
                       if "pp" not in axes[i] and g.dtype == dtype]
                for bucket in _buckets(ids, lambda i: out[i].numel()):
                    self._all_reduce_bucket(bucket, out, out,
                                            self.group["pp"])
        return out

    def _grad_kind(self, path):
        """How a leaf's gradient is reduced: ``"chunk"`` (reduce-scatter
        into the ZeRO chunk), ``"slice"`` (a ZeRO-3 slice) or
        ``"whole"``."""
        return ("slice" if self._z3_leaf(path) else
                "chunk" if self._chunked(path) else "whole")

    @staticmethod
    def _all_reduce_bucket(bucket, grads, out, group):
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        collective.all_reduce(flat, group=group)
        off = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view(grads[i].shape)
            off += n

    def _reduce_scatter_bucket(self, bucket, grads, out, group):
        """Leaves ``bucket`` laid out as ``[zr, Σc]`` (row i: every leaf's
        chunk i), reduce-scattered over sharding and all-reduced over
        ``group``: ``out[i]`` is this rank's chunk sum of leaf i."""
        sizes = [self._chunk(grads[i].numel()) for i in bucket]
        buf = torch.zeros((self.zr, sum(sizes)), dtype=grads[bucket[0]].dtype,
                          device=self.device)
        off = 0
        for i, c in zip(bucket, sizes):
            flat = grads[i].reshape(-1)
            buf[:, off:off + c] = torch.nn.functional.pad(
                flat, (0, self.zr * c - flat.numel())).view(self.zr, c)
            off += c
        red = collective.reduce_scatter(buf.view(-1),
                                        group=self.group["sharding"])
        collective.all_reduce(red, group=group)
        off = 0
        for i, c in zip(bucket, sizes):
            out[i] = red[off:off + c]
            off += c

    def leaf_sq(self, paths, grads):
        """Each leaf's squared gradient norm in fp32 (``[n]``), its
        disjoint parts summed over the ranks that hold them: chunks and
        ZeRO-3 slices over sharding, and each pp-, mp- or ep-split leaf
        over its axis (a leaf replicated on an axis is counted once).
        Squares are summed window by window."""
        sq = torch.zeros(len(grads), dtype=torch.float32, device=self.device)
        for k, g in enumerate(grads):
            flat = g.reshape(-1)
            for sl in self._windows(flat.numel()):
                sq[k] += flat[sl].float().square().sum()
        if self._zero2():
            collective.all_reduce(sq, group=self.group["sharding"])
        for axis in ("pp", "mp", "ep"):
            if self._live_group(axis) is None:
                continue
            mask = torch.tensor([axis in self._axes_of(p) for p in paths],
                                device=self.device)
            part = torch.where(mask, sq, 0.0)
            collective.all_reduce(part, group=self._live_group(axis))
            sq = torch.where(mask, part, sq)
        return sq

    def _apply(self, paths, leaves, grads, slots, step, lr):
        """Global-norm clip and the Adam update, in place; ``step`` and
        ``lr`` are 0-d fp32 device tensors.  A leaf chunked over sharding
        updates this rank's flat chunk and the chunks are all-gathered
        over the sharding group after; a ZeRO-3 slice updates in place
        and stays a slice."""
        ec = self.ec
        # --- global-norm clip: squares summed in fp32, grads keep their
        # dtype ((g * scale) is rounded back to it, as JAX does) ---
        scale = None
        if ec.grad_clip and ec.grad_clip > 0:
            gnorm = torch.sqrt(self.leaf_sq(paths, grads).sum())
            scale = torch.clamp(ec.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)

        b1, b2 = ec.beta1, ec.beta2
        bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)
        eps, decay = ec.eps, ec.weight_decay
        has_master = self._has_master()
        chunks = []

        for path, p, g in zip(paths, leaves, grads):
            slot = slots
            for k in path.split("/"):
                slot = slot[k]
            decay_on = bool(decay) and self.model.decay_this(path)
            gf = g.view(-1)
            m, v = slot["m"].view(-1), slot["v"].view(-1)
            if self._chunked(path):
                w_src = slot["master"] if has_master else \
                    self._own_chunk(p.detach())
                pf = torch.empty(gf.numel(), dtype=p.dtype,
                                 device=self.device) if has_master else w_src
                chunks.append((p, pf))
            else:
                pf = p.detach().view(-1)
                w_src = slot["master"].view(-1) if has_master else pf
            for sl in self._windows(pf.numel()):
                gw = gf[sl].float()
                if scale is not None:
                    gw = (gw * scale).to(g.dtype).float()
                mw = b1 * m[sl].float() + (1 - b1) * gw
                vw = b2 * v[sl].float() + (1 - b2) * gw * gw
                ww = w_src[sl].float()
                upd = (mw / bc1) / (torch.sqrt(vw / bc2) + eps)
                if decay_on:
                    upd = upd + decay * ww
                w_new = ww - lr * upd
                m[sl] = mw
                v[sl] = vw
                if has_master:
                    slot["master"].view(-1)[sl] = w_new
                pf[sl] = w_new
        if chunks:
            self._gather_chunks(chunks)

    def _gather_chunks(self, chunks):
        """Every rank's updated chunks all-gathered over the sharding
        group (one collective a bucket of one dtype) and written into the
        params."""
        for dtype in sorted({p.dtype for p, _ in chunks}, key=str):
            mine = [(p, c) for p, c in chunks if p.dtype == dtype]
            for bucket in _buckets(range(len(mine)),
                                   lambda i: mine[i][1].numel()):
                part = [mine[i] for i in bucket]
                flat = torch.cat([c for _, c in part])
                full = collective.all_gather(
                    flat, group=self.group["sharding"]).view(self.zr, -1)
                off = 0
                for p, c in part:
                    n = c.numel()
                    p.detach().view(-1).copy_(
                        full[:, off:off + n].reshape(-1)[:p.numel()])
                    off += n


def _sum_into(acc, gs):
    """``acc[k] += gs[k]`` in fp32 (a None gradient adds nothing)."""
    for k, g in enumerate(gs):
        if g is not None:
            g = g.float()
            acc[k] = g if acc[k] is None else acc[k].add_(g)


#: elements a gradient or parameter bucket holds at most (a single
#: larger leaf goes alone): what one collective moves
_BUCKET_ELEMS = 1 << 25


def _buckets(ids, size):
    """``ids`` in order, cut into runs of at most ``_BUCKET_ELEMS``
    elements by ``size(i)``."""
    out, cur, n = [], [], 0
    for i in ids:
        if cur and n + size(i) > _BUCKET_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size(i)
    if cur:
        out.append(cur)
    return out
