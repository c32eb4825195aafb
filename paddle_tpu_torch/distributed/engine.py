"""The training engine on one GPU (the single-device half of
``paddle_tpu/distributed/engine.py``).

``HybridEngine(cfg).step`` is the JAX package's ``_step_local`` at
dp = pp = sharding = mp = ep = 1, written eagerly:

  tokens [B, S] → embedding → blocks in a Python loop, each under the
  ``cfg.remat`` checkpoint policy → final LN + tied-vocab CE in
  sequence chunks (+ ``moe_aux_weight`` × the per-layer mean MoE aux
  loss for a MoE model) → grads (``torch.autograd.grad``), accumulated
  in fp32 over ``accum_steps`` micro-batches → global-norm clip → Adam
  with bias correction and decoupled weight decay, in windows of at most
  ``opt_update_window`` elements, in place.

Sequence parallelism with ``cfg.seq_parallel == "ring"`` and ``sep > 1``
runs every sep rank's shard on the one device: the whole sequence stays
on it, each block's attention is ``ring_attention`` over ``sep``
contiguous shards (``_attention``), and dropout draws its mask per
shard with the shard index folded into the seed (``_dropout``), as the
JAX step folds the sep index into its key.  Everything else in a step
is per token, so it equals the JAX engine's sharded step.  MoE and
bidirectional (``BertAdapter``) models train at sep = 1 only: the JAX
engine gates each sep shard separately, which is a later slice.

The step is the port's ``watch(jax.jit(step), name="hybrid_engine::
step")``: on CUDA the step's body runs eagerly on the first call (a real
step), is captured then as one CUDA graph (``_captured.CapturedStep``)
and replayed on every later call, under ``RecordEvent("hybrid_engine::
step")``.  What the graph reads lives at fixed addresses: the params and
the slots (written in place), ``tokens``/``labels`` (copied into static
device buffers through pinned host buffers), and three 0-d device
scalars written before each call, all the engine's own — the learning rate
(fp32), the step (fp32, filled from the Python int ``opt_state["step"]``
+ 1; Adam's bias corrections are computed from it on the device) and
the dropout key (int64: ``dropout_seed`` folded with the step; every further
fold and each mask is computed on the device from it, ``models/gpt.py``).
Passing other params or state tensors, or a batch of another shape,
captures again, which the compile watchdog reports as a rebuild; a
failed capture raises.  The loss returned is a copy of the graph's
output.  On the CPU (``device="cpu"``) the same body runs eagerly
through the same watched call.

What has no counterpart on one GPU is left out: the mesh and its
collectives, ZeRO chunking, the ``_SLOT_LANE`` padding of optimizer
slots (a TPU tiling concern) and the pipeline schedules.  Every other
parallel axis > 1, and Ulysses with ``sep > 1``, raises
``NotImplementedError``: those paths are the multi-GPU slice of the
port.  Optimizer slots are stored param-shaped, which is the JAX
package's canonical, topology-neutral form (``opt_canonical``).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.profiler import record_function

from .._captured import CapturedStep, StaticInputs, storage_tag
from .._device import resolve_device
from ..models.gpt import (_default_attention, _dropout, _fold, _flat_items,
                          run_blocks)
from ..observability.compile_watchdog import watch
from ..optimizer.optimizer import bias_correction, device_scalar
from ..profiler.profiler import RecordEvent
from .model_adapter import GPTAdapter, ModelAdapter

__all__ = ["HybridEngine", "EngineConfig"]


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
                 engine_cfg: EngineConfig = None, device=None):
        """``cfg``: a model config (GPTConfig trains through GPTAdapter)
        or a ``ModelAdapter`` (``BertAdapter(BertConfig)`` for BERT).
        Entry point: runs on CUDA unless ``device`` says otherwise.
        ``sep > 1`` trains with ring sequence parallelism on this one
        device when ``cfg.seq_parallel == "ring"``."""
        self.model = cfg if isinstance(cfg, ModelAdapter) else GPTAdapter(cfg)
        self.cfg = self.model.cfg
        if self.cfg.seq_parallel not in ("ulysses", "ring"):
            raise ValueError(
                f"unknown seq_parallel {self.cfg.seq_parallel!r}")
        self.sep, self.mp = sep, mp
        self.model.validate(self)
        axes = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep,
                "mp": mp, "ep": ep}
        multi = {k: n for k, n in axes.items() if n != 1
                 and not (k == "sep" and self.cfg.seq_parallel == "ring")}
        if multi:
            raise NotImplementedError(
                f"parallel axes {multi} are not ported yet: this engine "
                f"trains on one GPU (sep > 1 with seq_parallel='ring' "
                f"included), and dp/pp/sharding/mp/ep > 1 and Ulysses "
                f"sep > 1 are the multi-GPU slice of the port")
        self.ec = engine_cfg or EngineConfig()
        self.device = resolve_device(device)
        # the step's static inputs and device scalars, and the watched
        # step: one capture per engine (CUDA)
        self._inputs = StaticInputs(self.device, torch.long)
        self._lr = device_scalar(0.0, self.device)
        self._step = device_scalar(0, self.device)
        self._key = torch.zeros((), dtype=torch.long, device=self.device)
        body = weakref.WeakMethod(self._step_body)
        self._step_fn = watch(
            CapturedStep(lambda *a: body()(*a), self.device,
                         empty_cache=True),
            name="hybrid_engine::step")

    @property
    def captures(self):
        """CUDA graphs this engine has captured (0 on the CPU)."""
        return self._step_fn.captures

    @property
    def graph_pool_bytes(self):
        """Device memory the captured step's private pool holds (its
        activations and gradients; 0 before the capture and on the
        CPU)."""
        return self._step_fn.pool_bytes

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
        optimizer state for them."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(g, self.device)
        return params, self.init_opt(params)

    def init_opt(self, params):
        """Zero moments and (when kept) a master copy per leaf, in
        ``opt_dtype``; ``step`` is a Python int."""
        odt = self._opt_dtype()
        has_master = self._has_master()

        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            p = node.detach()
            slot = {"m": torch.zeros_like(p, dtype=odt),
                    "v": torch.zeros_like(p, dtype=odt)}
            if has_master:
                slot["master"] = p.to(odt, copy=True)
            return slot

        return {"step": 0, "slots": build(params)}

    def opt_canonical(self, opt_state, params):
        """``{"m", "v", "master"}`` trees of param-shaped tensors — the
        JAX engine's ``opt_canonical`` form.  Without a master slot the
        param is the master and is returned cast to ``opt_dtype``."""
        odt = self._opt_dtype()

        def pick(slots, p, name):
            if isinstance(p, dict):
                return {k: pick(slots[k], p[k], name) for k in p}
            if name == "master" and "master" not in slots:
                return p.detach().to(odt)
            return slots[name]

        return {name: pick(opt_state["slots"], params, name)
                for name in ("m", "v", "master")}

    def opt_from_canonical(self, canon, step=0):
        """Inverse of ``opt_canonical``: an optimizer state whose slots
        are copies of the canonical trees (cast to ``opt_dtype``), at
        step ``step`` (so a state carried over from JAX resumes with the
        bias correction of its next step)."""
        odt = self._opt_dtype()
        has_master = self._has_master()

        def build(m, v, master):
            if isinstance(m, dict):
                return {k: build(m[k], v[k], master[k]) for k in m}
            slot = {"m": m.to(self.device, odt, copy=True),
                    "v": v.to(self.device, odt, copy=True)}
            if has_master:
                slot["master"] = master.to(self.device, odt, copy=True)
            return slot

        return {"step": int(step),
                "slots": build(canon["m"], canon["v"], canon["master"])}

    # ------------------------------------------------------- forward pieces
    def _attention(self, q, k, v, causal=True):
        """Attention of one block, q/k/v ``[B, H, S, hd]`` over the whole
        sequence: ring attention over ``sep`` shards when sep > 1 (only
        ring reaches here), else flash where its gate allows and the
        naive route otherwise."""
        if self.sep > 1:
            from ..kernels.ring_attention import ring_attention

            return ring_attention(q, k, v, self.sep, causal=causal)
        return _default_attention(self.cfg, q, k, v, causal=causal)

    def _dropout(self, x, rate, seed):
        """Dropout on ``x [B, S, ...]``; at sep > 1 each of the ``sep``
        sequence shards draws its own mask, with its index folded into
        ``seed``."""
        if self.sep == 1 or seed is None or rate <= 0.0:
            return _dropout(x, rate, seed)
        return torch.cat([_dropout(c, rate, _fold(seed, i))
                          for i, c in enumerate(x.chunk(self.sep, dim=1))],
                         dim=1)

    def _embed_core(self, wte, wpe, tokens):
        """Embedding + position embedding, cast to the working dtype."""
        s = tokens.shape[1]
        return (wte[tokens] + wpe[:s]).to(self.cfg.torch_dtype())

    def tied_vocab_ce(self, x, wte, labels):
        """CE against the tied embedding, in sequence chunks.
        x ``[b, s, D]``; wte ``[V, D]``; labels ``[b, s]`` with -100 =
        ignore.  Returns (sum_loss, count).

        The number of chunks doubles while a chunk's fp32 logits exceed
        ``ce_block_elems`` and S still splits; each chunk runs under a
        checkpoint, so backward re-runs its head matmul instead of
        keeping its fp32 softmax alive.  The logits matmul runs in the
        working dtype and is cast to fp32 after, as in JAX."""

        def ce_chunk(xc, lc):
            logits = (xc @ wte.t()).float()
            logp = torch.log_softmax(logits, dim=-1)
            loss_tok = -logp.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
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

    def _local_loss(self, params, tokens, labels, seed=None):
        """Mean CE of one micro-batch, plus ``moe_aux_weight`` × the
        per-layer mean aux loss for a MoE model (the JAX step's
        ``_aux_mean`` is the identity on one device).  ``seed``: the
        dropout seed, already folded with the step and micro-batch
        (None: no dropout)."""
        cfg = self.cfg
        aux = {k: v for k, v in params.items() if k != "blocks"}
        x = self.model.embed(self, aux, tokens)
        if seed is not None:
            x = self._dropout(x, cfg.dropout, _fold(seed, 999983))

        def block_fn(bp, x, s):
            return self.model.block(self, bp, x, s)

        out, moe_aux = run_blocks(block_fn, params["blocks"], x, cfg.remat,
                                  seed)
        s, c = self.model.head_loss(self, aux, out, labels)
        loss = s / torch.clamp(c, min=1.0)
        if cfg.moe_experts:
            loss = loss + cfg.moe_aux_weight * moe_aux / cfg.num_layers
        return loss

    # ------------------------------------------------------------- the step
    def _windows(self, n):
        w = max(1, int(self.ec.opt_update_window))
        return [slice(lo, min(n, lo + w)) for lo in range(0, n, w)]

    def step(self, params, opt_state, tokens, labels, lr=None,
             dropout_seed=0):
        """One train step; returns ``(params, opt_state, loss)``.

        Where the JAX step donates its inputs and returns new arrays,
        this one updates ``params`` and ``opt_state`` in place and
        returns the same dicts, so the call reads like its counterpart;
        ``loss`` is a new 0-d fp32 tensor.  Param leaves are made to
        require grad.  ``dropout_seed`` varies the dropout masks per step
        (ignored when cfg.dropout == 0); the step counter is folded in as
        in JAX.  The optimizer update is the ``torch.profiler`` range
        ``engine::optimizer`` (visible on the eager route: a replayed
        graph records no ranges)."""
        tokens, labels = self._inputs(tokens, labels)
        S = tokens.shape[1]
        if self.sep > 1 and S % (self.sep * 128):
            raise ValueError(
                f"ring sequence parallelism splits S={S} into sep="
                f"{self.sep} shards of a multiple of 128 tokens each; "
                f"S % (sep * 128) must be 0")
        for _, t in _flat_items(params):
            if not t.requires_grad:
                t.requires_grad_(True)
        step = opt_state["step"] + 1
        self._step.fill_(step)
        self._lr.fill_(self.ec.lr if lr is None else lr)
        if self.cfg.dropout > 0.0:
            self._key.fill_(_fold(dropout_seed, opt_state["step"]))
        args = (params, opt_state["slots"], self._step, tokens, labels,
                self._lr, self._key)
        with RecordEvent("hybrid_engine::step"):
            loss = self._run(args)
        opt_state["step"] = step
        return params, opt_state, loss

    def _run(self, args):
        """The watched step (the graph's replay on CUDA); the loss is
        copied out of the graph's static output."""
        params, slots, *rest = args
        tag = storage_tag([t for tree in (params, slots)
                           for _, t in _flat_items(tree)] + rest)
        return self._step_fn(*args, storage=tag).clone()

    def _step_body(self, params, slots, step, tokens, labels, lr, key):
        """Grads, clip and the update: the captured step.  Reads every
        per-call value from a device tensor (``step``, ``lr``, ``key``)
        and writes params and slots in place; no host sync."""
        items = list(_flat_items(params))
        paths = [p for p, _ in items]
        leaves = [t for _, t in items]
        key = key if self.cfg.dropout > 0.0 else None
        loss, grads = self._grads(params, leaves, tokens, labels, key)
        with torch.no_grad(), record_function("engine::optimizer"):
            self._apply(paths, leaves, grads, slots, step, lr)
        return loss

    def _grads(self, params, leaves, tokens, labels, key):
        """(mean loss, grads): one backward pass, or ``accum_steps``
        micro-batches with the grads summed in fp32 and averaged."""
        accum = self.ec.accum_steps
        if accum == 1:
            loss = self._local_loss(params, tokens, labels, key)
            # grads keep their param's dtype (bf16 stays bf16)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            b = tokens.shape[0]
            if b % accum:
                raise ValueError(f"batch {b} must divide accum_steps "
                                 f"{accum}")
            mb = b // accum
            grads = [torch.zeros_like(t, dtype=torch.float32)
                     for t in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                rows = slice(i * mb, (i + 1) * mb)
                k = _fold(key, i) if key is not None else None
                l = self._local_loss(params, tokens[rows], labels[rows], k)
                for acc, g in zip(grads, torch.autograd.grad(l, leaves)):
                    acc.add_(g.float())
                loss = loss + l.detach()
            loss = loss / accum
            grads = [g / accum for g in grads]
        return loss, grads

    def _apply(self, paths, leaves, grads, slots, step, lr):
        """Global-norm clip and the Adam update, in place; ``step`` and
        ``lr`` are 0-d fp32 device tensors."""
        ec = self.ec
        # --- global-norm clip: squares summed in fp32, grads keep their
        # dtype ((g * scale) is rounded back to it, as JAX does) ---
        scale = None
        if ec.grad_clip and ec.grad_clip > 0:
            gn_sq = torch.zeros((), dtype=torch.float32, device=self.device)
            for g in grads:
                flat = g.view(-1)
                for sl in self._windows(flat.numel()):
                    gn_sq += flat[sl].float().square().sum()
            gnorm = torch.sqrt(gn_sq)
            scale = torch.clamp(ec.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)

        b1, b2 = ec.beta1, ec.beta2
        bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)
        eps, decay = ec.eps, ec.weight_decay
        has_master = self._has_master()

        for path, p, g in zip(paths, leaves, grads):
            slot = slots
            for k in path.split("/"):
                slot = slot[k]
            decay_on = bool(decay) and self.model.decay_this(path)
            pf, gf = p.detach().view(-1), g.view(-1)
            m, v = slot["m"].view(-1), slot["v"].view(-1)
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
