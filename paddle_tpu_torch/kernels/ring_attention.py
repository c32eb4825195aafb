"""Ring attention — sequence-parallel causal attention (the port of
``paddle_tpu/kernels/ring_attention.py``).

Each of ``sep`` ranks holds a contiguous shard of the sequence (rank
order) of Q, K and V, ``[B, H, s, D]`` with s = S / sep.  K/V blocks
travel around the ring; at ring step r rank i meets the block of rank
j = (i − r) mod sep and folds it into its own online-softmax state.
Causality across shards is block-triangular: a full pair when j < i,
the causal pair when j == i, nothing when j > i (no launch, where the
TPU computes zeros through ``lax.switch``).  Partial results merge by
logsumexp in fp32.

Backward (FlashAttention-2 style, a second pass round the ring): δ comes
from the final output and the fp32 dO; each pair recomputes P from the
ring-global lse, so its backward is the flash backward fed the global
lse and δ.  dQ sums per rank; dK/dV sum per visiting block in fp32, the
sums that ride the ring home.  The three sums are zeroed once a call and
every pair adds its terms into them in place.  Everything is cast to
q's dtype at the end.

Two layouts share the per-pair functions ``_pair_fwd`` and
``_pair_bwd``, which are rank-local.  On one device (``sep`` an int)
the shards are slices of the whole sequence and the rotation is an
index.  Across ranks (``sep`` the sep ``collective.Group``, one process
a rank holding its own shard) the rotation is a send: after each ring
step every rank passes its K/V block to the next rank and takes the
previous one's (one ``batch_isend_irecv``), and in the backward the
block's fp32 dK/dV sums travel with it, one more hop at the end to
bring each home, as the JAX ``ppermute``s do.

Kernels, on CUDA tensors (on CPU tensors each pair takes its plain
version, ``_pair_fwd_ref`` / ``_pair_bwd_ref``; there is no fallback
between the two):

- a pair's forward is the flash forward kernel
  (``flash_attention._flash_fwd``), causal for the diagonal pair and
  non-causal for a full pair; its output comes in q's dtype, as the TPU
  kernel's does, before the fp32 merge;
- a pair's backward with bf16 q/k/v and D ≤ 256 is one launch of
  ``ring_pair_bwd_sm90_launch`` (``csrc/flash_bwd_sm90.cu``, the bf16
  flash backward's wgmma + TMA kernel), counted in ``launches["pair_bwd"]``.
  It takes dO in bf16 and adds the pair's dQ, dK and dV into the ring's
  fp32 sums in place, each in a fixed order: dQ by TMA reduce-adds in
  key-tile order (as the flash backward's), dK and dV by the one thread
  that owns each element, so the pair gives the same bits on every run.  The ring rounds its fp32 dO to bf16 once a call:
  exact on the training path, where dO is the copy of a bf16 gradient,
  and one more 2⁻⁹-relative rounding per term, like P and dS, for an
  fp32 dO with more bits.  fp32 q/k/v take the scalar fp32 dK/dV and dQ
  kernels of ``csrc/flash_attention.cu`` (two launches, counted in
  ``flash_attention.launches["bwd"]``), whose outputs are added into the
  sums, and so do bf16 q/k/v with D > 256 (cast up to fp32 once a call).
  Every head dim runs on the card: as in ``flash_attention``, a D off the
  instantiated sizes is zero-padded once a call (q/k/v, dO and the sums),
  past 512 to a multiple of 512 that the fp32 kernels walk in
  512-column chunks.
"""
from __future__ import annotations

import math

import torch

from . import flash_attention as fa

__all__ = ["ring_attention", "launches", "captured"]

_NEG_INF = -1e30

#: launches of the bf16 pair backward kernel since the counts were last
#: set to 0 (CUDA path only); the pair forwards count in
#: ``flash_attention.launches["fwd"]``, the fp32 pair backwards in its
#: ``["bwd"]``.  Calls made under a CUDA-graph capture count in
#: ``captured``, as the flash wrappers' do
launches = {"pair_bwd": 0}
captured = {"pair_bwd": 0}
_COUNTS = (launches, captured)


# --------------------------------------------------------------- per pair


def _pair_fwd_ref(q, k, v, scale, causal):
    """Plain forward of one (Q shard, KV block) pair: (out, lse), both
    fp32 — what the JAX package runs per pair off the TPU."""
    s = fa._scores(q, k, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l[..., None], v.float())
    return out, m + torch.log(l)


def _pair_bwd_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain backward of one pair with the ring-global lse and δ:
    (dq, dk, dv) in fp32, by the two backward kernels' formulas."""
    f32 = torch.float32
    dk, dv = fa._bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal, f32)
    return (fa._bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, f32),
            dk, dv)


def _pair_operands(q, k, v, do):
    """q/k/v and dO as the pair backward kernels take them:
    bf16 with D ≤ 256 zero-padded to 64, 128 or 256; fp32 (and bf16 with
    D > 256, cast up) padded to ``flash_attention.HEAD_DIMS`` or a
    multiple of 512.  Exact: zero columns add nothing to the scores and
    give zero gradient columns."""
    if fa._wide_bf16(q):                 # D > 256: the fp32 kernels
        q, k, v, do = q.float(), k.float(), v.float(), do.float()
    return fa._pad_head_dim(q, k, v, do,
                            least=64 if q.dtype == torch.bfloat16 else 0)


def _pair_bwd_sm90(q, k, v, do, lse, delta, scale, causal, dq, dk, dv):
    """bf16 q/k/v/dO at D ∈ {64, 128, 256}: one launch that adds the
    pair's dQ, dK and dV into the fp32 sums ``dq``, ``dk``, ``dv``."""
    fa._check_cuda(q, k, v, do, lse, delta, dq, dk, dv)
    if do.dtype != q.dtype or q.shape[-1] not in (64, 128, 256) or any(
            t.shape != q.shape or t.dtype != torch.float32
            for t in (dq, dk, dv)):
        raise ValueError("the ring pair kernel takes bf16 q/k/v/dO at head "
                         "dim 64, 128 or 256 and fp32 sums of q's shape")
    B, H, S, D = q.shape
    if q.numel():
        fa._launch(_COUNTS, "pair_bwd",
                   fa._lib_bwd_sm90().ring_pair_bwd_sm90_launch, q, k, v, do,
                   lse, delta, dq, dk, dv, fa._dq_turns(q), B * H, S, D,
                   float(scale), int(causal))


def _on_cpu(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ring_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    return q.device.type == "cpu"


def _pair_fwd(q, k, v, scale, causal):
    """One pair's (out, lse): out in fp32 on the CPU (plain), in q's dtype
    from the flash forward kernel on the card; lse fp32."""
    if _on_cpu(q):
        return _pair_fwd_ref(q, k, v, scale, causal)
    return fa._flash_fwd(q, k, v, scale, causal)


def _pair_bwd(q, k, v, do, lse, delta, scale, causal, dq, dk, dv):
    """Add one pair's dQ, dK and dV, from the ring-global lse and δ, into
    the fp32 sums ``dq``, ``dk``, ``dv`` in place.  q/k/v/dO come as
    ``_pair_operands`` makes them (on the card bf16 needs it) and the
    sums at their width.  bf16 runs the one kernel that adds into the
    sums; fp32 the scalar dK/dV and dQ kernels, whose outputs are added
    here."""
    if _on_cpu(q):
        grads = _pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    elif q.dtype == torch.bfloat16:
        return _pair_bwd_sm90(q, k, v, do, lse, delta, scale, causal, dq, dk,
                              dv)
    else:
        grads = (fa._bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal),
                 *fa._bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal))
    for acc, t in zip((dq, dk, dv), grads):
        acc += t


# ------------------------------------------------------------- the ring


def _shards(t, sep, dtype=None):
    """``[B, H, S, ...]`` → ``[sep, B, H, S/sep, ...]``, contiguous, so
    that shard i is ``t_sh[i]``; one copy (cast to ``dtype`` on the way)."""
    x = t.unflatten(2, (sep, t.shape[2] // sep)).movedim(2, 0)
    return torch.empty(x.shape, dtype=dtype or t.dtype,
                       device=t.device).copy_(x)


def _unshard(t, dtype=None):
    """Inverse of ``_shards``, from any strided ``t``; one copy (cast to
    ``dtype`` on the way)."""
    x = t.movedim(0, 2)
    out = torch.empty((*x.shape[:2], x.shape[2] * x.shape[3],
                       *x.shape[4:]), dtype=dtype or t.dtype, device=t.device)
    out.view(x.shape).copy_(x)
    return out


def _schedule(sep):
    """(r, i, j) of every live pair in ring order: at step r rank i meets
    block j = (i − r) mod sep; pairs with j > i are skipped."""
    return [(r, i, (i - r) % sep) for r in range(sep) for i in range(sep)
            if (i - r) % sep <= i]


class _Ring(torch.autograd.Function):
    """Forward saves the shards of q, k, v, the output and the global
    lse, as the JAX ``_ring_fwd_rule`` does; backward runs the pair
    backward kernels, which add into the ring's fp32 sums.  Every tensor
    a kernel gets is allocated in the call, so a recompute under
    activation checkpointing launches the forward kernels again."""

    @staticmethod
    def forward(ctx, q, k, v, sep, scale):
        qs, ks, vs = (_shards(t, sep) for t in (q, k, v))
        acc = torch.zeros_like(qs, dtype=torch.float32)
        lse = torch.full(qs.shape[:-1], _NEG_INF, dtype=torch.float32,
                         device=q.device)
        for _, i, j in _schedule(sep):
            o, l = _pair_fwd(qs[i], ks[j], vs[j], scale, j == i)
            # logsumexp merge of rank i's running state with this pair,
            # in place: acc·e^(lse − lse') + o·e^(l − lse')
            lse_new = torch.logaddexp(lse[i], l)
            acc[i].mul_(torch.exp(lse[i] - lse_new)[..., None])
            acc[i].addcmul_(o, torch.exp(l - lse_new)[..., None])
            lse[i] = lse_new
        out = acc.to(q.dtype)
        ctx.save_for_backward(qs, ks, vs, out, lse)
        ctx.scale = scale
        return _unshard(out)

    @staticmethod
    def backward(ctx, g):
        qs, ks, vs, out, lse = ctx.saved_tensors
        sep, dtype, D = qs.shape[0], qs.dtype, qs.shape[-1]
        do = _shards(g, sep, dtype)
        # δ from the fp32 dO, as the JAX _ring_bwd_rule computes it
        delta = fa._delta(out, do if g.dtype == dtype else
                          _shards(g, sep, torch.float32))
        # at the kernels' width once a call (on the CPU too, where the
        # plain pairs take any width: the same path as on the card)
        qs, ks, vs, do = _pair_operands(qs, ks, vs, do)
        dq, dk, dv = (torch.zeros(qs.shape, dtype=torch.float32,
                                  device=qs.device) for _ in range(3))
        # ring order: each sum adds its terms in the order the JAX ring
        # adds them
        for _, i, j in _schedule(sep):
            _pair_bwd(qs[i], ks[j], vs[j], do[i], lse[i], delta[i],
                      ctx.scale, j == i, dq[i], dk[j], dv[j])
        return (*(_unshard(t[..., :D], dtype) for t in (dq, dk, dv)), None,
                None)


def _shift(tensors, group):
    """Every rank sends ``tensors`` to the next rank of ``group`` and
    returns what the previous one sent (new tensors).  The collective
    layer is imported here: this module loads before it."""
    from ..distributed.collective import ring_shift

    return ring_shift(tensors, group)


class _RingRanks(torch.autograd.Function):
    """The ring across the ranks of ``group``: this rank's q/k/v shard
    ``[B, H, s, D]`` (rank order = sequence order).  Forward and backward
    run the pairs of ``_schedule`` that land on this rank, in the same
    order; the K/V block at ring step r is rank (my − r)'s."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n, my = group.nranks, group.rank
        # the kernels take contiguous operands (q/k/v come as views of
        # the block's qkv product)
        q, k, v = (t.contiguous() for t in (q, k, v))
        acc = torch.zeros_like(q, dtype=torch.float32)
        lse = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32,
                         device=q.device)
        kv = (k, v)
        for r in range(n):
            j = (my - r) % n
            if j <= my:
                o, l = _pair_fwd(q, kv[0], kv[1], scale, j == my)
                lse_new = torch.logaddexp(lse, l)
                acc.mul_(torch.exp(lse - lse_new)[..., None])
                acc.addcmul_(o, torch.exp(l - lse_new)[..., None])
                lse = lse_new
            if r < n - 1:
                kv = _shift(kv, group)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, n = ctx.group, ctx.group.nranks
        my, dtype, D = group.rank, q.dtype, q.shape[-1]
        do = g.to(dtype).contiguous()
        delta = fa._delta(out, g.contiguous() if g.dtype == dtype else
                          g.float().contiguous())
        q, k, v, do = _pair_operands(q, k, v, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kk, vv = k, v
        dk = torch.zeros(kk.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for r in range(n):
            j = (my - r) % n
            if j <= my:
                _pair_bwd(q, kk, vv, do, lse, delta, ctx.scale, j == my,
                          dq, dk, dv)
            if r < n - 1:
                kk, vv, dk, dv = _shift((kk, vv, dk, dv), group)
            else:
                # one more hop brings each block's sums home
                dk, dv = _shift((dk, dv), group)
        return (dq[..., :D].to(dtype), dk[..., :D].to(dtype),
                dv[..., :D].to(dtype), None, None)


def ring_attention(q, k, v, sep, causal=True, scale=None, block_q=512,
                   block_kv=1024):
    """Causal attention over the whole sequence, computed as a ring of
    ``sep`` sequence shards.

    ``sep`` an int: q/k/v ``[B, H, S, D]`` hold the whole sequence on one
    device; rank i's shard is positions ``[i·S/sep, (i+1)·S/sep)``.
    ``sep`` a ``collective.Group`` (the JAX ``axis_name``): q/k/v are this
    rank's shard ``[B, H, S_local, D]``, the group's ranks holding the
    sequence in rank order.  As in the JAX wrapper: causal only
    (``NotImplementedError`` otherwise), and S_local a multiple of 128
    (``ValueError``).  ``block_q``/``block_kv`` (the TPU kernel's tiles)
    are accepted and ignored.  Differentiable; CPU tensors take the plain
    versions, CUDA tensors the kernels."""
    del block_q, block_kv
    if not causal:
        raise NotImplementedError(
            "ring_attention is causal-only; for non-causal, use "
            "flash_attention over the whole sequence")
    fa._check(q, k, v)
    if not isinstance(sep, int):
        if q.shape[2] % 128:
            raise ValueError(f"ring_attention needs S_local % 128 == 0, "
                             f"got {q.shape[2]}")
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        if sep.nranks == 1:
            return _Ring.apply(q, k, v, 1, float(scale))
        return _RingRanks.apply(q, k, v, sep, float(scale))
    S = q.shape[2]
    if sep < 1 or S % sep:
        raise ValueError(f"ring_attention splits S={S} into sep={sep} "
                         f"equal shards; S % sep must be 0")
    if (S // sep) % 128:
        raise ValueError(f"ring_attention needs S_local % 128 == 0, got "
                         f"S_local = {S} / {sep} = {S // sep}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, int(sep), float(scale))
