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
ring-global lse, so its dK/dV and dQ kernels are the flash backward
kernels fed the global lse and δ.  dQ sums per rank; dK/dV sum per
visiting block in fp32, the sums that ride the ring home.  Everything is
cast to q's dtype at the end.

This module runs every rank on one device (the local layout): the shards
are slices of the whole sequence and the rotation is an index, not a
send.  The per-pair functions ``_pair_fwd`` and ``_pair_bwd`` are
rank-local, so a point-to-point ring over several GPUs calls them as
they are.

Kernels, on CUDA tensors (on CPU tensors each pair takes its plain
version, ``_pair_fwd_ref`` / ``_pair_bwd_ref``; there is no fallback
between the two):

- a pair's forward is the flash forward kernel
  (``flash_attention._flash_fwd``), causal for the diagonal pair and
  non-causal for a full pair; its output comes in q's dtype, as the TPU
  kernel's does, before the fp32 merge;
- a pair's backward is ``ring_pair_bwd_dkdv_launch`` and
  ``ring_pair_bwd_dq_launch`` of ``csrc/flash_attention.cu``: the flash
  backward kernels instantiated for an fp32 dO and fp32 dK/dV/dQ, counted
  in ``launches``.  bf16 q/k/v run on the tensor cores, which round dO to
  bf16 as it is staged (the choice over TF32): exact on the training
  path, where dO is the fp32 copy of a bf16 gradient, and one more
  2⁻⁹-relative rounding per term, like P and dS, for an fp32 dO with more
  bits.  fp32 q/k/v take the scalar fp32 kernels, with no rounding, and
  so do bf16 q/k/v with D > 256 (cast up; the outputs are fp32 anyway).
  Every head dim runs on the card: as in ``flash_attention``, a D off the
  instantiated sizes is zero-padded, past 512 to a multiple of 512 that
  the fp32 kernels walk in 512-column chunks.
"""
from __future__ import annotations

import math

import torch

from . import flash_attention as fa

__all__ = ["ring_attention", "launches"]

_NEG_INF = -1e30

#: kernel launches of the pair backward since the counts were last set
#: to 0 (CUDA path only); the pair forwards count in
#: ``flash_attention.launches["fwd"]``
launches = {"pair_bwd_dkdv": 0, "pair_bwd_dq": 0}


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


def _pair_bwd_launch(name, n_out, q, k, v, do, lse, delta, scale, causal):
    """Launch ``ring_<name>_launch`` on padded copies as needed; returns
    its ``n_out`` fp32 outputs, sliced back to q's head dim."""
    if do.dtype != torch.float32:
        raise TypeError(f"a ring pair's backward takes an fp32 dO, got "
                        f"{do.dtype}")
    if fa._wide_bf16(q):                 # D > 256: the fp32 kernels
        q, k, v = q.float(), k.float(), v.float()
    D = q.shape[-1]
    q, k, v, do = fa._pad_head_dim(q, k, v, do)
    fa._check_cuda(q, k, v, do, lse, delta)
    B, H, S, Dk = q.shape
    outs = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
            for _ in range(n_out)]
    if q.numel():
        fa._launch(launches, name, getattr(fa._lib(), f"ring_{name}_launch"),
                   q, k, v, do, lse, delta, *outs, B * H, S, Dk, float(scale),
                   int(causal), fa._DTYPES[q.dtype])
    return fa._unpad_head_dim(D, *outs)


def _pair_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal):
    """(dk, dv) fp32 of one pair from the dK/dV kernel."""
    return _pair_bwd_launch("pair_bwd_dkdv", 2, q, k, v, do, lse, delta,
                            scale, causal)


def _pair_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal):
    """dq fp32 of one pair from the dQ kernel."""
    return _pair_bwd_launch("pair_bwd_dq", 1, q, k, v, do, lse, delta,
                            scale, causal)[0]


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


def _pair_bwd(q, k, v, do, lse, delta, scale, causal):
    """One pair's (dq, dk, dv) in fp32 from the ring-global lse and δ;
    ``do`` fp32."""
    if _on_cpu(q):
        return _pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    dk, dv = _pair_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    return _pair_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal), dk, dv


# ------------------------------------------------------------- the ring


def _shards(t, sep, dtype=None):
    """``[B, H, S, ...]`` → ``[sep, B, H, S/sep, ...]``, contiguous, so
    that shard i is ``t_sh[i]``; one copy (cast to ``dtype`` on the way)."""
    x = t.unflatten(2, (sep, t.shape[2] // sep)).movedim(2, 0)
    return torch.empty(x.shape, dtype=dtype or t.dtype,
                       device=t.device).copy_(x)


def _unshard(t, dtype=None):
    """Inverse of ``_shards``."""
    x = t.movedim(0, 2)
    return x.reshape(*x.shape[:2], -1, *x.shape[4:]).to(dtype or t.dtype)


def _schedule(sep):
    """(r, i, j) of every live pair in ring order: at step r rank i meets
    block j = (i − r) mod sep; pairs with j > i are skipped."""
    return [(r, i, (i - r) % sep) for r in range(sep) for i in range(sep)
            if (i - r) % sep <= i]


class _Ring(torch.autograd.Function):
    """Forward saves the shards of q, k, v, the output and the global
    lse, as the JAX ``_ring_fwd_rule`` does; backward runs the pair
    backward kernels.  Every tensor a kernel gets is allocated in the
    call, so a recompute under activation checkpointing launches the
    forward kernels again."""

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
        sep = qs.shape[0]
        do = _shards(g, sep, torch.float32)
        delta = (do * out.float()).sum(dim=-1)
        dq, dk, dv = (torch.zeros_like(t, dtype=torch.float32)
                      for t in (qs, ks, vs))
        # ring order: each sum adds its terms in the order the JAX ring
        # adds them
        for _, i, j in _schedule(sep):
            dq_p, dk_p, dv_p = _pair_bwd(qs[i], ks[j], vs[j], do[i], lse[i],
                                         delta[i], ctx.scale, j == i)
            dq[i] += dq_p
            dk[j] += dk_p
            dv[j] += dv_p
        return (_unshard(dq, qs.dtype), _unshard(dk, ks.dtype),
                _unshard(dv, vs.dtype), None, None)


def ring_attention(q, k, v, sep, causal=True, scale=None, block_q=512,
                   block_kv=1024):
    """Causal attention over the whole sequence, computed as a ring of
    ``sep`` sequence shards.

    q/k/v: ``[B, H, S, D]``, the whole sequence on one device; rank i's
    shard is positions ``[i·S/sep, (i+1)·S/sep)``.  As in the JAX
    wrapper: causal only (``NotImplementedError`` otherwise), and S/sep
    a multiple of 128 (``ValueError``); S must split into ``sep``
    shards.  ``block_q``/``block_kv`` (the TPU kernel's tiles) are
    accepted and ignored.  Differentiable; CPU tensors take the plain
    versions, CUDA tensors the kernels."""
    del block_q, block_kv
    if not causal:
        raise NotImplementedError(
            "ring_attention is causal-only; for non-causal, use "
            "flash_attention over the whole sequence")
    fa._check(q, k, v)
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
