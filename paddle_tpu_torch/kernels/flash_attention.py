"""Flash attention — softmax(Q Kᵀ·scale) V with a per-row logsumexp, and
its backward (the port of ``paddle_tpu/kernels/flash_attention.py``).

Three TPU kernels, each beside its plain PyTorch version:

- forward (``_fwd_kernel``): O and the fp32 row logsumexp ``lse``;
- backward dK/dV (``_bwd_dkdv_kernel``) and dQ (``_bwd_dq_kernel``):
  recompute P = exp(s − lse) tile by tile with δ = rowsum(dO∘O).

The plain versions (``_flash_fwd_ref``, ``_flash_bwd_ref``) compute the
same formulas over the whole [S, S] score matrix in fp32.  The CUDA
kernels are built with ``nvcc`` for ``sm_90a`` at first use and called
through ctypes.  bf16 inputs: the forward is ``csrc/flash_fwd_sm90.cu``
and the backward (dQ, dK and dV in one launch) ``csrc/flash_bwd_sm90.cu``,
both wgmma and TMA, warp specialised; the backward adds dQ into a zeroed
fp32 buffer across key tiles, so dQ on the card is not bit-reproducible
from run to run (the order of the fp32 sums varies; well inside the bf16
tolerance).  fp32 inputs: the scalar forward, dK/dV and dQ kernels of
``csrc/flash_attention.cu``.  ``_Flash`` binds the
forward and backward as one ``torch.autograd.Function`` (the JAX
package's ``_flash`` custom VJP): on CPU tensors it runs the plain
versions, on CUDA tensors the kernels, and there is no fallback from one
to the other.  The forward it calls is the operator
``torch.ops.paddle_tpu_torch.flash_fwd`` (``flash_fwd``), so that an
exported program (``jit``) holds the operator and picks the route by the
device it runs on.

Layouts: q, k, v, out, dO ``[B, H, S, D]`` in fp32 or bf16; ``lse``
``[B, H, S]`` fp32.  Math is fp32 on both paths.  The kernels are
instantiated for D ∈ ``HEAD_DIMS`` = {32, 64, 128, 256, 512}, and the fp32
ones take any multiple of 512 as well, in 512-column chunks (the scores
and dP = dO·Vᵀ summed over the chunks, each output chunk from its own
columns, one grid slice a chunk, all on one lse and δ).  Any other D is
zero-padded up to the next of them (past 512, the next multiple of 512)
and the result sliced back, which is exact (zero columns add nothing to
q·k and give zero output and gradient columns; the scale stays that of
the real D).  Routing by shape, not a fallback: the bf16 kernels take
D ≤ 256, so bf16 inputs with D > 256 are cast up to fp32, run through
the fp32 kernels (D = 512 tiles of 16 rows) and rounded back to bf16.
The JAX ``flash_attention`` computes any D too, but its gate refuses
D > 256, so no caller of either package reaches D > 256 through the gate.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "flash_attention_available",
           "flash_attention_plain", "flash_fwd", "launches", "captured"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernels are instantiated for (512: fp32 only, and
#: every multiple of 512 in chunks of 512)
HEAD_DIMS = (32, 64, 128, 256, 512)
#: the widest head dim of the bf16 kernels; wider bf16 runs in fp32
BF16_MAX_HEAD_DIM = 256

#: kernel launches since the counts were last set to 0 (CUDA path only):
#: ``fwd`` every forward kernel, ``bwd`` every backward kernel (a bf16
#: backward is one launch; an fp32 one launches its dK/dV and its dQ
#: kernel, two, and so does a ring pair with fp32 q/k/v).  A call made
#: while its stream is being captured launches nothing and counts in
#: ``captured`` instead; whoever replays the graph adds its captured
#: calls to ``launches`` at each replay (``paddle_tpu_torch/_captured.py``)
launches = {"fwd": 0, "bwd": 0}
captured = {"fwd": 0, "bwd": 0}
_COUNTS = (launches, captured)


# --------------------------------------------------------------- reference


def _scores(q, k, scale, causal):
    """fp32 s = q kᵀ · scale with the causal mask applied (−1e30)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[2]
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


def _flash_fwd_ref(q, k, v, scale, causal):
    """Plain forward: (out in q's dtype, lse [B, H, S] fp32).  The
    ``l == 0 → 1`` guard is the kernel's, so a fully masked row gives a
    zero output."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _delta(out, do):
    """δ = rowsum(dO∘O) in fp32, ``[B, H, S]`` — outside the kernels, as
    in the JAX package."""
    return (do.float() * out.float()).sum(dim=-1)


def _bwd_p_ds(q, k, v, lse, delta, do, scale, causal):
    """The recompute both backward kernels share: P = exp(s − lse) and
    dS = P∘(dO vᵀ − δ)·scale, fp32."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal, dtype=None):
    """Plain dK/dV: dV = Pᵀ dO, dK = dSᵀ Q, in ``dtype`` (q's when
    None)."""
    p, ds = _bwd_p_ds(q, k, v, lse, delta, do, scale, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(dtype or q.dtype), dv.to(dtype or q.dtype)


def _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, dtype=None):
    """Plain dQ: dQ = dS K, in ``dtype`` (q's when None)."""
    _, ds = _bwd_p_ds(q, k, v, lse, delta, do, scale, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(dtype or q.dtype)


def _flash_bwd_ref(q, k, v, out, lse, do, scale, causal):
    """Plain backward: the two backward kernels' recompute formulas over
    the whole score matrix, δ computed inside.  Returns (dq, dk, dv) in
    q's dtype."""
    delta = _delta(out, do)
    dk, dv = _bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    return _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal), dk, dv


# ------------------------------------------------------------------ kernels


def _lib():
    from . import _build

    lib = _build.load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [ptr] * 5 + [i] * 3 + [f, i, ptr]
        lib.flash_bwd_dkdv_launch.argtypes = [ptr] * 8 + [i] * 3 + [f, i,
                                                                   ptr]
        lib.flash_bwd_dq_launch.argtypes = [ptr] * 7 + [i] * 3 + [f, i, ptr]
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkdv_launch,
                   lib.flash_bwd_dq_launch):
            fn.restype = ctypes.c_int
    return lib


def _lib_sm90():
    from . import _build

    lib = _build.load("flash_fwd_sm90")
    if lib.flash_fwd_sm90_launch.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_sm90_launch.argtypes = [ptr] * 5 + [i] * 3 + [f, i,
                                                                    ptr]
        lib.flash_fwd_sm90_launch.restype = ctypes.c_int
    return lib


def _lib_bwd_sm90():
    from . import _build

    lib = _build.load("flash_bwd_sm90")
    if lib.flash_bwd_sm90_launch.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the flash backward and a ring pair's (one signature: the ring's
        # dq, dk and dv are fp32 sums the kernel adds into)
        for fn in (lib.flash_bwd_sm90_launch, lib.ring_pair_bwd_sm90_launch):
            fn.argtypes = [ptr] * 9 + [i] * 3 + [f, i, ptr]
            fn.restype = ctypes.c_int
    return lib


def _pad_head_dim(*ts, least=0):
    """``ts`` ``[..., D]`` zero-padded on the head dim to the smallest
    size in ``HEAD_DIMS`` that holds D and ``least``, past 512 to the next
    multiple of 512 (unchanged when D is that size)."""
    D = ts[0].shape[-1]
    n = next((n for n in HEAD_DIMS if n >= max(D, least)),
             -(-D // HEAD_DIMS[-1]) * HEAD_DIMS[-1])
    return ts if n == D else tuple(F.pad(t, (0, n - D)) for t in ts)


def _unpad_head_dim(D, *ts):
    """The first ``D`` columns of each padded result, contiguous."""
    return tuple(t if t.shape[-1] == D else t[..., :D].contiguous()
                 for t in ts)


def _check_cuda(q, k, v, *rest):
    for t in (q, k, v) + rest:
        if t.device != q.device:
            raise ValueError("flash_attention: inputs on different devices")
        if t.dtype not in (q.dtype, torch.float32) or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernels take contiguous, "
                             "16-byte aligned tensors of q's dtype (lse "
                             "and delta fp32)")


def _launch(counts, name, fn, *args):
    """Call the C entry ``fn`` on the current stream with tensors passed
    as device pointers; raise on a non-zero CUDA error, else count the
    call in ``counts``, a ``(launches, captured)`` pair: in
    ``launches[name]``, or in ``captured[name]`` while the stream is
    being captured (nothing launches then)."""
    q = args[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    counts[torch.cuda.is_current_stream_capturing()][name] += 1


def _wide_bf16(q):
    """bf16 inputs whose head dim only the fp32 kernels take."""
    return q.dtype == torch.bfloat16 and q.shape[-1] > BF16_MAX_HEAD_DIM


def _flash_fwd_cuda(q, k, v, scale, causal):
    """bf16: the wgmma/TMA kernel, which takes D ∈ {64, 128, 256} (D = 32
    pads to 64) and a scale ≥ 0 (it takes the row max before scaling; a
    negative scale runs as −K with |scale|, which is exact); fp32, and
    bf16 with D > 256: the scalar kernel."""
    if _wide_bf16(q):
        out, lse = _flash_fwd_cuda(q.float(), k.float(), v.float(), scale,
                                   causal)
        return out.to(q.dtype), lse
    D = q.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    if bf16 and scale < 0:
        k, scale = -k, -scale
    q, k, v = _pad_head_dim(q, k, v, least=64 if bf16 else 0)
    _check_cuda(q, k, v)
    B, H, S, Dk = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel():
        if bf16:
            _launch(_COUNTS, "fwd", _lib_sm90().flash_fwd_sm90_launch, q, k,
                    v, out, lse, B * H, S, Dk, float(scale), int(causal))
        else:
            _launch(_COUNTS, "fwd", _lib().flash_fwd_launch, q, k, v, out,
                    lse, B * H, S, Dk, float(scale), int(causal))
    return _unpad_head_dim(D, out)[0], lse


def _bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal):
    """fp32: (dk, dv) from the scalar dK/dV kernel."""
    D = q.shape[-1]
    q, k, v, do = _pad_head_dim(q, k, v, do)
    _check_cuda(q, k, v, do, lse, delta)
    B, H, S, Dk = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        _launch(_COUNTS, "bwd", _lib().flash_bwd_dkdv_launch, q, k, v, do,
                lse, delta, dk, dv, B * H, S, Dk, float(scale), int(causal))
    return _unpad_head_dim(D, dk, dv)


def _bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal):
    """fp32: dq from the scalar dQ kernel."""
    D = q.shape[-1]
    q, k, v, do = _pad_head_dim(q, k, v, do)
    _check_cuda(q, k, v, do, lse, delta)
    B, H, S, Dk = q.shape
    dq = torch.empty_like(q)
    if q.numel():
        _launch(_COUNTS, "bwd", _lib().flash_bwd_dq_launch, q, k, v, do,
                lse, delta, dq, B * H, S, Dk, float(scale), int(causal))
    return _unpad_head_dim(D, dq)[0]


def _bwd_sm90(q, k, v, do, lse, delta, scale, causal):
    """bf16, D ≤ 256: (dq, dk, dv) from the one wgmma/TMA kernel, which
    takes D ∈ {64, 128, 256} (D = 32 pads to 64).  dQ is summed over the
    key tiles into a zeroed fp32 buffer and rounded to bf16 here; the
    zeroing and the rounding are part of the call."""
    D = q.shape[-1]
    q, k, v, do = _pad_head_dim(q, k, v, do, least=64)
    _check_cuda(q, k, v, do, lse, delta)
    B, H, S, Dk = q.shape
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        _launch(_COUNTS, "bwd", _lib_bwd_sm90().flash_bwd_sm90_launch, q,
                k, v, do, lse, delta, dq_acc, dk, dv, B * H, S, Dk,
                float(scale), int(causal))
    return _unpad_head_dim(D, dq_acc.to(q.dtype), dk, dv)


def _flash_bwd_cuda(q, k, v, out, lse, do, scale, causal):
    """(dq, dk, dv) in q's dtype: bf16 (D ≤ 256) from the fused kernel in
    one launch, fp32 (and bf16 with D > 256, cast up) from the scalar
    dK/dV and dQ kernels; δ = rowsum(dO∘O) is computed here, outside the
    kernels, as in the JAX package."""
    if _wide_bf16(q):
        grads = _flash_bwd_cuda(q.float(), k.float(), v.float(), out, lse,
                                do.float(), scale, causal)
        return tuple(g.to(q.dtype) for g in grads)
    do = do.to(q.dtype).contiguous()
    delta = _delta(out, do)
    if q.dtype == torch.bfloat16:
        return _bwd_sm90(q, k, v, do, lse, delta, scale, causal)
    dk, dv = _bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    return _bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal), dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The forward as a ``torch.library`` operator, ``(out, lse)``: the
    plain version on CPU tensors, the CUDA kernel on CUDA tensors (the
    dispatcher picks by device), and a fake version giving the shapes
    to a trace.  A program exported on the CPU (``jit.save``) holds this
    operator, not a route, so it launches the kernel when moved to the
    card: the counterpart of the JAX package's ``jax.export(...,
    platforms=["cpu", "tpu"])``."""
    return _flash_fwd_ref(q, k, v, scale, causal)


flash_fwd.register_kernel("cuda")(_flash_fwd_cuda)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _flash_fwd(q, k, v, scale, causal, plain=False):
    """(out, lse): the plain version when ``plain``, else the operator
    (the plain version on CPU tensors, the CUDA kernel on CUDA ones)."""
    if plain:
        return _flash_fwd_ref(q, k, v, scale, causal)
    return flash_fwd(q, k, v, float(scale), bool(causal))


def _flash_bwd(q, k, v, out, lse, do, scale, causal, plain=False):
    if plain or q.device.type == "cpu":
        return _flash_bwd_ref(q, k, v, out, lse, do, scale, causal)
    return _flash_bwd_cuda(q, k, v, out, lse, do, scale, causal)


class _Flash(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse), as the JAX ``_flash_fwd_rule``
    does; backward runs the backward kernel(s) (or the plain
    backward).  Every tensor it hands a kernel is allocated in the call,
    so a recompute under activation checkpointing launches the forward
    kernel again into fresh buffers."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_fwd(q, k, v, scale, causal, plain)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.plain = scale, causal, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do.contiguous(),
                                ctx.scale, ctx.causal, ctx.plain)
        return dq, dk, dv, None, None, None


# -------------------------------------------------------------- public API


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, H, S, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_available(q, k, v, mask, causal=False):
    """The JAX package's gate, kept as it is: no mask, equal [B, H, S, D]
    shapes, D ≤ 256, and S a multiple of 128 unless causal.  On the card
    the kernels take every D it admits (padded up to ``HEAD_DIMS``), and
    ``flash_attention`` called directly takes any D."""
    if mask is not None:
        return False
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        return False
    B, H, S, D = q.shape
    if D > 256:
        return False
    if S % 128 != 0 and not causal:
        return False
    return True


def flash_attention(q, k, v, causal=False, scale=None, block_q=512,
                    block_kv=1024):
    """q/k/v ``[B, H, S, D]`` → ``[B, H, S, D]``, differentiable.

    The JAX wrapper's behaviour is kept on purpose, so callers and tests
    see one contract:

    - causal inputs whose S is not a multiple of 128 give the JAX
      package's padded-then-sliced result (zero-padded keys lie after
      every real query, so they never enter a real row); the CUDA
      kernels mask the ragged tail in-kernel instead of padding;
    - the same non-causal inputs raise ``ValueError`` (padded keys would
      enter the softmax), as in JAX;
    - ``block_q``/``block_kv`` are the TPU kernel's VMEM tiles.  They are
      accepted and ignored: on the card each kernel uses its own tiles
      (128 queries × 128 keys, or × 64 at D = 256, in the bf16 forward;
      128 keys × 64 queries in the bf16 backward; 64 × 64 in the fp32
      kernels, 32 × 32 in their backward at D = 256 and 16 × 16 at
      D ≥ 512).

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    and count them in ``launches``."""
    del block_q, block_kv
    _check(q, k, v)
    S = q.shape[2]
    if S % 128 != 0 and not causal:
        raise ValueError(
            f"flash_attention requires seq_len % 128 == 0 for non-causal "
            f"attention, got S={S}; pad the sequence or gate on "
            f"flash_attention_available()")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, float(scale), bool(causal), False)


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """The same differentiable function through the plain versions on
    any device — what ``chip_smoke.py`` holds the kernels against
    (``gpt_block(..., attention=flash_attention_plain)``)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, float(scale), bool(causal), True)
