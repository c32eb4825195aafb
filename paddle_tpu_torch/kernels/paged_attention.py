"""Ragged paged attention — one fused prefill+decode attention over a
block-paged KV cache (the port of ``paddle_tpu/kernels/paged_attention.py``).

Row semantics: row ``b`` contributes ``query_lens[b]`` query tokens whose
keys/values have just been written to its pages, so its chunk occupies
absolute positions ``context_lens[b] - query_lens[b] ..
context_lens[b] - 1``.  Query token ``t`` attends causally to every kv
position ``<= context_lens[b] - query_lens[b] + t``.  ``query_lens[b] ==
0`` marks an idle row (output zeros).

Two implementations with one contract:

- ``_ragged_attention_ref`` — the plain PyTorch version: gather the
  pages, mask, fp32 softmax.  The CPU path and the numerics oracle the
  kernel is held against on the card.
- the CUDA kernel (``csrc/ragged_paged_attention.cu``), built with
  ``nvcc`` for ``sm_90a`` at first use and called through ctypes.  It
  takes every head dim (a stage holds a 64- or 128-column chunk of it)
  and reads the pool as it is allocated: 16 bytes a load where the rows
  and pointers allow it, one element a load otherwise (hd odd, or
  hd % 8 != 0 at bf16).  It splits the kv axis into spans of
  ``SPLIT_KEYS`` keys (``_splits``); a tile whose keys span several
  splits leaves fp32 partials in a scratch tensor that a second kernel
  merges.  The grid and the scratch follow from the shapes alone: a call
  reads no value of ``query_lens``, ``context_lens`` or ``page_tables``
  on the host, so it can be captured in a CUDA graph (the serving
  engine replays its whole step from one).  Inside a capture the scratch
  comes from the graph's private memory pool and stays there for the
  graph's life: at most ``_SCRATCH_BYTES`` a call, and the calls of one
  step reuse it.  The 16-byte-load choice (``vec16``) is made from the
  pointers the capture sees, which are the pointers every replay uses.

Launch counts: ``ragged_paged_attention.launches`` counts kernel
launches; a call made while the current stream is being captured
launches nothing and counts in ``ragged_paged_attention.captured``
instead.  Whoever replays the graph adds its captured calls to
``launches`` at each replay (``serving/engine.py``).

``ragged_paged_attention`` picks by device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.  There is no fallback
from one to the other.

Layouts:
  q            [B, Q, H, hd]        Q = max query tokens per row, padded
  k/v_pages    [P, page_size, H, hd] the shared page pool (one layer)
  page_tables  [B, max_pages] int32  physical page id per logical page
  query_lens   [B] int32             valid query tokens (0 = idle row)
  context_lens [B] int32             kv tokens incl. this chunk
Returns [B, Q, H, hd] in q.dtype; padded query slots and idle rows
return zeros.

``paged_attention`` (the decode-only entry: one query token per row,
``seq_lens`` masking) is the Q == 1 degenerate case of the same function.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["ragged_paged_attention", "paged_attention",
           "paged_attention_available"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys one block of the CUDA kernel walks: its span of the kv axis
SPLIT_KEYS = 256
#: the partials of a split call may take this much fp32 scratch before
#: the span widens
_SCRATCH_BYTES = 64 << 20
#: splits whose merge weights fit the combine kernel's shared memory
_MAX_SPLITS = 512


def paged_attention_available():
    """Whether the CUDA kernel can be built and launched here: a card
    and ``nvcc``.  Without them the wrapper takes its plain version on
    CPU tensors (and raises on CUDA ones)."""
    from ._build import _nvcc

    if not torch.cuda.is_available():
        return False
    try:
        _nvcc()
    except RuntimeError:
        return False
    return True


# ---------------------------------------------------------------- reference


def _ragged_attention_ref(q, k_pages, v_pages, page_tables, query_lens,
                          context_lens, scale=None):
    """Gather-then-mask oracle: [B, max_kv] dense view of the pages with
    the per-row causal mask applied at each query token's absolute
    position.  Takes the wrapper's arguments, so it can stand in for it
    (``gpt_ragged_step(..., attention=_ragged_attention_ref)``)."""
    B, Q, H, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    page_size = k_pages.shape[1]
    max_pages = page_tables.shape[1]
    tables = page_tables.long()
    qlens = query_lens.long()
    ctxs = context_lens.long()
    k = k_pages[tables].reshape(B, max_pages * page_size, H, hd)
    v = v_pages[tables].reshape(B, max_pages * page_size, H, hd)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    t = torch.arange(max_pages * page_size, device=q.device)
    tq = torch.arange(Q, device=q.device)
    # query token tq of row b sits at absolute position ctx - q_len + tq
    pos = (ctxs - qlens)[:, None] + tq[None, :]                    # [B, Q]
    ok = ((t[None, None, :] <= pos[:, :, None])
          & (tq[None, :, None] < qlens[:, None, None]))
    s = torch.where(ok[:, None], s, _NEG_INF)
    # fp32 softmax; fully-masked rows (padded query slots / idle rows)
    # yield uniform junk — zeroed below rather than divided by 0
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,bthd->bqhd", p, v.float())
    out = torch.where((tq[None, :] < qlens[:, None])[:, :, None, None],
                      out, 0.0)
    return out.to(q.dtype)


# ------------------------------------------------------------------- kernel


def _kernel_fn():
    from . import _build

    lib = _build.load("ragged_paged_attention")
    fn = lib.ragged_paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _splits(B, Q, H, hd, max_kv):
    """(splits, span) of the kv axis for these static shapes: spans of
    ``SPLIT_KEYS`` keys, doubled while the partials would pass 64 MiB of
    scratch or the splits ``_MAX_SPLITS``.  Prefill-heavy shapes (large Q)
    get fewer, longer splits: their query tiles already fill the card."""
    span = SPLIT_KEYS
    while True:
        splits = -(-max_kv // span)
        if splits == 1 or (splits <= _MAX_SPLITS and
                           B * H * Q * splits * (hd + 2) * 4
                           <= _SCRATCH_BYTES):
            return splits, span
        span *= 2


def _ragged_attention_cuda(q, k_pages, v_pages, page_tables, query_lens,
                           context_lens, scale):
    B, Q, H, hd = q.shape
    P, page_size = k_pages.shape[:2]
    max_pages = page_tables.shape[1]
    # 16-byte loads where every row and base pointer allows them
    vec16 = (hd * q.element_size() % 16 == 0
             and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, span = _splits(B, Q, H, hd, max_pages * page_size)
    # m, l and acc of every (row, head, query, split), when there are
    # splits to merge
    part = torch.empty(B * H * Q * splits * (hd + 2) if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_tables.data_ptr(), query_lens.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(),
                part.data_ptr() if splits > 1 else None, B, Q, H, hd,
                page_size, max_pages, P, splits, span, float(scale),
                _DTYPES[q.dtype], int(vec16), stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        ragged_paged_attention.captured += 1
    else:
        ragged_paged_attention.launches += 1
    return out


# -------------------------------------------------------------- public API


def _check(q, k_pages, v_pages, page_tables, query_lens, context_lens):
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("q must be [B, Q, H, hd] and k/v_pages "
                         "[P, page_size, H, hd]")
    B, _, H, hd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (H, hd):
        raise ValueError(f"k/v_pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be [B={B}, max_pages], got "
                         f"{tuple(page_tables.shape)}")
    if query_lens.shape != (B,) or context_lens.shape != (B,):
        raise ValueError("query_lens and context_lens must be [B]")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"ragged_paged_attention takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    for t in (page_tables, query_lens, context_lens):
        if t.dtype.is_floating_point or t.dtype.is_complex:
            raise TypeError("page_tables, query_lens and context_lens must "
                            "be integer tensors")
    devices = {t.device for t in (q, k_pages, v_pages, page_tables,
                                  query_lens, context_lens)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return devices.pop()


def ragged_paged_attention(q, k_pages, v_pages, page_tables, query_lens,
                           context_lens, scale=None):
    """Fused prefill+decode attention over a paged KV cache (see module
    docstring for layouts).  CPU tensors take the plain PyTorch version;
    CUDA tensors launch the hand-written kernel (and count one launch in
    ``ragged_paged_attention.launches``, or one captured call in
    ``.captured`` under a CUDA-graph capture) or raise."""
    device = _check(q, k_pages, v_pages, page_tables, query_lens,
                    context_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if device.type == "cpu":
        return _ragged_attention_ref(q, k_pages, v_pages, page_tables,
                                     query_lens, context_lens, scale)
    if device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cpu or cuda "
                         f"tensors, got {device}")
    return _ragged_attention_cuda(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        page_tables.to(torch.int32).contiguous(),
        query_lens.to(torch.int32).contiguous(),
        context_lens.to(torch.int32).contiguous(), scale)


#: calls that launched the kernel since the count was last set to 0 (CUDA
#: path only; a call whose tiles span several splits also launches the
#: combine, which is not counted apart), replays of captured calls
#: included
ragged_paged_attention.launches = 0
#: calls recorded into a CUDA graph under capture (launched at replay)
ragged_paged_attention.captured = 0


# ------------------------------------------- decode (Q == 1) degenerate


def paged_attention(q, k_pages, v_pages, page_tables, seq_lens, scale=None):
    """Single-token decode attention over a paged KV cache: q [B, H, hd],
    one query token per sequence attending over its first ``seq_lens``
    kv tokens — the query_len == 1 row of the ragged function (seq_len 0
    marks an inactive slot)."""
    qlens = (seq_lens > 0).to(seq_lens.dtype)
    return ragged_paged_attention(q[:, None], k_pages, v_pages, page_tables,
                                  qlens, seq_lens, scale)[:, 0]
