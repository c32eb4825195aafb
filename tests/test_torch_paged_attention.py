"""The port's ragged paged attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides.  The
JAX side runs as its own tests run it on the CPU: the gather reference
``_ragged_attention_ref`` and the Pallas kernel in interpret mode.  On
the CPU the port's wrapper takes its plain version; the CUDA kernel is
held against that plain version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).  fp32,
atol = rtol = 2e-5: the two sides sum in different orders."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.paged_attention import (
    _paged_attention_kernel as jax_paged_kernel,
    _paged_attention_ref as jax_paged_ref,
    _ragged_attention_kernel as jax_ragged_kernel,
    _ragged_attention_ref as jax_ragged_ref,
    paged_attention_available)
from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)

# mixed mid-prefill, prompt-completing, decode and idle rows; contexts
# straddle the page_size=4 boundary (7, 8, 9; 16, 17; 24)
CASES = [((5, 1, 3, 0), (7, 8, 9, 0)),
         ((6, 6, 1, 1), (7, 8, 9, 24)),
         ((1, 1, 1, 1), (4, 5, 16, 17))]


def _case(qlens, ctxs, Q=6, H=2, hd=8, P=12, ps=4, M=6, seed=2):
    rng = np.random.RandomState(seed)
    B = len(qlens)
    q = rng.standard_normal((B, Q, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, H, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, H, hd)).astype(np.float32)
    tables = np.stack([rng.permutation(P)[:M] for _ in range(B)]) \
        .astype(np.int32)
    return (q, kp, vp, tables, np.asarray(qlens, np.int32),
            np.asarray(ctxs, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port(args, scale):
    return pa._ragged_attention_ref(*_torch(*args), scale).numpy()


@pytest.mark.parametrize("qlens,ctxs", CASES)
def test_plain_matches_jax_reference(qlens, ctxs):
    args = _case(qlens, ctxs)
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    ref = jax_ragged_ref(*[jnp.asarray(a) for a in args], scale)
    out = _port(args, scale)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    # padded query slots and idle rows are exact zeros
    for b, ql in enumerate(qlens):
        assert not out[b, ql:].any()


@pytest.mark.parametrize("hd", [16, 17, 48, 80, 100, 320, 544, 1024])
def test_plain_matches_jax_reference_any_head_dim(hd):
    """Head dims off the kernel's 64/128-column chunks and past them (544
    and 1024 walk 5 and 8 chunks), which the CUDA kernel takes through
    zero-filled tails (and one-element loads where a row is not a
    multiple of 16 bytes): the plain version it is held against on the
    card equals the JAX reference on the CPU."""
    args = _case(*CASES[1], hd=hd, seed=hd)
    scale = 1.0 / np.sqrt(hd)
    ref = jax_ragged_ref(*[jnp.asarray(a) for a in args], scale)
    out = _port(args, scale)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    out = pa.ragged_paged_attention(*_torch(*args))      # the wrapper
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.skipif(not paged_attention_available(),
                    reason="pallas unavailable")
@pytest.mark.parametrize("qlens,ctxs", CASES)
def test_plain_matches_pallas_kernel_interpret(qlens, ctxs):
    args = _case(qlens, ctxs)
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    ker = jax_ragged_kernel(*[jnp.asarray(a) for a in args], scale,
                            interpret=True)
    np.testing.assert_allclose(_port(args, scale), np.asarray(ker), **TOL)


@pytest.mark.skipif(not paged_attention_available(),
                    reason="pallas unavailable")
def test_decode_entry_is_qlen1_row_and_matches_jax():
    q, kp, vp, tables, _, _ = _case([1, 1, 1], [9, 4, 0], Q=1)
    lens = np.asarray([9, 4, 0], np.int32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jargs = [jnp.asarray(a) for a in (q[:, 0], kp, vp, tables, lens)]
    ref = np.asarray(jax_paged_ref(*jargs, scale))
    ker = np.asarray(jax_paged_kernel(*jargs, scale, interpret=True))
    out = pa.paged_attention(*_torch(q[:, 0], kp, vp, tables, lens)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, ker, **TOL)
    assert not out[2].any()                      # inactive slot


def test_wrapper_takes_plain_version_on_cpu_without_a_launch():
    args = _case(*CASES[0])
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(*_torch(*args))      # default scale
    assert pa.ragged_paged_attention.launches == before
    np.testing.assert_array_equal(out.numpy(), _port(args, scale))
    # bf16 goes the same way and keeps its dtype
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in args[:3])
    out = pa.ragged_paged_attention(q, kp, vp, *_torch(*args[3:]))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrapper_rejects_other_dtypes(dtype):
    q, kp, vp, tb, ql, cl = _torch(*_case(*CASES[0]))
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q.to(dtype), kp.to(dtype), vp.to(dtype),
                                  tb, ql, cl)
    with pytest.raises(TypeError):                       # mixed dtypes
        pa.ragged_paged_attention(q, kp.bfloat16(), vp, tb, ql, cl)
    with pytest.raises(TypeError):                       # float indices
        pa.ragged_paged_attention(q, kp, vp, tb.float(), ql, cl)


def test_wrapper_rejects_bad_shapes_and_devices():
    q, kp, vp, tb, ql, cl = _torch(*_case(*CASES[0]))
    bad = [(q[0], kp, vp, tb, ql, cl),                   # q not 4-d
           (q, kp[..., :4], vp[..., :4], tb, ql, cl),    # head dim
           (q, kp, vp[:, :2], tb, ql, cl),               # k/v differ
           (q, kp, vp, tb[:2], ql, cl),                  # table rows
           (q, kp, vp, tb, ql[:2], cl)]                  # lens
    for args in bad:
        with pytest.raises(ValueError):
            pa.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pa.ragged_paged_attention(*(t.to("meta") for t in
                                    (q, kp, vp, tb, ql, cl)))



# ------------------------------------------- the kernel's split and merge


def _partial(q, k, v, pos, qpos, scale):
    """(m, l, acc) of the queries q [R, H, hd] over keys k/v [n, H, hd]
    at positions pos [n], query i seeing the keys at or before qpos[i]:
    m = -inf, l = 0 and acc = 0 where a query sees none, as in the
    kernel's online softmax."""
    R, H, hd = q.shape
    if not len(pos):
        return (torch.full((H, R), -np.inf), torch.zeros(H, R),
                torch.zeros(H, R, hd))
    s = torch.einsum("rhd,nhd->hrn", q, k) * scale
    s = torch.where((pos[None, :] <= qpos[:, None])[None], s, -np.inf)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(m == -np.inf, 0.0, m)[..., None])
    return m, p.sum(-1), torch.einsum("hrn,nhd->hrd", p, v)


def _merge(parts):
    """Merge (m, l, acc) partials in order: weights e^(m_i - M), and a
    partial with m = -inf weighs 0."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    out_l, out_acc = 0.0, 0.0
    for m, l, acc in parts:
        w = torch.where(M == -np.inf, 0.0, torch.exp(m - M))
        out_l = out_l + w * l
        out_acc = out_acc + w[..., None] * acc
    return M, out_l, out_acc


def _split_merge(q, kp, vp, tables, qlens, ctxs, scale, span, rows=16,
                 stage=64, warps=4):
    """The CUDA kernel's algorithm in plain PyTorch, used only here: tiles
    of ``rows`` query tokens; the kv axis cut into splits of ``span`` keys
    up to what the tile's last query sees; in each split, every ``stage``
    keys dealt to ``warps`` warps a slice each; a warp's (m, l, acc)
    merged over the warps, then the splits in order, and divided by l
    (l == 0 -> 1).  Padded slots and idle rows stay zeros."""
    B, Q, H, hd = q.shape
    ps, M = kp.shape[1], tables.shape[1]
    out = torch.zeros(B, Q, H, hd)
    for b in range(B):
        qlen, ctx = int(qlens[b]), min(int(ctxs[b]), M * ps)
        keys = kp[tables[b].long()].reshape(M * ps, H, hd).float()
        vals = vp[tables[b].long()].reshape(M * ps, H, hd).float()
        for t0 in range(0, Q, rows):
            t1 = min(t0 + rows, qlen, Q)
            if t0 >= t1:
                continue
            kv_len = ctx - qlen + t1
            nsplit = -(-kv_len // span) if kv_len > span else 1
            qpos = ctx - qlen + torch.arange(t0, t1)
            qs = q[b, t0:t1].float()
            splits = []
            for s in range(nsplit):
                kb, ke = s * span, min(s * span + span, kv_len)
                parts = []
                for w in range(warps):
                    pos = torch.tensor([k for k in range(kb, ke) if
                                        (k - kb) % stage // (stage // warps)
                                        == w], dtype=torch.long)
                    parts.append(_partial(qs, keys[pos], vals[pos], pos,
                                          qpos, scale))
                splits.append(_merge(parts))
            _, l, acc = _merge(splits)
            o = acc / torch.where(l == 0, 1.0, l)[..., None]      # [H, R, hd]
            out[b, t0:t1] = o.permute(1, 0, 2)
    return out.to(q.dtype)


# contexts on a split boundary and either side of it (for spans 16 and
# 64), a whole prompt in one chunk (qlen == ctx), idle rows, a chunk
# whose two query tiles end in different splits, one key
SPLIT_CASES = [((1, 1, 1, 0), (16, 17, 64, 0)),
               ((20, 0, 1, 3), (20, 0, 63, 65)),
               ((1, 18, 1, 0), (1, 40, 129, 0))]


@pytest.mark.parametrize("span", [1, 16, 64, 256, 1000])
@pytest.mark.parametrize("qlens,ctxs", SPLIT_CASES)
def test_split_and_merge_matches_jax_reference(qlens, ctxs, span):
    """The kernel's kv split and its merges (of the warps within a split,
    then of the splits in order, a split with no visible key weighing 0)
    reproduce the JAX reference: spans of one key, 16, 64, 256 and one
    longer than every context."""
    args = _case(qlens, ctxs, Q=24, hd=16, P=48, ps=4, M=40, seed=span)
    scale = 1.0 / np.sqrt(16)
    ref = np.asarray(jax_ragged_ref(*[jnp.asarray(a) for a in args], scale))
    out = _split_merge(*_torch(*args), scale, span).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    for b, ql in enumerate(qlens):
        assert not out[b, ql:].any()


@pytest.mark.parametrize("B,Q,H,hd,max_kv,want", [
    (8, 64, 16, 128, 2048, (8, 256)),       # the serving batch
    (8, 64, 16, 128, 100, (1, 256)),        # one split: no scratch
    (1, 2048, 16, 128, 2048, (2, 1024)),    # a long prefill: wider spans
    (1, 1, 1, 64, 1 << 20, (512, 2048)),    # at most 512 splits
])
def test_split_plan_follows_the_shapes(B, Q, H, hd, max_kv, want):
    """The wrapper's kv split, from the static shapes alone: spans of
    ``SPLIT_KEYS`` (a multiple of the kernel's 64-key stage), doubled
    while the partials would pass 64 MiB or the splits 512, and always
    covering every key."""
    splits, span = pa._splits(B, Q, H, hd, max_kv)
    assert (splits, span) == want
    assert span % 64 == 0 and splits * span >= max_kv
    assert splits == 1 or B * H * Q * splits * (hd + 2) * 4 <= 64 << 20
