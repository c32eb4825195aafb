"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This
file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them; there ``tests/conftest.py`` (which imports jax)
is bypassed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: both sides compute in fp32, so fp32 differs by summation
order only (ragged paged attention 1e-5; flash attention, whose
backward sums up to S products of unit-variance terms, 1e-4) and bf16 by
one rounding of the output (atol 1e-2, rtol 1.6e-2)."""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}

# mid-prefill / prompt-completing / decode / idle rows, contexts
# straddling pages, and a row whose chunk spans two 16-query tiles
CASES = [((5, 1, 3, 0), (7, 8, 9, 0)),
         ((6, 6, 1, 1), (7, 8, 9, 24)),
         ((1, 1, 1, 1), (4, 5, 16, 17)),
         ((20, 1, 0, 18), (20, 33, 0, 40))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(qlens, ctxs, hd, Q=20, H=2, P=24, ps=4, M=10, seed=2):
    rng = np.random.RandomState(seed)
    B = len(qlens)
    arrays = (rng.standard_normal((B, Q, H, hd)).astype(np.float32),
              rng.standard_normal((P, ps, H, hd)).astype(np.float32),
              rng.standard_normal((P, ps, H, hd)).astype(np.float32),
              np.stack([rng.permutation(P)[:M] for _ in range(B)])
              .astype(np.int32),
              np.asarray(qlens, np.int32), np.asarray(ctxs, np.int32))
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("qlens,ctxs", CASES)
def test_kernel_matches_plain(cuda, qlens, ctxs, hd, dtype):
    q, kp, vp, tb, ql, cl = _case(qlens, ctxs, hd)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
    ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    for b, n in enumerate(qlens):                 # padded slots are zeros
        assert not out[b, n:].any()


@pytest.mark.cuda
def test_decode_entry_on_card(cuda):
    q, kp, vp, tb, _, _ = _case([1, 1, 1], [9, 4, 0], 128, Q=1)
    seq = torch.tensor([9, 4, 0], dtype=torch.int32, device=cuda)
    out = pa.paged_attention(q[:, 0], kp, vp, tb, seq)
    ref = pa._ragged_attention_ref(q, kp, vp, tb, (seq > 0).int(), seq)
    torch.testing.assert_close(out, ref[:, 0], **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 17, 48, 80, 100, 320, 512])
def test_kernel_any_head_dim(cuda, hd, dtype):
    """Head dims off the 64/128-column chunks (zero-filled tails; one-
    element loads where a row is not a multiple of 16 bytes: hd 17 in both
    dtypes, 100 in bf16) and past 128 (scores summed over head-dim chunks,
    one grid slice per output chunk), against the plain version."""
    for qlens, ctxs in (CASES[0], CASES[3]):
        q, kp, vp, tb, ql, cl = _case(qlens, ctxs, hd, seed=hd)
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
        ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        for b, n in enumerate(qlens):
            assert not out[b, n:].any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_load(cuda):
    """Head dims past 512 (544, 1024) run, in head-dim chunks, and equal
    the plain version in both dtypes; a dtype the kernel has no route for
    (fp16) raises."""
    for hd in (544, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tb, ql, cl = _case(*CASES[3], hd, seed=hd)
            q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
            out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
            ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == q.shape
            torch.testing.assert_close(out.float(), ref.float(),
                                       **TOL[dtype])
    q, kp, vp, tb, ql, cl = _case(*CASES[0], 32)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q.half(), kp.half(), vp.half(), tb, ql, cl)


def _serving_case(qlens, ctxs, dtype, hd=128, Q=64, H=2, P=320, ps=16,
                  M=128, seed=0):
    """Rows at the serving engine's widths (chunks of up to 64 queries,
    contexts up to 2048 over 16-token pages), few heads."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(qlens)
    q, kp, vp = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Q, H, hd), (P, ps, H, hd),
                               (P, ps, H, hd)))
    tb = torch.randint(0, P, (B, M), generator=g, device="cuda",
                       dtype=torch.int32)
    return (q, kp, vp, tb,
            torch.tensor(qlens, dtype=torch.int32, device="cuda"),
            torch.tensor(ctxs, dtype=torch.int32, device="cuda"))


SPAN = pa.SPLIT_KEYS
# contexts either side of a split boundary, one key, a 64-query chunk
# whose tiles end in different splits, all-decode rows at the longest
# context, idle rows among them
SPLIT_CASES = [((1, 1, 1, 1), (SPAN - 1, SPAN, SPAN + 1, 2 * SPAN)),
               ((1, 0, 1, 0), (1, 0, 2 * SPAN + 1, 5)),
               ((64, 1, 0, 64), (2048, 2048, 0, SPAN + 3)),
               ((1,) * 8, (2048,) * 8),
               ((64, 40, 16, 17), (64, 2 * SPAN, SPAN + 16, SPAN))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qlens,ctxs", SPLIT_CASES)
def test_kernel_split_boundaries(cuda, qlens, ctxs, dtype):
    """The kv split: tiles whose keys end just before, on and just after a
    split boundary, a single key, a prompt chunk of 64 queries at context
    2048 (its tiles merge 5 to 8 splits), all-decode rows at 2048 and idle
    rows: against the plain version, padded slots zeros."""
    args = _serving_case(qlens, ctxs, dtype, seed=sum(ctxs))
    assert pa._splits(len(qlens), 64, 2, 128, 2048) == (2048 // SPAN, SPAN)
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(*args)
    ref = pa._ragged_attention_ref(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    for b, n in enumerate(qlens):
        assert not out[b, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """One call captured in a CUDA graph and replayed with other query
    and context lengths written into the captured inputs: the kernel reads
    them on the device only, so each replay equals the plain version on
    that replay's inputs."""
    q, kp, vp, tb, ql, cl = _serving_case(SPLIT_CASES[2][0],
                                          SPLIT_CASES[2][1], dtype, seed=3)
    pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)        # build, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
    for qlens, ctxs in (c for c in SPLIT_CASES if len(c[0]) == len(ql)):
        ql.copy_(torch.tensor(qlens, dtype=torch.int32))
        cl.copy_(torch.tensor(ctxs, dtype=torch.int32))
        graph.replay()
        ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        for b, n in enumerate(qlens):
            assert not out[b, n:].any()


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda):
    """The whole serving path on ``tiny`` at fp32: greedy output on the
    card (kernel attention) equals the CPU run (plain attention), and
    the card run launched the kernel once per layer per step."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.serving import Engine, SamplingParams

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (5, 11, 3, 30)]
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(page_size=8, num_pages=64, max_batch_size=2, chunk_len=8)
    cpu = Engine(cfg, params, device="cpu", **kw).generate(prompts, sp)
    eng = Engine(cfg, {k: (v.cuda() if torch.is_tensor(v) else
                           {kk: vv.cuda() for kk, vv in v.items()})
                       for k, v in params.items()}, **kw)
    pa.ragged_paged_attention.launches = 0
    assert eng.generate(prompts, sp) == cpu
    assert pa.ragged_paged_attention.launches == cfg.num_layers * eng.steps


# ---------------------------------------------------- flash attention


FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}


def _bwd_launches(q):
    """Backward kernels one flash backward launches: bf16 with D <= 256
    one (dQ, dK, dV together), fp32 (and wider bf16) two (dK/dV, dQ)."""
    return 1 if q.dtype == torch.bfloat16 and q.shape[-1] <= 256 else 2


def _flash_case(S, D, dtype, B=2, H=2, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, S, D))
                             .astype(np.float32)).cuda().to(dtype)
            for _ in range(4)]                     # q, k, v, dO


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S,causal", [(1, True), (17, True), (64, True),
                                      (200, True), (256, True), (1, False),
                                      (17, False), (64, False),
                                      (256, False)])
def test_flash_kernels_match_plain(cuda, S, causal, D, dtype):
    """Forward (out, lse), dK/dV and dQ kernels against the plain
    versions on the same inputs; the backward kernels get the plain
    forward's out and lse, so each kernel is held on its own."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_case(S, D, dtype)
    scale = 1.0 / np.sqrt(D)
    before = dict(fa.launches)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, ref, ref_lse, do, scale,
                                    causal)
    rq, rk, rv = fa._flash_bwd_ref(q, k, v, ref, ref_lse, do, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": before["fwd"] + 1,
                           "bwd": before["bwd"] + _bwd_launches(q)}
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])
    for name, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_plain(cuda):
    """``flash_attention`` (kernels) and ``flash_attention_plain`` give
    the same output and grads through autograd."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_case(200, 64, torch.float32, seed=1)
    outs = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        outs.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_kernels_reject_other_head_dims(cuda):
    """Every D outside ``HEAD_DIMS`` runs zero-padded (D = 96 up to 128,
    D = 192 up to 256, D = 320 up to 512, D = 640 up to 1024; equal to the
    plain version), and so do D = 320, 512, 640 and 1024 past the JAX
    gate, through ``flash_attention`` and ``ring_attention`` with their
    gradients (bf16 runs them in fp32; past 512 in 512-column chunks)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = _ring_module()
    for D, dtype in ((96, torch.float32), (192, torch.float32),
                     (320, torch.float32), (320, torch.bfloat16),
                     (512, torch.float32), (512, torch.bfloat16),
                     (640, torch.float32), (640, torch.bfloat16),
                     (1024, torch.float32), (1024, torch.bfloat16)):
        q, k, v, do = _flash_case(128, D, dtype)
        assert fa.flash_attention_available(q, k, v, None,
                                            causal=True) == (D <= 256)
        for fns in ((fa.flash_attention, fa.flash_attention_plain),
                    (lambda *a, causal: ra.ring_attention(*a, sep=1),
                     fa.flash_attention_plain)):
            outs = []
            for fn in fns:
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = fn(*leaves, causal=True)
                out.backward(do)
                outs.append([out.detach()] + [t.grad for t in leaves])
            for a, b in zip(*outs):
                assert a.shape == b.shape == q.shape and a.dtype == dtype
                torch.testing.assert_close(a.float(), b.float(),
                                           **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 17, 200, 256])
def test_flash_kernels_wide_head_dims(cuda, S, causal, D, dtype):
    """128 < D ≤ 256 on every flash-family kernel: the forward, dK/dV and
    dQ, and a ring pair's dK/dV and dQ (fp32 dO and outputs, a
    ring-global lse), each against its plain version on the same
    inputs.  D = 192 runs zero-padded to 256."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = _ring_module()
    q, k, v, do = _flash_case(S, D, dtype, seed=S + D)
    scale = 1.0 / np.sqrt(D)
    before = dict(fa.launches)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, ref, ref_lse, do, scale,
                                    causal)
    rq, rk, rv = fa._flash_bwd_ref(q, k, v, ref, ref_lse, do, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": before["fwd"] + 1,
                           "bwd": before["bwd"] + _bwd_launches(q)}
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])
    for name, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert a.dtype == dtype and a.shape == q.shape, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype],
                                   msg=name)
    do32 = do.float()
    lse_g = ref_lse + np.log(2.0)          # as if merged with one more block
    delta = (do32 * ref.float()).sum(-1)
    before = dict(ra.launches)
    pk, pv = ra._pair_bwd_dkdv_cuda(q, k, v, do32, lse_g, delta, scale,
                                    causal)
    pq = ra._pair_bwd_dq_cuda(q, k, v, do32, lse_g, delta, scale, causal)
    want = ra._pair_bwd_ref(q, k, v, do32, lse_g, delta, scale, causal)
    torch.cuda.synchronize()
    assert ra.launches == {n: before[n] + 1 for n in before}
    for name, a, b in zip(("dq", "dk", "dv"), (pq, pk, pv), want):
        assert a.dtype == torch.float32 and a.shape == q.shape, name
        torch.testing.assert_close(a, b, **FLASH_TOL[dtype], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 17, 64, 200, 384, 2048])
def test_flash_forward_bf16_matches_plain(cuda, S, D, causal):
    """The bf16 forward (the training path's, the ``dots`` recompute's
    and every ring pair's) against ``_flash_fwd_ref``: out at the bf16
    tolerance, lse at the fp32 one, over ragged S, both masks and every
    instantiated head dim."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, _ = _flash_case(S, D, torch.bfloat16, seed=7 * S + D)
    scale = 1.0 / np.sqrt(D)
    before = fa.launches["fwd"]
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    torch.testing.assert_close(out.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_forward_bf16_any_scale(cuda, scale, causal):
    """The bf16 forward takes the row max before scaling, so a negative
    scale runs as −K with |scale| and a zero scale gives every live key
    the same weight: both equal the plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, _ = _flash_case(200, 64, torch.bfloat16, seed=13)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 17, 64, 200, 384, 2048])
def test_flash_backward_bf16_matches_plain(cuda, S, D, causal):
    """The bf16 backward (dQ, dK and dV in one wgmma/TMA kernel, one
    launch) against ``_bwd_dq_ref`` / ``_bwd_dkdv_ref`` at the bf16
    tolerance, over ragged S, both masks and every head dim it takes
    (D = 32 padded to 64).  dQ is summed with atomics, so it is held to
    the plain version, never to another run of itself."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_case(S, D, torch.bfloat16, seed=5 * S + D)
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    before = fa.launches["bwd"]
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, out, lse, do, scale, causal)
    rq, rk, rv = fa._flash_bwd_ref(q, k, v, out, lse, do, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches["bwd"] == before + 1
    for name, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        torch.testing.assert_close(a.float(), b.float(),
                                   **FLASH_TOL[torch.bfloat16], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_backward_bf16_any_scale(cuda, scale, causal):
    """The bf16 backward takes no row max, so any scale runs as it is: a
    negative one, and zero (every live key weighs the same).  At
    |scale| = 0.3 the dS terms are 2.4 times those of the default scale
    at this head dim, so the bf16 rounding of P and dS for the tensor
    cores alone moves dK by up to 0.027 (measured on an H100): the kernel
    is held to the plain formulas with P and dS rounded to bf16 where it
    rounds them."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_case(200, 64, torch.bfloat16, seed=17)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, scale, causal)
    p, ds = fa._bwd_p_ds(q, k, v, lse, fa._delta(out, do), do, scale,
                         causal)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    want = (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.float()))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b, **FLASH_TOL[torch.bfloat16],
                                   msg=name)


@pytest.mark.cuda
def test_ring_full_pair_forward_matches_plain(cuda):
    """A ring's full pair runs the bf16 forward non-causally at the shard
    length of the sep = 4 training path (s = 512): out and lse against
    the plain pair forward."""
    ra = _ring_module()
    q, k, v, _ = _flash_case(512, 128, torch.bfloat16, B=2, H=4, seed=11)
    scale = 1.0 / np.sqrt(128)
    out, lse = ra._pair_fwd(q, k, v, scale, False)
    ref, ref_lse = ra._pair_fwd_ref(q, k, v, scale, False)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """Two ``HybridEngine`` steps on ``tiny`` fp32 on the card (flash
    kernels) and on the CPU (plain versions): equal losses at 1e-4, and
    the card counted 2 forward launches per layer per step under
    ``dots`` (the forward and its recompute) and the fp32 backward's two
    kernels."""
    from paddle_tpu_torch.distributed import HybridEngine
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import GPT_CONFIGS

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (2, 100))
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], 1)
    losses = {}
    for dev in ("cpu", "cuda"):
        eng = HybridEngine(cfg, device=dev)
        params, opt = eng.init(seed=0)
        if dev == "cuda":
            params = {k: (v.to(dev) if torch.is_tensor(v) else
                          {kk: vv.to(dev) for kk, vv in v.items()})
                      for k, v in cpu_params.items()}
            opt = eng.init_opt(params)
            for n in fa.launches:
                fa.launches[n] = 0
        else:
            cpu_params = {k: (v.clone() if torch.is_tensor(v) else
                              {kk: vv.clone() for kk, vv in v.items()})
                          for k, v in params.items()}
        losses[dev] = [float(eng.step(params, opt, tokens, labels,
                                      lr=1e-3)[2]) for _ in range(2)]
    L = cfg.num_layers
    # fp32: each backward launches its dK/dV and its dQ kernel
    assert fa.launches == {"fwd": 2 * 2 * L, "bwd": 2 * 2 * L}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4,
                               rtol=1e-4)


# ----------------------------------------------------- ring attention


def _ring_module():
    import importlib

    return importlib.import_module("paddle_tpu_torch.kernels.ring_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_pair_kernels_match_plain(cuda, causal, D, dtype):
    """One ring pair's dK/dV and dQ kernels (fp32 dO, fp32 outputs)
    against ``_pair_bwd_ref`` with a ring-global lse and δ (the pair's
    merged with one more block).  bf16 q/k/v round P, dS and the fp32 dO
    to bf16 for the tensor cores: the bf16 tolerance."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = _ring_module()
    q, k, v, k2 = _flash_case(256, D, dtype, seed=D)
    v2, do = _flash_case(256, D, torch.float32, seed=D + 1)[:2]
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    _, lse2 = fa._flash_fwd_ref(q, k2, v2.to(dtype), scale, False)
    lse = torch.logaddexp(lse, lse2)
    delta = (do * out.float()).sum(-1)
    before = dict(ra.launches)
    dk, dv = ra._pair_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = ra._pair_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    want = ra._pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert ra.launches == {n: before[n] + 1 for n in before}
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == torch.float32 and a.shape == q.shape, name
        torch.testing.assert_close(a, b, **FLASH_TOL[dtype], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_attention_on_card_matches_flash(cuda, dtype):
    """``ring_attention`` over 4 shards against ``flash_attention`` on
    the whole sequence: output and grads at the flash tolerances, and 10
    live pairs launched (4 diagonal, 6 full) of each kernel."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = _ring_module()
    q, k, v, do = _flash_case(512, 64, dtype, seed=3)
    outs = []
    for fn in (lambda *a: ra.ring_attention(*a, sep=4),
               lambda *a: fa.flash_attention(*a, causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        outs.append([out.detach()] + [t.grad for t in leaves])
    fwd0, bwd0 = fa.launches["fwd"], dict(ra.launches)
    ra.ring_attention(*(t.clone().requires_grad_(True) for t in (q, k, v)),
                      sep=4).backward(do)
    assert fa.launches["fwd"] - fwd0 == 10
    assert ra.launches == {n: bwd0[n] + 10 for n in bwd0}
    for a, b in zip(*outs):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype])

