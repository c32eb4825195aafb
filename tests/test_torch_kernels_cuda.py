"""The port's CUDA kernels on the card, against their plain versions, and
what the serving engine and fleet do on the card alone (the step making
no host sync, the engine's captured step replayed on other batches and
captured again when its tensors move, a bitflip flipping a CUDA pool in
place, device memory following the engines a fleet holds); the MoE
block on the card against its CPU result, and flash attention at
BERT-base's non-causal head dim 64.

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
import torch.nn.functional as F

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


def _random_step(rng, cfg, B, T, M, P, Q):
    """One packed step of random rows (chunks, decode rows, idle rows,
    padding) over ``P`` pages: the engine's host arrays."""
    qlens = np.zeros(B, np.int32)
    ctxs = np.zeros(B, np.int32)
    rows = np.full(T, B, np.int32)
    slots = np.zeros(T, np.int32)
    tables = np.zeros((B, M), np.int32)
    off = 0
    pages = rng.permutation(P)
    for b in range(B):
        q = int(rng.choice([0, 1, rng.randint(1, Q + 1)]))
        q = min(q, T - off)
        if q == 0:
            continue
        ctx = int(rng.randint(q, M * 4 + 1))
        qlens[b], ctxs[b] = q, ctx
        rows[off:off + q] = b
        slots[off:off + q] = np.arange(q)
        tables[b] = pages[b * M:(b + 1) * M]
        off += q
    tokens = rng.randint(0, cfg.vocab_size, T).astype(np.int32)
    return tokens, rows, slots, qlens, ctxs, tables


@pytest.mark.cuda
@pytest.mark.parametrize("experts", [0, 4])
def test_ragged_step_makes_no_host_sync(cuda, experts):
    """``gpt_ragged_step`` (the MoE branch too) on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the step
    waits for the device."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.models.gpt import gpt_ragged_step

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], moe_experts=experts)
    params = gpt_init(cfg, device=cuda)
    rng = np.random.RandomState(1)
    B, T, M, P, Q = 4, 24, 8, 40, 8
    step = [torch.from_numpy(a).to(cuda)
            for a in _random_step(rng, cfg, B, T, M, P, Q)]
    shape = (cfg.num_layers, P + 1, 4, cfg.num_heads, cfg.head_dim)
    kp = torch.randn(shape, device=cuda).bfloat16()
    vp = torch.randn(shape, device=cuda).bfloat16()
    args = (*step[:5], kp, vp, step[5])
    gpt_ragged_step(cfg, params, *args, max_q=Q)      # build, warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _, _ = gpt_ragged_step(cfg, params, *args, max_q=Q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits[step[3] > 0]).all()


@pytest.mark.cuda
def test_engine_replays_its_captured_step(cuda):
    """The engine captures its step once (in ``warmup``) and replays it:
    replayed on other batch contents, each step's logits and pages equal
    ``gpt_ragged_step`` called eagerly on the same inputs and pool, each
    replay adds 24 launches (one a layer) to the kernel's count, and the
    watchdog reports one build of ``serving::unified_step``."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.models.gpt import gpt_ragged_step
    from paddle_tpu_torch.observability import watchdog_enabled
    from paddle_tpu_torch.serving import Engine

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], num_layers=24,
                              dtype="float32")
    params = gpt_init(cfg, device=cuda)
    with watchdog_enabled() as wd:
        wd.reset()
        eng = Engine(cfg, params, page_size=4, num_pages=40,
                     max_batch_size=4, chunk_len=8, token_budget=24)
        eng.warmup()
        assert eng.captures == 1
        B, T, M = 4, 24, eng.cache.max_pages_per_seq
        rng = np.random.RandomState(0)
        g = torch.Generator(device=cuda).manual_seed(0)
        for _ in range(4):
            arrays = _random_step(rng, cfg, B, T, 8, 40, 8)
            tables = np.zeros((B, M), np.int32)
            tables[:, :8] = arrays[5]
            for pool in (eng.cache.k_pages, eng.cache.v_pages):
                pool.normal_(generator=g)
            k0, v0 = eng.cache.k_pages.clone(), eng.cache.v_pages.clone()
            before = pa.ragged_paged_attention.launches
            logits = eng._run_step(*arrays[:5], tables).copy()
            assert pa.ragged_paged_attention.launches - before == 24
            dev = [torch.from_numpy(a).to(cuda) for a in arrays[:5]]
            ref, k0, v0 = gpt_ragged_step(
                cfg, params, *dev, k0, v0, torch.from_numpy(tables).to(cuda),
                max_q=eng.chunk_len)
            live = arrays[3] > 0
            torch.testing.assert_close(torch.from_numpy(logits[live]),
                                       ref[torch.from_numpy(live)].float()
                                       .cpu(), atol=1e-4, rtol=1e-4)
            P = eng.cache.num_pages
            torch.testing.assert_close(eng.cache.k_pages[:, :P], k0[:, :P],
                                       atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(eng.cache.v_pages[:, :P], v0[:, :P],
                                       atol=1e-5, rtol=1e-5)
        assert eng.captures == 1
        rep = wd.report()["serving::unified_step"]
    assert rep["compiles"] == 1 and rep["recompiles"] == 0


@pytest.mark.cuda
def test_defrag_with_shared_prefix_on_the_card_matches_the_cpu(cuda):
    """``tests/test_torch_serving.py``'s defrag scenario (a pinned hole
    below two requests sharing a cached prefix, freed and compacted
    mid-decode) on the card's captured step: the greedy tokens equal the
    CPU engine's (which the CPU test holds to the JAX engine's), the
    defrag moves the same pages, and the engine captures once."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.serving import Engine, SamplingParams

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(61)
    system = [int(t) for t in rng.randint(0, 1024, 12)]
    tails = [[int(t) for t in rng.randint(0, 1024, 6)] for _ in range(2)]

    def drive(eng):
        eng.cache.allocate("hole", 16)
        eng.generate([system + [7, 7, 7]], SamplingParams(max_new_tokens=2))
        sp = SamplingParams(max_new_tokens=10)
        b = eng.add_request(system + tails[0], sp)
        c = eng.add_request(system + tails[1], sp)
        for _ in range(3):
            eng.step()
        eng.cache.free("hole")
        moved = eng.cache.defrag()
        eng.cache.check_integrity()
        while eng.has_work():
            eng.step()
        return [b.output, c.output], moved

    kw = dict(page_size=4, num_pages=64, max_batch_size=2, chunk_len=16)
    cpu = drive(Engine(cfg, params, device="cpu", **kw))
    card_params = {k: (v.to(cuda) if torch.is_tensor(v) else
                       {kk: vv.to(cuda) for kk, vv in v.items()})
                   for k, v in params.items()}
    eng = Engine(cfg, card_params, **kw)
    assert drive(eng) == cpu and cpu[1] > 0
    assert eng.captures == 1


@pytest.mark.cuda
def test_engine_recaptures_when_its_tensors_move(cuda):
    """A replaced parameter tensor moves an address the graph holds: the
    engine captures its step again (the watchdog reports one rebuild,
    with the new ``storage`` tag in its diff) and serves the same greedy
    tokens as before."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.observability import watchdog_enabled
    from paddle_tpu_torch.serving import Engine, SamplingParams

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    params = gpt_init(cfg, device=cuda)
    sp = SamplingParams(max_new_tokens=6)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    with watchdog_enabled() as wd:
        wd.reset()
        eng = Engine(cfg, params, page_size=4, num_pages=32,
                     max_batch_size=2, chunk_len=4)
        first = eng.generate(prompts, sp)
        eng.params = dict(params, wte=params["wte"].clone())
        again = eng.generate(prompts, sp)
        rep = wd.report()["serving::unified_step"]
    assert again == first
    assert eng.captures == 2
    assert rep["compiles"] == 2 and rep["recompiles"] == 1


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
    dQ, and a ring pair's backward (adding into fp32 sums, a ring-global
    lse), each against its plain version on the same inputs.  D = 192
    runs zero-padded to 256."""
    from paddle_tpu_torch.kernels import flash_attention as fa

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
    lse_g = ref_lse + np.log(2.0)          # as if merged with one more block
    delta = (do.float() * ref.float()).sum(-1)
    _check_ring_pair(q, k, v, do, lse_g, delta, scale, causal, seed=D)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_d64_matches_plain(cuda, dtype):
    """BERT-base's attention (non-causal, head dim 64, S = 512) through
    ``flash_attention`` on the card against ``flash_attention_plain``:
    output and q/k/v gradients at the flash tolerance of the dtype; the
    kernels launch once forward and once (bf16) or twice (fp32) backward,
    the plain version never."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_case(512, 64, dtype, B=2, H=12, seed=64)
    outs, launched = [], []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(fa.launches)
        out = fn(*leaves, causal=False)
        grads = torch.autograd.grad(out, leaves, do)
        launched.append({n: fa.launches[n] - before[n] for n in before})
        outs.append([out.detach()] + list(grads))
    torch.cuda.synchronize()
    assert launched == [{"fwd": 1, "bwd": _bwd_launches(q)},
                        {"fwd": 0, "bwd": 0}]
    for name, a, b in zip(("out", "dq", "dk", "dv"), *outs):
        assert a.dtype == dtype and a.shape == q.shape, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
def test_moe_layer_on_card_matches_cpu(cuda):
    """``moe_layer`` in fp32 on the card and on the CPU with equal inputs
    (capacity factor 1.0, so choices are dropped): the same routing, y
    at 1e-5 and the gradients of Σ y·r + aux at 1e-4."""
    from paddle_tpu_torch.distributed import moe

    rng = np.random.RandomState(0)
    E, D, F_ = 8, 64, 128
    arrays = {"gate_w": rng.randn(D, E) * 0.5, "up_w": rng.randn(E, D, F_)
              * 0.1, "up_b": rng.randn(E, F_) * 0.1,
              "down_w": rng.randn(E, F_, D) * 0.1,
              "down_b": rng.randn(E, D) * 0.1,
              "x": rng.randn(4, 64, D), "r": rng.randn(4, 64, D)}
    runs = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev,
                             requires_grad=k != "r")
             for k, v in arrays.items()}
        params = {k: t[k] for k in ("gate_w", "up_w", "up_b", "down_w",
                                    "down_b")}
        route = moe.moe_route(t["x"].detach().reshape(-1, D)
                              @ t["gate_w"].detach(), top_k=2,
                              capacity_factor=1.0)
        y, aux = moe.moe_layer(params, t["x"], top_k=2, capacity_factor=1.0)
        grads = torch.autograd.grad((y * t["r"]).sum() + aux,
                                    [t["x"]] + list(params.values()))
        runs[dev] = ([route.expert, route.slot, route.keep],
                     [y.detach(), aux.detach()], grads)
    torch.cuda.synchronize()
    assert not bool(runs["cpu"][0][2].all())           # drops happened
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------- ring attention


def _ring_module():
    import importlib

    return importlib.import_module("paddle_tpu_torch.kernels.ring_attention")


def _check_ring_pair(q, k, v, do, lse, delta, scale, causal, seed):
    """One ring pair's backward as the ring runs it (q/k/v/dO at the
    kernels' width from ``_pair_operands``, fp32 sums at that width)
    from non-zero starting sums: the sums end at start + ``_pair_bwd_ref``
    at the flash tolerance of q's dtype, zero-padded columns stay zero,
    and the launches are counted (bf16: one ``pair_bwd``; fp32: the
    scalar dK/dV and dQ kernels, two flash ``bwd``).  Returns the sums."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = _ring_module()
    D = q.shape[-1]
    ops = ra._pair_operands(q, k, v, do)
    start = [F.pad(t.float(), (0, ops[0].shape[-1] - D))
             for t in _flash_case(q.shape[2], D, torch.float32,
                                  B=q.shape[0], H=q.shape[1], seed=seed)[:3]]
    sums = [t.clone() for t in start]
    before = (dict(ra.launches), fa.launches["bwd"])
    ra._pair_bwd(*ops, lse, delta, scale, causal, *sums)
    want = ra._pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    bf16 = ops[0].dtype == torch.bfloat16
    assert ra.launches["pair_bwd"] == before[0]["pair_bwd"] + bf16
    assert fa.launches["bwd"] == before[1] + 2 * (not bf16)
    for name, a, s0, b in zip(("dq", "dk", "dv"), sums, start, want):
        assert a.dtype == torch.float32 and a.shape == ops[0].shape, name
        torch.testing.assert_close(a[..., :D], s0[..., :D] + b,
                                   **FLASH_TOL[q.dtype], msg=name)
        assert not a[..., D:].any(), name
    return sums


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("s", [128, 256, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_pair_kernels_match_plain(cuda, causal, s, D, dtype):
    """One ring pair's backward (bf16: the one wgmma/TMA kernel adding
    into the sums; fp32: the scalar kernels, added) against
    ``_pair_bwd_ref`` with a ring-global lse and δ (the pair's merged
    with one more block), from non-zero starting sums, over the shard
    lengths and head dims of the ring (D = 32 and 80 zero-padded).  bf16
    dO as the ring hands it; P and dS rounded to bf16 for the tensor
    cores: the bf16 tolerance.  A second run from the same start gives
    the same dK and dV bit for bit (one thread adds each element); dQ is
    summed with TMA reduce-adds and is only held to the plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, k2 = _flash_case(s, D, dtype, seed=s + D)
    v2, do = _flash_case(s, D, dtype, seed=s + D + 1)[:2]
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    _, lse2 = fa._flash_fwd_ref(q, k2, v2, scale, False)
    lse = torch.logaddexp(lse, lse2)
    delta = (do.float() * out.float()).sum(-1)
    first = _check_ring_pair(q, k, v, do, lse, delta, scale, causal, seed=D)
    again = _check_ring_pair(q, k, v, do, lse, delta, scale, causal, seed=D)
    assert torch.equal(first[1], again[1]) and torch.equal(first[2],
                                                           again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_attention_on_card_matches_flash(cuda, dtype):
    """``ring_attention`` over 4 shards against ``flash_attention`` on
    the whole sequence: output and grads at the flash tolerances, and 10
    live pairs (4 diagonal, 6 full): 10 forward launches, and one pair
    backward launch a pair in bf16 (two scalar kernels a pair in fp32)."""
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
    before = (dict(fa.launches), ra.launches["pair_bwd"])
    ra.ring_attention(*(t.clone().requires_grad_(True) for t in (q, k, v)),
                      sep=4).backward(do)
    bf16 = dtype == torch.bfloat16
    assert fa.launches["fwd"] - before[0]["fwd"] == 10
    assert ra.launches["pair_bwd"] - before[1] == 10 * bf16
    assert fa.launches["bwd"] - before[0]["bwd"] == 20 * (not bf16)
    for a, b in zip(*outs):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype])



# ------------------------------------------------ the fleet on the card


@pytest.mark.cuda
def test_bitflip_flips_the_pool_in_place_on_the_card(cuda):
    """The bitflip kind on a CUDA pool XORs one byte where the pool
    lives: same tensors, no new device memory, and the same byte and bit
    as the kind flips on a CPU copy for the same seed; through the
    engine's ``serving.step`` site the pool it flips stays the engine's."""
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.resilience import (FaultSpec, fault_point,
                                             injected_faults)
    from paddle_tpu_torch.serving import Engine

    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (4, 64, 8, 4, 32)
    card = {k: torch.randn(shape, generator=g, device=cuda).bfloat16()
            for k in ("k_pages", "v_pages")}
    host = {k: v.cpu() for k, v in card.items()}
    orig = {k: v.clone() for k, v in host.items()}
    ptrs = {k: v.data_ptr() for k, v in card.items()}
    for tree in (card, host):
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        with injected_faults(FaultSpec("x", "bitflip"), seed=3):
            fault_point("x", tree=tree)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == mem
    assert {k: v.data_ptr() for k, v in card.items()} == ptrs
    flipped = 0
    for k in card:
        a = card[k].cpu().view(torch.int16)
        assert torch.equal(a, host[k].view(torch.int16))
        x = (a ^ orig[k].view(torch.int16)).view(torch.uint8)
        flipped += int(sum(bin(int(b)).count("1") for b in x[x != 0]))
    assert flipped == 1

    cfg = GPT_CONFIGS["tiny"]
    eng = Engine(cfg, gpt_init(cfg, device="cuda"), page_size=8,
                 num_pages=64, max_batch_size=2, chunk_len=8)
    eng.add_request([1, 2, 3])
    pool = (eng.cache.k_pages, eng.cache.v_pages)
    before = (pool[0].clone(), pool[1].clone())
    with injected_faults(FaultSpec("serving.step", "bitflip"), seed=1):
        eng.step()
    assert (eng.cache.k_pages, eng.cache.v_pages) == pool
    assert any(not torch.equal(a, b) for a, b in zip(pool, before))


@pytest.mark.cuda
def test_fleet_returns_engine_memory_on_the_card(cuda):
    """kill_replica, drain(restart=False) and restart_replica give the old
    engine's pool back to the card at once: device memory follows the
    number of engines the fleet holds, one pool each."""
    import gc

    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.serving import (Engine, FleetRequestState,
                                          FleetRouter, SamplingParams)

    cfg = GPT_CONFIGS["tiny"]
    params = gpt_init(cfg, device="cuda")

    def make():
        return Engine(cfg, params, page_size=8, num_pages=4096,
                      max_batch_size=2, chunk_len=8)

    def held():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - base

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    router = FleetRouter([make] * 3, registry=MetricsRegistry())
    pool = held() / 3
    slack = 8 << 20
    rng = np.random.RandomState(0)
    sp = SamplingParams(max_new_tokens=6)
    reqs = [router.submit(list(rng.randint(0, cfg.vocab_size, n)), sp)
            for n in (5, 9, 7, 12)]
    for _ in range(3):
        router.step()
    router.kill_replica(0)
    assert abs(held() - 2 * pool) <= slack
    router.drain(1, restart=False)
    while router.has_work():
        router.step()
    assert all(r.state == FleetRequestState.FINISHED for r in reqs)
    assert abs(held() - pool) <= slack
    router.restart_replica(0)
    router.drain(2)                       # a rolling restart
    router.step()
    assert abs(held() - 2 * pool) <= slack
    assert router.metrics.snapshot()["lost"] == 0


# ------------------------------------------------ the eager API on the card


@pytest.mark.cuda
def test_eager_multi_head_attention_launches_flash(cuda):
    """``nn.MultiHeadAttention`` on the card launches the flash forward
    (and, training, the backward); with attention dropout drawn it takes
    the naive route and launches nothing."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import flash_attention as fa

    paddle.set_device("gpu")
    paddle.seed(0)
    mha = paddle.nn.MultiHeadAttention(256, 4)
    x = torch.randn(2, 128, 256, device=cuda)
    for key in fa.launches:
        fa.launches[key] = 0
    with paddle.amp.auto_cast():
        mha(x).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": 1, "bwd": 1}
    drop = paddle.nn.MultiHeadAttention(256, 4, dropout=0.1)
    for key in fa.launches:
        fa.launches[key] = 0
    with paddle.amp.auto_cast():
        drop(x).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": 0, "bwd": 0}
    drop.eval()
    with torch.no_grad(), paddle.amp.auto_cast():
        drop(x)
    assert fa.launches == {"fwd": 1, "bwd": 0}


@pytest.mark.cuda
def test_fp32_conv2d_on_card_is_exact_under_default_tf32_flags(cuda):
    """With PyTorch's default flags (cuDNN TF32 on) the port's fp32
    ``Conv2D`` still computes in fp32, forward and backward: it matches
    the CPU at 1e-5 of the largest entry (TF32 would miss by about
    1e-3)."""
    import paddle_tpu_torch as paddle

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        paddle.set_device("cpu")
        paddle.seed(0)
        conv = paddle.nn.Conv2D(64, 128, 3, padding=1)
        x = torch.randn(8, 64, 28, 28)
        ct = torch.randn(8, 128, 28, 28)
        xs = [x.clone().requires_grad_(True),
              x.cuda().requires_grad_(True)]
        outs, grads = [], []
        for dev, xi in zip(("cpu", "cuda"), xs):
            conv.to(dev)
            conv.weight.grad = None
            out = conv(xi)
            (out * ct.to(dev)).sum().backward()
            # clones: moving the layer later moves its .grad in place
            outs.append(out.detach().cpu().clone())
            grads.append((xi.grad.cpu().clone(),
                           conv.weight.grad.cpu().clone()))
        assert torch.backends.cudnn.allow_tf32        # left as it was
        for a, b in zip([outs[1], *grads[1]], [outs[0], *grads[0]]):
            err = (a - b).abs().max() / b.abs().max()
            assert err < 1e-5, float(err)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        paddle.set_device("cpu")


# ------------------------------------------------ the training graphs


def _eager_engine_class():
    """``HybridEngine`` calling its step body directly each step: the
    graph route's baseline (the engine has no eager route on the card, as
    the JAX engine has none beside its jit)."""
    from paddle_tpu_torch.distributed import HybridEngine

    class EagerEngine(HybridEngine):
        def _run(self, args):
            return self._step_body(*args)

    return EagerEngine


def _train_counts():
    import importlib

    from paddle_tpu_torch.kernels import flash_attention as fa

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    for counts in (fa.launches, ra.launches):
        for n in counts:
            counts[n] = 0
    return fa.launches, ra.launches


@pytest.mark.cuda
def test_engine_graph_matches_eager_on_card(cuda):
    """A 2-layer fp32 ``tiny`` GPT ``HybridEngine``, 3 steps from one
    ``init(seed=0)`` on the eager route and on the graph route (step 1
    eager, then captured once and replayed): losses, every parameter and
    every Adam slot at 1e-5 (the same kernels on the same inputs), the
    graph engine captured once (the watchdog: one build of
    ``hybrid_engine::step``), and its three losses distinct tensors."""
    from paddle_tpu_torch.distributed import HybridEngine
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.observability import watchdog_enabled

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32",
                              num_layers=2)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (2, 128))
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], 1)
    runs = {}
    with watchdog_enabled() as wd:
        wd.reset()
        for route, cls in (("eager", _eager_engine_class()),
                           ("graph", HybridEngine)):
            eng = cls(cfg, device=cuda)
            params, opt = eng.init(seed=0)
            losses = [eng.step(params, opt, tokens, labels, lr=1e-3)[2]
                      for _ in range(3)]
            runs[route] = (eng, params, opt, losses)
        rep = wd.report()["hybrid_engine::step"]
    assert runs["graph"][0].captures == 1 and runs["eager"][0].captures == 0
    assert rep["compiles"] == 1 and rep["recompiles"] == 0
    assert runs["graph"][0].graph_pool_bytes > 0
    (_, pe, oe, le), (_, pg, og, lg) = runs["eager"], runs["graph"]
    torch.testing.assert_close(torch.stack(lg), torch.stack(le), **TOL[
        torch.float32])
    assert len({float(x) for x in lg}) == 3
    flat = lambda t: {f"{k}/{kk}": vv for k, v in t.items()  # noqa: E731
                      for kk, vv in (v.items() if isinstance(v, dict)
                                     else [("", v)])}
    for k, v in flat(pe).items():
        torch.testing.assert_close(flat(pg)[k], v, **TOL[torch.float32])
    for name in ("m", "v"):
        for k, v in flat(eng.opt_canonical(oe, pe)[name]).items():
            got = flat(eng.opt_canonical(og, pg)[name])[k]
            torch.testing.assert_close(got, v, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("sep", [1, 2])
def test_engine_graph_counts_launches_through_replays(cuda, sep):
    """bf16 ``tiny`` at sep 1 (flash) and sep 2 (the ring): 4 steps (one
    eager, one capture, replays) launch per step what an eager step
    launches — flash 2L forward / L backward, or 2·3L forward and 3L
    ring-pair backward for the ring's three live pairs a layer — and the
    engine captures once."""
    from paddle_tpu_torch.distributed import HybridEngine
    from paddle_tpu_torch.models import GPT_CONFIGS

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], max_seq_len=256,
                              seq_parallel="ring")
    L = cfg.num_layers
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (2, 256))
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], 1)
    eng = HybridEngine(cfg, sep=sep, device=cuda)
    params, opt = eng.init(seed=0)
    fl, rl = _train_counts()
    for _ in range(4):
        loss = eng.step(params, opt, tokens, labels)[2]
    torch.cuda.synchronize()
    live = sep * (sep + 1) // 2
    per = ({"fwd": 2 * L, "bwd": L, "pair_bwd": 0} if sep == 1 else
           {"fwd": 2 * live * L, "bwd": 0, "pair_bwd": live * L})
    assert {**fl, **rl} == {n: 4 * k for n, k in per.items()}
    assert eng.captures == 1 and bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_hapi_train_batch_graph_matches_eager_on_card(cuda):
    """ResNet-18 (10 classes) at 4 x 3 x 64 x 64, fp32, Momentum 0.01/0.9
    with weight decay: 3 ``train_batch`` steps on the graph route against
    the same steps with the bodies called eagerly, from the same weights:
    losses, parameters, velocities and batch-norm buffers at 1e-5 of each
    tensor's largest entry, with cuDNN held to its deterministic
    algorithms (its default fp32 weight-gradient algorithms sum with
    atomics, so two runs of one route differ in the last bits, which
    train-mode batch norm at batch 4 amplifies past 1e-3 within three
    steps); then ``eval_batch`` twice: one capture, equal losses,
    buffers unchanged."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi import Model

    class EagerModel(Model):
        def _run_train(self, args):
            return self._train_body(*args)

        def _run_eval(self, x, y):
            return self._eval_body(x, y)

    paddle.set_device("gpu")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        models = []
        for cls in (EagerModel, Model):
            paddle.seed(0)
            net = paddle.vision.resnet18(num_classes=10)
            model = cls(net)
            model.prepare(paddle.optimizer.Momentum(
                learning_rate=0.01, momentum=0.9,
                parameters=model.parameters(), weight_decay=1e-4),
                paddle.nn.CrossEntropyLoss())
            models.append(model)
        rng = np.random.RandomState(3)
        losses = ([], [])
        for step in range(3):
            x = rng.rand(4, 3, 64, 64).astype(np.float32)
            y = rng.randint(0, 10, (4,)).astype(np.int64)
            for m, out in zip(models, losses):
                out.append(m.train_batch(x, y)[0])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
        eager, graph = models
        assert graph.captures == {"train": 1, "eval": 0}
        for (k, a), b in zip(graph.network.state_dict().items(),
                             eager.network.state_dict().values()):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, (k, err)
        for k, s in graph._opt_state["slots"].items():
            b = eager._opt_state["slots"][k]["velocity"]
            err = float((s["velocity"] - b).abs().max()
                        / b.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, (k, err)
        bufs = {k: b.clone() for k, b in graph.network.named_buffers()}
        ev = [graph.eval_batch(x, y)[0] for _ in range(2)]
        assert ev[0] == ev[1] and graph.captures["eval"] == 1
        assert ev[0] == pytest.approx(eager.eval_batch(x, y)[0], rel=1e-5)
        for k, b in graph.network.named_buffers():
            assert torch.equal(b, bufs[k]), k
    finally:
        torch.backends.cudnn.deterministic = prev
        paddle.set_device("cpu")


@pytest.mark.cuda
def test_hapi_prepare_again_captures_again_on_card(cuda):
    """A small MLP, fp32: two ``train_batch`` steps under Adam and a mean
    cross entropy, ``prepare`` with AdamW and a summed cross entropy,
    two more steps.  The graph route captures once before and once after
    the second ``prepare`` (the watchdog sees two builds, no rebuild),
    and its losses, parameters and slots equal those of the bodies called
    eagerly at 1e-5 of each tensor's largest entry: no replay of the old
    loss or update rule."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.observability import watchdog_enabled

    class EagerModel(Model):
        def _run_train(self, args):
            return self._train_body(*args)

    def prepare(m, second):
        if second:
            opt = paddle.optimizer.AdamW(learning_rate=0.02,
                                         weight_decay=0.1,
                                         parameters=m.parameters())
        else:
            opt = paddle.optimizer.Adam(learning_rate=0.05,
                                        parameters=m.parameters())
        m.prepare(opt, paddle.nn.CrossEntropyLoss(
            reduction="sum" if second else "mean"))

    paddle.set_device("gpu")
    try:
        with watchdog_enabled() as wd:
            wd.reset()
            models = []
            for cls in (EagerModel, Model):
                paddle.seed(0)
                nn = paddle.nn
                m = cls(nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                      nn.Linear(16, 4)))
                prepare(m, False)
                models.append(m)
            eager, graph = models
            rng = np.random.RandomState(4)
            losses = ([], [])
            for step in range(4):
                if step == 2:
                    assert graph.captures["train"] == 1
                    for m in models:
                        prepare(m, True)
                x = rng.randn(6, 8).astype(np.float32)
                y = rng.randint(0, 4, (6,)).astype(np.int64)
                for m, out in zip(models, losses):
                    out.append(m.train_batch(x, y)[0])
            rep = wd.report()["hapi::train_step"]
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
        assert graph.captures["train"] == 1
        assert rep["compiles"] == 2 and rep["recompiles"] == 0
        for (k, a), b in zip(graph.network.state_dict().items(),
                             eager.network.state_dict().values()):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, (k, err)
        for k, s in graph._opt_state["slots"].items():
            for n, t in s.items():
                b = eager._opt_state["slots"][k][n]
                err = float((t - b).abs().max()
                            / b.abs().max().clamp_min(1e-30))
                assert err <= 1e-5, (k, n, err)
    finally:
        paddle.set_device("cpu")


def _small_encoder(device):
    import paddle_tpu_torch as paddle

    paddle.set_device(device)
    try:
        paddle.seed(0)
        enc = paddle.nn.TransformerEncoder(
            paddle.nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0,
                                              activation="gelu"), 2)
    finally:
        paddle.set_device("cpu")
    return enc.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_operator_on_card_matches_plain(cuda, causal, dtype):
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = [torch.randn(2, 4, 256, 64, generator=g, device="cuda")
               .to(dtype) for _ in range(3)]
    before = fa.launches["fwd"]
    out, lse = fa.flash_fwd(q, k, v, 0.125, causal)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == before + 1
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cpu_exported_program_launches_the_kernel_on_the_card(cuda,
                                                              tmp_path):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import flash_attention as fa

    enc = _small_encoder("cpu")
    x = torch.randn(2, 128, 64, generator=torch.Generator().manual_seed(2))
    jit.save(enc, str(tmp_path / "m"), example_inputs=[x])
    with torch.no_grad():
        ref = enc(x)
    pred = jit.load(str(tmp_path / "m"))          # the card by default
    before = dict(fa.launches)
    out = pred(x)
    out2 = pred(x)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert fa.launches["fwd"] - before["fwd"] == 4     # 2 layers x 2 calls
    assert set(pred.routes.values()) == {"graph"} and pred.captures == 1
    assert torch.equal(out, out2)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_predictor_replay_equals_its_eager_run(cuda):
    import copy

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.contrib.quant import PTQ

    enc = _small_encoder("cuda")
    x = torch.randn(4, 128, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    calib = copy.deepcopy(enc)
    ptq = PTQ()
    ptq.quantize(calib)
    with torch.no_grad():
        calib(x)
    scales = {k: {"activation": s} for k, s in ptq.scales().items()}
    for precision in ("float32", "bfloat16", "int8"):
        cfg = inference.Config().set_model(enc)
        if precision == "int8":
            cfg.enable_int8(scales)
        else:
            cfg.set_precision(precision)
        pred = inference.create_predictor(cfg)
        first, replay = pred.run(x), pred.run(x)
        (_, mod, route), = pred._impl._programs.values()
        assert route == "graph" and pred.captures == 1
        with torch.no_grad():
            eager = mod(x)
        torch.cuda.synchronize()
        assert torch.equal(first, replay), precision
        assert torch.equal(replay, eager), precision


@pytest.mark.cuda
def test_one_capture_per_signature(cuda):
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.observability.compile_watchdog import (
        CompileWatchdog, watchdog_enabled)

    enc = _small_encoder("cuda")
    traced = jit.to_static(enc)
    wd = CompileWatchdog()
    traced._compiled = wd.watch(traced._run, name="jit::enc")
    shapes = [(2, 128, 64), (1, 256, 64)] * 3
    with watchdog_enabled(wd):
        for s in shapes:
            traced(torch.randn(*s, device="cuda"))
    rep = wd.report()["jit::enc"]
    assert (rep["compiles"], traced.captures) == (2, 2)

    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")             # where static.data places feeds
    try:
        main = static.Program()
        with static.program_guard(main):
            src = static.data("src", [None, 128, 64], "float32")
            out = enc(src)
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [4], "float32")
            y = static.cond(x.sum() > 0.0, lambda: x * 2.0, lambda: x - 1.0)
    finally:
        paddle.set_device("cpu")
    exe = static.Executor("gpu")
    for b in (2, 3, 2, 3):
        exe.run(main, feed={"src": np.ones((b, 128, 64), np.float32)},
                fetch_list=[out])
    assert exe.last_route == "graph" and exe.captures == 2
    (r,) = exe.run(prog, feed={"x": np.ones(4, np.float32)}, fetch_list=[y])
    assert exe.last_route == "eager" and exe.captures == 2
    np.testing.assert_allclose(r, np.full(4, 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_is_bitwise_over_repeats(cuda, D, causal):
    """The bf16 backward sums dQ over the key tiles in a fixed order: ten
    calls give the same dq, dk and dv bits, each at the plain version's
    bf16 tolerance (a ragged S with several key and query tiles)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(D)
    q, k, v, do = (torch.randn((2, 3, 600, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    delta = fa._delta(out, do)
    first = fa._bwd_sm90(q, k, v, do, lse, delta, scale, causal)
    want = (fa._bwd_dq_ref(q, k, v, do, lse, delta, scale, causal),
            *fa._bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal))
    for a, b in zip(first, want):
        torch.testing.assert_close(a.float(), b.float(),
                                   **TOL[torch.bfloat16])
    for _ in range(10):
        again = fa._bwd_sm90(q, k, v, do, lse, delta, scale, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_pair_sums_are_bitwise_over_repeats(cuda, causal):
    """A bf16 ring pair adds dQ, dK and dV into non-zero fp32 sums: ten
    runs from the same sums give the same bits."""
    import importlib

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((2, 4, 384, 128), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    start = [torch.randn((2, 4, 384, 128), generator=g, device="cuda")
             for _ in range(3)]
    scale = 1.0 / np.sqrt(128)
    out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
    delta = fa._delta(out, do)
    runs = []
    for _ in range(10):
        sums = [t.clone() for t in start]
        ra._pair_bwd(q, k, v, do, lse, delta, scale, causal, *sums)
        runs.append(sums)
    want = ra._pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    for a, s, b in zip(runs[0], start, want):
        torch.testing.assert_close(a, s + b, **TOL[torch.bfloat16])
    assert all(torch.equal(a, b) for r in runs for a, b in zip(runs[0], r))


def _card_mlp(paddle):
    paddle.set_device("gpu")
    paddle.seed(0)
    model = paddle.Model(paddle.nn.Sequential(
        paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
        paddle.nn.Linear(32, 4)))
    model.prepare(paddle.optimizer.Momentum(
        learning_rate=0.1, parameters=model.parameters()),
        paddle.nn.CrossEntropyLoss())
    return model


@pytest.mark.cuda
def test_train_batch_replay_equals_its_live_step(cuda):
    """``replay_train_batch`` re-runs the captured step from a pre-step
    snapshot: its parameters equal the live step's bit for bit, and the
    model's parameters, slots and step count are as the live step left
    them; still one capture."""
    import paddle_tpu_torch as paddle

    model = _card_mlp(paddle)
    rng = np.random.RandomState(0)
    try:
        batches = [(rng.randn(8, 16).astype(np.float32),
                    rng.randint(0, 4, (8,)).astype(np.int64))
                   for _ in range(3)]
        for x, y in batches[:2]:
            model.train_batch(x, y)
        snap = model.train_state_snapshot()
        live_loss, _ = model.train_batch(*batches[2])
        after = model.train_state_snapshot()
        loss, params = model.replay_train_batch(snap, batches[2])
        assert loss == live_loss
        for k, p in model.network.named_parameters():
            assert torch.equal(params[k], p), k
            assert torch.equal(after["params"][k], p), k
        for k, s in model._opt_state["slots"].items():
            for n, t in s.items():
                assert torch.equal(after["opt_state"]["slots"][k][n], t)
        assert model._opt_state["step"] == 3
        assert model.captures["train"] == 1
    finally:
        paddle.set_device("cpu")


@pytest.mark.cuda
def test_in_place_engine_restore_keeps_one_capture(cuda, tmp_path):
    """``load_engine_state(into=)`` rewinds a live ``HybridEngine`` (a
    2-layer fp32 ``tiny`` GPT on its graph route) to a checkpoint: the
    steps after it repeat the first run's losses bit for bit, on the
    same captured graph (one capture, one watchdog build)."""
    from paddle_tpu_torch.distributed import HybridEngine
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.observability import watchdog_enabled

    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32",
                              num_layers=2)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (2, 128))
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], 1)
    with watchdog_enabled() as wd:
        wd.reset()
        eng = HybridEngine(cfg, device=cuda)
        params, opt = eng.init(seed=0)
        for _ in range(2):
            eng.step(params, opt, tokens, labels, lr=1e-3)
        ck.save_engine_state(str(tmp_path / "ck"), eng, params, opt)
        first = [float(eng.step(params, opt, tokens, labels, lr=1e-3)[2])
                 for _ in range(2)]
        ck.load_engine_state(str(tmp_path / "ck"), eng, into=(params, opt))
        assert opt["step"] == 2
        again = [float(eng.step(params, opt, tokens, labels, lr=1e-3)[2])
                 for _ in range(2)]
        rep = wd.report()["hybrid_engine::step"]
    assert again == first
    assert eng.captures == 1 and rep["compiles"] == 1


# --------------------------------------------------- the sentinel's CRC


@pytest.mark.cuda
def test_crc32_kernel_equals_zlib_on_the_card(cuda):
    """One launch digests leaves of every kind (fp32, bf16 under its '<V2'
    header, int64, 0-d, empty, odd byte counts, a strided view, several
    256 KiB blocks), equal to zlib's digest of the same bytes."""
    from paddle_tpu_torch.kernels import crc32
    from paddle_tpu_torch.resilience import integrity

    g = torch.Generator(device="cuda").manual_seed(0)
    leaves = [torch.randn(700, 513, generator=g, device="cuda"),
              torch.randn(33, 17, generator=g, device="cuda").bfloat16(),
              torch.randint(0, 1 << 40, (999,), generator=g, device="cuda"),
              torch.tensor(1.5, device="cuda"), torch.zeros(0, device="cuda"),
              torch.randint(0, 255, (262144 * 3 + 5,), dtype=torch.uint8,
                            generator=g, device="cuda"),
              torch.randn(20, 30, generator=g, device="cuda")[::2, 5:]]
    before = crc32.crc32_leaves.launches
    got = crc32.crc32_leaves(leaves, [integrity._header_crc(t)
                                      for t in leaves])
    assert crc32.crc32_leaves.launches == before + 1
    assert got == [integrity._leaf_crc(t.cpu()) for t in leaves]
    assert integrity.tree_fingerprint({"l": leaves}) == \
        integrity.tree_fingerprint({"l": [t.cpu() for t in leaves]})


@pytest.mark.cuda
def test_sentinel_overhead_under_bound_on_the_card(cuda):
    """``tests/test_integrity.py``'s overhead smoke on the port: at
    ``bench.py``'s ``bench_integrity`` config (MLP hidden 1024, batch
    128, fp32, Momentum), a fingerprint every 25 steps and a replay every
    100, amortized over the median step, stay under 3 % of step time,
    and a fingerprint's median stays under 0.2 s."""
    import time

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    paddle.set_device("gpu")
    try:
        paddle.seed(0)
        nn = paddle.nn
        model = paddle.Model(nn.Sequential(
            nn.Linear(1024, 1024), nn.ReLU(), nn.Linear(1024, 1024),
            nn.ReLU(), nn.Linear(1024, 10)))
        model.prepare(paddle.optimizer.Momentum(
            learning_rate=0.01, parameters=model.parameters()),
            nn.CrossEntropyLoss())
        rng = np.random.RandomState(0)
        x = rng.randn(128, 1024).astype(np.float32)
        y = rng.randint(0, 10, (128,)).astype(np.int64)

        def median(fn, n):
            fn()
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        step = median(lambda: model.train_batch(x, y), 20)
        tree = {"params": dict(model.network.named_parameters())}
        fp = median(lambda: tree_fingerprint(tree), 9)
        snap = model.train_state_snapshot()
        # 21 replays: single replays of a graph stall for 4-10 ms on a
        # shared host, in plain PyTorch too, and a median of few cannot
        # outvote two of them
        rp = median(lambda: model.replay_train_batch(snap, (x, y)), 21)
        ratio = (fp / 25 + rp / 100) / step
        assert ratio < 0.03, (step, fp, rp, ratio)
        assert fp < 0.2, fp
    finally:
        paddle.set_device("cpu")


@pytest.mark.cuda
def test_capture_survives_pinned_allocations_in_another_thread(cuda):
    """A captured step captures while another thread allocates pinned
    host memory (the DataLoader's prefetch thread does, building batches
    for a training step): the capture is thread-local, so the other
    thread's CUDA calls do not invalidate it, and the replay equals the
    eager call."""
    import threading

    from paddle_tpu_torch._captured import CapturedStep, storage_tag

    w = torch.randn(512, 512, device=cuda) / 512 ** 0.5

    def body(x):
        for _ in range(300):
            x = torch.tanh(x @ w)
        return x

    stop = threading.Event()
    pinned = []

    def pin():
        n = 1 << 20
        while not stop.is_set():
            # a new size each time: the caching host allocator cannot
            # serve it from its cache, so each is a cudaHostAlloc
            pinned.append(torch.empty(n, dtype=torch.uint8,
                                      pin_memory=True))
            n += 4096
            if len(pinned) > 64:
                pinned.pop(0)

    thread = threading.Thread(target=pin, daemon=True)
    thread.start()
    try:
        x = torch.randn(64, 512, device=cuda)
        step = CapturedStep(body, cuda)
        tag = storage_tag([x])
        eager = step(x, storage=tag)
        replay = step(x, storage=tag)
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    assert step.captures == 1
    torch.testing.assert_close(replay, eager, atol=1e-6, rtol=1e-6)
