"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This
file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them; there ``tests/conftest.py`` (which imports jax)
is bypassed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: both sides compute in fp32, so fp32 differs by summation
order only (1e-5) and bf16 by one rounding of the output (atol 1e-2,
rtol 1.6e-2)."""
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
def test_kernel_rejects_what_it_cannot_load(cuda):
    q, kp, vp, tb, ql, cl = _case(*CASES[0], 48)
    with pytest.raises(ValueError, match="head_dim"):
        pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
    q, kp, vp, tb, ql, cl = _case(*CASES[0], 32)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q.half(), kp.half(), vp.half(), tb, ql, cl)


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
