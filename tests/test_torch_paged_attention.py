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


@pytest.mark.parametrize("hd", [16, 17, 48, 80, 100, 320])
def test_plain_matches_jax_reference_any_head_dim(hd):
    """Head dims off the 32-grid and past 256, which the CUDA kernel takes
    through masked tail lanes (and one-element loads where a row is not a
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

