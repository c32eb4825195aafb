"""The port's flash attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides.  The
JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (``flash_attention``, ``_flash_fwd``) and the naive XLA
route.  On the CPU the port's ``_Flash`` takes its plain versions; the
CUDA kernels are held against those on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).  fp32,
atol = rtol = 1e-4: only the order of the sums differs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import _flash_fwd as jax_flash_fwd
from paddle_tpu.kernels.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu.kernels.flash_attention import \
    flash_attention_available as jax_available
from paddle_tpu.ops.attention import _naive_attention as jax_naive
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.ops.attention import _naive_attention

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

# (S, D, causal): S = 200 only causal (the JAX side pads it to 256)
CASES = [(128, 32, False), (128, 32, True), (256, 64, False),
         (256, 64, True), (200, 32, True), (200, 64, True)]


def _qkv(S, D, B=1, H=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(4)]                     # q, k, v, dO


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("S,D,causal", CASES)
def test_forward_matches_jax(S, D, causal):
    q, k, v, _ = _qkv(S, D)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal))
    tq, tk, tv = _t(q, k, v)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    naive = _naive_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), **TOL)
    jnaive = jax_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, training=False)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive), **TOL)


@pytest.mark.parametrize("S,D,causal", [c for c in CASES if c[0] % 128 == 0])
def test_lse_matches_jax_flash_fwd(S, D, causal):
    """lse against the JAX kernel's own (S a multiple of 128, where the
    JAX forward runs unpadded), at the default tiles fitted to S."""
    q, k, v, _ = _qkv(S, D, seed=1)
    scale = 1.0 / np.sqrt(D)
    blk = min(S, 512)
    out_j, lse_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal, blk, blk)
    out, lse = fa._flash_fwd(*_t(q, k, v), scale, causal)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("S,D,causal", CASES)
def test_backward_matches_jax_grad(S, D, causal):
    q, k, v, do = _qkv(S, D, seed=2)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal)
                       * jnp.asarray(do))

    gj = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    for a, b, name in zip((tq.grad, tk.grad, tv.grad), gj, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"d{name}")
    # and against autograd through the naive route
    nq, nk, nv = _t(q, k, v, grad=True)
    _naive_attention(nq, nk, nv, causal=causal).backward(
        torch.from_numpy(do))
    for a, b, name in zip((tq.grad, tk.grad, tv.grad),
                          (nq.grad, nk.grad, nv.grad), "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                   err_msg=f"naive d{name}")


def test_bwd_ref_is_the_autograd_function():
    """``_flash_bwd_ref`` (what the CPU backward runs) against the
    gradient of the plain forward."""
    q, k, v, do = _qkv(128, 32, seed=3)
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = fa._flash_fwd_ref(tq, tk, tv, 0.3, True)
    out.backward(torch.from_numpy(do))
    dq, dk, dv = fa._flash_bwd_ref(*_t(q, k, v), out.detach(), lse.detach(),
                                   torch.from_numpy(do), 0.3, True)
    for a, b in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("S,causal", [(128, False), (72, True)])
def test_wide_head_dim_matches_jax(S, causal):
    """D = 320, past the JAX gate's 256, which the JAX ``flash_attention``
    computes all the same (Pallas in interpret mode) and the port takes on
    the card by zero-padding to 512 (fp32 kernels; bf16 cast up): the
    output and dq/dk/dv of the plain route on that padded problem, sliced
    back, against the JAX package and its gradient at 1e-4."""
    D = 320
    q, k, v, do = _qkv(S, D, seed=8)
    scale = 1.0 / np.sqrt(D)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal)
                       * jnp.asarray(do))

    out_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal)
    grads_j = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    padded = fa._pad_head_dim(*_t(q, k, v, do))
    assert padded[0].shape[-1] == 512
    out_p, lse = fa._flash_fwd_ref(*padded[:3], scale, causal)
    grads_p = fa._flash_bwd_ref(*padded[:3], out_p, lse, padded[3], scale,
                                causal)
    got = fa._unpad_head_dim(D, out_p, *grads_p)
    for a, b, name in zip(got, (out_j,) + tuple(grads_j),
                          ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # and the public entry on the CPU (the plain route, unpadded)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    for a, b, name in zip((out.detach(), tq.grad, tk.grad, tv.grad),
                          (out_j,) + tuple(grads_j), ("out", "dq", "dk",
                                                      "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"entry {name}")


@pytest.mark.parametrize("S,causal", [(128, False), (72, True)])
def test_head_dim_past_512_matches_jax(S, causal):
    """D = 640, which the port takes on the card by zero-padding to 1024
    and walking two 512-column chunks (the scores and dP summed over both,
    each output chunk from its own columns, one lse and δ): the plain
    route on that padded problem, and its 512-column chunks of out, dq,
    dk and dv computed from the summed scores alone, against the JAX
    ``flash_attention`` (Pallas in interpret mode) and its gradient at
    1e-4."""
    D = 640
    q, k, v, do = _qkv(S, D, seed=9)
    scale = 1.0 / np.sqrt(D)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal)
                       * jnp.asarray(do))

    out_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal)
    grads_j = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    padded = fa._pad_head_dim(*_t(q, k, v, do))
    assert padded[0].shape[-1] == 1024
    pq, pk, pv, pdo = padded
    out_p, lse = fa._flash_fwd_ref(pq, pk, pv, scale, causal)
    p, ds = fa._bwd_p_ds(pq, pk, pv, lse, fa._delta(out_p, pdo), pdo, scale,
                         causal)
    # the kernels' output chunks: P, dS over all columns, then each
    # chunk's columns alone
    chunks = [(torch.einsum("bhqk,bhkd->bhqd", p, pv[..., c:c + 512]),
               torch.einsum("bhqk,bhkd->bhqd", ds, pk[..., c:c + 512]),
               torch.einsum("bhqk,bhqd->bhkd", ds, pq[..., c:c + 512]),
               torch.einsum("bhqk,bhqd->bhkd", p, pdo[..., c:c + 512]))
              for c in (0, 512)]
    # P = exp(s - lse) is normalised already, so P V is the output
    got = [torch.cat(parts, -1)[..., :D] for parts in zip(*chunks)]
    for a, b, name in zip(got, (out_j,) + tuple(grads_j),
                          ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # and the public entry on the CPU (the plain route, unpadded)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    for a, b, name in zip((out.detach(), tq.grad, tk.grad, tv.grad),
                          (out_j,) + tuple(grads_j), ("out", "dq", "dk",
                                                      "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"entry {name}")


def test_non_causal_ragged_seq_raises_like_jax():
    q, k, v, _ = _qkv(200, 32)
    with pytest.raises(ValueError, match="128"):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False)
    with pytest.raises(ValueError, match="128"):
        fa.flash_attention(*_t(q, k, v), causal=False)


@pytest.mark.parametrize("shape,mask,causal", [
    ((1, 2, 128, 32), False, False), ((1, 2, 200, 32), False, False),
    ((1, 2, 200, 32), False, True), ((1, 2, 128, 32), True, True),
    ((1, 2, 128, 320), False, True), ((1, 2, 128, 256), False, False)])
def test_available_matches_jax(shape, mask, causal):
    a = np.zeros(shape, np.float32)
    m = np.zeros(shape[2:], np.float32) if mask else None
    want = jax_available(*(jnp.asarray(a),) * 3,
                         None if m is None else jnp.asarray(m),
                         causal=causal)
    got = fa.flash_attention_available(
        *(torch.from_numpy(a),) * 3,
        None if m is None else torch.from_numpy(m), causal=causal)
    assert got == want


def test_plain_entry_and_counters():
    """``flash_attention_plain`` gives the same values; CPU calls count
    no kernel launch."""
    q, k, v, do = _qkv(128, 32, seed=4)
    before = dict(fa.launches)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(do))
    pq, pk, pv = _t(q, k, v, grad=True)
    pout = fa.flash_attention_plain(pq, pk, pv, causal=True)
    pout.backward(torch.from_numpy(do))
    assert torch.equal(out, pout) and torch.equal(tq.grad, pq.grad)
    assert fa.launches == before


def test_naive_attention_mask_and_scale():
    """Additive mask and explicit scale against the JAX naive route."""
    q, k, v, _ = _qkv(16, 8, seed=5)
    rng = np.random.RandomState(6)
    mask = np.where(rng.rand(16, 16) < 0.3, -1e4, 0.0).astype(np.float32)
    want = jax_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     mask=jnp.asarray(mask), causal=True, scale=0.2,
                     training=False)
    got = _naive_attention(*_t(q, k, v), mask=torch.from_numpy(mask),
                           causal=True, scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # attention dropout: off outside training, drawn while training
    plain = _naive_attention(*_t(q, k, v))
    assert torch.equal(_naive_attention(*_t(q, k, v), dropout_p=0.1,
                                        training=False), plain)
    dropped = _naive_attention(*_t(q, k, v), dropout_p=0.1)
    assert torch.isfinite(dropped).all() and not torch.equal(dropped, plain)
