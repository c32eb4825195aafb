"""The port's ring attention and its sequence-parallel engine against the
JAX package's.

Inputs are made with numpy from a seed and handed to both sides.  The
JAX ring runs as its own tests run it (``tests/test_ring_attention.py``):
``shard_map`` over ``jax.devices()[:sep]`` of the virtual CPU mesh,
where each pair takes its plain jnp path.  The port runs every rank on
one device and, on the CPU, each pair on its plain version; the CUDA
kernels are held against those on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
Tolerances are stated at each comparison."""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.kernels.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu.kernels import ring_attention as jra
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.distributed import HybridEngine
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (GPTConfig, opt_from_jax,
                                     params_from_jax, params_to_numpy)
from paddle_tpu_torch.ops.attention import _naive_attention

ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")

torch.set_num_threads(1)


def _arrays(shape, n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _jax_ring(q, k, v, g, sep):
    """Output and (dq, dk, dv) of ``sum(ring(q, k, v) * g)``, the ring
    mapped over ``sep`` virtual devices with the sequence split in rank
    order."""
    mesh = Mesh(np.array(jax.devices()[:sep]), ("sep",))
    spec = P(None, None, "sep", None)
    mapped = jax.shard_map(
        lambda q, k, v: jra.ring_attention(q, k, v, "sep", causal=True),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=True)
    out = jax.jit(mapped)(q, k, v)
    grads = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(mapped(q, k, v) * g), argnums=(0, 1, 2)))(
            q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


# ------------------------------------------------------------------ ring


@pytest.mark.parametrize("sep,S,D", [(2, 256, 64), (4, 512, 32)])
def test_ring_matches_jax(sep, S, D):
    """fp32: output at 2e-5 and dq/dk/dv at 1e-4 (both sides merge the
    same fp32 pair results; only the order of the sums inside a pair
    differs)."""
    q, k, v, g = _arrays((1, 2, S, D), 4, seed=sep, scale=0.5)
    out_j, grads_j = _jax_ring(q, k, v, g, sep)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = ra.ring_attention(tq, tk, tv, sep)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=2e-5,
                               rtol=2e-5)
    for a, b, name in zip((tq.grad, tk.grad, tv.grad), grads_j, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


def test_ring_equals_flash_and_counts_no_launch():
    """The ring over 4 shards computes causal attention over the whole
    sequence: the same output and grads as ``flash_attention`` (plain
    versions on the CPU) at 1e-5, and CPU calls launch no kernel."""
    q, k, v, g = _arrays((2, 2, 512, 32), 4, seed=7)
    before = (dict(fa.launches), dict(ra.launches))
    res = []
    for fn in (lambda *a: ra.ring_attention(*a, sep=4),
               lambda *a: fa.flash_attention(*a, causal=True)):
        tq, tk, tv = _t(q, k, v, grad=True)
        out = fn(tq, tk, tv)
        out.backward(torch.from_numpy(g))
        res.append([out.detach(), tq.grad, tk.grad, tv.grad])
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
    assert (dict(fa.launches), dict(ra.launches)) == before


def test_ring_bf16_keeps_dtype():
    q, k, v, g = _arrays((1, 2, 256, 32), 4, seed=8)
    tq, tk, tv = (t.bfloat16().requires_grad_(True) for t in _t(q, k, v))
    out = ra.ring_attention(tq, tk, tv, 2)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))
    ref = _naive_attention(*(t.detach().float() for t in (tq, tk, tv)),
                           causal=True)
    # two bf16 roundings of the output (the pair, then the merged sum)
    np.testing.assert_allclose(out.detach().float().numpy(), ref.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_ring_rejects_like_jax():
    q, k, v = _t(*_arrays((1, 1, 256, 32), 3, seed=9))
    with pytest.raises(NotImplementedError):
        ra.ring_attention(q, k, v, 2, causal=False)
    with pytest.raises(ValueError, match="128"):
        ra.ring_attention(q[:, :, :200], k[:, :, :200], v[:, :, :200], 2)
    with pytest.raises(ValueError, match="S % sep"):
        ra.ring_attention(q, k, v, 3)
    # the JAX wrapper's own check, for the same shard size
    mesh = Mesh(np.array(jax.devices()[:2]), ("sep",))
    with pytest.raises(ValueError, match="128"):
        jax.shard_map(
            lambda q, k, v: jra.ring_attention(q[:, :, :100], k[:, :, :100],
                                               v[:, :, :100], "sep"),
            mesh=mesh, in_specs=(P(None, None, "sep", None),) * 3,
            out_specs=P(None, None, "sep", None), check_vma=True,
        )(*(jnp.asarray(t.numpy()) for t in (q, k, v)))


# -------------------------------------------------------------- per pair


@pytest.mark.parametrize("causal", [True, False])
def test_pair_refs_match_jax(causal):
    """One pair, bf16 q/k/v and an fp32 dO (the training path's types):
    the plain forward and the plain backward with a ring-global lse and
    δ against the JAX package's.  Both compute in fp32 from the same
    bf16 values, so only summation order differs: 1e-4."""
    qn, kn, vn, don = _arrays((1, 2, 128, 64), 4, seed=10)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    scale = 1.0 / math.sqrt(64)
    out, lse = ra._pair_fwd_ref(q, k, v, scale, causal)
    out_j, lse_j = jra._pair_fwd_ref(jq, jk, jv, scale, causal)
    assert out.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-4,
                               rtol=1e-4)
    # a ring-global lse: this pair's merged with one more (log 2 larger)
    lse = lse + math.log(2.0)
    delta = (do * out).sum(-1)
    got = ra._pair_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    want = jra._pair_bwd_ref(jq, jk, jv, jnp.asarray(don),
                             jnp.asarray(lse.numpy()),
                             jnp.asarray(delta.numpy()), scale, causal)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_pair_bwd_ref_is_the_gradient_of_the_pair():
    """With the pair's own lse and δ the pair backward is the gradient of
    the plain pair forward."""
    q, k, v, do = _t(*_arrays((1, 2, 128, 32), 4, seed=11), grad=True)
    out, lse = ra._pair_fwd_ref(q, k, v, 0.2, True)
    out.backward(do.detach())
    got = ra._pair_bwd_ref(q.detach(), k.detach(), v.detach(), do.detach(),
                           lse.detach(), (do * out).sum(-1).detach(), 0.2,
                           True)
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------- flash head-dim padding


@pytest.mark.parametrize("D", [48, 80, 160, 192])
def test_flash_head_dim_padding_is_exact(D):
    """What the CUDA wrappers do for a D not in ``HEAD_DIMS``: zero-pad
    q/k/v/dO to the next size (256 for 128 < D < 256), run, slice; past
    512 they pad to the next multiple of 512, which the fp32 kernels walk
    in 512-column chunks.  Run
    here through the plain versions, against the JAX package's
    ``flash_attention`` (Pallas in interpret mode) and its gradient at
    1e-4, and against ``_naive_attention`` and its autograd at 1e-5."""
    q, k, v, do = _t(*_arrays((1, 2, 128, D), 4, seed=D))
    scale = 1.0 / math.sqrt(D)
    padded = fa._pad_head_dim(q, k, v, do)
    assert padded[0].shape[-1] == min(n for n in fa.HEAD_DIMS if n >= D)
    out_p, lse = fa._flash_fwd_ref(*padded[:3], scale, True)
    grads_p = fa._flash_bwd_ref(*padded[:3], out_p, lse, padded[3], scale,
                                True)
    out, dq, dk, dv = fa._unpad_head_dim(D, out_p, *grads_p)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    out_j = jax_flash(jq, jk, jv, causal=True)
    grads_j = jax.grad(lambda *a: jnp.sum(
        jax_flash(*a, causal=True) * jnp.asarray(do.numpy())),
        argnums=(0, 1, 2))(jq, jk, jv)
    for a, b in zip((out, dq, dk, dv), (out_j,) + tuple(grads_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    nq, nk, nv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = _naive_attention(nq, nk, nv, causal=True)
    ref.backward(do)
    for a, b in ((out, ref.detach()), (dq, nq.grad), (dk, nk.grad),
                 (dv, nv.grad)):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
    for wide, padded in ((640, 1024), (1024, 1024), (1100, 1536)):
        assert fa._pad_head_dim(torch.zeros(1, 1, 8, wide))[0].shape[-1] \
            == padded


# ---------------------------------------------------------------- engine

KW = dict(vocab_size=256, max_seq_len=512, hidden=64, num_layers=2,
          num_heads=2, ffn_hidden=128, dtype="float32", seq_parallel="ring")
STEPS, LR = 2, 1e-3


def _batch(B=2, S=512, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, KW["vocab_size"], (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


@pytest.fixture(scope="module")
def ring_runs():
    """2 steps of the JAX engine at sep=4 (ring over 4 virtual devices)
    and of the port's at sep=4 and sep=1, from the same params, Adam
    state and batch."""
    tokens, labels = _batch()
    jeng = JaxEngine(JaxGPTConfig(**KW), sep=4, devices=jax.devices()[:4])
    jp, jo = jeng.init(seed=0)
    p0 = params_from_jax(jp, device="cpu")
    canon0 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jlosses = []
    for _ in range(STEPS):
        jp, jo, loss = jeng.step(jp, jo, tokens, labels, lr=LR)
        jlosses.append(float(loss))
    runs = {"jax": (jlosses, _flat(jax.tree_util.tree_map(np.asarray, jp)))}
    for sep in (4, 1):
        eng = HybridEngine(GPTConfig(**KW), sep=sep, device="cpu")
        params = {k: (v.clone() if torch.is_tensor(v) else
                      {kk: vv.clone() for kk, vv in v.items()})
                  for k, v in p0.items()}
        opt = eng.opt_from_canonical({k: {**v} for k, v in canon0.items()})
        losses = [float(eng.step(params, opt, tokens, labels, lr=LR)[2])
                  for _ in range(STEPS)]
        runs[f"sep{sep}"] = (losses, _flat(params_to_numpy(params)))
    runs["p0"] = _flat(params_to_numpy(p0))
    return runs


@pytest.mark.parametrize("other", ["jax", "sep1"])
def test_ring_engine_matches(ring_runs, other):
    """The port's sep=4 ring engine against the JAX sep=4 ring engine and
    against the port's sep=1 engine, at ``test_torch_train.py``'s engine
    tolerances: losses atol 2e-4 / rtol 1e-4; every param within
    STEPS·lr, and the updates (p − p0) within 2e-5 + 1e-2 relative on
    99.9 % of each leaf's elements."""
    losses, params = ring_runs["sep4"]
    want_losses, want = ring_runs[other]
    np.testing.assert_allclose(losses, want_losses, atol=2e-4, rtol=1e-4)
    assert losses[-1] < losses[0]
    p0 = ring_runs["p0"]
    assert params.keys() == want.keys()
    for key in params:
        np.testing.assert_allclose(params[key], want[key], atol=STEPS * LR,
                                   rtol=0, err_msg=key)
        d, dw = params[key] - p0[key], want[key] - p0[key]
        close = np.abs(d - dw) <= 2e-5 + 1e-2 * np.abs(dw)
        assert close.mean() >= 0.999, (key, close.mean())


def test_engine_sep_axes_and_checks():
    """Ring sep > 1 builds; Ulysses sep > 1 and mp > 1 are still the
    multi-GPU slice; Ulysses with heads not divisible by sep fails the
    ported ``validate``; a step whose S does not split into sep shards
    of 128 raises before any work."""
    ring = GPTConfig(**KW)
    ulysses = dataclasses.replace(ring, seq_parallel="ulysses")
    assert HybridEngine(ring, sep=4, device="cpu").sep == 4
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        HybridEngine(ulysses, sep=2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        HybridEngine(ring, sep=2, mp=2, device="cpu")
    with pytest.raises(ValueError, match="head"):
        HybridEngine(ulysses, sep=4, device="cpu")
    eng = HybridEngine(ring, sep=4, device="cpu")
    params, opt = eng.init(seed=0)
    tokens, labels = _batch(S=256)
    with pytest.raises(ValueError, match="sep \\* 128"):
        eng.step(params, opt, tokens, labels)
    assert opt["step"] == 0


def test_engine_dropout_draws_a_mask_per_shard():
    """At sep = 4 each sequence shard draws its own mask (the shard index
    folded into the seed), the same one on every call; sep = 1 draws
    one mask over the whole sequence."""
    x = torch.ones(2, 512, 8)
    eng = HybridEngine(GPTConfig(**KW), sep=4, device="cpu")
    a, b = eng._dropout(x, 0.5, 123), eng._dropout(x, 0.5, 123)
    assert torch.equal(a, b)
    masks = [m != 0 for m in a.chunk(4, dim=1)]
    assert all(not torch.equal(masks[0], m) for m in masks[1:])
    one = HybridEngine(GPTConfig(**KW), device="cpu")._dropout(x, 0.5, 123)
    assert not torch.equal(one, a)
    assert torch.equal(eng._dropout(x, 0.0, 123), x)
