"""The port's op corpus against the JAX package's, op by op.

Every op of the JAX package's corpus (the 284 that its ``ops/`` and
``contrib/quant.py`` register, ``jax_corpus``) runs in both packages on
the same numpy inputs, made from a seed, and the outputs are held to
each other at fp32 ``atol = rtol = 1e-5``; where the
op is differentiable, so is the gradient of ``sum(op(...))`` (over every
floating output) with respect to every floating input, the port's torch
autograd against the JAX package's tape.  1e-4 is used, and marked
``tol=LOOSE``, for reductions over more than 10^3 elements and for
linear algebra (LAPACK and XLA factor in other orders).  The
sign-ambiguous decompositions (``qr``, ``svd``, ``eigh``) are held by
reconstruction and orthogonality, their spectra to JAX's, and their
gradients through sign-free functions of the factors.  The random ops
cannot match JAX's PRNG: they are held to ``paddle.seed``
reproducibility and to their distributions, as the JAX tests hold them.
Integer outputs compare by value: the JAX package runs in JAX's 32-bit
mode, where int64 is int32.

Left out of the port, with the reason:
- ``core/vma.py``: shard_map's varying axes have no torch counterpart;
- ``core/autograd.py``'s ``TapeNode``/``run_backward*``: torch's autograd
  does that work, with ``paddle_tpu_torch.autograd.backward``;
- ``distributed/ps``, ``distributed/fleet_executor.py`` and
  ``distributed/auto_parallel/``: the multi-GPU slice (ROADMAP item 5).
``fft``, ``signal``, ``distribution``, ``sparse``, ``text``, ``onnx``,
``device``, ``framework_io``, ``utils``, ``incubate``, ``nn/layer/rnn.py``
and the vision data and detection modules are ported (their
``tests/test_torch_*.py`` hold them to the JAX package).  None of these
modules registers an op in the JAX package's ``ops/``; the registry
parity below holds the port to that corpus (``jax_corpus``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.ops as jops
from paddle_tpu.core.dispatch import get_op as jget_op
from paddle_tpu.core.dispatch import list_ops as jlist_ops

import paddle_tpu_torch as paddle
import paddle_tpu_torch.ops as pops
from paddle_tpu_torch.core.dispatch import get_op as pget_op

from torch_op_cases import (CASES, LOOSE, RANDOM, SPECIAL, TOL, close,
                            convert, inputs, leaves, outputs, run_port,
                            sum_outputs)



def jax_corpus():
    """The JAX package's op corpus: the ops its ``ops/`` and
    ``contrib/quant.py`` register (284).  Its registry can hold more,
    depending on what the process imported: ``parallel_cross_entropy``
    (``distributed/mp_layers.py``, tensor parallelism: ROADMAP item 5)
    and ops tests register through ``incubate.custom_op``."""
    out = set()
    for name in jlist_ops():
        fn = jget_op(name).pure_fn
        mod = getattr(getattr(fn, "fun", fn), "__module__", "")
        if mod.startswith("paddle_tpu.ops.") or \
                mod == "paddle_tpu.contrib.quant":
            out.add(name)
    return out


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -------------------------------------------------------------- running


def _run_jax(case):
    grad = case.grad and jget_op(case.name).differentiable

    def make(a, g):
        return jpaddle.to_tensor(a, stop_gradient=not (
            g and a.dtype.kind == "f"))

    kw = {k: jpaddle.to_tensor(v) if isinstance(v, np.ndarray) and
          v.dtype.kind == "f" else v for k, v in case.kw.items()}
    args = [convert(v, make, grad) for v in inputs(case)]
    outs = outputs(jget_op(case.name).eager_fn(*args, **kw))
    fwd = [np.asarray(o.numpy()) for o in outs]
    if not grad:
        return fwd, None
    floats = [o for o in outs if np.issubdtype(o.numpy().dtype,
                                               np.floating)]
    loss = sum_outputs(floats, jops)
    if loss is None:
        return fwd, None
    ins = [a for a in leaves(args) if hasattr(a, "numpy") and
           np.issubdtype(a.numpy().dtype, np.floating)]
    loss.backward()
    return fwd, [np.zeros(tuple(a.shape), np.float32) if a.grad is None
                 else a.grad.numpy() for a in ins]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_op_matches_jax(case):
    want_fwd, want_grad = _run_jax(case)
    got_fwd, got_grad = run_port(case, pops, pget_op)
    close(got_fwd, want_fwd, case.tol, f"{case.id} output")
    assert (got_grad is None) == (want_grad is None), case.id
    if want_grad is not None:
        close(got_grad, want_grad, case.tol, f"{case.id} gradient")


def test_registry_covers_the_jax_corpus():
    """Every op name of the JAX corpus is registered in the port and none
    else, every one is tested here, and differentiability agrees."""
    jax_names = jax_corpus()
    port_names = set(paddle.core.list_ops())
    assert len(jax_names) == 284
    assert jax_names - port_names == set()
    assert port_names - jax_names == set()
    tested = {c.name for c in CASES} | SPECIAL | RANDOM
    assert jax_names - tested == set()
    for name in jax_names:
        assert pget_op(name).differentiable == \
            jget_op(name).differentiable, name


# ------------------------------------------- sign-ambiguous decompositions


def _spd(n, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (n, n)).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("shape,mode", [((5, 3), "reduced"),
                                        ((4, 4), "reduced"),
                                        ((5, 3), "complete")])
def test_qr_reconstructs_and_is_orthogonal(shape, mode):
    a = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    x = torch.from_numpy(a).requires_grad_(True)
    q, r = pops.qr(x, mode=mode)
    np.testing.assert_allclose((q @ r).detach().numpy(), a, **LOOSE)
    qtq = (q.T @ q).detach().numpy()
    np.testing.assert_allclose(qtq, np.eye(qtq.shape[0]), **LOOSE)
    assert np.allclose(np.triu(r.detach().numpy()), r.detach().numpy())
    # JAX differentiates the reduced factorisation only
    jq, jr = jops.qr(jpaddle.to_tensor(a), mode=mode)
    # |R| does not depend on the signs the factorisation picks
    np.testing.assert_allclose(np.abs(r.detach().numpy()),
                               np.abs(jr.numpy()), **LOOSE)
    if mode == "reduced":
        xj = jpaddle.to_tensor(a, stop_gradient=False)
        jops.sum(jops.abs(jops.qr(xj)[1])).backward()
        pops.sum(pops.abs(r)).backward()
        np.testing.assert_allclose(x.grad.numpy(), xj.grad.numpy(), **LOOSE)


@pytest.mark.parametrize("shape,full", [((5, 3), False), ((3, 4), False),
                                        ((4, 4), True)])
def test_svd_reconstructs_and_is_orthogonal(shape, full):
    a = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    x = torch.from_numpy(a).requires_grad_(True)
    u, s, vh = pops.svd(x, full_matrices=full)
    k = s.shape[0]
    rec = (u[:, :k] * s) @ vh[:k]
    np.testing.assert_allclose(rec.detach().numpy(), a, **LOOSE)
    for m in (u, vh.T):
        mtm = (m.T @ m).detach().numpy()
        np.testing.assert_allclose(mtm, np.eye(mtm.shape[0]), **LOOSE)
    xj = jpaddle.to_tensor(a, stop_gradient=False)
    ju, js, jvh = jops.svd(xj, full_matrices=full)
    np.testing.assert_allclose(s.detach().numpy(), js.numpy(), **LOOSE)
    # the singular values' gradient, U Vᵀ, is sign-free
    pops.sum(s).backward()
    jops.sum(js).backward()
    np.testing.assert_allclose(x.grad.numpy(), xj.grad.numpy(), **LOOSE)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_reconstructs_and_is_orthogonal(uplo):
    a = _spd(4, 3)
    x = torch.from_numpy(a).requires_grad_(True)
    w, v = pops.eigh(x, UPLO=uplo)
    rec = (v * w) @ v.T
    np.testing.assert_allclose(rec.detach().numpy(), a, **LOOSE)
    np.testing.assert_allclose((v.T @ v).detach().numpy(), np.eye(4),
                               **LOOSE)
    xj = jpaddle.to_tensor(a, stop_gradient=False)
    jw, jv = jops.eigh(xj, UPLO=uplo)
    np.testing.assert_allclose(w.detach().numpy(), jw.numpy(), **LOOSE)
    # the eigenvalues and |v|² are sign-free
    weights = np.arange(1, 5, dtype=np.float32)
    pops.sum(w * torch.from_numpy(weights)) .backward(retain_graph=True)
    jops.sum(jops.multiply(jw, jpaddle.to_tensor(weights))).backward()
    np.testing.assert_allclose(x.grad.numpy(), xj.grad.numpy(), **LOOSE)


# ------------------------------------------------------------ random ops


RANDOM_CASES = {
    "uniform": (lambda ops, **k: ops.uniform([4000], min=-2.0, max=3.0,
                                             **k), 0.5, 25 / 12),
    "rand": (lambda ops, **k: ops.rand([4000], **k), 0.5, 1 / 12),
    "randn": (lambda ops, **k: ops.randn([4000], **k), 0.0, 1.0),
    "standard_normal": (lambda ops, **k: ops.standard_normal([4000], **k),
                        0.0, 1.0),
    "normal": (lambda ops, **k: ops.normal(2.0, 0.5, [4000], **k), 2.0,
               0.25),
    "randint": (lambda ops, **k: ops.randint(0, 10, [4000], **k), 4.5,
                8.25),
    "randperm": (lambda ops, **k: ops.randperm(4000, **k), 1999.5,
                 (4000 ** 2 - 1) / 12),
    "bernoulli": (lambda ops, **k: ops.bernoulli(
        torch.full((4000,), 0.3), **k), 0.3, 0.21),
    "poisson": (lambda ops, **k: ops.poisson(torch.full((4000,), 3.0), **k),
                3.0, 3.0),
    "exponential": (lambda ops, **k: ops.exponential(
        torch.zeros(4000), lam=2.0, **k), 0.5, 0.25),
    "multinomial": (lambda ops, **k: ops.multinomial(
        torch.tensor([0.1, 0.2, 0.7]), 4000, replacement=True, **k),
        1.6, 0.44),
    "gumbel_softmax": (lambda ops, **k: ops.gumbel_softmax(
        torch.log(torch.tensor([[0.1, 0.2, 0.7]]).expand(4000, 3)), **k)
        .argmax(-1), 1.6, 0.44),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_op_is_seeded_and_distributed(name):
    """``paddle.seed`` fixes the draws, another seed changes them, and the
    sample mean and variance of 4000 draws lie within 5 standard errors
    of the distribution's (the JAX tests' kind of check)."""
    draw, mean, var = RANDOM_CASES[name]
    paddle.seed(11)
    a = draw(pops).double()
    paddle.seed(11)
    b = draw(pops).double()
    paddle.seed(12)
    c = draw(pops).double()
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    n = a.numel()
    assert abs(float(a.mean()) - mean) < 5 * (var / n) ** 0.5
    assert abs(float(a.var()) - var) < 0.15 * var
    gen = torch.Generator().manual_seed(3)
    d = draw(pops, key=gen).double()
    gen.manual_seed(3)
    assert torch.equal(d, draw(pops, key=gen).double())


@pytest.mark.parametrize("name,p", [("dropout", 0.3), ("dropout2d", 0.5)])
def test_dropout_keeps_one_minus_p_and_rescales(name, p):
    paddle.seed(5)
    x = torch.ones(64, 32, 4, 4)
    out = getattr(pops, name)(x, p=p, training=True)
    kept = out != 0
    draws = x.numel() if name == "dropout" else 64 * 32
    assert abs(float(kept.float().mean()) - (1 - p)) < \
        5 * (p * (1 - p) / draws) ** 0.5
    assert torch.allclose(out[kept], torch.tensor(1 / (1 - p)))
    if name == "dropout2d":      # whole channels
        per_channel = kept.float().mean((2, 3))
        assert set(per_channel.unique().tolist()) <= {0.0, 1.0}
    paddle.seed(5)
    assert torch.equal(out, getattr(pops, name)(x, p=p, training=True))


def test_gumbel_softmax_rows_and_straight_through():
    paddle.seed(0)
    x = torch.randn(6, 5, requires_grad=True)
    soft = pops.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(soft.sum(-1).detach().numpy(), 1.0, rtol=1e-5)
    hard = pops.gumbel_softmax(x, hard=True)
    assert torch.equal(hard.detach().sum(-1), torch.ones(6))
    assert set(hard.detach().unique().tolist()) <= {0.0, 1.0}
    (hard * torch.arange(5.0)).sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


# ------------------------------------------------------------ beam search


def test_beam_search_matches_jax():
    """``beam_search`` with its ``step_fn(history, t) -> log_probs``
    contract: the same decoder table in both packages, the same
    sequences and scores (the port's loop against the JAX ``lax.scan``)."""
    import jax.numpy as jnp

    from paddle_tpu.ops.search import beam_search as jbeam

    V, B, K, T = 7, 2, 3, 5
    table = np.log(np.random.default_rng(4).dirichlet(np.ones(V), V)
                   ).astype(np.float32)

    def jstep(hist, t):
        last = jnp.take_along_axis(hist, jnp.full(hist.shape[:2] + (1,), t),
                                   2)[..., 0]
        return jnp.asarray(table)[last]

    def pstep(hist, t):
        return torch.from_numpy(table)[hist[:, :, t].long()]

    jseq, jsc = jbeam(jstep, 1, 0, K, T, batch_size=B)
    pseq, psc = pops.beam_search(pstep, 1, 0, K, T, batch_size=B,
                                 device="cpu")
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), **TOL)
    jseq, jsc = jbeam(jstep, 1, 0, K, T, batch_size=B, length_penalty=0.6)
    pseq, psc = pops.beam_search(pstep, 1, 0, K, T, batch_size=B,
                                 length_penalty=0.6, device="cpu")
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), **TOL)


@pytest.mark.parametrize("case", ["pad", "unpad", "expand"])
def test_sequence_layout_helpers_match_jax(case):
    from paddle_tpu.ops import sequence as jseq

    from paddle_tpu_torch.ops import sequence as pseq

    rng = np.random.default_rng(9)
    ln = np.array([2, 4, 1])
    if case == "pad":
        flat = rng.uniform(size=(7, 3)).astype(np.float32)
        want = jseq.sequence_pad(flat, ln, maxlen=5, pad_value=-1.0)
        got = pseq.sequence_pad(torch.from_numpy(flat), ln, maxlen=5,
                                pad_value=-1.0)
    elif case == "unpad":
        padded = rng.uniform(size=(3, 4, 2)).astype(np.float32)
        want = jseq.sequence_unpad(padded, ln)
        got = pseq.sequence_unpad(torch.from_numpy(padded), ln)
    else:
        x = rng.uniform(size=(3, 2)).astype(np.float32)
        want = jseq.sequence_expand(x, np.array([2, 0, 3]))
        got = pseq.sequence_expand(torch.from_numpy(x), np.array([2, 0, 3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
