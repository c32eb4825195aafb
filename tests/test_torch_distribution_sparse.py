"""The port's ``distribution``, ``sparse`` and ``contrib.sparsity``
against the JAX package's on the same seeded inputs.

Distributions: ``log_prob``, ``prob``, ``entropy``, ``kl_divergence``
and the moments at fp32 1e-5, and the gradient of ``log_prob`` with
respect to the parameters held to ``jax.grad``'s.  Sampling cannot match
JAX's PRNG: it is held to ``paddle.seed`` reproducibility, to the
shapes, and to the distributions' means and variances over 2e5 draws
(5 standard errors).  Sparse: COO and CSR conversions, ``to_dense``,
``matmul`` (and its gradient in the dense operand) and ``add``, equal to
JAX (indices exactly).  ASP: the 2:4 masks equal JAX's bit for bit, and
pruned weights stay zero through a decorated optimizer."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.contrib.sparsity as jasp
import paddle_tpu.distribution as jd
import paddle_tpu.sparse as jsp

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.contrib.sparsity as tasp
import paddle_tpu_torch.distribution as td
import paddle_tpu_torch.sparse as tsp

tpaddle.set_device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "data", x))


def close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def rng(seed):
    return np.random.RandomState(seed)


def params(name, seed=0, n=(3, 4)):
    r = rng(seed)
    if name == "Normal":
        return (r.randn(*n).astype(np.float32),
                (r.rand(*n) + 0.5).astype(np.float32))
    if name == "Uniform":
        lo = r.randn(*n).astype(np.float32)
        return lo, (lo + r.rand(*n) + 0.5).astype(np.float32)
    if name == "Categorical":
        return (r.randn(*n, 5).astype(np.float32),)
    if name == "Bernoulli":
        return ((r.rand(*n) * 0.9 + 0.05).astype(np.float32),)
    if name == "Beta":
        return ((r.rand(*n) * 3 + 0.5).astype(np.float32),
                (r.rand(*n) * 12 + 0.5).astype(np.float32))
    if name == "Dirichlet":
        return ((r.rand(*n, 5) * 3 + 0.3).astype(np.float32),)


def values(name, seed=1, n=(3, 4)):
    r = rng(seed)
    if name in ("Normal",):
        return r.randn(*n).astype(np.float32)
    if name == "Uniform":
        lo, hi = params(name)
        return (lo + (hi - lo) * r.rand(*n) * 1.2 - 0.1).astype(np.float32)
    if name == "Categorical":
        return r.randint(0, 5, n)
    if name == "Bernoulli":
        return (r.rand(*n) < 0.5).astype(np.float32)
    if name == "Beta":
        return (r.rand(*n) * 0.9 + 0.05).astype(np.float32)
    if name == "Dirichlet":
        v = r.rand(*n, 5) + 0.1
        return (v / v.sum(-1, keepdims=True)).astype(np.float32)


NAMES = ["Normal", "Uniform", "Categorical", "Bernoulli", "Beta",
         "Dirichlet"]
ENTROPY = ["Normal", "Uniform", "Categorical", "Bernoulli"]


@pytest.mark.parametrize("name", NAMES)
def test_log_prob_and_prob_match_jax(name):
    p, v = params(name), values(name)
    j = getattr(jd, name)(*p)
    t = getattr(td, name)(*[torch.tensor(a) for a in p])
    tv = torch.tensor(v)
    want = _np(j.log_prob(v))
    got = _np(t.log_prob(tv))
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    close(t.prob(tv), j.prob(v))


def test_beta_log_prob_past_the_algdiv_switch_matches_jax():
    """``betaln`` switches to scipy's ``algdiv`` at b >= 8, as JAX's."""
    a = np.array([0.7, 2.0, 5.0, 30.0, 9.0], np.float32)
    b = np.array([8.5, 7.99, 40.0, 30.0, 120.0], np.float32)
    v = np.array([0.1, 0.3, 0.2, 0.5, 0.05], np.float32)
    close(td.Beta(torch.tensor(a), torch.tensor(b)).log_prob(
        torch.tensor(v)), jd.Beta(a, b).log_prob(v))


@pytest.mark.parametrize("name", NAMES)
def test_log_prob_gradients_match_jax(name):
    p, v = params(name), values(name)

    def jloss(*ps):
        return jnp.sum(getattr(jd, name)(*ps).log_prob(v).data)

    jg = jax.grad(jloss, argnums=tuple(range(len(p))))(
        *[jnp.asarray(a) for a in p])
    tps = [torch.tensor(a, requires_grad=True) for a in p]
    lp = getattr(td, name)(*tps).log_prob(torch.tensor(v))
    lp[torch.isfinite(lp)].sum().backward() if name == "Uniform" \
        else lp.sum().backward()
    for tp_, g in zip(tps, jg):
        close(tp_.grad, g)


@pytest.mark.parametrize("name", ENTROPY)
def test_entropy_and_moments_match_jax(name):
    p = params(name, 2)
    j = getattr(jd, name)(*p)
    t = getattr(td, name)(*[torch.tensor(a) for a in p])
    close(t.entropy(), j.entropy())
    for m in ("mean", "variance"):
        if hasattr(type(j), m):
            close(getattr(t, m), getattr(j, m))
    if name == "Categorical":
        close(t.probs, j.probs)


@pytest.mark.parametrize("name", ENTROPY)
def test_kl_divergence_matches_jax(name):
    p1, p2 = params(name, 3), params(name, 4)
    if name == "Uniform":       # q covers p in half the cells
        p2 = (p1[0] - np.where(np.arange(12).reshape(3, 4) % 2, 0.2, -0.2)
              .astype(np.float32), p1[1] + 0.3)
    jp, jq = getattr(jd, name)(*p1), getattr(jd, name)(*p2)
    tp_ = getattr(td, name)(*[torch.tensor(a) for a in p1])
    tq = getattr(td, name)(*[torch.tensor(a) for a in p2])
    want = _np(jd.kl_divergence(jp, jq))
    got = _np(td.kl_divergence(tp_, tq))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    close(tp_.kl_divergence(tq), got)


def test_unregistered_kl_pair_raises_like_jax():
    with pytest.raises(NotImplementedError, match="not registered"):
        td.kl_divergence(td.Normal(0.0, 1.0), td.Uniform(0.0, 1.0))
    with pytest.raises(ValueError, match="logits or probs"):
        td.Categorical()
    b = td.Bernoulli(logits=torch.tensor([0.3]))
    jb = jd.Bernoulli(logits=np.array([0.3], np.float32))
    close(b.mean, jb.mean)


SAMPLERS = {
    "Normal": (lambda t: t.Normal(np.float32(1.5), np.float32(2.0)),
               1.5, 4.0),
    "Uniform": (lambda t: t.Uniform(np.float32(-1.0), np.float32(3.0)),
                1.0, 16.0 / 12),
    "Bernoulli": (lambda t: t.Bernoulli(np.float32(0.3)), 0.3, 0.21),
    "Beta": (lambda t: t.Beta(np.float32(2.0), np.float32(5.0)),
             2.0 / 7, 10.0 / (49 * 8)),
    "Categorical": (lambda t: t.Categorical(
        logits=np.log(np.array([0.2, 0.5, 0.3], np.float32))),
        1.1, 0.5 + 1.2 - 1.21),
    "Dirichlet": (lambda t: t.Dirichlet(np.array([2.0, 3.0, 5.0],
                                                 np.float32)),
                  0.2, 0.2 * 0.8 / 11),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampling_is_seeded_and_has_the_right_moments(name):
    make, mean, var = SAMPLERS[name]
    n = 200_000
    tpaddle.seed(11)
    a = make(td).sample((n,))
    tpaddle.seed(11)
    b = make(td).sample((n,))
    c = make(td).sample((n,))
    assert torch.equal(a, b) and not torch.equal(b, c)
    x = a.double()
    if name == "Dirichlet":
        assert tuple(a.shape) == (n, 3)
        torch.testing.assert_close(a.sum(-1), torch.ones(n), atol=1e-5,
                                   rtol=0)
        x = x[:, 0]
    else:
        assert tuple(a.shape) == (n,)
    se = (var / n) ** 0.5
    assert abs(float(x.mean()) - mean) < 5 * se, (float(x.mean()), mean)
    assert abs(float(x.var()) - var) < 0.02 * var + 1e-3


def test_rsample_carries_gradients():
    loc = torch.tensor([0.5], requires_grad=True)
    scale = torch.tensor([2.0], requires_grad=True)
    tpaddle.seed(0)
    td.Normal(loc, scale).rsample((1000,)).mean().backward()
    assert torch.allclose(loc.grad, torch.ones(1))
    assert scale.grad is not None


# ----------------------------------------------------------------- sparse


def _coo_parts(seed, shape=(6, 5), density=0.3, dup=True):
    r = rng(seed)
    dense = (r.rand(*shape) < density) * r.randn(*shape)
    rows, cols = np.nonzero(dense)
    idx = np.stack([rows, cols])
    vals = dense[rows, cols].astype(np.float32)
    if dup and len(vals):       # a duplicate entry, summed by to_dense
        idx = np.concatenate([idx, idx[:, :1]], 1)
        vals = np.concatenate([vals, np.float32([0.5])])
    perm = r.permutation(len(vals))
    return idx[:, perm], vals[perm]


def _pair(seed, **kw):
    idx, vals = _coo_parts(seed, **kw)
    shape = kw.get("shape", (6, 5))
    return (jsp.sparse_coo_tensor(idx, vals, shape=shape),
            tsp.sparse_coo_tensor(torch.tensor(idx), torch.tensor(vals),
                                  shape=shape))


def test_coo_matches_jax():
    j, t = _pair(0)
    assert t.shape == j.shape and t.nnz == j.nnz
    np.testing.assert_array_equal(_np(t.indices()), _np(j.indices()))
    close(t.values(), j.values())
    close(t.to_dense(), j.to_dense())
    close(tsp.to_dense(t), jsp.to_dense(j))
    idx, vals = _coo_parts(1, dup=False)
    inferred = tsp.sparse_coo_tensor(idx, vals, dtype="float64")
    assert inferred.shape == jsp.sparse_coo_tensor(idx, vals).shape
    assert inferred.values().dtype == torch.float64


def test_csr_conversions_match_jax():
    j, t = _pair(2, dup=False)
    jc, tc = j.to_sparse_csr(), t.to_sparse_csr()
    for a, b in ((tc.crows(), jc.crows()), (tc.cols(), jc.cols())):
        np.testing.assert_array_equal(_np(a), _np(b))
    close(tc.values(), jc.values())
    close(tc.to_dense(), jc.to_dense())
    back_t, back_j = tc.to_sparse_coo(), jc.to_sparse_coo()
    np.testing.assert_array_equal(_np(back_t.indices()),
                                  _np(back_j.indices()))
    direct = tsp.sparse_csr_tensor(_np(jc.crows()), _np(jc.cols()),
                                   _np(jc.values()), jc.shape)
    close(direct.to_dense(), jc.to_dense())
    assert "nnz" in repr(tc) and "nnz" in repr(t)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_matmul_and_its_gradient_match_jax(fmt):
    j, t = _pair(3, shape=(8, 6), dup=fmt == "coo")
    if fmt == "csr":
        j, t = j.to_sparse_csr(), t.to_sparse_csr()
    b = rng(4).randn(6, 3).astype(np.float32)
    ct = rng(5).randn(8, 3).astype(np.float32)
    want = jsp.matmul(j, b)
    jg = jax.grad(lambda bb: jnp.sum(jsp.matmul(j, bb).data * ct))(
        jnp.asarray(b))
    tb = torch.tensor(b, requires_grad=True)
    got = tsp.matmul(t, tb)
    (got * torch.tensor(ct)).sum().backward()
    close(got, want)
    close(tb.grad, jg)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_add_matches_jax(fmt):
    (ja, ta), (jb, tb) = _pair(6), _pair(7)
    if fmt == "csr":
        ja, ta = ja.to_sparse_csr(), ta.to_sparse_csr()
    jo, to = jsp.add(ja, jb), tsp.add(ta, tb)
    assert type(to).__name__ == type(jo).__name__
    close(to.to_dense(), jo.to_dense())
    if fmt == "coo":
        np.testing.assert_array_equal(_np(to.indices()), _np(jo.indices()))
    with pytest.raises(ValueError, match="shape mismatch"):
        tsp.add(ta, _pair(8, shape=(3, 3))[1])


# -------------------------------------------------------------------- ASP


@pytest.mark.parametrize("shape,n,m", [((8, 16), 2, 4), ((3, 4, 8), 1, 4),
                                       ((6, 10), 2, 4), ((4, 12), 3, 6)])
def test_masks_match_jax(shape, n, m):
    w = rng(9).randn(*shape).astype(np.float32)
    want = jasp.create_mask(w, n, m)
    got = tasp.create_mask(torch.tensor(w), n, m)
    np.testing.assert_array_equal(got, want)
    assert tasp.check_mask(w * got, n, m) == jasp.check_mask(w * want, n, m)
    assert tasp.check_mask(torch.tensor(w), n, m) == \
        jasp.check_mask(w, n, m)


def test_prune_and_decorate_match_jax():
    """Three SGD steps of a pruned MLP in both packages from the same
    weights: the masks, the weights after each step (pruned entries
    zero) and the losses agree."""
    from torch_eager_ref import carry

    jpaddle.seed(2)

    def net(p):
        return p.nn.Sequential(p.nn.Linear(16, 16), p.nn.ReLU(),
                               p.nn.Linear(16, 4))

    jnet = net(jpaddle)
    tnet = carry(jnet, net(tpaddle))
    jh, th = jasp.prune_model(jnet), tasp.prune_model(tnet)
    assert sorted(th.masks()) == sorted(jh.masks())
    for k, v in th.masks().items():
        np.testing.assert_array_equal(_np(v), np.asarray(jh.masks()[k]))
    jopt = jasp.decorate(jpaddle.optimizer.SGD(
        learning_rate=0.1, parameters=jnet.parameters()), jnet)
    topt = tasp.decorate(tpaddle.optimizer.SGD(
        learning_rate=0.1, parameters=tnet.parameters()), tnet)
    x = rng(3).randn(8, 16).astype(np.float32)
    for _ in range(3):
        jl = (jnet(jpaddle.to_tensor(x)) ** 2).mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = (tnet(torch.tensor(x)) ** 2).mean()
        tl.backward()
        topt.step()
        topt.clear_grad()
        close(tl, jl)
    assert tasp.check_mask(tnet[0].weight) and tasp.check_mask(tnet[2].weight)
    for (k, a), b in zip(tnet.state_dict().items(),
                         jnet.state_dict().values()):
        close(a, b, atol=1e-6, rtol=1e-5)
