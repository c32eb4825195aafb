"""The port's tensor-parallel layers (``distributed/mp_layers.py``) at
mp = 2 against the JAX package's: ``ColumnParallelLinear`` +
``RowParallelLinear`` (forward in the JAX explicit ``shard_map`` mode,
gradients against JAX autodiff of the dense layers, as the JAX tests
hold them), a gathered column output, a row split of a whole input, the
vocab-parallel embedding and ``parallel_cross_entropy``.  Each rank of a
2-rank group (of one 4-rank CPU world) holds its partition of the same
numpy weights; its gradients are gathered here.  Tolerance 1e-5 (fp32,
sums in different orders)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.mp_layers import (ColumnParallelLinear,
                                              RowParallelLinear,
                                              parallel_cross_entropy)
from torch_world import World

MP = 2
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(0)
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    labels = rng.randint(0, 16, (3, 4))
    labels[0, :2] = -100
    return {"w1": f(8, 16), "b1": f(16), "w2": f(16, 8), "b2": f(8),
            "x": f(4, 8), "wy": f(4, 16), "h": f(4, 16), "wz": f(4, 8),
            "table": f(16, 6), "ids": rng.randint(0, 16, (3, 5)),
            "we": f(3, 5, 6), "logits": rng.randn(3, 4, 16).astype(
                np.float32), "labels": labels.astype(np.int64)}


@pytest.fixture(scope="module")
def ranks(world, arrays):
    return world.run("torch_dist_cases", "mp_layers_case", MP, arrays)[:MP]


def _mesh():
    return Mesh(np.array(jax.devices()[:MP]), ("mp",))


def _cat(parts, dim):
    return np.concatenate(parts, axis=dim)


def test_column_row_forward_matches_jax_explicit_mode(ranks, arrays):
    a = arrays
    col = ColumnParallelLinear(8, 16, gather_output=False, num_partitions=MP)
    row = RowParallelLinear(16, 8, input_is_parallel=True, num_partitions=MP)

    def local(w1, b1, w2, b2, xs):
        with col.swap_state({"weight": w1, "bias": b1}):
            with row.swap_state({"weight": w2, "bias": b2}):
                return row(col(Tensor(xs))).data

    want = jax.jit(jax.shard_map(
        local, mesh=_mesh(), in_specs=(P(None, "mp"), P("mp"),
                                       P("mp", None), P(), P()),
        out_specs=P(), check_vma=False))(a["w1"], a["b1"], a["w2"],
                                          a["b2"], a["x"])
    for r in ranks:
        np.testing.assert_allclose(r["mlp"], np.asarray(want), **TOL)


def test_column_row_grads_match_dense_autodiff(ranks, arrays):
    a = arrays

    def dense(x, w1, b1, w2, b2):
        return ((x @ w1 + b1) @ w2 + b2).sum()

    gx, gw1, gb1, gw2, gb2 = jax.grad(dense, argnums=(0, 1, 2, 3, 4))(
        a["x"], a["w1"], a["b1"], a["w2"], a["b2"])
    for r in ranks:
        np.testing.assert_allclose(r["mlp_grads"][0], gx, **TOL)
        np.testing.assert_allclose(r["mlp_grads"][4], gb2, **TOL)
    np.testing.assert_allclose(_cat([r["mlp_grads"][1] for r in ranks], 1),
                               gw1, **TOL)
    np.testing.assert_allclose(_cat([r["mlp_grads"][2] for r in ranks], 0),
                               gb1, **TOL)
    np.testing.assert_allclose(_cat([r["mlp_grads"][3] for r in ranks], 0),
                               gw2, **TOL)


def test_column_gather_output_matches_jax(ranks, arrays):
    a = arrays
    col = ColumnParallelLinear(8, 16, has_bias=False, gather_output=True,
                               num_partitions=MP)

    def local(w, xs):
        with col.swap_state({"weight": w}):
            return jax.lax.pmax(col(Tensor(xs)).data, "mp")

    want = jax.jit(jax.shard_map(local, mesh=_mesh(),
                                 in_specs=(P(None, "mp"), P()),
                                 out_specs=P(), check_vma=False))(
        a["w1"], a["x"])
    gx, gw = jax.grad(lambda x, w: ((x @ w) * a["wy"]).sum(),
                      argnums=(0, 1))(a["x"], a["w1"])
    for r in ranks:
        np.testing.assert_allclose(r["col_gather"], np.asarray(want), **TOL)
        np.testing.assert_allclose(r["col_gather_grads"][0], gx, **TOL)
    np.testing.assert_allclose(
        _cat([r["col_gather_grads"][1] for r in ranks], 1), gw, **TOL)


def test_row_splits_unparallel_input_matches_jax(ranks, arrays):
    a = arrays
    row = RowParallelLinear(16, 8, has_bias=False, input_is_parallel=False,
                            num_partitions=MP)

    def local(w, hs):
        with row.swap_state({"weight": w}):
            return row(Tensor(hs)).data

    want = jax.jit(jax.shard_map(local, mesh=_mesh(),
                                 in_specs=(P("mp", None), P()),
                                 out_specs=P(), check_vma=False))(
        a["w2"], a["h"])
    gh, gw = jax.grad(lambda h, w: ((h @ w) * a["wz"]).sum(),
                      argnums=(0, 1))(a["h"], a["w2"])
    for r in ranks:
        np.testing.assert_allclose(r["row_split"], np.asarray(want), **TOL)
        np.testing.assert_allclose(r["row_split_grads"][0], gh, **TOL)
    np.testing.assert_allclose(
        _cat([r["row_split_grads"][1] for r in ranks], 0), gw, **TOL)


def test_vocab_parallel_embedding_matches_jax(ranks, arrays):
    a = arrays
    want = jnp.take(a["table"], a["ids"], axis=0)
    gt = jax.grad(lambda t: (jnp.take(t, a["ids"], axis=0) * a["we"]).sum())(
        a["table"])
    for r in ranks:
        np.testing.assert_allclose(r["embed"], np.asarray(want), **TOL)
    np.testing.assert_allclose(_cat([r["embed_grad"] for r in ranks], 0),
                               gt, **TOL)


def test_parallel_cross_entropy_matches_jax(ranks, arrays):
    """Per-token CE of vocab-split logits against JAX's
    ``parallel_cross_entropy`` in ``shard_map``, and the logits' gradient
    of the mean CE against JAX autodiff."""
    a = arrays
    want = jax.jit(jax.shard_map(
        lambda lg, lb: parallel_cross_entropy(lg, lb, mp_axis="mp"),
        mesh=_mesh(), in_specs=(P(None, None, "mp"), P()), out_specs=P(),
        check_vma=False))(a["logits"], a["labels"])
    mask = (a["labels"] != -100).astype(np.float32)

    def dense(lg):
        logp = jax.nn.log_softmax(lg, axis=-1)
        tok = -jnp.take_along_axis(logp, jnp.maximum(a["labels"], 0)[
            ..., None], -1)[..., 0]
        return (tok * mask).sum() / mask.sum()

    g = jax.grad(dense)(a["logits"])
    for r in ranks:
        np.testing.assert_allclose(r["ce"], np.asarray(want), **TOL)
    np.testing.assert_allclose(_cat([r["ce_grad"] for r in ranks], -1), g,
                               **TOL)
