"""The inputs of every registered op's conformance case, and the port's
side of a case's run: shared by ``tests/test_torch_ops.py`` (the port on
the CPU against the JAX package) and ``chip_smoke.py`` phase 20 (a) (the
port on the card against the port on the CPU).  numpy and torch only:
``chip_smoke.py`` imports it without JAX.

A case names an op, the generators of its positional arguments (numpy
arrays made from a seed derived from the case's id), its keywords, its
tolerance against the JAX package on the CPU (``TOL`` = 1e-5;
``LOOSE`` = 1e-4 for reductions over more than 10^3 elements and
linear algebra) and whether its gradient, that of the sum of every
floating output, is compared.
"""
import numpy as np
import torch

TOL = dict(atol=1e-5, rtol=1e-5)
LOOSE = dict(atol=1e-4, rtol=1e-4)
#: decompositions held by reconstruction (their signs are free)
SPECIAL = {"qr", "svd", "eigh"}
#: ops whose draws cannot match across packages or devices
RANDOM = {"bernoulli", "exponential", "multinomial", "normal", "poisson",
          "rand", "randint", "randn", "randperm", "standard_normal",
          "uniform", "gumbel_softmax"}


# ------------------------------------------------------------- inputs


def R(*shape, lo=-1.0, hi=1.0):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def P(*shape):
    return R(*shape, lo=0.1, hi=1.0)


def I(lo, hi, *shape):  # noqa: E743
    return lambda rng: rng.integers(lo, hi, shape).astype(np.int64)


def B(*shape):
    return lambda rng: rng.uniform(size=shape) < 0.5


def SPD(n):
    def make(rng):
        a = rng.uniform(-1, 1, (n, n)).astype(np.float32)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def L(*gens):
    return lambda rng: [g(rng) for g in gens]


def Const(value):
    return lambda rng: value


class Case:
    def __init__(self, name, *args, kw=None, grad=True, tol=TOL, tag=""):
        self.name, self.args, self.kw = name, args, kw or {}
        self.grad, self.tol, self.tag = grad, tol, tag

    @property
    def id(self):
        return self.name + (f"[{self.tag}]" if self.tag else "")


def sum_outputs(outs, ops):
    total = None
    for o in outs:
        term = ops.sum(o)
        total = term if total is None else total + term
    return total


C = Case
CASES = [
    # ------------------------------------------------------------ math
    C("add", R(3, 4), R(3, 4)), C("add", R(3, 4), R(4), tag="broadcast"),
    C("add", R(3, 4), Const(2.5), tag="scalar"),
    C("subtract", R(3, 4), R(3, 4)), C("multiply", R(3, 4), R(1, 4)),
    C("divide", R(3, 4), P(3, 4)), C("floor_divide", R(3, 4), P(3, 4)),
    C("floor_divide", I(-9, 9, 3, 4), I(1, 4, 3, 4), tag="int"),
    C("remainder", R(3, 4, lo=-3, hi=3), P(3, 4)),
    C("pow", P(3, 4), R(3, 4)), C("pow", R(3, 4), Const(2.0), tag="scalar"),
    C("maximum", R(3, 4), R(3, 4)), C("minimum", R(3, 4), R(3, 4)),
    C("fmax", R(3, 4), R(3, 4)), C("fmin", R(3, 4), R(3, 4)),
    C("atan2", R(3, 4), R(3, 4)), C("hypot", R(3, 4), R(3, 4)),
    C("scale", R(3, 4), kw=dict(scale=2.0, bias=0.5)),
    C("scale", R(3, 4), kw=dict(scale=2.0, bias=0.5,
                                bias_after_scale=False), tag="before"),
    C("abs", R(3, 4)), C("neg", R(3, 4)), C("sign", R(3, 4)),
    C("exp", R(3, 4)), C("expm1", R(3, 4)), C("log", P(3, 4)),
    C("log2", P(3, 4)), C("log10", P(3, 4)), C("log1p", P(3, 4)),
    C("sqrt", P(3, 4)), C("rsqrt", P(3, 4)), C("square", R(3, 4)),
    C("reciprocal", P(3, 4)), C("sin", R(3, 4)), C("cos", R(3, 4)),
    C("tan", R(3, 4)), C("asin", R(3, 4, lo=-0.9, hi=0.9)),
    C("acos", R(3, 4, lo=-0.9, hi=0.9)), C("atan", R(3, 4)),
    C("sinh", R(3, 4)), C("cosh", R(3, 4)), C("tanh", R(3, 4)),
    C("asinh", R(3, 4)), C("acosh", R(3, 4, lo=1.1, hi=3.0)),
    C("atanh", R(3, 4, lo=-0.9, hi=0.9)),
    C("ceil", R(3, 4, lo=-3, hi=3)), C("floor", R(3, 4, lo=-3, hi=3)),
    C("round", R(3, 4, lo=-3, hi=3)), C("trunc", R(3, 4, lo=-3, hi=3)),
    C("frac", R(3, 4, lo=-3, hi=3)), C("erf", R(3, 4)),
    C("erfinv", R(3, 4, lo=-0.9, hi=0.9)), C("lgamma", R(3, 4, lo=0.5, hi=3)),
    C("digamma", R(3, 4, lo=0.5, hi=3)), C("sigmoid", R(3, 4)),
    C("logit", R(3, 4, lo=0.1, hi=0.9)),
    C("logit", R(3, 4, lo=0.0, hi=1.0), kw=dict(eps=0.2), tag="eps"),
    C("clip", R(3, 4), kw=dict(min=-0.5, max=0.5)),
    C("clip", R(3, 4), kw=dict(min=-0.2), tag="min"),
    C("isnan", R(3, 4)), C("isinf", R(3, 4)), C("isfinite", R(3, 4)),
    C("nan_to_num", Const(np.array([1.0, np.nan, np.inf, -np.inf, -2.0],
                                   np.float32)),
      kw=dict(nan=0.5, posinf=9.0, neginf=-9.0)),
    C("multiply_add", R(3, 4), R(3, 4), R(3, 4)), C("stanh", R(3, 4)),
    C("softplus", R(3, 4, lo=-30, hi=30)),
    C("logsumexp", R(3, 4)), C("logsumexp", R(3, 4, 5),
                               kw=dict(axis=1, keepdim=True), tag="axis"),
    C("lerp", R(3, 4), R(3, 4), R(3, 4)),
    C("lerp", R(3, 4), R(3, 4), Const(0.3), tag="scalar"),
    C("cumsum", R(3, 4)), C("cumsum", R(3, 4), kw=dict(axis=1), tag="axis"),
    C("cumprod", R(3, 4)), C("cumprod", R(3, 4), kw=dict(dim=0), tag="dim"),
    # (the JAX op's default axis=-1 raises in lax.cummax: axis 1 here)
    C("cummax", R(3, 6), kw=dict(axis=1)),
    C("cummin", R(3, 6), kw=dict(axis=0)),
    C("diff", R(3, 6)), C("diff", R(5, 6), kw=dict(n=2, axis=0), tag="n2"),
    C("gcd", I(-20, 20, 3, 4), I(1, 20, 3, 4)),
    C("lcm", I(-20, 20, 3, 4), I(1, 20, 3, 4)),
    C("equal", I(0, 3, 3, 4), I(0, 3, 3, 4)),
    C("not_equal", I(0, 3, 3, 4), I(0, 3, 3, 4)),
    C("less_than", R(3, 4), R(3, 4)), C("less_equal", I(0, 3, 6), I(0, 3, 6)),
    C("greater_than", R(3, 4), R(3, 4)),
    C("greater_equal", I(0, 3, 6), I(0, 3, 6)),
    C("logical_and", B(3, 4), B(3, 4)), C("logical_or", B(3, 4), B(3, 4)),
    C("logical_xor", B(3, 4), B(3, 4)), C("logical_not", B(3, 4)),
    C("bitwise_and", I(0, 64, 3, 4), I(0, 64, 3, 4)),
    C("bitwise_or", I(0, 64, 3, 4), I(0, 64, 3, 4)),
    C("bitwise_xor", I(0, 64, 3, 4), I(0, 64, 3, 4)),
    C("bitwise_not", I(-64, 64, 3, 4)),
    C("allclose", R(3, 4), R(3, 4)),
    C("allclose", Const(np.ones((3, 4), np.float32)),
      Const(np.ones((3, 4), np.float32) + 1e-7), tag="close"),
    C("isclose", R(3, 4), R(3, 4)),
    C("equal_all", I(0, 2, 3, 4), I(0, 2, 3, 4)),
    C("equal_all", Const(np.arange(4)), Const(np.arange(4)), tag="same"),
    C("where", B(3, 4), R(3, 4), R(3, 4)),
    C("heaviside", Const(np.array([-1.0, 0.0, 2.0, 0.0], np.float32)),
      Const(np.array([0.3, 0.5, 0.7, 0.9], np.float32))),
    # -------------------------------------------------------- creation
    C("zeros", Const([2, 3])), C("ones", Const([2, 3])),
    C("full", Const([2, 3]), Const(1.5)),
    C("zeros_like", R(2, 3)), C("ones_like", R(2, 3)),
    C("full_like", R(2, 3), Const(-2.0)),
    C("arange", Const(0), Const(10), Const(3)),
    C("arange", Const(0.0), Const(2.0), Const(0.25), tag="float"),
    C("linspace", Const(-1.0), Const(2.0), Const(7)),
    C("eye", Const(3), Const(4)), C("diag", R(4)),
    C("diag", R(4, 4), kw=dict(offset=1), tag="matrix"),
    C("diagflat", R(2, 2), kw=dict(offset=-1)),
    C("tril", R(4, 5), kw=dict(diagonal=1)), C("triu", R(4, 5)),
    C("meshgrid", R(3), R(4)), C("assign", R(3, 4)), C("clone", R(3, 4)),
    C("empty", Const([2, 3])), C("empty_like", R(2, 3)),
    C("complex", R(3, 4), R(3, 4), grad=False),
    # ---------------------------------------------------- manipulation
    C("cast", R(3, 4), Const("float16"), tol=dict(atol=1e-3, rtol=1e-3)),
    C("cast", I(-5, 5, 3, 4), Const("float32"), tag="int"),
    C("reshape", R(3, 4), Const([2, 6])),
    C("reshape", R(3, 4), Const([-1, 3]), tag="infer"),
    C("flatten", R(2, 3, 4), kw=dict(start_axis=1)),
    C("flatten", R(2, 3, 4, 5), kw=dict(start_axis=1, stop_axis=2),
      tag="middle"),
    C("transpose", R(2, 3, 4), Const([2, 0, 1])),
    C("transpose_last2", R(2, 3, 4)),
    C("moveaxis", R(2, 3, 4), Const(0), Const(2)),
    C("swapaxes", R(2, 3, 4), Const(0), Const(2)),
    C("unsqueeze", R(3, 4), Const(1)),
    C("unsqueeze", R(3, 4), Const([0, 3]), tag="list"),
    C("squeeze", R(3, 1, 4, 1)),
    C("squeeze", R(3, 1, 4, 1), kw=dict(axis=1), tag="axis"),
    C("squeeze", R(3, 1, 4, 1), kw=dict(axis=[0, 3]), tag="list"),
    C("concat", L(R(2, 3), R(4, 3))),
    C("concat", L(R(2, 3), R(2, 5)), kw=dict(axis=1), tag="axis"),
    C("stack", L(R(2, 3), R(2, 3), R(2, 3)), kw=dict(axis=1)),
    C("unstack", R(3, 4), kw=dict(axis=1)),
    C("split", R(6, 4), Const(3)),
    C("split", R(6, 4), Const([1, -1, 2]), tag="sections"),
    C("split", R(4, 6), Const([2, 4]), kw=dict(axis=1), tag="axis"),
    C("chunk", R(6, 4), Const(2)),
    C("tile", R(2, 3), Const([2, 1, 2])),
    C("expand", R(1, 3), Const([4, -1])),
    C("expand", R(3), Const([2, 4, 3]), tag="rank"),
    C("expand_as", R(1, 3), R(4, 3)), C("broadcast_to", R(3), Const([2, 3])),
    C("flip", R(3, 4), Const(1)), C("flip", R(3, 4), Const([0, 1]), tag="list"),
    C("roll", R(3, 4), Const(2)),
    C("roll", R(3, 4), Const(1), kw=dict(axis=1), tag="axis"),
    C("rot90", R(3, 4)), C("rot90", R(2, 3, 4), kw=dict(k=3, axes=(1, 2)),
                           tag="k3"),
    C("gather", R(5, 3), I(0, 5, 4)),
    C("gather", R(5, 3), I(0, 3, 2, 2), kw=dict(axis=1), tag="rank2"),
    C("gather_nd", R(4, 5, 3), I(0, 4, 6, 2)),
    C("take_along_axis", R(4, 5), I(0, 5, 4, 3), Const(1)),
    C("put_along_axis", R(4, 5), Const(np.array([[0], [2], [4], [1]])),
      R(4, 1), Const(1)),
    C("put_along_axis", R(4, 5), Const(np.array([[0, 3], [2, 1], [4, 0],
                                                 [1, 2]])),
      R(4, 2), Const(1), kw=dict(reduce="add"), tag="add"),
    C("put_along_axis", R(4, 5), Const(np.array([[0], [2], [4], [1]])),
      R(4, 1), Const(1), kw=dict(reduce="mul"), tag="mul",
      grad=False),     # JAX: scatter_mul has no gradient unless unique
    C("scatter", R(5, 3), Const(np.array([3, 0, 1])), R(3, 3)),
    C("scatter", R(5, 3), Const(np.array([3, 0, 3])), R(3, 3),
      kw=dict(overwrite=False), tag="add"),
    C("scatter_nd_add", R(4, 5), Const(np.array([[0, 1], [2, 3], [0, 1]])),
      R(3)),
    C("index_select", R(5, 3), I(0, 5, 6)),
    C("index_select", R(5, 3), I(0, 3, 4), kw=dict(axis=1), tag="axis"),
    C("index_sample", R(4, 6), I(0, 6, 4, 3)),
    C("masked_select", R(3, 4), B(3, 4), grad=False),
    C("masked_fill", R(3, 4), B(3, 4), Const(-7.0)),
    C("pad", R(2, 3, 4), Const([1, 2])),
    C("pad", R(2, 3, 4), Const([1, 0, 0, 2, 2, 1]), tag="all_dims"),
    C("pad", R(1, 2, 4, 5), Const([1, 2, 2, 1]), kw=dict(mode="reflect"),
      tag="reflect"),
    C("pad", R(1, 2, 4, 5), Const([1, 2, 2, 1]), kw=dict(mode="replicate"),
      tag="replicate"),
    C("pad", R(1, 2, 4, 5), Const([1, 2, 2, 1]), kw=dict(mode="circular"),
      tag="circular"),
    C("pad", R(2, 3), Const([1, 1]), kw=dict(value=0.5), tag="value"),
    C("getitem", R(4, 5), Const((slice(1, 3), slice(None, None, 2)))),
    C("getitem", R(4, 5), Const(2), tag="int"),
    C("getitem", R(4, 5, 3), Const((Ellipsis, 1)), tag="ellipsis"),
    C("slice", R(4, 5, 6), Const([0, 2]), Const([1, 2]), Const([3, 5])),
    C("strided_slice", R(6, 7), Const([0, 1]), Const([0, 1]), Const([6, 7]),
      Const([2, 3])),
    C("strided_slice", R(6, 7), Const([1]), Const([5]), Const([0]),
      Const([-2]), tag="negative"),
    C("repeat_interleave", R(3, 2), Const(2), kw=dict(axis=0)),
    C("repeat_interleave", R(3, 2), Const(2), tag="flat"),
    C("unbind", R(3, 4), kw=dict(axis=1)),
    C("as_real", Const((np.arange(6) + 1j * np.arange(6)[::-1]).astype(
        np.complex64))),
    C("as_complex", R(3, 2)),
    C("one_hot", I(0, 5, 6), Const(5)), C("unique", I(0, 5, 12)),
    C("nonzero", Const(np.array([[0, 1, 0], [2, 0, 3]], np.float32))),
    C("shard_index", I(0, 20, 8), Const(20), Const(4), Const(1)),
    # ------------------------------------------------------- reduction
    C("sum", R(3, 4)), C("sum", R(3, 4, 5), kw=dict(axis=[0, 2]), tag="list"),
    C("sum", R(3, 4), kw=dict(axis=1, keepdim=True), tag="keepdim"),
    C("sum", I(0, 5, 3, 4), kw=dict(axis=0), tag="int"),
    C("sum", R(40, 50), tol=LOOSE, tag="2000"),
    C("mean", R(3, 4)), C("mean", R(3, 4, 5), kw=dict(axis=-1), tag="axis"),
    C("max", R(3, 4)), C("max", R(3, 4), kw=dict(axis=0), tag="axis"),
    C("min", R(3, 4)), C("min", R(3, 4), kw=dict(axis=[0, 1], keepdim=True),
                         tag="keep"),
    C("prod", R(3, 4)), C("prod", R(3, 4, 2), kw=dict(axis=[0, 2]),
                          tag="list"),
    C("amax", R(3, 4), kw=dict(axis=1)), C("amin", R(3, 4), kw=dict(axis=0)),
    C("std", R(3, 4)), C("std", R(3, 4), kw=dict(axis=1, unbiased=False),
                         tag="biased"),
    C("var", R(3, 4)), C("var", R(3, 4), kw=dict(axis=0, keepdim=True),
                         tag="keep"),
    C("median", R(3, 5)), C("median", R(4, 6), kw=dict(axis=1), tag="even"),
    C("quantile", R(3, 5), Const(0.3)),
    C("quantile", R(3, 5), Const(0.75), kw=dict(axis=1), tag="axis"),
    C("nanmean", Const(np.array([[1.0, np.nan, 3.0], [4.0, 5.0, np.nan]],
                                np.float32))),
    C("nansum", Const(np.array([[1.0, np.nan, 3.0], [4.0, 5.0, np.nan]],
                               np.float32)), kw=dict(axis=1)),
    C("all", B(3, 4)), C("all", B(3, 4), kw=dict(axis=1), tag="axis"),
    C("any", B(3, 4)), C("any", B(3, 4), kw=dict(axis=0), tag="axis"),
    C("count_nonzero", I(0, 3, 3, 4)),
    C("count_nonzero", I(0, 3, 3, 4), kw=dict(axis=1, keepdim=True),
      tag="axis"),
    C("argmax", R(3, 4)), C("argmax", R(3, 4), kw=dict(axis=1, keepdim=True),
                            tag="axis"),
    C("argmin", R(3, 4)), C("argmin", R(3, 4), kw=dict(axis=0), tag="axis"),
    # ---------------------------------------------------------- search
    C("sort", R(3, 5)), C("sort", R(3, 5), kw=dict(axis=0, descending=True),
                          tag="desc"),
    C("argsort", R(3, 5)), C("argsort", R(3, 5), kw=dict(descending=True),
                             tag="desc"),
    C("topk", R(3, 6), Const(2)),
    C("topk", R(5, 4), Const(3), kw=dict(axis=0, largest=False),
      tag="smallest"),
    C("kthvalue", R(3, 6), Const(2)),
    C("kthvalue", R(5, 3), Const(4), kw=dict(axis=0, keepdim=True),
      tag="axis"),
    C("mode", I(0, 3, 4, 7), grad=False),
    C("searchsorted", Const(np.array([0.1, 0.3, 0.5, 0.9], np.float32)),
      R(3, 2, lo=0, hi=1)),
    C("searchsorted", Const(np.array([[1, 3, 5], [2, 4, 6]])),
      Const(np.array([[3, 6], [1, 4]])), kw=dict(right=True), tag="batched"),
    C("index_of_max", R(3, 4)),
    C("bucketize", R(5, lo=0, hi=1), Const(np.array([0.2, 0.5, 0.8],
                                                     np.float32))),
    # ---------------------------------------------------------- linalg
    C("matmul", R(3, 4), R(4, 5)),
    C("matmul", R(2, 4, 3), R(2, 5, 4), kw=dict(transpose_x=True,
                                                transpose_y=True),
      tag="transposed"),
    C("matmul", R(2, 3, 4), R(4), tag="vector"),
    C("mm", R(3, 4), R(4, 5)), C("bmm", R(2, 3, 4), R(2, 4, 5)),
    C("dot", R(3, 4), R(3, 4)), C("inner", R(3, 4), R(5, 4)),
    C("outer", R(3), R(4)), C("cross", R(4, 3), R(4, 3)),
    C("cross", R(3, 4), R(3, 4), kw=dict(axis=0), tag="axis"),
    C("t", R(3, 4)),
    C("norm", R(3, 4)), C("norm", R(3, 4), kw=dict(p=1, axis=1), tag="p1"),
    C("norm", R(3, 4), kw=dict(p=float("inf")), tag="inf"),
    C("norm", R(3, 4), kw=dict(p="fro", axis=[0, 1]), tag="fro_axes"),
    C("dist", R(3, 4), R(3, 4)),
    C("dist", R(3, 4), R(3, 4), kw=dict(p=float("inf")), tag="inf"),
    C("dist", R(3, 4), R(3, 4), kw=dict(p=0), tag="p0"),
    C("trace_op", R(4, 5)), C("trace_op", R(4, 5), kw=dict(offset=1),
                              tag="offset"),
    C("kron", R(2, 3), R(3, 2)),
    C("matrix_power", SPD(3), Const(3), tol=LOOSE),
    C("inverse", SPD(4), tol=LOOSE), C("pinv", R(4, 3), tol=LOOSE),
    C("det", SPD(3), tol=LOOSE), C("slogdet", SPD(3), tol=LOOSE),
    C("cholesky", SPD(4), tol=LOOSE),
    C("cholesky", SPD(4), kw=dict(upper=True), tol=LOOSE, tag="upper"),
    C("eigvalsh", SPD(4), tol=LOOSE),
    C("matrix_rank", Const(np.array([[1, 2], [2, 4], [0, 1]], np.float32))),
    C("solve", SPD(4), R(4, 2), tol=LOOSE),
    C("triangular_solve", Const(np.triu(np.arange(1, 17).reshape(4, 4))
                                .astype(np.float32)), R(4, 2), tol=LOOSE),
    C("triangular_solve", Const(np.tril(np.arange(1, 17).reshape(4, 4))
                                .astype(np.float32) + 4 * np.eye(4, dtype=
                                                                 np.float32)),
      R(4, 2), kw=dict(upper=False, transpose=True), tol=LOOSE,
      tag="lower_t"),
    C("lstsq", R(5, 3), R(5, 2), tol=LOOSE),
    C("multi_dot", L(R(2, 3), R(3, 4), R(4, 2))),
    C("einsum", Const("bij,bjk->bik"), R(2, 3, 4), R(2, 4, 5)),
    C("mv", R(3, 4), R(4)),
    C("histogram", R(50), kw=dict(bins=5, min=-1, max=1)),
    C("histogram", R(50), kw=dict(bins=4), tag="data_range"),
    C("bincount", I(0, 6, 20)),
    C("bincount", I(0, 6, 20), kw=dict(minlength=8), tag="minlength"),
    # ------------------------------------------------------ activation
    C("relu", R(3, 4)), C("relu6", R(3, 4, lo=-8, hi=8)),
    C("leaky_relu", R(3, 4), kw=dict(negative_slope=0.2)),
    C("prelu", R(4, 3), P(3)), C("elu", R(3, 4)), C("selu", R(3, 4)),
    C("celu", R(3, 4), kw=dict(alpha=0.7)), C("gelu", R(3, 4)),
    C("gelu", R(3, 4), kw=dict(approximate=True), tag="tanh"),
    C("silu", R(3, 4)), C("hardswish", R(3, 4, lo=-5, hi=5)),
    C("hardsigmoid", R(3, 4, lo=-5, hi=5)), C("hardtanh", R(3, 4, lo=-2, hi=2)),
    C("hardshrink", R(3, 4)), C("softshrink", R(3, 4)),
    C("tanhshrink", R(3, 4)), C("thresholded_relu", R(3, 4, lo=0, hi=2)),
    C("log_sigmoid", R(3, 4)), C("maxout", R(2, 6, 3), Const(2)),
    C("softmax", R(3, 4)), C("softmax", R(3, 4), kw=dict(axis=0), tag="axis"),
    C("log_softmax", R(3, 4)), C("softsign", R(3, 4)), C("mish", R(3, 4)),
    C("glu", R(3, 4)), C("glu", R(4, 3), kw=dict(axis=0), tag="axis"),
    C("tanh", R(3, 4)),
    # ---------------------------------------------------------- nn ops
    C("conv2d", R(2, 3, 6, 6), R(4, 3, 3, 3), R(4)),
    C("conv2d", R(2, 4, 7, 7), R(4, 2, 3, 3), kw=dict(
        stride=2, padding=1, groups=2), tag="grouped"),
    C("conv2d", R(1, 2, 7, 6), R(3, 2, 3, 2), kw=dict(
        padding="SAME", dilation=2), tag="same"),
    C("conv1d", R(2, 3, 9), R(4, 3, 3), kw=dict(padding=1)),
    C("conv3d", R(1, 2, 4, 5, 5), R(3, 2, 2, 3, 3)),
    C("conv2d_transpose", R(2, 3, 4, 4), R(3, 2, 3, 3), kw=dict(stride=2)),
    C("max_pool2d", R(2, 3, 6, 6), Const(2)),
    C("max_pool2d", R(1, 2, 7, 7), Const(3), kw=dict(stride=2, padding=1,
                                                     ceil_mode=True),
      tag="ceil"),
    C("avg_pool2d", R(2, 3, 6, 6), Const(2)),
    C("avg_pool2d", R(1, 2, 7, 7), Const(3), kw=dict(stride=2, padding=1),
      tag="padded"),
    C("adaptive_avg_pool2d", R(2, 3, 6, 6), Const(3)),
    C("adaptive_avg_pool2d", R(1, 2, 7, 5), Const((3, 2)), tag="uneven"),
    C("adaptive_max_pool2d", R(2, 3, 6, 6), Const(2)),
    C("global_avg_pool2d", R(2, 3, 4, 5)),
    C("layer_norm", R(3, 8), P(8), R(8)),
    C("layer_norm", R(2, 3, 4), P(3, 4), R(3, 4),
      kw=dict(normalized_ndim=2), tag="2d"),
    C("rms_norm", R(3, 8), P(8)),
    C("batch_norm_infer", R(4, 3, 2, 2), R(3), P(3), P(3), R(3)),
    C("batch_norm_train", R(4, 3, 2, 2), P(3), R(3)),
    C("instance_norm", R(2, 3, 4, 4), P(3), R(3)),
    C("group_norm", R(2, 4, 3, 3), Const(2), P(4), R(4)),
    C("local_response_norm", R(2, 6, 3, 3), Const(3)),
    C("embedding", I(0, 6, 3, 4), R(6, 5)),
    C("embedding", I(0, 6, 3, 4), R(6, 5), kw=dict(padding_idx=2),
      tag="padding"),
    C("dropout", R(3, 4), kw=dict(training=False)),
    C("dropout", R(3, 4), kw=dict(training=False, mode="downscale_in_infer"),
      tag="downscale"),
    C("dropout2d", R(2, 3, 4, 4), kw=dict(training=False)),
    C("interpolate", R(1, 2, 4, 5), kw=dict(size=(8, 10))),
    C("interpolate", R(1, 2, 4, 5), kw=dict(size=(7, 3)), tag="nearest_odd"),
    C("interpolate", R(1, 2, 4, 5), kw=dict(scale_factor=2, mode="bilinear"),
      tag="bilinear_up"),
    C("interpolate", R(1, 2, 8, 6), kw=dict(size=(3, 4), mode="bilinear"),
      tag="bilinear_down"),
    C("interpolate", R(1, 2, 4, 4), kw=dict(size=(7, 6), mode="bicubic"),
      tag="bicubic"),
    C("pixel_shuffle", R(2, 8, 3, 3), Const(2)),
    C("unfold", R(2, 3, 5, 5), Const(2)),
    C("unfold", R(1, 2, 6, 5), Const([3, 2]), kw=dict(
        strides=2, paddings=1, dilations=1), tag="strided"),
    # ------------------------------------------------------------ loss
    C("cross_entropy", R(4, 5), I(0, 5, 4)),
    C("cross_entropy", R(4, 5), I(0, 5, 4), kw=dict(
        ignore_index=1, weight=np.float32([1, 2, 3, 4, 5])), tag="weighted"),
    C("cross_entropy", R(4, 5), Const(np.full((4, 5), 0.2, np.float32)),
      kw=dict(soft_label=True), tag="soft"),
    C("softmax_with_cross_entropy", R(4, 5), I(0, 5, 4, 1)),
    C("nll_loss", R(4, 5, lo=-3, hi=0), I(0, 5, 4)),
    C("mse_loss", R(3, 4), R(3, 4)),
    C("l1_loss", R(3, 4), R(3, 4), kw=dict(reduction="sum")),
    C("smooth_l1_loss", R(3, 4, lo=-3, hi=3), R(3, 4)),
    C("binary_cross_entropy", R(3, 4, lo=0.05, hi=0.95),
      R(3, 4, lo=0, hi=1)),
    C("binary_cross_entropy_with_logits", R(3, 4), R(3, 4, lo=0, hi=1)),
    C("kl_div", R(3, 4, lo=-2, hi=0), P(3, 4)),
    C("margin_ranking_loss", R(6), R(6), Const(np.float32([1, -1, 1, 1,
                                                           -1, -1])),
      kw=dict(margin=0.1)),
    C("hinge_embedding_loss", R(6), Const(np.float32([1, -1, 1, 1, -1, -1]))),
    C("cosine_similarity", R(3, 4), R(3, 4)),
    C("cosine_similarity", R(3, 4, 2), R(3, 4, 2), kw=dict(axis=-1),
      tag="axis"),
    C("square_error_cost", R(3, 4), R(3, 4)),
    C("sigmoid_focal_loss", R(3, 4), R(3, 4, lo=0, hi=1)),
    C("sigmoid_focal_loss", R(3, 4), R(3, 4, lo=0, hi=1), kw=dict(
        normalizer=2.0, reduction="mean"), tag="mean"),
    C("label_smooth", R(3, 4, lo=0, hi=1)),
    C("label_smooth", R(3, 4, lo=0, hi=1), kw=dict(
        prior_dist=np.float32([0.1, 0.2, 0.3, 0.4])), tag="prior"),
    C("ctc_loss", Const(np.log(np.random.default_rng(5).dirichlet(
        np.ones(5), (7, 2))).astype(np.float32)),
      Const(np.array([[1, 2, 2], [3, 1, 0]])), Const(np.array([7, 5])),
      Const(np.array([3, 2]))),
    C("ctc_loss", Const(np.log(np.random.default_rng(6).dirichlet(
        np.ones(4), (6, 2))).astype(np.float32)),
      Const(np.array([[1, 1], [2, 3]])), Const(np.array([6, 6])),
      Const(np.array([2, 2])), kw=dict(reduction="none"), tag="none"),
    # ------------------------------------------------ attention, misc
    C("scaled_dot_product_attention", R(2, 2, 5, 8), R(2, 2, 5, 8),
      R(2, 2, 5, 8)),
    C("scaled_dot_product_attention", R(2, 2, 5, 8), R(2, 2, 5, 8),
      R(2, 2, 5, 8), kw=dict(is_causal=True), tag="causal"),
    C("fake_quant", R(3, 4), Const(0.8)),
    C("sequence_mask", Const(np.array([2, 4, 1])), kw=dict(maxlen=5)),
    C("sequence_pool", R(3, 5, 2), kw=dict(pool_type="average",
                                           lengths=np.array([2, 5, 1]))),
    C("sequence_pool", R(3, 5, 2), kw=dict(pool_type="max",
                                           lengths=np.array([2, 5, 1])),
      tag="max"),
    C("sequence_pool", R(3, 5, 2), kw=dict(pool_type="last",
                                           lengths=np.array([2, 5, 1])),
      tag="last"),
    C("sequence_pool", R(3, 5), kw=dict(pool_type="sqrt",
                                        lengths=np.array([2, 5, 1])),
      tag="sqrt"),
    C("sequence_reverse", R(3, 5, 2), kw=dict(lengths=np.array([2, 5, 1]))),
    C("sequence_softmax", R(3, 5), kw=dict(lengths=np.array([2, 5, 1]))),
]


# -------------------------------------------------------------- running

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.data if hasattr(x, "data") else x)


def outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def leaves(args):
    out = []
    for a in args:
        if isinstance(a, list):
            out.extend(leaves(a))
        else:
            out.append(a)
    return out


def inputs(case):
    """The case's argument values, from its own seed."""
    rng = np.random.default_rng(sum(map(ord, case.id)))
    return [g(rng) for g in case.args]


def convert(value, make, grad):
    if isinstance(value, np.ndarray):
        return make(value, grad)
    if isinstance(value, list) and value and all(
            isinstance(v, np.ndarray) for v in value):
        return [make(v, grad) for v in value]
    return value


def run_port(case, ops, get_op, device="cpu"):
    """Run ``case`` through the port's registered op on ``device``:
    ``(outputs, gradients)`` as numpy (gradients ``None`` when the op or
    the case has none)."""
    grad = case.grad and get_op(case.name).differentiable

    def make(a, g):
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        if g and t.is_floating_point():
            t.requires_grad_(True)
        return t

    kw = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
          and v.dtype.kind == "f" else v for k, v in case.kw.items()}
    args = [convert(v, make, grad) for v in inputs(case)]
    outs = outputs(get_op(case.name).eager_fn(*args, **kw))
    fwd = [_np(o) for o in outs]
    if not grad:
        return fwd, None
    floats = [o for o in outs if o.is_floating_point()]
    loss = sum_outputs(floats, ops)
    if loss is None:
        return fwd, None
    ins = [a for a in leaves(args)
           if isinstance(a, torch.Tensor) and a.is_floating_point()]
    if loss.requires_grad:
        loss.backward()
    return fwd, [np.zeros(tuple(a.shape), np.float32) if a.grad is None
                 else _np(a.grad) for a in ins]


def close(got, want, tol, what):
    """Outputs (or gradients) of two runs equal at ``tol``: booleans
    exactly, integers and floats by value."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, f"{what} {i}: {g.shape} vs {w.shape}"
        if w.dtype == np.bool_ or g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {i}")
        elif np.iscomplexobj(w):
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} {i}")
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), **tol,
                                       err_msg=f"{what} {i}")
