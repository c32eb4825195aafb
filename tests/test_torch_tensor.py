"""The port's Tensor surface and its core helpers: ``to_tensor``'s dtype
inference and placement against the JAX package's rules,
``stop_gradient``, ``Parameter``, the error taxonomy (``enforce``), the
flag table and what ``check_nan_inf`` and ``benchmark`` do in the
dispatch, and the Paddle-only Tensor methods: added only where
``torch.Tensor`` has no attribute of that name, so torch's own meanings
(``x.split(2)``, ``x.transpose(0, 1)``, ``x.max(0)``) stay torch's."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core import enforce as jenforce
from paddle_tpu.core import flags as jflags

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dispatch, enforce, flags
from paddle_tpu_torch.core import tensor as ptensor


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


# (data, dtype): the JAX package's inference, less JAX's 32-bit mode
# (Python ints are int64 in the port, int32 under JAX without x64)
INFER = [
    ([1.0, 2.0], torch.float32), (1.5, torch.float32),
    (np.float64(2.0), torch.float32), (True, torch.bool),
    ([True, False], torch.bool), (np.array([1.0, 2.0]), torch.float32),
    (np.array([1, 2], np.int32), torch.int32),
    (np.array(3.0, np.float16), torch.float16), ([[1, 2.5]], torch.float32),
    (3 + 4j, torch.complex64), ([1, 2], torch.int64), (7, torch.int64),
]


@pytest.mark.parametrize("data,dtype", INFER,
                         ids=[repr(d)[:20] for d, _ in INFER])
def test_to_tensor_infers_the_dtype(data, dtype):
    t = paddle.to_tensor(data)
    assert t.dtype == dtype
    want = jpaddle.to_tensor(data).numpy()
    assert tuple(t.shape) == want.shape
    np.testing.assert_array_equal(t.numpy(), want.astype(t.numpy().dtype))


def test_to_tensor_default_dtype_and_explicit_dtype():
    paddle.set_default_dtype("float64")
    try:
        assert paddle.to_tensor(1.5).dtype == torch.float64
        assert paddle.to_tensor([1.0]).dtype == torch.float32
    finally:
        paddle.set_default_dtype("float32")
    assert paddle.to_tensor([1, 2], dtype="float32").dtype == torch.float32
    assert paddle.to_tensor(np.ones(2), dtype="bfloat16").dtype == \
        torch.bfloat16
    assert paddle.tensor([1, 2]).dtype == torch.int64


def test_to_tensor_copies_and_places():
    src = torch.ones(3)
    t = paddle.to_tensor(src)
    t += 1
    assert torch.equal(src, torch.ones(3))
    a = np.zeros(2, np.float32)
    t = paddle.to_tensor(a)
    a[0] = 5
    assert float(t[0]) == 0
    assert t.device.type == "cpu"
    assert paddle.to_tensor([1.0], place=paddle.CPUPlace()).device.type == \
        "cpu"
    assert paddle.to_tensor([1.0], place="cpu").device.type == "cpu"


def test_to_tensor_raises_without_cuda_unless_the_cpu_is_set():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default place is the card")
    import threading

    errors = []

    def fresh_thread():   # the place is thread-local: a new thread has none
        try:
            paddle.to_tensor([1.0])
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=fresh_thread)
    t.start()
    t.join()
    assert errors and "CUDA is not available" in errors[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.to_tensor([1.0], place=paddle.CUDAPlace(0))


def test_stop_gradient():
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    assert x.requires_grad and not x.stop_gradient
    y = paddle.sum(paddle.multiply(x, x))
    y.backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[2.0, 4.0]])
    x.clear_grad()
    assert x.grad is None
    x.stop_gradient = True
    assert not x.requires_grad
    assert paddle.to_tensor([1.0]).stop_gradient
    # an integer tensor has no gradient, whatever stop_gradient says
    assert not paddle.to_tensor([1, 2], stop_gradient=False).requires_grad


def test_parameter():
    p = paddle.Parameter(torch.zeros(3))
    assert isinstance(p, torch.nn.Parameter) and p.trainable
    assert p.optimize_attr == {"learning_rate": 1.0} and p.name is None
    q = paddle.Parameter(torch.zeros(2), trainable=False, name="w")
    assert not q.requires_grad and q.name == "w" and q.stop_gradient
    assert paddle.nn.Parameter is paddle.Parameter
    lin = paddle.nn.Linear(2, 3)
    assert isinstance(lin.weight, paddle.Parameter)
    assert paddle.is_tensor(lin.weight) and not paddle.is_tensor([1])
    assert paddle.Tensor is torch.Tensor


def test_paddle_methods_are_added_only_where_torch_has_none():
    added = ptensor.patch_tensor_methods(paddle.ops)
    torch_own = set(dir(torch._C.TensorBase)) | set(vars(torch.Tensor))
    assert set(added) == set(ptensor._PADDLE_ONLY)
    for name in added:
        assert name not in torch_own or \
            vars(torch.Tensor).get(name) is not None and \
            name not in dir(torch._C.TensorBase), name
    # torch's meanings stay torch's
    x = torch.arange(6.0)
    assert [t.tolist() for t in x.split(2)] == [[0, 1], [2, 3], [4, 5]]
    assert [t.tolist() for t in paddle.split(x, 2)] == [[0, 1, 2],
                                                         [3, 4, 5]]
    m = torch.arange(6.0).reshape(2, 3)
    assert m.transpose(0, 1).shape == (3, 2)
    assert tuple(m.max(0).values.tolist()) == (3.0, 4.0, 5.0)
    assert m.size() == (2, 3)
    # the added ones
    assert m.astype("int32").dtype == torch.int32
    assert m.cast("float64").dtype == torch.float64
    assert bool(m.equal_all(m.clone()))
    assert m.place == paddle.CPUPlace()
    np.testing.assert_allclose(m.scale(2.0, 1.0).numpy(), m.numpy() * 2 + 1)
    t = torch.zeros(2)
    t.set_value(np.ones(2, np.float32))
    assert t.tolist() == [1.0, 1.0]


def test_enforce_taxonomy_matches_jax():
    assert enforce.__all__ == jenforce.__all__
    for name in enforce.__all__:
        mine, theirs = getattr(enforce, name), getattr(jenforce, name)
        if isinstance(theirs, type):
            assert [b.__name__ for b in mine.__mro__] == \
                [b.__name__ for b in theirs.__mro__], name
    with pytest.raises(enforce.InvalidArgumentError, match="bad 3"):
        enforce.enforce(False, "bad {}", 3)
    with pytest.raises(ValueError, match="expected 2, got 1"):
        enforce.enforce_eq(1, 2, "rank")
    with pytest.raises(enforce.InvalidArgumentError, match="must be > 0"):
        enforce.enforce_gt(0, 0)
    enforce.enforce_shape(torch.zeros(2, 3), (-1, 3))
    with pytest.raises(enforce.InvalidArgumentError,
                       match=r"expected \(-1, 4\), got \(2, 3\)"):
        enforce.enforce_shape(torch.zeros(2, 3), (None, 4))


def test_flags_table_matches_jax():
    # the JAX registry also holds flags its lint tests define in the same
    # process (underscored names); the table is the rest
    jax_table = {n for n in jflags.get_flags() if not n.startswith("_")}
    assert set(flags.get_flags()) == jax_table
    assert flags.get_flags(["check_nan_inf"]) == {"check_nan_inf": False}
    with pytest.raises(KeyError):
        flags.set_flags({"no_such_flag": 1})
    flags.set_flags({"FLAGS_tpu_interpret_pallas": "true"})
    try:
        assert flags.flag("tpu_interpret_pallas") is True   # kept, unused
    finally:
        flags.set_flags({"tpu_interpret_pallas": False})


def test_allocator_strategy_goes_to_the_caching_allocator(monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    old = flags.get_flags("allocator_strategy")["allocator_strategy"]
    try:
        flags.set_flags({"allocator_strategy": "naive_best_fit"})
        import os

        assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
            "expandable_segments:False"
        flags.set_flags({"allocator_strategy": "auto_growth"})
        assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
            "expandable_segments:True"
        with pytest.raises(ValueError):
            flags.set_flags({"allocator_strategy": "buddy"})
    finally:
        flags._registry["allocator_strategy"].update(value=old,
                                                     explicit=False)


def test_check_nan_inf_raises_in_the_dispatch():
    x = torch.tensor([1.0, 0.0])
    assert torch.isinf(paddle.divide(x, torch.zeros(2))).any()
    paddle.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError,
                           match="output 0 of op 'divide'"):
            paddle.divide(x, torch.zeros(2))
        paddle.add(x, x)            # finite outputs pass
        paddle.equal(x, x)          # boolean outputs are not scanned
    finally:
        paddle.set_flags({"check_nan_inf": False})
    jpaddle.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError,
                           match="output 0 of op 'divide'"):
            jpaddle.divide(jpaddle.to_tensor([1.0, 0.0]),
                           jpaddle.to_tensor([0.0, 0.0]))
    finally:
        jpaddle.set_flags({"check_nan_inf": False})


def test_benchmark_flag_times_each_op():
    dispatch._TIMES.clear()
    paddle.set_flags({"benchmark": True})
    try:
        x = torch.ones(8)
        paddle.add(x, x)
        paddle.add(x, x)
        paddle.exp(x)
    finally:
        paddle.set_flags({"benchmark": False})
    times = dispatch.op_times()
    assert times["add"][0] == 2 and times["exp"][0] == 1
    assert all(sec >= 0 for _, sec in times.values())
    paddle.add(x, x)
    assert dispatch.op_times()["add"][0] == 2


def test_autocast_applies_in_the_dispatch():
    x = torch.randn(2, 3)
    w = torch.randn(3, 4)
    with paddle.amp.auto_cast(dtype="bfloat16"):
        assert paddle.matmul(x, w).dtype == torch.bfloat16
        assert paddle.exp(x.bfloat16()).dtype == torch.float32
        assert paddle.add(x, x).dtype == torch.float32
    assert paddle.matmul(x, w).dtype == torch.float32


def test_top_level_exports_the_jax_surface():
    """Every name the JAX package's top level exports, ``save`` and
    ``load`` included, and every module its ``__init__`` imports."""
    import types

    # what the JAX ops modules' star imports carry along (no __all__)
    helpers = {"annotations", "jax", "jnp", "jax_lax_complex",
               "mxu_precision", "register_op", "split_key"}
    # submodules are attributes once anything imports them, so the
    # modules compared are those the JAX __init__ imports
    modules = {"core", "ops", "autograd", "nn", "optimizer", "amp", "io",
               "jit", "metric", "fft", "distribution", "sparse", "utils",
               "incubate", "static", "contrib", "device", "vision",
               "inference", "signal", "text", "onnx", "profiler",
               "observability", "resilience", "distributed", "hapi",
               "serving"}
    names = {n for n in dir(jpaddle) if not n.startswith("_")
             and not isinstance(getattr(jpaddle, n), types.ModuleType)}
    names = (names - helpers) | modules
    missing = sorted(n for n in names if not hasattr(paddle, n))
    assert missing == [], missing
    assert paddle.is_compiled_with_tpu() is False
    # the JAX registry also holds what the process imported beyond ops/
    # (tests/test_torch_ops.py::jax_corpus); every port op is JAX's
    assert set(paddle.core.list_ops()) <= set(jpaddle.core.list_ops())
    assert len(paddle.core.list_ops()) == 284
