"""The port's public surface, name by name, against the JAX package's.

Every public module of ``paddle_tpu`` is imported beside its counterpart
in ``paddle_tpu_torch`` (the module of the same path).  Every public
function or class a JAX module defines (its ``__module__`` is that
module), and every public method or class attribute of such a class,
must be a name of the port's module (or of its class): present, or on
``ALLOWED`` with the reason it is not ported.  An allow-listed name the
port has fails too, so the list cannot go stale.  The walk is shown to
bite on a name taken out of the port for one test.  Each name ported
to close the walk's gaps is then held to its JAX counterpart."""
from __future__ import annotations

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place

_AUTOGRAD = ("the JAX tape; the port's autograd is torch's "
             "(paddle_tpu_torch/core/__init__.py)")
_JAX_DEVICE = "a jax.Device; the port's Place has torch_device()"
_SPECS = ("a GSPMD PartitionSpec builder; the port lays tensors out "
          "per rank (distributed/mesh.py param_specs, the mp layers' "
          "windows)")
_JIT_STEP = ("builds the jitted XLA step; the port's step is eager, "
             "or a captured CUDA graph")
_PURE = "the jnp function the JAX dispatcher traces; the port's op is torch"

#: JAX or TPU plumbing with no meaning on torch: name -> why
ALLOWED = {
    # whole modules
    "paddle_tpu.core.autograd": _AUTOGRAD,
    "paddle_tpu.core.vma": "shard_map's varying-manual-axes typing; no "
                           "torch counterpart",
    "paddle_tpu.native": "a C++ TCPStore; the port uses "
                         "torch.distributed.TCPStore",
    # device and precision
    "paddle_tpu.core.place.Place.jax_device": _JAX_DEVICE,
    "paddle_tpu.core.place.current_jax_device": _JAX_DEVICE,
    "paddle_tpu.ops.linalg.mxu_precision": "the TPU MXU's matmul precision "
                                           "(ops/linalg.py _exact here)",
    "paddle_tpu.ops.creation.jax_lax_complex": "jax.lax.complex, imported "
                                               "into the module",
    "paddle_tpu.profiler.profiler.ProfilerTarget.TPU": "no TPU here; "
                                                       "ProfilerTarget.GPU",
    "paddle_tpu.inference.Config.enable_tpu": "no TPU here; enable_use_gpu",
    # the eager layer's jit plumbing
    "paddle_tpu.nn.layer.layers.Layer.raw_state":
        "jit plumbing (paddle_tpu_torch/nn/layer/layers.py docstring)",
    "paddle_tpu.nn.layer.layers.Layer.swap_state":
        "jit plumbing (paddle_tpu_torch/nn/layer/layers.py docstring)",
    "paddle_tpu.jit.TracedLayer.lower": "an XLA lowering; the port's "
                                        "trace is torch.export",
    "paddle_tpu.jit.TracedLayer.stablehlo": "StableHLO text of the "
                                            "lowering",
    "paddle_tpu.core.dispatch.OpDef.pure_fn": _PURE,
    "paddle_tpu.static.program.OpDesc.pure_fn": _PURE,
    "paddle_tpu.static.program.maybe_record": "the JAX dispatcher's "
        "recording hook; program_guard records through a "
        "TorchFunctionMode",
    # GSPMD spec builders
    "paddle_tpu.distributed.mesh.sharding_tree": _SPECS,
    "paddle_tpu.distributed.mesh.replicated": _SPECS,
    "paddle_tpu.distributed.topology.build_mesh":
        "a jax.sharding.Mesh; distributed.mesh.build_mesh is the port's",
    "paddle_tpu.distributed.topology.build_hybrid_mesh":
        "a jax.sharding.Mesh over ICI and DCN",
    "paddle_tpu.distributed.moe.MoELayer.sharding_specs": _SPECS,
    "paddle_tpu.distributed.mp_layers.ColumnParallelLinear.sharding_specs":
        _SPECS,
    "paddle_tpu.distributed.mp_layers.RowParallelLinear.sharding_specs":
        _SPECS,
    "paddle_tpu.distributed.mp_layers.VocabParallelEmbedding."
    "sharding_specs": _SPECS,
    "paddle_tpu.distributed.engine.HybridEngine.batch_spec": _SPECS,
    "paddle_tpu.distributed.engine.HybridEngine.opt_specs": _SPECS,
    "paddle_tpu.distributed.engine.HybridEngine.build_step": _JIT_STEP,
    "paddle_tpu.distributed.engine.HybridEngine.loss_fn_reference":
        "the unsharded jnp loss the jitted step is checked against",
    "paddle_tpu.distributed.pp_layers.PipelineEngine.build_step": _JIT_STEP,
    "paddle_tpu.distributed.pp_layers.PipelineEngine.unpack":
        "unpacks the jitted step's stacked stage tree",
    # inputs that are JAX's
    "paddle_tpu.sparse.SparseCsrTensor.from_bcsr":
        "takes a jax.experimental.sparse BCSR",
    "paddle_tpu.io.multiprocess.NumpyStub":
        "keeps forked workers off JAX's PJRT client; the port's workers "
        "return numpy to a parent that makes tensors",
}


def _public(name):
    return not any(p.startswith("_") for p in name.split(".")[1:])


def _modules():
    """[(JAX module, port module or None)] for every public JAX module."""
    out = []
    for info in pkgutil.walk_packages(paddle_tpu.__path__, "paddle_tpu."):
        if not _public(info.name):
            continue
        mod = importlib.import_module(info.name)
        try:
            port = importlib.import_module(
                "paddle_tpu_torch" + info.name[len("paddle_tpu"):])
        except ModuleNotFoundError:
            port = None
        out.append((mod, port))
    return out


def missing_names(pairs):
    """Every JAX-defined public name (module, function, class, method,
    class attribute) the port lacks, as a dotted JAX path."""
    missing = []
    for mod, port in pairs:
        if port is None:
            missing.append(mod.__name__)
            continue
        for name, obj in vars(mod).items():
            if name.startswith("_") or not (inspect.isfunction(obj) or
                                            inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            path = f"{mod.__name__}.{name}"
            if not hasattr(port, name):
                missing.append(path)
                continue
            if inspect.isclass(obj):
                theirs = getattr(port, name)
                missing += [f"{path}.{attr}" for attr in vars(obj)
                            if not attr.startswith("_")
                            and not hasattr(theirs, attr)]
    return missing


def _allowed(path):
    parts = path.split(".")
    return any(".".join(parts[:i]) in ALLOWED
               for i in range(1, len(parts) + 1))


@pytest.fixture(scope="module")
def pairs():
    prev = place._state.device
    paddle_tpu_torch.set_device("cpu")
    try:
        yield _modules()
    finally:
        place._state.device = prev


def test_every_jax_name_is_ported_or_allowed(pairs):
    missing = missing_names(pairs)
    assert [p for p in missing if not _allowed(p)] == []


def test_no_allowed_name_exists_in_the_port(pairs):
    missing = set(missing_names(pairs))
    stale = [p for p in ALLOWED if p not in missing]
    assert stale == []


@pytest.mark.parametrize("module, owner, name", [
    ("paddle_tpu_torch.core.random", None, "split_key"),
    ("paddle_tpu_torch.serving.kv_cache", "PagedKVCache", "can_allocate"),
])
def test_the_walk_bites_on_a_planted_miss(pairs, monkeypatch, module, owner,
                                          name):
    target = importlib.import_module(module)
    if owner is not None:
        target = getattr(target, owner)
    monkeypatch.delattr(target, name)
    jax_path = "paddle_tpu" + module[len("paddle_tpu_torch"):] + \
        (f".{owner}" if owner else "") + f".{name}"
    assert jax_path in missing_names(pairs)
    assert not _allowed(jax_path)


# --------------------------- the names ported with this test, against JAX


def test_amp_is_enabled_and_maybe_cast_inputs():
    # the package's auto_cast function shadows its module
    jamp = importlib.import_module("paddle_tpu.amp.auto_cast")
    tamp = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

    x = np.ones((2, 2), np.float32)
    i = np.ones((2,), np.int32)
    for amp, wrap, name in ((jamp, paddle_tpu.to_tensor, "jax"),
                            (tamp, torch.from_numpy, "torch")):
        args = [wrap(x).data if name == "jax" else wrap(x),
                wrap(i).data if name == "jax" else wrap(i)]
        assert amp.is_enabled() is False
        assert amp.maybe_cast_inputs("matmul", args) is args
        with amp.auto_cast(dtype="bfloat16"):
            assert amp.is_enabled() is True
            cast = amp.maybe_cast_inputs("matmul", args)
            assert [str(a.dtype).replace("torch.", "") for a in cast] == \
                ["bfloat16", "int32"]
            assert amp.maybe_cast_inputs("exp", args) is args
        with amp.auto_cast(dtype="bfloat16", custom_black_list={"matmul"}):
            assert amp.maybe_cast_inputs("matmul", args) is args


def test_tensor_retain_grads_and_persistable():
    import paddle_tpu_torch as tp

    x = np.arange(4, dtype=np.float32)
    grads = []
    for paddle in (paddle_tpu, tp):
        xt = paddle.to_tensor(x, stop_gradient=False)
        y = xt * 3.0
        y.retain_grads()
        (y * y).sum().backward()
        grads.append(np.asarray(y.grad.numpy()))
        assert xt.persistable is False
        layer = paddle.nn.Linear(2, 2)
        assert layer.weight.persistable is True
        assert layer.weight.regularizer is None
        xt.persistable = True
        assert xt.persistable is True
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def test_param_attr_regularizer_reaches_the_parameter():
    import paddle_tpu_torch as tp

    reg = object()
    layer = tp.nn.Linear(2, 2, weight_attr=tp.nn.ParamAttr(regularizer=reg))
    assert layer.weight.regularizer is reg
    assert layer.bias.regularizer is None
    import copy

    assert copy.deepcopy(layer.weight).regularizer is reg


def test_layer_add_parameter():
    import paddle_tpu_torch as tp

    for paddle in (paddle_tpu, tp):
        layer = paddle.nn.Layer()
        p = paddle.nn.Linear(3, 3).weight
        assert layer.add_parameter("w", p) is p
        assert [n for n, _ in layer.named_parameters()] == ["w"]


def test_metrics_registry_reset():
    from paddle_tpu.observability.metrics import MetricsRegistry as J

    from paddle_tpu_torch.observability.metrics import MetricsRegistry as T

    for cls in (J, T):
        reg = cls()
        reg.counter("c_total", "a counter").inc()
        assert len(reg.metrics()) == 1
        reg.reset()
        assert reg.metrics() == []


def test_kv_cache_can_allocate():
    import jax.numpy as jnp

    from paddle_tpu.serving.kv_cache import PagedKVCache as J

    from paddle_tpu_torch.serving.kv_cache import PagedKVCache as T

    kw = dict(num_layers=1, num_heads=2, head_dim=8, num_pages=4,
              page_size=4, max_seq_len=64)
    j = J(**kw, dtype=jnp.float32)
    t = T(**kw, dtype=torch.float32, device="cpu")
    for cache in (j, t):
        assert cache.allocate(0, 6)
    for n in (0, 1, 8, 9, 16):
        assert t.can_allocate(n) == j.can_allocate(n), n


def test_serving_metrics_summary():
    from paddle_tpu.observability.metrics import MetricsRegistry as JR
    from paddle_tpu.serving.metrics import ServingMetrics as J

    from paddle_tpu_torch.observability.metrics import MetricsRegistry as TR
    from paddle_tpu_torch.serving.metrics import ServingMetrics as T

    texts = []
    for cls, reg in ((J, JR), (T, TR)):
        m = cls(registry=reg())
        assert "       -" in m.summary()          # nothing observed yet
        m.requests_submitted.inc(3)
        m.ttft.observe(0.25)
        texts.append(m.summary())
    assert texts[1] == texts[0]


def test_profiler_device_trace_dir():
    """No device trace runs on the CPU, so the port has no directory;
    the JAX package's names where ``jax.profiler`` wrote its trace."""
    from paddle_tpu_torch.profiler.profiler import Profiler

    prof = Profiler()
    assert prof.device_trace_dir is None
    with prof:
        pass
    assert prof.device_trace_dir is None


@pytest.mark.parametrize("dt", ["float16", "bfloat16", "float32",
                                "float64", "int8", "uint8", "int32",
                                "int64", "bool", "complex64"])
def test_dtype_predicates_and_numpy_dtype(dt):
    from paddle_tpu.core import dtype as J

    from paddle_tpu_torch.core import dtype as T

    assert T.is_floating_dtype(dt) == bool(J.is_floating_dtype(dt))
    assert T.is_integer_dtype(dt) == bool(J.is_integer_dtype(dt))
    assert T.numpy_dtype(dt) == J.numpy_dtype(dt)


def test_place_allocation_type_and_devices():
    from paddle_tpu.core import place as J

    from paddle_tpu_torch.core import place as T

    for name in ("UNDEFINED", "CPU", "GPU", "TPU", "CUSTOM"):
        assert getattr(T.AllocationType, name) == \
            getattr(J.AllocationType, name)
    assert J.get_all_devices()[0] == "cpu:0"
    assert T.get_all_devices() == (["cpu:0"] if not torch.cuda.is_available()
                                   else [f"gpu:{i}" for i in range(
                                       torch.cuda.device_count())])


def test_paged_attention_available():
    """JAX's says whether Pallas imports; the port's whether its CUDA
    kernel can be built and launched here (a card and nvcc)."""
    from paddle_tpu.kernels import paged_attention_available as j

    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_available as t

    assert isinstance(j(), bool)
    if not torch.cuda.is_available():
        assert t() is False


@pytest.mark.parametrize("name", ["tanh", "sigmoid", "softplus"])
def test_math_activations_at_the_jax_path(name):
    from paddle_tpu.ops import math as J

    from paddle_tpu_torch.ops import math as T

    x = np.linspace(-30, 30, 13, dtype=np.float32)
    want = np.asarray(getattr(J, name)(x))
    got = getattr(T, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
