"""The port's ``paddle.save`` / ``paddle.load`` (``framework_io.py``)
against the JAX package's, in both directions.

The file format is the JAX package's (a pickle whose tensors are
``paddle_tpu.framework_io._TensorPayload``s holding numpy arrays): a
file either package writes loads in the other, with every tensor's
values, dtype (bf16 included) and shape, and the nested containers and
plain values around them.  The port writes and reads that class name
without importing ``paddle_tpu`` (its tests would not notice: this
process has it loaded, so the jax-free import of the port is
``test_torch_no_jax.py``'s check).  The save is atomic, as JAX's."""
import pickle
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.resilience.faults import (FaultSpec, SimulatedCrash,
                                                injected_faults)

tpaddle.set_device("cpu")


def _jax_tree():
    r = np.random.RandomState(0)
    return {"w": jpaddle.Tensor(r.randn(3, 4).astype(np.float32)),
            "ids": [jpaddle.Tensor(np.arange(5, dtype=np.int32)), "tag"],
            "nested": {"b": jpaddle.Tensor(jnp.asarray(r.randn(6),
                                                       jnp.bfloat16)),
                       "step": 7, "lr": 0.5, "none": None},
            "tup": (jpaddle.Tensor(np.ones((), np.float32)), 3)}


def _port_tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "ids": [torch.arange(5, dtype=torch.int32), "tag"],
            "nested": {"b": torch.randn(6, generator=g).bfloat16(),
                       "step": 7, "lr": 0.5, "none": None},
            "tup": (torch.ones(()), 3),
            "param": tpaddle.nn.Linear(2, 3).weight}


def _jnp(x):
    a = np.asarray(x.data)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    t = t.detach()
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def test_port_loads_a_file_the_jax_package_wrote(tmp_path):
    path = str(tmp_path / "jax.pdparams")
    tree = _jax_tree()
    jpaddle.save(tree, path)
    got = tpaddle.load(path)
    assert got["nested"]["step"] == 7 and got["nested"]["lr"] == 0.5
    assert got["nested"]["none"] is None and got["ids"][1] == "tag"
    assert isinstance(got["tup"], tuple) and got["tup"][1] == 3
    for a, b in ((got["w"], tree["w"]), (got["ids"][0], tree["ids"][0]),
                 (got["nested"]["b"], tree["nested"]["b"]),
                 (got["tup"][0], tree["tup"][0])):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_tnp(a), _jnp(b))
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert got["ids"][0].dtype == torch.int32


def test_jax_package_loads_a_file_the_port_wrote(tmp_path):
    path = str(tmp_path / "port.pdparams")
    tree = _port_tree()
    tpaddle.save(tree, path)
    got = jpaddle.load(path)
    assert got["nested"]["step"] == 7 and got["ids"][1] == "tag"
    assert isinstance(got["tup"], tuple)
    for a, b in ((got["w"], tree["w"]), (got["ids"][0], tree["ids"][0]),
                 (got["nested"]["b"], tree["nested"]["b"]),
                 (got["tup"][0], tree["tup"][0]),
                 (got["param"], tree["param"])):
        assert isinstance(a, jpaddle.Tensor)
        np.testing.assert_array_equal(_jnp(a), _tnp(b))
    assert str(got["nested"]["b"].data.dtype) == "bfloat16"
    # the class the JAX package's unpickler found is its own
    from paddle_tpu.framework_io import _TensorPayload

    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["w"], _TensorPayload)


def test_round_trip_in_the_port_is_bitwise(tmp_path):
    path = str(tmp_path / "rt.pdparams")
    tree = _port_tree()
    tpaddle.save(tree, path)
    got = tpaddle.load(path)
    for a, b in ((got["w"], tree["w"]), (got["nested"]["b"],
                                         tree["nested"]["b"]),
                 (got["param"], tree["param"])):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    numpy_tree = tpaddle.load(path, return_numpy=True)
    np.testing.assert_array_equal(numpy_tree["w"], tree["w"].numpy())


@pytest.mark.parametrize("protocol", [2, 4])
def test_protocols_cross_both_ways(tmp_path, protocol):
    path = str(tmp_path / f"p{protocol}.pd")
    tpaddle.save({"x": torch.arange(4.0)}, path, protocol=protocol)
    np.testing.assert_array_equal(np.asarray(jpaddle.load(path)["x"].data),
                                  np.arange(4.0, dtype=np.float32))
    jpaddle.save({"x": jpaddle.Tensor(np.arange(3, dtype=np.float32))},
                 path, protocol=protocol)
    assert tpaddle.load(path)["x"].tolist() == [0.0, 1.0, 2.0]


def test_layer_and_optimizer_state_round_trip(tmp_path):
    """A model's state dict and its optimizer's state load back into a
    fresh pair, equal bit for bit."""
    tpaddle.seed(3)
    net = tpaddle.nn.Sequential(tpaddle.nn.Linear(4, 8), tpaddle.nn.ReLU(),
                                tpaddle.nn.Linear(8, 2))
    opt = tpaddle.optimizer.Adam(1e-2, parameters=net.parameters())
    x = torch.randn(5, 4)
    for _ in range(2):
        net(x).square().mean().backward()
        opt.step()
        opt.clear_grad()
    tpaddle.save(net.state_dict(), str(tmp_path / "m.pdparams"))
    tpaddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    tpaddle.seed(4)
    net2 = tpaddle.nn.Sequential(tpaddle.nn.Linear(4, 8),
                                 tpaddle.nn.ReLU(), tpaddle.nn.Linear(8, 2))
    opt2 = tpaddle.optimizer.Adam(1e-2, parameters=net2.parameters())
    net2.set_state_dict(tpaddle.load(str(tmp_path / "m.pdparams")))
    opt2.set_state_dict(tpaddle.load(str(tmp_path / "m.pdopt")))
    for (k, a), b in zip(net.state_dict().items(),
                         net2.state_dict().values()):
        assert torch.equal(a, b), k
    for _ in range(2):
        for n, o in ((net, opt), (net2, opt2)):
            n(x).square().mean().backward()
            o.step()
            o.clear_grad()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_save_crash_keeps_the_old_file(tmp_path):
    path = str(tmp_path / "blob.pdparams")
    tpaddle.save({"a": torch.ones(4)}, path)
    with injected_faults(FaultSpec("framework_io.save", "kill")):
        with pytest.raises(SimulatedCrash):
            tpaddle.save({"a": torch.zeros(4)}, path)
    out = tpaddle.load(path, return_numpy=True)
    np.testing.assert_array_equal(out["a"], np.ones(4))


def test_foreign_paddle_tpu_classes_are_refused(tmp_path):
    """Only the payload class is mapped: any other ``paddle_tpu`` global
    in a file raises rather than importing the JAX package."""
    path = tmp_path / "foreign.pd"
    path.write_bytes(b"\x80\x04\x8c\x12paddle_tpu.nn.init\x94\x8c\x05Dummy"
                     b"\x94\x93\x94.")
    with pytest.raises(pickle.UnpicklingError, match="maps only"):
        tpaddle.load(str(path))


def test_bf16_save_without_ml_dtypes_raises(tmp_path, monkeypatch):
    """The file holds bf16 only as an ``ml_dtypes`` array (the JAX
    package's form): without ``ml_dtypes`` a bf16 save raises, and no file
    is written."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    path = tmp_path / "bf16.pdparams"
    with pytest.raises(ImportError, match="ml_dtypes"):
        tpaddle.save({"w": torch.ones(3, dtype=torch.bfloat16)}, str(path))
    assert not path.exists()
    tpaddle.save({"w": torch.ones(3)}, str(path))
    assert tpaddle.load(str(path))["w"].dtype == torch.float32
