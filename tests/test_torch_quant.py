"""The port's ``contrib.quant`` against the JAX package's, case by case as
the quantization half of ``tests/test_contrib.py`` (its ASP sparsity and
data-parallel cases test modules the port has not taken yet): the same
numpy inputs and the same weights (carried from JAX) through both;
fake-quant values and straight-through gradients at 1e-6, QAT and PTQ
forwards at 1e-5, calibrated scales at 1e-6 relative."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.contrib import quant as jquant

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.contrib import quant as tquant
from torch_eager_ref import carry


def _nets(seed=0):
    jpaddle.seed(seed)
    j = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    return j, carry(j, tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(),
                                      tnn.Linear(16, 4)))


def _x(seed, n=4):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


class TestFakeQuant:
    @pytest.mark.parametrize("bits", [8, 4])
    def test_quantize_dequantize(self, bits):
        x = np.linspace(-1.3, 1.3, 33, dtype=np.float32)
        ref = np.asarray(jquant.fake_quant(jnp.asarray(x), jnp.float32(1.0),
                                           bits))
        out = tquant.fake_quant(torch.from_numpy(x), 1.0, bits).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        if bits == 8:
            np.testing.assert_allclose(out[[0, -1]], [-1.0, 1.0], atol=1e-6)

    def test_straight_through_gradient(self):
        x = np.asarray([0.5, 2.0, -0.9, -1.5], np.float32)
        ref = np.asarray(jax.grad(lambda v: jquant.fake_quant(
            v, jnp.float32(1.0), 8).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        tquant.fake_quant(xt, 1.0, 8).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), ref, atol=1e-6)
        np.testing.assert_allclose(ref, [1.0, 0.0, 1.0, 0.0])


class TestQAT:
    def test_quantize_swaps_linears(self):
        _, net = _nets()
        tquant.QAT().quantize(net)
        kinds = [type(layer).__name__ for layer in net]
        assert kinds.count("QuantizedLinear") == 2

    def test_qat_forward_and_trainable(self):
        jnet, tnet = _nets()
        x = _x(0)
        jquant.QAT().quantize(jnet)
        tquant.QAT().quantize(tnet)
        jout = jnet(jpaddle.to_tensor(x))
        tout = tnet(torch.from_numpy(x))
        np.testing.assert_allclose(tout.detach().numpy(),
                                   np.asarray(jout.data), rtol=1e-5,
                                   atol=1e-5)
        (jout ** 2).mean().backward()
        (tout ** 2).mean().backward()
        np.testing.assert_allclose(
            tnet[0].inner.weight.grad.numpy(),
            np.asarray(jnet[0].inner.weight.grad.data), rtol=1e-5,
            atol=1e-6)
        js, ts = jquant.quant_scales(jnet), tquant.quant_scales(tnet)
        assert js.keys() == ts.keys() and len(ts) == 2
        for k in js:
            for s in ("weight", "activation"):
                np.testing.assert_allclose(ts[k][s], js[k][s], rtol=1e-6)

    def test_traced_before_calibration_raises(self):
        _, net = _nets()
        tquant.QAT().quantize(net)
        with pytest.raises(RuntimeError, match="activation scale"):
            torch.export.export(net, (torch.from_numpy(_x(0)),),
                                strict=False)


class TestPTQ:
    def test_ptq_calibrate_and_convert(self):
        jnet, tnet = _nets()
        x = _x(1, 16)
        jptq, tptq = jquant.PTQ(), tquant.PTQ()
        jptq.quantize(jnet)
        tptq.quantize(tnet)
        jnet(jpaddle.to_tensor(x))
        tnet(torch.from_numpy(x))
        js, ts = jptq.scales(), tptq.scales()
        assert js.keys() == ts.keys() and len(ts) == 2
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-6)
        jptq.convert(jnet)
        tptq.convert(tnet)
        np.testing.assert_allclose(
            tnet(torch.from_numpy(x)).detach().numpy(),
            np.asarray(jnet(jpaddle.to_tensor(x)).data), rtol=1e-5,
            atol=1e-5)

    def test_root_linear_observed_under_empty_name(self):
        ptq = tquant.PTQ()
        lin = tnn.Linear(8, 4)
        ptq.quantize(lin)
        lin(torch.from_numpy(_x(2)))
        assert list(ptq.scales()) == [""]
