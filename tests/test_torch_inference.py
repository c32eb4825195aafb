"""The port's ``inference`` (``Config`` / ``create_predictor`` at fp32,
bf16 and int8, and the generation predictor) against the JAX package's,
case by case as ``tests/test_inference.py``.

The same numpy inputs and the same weights (carried from JAX) go through
both packages' predictors, on the CPU (``Config.disable_gpu()``):

- fp32 outputs at 1e-5;
- bf16 outputs at the JAX test's 0.05 against fp32;
- int8: the quantized weights and the int32 accumulators of every
  Linear bit-equal to the JAX predictor's, the outputs at 1e-6 against
  the JAX int8 predictor, and at the JAX test's relative 0.1 against
  fp32;
- generation: tokens identical to the port's ``Engine.generate`` and to
  the JAX ``GenerationPredictor`` on the same ``tiny`` parameters."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.inference as jinf
import paddle_tpu.nn as jnn
from paddle_tpu.contrib.quant import PTQ as JPTQ
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init

import paddle_tpu_torch.inference as tinf
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit
from paddle_tpu_torch.contrib.quant import PTQ
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax
from paddle_tpu_torch.serving import Engine, SamplingParams
from torch_eager_ref import carry

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One thread (see ``test_torch_jit.py``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mlp(nn):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(16, 32)
            self.fc2 = nn.Linear(32, 8)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    return MLP()


def _models(seed):
    """JAX's ``MLP`` and the port's with its weights."""
    jpaddle.seed(seed)
    j = _mlp(jnn)
    return j, carry(j, _mlp(tnn))


def _encoders():
    def build(nn):
        return nn.TransformerEncoder(nn.TransformerEncoderLayer(
            64, 4, 128, dropout=0.0, activation="gelu"), 2)

    jpaddle.seed(5)
    j = build(jnn)
    t = carry(j, build(tnn))
    j.eval()
    t.eval()
    return j, t


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _config(*args):
    return tinf.Config(*args).disable_gpu()


def _scales(model, ptq_cls, to_tensor, batches=4, shape=(8, 16)):
    """PTQ scales from ``batches`` seeded calibration batches run through
    ``model`` (a copy: the hooks stay on it)."""
    ptq = ptq_cls()
    ptq.quantize(model)
    for i in range(batches):
        model(to_tensor(_x(shape, 100 + i)))
    return {name: {"activation": s} for name, s in ptq.scales().items()}


def _port_scales(tmodel, shape=(8, 16)):
    import copy

    return _scales(copy.deepcopy(tmodel), PTQ, torch.from_numpy, shape=shape)


class TestSavedProgramPath:
    def test_native_precision_runs_saved_artifact(self, tmp_path):
        jmodel, tmodel = _models(0)
        x = _x((4, 16), 0)
        ref = np.asarray(jmodel(jpaddle.to_tensor(x)).data)
        jit.save(tmodel, str(tmp_path / "mlp"), example_inputs=[x])
        pred = tinf.create_predictor(_config(str(tmp_path / "mlp")))
        np.testing.assert_allclose(pred.run(x).numpy(), ref, **TOL)
        assert pred._mode == "saved-program"

    def test_encoder_saved_program_matches_jax(self, tmp_path):
        jenc, tenc = _encoders()
        x = _x((2, 128, 64), 1)
        jpaddle.jit.save(jenc, str(tmp_path / "j"),
                         example_inputs=[jpaddle.to_tensor(x)])
        ref = np.asarray(jinf.create_predictor(
            jinf.Config(str(tmp_path / "j"))).run(x).data)
        jit.save(tenc, str(tmp_path / "t"), example_inputs=[x])
        out = tinf.create_predictor(_config(str(tmp_path / "t"))).run(x)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_precision_override_requires_layer(self, tmp_path):
        _, tmodel = _models(0)
        x = _x((4, 16), 0)
        jit.save(tmodel, str(tmp_path / "mlp"), example_inputs=[x])
        cfg = _config(str(tmp_path / "mlp")).set_precision(
            tinf.PrecisionType.Bfloat16)
        with pytest.raises(ValueError, match="set_model"):
            tinf.create_predictor(cfg)

    def test_config_defaults_to_the_card(self):
        cfg = tinf.Config()
        assert cfg.device == "cuda"
        assert cfg.enable_use_gpu(device_id=0).device == "cuda:0"
        assert cfg.enable_use_cpu().device == "cpu"


class TestPrecision:
    def test_bf16_predictor(self, tmp_path):
        jmodel, tmodel = _models(1)
        x = _x((4, 16), 0)
        ref = np.asarray(jmodel(jpaddle.to_tensor(x)).data)
        jit.save(tmodel, str(tmp_path / "m"), example_inputs=[x])
        _, fresh = _models(9)
        cfg = _config(str(tmp_path / "m")).set_precision(
            tinf.PrecisionType.Bfloat16).set_model(fresh)
        out = tinf.create_predictor(cfg).run(x)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0.05,
                                   atol=0.05)

    def test_bf16_encoder(self, tmp_path):
        _, tenc = _encoders()
        x = _x((2, 128, 64), 2)
        with torch.no_grad():
            ref = tenc(torch.from_numpy(x)).numpy()
        cfg = _config().set_precision(tinf.PrecisionType.Bfloat16)
        out = tinf.create_predictor(cfg.set_model(tenc)).run(x)
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0.05,
                                   atol=0.05)

    def test_int8_matches_the_jax_int8_predictor(self, monkeypatch):
        jmodel, tmodel = _models(2)
        x = _x((8, 16), 1)
        ref = np.asarray(jmodel(jpaddle.to_tensor(x)).data)
        jscales = _scales(_models(2)[0], JPTQ, jpaddle.to_tensor)
        scales = _port_scales(tmodel)
        for k in jscales:
            np.testing.assert_allclose(scales[k]["activation"],
                                       jscales[k]["activation"], rtol=1e-6)
        jpred = jinf.create_predictor(
            jinf.Config().set_model(jmodel).enable_int8(jscales))
        pred = tinf.create_predictor(
            _config().set_model(tmodel).enable_int8(scales))
        jout = np.asarray(jpred.run(x).data)
        out = pred.run(x).numpy()
        np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
        assert 0 < err < 0.1, err

        # the int32 accumulators of each Linear, on the same input, bit
        # for bit: the JAX twin's are read at its lax.dot_general
        accs = []
        real = jax.lax.dot_general

        def spy(*a, **kw):
            out = real(*a, **kw)
            if kw.get("preferred_element_type") == jnp.int32:
                accs.append(np.asarray(out))
            return out

        monkeypatch.setattr(jax.lax, "dot_general", spy)
        h = x
        for name, jlin in (("fc1", jmodel.fc1), ("fc2", jmodel.fc2)):
            jtwin = jinf._Int8Linear(jlin, jscales[name]["activation"])
            twin = pred.int8_layers[getattr(tmodel, name)]
            np.testing.assert_array_equal(twin.w_q.numpy(),
                                          np.asarray(jtwin.w_q))
            jh = np.asarray(jtwin(jnp.asarray(h)))
            acc = twin.accumulate(torch.from_numpy(h)).numpy()
            assert acc.dtype == np.int32
            np.testing.assert_array_equal(acc, accs[-1])
            h = np.maximum(jh, 0.0)

    def test_int8_encoder(self):
        _, tenc = _encoders()
        x = _x((2, 128, 64), 3)
        with torch.no_grad():
            ref = tenc(torch.from_numpy(x)).numpy()
        scales = _port_scales(tenc, shape=(2, 128, 64))
        out = tinf.create_predictor(
            _config().set_model(tenc).enable_int8(scales)).run(x).numpy()
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
        assert 0 < err < 0.1, err

    def test_int8_requires_scales(self):
        _, tmodel = _models(3)
        cfg = _config().set_model(tmodel)
        cfg.enable_int8({})
        with pytest.raises(ValueError, match="activation scale"):
            tinf.create_predictor(cfg)

    def test_int8_scales_from_json(self, tmp_path):
        _, tmodel = _models(4)
        p = tmp_path / "scales.json"
        p.write_text(json.dumps(_port_scales(tmodel)))
        pred = tinf.create_predictor(
            _config().set_model(tmodel).enable_int8(str(p)))
        assert np.isfinite(pred.run(np.ones((2, 16), np.float32))
                           .numpy()).all()


class TestModelUntouched:
    def test_user_model_keeps_fp32_behavior_after_int8_build(self):
        _, tmodel = _models(7)
        x = _x((4, 16), 5)
        with torch.no_grad():
            ref = tmodel(torch.from_numpy(x))
        pred = tinf.create_predictor(
            _config().set_model(tmodel).enable_int8(_port_scales(tmodel)))
        pred.run(x)
        with torch.no_grad():
            assert torch.equal(tmodel(torch.from_numpy(x)), ref)
        out = pred.run(x).numpy()
        err = np.abs(out - ref.numpy()).max() / (
            np.abs(ref.numpy()).max() + 1e-6)
        assert 0 < err < 0.1


class TestRootLinearInt8:
    def test_model_that_is_itself_a_linear(self):
        """A model whose only Linear is the root is quantized, keyed by
        the empty name.  The JAX predictor keys it so too, but its forward
        patch walks ``named_sublayers()`` without the root, so a bare
        Linear runs in fp32 there (ROADMAP §3): the port is held to the
        JAX predictor on the same Linear inside a ``Sequential``, where
        both quantize it."""
        jpaddle.seed(5)
        jlin = jnn.Linear(16, 4)
        lin = carry(jlin, tnn.Linear(16, 4))
        x = _x((8, 16), 3)
        scales = _port_scales(lin)
        assert list(scales) == [""]
        out = tinf.create_predictor(
            _config().set_model(lin).enable_int8(scales)).run(x).numpy()
        jseq = jnn.Sequential(jlin)
        jout = np.asarray(jinf.create_predictor(
            jinf.Config().set_model(jseq).enable_int8({"0": scales[""]}))
            .run(x).data)
        np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)
        with torch.no_grad():
            ref = lin(torch.from_numpy(x)).numpy()
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
        assert 0 < err < 0.1, err


class TestGeneration:
    def test_tokens_match_the_engine_and_jax(self):
        jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
        cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
        jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
        params = params_from_jax(jparams, device="cpu")
        rng = np.random.RandomState(11)
        prompts = [[int(t) for t in rng.randint(0, 1024, n)]
                   for n in (5, 12, 20)]
        knobs = dict(page_size=8, num_pages=64, max_batch_size=4,
                     chunk_len=8)
        pred = tinf.create_predictor(
            _config().enable_generation(cfg, params, **knobs))
        out = pred.generate(prompts, SamplingParams(max_new_tokens=6))
        eng = Engine(cfg, params, device="cpu", **knobs)
        assert out == eng.generate(prompts, SamplingParams(max_new_tokens=6))
        jpred = jinf.create_predictor(
            jinf.Config().enable_generation(jcfg, jparams, **knobs))
        from paddle_tpu.serving import SamplingParams as JSampling

        assert out == jpred.generate(prompts, JSampling(max_new_tokens=6))
        assert isinstance(pred.metrics(), dict)
