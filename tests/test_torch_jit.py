"""The port's ``jit`` (``to_static`` / ``save`` / ``load``) against the JAX
package's, case by case as ``tests/test_jit.py``, plus what the port adds
to the contract: the flash forward as a ``torch.library`` operator in
the exported program, weights crossing between the packages both ways
(programs do not), and the watchdog's one build per signature.

Inputs come from numpy with a seed; weights are the JAX package's,
carried by name (``layer_state_from_jax``) or through the ``.npz`` files.
fp32 outputs are held to the JAX package's at 1e-5.  The JAX side runs
as its own tests run it on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.observability import watchdog_enabled
from paddle_tpu_torch.observability.compile_watchdog import CompileWatchdog
from torch_eager_ref import carry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One thread, as in ``test_torch_transformer.py``: on the first
    parallel call after the thread count grows, PyTorch's CPU ``exp`` can
    return values up to 1e-4 off on a worker thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nets():
    """The JAX test's net, in both packages with the JAX weights."""
    def build(nn):
        return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                             nn.Softmax())

    jpaddle.seed(21)
    j = build(jnn)
    return j, carry(j, build(tnn))


def _encoders(layers=2, width=64, heads=4):
    """A small ``TransformerEncoder`` (GELU, dropout 0, eval) in both
    packages with the JAX weights."""
    def build(nn):
        return nn.TransformerEncoder(nn.TransformerEncoderLayer(
            width, heads, 2 * width, dropout=0.0, activation="gelu"), layers)

    jpaddle.seed(3)
    j = build(jnn)
    t = carry(j, build(tnn))
    j.eval()
    t.eval()
    return j, t


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class TestTraceToStatic:
    def test_to_static_matches_jax(self):
        jnet, tnet = _nets()
        x = _x((4, 8))
        ref = np.asarray(jpaddle.jit.to_static(jnet)(
            jpaddle.to_tensor(x)).data)
        traced = jit.to_static(tnet)
        np.testing.assert_allclose(traced(x).numpy(), ref, **TOL)
        with torch.no_grad():
            assert torch.equal(traced(x), tnet(torch.from_numpy(x)))
        assert set(traced.routes.values()) == {"cpu"}

    def test_function_tracing(self):
        @jit.to_static(device="cpu")
        def f(a, b):
            return a * 2 + b

        out = f(torch.ones(3), torch.ones(3))
        np.testing.assert_allclose(out.numpy(), [3, 3, 3])
        assert f.__name__ == "f"

    def test_encoder_matches_jax_and_holds_the_flash_op(self):
        jenc, tenc = _encoders()
        x = _x((2, 128, 64), seed=1)
        ref = np.asarray(jpaddle.jit.to_static(jenc)(
            jpaddle.to_tensor(x)).data)
        traced = jit.to_static(tenc)
        np.testing.assert_allclose(traced(x).numpy(), ref, **TOL)
        text = traced.program_text(x)
        assert "paddle_tpu_torch.flash_fwd" in text
        targets = [n.target for n in
                   traced.exported_program(x).graph_module.graph.nodes]
        assert targets.count(torch.ops.paddle_tpu_torch.flash_fwd.default) \
            == 2

    def test_one_build_per_signature(self):
        _, tenc = _encoders()
        wd = CompileWatchdog()
        traced = jit.TracedLayer(tenc)
        traced._compiled = wd.watch(traced._run, name="jit::enc")
        with watchdog_enabled(wd):
            for shape in ((2, 128, 64), (1, 256, 64), (2, 128, 64),
                          (1, 256, 64)):
                traced(_x(shape))
        rep = wd.report()["jit::enc"]
        assert (rep["calls"], rep["compiles"], rep["recompiles"]) == (4, 2, 1)
        assert len(traced.routes) == 2

    def test_weight_updates_are_seen(self):
        _, tnet = _nets()
        x = _x((4, 8))
        traced = jit.to_static(tnet)
        traced(x)
        lin = tnet[2]
        with torch.no_grad():
            lin.weight.mul_(2.0)                        # in place
            expect = tnet(torch.from_numpy(x))
        assert torch.equal(traced(x), expect)
        lin.weight.data = lin.weight.data * 0.5          # replaced
        with torch.no_grad():
            expect = tnet(torch.from_numpy(x))
        assert torch.equal(traced(x), expect)


class TestFlashOperator:
    def _qkv(self, dtype=torch.float32):
        g = torch.Generator().manual_seed(0)
        return [torch.randn(2, 3, 128, 32, generator=g).to(dtype)
                for _ in range(3)]

    @pytest.mark.parametrize("causal", [False, True])
    def test_opcheck(self, causal):
        q, k, v = self._qkv()
        torch.library.opcheck(fa.flash_fwd, (q, k, v, 0.125, causal))

    def test_cpu_route_is_the_plain_version(self):
        q, k, v = self._qkv()
        out, lse = fa.flash_fwd(q, k, v, 0.2, True)
        ref_out, ref_lse = fa._flash_fwd_ref(q, k, v, 0.2, True)
        assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)

    def test_fake_shapes(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode() as mode:
            q = mode.from_tensor(torch.empty(2, 3, 64, 32,
                                             dtype=torch.bfloat16))
            out, lse = fa.flash_fwd(q, q, q, 0.1, False)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert lse.shape == (2, 3, 64) and lse.dtype == torch.float32

    def test_training_route_unchanged(self):
        q, k, v = [t.requires_grad_() for t in self._qkv()]
        out = fa.flash_attention(q, k, v, causal=True)
        out.sum().backward()
        ref = fa.flash_attention_plain(*[t.detach().requires_grad_()
                                         for t in (q, k, v)], causal=True)
        assert torch.equal(out, ref)


class TestSaveLoad:
    def test_load_into_layer(self, tmp_path):
        _, tnet = _nets()
        x = _x((4, 8))
        with torch.no_grad():
            ref = tnet(torch.from_numpy(x))
        jit.save(tnet, str(tmp_path / "m"))
        _, fresh = _nets()
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        traced = jit.load(str(tmp_path / "m"), layer=fresh)
        assert torch.equal(traced(x), ref)

    def test_jax_artifact_loads_into_the_port(self, tmp_path):
        jnet, _ = _nets()
        x = _x((4, 8))
        ref = np.asarray(jnet(jpaddle.to_tensor(x)).data)
        jpaddle.jit.save(jnet, str(tmp_path / "m"),
                         example_inputs=[jpaddle.to_tensor(x)])
        _, fresh = _nets()
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        out = jit.load(str(tmp_path / "m"), layer=fresh, device="cpu")(x)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_port_artifact_loads_into_jax(self, tmp_path):
        jnet, tnet = _nets()
        x = _x((4, 8))
        ref = np.asarray(jnet(jpaddle.to_tensor(x)).data)
        jit.save(tnet, str(tmp_path / "m"), example_inputs=[x])
        jpaddle.seed(99)
        jfresh = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                                jnn.Linear(16, 4), jnn.Softmax())
        out = jpaddle.jit.load(str(tmp_path / "m"), layer=jfresh)(
            jpaddle.to_tensor(x))
        np.testing.assert_allclose(np.asarray(out.data), ref, **TOL)

    def test_predictor_without_class(self, tmp_path):
        jenc, tenc = _encoders()
        x = _x((2, 128, 64), seed=2)
        ref = np.asarray(jenc(jpaddle.to_tensor(x)).data)
        jit.save(tenc, str(tmp_path / "m"), example_inputs=[x])
        for name in ("m.pdmodel", "m.program.txt", "m.pdiparams.npz",
                     "m.pdibuffers.npz"):
            assert os.path.exists(tmp_path / name)
        meta = json.loads((tmp_path / "m.pdmodel.json").read_text())
        assert meta["format"] == "torch.export" and meta["has_program"]
        pred = jit.load(str(tmp_path / "m"), device="cpu")
        np.testing.assert_allclose(pred(x).numpy(), ref, **TOL)

    def test_predictor_in_fresh_process(self, tmp_path):
        """A process that imports no model class (and no jax) loads the
        artifact and serves it."""
        jenc, tenc = _encoders()
        x = _x((2, 128, 64), seed=3)
        ref = np.asarray(jenc(jpaddle.to_tensor(x)).data)
        jit.save(tenc, str(tmp_path / "m"), example_inputs=[x])
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "ref.npy", ref)
        script = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from paddle_tpu_torch import jit

pred = jit.load({str(tmp_path / 'm')!r}, device="cpu")
out = pred(np.load({str(tmp_path / 'x.npy')!r}))
np.testing.assert_allclose(out.numpy(), np.load({str(tmp_path / 'ref.npy')!r}),
                           rtol=1e-5, atol=1e-5)
assert not any(m.split(".")[0] in ("jax", "paddle_tpu") for m in sys.modules)
print("PREDICTOR_OK")
"""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("XLA_", "JAX_"))}
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "PREDICTOR_OK" in proc.stdout

    def test_jax_program_without_layer_raises(self, tmp_path):
        jnet, _ = _nets()
        x = jpaddle.to_tensor(_x((4, 8)))
        jpaddle.jit.save(jnet, str(tmp_path / "m"), example_inputs=[x])
        with pytest.raises(ValueError, match="layer="):
            jit.load(str(tmp_path / "m"), device="cpu")

    def test_predictor_without_program_raises(self, tmp_path):
        _, tnet = _nets()
        jit.save(tnet, str(tmp_path / "m"))
        with pytest.raises(ValueError, match="example_inputs"):
            jit.load(str(tmp_path / "m"), device="cpu")

    def test_device_defaults_to_the_card(self, tmp_path):
        _, tnet = _nets()
        jit.save(tnet, str(tmp_path / "m"), example_inputs=[_x((4, 8))])
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA"):
            jit.load(str(tmp_path / "m"))
