"""The port's ``hapi.Model`` against the JAX package's.

Three ``train_batch`` steps of ResNet-18 at 4 x 3 x 64 x 64 (Momentum
0.01/0.9, weight decay 1e-4, cross entropy, accuracy; at a learning rate
of 0.1 the random-init net diverges within three steps and the two
packages' fp32 rounding is amplified past any tolerance) from the same weights: losses at 1e-4
relative, accuracies exactly, parameters, velocities and batch-norm
buffers at 1e-4 of each tensor's largest entry.  ``fit``/``evaluate``/
``predict`` and the callbacks on ``tests/test_hapi.py``'s toy data
(losses and metrics at 1e-5).  ``.pdparams``/``.pdopt`` written by either
package load into the other and the next step agrees.  The README's
Quick start runs on the port."""
import os
import pickle
import re
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.vision import models as jm

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.hapi import (Callback, EarlyStopping, LRScheduler,
                                   Model, ModelCheckpoint)
from paddle_tpu_torch.vision import models as tm
from torch_eager_ref import carry, pair, rand



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Four threads for these large CPU convolutions, then the count the
    other test modules set (some hold results bit for bit)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _maxrel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _prepared(pkg, net, model_cls, lr=0.01):
    model = model_cls(net)
    opt = pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 parameters=model.parameters(),
                                 weight_decay=1e-4)
    model.prepare(opt, pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
    return model


def _batch(step, n=4, size=64):
    x = rand((n, 3, size, size), 50 + step)
    y = np.random.RandomState(60 + step).randint(0, 10, (n,)).astype(
        np.int64)
    return x, y


def _resnet_models():
    jl, tl = pair(lambda: jm.resnet18(num_classes=10),
                  lambda: tm.resnet18(num_classes=10))
    return (_prepared(jpaddle, jl, JModel), _prepared(tpaddle, tl, Model))


def _assert_models_close(jmodel, tmodel, tol=1e-4):
    tparams = dict(tmodel.network.named_parameters())
    for k, p in jmodel.network.named_parameters():
        assert _maxrel(tparams[k].detach().numpy(), np.asarray(p.data)) \
            <= tol, k
    tbufs = dict(tmodel.network.named_buffers())
    for k, b in jmodel.network.named_buffers():
        assert _maxrel(tbufs[k].numpy(), np.asarray(b.data)) <= tol, k
    for k, slots in jmodel._opt_state["slots"].items():
        v = tmodel._opt_state["slots"][k]["velocity"]
        assert _maxrel(v.numpy(), np.asarray(slots["velocity"])) <= tol, k
    assert tmodel._opt_state["step"] == int(jmodel._opt_state["step"])


def test_three_resnet18_train_batch_steps_equal_jax():
    jmodel, tmodel = _resnet_models()
    for step in range(3):
        x, y = _batch(step)
        jloss, jres = jmodel.train_batch([x], [y])
        tloss, tres = tmodel.train_batch([x], [y])
        assert tloss == pytest.approx(jloss, rel=1e-4)
        assert tres == pytest.approx(jres, abs=1e-12)
    _assert_models_close(jmodel, tmodel)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(writer, tmp_path):
    """Two steps in each package, then one package saves and the other
    loads into a fresh model with different weights: the next step of the
    loader equals the next step of the writer."""
    jmodel, tmodel = _resnet_models()
    for step in range(2):
        jmodel.train_batch(*_batch(step))
        tmodel.train_batch(*_batch(step))
    path = str(tmp_path / "ck")
    if writer == "jax":
        jmodel.save(path)
        src = jmodel
        jpaddle.seed(9)
        tpaddle.seed(9)
        dst = _prepared(tpaddle, tm.resnet18(num_classes=10), Model)
    else:
        tmodel.save(path)
        src = tmodel
        jpaddle.seed(9)
        dst = _prepared(jpaddle, jm.resnet18(num_classes=10), JModel)
    with open(path + ".pdparams", "rb") as f:
        blob = pickle.load(f)
    assert sorted(blob) == ["buffers", "params"]
    assert len(blob["params"]) == 62 and len(blob["buffers"]) == 40
    dst.load(path)
    x, y = _batch(2)
    sloss, _ = src.train_batch(x, y)
    dloss, _ = dst.train_batch(x, y)
    assert dloss == pytest.approx(sloss, rel=1e-4)
    jm_, tm_ = (src, dst) if writer == "jax" else (dst, src)
    _assert_models_close(jm_, tm_)


def test_save_load_round_trip_is_bit_equal(tmp_path):
    _, tmodel = _resnet_models()
    tmodel.train_batch(*_batch(0))
    path = str(tmp_path / "sub" / "ck")
    tmodel.save(path)
    assert not [f for f in os.listdir(tmp_path / "sub") if ".tmp." in f]
    tpaddle.seed(5)
    other = _prepared(tpaddle, tm.resnet18(num_classes=10), Model)
    other.load(path)
    for (k, a), (_, b) in zip(tmodel.network.state_dict().items(),
                              other.network.state_dict().items()):
        assert torch.equal(a, b), k
    for k, s in tmodel._opt_state["slots"].items():
        assert torch.equal(s["velocity"],
                           other._opt_state["slots"][k]["velocity"])


def test_eval_and_predict_keep_no_buffer_update():
    """As JAX's pure eval step: the network runs in its current mode (here
    train, so batch statistics) and its buffers are left as they were."""
    jmodel, tmodel = _resnet_models()
    x, y = _batch(0)
    before = {k: b.clone() for k, b in tmodel.network.named_buffers()}
    jloss, jres = jmodel.eval_batch([x], [y])
    tloss, tres = tmodel.eval_batch([x], [y])
    assert tloss == pytest.approx(jloss, rel=1e-4) and tres == jres
    np.testing.assert_allclose(tmodel.predict_batch([x]),
                               np.asarray(jmodel.predict_batch([x])),
                               atol=1e-4, rtol=1e-4)
    for k, b in tmodel.network.named_buffers():
        assert torch.equal(b, before[k]), k


class ToyDataset:
    """tests/test_hapi.py's linearly separable 2-class blobs."""

    @staticmethod
    def make(io, n=64, seed=0):
        class Toy(io.Dataset):
            def __init__(self):
                rng = np.random.RandomState(seed)
                self.y = rng.randint(0, 2, (n,)).astype(np.int64)
                self.x = (rng.randn(n, 8) * 0.3 + self.y[:, None].astype(
                    np.float32) * 2.0).astype(np.float32)

            def __len__(self):
                return len(self.x)

            def __getitem__(self, i):
                return self.x[i], self.y[i]

        return Toy()


def _toy(pkg, model_cls, seed=3, lr=0.1, opt="SGD"):
    pkg.seed(seed)
    net = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                            pkg.nn.Linear(16, 2))
    return net


def _toy_pair(lr=0.1):
    jnet = _toy(jpaddle, JModel)
    tnet = carry(jnet, _toy(tpaddle, Model))
    out = []
    for pkg, net, cls in ((jpaddle, jnet, JModel), (tpaddle, tnet, Model)):
        model = cls(net)
        model.prepare(pkg.optimizer.SGD(learning_rate=lr,
                                        parameters=model.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        out.append(model)
    return out


def test_fit_evaluate_predict_equal_jax():
    jmodel, tmodel = _toy_pair()
    np.random.seed(11)
    jh = jmodel.fit(ToyDataset.make(jpaddle.io), batch_size=16, epochs=4,
                    verbose=0)
    np.random.seed(11)
    th = tmodel.fit(ToyDataset.make(tpaddle.io), batch_size=16, epochs=4,
                    verbose=0)
    assert len(th) == 4
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5, abs=1e-6)
        assert a["acc"] == pytest.approx(b["acc"])
    assert th[-1]["loss"] < th[0]["loss"] and th[-1]["acc"] > 0.9
    test = (ToyDataset.make(jpaddle.io, 32, 9), ToyDataset.make(
        tpaddle.io, 32, 9))
    jl = jmodel.evaluate(test[0], batch_size=16, verbose=0)
    tl = tmodel.evaluate(test[1], batch_size=16, verbose=0)
    assert tl["loss"] == pytest.approx(jl["loss"], rel=1e-5)
    assert tl["acc"] == jl["acc"]
    jp = jmodel.predict(test[0], batch_size=16)
    tp = tmodel.predict(test[1], batch_size=16)
    assert tp[0].shape == (32, 2)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), atol=1e-5,
                               rtol=1e-5)


def test_fit_with_eval_data_and_callbacks(tmp_path):
    _, model = _toy_pair()
    seen = []

    class Spy(Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(("batch", step, round(logs["loss"], 6)))

        def on_epoch_end(self, epoch, logs=None):
            seen.append(("epoch", epoch, sorted(logs)))

    hist = model.fit(ToyDataset.make(tpaddle.io), ToyDataset.make(
        tpaddle.io, 32, 9), batch_size=16, epochs=2, verbose=1,
        log_freq=2, callbacks=[Spy()], save_dir=str(tmp_path))
    assert [s for s in seen if s[0] == "epoch"] == [
        ("epoch", e, ["acc", "eval_acc", "eval_loss", "loss"])
        for e in range(2)]
    assert len([s for s in seen if s[0] == "batch"]) == 8
    assert hist[-1]["eval_acc"] > 0.9
    for name in ("0", "1", "final"):
        assert os.path.exists(tmp_path / f"{name}.pdparams")
        assert os.path.exists(tmp_path / f"{name}.pdopt")


def test_early_stopping_and_lr_scheduler_callbacks(tmp_path):
    _, model = _toy_pair()
    stop = EarlyStopping(monitor="loss", patience=0, min_delta=10.0,
                         save_dir=str(tmp_path))
    hist = model.fit(ToyDataset.make(tpaddle.io), batch_size=16, epochs=5,
                     verbose=0, callbacks=[stop])
    assert len(hist) == 2 and stop.stopped_epoch == 1
    assert os.path.exists(tmp_path / "best_model.pdparams")

    tpaddle.seed(3)
    net = tnn.Linear(8, 2)
    sched = tpaddle.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model = Model(net)
    model.prepare(tpaddle.optimizer.SGD(sched, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
    model.fit(ToyDataset.make(tpaddle.io), batch_size=16, epochs=1,
              verbose=0, callbacks=[LRScheduler(by_step=True)])
    assert sched() == pytest.approx(0.1 * 0.5 ** 4)
    ModelCheckpoint(1, str(tmp_path / "mc"))


def test_grad_norm_logging_and_summary():
    _, model = _toy_pair()
    model.enable_grad_norm_logging()
    ds = ToyDataset.make(tpaddle.io)
    loss, res = model.train_batch(ds.x[:16], ds.y[:16])
    assert res["grad_norm"] > 0 and "acc" in res
    assert model.summary() == "Sequential: 178 parameters"


def test_not_ported_paths_raise(tmp_path):
    """``prepare(device_mesh=)`` trains over a world now
    (``test_torch_hapi_mesh.py``): in one process ``"auto"`` is a world of
    one rank and steps as the unmeshed model does, and a mesh of more
    ranks than the world raises naming them.  The resume and callback
    paths that raised before they were ported run: ``fit(resume_from=)``
    of an empty directory is a fresh start."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    _, model = _toy_pair()
    _, plain = _toy_pair()
    model.prepare(model._optimizer, tpaddle.nn.CrossEntropyLoss(),
                  tpaddle.metric.Accuracy(), device_mesh="auto")
    ds = ToyDataset.make(tpaddle.io)
    got, want = (m.train_batch(ds.x[:16], ds.y[:16]) for m in (model, plain))
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == want[1]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        model.prepare(device_mesh=mesh_mod.build_mesh(dp=2))
    _, model = _toy_pair()
    hist = model.fit(ToyDataset.make(tpaddle.io), batch_size=16, verbose=0,
                     resume_from=str(tmp_path / "none"))
    assert len(hist) == 1 and model._resume_info is None
    from paddle_tpu_torch.hapi import CheckpointCallback, ProfilerCallback

    with pytest.raises(ValueError, match="save_dir"):
        CheckpointCallback()
    assert ProfilerCallback().profiler is not None


def test_without_set_device_layers_and_model_need_cuda():
    """In a thread that has not chosen the CPU, the place is the card:
    creating a layer or a Model raises where CUDA is missing, and nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default place is valid")
    errors = []

    def run():
        for make in (lambda: tnn.Linear(2, 2),
                     lambda: Model(object()),
                     lambda: tpaddle.vision.resnet18()):
            try:
                make()
                errors.append("no error")
            except RuntimeError as e:
                errors.append(str(e))

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(errors) == 3 and all("CUDA" in e for e in errors), errors


def test_readme_quick_start_runs_on_the_port():
    """README's "eager + hapi" block with ``import paddle_tpu_torch as
    paddle`` (and its ``nn``) in place of the JAX package, on the CPU."""
    text = open(os.path.join(REPO, "README.md")).read()
    start = text.index("## Quick start")
    block = re.search(r"```python\n(.*?)```", text[start:], re.S).group(1)
    eager = block.split("\n\n# hybrid-parallel")[0]
    assert "import paddle_tpu as paddle" in eager
    code = eager.replace("import paddle_tpu as paddle",
                         "import paddle_tpu_torch as paddle").replace(
        "import paddle_tpu.nn as nn", "import paddle_tpu_torch.nn as nn")
    tpaddle.set_device("cpu")
    scope = {"train_dataset": ToyDataset.make(tpaddle.io, 2048)}
    exec(compile(code, "README.md", "exec"), scope)
    model = scope["model"]
    assert isinstance(model, Model)
    logs = model.evaluate(ToyDataset.make(tpaddle.io, 64, 9), batch_size=64,
                          verbose=0)
    assert logs["acc"] > 0.9
