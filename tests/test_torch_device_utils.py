"""The port's ``device``, ``utils`` (``log_util``, ``monitor``) and ``onnx``
against the JAX package's behaviour (``tests/test_device.py``,
``tests/test_utils_sparse_customop.py``, ``tests/test_training_health.py``
``TestStatBridge``, ``tests/test_domain_breadth.py`` ``TestOnnxDesignOut``)
on the CPU."""
import logging
import os

import numpy as np
import pytest
import torch

import paddle_tpu.utils as jutils

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import utils as tutils
from paddle_tpu_torch.observability.metrics import MetricsRegistry

tpaddle.set_device("cpu")


# ----------------------------------------------------------------- device


def test_set_and_get_device():
    prev = tdevice.get_device()
    tdevice.set_device("cpu")
    assert tdevice.get_device().startswith("cpu")
    tdevice.set_device(prev)
    assert tpaddle.device.get_device() == prev


def test_device_listing_and_places():
    devices = tdevice.get_all_devices()
    if torch.cuda.is_available():
        assert devices == [f"gpu:{i}" for i in
                           range(torch.cuda.device_count())]
    else:
        assert devices == ["cpu:0"]
    assert tdevice.device_count("cpu") == 1
    assert tdevice.CPUPlace().is_cpu_place()
    assert tdevice.CustomPlace("npu", 1).device_type == "npu"


def test_register_missing_library_raises():
    with pytest.raises(FileNotFoundError, match="not found"):
        tdevice.register_custom_device("npu", "/nonexistent/libnpu.so")
    assert tdevice.get_all_custom_device_type() == []


def test_custom_device_queries():
    assert tdevice.get_all_custom_device_type() == []
    assert not tdevice.is_custom_device_available("not_a_device")


def test_a_second_custom_device_is_refused(monkeypatch):
    """torch has one PrivateUse1 backend a process: once it is named, a
    device of another name raises (the JAX package's "register before
    the backend starts" rule)."""
    monkeypatch.setitem(tdevice._registered, "npu", "/lib/libnpu.so")
    with pytest.raises(RuntimeError, match="before any other"):
        tdevice.register_custom_device("xpu", "/lib/libxpu.so")
    assert tdevice.get_all_custom_device_type() == ["npu"]


# ------------------------------------------------------------------ utils


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_stat_registry(pkg):
    StatRegistry = (jutils if pkg == "jax" else tutils).StatRegistry
    r = StatRegistry()
    assert r.add("mem", 100) == 100
    assert r.add("mem", -40) == 60
    assert r.peak("mem") == 100 and r.get("mem") == 60
    assert r.stats() == {"mem": (60, 100)}
    r.reset("mem")
    assert r.get("mem") == 0 and r.peak("mem") == 0
    r.add("a", 1)
    r.reset()
    assert r.stats() == {}


def test_global_stats():
    tutils.stat_reset()
    tutils.stat_add("steps")
    tutils.stat_add("steps")
    assert tutils.stat_get("steps") == 2
    tutils.stat_reset("steps")
    assert tutils.stat_get("steps") == 0


def test_stats_appear_on_scrape():
    from paddle_tpu_torch.utils.monitor import StatRegistry, \
        bridge_to_metrics

    sr = StatRegistry()
    mr = MetricsRegistry()
    collector = bridge_to_metrics(sr, mr)
    assert mr.snapshot() == {}
    sr.add("pool_alloc", 5)
    sr.add("pool_alloc", -2)
    sr.add("host_buffers", 1)
    series = {s["labels"]["name"]: s["value"]
              for s in mr.snapshot()["runtime_stat"]["series"]}
    assert series["pool_alloc"] == {"current": 3, "peak": 5}
    assert series["host_buffers"]["current"] == 1
    mr.remove_collector(collector)
    sr.add("late", 1)
    assert "late" not in {s["labels"]["name"] for s in
                          mr.snapshot()["runtime_stat"]["series"]}


def test_default_bridge_installed():
    from paddle_tpu_torch.observability import default_registry

    tutils.stat_reset()
    tutils.stat_add("bridge_check", 7)
    try:
        series = {s["labels"]["name"]: s["value"] for s in
                  default_registry().snapshot()["runtime_stat"]["series"]}
        assert series["bridge_check"]["current"] == 7
    finally:
        tutils.stat_reset()


def test_failing_collector_is_skipped(caplog):
    mr = MetricsRegistry()

    def broken():
        raise RuntimeError("bridge broke")

    mr.add_collector(broken)
    mr.gauge("g").set(2)
    with caplog.at_level(logging.WARNING):
        assert mr.snapshot()["g"]["value"]["current"] == 2
    assert "collector" in caplog.text


def test_device_memory_stats():
    assert tutils.device_memory_stats("cpu") == {}
    assert tutils.device_memory_stats() == {}      # set_device("cpu")


def test_rank_in_log_records(capsys):
    from paddle_tpu_torch.utils.log_util import get_logger

    os.environ["PADDLE_TRAINER_ID"] = "3"
    try:
        log = get_logger("ptt_test", level=logging.INFO)
        log.info("hello")
        err = capsys.readouterr().err
        assert "[rank 3]" in err and "hello" in err
    finally:
        del os.environ["PADDLE_TRAINER_ID"]
    assert tutils.logger.name == "paddle_tpu_torch.utils"


def test_vlog_gated(capsys):
    from paddle_tpu_torch.utils.log_util import vlog

    vlog(3, "should not appear")
    assert "should not appear" not in capsys.readouterr().err


# ------------------------------------------------------------------- onnx


def test_onnx_export_emits_the_jit_artifact(tmp_path):
    tpaddle.seed(0)
    model = tpaddle.nn.Linear(4, 2)
    x = torch.ones(1, 4)
    path = tpaddle.onnx.export(model, str(tmp_path / "m.onnx"),
                               input_spec=[x])
    assert path == str(tmp_path / "m")
    pred = tpaddle.jit.Predictor(path, device="cpu")
    np.testing.assert_allclose(pred(x).detach().numpy(),
                               model(x).detach().numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="input_spec"):
        tpaddle.onnx.export(model, str(tmp_path / "n"))
