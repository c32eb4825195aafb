"""The port's distributed flight recorder (``observability/flight.py``)
against the JAX package's, mirroring ``tests/test_distributed_flight.py``
(:52-350 and :536-575): the ring, per-group sequence numbers and record
fields (equal to the JAX recorder's for the same calls), failed and
in-flight records, ``note_step``, the chrome timeline with collective
spans next to hapi's step, the stall fault sites, the multi-rank
``HangWatchdog`` (three store-backed ranks in one process, as the JAX
test runs them, and a 4-rank gloo world of the port's ranks) and
observer mode, a lint that every public op of the port's
``collective.py`` is recorded, and the overhead smoke.  The ``/flight``
endpoint belongs to the telemetry server, a later slice."""
import ast
import json
import os
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import collective as jcollective
from paddle_tpu.observability import FlightRecorder as JFlightRecorder
from paddle_tpu.observability import MetricsRegistry as JMetricsRegistry
from paddle_tpu.observability import Tracer as JTracer
from paddle_tpu.observability import use_flight_recorder as juse
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import (FlightRecorder, HangWatchdog,
                                            MetricsRegistry, Tracer,
                                            default_flight_recorder,
                                            default_tracer, record_collective,
                                            use_flight_recorder)
from paddle_tpu_torch.resilience import FaultSpec, injected_faults

from torch_world import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recorder(capacity=64):
    return FlightRecorder(capacity=capacity, registry=MetricsRegistry(),
                          tracer=Tracer())


def _jrecorder(capacity=64):
    return JFlightRecorder(capacity=capacity, registry=JMetricsRegistry(),
                           tracer=JTracer())


def _fields(recs):
    """Record fields that do not depend on the clock or the caller."""
    keep = ("seq", "group_seq", "op", "group", "shapes", "dtypes",
            "nbytes", "step", "error")
    return [{k: r[k] for k in keep} for r in recs]


class TestFlightRecorderRing:
    def test_seq_monotonic_and_ring_bounded(self):
        rec = _recorder(capacity=8)
        with use_flight_recorder(rec):
            for _ in range(20):
                collective.all_reduce(torch.ones(4))
        recs = rec.records()
        assert len(recs) == 8
        assert [r["seq"] for r in recs] == list(range(13, 21))
        assert rec.summary()["completed"] == 20
        assert rec.last_seq == 20
        jrec = _jrecorder(capacity=8)
        with juse(jrec):
            for _ in range(20):
                jcollective.all_reduce(jnp.ones((4,), jnp.float32))
        assert _fields(recs) == _fields(jrec.records())
        assert rec.summary()["by_op"] == jrec.summary()["by_op"]

    def test_per_group_seq_independent(self):
        g_mp = types.SimpleNamespace(axis_name="mp", nranks=4)
        out = []
        for rec in (_recorder(), _jrecorder()):
            x = np.ones((4,), np.float32)
            with rec.record("all_reduce", tensors=(x,)):
                pass
            with rec.record("all_reduce", group=g_mp, tensors=(x,)):
                pass
            with rec.record("barrier"):
                pass
            out.append(_fields(rec.records()))
        assert [(r["group"], r["group_seq"]) for r in out[0]] == \
            [("world", 1), ("mp", 1), ("world", 2)]
        assert [r["seq"] for r in out[0]] == [1, 2, 3]
        # the JAX recorder reads a numpy array through ``.data`` (a
        # memoryview with no dtype) and so records no shape for it; the
        # port records the array's shape and bytes
        order = ("seq", "group_seq", "op", "group")
        assert [[r[k] for k in order] for r in out[0]] == \
            [[r[k] for k in order] for r in out[1]]
        assert out[0][0]["shapes"] == [[4]] and out[0][0]["nbytes"] == 16

    def test_record_fields_and_metrics(self):
        rec = _recorder()
        with use_flight_recorder(rec):
            collective.all_reduce(torch.ones(8, 4))
        r = rec.records()[-1]
        assert r["op"] == "all_reduce" and r["group"] == "world"
        assert r["shapes"] == [[8, 4]] and r["nbytes"] == 8 * 4 * 4
        assert r["dtypes"] == ["float32"]
        assert r["end_s"] >= r["start_s"]
        assert r["caller"].startswith("test_torch_flight.py")
        jrec = _jrecorder()
        with juse(jrec):
            jcollective.all_reduce(jnp.ones((8, 4), jnp.float32))
        assert _fields([r]) == _fields(jrec.records())
        snap = rec.registry().snapshot()
        ops = {(s["labels"]["op"], s["labels"]["group"]): s["value"]
               for s in snap["collective_ops_total"]["series"]}
        assert ops[("all_reduce", "world")] == 1
        byt = {s["labels"]["op"]: s["value"]
               for s in snap["collective_bytes_total"]["series"]}
        assert byt["all_reduce"] == 128
        lat = snap["collective_latency_seconds"]["series"][0]["value"]
        assert lat["count"] == 1

    def test_failed_collective_recorded_with_error(self):
        rec = _recorder()
        with use_flight_recorder(rec):
            with pytest.raises(ValueError):
                collective.all_reduce(torch.ones(4), op="median",
                                      group=_two_rank_group())
        r = rec.records()[-1]
        assert r["op"] == "all_reduce" and "ValueError" in r["error"]
        assert rec.inflight() == []

    def test_inflight_visible_until_finish(self):
        rec = _recorder()
        r = rec.start("all_reduce", tensors=(torch.ones(4),))
        assert rec.inflight_brief() == {"seq": 1, "op": "all_reduce",
                                        "group": "world"}
        assert rec.last_seq == 0
        rec.finish(r)
        assert rec.inflight_brief() is None
        assert rec.last_seq == 1

    def test_note_step_rides_summary(self):
        rec = _recorder()
        rec.note_step(7, epoch=2)
        s = rec.summary()
        assert (s["step"], s["epoch"]) == (7, 2)
        assert rec.progress() == (7, 2)


def _two_rank_group():
    """A group object with a process group, so the call gets past the
    single-participant shortcut and reaches its op check."""
    return collective.Group([0, 1], pg=object(), gid=99)


# -------------------------------------------------- chrome-trace export


def test_collective_spans_next_to_hapi_step(tmp_path):
    """Collective spans land in the same chrome export as hapi::step
    spans, and Model.fit stamped the step-progress heartbeat."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.io import TensorDataset

    paddle.set_device("cpu")
    rng = np.random.RandomState(0)
    data = TensorDataset([torch.from_numpy(rng.randn(8, 4).astype(
        np.float32)), torch.from_numpy(rng.randint(0, 2, (8,)))])
    model = paddle.Model(nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                       nn.Linear(8, 2)))
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss())
    model.fit(data, batch_size=4, epochs=1, verbose=0)
    collective.all_reduce(torch.ones(4))
    path = default_tracer().export_chrome(str(tmp_path / "t.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert "hapi::step" in names
    assert "collective::all_reduce" in names
    assert default_flight_recorder().step == 1


# ---------------------------------------------------- stall fault sites


@pytest.mark.parametrize("site,call", [
    ("collective.all_reduce", lambda: collective.all_reduce(torch.ones(4))),
    ("collective.barrier", lambda: collective.barrier())])
def test_stall_fault_site_shows_in_latency(site, call):
    rec = _recorder()
    with use_flight_recorder(rec), \
            injected_faults(FaultSpec(site, "stall", occurrence=1,
                                      stall_s=0.12)):
        call()
    r = rec.records()[-1]
    assert r["op"] == site.split(".")[1]
    assert r["end_s"] - r["start_s"] >= 0.1


# ------------------------------------------------ cross-rank watchdog


STALLED = 1


@pytest.mark.faultinject
def test_stalled_rank_detected_bundled_and_named(tmp_path):
    """Three store-backed ranks, rank 1 stalled inside all_reduce: every
    rank's watchdog fires within the timeout, writes an atomic bundle
    whose rings agree up to the divergent seq, and names the stalled
    rank and op; when the stall clears the fleet re-converges."""
    master = TCPStore(is_master=True, world_size=3)
    recs, hws, regs = {}, {}, {}
    for r in range(3):
        st = master if r == 0 else TCPStore(port=master.port, world_size=3)
        regs[r] = MetricsRegistry()
        recs[r] = FlightRecorder(capacity=64, registry=regs[r],
                                 tracer=Tracer())
        hws[r] = HangWatchdog(st, rank=r, world_size=3, recorder=recs[r],
                              stall_timeout_s=0.4, interval_s=0.1,
                              bundle_dir=str(tmp_path / f"r{r}"),
                              registry=regs[r], tracer=Tracer())
    x = torch.ones(16)
    for r in range(3):
        with use_flight_recorder(recs[r]):
            for _ in range(3 if r == STALLED else 4):
                collective.all_reduce(x)
    entered = threading.Event()

    def stalled_rank():
        with use_flight_recorder(recs[STALLED]):
            entered.set()
            collective.all_reduce(x)

    with injected_faults(FaultSpec("collective.all_reduce", "stall",
                                   occurrence=1, stall_s=3.0)):
        t = threading.Thread(target=stalled_rank, daemon=True)
        t.start()
        assert entered.wait(timeout=5)
        time.sleep(0.1)
        assert recs[STALLED].inflight_brief()["op"] == "all_reduce"
        t0 = time.monotonic()
        for hw in hws.values():
            hw.start(interval_s=0.1)
        while time.monotonic() - t0 < 2.0 and \
                not all(hw.fired for hw in hws.values()):
            time.sleep(0.02)
        assert all(hw.fired == 1 for hw in hws.values())
        assert time.monotonic() - t0 < 2.0
        assert t.is_alive()
        for r, hw in hws.items():
            d = hw.last_desync
            assert (d["lagging_rank"], d["stalled_ranks"],
                    d["divergent_seq"], d["op"]) == \
                (STALLED, [STALLED], 4, "all_reduce")
            assert d["seqs"] == {"0": 4, "1": 3, "2": 4}
            assert regs[r].get("hang_watchdog_fired_total").value == 1
            assert regs[r].get("hang_watchdog_active").value == 1
        t.join(timeout=10)
    prefixes = {}
    for r, hw in hws.items():
        assert len(hw.bundles) == 1
        with open(hw.bundles[0]) as f:
            b = json.load(f)
        assert b["rank"] == r and b["reason"] == "hang"
        assert b["threads"] and "metrics" in b and "live_spans" in b
        prefixes[r] = [(rec["seq"], rec["op"]) for rec in b["records"]
                       if rec["seq"] < b["desync"]["divergent_seq"]]
    assert prefixes[0] == prefixes[1] == prefixes[2] == \
        [(1, "all_reduce"), (2, "all_reduce"), (3, "all_reduce")]
    with open(hws[STALLED].bundles[0]) as f:
        assert [(r["seq"], r["op"]) for r in json.load(f)["inflight"]] == \
            [(4, "all_reduce")]
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and \
            any(hw.hang_active for hw in hws.values()):
        time.sleep(0.05)
    for r, hw in hws.items():
        assert not hw.hang_active and hw.fired == 1
        assert regs[r].get("hang_watchdog_active").value == 0
        hw.stop()


def test_observer_mode_monitors_without_publishing():
    master = TCPStore(is_master=True, world_size=2)
    recs = {r: _recorder() for r in range(2)}
    pubs = {r: HangWatchdog(master, rank=r, world_size=2, recorder=recs[r],
                            stall_timeout_s=0.2, registry=MetricsRegistry(),
                            tracer=Tracer())
            for r in range(2)}
    with use_flight_recorder(recs[0]):
        collective.all_reduce(torch.ones(4))
    for p in pubs.values():
        p.poll()
    obs = HangWatchdog(master, rank=None, world_size=2, stall_timeout_s=0.2,
                       registry=MetricsRegistry(), tracer=Tracer())
    assert obs.poll() is False
    assert obs.published == 0
    time.sleep(0.25)
    pubs[0].poll()
    assert obs.poll() is True
    assert obs.last_desync["lagging_rank"] == 1
    assert obs.check() is True


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.mark.faultinject
def test_watchdog_names_stalled_rank_in_a_gloo_world(world, tmp_path):
    """Four real ranks over gloo: rank 2 stalls in its 4th all_reduce;
    each rank's watchdog, beating on its own thread, names rank 2 and
    seq 4, and each rank bundles its in-flight record and stacks."""
    out = world.run("torch_dist_cases", "flight_hang_case", 2,
                    str(tmp_path))
    for r, res in enumerate(out):
        assert res["fired"] == 1, (r, res)
        assert (res["lagging_rank"], res["divergent_seq"], res["op"]) == \
            (2, 4, "all_reduce")
        assert res["losses_equal"]
    assert out[2]["inflight"] == [[4, "all_reduce"]]
    assert all(res["threads"] for res in out)


# ----------------------------------------------------------- lints


_PLUMBING = {"new_group", "get_group", "world_group", "collective_stats",
             "reset_collective_stats"}


def _unrecorded(path):
    tree = ast.parse(open(path).read())
    exported = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            exported = {e.value for e in node.value.elts}
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or \
                node.name not in exported or node.name in _PLUMBING:
            continue
        if not any(isinstance(d, ast.Call) and getattr(d.func, "id", "")
                   == "record_collective" for d in node.decorator_list):
            out.append(node.name)
    return out


def test_every_public_collective_is_recorded():
    assert _unrecorded(os.path.join(
        REPO, "paddle_tpu_torch", "distributed", "collective.py")) == []


def test_lint_detects_an_unrecorded_op(tmp_path):
    bad = tmp_path / "fake_collective.py"
    bad.write_text(
        "__all__ = ['all_reduce', 'barrier', 'new_group']\n"
        "from paddle_tpu_torch.observability.flight import "
        "record_collective\n"
        "def all_reduce(x, group=None):\n"
        "    return x\n"
        "@record_collective('barrier')\n"
        "def barrier(group=None):\n"
        "    pass\n"
        "def new_group():\n"
        "    pass\n")
    assert _unrecorded(str(bad)) == ["all_reduce"]


def test_record_collective_keeps_the_bare_callable():
    calls = []

    @record_collective("probe")
    def probe(x, group=None):
        calls.append(x)
        return x

    rec = _recorder()
    with use_flight_recorder(rec):
        probe(1)
        probe.__wrapped__(2)
    assert calls == [1, 2] and rec.summary()["completed"] == 1


# --------------------------------------------------- overhead smoke


def test_implied_step_overhead_under_bound():
    """The recorder's per-collective cost, scaled to the JAX package's
    documented 1.3B-class step (64 collectives, 1.5 s; ``bench.py``'s
    ``bench_distributed``), stays under its 3 % bound."""
    x = torch.ones(1024)
    bare = collective.all_reduce.__wrapped__
    rec = FlightRecorder(capacity=512, registry=MetricsRegistry(),
                         tracer=Tracer(max_traces=64))

    def per_op(fn, n=300):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        return (time.perf_counter() - t0) / n

    per_op(bare)
    with use_flight_recorder(rec):
        per_op(collective.all_reduce)
        inst = np.median([per_op(collective.all_reduce) for _ in range(3)])
    base = np.median([per_op(bare) for _ in range(3)])
    over = max(0.0, inst - base)
    assert over * 64 / 1.5 < 0.03
    assert over * 1e6 < 1000


def test_observer_leaves_out_stale_heartbeats():
    """A killed world's last beats are not a hang of the relaunched one:
    ``reset()`` (the supervisor's, after it ends a world) deletes every
    rank's heartbeat, so the observer reads only the new world's; before
    it, the dead world's lag fires as in the JAX watchdog."""
    master = TCPStore(is_master=True, world_size=2)
    pubs = {r: HangWatchdog(master, rank=r, world_size=2,
                            recorder=_recorder(), stall_timeout_s=0.0,
                            registry=MetricsRegistry(), tracer=Tracer(),
                            key_prefix="stale")
            for r in range(2)}
    with use_flight_recorder(pubs[0].recorder):
        collective.all_reduce(torch.ones(4))
    for p in pubs.values():
        p.publish()

    def observer():
        return HangWatchdog(master, rank=None, world_size=2,
                            stall_timeout_s=0.0, key_prefix="stale",
                            registry=MetricsRegistry(), tracer=Tracer())

    obs = observer()
    assert obs.poll() is True
    obs.reset()
    assert obs.heartbeats() == {}
    assert obs.poll() is False and observer().poll() is False
    relaunched = HangWatchdog(master, rank=0, world_size=2,
                              recorder=_recorder(), stall_timeout_s=0.0,
                              registry=MetricsRegistry(), tracer=Tracer(),
                              key_prefix="stale")
    relaunched.publish()
    assert list(obs.heartbeats()) == [0]
    assert obs.poll() is False


def test_a_busy_rank_outside_collectives_is_not_a_hang(world):
    """Rank 1 works on the host (no collective in flight, as when it
    writes a checkpoint) for four stall timeouts while its peers wait on
    the wire in ``barrier()``: it lags them by the wire's half step, but
    no watchdog fires — only a rank inside a collective that never
    reached the wire, or behind in completed seqs, is named."""
    out = world.run("torch_dist_cases", "flight_busy_rank_case", 1, 2.0,
                    0.5)
    assert out[1]["lag"] == 0.5
    assert [res["fired"] for res in out] == [0, 0, 0, 0], \
        [res["desync"] for res in out]
