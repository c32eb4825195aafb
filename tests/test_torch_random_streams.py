"""Named random streams and ``RNGStatesTracker``
(``paddle_tpu_torch/core/random.py``) against the JAX package's
(``paddle_tpu/core/random.py``) on the CPU.

The tracker's and the streams' errors, the active stream ``rng_state``
sets and restores, and that draws under a named stream or inside
``key_stream`` leave the default stream alone are checked on both
packages.  Snapshots round-trip every stream (and the older snapshot of
the default stream's generators alone still loads), a hapi fit killed
mid-run resumes with a named stream's draws where they were, and in an
mp 2 world over gloo the masks drawn under ``global_seed`` are equal on
both ranks and those under ``local_seed`` differ.  Masks are never
compared with JAX's: a JAX key and a torch generator draw differently
from the same seed."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core import random as jrandom

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from torch_world import World


@pytest.fixture(autouse=True)
def _isolated():
    """Each test's streams, tracker seeds and active stream are its own."""
    tpaddle.set_device("cpu")
    saved = (dict(trandom._streams), dict(jrandom._state.streams),
             set(trandom.get_rng_state_tracker().seeds),
             set(jrandom.get_rng_state_tracker().seeds))
    trandom.get_rng_state_tracker().reset()
    jrandom.get_rng_state_tracker().reset()
    yield
    trandom._streams.clear()
    trandom._streams.update(saved[0])
    jrandom._state.streams.clear()
    jrandom._state.streams.update(saved[1])
    trandom.get_rng_state_tracker().seeds = saved[2]
    jrandom.get_rng_state_tracker().seeds = saved[3]


def _jkey(k):
    return np.asarray(jax.random.key_data(k))


def _tkey(k):
    return k.numpy()


BOTH = [pytest.param(jrandom, _jkey, id="jax"),
        pytest.param(trandom, _tkey, id="torch")]


@pytest.mark.parametrize("rnd, key", BOTH)
def test_tracker_refuses_a_repeated_seed(rnd, key):
    tracker = rnd.get_rng_state_tracker()
    tracker.add("global_seed", 11)
    with pytest.raises(ValueError, match="already added"):
        tracker.add("local_seed", 11)
    tracker.reset()
    tracker.add("local_seed", 11)        # reset forgets the seeds


@pytest.mark.parametrize("rnd, key", BOTH)
def test_unregistered_streams_raise_key_error(rnd, key):
    with pytest.raises(KeyError):
        with rnd.get_rng_state_tracker().rng_state("never_added"):
            pass
    with pytest.raises(KeyError):
        rnd.current_key("never_added")


@pytest.mark.parametrize("rnd, key", BOTH)
def test_rng_state_sets_and_restores_the_active_stream(rnd, key):
    tracker = rnd.get_rng_state_tracker()
    tracker.add("global_seed", 21)
    tracker.add("local_seed", 22)
    g0 = key(rnd.current_key("global_seed"))
    with tracker.rng_state("local_seed"):
        with tracker.rng_state("global_seed"):
            rnd.split_key()
        assert rnd._state.active == "local_seed"
    assert rnd._state.active == "default"
    assert not np.array_equal(key(rnd.current_key("global_seed")), g0)
    with pytest.raises(RuntimeError):
        with tracker.rng_state("global_seed"):
            raise RuntimeError("inside")
    assert rnd._state.active == "default"


@pytest.mark.parametrize("rnd, key", BOTH)
def test_named_draws_leave_the_default_stream_alone(rnd, key):
    rnd.seed(5)
    rnd.get_rng_state_tracker().add("local_seed", 6)
    d0 = key(rnd.current_key())
    l0 = key(rnd.current_key("local_seed"))
    with rnd.get_rng_state_tracker().rng_state("local_seed"):
        rnd.split_key()
    rnd.split_key("local_seed")
    with rnd.key_stream(rnd.split_key("local_seed")):
        rnd.split_key()
        rnd.split_key()
    assert np.array_equal(key(rnd.current_key()), d0)
    assert not np.array_equal(key(rnd.current_key("local_seed")), l0)


@pytest.mark.parametrize("rnd, key", BOTH)
def test_split_key_is_seeded_and_key_stream_deterministic(rnd, key):
    draws = []
    for _ in range(2):
        rnd.seed(7, stream="s")
        base = rnd.split_key("s")
        with rnd.key_stream(base):
            inner = [rnd.split_key(), rnd.split_key("s")]
            with rnd.key_stream(rnd.split_key()):
                nested = rnd.split_key()
            inner.append(rnd.split_key())       # the outer one again
        draws.append([base, *inner, nested])
    as_np = [[np.asarray(jax.random.key_data(d)) if rnd is jrandom
              else np.asarray(d) for d in run] for run in draws]
    for a, b in zip(*as_np):
        assert np.array_equal(a, b)
    first = as_np[0]
    # every draw inside differs: the counter moves, whatever stream is named
    assert len({a.tobytes() for a in first[1:4]}) == 3
    assert not np.array_equal(first[3], first[4])


def test_device_draws_follow_the_active_stream():
    """``F.dropout`` and the random ops draw from the active stream's
    generator; a named stream seeded with s draws what
    ``torch.Generator().manual_seed(s)`` draws."""
    tpaddle.seed(1)
    tracker = trandom.get_rng_state_tracker()
    tracker.add("global_seed", 40)
    x = torch.ones(64, 64)
    with tracker.rng_state("global_seed"):
        got = tpaddle.nn.functional.dropout(x, 0.5)
        u = tpaddle.rand([8])
    ref = torch.Generator().manual_seed(40)
    mask = torch.rand(x.shape, generator=ref) < 0.5
    assert torch.equal(got, torch.where(mask, x / 0.5, 0))
    assert torch.equal(u, torch.rand(8, generator=ref))
    # the default stream was not touched: it draws seed 1's first numbers
    assert torch.equal(tpaddle.rand([8]),
                       torch.rand(8, generator=torch.Generator().manual_seed(1)))


def test_key_stream_gives_fresh_generators_and_keeps_identity():
    tpaddle.seed(3)
    gen = trandom.generator("cpu")
    with trandom.key_stream(99):
        a, b = trandom.generator("cpu"), trandom.generator("cpu")
        assert a is not gen and b is not a
        first = torch.rand(4, generator=a)
    with trandom.key_stream(99):
        assert torch.equal(torch.rand(4, generator=trandom.generator("cpu")),
                           first)
    assert trandom.generator("cpu") is gen
    tpaddle.seed(4)
    trandom.seed(5, stream="other")
    assert trandom.generator("cpu") is gen          # seeded in place
    with trandom.get_rng_state_tracker().rng_state("other"):
        other = trandom.generator("cpu")
    assert set(map(id, trandom.generators("cpu"))) >= {id(gen), id(other)}


def test_snapshot_round_trips_every_stream():
    tpaddle.seed(8)
    tracker = trandom.get_rng_state_tracker()
    tracker.add("global_seed", 80)
    with tracker.rng_state("global_seed"):
        torch.rand(3, generator=trandom.generator("cpu"))
    torch.rand(2, generator=trandom.generator("cpu"))
    trandom.split_key()
    snap = trandom.get_rng_state()
    assert {"default", "global_seed"} <= set(snap)

    def draws():
        out = [torch.rand(5, generator=trandom.generator("cpu")),
               torch.tensor(trandom.split_key())]
        with tracker.rng_state("global_seed"):
            out += [torch.rand(5, generator=trandom.generator("cpu")),
                    torch.tensor(trandom.split_key())]
        return out

    want = draws()
    tpaddle.seed(1234)
    trandom.seed(4321, stream="global_seed")
    trandom.set_rng_state(snap)
    for a, b in zip(draws(), want):
        assert torch.equal(a, b)
    # a snapshot of the default stream's generators alone still loads
    older = {"cpu": snap["default"]["cpu"]}
    tpaddle.seed(77)
    trandom.set_rng_state(older)
    assert torch.equal(torch.rand(5, generator=trandom.generator("cpu")),
                       want[0])


def test_jax_snapshot_round_trips_a_named_stream():
    jrandom.seed(8)
    jrandom.get_rng_state_tracker().add("global_seed", 80)
    snap = jrandom.get_rng_state()
    want = _jkey(jrandom.split_key("global_seed"))
    jrandom.seed(999, stream="global_seed")
    jrandom.set_rng_state(snap)
    assert np.array_equal(_jkey(jrandom.split_key("global_seed")), want)


# ---------------------------------------------------- a fit that resumes


class _Data(tpaddle.io.Dataset):
    def __init__(self):
        rng = np.random.RandomState(0)
        self.y = rng.randint(0, 2, (64,)).astype(np.int64)
        self.x = (rng.randn(64, 8) + self.y[:, None] * 2.0).astype(
            np.float32)

    def __len__(self):
        return 64

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _model(stream_seed):
    """A hapi model whose hidden dropout draws from the tracker's
    ``local_seed`` stream (seeded ``stream_seed``)."""
    from paddle_tpu_torch.hapi import Model

    nn = tpaddle.nn
    tracker = trandom.get_rng_state_tracker()

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(8, 32)
            self.b = nn.Linear(32, 2)

        def forward(self, x):
            with tracker.rng_state("local_seed"):
                h = nn.functional.dropout(nn.functional.relu(self.a(x)), 0.3)
            return self.b(h)

    tpaddle.seed(3)
    tracker.reset()
    tracker.add("local_seed", stream_seed)
    model = Model(Net())
    model.prepare(tpaddle.optimizer.Momentum(
        learning_rate=0.1, parameters=model.parameters()),
        nn.CrossEntropyLoss())
    return model


def _fit(ckdir, stream_seed, kill_at=None, resume=None):
    from paddle_tpu_torch.hapi import Callback, CheckpointCallback
    from paddle_tpu_torch.resilience import (FaultSpec, SimulatedCrash,
                                             injected_faults)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    model = _model(stream_seed)
    rec = Losses()
    args = dict(batch_size=16, epochs=2, shuffle=False, verbose=0,
                callbacks=[rec, CheckpointCallback(ckdir, every_n_steps=1)],
                resume_from=resume)
    if kill_at is None:
        model.fit(_Data(), **args)
    else:
        with injected_faults(FaultSpec("hapi.train_step", "kill",
                                       occurrence=kill_at)):
            with pytest.raises(SimulatedCrash):
                model.fit(_Data(), **args)
    return rec.losses


def test_replay_snapshot_carries_a_named_stream():
    """``replay_train_batch`` from a pre-step snapshot draws the live
    step's masks from the named stream, which has moved on since."""
    model = _model(60)
    data = _Data()
    batches = [(data.x[i:i + 16], data.y[i:i + 16]) for i in (0, 16, 32)]
    for x, y in batches[:2]:
        model.train_batch(x, y)
    snap = model.train_state_snapshot()
    live_loss, _ = model.train_batch(*batches[2])
    live = {k: p.detach().clone()
            for k, p in model.network.named_parameters()}
    loss, params = model.replay_train_batch(snap, batches[2])
    assert loss == live_loss
    for k, p in live.items():
        assert torch.equal(params[k], p), k


@pytest.mark.faultinject
def test_fit_resumes_with_a_named_stream(tmp_path):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _fit(str(tmp_path / "ref"), 50)
        ckdir = str(tmp_path / "ck")
        part_a = _fit(ckdir, 50, kill_at=6)
        # relaunched with another seed: the restore overwrites the stream
        part_b = _fit(ckdir, 51, resume=ckdir)
        other = _fit(str(tmp_path / "other"), 51)
    finally:
        torch.set_num_threads(prev)
    assert len(ref) == 8 and len(part_a) == 6 and len(part_b) == 2
    assert part_a + part_b == ref               # bitwise on the CPU
    assert other[6:] != ref[6:]                 # the stream mattered


# ------------------------------------------------------------ a world

MP = 2


@pytest.fixture(scope="module")
def tracker_ranks():
    rng = np.random.RandomState(0)
    f = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)  # noqa: E731
    arrays = {"w1": f(16, 64), "b1": f(64), "w2": f(64, 16), "b2": f(16),
              "x": f(8, 16)}
    world = World(MP)
    try:
        yield world.run("torch_dist_cases", "tracker_case", MP, arrays, 7)
    finally:
        world.close()


def test_global_masks_equal_and_local_masks_differ_across_mp(tracker_ranks):
    r0, r1 = tracker_ranks
    assert r0["global"] == r1["global"] and r0["local"] == r1["local"]
    assert r0["global"][0] == r0["global"][1]       # equal across the group
    assert r0["local"][0] != r0["local"][1]         # distinct per rank
    for r in tracker_ranks:
        assert 0.02 < r["dropped"][0] < 0.2 and 0.02 < r["dropped"][1] < 0.2


def test_tracker_runs_repeat_and_keep_the_default_stream(tracker_ranks):
    for r in tracker_ranks:
        assert r["losses"][0] == r["losses"][1]
        assert r["default_kept"]
    assert tracker_ranks[0]["losses"] == tracker_ranks[1]["losses"]
