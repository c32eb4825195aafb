"""The port's DataLoader worker processes (``paddle_tpu_torch/io/
multiprocess.py``) and industrial datasets (``io/industrial.py``) against
the JAX package's.

Under one numpy seed the port's loader with forked workers yields the
JAX loader's batches, and its own ``num_workers=0`` batches bit for bit,
in the sampler's order; errors, deaths and timeouts of workers reach the
caller; a worker that asks for CUDA gets the directed error.  Every test
that starts workers runs under its own deadline (``deadline``) and,
through the autouse ``no_shm_left`` fixture, checks that no
shared-memory segment made for this process (``/dev/shm/ptt_<pid>_*``)
is left behind."""
import contextlib
import glob
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.io import multiprocess as tmp_

tpaddle.set_device("cpu")
# this process's segments only: another xdist worker's loaders may hold
# live segments of their own at any time
SHM = "/dev/shm/" + tmp_.segment_prefix() + "*"


@contextlib.contextmanager
def deadline(seconds):
    """Fail the test (TimeoutError) if its body runs past ``seconds``."""
    def boom(signum, frame):
        raise TimeoutError(f"test body exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, boom)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def no_shm_left():
    before = set(glob.glob(SHM))
    yield
    time.sleep(0.05)
    left = set(glob.glob(SHM)) - before
    assert not left, f"shared-memory segments left behind: {left}"


def _square(io):
    class SquareDataset(io.Dataset):
        def __init__(self, n=32):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            x = np.full((8,), float(i), np.float32)
            return x * x, np.int64(i), {"id": np.int32(i)}

    return SquareDataset


def _np(batch):
    if isinstance(batch, (tuple, list)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(getattr(batch, "data", batch))


def _equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype or \
            np.asarray(a).dtype.kind == np.asarray(b).dtype.kind


def _batches(loader):
    return [_np(b) for b in loader]


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_workers_match_jax_and_inline_order(workers, shuffle):
    """Seeded sampler: the port with workers == the port inline == the
    JAX loader (inline and with its own workers), bit for bit."""
    with deadline(60):
        runs = {}
        for name, io, nw in (("jax0", jio, 0), ("jaxw", jio, 2),
                             ("port0", tio, 0), ("portw", tio, workers)):
            np.random.seed(7)
            runs[name] = _batches(io.DataLoader(
                _square(io)(30), batch_size=4, shuffle=shuffle,
                num_workers=nw, timeout=30))
        assert len(runs["portw"]) == 8
        for name in ("jax0", "jaxw", "port0"):
            _equal(runs["portw"], runs[name])


@pytest.mark.parametrize("mode", ["no_shm", "threads"])
def test_other_transports_match_inline(mode):
    with deadline(60):
        ds = _square(tio)(16)
        ref = _batches(tio.DataLoader(ds, batch_size=4))
        kw = ({"use_shared_memory": False} if mode == "no_shm"
              else {"use_thread_workers": True})
        got = _batches(tio.DataLoader(ds, batch_size=4, num_workers=2,
                                      timeout=30, **kw))
        _equal(got, ref)


def test_tensors_and_dtypes_cross_the_segment_exactly():
    """Torch leaves (bf16, bool, int64, 0-d), numpy leaves and scalars
    rebuild with their dtypes, shapes and bits."""
    class Mixed(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {"bf": torch.full((2, 3), i / 3, dtype=torch.bfloat16),
                    "flag": torch.tensor(i % 2 == 0),
                    "id": torch.tensor(i, dtype=torch.int64),
                    "arr": np.arange(4, dtype=np.uint8) + i,
                    "name": f"s{i}"}

    def collate(samples):
        out = tio.default_collate_fn(
            [{k: v for k, v in s.items() if k != "name"} for s in samples])
        out["name"] = [s["name"] for s in samples]
        return out

    with deadline(60):
        ref = list(tio.DataLoader(Mixed(), batch_size=3, collate_fn=collate))
        got = list(tio.DataLoader(Mixed(), batch_size=3, collate_fn=collate,
                                  num_workers=2, timeout=30))
    for a, b in zip(ref, got):
        for k in ("bf", "flag", "id"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert torch.equal(a[k], b[k]), k
        np.testing.assert_array_equal(a["arr"], b["arr"])
        assert list(b["name"]) == a["name"]


# ------------------------------------------------------ worker faults


def test_worker_error_propagates_with_traceback():
    class Failing(tio.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 7:
                raise ValueError("poisoned sample 7")
            return np.ones(2, np.float32)

    with deadline(60):
        loader = tio.DataLoader(Failing(), batch_size=4, num_workers=2,
                                timeout=30)
        with pytest.raises(RuntimeError, match="poisoned sample 7") as ei:
            list(loader)
        assert "Traceback" in str(ei.value)


def test_worker_init_fn_and_worker_info():
    seen = []

    class WhoAmI(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            return np.asarray([info.id, info.num_workers, os.getpid()])

    def init(worker_id):
        assert tio.get_worker_info().id == worker_id
        assert tpaddle._device.IN_FORKED_WORKER

    with deadline(60):
        for b in tio.DataLoader(WhoAmI(), batch_size=2, num_workers=2,
                                worker_init_fn=init, timeout=30):
            seen.append(b.numpy())
    rows = np.concatenate(seen)
    assert set(rows[:, 0]) <= {0, 1} and set(rows[:, 1]) == {2}
    assert os.getpid() not in set(rows[:, 2])
    assert tio.get_worker_info() is None
    assert not tpaddle._device.IN_FORKED_WORKER


def _stream(io, sharded, n=24):
    class Stream(io.IterableDataset):
        def __iter__(self):
            info = io.get_worker_info()
            wid = info.id if (info and sharded) else 0
            nw = info.num_workers if (info and sharded) else 1
            for i in range(n):
                if i % nw == wid:
                    yield np.full((4,), float(i), np.float32)

    return Stream()


@pytest.mark.parametrize("sharded", [True, False])
def test_iterable_streams_match_jax(sharded):
    """Round-robin interleave of the workers' streams: the JAX package's
    batches in its order (sharded: every sample once; unsharded: each
    sample once a worker, as the reference)."""
    with deadline(60):
        want = _batches(jio.DataLoader(_stream(jio, sharded), batch_size=4,
                                       num_workers=3))
        got = _batches(tio.DataLoader(_stream(tio, sharded), batch_size=4,
                                      num_workers=3, timeout=30))
    _equal(got, want)
    seen = sorted(v for b in got for v in b[:, 0])
    assert seen == sorted([float(i) for i in range(24)]
                          * (1 if sharded else 3))


def test_cuda_in_a_worker_is_refused_with_a_directed_error():
    """A forked worker must never touch CUDA: asking the port for the
    card inside one raises the directed error in the parent."""
    class AsksForTheCard(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            tpaddle.set_device("gpu")
            return np.ones(2, np.float32)

    with deadline(60):
        loader = tio.DataLoader(AsksForTheCard(), batch_size=2,
                                num_workers=2, timeout=30)
        with pytest.raises(RuntimeError,
                           match="CUDA use inside a forked worker"):
            list(loader)
    assert tpaddle.get_device() == "cpu"


def test_sigkilled_worker_is_named_promptly():
    class Killer(tio.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if tio.get_worker_info().id == 1:
                os._exit(137)
            time.sleep(0.01)
            return np.ones(2, np.float32)

    with deadline(30):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError,
                           match=r"DataLoader worker 1 failed") as ei:
            list(tio.DataLoader(Killer(), batch_size=4, num_workers=2))
        assert "exitcode 137" in str(ei.value)
        assert time.monotonic() - t0 < 20.0


def test_clean_exit_without_batch_raises_not_hangs():
    class CleanExit(tio.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i >= 4:
                os._exit(0)
            return np.ones(2, np.float32)

    with deadline(30):
        with pytest.raises(RuntimeError,
                           match="without producing the awaited batch"):
            list(tio.DataLoader(CleanExit(), batch_size=4, num_workers=2))


def test_timeout_raises():
    class Slow(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(2)
            return np.ones(2, np.float32)

    with deadline(30):
        with pytest.raises(RuntimeError, match="timed out after 1s"):
            list(tio.DataLoader(Slow(), batch_size=2, num_workers=1,
                                timeout=1))


# ------------------------------------------------------ early abandon


def test_early_break_unlinks_pending_segments():
    """Breaking after one batch unlinks every prefetched segment (the
    autouse fixture checks /dev/shm)."""
    with deadline(60):
        it = iter(tio.DataLoader(_square(tio)(64), batch_size=4,
                                 num_workers=3, timeout=30))
        next(it)
        time.sleep(0.2)
        it.close()


def test_iterable_early_break_unlinks_worker_held_segments():
    """Iterable mode, bounded queue: a worker blocked in put() holds a
    segment whose name has not reached the parent; the cooperative stop
    lets it through and it is unlinked."""
    class BigStream(tio.IterableDataset):
        def __iter__(self):
            for i in range(500):
                yield np.full((256,), float(i), np.float32)

    with deadline(60):
        it = iter(tio.DataLoader(BigStream(), batch_size=4, num_workers=2,
                                 timeout=30))
        next(it)
        time.sleep(0.5)
        it.close()


# --------------------------------------------------- industrial datasets


def _slot_files(tmp_path, n_files=2, lines=6):
    files = []
    for fi in range(n_files):
        f = tmp_path / f"part-{fi}.txt"
        rows = []
        for i in range(lines):
            uid = fi * lines + i
            rows.append(f"click:{uid % 2} slot1:{uid} slot1:{uid + 100} "
                        f"dense:{uid / 10:.2f}")
        f.write_text("\n".join(rows) + "\n")
        files.append(str(f))
    return files


def _in_memory(io, tmp_path):
    ds = io.InMemoryDataset()
    ds.init(use_slots=["click", "slot1", "dense"], dense_slots=("dense",))
    ds.set_filelist([str(tmp_path / "part-*.txt")])
    return ds.load_into_memory()


@pytest.mark.parametrize("shuffle", ["none", "local", "global"])
def test_in_memory_dataset_matches_jax(tmp_path, shuffle):
    _slot_files(tmp_path)
    sets = [_in_memory(io, tmp_path) for io in (jio, tio)]
    for ds in sets:
        if shuffle == "local":
            ds.local_shuffle(seed=3)
            ds.local_shuffle()
        elif shuffle == "global":
            ds.global_shuffle()
    j, t = sets
    assert len(t) == len(j) == t.get_memory_data_size() == 12
    for i in range(12):
        _equal(_np(t[i]), _np(j[i]))
    assert t[0]["dense"].dtype == np.float32


def test_queue_dataset_streams_and_shards(tmp_path):
    files = _slot_files(tmp_path)

    def parse(line):
        return np.asarray([float(tok.split(":")[1])
                           for tok in line.split()[:2]], np.float32)

    def make(io):
        ds = io.QueueDataset()
        ds.init(parse_fn=parse)
        ds.set_filelist(files)
        return ds

    assert [list(s) for s in make(tio)] == [list(s) for s in make(jio)]
    with deadline(60):
        got = _batches(tio.DataLoader(make(tio), batch_size=3,
                                      num_workers=2, timeout=30))
        want = _batches(jio.DataLoader(make(jio), batch_size=3,
                                       num_workers=2))
    _equal(got, want)
    assert sum(b.shape[0] for b in got) == 12


def test_industrial_guards(tmp_path):
    with pytest.raises(RuntimeError, match="load_into_memory"):
        len(tio.InMemoryDataset())
    with pytest.raises(NotImplementedError, match="pipe_command"):
        tio.InMemoryDataset().init(pipe_command="awk ...")
    with pytest.raises(TypeError, match="unknown init"):
        tio.InMemoryDataset().init(bogus=1)
    from paddle_tpu.io.industrial import parse_slot_line as jparse
    from paddle_tpu_torch.io.industrial import parse_slot_line as tparse

    line = "a:1 b:2.5 a:3 c:7"
    _equal(_np(tparse(line, ["a", "b"], ("b",))),
           _np(jparse(line, ["a", "b"], ("b",))))
