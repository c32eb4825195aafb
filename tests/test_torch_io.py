"""The port's ``io`` against the JAX package's: under one numpy seed the
DataLoader yields the same batches in the same order (shuffled, weighted,
distributed, iterable), collated alike; batches land on the device of
``set_device``; the prefetch thread hands on the dataset's errors and
stops when the caller stops iterating."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io as tio

tpaddle.set_device("cpu")


class _Data:
    """The same map-style dataset in both packages."""

    @staticmethod
    def make(io, n=37):
        class Data(io.Dataset):
            def __len__(self):
                return n

            def __getitem__(self, i):
                x = np.full((3,), i, np.float64)
                return x, np.int64(i), {"id": np.int32(i)}

        return Data()


def _np(batch):
    if isinstance(batch, (tuple, list)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    return np.asarray(batch.data if hasattr(batch, "data") and
                      not isinstance(batch, torch.Tensor) else batch)


def _same(jl, tl, seed=0):
    np.random.seed(seed)
    jb = [_np(b) for b in jl]
    np.random.seed(seed)
    tb = [_np(b) for b in tl]
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2]["id"], b[2]["id"])
    return tb


@pytest.mark.parametrize("kw", [dict(batch_size=8, shuffle=True),
                                dict(batch_size=5, shuffle=True,
                                     drop_last=True),
                                dict(batch_size=6)], ids=str)
def test_batch_order_equals_jax_under_one_numpy_seed(kw):
    tb = _same(jio.DataLoader(_Data.make(jio), **kw),
               tio.DataLoader(_Data.make(tio), **kw))
    assert tb[0][0].dtype == np.float32               # float64 → float32
    assert len(tb) == len(tio.DataLoader(_Data.make(tio), **kw))


def test_samplers_equal_jax():
    for make in (lambda io: io.BatchSampler(sampler=io.RandomSampler(
                     _Data.make(io), replacement=True, num_samples=20),
                     batch_size=4),
                 lambda io: io.BatchSampler(sampler=io.WeightedRandomSampler(
                     np.arange(1, 11), 15), batch_size=3),
                 lambda io: io.DistributedBatchSampler(
                     _Data.make(io), 4, num_replicas=3, rank=1,
                     shuffle=True)):
        np.random.seed(4)
        a = list(make(jio))
        np.random.seed(4)
        b = list(make(tio))
        assert a == b and len(b) > 0


def test_datasets():
    td = tio.TensorDataset([np.arange(6).reshape(3, 2), np.arange(3)])
    assert len(td) == 3 and td[1][1] == 1
    cat = tio.ConcatDataset([_Data.make(tio, 3), _Data.make(tio, 4)])
    assert len(cat) == 7 and cat[5][1] == 2 and cat[-1][1] == 3
    sub = tio.Subset(_Data.make(tio), [4, 2])
    assert sub[1][1] == 2 and len(sub) == 2
    comp = tio.ComposeDataset([td, td])
    assert len(comp[0]) == 4
    np.random.seed(1)
    parts = tio.random_split(_Data.make(tio, 10), [3, 7])
    assert [len(p) for p in parts] == [3, 7]
    np.random.seed(1)
    jparts = jio.random_split(_Data.make(jio, 10), [3, 7])
    assert parts[0].indices == jparts[0].indices


def test_iterable_dataset_batches():
    def make(io):
        class Stream(io.IterableDataset):
            def __iter__(self):
                for i in range(11):
                    yield np.array([i, i], np.float32)

        return Stream()

    _np_ = lambda loader: [np.asarray(_np(b)) for b in loader]  # noqa
    a = _np_(jio.DataLoader(make(jio), batch_size=4))
    b = _np_(tio.DataLoader(make(tio), batch_size=4))
    assert [x.tolist() for x in a] == [x.tolist() for x in b]
    with pytest.raises(TypeError):
        len(tio.DataLoader(make(tio), batch_size=4))


def test_batches_are_tensors_on_the_set_device():
    tpaddle.set_device("cpu")
    x, y, d = next(iter(tio.DataLoader(_Data.make(tio), batch_size=4)))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert y.dtype == torch.int64 and d["id"].dtype == torch.int32
    collated = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert collated.shape == (2, 2)


def test_worker_processes_are_not_ported():
    """(Name kept from the slice before worker processes were ported;
    ``test_torch_dataloader_mp.py`` holds them to the JAX package.)
    ``num_workers=2`` now yields the batches ``num_workers=0`` yields."""
    np.random.seed(3)
    want = [_np(b) for b in tio.DataLoader(_Data.make(tio), batch_size=4,
                                           shuffle=True)]
    np.random.seed(3)
    got = [_np(b) for b in tio.DataLoader(_Data.make(tio), batch_size=4,
                                          shuffle=True, num_workers=2,
                                          timeout=30)]
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for a, b in ((g[0], w[0]), (g[1], w[1]), (g[2]["id"], w[2]["id"])):
            np.testing.assert_array_equal(a, b)


def test_dataset_errors_reach_the_caller():
    class Bad(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return np.float32(i)

    loader = tio.DataLoader(Bad(), batch_size=2)
    it = iter(loader)
    assert next(it).tolist() == [0.0, 1.0]
    assert next(it).tolist() == [2.0, 3.0]
    with pytest.raises(KeyError):
        next(it)


def test_prefetch_thread_stops_when_iteration_stops():
    before = threading.active_count()
    loader = tio.DataLoader(_Data.make(tio, 400), batch_size=1)
    for i, _ in enumerate(loader):
        if i == 3:
            break
    for t in threading.enumerate():
        if t.name == "DataLoader-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()
    assert threading.active_count() <= before
