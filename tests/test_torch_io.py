"""``paddle_tpu_torch.io`` against the JAX package's ``io`` on the CPU:

- the datasets (``TensorDataset``, ``ComposeDataset``, ``ChainDataset``,
  ``ConcatDataset``, ``Subset``, ``random_split``) give the reference's
  items;
- every sampler gives the reference's index order after the same
  ``np.random.seed`` (``DistributedBatchSampler``: ``RandomState(epoch)``,
  per rank, padded and with ``drop_last``);
- the DataLoader's batches — synchronous, thread workers, process
  workers through the native shared-memory ring — equal the reference's
  synchronous batches, in order, as tensors on the current device, and
  the ring carried every process-worker batch;
- a worker's exception surfaces in the trainer, and a worker process
  that dies is reported;
- ``IterableDataset``, dict and tuple collation, ``drop_last``.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu import io as jio
from paddle_tpu.vision.datasets import FakeData as JFakeData
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision.datasets import FakeData
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _np(x):
    return np.asarray(as_np(x))


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, (list, tuple)) else [g]
        w = w if isinstance(w, (list, tuple)) else [w]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(_np(a), _np(b))


ARR = np.arange(40, dtype=np.float32).reshape(20, 2)
LAB = np.arange(20, dtype=np.int64)


# --------------------------------------------------------------- datasets
def test_tensor_compose_concat_subset_datasets():
    t = tio.TensorDataset([ARR, LAB])
    j = jio.TensorDataset([ARR, LAB])
    assert len(t) == len(j) == 20
    for i in (0, 7, 19):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
    with pytest.raises(ValueError):
        tio.TensorDataset([ARR, LAB[:5]])
    fake_t, fake_j = FakeData(5, (2, 3), 4), JFakeData(5, (2, 3), 4)
    for tc, jc in ((tio.ComposeDataset([fake_t, fake_t]),
                    jio.ComposeDataset([fake_j, fake_j])),
                   (tio.ConcatDataset([fake_t, fake_t]),
                    jio.ConcatDataset([fake_j, fake_j])),
                   (tio.Subset(fake_t, [4, 0, 2]),
                    jio.Subset(fake_j, [4, 0, 2]))):
        assert len(tc) == len(jc)
        for i in range(len(tc)):
            for a, b in zip(tc[i], jc[i]):
                np.testing.assert_array_equal(_np(a), _np(b))
    assert tio.ConcatDataset([fake_t, fake_t])[-1][1] == fake_t[4][1]


@pytest.mark.parametrize("lengths", [[12, 8], [0.25, 0.75]])
def test_random_split_matches_reference(lengths):
    np.random.seed(4)
    got = tio.random_split(FakeData(20, (1,), 3), lengths)
    np.random.seed(4)
    want = jio.random_split(JFakeData(20, (1,), 3), lengths)
    assert [s.indices for s in got] == [s.indices for s in want]


def test_chain_and_iterable_datasets():
    class Count(tio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(np.arange(self.n, dtype=np.int64))

    chain = tio.ChainDataset([Count(3), Count(4)])
    assert [int(v) for v in chain] == [0, 1, 2, 0, 1, 2, 3]
    with pytest.raises(RuntimeError):
        Count(2)[0]
    for drop, want in ((False, [[0, 1, 2], [3, 4, 5], [6]]),
                       (True, [[0, 1, 2], [3, 4, 5]])):
        got = [b.tolist() for b in tio.DataLoader(Count(7), batch_size=3,
                                                  drop_last=drop)]
        assert got == want


# --------------------------------------------------------------- samplers
SAMPLERS = {
    "sequence": lambda m: m.SequenceSampler(list(range(17))),
    "random": lambda m: m.RandomSampler(list(range(17))),
    "random_replacement": lambda m: m.RandomSampler(
        list(range(17)), replacement=True, num_samples=25),
    "random_num_samples": lambda m: m.RandomSampler(list(range(17)),
                                                    num_samples=9),
    "subset_random": lambda m: m.SubsetRandomSampler([3, 9, 1, 12, 5]),
    "weighted": lambda m: m.WeightedRandomSampler(
        [0.1, 0.5, 2.0, 0.0, 1.0], 12),
    "weighted_no_replacement": lambda m: m.WeightedRandomSampler(
        [0.1, 0.5, 2.0, 0.3, 1.0], 4, replacement=False),
    "batch_shuffle": lambda m: m.BatchSampler(list(range(17)), shuffle=True,
                                              batch_size=4),
    "batch_drop_last": lambda m: m.BatchSampler(list(range(17)),
                                                batch_size=4,
                                                drop_last=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_order_matches_reference(name):
    t, j = SAMPLERS[name](tio), SAMPLERS[name](jio)
    for seed in (0, 1):
        np.random.seed(seed)
        got = list(t)
        np.random.seed(seed)
        assert got == list(j)
    assert len(t) == len(j)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_distributed_batch_sampler_matches_reference(shuffle, drop_last):
    data = list(range(23))
    for rank in range(3):
        kw = dict(batch_size=3, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        t = tio.DistributedBatchSampler(data, **kw)
        j = jio.DistributedBatchSampler(data, **kw)
        for epoch in (0, 5):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
        assert len(t) == len(j)


def test_distributed_batch_sampler_defaults_to_one_rank():
    s = tio.DistributedBatchSampler(list(range(10)), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


# ------------------------------------------------------------- DataLoader
def _reference_batches(shuffle, seed, batch_size=4, drop_last=False):
    np.random.seed(seed)
    jl = jio.DataLoader(JFakeData(18, (3, 4), 5), batch_size=batch_size,
                        shuffle=shuffle, drop_last=drop_last)
    return [[b.value for b in batch] for batch in jl]


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches_sync_and_threads_match_reference(workers, shuffle):
    np.random.seed(2)
    tl = tio.DataLoader(FakeData(18, (3, 4), 5), batch_size=4,
                        shuffle=shuffle, num_workers=workers,
                        prefetch_factor=2)
    got = list(tl)
    assert len(tl) == 5
    _same_batches(got, _reference_batches(shuffle, 2))
    assert got[0][0].device.type == "cpu" and got[0][1].dtype == torch.int32


def test_process_workers_through_the_ring_match_reference():
    """Two spawned workers, batches in order through the shared-memory
    ring (every one of them), equal to the reference's; a second pass
    starts the workers anew."""
    from paddle_tpu_torch import csrc
    assert csrc.available()
    np.random.seed(3)
    tl = tio.DataLoader(FakeData(18, (3, 4), 5), batch_size=4,
                        shuffle=True, num_workers=2, worker_mode="process",
                        drop_last=True)
    got = list(tl)
    assert tl.transport == {"ring": 4, "queue": 0}
    _same_batches(got, _reference_batches(True, 3, drop_last=True))
    assert len(list(tl)) == 4


def test_process_workers_without_shared_memory_use_the_queue():
    tl = tio.DataLoader(tio.TensorDataset([ARR, LAB]), batch_size=5,
                        num_workers=2, worker_mode="process",
                        use_shared_memory=False)
    got = list(tl)
    assert tl.transport == {"ring": 0, "queue": 4}
    np.testing.assert_array_equal(_np(got[2][1]), LAB[10:15])


def test_worker_errors_surface():
    bad = tio.Subset(tio.TensorDataset([ARR, LAB]), [0, 1, 2, 99])
    for kw in ({"num_workers": 2}, {"num_workers": 2,
                                    "worker_mode": "process"}):
        with pytest.raises((IndexError, RuntimeError), match="index|99"):
            list(tio.DataLoader(bad, batch_size=2, **kw))
    dead = tio.DataLoader(tio.TensorDataset([ARR, LAB]), batch_size=2,
                          num_workers=2, worker_mode="process",
                          worker_init_fn=os._exit, timeout=0)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(dead)
    with pytest.raises(ValueError, match="worker_mode"):
        tio.DataLoader(bad, worker_mode="fork")


def test_collate_dicts_tuples_and_tensors():
    samples = [{"x": np.full(2, i, np.float32), "y": (i, float(i))}
               for i in range(3)]
    got = tio.default_collate_fn(samples)
    np.testing.assert_array_equal(got["x"], np.repeat(np.arange(3.0), 2)
                                  .reshape(3, 2))
    assert got["y"][0].tolist() == [0, 1, 2]
    want = jio.default_collate_fn(samples)
    np.testing.assert_array_equal(got["y"][1], want["y"][1])
    t = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(t, torch.Tensor) and t.shape == (2, 2)
    loader = tio.DataLoader(tio.TensorDataset([ARR, LAB]), batch_size=8,
                            num_workers=2)
    first = next(iter(loader))
    assert isinstance(first, list) and first[0].shape == (8, 2)
    assert tio.get_worker_info() is None


def test_worker_init_fn_runs_once_a_thread_worker():
    seen = []
    loader = tio.DataLoader(tio.TensorDataset([ARR, LAB]), batch_size=4,
                            num_workers=3, worker_init_fn=seen.append)
    assert len(list(loader)) == 5
    assert sorted(seen) == [0, 1, 2]


def test_batches_land_on_the_current_device():
    paddle.set_device("cpu")
    (x, _), = list(tio.DataLoader(tio.TensorDataset([ARR[:2], LAB[:2]]),
                                  batch_size=2))
    assert x.device.type == "cpu"
    P.set_device("cpu")
