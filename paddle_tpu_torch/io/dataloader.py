"""DataLoader — the counterpart of ``paddle_tpu/io/dataloader.py``
(reference: ``python/paddle/io/dataloader/dataloader_iter.py`` +
``worker.py``: worker processes, pinned memory, prefetch).

Workers produce numpy batches (``default_collate_fn``); a bounded
prefetch keeps ``num_workers * prefetch_factor`` batches in flight, in
order. ``num_workers > 0`` runs a thread pool by default (numpy releases
the interpreter lock in its heavy loops, and threads need no pickling of
the dataset); ``worker_mode="process"`` runs worker processes from the
``spawn`` context with an order-preserving reorder buffer and crash
propagation, each worker writing its batches into a native shared-memory
ring of its own (``paddle_tpu_torch.csrc.ShmRing``) where one can be
built, else through a ``multiprocessing`` queue, record by record.

The one difference from the JAX package: a batch comes out as tensors on
the port's current device (``paddle.set_device``), a CUDA batch copied
from pinned host memory with ``non_blocking=True``, so the copy overlaps
the work already queued on the card.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from ..core import device as device_mod
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

#: each process worker's ring: one ImageNet training batch (64 float32
#: images of 3 x 224 x 224, 38.5 MB pickled) fits it; a larger record goes
#: through the queue
RING_BYTES = 1 << 26


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


def _mp_worker_loop(dataset, index_queue, result_queue, collate_fn, wid,
                    num_workers, worker_init_fn, ring_name=None):
    """Worker-process main (reference ``worker.py::_worker_loop``): pull
    (task_id, indices), fetch and collate, push (task_id, batch, error).

    With ``ring_name`` the results travel through the native shared-memory
    ring (one copy into the mapped segment) instead of being pickled
    through the queue's pipe; a record the ring cannot take (it failed to
    open, or the record is larger than the ring) goes through the queue."""
    _worker_info.info = _WorkerInfo(wid, num_workers, dataset)
    ring = None
    if ring_name is not None:
        try:
            from ..csrc import ShmRing
            ring = ShmRing.open(ring_name)
        except (OSError, RuntimeError):
            ring = None

    def emit(rec):
        if ring is not None:
            try:
                ring.push(pickle.dumps(rec,
                                       protocol=pickle.HIGHEST_PROTOCOL))
                return
            except ValueError:
                pass  # record larger than the ring: use the queue
        result_queue.put(rec)

    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while True:
            task = index_queue.get()
            if task is None:
                break
            task_id, indices = task
            try:
                batch = collate_fn([dataset[i] for i in indices])
                emit((task_id, batch, None))
            except Exception as e:  # noqa: BLE001 - propagated to parent
                emit((task_id, None,
                      f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
    except KeyboardInterrupt:
        pass
    finally:
        if ring is not None:
            ring.mark_closed()
            ring.close(unlink=False)


def default_collate_fn(batch):
    """Stack a list of samples into batched numpy arrays (Paddle's
    semantics); samples that are tensors stack into a tensor."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    return batch


def _to_tensor_batch(batch, device):
    """A collated batch as tensors on ``device``: numpy arrays become
    tensors (int64 stays int64); a CUDA copy goes from pinned memory
    with ``non_blocking=True``; lists and tuples become lists, as in the
    reference."""
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        if device.type == "cuda" and batch.device.type == "cpu":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _to_tensor_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_to_tensor_batch(b, device) for b in batch]
    return batch


class DataLoader:
    """Batches of ``dataset`` through a :class:`BatchSampler` (or
    ``batch_sampler``), collated by ``collate_fn``, on the current
    device. After an iteration with process workers,
    :attr:`transport` counts the batches that came through the rings
    (``"ring"``) and through the queue (``"queue"``)."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False,
                 collate_fn: Optional[Callable] = None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, worker_mode="thread"):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(2, int(prefetch_factor))
        self.worker_init_fn = worker_init_fn
        self.timeout = float(timeout)
        self.use_shared_memory = bool(use_shared_memory)
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.transport = {"ring": 0, "queue": 0}
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # ------------------------------------------------------------------ iter
    def __iter__(self):
        device = device_mod.current_torch_device()
        if self._iterable:
            batches = self._iter_iterable()
        elif self.num_workers == 0:
            batches = self._iter_sync()
        elif self.worker_mode == "process":
            batches = self._iter_multiprocess()
        else:
            batches = self._iter_prefetch()
        for batch in batches:
            yield _to_tensor_batch(batch, device)

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _iter_sync(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if self.batch_size and len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_prefetch(self):
        """Thread-pool prefetch: ``num_workers`` fetchers, a bounded
        queue of futures, in order (the reference's reorder buffer)."""
        from concurrent.futures import ThreadPoolExecutor

        depth = self.num_workers * self.prefetch_factor
        batches = list(self.batch_sampler)
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="dataloader") as pool:
            if self.worker_init_fn:
                for wid in range(self.num_workers):
                    pool.submit(self.worker_init_fn, wid)
            futures = queue.Queue()
            it = iter(batches)

            def submit_next():
                try:
                    indices = next(it)
                except StopIteration:
                    return False
                futures.put(pool.submit(self._fetch, indices))
                return True

            for _ in range(min(depth, len(batches))):
                submit_next()
            while not futures.empty():
                fut = futures.get()
                submit_next()
                yield fut.result()

    def _make_rings(self, nw):
        """One ring a worker (``RING_BYTES``) where the native ring builds
        and ``use_shared_memory`` is on; else none (the queue carries
        every record)."""
        from ..csrc import ShmRing, available
        if not (self.use_shared_memory and available()):
            return []
        import uuid
        tag = uuid.uuid4().hex[:12]
        rings = []
        try:
            for wid in range(nw):
                rings.append(ShmRing.create(
                    f"/pt_dl_{os.getpid()}_{tag}_{wid}", RING_BYTES))
        except OSError:
            for r in rings:
                r.close(unlink=True)
            return []
        return rings

    def _iter_multiprocess(self):
        """Spawn-context worker processes, an order-preserving reorder
        buffer and crash propagation (the reference's
        ``_DataLoaderIterMultiProcess``)."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        nw = self.num_workers
        rings = self._make_rings(nw)
        ring_names = [r.name for r in rings] or [None] * nw
        self.transport = {"ring": 0, "queue": 0}
        workers = [
            ctx.Process(
                target=_mp_worker_loop,
                args=(self.dataset, index_q, result_q, self.collate_fn, wid,
                      nw, self.worker_init_fn, ring_names[wid]),
                daemon=True)
            for wid in range(nw)]
        for w in workers:
            w.start()
        batches = list(self.batch_sampler)
        depth = min(nw * self.prefetch_factor, len(batches))
        poll_s = self.timeout if self.timeout > 0 else 5.0

        def result_get():
            """One (tid, batch, err) record; raises queue.Empty after
            poll_s. With rings the queue is polled too: a worker sends a
            record there when its ring cannot take it."""
            if not rings:
                rec = result_q.get(timeout=poll_s)
                self.transport["queue"] += 1
                return rec
            deadline = time.monotonic() + poll_s
            while True:
                for r in rings:
                    try:
                        data = r.pop(timeout_ms=20)
                    except EOFError:
                        continue  # that worker finished and hung up
                    if data is not None:
                        self.transport["ring"] += 1
                        return pickle.loads(data)
                try:
                    rec = result_q.get_nowait()
                    self.transport["queue"] += 1
                    return rec
                except queue.Empty:
                    pass
                if time.monotonic() > deadline:
                    raise queue.Empty

        try:
            for i in range(depth):
                index_q.put((i, batches[i]))
            next_submit = depth
            next_out = 0
            buffer = {}
            while next_out < len(batches):
                if next_out in buffer:
                    batch = buffer.pop(next_out)
                    next_out += 1
                    if next_submit < len(batches):
                        index_q.put((next_submit, batches[next_submit]))
                        next_submit += 1
                    yield batch
                    continue
                try:
                    tid, batch, err = result_get()
                except queue.Empty:
                    dead = [w.pid for w in workers if not w.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker(s) {dead} exited "
                            f"unexpectedly") from None
                    if self.timeout > 0:
                        raise RuntimeError(
                            f"DataLoader timed out after {self.timeout}s "
                            f"waiting for a worker batch") from None
                    continue
                if err is not None:
                    raise RuntimeError(
                        f"DataLoader worker raised:\n{err}")
                buffer[tid] = batch
        finally:
            for _ in workers:
                index_q.put(None)
            for w in workers:
                w.join(timeout=2.0)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=2.0)
            for r in rings:
                r.close(unlink=True)
            index_q.close()
            result_q.close()
