"""Data loading: counterpart of ``paddle_tpu/io/__init__.py``.

Datasets (``Dataset``, ``IterableDataset``, ``TensorDataset``,
``ComposeDataset``, ``ChainDataset``, ``Subset``, ``random_split``),
samplers (``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``BatchSampler``, ``DistributedBatchSampler``)
and the ``DataLoader``.  The samplers draw from numpy's global stream
exactly as the JAX package's do (``np.random.permutation``, ``randint``,
``choice``, ``RandomState(epoch)``), so one numpy seed gives the same
batches in both packages.

Batches are torch tensors on the loader's device: ``cuda`` unless the
caller passes ``device="cpu"`` (the loader never moves a batch to the
CPU on its own).  On the card each batch is copied into pinned host
memory and then to the card with ``non_blocking=True`` on a side stream,
one batch ahead of the one the step reads, and the step's stream waits
on the copy's event before it reads the batch: the counterpart of the
JAX loader's device prefetch (``_iter_device_prefetch``, ``_to_device``).
The copy into pinned memory is also the snapshot of the JAX ``copy=``
rule: a custom ``collate_fn`` may refill one buffer per batch, and the
asynchronous copy must not read the next batch's values.  On the CPU a
custom collate's leaves are cloned (batches from the default collate and
from workers are fresh already).

``num_workers > 0`` spawns worker processes (``io/worker.py``): they
collate to numpy and ship batches through shared memory
(``use_shared_memory=False``: pickled through the queue), in order, with
``timeout`` and ``worker_init_fn`` as in the JAX package.  Every fetch in
the main process retries a transient ``OSError`` (``dataloader.fetch``,
counted on ``dataloader.retries``: the JAX flags ``dataloader_retries``
2 and ``dataloader_retry_backoff_s`` 0.05).  ``DistributedBatchSampler``
reads ``num_replicas`` and ``rank`` from the environment when they are
None (``distributed/env.py``).  The JAX loader's thread mode
(``PADDLE_TPU_THREAD_LOADER=1``) is not ported.
"""

from __future__ import annotations

import math
import queue
import time
import warnings

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "BatchSampler", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "DistributedBatchSampler", "DataLoader", "get_worker_info",
           "default_collate_fn"]

FETCH_RETRIES = 2         # the JAX flag dataloader_retries
FETCH_BACKOFF_S = 0.05    # the JAX flag dataloader_retry_backoff_s


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Row ``idx`` of each of ``tensors`` (torch tensors or arrays)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple))
                       else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions) over one
    ``np.random.permutation`` of the indices."""
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths):
        lengths = [int(math.floor(total * n)) for n in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total)
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start:start + n].tolist()))
        start += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches: the indices (shuffled by ``RandomState(epoch)``
    when ``shuffle``) padded to a multiple of ``num_replicas``, then every
    ``num_replicas``-th from ``rank``.  Either left None is read from the
    environment (``distributed/env.py``: the launcher's
    ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``, else
    ``torch.distributed``), as the JAX sampler does."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import env as dist_env
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else dist_env.get_world_size()
        self.local_rank = rank if rank is not None else dist_env.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """In a worker process: its ``id``, ``num_workers`` and ``dataset``;
    None in the main process."""
    return _worker_info


def _dl_retry_counter():
    from ..observability import metrics as _metrics
    return _metrics.counter(
        "dataloader.retries",
        "transient-OSError DataLoader fetch retries (labels: site)")


def default_collate_fn(batch):
    """Stack samples into CPU tensors: tensors and arrays stacked, ints
    as int64, floats as float32; tuples, lists and dicts element-wise;
    anything else passes through as a list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _map_leaves(fn, obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_leaves(fn, x) for x in obj)
    if isinstance(obj, list):
        return [_map_leaves(fn, x) for x in obj]
    if isinstance(obj, dict):
        return {k: _map_leaves(fn, v) for k, v in obj.items()}
    return obj


def _as_tensor(x, copy=False):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy() if copy else x)
    return x.clone() if copy else x


def _pinned_copy(x):
    """A copy of a batch leaf in page-locked host memory (always a copy:
    the snapshot an asynchronous copy to the card needs)."""
    t = _as_tensor(x)
    return torch.empty_like(t, pin_memory=True).copy_(t)


class DataLoader:
    """Iterates batches of tensors on ``device`` (``cuda`` unless
    ``device="cpu"``); the JAX loader's arguments (``places``,
    ``return_list``, ``use_buffer_reader``: accepted, as there)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate_fn
        self._custom_collate = collate_fn
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if persistent_workers:
            warnings.warn(
                "persistent_workers is not implemented: workers are "
                "re-spawned per epoch (spawn start method)")
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        from ..distributed.checkpoint.io_retry import call_with_retries
        return call_with_retries(
            lambda: self.collate_fn([self.dataset[i] for i in indices]),
            retries=FETCH_RETRIES, backoff_s=FETCH_BACKOFF_S,
            site="dataloader.fetch", counter=_dl_retry_counter())

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_multiprocess(self):
        import multiprocessing as mp

        from .worker import unpack_batch, worker_loop

        if mp.parent_process() is not None:
            raise RuntimeError(
                "DataLoader(num_workers>0) was reached inside a spawned "
                "worker process: the training script's entry code must be "
                "under `if __name__ == '__main__':` (spawn re-imports the "
                "main module), or pass num_workers=0")
        ctx = mp.get_context("spawn")   # a forked child would inherit CUDA
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        n = self.num_workers
        workers = []
        try:
            for wid in range(n):
                p = ctx.Process(
                    target=worker_loop,
                    args=(self.dataset, index_q, result_q,
                          self._custom_collate, self.use_shared_memory,
                          self.worker_init_fn, wid, n),
                    daemon=True)
                p.start()
                workers.append(p)
            batches = list(self.batch_sampler)
            # at most n * prefetch_factor jobs in flight, so the workers
            # cannot fill /dev/shm ahead of the consumer
            window = max(n * self.prefetch_factor, 1)
            fed = 0
            pending = {}
            next_seq = 0
            done = 0

            def feed():
                nonlocal fed
                while fed < len(batches) and fed - next_seq < window:
                    index_q.put((fed, list(batches[fed])))
                    fed += 1
                if fed == len(batches):
                    fed += n            # the stop tokens, once
                    for _ in range(n):
                        index_q.put(None)

            feed()
            wait_start = time.monotonic()
            while next_seq < len(batches):
                if next_seq in pending:
                    yield _map_leaves(_as_tensor, pending.pop(next_seq))
                    next_seq += 1
                    wait_start = time.monotonic()
                    feed()
                    continue
                remaining = None
                if self.timeout:
                    remaining = self.timeout - (time.monotonic() - wait_start)
                    if remaining <= 0:
                        raise RuntimeError(
                            f"DataLoader timed out after {self.timeout}s "
                            f"waiting for batch {next_seq}")
                try:
                    kind, a, b = result_q.get(
                        timeout=min(remaining, 1.0) if remaining else 1.0)
                except queue.Empty:
                    if not any(p.is_alive() for p in workers):
                        raise RuntimeError(
                            "all DataLoader workers died without reporting "
                            "(OOM-killed?); check system logs") from None
                    continue
                if kind == "error":
                    raise RuntimeError(f"DataLoader worker {a} failed:\n{b}")
                if kind == "done":
                    done += 1
                    if done == n and next_seq < len(batches) \
                            and not pending and result_q.empty():
                        raise RuntimeError(
                            "DataLoader workers exited before producing "
                            "all batches")
                    continue
                pending[a] = unpack_batch(b)
        finally:
            # free queued shared-memory payloads (an early break or an
            # error above)
            try:
                while True:
                    kind, _, b = result_q.get_nowait()
                    if kind == "batch":
                        unpack_batch(b)
            except queue.Empty:
                pass
            for p in workers:
                if p.is_alive():
                    p.terminate()
            for p in workers:
                p.join(5)

    def _loader_mode(self) -> str:
        if self._iterable_mode:
            return "iterable"
        return "inline" if self.num_workers <= 0 else "multiprocess"

    def _batches_need_copy(self) -> bool:
        """A custom collate_fn in this process may refill one buffer per
        batch; the default collate allocates fresh arrays and workers'
        batches crossed a process boundary."""
        return self._custom_collate is not None and \
            self._loader_mode() != "multiprocess"

    def _iter_inner(self):
        mode = self._loader_mode()
        if mode == "iterable":
            yield from self._iter_iterable()
        elif mode == "inline":
            for indices in self.batch_sampler:
                yield self._fetch(indices)
        else:
            yield from self._iter_multiprocess()

    def _iter_cpu(self, inner):
        copy = self._batches_need_copy()
        for batch in inner:
            yield _map_leaves(lambda x: _as_tensor(x, copy), batch)

    def _iter_device_prefetch(self, inner):
        """One batch ahead: pin the next batch (a copy: the snapshot) and
        start its copy to the card on a side stream, then hand out the
        one before, after the current stream waits on its event."""
        dev = self.device
        side = torch.cuda.Stream(dev)

        def start(batch):
            pinned = _map_leaves(_pinned_copy, batch)
            with torch.cuda.stream(side):
                on_card = _map_leaves(
                    lambda t: t.to(dev, non_blocking=True), pinned)
                ev = torch.cuda.Event()
                ev.record(side)
            return on_card, ev, pinned   # pinned stays alive until then

        def finish(staged):
            on_card, ev, _ = staged
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            # the batch was allocated on the side stream: tell the caching
            # allocator the step's stream uses it
            _map_leaves(lambda t: t.record_stream(cur), on_card)
            return on_card

        staged = None
        try:
            for batch in inner:
                nxt = start(batch)
                if staged is not None:
                    yield finish(staged)
                staged = nxt
            if staged is not None:
                yield finish(staged)
        finally:
            if hasattr(inner, "close"):
                inner.close()       # the workers end with the epoch

    def __iter__(self):
        inner = self._iter_inner()
        if self.device.type == "cuda":
            return self._iter_device_prefetch(inner)
        return self._iter_cpu(inner)
