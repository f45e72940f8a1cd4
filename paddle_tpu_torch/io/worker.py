"""Multiprocess DataLoader workers with shared-memory batch transport.

Counterpart of ``paddle_tpu/io/worker.py``: the workers are SPAWNED,
never forked (a forked child would inherit the parent's CUDA context and
threads), pull lists of indices, collate the samples to numpy and ship
the batch to the parent through ``multiprocessing.shared_memory`` blocks
(only metadata crosses the queue) or, with ``use_shared_memory=False``,
pickled through the queue.  A worker never touches CUDA: it sees numpy
(a custom collate's CPU tensors are turned into numpy here), and only the
parent makes tensors and moves them to the card.
"""

from __future__ import annotations

import traceback
from multiprocessing import shared_memory
from typing import Any, List

import numpy as np

__all__ = ["worker_loop", "pack_batch", "unpack_batch", "numpy_collate"]


def numpy_collate(batch: List[Any]):
    """Stack samples into numpy arrays, with ``default_collate_fn``'s
    structure (tuple / list / dict of arrays or scalars; int -> int64,
    float -> float32)."""
    first = batch[0]
    if isinstance(first, np.ndarray):
        return np.stack(batch)
    if isinstance(first, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(first, (tuple, list)):
        return type(first)(numpy_collate(list(col)) for col in zip(*batch))
    if isinstance(first, dict):
        return {k: numpy_collate([d[k] for d in batch]) for k in first}
    # strings / arbitrary objects pass through as a list
    return list(batch)


def _to_numpy_tree(obj):
    """The CPU tensors a dataset or a custom collate_fn produced, as
    numpy (by type name: a worker imports no torch unless the dataset
    does)."""
    if type(obj).__name__ in ("Tensor", "Parameter") and \
            hasattr(obj, "numpy"):
        return obj.detach().numpy()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_numpy_tree(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    return obj


def pack_batch(batch, use_shared_memory: bool):
    """Replace non-empty ndarrays with shared-memory descriptors.

    Returns (payload, shm_blocks): payload is queue-safe metadata; the
    worker closes its handles right after the put, and the parent
    re-attaches by name, copies and unlinks."""
    blocks = []

    def pack(x):
        if isinstance(x, np.ndarray) and use_shared_memory and x.nbytes > 0:
            shm = shared_memory.SharedMemory(create=True, size=x.nbytes)
            view = np.ndarray(x.shape, x.dtype, buffer=shm.buf)
            view[...] = x
            blocks.append(shm)
            return ("__shm__", shm.name, x.shape, str(x.dtype))
        if isinstance(x, np.ndarray):
            return ("__np__", x)
        if isinstance(x, (tuple, list)):
            return ("__seq__", type(x).__name__, [pack(v) for v in x])
        if isinstance(x, dict):
            return ("__map__", {k: pack(v) for k, v in x.items()})
        return ("__obj__", x)

    return pack(batch), blocks


def unpack_batch(payload):
    """Inverse of :func:`pack_batch` (parent side); unlinks the shared
    memory blocks it consumed."""
    tag = payload[0]
    if tag == "__shm__":
        _, name, shape, dtype = payload
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf).copy()
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return arr
    if tag == "__np__":
        return payload[1]
    if tag == "__seq__":
        seq = [unpack_batch(v) for v in payload[2]]
        return tuple(seq) if payload[1] == "tuple" else seq
    if tag == "__map__":
        return {k: unpack_batch(v) for k, v in payload[1].items()}
    return payload[1]


def worker_loop(dataset, index_queue, result_queue, collate_fn,
                use_shared_memory: bool, worker_init_fn, worker_id: int,
                num_workers: int = 0):
    """A worker's main: publish its identity (``get_worker_info``), run
    ``worker_init_fn``, then pull ``(seq, indices)`` jobs, collate and
    ship ``("batch", seq, payload)`` until a ``None`` job; a failure ships
    ``("error", worker_id, traceback)`` and ends the worker."""
    try:
        from .. import io as _io
        _io._worker_info = _io._WorkerInfo(worker_id, num_workers, dataset)
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
    except BaseException:
        result_queue.put(("error", worker_id, traceback.format_exc()))
        return
    while True:
        job = index_queue.get()
        if job is None:
            result_queue.put(("done", worker_id, None))
            return
        seq, indices = job
        try:
            samples = [dataset[i] for i in indices]
            if collate_fn is not None:
                batch = _to_numpy_tree(collate_fn(samples))
            else:
                batch = numpy_collate([_to_numpy_tree(s) for s in samples])
            payload, blocks = pack_batch(batch, use_shared_memory)
            result_queue.put(("batch", seq, payload))
            for b in blocks:
                b.close()  # the parent re-attaches by name and unlinks
        except BaseException:
            result_queue.put(("error", worker_id, traceback.format_exc()))
            return
