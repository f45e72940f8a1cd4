"""Sharded checkpoint save: counterpart of
``paddle_tpu/distributed/checkpoint/save_state_dict.py``, with the same
files and the same split into a snapshot and a write.

The unit of storage is a piece of a global tensor.  A ``jax.Array``
carries its pieces (its addressable shards) with it; a torch tensor does
not, so a rank states a piece of its own with :class:`ShardedLeaf`: its
local tensor, the global tensor's shape, the local tensor's offset in it,
and a ``replica_id`` (0 on the one rank that writes the piece, as a
shard's ``replica_id`` in the JAX package).  A plain tensor, numpy array
or scalar is a whole leaf owned by rank 0, as the JAX package makes its
coordinator own every leaf that is not a ``jax.Array``.

Each rank writes one data file (``{rank}_0.distcp``, a ``.npz``) with the
pieces it owns and one metadata file (``{rank}.metadata``); a load merges
every metadata file it finds.  bfloat16, which numpy lacks, is written as
its 16-bit words (uint16) with the recorded dtype ``"bfloat16"``.

* :func:`plan_save` - the snapshot: every owned piece copied to the host
  (``.detach().to("cpu", copy=True)``), and the rank's metadata.  After it
  returns the caller may overwrite the tensors (the async-save contract).
* :func:`write_planned` - host I/O only: the rank's two files from a plan,
  opened through ``testing.chaos.checked_open``.

``save_state_dict`` composes the two and writes in place; the atomic,
versioned protocol is ``manager.py``'s, on the same halves.
"""

from __future__ import annotations

import os
import pickle
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...testing.chaos import checked_open
from .. import env as _env
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .utils import flatten_state_dict

__all__ = ["ShardedLeaf", "SavePlan", "plan_save", "write_planned",
           "save_state_dict", "wait_async_save"]

BF16 = "bfloat16"

_async_lock = threading.Lock()
_async_threads = []
_async_errors = []


@dataclass
class ShardedLeaf:
    """This rank's piece of a global tensor: ``local`` (a torch tensor or
    numpy array) at ``global_offset`` in a tensor of ``global_shape``.
    Only the rank whose ``replica_id`` is 0 writes it; a load fills
    ``local`` in place with its box of the saved tensor."""
    local: Any
    global_shape: Tuple[int, ...]
    global_offset: Tuple[int, ...]
    replica_id: int = 0

    def __post_init__(self):
        self.global_shape = tuple(int(d) for d in self.global_shape)
        self.global_offset = tuple(int(o) for o in self.global_offset)
        shape = tuple(self.local.shape)
        if not (len(shape) == len(self.global_shape)
                == len(self.global_offset)) or any(
                    o < 0 or o + s > g for o, s, g in
                    zip(self.global_offset, shape, self.global_shape)):
            raise ValueError(
                f"ShardedLeaf: a local {shape} at {self.global_offset} does "
                f"not lie inside the global shape {self.global_shape}")


def _host_copy(v) -> Tuple[np.ndarray, str]:
    """A C-ordered host copy of a tensor, array or scalar that owns its
    bytes, and the dtype to record (bfloat16 as its uint16 words)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        arr = np.ascontiguousarray(t.to("cpu", copy=True).numpy())
        if bf16:
            return arr.view(np.uint16), BF16
        return arr, str(arr.dtype)
    arr = np.array(v, copy=True, order="C")
    return arr, str(arr.dtype)


def _data_file(rank: int) -> str:
    return f"{rank}_0.distcp"


def _metadata_file(rank: int) -> str:
    return f"{rank}.metadata"


def _pieces(val, rank: int):
    """``(global shape, [(offset, leaf)])``: the pieces of ``val`` this
    rank writes."""
    if isinstance(val, ShardedLeaf):
        pieces = [] if val.replica_id != 0 else \
            [(val.global_offset, val.local)]
        return val.global_shape, pieces
    shape = tuple(val.shape) if isinstance(val, torch.Tensor) \
        else tuple(np.shape(val))
    # whole leaves are the coordinator's
    return shape, ([(tuple(0 for _ in shape), val)] if rank == 0 else [])


@dataclass
class SavePlan:
    """The host-side snapshot of one rank's share of a save: everything
    ``write_planned`` needs, no tensor of the caller referenced."""
    rank: int
    metadata: Metadata
    payload: Dict[str, np.ndarray]

    @property
    def data_file(self) -> str:
        return _data_file(self.rank)

    @property
    def metadata_file(self) -> str:
        return _metadata_file(self.rank)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.payload.values())


def plan_save(state_dict: Dict, rank: Optional[int] = None) -> SavePlan:
    """Copy this rank's share of ``state_dict`` to the host and build its
    metadata.  Synchronous: when it returns, the payload owns its bytes,
    so the caller may overwrite the source tensors."""
    if not isinstance(state_dict, dict):
        raise TypeError("state_dict must be a dict, got "
                        f"{type(state_dict).__name__}")
    flat, mapping = flatten_state_dict(state_dict)
    if rank is None:
        rank = _env.get_rank()
    md = Metadata(flat_mapping=mapping)
    file_name = _data_file(rank)
    payload: Dict[str, np.ndarray] = {}
    for key, val in flat.items():
        shape, pieces = _pieces(val, rank)
        md.global_shape[key] = tuple(int(d) for d in shape)
        entries = md.state_dict_metadata.setdefault(key, [])
        for i, (offset, leaf) in enumerate(pieces):
            arr, dtype = _host_copy(leaf)
            offset = tuple(int(o) for o in offset)
            entries.append(LocalTensorMetadata(offset, tuple(arr.shape),
                                               dtype))
            md.storage_metadata[LocalTensorIndex(key, offset)] = file_name
            payload[f"{key}|{i}"] = arr
    return SavePlan(rank, md, payload)


def write_planned(path: str, plan: SavePlan) -> list:
    """Write one rank's data and metadata files into ``path``; returns
    the file names written.  Host I/O only."""
    written = []
    if plan.payload:
        with checked_open(os.path.join(path, plan.data_file), "wb") as f:
            np.savez(f, **plan.payload)
        written.append(plan.data_file)
    with checked_open(os.path.join(path, plan.metadata_file), "wb") as f:
        pickle.dump(plan.metadata, f)
    written.append(plan.metadata_file)
    return written


def save_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False) -> None:
    """Save a nested, possibly sharded ``state_dict`` to ``path``: every
    rank writes the pieces it owns, a replicated piece once.

    This writes IN PLACE: a crash mid-write leaves ``path`` partial.
    ``CheckpointManager`` (``manager.py``) commits versions atomically on
    the same snapshot and write."""
    plan = plan_save(state_dict)
    os.makedirs(path, exist_ok=True)
    rank = plan.rank
    wait_async_save()       # after this process's earlier async writes
    if rank == coordinator_rank:
        # drop what a bigger job left, so a save with fewer ranks cannot
        # merge with it; only files no current rank rewrites are touched
        n_proc = _env.get_world_size()
        for f in os.listdir(path):
            head = f.split("_")[0].split(".")[0]
            if f.endswith((".distcp", ".metadata")) and head.isdigit() \
                    and int(head) >= n_proc:
                os.remove(os.path.join(path, f))
    # both of this rank's files are rewritten: delete both first, so a
    # crash between the two writes leaves no stale metadata pointing into
    # the new data file
    for stale in (_data_file(rank), _metadata_file(rank)):
        p = os.path.join(path, stale)
        if os.path.exists(p):
            os.remove(p)

    if not async_save:
        write_planned(path, plan)
        return

    def guarded():
        try:
            write_planned(path, plan)
        except BaseException as e:  # noqa: BLE001 - raised by wait_async_save
            with _async_lock:
                _async_errors.append(e)
    t = threading.Thread(target=guarded)
    with _async_lock:
        _async_threads.append(t)
    t.start()


def wait_async_save() -> None:
    """Block until every pending async save ends; re-raise a failure."""
    with _async_lock:
        pending, _async_threads[:] = _async_threads[:], []
    for t in pending:
        t.join()
    with _async_lock:
        errors, _async_errors[:] = _async_errors[:], []
    if errors:
        raise RuntimeError(
            f"{len(errors)} async checkpoint save(s) failed") from errors[0]
