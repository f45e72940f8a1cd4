"""Sharded checkpoint load with reshard-on-load: counterpart of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``.

Every rank reads from the shared file system: each target asks for a box
of its global tensor (a whole tensor its whole box, a
:class:`~.save_state_dict.ShardedLeaf` its own), and the box is assembled
from the saved pieces that intersect it.  So a version written under one
layout loads under any other, with no collective.  The metadata may come
from either package (``metadata.load_metadata_file``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from .metadata import LocalTensorIndex, Metadata, load_metadata_file
from .save_state_dict import BF16, ShardedLeaf
from .utils import copy_intersection, flatten_state_dict, unflatten_state_dict

__all__ = ["load_state_dict", "load_metadata", "read_state_dict"]


def load_metadata(path: str) -> Metadata:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint directory {path!r} does not exist")
    if not os.path.isdir(path):
        raise ValueError(f"checkpoint path {path!r} is not a directory")
    md = Metadata()
    files = sorted(f for f in os.listdir(path) if f.endswith(".metadata"))
    if not files:
        raise ValueError(
            f"checkpoint directory {path!r} contains no .metadata files — "
            "not a checkpoint (or an incomplete save)")
    for f in files:
        with open(os.path.join(path, f), "rb") as fh:
            md.merge(load_metadata_file(fh))
    return md


class _Storage:
    """Lazy ``.distcp`` reader: only the requested members are read, so a
    resharded load never holds whole files in memory."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, np.lib.npyio.NpzFile] = {}

    def piece(self, file_name: str, key: str, idx_in_file: int) -> np.ndarray:
        if file_name not in self._files:
            self._files[file_name] = np.load(
                os.path.join(self.path, file_name), allow_pickle=False)
        return self._files[file_name][f"{key}|{idx_in_file}"]

    def close(self):
        for z in self._files.values():
            z.close()
        self._files.clear()


def _pieces_for(md: Metadata, storage: _Storage, key: str):
    """``[(offset, array)]``, every saved piece of ``key`` (bfloat16 as
    its uint16 words), and the recorded dtype."""
    out, dtype = [], None
    per_file_counter: Dict[str, int] = {}
    for meta in md.state_dict_metadata.get(key, []):
        index = LocalTensorIndex(key, tuple(meta.global_offset))
        file_name = md.storage_metadata[index]
        i = per_file_counter.get(file_name, 0)
        # a file holds a key's pieces in its metadata's order
        arr = storage.piece(file_name, key, i)
        per_file_counter[file_name] = i + 1
        stored = "uint16" if meta.dtype == BF16 else meta.dtype
        if str(arr.dtype) != stored:
            raise ValueError(
                f"checkpoint corruption for {key!r}: stored dtype "
                f"{arr.dtype} != recorded {meta.dtype}")
        out.append((tuple(meta.global_offset), arr))
        dtype = meta.dtype
    return out, dtype


def _assemble(pieces, offset: Tuple[int, ...], shape: Tuple[int, ...],
              dtype, key: str) -> np.ndarray:
    """The global box ``[offset, offset + shape)`` from the saved pieces."""
    for src_off, src in pieces:
        if src_off == tuple(offset) and src.shape == tuple(shape):
            return src.astype(dtype, copy=False)     # the box is one piece
    dst = np.zeros(shape, dtype=dtype)
    mask = np.zeros(shape, dtype=bool)
    for src_off, src in pieces:
        copy_intersection(dst, offset, src.astype(dtype, copy=False), src_off)
        copy_intersection(mask, offset, np.ones(src.shape, bool), src_off)
    if not mask.all():
        want = int(np.prod(shape)) if shape else 1
        raise ValueError(
            f"checkpoint pieces for {key!r} cover {int(mask.sum())}/{want} "
            f"elements of slice offset={offset} shape={shape}; the "
            "checkpoint is incomplete")
    return dst


def _assemble_resized(pieces, offset: Tuple[int, ...],
                      shape: Tuple[int, ...], dtype, key: str,
                      saved_last: int) -> np.ndarray:
    """:func:`_assemble`, except the box may overhang the saved extent
    along the LAST dimension: the covered part keeps the coverage check,
    the overhang is zero."""
    last_cov = min(offset[-1] + shape[-1], saved_last) - offset[-1]
    if last_cov <= 0:        # the box lies in the grown pad
        return np.zeros(shape, dtype=dtype)
    if last_cov == shape[-1]:
        return _assemble(pieces, offset, shape, dtype, key)
    dst = np.zeros(shape, dtype=dtype)
    dst[..., :last_cov] = _assemble(
        pieces, offset, shape[:-1] + (last_cov,), dtype, key)
    return dst


def _storage_dtype(pieces) -> np.dtype:
    return pieces[0][1].dtype if pieces else np.dtype(np.float32)


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """An assembled box as a CPU tensor of its recorded dtype."""
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _as_numpy(arr: np.ndarray, dtype: str) -> np.ndarray:
    """An assembled box as numpy: bfloat16's words widened to float32
    (exact)."""
    if dtype == BF16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def load_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    resize_trailing: bool = False) -> None:
    """Load ``path`` into ``state_dict`` IN PLACE, resharding as needed:
    a tensor leaf is filled with its whole global tensor, a
    ``ShardedLeaf`` with its own box, each on its own device and in its
    own dtype.  Other leaves are left as they are.

    ``resize_trailing=True`` also lets a target's global shape differ
    from the saved one in its LAST dimension only: the saved extent is
    loaded, an overhang is zero (the elastic ZeRO-3 re-plan,
    ``fleet.hybrid_step.load_zero3_state``: a flat ``(Fp,)`` leaf changes
    only its dp-dependent zero pad across world sizes)."""
    md = load_metadata(path)
    storage = _Storage(path)
    try:
        _load_into(md, storage, state_dict, path,
                   resize_trailing=resize_trailing)
    finally:
        storage.close()


def read_state_dict(path: str) -> Dict:
    """The WHOLE checkpoint at ``path`` as a nested dict of numpy arrays
    (no template): the resume path of a process that has not built its
    state yet.  The nesting is the saved one (``flat_mapping``); bfloat16
    leaves come back as float32."""
    md = load_metadata(path)
    storage = _Storage(path)
    flat: Dict[str, np.ndarray] = {}
    try:
        for key in md.state_dict_metadata:
            shape = tuple(md.global_shape.get(key, ()))
            pieces, dtype = _pieces_for(md, storage, key)
            if not pieces:
                raise ValueError(
                    f"checkpoint at {path!r} has no stored pieces for "
                    f"{key!r}")
            flat[key] = _as_numpy(_assemble(
                pieces, tuple(0 for _ in shape), shape,
                _storage_dtype(pieces), key), dtype)
    finally:
        storage.close()
    return unflatten_state_dict(flat, md.flat_mapping)


def _target(leaf):
    """``(tensor to fill, global shape, box offset)`` of a target leaf,
    or None for a leaf a load leaves alone."""
    if isinstance(leaf, ShardedLeaf):
        return leaf.local, leaf.global_shape, leaf.global_offset
    if isinstance(leaf, torch.Tensor):
        shape = tuple(leaf.shape)
        return leaf, shape, tuple(0 for _ in shape)
    return None


def _load_into(md: Metadata, storage: _Storage, state_dict: Dict,
               path: str, resize_trailing: bool = False) -> None:
    flat, _ = flatten_state_dict(state_dict)
    targets = {k: t for k, t in ((k, _target(v)) for k, v in flat.items())
               if t is not None}
    missing = [k for k in targets if k not in md.state_dict_metadata]
    if missing:
        raise KeyError(f"keys not found in checkpoint {path!r}: {missing}")

    for key, (dst, shape, offset) in targets.items():
        saved_shape = tuple(md.global_shape.get(key, shape))
        saved_last = None     # set iff this key loads through a resize
        if saved_shape != shape:
            if resize_trailing and len(shape) >= 1 and \
                    len(saved_shape) == len(shape) and \
                    saved_shape[:-1] == shape[:-1]:
                saved_last = int(saved_shape[-1])
            else:
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint has "
                    f"{saved_shape}, target expects {shape}"
                    + (" (resize_trailing only covers a last-dim "
                       "difference)" if resize_trailing else ""))
        pieces, dtype = _pieces_for(md, storage, key)
        box = tuple(dst.shape)
        store = _storage_dtype(pieces)
        if saved_last is None:
            arr = _assemble(pieces, offset, box, store, key)
        else:
            arr = _assemble_resized(pieces, offset, box, store, key,
                                    saved_last)
        if isinstance(dst, torch.Tensor):
            with torch.no_grad():
                dst.copy_(_as_tensor(arr, dtype))
        else:
            np.copyto(dst, _as_numpy(arr, dtype), casting="unsafe")
