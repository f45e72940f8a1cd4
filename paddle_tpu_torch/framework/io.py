"""``paddle_tpu_torch.save`` / ``load``: counterpart of
``paddle_tpu/framework/io.py``, in its file format.

A file is the magic ``PDTPU1\\n`` then a pickle in which every tensor is
a leaf ``{"__tensor__": True, "data": ndarray, "stop_gradient": bool}``,
to a path or a file object.  So a float32, float16 or integer state
saved by either package loads in the other.

bfloat16, which numpy lacks: the port writes its 16-bit words as a
uint16 array with ``"dtype": "bfloat16"`` beside it, so it round-trips
without ``ml_dtypes``.  Across the packages: a bfloat16 file of the JAX
package (an ``ml_dtypes`` array in the pickle) loads in the port where
``ml_dtypes`` is installed (unpickling needs it) and comes back as
bfloat16; a bfloat16 file of the port loads in the JAX package as the
uint16 words (it does not read ``"dtype"``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_MAGIC = b"PDTPU1\n"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        leaf = {"__tensor__": True, "stop_gradient": not obj.requires_grad}
        if t.dtype == torch.bfloat16:
            leaf["data"] = t.view(torch.int16).numpy().view(np.uint16)
            leaf["dtype"] = "bfloat16"
        else:
            leaf["data"] = t.numpy()
        return leaf
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _tensor(a: np.ndarray, bf16_words: bool = False) -> torch.Tensor:
    if bf16_words or a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _from_host(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = _tensor(obj["data"], obj.get("dtype") == "bfloat16")
            if t.is_floating_point() and not obj.get("stop_gradient", True):
                t.requires_grad_(True)
            return t
        return {k: _from_host(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v, return_numpy) for v in obj)
    if isinstance(obj, np.ndarray) and not return_numpy \
            and (obj.dtype.kind in "biuf" and obj.dtype.itemsize <= 4
                 or obj.dtype == np.complex64):
        # a bare array in a state dict loads as a tensor, as in the JAX
        # package; 64-bit arrays pass through as numpy there
        return _tensor(obj)
    return obj


def save(obj: Any, path, protocol: int = 4, **configs):
    """Serialise ``obj`` (nested dicts / lists of tensors, arrays, ...) to
    a path (its directory made) or a writable file object."""
    if not isinstance(protocol, int) or not 2 <= protocol <= 5:
        raise ValueError(f"protocol must be 2..5, got {protocol!r}")
    if hasattr(path, "write"):
        path.write(_MAGIC)
        pickle.dump(_to_host(obj), path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_to_host(obj), f, protocol=protocol)


def _load_stream(f, return_numpy):
    head = f.read(len(_MAGIC))
    if head != _MAGIC:
        f.seek(0)
    return _from_host(pickle.load(f), return_numpy)


def load(path, return_numpy: bool = False, **configs) -> Any:
    """Load from a path or a readable file object: tensors (on the CPU)
    where the file has tensors, or their arrays with ``return_numpy``.
    Unpickling runs code: load only files this program or a trusted one
    wrote."""
    if hasattr(path, "read"):
        return _load_stream(path, return_numpy)
    with open(path, "rb") as f:
        return _load_stream(f, return_numpy)
