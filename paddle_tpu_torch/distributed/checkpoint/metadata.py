"""The checkpoint's metadata: counterpart of
``paddle_tpu/distributed/checkpoint/metadata.py``, the same three
dataclasses with the same fields.

``LocalTensorMetadata`` places one saved piece in its global tensor,
``LocalTensorIndex`` names a piece, and ``Metadata`` is the manifest of
a save: every piece of every flat key, the file that holds it, the
original nesting and each key's global shape.

A rank's ``{rank}.metadata`` file is a pickle of its ``Metadata``.  The
JAX package's pickles name its own module's classes, so
:func:`load_metadata_file` unpickles through an ``Unpickler`` that maps
any module whose name ends in ``distributed.checkpoint.metadata`` onto
this one: the port reads versions the JAX package wrote.  The port's
pickles name the port's classes, which the JAX package does not map back.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata",
           "load_metadata_file"]

_TAIL = "distributed.checkpoint.metadata"


@dataclass
class LocalTensorMetadata:
    """Where one saved piece lies inside its global tensor."""
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str = "float32"


@dataclass(frozen=True)
class LocalTensorIndex:
    """The name of one saved piece: (flat key, global offset)."""
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    # flat key -> every piece that tiles the global tensor
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(
        default_factory=dict)
    # piece -> the data file that holds it
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    # flat key -> the original nested key path
    flat_mapping: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # flat key -> its global shape
    global_shape: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def merge(self, other: "Metadata") -> "Metadata":
        for k, pieces in other.state_dict_metadata.items():
            mine = self.state_dict_metadata.setdefault(k, [])
            seen = {(tuple(p.global_offset), tuple(p.local_shape))
                    for p in mine}
            for p in pieces:
                if (tuple(p.global_offset), tuple(p.local_shape)) not in seen:
                    mine.append(p)
        self.storage_metadata.update(other.storage_metadata)
        self.flat_mapping.update(other.flat_mapping)
        self.global_shape.update(other.global_shape)
        return self


class _Unpickler(pickle.Unpickler):
    """Either package's metadata classes become this module's."""

    def find_class(self, module, name):
        if module == _TAIL or module.endswith("." + _TAIL):
            if name not in _CLASSES:
                raise pickle.UnpicklingError(
                    f"{module}.{name} is not a checkpoint metadata class")
            return _CLASSES[name]
        return super().find_class(module, name)


_CLASSES = {c.__name__: c for c in (LocalTensorMetadata, LocalTensorIndex,
                                    Metadata)}


def load_metadata_file(fh) -> Metadata:
    """One rank's ``.metadata`` pickle, written by either package."""
    return _Unpickler(fh).load()
