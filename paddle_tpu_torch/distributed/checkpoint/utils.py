"""Checkpoint helpers: state-dict flattening and slice arithmetic.

A copy of ``paddle_tpu/distributed/checkpoint/utils.py`` (numpy only):
``flatten_state_dict`` / ``unflatten_state_dict`` and the intersection of
two boxes in global coordinates that a resharded load is made of.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

FLAT_SEP = "."


def flatten_state_dict(state_dict: Dict) -> Tuple[Dict[str, Any],
                                                  Dict[str, Tuple[str, ...]]]:
    """Flatten arbitrarily nested dicts to ``{dotted_key: leaf}``.

    Returns ``(flat, mapping)``; ``mapping`` records each flat key's
    original key path, so a load can restore the nesting."""
    flat: Dict[str, Any] = {}
    mapping: Dict[str, Tuple[str, ...]] = {}

    def visit(prefix: Tuple[str, ...], node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(prefix + (str(k),), v)
        else:
            key = FLAT_SEP.join(prefix)
            if key in flat:
                raise ValueError(f"duplicate flat key {key!r} in state_dict")
            flat[key] = node
            mapping[key] = prefix

    visit((), state_dict)
    return flat, mapping


def unflatten_state_dict(flat: Dict[str, Any],
                         mapping: Dict[str, Tuple[str, ...]]) -> Dict:
    out: Dict = {}
    for key, val in flat.items():
        path = mapping.get(key, (key,))
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return out


def offset_of(index: Tuple[slice, ...], shape: Tuple[int, ...]):
    """The global offset of a shard's index (a tuple of slices)."""
    return tuple((sl.start or 0) for sl in index)


def copy_intersection(dst: np.ndarray, dst_offset, src: np.ndarray,
                      src_offset) -> int:
    """Copy the overlap of two boxes in global coordinates from ``src``
    into ``dst`` in place; returns the number of elements copied.  ``dst``
    occupies ``[dst_offset, dst_offset + dst.shape)``, ``src`` likewise."""
    if dst.ndim == 0:
        dst[...] = src
        return 1
    lo = [max(a, b) for a, b in zip(dst_offset, src_offset)]
    hi = [min(a + s, b + t) for a, s, b, t in
          zip(dst_offset, dst.shape, src_offset, src.shape)]
    if any(h <= l for l, h in zip(lo, hi)):
        return 0
    dst_sl = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, dst_offset))
    src_sl = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, src_offset))
    dst[dst_sl] = src[src_sl]
    return int(np.prod([h - l for l, h in zip(lo, hi)]))
