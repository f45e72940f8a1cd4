"""Shared model-building helpers: counterpart of
``paddle_tpu/models/_common.py``."""

from __future__ import annotations

import torch.nn as nn

__all__ = ["tp_linear_pair"]


def tp_linear_pair(tensor_parallel: bool, col_in: int, col_out: int,
                   row_in: int = None, row_out: int = None, parts: int = 1):
    """(column, row) linear pair: Megatron column-parallel into
    row-parallel when ``tensor_parallel``, plain Linears otherwise.

    MLP shape (the default): col d->4d, row 4d->d.  Attention shape: col
    d->3d (qkv) but row d->d (the out-projection reads the mixed heads):
    pass ``row_in`` / ``row_out``, and ``parts=3`` so that each rank's
    column shard holds its heads' q, k and v."""
    row_in = col_out if row_in is None else row_in
    row_out = col_in if row_out is None else row_out
    if tensor_parallel:
        from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                                   RowParallelLinear)
        return (ColumnParallelLinear(col_in, col_out, gather_output=False,
                                     parts=parts),
                RowParallelLinear(row_in, row_out, input_is_parallel=True))
    return nn.Linear(col_in, col_out), nn.Linear(row_in, row_out)
