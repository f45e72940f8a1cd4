"""fleet.utils: the sequence-parallel utilities.  Counterpart of
``paddle_tpu/distributed/fleet/utils/``."""

from . import sequence_parallel_utils  # noqa: F401
from .sequence_parallel_utils import (  # noqa: F401
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp, all_gather,
    is_sequence_parallel_parameter, mark_as_sequence_parallel_parameter,
    reduce_scatter, register_sequence_parallel_allreduce_hooks, scatter)
