"""fleet: hybrid-parallel training.  Counterpart of
``paddle_tpu/distributed/fleet/`` (Paddle's ``distributed/fleet``): the
topology and ``fleet.init`` / ``distributed_model`` /
``distributed_optimizer``, the tensor-parallel layers, the RNG tracker,
ZeRO (``group_sharded_parallel``), ``recompute``, pipeline parallelism
(``PipelineLayer``, ``PipelineParallel``, ``spmd_pipeline``), the
sequence-parallel utilities (``utils``) and the hybrid train steps
(``hybrid_step``)."""

from . import random as rng_utils  # noqa: F401  (fleet.meta_parallel RNG)
from .fleet import (DistributedStrategy, HybridParallelOptimizer,  # noqa: F401
                    barrier_worker, distributed_model, distributed_optimizer,
                    get_hybrid_communicate_group, init, is_first_worker,
                    worker_index, worker_num)
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pipeline_parallel import (PipelineParallel,  # noqa: F401
                                PipelineParallelWithInterleave)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .random import get_rng_state_tracker  # noqa: F401
from .recompute import recompute  # noqa: F401
from .sharding import (DygraphShardingOptimizer,  # noqa: F401
                       GroupShardedOptimizerStage2, group_sharded_parallel)
from .spmd_pipeline import pipeline_forward, stack_stage_params  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401

# submodule aliases matching the reference layout
from . import mp_layers as meta_parallel  # noqa: F401
