"""Distributed training and serving: the environment (``env``), groups
and process-granular collectives (``collective``), ``init_parallel_env``
and ``DataParallel`` (``parallel``), the collective launcher
(``python -m paddle_tpu_torch.distributed.launch``), ``fleet`` (the
hybrid topology, tensor-parallel layers, ZeRO, ``recompute``, and
``fleet.elastic``: ``run_elastic`` over the launcher's restart
generations), ``sharding`` (``group_sharded_parallel``), ``checkpoint``
(sharded save and reshard-on-load, ``CheckpointManager``'s atomic
versions), the rendezvous store (``Store``, ``TCPStore``), the comm
watchdog (``watchdog``) and ``rpc``."""

from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_gather_into_tensor, all_gather_object,
                         all_reduce, alltoall, alltoall_single, barrier,
                         broadcast, broadcast_object_list,
                         destroy_process_group, gather, get_group, irecv,
                         is_initialized, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send, stream, wait)
from .store import Store, TCPStore  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .parallel import DataParallel, init_parallel_env  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from . import rpc  # noqa: F401
