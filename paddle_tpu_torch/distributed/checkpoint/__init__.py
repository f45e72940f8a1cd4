"""Distributed (sharded) checkpoints: counterpart of
``paddle_tpu/distributed/checkpoint/``.  ``save_state_dict`` /
``load_state_dict`` with reshard-on-load (a rank states its piece of a
global tensor with ``ShardedLeaf``), the template-free
``read_state_dict``, and ``CheckpointManager``'s atomic, versioned,
integrity-checked versions with the resume and preemption policy
(``manager``); ``io_retry``'s transient-I/O retries."""

from .load_state_dict import load_metadata, load_state_dict, read_state_dict
from .manager import (CheckpointManager, all_steps, clear_preemption,
                      latest_complete, preemption_requested,
                      request_preemption, verify_version)
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .save_state_dict import (ShardedLeaf, plan_save, save_state_dict,
                              wait_async_save, write_planned)
from .utils import flatten_state_dict, unflatten_state_dict

__all__ = [
    "save_state_dict", "load_state_dict", "load_metadata", "wait_async_save",
    "read_state_dict", "plan_save", "write_planned", "ShardedLeaf",
    "CheckpointManager", "latest_complete", "all_steps", "verify_version",
    "preemption_requested", "request_preemption", "clear_preemption",
    "Metadata", "LocalTensorMetadata", "LocalTensorIndex",
    "flatten_state_dict", "unflatten_state_dict",
]
