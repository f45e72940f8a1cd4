"""Distributed environment state: who this process is in the job.

Counterpart of ``paddle_tpu/distributed/env.py`` (Paddle's
``distributed/parallel.py`` accessors ``get_rank``, ``get_world_size`` and
``ParallelEnv``).  The launcher's variables win, as in the JAX module:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_CURRENT_ENDPOINT``
and ``PADDLE_TRAINER_ENDPOINTS``.  Where they are unset the answer comes
from ``torch.distributed`` when a default process group exists, else it is
the single-rank job (rank 0 of 1).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "is_initialized", "ParallelEnv",
           "local_device"]

_initialized = False


def is_initialized() -> bool:
    return _initialized


def _mark_initialized(value: bool = True) -> None:
    global _initialized
    _initialized = bool(value)


def _torch_pg() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    if group is not None:
        return group.get_group_rank(get_rank())
    v = os.environ.get("PADDLE_TRAINER_ID")
    if v is not None:
        return int(v)
    return dist.get_rank() if _torch_pg() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    v = os.environ.get("PADDLE_TRAINERS_NUM")
    if v is not None:
        return int(v)
    return dist.get_world_size() if _torch_pg() else 1


def local_device() -> torch.device:
    """This rank's device: ``cuda:<FLAGS_selected_gpus>`` when the launcher
    gave the rank a card (``--devices``), ``cpu`` when it named the CPU,
    else ``cuda`` (the port's default place)."""
    sel = os.environ.get("FLAGS_selected_gpus")
    if sel is None:
        return torch.device("cuda")
    sel = sel.split(",")[0].strip()
    return torch.device("cpu" if sel == "cpu" else f"cuda:{int(sel)}")


class ParallelEnv:
    """Paddle's ``ParallelEnv``: the launcher's view of this rank."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", get_rank()))

    @property
    def device_id(self):
        d = local_device()
        return 0 if d.index is None else d.index

    @property
    def device(self) -> torch.device:
        return local_device()

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                              "127.0.0.1:6170").split(",")
