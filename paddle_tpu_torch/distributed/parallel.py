"""``init_parallel_env`` and ``DataParallel``.

Counterpart of ``paddle_tpu/distributed/parallel.py`` (Paddle's
``distributed/parallel.py``: ``init_parallel_env``, ``DataParallel`` and
its C++ ``EagerReducer``).  One process per rank, as the launcher
(``distributed/launch``) starts them.

``init_parallel_env(backend=None)`` joins the launcher's job as rank
``PADDLE_TRAINER_ID`` of ``PADDLE_TRAINERS_NUM`` and starts the rank's
``watchdog.Heartbeat`` on the job's control-plane store, the launcher's
``TCPStore`` (``distributed/store.py``) at ``PADDLE_MASTER``.  The
process group's store is another: rank 0 hosts a
``torch.distributed.TCPStore`` at ``COORDINATOR_ADDRESS`` (the launcher's
fresh ``host:port`` for each restart generation) and every rank joins it.
``destroy_process_group`` stops the heartbeat, so a re-initialised job
beats on its own store.
The backend rule (:func:`choose_backend`): ``nccl`` when every rank has a
card of its own, ``gloo`` for CPU ranks or ranks that share a card (NCCL
cannot put two ranks on one card).  An explicit ``backend=`` wins.  A
failure raises; nothing switches backend or device on its own.

``DataParallel`` keeps the JAX module's surface: the initial parameters
and buffers broadcast from rank 0, the gradients all-reduced (averaged)
in buckets of ``comm_buffer_size`` MB during ``backward``, ``no_sync``,
``scale_loss`` and ``apply_collective_grads``.  The bucketing is
``torch.nn.parallel.DistributedDataParallel``'s; its communication hook
is this package's ``all_reduce`` (counted, and host-staged on gloo like
every collective here), and ``comm`` (:class:`CommStats`) keeps its
calls, bytes and seconds.  Methods of the wrapped model other than
``forward`` (``compute_loss``) run through the same machinery when called
on the wrapper.
"""

from __future__ import annotations

import inspect
import os
import time
from contextlib import nullcontext
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from . import collective as _coll
from . import env as _env
from .env import ParallelEnv

__all__ = ["init_parallel_env", "DataParallel", "ParallelEnv",
           "choose_backend", "world_devices", "CommStats"]


def world_devices() -> Optional[list]:
    """Every rank's device, from the launcher's ``PADDLE_WORLD_DEVICES``
    (card ids or ``cpu``, in rank order); None without it."""
    spec = os.environ.get("PADDLE_WORLD_DEVICES")
    if not spec:
        return None
    return [torch.device("cpu") if d.strip() == "cpu"
            else torch.device("cuda", int(d)) for d in spec.split(",")]


def choose_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devices = list(devices)
    cards = [d.index or 0 for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_parallel_env(backend: Optional[str] = None,
                      timeout_s: float = 1800.0) -> ParallelEnv:
    """Join the launcher's job (a no-op for a single-rank job) and make
    its process group this package's default group."""
    world, rank = _env.get_world_size(), _env.get_rank()
    if world > 1 and not dist.is_initialized():
        devices = world_devices()
        if backend is None:
            # without the launcher's list: each rank is taken to own its
            # card (Paddle's launcher gives one a rank), the CPU is gloo
            backend = choose_backend(devices or [_env.local_device()])
        timeout = timedelta(seconds=float(timeout_s))
        store = _pg_store(rank, world, timeout)
        if backend == "nccl":
            torch.cuda.set_device(_env.local_device())
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    if dist.is_initialized():
        _coll._set_default(_coll.Group(
            dist.group.WORLD, range(dist.get_world_size()),
            dist.get_backend(), gid=0, rank=dist.get_rank()))
        # this rank's liveness on the job's store, so that a watchdog's
        # hang report can name the ranks whose beat stopped
        global _heartbeat
        store = _coll._host_store()
        if _heartbeat is None and store is not None:
            from .watchdog import Heartbeat
            _heartbeat = Heartbeat(store, rank,
                                   generation=_coll._generation()).start()
    _env._mark_initialized()
    return ParallelEnv()


_heartbeat = None


def _stop_heartbeat() -> None:
    """Stop this rank's heartbeat (``destroy_process_group``'s)."""
    global _heartbeat
    if _heartbeat is not None:
        _heartbeat.stop()
        _heartbeat = None


def _pg_store(rank: int, world: int, timeout: timedelta):
    """The process group's store: rank 0 hosts it at
    ``COORDINATOR_ADDRESS``, every other rank joins it."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if not coord:
        raise RuntimeError(
            "init_parallel_env: COORDINATOR_ADDRESS is unset; start the "
            "job with python -m paddle_tpu_torch.distributed.launch")
    host, port = coord.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, rank == 0, timeout)


class _Entry(nn.Module):
    """What DDP wraps: ``forward(method, ...)`` calls ``inner``'s
    ``method``, so any method of the model runs under DDP's reducer."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, method, *args, **kwargs):
        if method == "forward":
            return self.inner(*args, **kwargs)
        return getattr(self.inner, method)(*args, **kwargs)


class CommStats:
    """What the gradient all-reduce cost: ``calls`` (buckets), ``bytes``
    and ``seconds`` on the host clock (a CUDA bucket's wait for the
    backward that filled it excluded: the stream is synchronised before
    the clock starts)."""

    def __init__(self, group):
        self.group = group
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0


def _allreduce_hook(stats: CommStats, bucket):
    """DDP's communication hook: the bucket averaged over the group by
    this package's ``all_reduce``."""
    buf = bucket.buffer()
    if buf.is_cuda:
        torch.cuda.current_stream(buf.device).synchronize()
    t0 = time.perf_counter()
    _coll.all_reduce(buf, _coll.ReduceOp.AVG, stats.group)
    stats.seconds += time.perf_counter() - t0
    stats.calls += 1
    stats.bytes += buf.numel() * buf.element_size()
    fut = torch.futures.Future()
    fut.set_result(buf)
    return fut


class DataParallel(nn.Module):
    """Data-parallel training over ``group`` (the default group)."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        self._group = group if group is not None else _coll.get_group()
        self.comm_buffer_size = int(comm_buffer_size)
        self.find_unused_parameters = bool(find_unused_parameters)
        self.comm = CommStats(self._group)
        ddp = None
        if self._group.nranks > 1 and self._group.pg is not None:
            self._broadcast_initial_params()
            kw = dict(broadcast_buffers=False,
                      bucket_cap_mb=self.comm_buffer_size,
                      find_unused_parameters=self.find_unused_parameters,
                      process_group=self._group.pg)
            if "init_sync" in inspect.signature(
                    nn.parallel.DistributedDataParallel).parameters:
                kw["init_sync"] = False     # the broadcast above did it
            ddp = nn.parallel.DistributedDataParallel(_Entry(layers), **kw)
            ddp.register_comm_hook(self.comm, _allreduce_hook)
        # not a submodule: the state dict is the wrapped model's alone
        object.__setattr__(self, "_ddp", ddp)

    @torch.no_grad()
    def _broadcast_initial_params(self) -> None:
        """Rank 0's parameters AND buffers win (Paddle's
        ``sync_params_buffers``)."""
        for t in list(self._layers.parameters()) + \
                list(self._layers.buffers()):
            _coll.broadcast(t.data, src=self._group.ranks[0],
                            group=self._group)

    def _call(self, method, *args, **kwargs):
        if self._ddp is None:
            fn = self._layers if method == "forward" \
                else getattr(self._layers, method)
            return fn(*args, **kwargs)
        return self._ddp(method, *args, **kwargs)

    def forward(self, *inputs, **kwargs):
        return self._call("forward", *inputs, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            pass
        attr = getattr(self._layers, name)
        if inspect.ismethod(attr):
            return lambda *a, **k: self._call(name, *a, **k)
        return attr

    def no_sync(self):
        """Gradients accumulate locally inside the context; the next
        synchronised backward (or ``apply_collective_grads``) averages
        them."""
        return self._ddp.no_sync() if self._ddp is not None \
            else nullcontext()

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self) -> None:
        """Average every gradient over the group now, in buckets of
        ``comm_buffer_size`` MB (after ``no_sync`` accumulation)."""
        if self._ddp is None:
            return
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        cap = self.comm_buffer_size * 2 ** 20
        bucket, size = [], 0
        for g in grads + [None]:
            if g is not None and (not bucket or (
                    size + g.numel() * g.element_size() <= cap
                    and g.dtype == bucket[0].dtype
                    and g.device == bucket[0].device)):
                bucket.append(g)
                size += g.numel() * g.element_size()
                continue
            if bucket:
                flat = _flatten_dense_tensors(bucket)
                _coll.all_reduce(flat, _coll.ReduceOp.AVG, self._group)
                for t, v in zip(bucket, _unflatten_dense_tensors(flat,
                                                                 bucket)):
                    t.copy_(v)
            bucket = [g] if g is not None else []
            size = g.numel() * g.element_size() if g is not None else 0

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict
