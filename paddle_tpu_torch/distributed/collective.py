"""Groups and process-granular collectives.

Counterpart of ``paddle_tpu/distributed/collective.py`` with the eager
multi-process semantics of ``paddle_tpu/distributed/eager_comm.py``
(Paddle's ``distributed/communication/`` and its C++ ``ProcessGroup``).
Every collective is PROCESS-granular: each process of the group
contributes one tensor, the one-rank-per-device model of Paddle and of
the JAX package's eager path.  A group of one rank is the single-rank
no-op.  Tensors change in place where Paddle's do.

A :class:`Group` holds a ``torch.distributed`` ``ProcessGroup`` and calls
its methods directly, so the same code runs over the default group of
:func:`~paddle_tpu_torch.distributed.parallel.init_parallel_env`, a
:func:`new_group`, or a group of its own (:func:`private_group`: the
serving engine's tensor-parallel ranks, which must not touch the
process's default group).

The transport: gloo moves host memory.  A CUDA tensor given to a
collective of a gloo group is copied to the host, reduced or moved there,
and copied back, every time, and counted in ``collective.host_staged``;
nothing decides this silently per call.  NCCL groups take the CUDA tensors
as they are.  Each call counts ``collective.calls`` and the input bytes in
``collective.bytes`` (labels ``op``), in the port's metrics registry.

The host waits where the JAX package registers its comm watchdog
(``watchdog.py``) are registered here too: ``barrier``, the object
collectives and the wait of a receive, each a ``comm_task`` whose meta
holds the job's control-plane store (:func:`_host_store`) and the restart
generation, so a hang report names the ranks with no heartbeat.  With
``watchdog.COMM_STATIC_CHECK`` on, ``all_reduce`` and ``all_gather`` over
the whole job first check every rank's shape and dtype through that store
(``static_check_meta``).

Two deliberate supersets, as in the JAX package: ``reduce`` leaves the
result on every rank (Paddle promises it only on ``dst``), and ``gather``
fills ``gather_list`` on every rank.  The JAX module's ``axis_context``
(collectives lowered inside ``shard_map``) has no torch counterpart: a
torch program is eager, so every collective here is the eager one.
"""

from __future__ import annotations

import os
import pickle
from datetime import timedelta
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..observability import metrics as _metrics
from . import env as _env
from . import watchdog as _wd

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "private_group",
           "is_initialized", "destroy_process_group", "all_reduce",
           "reduce", "all_gather", "all_gather_into_tensor",
           "all_gather_concat", "all_gather_object", "reduce_scatter",
           "alltoall", "alltoall_single", "broadcast", "broadcast_object_list",
           "scatter", "gather", "send", "recv", "isend", "irecv",
           "barrier", "wait", "stream"]

_M_CALLS = _metrics.counter("collective.calls",
                            "collective API invocations per op")
_M_BYTES = _metrics.counter("collective.bytes",
                            "payload bytes entering each collective")
_M_STAGED = _metrics.counter(
    "collective.host_staged",
    "collectives of a gloo group whose CUDA tensors went through the host")


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communication group: ``ranks`` (global ranks, in group order),
    this process's place in it, and the ``ProcessGroup`` (None for a
    single-rank group and for a process outside the group)."""

    _counter = 0

    def __init__(self, pg=None, ranks=None, backend: str = "gloo",
                 gid: Optional[int] = None, rank: Optional[int] = None):
        Group._counter += 1
        self.id = gid if gid is not None else Group._counter
        self.pg = pg
        self._ranks = list(ranks) if ranks is not None else [0]
        self.backend = backend
        # this process's global rank (a private group numbers its own)
        self._me = _env.get_rank() if rank is None else int(rank)

    @property
    def nranks(self) -> int:
        return len(self._ranks)

    world_size = nranks

    @property
    def ranks(self) -> List[int]:
        return list(self._ranks)

    def get_group_rank(self, global_rank: int) -> int:
        """The group rank of ``global_rank``; -1 outside the group."""
        return self._ranks.index(global_rank) \
            if global_rank in self._ranks else -1

    @property
    def rank(self) -> int:
        return self.get_group_rank(self._me)

    @property
    def process_group(self):
        return self.pg

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"backend={self.backend})")


_default: Optional[Group] = None
_groups: dict = {}


def _set_default(group: Optional[Group]) -> None:
    global _default
    _default = group
    if group is not None:
        _groups[0] = group


def _get_default_group() -> Group:
    global _default
    if _default is None:
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            _default = Group(dist.group.WORLD, range(world),
                             dist.get_backend(), gid=0, rank=dist.get_rank())
        else:
            _default = Group(None, [0], gid=0, rank=0)
    return _default


def _group(group) -> Group:
    return group if group is not None else _get_default_group()


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (every rank of the job by default).  Every
    process of the job calls it, members or not (``torch.distributed``'s
    rule); a non-member gets a group whose collectives do nothing."""
    world = _env.get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    pg = None
    base = _get_default_group()
    if base.pg is not None:
        kw = {} if timeout is None else {
            "timeout": timeout if isinstance(timeout, timedelta)
            else timedelta(seconds=float(timeout))}
        pg = dist.new_group(ranks, backend=backend, **kw)
        if pg is dist.GroupMember.NON_GROUP_MEMBER:
            pg = None
    g = Group(pg if len(ranks) > 1 else None, ranks,
              backend or base.backend, rank=base._me)
    _groups[g.id] = g
    return g


def private_group(store, rank: int, size: int, backend: str = "gloo",
                  timeout_s: float = 300.0) -> Group:
    """A group of its own over ``store`` (a ``torch.distributed`` store),
    outside the process's default group: ranks ``0 .. size - 1``, this
    process ``rank``.  Gloo connects the ranks over the loopback device
    (the ranks of one machine)."""
    timeout = timedelta(seconds=float(timeout_s))
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = timeout
        pg = dist.ProcessGroupGloo(store, rank, size, opts)
    elif backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(store, rank, size, opts)
    else:
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    return Group(pg, range(size), backend, rank=rank)


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _get_default_group()
    return _groups[gid]


def is_initialized() -> bool:
    return _env.is_initialized()


def destroy_process_group(group=None) -> None:
    """Without ``group``: the default group and every group made from it
    go, and the job is single-rank again."""
    global _default
    if group is not None and group is not _default:
        if group.pg is not None and dist.is_initialized():
            dist.destroy_process_group(group.pg)
        _groups.pop(group.id, None)
        return
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _default = None
    _groups.clear()
    _store_state.update(store=None, seq={})
    from . import parallel
    parallel._stop_heartbeat()
    _env._mark_initialized(False)


# ------------------------------------------------------- the control plane
_store_state = {"store": None, "seq": {}}


def _generation() -> str:
    """The launcher's restart generation: a restarted world's keys must
    not meet those the last one left in the store."""
    return os.environ.get("PADDLE_RESTART_GENERATION", "0")


def _host_store():
    """The job's control-plane store: the launcher's ``TCPStore`` at
    ``PADDLE_MASTER`` (a ``store.TCPStore`` client), None for a
    single-rank job."""
    st = _store_state
    world = _env.get_world_size()
    master = os.environ.get("PADDLE_MASTER")
    if st["store"] is None and world > 1 and master:
        from .store import TCPStore
        host, port = master.rsplit(":", 1)
        st["store"] = TCPStore(host, int(port), world_size=world)
    return st["store"]


def _next_seq(key) -> int:
    seq = _store_state["seq"].get(key, 0)
    _store_state["seq"][key] = seq + 1
    return seq


def _watched(name: str) -> "_wd.comm_task":
    """A watchdog task around a host wait of this rank."""
    return _wd.comm_task(name, rank=_env.get_rank(),
                         world_size=_env.get_world_size(),
                         store=_host_store(), generation=_generation())


def _maybe_static_check(op: str, tensor: torch.Tensor, g: "Group") -> None:
    """``COMM_STATIC_CHECK``: every rank's shape and dtype for ``op``
    checked before it runs, for collectives over the whole job (a
    sub-group's ranks do not include the checking rank 0, as in the JAX
    package)."""
    if not _wd.COMM_STATIC_CHECK or g.nranks != _env.get_world_size():
        return
    store = _host_store()
    if store is None:
        return
    _wd.static_check_meta(
        store, _env.get_rank(), _env.get_world_size(), op,
        _next_seq(("check", op)), shape=tuple(tensor.shape),
        dtype=str(tensor.dtype).replace("torch.", ""),
        generation=_generation())


# ------------------------------------------------------------ transport
def _count(op: str, g: Group, *tensors) -> bool:
    """Count one call and its input bytes; returns whether the group's
    transport stages these tensors through the host."""
    staged = g.backend == "gloo" and any(
        isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)
    if _metrics.enabled():
        _M_CALLS.inc(op=op)
        n = sum(t.numel() * t.element_size() for t in tensors
                if isinstance(t, torch.Tensor))
        if n:
            _M_BYTES.inc(n, op=op)
        if staged:
            _M_STAGED.inc(op=op)
    return staged


# bfloat16 travels as float16's bits: data-movement calls only copy, and
# not every gloo release knows bfloat16
_RAW = {torch.bfloat16: torch.float16}


def _buf(t: torch.Tensor, staged: bool, move: bool = False) -> torch.Tensor:
    """What the transport reads and writes for ``t``: a host copy when
    staged, else ``t`` itself when contiguous.  ``move``: the call only
    moves bytes (see ``_RAW``)."""
    if staged:
        buf = t.detach().to("cpu").contiguous()
    else:
        buf = t.detach() if t.is_contiguous() else t.detach().contiguous()
    return buf.view(_RAW[buf.dtype]) if move and buf.dtype in _RAW else buf


def _back(t: torch.Tensor, buf: torch.Tensor) -> None:
    if buf.dtype != t.dtype:
        buf = buf.view(t.dtype)
    if buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf)


def _active(g: Group) -> bool:
    return g.nranks > 1 and g.pg is not None


def _root(g: Group, src: int) -> int:
    r = g.get_group_rank(src)
    if r < 0:
        raise ValueError(f"rank {src} is not in the group {g.ranks}")
    return r


def _reduce_into(g: Group, buf: torch.Tensor, op: str) -> None:
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    g.pg.allreduce([buf], opts).wait()
    if op == ReduceOp.AVG:
        if buf.is_floating_point():
            buf.div_(g.nranks)
        else:
            buf.div_(g.nranks, rounding_mode="trunc")


# ------------------------------------------------------------ the API
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True) -> torch.Tensor:
    """In place: every rank's ``tensor`` becomes the reduction of all."""
    g = _group(group)
    staged = _count("all_reduce", g, tensor)
    if not _active(g):
        return tensor
    _maybe_static_check("all_reduce", tensor, g)
    buf = _buf(tensor, staged)
    _reduce_into(g, buf, op)
    _back(tensor, buf)
    return tensor


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None,
           sync_op: bool = True):
    """The reduction lands on every rank, ``dst`` included (the JAX
    package's superset of Paddle's ``reduce``)."""
    g = _group(group)
    if _active(g):
        _root(g, dst)
    return all_reduce(tensor, op, g, sync_op)


def _gather_bufs(g: Group, buf: torch.Tensor) -> List[torch.Tensor]:
    outs = [torch.empty_like(buf) for _ in range(g.nranks)]
    g.pg.allgather([outs], [buf]).wait()
    return outs


def all_gather(tensor_list: list, tensor: torch.Tensor, group=None,
               sync_op: bool = True) -> list:
    """``tensor_list`` becomes every rank's ``tensor``, in rank order."""
    g = _group(group)
    staged = _count("all_gather", g, tensor)
    tensor_list.clear()
    if not _active(g):
        tensor_list.append(tensor)
        return tensor_list
    _maybe_static_check("all_gather", tensor, g)
    outs = _gather_bufs(g, _buf(tensor, staged, move=True))
    tensor_list.extend(o.view(tensor.dtype).to(tensor.device) for o in outs)
    return tensor_list


def all_gather_concat(tensor: torch.Tensor, dim: int = -1,
                      group=None) -> torch.Tensor:
    """The ranks' ``tensor`` concatenated along ``dim`` in rank order, as
    a new tensor on ``tensor``'s device (one copy to the host and one back
    when staged)."""
    g = _group(group)
    staged = _count("all_gather", g, tensor)
    if not _active(g):
        return tensor
    outs = _gather_bufs(g, _buf(tensor, staged, move=True))
    return torch.cat(outs, dim=dim).view(tensor.dtype).to(tensor.device)


def all_gather_into_tensor(out: torch.Tensor, tensor: torch.Tensor,
                           group=None, sync_op: bool = True) -> torch.Tensor:
    """``out`` (``[W * n, ...]``) becomes the ranks' ``tensor``
    (``[n, ...]``) concatenated on the first axis, in rank order."""
    g = _group(group)
    staged = _count("all_gather", g, tensor)
    with torch.no_grad():
        if not _active(g):
            out.copy_(tensor.reshape(out.shape))
            return out
        outs = _gather_bufs(g, _buf(tensor, staged, move=True))
        out.copy_(torch.cat(outs, dim=0).view(tensor.dtype)
                  .reshape(out.shape))
    return out


def _object_device(g: Group) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) \
        if g.backend == "nccl" else torch.device("cpu")


def all_gather_object(object_list: list, obj: Any, group=None) -> list:
    """``object_list`` becomes every rank's picklable ``obj``."""
    g = _group(group)
    _count("all_gather_object", g)
    object_list.clear()
    if not _active(g):
        object_list.append(obj)
        return object_list
    dev = _object_device(g)
    data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(dev)
    with _watched(f"all_gather_object#{_next_seq('all_gather_object')}"):
        sizes = _gather_bufs(g, torch.tensor([data.numel()],
                                             dtype=torch.int64, device=dev))
        n = max(int(s.item()) for s in sizes)
        padded = torch.zeros(n, dtype=torch.uint8, device=dev)
        padded[:data.numel()] = data
        outs = _gather_bufs(g, padded)
    for s, o in zip(sizes, outs):
        object_list.append(pickle.loads(o[:int(s.item())].cpu().numpy()
                                        .tobytes()))
    return object_list


def reduce_scatter(tensor: torch.Tensor, tensor_or_tensor_list,
                   op: str = ReduceOp.SUM, group=None,
                   sync_op: bool = True) -> torch.Tensor:
    """``tensor`` becomes this rank's tile of the reduction of the ranks'
    inputs (a list is concatenated on the first axis first): tile ``r`` of
    ``W`` equal tiles.  The reduction is a whole all-reduce, then the
    slice: one path for every backend and op."""
    g = _group(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    staged = _count("reduce_scatter", g, src)
    with torch.no_grad():
        if not _active(g):
            tensor.copy_(src.reshape(tensor.shape))
            return tensor
        if src.shape[0] % g.nranks:
            raise ValueError(f"reduce_scatter: dim 0 {src.shape[0]} not "
                             f"divisible by the group size {g.nranks}")
        buf = src.detach().to("cpu" if staged else src.device,
                              copy=True).contiguous()
        _reduce_into(g, buf, op)
        tile = src.shape[0] // g.nranks
        tensor.copy_(buf[g.rank * tile:(g.rank + 1) * tile]
                     .reshape(tensor.shape))
    return tensor


def alltoall(out_tensor_list: list, in_tensor_list: list, group=None,
             sync_op: bool = True) -> list:
    """Rank r's ``in_tensor_list[j]`` becomes rank j's
    ``out_tensor_list[r]``."""
    g = _group(group)
    staged = _count("alltoall", g, *in_tensor_list)
    if not _active(g):
        out_tensor_list[:] = list(in_tensor_list)
        return out_tensor_list
    dev = in_tensor_list[0].device
    dtype = in_tensor_list[0].dtype
    x = torch.stack([t.detach() for t in in_tensor_list], dim=0)
    x = _buf(x, staged, move=True)
    o = torch.empty_like(x)
    g.pg.alltoall_base(o, x, [], [], dist.AllToAllOptions()).wait()
    out_tensor_list[:] = [r.view(dtype).to(dev) for r in o.unbind(0)]
    return out_tensor_list


def alltoall_single(out_tensor: torch.Tensor, in_tensor: torch.Tensor,
                    in_split_sizes=None, out_split_sizes=None, group=None,
                    sync_op: bool = True) -> torch.Tensor:
    """The first axis of ``in_tensor`` split among the ranks (evenly, or
    by ``in_split_sizes``); ``out_tensor`` receives rank j's part for this
    rank at its j-th place (``out_split_sizes``)."""
    g = _group(group)
    staged = _count("alltoall", g, in_tensor)
    with torch.no_grad():
        if not _active(g):
            out_tensor.copy_(in_tensor)
            return out_tensor
        buf = _buf(out_tensor, staged, move=True)
        g.pg.alltoall_base(buf, _buf(in_tensor, staged, move=True),
                           list(out_split_sizes or []),
                           list(in_split_sizes or []),
                           dist.AllToAllOptions()).wait()
        _back(out_tensor, buf)
    return out_tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True) -> torch.Tensor:
    """In place: every rank's ``tensor`` becomes rank ``src``'s."""
    g = _group(group)
    staged = _count("broadcast", g, tensor)
    if not _active(g):
        return tensor
    opts = dist.BroadcastOptions()
    opts.rootRank = _root(g, src)
    buf = _buf(tensor, staged, move=True)
    g.pg.broadcast([buf], opts).wait()
    _back(tensor, buf)
    return tensor


def broadcast_object_list(object_list: list, src: int = 0,
                          group=None) -> list:
    """In place: every rank's ``object_list`` becomes rank ``src``'s (two
    broadcasts: the pickle's length, then its bytes)."""
    g = _group(group)
    _count("broadcast_object_list", g)
    if not _active(g):
        return object_list
    dev = _object_device(g)
    root = _root(g, src)
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    if g.rank == root:
        data = torch.frombuffer(bytearray(pickle.dumps(list(object_list))),
                                dtype=torch.uint8).to(dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    with _watched(
            f"broadcast_object_list#{_next_seq('broadcast_object_list')}"):
        g.pg.broadcast([size], opts).wait()
        if g.rank != root:
            data = torch.empty(int(size.item()), dtype=torch.uint8,
                               device=dev)
        g.pg.broadcast([data], opts).wait()
    if g.rank != root:
        object_list[:] = pickle.loads(data.cpu().numpy().tobytes())
    return object_list


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None, sync_op: bool = True) -> torch.Tensor:
    """In place: ``tensor`` becomes rank ``src``'s ``tensor_list[rank]``."""
    g = _group(group)
    staged = _count("scatter", g, tensor)
    with torch.no_grad():
        if not _active(g):
            if tensor_list:
                tensor.copy_(tensor_list[src])
            return tensor
        opts = dist.ScatterOptions()
        opts.rootRank = _root(g, src)
        buf = _buf(tensor, staged, move=True)
        ins = [[_buf(t, staged, move=True) for t in tensor_list]] \
            if g.rank == opts.rootRank else []
        g.pg.scatter([buf], ins, opts).wait()
        _back(tensor, buf)
    return tensor


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op: bool = True) -> list:
    """``gather_list`` becomes every rank's ``tensor`` on every rank (the
    JAX package's superset of Paddle's ``gather``)."""
    if gather_list is None:
        gather_list = []
    g = _group(group)
    if _active(g):
        _root(g, dst)
    return all_gather(gather_list, tensor, g, sync_op)


class _Task:
    """A point-to-point call in flight: ``wait()`` finishes it (a
    receive's wait as a watchdog task named ``watch``)."""

    def __init__(self, work, finish=None, watch=None):
        self._work = work
        self._finish = finish
        self._watch = watch
        self._done = work is None

    def wait(self) -> bool:
        if not self._done:
            if self._watch is None:
                self._work.wait()
            else:
                with _watched(self._watch):
                    self._work.wait()
            if self._finish is not None:
                self._finish()
            self._done = True
        return True

    def is_completed(self) -> bool:
        return self._done


def isend(tensor: torch.Tensor, dst: int = 0, group=None) -> _Task:
    g = _group(group)
    staged = _count("send", g, tensor)
    if not _active(g):
        return _Task(None)
    return _Task(g.pg.send([_buf(tensor, staged, move=True)],
                           _root(g, dst), 0))


def irecv(tensor: torch.Tensor, src: int = 0, group=None) -> _Task:
    g = _group(group)
    staged = _count("recv", g, tensor)
    if not _active(g):
        return _Task(None)
    buf = _buf(tensor, staged, move=True)
    return _Task(g.pg.recv([buf], _root(g, src), 0),
                 lambda: _back(tensor, buf),
                 watch=f"recv({src}->{g._me})")


def send(tensor: torch.Tensor, dst: int = 0, group=None,
         sync_op: bool = True):
    task = isend(tensor, dst, group)
    if sync_op:
        task.wait()
        return tensor
    return task


def recv(tensor: torch.Tensor, src: int = 0, group=None,
         sync_op: bool = True):
    task = irecv(tensor, src, group)
    if sync_op:
        task.wait()
        return tensor
    return task


def barrier(group=None) -> None:
    g = _group(group)
    _count("barrier", g)
    if _active(g):
        with _watched(f"barrier#{_next_seq('barrier')}"):
            g.pg.barrier().wait()


def wait(tensor, group=None, use_calc_stream: bool = True):
    """The collectives here return when their result is in place; a CUDA
    tensor's stream is synchronised for the caller's host reads."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class stream:
    """Paddle's ``distributed.stream`` namespace: the same calls."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    broadcast = staticmethod(broadcast)
    send = staticmethod(send)
    recv = staticmethod(recv)
