"""Pipeline parallelism over the pipeline group's ring: counterpart of
``paddle_tpu/distributed/fleet/spmd_pipeline.py``.

The JAX package runs the schedule as ONE SPMD program under ``shard_map``
over its ``pp`` mesh axis: every stage holds its own parameters,
activations move with ``lax.ppermute``, every rank runs every tick with
masking, and backward is AD through the schedule (``ppermute``'s
transpose is the reverse permute).  The port is process-granular: each
rank of the pipeline group calls the same function with its own stage (or
``V`` chunks) and the same tick arithmetic, and

- ``lax.ppermute`` over the ring is :func:`ring_permute`, an autograd
  function over the port's ``isend`` / ``irecv`` whose backward is the
  reverse permute;
- the closing ``psum`` of the last stage's masked outputs is an
  all-reduce whose backward is the identity (``mp_layers``'
  ``reduce_from_mp`` over the pipeline group), the gradient the JAX
  function gives at its inputs: every rank's loss on the replicated
  outputs sends its cotangent to the last stage's banked outputs once;
- ``jax.checkpoint`` is ``torch.utils.checkpoint.checkpoint(...,
  use_reentrant=False)``.

A tick whose result the JAX schedule masks away skips the compute (its
output is its input, passed on).  Every rank posts one send and one
receive a tick, forward and backward, in the same order: in the backward
the ticks' permutes form one chain on every rank (a tick's input always
depends on the carry it received, the first carry is a leaf that
requires grad, and the returned outputs hand the last carry a zero
gradient), so the autograd engine runs them last tick first everywhere
and the ring cannot deadlock.  Every rank differentiates with
``backward()``: ``torch.autograd.grad`` over some inputs only would skip
the permutes that do not lead to them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from .. import collective as _coll
from .mp_layers import reduce_from_mp

__all__ = ["pipeline_forward", "interleaved_pipeline_forward",
           "stack_stage_params", "ring_permute", "run_schedule",
           "schedule_ticks", "tick_work", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (and
    the matching entries of ``rest``, trees at least as deep)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def stack_stage_params(per_stage_params: list):
    """Stack a list of like-structured stage parameter trees along a new
    first dimension."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in
                                               per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params), dim=0)


def _pp_group(group):
    """``group``, else the pipeline group of ``fleet.init``'s topology,
    else None (one rank)."""
    if group is not None:
        return group
    from .fleet import _fleet_state
    hcg = _fleet_state["hcg"]
    return None if hcg is None else hcg.get_pipe_parallel_group()


def _exchange(x, group, shift):
    """Send ``x`` to the rank ``shift`` places on along the ring and
    receive the tensor of the rank ``shift`` places back."""
    P, r = group.nranks, group.rank
    ranks = group.ranks
    out = torch.empty_like(x)
    send = _coll.isend(x.detach().contiguous(), ranks[(r + shift) % P],
                       group)
    recv = _coll.irecv(out, ranks[(r - shift) % P], group)
    recv.wait()
    send.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, -1), None


def ring_permute(x, group=None):
    """``lax.ppermute(x, perm=[(i, (i + 1) % P)])`` over the pipeline
    group: this rank's ``x`` goes to the next rank, and the result is
    what the previous rank sent.  Its backward is the reverse permute.
    One rank: ``x``."""
    group = _pp_group(group)
    if group is None or group.nranks == 1:
        return x
    return _RingPermute.apply(x, group)


class _Join(torch.autograd.Function):
    """``keep``; the backward hands each of ``others`` a zero gradient
    (``jnp.where``'s unselected operand): it keeps them on the path of
    every rank's backward."""

    @staticmethod
    def forward(ctx, keep, *others):
        ctx.metas = [(o.shape, o.dtype, o.device) for o in others]
        return keep.view_as(keep)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.metas))


def join(keep, *others):
    """``keep``, with ``others`` kept on the backward's path (a zero
    gradient each)."""
    if not torch.is_grad_enabled():
        return keep
    return _Join.apply(keep, *others)


def first_carry(like):
    """The ring's first carry: zeros like ``like``, a leaf that requires
    grad (so the first tick's permute exists on every rank)."""
    return torch.zeros_like(like).requires_grad_(torch.is_grad_enabled())


def _remat(fn):
    """``fn`` under ``jax.checkpoint``'s counterpart: activations
    recomputed in the backward."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def schedule_ticks(P: int, V: int, M: int) -> int:
    """Ticks of the schedule over ``P`` ranks of ``V`` chunks each for
    ``M`` micro-batches: the last micro-batch enters global stage 0 at
    ``((M-1)//P)*P*V + (M-1)%P`` and needs ``P*V`` ticks to drain (V 1:
    GPipe's ``M + P - 1``)."""
    return ((M - 1) // P) * P * V + (M - 1) % P + P * V


def tick_work(t: int, idx: int, P: int, V: int, M: int):
    """What rank ``idx`` does at tick ``t``: ``(v, m, active)``, its chunk
    slot ``v`` (global stage ``v * P + idx``, the Megatron assignment) on
    micro-batch ``m``.  Micro-batch m enters global stage 0 at tick
    ``(m // P) * P * V + m % P`` and moves one global stage a tick, so the
    rank's step ``u = t - idx`` lies in round ``u // (P V)``, slot
    ``(u % (P V)) // P``, on micro-batch ``round * P + u % P``."""
    u = t - idx
    m = (u // (P * V)) * P + u % P
    return (u % (P * V)) // P, m, 0 <= u and m < M


def run_schedule(stage_of: Callable, enter: Callable, leave: Callable,
                 like, M: int, V: int, group):
    """The tick loop of every schedule here, on this rank of ``group``:
    ``enter(m)`` is micro-batch m's input to global stage 0,
    ``stage_of(v, h)`` runs this rank's chunk slot v, ``leave(m, h)``
    takes the last global stage's output; the carry goes round the ring
    every tick.  Returns the last carry, which the caller joins into what
    it differentiates (a zero gradient that starts every rank's chain of
    permutes)."""
    P = 1 if group is None else group.nranks
    idx = 0 if group is None else group.rank
    carry = first_carry(like)
    for t in range(schedule_ticks(P, V, M)):
        v, m, active = tick_work(t, idx, P, V, M)
        h = carry
        if active:
            if idx == 0 and v == 0:
                h = join(enter(m), carry)
            h = stage_of(v, h)
            if idx == P - 1 and v == V - 1:
                leave(m, h)
        carry = ring_permute(h, group)
    return carry


def _collect(outs, like, last, M, group):
    """The last stage's outputs on every rank: the all-reduce of the
    masked stack, identity backward."""
    if last:
        stacked = torch.stack(outs)
    else:
        stacked = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                              device=like.device)
    return reduce_from_mp(stacked, group)


def _pipeline(stage_of, inputs, M, V, group):
    group = _pp_group(group)
    outs = [None] * M
    carry = run_schedule(stage_of, lambda m: inputs[m], outs.__setitem__,
                         inputs[0], M, V, group)
    last = group is None or group.rank == group.nranks - 1
    return join(_collect(outs, inputs[0], last, M, group), carry)


def pipeline_forward(stage_fn: Callable, params_local: Any, inputs,
                     n_microbatches: int, group=None, remat: bool = True):
    """The GPipe forward on this rank's stage.

    ``stage_fn(params, h) -> h'``; ``inputs`` ``[M, mb, ...]``, the same
    on every rank (stage 0 reads it).  Returns the last stage's outputs
    ``[M, mb, ...]`` on every rank.  ``M + P - 1`` ticks: tick t feeds
    micro-batch t to stage 0, stage s works on micro-batch t - s."""
    fn = _remat(stage_fn) if remat else stage_fn
    return _pipeline(lambda v, h: fn(params_local, h), inputs,
                     n_microbatches, 1, group)


def interleaved_pipeline_forward(stage_fn: Callable, chunk_params_local: Any,
                                 inputs, n_microbatches: int, n_chunks: int,
                                 group=None, remat: bool = True):
    """The interleaved (VPP) schedule on this rank's ``n_chunks`` (V)
    chunks: global stage ``g = v * P + r`` lives on rank r, chunk v (the
    Megatron assignment); a rank computes one chunk a tick
    (:func:`tick_work`).

    ``chunk_params_local``: a tree whose leaves lead with V;
    ``stage_fn(chunk_params, h) -> h'`` for one chunk; ``inputs``
    ``[M, mb, ...]``.  Returns the last global stage's outputs on every
    rank."""
    fn = _remat(stage_fn) if remat else stage_fn
    return _pipeline(
        lambda v, h: fn(tree_map(lambda leaf: leaf[v], chunk_params_local),
                        h),
        inputs, n_microbatches, n_chunks, group)
