"""Sequence-parallel utilities (Megatron SP): counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``
(Paddle's ``fleet/utils/sequence_parallel_utils.py``: ``scatter``,
``all_gather``, ``reduce_scatter``, ``ScatterOp``, ``GatherOp``,
``AllGatherOp``, ``ReduceScatterOp``, ``ColumnSequenceParallelLinear``,
``RowSequenceParallelLinear``, ``mark_as_sequence_parallel_parameter``,
``register_sequence_parallel_allreduce_hooks``).

The JAX package makes each operator a sharding move of a global array,
whose adjoint GSPMD derives.  The port is process-granular, as Paddle
is: each operator is an autograd function over the model-parallel group
(``mp_layers.mp_state``; any group may be given) whose backward is its
adjoint:

- :func:`scatter`: this rank's slice along ``axis``; backward all-gathers;
- :func:`all_gather`: the ranks' slices concatenated along ``axis``;
  backward reduce-scatters (the cotangents are partial, as in a
  tensor-parallel region);
- :func:`reduce_scatter`: the sum of the ranks' tensors, this rank's
  slice along ``axis``; backward all-gathers;
- ``GatherOp``: all-gather forward, slice backward (Paddle's, for a
  replicated consumer such as the loss).

Reductions run in float32 and come back in the input's type.  The
sequence axis of a ``[B, S, H]`` activation is 1 (the JAX layers' choice;
0 for 2-D inputs).

A parameter that the ranks hold alike but apply to their own sequence
slice (a LayerNorm, the row-parallel bias) gets a partial gradient on
each rank.  GSPMD sums those in the JAX package, where
``register_sequence_parallel_allreduce_hooks`` only checks the layout;
here the hook does the sum: an all-reduce of each marked parameter's
gradient over the group (every ``accumulation_steps``-th accumulation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import collective as _coll
from .. import mp_layers as _mp

__all__ = ["scatter", "all_gather", "reduce_scatter",
           "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "allreduce_sequence_parallel_grads"]


def _group(group):
    group = group if group is not None else _mp.mp_state()[0]
    return group if group is not None and group.nranks > 1 else None


def _split(x, axis, group):
    return x.chunk(group.nranks, dim=axis)[group.rank].contiguous()


def _gather(x, axis, group):
    return _coll.all_gather_concat(x.detach().contiguous(), axis, group)


def _reduce_scatter(x, axis, group):
    n = group.nranks
    src = x.detach().movedim(axis, 0).float().contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: axis {axis} of {tuple(x.shape)} "
                         f"is not divisible by the group size {n}")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _coll.reduce_scatter(out, src, group=group)
    return out.movedim(0, axis).to(x.dtype).contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _split(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.axis, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _reduce_scatter(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


def _op(fn):
    def call(input, axis: int = 0, group=None):  # noqa: A002
        g = _group(group)
        return input if g is None else fn.apply(input, axis, g)
    return call


scatter = _op(_Scatter)
scatter.__doc__ = """This rank's slice of ``input`` along ``axis`` over the
group (the model-parallel group by default); backward all-gathers."""
all_gather = _op(_AllGather)
all_gather.__doc__ = """The ranks' ``input`` concatenated along ``axis``;
backward reduce-scatters."""
reduce_scatter = _op(_ReduceScatter)
reduce_scatter.__doc__ = """The sum of the ranks' ``input``, this rank's
slice along ``axis``; backward all-gathers."""
_gather_op = _op(_Gather)


class _OpModule:
    """Paddle's ``ScatterOp.apply(x)`` call shape."""

    def __init__(self, fn):
        self._fn = fn

    def apply(self, x, *a, **k):
        return self._fn(x, *a, **k)

    __call__ = apply


ScatterOp = _OpModule(scatter)
GatherOp = _OpModule(_gather_op)
AllGatherOp = _OpModule(all_gather)
ReduceScatterOp = _OpModule(reduce_scatter)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter):
    return bool(getattr(parameter, "sequence_parallel", False))


def allreduce_sequence_parallel_grads(grads, group=None):
    """In place: each of ``grads`` becomes its sum over the group (one
    float32 all-reduce for all of them)."""
    g = _group(group)
    grads = [t for t in grads if t is not None]
    if g is None or not grads:
        return
    flat = torch.cat([t.detach().float().reshape(-1) for t in grads])
    _coll.all_reduce(flat, _coll.ReduceOp.SUM, g)
    off = 0
    with torch.no_grad():
        for t in grads:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def register_sequence_parallel_allreduce_hooks(layer, accumulation_steps=1,
                                               fuse_allreduce=False):
    """Sum each marked parameter's gradient over the model-parallel group
    after every ``accumulation_steps``-th accumulation into it (one
    all-reduce a parameter; ``fuse_allreduce`` is accepted and changes
    nothing).  Returns the hook handles."""
    g = _group(None)
    handles = []
    if g is None:
        return handles
    steps = max(int(accumulation_steps), 1)
    for p in layer.parameters():
        if not (is_sequence_parallel_parameter(p) and p.requires_grad):
            continue
        count = [0]

        def hook(param, count=count):
            count[0] += 1
            if count[0] % steps == 0:
                allreduce_sequence_parallel_grads([param.grad], g)
        handles.append(p.register_post_accumulate_grad_hook(hook))
    return handles


def _seq_axis(x):
    return 1 if x.dim() >= 3 else 0


class ColumnSequenceParallelLinear(_mp.ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-sharded: the
    input is all-gathered along the sequence (backward reduce-scatters,
    which sums the ranks' partial input gradients), then this rank's
    columns are applied."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear: gather_output "
                             "must be False")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name)

    def forward(self, x):
        x = all_gather(x, _seq_axis(x), self.mp_group)
        return F.linear(x, self.weight, self.bias)


class RowSequenceParallelLinear(_mp.RowParallelLinear):
    """A row-parallel linear whose output leaves sequence-sharded: the
    ranks' partial products are reduce-scattered along the sequence (one
    reduce-scatter instead of an all-reduce then a split), then the whole
    bias is added; the bias is a sequence-parallel parameter."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear: input_is_parallel "
                             "must be True")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = reduce_scatter(F.linear(x, self.weight), _seq_axis(x),
                             self.mp_group)
        return out + self.bias if self.bias is not None else out
