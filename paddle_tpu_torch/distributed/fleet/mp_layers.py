"""Tensor-parallel (Megatron) layers: counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py`` (Paddle's
``fleet/layers/mpu/mp_layers.py``: ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelCrossEntropy``).

The JAX package annotates the GLOBAL weights with a ``NamedSharding``
and lets GSPMD insert every collective, so its tensor-parallel model is
the dense model's math on global arrays.  The port is process-granular:
a rank holds its own shard, and the collectives are Megatron's four
operators, ``torch.autograd.Function`` s over the mp group
(``distributed/collective.py``):

- :func:`copy_to_mp`: identity forward, all-reduce (sum) backward;
- :func:`reduce_from_mp`: all-reduce forward, identity backward;
- :func:`gather_from_mp`: gather on the last dim forward, split backward;
- :func:`scatter_to_mp`: split on the last dim forward, gather backward.

Beside them, :func:`all_to_all` over any group (``lax.all_to_all`` with
``tiled=True``), whose backward is the reverse all-to-all: Ulysses
attention's head exchange and expert parallelism's token exchange.

Reductions run in float32 and come back in the input's type.

Layouts, in ``torch.nn.Linear``'s ``[out, in]`` (``models/convert.py``
maps the JAX ``[in, out]`` weights): a column-parallel weight holds rows
``r * out / mp ..`` of the global weight and its bias the same slice; a
row-parallel weight holds columns ``r * in / mp ..``, its bias whole
(added after the reduce, as in the JAX code); a vocab-parallel embedding
holds rows ``r * V / mp ..``.  ``ColumnParallelLinear(parts=3)`` splits
each of 3 equal blocks of the output (a fused q/k/v) on its own, so a
rank holds its heads' q, k and v.  Every such parameter carries
``mp_split = True`` and its split (``split_axis``, ``split_parts``,
``split_rank``, ``split_degree``, ``global_shape``): :func:`shard_of`,
:func:`full_of` and :func:`gather_full` use them for ``convert.py``'s
global <-> local maps, the models' initialisation (a rank's shard of the
weights a one-process model draws from the same seed) and ZeRO.

At mp degree 1, or with no ``fleet.init``, every layer is the plain one:
the whole weight, and the collectives do nothing (the JAX ``shard_param``
returns the parameter unchanged when there is no mesh).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import collective as _coll

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard_param",
           "copy_to_mp", "reduce_from_mp", "gather_from_mp",
           "scatter_to_mp", "all_to_all", "mp_state", "shard_of", "full_of",
           "gather_full", "init_global_"]


def mp_state(mp_group=None):
    """``(group, rank, degree)`` of the model-parallel group: ``mp_group``
    if given, else the one of ``fleet.init``'s topology, else a single
    rank."""
    if mp_group is None:
        from .fleet import _fleet_state
        hcg = _fleet_state["hcg"]
        if hcg is None:
            return None, 0, 1
        mp_group = hcg.get_model_parallel_group()
    return mp_group, max(mp_group.rank, 0), mp_group.nranks


# ----------------------------------------------------- the four operators
def _all_reduce(x, group):
    buf = x.detach().float().contiguous()
    _coll.all_reduce(buf, _coll.ReduceOp.SUM, group)
    return buf.to(x.dtype)


def _gather_last(x, group):
    return _coll.all_gather_concat(x.detach().contiguous(), -1, group)


def _split_last(x, group):
    n = group.nranks
    return x.chunk(n, dim=-1)[group.rank].contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _split_last(g, ctx.group), None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def _active(group) -> bool:
    return group is not None and group.nranks > 1


def copy_to_mp(x, group):
    return _CopyToMP.apply(x, group) if _active(group) else x


def reduce_from_mp(x, group):
    return _ReduceFromMP.apply(x, group) if _active(group) else x


def gather_from_mp(x, group):
    return _GatherFromMP.apply(x, group) if _active(group) else x


def scatter_to_mp(x, group):
    return _ScatterToMP.apply(x, group) if _active(group) else x


def _exchange_all(x, group, split, concat):
    """Chunk j of ``x`` along ``split`` goes to rank j; the chunks
    received, in rank order, are concatenated along ``concat``."""
    send = torch.stack(x.chunk(group.nranks, dim=split)).contiguous()
    recv = torch.empty_like(send)
    _coll.alltoall_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange_all(x.detach(), group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_all(g.contiguous(), ctx.group, ctx.concat,
                              ctx.split), None, None, None)


def all_to_all(x, group, split_axis: int = 0, concat_axis: int = 0):
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group``: ``x`` cut in ``nranks`` equal chunks along ``split_axis``,
    chunk j sent to rank j, and the chunks received concatenated along
    ``concat_axis`` in rank order.  Differentiable: the backward is the
    all-to-all with the two axes swapped.  One rank: ``x``."""
    if not _active(group):
        return x
    if x.shape[split_axis] % group.nranks:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide by the group size "
                         f"{group.nranks}")
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# ------------------------------------------------------- shard bookkeeping
def shard_param(param, axis, rank, degree, global_shape, parts=1):
    """Mark ``param`` as this rank's shard of a ``global_shape`` tensor
    split on ``axis`` (seen as ``parts`` equal blocks, each split in
    ``degree``); degree 1 leaves it an ordinary parameter."""
    if degree > 1:
        param.mp_split = True
        param.split_axis = axis
        param.split_parts = parts
        param.split_rank = rank
        param.split_degree = degree
        param.global_shape = tuple(global_shape)
    return param


def _blocks(shape, axis, parts):
    return shape[:axis] + (parts, shape[axis] // parts) + shape[axis + 1:]


def shard_of(full: torch.Tensor, axis: int, parts: int, rank: int,
             degree: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full`` (a copy; see :func:`shard_param`)."""
    shape = tuple(full.shape)
    n = shape[axis] // parts // degree
    v = full.reshape(_blocks(shape, axis, parts)).narrow(axis + 1, rank * n,
                                                         n)
    out = list(shape)
    out[axis] = shape[axis] // degree
    return v.reshape(out).clone()


def full_of(shards, axis: int, parts: int) -> torch.Tensor:
    """The global tensor of ``shards`` (every rank's, in rank order)."""
    shape = tuple(shards[0].shape)
    cat = torch.cat([s.reshape(_blocks(shape, axis, parts)) for s in shards],
                    dim=axis + 1)
    out = list(shape)
    out[axis] = shape[axis] * len(shards)
    return cat.reshape(out)


def gather_full(param, value=None, group=None) -> torch.Tensor:
    """The global value of ``param`` (or of ``value``, a tensor laid out
    as ``param``): the ranks' shards gathered over ``group``, the mp group
    by default; a parameter no rank splits comes back as it is."""
    value = param.detach() if value is None else value
    if not getattr(param, "mp_split", False):
        return value
    group = group if group is not None else mp_state()[0]
    shards = []
    _coll.all_gather(shards, value.contiguous(), group)
    return full_of(shards, param.split_axis, param.split_parts)


@torch.no_grad()
def init_global_(param, fill) -> None:
    """``fill`` (an in-place initialiser of a whole tensor) applied to
    the global tensor of ``param``, of which ``param`` keeps its shard:
    a rank draws what a one-process model draws from the same generator
    state, and keeps its part."""
    if not getattr(param, "mp_split", False):
        fill(param)
        return
    full = torch.empty(param.global_shape, dtype=param.dtype,
                       device=param.device)
    fill(full)
    param.copy_(shard_of(full, param.split_axis, param.split_parts,
                         param.split_rank, param.split_degree))


def _divide(n, degree, what):
    if n % degree:
        raise ValueError(f"{what} {n} is not divisible by the model-parallel "
                         f"degree {degree}")
    return n // degree


# ------------------------------------------------------------- the layers
class _Marked:
    """A layer whose parameters carry their split (``shard_param``),
    marked again after every conversion (``to``, ``to_empty`` make new
    parameters)."""

    def _mark(self):
        for name, spec in self._splits.items():
            p = getattr(self, name)
            if p is not None:
                shard_param(p, *spec)

    def _apply(self, fn, *a, **k):
        out = super()._apply(fn, *a, **k)
        self._mark()
        return out


class VocabParallelEmbedding(_Marked, nn.Embedding):
    """Rows ``rank * V / mp ..`` of the ``[V, H]`` table.  Ids outside
    this rank's rows look up zeros; the ranks' lookups are all-reduced.
    ``attend(h)`` is the tied output head: this rank's vocabulary slice
    of the logits (``[.., V / mp]``)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        group, rank, degree = mp_state(mp_group)
        local = _divide(num_embeddings, degree, "num_embeddings")
        super().__init__(local, embedding_dim)
        self.mp_group, self.mp_rank, self.mp_degree = group, rank, degree
        self.vocab_start = rank * local
        self._splits = {"weight": (0, rank, degree,
                                   (num_embeddings, embedding_dim))}
        self._mark()

    def forward(self, x):
        if self.mp_degree == 1:
            return super().forward(x)
        local = x - self.vocab_start
        outside = (local < 0) | (local >= self.num_embeddings)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return reduce_from_mp(out, self.mp_group)

    def attend(self, h):
        return F.linear(copy_to_mp(h, self.mp_group), self.weight)


class ColumnParallelLinear(_Marked, nn.Linear):
    """``y = x W^T + b`` with this rank's rows of W and b (``[out / mp,
    in]``); ``gather_output`` gathers the ranks' outputs on the last dim.
    ``parts``: the output is that many equal blocks (a fused q/k/v), each
    split among the ranks."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, parts=1):
        group, rank, degree = mp_state(mp_group)
        _divide(out_features, parts * degree, "out_features")
        super().__init__(in_features, out_features // degree,
                         bias=has_bias)
        self.mp_group, self.mp_rank, self.mp_degree = group, rank, degree
        self.gather_output = gather_output
        self._splits = {
            "weight": (0, rank, degree, (out_features, in_features), parts),
            "bias": (0, rank, degree, (out_features,), parts)}
        self._mark()

    def forward(self, x):
        y = F.linear(copy_to_mp(x, self.mp_group), self.weight, self.bias)
        return gather_from_mp(y, self.mp_group) if self.gather_output else y


class RowParallelLinear(_Marked, nn.Linear):
    """``y = x W^T + b`` with this rank's columns of W (``[out, in /
    mp]``): the ranks' partial products are all-reduced, then the whole
    bias is added.  Without ``input_is_parallel`` the input is split on
    its last dim first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        group, rank, degree = mp_state(mp_group)
        super().__init__(_divide(in_features, degree, "in_features"),
                         out_features, bias=has_bias)
        self.mp_group, self.mp_rank, self.mp_degree = group, rank, degree
        self.input_is_parallel = input_is_parallel
        self._splits = {"weight": (1, rank, degree,
                                   (out_features, in_features))}
        self._mark()

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_mp(x, self.mp_group)
        y = reduce_from_mp(F.linear(x, self.weight), self.mp_group)
        return y + self.bias if self.bias is not None else y


class _ParallelCE(torch.autograd.Function):
    """Cross-entropy over vocabulary-sharded logits: the max
    (all-reduce MAX), the sum of exponentials and the target logit
    (all-reduce SUM) over the mp group; the backward is local."""

    @staticmethod
    def forward(ctx, logits, label, start, group, ignore_index):
        x = logits.float()
        gmax = x.amax(dim=-1)
        _coll.all_reduce(gmax, _coll.ReduceOp.MAX, group)
        x = x - gmax[..., None]
        e = torch.exp(x)
        sums = e.sum(dim=-1)
        local = label - start
        inside = (local >= 0) & (local < x.shape[-1])
        idx = local.clamp(0, x.shape[-1] - 1)
        target = torch.where(inside, x.gather(-1, idx[..., None])[..., 0],
                             0.0)
        both = torch.stack([sums, target])
        _coll.all_reduce(both, _coll.ReduceOp.SUM, group)
        valid = label != ignore_index
        loss = torch.where(valid, torch.log(both[0]) - both[1], 0.0)
        ctx.save_for_backward(e, both[0], idx, inside & valid, valid)
        return loss

    @staticmethod
    def backward(ctx, g):
        e, sums, idx, hit, valid = ctx.saved_tensors
        grad = e / sums[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -hit.float()[..., None])
        grad = grad * (g * valid.float())[..., None]
        return grad, None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-element cross-entropy (``reduction="none"``, float32) of
    vocabulary-sharded logits ``[.., V / mp]`` against global labels;
    ``ignore_index`` labels give 0.  At degree 1: the plain
    cross-entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group, self.mp_rank, self.mp_degree = mp_state(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        if label.dim() == input.dim() and label.shape[-1] == 1:
            label = label.squeeze(-1)
        label = label.long()
        if self.mp_degree == 1:
            return F.cross_entropy(
                input.float().reshape(-1, input.shape[-1]),
                label.reshape(-1), ignore_index=self.ignore_index,
                reduction="none").reshape(label.shape)
        start = self.mp_rank * input.shape[-1]
        return _ParallelCE.apply(input, label, start, self.mp_group,
                                 self.ignore_index)
