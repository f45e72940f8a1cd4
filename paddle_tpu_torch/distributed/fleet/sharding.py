"""ZeRO: the sharded optimizer stages.  Counterpart of
``paddle_tpu/distributed/fleet/sharding.py`` (Paddle's
``DygraphShardingOptimizer``, ``GroupShardedOptimizerStage2``,
``GroupShardedStage3``, ``group_sharded_parallel``).

The JAX package lays optimizer state, gradients and (stage 3) parameters
out sharded over its mesh's ``sharding`` axis and lets GSPMD move the
data, on global arrays.  The port is process-granular: the sharding group
is a data-parallel group (each rank takes its slice of the global batch,
gradients are averaged), and a rank OWNS a slice of each parameter along
the first dimension the JAX ``_shard_spec_for`` would shard: the first
dimension of the JAX layout (``[in, out]`` for a linear weight, which
:func:`mark_jax_layout` notes) that the sharding degree divides and that
tensor parallelism does not already split.  A parameter with no such
dimension stays whole on every rank (the JAX rule, with its one warning
per shape).

- Stage 1 (``level="os"``): gradients are all-reduced (averaged); a
  rank's optimizer keeps moments and masters for its owned slices only and
  updates them (the fused step over the owned slices, whose tensors are
  made once, so its table is reused); then the parameters are
  all-gathered.
- Stage 2 (``"os_g"``): as stage 1, with the gradients reduce-scattered
  instead, so a rank keeps only its slices' gradients.
- Stage 3 (``"p_g_os"``, :func:`apply_stage3_param_sharding`): the model
  holds only its slices; each module all-gathers its parameters before
  its forward (and a tied head before ``attend``) and drops them after,
  autograd keeps what the backward needs, and the gathered weights'
  gradients are reduce-scattered (averaged) into the slices.
- ``offload=True``: the owned optimizer state lives in (pinned) host
  memory between steps and is staged to the card for the update.

Wholes the ranks hold alike are all-reduced (averaged).  The step's norms
and ``found_inf`` are summed over the sharding (and mp) groups
(``norm.py``).  Collectives are bucketed: one per type for a stage's
gradients and one for the gather.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .. import collective as _coll
from .norm import CrossRankNorm, split_over

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "group_sharded_parallel", "apply_stage3_param_sharding",
           "mark_jax_layout", "zero_dim", "state_bytes"]

_warned_shapes: set = set()


def mark_jax_layout(model: nn.Module) -> nn.Module:
    """Note on each ``nn.Linear`` weight of ``model`` that the JAX
    package keeps it transposed (``[in, out]``): ZeRO's choice of
    dimension follows the JAX layout."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight._jax_transposed = True
    return model


def zero_dim(p, degree: int):
    """The dimension of ``p`` (the port's layout) that ZeRO splits over
    ``degree`` ranks, or None to keep it whole: the JAX
    ``_shard_spec_for`` on the JAX layout of the global tensor."""
    if degree <= 1 or p.dim() == 0:
        return None
    shape = tuple(getattr(p, "global_shape", None) or p.shape)
    flip = getattr(p, "_jax_transposed", False) and len(shape) == 2
    taken = p.split_axis if getattr(p, "mp_split", False) else None
    if flip:
        shape = shape[::-1]
        taken = None if taken is None else 1 - taken
    for dim, sz in enumerate(shape):
        if dim != taken and sz >= degree and sz % degree == 0:
            return len(shape) - 1 - dim if flip else dim
    key = (shape, degree)
    if key not in _warned_shapes:
        _warned_shapes.add(key)
        warnings.warn(
            f"ZeRO sharding: no free dim of shape {shape} is divisible by "
            f"the sharding degree {degree}; this tensor stays whole")
    return None


def _slice(t, dim, rank, degree):
    k = t.shape[dim] // degree
    return t.narrow(dim, rank * k, k)


def _resolve_group(group):
    """A ``Group``, or None: the topology's sharding group under
    ``fleet.init``, else every rank (Paddle's default)."""
    if group is not None:
        return group
    from .fleet import _fleet_state
    hcg = _fleet_state["hcg"]
    if hcg is not None:
        return hcg.get_sharding_parallel_group()
    return _coll.get_group()


def _mp_group():
    from .fleet import _fleet_state
    hcg = _fleet_state["hcg"]
    return None if hcg is None else hcg.get_model_parallel_group()


def _copy_attrs(dst, src):
    for a in ("need_clip", "optimize_attr", "_jax_transposed"):
        if hasattr(src, a):
            setattr(dst, a, getattr(src, a))


@torch.no_grad()
def _avg_all_reduce(tensors, group):
    """Average ``tensors`` over ``group`` in place, one all-reduce per
    type."""
    by_type = {}
    for t in tensors:
        by_type.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_type.values():
        flat = _flatten_dense_tensors(ts)
        _coll.all_reduce(flat, _coll.ReduceOp.AVG, group)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


@torch.no_grad()
def _avg_reduce_scatter(fulls, dims, group):
    """This rank's averaged slices of ``fulls`` (split on ``dims``), one
    reduce-scatter per type."""
    n, out = group.nranks, [None] * len(fulls)
    by_type = {}
    for i, t in enumerate(fulls):
        by_type.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_type.values():
        rows = [fulls[i].movedim(dims[i], 0).reshape(n, -1) for i in idx]
        flat = torch.cat(rows, dim=1)
        tile = torch.empty((1, flat.shape[1]), dtype=flat.dtype,
                           device=flat.device)
        _coll.reduce_scatter(tile, flat, _coll.ReduceOp.AVG, group)
        off = 0
        for i, r in zip(idx, rows):
            shape = list(fulls[i].movedim(dims[i], 0).shape)
            shape[0] //= n
            part = tile[0, off:off + r.shape[1]].reshape(shape)
            out[i] = part.movedim(0, dims[i]).contiguous()
            off += r.shape[1]
    return out


@torch.no_grad()
def _gather_into(pairs, group):
    """For each ``(param, shard, dim)``: the ranks' shards gathered on
    ``dim`` into ``param``, one all-gather per type."""
    n = group.nranks
    by_type = {}
    for p, s, d in pairs:
        by_type.setdefault((s.dtype, s.device), []).append((p, s, d))
    for items in by_type.values():
        flat = torch.cat([s.detach().reshape(-1) for _, s, _ in items])
        every = _coll.all_gather_concat(flat, 0, group).view(n, -1)
        off = 0
        for p, s, d in items:
            parts = every[:, off:off + s.numel()].reshape(n, *s.shape)
            p.data.copy_(torch.cat(parts.unbind(0), dim=d))
            off += s.numel()


def state_bytes(optimizer) -> int:
    """Bytes of an optimizer's accumulators (moments, masters, ...) held
    on the card or host."""
    inner = getattr(optimizer, "_inner", optimizer)
    inner = getattr(inner, "_inner_opt", inner)
    return sum(t.numel() * t.element_size()
               for store in inner._accumulators.values()
               for t in store.values() if isinstance(t, torch.Tensor))


class DygraphShardingOptimizer:
    """ZeRO stages 1 and 2 (and the optimizer side of stage 3) around
    ``optimizer``: see the module's head."""

    def __init__(self, optimizer, hcg=None, stage: int = 1,
                 offload: bool = False, group=None):
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage {stage}: 1, 2 or 3")
        self._inner = optimizer
        self._hcg = hcg
        self._stage = stage
        self._offload = offload
        self._group = _resolve_group(
            group if group is not None or hcg is None
            else hcg.get_sharding_parallel_group())
        n, r = self._group.nranks, max(self._group.rank, 0)
        # (param, the tensor the inner optimizer steps, its ZeRO dim)
        self._entries = []
        for g in optimizer._param_groups:
            owned = []
            for p in g["params"]:
                s, dim = self._owned(p, n, r)
                if s is not p:
                    optimizer._names[id(s)] = optimizer._names[id(p)]
                if dim is not None and hasattr(s, "_zero3_dim"):
                    p = s            # the model holds the slice itself
                self._entries.append((p, s, dim))
                owned.append(s)
            g["params"] = owned
        optimizer._fused_tables.clear()
        mp = hcg.get_model_parallel_group() if hcg is not None \
            else _mp_group()
        optimizer._set_grad_reduce(CrossRankNorm(
            {"mp": mp, "sharding": self._group}))
        self._host = {}              # offload: (acc, name) -> host tensor
        self._synced = False         # this step's gradients reduced

    def _owned(self, p, n, r):
        shard = getattr(p, "_zero3_shard", None)
        if shard is not None:                    # stage 3's own slice
            return shard, shard._zero3_dim
        dim = zero_dim(p, n)
        if dim is None:
            return p, None
        s = nn.Parameter(_slice(p.detach(), dim, r, n).clone(),
                         requires_grad=p.requires_grad)
        _copy_attrs(s, p)
        s._split_over = split_over(p) | {"sharding"}
        return s, dim

    # ------------------------------------------------------ communication
    def _sync_grads(self) -> None:
        """Gradients to the owned tensors: averaged over the group (once
        a step: a GradScaler's ``unscale_`` runs it first)."""
        if self._synced:
            return
        self._synced = True
        g = self._group
        whole = [p.grad for p, s, d in self._entries
                 if d is None and p.grad is not None]
        _avg_all_reduce(whole, g)
        # (stage 3's slices got theirs from autograd's reduce-scatter)
        split = [(p, s, d) for p, s, d in self._entries
                 if s is not p and p.grad is not None]
        if not split:
            return
        n, r = g.nranks, max(g.rank, 0)
        if self._stage == 1:
            _avg_all_reduce([p.grad for p, _, _ in split], g)
            for p, s, d in split:
                s.grad = _slice(p.grad, d, r, n).contiguous()
        else:
            tiles = _avg_reduce_scatter([p.grad for p, _, _ in split],
                                        [d for _, _, d in split], g)
            for (p, s, _), t in zip(split, tiles):
                s.grad = t
                p.grad = None

    def _gather(self) -> None:
        _gather_into([(p, s, d) for p, s, d in self._entries
                      if s is not p], self._group)

    def _stage_state(self, to_card: bool) -> None:
        """Offload: the owned state onto the card for the update, or back
        into host memory after it."""
        if not self._offload:
            return
        for acc, store in self._inner._accumulators.items():
            for name, t in store.items():
                if not isinstance(t, torch.Tensor):
                    continue
                key = (acc, name)
                if to_card:
                    host = self._host.get(key)
                    if host is not None:
                        store[name] = host.to(self._device, non_blocking=True)
                elif t.device.type != "cpu":
                    host = self._host.get(key)
                    if host is None:
                        host = self._host[key] = torch.empty(
                            t.shape, dtype=t.dtype,
                            pin_memory=torch.cuda.is_available())
                    host.copy_(t)
                    store[name] = host
                else:                      # the CPU: nothing to move
                    self._host[key] = t

    @property
    def _device(self):
        return self._entries[0][1].device

    # --------------------------------------------------------------- step
    def _run(self, update) -> None:
        self._sync_grads()
        self._stage_state(True)
        update()
        self._stage_state(False)
        if self._stage < 3:
            self._gather()
        self._synced = False

    _before_unscale = _sync_grads

    def step(self):
        self._run(self._inner.step)

    def _scaler_step(self, scaler):
        self._run(lambda: scaler._step(self._inner))

    def clear_grad(self, set_to_zero: bool = True):
        self._inner.clear_grad(set_to_zero)
        for p, _, _ in self._entries:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def __getattr__(self, name):
        return getattr(self._inner, name)


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Paddle's ``group_sharded_optimizer_stage2.py``: ``params`` must be
    parameters of the optimizer (the reference asserts the same)."""

    def __init__(self, params, optim, group=None, offload=False, **kwargs):
        opt_params = {id(p) for p in optim._parameter_list}
        missing = [p for p in (params or []) if id(p) not in opt_params]
        if missing:
            raise ValueError(
                f"{len(missing)} params passed to "
                "GroupShardedOptimizerStage2 are not held by the inner "
                "optimizer")
        super().__init__(optim, stage=2, offload=offload, group=group)


# ------------------------------------------------------------- stage 3
class _GatherParam(torch.autograd.Function):
    """The ranks' slices gathered on ``dim`` forward; the gradient
    reduce-scattered (averaged) back to the slice."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return _coll.all_gather_concat(shard.detach().contiguous(), dim,
                                       group)

    @staticmethod
    def backward(ctx, g):
        return _avg_reduce_scatter([g.contiguous()], [ctx.dim],
                                   ctx.group)[0], None, None


def _stage3_hooks(module, names, group):
    saved = {}

    def gather(mod, args=None):
        for name in names:
            shard = mod._parameters[name]
            saved[name] = shard
            mod._parameters[name] = _GatherParam.apply(
                shard, shard._zero3_dim, group)

    def release(mod, args=None, out=None):
        for name in names:
            mod._parameters[name] = saved.pop(name)

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(release)
    attend = getattr(module, "attend", None)
    if attend is not None:         # a tied head reads the weight outside

        def gathered_attend(*a, **k):
            gather(module)
            try:
                return attend(*a, **k)
            finally:
                release(module)
        module.attend = gathered_attend


def apply_stage3_param_sharding(layer, group=None):
    """ZeRO-3: every parameter of ``layer`` that has a ZeRO dimension is
    replaced by this rank's slice (gathered on use, see the module's
    head).  The old parameter keeps ``_zero3_shard``, so an optimizer
    built on it steps the slice."""
    group = _resolve_group(group)
    n, r = group.nranks, max(group.rank, 0)
    if n <= 1:
        return layer
    mark_jax_layout(layer)
    for module in layer.modules():
        names = []
        for name, p in list(module._parameters.items()):
            if p is None or hasattr(p, "_zero3_dim"):
                continue
            dim = zero_dim(p, n)
            if dim is None:
                continue
            shard = nn.Parameter(_slice(p.detach(), dim, r, n).clone(),
                                 requires_grad=p.requires_grad)
            _copy_attrs(shard, p)
            for a in ("mp_split", "split_axis", "split_parts",
                      "split_rank", "split_degree", "global_shape"):
                if hasattr(p, a):
                    setattr(shard, a, getattr(p, a))
            shard._zero3_dim = dim
            shard._zero3_group = group
            shard._zero3_full = tuple(p.shape)
            shard._split_over = split_over(p) | {"sharding"}
            p._zero3_shard = shard
            p.data = p.data.new_empty(0)       # the whole goes
            module._parameters[name] = shard
            names.append(name)
        if names:
            _stage3_hooks(module, names, group)
    return layer


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """``paddle.distributed.sharding.group_sharded_parallel``: level
    ``"os"`` (stage 1), ``"os_g"`` (stage 2) or ``"p_g_os"`` (stage 3).
    Returns ``(model, optimizer, scaler)``."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}[level]
    mark_jax_layout(model)
    if stage == 3:
        apply_stage3_param_sharding(model, group=group)
    opt = DygraphShardingOptimizer(optimizer, stage=stage, offload=offload,
                                   group=group)
    return model, opt, scaler
