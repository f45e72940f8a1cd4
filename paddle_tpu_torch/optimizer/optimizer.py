"""The optimizers: counterpart of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer`` and SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta,
Adamax, Lamb).

The base :class:`Optimizer` owns its state tensors: param groups, the
learning rate as a float or an ``LRScheduler`` (``optimizer/lr.py``),
weight decay as a float, ``L2Decay`` or ``L1Decay``, float32 master
weights for bfloat16 parameters (``multi_precision``, set by
``amp.decorate`` at O2), ``step``, ``clear_grad`` and ``minimize``, and
``state_dict`` / ``set_state_dict`` with structured keys
(``"gpt.blocks.0.attn.qkv.weight@moment1"``, ``"...@master_weight"``,
``"global_step"``, ``"LR_Scheduler"``; see
``models/convert.py:optimizer_state_from_numpy`` for a JAX run's).

``step()`` first offers the step to the fused path (``optimizer/fused.py``:
Adam, AdamW, SGD and Momentum run on the ``fused_adamw`` kernels, the
JAX package's whole-tree program); the rest, and every step the fused
path declines, runs the rules below, the JAX package's ``rule``
closures written in ``torch`` ops: over the whole list in
``torch._foreach_*`` calls for SGD, Momentum and Adam / AdamW, per
tensor for the rest.  Each rule is pure (new weight and states from old
ones), as the JAX rules are, and the results are copied into the
parameters and states in place.

Parameters are ``model.parameters()``, ``model.named_parameters()`` or
groups (``[{"params": ..., "learning_rate": ratio, "weight_decay": wd}]``).
Names: a parameter's structured name where the caller gave one
(``named_parameters()``), else ``param_<i>`` in order; the JAX package
passes ``Parameter.name`` (a process-wide ``param_<n>``) to
``apply_decay_param_fun`` and keys its state by it, the port uses the
structured name for both (``exclude_from_weight_decay_fn`` of Lamb gets
the name too).
"""

from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb"]

_LOW = (torch.float16, torch.bfloat16)
# elements a slice of the list rules takes at once (see _apply_per_leaf)
_LIST_ELEMS = 1 << 27


def _wd_value(weight_decay) -> float:
    """The L2 coefficient (L1Decay is applied apart, as a sign term)."""
    if weight_decay is None or isinstance(weight_decay, L1Decay):
        return 0.0
    if hasattr(weight_decay, "_coeff"):              # L2Decay
        return float(weight_decay._coeff)
    return float(weight_decay)


def _l1_value(weight_decay) -> float:
    return float(weight_decay._coeff) \
        if isinstance(weight_decay, L1Decay) else 0.0


def _plus_decay(xs, ws, wds):
    """``xs[i] + wds[i] * ws[i]`` where ``wds[i]`` is not 0, else
    ``xs[i]``: the rules' ``if wd: g = g + wd * w`` over lists."""
    idx = [i for i, wd in enumerate(wds) if wd]
    out = list(xs)
    if idx:
        decayed = torch._foreach_add(
            [xs[i] for i in idx],
            torch._foreach_mul([ws[i] for i in idx], [wds[i] for i in idx]))
        for i, t in zip(idx, decayed):
            out[i] = t
    return out


class Optimizer:
    _state_names: List[str] = []
    # the fused kernel's rule for this optimizer (ops/fused_optimizer.py
    # RULES), None where the step always runs the list rules
    _fused_rule: Optional[str] = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError(f"{type(self).__name__}: pass parameters= "
                             "explicitly")
        self._lr = learning_rate
        self._names: Dict[int, str] = {}
        self._param_groups = self._build_groups(parameters)
        self._weight_decay = _wd_value(weight_decay)
        self._l1 = _l1_value(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # accumulator -> parameter name -> tensor
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = \
            defaultdict(dict)
        # the applied-step count: on the host, or (after a fused scaler
        # step, which may skip) newer on the card in _step_dev
        self._gs_host = 0
        self._gs_ahead = False
        self._step_dev: Optional[torch.Tensor] = None
        self._fused_tables: dict = {}
        # the cross-rank sums of a step whose gradients the ranks split
        # (distributed/fleet/norm.py CrossRankNorm), None on one rank
        self._grad_reduce = None

    def _set_grad_reduce(self, reduce) -> None:
        """Make every step reduce its norms and ``found_inf`` with
        ``reduce`` (a ``CrossRankNorm``, or None): the fused step's split
        norm, the clip's ``_global_norm_reduce_fn`` and the GradScaler's
        host path."""
        self._grad_reduce = reduce if reduce else None
        if self._grad_clip is not None:
            self._grad_clip._global_norm_reduce_fn = None \
                if self._grad_reduce is None else \
                self._grad_reduce.per_tensor_sq

    # ------------------------------------------------------------ params
    def _name_params(self, items, offset):
        items = list(items)
        if items and isinstance(items[0], tuple):
            named = [(n, p) for n, p in items]
        else:
            named = [(f"param_{offset + i}", p) for i, p in enumerate(items)]
        for n, p in named:
            self._names[id(p)] = n
        return [p for _, p in named]

    def _build_groups(self, parameters):
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            groups, count = [], 0
            for g in parameters:
                g = dict(g)
                g["params"] = self._name_params(g["params"], count)
                count += len(g["params"])
                groups.append(g)
            return groups
        return [{"params": self._name_params(parameters, 0)}]

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        return [p for g in self._param_groups for p in g["params"]]

    def _param_name(self, p) -> str:
        return self._names[id(p)]

    def _effective_wd(self, p, wd: float) -> float:
        """The per-tensor overrides of the decay (AdamW's
        ``apply_decay_param_fun``, Lamb's ``exclude_from_weight_decay_fn``),
        shared by the fused path and the list rules."""
        return wd

    # -------------------------------------------------------- global step
    @property
    def _global_step(self) -> int:
        if self._gs_ahead:
            # a fused scaler step kept the count on the card (it depends
            # on found_inf): reading it is the sync point
            self._gs_host = int(self._step_dev.item())
            self._gs_ahead = False
        return self._gs_host

    @_global_step.setter
    def _global_step(self, value) -> None:
        self._gs_host = int(value)
        self._gs_ahead = False

    def _device_step(self, device) -> torch.Tensor:
        if self._step_dev is None or self._step_dev.device != device:
            self._step_dev = torch.zeros(1, dtype=torch.int32, device=device)
        return self._step_dev

    # ---------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("set_lr not allowed with an LRScheduler")
        self._lr = float(value)

    # ------------------------------------------------------------- state
    def _use_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW

    def _create_master_weight(self, p) -> torch.Tensor:
        store = self._accumulators["master_weight"]
        name = self._param_name(p)
        if name not in store:
            store[name] = p.detach().float().clone()
        return store[name]

    def _get_state(self, acc: str, p) -> torch.Tensor:
        store = self._accumulators[acc]
        name = self._param_name(p)
        if name not in store:
            store[name] = torch.zeros_like(
                p, dtype=torch.float32 if self._multi_precision else p.dtype,
                memory_format=torch.contiguous_format).detach()
        return store[name]

    # -------------------------------------------------------------- step
    def _collect_work(self):
        """Every group's parameters with a gradient, as mutable ``[param,
        grad, lr ratio, wd, l1]`` lists (the ratio: the group's
        ``learning_rate`` times the parameter's
        ``optimize_attr["learning_rate"]``), and ``(param, grad)`` pairs
        for the clip, which sees all groups at once."""
        work, all_pg = [], []
        for group in self._param_groups:
            ratio = float(group.get("learning_rate", 1.0))
            if "weight_decay" in group:
                wd = _wd_value(group["weight_decay"])
                l1 = _l1_value(group["weight_decay"])
            else:
                wd, l1 = self._weight_decay, self._l1
            for p in group["params"]:
                if p.grad is None or not p.requires_grad:
                    continue
                pr = ratio * float(getattr(p, "optimize_attr", {}).get(
                    "learning_rate", 1.0))
                work.append([p, p.grad, pr, wd, l1])
                all_pg.append((p, p.grad))
        return work, all_pg

    @torch.no_grad()
    def step(self):
        from . import fused as _fused
        self._global_step += 1
        work, all_pg = self._collect_work()
        if not _fused.try_step(self, work):
            self._apply_per_leaf(work, all_pg)

    def _apply_per_leaf(self, work, all_pg):
        """The rule over every tensor (the fused path declined: no kernel
        rule, L1 decay, a custom clip, a 16-bit parameter without a
        master): lists of weights, gradients and states through
        :meth:`_rule_many`, a slice of about ``_LIST_ELEMS`` elements at a
        time, the results copied back in one ``torch._foreach_copy_`` per
        slice.  The clip gives new tensors (``nn/clip.py``), made slice by
        slice beside the update (the global norm's scale once, before the
        first), so ``p.grad`` keeps what backward wrote, as in the JAX
        package, and no clipped copy of every gradient is ever held.  A
        clip with its own ``__call__`` (a subclass) clips the whole list
        at once."""
        from ..nn.clip import ClipGradBase
        clip = self._grad_clip
        sliced = clip is not None and \
            type(clip).__call__ is ClipGradBase.__call__
        prepared = None
        if sliced:
            applicable = [(p, g) for p, g in all_pg if clip._applies(p, g)]
            sliced = bool(applicable)
            if sliced:
                prepared = clip._prepare([g for _, g in applicable],
                                         [p for p, _ in applicable])
        elif clip is not None:
            for item, (_, g) in zip(work, clip(all_pg)):
                item[1] = g
        lr = self.get_lr()
        params, masters, ws, gs, lrs, wds, l1s = [], [], [], [], [], [], []
        states = [[] for _ in self._state_names]
        for p, g, ratio, wd, l1 in work:
            if g is None:
                continue
            master = self._create_master_weight(p) if self._use_master(p) \
                else None
            params.append(p)
            masters.append(master)
            ws.append(master if master is not None else p.detach())
            gs.append(g)
            lrs.append(lr * ratio)
            wds.append(self._effective_wd(p, wd))
            l1s.append(l1)
            for lst, n in zip(states, self._state_names):
                lst.append(self._get_state(n, p))
        step = torch.tensor(float(self._global_step), dtype=torch.float32)
        # slices of about _LIST_ELEMS elements: the clipped gradients and
        # the list ops' temporaries stay small beside the model's tensors
        start = 0
        while start < len(params):
            end, size = start + 1, ws[start].numel()
            while end < len(params) and \
                    size + ws[end].numel() <= _LIST_ELEMS:
                size += ws[end].numel()
                end += 1
            sl = slice(start, end)
            sgs = gs[sl]
            if sliced:
                idx = [i for i, (p, g) in enumerate(zip(params[sl], sgs))
                       if clip._applies(p, g)]
                for i, g in zip(idx, clip._clip_many([sgs[i] for i in idx],
                                                     prepared)):
                    sgs[i] = g
            sgs = [(g + l1 * torch.sign(p.detach().to(g.dtype)) if l1
                    else g).to(w.dtype)
                   for p, g, l1, w in zip(params[sl], sgs, l1s[sl], ws[sl])]
            new_ws, new_states = self._rule_many(
                ws[sl], sgs, [[s.to(w.dtype) for s, w in
                               zip(lst[sl], ws[sl])] for lst in states],
                lrs[sl], wds[sl], step)
            dst = [m for m in masters[sl] if m is not None]
            src = [nw for nw, m in zip(new_ws, masters[sl]) if m is not None]
            dst += [p.detach() for p in params[sl]]
            src += new_ws
            for lst, new in zip(states, new_states):
                dst += lst[sl]
                src += new
            torch._foreach_copy_(dst, src)
            start = end

    def _rule(self, w, g, states, lr, wd, step):
        """``(new_w, new_states)`` from the float weight ``w``, gradient
        ``g``, states, learning rate, decay and the step (a float32
        0-d tensor): the JAX package's ``rule``."""
        raise NotImplementedError

    def _rule_many(self, ws, gs, states, lrs, wds, step):
        """:meth:`_rule` over lists (``states``: one list per state name,
        in ``_state_names`` order), returning ``(new_ws, new_states)`` in
        the same layout.  This one calls ``_rule`` per tensor; SGD,
        Momentum and Adam / AdamW override it with the same operations as
        ``torch._foreach_*`` calls, a few launches for the whole list."""
        outs = [self._rule(w, g, [lst[i] for lst in states], lr, wd, step)
                for i, (w, g, lr, wd) in enumerate(zip(ws, gs, lrs, wds))]
        return [w for w, _ in outs], \
            [[st[k] for _, st in outs] for k in range(len(states))]

    def _fused_hyper(self) -> dict:
        """The fused kernel's hyperparameters for ``_fused_rule``."""
        return {}

    # -------------------------------------------------------------- misc
    def clear_grad(self, set_to_zero: bool = True):
        """Drops every gradient, whatever ``set_to_zero`` says, as the
        JAX package's ``Tensor.clear_grad`` does: the next backward writes
        them anew."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def _known_state_names(self):
        return set(self._state_names) | set(self._accumulators) | \
            {"master_weight"}

    def state_dict(self) -> dict:
        out = {"LR_Scheduler": self._lr.state_dict()
               if isinstance(self._lr, LRScheduler) else {},
               "global_step": self._global_step}
        for acc, store in self._accumulators.items():
            for p in self._parameter_list:
                name = self._param_name(p)
                if name in store:
                    out[f"{name}@{acc}"] = store[name]
        return out

    def set_state_dict(self, state: dict) -> None:
        """Loads a :meth:`state_dict` (or a JAX run's, converted by
        ``models/convert.py:optimizer_state_from_numpy``): the scheduler,
        the step count and every accumulator of a parameter named in it,
        copied in place where one exists."""
        if isinstance(self._lr, LRScheduler) and state.get("LR_Scheduler"):
            self._lr.set_state_dict(state["LR_Scheduler"])
        self._global_step = int(state.get("global_step", 0))
        by_name = {self._param_name(p): p for p in self._parameter_list}
        accs = self._known_state_names()
        for key, v in state.items():
            if key in ("LR_Scheduler", "global_step"):
                continue
            name, _, acc = key.rpartition("@")
            p = by_name.get(name)
            if p is None or acc not in accs:
                warnings.warn(f"optimizer.set_state_dict: unmatched key "
                              f"{key!r}; skipping")
                continue
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{type(self).__name__}.set_state_dict: "
                                 f"{key} {tuple(v.shape)} vs "
                                 f"{tuple(p.shape)}")
            dtype = torch.float32 if acc == "master_weight" or \
                self._multi_precision else p.dtype
            v = torch.as_tensor(v).detach().to(device=p.device, dtype=dtype)
            store = self._accumulators[acc]
            old = store.get(name)
            if old is not None and old.dtype == dtype:
                old.copy_(v)            # keeps the fused tables' pointers
            else:
                store[name] = v.clone(memory_format=torch.contiguous_format)


class SGD(Optimizer):
    _state_names: List[str] = []
    _fused_rule = "sgd"

    def _rule(self, w, g, states, lr, wd, step):
        if wd:
            g = g + wd * w
        return w - lr * g, []

    def _rule_many(self, ws, gs, states, lrs, wds, step):
        gs = _plus_decay(gs, ws, wds)
        return torch._foreach_sub(ws, torch._foreach_mul(gs, lrs)), []


class Momentum(Optimizer):
    _state_names = ["velocity"]
    _fused_rule = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _rule(self, w, g, states, lr, wd, step):
        (v,) = states
        mu = self._momentum
        if wd:
            g = g + wd * w
        v2 = mu * v + g
        if self._nesterov:
            return w - lr * (g + mu * v2), [v2]
        return w - lr * v2, [v2]

    def _rule_many(self, ws, gs, states, lrs, wds, step):
        (vs,) = states
        mu = self._momentum
        gs = _plus_decay(gs, ws, wds)
        v2 = torch._foreach_add(torch._foreach_mul(vs, mu), gs)
        upd = torch._foreach_add(gs, torch._foreach_mul(v2, mu)) \
            if self._nesterov else v2
        return torch._foreach_sub(ws, torch._foreach_mul(upd, lrs)), [v2]

    def _fused_hyper(self):
        return dict(momentum=self._momentum, nesterov=self._nesterov)


class _AdamBase(Optimizer):
    _state_names = ["moment1", "moment2"]
    _fused_rule = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, decoupled: bool = False,
                 apply_decay_param_fun=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._decoupled = decoupled
        self._apply_decay_param_fun = apply_decay_param_fun

    def _effective_wd(self, p, wd):
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._param_name(p)):
            return 0.0
        return wd

    def _rule(self, w, g, states, lr, wd, step):
        m, v = states
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        if wd and not self._decoupled:
            g = g + wd * w
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / (1 - b1 ** step)
        vhat = v2 / (1 - b2 ** step)
        upd = mhat / (torch.sqrt(vhat) + eps)
        if wd and self._decoupled:
            upd = upd + wd * w
        return w - lr * upd, [m2, v2]

    def _rule_many(self, ws, gs, states, lrs, wds, step):
        ms, vs = states
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        if not self._decoupled:
            gs = _plus_decay(gs, ws, wds)
        m2 = torch._foreach_add(torch._foreach_mul(ms, b1),
                                torch._foreach_mul(gs, 1 - b1))
        v2 = torch._foreach_add(
            torch._foreach_mul(vs, b2),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
        # float32 bias corrections, as _rule's (the step is on the host)
        bc1 = (1 - b1 ** step).item()
        bc2 = (1 - b2 ** step).item()
        den = torch._foreach_sqrt(torch._foreach_div(v2, bc2))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(torch._foreach_div(m2, bc1), den)
        if self._decoupled:
            upd = _plus_decay(upd, ws, wds)
        return torch._foreach_sub(ws, torch._foreach_mul(upd, lrs)), [m2, v2]

    def _fused_hyper(self):
        return dict(beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon, decoupled=self._decoupled)


class Adam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, decoupled=False)


class AdamW(_AdamBase):
    """``apply_decay_param_fun(name) -> bool`` picks the parameters that
    decay; it receives a parameter's structured name
    (``gpt.blocks.0.attn.qkv.weight``), so it needs named parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        if apply_decay_param_fun is not None and parameters is not None:
            parameters = list(parameters)
            if parameters and not isinstance(parameters[0], (tuple, dict)):
                raise ValueError(
                    "AdamW: apply_decay_param_fun needs the parameters' "
                    "names: pass model.named_parameters()")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, decoupled=True,
                         apply_decay_param_fun=apply_decay_param_fun)


class Adagrad(Optimizer):
    _state_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = float(epsilon)

    def _rule(self, w, g, states, lr, wd, step):
        (acc,) = states
        if wd:
            g = g + wd * w
        acc2 = acc + torch.square(g)
        return w - lr * g / (torch.sqrt(acc2) + self._epsilon), [acc2]


class RMSProp(Optimizer):
    _state_names = ["mean_square", "mean_grad", "momentum_acc"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), centered

    def _rule(self, w, g, states, lr, wd, step):
        ms, mg, mom = states
        rho, eps = self._rho, self._epsilon
        if wd:
            g = g + wd * w
        ms2 = rho * ms + (1 - rho) * torch.square(g)
        if self._centered:
            mg2 = rho * mg + (1 - rho) * g
            denom = torch.sqrt(ms2 - torch.square(mg2) + eps)
        else:
            mg2 = mg
            denom = torch.sqrt(ms2 + eps)
        mom2 = self._momentum * mom + lr * g / denom
        return w - mom2, [ms2, mg2, mom2]


class Adadelta(Optimizer):
    _state_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = float(rho), float(epsilon)

    def _rule(self, w, g, states, lr, wd, step):
        ag, au = states
        rho, eps = self._rho, self._epsilon
        if wd:
            g = g + wd * w
        ag2 = rho * ag + (1 - rho) * torch.square(g)
        upd = torch.sqrt(au + eps) / torch.sqrt(ag2 + eps) * g
        au2 = rho * au + (1 - rho) * torch.square(upd)
        return w - lr * upd, [ag2, au2]


class Adamax(Optimizer):
    _state_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _rule(self, w, g, states, lr, wd, step):
        m, u = states
        b1, b2 = self._beta1, self._beta2
        if wd:
            g = g + wd * w
        m2 = b1 * m + (1 - b1) * g
        u2 = torch.maximum(b2 * u, torch.abs(g))
        return w - lr / (1 - b1 ** step) * m2 / (u2 + self._epsilon), \
            [m2, u2]


class Lamb(Optimizer):
    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _effective_wd(self, p, wd):
        if self._exclude_fn is not None and \
                self._exclude_fn(self._param_name(p)):
            return 0.0
        return wd

    def _rule(self, w, g, states, lr, wd, step):
        m, v = states
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / (1 - b1 ** step)
        vhat = v2 / (1 - b2 ** step)
        r = mhat / (torch.sqrt(vhat) + eps)
        if wd:
            r = r + wd * w
        w_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return w - lr * trust * r, [m2, v2]
