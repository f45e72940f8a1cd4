"""The fused optimizer step: the ``fused_adamw`` CUDA kernel pair, its plain
PyTorch version, and the table that describes the tensors to it.

No Pallas kernel stands behind it.  The JAX package runs the whole
optimizer step as one XLA program over the parameter tree
(``paddle_tpu/optimizer/fused.py``, ``_build_program``): AMP unscale, the
``found_inf`` reduction, gradient clipping, the update with a skip on
overflow, and the GradScaler's bookkeeping, with no host sync.  The port
runs the same step as two launches of ``paddle_tpu_torch/csrc/
fused_adamw.cu`` over every tensor (see the head of that file):

1. ``fused_norm_kernel``: per chunk of 64 Ki elements the sum of squares
   of the unscaled gradient and a non-finite flag; the last block reduces
   them to the clip coefficients, ``found_inf``, the applied-step count
   and the scaler's scale, good, bad and skip counts, all in device
   memory;
2. ``fused_update_kernel``: unscale, clip, and the rule (Adam / AdamW with
   bias correction on the applied-step count, SGD, Momentum) on float32
   weights (O1) or float32 masters with their bfloat16 or float16 copies
   (O2); it skips the rule when ``found_inf`` is set.  With a scaler it
   writes each unscaled gradient back over the gradient, applied step or
   skipped, as the JAX program returns the unscaled gradients into
   ``p.grad`` (``paddle_tpu/optimizer/fused.py:399-401``).

A third, tiny launch writes the step's gradient addresses into the
device table from its kernel arguments, so nothing is copied from the
host and the step never waits for the card.

Split norm (``reduce=``: tensor parallelism and ZeRO, where each rank
holds a part of the gradients).  Launch 1 then stops at this rank's part,
per tensor its sum of squares times its norm weight (``norm_weights``: 1
for a tensor the ranks split, ``1 / copies`` for one that ``copies``
ranks hold alike) and the non-finite flag, in a float64 vector on the
card; ``reduce`` sums that vector over the ranks' groups (one all-reduce
a group), and ``fused_finish_kernel`` makes the coefficients,
``found_inf`` and the scaler's bookkeeping from the sums, as the last
block of launch 1 does otherwise.  So every rank clips by the global norm
and skips together.  Without ``reduce`` the step is the two launches
above, unchanged.

:class:`FusedTable` holds what does not change from step to step (the
parameters, masters and states, per tensor its weight decay, learning
rate ratio and ``need_clip``; on the card the table and the workspace).
:func:`fused_adamw` runs one step: the kernels for CUDA tensors,
:func:`fused_adamw_reference` (the same two phases in ``torch`` ops) for
CPU tensors.  A CUDA table launches the kernels or raises; nothing falls
back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build
from ._build import KernelTypeError, KernelValueError

__all__ = ["FusedTable", "ScalerConfig", "fused_adamw",
           "fused_adamw_reference", "table_bytes", "CHUNK", "RULES",
           "CLIP_KINDS"]

CHUNK = 1 << 16          # elements a block of either launch takes
RULES = {"adam": 0, "sgd": 1, "momentum": 2}
CLIP_KINDS = {None: 0, "global": 1, "norm": 2, "value": 3}
_DESC_WORDS = 8
_P_BF16, _G_BF16, _NEED_CLIP, _ALIGNED, _P_F16, _G_F16 = 1, 2, 4, 8, 16, 32
# the 16-bit parameter types a float32 master may carry (O2)
_LOW = (torch.bfloat16, torch.float16)
_TYPE_FLAGS = {torch.float32: 0, torch.bfloat16: _P_BF16 | _G_BF16,
               torch.float16: _P_F16 | _G_F16}


class ScalerConfig(NamedTuple):
    """A GradScaler's dynamic-scaling rule (``GradScaler.update()``)."""
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    incr_every: int = 2000
    decr_every: int = 1
    dynamic: bool = True


def _float_bits(x: float) -> int:
    return int(np.array([x], np.float32).view(np.uint32)[0])


class FusedTable:
    """What a fused step reads besides the gradients, for one parameter
    list.

    ``params``: the parameters (float32; or bfloat16 or float16 with a
    float32 ``masters`` entry, O2).  ``states``: per parameter the two state
    tensors in the rule's order (Adam: moment1, moment2; Momentum:
    velocity, None; SGD: None, None), float32, shaped like the parameter.
    ``wds``, ``lr_ratios``, ``need_clip``: per parameter its weight decay
    (0 where it does not decay), its learning rate over the optimizer's,
    and whether the clip applies.  ``norm_weights``: per parameter the
    weight of its sum of squares in a split norm (None: all 1).  All
    tensors on one device, contiguous.

    On the card it owns, besides the table: ``gptr`` (the step's gradient
    addresses), ``partials`` (a float per chunk), ``coef`` (a clip
    coefficient per tensor), ``wsf`` (the inverse scale used, the learning
    rate) and ``wsi`` (the ticket, the non-finite accumulator, found_inf).
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 masters: Sequence[Optional[torch.Tensor]],
                 states: Sequence[Sequence[Optional[torch.Tensor]]],
                 wds: Sequence[float], lr_ratios: Sequence[float],
                 need_clip: Sequence[bool],
                 norm_weights: Optional[Sequence[float]] = None):
        n = len(params)
        norm_weights = [1.0] * n if norm_weights is None else norm_weights
        if n == 0 or not (n == len(masters) == len(states) == len(wds)
                          == len(lr_ratios) == len(need_clip)
                          == len(norm_weights)):
            raise KernelValueError("fused_adamw: one entry per parameter, "
                                   "and at least one parameter")
        self.params = list(params)
        self.masters = list(masters)
        self.states = [list(s) for s in states]
        self.wds = [float(w) for w in wds]
        self.lr_ratios = [float(r) for r in lr_ratios]
        self.need_clip = [bool(c) for c in need_clip]
        self.norm_weights = [float(w) for w in norm_weights]
        if any(not 0.0 < w <= 1.0 for w in self.norm_weights):
            raise KernelValueError("fused_adamw: norm weights in (0, 1]")
        self.device = self.params[0].device
        for p, mw, st in zip(self.params, self.masters, self.states):
            for t in (p, mw, *st):
                if t is None:
                    continue
                if t.device != self.device:
                    raise KernelValueError(
                        f"fused_adamw: tensors on {t.device} and "
                        f"{self.device}")
                if not t.is_contiguous():
                    raise KernelValueError(
                        "fused_adamw: tensors must be contiguous")
                if t.shape != p.shape:
                    raise KernelValueError(
                        f"fused_adamw: state {tuple(t.shape)} for a "
                        f"parameter {tuple(p.shape)}")
            if mw is None and p.dtype != torch.float32:
                raise KernelTypeError(
                    f"fused_adamw: a {p.dtype} parameter needs a float32 "
                    "master (multi_precision)")
            if mw is not None and (p.dtype not in _LOW
                                   or mw.dtype != torch.float32):
                raise KernelTypeError(
                    "fused_adamw: masters are float32 copies of bfloat16 "
                    f"or float16 parameters, got {mw.dtype} for {p.dtype}")
            for s in st:
                if s is not None and s.dtype != torch.float32:
                    raise KernelTypeError(
                        f"fused_adamw: states are float32, got {s.dtype}")
        self.numels = [p.numel() for p in self.params]
        self.chunks = [max(1, -(-k // CHUNK)) for k in self.numels]
        self.chunk_begin = np.concatenate(
            [[0], np.cumsum(self.chunks)[:-1]]).astype(np.int64)
        self.n_chunks = int(sum(self.chunks))
        dev = self.device
        self.coef = torch.ones(n, dtype=torch.float32, device=dev)
        self.wsf = torch.zeros(2, dtype=torch.float32, device=dev)
        self.wsi = torch.zeros(3, dtype=torch.int32, device=dev)
        if dev.type == "cpu":
            return
        self.desc = torch.empty(n * _DESC_WORDS, dtype=torch.int64,
                                device=dev)
        self.gptr = torch.zeros(n, dtype=torch.int64, device=dev)
        self.partials = torch.zeros(self.n_chunks, dtype=torch.float32,
                                    device=dev)
        # the split norm's per-tensor sums and flag (made at first use)
        self.tsum = None
        words = np.zeros((n, _DESC_WORDS), np.int64)
        for i, (p, mw, st) in enumerate(zip(self.params, self.masters,
                                            self.states)):
            ptrs = [p.data_ptr()] + [0 if s is None else s.data_ptr()
                                     for s in (st + [None, None])[:2]]
            ptrs.append(0 if mw is None else mw.data_ptr())
            # a gradient has its parameter's type (autograd's rule)
            # the norm weight rides in the flags word's high half
            flags = _TYPE_FLAGS[p.dtype] | \
                (_NEED_CLIP if self.need_clip[i] else 0) | \
                (_ALIGNED if all(a % 16 == 0 for a in ptrs) else 0) | \
                (_float_bits(self.norm_weights[i]) << 32)
            hyper = _float_bits(self.wds[i]) | \
                (_float_bits(self.lr_ratios[i]) << 32)
            words[i] = ptrs + [self.numels[i], self.chunk_begin[i],
                               np.uint64(hyper).view(np.int64), flags]
        _upload(self.desc, words.reshape(-1))

    def n_tensors(self) -> int:
        return len(self.params)


def _upload(dst: torch.Tensor, words: np.ndarray) -> None:
    """Write int64 ``words`` into ``dst`` on the card through kernel
    arguments (``ptt_fused_table_upload``): no host-to-device copy."""
    words = np.ascontiguousarray(words, dtype=np.int64)
    err = _build.library().ptt_fused_table_upload(
        dst.data_ptr(), words.ctypes.data, int(words.size),
        _build.stream(dst.device))
    _build.check(err, "fused_adamw (table upload)")


def _check_grads(table: FusedTable, grads) -> None:
    if len(grads) != table.n_tensors():
        raise KernelValueError(f"fused_adamw: {len(grads)} gradients for "
                               f"{table.n_tensors()} parameters")
    for p, g in zip(table.params, grads):
        if g.device != table.device:
            raise KernelValueError(f"fused_adamw: a gradient on {g.device}, "
                                   f"the table on {table.device}")
        if g.shape != p.shape or not g.is_contiguous():
            raise KernelValueError(
                f"fused_adamw: gradient {tuple(g.shape)} for a parameter "
                f"{tuple(p.shape)}, or not contiguous")
        if g.dtype != p.dtype:
            raise KernelTypeError(f"fused_adamw: a {g.dtype} gradient for a "
                                  f"{p.dtype} parameter")


def _clip_args(clip):
    """(kind code, clip norm, lo, hi) of ``clip``: None, ("global", c),
    ("norm", c) or ("value", lo, hi)."""
    if clip is None:
        return 0, 0.0, 0.0, 0.0
    kind = clip[0]
    if kind not in ("global", "norm", "value"):
        raise KernelValueError(f"fused_adamw: clip kind {kind!r}")
    if kind == "value":
        return 3, 0.0, float(clip[1]), float(clip[2])
    return CLIP_KINDS[kind], float(clip[1]), 0.0, 0.0


def fused_adamw(table: FusedTable, grads: Sequence[torch.Tensor], lr: float,
                step: torch.Tensor, *, rule: str = "adam",
                beta1: float = 0.9, beta2: float = 0.999,
                epsilon: float = 1e-8, decoupled: bool = True,
                momentum: float = 0.0, nesterov: bool = False, clip=None,
                scaler=None, reduce=None) -> None:
    """One optimizer step over ``table`` with ``grads`` (one per parameter,
    of its type), in place.

    ``step``: int32 ``[1]``, the applied-step count, +1 unless the step is
    skipped; Adam's bias correction reads it after that.  ``clip``: None,
    ``("global", c)`` (ClipGradByGlobalNorm), ``("norm", c)``
    (ClipGradByNorm) or ``("value", lo, hi)`` (ClipGradByValue), on the
    tensors with ``need_clip``.  ``scaler``: None or ``(scale, counts,
    ScalerConfig)``, ``scale`` float32 ``[1]`` and ``counts`` int32
    ``[4]`` (found_inf, good, bad, skips) updated as ``GradScaler``
    does; the gradients are unscaled by ``1 / scale`` first, the step is
    skipped if any is not finite, and every gradient is overwritten IN
    PLACE with its unscaled value (applied or skipped; the JAX program's
    unscaled gradients in ``p.grad``).  Nothing is read back to the
    host.  ``reduce``: None, or a callable that sums a float64 tensor over
    the ranks that share the step, in place (the split norm, see the head
    of this module); it runs only where the step has a norm or a scaler.

    CUDA tensors launch the kernels; CPU tensors take
    :func:`fused_adamw_reference`."""
    if rule not in RULES:
        raise KernelValueError(f"fused_adamw: rule {rule!r}")
    kind, cn, lo, hi = _clip_args(clip)
    if table.device.type == "cpu":
        return fused_adamw_reference(
            table, grads, lr, step, rule=rule, beta1=beta1, beta2=beta2,
            epsilon=epsilon, decoupled=decoupled, momentum=momentum,
            nesterov=nesterov, clip=clip, scaler=scaler, reduce=reduce)
    _check_grads(table, grads)
    for t in (step, *(() if scaler is None else scaler[:2])):
        if t.device != table.device or not t.is_contiguous():
            raise KernelValueError("fused_adamw: step and scaler state on "
                                   "the table's device, contiguous")
    if step.dtype != torch.int32 or (scaler is not None and (
            scaler[0].dtype != torch.float32
            or scaler[1].dtype != torch.int32)):
        raise KernelTypeError("fused_adamw: step int32, scale float32, "
                              "counts int32")
    lib = _build.library()
    stream = _build.stream(table.device)
    n = table.n_tensors()
    _upload(table.gptr, np.array([g.data_ptr() for g in grads], np.int64))
    table.wsf[1:2].fill_(lr)
    if scaler is None:
        sc_f = sc_i = None
        cfg = ScalerConfig()
    else:
        sc_f, sc_i, cfg = scaler[0].data_ptr(), scaler[1].data_ptr(), \
            scaler[2]
    scan = int(scaler is not None or kind in (1, 2))
    split = reduce is not None and scan
    if split and table.tsum is None:
        table.tsum = torch.zeros(n + 1, dtype=torch.float64,
                                 device=table.device)
    rule_args = (int(cfg.dynamic), float(cfg.incr_ratio),
                 float(cfg.decr_ratio), int(cfg.incr_every),
                 int(cfg.decr_every))
    err = lib.ptt_fused_norm(
        table.desc.data_ptr(), table.gptr.data_ptr(), n, table.n_chunks,
        CHUNK, table.partials.data_ptr(), table.coef.data_ptr(),
        table.wsf.data_ptr(), table.wsi.data_ptr(), step.data_ptr(), sc_f,
        sc_i, table.tsum.data_ptr() if split else None, kind, cn, scan,
        *rule_args, stream)
    _build.check(err, "fused_adamw (norm)")
    if split:
        reduce(table.tsum)
        err = lib.ptt_fused_finish(
            table.desc.data_ptr(), n, table.tsum.data_ptr(),
            table.coef.data_ptr(), table.wsf.data_ptr(),
            table.wsi.data_ptr(), step.data_ptr(), sc_f, sc_i, kind, cn,
            *rule_args, stream)
        _build.check(err, "fused_adamw (finish)")
    err = lib.ptt_fused_update(
        table.desc.data_ptr(), table.gptr.data_ptr(), n, table.n_chunks,
        CHUNK, table.coef.data_ptr(), table.wsf.data_ptr(),
        table.wsi.data_ptr(), step.data_ptr(), RULES[rule], int(decoupled),
        int(nesterov), float(beta1), float(beta2), float(epsilon),
        float(momentum), kind, lo, hi, int(scaler is not None), stream)
    _build.check(err, "fused_adamw (update)")
    fused_adamw.launches += 1


fused_adamw.launches = 0


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float() if dtype != torch.float32 else x


@torch.no_grad()
def fused_adamw_reference(table: FusedTable, grads, lr: float,
                          step: torch.Tensor, *, rule: str = "adam",
                          beta1: float = 0.9, beta2: float = 0.999,
                          epsilon: float = 1e-8, decoupled: bool = True,
                          momentum: float = 0.0, nesterov: bool = False,
                          clip=None, scaler=None,
                          coef: Optional[torch.Tensor] = None,
                          reduce=None) -> None:
    """The plain version of :func:`fused_adamw`: the kernels' two phases
    in ``torch`` ops, on any device, with the same roundings (a bfloat16
    or float16 gradient is rounded to its type after the unscale and after
    the global-norm clip, as the JAX program does), and with a scaler the
    same write of the unscaled gradients over ``grads``.

    ``coef``: clip coefficients (one per parameter) for phase 2 to use
    instead of phase 1's, which still go to ``table.coef``.  A check of
    the kernels passes theirs, so that it can hold phase 2 alone to a
    tight limit: the two versions sum the norms in other orders, and a
    coefficient one float32 ulp apart may round a clipped bfloat16
    gradient to its neighbour.  ``reduce``: the split norm, as
    :func:`fused_adamw`'s (per-tensor weighted sums and the flag in a
    float64 vector, reduced, then the coefficients and ``found_inf`` from
    the sums)."""
    if rule not in RULES:
        raise KernelValueError(f"fused_adamw: rule {rule!r}")
    kind, cn, lo, hi = _clip_args(clip)
    coef_in = None if coef is None else coef.clone()
    gdt = [g.dtype for g in grads]
    # phase 1: unscale, found_inf, the clip coefficients, the bookkeeping
    if scaler is not None:
        inv = 1.0 / scaler[0].float()
        us = []
        for g in grads:
            inv_g = _round_to(inv, g.dtype)
            us.append(_round_to(g.float() * inv_g, g.dtype))
        found = torch.stack([~torch.isfinite(u).all() for u in us]).any()
    else:
        inv = torch.ones(1, dtype=torch.float32, device=table.device)
        us = [g.float() for g in grads]
        found = torch.zeros((), dtype=torch.bool, device=table.device)
    sq = [torch.sum(u * u, dtype=torch.float64) for u in us]
    coef = torch.ones(len(us), dtype=torch.float32, device=table.device)
    if reduce is not None and (scaler is not None or kind in (1, 2)):
        vec = torch.stack([s * w if c else torch.zeros_like(s) for s, w, c
                           in zip(sq, table.norm_weights, table.need_clip)]
                          + [found.double()])
        reduce(vec)
        sq = list(vec[:-1].unbind())
        if scaler is not None:
            found = vec[-1] > 0
    if kind == 1:
        total = sum(s for s, c in zip(sq, table.need_clip) if c)
        norm = torch.sqrt(torch.as_tensor(total, dtype=torch.float64)
                          .float())
        cg = cn / torch.clamp(norm, min=cn)
        coef = torch.where(torch.tensor(table.need_clip,
                                        device=table.device), cg, coef)
    elif kind == 2:
        for i, (s, c) in enumerate(zip(sq, table.need_clip)):
            norm = torch.sqrt(s.float())
            if c and norm > cn:
                coef[i] = cn / torch.clamp(norm, min=1e-12)
    table.coef.copy_(coef)
    if coef_in is not None:
        coef = coef_in.to(device=table.device, dtype=torch.float32)
    table.wsf[0] = inv.reshape(())
    table.wsf[1] = lr
    table.wsi[2] = found.int()
    step += (~found).int()
    if scaler is not None:
        _scaler_update(scaler, found)
        for g, u in zip(grads, us):
            g.copy_(u)              # the unscaled gradient, in g's type
    if bool(found):
        return
    # phase 2: the update
    t = step.float()
    bc1 = 1.0 - torch.tensor(beta1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(beta2, dtype=torch.float32) ** t
    lr32 = table.wsf[1]
    for i, (p, mw, (m, v)) in enumerate(zip(table.params, table.masters,
                                            table.states)):
        u = us[i]
        if table.need_clip[i]:
            if kind == 1:
                u = _round_to(u * coef[i], gdt[i])
            elif kind == 2:
                u = u * coef[i]
            elif kind == 3:
                u = torch.clamp(u, lo, hi)
        w = mw if mw is not None else p
        w32 = w.float()
        wd = table.wds[i]
        lr_i = lr32 * table.lr_ratios[i]
        if rule == "adam":
            if wd and not decoupled:
                u = u + wd * w32
            m.copy_(beta1 * m + (1 - beta1) * u)
            v.copy_(beta2 * v + (1 - beta2) * (u * u))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + epsilon)
            if wd and decoupled:
                upd = upd + wd * w32
            new = w32 - lr_i * upd
        else:
            if wd:
                u = u + wd * w32
            if rule == "sgd":
                new = w32 - lr_i * u
            else:
                v2 = momentum * m + u
                new = w32 - lr_i * (u + momentum * v2 if nesterov else v2)
                m.copy_(v2)
        if mw is not None:
            mw.copy_(new)
        p.copy_(new.to(p.dtype))


def _scaler_update(scaler, found: torch.Tensor) -> None:
    """``GradScaler.update()`` on the device scalars, as the JAX program
    replays it: scale, good and bad counts, the skip count."""
    scale, counts, cfg = scaler
    good, bad = counts[1], counts[2]
    if cfg.dynamic:
        bad1, good1 = bad + 1, good + 1
        dec, inc = bad1 >= cfg.decr_every, good1 >= cfg.incr_every
        new_scale = torch.where(
            found,
            torch.where(dec, torch.clamp(scale * cfg.decr_ratio, min=1.0),
                        scale),
            torch.where(inc, scale * cfg.incr_ratio, scale))
        new_good = torch.where(found, 0, torch.where(inc, 0, good1))
        new_bad = torch.where(found, torch.where(dec, 0, bad1), 0)
        scale.copy_(new_scale)
        counts[1] = new_good
        counts[2] = new_bad
    counts[0] = found.int()
    counts[3] += found.int()


def table_bytes(table: FusedTable, grads: Sequence[torch.Tensor],
                clip=None, scaler=None) -> int:
    """The bytes one applied fused step must move: launch 1 reads each
    gradient once (when it scans them), launch 2 reads p (or the master),
    g and the states and writes them back (the master's 16-bit copy too),
    and with a scaler writes the unscaled gradient back over g."""
    kind = _clip_args(clip)[0]
    scan = scaler is not None or kind in (1, 2)
    total = 0
    for p, mw, st, g in zip(table.params, table.masters, table.states,
                            grads):
        n = p.numel()
        gb = g.element_size() * n
        states = sum(4 * n for s in st if s is not None)
        w = 4 * n
        total += (gb if scan else 0) + gb + 2 * (w + states) + \
            (gb if scaler is not None else 0)
        if mw is not None:
            total += p.element_size() * n
    return total
