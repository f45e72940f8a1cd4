"""The fused optimizer step: counterpart of ``paddle_tpu/optimizer/fused.py``.

The JAX package runs a whole optimizer step as one XLA program over the
parameter tree: AMP unscale, the on-device ``found_inf``, the clip, the
update with a skip on overflow, and the GradScaler's bookkeeping, with no
host sync.  The port runs the same step on the ``fused_adamw`` kernels
(``ops/fused_optimizer.py``, ``csrc/fused_adamw.cu``) on the card, and on
their plain version on the CPU.

The plan is the JAX package's: which tensors use float32 masters (O2:
``multi_precision`` and a bfloat16 or float16 parameter), each tensor's
weight decay (after ``apply_decay_param_fun`` /
``exclude_from_weight_decay_fn``),
learning-rate ratio and ``need_clip``, the clip's kind (exact types of
``nn/clip.py``) and the scaler's rule.  The plan's table is built once per
parameter list and reused (``optimizer.fused`` kind ``miss`` when built,
``hit`` when reused).

Fallbacks, counted as kind ``fallback`` and served by the list rules
(``Optimizer._apply_per_leaf``), where the JAX package falls back
(``paddle_tpu/optimizer/fused.py:46-52``):
L1 decay, custom subclasses of the clip classes, optimizers without an
elementwise rule (LBFGS); and, in the port, the rules the kernel does not
carry (Adagrad, RMSProp, Adadelta, Adamax, Lamb: the JAX program runs
them too), a 16-bit parameter without a master, or a state of another
type than float32.

Scaler steps: the applied-step count depends on ``found_inf``, so it
stays on the card (``Optimizer._step_dev``) with the scaler's scale and
counts; the skipped step leaves it unchanged, as the JAX program does.

Under tensor parallelism and ZeRO (``opt._grad_reduce``, a
``distributed/fleet/norm.py`` ``CrossRankNorm``) the table carries each
tensor's norm weight and the step runs the kernels' split norm: the
per-tensor sums and the non-finite flag are summed over the ranks
before the coefficients and ``found_inf`` are made.
The update kernel writes each unscaled gradient back into ``p.grad``,
applied step or skipped, as the JAX program returns them
(``paddle_tpu/optimizer/fused.py:399-401``); a step without a scaler
leaves ``p.grad`` as backward wrote it.  So after any step ``p.grad`` is
what the reference leaves: unscaled and not clipped, whichever route
(fused or the list rules, ``Optimizer._apply_per_leaf``) the step took.
"""

from __future__ import annotations

import torch

from ..observability import metrics as _metrics
from ..ops import fused_optimizer as _fo

__all__ = ["try_step", "scaler_step"]

_M_FUSED = _metrics.counter(
    "optimizer.fused",
    "fused train-update outcomes per step (kind=hit|miss|fallback)")
_K_HIT = (("kind", "hit"),)
_K_MISS = (("kind", "miss"),)
_K_FALLBACK = (("kind", "fallback"),)

def _clip_config(opt):
    """(the clip as ``fused_adamw`` takes it, fusible).  Exact types:
    subclasses of the clip classes fall back."""
    clip = opt._grad_clip
    if clip is None:
        return None, True
    from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)
    t = type(clip)
    if t is ClipGradByGlobalNorm:
        return ("global", clip.clip_norm), True
    if t is ClipGradByNorm:
        return ("norm", clip.clip_norm), True
    if t is ClipGradByValue:
        return ("value", clip.min, clip.max), True
    return None, False


def _plan(opt, work):
    """The table for this step's tensors (built, or reused), or None when
    the step cannot run fused."""
    rule = opt._fused_rule
    if rule is None:
        return None
    leaves = []
    for p, g, ratio, wd, l1 in work:
        if l1:
            return None           # L1Decay's sign term: the list rules
        use_master = opt._use_master(p)
        if p.dtype != torch.float32 and not use_master:
            return None
        leaves.append((p, use_master, opt._effective_wd(p, wd), ratio,
                       bool(getattr(p, "need_clip", True))))
    masters = [opt._create_master_weight(p) if um else None
               for p, um, *_ in leaves]
    names = (opt._state_names + [None, None])[:2]
    states = [[None if n is None else opt._get_state(n, p) for n in names]
              for p, *_ in leaves]
    if any(s is not None and (s.dtype != torch.float32
                              or not s.is_contiguous())
           for st in states for s in st) or \
            any(not p.is_contiguous() for p, *_ in leaves):
        return None
    red = opt._grad_reduce
    weights = None if red is None else red.weights([p for p, *_ in leaves])
    key = tuple((id(p), p.data_ptr(), p.dtype, um, wd, ratio, nc,
                 None if mw is None else mw.data_ptr(),
                 tuple(None if s is None else s.data_ptr() for s in st))
                for (p, um, wd, ratio, nc), mw, st in zip(leaves, masters,
                                                          states)) + \
        (None if weights is None else tuple(weights),)
    table = opt._fused_tables.get(key)
    if table is None:
        _M_FUSED.inc_key(_K_MISS)
        opt._fused_tables.clear()      # one parameter list at a time
        table = opt._fused_tables[key] = _fo.FusedTable(
            [p for p, *_ in leaves], masters, states,
            [wd for _, _, wd, _, _ in leaves],
            [r for _, _, _, r, _ in leaves],
            [nc for *_, nc in leaves], weights)
    else:
        _M_FUSED.inc_key(_K_HIT)
    return table


def _execute(opt, table, work, clip, scaler=None):
    step = opt._device_step(table.device)
    if scaler is None:
        # the caller counted this step on the host already
        step.fill_(opt._gs_host - 1)
    elif not opt._gs_ahead:
        step.fill_(opt._gs_host)
    grads = [g.contiguous() for _, g, *_ in work]
    red = opt._grad_reduce
    _fo.fused_adamw(table, grads, opt.get_lr(), step, rule=opt._fused_rule,
                    clip=clip, scaler=scaler,
                    reduce=None if red is None else red.reduce,
                    **opt._fused_hyper())
    if scaler is not None:
        opt._gs_ahead = True
        for (_, g, *_), gc in zip(work, grads):
            if gc is not g:          # unscaled into a contiguous copy
                g.copy_(gc)


def try_step(opt, work) -> bool:
    """The fused path of a plain ``Optimizer.step`` (no scaler): ``work``
    is the collected ``[param, grad, ratio, wd, l1]`` list and the caller
    has counted the step.  False: run the list rules."""
    if not work:
        return False
    if opt._fused_rule is None or any(item[4] for item in work):
        _M_FUSED.inc_key(_K_FALLBACK)
        return False
    clip, ok = _clip_config(opt)
    table = _plan(opt, work) if ok else None
    if table is None:
        _M_FUSED.inc_key(_K_FALLBACK)
        return False
    _execute(opt, table, work, clip)
    return True


def scaler_step(scaler, opt) -> bool:
    """A whole ``GradScaler.step`` on the kernels: unscale, found_inf,
    clip, update or skip, the scale's bookkeeping, all on the card (read
    back at ``scaler._sync_fused_state``).  False: the caller runs the
    host-sync path."""
    clip, ok = _clip_config(opt)
    if not ok:
        _M_FUSED.inc_key(_K_FALLBACK)
        return False
    work, _ = opt._collect_work()
    if not work:
        return False
    if sum(1 for p in opt._parameter_list if p.grad is not None) \
            != len(work):
        # a frozen parameter holds a gradient: the host path still
        # unscales it and counts it in found_inf
        _M_FUSED.inc_key(_K_FALLBACK)
        return False
    table = _plan(opt, work)
    if table is None:
        _M_FUSED.inc_key(_K_FALLBACK)
        return False
    scale, counts = scaler._fused_state(table.device)
    _execute(opt, table, work, clip, (scale, counts, scaler._config()))
    scaler._fused_commit()
    return True
