"""Mixed precision: counterpart of ``paddle_tpu/amp/auto_cast.py``
(``auto_cast`` at levels O1 and O2 in bfloat16 or float16, ``decorate``).

``auto_cast`` is a context over ``torch.autocast`` on the device the
port runs on (``cuda`` unless ``device="cpu"``) in the type it is given
(``dtype="bfloat16"`` or ``"float16"``; below, "bfloat16" stands for
either).  Which ops run in it differs in detail between the two
frameworks:

- The JAX package's O1 casts to bfloat16 the ops of its white list, taken
  from the op specs (``amp: white`` in ``paddle_tpu/ops/specs/*.yaml``):
  matmul, linear, bmm, einsum, sdpa, flash_attention, conv and a few more;
  the black list (softmax, layer_norm, cross_entropy, ...) is promoted to
  float32; everything else runs in the type it receives.  Its O2 casts
  every op but the black list to bfloat16.
- torch's autocast casts linear, matmul, bmm, einsum and convolutions to
  bfloat16 and keeps layer_norm, softmax, log_softmax and the losses in
  float32 (on the card; on the CPU layer_norm follows its input);
  everything else runs in the type it receives.

On the port's GPT the two agree where it matters: the qkv, projection and
MLP matrix products and the tied head run in bfloat16, the LayerNorms and
the loss in float32, and the flash kernels receive bfloat16 q/k/v from the
bfloat16 ``qkv`` product and return gradients in bfloat16.

O1 keeps parameters, gradients and optimizer state in float32.  O2 is
``decorate``: the parameters and buffers become bfloat16 except those of
normalisation layers (LayerNorm, RMSNorm, batch, group and instance
norms: ``_cast_model_keep_norms``), whose inputs are then cast to their
float32 parameters' type on the way in (the JAX black list's promotion;
``F.layer_norm`` takes one type), and the optimizer keeps float32 master
weights (``multi_precision``).  Under ``auto_cast(level="O2")`` the
bfloat16 parameters carry the rest: torch's autocast has one policy for
both levels.  float16 trains as the JAX package does, with a dynamic
``GradScaler`` (``amp/grad_scaler.py``, default scale 65536): the flash
kernels and ``fused_adamw`` take float16 (and the paged and MoE kernels
serve in it).

Custom op lists (``custom_white_list`` / ``custom_black_list``) switch
policy: torch's autocast is turned off and the JAX package's per-op rule
runs instead, with the custom changes applied, in a function mode
(``amp/op_lists.py``: the JAX lists, the table of op names, the mode).
Without a custom list ``auto_cast`` stays ``torch.autocast``, at its
cost.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..core.device import resolve_device
from . import op_lists

__all__ = ["auto_cast", "amp_guard", "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}


def _check_dtype(dtype, what) -> torch.dtype:
    """The torch type of an AMP ``dtype`` (the JAX package's
    ``amp dtype must be float16 or bfloat16``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: amp dtype must be float16 or bfloat16, "
                         f"got {dtype}")
    return _DTYPES[dtype]


class auto_cast:
    """``with auto_cast(True, level="O1", dtype="bfloat16"):`` runs the
    forward in mixed precision (``dtype="float16"`` too); level ``O0`` (or
    ``enable=False``) runs it in the parameters' type.  With
    ``custom_white_list`` or ``custom_black_list`` (Paddle op names, from
    ``op_lists.OPS``; any other raises ``NotImplementedError``) the JAX
    package's per-op lists run instead of torch's autocast; ``.mode`` is
    then the :class:`~.op_lists.ListCastMode` (``mode.ran`` counts the
    type each mapped op ran in)."""

    def __init__(self, enable: bool = True, custom_white_list=None,
                 custom_black_list=None, level: str = "O1",
                 dtype: str = "bfloat16", use_promote: bool = True,
                 device=None):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        self._dtype = _check_dtype(dtype, "auto_cast")
        self._enable = bool(enable) and level != "O0"
        self._level = level
        self._device = resolve_device(device)
        self.mode = None
        if custom_white_list or custom_black_list:
            white, black = op_lists.lists_with(custom_white_list,
                                               custom_black_list)
            if self._enable:
                self.mode = op_lists.ListCastMode(self._dtype, level, white,
                                                  black)
        self._ctx = None

    def __enter__(self):
        # with custom lists torch's autocast is off (it would round a
        # black-listed op's float32 inputs before the mode saw them)
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(torch.autocast(
            self._device.type, dtype=self._dtype,
            enabled=self._enable and self.mode is None))
        if self.mode is not None:
            self._ctx.enter_context(op_lists.enter(self.mode))
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


amp_guard = auto_cast

# the port's normalisation layers, which O2 keeps in float32
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm,
          nn.modules.instancenorm._InstanceNorm)


def _norm_types():
    from ..nn.norm import RMSNorm
    return _NORMS + (RMSNorm, nn.RMSNorm)


def _to_norm_type(module, args):
    """Forward pre-hook of a kept norm: its floating inputs in its
    parameters' type."""
    dt = next(module.parameters()).dtype
    return tuple(a.to(dt) if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _cast_model_keep_norms(model: nn.Module, dtype=torch.bfloat16):
    """O2's cast: every floating parameter and buffer to ``dtype`` in place
    (the Parameter objects stay, so an optimizer built before keeps them),
    except those of normalisation layers, which stay float32 and cast
    their inputs to float32."""
    norms = _norm_types()
    for sub in model.modules():
        if isinstance(sub, norms):
            if any(True for _ in sub.parameters()) and \
                    not getattr(sub, "_o2_input_hook", None):
                sub._o2_input_hook = sub.register_forward_pre_hook(
                    _to_norm_type)
            continue
        for p in sub.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        for name, b in sub.named_buffers(recurse=False):
            if b is not None and b.is_floating_point():
                setattr(sub, name, b.to(dtype))
    return model


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2 casts the models' parameters to
    ``dtype`` (bfloat16 or float16; norm layers stay float32) and turns on
    the optimizers' float32 master weights (unless
    ``master_weight=False``).  Returns what it was given, as paddle
    does."""
    dt = _check_dtype(dtype, "decorate")
    single_model = isinstance(models, nn.Module)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            _cast_model_keep_norms(m, dt)
    if optimizers is None:
        return models if single_model else model_list
    opt_list = list(optimizers) if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    for o in opt_list:
        if master_weight is not False:
            o._multi_precision = True
    if single_model:
        return models, optimizers
    return model_list, opt_list
