"""Mixed precision: counterpart of ``paddle_tpu/amp/auto_cast.py``
(``auto_cast`` at level O1, bfloat16).

``auto_cast`` is a context over ``torch.autocast`` on the device the
port runs on (``cuda`` unless ``device="cpu"``).  Which ops run in
bfloat16 differs in detail between the two frameworks:

- The JAX package's O1 casts to bfloat16 the ops of its white list, taken
  from the op specs (``amp: white`` in ``paddle_tpu/ops/specs/*.yaml``):
  matmul, linear, bmm, einsum, sdpa, flash_attention, conv and a few more;
  the black list (softmax, layer_norm, cross_entropy, ...) is promoted to
  float32; everything else runs in the type it receives.
- torch's autocast casts linear, matmul, bmm, einsum and convolutions to
  bfloat16 and keeps layer_norm, softmax, log_softmax and the losses in
  float32; everything else runs in the type it receives.

On the port's GPT the two agree where it matters: the qkv, projection and
MLP matrix products and the tied head run in bfloat16, the LayerNorms and
the loss in float32, and the flash kernels receive bfloat16 q/k/v from the
bfloat16 ``qkv`` product and return gradients in bfloat16.  Parameters,
their gradients and the optimizer state stay float32.

Level O2 (``decorate``, bfloat16 parameters with float32 masters), float16
(which needs a ``GradScaler``) and custom op lists are later work: the
first two raise, and the lists are not taken.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device

__all__ = ["auto_cast", "decorate"]


class auto_cast:
    """``with auto_cast(True, level="O1", dtype="bfloat16"):`` runs the
    forward in mixed precision; level ``O0`` (or ``enable=False``) runs it
    in float32."""

    def __init__(self, enable: bool = True, level: str = "O1",
                 dtype: str = "bfloat16", device=None):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        if level == "O2":
            raise NotImplementedError(
                "auto_cast level O2 (bfloat16 parameters, decorate) is not "
                "ported yet: see ROADMAP.md")
        if dtype not in ("bfloat16", torch.bfloat16):
            raise NotImplementedError(
                f"auto_cast dtype {dtype}: only bfloat16 is ported (float16 "
                "needs a GradScaler, see ROADMAP.md)")
        self._enable = bool(enable) and level != "O0"
        self._device = resolve_device(device)
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.autocast(self._device.type, dtype=torch.bfloat16,
                                   enabled=self._enable)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)



def decorate(*args, **kwargs):
    raise NotImplementedError(
        "amp.decorate (level O2) is not ported yet: see ROADMAP.md")
