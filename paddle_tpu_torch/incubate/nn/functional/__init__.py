"""Fused functionals of the Llama family (rotary position embedding and
SwiGLU), and ring / Ulysses attention (:mod:`.ring_attention`).

Counterparts of ``paddle_tpu/incubate/nn/functional/__init__.py``
(``_rope_impl``, ``_default_cos_sin``, ``fused_rotary_position_embedding``,
``swiglu``).  Neither is a Pallas kernel in the JAX package (each is one
fused XLA expression there); here they are plain torch.  Layout
``[batch, seq, heads, head_dim]``.

Positions: ``position_ids`` None means ``0 .. S-1``; a ``(S,)`` tensor
gives one position per token and a ``(B, S)`` tensor one per row and
token.  The angles are ``position * inv_freq`` in float32, computed
from the positions as given (a tensor on the card stays there, so the
serving engine's captured programs never touch the host).  cos and sin
are cast to q's dtype before the rotation, as the JAX package builds its
table in q's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ring_attention import (ring_attention,  # noqa: F401
                             ring_attention_chunked, ring_attention_local,
                             ulysses_attention, ulysses_attention_local)

__all__ = ["fused_rotary_position_embedding", "rope_cos_sin", "swiglu",
           "ring_attention_local", "ring_attention",
           "ring_attention_chunked", "ulysses_attention_local",
           "ulysses_attention"]


def rope_cos_sin(position_ids, head_dim: int, base: float = 10000.0,
                 use_neox_rotary_style: bool = True):
    """float32 cos and sin of the rotary angles of ``position_ids``
    (``(S,)`` or ``(B, S)``), shaped ``[1 or B, S, 1, head_dim]`` to
    broadcast over the heads."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=position_ids.device)
                          / head_dim))
    freqs = position_ids.float()[..., None] * inv            # (..., D/2)
    if use_neox_rotary_style:
        emb = torch.cat([freqs, freqs], dim=-1)
    else:
        emb = freqs.repeat_interleave(2, dim=-1)
    if emb.dim() == 2:                                       # (S, D)
        emb = emb[None]
    return torch.cos(emb)[:, :, None, :], torch.sin(emb)[:, :, None, :]


def _rotate(x, cos, sin, use_neox: bool):
    if use_neox:
        x1, x2 = x.chunk(2, dim=-1)
        rx = torch.cat([-x2, x1], dim=-1)
    else:
        rx = torch.stack([-x[..., 1::2], x[..., 0::2]],
                         dim=-1).reshape(x.shape)
    return x * cos + rx * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True,
                                    rotary_emb_base: float = 10000.0):
    """Rotates ``q`` (and ``k``, ``v`` where given) by their positions;
    returns ``(q, k, v)`` with None for the tensors not given.  ``cos`` and
    ``sin`` (``[1 or B, S, 1, head_dim]``, from :func:`rope_cos_sin`) may
    be passed precomputed; else they come from ``position_ids``."""
    if cos is None or sin is None:
        if position_ids is None:
            position_ids = torch.arange(q.shape[1], device=q.device)
        cos, sin = rope_cos_sin(position_ids, q.shape[-1], rotary_emb_base,
                                use_neox_rotary_style)
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    return tuple(None if x is None else
                 _rotate(x, cos, sin, use_neox_rotary_style)
                 for x in (q, k, v))


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y`` None, ``x`` is split in two halves on
    its last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y
