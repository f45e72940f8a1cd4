"""Scaled dot-product attention: counterpart of
``paddle_tpu/nn/functional/attention.py:scaled_dot_product_attention`` and
the flash dispatch of ``paddle_tpu/ops/pallas_kernels.py``.

Layout ``[batch, seq, heads, head_dim]``, as paddle's flash-attention API.
No mask, or a boolean key-padding mask (``[B, 1, Sk]`` or
``[B, 1, 1, Sk]``, see :func:`as_kv_padding_mask`), and attention dropout
go through :func:`paddle_tpu_torch.ops.flash_attention.flash_attention`:
the flash kernels for CUDA tensors, their plain versions for CPU tensors.
A head dim the kernels do not take (``plain_route``: hd outside 64, 128,
256) goes on the card to ``flash_attention_fwd_reference`` under autograd
and is counted in ``flash_attention_fwd.plain_calls``, as the JAX package
takes ``sdpa_xla`` where its kernel does not apply.  Any other mask
(additive, or a full ``[Sq, Sk]`` one) takes the plain softmax path
below, as the JAX package takes ``sdpa_xla``.
"""

from __future__ import annotations

import math

import torch

from ...ops import flash_attention as fa
from .common import dropout

__all__ = ["scaled_dot_product_attention", "as_kv_padding_mask"]


def as_kv_padding_mask(attn_mask, B: int, Sk: int):
    """``attn_mask`` as a ``[B, Sk]`` key-padding mask if it is
    unambiguously one: BOOLEAN, of shape ``[B, 1, Sk]`` or
    ``[B, 1, 1, Sk]``; else None.  (The port's copy of
    ``paddle_tpu/ops/pallas_kernels.py:as_kv_padding_mask``: integer masks
    are additive in paddle, and a bare 2-D mask could be ``[Sq, Sk]``.)"""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return None
    if tuple(attn_mask.shape) in ((B, 1, Sk), (B, 1, 1, Sk)):
        return attn_mask.reshape(B, Sk)
    return None


def _draw_seed(generator) -> int:
    """The flash kernels' int32 dropout seed, one draw of the model's
    generator (on the host, so the card is not waited for)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


def _sdpa_plain(q, k, v, mask, dropout_p, causal, generator):
    """softmax(q k^T / sqrt(hd) + mask) v for masks the flash kernels do
    not take; the JAX package's ``_sdpa_xla_impl``."""
    nh, nkv = q.shape[2], k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    lowest = torch.finfo(logits.dtype).min
    if causal:
        Sq, Sk = logits.shape[-2], logits.shape[-1]
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :] - (Sk - Sq))
        logits = logits.masked_fill(~keep, lowest)
    if mask.dtype == torch.bool:
        logits = logits.masked_fill(~mask, lowest)
    else:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_p, True, generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, generator=None):
    """Attention over ``[B, S, heads, hd]`` tensors; ``dropout_p`` applies
    in training only, its randomness drawn from ``generator``."""
    B, Sk = query.shape[0], key.shape[1]
    kv_mask = as_kv_padding_mask(attn_mask, B, Sk)
    rate = float(dropout_p) if training else 0.0
    if attn_mask is None or kv_mask is not None:
        seed = _draw_seed(generator) if rate else None
        if fa.plain_route(query):
            fa.flash_attention_fwd.plain_calls += 1
            return fa.flash_attention_fwd_reference(
                query, key, value, is_causal, kv_mask, rate, seed)[0]
        return fa.flash_attention(query, key, value, is_causal, kv_mask,
                                  rate, seed)
    return _sdpa_plain(query, key, value, attn_mask, rate, is_causal,
                       generator)
