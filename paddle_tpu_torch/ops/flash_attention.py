"""FlashAttention forward: the ``flash_fwd`` CUDA kernel and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas_flash.py:flash_attention_fwd``
(the Pallas TPU kernel ``_fwd_kernel``).  The kernel is
``paddle_tpu_torch/csrc/flash_fwd.cu``.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_reference"]

_NEG_INF = -1e30


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "[B, S, heads, hd] with k and v alike")
    B, _, nh, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] == 0 \
            or nh % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}: batch and hd must match and "
                         "kv heads divide query heads")


def flash_attention_fwd(q, k, v, causal: bool = False, kv_mask=None,
                        dropout_rate: float = 0.0):
    """Returns ``(out, lse)``: out ``[B, Sq, nh, hd]`` in q's dtype, lse
    ``[B, nh, Sq]`` float32 (the log-sum-exp of each row's scaled scores).

    q ``[B, Sq, nh, hd]``; k, v ``[B, Sk, nkv, hd]`` with ``nh % nkv == 0``
    (grouped-query attention: query head h reads kv head
    ``h // (nh // nkv)``).  ``causal`` is end-aligned: query i sees keys
    ``<= i + Sk - Sq``.  Any Sq and Sk work; a row that sees no key gives
    zeros and lse -1e30.

    The JAX version returns lse as ``[B, nh, Sq, 128]``, each row broadcast
    across 128 lanes; that layout is an artefact of the TPU's (8, 128)
    tiles and is dropped here.

    CUDA tensors (float32 or bfloat16, contiguous, hd in 64/128/256)
    launch the ``flash_fwd`` kernel; CPU tensors take
    :func:`flash_attention_fwd_reference`.  The key-padding mask and
    dropout of the JAX kernel come with the training slice and raise here.
    """
    if kv_mask is not None or dropout_rate:
        raise NotImplementedError(
            "flash_attention_fwd: kv_mask and dropout come with the "
            "training slice of the port (see ROADMAP.md)")
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    _build.check_device_tensors("flash_fwd", (q, k, v))
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    if hd not in (64, 128, 256):
        raise ValueError(f"flash_fwd: head dim {hd} not in (64, 128, 256)")
    out = torch.empty_like(q)
    lse = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    err = _build.library().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, nh, nkv, hd, int(bool(causal)),
        _build.dtype_code(q.dtype), _build.stream(q.device))
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_reference(q, k, v, causal: bool = False):
    """The plain version of ``flash_fwd``: the whole score matrix in
    float32, the same masking and the same zero-row convention."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    rep = nh // nkv
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        keep = torch.arange(Sk, device=q.device)[None, :] <= qpos
        s = s.masked_fill(~keep, float("-inf"))
    # a row with no visible key: m = -1e30, p = 0, l = 0 -> zeros
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse
