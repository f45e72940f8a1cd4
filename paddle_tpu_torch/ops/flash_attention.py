"""FlashAttention forward and backward: the ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` CUDA kernels, their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas_flash.py``: ``flash_attention_fwd``
(the Pallas TPU kernel ``_fwd_kernel``), ``flash_attention_bwd`` (the
kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` driven by
``_flash_bwd``) and the differentiable ``flash_attention`` (its
``custom_vjp``).  The kernels are ``paddle_tpu_torch/csrc/flash_fwd.cu``
and ``paddle_tpu_torch/csrc/flash_bwd.cu``.  In bfloat16 all three run
on the tensor cores (``wgmma`` on bf16 tiles in shared memory,
``tc_common.cuh``), rounding p and ds to bf16 before their second product
(the forward and dq as the TPU kernels cast them; dk/dv as the TPU's
matrix unit would round its fp32 p and ds); in float32 they run on fp32
FMAs, the precision reference of the fp32 checks.

Dropout.  The keep mask is a pure function of (seed, batch * head, query
row, key column): the lowbias32 mix of the JAX package's ``_hash_bits``
applied to ABSOLUTE coordinates with the seed word ``seed ^ (bh << 20)``,
kept where the bits are below ``uint32((1 - rate) * 4294967295.0)``.  So
the forward and both backward kernels redraw the same bits whatever their
tiling, and the plain versions draw them too.  (The JAX kernels seed each
tile and draw on tile-local coordinates; where their forward and backward
tile alike, in one tile of Sq, Sk <= 512, they give these bits exactly.)
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import _build

__all__ = ["flash_attention", "FlashAttention", "flash_attention_fwd",
           "KERNEL_HEAD_DIMS", "plain_route",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_reference",
           "flash_attention_bwd_reference", "dropout_keep_mask"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
# the head dims every attention kernel of the port takes (flash and paged)
KERNEL_HEAD_DIMS = (64, 128, 256)


def plain_route(q) -> bool:
    """The callers' route, decided from the shape before any launch (the
    JAX package's ``flash_attention_available``): True for a tensor off
    the CPU whose head dim (``q.shape[-1]``) no attention kernel takes.
    The caller then runs the kernel's plain version and adds one to the
    wrapper's ``plain_calls``, never to its ``launches``.  A CPU tensor
    gives False: the wrappers take their plain versions for it anyway."""
    return q.device.type != "cpu" and q.shape[-1] not in KERNEL_HEAD_DIMS


# ------------------------------------------------------------------ dropout

def _keep_threshold(rate: float) -> int:
    """The uint32 keep threshold, truncated as ``jnp.uint32`` truncates."""
    return int((1.0 - rate) * 4294967295.0)


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 tensors holding uint32 values,
    split in 16-bit halves so that no product leaves int64."""
    hi = (((x >> 16) * c) & _M32) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def dropout_keep_mask(B: int, nh: int, Sq: int, Sk: int, seed: int,
                      rate: float, device=None) -> torch.Tensor:
    """The keep mask ``[B, nh, Sq, Sk]`` (bool) that all three kernels
    draw: lowbias32 of (row * 0x10193 + col + word * 0x9E3779B9), word =
    ``seed ^ (bh << 20)`` in uint32, bh = b * nh + h."""
    i64 = dict(dtype=torch.int64, device=device)
    rows = torch.arange(Sq, **i64)[:, None]
    cols = torch.arange(Sk, **i64)[None, :]
    word = ((seed & _M32) ^ (torch.arange(B * nh, **i64) << 20)) & _M32
    x = (rows * 0x10193 + cols)[None] + _mul32(word, 0x9E3779B9)[:, None,
                                                                 None]
    x &= _M32
    x ^= x >> 16
    x = _mul32(x, 0x7FEB352D)
    x ^= x >> 15
    x = _mul32(x, 0x846CA68B)
    x ^= x >> 16
    return (x < _keep_threshold(rate)).view(B, nh, Sq, Sk)


def _autocast_off(device):
    """Autocast off for the plain versions' float32 math; a device with no
    autocast (``meta``) has none to turn off."""
    if device.type in ("cpu", "cuda"):
        return torch.autocast(device.type, enabled=False)
    return contextlib.nullcontext()


# ------------------------------------------------------------------- checks

def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "[B, S, heads, hd] with k and v alike")
    B, _, nh, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] == 0 \
            or nh % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}: batch and hd must match and "
                         "kv heads divide query heads")


def _check_training_args(k, kv_mask, dropout_rate, seed):
    """Validates the kv mask and dropout arguments; returns the mask as
    contiguous int32 ``[B, Sk]`` (or None) and the seed as an int."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate {dropout_rate} "
                         "not in [0, 1)")
    if dropout_rate and seed is None:
        raise ValueError("flash_attention: dropout needs an int32 seed")
    if kv_mask is not None:
        B, Sk = k.shape[0], k.shape[1]
        if tuple(kv_mask.shape) != (B, Sk):
            raise ValueError(f"flash_attention: kv_mask "
                             f"{tuple(kv_mask.shape)}, want [B, Sk] = "
                             f"{[B, Sk]}")
        if kv_mask.dtype != torch.int32 or not kv_mask.is_contiguous():
            kv_mask = (kv_mask != 0).to(torch.int32).contiguous()
    return kv_mask, int(seed or 0)


def _launch_args(kv_mask, dropout_rate, seed):
    """The trailing C arguments every flash entry point takes: the mask
    pointer (None for no mask), then seed, keep threshold, keep
    probability."""
    rate = float(dropout_rate)
    return ((kv_mask.data_ptr() if kv_mask is not None else None),
            seed & _M32, _keep_threshold(rate) if rate else 0, 1.0 - rate)


def _kernel_dims(kernel, q, k, floats, kv_mask):
    _build.check_device_tensors(kernel, floats,
                                () if kv_mask is None else (kv_mask,))
    B, Sq, nh, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    return B, Sq, k.shape[1], nh, k.shape[2], hd


# ------------------------------------------------------------------ forward

def flash_attention_fwd(q, k, v, causal: bool = False, kv_mask=None,
                        dropout_rate: float = 0.0, seed=None):
    """Returns ``(out, lse)``: out ``[B, Sq, nh, hd]`` in q's dtype, lse
    ``[B, nh, Sq]`` float32 (the log-sum-exp of each row's scaled scores).

    q ``[B, Sq, nh, hd]``; k, v ``[B, Sk, nkv, hd]`` with ``nh % nkv == 0``
    (grouped-query attention: query head h reads kv head
    ``h // (nh // nkv)``).  ``causal`` is end-aligned: query i sees keys
    ``<= i + Sk - Sq``.  ``kv_mask`` ``[B, Sk]`` (nonzero = valid key)
    hides padded keys.  ``dropout_rate`` with an int32 ``seed`` drops the
    normalised probabilities (see :func:`dropout_keep_mask`); lse is that
    of the undropped scores.  Any Sq and Sk work; a row that sees no key
    gives zeros and lse -1e30.

    The JAX version returns lse as ``[B, nh, Sq, 128]``, each row broadcast
    across 128 lanes; that layout is an artefact of the TPU's (8, 128)
    tiles and is dropped here.

    CUDA tensors (float32 or bfloat16, contiguous, hd in 64/128/256)
    launch the ``flash_fwd`` kernel (bfloat16: ``flash_fwd_tc_kernel`` on
    the tensor cores; float32: ``flash_fwd_kernel`` on FMAs); CPU tensors
    take :func:`flash_attention_fwd_reference`.
    """
    _check_shapes(q, k, v)
    kv_mask, seed = _check_training_args(k, kv_mask, dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, kv_mask,
                                             dropout_rate, seed)
    B, Sq, Sk, nh, nkv, hd = _kernel_dims("flash_fwd", q, k, (q, k, v),
                                          kv_mask)
    out = torch.empty_like(q)
    lse = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    mask_ptr, seed, thresh, keep_p = _launch_args(kv_mask, dropout_rate, seed)
    err = _build.library().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), mask_ptr, B, Sq, Sk, nh, nkv, hd,
        int(bool(causal)), _build.dtype_code(q.dtype), seed, thresh, keep_p,
        _build.stream(q.device))
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.plain_calls = 0     # callers' plain routes (plain_route)


def _scores(q, k, causal, kv_mask):
    """fp32 scaled scores ``[B, nh, Sq, Sk]``, the validity mask that the
    kernels apply, and k's heads repeated to q's."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(nh // nkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    valid = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        valid = valid & (torch.arange(Sk, device=q.device)[None, :] <= qpos)
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, :]
    return s, valid, kf


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  kv_mask=None, dropout_rate: float = 0.0,
                                  seed=None):
    """The plain version of ``flash_fwd``: the whole score matrix in
    float32 (autocast off), the same masking, the same keep bits and the
    same zero-row convention."""
    with _autocast_off(q.device):
        B, Sq, nh, hd = q.shape
        Sk = k.shape[1]
        s, valid, _ = _scores(q, k, causal, kv_mask)
        vf = v.float().repeat_interleave(nh // k.shape[2], dim=2)
        s = s.masked_fill(~valid, float("-inf"))
        # a row with no visible key: m = -1e30, p = 0, l = 0 -> zeros
        m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        if dropout_rate:
            keep = dropout_keep_mask(B, nh, Sq, Sk, int(seed), dropout_rate,
                                     q.device)
            p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
        lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


# ----------------------------------------------------------------- backward

def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        kv_mask=None, dropout_rate: float = 0.0, seed=None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd`'s output
    with respect to q, k and v, from the forward's ``out`` and ``lse`` and
    the output gradient ``do`` (like q).  The mask, rate and seed must be
    the forward's.  Gradients come in their inputs' dtypes.

    CUDA tensors launch ``flash_bwd_dq`` then ``flash_bwd_dkv``; CPU
    tensors take :func:`flash_attention_bwd_reference`.
    """
    _check_shapes(q, k, v)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"do {tuple(do.shape)} must be like q "
                         f"{tuple(q.shape)}")
    kv_mask, seed = _check_training_args(k, kv_mask, dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             kv_mask, dropout_rate, seed)
    dq = flash_attention_bwd_dq(q, k, v, out, lse, do, causal, kv_mask,
                                dropout_rate, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, do, causal, kv_mask,
                                     dropout_rate, seed)
    return dq, dk, dv


def _bwd_launch(kernel, entry, q, k, v, out, lse, do, grads, causal,
                kv_mask, dropout_rate, seed, scratch=()):
    B, Sq, Sk, nh, nkv, hd = _kernel_dims(kernel, q, k, (q, k, v, out, do),
                                          kv_mask)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, nh, Sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{kernel}: lse must be contiguous float32 "
                         f"[B, nh, Sq] = {[B, nh, Sq]} on {q.device}")
    mask_ptr, seed, thresh, keep_p = _launch_args(kv_mask, dropout_rate, seed)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
        *scratch, mask_ptr, B, Sq, Sk, nh, nkv, hd, int(bool(causal)),
        _build.dtype_code(q.dtype), seed, thresh, keep_p,
        _build.stream(q.device))
    _build.check(err, kernel)


def flash_attention_bwd_dq(q, k, v, out, lse, do, causal=False,
                           kv_mask=None, dropout_rate=0.0, seed=None):
    """dq through the ``flash_bwd_dq`` kernel (CUDA tensors; bfloat16 on
    the tensor cores, ``flash_bwd_dq_tc_kernel``, float32 on FMAs) or the
    plain version (CPU tensors).  Arguments as
    :func:`flash_attention_bwd`."""
    _check_shapes(q, k, v)
    kv_mask, seed = _check_training_args(k, kv_mask, dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             kv_mask, dropout_rate, seed,
                                             parts=("dq",))[0]
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", "ptt_flash_bwd_dq", q, k, v, out, lse, do,
                (dq,), causal, kv_mask, dropout_rate, seed)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, out, lse, do, causal=False,
                            kv_mask=None, dropout_rate=0.0, seed=None):
    """(dk, dv) through the ``flash_bwd_dkv`` kernel (CUDA tensors;
    bfloat16 on the tensor cores, ``flash_bwd_dkv_tc_kernel`` after a
    pre-pass of each query row's lse and D = rowsum(dO * out) into a
    scratch tensor, float32 on FMAs) or the plain version (CPU tensors).
    Arguments as :func:`flash_attention_bwd`."""
    _check_shapes(q, k, v)
    kv_mask, seed = _check_training_args(k, kv_mask, dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             kv_mask, dropout_rate, seed,
                                             parts=("dkv",))[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stats = None
    if q.dtype == torch.bfloat16:
        # (lse log2 e, D) of each query row, rows padded to 64
        B, Sq, nh = q.shape[:3]
        stats = torch.empty((B, nh, -(-Sq // 64) * 64, 2),
                            dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dkv", "ptt_flash_bwd_dkv", q, k, v, out, lse, do,
                (dk, dv), causal, kv_mask, dropout_rate, seed,
                (None if stats is None else stats.data_ptr(),))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=False,
                                  kv_mask=None, dropout_rate=0.0, seed=None,
                                  parts=("dq", "dkv")):
    """The plain version of the two backward kernels, in the FA-2 form
    they compute (not autograd through the forward): with
    p = exp(s - lse) on valid entries and D = rowsum(dO * O),

        dv = (keep ? p / (1 - rate) : 0)^T dO
        dp = keep ? dO V^T / (1 - rate) : 0
        ds = p * (dp - D) / sqrt(hd)
        dq = ds K,  dk = ds^T Q

    summed over each kv head's group of query heads.  float32 throughout
    (autocast off).  Returns ``(dq, dk, dv)``; ``parts`` names which to
    compute (the others are None)."""
    with _autocast_off(q.device):
        B, Sq, nh, hd = q.shape
        Sk, nkv = k.shape[1], k.shape[2]
        s, valid, kf = _scores(q, k, causal, kv_mask)
        p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
        del s
        dof = do.float()
        vf = v.float().repeat_interleave(nh // nkv, dim=2)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        if dropout_rate:
            keep = dropout_keep_mask(B, nh, Sq, Sk, int(seed), dropout_rate,
                                     q.device)
            dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
        ds = p * (dp - delta) / math.sqrt(hd)
        del dp
        dq = dk = dv = None
        if "dq" in parts:
            dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)
        if "dkv" in parts:
            if dropout_rate:
                p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            rep = (B, Sk, nkv, nh // nkv, hd)
            dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
            dk = dk.reshape(rep).sum(3).to(k.dtype)
            dv = dv.reshape(rep).sum(3).to(v.dtype)
    return dq, dk, dv


# ------------------------------------------------------------- autograd

class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward on the two backward kernels
    (the JAX package's ``custom_vjp``).  The forward saves q, k, v, out,
    lse, the int32 mask and the seed; the backward redraws the forward's
    dropout bits from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_mask, dropout_rate, seed):
        kv_mask, seed = _check_training_args(k, kv_mask, dropout_rate, seed)
        out, lse = flash_attention_fwd(q, k, v, causal, kv_mask,
                                       dropout_rate, seed)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.causal, ctx.dropout_rate, ctx.seed = causal, dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.to(out.dtype).contiguous(), ctx.causal,
            kv_mask, ctx.dropout_rate, ctx.seed)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False, kv_mask=None,
                    dropout_rate: float = 0.0, seed=None):
    """Differentiable flash attention, ``[B, Sq, nh, hd]`` out; arguments
    as :func:`flash_attention_fwd`."""
    return FlashAttention.apply(q, k, v, causal, kv_mask, dropout_rate, seed)
