"""Mixture-of-experts routing: the ``moe_dispatch`` and ``moe_combine``
CUDA kernels, their plain PyTorch versions, and the autograd Functions
around them.

Counterpart of ``paddle_tpu/ops/pallas_moe.py`` (the Pallas TPU kernels
``_dispatch_kernel`` and ``_combine_kernel`` with their custom VJPs) and of
the MoE wrappers of ``paddle_tpu/ops/pallas_kernels.py``
(``moe_routing_indices``, ``moe_dispatch``, ``moe_combine``), folded in
here.  The kernels are ``paddle_tpu_torch/csrc/moe.cu``.

Routing is carried as indices: per token and routing choice the flat
destination slot ``eid * C + slot`` (or the dummy slot ``E * C`` when the
choice was dropped), and the inverse map from slot to token (``T`` for an
empty slot).  Dispatch gathers token rows by the inverse map into the
``[E * C, M]`` expert buffers; combine sums each token's k expert rows
weighted by the gate.  Both are differentiable (``MoEDispatch``,
``MoECombine``); their backward passes are the plain index ops of the JAX
package's custom VJPs (a scatter-add for dispatch; a scatter of the
weighted cotangent and a row-wise dot for combine), which it wrote in XLA
and not in Pallas.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import KernelTypeError, KernelValueError

__all__ = ["routing_indices", "moe_dispatch", "moe_combine", "MoEDispatch",
           "MoECombine", "moe_dispatch_reference", "moe_combine_reference"]

_MAX_K = 8      # csrc/moe.cu stages a token's k slots in shared memory


def routing_indices(eid, slot, keep, num_experts: int, capacity: int):
    """Index plumbing for the fused path (integer ops, no gradient).

    eid/slot ``[T, k]`` int: routing choice -> expert id / buffer slot;
    keep ``[T, k]`` 0/1 float.  Returns ``(flat [T, k], inv [E * C])``,
    both int32: the flat destination slot per choice (``E * C`` = the
    dummy for drops) and the inverse slot -> token map (``T`` = empty)."""
    E, C = int(num_experts), int(capacity)
    T, k = eid.shape
    flat = torch.where(keep > 0.5, eid.int() * C + slot.int(),
                       torch.full_like(eid, E * C, dtype=torch.int32))
    tok = torch.arange(T, dtype=torch.int32, device=eid.device)[:, None] \
        .expand(T, k)
    # every kept choice owns its slot alone; the dummy slot, written by
    # every dropped choice, is cut off
    inv = torch.full((E * C + 1,), T, dtype=torch.int32, device=eid.device)
    inv.scatter_(0, flat.reshape(-1).long(), tok.reshape(-1))
    return flat, inv[:E * C]


def _row_checks(kernel, x, M):
    if M * x.element_size() % 16:
        raise KernelValueError(
            f"{kernel}: a row of {M} {x.dtype} elements is not "
            "a whole number of 16-byte vectors")


# ---------------------------------------------------------------- dispatch

def _dispatch(x, inv):
    """The forward of :func:`moe_dispatch`: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.dim() != 2 or inv.dim() != 1:
        raise KernelValueError(
            f"moe_dispatch: x {tuple(x.shape)} must be [T, M] "
            f"and inv {tuple(inv.shape)} [E * C]")
    if x.device.type == "cpu":
        return moe_dispatch_reference(x, inv)
    _build.check_device_tensors("moe_dispatch", (x,), (inv,),
                                _build.FP16_DTYPES)
    T, M = x.shape
    _row_checks("moe_dispatch", x, M)
    rows = inv.shape[0]
    out = torch.empty((rows, M), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    err = _build.library().ptt_moe_dispatch(
        x.data_ptr(), inv.data_ptr(), out.data_ptr(), T, rows, M,
        _build.dtype_code(x.dtype, _build.FP16_DTYPES),
        _build.stream(x.device))
    _build.check(err, "moe_dispatch")
    moe_dispatch.launches += 1
    return out


class MoEDispatch(torch.autograd.Function):
    """Dispatch with the JAX package's VJP (``_dispatch_bwd``): the
    cotangent of each buffer row goes back to its source token, a token
    routed k ways summing k rows; empty slots' rows are dropped."""

    @staticmethod
    def forward(ctx, x, inv):
        ctx.save_for_backward(inv)
        ctx.T = x.shape[0]
        return _dispatch(x, inv)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        dx = torch.zeros((ctx.T + 1, g.shape[1]), dtype=g.dtype,
                         device=g.device)
        dx.index_add_(0, inv.long(), g)
        return dx[:ctx.T], None


def moe_dispatch(x, inv):
    """Pack token rows into the flat expert buffers: ``out[i] =
    x[inv[i]]``, zeros where ``inv[i] == T`` (an empty slot).  x ``[T,
    M]``; inv ``[E * C]`` int32 in ``[0, T]``.  Returns ``[E * C, M]``;
    reshape to ``(E, C, M)`` for the batched experts.  Differentiable in
    x.

    CUDA tensors (float32, bfloat16 or float16, contiguous, 16-byte
    aligned, M a multiple of 4 or 8) launch the ``moe_dispatch`` kernel; CPU tensors
    take :func:`moe_dispatch_reference`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MoEDispatch.apply(x, inv)
    return _dispatch(x, inv)


moe_dispatch.launches = 0


def moe_dispatch_reference(x, inv):
    """The plain version of ``moe_dispatch``: one gather from x with a
    zero row appended."""
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x_pad[inv.long()]


# ----------------------------------------------------------------- combine

def _combine(expert_rows, w, flat):
    """The forward of :func:`moe_combine`: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if expert_rows.dim() != 2 or w.dim() != 2 or flat.shape != w.shape:
        raise KernelValueError(
            f"moe_combine: rows {tuple(expert_rows.shape)} "
            f"must be [E * C, M], w {tuple(w.shape)} and flat "
            f"{tuple(flat.shape)} alike [T, k]")
    if expert_rows.device.type == "cpu":
        return moe_combine_reference(expert_rows, w, flat)
    _build.check_device_tensors("moe_combine", (expert_rows,), (flat,),
                                _build.FP16_DTYPES)
    if w.device != expert_rows.device or not w.is_contiguous():
        raise KernelValueError("moe_combine: w must be contiguous on "
                               f"{expert_rows.device}")
    if w.dtype != torch.float32:
        raise KernelTypeError(f"moe_combine: w must be float32, got {w.dtype}")
    EC, M = expert_rows.shape
    T, k = w.shape
    _row_checks("moe_combine", expert_rows, M)
    if not 1 <= k <= _MAX_K:
        raise KernelValueError(f"moe_combine: k = {k} not in [1, {_MAX_K}]")
    out = torch.empty((T, M), dtype=expert_rows.dtype,
                      device=expert_rows.device)
    if T == 0:
        return out
    err = _build.library().ptt_moe_combine(
        expert_rows.data_ptr(), w.data_ptr(), flat.data_ptr(),
        out.data_ptr(), T, EC, k, M,
        _build.dtype_code(expert_rows.dtype, _build.FP16_DTYPES),
        _build.stream(expert_rows.device))
    _build.check(err, "moe_combine")
    moe_combine.launches += 1
    return out


class MoECombine(torch.autograd.Function):
    """Combine with the JAX package's VJP (``_combine_bwd``): the rows'
    cotangent is ``w * g`` scattered to each kept choice's slot (the dummy
    slot's is dropped), and ``dw[t, j]`` is the float32 dot of the routed
    row with ``g[t]`` (0 for a dropped choice)."""

    @staticmethod
    def forward(ctx, expert_rows, w, flat):
        ctx.save_for_backward(expert_rows, w, flat)
        return _combine(expert_rows, w, flat)

    @staticmethod
    def backward(ctx, g):
        rows, w, flat = ctx.saved_tensors
        EC, M = rows.shape
        idx = flat.long()
        kept = idx < EC
        gathered = rows[idx.clamp(max=max(EC - 1, 0))]          # [T, k, M]
        dw = (gathered.float() * g.float()[:, None, :]).sum(-1)
        dw = torch.where(kept, dw, torch.zeros_like(dw)).to(w.dtype)
        d_rows = torch.zeros((EC + 1, M), dtype=g.dtype, device=g.device)
        d_rows.index_add_(0, idx.reshape(-1),
                          (w[:, :, None].to(g.dtype) * g[:, None, :])
                          .reshape(-1, M))
        return d_rows[:EC], dw, None


def moe_combine(expert_rows, w, flat):
    """Weighted un-dispatch: ``out[t] = sum_j w[t, j] *
    expert_rows[flat[t, j]]`` in float32, the dummy slot ``E * C``
    contributing 0, rounded once to the rows' type.  expert_rows ``[E * C,
    M]``; w ``[T, k]`` float32 (another float type is cast: the sum is
    float32 either way); flat ``[T, k]`` int32.  Returns ``[T, M]``.
    Differentiable in expert_rows and w.

    CUDA tensors (rows float32, bfloat16 or float16, contiguous, 16-byte
    aligned, M a multiple of 4 or 8; k <= 8) launch the ``moe_combine`` kernel; CPU
    tensors take :func:`moe_combine_reference`."""
    w = w.float()
    if torch.is_grad_enabled() and (expert_rows.requires_grad
                                    or w.requires_grad):
        return MoECombine.apply(expert_rows, w, flat)
    return _combine(expert_rows, w, flat)


moe_combine.launches = 0


def moe_combine_reference(expert_rows, w, flat):
    """The plain version of ``moe_combine``: a k-row gather from the rows
    with a zero row appended, the products and their sum in float32."""
    M = expert_rows.shape[1]
    rows_pad = torch.cat([expert_rows, expert_rows.new_zeros((1, M))])
    gathered = rows_pad[flat.long()]                            # [T, k, M]
    out = (w[:, :, None].float() * gathered.float()).sum(1)
    return out.to(expert_rows.dtype)
