"""Weight-only quantized linear layers: the ``weight_only_matmul`` and
``weight_only_gemm`` CUDA kernels and their plain PyTorch version.

The JAX package has no Pallas kernel here: its serving programs
dequantize the int8 or fp8 weight snapshot in the trace
(``paddle_tpu/inference/quant.py`` ``dequant_values``) and XLA fuses the
per-channel scale multiply into the consuming dot
(``paddle_tpu/quantization/weight_only.py:90``), at any shape.  PyTorch
fuses nothing, so the port's counterpart of that fused product is two
hand-written kernels: ``paddle_tpu_torch/csrc/weight_only.cu`` for the
serving tick's few rows, ``csrc/weight_only_gemm.cu`` (warp-specialised:
a TMA producer, ``wgmma`` over codes dequantized into its register
operand) for the prompts' wide products, on the tile schedule that
:func:`gemm_schedule` fixes from the shape.

Both compute ``x @ W.T + bias`` with ``W = dequantize(q, scale[:, None])``:
q ``[N, K]`` int8 or ``float8_e4m3fn`` codes in the ``nn.Linear`` layout,
scale and bias ``[N]`` in x's type.  A CPU tensor takes
:func:`weight_only_matmul_reference`; a CUDA tensor launches the kernel
(counted in each wrapper's ``launches``) or raises if the kernel does not
take it.  ``weight_only_matmul`` takes float32 or bfloat16 x of at most
``KERNEL_MAX_ROWS`` rows, ``weight_only_gemm`` bfloat16 x of more; both
K a multiple of 16 and x contiguous and 16-byte aligned.

The callers (``WeightOnlyLinear``, the tied head, ``nn.quant``) go through
:func:`weight_only_forward`, which decides from the shape and type before
any launch: a product no kernel takes (:func:`dequant_route`: K not a
multiple of 16, float16 or another type, float32 wider than
``KERNEL_MAX_ROWS``, x not contiguous or not aligned) runs the plain
version on the card, as the JAX package leaves it to XLA, and adds one to
``weight_only_matmul.dequant_calls``, never to a ``launches``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import KernelTypeError, KernelValueError

__all__ = ["weight_only_matmul", "weight_only_gemm",
           "weight_only_matmul_reference", "weight_only_forward",
           "dequantize", "dequant_route", "gemm_schedule", "GemmSchedule",
           "KERNEL_MAX_ROWS", "CODE_DTYPES"]

# csrc/weight_only.cu: up to 8 tiles of 16 rows; wider bf16 products are
# csrc/weight_only_gemm.cu's
KERNEL_MAX_ROWS = 128
# code type -> the kernel's qtype
CODE_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

# csrc/weight_only_gemm.cu's tiles: 128 channels (two warpgroups of 64)
# by one of GEMM_ROWS rows of x, in 64-deep k steps
GEMM_CHANNELS = 128
GEMM_ROWS = (256, 128, 64)
GEMM_K_STEP = 64
# A k step's cost by tile height, relative to a 256-row step (the code
# gathers and the dequantize do not shrink with the rows); the time of a
# 256-row step; a split's extra cost: the reduce's launch, and the
# partials' fp32 bytes written and read (and y's) at about this rate.
# Fitted to chip_smoke.py's schedule sweep on an H100 (PERF.md §6).
_GEMM_STEP_COST = {256: 1.0, 128: 0.72, 64: 0.6}
_GEMM_STEP_S = 0.78e-6
_GEMM_REDUCE_S = 2.5e-6
_GEMM_REDUCE_BYTES_PER_S = 2.5e12
_GEMM_MAX_SPLITS = 4
_GEMM_MIN_SPLIT_STEPS = 8       # k steps a split keeps at least


class GemmSchedule(NamedTuple):
    """``weight_only_gemm``'s launch: tiles of ``rows`` rows of x by
    ``GEMM_CHANNELS`` channels, K cut into ``splits`` runs of ``k_steps``
    steps (fp32 partials summed by a second kernel when ``splits`` > 1),
    walked by ``blocks`` persistent blocks."""
    rows: int
    splits: int
    k_steps: int
    blocks: int


@functools.lru_cache(maxsize=None)
def gemm_schedule(M: int, N: int, K: int, sms: int) -> GemmSchedule:
    """The schedule of an ``[M, K] x [N, K]^T`` product on a card of
    ``sms`` SMs: a pure function of the four, so a captured launch replays
    the same work.  Of the tile heights ``GEMM_ROWS`` and K splits (only
    while the tiles leave SMs idle, each split at least
    ``_GEMM_MIN_SPLIT_STEPS`` steps) it takes the least estimated time:
    waves of units times steps a unit times a step's cost at that height,
    plus the reduce's for a split; ties to taller tiles, fewer splits.
    Cached: the wrapper asks at every launch."""
    nk = -(-K // GEMM_K_STEP)
    n_tiles = -(-N // GEMM_CHANNELS)
    best = None
    for rows in GEMM_ROWS:
        m_tiles = -(-M // rows)
        tiles = m_tiles * n_tiles
        for want in range(1, _GEMM_MAX_SPLITS + 1):
            k_steps = -(-nk // want)
            splits = -(-nk // k_steps)
            if splits != want or (splits > 1 and (
                    tiles * (splits - 1) >= sms
                    or k_steps < _GEMM_MIN_SPLIT_STEPS)):
                continue
            units = tiles * splits
            cost = -(-units // sms) * k_steps * _GEMM_STEP_COST[rows]
            if splits > 1:
                cost += (_GEMM_REDUCE_S + M * N * (8 * splits + 2)
                         / _GEMM_REDUCE_BYTES_PER_S) / _GEMM_STEP_S
            key = (cost, -rows, splits)
            if best is None or key < best[0]:
                best = (key, GemmSchedule(rows, splits, k_steps,
                                          min(units, sms)))
    return best[1]


def dequantize(q, scale):
    """``q * scale`` in the scale's type (codes of either format);
    ``scale`` broadcasts against ``q`` (keepdims).  int8 codes enter the
    product directly (one pass over the codes; their cast to the scale's
    type is exact, so the values are those of cast-then-multiply), fp8
    codes, which PyTorch does not promote, are cast first."""
    if q.dtype == torch.int8:
        return q * scale
    return q.to(scale.dtype) * scale


def weight_only_matmul_reference(x, q, scale, bias=None):
    """The plain version: the dequantized weight ``[N, K]`` in the scale's
    type, cast to x's, then ``F.linear``."""
    w = dequantize(q, scale[:, None]).to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


def _rows(x) -> int:
    return math.prod(x.shape[:-1])


def dequant_route(x, q) -> bool:
    """True for an x off the CPU whose product with the codes ``q`` no
    kernel takes: K not a multiple of 16, x neither float32 nor bfloat16,
    float32 with more than ``KERNEL_MAX_ROWS`` rows (the float32 kernel,
    the precision reference of the card-against-CPU checks, stays on FMAs
    for the tick's rows), or x not contiguous or not 16-byte aligned.
    Decided before any launch; the caller then runs
    :func:`weight_only_matmul_reference` and adds one to
    ``weight_only_matmul.dequant_calls``.  A CPU tensor gives False: the
    wrappers take their plain version for it anyway."""
    if x.device.type == "cpu":
        return False
    return (q.shape[-1] % 16 != 0
            or x.dtype not in (torch.float32, torch.bfloat16)
            or (x.dtype == torch.float32 and _rows(x) > KERNEL_MAX_ROWS)
            or not x.is_contiguous() or x.data_ptr() % 16 != 0)


def weight_only_forward(x, q, scale, bias=None):
    """The callers' product, routed from the shape and type before any
    launch: :func:`dequant_route` -> the plain version, counted in
    ``weight_only_matmul.dequant_calls``; more than ``KERNEL_MAX_ROWS``
    rows on the card -> :func:`weight_only_gemm`; otherwise
    :func:`weight_only_matmul` (the plain version for a CPU tensor)."""
    if dequant_route(x, q):
        weight_only_matmul.dequant_calls += 1
        return weight_only_matmul_reference(x, q, scale, bias)
    if x.device.type != "cpu" and _rows(x) > KERNEL_MAX_ROWS:
        return weight_only_gemm(x, q, scale, bias)
    return weight_only_matmul(x, q, scale, bias)


def _checks(kernel, x, q, scale, bias):
    if q.dim() != 2 or scale.shape != (q.shape[0],):
        raise KernelValueError(f"{kernel}: q {tuple(q.shape)} must be "
                               f"[N, K] and scale {tuple(scale.shape)} [N]")
    if x.shape[-1] != q.shape[1]:
        raise KernelValueError(f"{kernel}: x {tuple(x.shape)} does not "
                               f"contract with q {tuple(q.shape)}")
    if q.dtype not in CODE_DTYPES:
        raise KernelTypeError(f"{kernel}: codes must be int8 or "
                              f"float8_e4m3fn, got {q.dtype}")
    if bias is not None and bias.shape != (q.shape[0],):
        raise KernelValueError(f"{kernel}: bias {tuple(bias.shape)} "
                               f"must be [{q.shape[0]}]")


def _device_operands(kernel, x, q, scale, bias):
    """x as ``[M, K]`` after the checks both kernels need on the card."""
    if not x.is_contiguous():
        raise KernelValueError(f"{kernel}: x must be contiguous")
    x2 = x.reshape(-1, x.shape[-1])
    floats = (x2, scale) if bias is None else (x2, scale, bias)
    _build.check_device_tensors(kernel, floats, ())
    if q.device != x.device or not q.is_contiguous() or q.data_ptr() % 16:
        raise KernelValueError(
            f"{kernel}: codes must be contiguous and 16-byte "
            "aligned on x's device")
    if q.shape[1] % 16:
        raise KernelValueError(
            f"{kernel}: K {q.shape[1]} is not a multiple of "
            "16 (the kernel loads 16 codes at a time)")
    return x2


def weight_only_matmul(x, q, scale, bias=None):
    """``x [..., K] @ dequantize(q, scale).T (+ bias)`` -> ``[..., N]``.

    CUDA tensors: x, scale and bias float32 or bfloat16 of one type,
    contiguous, at most ``KERNEL_MAX_ROWS`` rows, K a multiple of 16 (the
    callers send other products elsewhere: :func:`weight_only_forward`).
    CPU tensors take the plain version."""
    _checks("weight_only_matmul", x, q, scale, bias)
    if x.device.type == "cpu":
        return weight_only_matmul_reference(x, q, scale, bias)
    N, K = q.shape
    lead = x.shape[:-1]
    M = _rows(x)
    if M > KERNEL_MAX_ROWS:
        raise KernelValueError(
            f"weight_only_matmul: {M} rows, the kernel takes "
            f"at most {KERNEL_MAX_ROWS} (wider products are "
            "weight_only_gemm's)")
    x2 = _device_operands("weight_only_matmul", x, q, scale, bias)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        err = _build.library().ptt_weight_only_matmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), M, N,
            K, _build.dtype_code(x.dtype), CODE_DTYPES[q.dtype],
            _build.stream(x.device))
        _build.check(err, "weight_only_matmul")
        weight_only_matmul.launches += 1
    return y.reshape(*lead, N)


weight_only_matmul.launches = 0
weight_only_matmul.dequant_calls = 0    # the callers' dequant_route


def weight_only_gemm(x, q, scale, bias=None):
    """``x [..., K] @ dequantize(q, scale).T (+ bias)`` -> ``[..., N]`` for
    wide products (the prompts).

    CUDA tensors: x, scale and bias bfloat16, contiguous, 16-byte aligned,
    more than ``KERNEL_MAX_ROWS`` rows, K a multiple of 16; launched on
    :func:`gemm_schedule`'s tiles (a split K sums its fp32 partials, in
    split order, from a workspace allocated here).  CPU tensors take the
    plain version."""
    _checks("weight_only_gemm", x, q, scale, bias)
    if x.device.type == "cpu":
        return weight_only_matmul_reference(x, q, scale, bias)
    N, K = q.shape
    lead = x.shape[:-1]
    M = _rows(x)
    if M <= KERNEL_MAX_ROWS:
        raise KernelValueError(
            f"weight_only_gemm: {M} rows, the kernel takes "
            f"more than {KERNEL_MAX_ROWS} (narrower products "
            "are weight_only_matmul's)")
    if x.dtype != torch.bfloat16:
        raise KernelTypeError(f"weight_only_gemm: x must be bfloat16, got "
                              f"{x.dtype}")
    x2 = _device_operands("weight_only_gemm", x, q, scale, bias)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    sched = gemm_schedule(M, N, K, _build.sm_count(x.device))
    ws = None if sched.splits == 1 else torch.empty(
        (sched.splits, M, N), dtype=torch.float32, device=x.device)
    err = _build.library().ptt_weight_only_gemm(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K,
        CODE_DTYPES[q.dtype], sched.rows, sched.splits, sched.k_steps,
        sched.blocks, _build.stream(x.device))
    _build.check(err, "weight_only_gemm")
    weight_only_gemm.launches += 1
    return y.reshape(*lead, N)


weight_only_gemm.launches = 0
