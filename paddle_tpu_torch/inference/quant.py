"""Weight-only quantized serving: the engine's weights as int8 or fp8 codes.

Counterpart of ``paddle_tpu/inference/quant.py``.  There the serving
engine snapshots the model's state dict at construction
(:func:`snapshot`: the matmul weights quantized per output channel, the
rest kept), feeds the snapshot to every compiled program and dequantizes
it in the trace (:func:`dequant_values`), so that XLA fuses the scale
multiply into the consuming matmuls.  The port keeps the snapshot and its
accounting, key for key (the port's state-dict keys are the JAX keys,
``models/convert.py``), and serves it through a twin of the model
(:func:`quantize_model`): every quantized ``nn.Linear`` becomes a
:class:`WeightOnlyLinear` whose forward is ``ops/weight_only.py``'s
``weight_only_forward`` (the ``weight_only_matmul`` kernel for the tick's
rows, ``weight_only_gemm`` for the prompts'), and the token embedding a
:class:`WeightOnlyEmbedding` (the lookup gathers code rows times scale
rows; GPT's tied head runs through the kernels with the per-vocabulary-row
scale). The twin holds no reference to the model's floating-point matmul
weights, and later edits of the live model do not reach it: the JAX
engine's snapshot semantics.

Which leaves quantize (the JAX rule, on the JAX keys and layout): 2-D
``*.weight`` matrices.  Token embeddings (``wte`` / ``embed_tokens``)
reduce over the hidden axis: one scale per vocabulary row serves both the
lookup and the tied head.  Positional embeddings (``wpe``, rotary tables)
and 1-D tensors (norms, biases) stay in floating point, and so do the
3-D stacked MoE expert weights; a 2-D MoE gate weight is quantized.  The
JAX package keeps a linear weight as ``[in, out]`` and reduces it over
axis 0; the port's ``nn.Linear`` keeps ``[out, in]``, so the same channel
is reduced over axis 1 (``transposed`` below), and codes and scales are
the JAX ones transposed, bit for bit.

Tensor-parallel serving quantizes its plan instead
(:func:`quantize_plan`, :func:`plan_stats`; ``inference/tp.py``): the
plan keeps the JAX layout, so its codes and scales are the JAX plan's,
and each rank runs its column shard on the weight-only route.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..ops.weight_only import dequantize, weight_only_forward
from ..quantization.weight_only import (quantize_absmax_fp8,
                                        quantize_absmax_int8)

__all__ = ["WeightSnapshot", "snapshot", "dequant_values", "MODES",
           "quantize_model", "WeightOnlyLinear", "WeightOnlyEmbedding",
           "quantize_plan", "plan_stats"]

MODES = ("int8", "fp8")
_QUANTIZERS = {"int8": quantize_absmax_int8, "fp8": quantize_absmax_fp8}

# key-name hints, checked against the LAST two dotted components
_EMBED_HINTS = ("wte", "embed_tokens", "tok_embeddings")
_SKIP_HINTS = ("wpe", "pos_emb", "position_embeddings", "rotary")


def _quant_axis(key: str, arr) -> Optional[int]:
    """Reduction (contraction) axis for this leaf in the JAX layout, or
    None = keep fp."""
    if getattr(arr, "ndim", 0) != 2 or not key.endswith(".weight"):
        return None
    parts = key.lower().split(".")
    tail = parts[-3:-1] if len(parts) >= 3 else parts[:-1]
    if any(h in p for p in tail for h in _SKIP_HINTS):
        return None
    if any(h in p for p in tail for h in _EMBED_HINTS):
        return 1          # [V, H]: per-vocab-row scale (lookup + tied head)
    return 0              # [in, out] linear: per-output-column scale


class WeightSnapshot:
    """The quantized state dict.

    ``values`` is aligned with the sorted keys: a tensor for fp leaves, a
    ``(codes, scale)`` pair for quantized ones; ``axes`` records the axis
    each quantized leaf was reduced over, in the port's layout (None =
    fp).  Byte counts feed ``stats()["quant"]``."""

    def __init__(self, values: List[Any], axes: List[Optional[int]],
                 weight_bytes: int, fp_weight_bytes: int,
                 mode: str = "int8"):
        self.values = values
        self.axes = axes
        self.weight_bytes = weight_bytes
        self.fp_weight_bytes = fp_weight_bytes
        self.mode = mode

    @property
    def ratio(self) -> float:
        return round(self.fp_weight_bytes / max(self.weight_bytes, 1), 2)

    def stats(self) -> Dict[str, Any]:
        return {"mode": self.mode,
                "quantized_tensors": sum(a is not None for a in self.axes),
                "weight_bytes": self.weight_bytes,
                "fp_weight_bytes": self.fp_weight_bytes,
                "ratio": self.ratio}


def snapshot(keys: List[str], values: List[Any], mode: str = "int8",
             transposed=()) -> WeightSnapshot:
    """Quantize a state dict (once per engine).  ``transposed`` names the
    keys whose tensors are the transpose of the JAX layout (the port's
    ``nn.Linear`` weights): they are reduced over the other axis, so each
    output channel still owns a scale.  An unknown ``mode`` raises the JAX
    engine's error."""
    if mode not in MODES:
        raise ValueError(f"FLAGS_serving_quant supports {MODES}; "
                         f"got {mode!r}")
    quantize = _QUANTIZERS[mode]
    transposed = set(transposed)
    out, axes, qb, fb = [], [], 0, 0
    for key, v in zip(keys, values):
        v = torch.as_tensor(v)
        nbytes = v.numel() * v.element_size()
        fb += nbytes
        axis = _quant_axis(key, v)
        if axis is not None and key in transposed:
            axis = 1 - axis
        if axis is None:
            out.append(v)
            qb += nbytes
        else:
            q, s = quantize(v, axis=axis)
            out.append((q, s))
            qb += q.numel() + s.numel() * s.element_size()
        axes.append(axis)
    return WeightSnapshot(out, axes, qb, fb, mode)


def dequant_values(values, axes) -> List[Any]:
    """The floating-point state a model expects, from a snapshot's values
    (the JAX programs' in-trace inverse; the port's engine serves the
    codes through the twin instead)."""
    return [v if a is None else dequantize(*v)
            for v, a in zip(values, axes)]


class WeightOnlyLinear(nn.Module):
    """An ``nn.Linear`` of the serving twin: ``qweight`` ``[out, in]`` int8
    or fp8 codes, ``scale`` ``[out]`` and ``bias`` ``[out]`` (or None) in
    the activations' type, all buffers; the forward is
    ``weight_only_forward`` (the weight-only kernels; shapes or types they
    do not take: the counted dequantize route)."""

    def __init__(self, qweight, scale, bias=None):
        super().__init__()
        self.out_features, self.in_features = qweight.shape
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", None if bias is None
                             else bias.detach().clone())

    def forward(self, x):
        return weight_only_forward(x, self.qweight, self.scale, self.bias)


class WeightOnlyEmbedding(nn.Module):
    """The token embedding of the serving twin: ``qweight`` ``[V, H]``
    codes and ``scale`` ``[V]``, one per vocabulary row.  The lookup is
    the code rows times their scales (the rows of the JAX program's
    dequantized table, bit for bit); ``attend(h)``, GPT's tied head, runs
    through ``weight_only_forward``."""

    def __init__(self, qweight, scale):
        super().__init__()
        self.num_embeddings, self.embedding_dim = qweight.shape
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)

    def forward(self, ids):
        # gathered as bytes: index kernels need not know the fp8 type
        codes = self.qweight.view(torch.uint8)[ids].view(self.qweight.dtype)
        return dequantize(codes, self.scale[ids][..., None])

    def attend(self, h):
        return weight_only_forward(h, self.qweight, self.scale)


def quantize_model(model: nn.Module, mode: str = "int8"):
    """The serving twin of ``model`` in ``mode`` and its
    :class:`WeightSnapshot`.  The twin is a deep copy of the model without
    the quantized weights: each quantized ``nn.Linear`` is a
    :class:`WeightOnlyLinear`, the token embedding a
    :class:`WeightOnlyEmbedding`; everything else (norms, biases,
    position embeddings, MoE experts) is copied as it is."""
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    state = model.state_dict()
    keys = sorted(state)
    snap = snapshot(keys, [state[k] for k in keys], mode, transposed=linear)
    quantized = {k: v for k, v, a in zip(keys, snap.values, snap.axes)
                 if a is not None}
    # the deep copy skips the quantized weights: it never holds them
    memo = {id(p): None for name, p in model.named_parameters()
            if name in quantized}
    twin = copy.deepcopy(model, memo)
    for key, (q, s) in quantized.items():
        path = key[:-len(".weight")]
        parent_path, _, name = path.rpartition(".")
        parent = twin.get_submodule(parent_path)
        old = parent.get_submodule(name)
        if isinstance(old, nn.Linear):
            new = WeightOnlyLinear(q, s.reshape(-1), old.bias)
        elif isinstance(old, nn.Embedding):
            new = WeightOnlyEmbedding(q, s.reshape(-1))
        else:
            raise TypeError(f"quantize_model: {key} belongs to a "
                            f"{type(old).__name__}, which has no quantized "
                            "twin")
        parent._modules[name] = new
    return twin, snap


def quantize_plan(plan, mode: str = "int8") -> None:
    """Quantize a tensor-parallel plan (``inference/tp.py``) in place,
    before it is sharded: every matmul weight (``qkv_w`` ``[H, 3, nh,
    hd]``, ``proj_w``, ``fc1_w``, ``fc2_w`` ``[in, out]``) becomes
    ``{"q": codes, "s": scale}`` reduced over its contraction axis 0, and
    ``wte`` ``[V, H]`` over H, so its per-row scale shards with the
    vocabulary.  The scale keeps its reduced axis of size 1, so it shards
    on the weight's own axis.  The JAX ``quantize_plan``."""
    if mode not in MODES:
        raise ValueError(f"FLAGS_serving_quant supports {MODES}; "
                         f"got {mode!r}")
    quantize = _QUANTIZERS[mode]

    def q(name, holder):
        qv, s = quantize(holder[name], axis=1 if name == "wte" else 0)
        holder[name] = {"q": qv, "s": s}
    q("wte", plan.params)
    for blk in plan.params["blocks"]:
        for name in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
            q(name, blk)
    plan.meta["quant"] = mode


def plan_stats(plan) -> Dict[str, Any]:
    """Weight bytes of a quantized plan (before sharding), in
    :meth:`WeightSnapshot.stats`'s schema: the JAX ``plan_stats``."""
    acc = {"qb": 0, "fb": 0, "n": 0}

    def walk(x):
        if isinstance(x, dict) and set(x) == {"q", "s"}:
            q, s = x["q"], x["s"]
            acc["qb"] += q.numel() + s.numel() * s.element_size()
            acc["fb"] += q.numel() * s.element_size()
            acc["n"] += 1
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            b = x.numel() * x.element_size()
            acc["qb"] += b
            acc["fb"] += b
    walk(plan.params)
    return {"mode": plan.meta.get("quant"), "quantized_tensors": acc["n"],
            "weight_bytes": acc["qb"], "fp_weight_bytes": acc["fb"],
            "ratio": round(acc["fb"] / max(acc["qb"], 1), 2)}
