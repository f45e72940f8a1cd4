"""MoE layer: gate -> dispatch -> experts -> combine.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``
(``ExpertMLP``, ``MoELayer``) with both of its data planes, chosen at
construction as the JAX layer snapshots ``FLAGS_moe_fused_dispatch``:

- fused (``fused=True``, the default): the gate's index-form routing
  drives the ``moe_dispatch`` and ``moe_combine`` kernels of
  ``ops/moe.py``, and no ``(T, E, C)`` tensor is built;
- dense (``fused=False``, the JAX layer's oracle): the gate's ``(T, E,
  C)`` combine and dispatch tensors, ``einsum("tec,tm->ecm")`` into the
  expert buffers and ``einsum("tec,ecm->tm")`` back, plain large
  products that the JAX package leaves to XLA outside any Pallas kernel.

``audit_dispatch`` goes with the X-ray rewrite (ROADMAP.md A.9).  The
JAX layer's experts shard over an ``ep`` mesh axis under GSPMD; the port
has no mesh, and its expert parallelism is the hybrid step's
(``distributed/fleet/hybrid_step.py``, ``moe_num_experts``), so
``moe_group`` and ``mp_group`` are accepted here and unused.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .....core.device import resolve_device
from .....ops.moe import moe_combine, moe_dispatch, routing_indices
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["ExpertMLP", "MoELayer"]


class ExpertMLP(nn.Module):
    """E two-layer MLPs with stacked weights in the JAX package's layout:
    ``w1 [E, M, H]``, ``b1 [E, 1, H]``, ``w2 [E, H, M]``, ``b2 [E, 1,
    M]``; the experts run as two batched products over E.  The activation
    is the exact (erf) GELU, the JAX layer's default; the dense GPT MLP
    uses the tanh form."""

    def __init__(self, num_expert: int, d_model: int, d_hidden: int):
        super().__init__()
        self.num_expert = num_expert
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.w1 = nn.Parameter(torch.empty(num_expert, d_model, d_hidden))
        self.b1 = nn.Parameter(torch.zeros(num_expert, 1, d_hidden))
        self.w2 = nn.Parameter(torch.empty(num_expert, d_hidden, d_model))
        self.b2 = nn.Parameter(torch.zeros(num_expert, 1, d_model))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX layer's init: w1 ~ U(+-1/sqrt(M)), w2 ~ U(+-1/sqrt(H)),
        biases 0."""
        s1, s2 = 1.0 / math.sqrt(self.d_model), 1.0 / math.sqrt(self.d_hidden)
        if self.w1.device.type == "meta":
            return
        self.w1.uniform_(-s1, s1, generator=generator)
        self.w2.uniform_(-s2, s2, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        """x ``(E, C, d_model)`` -> ``(E, C, d_model)``."""
        h = F.gelu(torch.bmm(x, self.w1) + self.b1)
        return torch.bmm(h, self.w2) + self.b2


class MoELayer(nn.Module):
    """``gate`` is a gate instance or one of "naive" / "switch" /
    "gshard"; ``experts`` an :class:`ExpertMLP` (or give ``num_expert``
    and ``d_hidden``).  After each forward the gate's aux loss is
    ``self.l_aux``, for the caller to add to the training loss.
    ``generator`` (the model's) feeds GShard's random routing.
    ``moe_group`` and ``mp_group`` are the JAX layer's, accepted and
    unused there and here.

    The layer lives on ``device``: ``cuda`` by default (raises without
    CUDA unless ``device="cpu"``), where dispatch and combine run the
    kernels; ``"meta"`` leaves the weights for the caller to materialise,
    as ``GPTForCausalLM`` does.  Given experts or a gate move there.
    ``fused`` picks the data plane once, here (the JAX
    ``FLAGS_moe_fused_dispatch``): the kernels, or the dense einsums."""

    def __init__(self, d_model: int, experts: Optional[ExpertMLP] = None,
                 gate: "BaseGate | str" = "gshard", num_expert: int = None,
                 d_hidden: int = None, top_k: int = 2,
                 capacity_factor: Optional[float] = None, moe_group=None,
                 mp_group=None, generator=None, device=None,
                 fused: bool = True, **gate_kwargs):
        super().__init__()
        meta = device is not None and torch.device(device).type == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        if experts is None:
            if not (num_expert and d_hidden):
                raise ValueError("give experts= or (num_expert=, d_hidden=)")
            experts = ExpertMLP(num_expert, d_model, d_hidden)
        self.experts = experts
        E = experts.num_expert
        if isinstance(gate, str):
            cf = 1.25 if capacity_factor is None else capacity_factor
            if gate == "naive":
                gate = NaiveGate(d_model, E, top_k=top_k,
                                 capacity_factor=cf, **gate_kwargs)
            elif gate == "switch":
                gate = SwitchGate(d_model, E, capacity_factor=cf,
                                  **gate_kwargs)
            elif gate == "gshard":
                if top_k != 2:
                    raise ValueError("gshard gate routes top-2; use "
                                     "gate='naive' for other top_k")
                if "capacity" not in gate_kwargs and \
                        capacity_factor is not None:
                    # a tokens / (E * k) factor as GShard's tokens / E pair
                    gate_kwargs["capacity"] = (2 * capacity_factor,
                                               2 * capacity_factor)
                gate = GShardGate(d_model, E, generator=generator,
                                  **gate_kwargs)
            else:
                raise ValueError(f"unknown gate {gate!r}")
        self.gate = gate
        self.l_aux = None
        self.fused = bool(fused)
        self.to(device)

    def forward(self, x):
        """x ``(..., d_model)``; every leading position is a token."""
        shape = x.shape
        M = shape[-1]
        xt = x.reshape(-1, M)
        if not self.fused:
            combine, dispatch, aux = self.gate(xt)              # (T, E, C)
            self.l_aux = aux
            expert_in = torch.einsum("tec,tm->ecm", dispatch, xt)
            out = torch.einsum("tec,ecm->tm", combine,
                               self.experts(expert_in))
            return out.reshape(shape)
        eid, slot, keep, w, cap, aux = self.gate.forward_indices(xt)
        self.l_aux = aux
        E = self.gate.tot_expert
        flat, inv = routing_indices(eid, slot, keep, E, cap)
        rows = moe_dispatch(xt.contiguous(), inv)               # (E*C, M)
        expert_out = self.experts(rows.view(E, cap, M))         # (E, C, M)
        out = moe_combine(expert_out.reshape(E * cap, M).contiguous(), w,
                          flat)
        return out.reshape(shape)
