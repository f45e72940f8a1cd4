"""MoE gates: naive top-k, Switch (top-1), GShard (top-2), in index form.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/gate.py``:
``capacity``, ``BaseGate``, ``NaiveGate`` (``_prepare``,
``_route_indices``, ``_aux``, ``forward_indices``), ``SwitchGate`` and
``GShardGate`` with its train/eval capacity and random routing.  Each gate
gives, per token and routing choice, the expert id, the slot in that
expert's fixed-capacity buffer, a keep flag (0 past capacity or when
random routing drops the choice) and the renormalised combine weight,
for the fused dispatch of ``ops/moe.py``.  The JAX gates' dense ``(T, E,
C)`` form (``_route``, ``forward``) and expert parallelism (the JAX
gates' ``world_size``) are not ported yet (ROADMAP.md).

Two details fix the routing bit for bit against the JAX package:

- top-k takes the LOWER expert index first among equal probabilities, as
  ``lax.top_k`` does (``torch.topk`` promises no order on ties; under
  bf16 autocast the gate's logits tie often enough to matter), by a
  stable descending sort;
- GShard's random routing draws its uniforms from the model's generator
  on the device (one host draw seeds a device generator, as the model's
  dropout does), through :meth:`GShardGate.uniforms`, which tests replace
  to feed both frameworks the same numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .....nn.functional.common import _device_generator

__all__ = ["BaseGate", "NaiveGate", "SwitchGate", "GShardGate", "capacity"]


def capacity(num_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float, min_capacity: int = 4) -> int:
    cap = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _topk_indices(gates, k: int):
    """Indices of the k largest entries of each row, largest first, the
    lower index first among equals (``lax.top_k``'s order)."""
    return torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]


class BaseGate(nn.Module):
    """``forward_indices(x)`` gives the routing decision in index form;
    the aux loss of the last call is ``get_loss()``."""

    def __init__(self, d_model: int, num_expert: int, top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.tot_expert = num_expert
        self.top_k = top_k
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear: bool = True):
        loss, self.loss = self.loss, (None if clear else self.loss)
        return loss


class NaiveGate(BaseGate):
    """Top-k softmax routing with fixed capacity, no aux loss."""

    def __init__(self, d_model, num_expert, top_k=2,
                 capacity_factor: float = 1.0, min_capacity: int = 4):
        super().__init__(d_model, num_expert, top_k)
        self.gate = nn.Linear(d_model, self.tot_expert)
        self.capacity_factor = capacity_factor
        self.min_capacity = min_capacity

    def _route_indices(self, gates, cap, second_keep=None):
        """Per token and routing choice: expert id (the top-k index),
        buffer slot (running position inside that expert, offset by the
        higher-priority choices' counts INCLUDING their drops), keep flag
        and the gate weight ``gates[t, eid] * keep`` renormalised over the
        kept choices.  Returns (eid, slot, keep, w, frac, mean_gate); eid
        and slot ``[T, k]`` int64, keep and w ``[T, k]`` float."""
        E = self.tot_expert
        idx = _topk_indices(gates, self.top_k)                  # (T, k)
        taken = None
        slots, keeps, ws = [], [], []
        frac = None
        for i in range(self.top_k):
            m = nn.functional.one_hot(idx[:, i], E).float()     # (T, E)
            if i == 0:
                frac = m.mean(0)
            if i == 1 and second_keep is not None:
                m = m * second_keep[:, None]
            # exclusive running count over tokens, scanned as [E, T]: down
            # the outer dim of [T, 4] the scan took ~0.7 ms at T 8192 on an
            # H100 (integers below 2**24 either way, so equal in fp32)
            pos = torch.cumsum(m.t().contiguous(), 1).t() - m
            if taken is not None:
                pos = pos + taken[None]
            m_kept = m * (pos < float(cap)).float()
            # m is one-hot over E (or all 0 when random routing dropped
            # the choice): the row sums pick this choice's expert column
            slots.append((pos * m).sum(1).long().clamp(0, cap - 1))
            keeps.append(m_kept.sum(1))
            ws.append((gates * m_kept).sum(1))
            counts = m.sum(0)                     # drops included
            taken = counts if taken is None else taken + counts
        slot = torch.stack(slots, 1)
        keep = torch.stack(keeps, 1)
        w = torch.stack(ws, 1)
        w = w / w.sum(1, keepdim=True).clamp(min=1e-9)
        return idx, slot, keep, w, frac, gates.mean(0)

    def _gates(self, x):
        """Softmax of the gate's logits: in float32 under autocast (the JAX
        package's O1 keeps softmax in float32), else in their type."""
        logits = self.gate(x)
        amp = torch.is_autocast_enabled(x.device.type)
        return torch.softmax(logits, -1,
                             dtype=torch.float32 if amp else logits.dtype)

    def _prepare(self, x):
        """Gate probabilities, the routing capacity and an optional per-
        token 0/1 keep mask for the second choice."""
        cap = capacity(x.shape[0], self.tot_expert, self.top_k,
                       self.capacity_factor, self.min_capacity)
        return self._gates(x), cap, None

    def _aux(self, frac, mean_gate):
        return torch.zeros((), dtype=torch.float32, device=frac.device)

    def forward_indices(self, x):
        """Routing of x ``[T, d_model]``: returns (eid, slot, keep, w, cap,
        aux) (see :meth:`_route_indices`) and sets the aux loss."""
        gates, cap, second_keep = self._prepare(x)
        eid, slot, keep, w, frac, mean_gate = self._route_indices(
            gates, cap, second_keep)
        aux = self._aux(frac, mean_gate)
        self.set_loss(aux)
        return eid, slot, keep, w, cap, aux


class SwitchGate(NaiveGate):
    """Top-1 routing with the Switch-Transformer load-balance loss
    ``E * sum_e(frac_e * mean_gate_e)``."""

    def __init__(self, d_model, num_expert, top_k=1, capacity_factor=1.0,
                 min_capacity=4):
        if top_k != 1:
            raise ValueError("SwitchGate routes top-1")
        super().__init__(d_model, num_expert, 1, capacity_factor,
                         min_capacity)

    def _aux(self, frac, mean_gate):
        return (frac * mean_gate).sum() * float(self.tot_expert)


class GShardGate(NaiveGate):
    """Top-2 routing with the GShard aux loss, capacity ``(train, eval)``
    in multiples of tokens / E, and random routing of the second choice
    in training: kept with probability ``2 * g2``."""

    def __init__(self, d_model, num_expert, top_k=2, capacity=(1.2, 2.4),
                 generator=None):
        if top_k != 2:
            raise ValueError("GShardGate routes top-2")
        super().__init__(d_model, num_expert, 2)
        self._cap_train, self._cap_eval = capacity
        self.generator = generator

    def uniforms(self, n: int, device) -> torch.Tensor:
        """``n`` float32 uniforms in [0, 1) on ``device`` for random
        routing, from the gate's generator (the model's)."""
        return torch.rand((n,), generator=_device_generator(self.generator,
                                                            device),
                          device=device)

    def _prepare(self, x):
        T = x.shape[0]
        factor = self._cap_train if self.training else self._cap_eval
        cap = capacity(T, self.tot_expert, 1, factor,
                       min_capacity=self.min_capacity)
        gates = self._gates(x)
        second_keep = None
        if self.training:
            g2 = torch.sort(gates, dim=-1, descending=True)[0][:, 1]
            second_keep = (2.0 * g2 > self.uniforms(T, x.device)).float()
        return gates, cap, second_keep

    def _aux(self, frac, mean_gate):
        return (frac * mean_gate).sum() * float(self.tot_expert)
