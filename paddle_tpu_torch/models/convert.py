"""Carry the JAX package's model weights and AdamW state into the port.

``paddle_tpu`` names its parameters as the port does
(``gpt.blocks.0.attn.qkv.weight``, ``model.layers.0.self_attn.q_proj.weight``,
``bert.layers.0.attention.qkv.weight``, ...), but its ``Linear`` keeps the
weight as ``[in, out]`` and computes ``x @ W``
(``paddle_tpu/nn/layer/common.py:18``), while ``torch.nn.Linear`` keeps
``[out, in]`` and computes ``x @ W.T``.  So the conversion TRANSPOSES the
weight of every ``nn.Linear`` of the port's model, decided by the type of
the module that owns the parameter (GPT's qkv, proj, fc1, fc2 and the MoE
gate; Llama's q/k/v/o, gate/up/down projections and its untied
``lm_head``; BERT's qkv, out, intermediate, output, pooler, transform and
classifier).  Everything else passes as it is: embeddings (BERT's tied
decoder among them), biases, LayerNorm and RMSNorm parameters,
``decoder_bias`` and the stacked MoE expert weights
(``experts.w1/b1/w2/b2``, whose layout the port keeps).  The AdamW moments
of a linear weight are transposed like the weight.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

__all__ = ["state_from_numpy", "adamw_state_from_numpy"]


def _linear_weights(model: nn.Module) -> set:
    """The names of ``model``'s ``nn.Linear`` weights."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, nn.Linear)}


def _tensor(name, arr, transpose):
    t = torch.from_numpy(np.array(arr, copy=True))
    if not transpose:
        return t
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D linear weight, got shape "
                         f"{tuple(t.shape)}")
    return t.t().contiguous()


def state_from_numpy(state: Dict[str, np.ndarray], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """Map a JAX model's ``state_dict()`` (as numpy arrays) onto
    ``model.load_state_dict`` of the port's model of the same family and
    configuration (GPT, GPT-MoE, Llama or BERT)."""
    linear = _linear_weights(model)
    return {name: _tensor(name, arr, name in linear)
            for name, arr in state.items()}


def adamw_state_from_numpy(state: Dict[str, np.ndarray], model
                           ) -> Dict[str, torch.Tensor]:
    """Map the JAX ``AdamW.state_dict()``, remapped to structured keys
    (``opt.remap_state_keys(model, sd, to_structured=True)``:
    ``"gpt.blocks.0.attn.qkv.weight@moment1"``, ``"global_step"``) and
    taken as numpy arrays, onto the port's ``AdamW.set_state_dict``, on
    the device of ``model``'s parameters.  Keys without a moment (the
    empty ``LR_Scheduler``) are dropped; any other accumulator raises."""
    params = dict(model.named_parameters())
    linear = _linear_weights(model)
    out = {"global_step": int(np.asarray(state["global_step"]))}
    for key, arr in state.items():
        if "@" not in key:
            continue
        name, acc = key.rsplit("@", 1)
        if acc not in ("moment1", "moment2") or name not in params:
            raise ValueError(f"adamw_state_from_numpy: {key!r} is not a "
                             "moment of a parameter of the model")
        out[key] = _tensor(key, arr, name in linear).to(params[name].device)
    return out
