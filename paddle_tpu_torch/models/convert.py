"""Carry the JAX package's GPT weights and AdamW state into the port.

``paddle_tpu`` names its parameters as the port does
(``gpt.blocks.0.attn.qkv.weight`` and so on), but its ``Linear`` keeps the
weight as ``[in, out]`` and computes ``x @ W``
(``paddle_tpu/nn/layer/common.py:18``), while ``torch.nn.Linear`` keeps
``[out, in]`` and computes ``x @ W.T``.  The port uses ``torch.nn.Linear``
unchanged, so the conversion TRANSPOSES every linear weight (the MoE
gate's ``gpt.blocks.N.mlp.gate.gate.weight`` among them); embeddings,
biases, LayerNorm parameters and the stacked MoE expert weights
(``experts.w1/b1/w2/b2``, whose layout the port keeps) pass as they are.
The AdamW moments of a linear weight are transposed like the weight.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["gpt_state_from_numpy", "adamw_state_from_numpy"]

_LINEAR_WEIGHTS = (".qkv.weight", ".proj.weight", ".fc1.weight",
                   ".fc2.weight", ".gate.gate.weight")


def gpt_state_from_numpy(state: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Map the JAX ``GPTForCausalLM.state_dict()`` (as numpy arrays) onto
    the port's ``GPTForCausalLM.load_state_dict``."""
    out = {}
    for name, arr in state.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        if name.endswith(_LINEAR_WEIGHTS):
            if t.dim() != 2:
                raise ValueError(f"{name}: expected a 2-D linear weight, "
                                 f"got shape {tuple(t.shape)}")
            t = t.t().contiguous()
        out[name] = t
    return out


def adamw_state_from_numpy(state: Dict[str, np.ndarray], model
                           ) -> Dict[str, torch.Tensor]:
    """Map the JAX ``AdamW.state_dict()``, remapped to structured keys
    (``opt.remap_state_keys(model, sd, to_structured=True)``:
    ``"gpt.blocks.0.attn.qkv.weight@moment1"``, ``"global_step"``) and
    taken as numpy arrays, onto the port's ``AdamW.set_state_dict``, on
    the device of ``model``'s parameters.  Keys without a moment (the
    empty ``LR_Scheduler``) are dropped; any other accumulator raises."""
    params = dict(model.named_parameters())
    out = {"global_step": int(np.asarray(state["global_step"]))}
    for key, arr in state.items():
        if "@" not in key:
            continue
        name, acc = key.rsplit("@", 1)
        if acc not in ("moment1", "moment2") or name not in params:
            raise ValueError(f"adamw_state_from_numpy: {key!r} is not a "
                             "moment of a parameter of the model")
        t = torch.from_numpy(np.array(arr, copy=True))
        if name.endswith(_LINEAR_WEIGHTS):
            t = t.t().contiguous()
        out[key] = t.to(params[name].device)
    return out
