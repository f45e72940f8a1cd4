"""Carry the JAX package's model weights and optimizer state into the port.

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
(``experts.w1/b1/w2/b2``, whose layout the port keeps).  An optimizer's
accumulators and master weights of a linear weight are transposed like
the weight.

Tensor parallelism and ZeRO-3: the JAX package's arrays are GLOBAL (its
sharding is a layout of one array), while a rank of the port holds its
shard (``distributed/fleet/mp_layers.py``, ``sharding.py``).
``state_from_numpy`` and ``optimizer_state_from_numpy`` keep this rank's
shard of each global array (the tensor-parallel split, then the ZeRO-3
slice); :func:`full_state_dict` gathers a model's shards back into global
tensors on every rank (collectives over the groups that split them).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

__all__ = ["state_from_numpy", "optimizer_state_from_numpy",
           "adamw_state_from_numpy", "full_state_dict", "local_shard"]


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


def local_shard(t: torch.Tensor, p) -> torch.Tensor:
    """This rank's part of the global tensor ``t`` (the port's layout)
    for the parameter ``p``: its tensor-parallel shard, then its ZeRO-3
    slice; ``t`` itself for a parameter no rank splits."""
    from ..distributed.fleet.mp_layers import shard_of
    if getattr(p, "mp_split", False):
        t = shard_of(t, p.split_axis, p.split_parts, p.split_rank,
                     p.split_degree)
    dim = getattr(p, "_zero3_dim", None)
    if dim is not None:
        g = p._zero3_group
        k = t.shape[dim] // g.nranks
        t = t.narrow(dim, g.rank * k, k).clone()
    return t


def state_from_numpy(state: Dict[str, np.ndarray], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """Map a JAX model's ``state_dict()`` (as numpy arrays) onto
    ``model.load_state_dict`` of the port's model of the same family and
    configuration (GPT, GPT-MoE, Llama or BERT); under tensor
    parallelism or ZeRO-3 each array becomes this rank's shard."""
    linear = _linear_weights(model)
    params = dict(model.named_parameters())
    out = {}
    for name, arr in state.items():
        t = _tensor(name, arr, name in linear)
        out[name] = local_shard(t, params[name]) if name in params else t
    return out


@torch.no_grad()
def full_state_dict(model: nn.Module, jax_layout: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered into the global
    tensor (a copy on the CPU), on every rank: ZeRO-3 slices over their group,
    then tensor-parallel shards over the mp group.  ``jax_layout``:
    linear weights transposed to the JAX package's ``[in, out]``."""
    from ..distributed import collective as _coll
    from ..distributed.fleet.mp_layers import gather_full
    linear = _linear_weights(model)
    params = dict(model.named_parameters())
    out = {}
    for name, v in model.state_dict().items():
        p = params.get(name)
        t = v.detach()
        if p is not None and getattr(p, "_zero3_dim", None) is not None:
            t = _coll.all_gather_concat(t.contiguous(), p._zero3_dim,
                                        p._zero3_group)
        if p is not None and getattr(p, "mp_split", False):
            t = gather_full(p, t)
        t = t.to("cpu", copy=True)
        out[name] = t.t().contiguous() if jax_layout and name in linear \
            else t
    return out


def optimizer_state_from_numpy(state: Dict[str, np.ndarray], model
                               ) -> Dict[str, torch.Tensor]:
    """Map a JAX optimizer's ``state_dict()``, remapped to structured keys
    (``opt.remap_state_keys(model, sd, to_structured=True)``:
    ``"gpt.blocks.0.attn.qkv.weight@moment1"``, ``"global_step"``,
    ``"LR_Scheduler"``) and taken as numpy arrays, onto the port's
    ``Optimizer.set_state_dict``, on the device of ``model``'s parameters.
    Every accumulator of every optimizer (moments, velocity, Adagrad's
    moment, RMSProp's three, Adadelta's two, Adamax's two) and the
    ``master_weight`` copies are elementwise, so a linear weight's are
    transposed like the weight; the scheduler's state passes as it is.
    A key that names no parameter of the model raises."""
    params = dict(model.named_parameters())
    linear = _linear_weights(model)
    out = {"global_step": int(np.asarray(state["global_step"])),
           "LR_Scheduler": dict(state.get("LR_Scheduler") or {})}
    for key, arr in state.items():
        if key in ("global_step", "LR_Scheduler"):
            continue
        name, sep, acc = key.rpartition("@")
        if not sep or name not in params:
            raise ValueError(f"optimizer_state_from_numpy: {key!r} is not "
                             "an accumulator of a parameter of the model")
        out[key] = local_shard(_tensor(key, arr, name in linear),
                               params[name]).to(params[name].device)
    return out


# the name of earlier slices, which carried AdamW's moments alone
adamw_state_from_numpy = optimizer_state_from_numpy
