"""AdamW: counterpart of ``paddle_tpu/optimizer/optimizer.py``
(``_AdamBase`` with ``decoupled=True``, ``AdamW``).

The JAX package's rule (``_AdamBase.rule``), with the global step t:

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2
    w = w - lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * w)

is ``torch.optim.AdamW``'s update exactly (decoupled decay on the weight
before the step), so the port delegates the update to it (``foreach=True``:
a few fused launches over all parameters, the counterpart of the JAX
package's fused whole-tree update).  Around it the port keeps paddle's
interface: ``step()`` clips the gradients first (``grad_clip``),
``clear_grad()``, and ``state_dict()`` / ``set_state_dict()`` with the
JAX package's structured keys (``"gpt.wte.weight@moment1"``,
``"global_step"``; see ``models/convert.py:adamw_state_from_numpy``).
Learning-rate schedulers and the other optimizers are later work.
"""

from __future__ import annotations

import torch

__all__ = ["AdamW"]

_MOMENTS = (("moment1", "exp_avg"), ("moment2", "exp_avg_sq"))


class AdamW:
    """``parameters`` is ``model.parameters()`` or
    ``model.named_parameters()``.  ``apply_decay_param_fun(name) -> bool``
    picks the parameters that decay; it receives a parameter's STRUCTURED
    name (``gpt.blocks.0.attn.qkv.weight``), so it needs named parameters
    (the JAX package passes ``Parameter.name``, a process-wide
    ``param_<n>``)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        if parameters is None:
            raise ValueError("AdamW: pass parameters= explicitly")
        items = list(parameters)
        if items and isinstance(items[0], tuple):
            names = [n for n, _ in items]
            params = [p for _, p in items]
        else:
            if apply_decay_param_fun is not None:
                raise ValueError(
                    "AdamW: apply_decay_param_fun needs the parameters' "
                    "names: pass model.named_parameters()")
            params = items
            names = [f"param_{i}" for i in range(len(params))]
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "AdamW: learning-rate schedulers are not ported yet (see "
                "ROADMAP.md); pass a float")
        self._names = dict(zip(names, params))
        self._params = params
        wd = float(weight_decay or 0.0)
        decays = [apply_decay_param_fun is None or apply_decay_param_fun(n)
                  for n in names]
        groups = [{"params": [p for p, d in zip(params, decays) if d],
                   "weight_decay": wd},
                  {"params": [p for p, d in zip(params, decays) if not d],
                   "weight_decay": 0.0}]
        self._opt = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=float(learning_rate),
            betas=(float(beta1), float(beta2)), eps=float(epsilon),
            foreach=True)
        self._grad_clip = grad_clip
        self._global_step = 0

    def step(self) -> None:
        self._global_step += 1
        if self._grad_clip is not None:
            self._grad_clip([(p, p.grad) for p in self._params
                             if p.grad is not None])
        self._opt.step()

    def clear_grad(self) -> None:
        """Drops the gradients (the next backward writes them anew)."""
        self._opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        out = {"global_step": self._global_step}
        for name, p in self._names.items():
            st = self._opt.state.get(p)
            if st:
                for key, tkey in _MOMENTS:
                    out[f"{name}@{key}"] = st[tkey]
        return out

    def set_state_dict(self, state: dict) -> None:
        """Loads a :meth:`state_dict` (or the converted JAX one): the step
        count and both moments of every parameter named in it."""
        step = int(state["global_step"])
        for name, p in self._names.items():
            if f"{name}@moment1" not in state:
                continue
            st = {"step": torch.tensor(float(step))}
            for key, tkey in _MOMENTS:
                t = state[f"{name}@{key}"]
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"AdamW.set_state_dict: {name}@{key} "
                                     f"{tuple(t.shape)} vs {tuple(p.shape)}")
                st[tkey] = t.detach().to(device=p.device,
                                         dtype=p.dtype).clone()
            self._opt.state[p] = st
        self._global_step = step
