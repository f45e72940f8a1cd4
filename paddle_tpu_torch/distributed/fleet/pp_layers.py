"""The pipeline layer container: counterpart of
``paddle_tpu/distributed/fleet/pp_layers.py`` (Paddle's
``meta_parallel/parallel_layers/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer`` with uniform or by-class
segmentation).

As in the JAX package the container builds EVERY stage: its stage
boundaries drive the host-level micro-batch loop
(``pipeline_parallel.py``), where one process runs the stages back to
back; the per-rank schedules over p2p are ``spmd_pipeline.py`` and
``hybrid_step.py``.  A ``SharedLayerDesc`` key is built once, so tied
weights are one ``Parameter``.
"""

from __future__ import annotations

from typing import Callable, List

import torch.nn as nn

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._recompute_interval = recompute_interval

        # shared descs share one instance per key
        self._shared_layers = {}
        built: List[nn.Module] = []
        self._descs = list(layers)
        for desc in self._descs:
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name not in self._shared_layers:
                    self._shared_layers[desc.layer_name] = desc.build_layer()
                built.append(self._shared_layers[desc.layer_name])
            elif isinstance(desc, LayerDesc):
                built.append(desc.build_layer())
            elif isinstance(desc, nn.Module):
                built.append(desc)
            elif callable(desc):
                built.append(_FnLayer(desc))
            else:
                raise TypeError(f"bad pipeline entry {desc!r}")
        self.run_function = nn.ModuleList(built)
        self._segment(seg_method)

    def _segment(self, seg_method):
        n = len(self.run_function)
        stages = self._num_stages
        if seg_method.startswith("layer:"):
            # cut at layers of the given class name
            cls_name = seg_method.split(":", 1)[1]
            marks = [i for i, layer in enumerate(self.run_function)
                     if type(layer).__name__ == cls_name]
            per = max(len(marks) // stages, 1)
            bounds = [0]
            for s in range(1, stages):
                k = min(s * per, len(marks) - 1)
                bounds.append(marks[k])
            bounds.append(n)
        else:  # uniform
            per = (n + stages - 1) // stages
            bounds = [min(i * per, n) for i in range(stages)] + [n]
        self.segment_parts = bounds

    def get_stage_layers(self, stage_id: int) -> List[nn.Module]:
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        return list(self.run_function)[lo:hi]

    def stage_forward(self, stage_id: int, x):
        for layer in self.get_stage_layers(stage_id):
            x = layer(x)
        return x

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x

    def get_shared_layer(self, key):
        return self._shared_layers[key]


class _FnLayer(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)
