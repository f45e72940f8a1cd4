"""Post-training quantization.

Counterpart of ``paddle_tpu/quantization/ptq.py`` (Paddle's ``PTQ``:
``quantize`` inserts observers, calibration batches run through the
model, ``convert`` freezes the observed scales).
"""

from __future__ import annotations

import copy
import itertools

import torch
import torch.nn as nn

from .observers import AbsmaxObserver
from .qat import QAT

__all__ = ["PTQ"]


class PTQ(QAT):
    """Calibrate with observers, then ``convert`` to frozen fake quant.

    flow:  q = PTQ(QuantConfig(activation=AbsmaxObserver,
                               weight=AbsmaxObserver))
           model_q = q.quantize(model)
           q.calibrate(model_q, batches)               # observe
           final = q.convert(model_q)                  # freeze scales
    """

    def calibrate(self, model: nn.Module, data_loader, num_batches=None,
                  input_index=0):
        """Drive calibration batches (any iterable: tensors, or tuples
        whose ``input_index`` entry is the model input) through the
        observing model, without gradients."""
        it = data_loader if num_batches is None \
            else itertools.islice(data_loader, num_batches)
        with torch.no_grad():
            for batch in it:
                x = batch[input_index] \
                    if isinstance(batch, (tuple, list)) else batch
                model(x)
        return model

    def convert(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        model = model if inplace else copy.deepcopy(model)
        for layer in model.modules():
            if isinstance(layer, AbsmaxObserver):
                layer.observe(False)
        return model
