"""Model quantization: QAT fake quant, PTQ observers and weight-only codes.

Counterpart of ``paddle_tpu/quantization/`` (Paddle's
``python/paddle/quantization/``): ``QuantConfig``, ``QAT``, ``PTQ``,
``QuantedLinear``, ``AbsmaxObserver``, ``FakeQuanterWithAbsMaxObserver``,
the STE round trip, and the weight-only int8/fp8 quantizers that serving
uses (``inference/quant.py``).  ``QuantedConv2D`` waits until the port
has ``Conv2D``.
"""

from .config import QuantConfig
from .observers import AbsmaxObserver
from .ptq import PTQ
from .qat import QAT, QuantedLinear
from .quanters import (FakeQuanterWithAbsMaxObserver, fake_quantize_absmax,
                       quantize_dequantize)
from .weight_only import (dequantize, dequantize_int8,
                          quantize_absmax_fp8, quantize_absmax_int8)

__all__ = ["QuantConfig", "QAT", "PTQ", "QuantedLinear", "AbsmaxObserver",
           "FakeQuanterWithAbsMaxObserver", "fake_quantize_absmax",
           "quantize_dequantize", "quantize_absmax_int8",
           "quantize_absmax_fp8", "dequantize", "dequantize_int8"]
