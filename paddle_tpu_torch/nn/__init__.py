"""The parts of the JAX package's ``nn`` that the port's training path
needs: functionals (attention, dropout, cross-entropy, RMSNorm),
``RMSNorm``, global-norm clipping, and ``nn.quant``'s weight-only linear
ops."""

from . import functional, quant  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .norm import RMSNorm  # noqa: F401
