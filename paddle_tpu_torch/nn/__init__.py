"""The parts of the JAX package's ``nn`` that the port's training path
needs: functionals (attention, dropout, cross-entropy, RMSNorm),
``RMSNorm``, gradient clipping (by value, norm and global norm), and
``nn.quant``'s weight-only linear ops."""

from . import functional, quant  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from .norm import RMSNorm  # noqa: F401
