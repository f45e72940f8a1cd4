"""The parts of the JAX package's ``nn`` that the port's training path
needs: functionals (attention, dropout, cross-entropy, RMSNorm),
``RMSNorm`` and global-norm clipping."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .norm import RMSNorm  # noqa: F401
