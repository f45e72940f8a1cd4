from . import lr  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import (Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,  # noqa: F401
                        Momentum, Optimizer, RMSProp, SGD)
