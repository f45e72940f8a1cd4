from . import debugging  # noqa: F401
from .auto_cast import amp_guard, auto_cast, decorate  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
