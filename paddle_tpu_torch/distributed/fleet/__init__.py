"""Fleet utilities of the port: so far ``recompute`` (activation
recomputation)."""

from .recompute import recompute  # noqa: F401
