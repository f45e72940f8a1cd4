"""The parts of the JAX package's ``incubate.nn`` that the port has."""

from . import functional  # noqa: F401
