from .auto_cast import auto_cast, decorate  # noqa: F401
