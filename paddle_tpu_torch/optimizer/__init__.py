from .optimizer import AdamW  # noqa: F401
