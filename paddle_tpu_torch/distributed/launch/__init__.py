"""``python -m paddle_tpu_torch.distributed.launch``: the collective
launcher (``main.py``)."""

from .main import launch, parse_args  # noqa: F401
