"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for the NVIDIA H100.

It serves GPT through the paged continuous-batching engine
(``inference.serving.ServingEngine``) and trains it (``amp``,
``optimizer``, ``nn``), dense or GPT-MoE (``incubate.distributed.models.
moe``), with hand-written CUDA kernels for the flash attention forward
and backward, paged decode, chunked prefill and the MoE token dispatch
and combine (``ops/``, ``csrc/``).  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where the kernels' plain PyTorch versions
run instead.  The package imports ``torch``, never ``jax`` or
``paddle_tpu``.
"""

from .core.device import resolve_device  # noqa: F401
