"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for the NVIDIA H100.

It serves GPT and Llama through the paged continuous-batching engine
(``inference.serving.ServingEngine``), generates with them
(``model.generate``, ``models.generation``; seeded through
``core.random.seed``) and trains them and BERT in bfloat16 or float16
(``amp``, ``optimizer``, ``nn``; ``models.gpt``, ``models.llama``,
``models.bert``),
GPT dense or GPT-MoE (``incubate.distributed.models.moe``), with
hand-written CUDA kernels for the flash attention forward
and backward, paged decode, chunked prefill, the MoE token dispatch
and combine and the weight-only int8/fp8 linear layers of quantized
serving (``ops/``, ``csrc/``; ``quantization``, ``inference.quant``,
``nn.quant``); ``hapi.Model`` trains with ``io.DataLoader`` and
``metric``, and ``save`` / ``load`` read and write the JAX package's file
format.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where the kernels' plain PyTorch versions
run instead.  The package imports ``torch``, never ``jax`` or
``paddle_tpu``.
"""

from .core.device import resolve_device  # noqa: F401
from .framework.io import load, save  # noqa: F401
