"""GPT model family (decoder-only, GPT-2/3 style): training and serving.

Counterpart of ``paddle_tpu/models/gpt.py``: pre-LayerNorm blocks (eps
1e-5), learned position embedding, tanh-GELU MLP, output head tied to the
token embedding, dropout on the embeddings, the residual branches and the
attention probabilities.  GPT-MoE (``moe_num_experts > 0``): every
``moe_every_n_layers``-th block's MLP is a mixture of experts
(``incubate/distributed/models/moe``, GShard top-2 by default) whose
dispatch and combine run on the ``moe_dispatch`` / ``moe_combine``
kernels, and ``compute_loss`` adds ``moe_aux_weight`` times each MoE
block's aux loss.  Module and parameter names match the JAX
model's ``state_dict`` (``gpt.wte.weight``,
``gpt.blocks.0.attn.qkv.weight``, ...), so ``models/convert.py`` only has
to transpose the linear weights.

Training: ``forward(input_ids)`` and ``compute_loss(input_ids, labels)``
run cache-less causal attention through the flash kernels (forward and
backward).  ``use_recompute`` (in training) checkpoints every
``recompute_interval``-th dense block through
``distributed/fleet/recompute.py`` with ``recompute_policy`` (None: full
recompute); MoE blocks run without it, as in the JAX model.  Serving and
generation: ``forward_with_cache`` over the caches of ``init_caches``
(dense ``(k, v)`` tuples, ``StaticKVCache``, ``PagedKVCache`` or
``BlockKVCache``, ``models/kv_cache.py``), and ``generate``
(``models/generation.py``).

Tensor parallelism (``tensor_parallel=True`` under ``fleet.init`` with
``mp_degree`` > 1, ``distributed/fleet/mp_layers.py``): qkv / proj and
fc1 / fc2 are column / row-parallel pairs, so a rank holds ``num_heads /
mp`` heads (its attention dropout draws those heads' masks of the whole
model); ``wte`` is a ``VocabParallelEmbedding`` whose tied head gives
this rank's vocabulary slice of the logits; ``compute_loss`` reduces
them through ``ParallelCrossEntropy``, and the logits ``forward``
returns are gathered (the JAX model's are global).  The weights a rank
draws from ``seed`` are its shard of the one-process model's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..incubate.distributed.models.moe import MoELayer
from ..nn.functional import (cross_entropy, dropout,
                             scaled_dot_product_attention)
from ..distributed.fleet.mp_layers import (ParallelCrossEntropy,
                                           VocabParallelEmbedding,
                                           gather_from_mp, init_global_)
from ..observability.flops import training_flops_per_token
from ._common import tp_linear_pair
from .generation import GenerationMixin
from .kv_cache import BlockKVCache, PagedKVCache, StaticKVCache

__all__ = ["GPTConfig", "TiedEmbedding", "GPTAttention", "GPTMLP",
           "GPTBlock", "GPTModel", "GPTForCausalLM", "gpt3_tiny",
           "gpt3_124m", "gpt3_350m", "gpt3_1p3b", "gpt3_6p7b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0  # 0 -> 4 * hidden
    dropout: float = 0.0
    use_recompute: bool = False
    recompute_interval: int = 1
    recompute_policy: str = None
    tensor_parallel: bool = False
    # GPT-MoE: the MLP of every moe_every_n_layers-th block is a mixture
    # of moe_num_experts experts (0 = dense)
    moe_num_experts: int = 0
    moe_every_n_layers: int = 2
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    # the MoE blocks' data plane (the JAX FLAGS_moe_fused_dispatch): the
    # moe_dispatch / moe_combine kernels, or the dense (T, E, C) einsums
    moe_fused_dispatch: bool = True

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.moe_num_experts > 0 and self.moe_every_n_layers < 1:
            raise ValueError(
                "moe_every_n_layers must be >= 1 when moe_num_experts > 0 "
                "(1 = every block is MoE)")


class TiedEmbedding(nn.Embedding):
    """The token embedding, which is also the output head: ``attend(h)`` =
    ``h @ weight.T``.  The head goes through this call, so that the
    quantized serving twin (``inference/quant.py``) can substitute a module
    with the same two calls."""

    def attend(self, h):
        return F.linear(h, self.weight)


def _local_heads(n: int, layer, what: str):
    """``(heads on this rank, mask_heads)`` of ``n`` heads split by
    ``layer``'s model-parallel degree (``mask_heads`` None at degree 1)."""
    degree = getattr(layer, "mp_degree", 1)
    if n % degree:
        raise ValueError(f"{what} {n} is not divisible by the "
                         f"model-parallel degree {degree}")
    local = n // degree
    return local, ((layer.mp_rank * local, n) if degree > 1 else None)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.head_dim = cfg.hidden_size // cfg.num_heads
        H = cfg.hidden_size
        self.qkv, self.proj = tp_linear_pair(cfg.tensor_parallel, H, 3 * H,
                                             row_in=H, row_out=H, parts=3)
        self.num_heads, self.mask_heads = _local_heads(
            cfg.num_heads, self.qkv, "num_heads")
        self.dropout = cfg.dropout
        self.generator = generator

    def forward(self, x, kv_cache=None):
        """Without a cache: causal attention over ``x`` (training), returns
        the output.  With one: attends through the cache, returns
        ``(output, new_cache)``.  A dense cache ``(k, v)`` is concatenated
        with the new keys and values: the prompt (``k_len == s``) and a
        chunk (``k_len > s``) attend under flash's end-aligned causal mask
        (the JAX model's offset mask ``qpos >= kpos``), a decode token
        (``s == 1``) sees the whole cache."""
        b, s = x.shape[:2]
        hidden = self.num_heads * self.head_dim
        q, k, v = self.qkv(x).view(b, s, 3, self.num_heads,
                                   self.head_dim).unbind(2)
        if isinstance(kv_cache, tuple):
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
            out = scaled_dot_product_attention(
                q.contiguous(), k, v, dropout_p=self.dropout,
                is_causal=s > 1, training=self.training,
                generator=self.generator, mask_heads=self.mask_heads)
            return self.proj(out.reshape(b, s, hidden)), (k, v)
        if kv_cache is not None:
            new_cache, out = kv_cache.update_and_attend(q, k, v)
            return self.proj(out.reshape(b, s, hidden)), new_cache
        # the kernels take contiguous tensors; unbind gives strided views
        out = scaled_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            dropout_p=self.dropout, is_causal=True, training=self.training,
            generator=self.generator, mask_heads=self.mask_heads)
        return self.proj(out.reshape(b, s, hidden))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1, self.fc2 = tp_linear_pair(
            cfg.tensor_parallel, cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None, use_moe=False,
                 device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.attn = GPTAttention(cfg, generator)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        if use_moe:
            self.mlp = MoELayer(
                d_model=cfg.hidden_size, num_expert=cfg.moe_num_experts,
                d_hidden=cfg.intermediate_size,
                gate=("gshard" if cfg.moe_top_k == 2 else
                      "switch" if cfg.moe_top_k == 1 else "naive"),
                top_k=cfg.moe_top_k, generator=generator, device=device,
                fused=cfg.moe_fused_dispatch)
        else:
            self.mlp = GPTMLP(cfg)
        self.dropout = cfg.dropout
        self.generator = generator

    def _drop(self, x):
        return dropout(x, self.dropout, self.training, self.generator)

    def forward(self, x, kv_cache=None):
        if kv_cache is None:
            x = x + self._drop(self.attn(self.ln1(x)))
            return x + self._drop(self.mlp(self.ln2(x)))
        a, new_cache = self.attn(self.ln1(x), kv_cache)
        x = x + self._drop(a)
        return x + self._drop(self.mlp(self.ln2(x))), new_cache


class GPTModel(nn.Module):
    """``device`` is where the MoE blocks are built (``GPTForCausalLM``
    builds on ``meta`` and materialises the weights on its own device)."""

    def __init__(self, cfg: GPTConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.generator = generator
        self.wte = (VocabParallelEmbedding if cfg.tensor_parallel
                    else TiedEmbedding)(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        def _is_moe(i):
            return cfg.moe_num_experts > 0 and \
                (i + 1) % cfg.moe_every_n_layers == 0
        self.blocks = nn.ModuleList(GPTBlock(cfg, generator, _is_moe(i),
                                             device)
                                    for i in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids, kv_caches=None, pos_offset=0):
        """input_ids ``[B, s]``; pos_offset an int, a 0-d tensor (prefill
        and chunks) or a ``[B, 1]`` tensor (decode).  Returns the final
        hidden states, and with ``kv_caches`` also the new caches."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device) + pos_offset
        # the padded rows of a bucket may run past the position table;
        # clamp them (their outputs are discarded), as XLA's gather does
        pos = pos.clamp(max=self.cfg.max_seq_len - 1)
        x = dropout(self.wte(input_ids) + self.wpe(pos), self.cfg.dropout,
                    self.training, self.generator)
        if kv_caches is None:
            if self.cfg.use_recompute and self.training:
                k = max(1, self.cfg.recompute_interval)
                for i, block in enumerate(self.blocks):
                    if isinstance(block.mlp, MoELayer) or i % k:
                        # the gate's aux loss leaves an MoE block as an
                        # attribute: MoE blocks are not checkpointed (as
                        # in the JAX model)
                        x = block(x)
                    else:
                        x = recompute(block, x,
                                      policy=self.cfg.recompute_policy)
            else:
                for block in self.blocks:
                    x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.blocks, kv_caches):
            x, nc = block(x, cache)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT with the tied output head.

    ``GPTForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``
    builds the weights on ``device`` (``cuda`` by default; raises without
    CUDA unless ``device="cpu"``) from a ``torch.Generator`` seeded with
    ``seed``: embeddings and linear weights ~ N(0, 0.02), biases 0,
    LayerNorm 1 / 0; MoE experts as the JAX layer inits them
    (``ExpertMLP.reset_parameters``).  Real weights come through
    ``load_state_dict`` (see ``models/convert.py`` for the JAX model's).

    Dropout draws from ``self.generator``, a host ``torch.Generator`` that
    the model owns, seeded with ``seed``: the flash kernels' dropout seed
    is one draw of it, and the elementwise dropouts seed a generator on
    the card from it, so the host never waits for the card.
    """

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.generator = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            self.gpt = GPTModel(cfg, self.generator, device="meta")
        self.gpt.to_empty(device=device)
        self.gpt.to(dtype)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        dev = self.gpt.wte.weight.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in self.gpt.named_parameters():
            if ".experts." in name:
                continue
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                init_global_(p, lambda t: t.normal_(0.0, 0.02,
                                                    generator=gen))
        for m in self.gpt.modules():
            if isinstance(m, MoELayer):
                m.experts.reset_parameters(gen)

    # read from the final norm, which the quantized serving twin keeps
    @property
    def device(self) -> torch.device:
        return self.gpt.ln_f.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.ln_f.weight.dtype

    def init_caches(self, batch_size: int, cache_impl: str = "dense",
                    block_size: int = None, max_context: int = None):
        """One fresh cache per layer for ``batch_size`` sequences (the
        JAX model's ``init_caches``): ``"dense"`` ``(k, v)`` tuples of
        length 0; ``"static"`` :class:`StaticKVCache` over ``max_seq_len``;
        ``"paged"`` with ``max_context`` a :class:`PagedKVCache` pool sized
        by that context (blocks of 64), without it a host-allocated
        :class:`BlockKVCache` over ``max_seq_len`` (blocks of 16)."""
        nh = self.gpt.blocks[0].attn.num_heads     # this rank's heads
        return _init_caches(self.cfg, nh, nh, self.dtype, self.device,
                            batch_size, cache_impl, block_size, max_context)

    def _logits(self, h):
        """The tied head's logits, gathered over the mp group under
        tensor parallelism."""
        return gather_from_mp(self.gpt.wte.attend(h),
                              getattr(self.gpt.wte, "mp_group", None))

    def forward_with_cache(self, input_ids, caches, pos_offset=0):
        """Returns ``(logits [B, s, vocab], new_caches)``."""
        h, new_caches = self.gpt(input_ids, caches, pos_offset)
        return self._logits(h), new_caches

    def forward(self, input_ids):
        """Logits ``[B, S, vocab]`` of ``input_ids`` ``[B, S]`` through
        the tied head, causal attention without a cache."""
        return self._logits(self.gpt(input_ids))

    def compute_loss(self, input_ids, labels):
        """Mean cross-entropy of the logits against ``labels`` ``[B, S]``
        (the caller shifts; nothing is shifted here, as in the JAX
        package), plus ``moe_aux_weight`` times each MoE block's aux
        loss.  Under tensor parallelism the vocabulary-sharded logits go
        through ``ParallelCrossEntropy`` (never gathered)."""
        if getattr(self.gpt.wte, "mp_degree", 1) > 1:
            per = ParallelCrossEntropy()(
                self.gpt.wte.attend(self.gpt(input_ids)), labels)
            loss = per.sum() / (labels != -100).sum().clamp_min(1)
        else:
            logits = self(input_ids)
            loss = cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                                 labels.reshape(-1))
        if self.cfg.moe_num_experts > 0:
            for block in self.gpt.blocks:
                aux = getattr(block.mlp, "l_aux", None)
                if aux is not None:
                    loss = loss + self.cfg.moe_aux_weight * aux
        return loss

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len=None) -> float:
        """Train-step FLOPs per token, 6N + 12 L H S
        (``observability/flops.py``)."""
        return training_flops_per_token(
            self.num_params(), self.cfg.num_layers, self.cfg.hidden_size,
            seq_len or self.cfg.max_seq_len)


def _init_caches(cfg, num_heads, dense_heads, dtype, device, batch_size,
                 cache_impl, block_size, max_context):
    """The caches of ``init_caches`` for GPT and Llama: ``dense_heads``
    heads in dense caches (Llama's kv heads), ``num_heads`` in the others
    (Llama repeats its kv heads before those)."""
    hd = cfg.hidden_size // cfg.num_heads
    n = cfg.num_layers
    if cache_impl == "paged" and max_context is not None:
        return [PagedKVCache(batch_size, max_context, num_heads, hd, dtype,
                             block_size or 64, device) for _ in range(n)]
    if cache_impl == "paged":
        block_size = block_size or 16
        max_blocks = -(-cfg.max_seq_len // block_size)
        return [BlockKVCache(batch_size * max_blocks + 1, block_size,
                             num_heads, hd, batch_size, max_blocks, dtype,
                             device) for _ in range(n)]
    if cache_impl == "static":
        return [StaticKVCache(batch_size, cfg.max_seq_len, num_heads, hd,
                              dtype, device) for _ in range(n)]
    if cache_impl != "dense":
        raise ValueError(f"cache_impl {cache_impl!r}: dense, static or "
                         "paged")
    return [(torch.zeros((batch_size, 0, dense_heads, hd), dtype=dtype,
                         device=device),) * 2 for _ in range(n)]


def _preset(defaults, kw):
    defaults.update(kw)  # caller overrides win (e.g. num_layers)
    return GPTConfig(**defaults)


def gpt3_tiny(**kw):
    return _preset(dict(vocab_size=1024, hidden_size=128, num_layers=2,
                        num_heads=4, max_seq_len=256), kw)


def gpt3_124m(**kw):
    return _preset(dict(hidden_size=768, num_layers=12, num_heads=12,
                        max_seq_len=1024), kw)


def gpt3_350m(**kw):
    return _preset(dict(hidden_size=1024, num_layers=24, num_heads=16,
                        max_seq_len=1024), kw)


def gpt3_1p3b(**kw):
    return _preset(dict(hidden_size=2048, num_layers=24, num_heads=16,
                        max_seq_len=2048), kw)


def gpt3_6p7b(**kw):
    return _preset(dict(hidden_size=4096, num_layers=32, num_heads=32,
                        max_seq_len=2048), kw)
