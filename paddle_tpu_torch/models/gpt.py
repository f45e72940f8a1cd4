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
backward).  Serving: ``forward_with_cache`` over paged KV caches, always
under ``torch.no_grad()``.  Activation recompute and tensor parallelism
wait for later slices (see ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..incubate.distributed.models.moe import MoELayer
from ..nn.functional import (cross_entropy, dropout,
                             scaled_dot_product_attention)
from ..observability.flops import training_flops_per_token
from .kv_cache import PagedKVCache

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt3_tiny", "gpt3_124m", "gpt3_350m",
           "gpt3_1p3b", "gpt3_6p7b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0  # 0 -> 4 * hidden
    dropout: float = 0.0
    use_recompute: bool = False  # True is not ported yet, nor its knobs
    recompute_interval: int = 1
    recompute_policy: str = None
    # GPT-MoE: the MLP of every moe_every_n_layers-th block is a mixture
    # of moe_num_experts experts (0 = dense)
    moe_num_experts: int = 0
    moe_every_n_layers: int = 2
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.moe_num_experts > 0 and self.moe_every_n_layers < 1:
            raise ValueError(
                "moe_every_n_layers must be >= 1 when moe_num_experts > 0 "
                "(1 = every block is MoE)")
        if self.use_recompute or self.recompute_interval != 1 \
                or self.recompute_policy is not None:
            raise NotImplementedError(
                "activation recompute (use_recompute, recompute_interval, "
                "recompute_policy) is not ported yet: see ROADMAP.md")


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = cfg.dropout
        self.generator = generator

    def forward(self, x, kv_cache=None):
        """Without a cache: causal attention over ``x`` (training), returns
        the output.  With one: attends through the cache, returns
        ``(output, new_cache)``."""
        b, s, hidden = x.shape
        q, k, v = self.qkv(x).view(b, s, 3, self.num_heads,
                                   self.head_dim).unbind(2)
        if kv_cache is not None:
            new_cache, out = kv_cache.update_and_attend(q, k, v)
            return self.proj(out.reshape(b, s, hidden)), new_cache
        # the kernels take contiguous tensors; unbind gives strided views
        out = scaled_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            dropout_p=self.dropout, is_causal=True, training=self.training,
            generator=self.generator)
        return self.proj(out.reshape(b, s, hidden))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

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
                top_k=cfg.moe_top_k, generator=generator, device=device)
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
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
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
            for block in self.blocks:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.blocks, kv_caches):
            x, nc = block(x, cache)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
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
                p.normal_(0.0, 0.02, generator=gen)
        for m in self.gpt.modules():
            if isinstance(m, MoELayer):
                m.experts.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def init_caches(self, batch_size: int, max_context: int,
                    block_size: int = 64):
        """One fresh :class:`PagedKVCache` per layer for ``batch_size``
        sequences of up to ``max_context`` tokens."""
        cfg = self.cfg
        return [PagedKVCache(batch_size, max_context, cfg.num_heads,
                             cfg.hidden_size // cfg.num_heads, self.dtype,
                             block_size, self.device)
                for _ in range(cfg.num_layers)]

    def forward_with_cache(self, input_ids, caches, pos_offset=0):
        """Returns ``(logits [B, s, vocab], new_caches)``."""
        h, new_caches = self.gpt(input_ids, caches, pos_offset)
        return F.linear(h, self.gpt.wte.weight), new_caches

    def forward(self, input_ids):
        """Logits ``[B, S, vocab]`` of ``input_ids`` ``[B, S]`` through
        the tied head, causal attention without a cache."""
        return F.linear(self.gpt(input_ids), self.gpt.wte.weight)

    def compute_loss(self, input_ids, labels):
        """Mean cross-entropy of the logits against ``labels`` ``[B, S]``
        (the caller shifts; nothing is shifted here, as in the JAX
        package), plus ``moe_aux_weight`` times each MoE block's aux
        loss."""
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
