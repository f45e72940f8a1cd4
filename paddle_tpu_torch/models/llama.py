"""Llama-2 model family: training and serving.

Counterpart of ``paddle_tpu/models/llama.py``: RMSNorm pre-norm blocks,
rotary position embeddings (NeoX style), a SwiGLU MLP, no biases, an
untied output head, and grouped-query attention through ``num_kv_heads``.
Module and parameter names match the JAX model's ``state_dict``
(``model.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, ...);
``models/convert.py`` carries its weights over.

Training: ``forward(input_ids)`` and ``compute_loss(input_ids, labels)``
run cache-less causal attention through the flash kernels, which read kv
head ``h // (nh // nkv)`` themselves: K and V are never repeated.
Serving and generation: ``forward_with_cache`` over the caches of
``init_caches`` and ``generate`` (``models/generation.py``).  Dense
caches hold the kv heads; static and paged ones hold ``num_heads`` heads,
so K and V are repeated to the query heads BEFORE their write, as in the
JAX model.

RoPE positions are ``arange(s) + pos_offset``, for the three forms the
serving engine passes: an int (whole-prompt prefill from 0), a 0-d tensor
(a chunk at its start) and a ``[B, 1]`` tensor (decode, verify and draft
steps, one position per row).  cos and sin are computed once per forward
and shared by the layers.  ``use_recompute`` (in training) checkpoints
every layer (``distributed/fleet/recompute.py``, full recompute).

Tensor parallelism (``tensor_parallel=True`` under ``fleet.init`` with
``mp_degree`` > 1): q / k / v and gate / up are column-parallel, o and
down row-parallel, the token embedding vocabulary-parallel, and the
output head whole (as in the JAX model); GQA splits the kv heads by the
same degree, and a degree that does not divide ``num_kv_heads`` raises
when the model is built, before any collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import (fused_rotary_position_embedding,
                                      rope_cos_sin, swiglu)
from ..nn import RMSNorm
from ..nn.functional import cross_entropy, scaled_dot_product_attention
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           init_global_)
from ..observability.flops import training_flops_per_token
from .generation import GenerationMixin
from .gpt import _init_caches, _local_heads

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaForCausalLM", "llama_tiny", "llama2_7b",
           "llama2_13b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0  # 0 -> same as num_heads (MHA); else GQA
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rms_eps: float = 1e-6
    rope_base: float = 10000.0
    use_recompute: bool = False
    tensor_parallel: bool = False

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} does not "
                             f"divide num_heads {self.num_heads}")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.head_dim = cfg.hidden_size // cfg.num_heads
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, self.head_dim
        H = cfg.hidden_size
        if cfg.tensor_parallel:
            # the kv heads' split is checked first: it raises before any
            # layer reads the topology's groups
            from ..distributed.fleet.mp_layers import mp_state
            degree = mp_state()[2]
            if kvh % degree:
                raise ValueError(f"num_kv_heads {kvh} is not divisible by "
                                 f"the model-parallel degree {degree}")
            col = lambda o: ColumnParallelLinear(  # noqa: E731
                H, o, has_bias=False, gather_output=False)
            self.q_proj, self.k_proj, self.v_proj = \
                col(h * hd), col(kvh * hd), col(kvh * hd)
            self.o_proj = RowParallelLinear(h * hd, H, has_bias=False,
                                            input_is_parallel=True)
        else:
            self.q_proj = nn.Linear(H, h * hd, bias=False)
            self.k_proj = nn.Linear(H, kvh * hd, bias=False)
            self.v_proj = nn.Linear(H, kvh * hd, bias=False)
            self.o_proj = nn.Linear(h * hd, H, bias=False)
        self.num_heads, self.mask_heads = _local_heads(h, self.q_proj,
                                                       "num_heads")
        self.num_kv_heads = _local_heads(kvh, self.q_proj,
                                         "num_kv_heads")[0]

    def forward(self, x, rope, kv_cache=None):
        """``rope`` is the forward's ``(cos, sin)``.  Without a cache:
        causal attention over ``x`` (training), returns the output.  With
        one: attends through the cache, returns ``(output, new_cache)``."""
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).view(b, s, nh, hd)
        k = self.k_proj(x).view(b, s, nkv, hd)
        v = self.v_proj(x).view(b, s, nkv, hd)
        cos, sin = rope
        q, k, _ = fused_rotary_position_embedding(q, k, cos=cos, sin=sin)
        if isinstance(kv_cache, tuple):
            # dense caches hold the kv heads; the flash kernels read kv
            # head h // (nh // nkv), as in training (the JAX model's)
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
            out = scaled_dot_product_attention(
                q.contiguous(), k, v, is_causal=s > 1,
                training=self.training, mask_heads=self.mask_heads)
            return self.o_proj(out.reshape(b, s, nh * hd)), (k, v)
        if kv_cache is not None:
            if nkv != nh:
                # static and paged caches hold one kv head per query head
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            new_cache, out = kv_cache.update_and_attend(q, k, v)
            return self.o_proj(out.reshape(b, s, nh * hd)), new_cache
        out = scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=self.training,
                                           mask_heads=self.mask_heads)
        return self.o_proj(out.reshape(b, s, nh * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.intermediate_size
        if cfg.tensor_parallel:
            self.gate_proj = ColumnParallelLinear(H, inter, has_bias=False,
                                                  gather_output=False)
            self.up_proj = ColumnParallelLinear(H, inter, has_bias=False,
                                                gather_output=False)
            self.down_proj = RowParallelLinear(inter, H, has_bias=False,
                                               input_is_parallel=True)
        else:
            self.gate_proj = nn.Linear(H, inter, bias=False)
            self.up_proj = nn.Linear(H, inter, bias=False)
            self.down_proj = nn.Linear(inter, H, bias=False)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, rope, kv_cache=None):
        if kv_cache is None:
            x = x + self.self_attn(self.input_layernorm(x), rope)
            return x + self.mlp(self.post_attention_layernorm(x))
        a, new_cache = self.self_attn(self.input_layernorm(x), rope,
                                      kv_cache)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = (VocabParallelEmbedding if cfg.tensor_parallel
                             else nn.Embedding)(cfg.vocab_size,
                                                cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, input_ids, kv_caches=None, pos_offset=0):
        """input_ids ``[B, s]``; pos_offset an int, a 0-d tensor (chunks)
        or a ``[B, 1]`` tensor (decode).  Returns the final hidden states,
        and with ``kv_caches`` also the new caches."""
        cfg = self.cfg
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device) + pos_offset
        rope = rope_cos_sin(pos, cfg.hidden_size // cfg.num_heads,
                            cfg.rope_base)
        x = self.embed_tokens(input_ids)
        if kv_caches is None:
            if cfg.use_recompute and self.training:
                for layer in self.layers:
                    x = recompute(layer, x, rope)
            else:
                for layer in self.layers:
                    x = layer(x, rope)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            x, nc = layer(x, rope, cache)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Llama with its untied output head.

    ``LlamaForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``
    builds the weights on ``device`` (``cuda`` by default; raises without
    CUDA unless ``device="cpu"``), in ``dtype`` from the start (a 7B model
    is never held in float32 on the way to bfloat16), from a
    ``torch.Generator`` seeded with ``seed``: embeddings and linear weights
    ~ N(0, 0.02), RMSNorm weights 1.  Real weights come through
    ``load_state_dict`` (``models/convert.py`` for the JAX model's).
    """

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.model = LlamaModel(cfg)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
        self.to(dtype)
        self.to_empty(device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                init_global_(p, lambda t: t.normal_(0.0, 0.02,
                                                    generator=gen))

    # read from the final norm, which the quantized serving twin keeps
    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.norm.weight.dtype

    def init_caches(self, batch_size: int, cache_impl: str = "dense",
                    block_size: int = None, max_context: int = None):
        """One fresh cache per layer, as GPT's ``init_caches``: dense
        caches hold ``num_kv_heads`` heads, static and paged ones
        ``num_heads`` (the kv heads repeated before the write, as in the
        JAX model)."""
        attn = self.model.layers[0].self_attn     # this rank's heads
        return _init_caches(self.cfg, attn.num_heads, attn.num_kv_heads,
                            self.dtype, self.device, batch_size, cache_impl,
                            block_size, max_context)

    def forward_with_cache(self, input_ids, caches, pos_offset=0):
        """Returns ``(logits [B, s, vocab], new_caches)``."""
        h, new_caches = self.model(input_ids, caches, pos_offset)
        return self.lm_head(h), new_caches

    def forward(self, input_ids):
        """Logits ``[B, S, vocab]`` of ``input_ids`` ``[B, S]``, causal
        attention without a cache."""
        return self.lm_head(self.model(input_ids))

    def compute_loss(self, input_ids, labels):
        """Mean cross-entropy of the logits against ``labels`` ``[B, S]``
        (the caller shifts, as in the JAX package)."""
        logits = self(input_ids)
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                             labels.reshape(-1))

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
    return LlamaConfig(**defaults)


def llama_tiny(**kw):
    return _preset(dict(vocab_size=1024, hidden_size=128, num_layers=2,
                        num_heads=4, intermediate_size=384, max_seq_len=256),
                   kw)


def llama2_7b(**kw):
    return _preset(dict(hidden_size=4096, num_layers=32, num_heads=32,
                        intermediate_size=11008, max_seq_len=4096), kw)


def llama2_13b(**kw):
    return _preset(dict(hidden_size=5120, num_layers=40, num_heads=40,
                        intermediate_size=13824, max_seq_len=4096), kw)
