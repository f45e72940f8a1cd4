"""BERT model family: masked-LM pretraining and sequence classification.

Counterpart of ``paddle_tpu/models/bert.py``: the original post-LN encoder
(LayerNorm eps 1e-12, exact GELU), learned position and segment
embeddings (``token_type_ids`` None is segment 0, which is added), a
tanh pooler over the first token, the MLM head (dense, GELU, LayerNorm,
a decoder tied to the word embeddings plus ``decoder_bias``) and a
classifier over the pooled output.  Module and parameter names match the
JAX model's ``state_dict`` (``bert.layers.0.attention.qkv.weight``,
``decoder_bias``, ...); ``models/convert.py`` carries its weights over.

Attention is bidirectional through ``scaled_dot_product_attention``: an
``attention_mask`` ``[B, S]`` (1 keeps a key, 0 pads it) becomes the
boolean ``[B, 1, 1, S]`` mask that the flash kernels take as their kv
mask; the attention dropout is the kernels' hashed dropout.  Dropout
draws from ``self.generator``, a host ``torch.Generator`` that the model
owns, seeded with ``seed`` (as in ``models/gpt.py``).  ``use_recompute``
(in training) checkpoints every layer (``distributed/fleet/recompute.py``,
full recompute; the dropout draws are replayed).  Tensor parallelism
(``tensor_parallel=True`` under ``fleet.init`` with ``mp_degree`` > 1):
the encoder's qkv / out and intermediate / output are column / row-parallel
pairs (the JAX ``bert.py:93-121``), the embeddings and heads whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn.functional import (cross_entropy, dropout,
                             scaled_dot_product_attention)
from ..distributed.fleet.mp_layers import init_global_
from ..observability.flops import training_flops_per_token
from ._common import tp_linear_pair
from .gpt import TiedEmbedding, _local_heads

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "bert_base", "bert_tiny"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    tensor_parallel: bool = False
    use_recompute: bool = False


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    defaults = dict(vocab_size=1024, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
    defaults.update(kw)
    return BertConfig(**defaults)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.word_embeddings = TiedEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.dropout = cfg.dropout
        self.generator = generator

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return dropout(self.layer_norm(x), self.dropout, self.training,
                       self.generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.head_dim = cfg.hidden_size // cfg.num_heads
        H = cfg.hidden_size
        self.qkv, self.out = tp_linear_pair(cfg.tensor_parallel, H, 3 * H,
                                            row_in=H, row_out=H, parts=3)
        self.num_heads, self.mask_heads = _local_heads(
            cfg.num_heads, self.qkv, "num_heads")
        self.dropout = cfg.dropout
        self.generator = generator

    def forward(self, x, attention_mask=None):
        """``attention_mask``: the boolean ``[B, 1, 1, S]`` keep mask."""
        b, s = x.shape[:2]
        hidden = self.num_heads * self.head_dim
        q, k, v = self.qkv(x).view(b, s, 3, self.num_heads,
                                   self.head_dim).unbind(2)
        # the kernels take contiguous tensors; unbind gives strided views
        out = scaled_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            attn_mask=attention_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training,
            generator=self.generator, mask_heads=self.mask_heads)
        return self.out(out.reshape(b, s, hidden))


class BertLayer(nn.Module):
    """Post-LN transformer block (the original BERT's order)."""

    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.attention = BertSelfAttention(cfg, generator)
        self.attn_norm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)
        self.intermediate, self.output = tp_linear_pair(
            cfg.tensor_parallel, cfg.hidden_size, cfg.intermediate_size)
        self.out_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.dropout
        self.generator = generator

    def _drop(self, x):
        return dropout(x, self.dropout, self.training, self.generator)

    def forward(self, x, attention_mask=None):
        x = self.attn_norm(x + self._drop(self.attention(x, attention_mask)))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.out_norm(x + self._drop(h))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, generator)
        self.layers = nn.ModuleList(BertLayer(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Returns ``(sequence_output [B, S, H], pooled_output [B, H])``;
        ``attention_mask`` ``[B, S]``, nonzero where a key is kept."""
        if input_ids.shape[1] > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {input_ids.shape[1]} exceeds "
                f"max_position_embeddings="
                f"{self.cfg.max_position_embeddings}")
        if attention_mask is not None:
            attention_mask = (attention_mask > 0)[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            if self.cfg.use_recompute and self.training:
                x = recompute(layer, x, attention_mask)
            else:
                x = layer(x, attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class _BertPretrained(nn.Module):
    """Builds ``_build(cfg)`` on ``meta``, then on ``device`` in ``dtype``,
    and initialises it from ``seed``: embeddings and linear weights ~ N(0,
    initializer_range), biases 0, LayerNorm 1 / 0.  The dropout generator
    is the model's own (see the module docstring)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.generator = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            self._build(cfg)
        self.to(dtype)
        self.to_empty(device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        norms = {f"{n}.{p}" for n, m in self.named_modules()
                 if isinstance(m, nn.LayerNorm) for p in ("weight", "bias")}
        for name, p in self.named_parameters():
            if name in norms:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                init_global_(p, lambda t: t.normal_(
                    0.0, self.cfg.initializer_range, generator=gen))

    @property
    def device(self) -> torch.device:
        return self.bert.pooler.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.bert.pooler.weight.dtype

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertForMaskedLM(_BertPretrained):
    """The MLM head (BASELINE rung 3): dense, GELU, LayerNorm, and the
    decoder tied to the word embeddings plus ``decoder_bias``."""

    def _build(self, cfg):
        self.bert = BertModel(cfg, self.generator)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_norm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Logits ``[B, S, vocab]``."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        # the bias is added after the product, as in the JAX model (under
        # auto_cast: a bfloat16 product plus a float32 bias)
        return self.bert.embeddings.word_embeddings.attend(h) \
            + self.decoder_bias

    def compute_loss(self, input_ids, labels, ignore_index: int = -100,
                     token_type_ids=None, attention_mask=None):
        """Mean cross-entropy over the labels that are not
        ``ignore_index``."""
        logits = self(input_ids, token_type_ids, attention_mask)
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                             labels.reshape(-1), ignore_index=ignore_index)

    def flops_per_token(self, seq_len) -> float:
        """Train-step FLOPs per token, 6N + 12 L H S
        (``observability/flops.py``)."""
        return training_flops_per_token(
            self.num_params(), self.cfg.num_layers, self.cfg.hidden_size,
            seq_len)


class BertForSequenceClassification(_BertPretrained):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 dtype=torch.float32, seed: int = 0):
        self.num_classes = num_classes
        super().__init__(cfg, device, dtype, seed)

    def _build(self, cfg):
        self.bert = BertModel(cfg, self.generator)
        self.classifier = nn.Linear(cfg.hidden_size, self.num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Logits ``[B, num_classes]`` of the pooled output."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(dropout(pooled, self.cfg.dropout,
                                       self.training, self.generator))
