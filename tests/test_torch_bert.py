"""The port's BERT family against the JAX package's, on the CPU.

`bert_tiny(dropout=0.0)` in fp32, weights from the JAX model through
`paddle_tpu_torch/models/convert.py`, the same numpy inputs on both
sides; atol 1e-5 for outputs, losses, gradients and the parameters after
two AdamW steps:

- sequence and pooled output, with and without `attention_mask` (padded
  rows; every row keeps at least one key, where the flash kernels' kv
  mask and the JAX package's masked softmax agree) and `token_type_ids`;
- the MLM loss with ignored labels (-100) and its gradients; the pooler
  takes none, and two AdamW steps leave it untouched on both sides;
- `BertForSequenceClassification` logits; the max-position `ValueError`;
- the attention dropout of BERT's non-causal, masked attention: the
  port's flash keep bits against the JAX flash kernels' (their hash, as
  in `tests/test_torch_train.py`), forward and gradients atol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
from paddle_tpu.models.bert import BertForSequenceClassification as JaxCls
from paddle_tpu.models.bert import bert_base as jax_base
from paddle_tpu.models.bert import bert_tiny as jax_tiny
from paddle_tpu.ops import pallas_flash as jflash
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.bert import (BertForMaskedLM,
                                          BertForSequenceClassification,
                                          bert_base, bert_tiny)
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.nn.functional import attention as tattn

ATOL = 1e-5


def _np(t):
    return np.asarray(t._value)


def _port(jm, cls, cfg, **kw):
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = cls(cfg, device="cpu", seed=1, **kw)
    tm.load_state_dict(state_from_numpy(state, tm))
    return tm


@pytest.fixture(scope="module")
def mlm():
    paddle.seed(0)
    jm = JaxMLM(jax_tiny(dropout=0.0))
    jm.eval()
    tm = _port(jm, BertForMaskedLM, bert_tiny(dropout=0.0)).eval()
    return jm, tm


def _inputs(seed, B=3, S=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int64)
    types = (rng.uniform(size=(B, S)) > 0.5).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 15:] = 0
    mask[2, 3:] = 0
    labels = np.where(rng.uniform(size=(B, S)) < 0.3, ids, -100)
    return ids, types, mask, labels


def _j(a):
    return None if a is None else paddle.to_tensor(a.astype(np.int32))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("typed", [False, True])
def test_sequence_and_pooled_output_match_jax(mlm, masked, typed):
    jm, tm = mlm
    ids, types, mask, _ = _inputs(1)
    types = types if typed else None
    mask = mask if masked else None
    jseq, jpool = jm.bert(_j(ids), _j(types), _j(mask))
    with torch.no_grad():
        tseq, tpool = tm.bert(_t(ids), _t(types), _t(mask))
    np.testing.assert_allclose(tseq.numpy(), _np(jseq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), _np(jpool), atol=ATOL, rtol=0)
    if not typed:         # None is segment 0, which is added
        with torch.no_grad():
            zeros = tm.bert(_t(ids), torch.zeros_like(_t(ids)), _t(mask))[0]
        assert torch.equal(zeros, tseq)


def _jax_grads(jm):
    names = {id(p): n for n, p in jm.named_parameters()}
    return {names[id(p)]: _np(p.grad)
            for p in jm.parameters() if p.grad is not None}


def test_mlm_loss_and_grads_match_jax(mlm):
    jm, tm = mlm
    ids, types, mask, labels = _inputs(2)
    jl = jm.compute_loss(_j(ids), paddle.to_tensor(labels), -100, _j(types),
                         _j(mask))
    jl.backward()
    tl = tm.compute_loss(_t(ids), _t(labels), -100, _t(types), _t(mask))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.item()), atol=ATOL,
                               rtol=0)
    want = state_from_numpy(_jax_grads(jm), tm)
    got = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    assert set(want) == set(got)
    assert not any(n.startswith("bert.pooler") for n in got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)
    # every label ignored: paddle's mean is 0
    none = np.full_like(labels, -100)
    assert tm.compute_loss(_t(ids), _t(none)).item() == 0.0


def test_adamw_steps_match_jax_and_leave_the_pooler():
    lr, steps = 1e-4, 2
    paddle.seed(3)
    jm = JaxMLM(jax_tiny(dropout=0.0))
    tm = _port(jm, BertForMaskedLM, bert_tiny(dropout=0.0))
    pooler = {n: p.detach().clone() for n, p in tm.named_parameters()
              if n.startswith("bert.pooler")}
    jopt = joptim.AdamW(learning_rate=lr, parameters=jm.parameters(),
                        weight_decay=0.01,
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=lr, parameters=tm.parameters(),
                        weight_decay=0.01,
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    ids, types, mask, labels = _inputs(4)
    for _ in range(steps):
        jl = jm.compute_loss(_j(ids), paddle.to_tensor(labels), -100,
                             _j(types), _j(mask))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tm.compute_loss(_t(ids), _t(labels), -100, _t(types), _t(mask))
        tl.backward()
        topt.step()
        topt.clear_grad()
        assert abs(tl.item() - float(jl.item())) < ATOL
    want = state_from_numpy({k: _np(v) for k, v in jm.state_dict().items()},
                            tm)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)
    # no gradient, no step: weight decay did not touch the pooler either
    for name, p in pooler.items():
        assert torch.equal(tm.state_dict()[name], p)
        assert torch.equal(want[name], p)


def test_auto_cast_o1_bf16_loss_matches_jax(mlm):
    jm, tm = mlm
    ids, types, mask, labels = _inputs(5)
    with jamp.auto_cast(True, level="O1", dtype="bfloat16"):
        jl = float(jm.compute_loss(_j(ids), paddle.to_tensor(labels), -100,
                                   _j(types), _j(mask)).item())
    with tamp.auto_cast(True, device="cpu"), torch.no_grad():
        tl = tm.compute_loss(_t(ids), _t(labels), -100, _t(types), _t(mask))
    assert tl.dtype == torch.float32
    assert abs(tl.item() - jl) < 2e-2


def test_sequence_classification_and_max_position():
    paddle.seed(4)
    jm = JaxCls(jax_tiny(dropout=0.0), num_classes=3)
    jm.eval()
    tm = _port(jm, BertForSequenceClassification, bert_tiny(dropout=0.0),
               num_classes=3).eval()
    ids, types, mask, _ = _inputs(6)
    want = _np(jm(_j(ids), _j(types), _j(mask)))
    with torch.no_grad():
        got = tm(_t(ids), _t(types), _t(mask))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    too_long = torch.zeros((1, 129), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(too_long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        jm(paddle.to_tensor(np.zeros((1, 129), np.int32)))
    # the presets are the JAX package's; the refusals
    assert vars(bert_base()) == vars(jax_base())
    assert vars(bert_tiny(num_layers=3)) == vars(jax_tiny(num_layers=3))
    assert bert_tiny(use_recompute=True).use_recompute    # ported
    assert bert_tiny(tensor_parallel=True).tensor_parallel   # ported
    mlm_ = BertForMaskedLM(bert_tiny(), device="cpu")
    assert mlm_.num_params() == int(JaxMLM(jax_tiny()).num_params())


@pytest.fixture
def hash_dropout(monkeypatch):
    """The JAX flash kernels' dropout down the generic interpreter, where
    they draw their keep mask with `_hash_bits` (as in
    `tests/test_torch_train.py`)."""
    monkeypatch.setattr(jflash, "_resolve_interpret", lambda i, r: True)


def test_attention_dropout_bits_match_the_jax_flash_kernels(hash_dropout):
    """BERT's self-attention in training, dropout 0.1, padded rows: the
    port's output and gradients against the JAX flash kernels run on the
    same q, k, v, kv mask and seed (the one the layer drew from the
    model's generator)."""
    rate = 0.1
    tm = BertForMaskedLM(bert_tiny(dropout=rate, hidden_size=128,
                                   num_heads=4), device="cpu", seed=7)
    tm.train()
    att = tm.bert.layers[0].attention
    B, S, H, nh = 2, 96, 128, 4
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((B, S, H)).astype(np.float32))
    mask = np.ones((B, S), np.int32)
    mask[1, 60:] = 0
    keep = torch.from_numpy(mask > 0)[:, None, None, :]
    state = tm.generator.get_state()
    seed = tattn._draw_seed(tm.generator)
    tm.generator.set_state(state)
    qkv = att.qkv(x).detach().view(B, S, 3, nh, H // nh)
    q, k, v = (qkv[:, :, i].contiguous().requires_grad_() for i in range(3))
    out = tattn.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, dropout_p=rate, generator=tm.generator)
    do = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(do))

    def f(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, False, True,
                                      jnp.asarray(mask), jnp.int32(seed),
                                      None, rate)
    jout, vjp = jax.vjp(f, *(jnp.asarray(t.detach().numpy())
                             for t in (q, k, v)))
    want = [np.asarray(jout)] + [np.asarray(g) for g in
                                 vjp(jnp.asarray(do))]
    for got, w in zip((out, q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.detach().numpy(), w, atol=2e-4,
                                   rtol=0)
    # the layer itself draws that seed: its output is the same attention
    # through the out projection
    tm.generator.set_state(state)
    with torch.no_grad():
        layer_out = att(x, keep)
    np.testing.assert_allclose(
        layer_out.numpy(),
        att.out(torch.tensor(want[0]).reshape(B, S, H)).detach().numpy(),
        atol=2e-4, rtol=0)
    # the dropout did bite
    plain = tattn.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    assert np.abs(plain.detach().numpy() - want[0]).max() > 1e-2
