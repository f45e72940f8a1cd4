"""The port's Llama family against the JAX package's, on the CPU.

The same numpy inputs go through the JAX package and the port (CPU
tensors, where the attention wrappers take their plain versions);
weights go from the JAX model to the port through
`paddle_tpu_torch/models/convert.py`.  Tolerances:

- RoPE and RMSNorm: fp32 atol 1e-6; bf16 within one bf16 ulp of the JAX
  result (the two frameworks round a bf16 product in their own orders);
- logits of `forward` and `forward_with_cache` (prefill from empty, a
  chunk at a 0-d start through the chunk view, decode steps at per-row
  `[B, 1]` positions), fp32: atol 1e-4 (two frameworks' matmul and
  softmax orders over two layers);
- `compute_loss` and its gradients: atol 1e-5;
- two AdamW steps with global-norm clipping: losses atol 1e-5, parameters
  atol 1e-5, and no parameter moved by more than 2 x lr x steps from the
  JAX one (reference fact 6 of ROADMAP.md: Adam steps a weight whose
  gradient is rounding noise by ~lr);
- bf16 autocast (O1): loss within 2e-2.

Both MHA (`llama_tiny()`) and GQA (`llama_tiny(num_kv_heads=2)`).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama2_13b as jax_13b
from paddle_tpu.models.llama import llama2_7b as jax_7b
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama2_7b, llama2_13b, llama_tiny)
from paddle_tpu_torch.nn import functional as TF

FAMILY = [{}, dict(num_kv_heads=2)]
FAMILY_IDS = ["mha", "gqa"]


def _np(t):
    return np.asarray(t._value).astype(np.float32)


def _bf16(a):
    """``a`` rounded to bf16, as float32 numpy (exact in both
    frameworks)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _assert_within_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.fixture(scope="module", params=FAMILY, ids=FAMILY_IDS)
def pair(request):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**request.param))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**request.param), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm


# -------------------------------------------------------------- functionals

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["none", "(s,)", "(B,s)"])
def test_rope_matches_jax(positions, dtype):
    rng = np.random.RandomState(0)
    B, s, nh, hd = 2, 9, 4, 32
    q = rng.standard_normal((B, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, s, 2, hd)).astype(np.float32)
    pos = {"none": None,
           "(s,)": np.arange(s) + 37,
           "(B,s)": np.arange(s)[None] + np.array([[5], [250]])}[positions]
    if dtype == "bfloat16":
        q, k = _bf16(q), _bf16(k)
    jq, jk, jv = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q).astype(dtype), paddle.to_tensor(k).astype(dtype),
        None, position_ids=None if pos is None else
        paddle.to_tensor(pos.astype(np.int32)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = TIF.fused_rotary_position_embedding(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        position_ids=None if pos is None else torch.from_numpy(pos))
    assert jv is None and tv is None and tq.dtype == tdt
    for got, want in ((tq, jq), (tk, jk)):
        got, want = got.float().numpy(), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            _assert_within_bf16_ulp(got, want)


def test_rope_interleaved_style_and_swiglu_match_jax():
    rng = np.random.RandomState(1)
    q = rng.standard_normal((1, 7, 2, 16)).astype(np.float32)
    want = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), use_neox_rotary_style=False,
        rotary_emb_base=500.0)[0]
    got = TIF.fused_rotary_position_embedding(
        torch.from_numpy(q), use_neox_rotary_style=False,
        rotary_emb_base=500.0)[0]
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)
    x, y = (rng.standard_normal((3, 10)).astype(np.float32) for _ in "xy")
    np.testing.assert_allclose(
        TIF.swiglu(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        _np(JIF.swiglu(paddle.to_tensor(x), paddle.to_tensor(y))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        TIF.swiglu(torch.from_numpy(x)).numpy(),
        _np(JIF.swiglu(paddle.to_tensor(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    if dtype == "bfloat16":
        x, w = _bf16(x), _bf16(w)
    want = _np(JF.rms_norm(paddle.to_tensor(x).astype(dtype),
                           paddle.to_tensor(w).astype(dtype), 1e-6))
    tdt = getattr(torch, dtype)
    got = TF.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      1e-6)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        _assert_within_bf16_ulp(got.float().numpy(), want)
    # the amp black list: under O1 a bf16 input runs and returns fp32
    xb = torch.from_numpy(_bf16(x)).bfloat16()
    with tamp.auto_cast(True, device="cpu"):
        out = tnn.RMSNorm(64)(xb)
    assert out.dtype == torch.float32
    with jamp.auto_cast(True, level="O1", dtype="bfloat16"):
        jout = JF.rms_norm(paddle.to_tensor(_bf16(x)).astype("bfloat16"),
                           paddle.to_tensor(np.ones(64, np.float32)), 1e-6)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), atol=1e-6,
                               rtol=0)


# -------------------------------------------------------------------- model

def test_forward_logits_match_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(3).randint(0, 1024, (2, 21))
    want = _np(jm(paddle.to_tensor(ids.astype(np.int32))))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_paged_prefill_chunk_and_decode_match_jax(pair):
    """A prefill from empty (int position 0), a 4-token chunk through the
    chunk view at a 0-d start, then decode steps at per-row ``[B, 1]``
    positions, the rows at different lengths."""
    jm, tm = pair
    B, S, C, bs, steps = 2, 9, 4, 8, 3
    rng = np.random.RandomState(4)
    ids = rng.randint(1, 1024, (B, S))
    chunk = rng.randint(1, 1024, (B, C))
    jc = jm.init_caches(B, cache_impl="paged", max_context=32, block_size=bs)
    tc = tm.init_caches(B, cache_impl="paged", max_context=32,
                        block_size=bs)

    def both(j_ids, jcaches, joff, t_ids, tcaches, toff):
        jl, jcaches = jm.forward_with_cache(
            paddle.to_tensor(j_ids.astype(np.int32)), jcaches, pos_offset=joff)
        with torch.no_grad():
            tl, tcaches = tm.forward_with_cache(torch.from_numpy(t_ids),
                                                tcaches, toff)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=0)
        return _np(jl), jcaches, tcaches

    _, jc, tc = both(ids, jc, 0, ids, tc, 0)
    jv = [jkv.PagedChunkView.from_parts(c.k, c.v, c.tables, c.seq_lens, c.bs)
          for c in jc]
    tv = [tkv.PagedChunkKernelView.from_parts(c.k, c.v, c.tables,
                                              c.seq_lens, c.bs) for c in tc]
    logits, jc, tc = both(chunk, jv, paddle.to_tensor(np.int32(S))._value,
                          chunk, tv, torch.tensor(S, dtype=torch.int32))
    # row 1 steps back two positions: rows decode at different lengths
    lens = np.asarray([S + C, S + C - 2], np.int32)
    jc = [jkv.PagedKVCache.from_parts(c.k, c.v, c.tables,
                                      paddle.to_tensor(lens)._value, c.bs)
          for c in jc]
    tc = [tkv.PagedKVCache.from_parts(c.k, c.v, c.tables,
                                      torch.from_numpy(lens), c.bs)
          for c in tc]
    nxt = logits[:, -1].argmax(-1)[:, None]
    for step in range(steps):
        jl_ = jc[0].seq_lens
        logits, jc, tc = both(nxt, jc, jl_[:, None], nxt, tc,
                              tc[0].seq_lens[:, None])
        nxt = logits[:, -1].argmax(-1)[:, None]
    assert tc[0].seq_lens.tolist() == (lens + steps).tolist()


def _jax_grads(jm):
    names = {id(p): n for n, p in jm.named_parameters()}
    return {names[id(p)]: np.asarray(p.grad._value)
            for p in jm.parameters() if p.grad is not None}


def _batch(seed, B=2, S=32):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int64),
            rng.randint(0, 1024, (B, S)).astype(np.int64))


def test_loss_and_grads_match_jax(pair):
    jm, tm = pair
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)
    ids, labels = _batch(5)
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.item()), atol=1e-5,
                               rtol=0)
    want = state_from_numpy(_jax_grads(jm), tm)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("kw", FAMILY, ids=FAMILY_IDS)
def test_adamw_steps_with_clip_match_jax(kw):
    lr, steps = 1e-4, 2
    paddle.seed(6)
    jm = JaxLlama(jax_tiny(**kw))
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    jopt = joptim.AdamW(learning_rate=lr, parameters=jm.parameters(),
                        weight_decay=0.01,
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=lr, parameters=tm.parameters(),
                        weight_decay=0.01,
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    ids, labels = _batch(7)
    losses = []
    for _ in range(steps):
        jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
        tl.backward()
        topt.step()
        topt.clear_grad()
        losses.append((float(jl.item()), tl.item()))
    for jl, tl in losses:
        assert abs(jl - tl) < 1e-5
    assert losses[-1][1] < losses[0][1]
    want = state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm)
    for name, p in tm.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr * steps, name
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_auto_cast_o1_bf16_loss_matches_jax(pair):
    """bf16 O1 on both sides: the projections and the head in bf16, RMSNorm
    (black list) and the loss in fp32, the residual stream fp32; loss
    within 2e-2 of JAX's."""
    jm, tm = pair
    ids, labels = _batch(8)
    with jamp.auto_cast(True, level="O1", dtype="bfloat16"):
        jl = float(jm.compute_loss(paddle.to_tensor(ids),
                                   paddle.to_tensor(labels)).item())
    with tamp.auto_cast(True, level="O1", dtype="bfloat16", device="cpu"):
        tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
        x = torch.zeros(2, 3, 128)
        layer = tm.model.layers[0]
        assert layer.self_attn.q_proj(x).dtype == torch.bfloat16
        assert layer.input_layernorm(x).dtype == torch.float32
        assert layer(x, TIF.rope_cos_sin(torch.arange(3), 32)).dtype \
            == torch.float32
    assert tl.dtype == torch.float32
    assert abs(tl.item() - jl) < 2e-2


def test_config_refusals_presets_and_flops():
    assert llama_tiny(use_recompute=True).use_recompute   # ported
    assert llama_tiny(tensor_parallel=True).tensor_parallel  # ported
    with pytest.raises(ValueError, match="divide"):
        llama_tiny(num_kv_heads=3)
    # the presets are the JAX package's
    for port, jax in ((llama_tiny(), jax_tiny()), (llama2_7b(), jax_7b()),
                      (llama2_13b(), jax_13b()),
                      (llama2_7b(num_kv_heads=4), jax_7b(num_kv_heads=4))):
        assert vars(port) == vars(jax)
    assert LlamaConfig().num_kv_heads == 32
    assert llama2_7b(num_layers=8).num_layers == 8   # overrides win
    tm = LlamaForCausalLM(llama_tiny(num_kv_heads=2), device="cpu")
    jm = JaxLlama(jax_tiny(num_kv_heads=2))
    assert tm.num_params() == int(jm.num_params())
    assert tm.flops_per_token(64) == pytest.approx(float(
        jm.flops_per_token(64)))
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"
    bf = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
