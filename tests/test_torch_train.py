"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs go through the JAX package and the port (CPU
tensors, where the flash wrappers take their plain versions).  Each test
states its tolerance:

- flash backward: the port's plain version against the JAX backward
  kernels in interpret mode, fp32, atol 2e-4 (as
  ``tests/test_pallas_flash.py``);
- dropout: bit-identical keep masks where the JAX kernels run one tile
  (Sq, Sk <= 512), so the outputs and gradients agree to fp32 rounding
  (atol 2e-4);
- tiny GPT (``gpt3_tiny``, weights through ``models/convert.py``), fp32,
  dropout 0: loss atol 1e-5, gradients atol 1e-4, parameters after three
  AdamW steps atol 1e-5;
- bf16 autocast (O1): loss within 2e-2 (the two frameworks round to bf16
  at different places).
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
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_flash as jflash
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.convert import (adamw_state_from_numpy,
                                             state_from_numpy)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tflash

ATOL = 2e-4


def _flash_case(B, Sq, Sk, nh, nkv, hd=32, seed=0, masked=False):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, nh, hd), (B, Sk, nkv, hd), (B, Sk, nkv, hd),
             (B, Sq, nh, hd))]
    mask = None
    if masked:
        mask = (rng.uniform(size=(B, Sk)) > 0.3).astype(np.int32)
        mask[-1] = 0                 # a batch row whose rows see no key
    return arrs, mask


def _jax_vjp(q, k, v, do, causal, mask=None, rate=0.0, seed=None):
    """Output and gradients of the JAX package's differentiable flash
    attention (forward and backward kernels in interpret mode)."""
    jm = None if mask is None else jnp.asarray(mask)
    js = None if seed is None else jnp.int32(seed)

    def f(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal, True, jm, js, None,
                                      rate)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def _port_autograd(q, k, v, do, causal, mask=None, rate=0.0, seed=None):
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = tflash.flash_attention(*x, causal, tm, rate, seed)
    out.backward(torch.from_numpy(do))
    return [t.detach().numpy() for t in (out, *(t.grad for t in x))]


# ------------------------------------------------------------- flash bwd

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,nh,nkv", [(2, 64, 64, 4, 4),
                                            (1, 64, 64, 4, 2),
                                            (1, 64, 256, 2, 2)])
def test_flash_bwd_reference_matches_pallas_bwd(B, Sq, Sk, nh, nkv, causal):
    (q, k, v, do), _ = _flash_case(B, Sq, Sk, nh, nkv)
    out, lse = jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True)
    want = jflash.flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
        jnp.asarray(do), causal=causal, interpret=True)
    # the port keeps lse as [B, nh, Sq]: lane 0 of the JAX layout
    got = tflash.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, np.array(out),
                                         np.array(lse)[..., 0], do)),
        causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", [
    dict(B=2, Sq=64, Sk=64, nh=4, nkv=4, causal=True),
    dict(B=1, Sq=64, Sk=64, nh=4, nkv=2, causal=False),
    dict(B=1, Sq=64, Sk=256, nh=2, nkv=2, causal=True),
    dict(B=2, Sq=64, Sk=96, nh=4, nkv=2, causal=True, masked=True),
    dict(B=2, Sq=64, Sk=96, nh=2, nkv=2, causal=False, masked=True),
])
def test_flash_attention_grads_match_jax_vjp(case):
    """The differentiable entry (FlashAttention on the plain versions)
    against jax.vjp of the JAX package's flash_attention, with GQA, Sq <
    Sk and a kv mask with a fully masked batch row."""
    case = dict(case)
    causal = case.pop("causal")
    (q, k, v, do), mask = _flash_case(**case)
    want = _jax_vjp(q, k, v, do, causal, mask)
    got = _port_autograd(q, k, v, do, causal, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    if mask is not None:
        assert not got[0][-1].any()              # fully masked row: zeros


@pytest.fixture
def hash_dropout(monkeypatch):
    """Send the JAX flash kernels' dropout down the generic interpreter,
    where they draw their keep mask with `_hash_bits` (the TPU-semantics
    interpreter would draw the TPU PRNG's bits instead)."""
    monkeypatch.setattr(jflash, "_resolve_interpret", lambda i, r: True)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_dropout_bits_match_jax(hash_dropout, causal, masked):
    """One JAX tile (S <= 512): the port's keep bits are the JAX kernels'
    exactly, seed 42, rate 0.2, so forward and gradients agree."""
    (q, k, v, do), mask = _flash_case(2, 128, 192, 4, 2, masked=masked)
    want = _jax_vjp(q, k, v, do, causal, mask, rate=0.2, seed=42)
    got = _port_autograd(q, k, v, do, causal, mask, rate=0.2, seed=42)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # the same with dropout off differs: the mask did bite
    plain = _port_autograd(q, k, v, do, causal, mask)
    assert np.abs(plain[0] - got[0]).max() > 1e-2


def test_dropout_keep_rate_and_independence_of_tiling():
    """Keep rate within 4 sigma at S 2048; the backward at Sk > 512 (two
    JAX tiles, where the JAX backward redraws other bits than its forward
    drew) agrees with autograd through the plain forward."""
    rate = 0.1
    keep = tflash.dropout_keep_mask(1, 2, 2048, 2048, seed=7, rate=rate)
    n = keep.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs((1 - keep.float().mean().item()) - rate) < 4 * sigma
    # neighbouring heads and seeds draw different bits
    assert (keep[0, 0] != keep[0, 1]).any()
    other = tflash.dropout_keep_mask(1, 1, 64, 64, seed=8, rate=rate)
    assert (other[0, 0] != keep[0, 0, :64, :64]).any()

    (q, k, v, do), _ = _flash_case(1, 96, 640, 2, 2, seed=3)
    got = _port_autograd(q, k, v, do, True, rate=0.3, seed=11)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = tflash.flash_attention_fwd_reference(*x, True, None, 0.3, 11)
    out.backward(torch.from_numpy(do))
    want = [out.detach().numpy()] + [t.grad.numpy() for t in x]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_flash_function_matches_autograd_through_the_plain_forward():
    (q, k, v, do), mask = _flash_case(2, 48, 80, 4, 2, seed=4, masked=True)
    got = _port_autograd(q, k, v, do, True, mask, rate=0.25, seed=3)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = tflash.flash_attention_fwd_reference(
        *x, True, torch.from_numpy(mask), 0.25, 3)
    out.backward(torch.from_numpy(do))
    want = [out.detach().numpy()] + [t.grad.numpy() for t in x]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


# ------------------------------------------------------------ functionals

def test_cross_entropy_ignores_labels_as_paddle_does():
    rng = np.random.RandomState(5)
    logits = rng.standard_normal((12, 17)).astype(np.float32)
    labels = rng.randint(0, 17, 12).astype(np.int64)
    labels[[1, 4, 7]] = -100
    for reduction in ("mean", "sum", "none"):
        want = JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(labels),
                                reduction=reduction)
        got = TF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   atol=1e-5, rtol=0)
    # every label ignored: paddle's mean is 0, not NaN
    none = torch.full((12,), -100)
    assert TF.cross_entropy(torch.from_numpy(logits), none).item() == 0.0


def test_sdpa_routes_padding_masks_to_flash_and_others_to_plain():
    (q, k, v, _), mask = _flash_case(2, 16, 24, 2, 2, seed=6, masked=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bool_mask = torch.from_numpy(mask != 0)
    before = tflash.flash_attention_fwd.launches
    got = TF.scaled_dot_product_attention(
        tq, tk, tv, attn_mask=bool_mask[:, None, None, :])
    assert TF.as_kv_padding_mask(bool_mask[:, None, None, :], 2, 24) \
        is not None
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask[:, None, None, :] != 0))
    # rows whose keys are all masked differ by convention (flash: zeros;
    # the XLA softmax: uniform); compare the rows that see a key
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want._value)[0],
                               atol=1e-5, rtol=0)
    assert tflash.flash_attention_fwd.launches == before   # CPU: no kernel
    # an additive [Sq, Sk] mask takes the plain softmax path
    add = np.where(np.tril(np.ones((16, 24)), 8) > 0, 0.0,
                   -1e4).astype(np.float32)
    got = TF.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(add))
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(add))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               atol=1e-5, rtol=0)


# -------------------------------------------------------------------- GPT

def _gpt_pair(seed=0, **kw):
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny(**kw))
    jm.train()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(**kw), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    tm.train()
    return jm, tm


def _batch(B=2, S=32, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int64)
    labels = rng.randint(0, 1024, (B, S)).astype(np.int64)
    return ids, labels


def _jax_grads(jm):
    names = {id(p): n for n, p in jm.named_parameters()}
    return {names[id(p)]: np.asarray(p.grad._value)
            for p in jm.parameters() if p.grad is not None}


def test_gpt_loss_and_grads_match_jax():
    jm, tm = _gpt_pair()
    ids, labels = _batch()
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.item()), atol=1e-5,
                               rtol=0)
    jg = _jax_grads(jm)
    tg = {n: p.grad for n, p in tm.named_parameters()}
    assert set(jg) == set(tg)
    for name, g in jg.items():
        want = g.T if g.ndim == 2 and name.endswith(
            ("qkv.weight", "proj.weight", "fc1.weight", "fc2.weight")) else g
        np.testing.assert_allclose(tg[name].numpy(), want, atol=1e-4,
                                   rtol=0, err_msg=name)


def _train_both(jm, tm, steps, ids, labels, jopt, topt):
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
    return losses


def _assert_params_match(jm, tm, atol, noise_atol):
    """Parameters agree to ``atol``, except the key third of each qkv
    bias: its gradient is zero in exact arithmetic (a bias added to every
    key shifts a row's scores alike, and softmax ignores that), so both
    frameworks' AdamW step it by m / sqrt(v) of rounding noise, about lr
    per step in either direction; it is held to ``noise_atol``, twice lr
    times the steps.  (The learning rate is bench.py's 1e-4: Adam divides
    by sqrt(v), so a weight whose gradient is tiny moves by up to lr on
    rounding noise, and lr 1e-2 would put such weights 1e-5 apart.)"""
    state = state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm)
    H = tm.cfg.hidden_size
    for name, p in tm.state_dict().items():
        got, want = p.numpy(), state[name].numpy()
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(got[H:2 * H], want[H:2 * H],
                                       atol=noise_atol, rtol=0,
                                       err_msg=name)
            got = np.concatenate([got[:H], got[2 * H:]])
            want = np.concatenate([want[:H], want[2 * H:]])
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=name)


def test_adamw_with_global_norm_clip_matches_jax():
    jm, tm = _gpt_pair()
    ids, labels = _batch(seed=1)
    no_decay = lambda n: not n.endswith("bias") and ".ln" not in n  # noqa
    jnames = {p.name: n for n, p in jm.named_parameters()}
    jopt = joptim.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                        weight_decay=0.01,
                        apply_decay_param_fun=lambda pn: no_decay(
                            jnames[pn]),
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=1e-4,
                        parameters=tm.named_parameters(), weight_decay=0.01,
                        apply_decay_param_fun=no_decay,
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    losses = _train_both(jm, tm, 3, ids, labels, jopt, topt)
    for jl, tl in losses:
        assert abs(jl - tl) < 1e-5
    assert losses[-1][1] < losses[0][1]
    _assert_params_match(jm, tm, 1e-5, 3 * 2e-4)


def test_global_norm_clip_scales_like_paddle():
    rng = np.random.RandomState(2)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 5), (7,))]
    jp = [(None, paddle.to_tensor(g)) for g in grads]
    want = [np.asarray(g._value) for _, g in
            jnn.ClipGradByGlobalNorm(1.0)(jp)]
    tp = [(None, torch.from_numpy(g.copy())) for g in grads]
    got = [g.numpy() for _, g in tnn.ClipGradByGlobalNorm(1.0)(tp)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    # within the limit: untouched
    small = [(None, torch.full((3,), 0.1))]
    assert torch.equal(tnn.ClipGradByGlobalNorm(1.0)(small)[0][1],
                       torch.full((3,), 0.1))


def test_adamw_state_carries_a_jax_run_into_the_port():
    """Two JAX steps, weights and moments carried over, one more step in
    each: the parameters agree."""
    jm, tm = _gpt_pair(seed=3)
    ids, labels = _batch(seed=2)
    jopt = joptim.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                        weight_decay=0.01)
    for _ in range(2):
        jm.compute_loss(paddle.to_tensor(ids),
                        paddle.to_tensor(labels)).backward()
        jopt.step()
        jopt.clear_grad()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_from_numpy(state, tm))
    jsd = jopt.remap_state_keys(jm, jopt.state_dict(), to_structured=True)
    jsd = {k: (np.asarray(v._value) if hasattr(v, "_value") else v)
           for k, v in jsd.items()}
    topt = toptim.AdamW(learning_rate=1e-4,
                        parameters=tm.named_parameters(), weight_decay=0.01)
    topt.set_state_dict(adamw_state_from_numpy(jsd, tm))
    assert topt.state_dict()["global_step"] == 2
    _train_both(jm, tm, 1, ids, labels, jopt, topt)
    _assert_params_match(jm, tm, 1e-5, 3 * 2e-4)
    sd = topt.state_dict()
    assert sd["global_step"] == 3
    assert sd["gpt.blocks.0.attn.qkv.weight@moment1"].shape == \
        tm.gpt.blocks[0].attn.qkv.weight.shape


def test_auto_cast_o1_bf16_loss_matches_jax():
    """bf16 O1 on both sides (the JAX package casts its white-list ops,
    torch's CPU autocast its own list; both put the matrix products in
    bf16 and keep LayerNorm and the loss in fp32): loss within 2e-2 of
    JAX's; the qkv product ran in bf16."""
    jm, tm = _gpt_pair(seed=4)
    ids, labels = _batch(seed=3)
    with jamp.auto_cast(True, level="O1", dtype="bfloat16"):
        jl = float(jm.compute_loss(paddle.to_tensor(ids),
                                   paddle.to_tensor(labels)).item())
    with tamp.auto_cast(True, level="O1", dtype="bfloat16", device="cpu"):
        tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    assert tl.dtype == torch.float32
    tl.backward()
    assert tm.gpt.blocks[0].attn.qkv.weight.grad.dtype == torch.float32
    assert abs(tl.item() - jl) < 2e-2
    x = torch.zeros(2, 128)
    with tamp.auto_cast(True, device="cpu"):
        assert tm.gpt.blocks[0].attn.qkv(x).dtype == torch.bfloat16
        assert tm.gpt.blocks[0].ln1(x).dtype == torch.float32
    with tamp.auto_cast(True, level="O0", device="cpu"):
        assert tm.gpt.blocks[0].attn.qkv(x).dtype == torch.float32
    # O2, decorate, float16 and custom op lists are ported
    # (tests/test_torch_amp.py, tests/test_torch_fp16.py): a white-listed
    # softmax runs in bfloat16
    tamp.auto_cast(True, level="O2", device="cpu")
    with tamp.auto_cast(True, dtype="float16", device="cpu"):
        assert tm.gpt.blocks[0].attn.qkv(x).dtype == torch.float16
        assert tm.gpt.blocks[0].ln1(x).dtype == torch.float32
    with tamp.auto_cast(True, custom_white_list={"softmax"}, device="cpu"):
        assert torch.softmax(x, -1).dtype == torch.bfloat16
        assert tm.gpt.blocks[0].ln1(x).dtype == torch.float32


def test_gpt_dropout_draws_from_the_model_generator():
    """Dropout in training only; two models with one seed draw the same
    masks, the eval forward is deterministic and differs from training."""
    ids, labels = _batch(S=16)
    tid, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    a = GPTForCausalLM(gpt3_tiny(dropout=0.2), device="cpu", seed=5)
    b = GPTForCausalLM(gpt3_tiny(dropout=0.2), device="cpu", seed=5)
    la, lb = a.compute_loss(tid, tlab), b.compute_loss(tid, tlab)
    assert la.item() == lb.item()
    assert a.compute_loss(tid, tlab).item() != la.item()   # new masks
    la.backward()
    assert all(torch.isfinite(p.grad).all() for p in a.parameters())
    a.eval()
    e1, e2 = a.compute_loss(tid, tlab), a.compute_loss(tid, tlab)
    assert e1.item() == e2.item() != la.item()


def test_model_counts_flops_and_refuses_recompute():
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    jm = JaxGPT(jax_tiny())
    assert tm.num_params() == int(jm.num_params())
    assert tm.flops_per_token(64) == pytest.approx(float(
        jm.flops_per_token(64)))
    # recompute is ported (tests/test_torch_recompute.py); a policy torch
    # has no meaning for is refused at the forward, by its name
    cfg = gpt3_tiny(use_recompute=True, recompute_interval=2,
                    recompute_policy="save_only_these_names")
    ids = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="save_only_these_names"):
        GPTForCausalLM(cfg, device="cpu").compute_loss(ids, ids)
