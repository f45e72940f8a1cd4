"""Mixed precision in the port against the JAX package, on the CPU: O2
and ``decorate``, the GradScaler's host path, and ``amp.debugging``.

Tolerances: the O2 loss within ``GRAD_TOL`` (atol 2e-2, rtol 1e-2: the
two frameworks round to bfloat16 at other places); the scaler's scale,
good and bad counts and ``found_inf`` exactly equal after every step,
parameters within 1e-6 (float32).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.amp import debugging as jdebug
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.amp import debugging as tdebug
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

GRAD_TOL = dict(atol=2e-2, rtol=1e-2)


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny(**kw))
    jm.train()
    tm = GPTForCausalLM(gpt3_tiny(**kw), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    tm.train()
    return jm, tm


def _ids(seed, B=2, S=32):
    return np.random.RandomState(seed).randint(0, 1024, (B, S))


def test_o2_loss_and_steps_match_jax():
    """``decorate`` at O2 on both sides: bfloat16 parameters but the
    LayerNorms', float32 masters in AdamW; three steps of the loss under
    ``auto_cast(level="O2")`` within GRAD_TOL of the JAX package's, and
    the masters of the LayerNorms (float32 parameters: none) absent."""
    jm, tm = _pair(0)
    jopt = joptim.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=1e-3,
                        parameters=tm.named_parameters(),
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    out = tamp.decorate(tm, topt, level="O2", dtype="bfloat16")
    assert out == (tm, topt) and topt._multi_precision
    dtypes = {n: p.dtype for n, p in tm.named_parameters()}
    assert dtypes["gpt.blocks.0.attn.qkv.weight"] == torch.bfloat16
    assert dtypes["gpt.wte.weight"] == torch.bfloat16
    assert dtypes["gpt.blocks.0.ln1.weight"] == torch.float32
    assert dtypes["gpt.ln_f.bias"] == torch.float32
    jd = {n: str(p._value.dtype) for n, p in jm.named_parameters()}
    assert {n: str(d).replace("torch.", "") for n, d in dtypes.items()} \
        == jd
    ids = _ids(1)
    for step in range(3):
        with jamp.auto_cast(True, level="O2", dtype="bfloat16"):
            jl = jm.compute_loss(paddle.to_tensor(ids),
                                 paddle.to_tensor(ids))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        with tamp.auto_cast(True, level="O2", dtype="bfloat16",
                            device="cpu"):
            tl = tm.compute_loss(torch.from_numpy(ids),
                                 torch.from_numpy(ids))
        assert tl.dtype == torch.float32
        tl.backward()
        assert tm.gpt.blocks[0].attn.qkv.weight.grad.dtype == torch.bfloat16
        topt.step()
        topt.clear_grad()
        torch.testing.assert_close(torch.tensor(tl.item()),
                                   torch.tensor(float(jl.item())),
                                   **GRAD_TOL)
    masters = topt._accumulators["master_weight"]
    assert "gpt.blocks.0.attn.qkv.weight" in masters
    assert "gpt.blocks.0.ln1.weight" not in masters
    assert masters["gpt.wte.weight"].dtype == torch.float32
    assert topt._global_step == 3


def test_o2_keeps_norms_float32_and_feeds_them_their_type():
    """A kept norm casts its input to float32 (the JAX black list's
    promotion), so a bfloat16 stream through a float32 LayerNorm or
    RMSNorm runs even without autocast."""
    tm = tamp.decorate(GPTForCausalLM(gpt3_tiny(), device="cpu"))
    x = torch.randn(2, 5, 128).bfloat16()
    assert tm.gpt.blocks[0].ln1(x).dtype == torch.float32
    lm = tamp.decorate(LlamaForCausalLM(llama_tiny(), device="cpu"))
    assert lm.model.layers[0].input_layernorm.weight.dtype == torch.float32
    assert lm.model.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    ids = torch.from_numpy(_ids(2, S=16))
    with tamp.auto_cast(True, level="O2", device="cpu"):
        loss = lm.compute_loss(ids, ids)
    assert torch.isfinite(loss)
    # decorate twice: one hook per norm
    tamp.decorate(tm)
    assert len(tm.gpt.blocks[0].ln1._forward_pre_hooks) == 1
    # a list of models and no optimizer
    models = tamp.decorate([GPTForCausalLM(gpt3_tiny(), device="cpu")])
    assert models[0].gpt.wpe.weight.dtype == torch.bfloat16
    out = tamp.decorate(GPTForCausalLM(gpt3_tiny(), device="cpu"),
                        toptim.SGD(parameters=[torch.nn.Parameter(
                            torch.zeros(2))]), level="O1")
    assert out[0].gpt.wpe.weight.dtype == torch.float32
    assert out[1]._multi_precision


def test_float16_and_custom_lists_still_raise():
    """Custom white and black lists still raise, naming ROADMAP A.7
    (float16 runs now: ``tests/test_torch_fp16.py`` holds it against the
    JAX package); an unknown level or AMP type raises as in the JAX
    package."""
    for call in (lambda: tamp.auto_cast(True, custom_black_list={"matmul"},
                                        device="cpu"),
                 lambda: tamp.auto_cast(True, dtype="float16",
                                        custom_white_list={"softmax"},
                                        device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError):
        tamp.auto_cast(True, level="O3", device="cpu")
    for call in (lambda: tamp.auto_cast(True, dtype="float64",
                                        device="cpu"),
                 lambda: tamp.decorate(GPTForCausalLM(gpt3_tiny(),
                                                      device="cpu"),
                                       dtype="int8")):
        with pytest.raises(ValueError, match="float16 or bfloat16"):
            call()


# ------------------------------------------------------------ GradScaler

def _params(seed):
    rng = np.random.RandomState(seed)
    vals = [rng.uniform(-1, 1, s).astype(np.float32)
            for s in ((6, 3), (5,), (2, 2, 3))]
    return ([paddle.Parameter(v) for v in vals],
            [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals])


def _grads(step, inf_at):
    rng = np.random.RandomState(100 + step)
    gs = [rng.uniform(-1, 1, s).astype(np.float32)
          for s in ((6, 3), (5,), (2, 2, 3))]
    if step in inf_at:
        gs[1][2] = np.nan if step % 2 else np.inf
    return gs


@pytest.mark.parametrize("recipe", ["step", "unscale_then_step"])
def test_grad_scaler_matches_jax(recipe):
    """Six steps with overflows at steps 1, 2 and 4 (decr every 2 bad
    steps, incr every 2 good ones).  ``step``: the fused path in both
    packages.  ``unscale_then_step``: ``unscale_`` then ``step``, the
    recipe that leaves room to read or clip the unscaled gradients (the
    host path: gradients unscaled in place, found_inf read back; the
    optimizer's own global-norm clip then runs on them).  After every
    step the scale, the good and bad counts and found_inf equal the JAX
    scaler's; parameters within 1e-6."""
    jp, tp = _params(0)
    jopt = joptim.Adam(learning_rate=0.01, parameters=jp,
                       grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    topt = toptim.Adam(learning_rate=0.01, parameters=tp,
                       grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    kw = dict(init_loss_scaling=2.0 ** 6, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    for s in range(6):
        scale = ts._scale
        for j, t, g in zip(jp, tp, _grads(s, (1, 2, 4))):
            j.grad = paddle.to_tensor(g * scale)
            t.grad = torch.from_numpy(g * scale)
        if recipe == "step":
            js.step(jopt)
            ts.step(topt)
        else:
            js.unscale_(jopt)
            ts.unscale_(topt)
            assert ts._found_inf == js._found_inf
            for j, t in zip(jp, tp):                 # unscaled in place
                np.testing.assert_allclose(t.grad.numpy(),
                                           np.asarray(j.grad._value),
                                           atol=0, rtol=0)
            js.step(jopt)
            ts.step(topt)
        assert (ts._scale, ts._good_steps, ts._bad_steps, ts._found_inf) \
            == (js._scale, js._good_steps, js._bad_steps, js._found_inf), s
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(j._value), atol=1e-6,
                                       rtol=0)
        assert topt._global_step == jopt._global_step
        jopt.clear_grad()
        topt.clear_grad()
    assert ts.state_dict() == js.state_dict()


def test_grad_scaler_state_passthrough_and_minimize():
    ts = tamp.GradScaler(init_loss_scaling=8.0)
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()
    loss = torch.tensor(1.5, requires_grad=True)
    assert ts.scale(loss).item() == 12.0
    assert ts.get_loss_scaling().item() == 8.0
    ts.set_init_loss_scaling(4.0)
    sd = ts.state_dict()
    other = tamp.GradScaler()
    other.load_state_dict(sd)
    assert other._scale == 4.0 and other.state_dict() == sd
    # disabled: a strict passthrough
    off = tamp.GradScaler(enable=False)
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.SGD(learning_rate=0.5, parameters=[p])
    assert off.scale(loss) is loss
    p.grad = torch.full((3,), float("inf"))
    off.step(opt)
    assert not torch.isfinite(p).any() and off._scale == 2.0 ** 16
    # minimize = backward, then step
    q = torch.nn.Parameter(torch.ones(2))
    opt = toptim.SGD(learning_rate=0.5, parameters=[q])
    sc = tamp.GradScaler(init_loss_scaling=4.0)
    sc.minimize(opt, sc.scale((q * 3).sum()))
    torch.testing.assert_close(q.detach(), torch.full((2,), -0.5))
    assert tamp.AmpScaler is tamp.GradScaler


# ------------------------------------------------------------- debugging

def test_check_numerics_matches_jax():
    bad = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    for mode in (None, 0):
        with pytest.raises(FloatingPointError) as t_err:
            tdebug.check_numerics(torch.from_numpy(bad), "op", "x", mode)
        with pytest.raises(FloatingPointError) as j_err:
            jdebug.check_numerics(paddle.to_tensor(bad), "op", "x", mode)
        assert str(t_err.value) == str(j_err.value)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tdebug.check_numerics(torch.from_numpy(bad), "op", "x",
                              tdebug.DebugMode.CHECK_NAN_INF)
    assert "1 NaN and 2 Inf" in str(w[0].message)
    ok = torch.ones(3)
    assert tdebug.check_numerics(ok) is ok
    ints = torch.arange(3)
    assert tdebug.check_numerics(ints) is ints


def test_tensor_checker_and_operator_stats():
    tdebug.enable_tensor_checker()
    try:
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.zeros(2) - 1.0)
        torch.ones(2) + 1                              # finite: quiet
    finally:
        tdebug.disable_tensor_checker()
    assert torch.isnan(torch.log(torch.zeros(1) - 1.0)).all()
    with tdebug.collect_operator_stats():
        x = torch.ones(3)
        (x + x) * 2
        x + 1
    assert tdebug._op_stats["add"] == 2 and tdebug._op_stats["mul"] == 1
    # the JAX package's switches exist under the same names
    assert set(tdebug.__all__) == set(jdebug.__all__)
