"""Mixed precision in the port against the JAX package, on the CPU: O2
and ``decorate``, custom white and black lists, the GradScaler's host
path, and ``amp.debugging``.

Tolerances: the O2 loss, and the losses under custom lists, within
``GRAD_TOL`` (atol 2e-2, rtol 1e-2: the two frameworks round to bfloat16
or float16 at other places); parameters after two AdamW steps under
custom lists within 2 x lr x steps (ROADMAP.md reference fact 6: Adam
moves a weight whose gradient is rounding noise by ~lr a step); the
scaler's scale, good and bad counts and ``found_inf`` exactly equal after
every step, parameters within 1e-6 (float32).
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
from paddle_tpu.ops import spec_meta
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import op_lists
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
    """Custom white and black lists run (a black-listed matmul in
    float32, a white-listed softmax in float16), and a name outside the
    port's table raises, naming it (float16 runs too:
    ``tests/test_torch_fp16.py`` holds it against the JAX package); an
    unknown level or AMP type raises as in the JAX package."""
    x = torch.randn(4, 4)
    with tamp.auto_cast(True, custom_black_list={"matmul"}, device="cpu"):
        assert torch.matmul(x.bfloat16(), x).dtype == torch.float32
    with tamp.auto_cast(True, dtype="float16", custom_white_list={"softmax"},
                        device="cpu"):
        assert torch.softmax(x, -1).dtype == torch.float16
    with pytest.raises(NotImplementedError, match="reduce_sum"):
        tamp.auto_cast(True, custom_black_list={"reduce_sum"}, device="cpu")
    with pytest.raises(ValueError):
        tamp.auto_cast(True, level="O3", device="cpu")
    for call in (lambda: tamp.auto_cast(True, dtype="float64",
                                        device="cpu"),
                 lambda: tamp.decorate(GPTForCausalLM(gpt3_tiny(),
                                                      device="cpu"),
                                       dtype="int8")):
        with pytest.raises(ValueError, match="float16 or bfloat16"):
            call()


# ---------------------------------------------------------- custom lists

def test_autocast_custom_lists_match_jax():
    """The counterpart of ``tests/test_amp.py::test_autocast_custom_lists``:
    ``add`` on the white list gives bfloat16 and ``matmul`` on the black
    list float32, in both packages, on the same values."""
    v = np.random.RandomState(0).randn(2, 2).astype(np.float32)
    jx, tx = paddle.to_tensor(v), torch.from_numpy(v)
    with jamp.auto_cast(custom_white_list={"add"}, level="O1"):
        jout = jx + jx
    with tamp.auto_cast(custom_white_list={"add"}, level="O1",
                        device="cpu") as ctx:
        tout = tx + tx
    assert str(jout.dtype) == "bfloat16" and tout.dtype == torch.bfloat16
    assert ctx.mode.ran == {("add", torch.bfloat16): 1}
    np.testing.assert_array_equal(
        np.asarray(jout._value.astype(np.float32)), tout.float().numpy())
    with jamp.auto_cast(custom_black_list={"matmul"}, level="O1"):
        jout = paddle.matmul(jx.astype("bfloat16"), jx)
    with tamp.auto_cast(custom_black_list={"matmul"}, level="O1",
                        device="cpu"):
        tout = torch.matmul(tx.bfloat16(), tx)
    assert str(jout.dtype) == "float32" and tout.dtype == torch.float32
    np.testing.assert_allclose(jout.numpy(), tout.numpy(), atol=1e-6)


def test_list_copies_equal_the_op_specs():
    """The port's copies of the 17 white and 41 black names are the JAX
    package's lists from its op specs, and the table of names covers
    both and ``add``, ``divide`` and ``embedding``; the default path
    stays ``torch.autocast`` (no mode)."""
    assert op_lists.WHITE == spec_meta.amp_white()
    assert op_lists.BLACK == spec_meta.amp_black()
    assert len(op_lists.WHITE) == 17 and len(op_lists.BLACK) == 41
    assert set(op_lists.OPS) == (op_lists.WHITE | op_lists.BLACK
                                 | {"add", "divide", "embedding"})
    assert tamp.auto_cast(True, device="cpu").mode is None
    white, black = op_lists.lists_with({"mean"}, {"linear"})
    assert "mean" in white and "mean" not in black
    assert "linear" in black and "linear" not in white
    for bad in ({"reduce_sum"}, {"lookup_table_v2"}):
        with pytest.raises(NotImplementedError, match="port's table"):
            tamp.auto_cast(True, custom_white_list=bad, device="cpu")


# PaddleNLP-style lists in this repo's op names (chip_smoke.py phase 24)
LISTS = dict(custom_black_list={"divide"}, custom_white_list={"embedding"})


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_custom_lists_train_like_jax(level, dtype):
    """gpt3_tiny under ``custom_black_list={"divide"}``,
    ``custom_white_list={"embedding"}``: the loss of each of two AdamW
    steps within GRAD_TOL of the JAX package's, and the parameters after
    them within 2 x lr x steps; at O2 both sides ``decorate`` first."""
    lr = 1e-3
    jm, tm = _pair(3)
    jopt = joptim.AdamW(learning_rate=lr, parameters=jm.parameters())
    topt = toptim.AdamW(learning_rate=lr, parameters=tm.named_parameters())
    if level == "O2":
        jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype=dtype)
        tm, topt = tamp.decorate(tm, topt, level="O2", dtype=dtype)
    ids = _ids(4)
    for _ in range(2):
        with jamp.auto_cast(True, level=level, dtype=dtype, **LISTS):
            jl = jm.compute_loss(paddle.to_tensor(ids),
                                 paddle.to_tensor(ids))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        with tamp.auto_cast(True, level=level, dtype=dtype, device="cpu",
                            **LISTS) as ctx:
            tl = tm.compute_loss(torch.from_numpy(ids),
                                 torch.from_numpy(ids))
        tl.backward()
        topt.step()
        topt.clear_grad()
        torch.testing.assert_close(torch.tensor(tl.item()),
                                   torch.tensor(float(jl.item())),
                                   **GRAD_TOL)
    low = getattr(torch, dtype)
    assert ctx.mode.ran[("embedding", low)] == 2      # wte and wpe
    assert ctx.mode.ran[("layer_norm", torch.float32)] > 0
    jstate = {k: np.asarray(v._value.astype(np.float32))
              for k, v in jm.state_dict().items()}
    want = state_from_numpy(jstate, tm)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.float().numpy(), want[name].numpy(),
                                   atol=2 * lr * 2 + 1e-2 * (level == "O2"),
                                   err_msg=name)


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
