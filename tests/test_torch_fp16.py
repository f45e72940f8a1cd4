"""float16 in the port against the JAX package, on the CPU: mixed
precision at O1 and O2, the flash kernels' plain versions in fp16, the
paged and MoE wrappers taking fp16 to their kernels, and the weight-only
kernels refusing it before any launch.

Tolerances:

- the flash plain versions on fp16 inputs against the JAX Pallas kernels
  in interpret mode on the same values (the forward and dq round p and
  ds to fp16 as the port's tensor-core kernels do; the plain versions do
  not round): outputs atol 4e-3, gradients atol 4e-3 + rtol 2e-3 (one
  fp16 rounding is 2^-11 relative, bf16's limits of
  ``tests/test_torch_flash_bf16.py`` five-fold tighter);
- O1 and O2 under ``auto_cast(dtype="float16")`` with a dynamic
  ``GradScaler`` at its default scale (65536, the JAX default): the
  scaler's scale and counts exactly equal after every step; losses
  within atol 1e-3 (the two frameworks round to fp16 at other places:
  torch's autocast lists against the JAX white list, see
  ``amp/auto_cast.py``; on these inputs they differ by less than 1e-4
  in a loss of ~6.9); the gradients after each step, unscaled in both,
  within atol 1e-3 (at most ~0.2 in size; a scaled one would be 65536
  times that); parameters
  after two AdamW steps within 2 x lr x steps (ROADMAP.md reference fact
  6: Adam moves a weight whose gradient is rounding noise by ~lr a
  step), O2's fp16 copies within that plus one fp16 step (2^-10).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.ops import pallas_flash as jflash
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tflash

TOL = dict(atol=4e-3, rtol=0.0)
GRAD_TOL = dict(atol=4e-3, rtol=2e-3)
LOSS_ATOL = 1e-3
LR, STEPS = 1e-3, 2
# (B, Sq, Sk, nh, nkv, causal) at hd 64: one tile of the JAX kernels
CASES = [(2, 64, 64, 4, 4, True), (1, 64, 128, 4, 2, True),
         (1, 96, 64, 2, 2, True), (2, 64, 96, 2, 1, False)]


def _fp16_case(B, Sq, Sk, nh, nkv, hd=64, seed=12):
    """fp16 inputs as JAX arrays and as torch tensors, from one numpy
    draw rounded to fp16 once."""
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, nh, hd), (B, Sk, nkv, hd), (B, Sk, nkv, hd),
              (B, Sq, nh, hd)]
    arrs = [rng.standard_normal(s).astype(np.float16) for s in shapes]
    return ([torch.from_numpy(a) for a in arrs],
            [jnp.asarray(a) for a in arrs])


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("B,Sq,Sk,nh,nkv,causal", CASES)
def test_fp16_flash_plain_versions_match_the_pallas_kernels(B, Sq, Sk, nh,
                                                            nkv, causal):
    """Forward, dq and dk/dv of the port's wrappers on fp16 CPU tensors
    (the plain versions) against the JAX kernels in interpret mode, which
    keep fp16 in and out."""
    (q, k, v, do), (jq, jk, jv, jdo) = _fp16_case(B, Sq, Sk, nh, nkv)
    out_j, lse_j = jflash.flash_attention_fwd(jq, jk, jv, causal=causal,
                                              interpret=True)
    assert out_j.dtype == jnp.float16
    out_t, lse_t = tflash.flash_attention_fwd(q, k, v, causal=causal)
    assert out_t.dtype == torch.float16
    np.testing.assert_allclose(out_t.float().numpy(), _f32(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), _f32(lse_j)[..., 0], **TOL)
    grads_j = jflash.flash_attention_bwd(jq, jk, jv, out_j, lse_j, jdo,
                                         causal=causal, interpret=True)
    out = torch.from_numpy(_f32(out_j)).half()
    lse = torch.from_numpy(_f32(lse_j)[..., 0].copy())
    dq = tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal)
    for got, want, x in ((dq, grads_j[0], q), (dk, grads_j[1], k),
                         (dv, grads_j[2], v)):
        assert got.dtype == torch.float16 and got.shape == x.shape
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **GRAD_TOL)


def test_fp16_flash_with_kv_mask_and_plain_route():
    """The kv-mask path and ``plain_route`` in fp16 behave as in the other
    types: a fully masked batch row gives zeros, the differentiable
    function's gradients match autograd through the plain forward, and a
    head dim no kernel takes is the plain route off the CPU only."""
    (q, k, v, do), _ = _fp16_case(2, 64, 64, 4, 4)
    mask = torch.ones((2, 64), dtype=torch.int32)
    mask[1] = 0
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tflash.flash_attention(*x, True, mask, 0.0, None)
    assert out.dtype == torch.float16 and not out[1].any()
    out.backward(do)
    y = [t.float().requires_grad_() for t in (q, k, v)]
    ref = tflash.flash_attention_fwd_reference(*y, True, mask)[0]
    ref.backward(do.float())
    for a, b in zip(x, y):
        np.testing.assert_allclose(a.grad.float().numpy(), b.grad.numpy(),
                                   **GRAD_TOL)
    assert not tflash.plain_route(q)
    assert tflash.plain_route(torch.empty(1, 4, 2, 32, dtype=torch.float16,
                                          device="meta"))
    assert not tflash.plain_route(torch.empty(1, 4, 2, 64,
                                              dtype=torch.float16,
                                              device="meta"))


class _Reached(Exception):
    pass


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library a stub that raises when reached: off the CPU
    (``meta`` tensors) a wrapper must refuse fp16 before it."""
    def reached():
        raise _Reached()
    monkeypatch.setattr(_build, "library", reached)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)


def _meta(*shape, dtype=torch.float16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_flash_takes_fp16_to_the_kernels(no_library):
    """fp16 ``meta`` tensors pass the flash wrappers' checks and reach the
    library (the tensor-core kernels take fp16)."""
    x = _meta(1, 64, 2, 64)
    lse = _meta(1, 2, 64, dtype=torch.float32)
    for call in (lambda: tflash.flash_attention_fwd(x, x, x, True),
                 lambda: tflash.flash_attention_bwd_dq(x, x, x, x, lse, x,
                                                       True),
                 lambda: tflash.flash_attention_bwd_dkv(x, x, x, x, lse, x,
                                                        True)):
        with pytest.raises(_Reached):
            call()
    assert _build.dtype_code(torch.float16, _build.FP16_DTYPES) == 2


def _refusals():
    from paddle_tpu_torch.ops import moe, paged_attention as pa
    from paddle_tpu_torch.ops import weight_only as wo
    pool, tables = _meta(4, 5, 16, 64), torch.empty(2, 2, dtype=torch.int32,
                                                    device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    idx = torch.empty(6, 2, dtype=torch.int32, device="meta")
    codes = torch.empty(64, 64, dtype=torch.int8, device="meta")
    return {
        "paged_decode": (pa.paged_attention, lambda: pa.paged_attention(
            _meta(2, 4, 64), pool, pool, tables, lens)),
        "paged_chunk": (pa.paged_chunk_attention,
                        lambda: pa.paged_chunk_attention(
                            _meta(2, 3, 4, 64), pool, pool, tables, lens)),
        "moe_dispatch": (moe.moe_dispatch, lambda: moe.moe_dispatch(
            _meta(6, 64), torch.empty(4, dtype=torch.int32,
                                      device="meta"))),
        "moe_combine": (moe.moe_combine, lambda: moe.moe_combine(
            _meta(8, 64), _meta(6, 2, dtype=torch.float32), idx)),
        "weight_only_matmul": (wo.weight_only_matmul,
                               lambda: wo.weight_only_matmul(
                                   _meta(6, 64), codes, _meta(64))),
        "weight_only_gemm": (wo.weight_only_gemm,
                             lambda: wo.weight_only_gemm(
                                 _meta(256, 64), codes, _meta(64)))}


@pytest.mark.parametrize("kernel", ["paged_decode", "paged_chunk",
                                    "moe_dispatch", "moe_combine",
                                    "weight_only_matmul",
                                    "weight_only_gemm"])
def test_kernels_without_fp16_raise_before_launch(no_library, kernel):
    """The weight-only pair raises ``KernelTypeError`` for float16 off
    the CPU, before the library is reached, and counts no launch (its
    callers send fp16 to ``dequant_route`` first); the paged and MoE
    kernels have fp16 instances, so fp16 ``meta`` tensors pass their
    wrappers' checks and reach the library."""
    fn, call = _refusals()[kernel]
    n = fn.launches
    if kernel.startswith("weight_only"):
        with pytest.raises(_build.KernelTypeError):
            call()
        with pytest.raises(_build.KernelTypeError, match="float16"):
            _build.dtype_code(torch.float16)
    else:
        with pytest.raises(_Reached):
            call()
        assert _build.dtype_code(torch.float16, _build.FP16_DTYPES) == 2
    assert fn.launches == n


# --------------------------------------------------------------- O1, O2

def _pair():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    jm.train()
    tm.train()
    return jm, tm


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_fp16_training_matches_jax(level):
    """Two AdamW steps (global clip 1.0) under ``auto_cast(dtype=
    "float16")`` with a dynamic GradScaler at its defaults, both packages;
    O2 through ``decorate(dtype="float16")``: fp16 parameters but the
    LayerNorms', float32 masters.  Losses, the scaler and parameters as
    the module says; the fused step runs (no fallback) and the gradients
    after each step are the JAX package's, unscaled."""
    jm, tm = _pair()
    jopt = joptim.AdamW(learning_rate=LR, parameters=jm.parameters(),
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    if level == "O2":
        jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="float16")
        tm, topt = tamp.decorate(tm, topt, level="O2", dtype="float16")
        dt = {n: p.dtype for n, p in tm.named_parameters()}
        assert dt["gpt.blocks.0.attn.qkv.weight"] == torch.float16
        assert dt["gpt.blocks.0.ln1.weight"] == torch.float32
        assert {n: str(d).replace("torch.", "") for n, d in dt.items()} == \
            {n: str(p._value.dtype) for n, p in jm.named_parameters()}
    js, ts = jamp.GradScaler(), tamp.GradScaler()
    assert ts._scale == js._scale == 65536.0
    ids = np.random.RandomState(1).randint(0, 1024, (2, 32))
    tmetrics.reset()
    linear = ("qkv.weight", "proj.weight", "fc1.weight", "fc2.weight")
    for _ in range(STEPS):
        with jamp.auto_cast(True, level=level, dtype="float16"):
            jl = jm.compute_loss(paddle.to_tensor(ids),
                                 paddle.to_tensor(ids))
        js.scale(jl).backward()
        js.step(jopt)
        with tamp.auto_cast(True, level=level, dtype="float16",
                            device="cpu"):
            tl = tm.compute_loss(torch.from_numpy(ids),
                                 torch.from_numpy(ids))
        assert tl.dtype == torch.float32
        ts.scale(tl).backward()
        if level == "O2":
            assert tm.gpt.blocks[0].attn.qkv.weight.grad.dtype == \
                torch.float16
        ts.step(topt)
        np.testing.assert_allclose(tl.item(), float(jl.item()),
                                   atol=LOSS_ATOL, rtol=0)
        assert (ts._scale, ts._good_steps, ts._bad_steps, ts._found_inf) \
            == (js._scale, js._good_steps, js._bad_steps, js._found_inf)
        jg = {n: np.asarray(p.grad._value.astype("float32"))
              for n, p in jm.named_parameters()}
        for n, p in tm.named_parameters():
            want = jg[n].T if n.endswith(linear) else jg[n]
            np.testing.assert_allclose(p.grad.float().numpy(), want,
                                       atol=1e-3, rtol=0, err_msg=n)
        jopt.clear_grad()
        topt.clear_grad()
    fused = tmetrics.get("optimizer.fused")
    assert fused.value(kind="fallback") == 0
    assert fused.value(kind="hit") + fused.value(kind="miss") == STEPS
    lim = 2 * LR * STEPS
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        want = np.asarray(jp[n]._value.astype("float32"))
        if n.endswith(linear):
            want = want.T
        np.testing.assert_allclose(
            p.detach().float().numpy(), want, atol=lim,
            rtol=2 ** -10 if p.dtype == torch.float16 else 0, err_msg=n)
    assert topt._global_step == jopt._global_step
    if level == "O2":
        masters = topt._accumulators["master_weight"]
        assert masters["gpt.wte.weight"].dtype == torch.float32
        assert "gpt.blocks.0.ln1.weight" not in masters


def test_fp16_autocast_casts_the_products():
    """``auto_cast(dtype="float16")`` opens torch's autocast in float16:
    the matrix products run in fp16, the LayerNorms and the loss in
    float32; the flash wrapper receives fp16 q, k, v."""
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    seen = []
    orig = tflash.flash_attention_fwd

    def spy(q, *a, **kw):
        seen.append(q.dtype)
        return orig(q, *a, **kw)
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 1024, (1, 16)))
    tflash.flash_attention_fwd = spy
    try:
        with tamp.auto_cast(True, dtype="float16", device="cpu"):
            h = tm.gpt.blocks[0].attn.qkv(torch.randn(1, 4, 128))
            loss = tm.compute_loss(ids, ids)
    finally:
        tflash.flash_attention_fwd = orig
    assert h.dtype == torch.float16 and loss.dtype == torch.float32
    assert seen and all(d == torch.float16 for d in seen)


# ------------------------------------------------------ float16 serving

def _fp16_paged_case(B, nh, hd, bs, lens, maxb, seed):
    rng = np.random.RandomState(seed)
    npool = B * maxb + 1
    k = (rng.standard_normal((nh, npool, bs, hd)) * 0.5).astype(np.float16)
    v = (rng.standard_normal((nh, npool, bs, hd)) * 0.5).astype(np.float16)
    perm = rng.permutation(np.arange(1, npool))
    tables = np.zeros((B, maxb), np.int32)
    for b, n in enumerate(lens):
        live = min(-(-n // bs), maxb)
        tables[b, :live] = perm[b * maxb:b * maxb + live]
    return k, v, tables


@pytest.fixture
def pallas_load(monkeypatch):
    """`_chunk_fused_kernel` calls `pl.load`, gone from this jax release;
    ref indexing replaces it for the test only (as in
    ``tests/test_torch_kernels.py``)."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)


def test_fp16_paged_plain_versions_match_the_pallas_kernels(pallas_load):
    """The plain ``paged_decode``, ``paged_chunk`` and verify versions on
    fp16 inputs against the JAX Pallas kernels in interpret mode on the
    same fp16 values, fp16 out (TOL: a few fp16 roundings of an output of
    size ~1)."""
    from paddle_tpu.ops import pallas_paged as jpp
    from paddle_tpu_torch.ops import paged_attention as tpa
    B, nh, hd, bs, maxb = 4, 2, 16, 8, 5
    lens = np.array([0, 1, 13, 40], np.int32)
    k, v, tables = _fp16_paged_case(B, nh, hd, bs, lens, maxb, 0)
    q = (np.random.RandomState(1).standard_normal((B, nh, hd))
         ).astype(np.float16)
    want = jpp.paged_attention(*(jnp.asarray(a) for a in
                                 (q, k, v, tables, lens)), interpret=True)
    got = tpa.paged_attention(*(torch.from_numpy(a) for a in
                                (q, k, v, tables, lens)))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **TOL)
    for s, starts in ((6, (0, 7, 16, 33)), (3, (0, 0, 21, 37))):
        st = np.asarray(starts, np.int32)
        k, v, tables = _fp16_paged_case(B, nh, hd, bs, st + s, maxb, s)
        q = (np.random.RandomState(s).standard_normal((B, s, nh, hd))
             ).astype(np.float16)
        args = (q, k, v, tables, st)
        want = jpp.paged_chunk_attention(*(jnp.asarray(a) for a in args),
                                         interpret=True)
        targs = [torch.from_numpy(a) for a in args]
        for fn in (tpa.paged_chunk_attention, tpa.paged_verify_attention):
            got = fn(*targs)
            assert got.dtype == torch.float16
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want).astype(np.float32),
                **TOL)
        wantv = jpp.paged_verify_attention(*(jnp.asarray(a) for a in args),
                                           interpret=True)
        np.testing.assert_allclose(
            tpa.paged_verify_attention(*targs).float().numpy(),
            np.asarray(wantv).astype(np.float32), **TOL)


def _fp16_models():
    """The JAX gpt3_tiny with every parameter cast to fp16 and the port's
    fp16 model with the same fp16 values."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    for p in jm.parameters():
        p.set_value(p.astype("float16"))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", dtype=torch.float16,
                        seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm.eval()


@pytest.mark.parametrize("chunk", [0, 16])
def test_fp16_engine_streams_match_the_jax_engine(chunk):
    """An fp16 gpt3_tiny served by the port's engine (CPU: the plain
    paged versions in fp16) and by the JAX engine on the same fp16 weights
    (``FLAGS_serving_pallas_prefill=0``, ``FLAGS_serving_pallas_verify=0``:
    its dense views), whole-prompt and 16-token chunks, greedy: the
    streams are equal (ROADMAP.md reference fact 10: a token that parts
    would be reported with its top-2 logit gap, not tuned away); the
    pools are fp16, and the prefix cache's blocks export as fp16 numpy
    and import back bit for bit."""
    from paddle_tpu.flags import flag_guard
    from paddle_tpu.inference.serving import Request as JaxRequest
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu_torch.inference import serving as tserving
    jm, tm = _fp16_models()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 1024, (n,)).tolist() for n in (29, 11, 40)]
    budgets = (8, 6, 5)
    eng_kw = dict(max_batch=2, max_context=64, block_size=16,
                  steps_per_tick=4, prefill_chunk=chunk)
    with flag_guard(serving_pallas_prefill=False,
                    serving_pallas_verify=False, serving_overlap=False):
        jeng = JaxEngine(jm, **eng_kw)
        jreqs = [jeng.add_request(JaxRequest(p, max_new_tokens=b))
                 for p, b in zip(prompts, budgets)]
        jeng.run()
    eng = tserving.ServingEngine(tm, device="cpu", overlap=False, **eng_kw)
    assert eng.pools[0][0].dtype == torch.float16
    reqs = [eng.add_request(tserving.Request(p, max_new_tokens=b))
            for p, b in zip(prompts, budgets)]
    eng.run()
    got = [list(r.output_ids) for r in reqs]
    want = [list(r.output_ids) for r in jreqs]
    assert got == want
    blocks = eng.pools[0][0][:, 1:3].clone()
    host = tserving._to_host(blocks)
    assert host.dtype == np.float16
    assert torch.equal(tserving._from_host(host, torch.float16), blocks)


def test_sample_rows_reads_fp16_logits_in_float32():
    """Token choice on fp16 logits: the filter, softmax and threefry draw
    run on the float32 cast (the same tokens as on the float32 copy), and
    greedy rows take the fp16 argmax."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.models.generation import sample_rows
    logits = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (4, 1024)).astype(np.float16))
    keys = threefry.fold_in(threefry.key(torch.arange(4, dtype=torch.int64)
                                         + 7), torch.full((4,), 5))
    args = (torch.tensor([True, True, False, True]),
            torch.full((4,), 0.8), torch.tensor([0, 40, 0, 0]),
            torch.tensor([1.0, 1.0, 1.0, 0.9]), keys, True)
    got = sample_rows(logits, *args)
    assert torch.equal(got, sample_rows(logits.float(), *args))
    assert int(got[2]) == int(logits[2].float().argmax())
