"""The port's weight-only quantized serving and `quantization` package
against the JAX package's, on the CPU.

* The int8 and fp8 absmax quantizers (`quantization/weight_only.py`): codes
  and scales bit-identical to JAX's, float32 and bfloat16, either axis,
  with an all-zero channel (scale 1).
* The engine snapshot (`inference/quant.py`): `stats()` and the per-leaf
  reduction axes equal JAX's on the GPT and GQA Llama state dicts (the
  port reduces its `[out, in]` linear weights over axis 1 where JAX
  reduces `[in, out]` over axis 0; the codes are JAX's transposed).
* `weight_only_matmul_reference` and `nn.quant` (`weight_quantize`,
  `weight_dequantize`, `weight_only_linear`, `llm_int8_linear`) against
  JAX: codes exact, products within atol 1e-5 in float32.
* The quantized engines: `ServingEngine(model, quant="int8" | "fp8")`
  against the JAX engine's same mode, both with the overlapped loop on and
  the JAX engine's paged Pallas views off (as in
  `tests/test_torch_serving.py`): greedy and sampled streams, `steps`,
  `ticks` and `stats()["quant"]` equal, for GPT and GQA Llama, whole-prompt
  and 16-token chunks with the prefix cache (a shared prefix: hits), n-gram
  speculation and a model draft (quantized too).  The mode check's
  message is the JAX engine's.
* The serving twin holds codes, not the model's float matmul weights, and
  later edits of the live model do not reach the engine.
* `inference/graphs.py`'s counts, which a capture records and a replay
  adds again, include both weight-only kernels'.  The callers' three ways,
  decided from the whole shape on `meta` tensors (the library a stub):
  `weight_only_matmul` up to 128 rows, `weight_only_gemm` for wider bf16,
  and the counted dequantize route for what neither takes (K 72, float16,
  float32 past 128 rows, a non-contiguous or misaligned x).
* `weight_only_gemm`'s tile schedule (`gemm_schedule`): pure in (M, N, K,
  SMs), its units covering every output and every k once over Llama-2
  7B's and GPT-3 1.3B's shapes at M 129-4096 and 132 or 114 SMs, and
  passed to the kernel with a workspace exactly when K is split.
* QAT and PTQ on a small MLP: forward, the straight-through gradient mask,
  the EMA and observer scales, `convert`.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference import quant as jquant
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import quant as jnq
from paddle_tpu.quantization import weight_only as jwo
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.inference import quant as tquant
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import quant as tnq
from paddle_tpu_torch.ops import weight_only as wo
from paddle_tpu_torch.quantization import weight_only as two

JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)
QUANTIZERS = {"int8": (jwo.quantize_absmax_int8, two.quantize_absmax_int8),
              "fp8": (jwo.quantize_absmax_fp8, two.quantize_absmax_fp8)}


def _bits(a):
    """The bytes of an array or tensor, for bit-for-bit comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 else \
            a.float().numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        np.asarray(jnp.asarray(a).astype(jnp.float32)).view(np.uint32)


def _weight(rng, shape):
    """Channels of different magnitudes, an all-zero column and row."""
    w = (rng.standard_normal(shape)
         * rng.exponential(1.0, (1, shape[1]))).astype(np.float32)
    w[:, 3] = 0.0
    w[5, :] = 0.0
    return w


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantizers_are_bit_identical_to_jax(mode, dtype, axis):
    w = _weight(np.random.RandomState(0), (64, 48))
    jfn, tfn = QUANTIZERS[mode]
    jqv, js = jfn(jnp.asarray(w).astype(dtype), axis=axis)
    tqv, ts = tfn(torch.from_numpy(w).to(getattr(torch, dtype)), axis=axis)
    assert tqv.dtype == (torch.int8 if mode == "int8"
                         else torch.float8_e4m3fn)
    assert tuple(ts.shape) == js.shape and ts.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(_bits(two.dequantize(tqv, ts)),
                                  _bits(jwo.dequantize(jqv, js)))
    # the all-zero channel: scale 1, codes 0
    zero = 3 if axis == 0 else 5
    assert float(ts.reshape(-1)[zero]) == 1.0


# ------------------------------------------------------------- snapshots

def _jax_llama(**kw):
    return JaxLlamaConfig(**{**vars(jax_llama_tiny()), **kw})


# Llama with GQA: 2 kv heads for 4 query heads
FAMILIES = {"gpt": (JaxGPT, jax_tiny, GPTForCausalLM, gpt3_tiny, {}),
            "llama": (JaxLlama, _jax_llama, LlamaForCausalLM, llama_tiny,
                      dict(num_kv_heads=2))}


def _pair(family, seed=0, **kw):
    """The JAX model of a family and the port's with the same weights."""
    jax_cls, jax_cfg, cls, cfg, fkw = FAMILIES[family]
    paddle.seed(seed)
    jm = jax_cls(jax_cfg(**fkw, **kw))
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = cls(cfg(**fkw, **kw), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm


@pytest.fixture(scope="module")
def models(request):
    """A target and a one-layer draft of a family (GPT unless a test asks
    for another), each as the JAX model and the port's."""
    family = getattr(request, "param", "gpt")
    return _pair(family), _pair(family, 5, num_layers=1)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("models", ["gpt", "llama"], indirect=True)
def test_snapshot_stats_and_axes_match_jax(models, mode):
    (jm, tm), _ = models
    jsd = jm.state_dict()
    keys = sorted(jsd)
    jsnap = jquant.snapshot(keys, [jsd[k]._value for k in keys], mode)
    twin, snap = tquant.quantize_model(tm, mode)
    assert sorted(tm.state_dict()) == keys
    assert snap.stats() == jsnap.stats()
    assert snap.stats()["quantized_tensors"] > 0
    linear = {k for k in keys
              if k.endswith(".weight") and tm.get_submodule(k[:-7])
              .__class__ is torch.nn.Linear}
    for key, axis, jaxis, v, jv in zip(keys, snap.axes, jsnap.axes,
                                       snap.values, jsnap.values):
        if jaxis is None:
            assert axis is None, key
            continue
        assert axis == (1 - jaxis if key in linear else jaxis), key
        q, s = v
        if key in linear:
            q, s = q.t(), s.t()
        np.testing.assert_array_equal(_bits(q), _bits(jv[0]))
        np.testing.assert_array_equal(_bits(s), _bits(jv[1]))
    # the twin: codes and scales as buffers, no float matmul weight
    names = dict(twin.named_parameters())
    assert not any(k in names for k, a in zip(keys, snap.axes)
                   if a is not None)
    kinds = {type(m) for m in twin.modules()}
    assert tquant.WeightOnlyLinear in kinds
    assert tquant.WeightOnlyEmbedding in kinds
    assert torch.nn.Linear not in kinds


# -------------------------------------------------------- the product

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_weight_only_matmul_reference_matches_jax(mode):
    rng = np.random.RandomState(1)
    w = _weight(rng, (48, 40))                      # JAX layout [K, N]
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    jfn, tfn = QUANTIZERS[mode]
    jqv, js = jfn(jnp.asarray(w), axis=0)
    want = np.asarray(jnp.asarray(x) @ jwo.dequantize(jqv, js)
                      + jnp.asarray(b))
    tqv, ts = tfn(torch.from_numpy(w.T.copy()), axis=1)   # [N, K]
    np.testing.assert_array_equal(_bits(tqv), _bits(np.asarray(jqv).T))
    got = wo.weight_only_matmul(torch.from_numpy(x), tqv, ts.reshape(-1),
                                torch.from_numpy(b))
    assert got.shape == (3, 5, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), wo.weight_only_matmul_reference(
            torch.from_numpy(x), tqv, ts.reshape(-1),
            torch.from_numpy(b)).numpy())
    # a CPU tensor never counts a launch or a dequantize route
    assert wo.weight_only_matmul.launches == 0
    assert wo.weight_only_matmul.dequant_calls == 0


def test_nn_quant_matches_jax():
    rng = np.random.RandomState(2)
    w = _weight(rng, (48, 40))                      # Paddle's [K, N]
    x = rng.standard_normal((6, 48)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    jqv, js = jnq.weight_quantize(paddle.to_tensor(w))
    tqv, ts = tnq.weight_quantize(torch.from_numpy(w))
    assert tqv.shape == (48, 40) and tqv.t().is_contiguous()
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv._value))
    np.testing.assert_array_equal(_bits(ts), _bits(js._value))
    np.testing.assert_array_equal(
        _bits(tnq.weight_dequantize(tqv, ts)),
        _bits(jnq.weight_dequantize(jqv, js)._value))
    jx, jb = paddle.to_tensor(x), paddle.to_tensor(b)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    for jargs, targs in (((jqv, jb, js), (tqv, tb, ts)),
                         ((jqv, None, js), (tqv, None, ts)),
                         ((jqv, jb, None), (tqv, tb, None))):
        want = np.asarray(jnq.weight_only_linear(jx, *jargs)._value)
        got = tnq.weight_only_linear(tx, *targs)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # a contiguous [K, N] weight takes the same product
    np.testing.assert_array_equal(
        tnq.weight_only_linear(tx, tqv.contiguous(), tb, ts).numpy(),
        tnq.weight_only_linear(tx, tqv, tb, ts).numpy())
    np.testing.assert_allclose(
        tnq.llm_int8_linear(tx, tqv, tb, ts).numpy(),
        np.asarray(jnq.llm_int8_linear(jx, jqv, jb, js)._value),
        atol=1e-5, rtol=0)
    # K 72: a width no kernel takes (the card's dequantize route), which
    # JAX's weight_only_linear computes like any other
    w = _weight(rng, (72, 40))
    x = rng.standard_normal((6, 72)).astype(np.float32)
    jqv, js = jnq.weight_quantize(paddle.to_tensor(w))
    tqv, ts = tnq.weight_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv._value))
    np.testing.assert_allclose(
        tnq.weight_only_linear(torch.from_numpy(x), tqv, tb, ts).numpy(),
        np.asarray(jnq.weight_only_linear(paddle.to_tensor(x), jqv, jb,
                                          js)._value), atol=1e-5, rtol=0)


# --------------------------------------------------------------- engines

def _shared_mix():
    """Two prompts sharing a 32-token prefix (two full 16-token blocks: a
    hit for the second), a third on its own; greedy and sampled."""
    rng = np.random.RandomState(3)
    system = rng.randint(1, 1024, (32,)).tolist()
    prompts = [system + rng.randint(1, 1024, (9,)).tolist(),
               rng.randint(1, 1024, (21,)).tolist(),
               system + rng.randint(1, 1024, (5,)).tolist()]
    return [dict(prompt_ids=p, max_new_tokens=(8, 7, 6)[i],
                 do_sample=i == 1, seed=40 + i, temperature=0.9, top_k=40,
                 top_p=0.95)
            for i, p in enumerate(prompts)]


def _spec_mix():
    """A repetitive prompt (n-gram hits) and a random one; one sampled."""
    rng = np.random.RandomState(4)
    pat = rng.randint(1, 1024, (6,)).tolist()
    return [dict(prompt_ids=(pat * 6)[:26], max_new_tokens=10),
            dict(prompt_ids=rng.randint(1, 1024, (15,)).tolist(),
                 max_new_tokens=9, do_sample=True, seed=7, temperature=1.3,
                 top_k=0, top_p=1.0)]


ENGINE = dict(max_batch=2, max_context=64, block_size=16, steps_per_tick=4,
              pad_buckets=(64,))   # one prompt bucket: fewer JAX compiles
ENGINE_CASES = [
    ("gpt", "int8", dict(prefill_chunk=0), _shared_mix),
    ("gpt", "fp8", dict(prefill_chunk=16), _shared_mix),
    ("llama", "fp8", dict(prefill_chunk=0), _shared_mix),
    ("llama", "int8", dict(prefill_chunk=16), _shared_mix),
    ("gpt", "int8", dict(spec_decode=True, spec_draft="ngram", spec_k=4),
     _spec_mix),
    ("gpt", "fp8", dict(spec_decode=True, spec_draft="model", spec_k=3),
     _spec_mix)]
ENGINE_IDS = ["gpt-int8-whole", "gpt-fp8-chunked", "llama-fp8-whole",
              "llama-int8-chunked", "gpt-int8-ngram", "gpt-fp8-model-draft"]


def _serve(engine_cls, req_cls, model, mix, **kw):
    eng = engine_cls(model, **{**ENGINE, **kw})
    reqs = [eng.add_request(req_cls(**m)) for m in mix()]
    eng.run()
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert [len(r.output_ids) for r in reqs] == [m["max_new_tokens"]
                                                 for m in mix()]
    return [list(r.output_ids) for r in reqs], st


@pytest.mark.parametrize(
    "models,mode,case,mix",
    [pytest.param(f, m, c, x, id=i)
     for (f, m, c, x), i in zip(ENGINE_CASES, ENGINE_IDS)],
    indirect=["models"])
def test_quant_engine_matches_the_jax_engine(models, mode, case, mix):
    (jm, tm), (jd, td) = models
    draft = case.get("spec_draft") == "model"
    with flag_guard(serving_overlap=True, **JAX_FLAGS):
        want, jst = _serve(JaxEngine, JaxRequest, jm, mix, quant=mode,
                           prefix_cache=True,
                           draft_model=jd if draft else None, **case)
    got, st = _serve(ServingEngine, Request, tm, mix, quant=mode,
                     device="cpu", overlap=True,
                     draft_model=td if draft else None, **case)
    assert got == want
    assert st["quant"] == jst["quant"]
    assert st["quant"]["mode"] == mode
    for key in ("steps", "ticks", "prefill_chunks", "prefix_cache",
                "speculative"):
        assert st.get(key) == jst.get(key), key
    if not case.get("spec_decode"):
        assert st["prefix_cache"]["hits"] > 0


def test_moe_quant_engine_matches_the_jax_engine(monkeypatch):
    """GPT-MoE in int8: the 2-D gate weights are quantized, the stacked
    expert weights stay fp (the snapshots' stats equal), and the greedy
    streams equal the JAX engine's.  The JAX MoE kernels' interpret mode
    calls `pl.load` / `pl.store`, gone from this jax release: ref
    indexing stands in, as in `tests/test_torch_moe.py`."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)
    if not hasattr(pl, "store"):
        monkeypatch.setattr(pl, "store",
                            lambda ref, idx, v: ref.__setitem__(idx, v),
                            raising=False)
    paddle.seed(4)
    jm = JaxGPT(jax_tiny(moe_num_experts=4))
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(moe_num_experts=4), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    tm.eval()
    twin, _ = tquant.quantize_model(tm, "int8")
    assert isinstance(twin.gpt.blocks[1].mlp.gate.gate,
                      tquant.WeightOnlyLinear)
    def mix():                # greedy: the fewest JAX programs to build
        return [m for m in _shared_mix() if not m["do_sample"]]
    kw = dict(quant="int8", prefix_cache=False)
    with flag_guard(serving_overlap=True, **JAX_FLAGS):
        want, jst = _serve(JaxEngine, JaxRequest, jm, mix, **kw)
    got, st = _serve(ServingEngine, Request, tm, mix, device="cpu",
                     overlap=True, **kw)
    assert got == want
    assert st["quant"] == jst["quant"]
    assert (st["steps"], st["ticks"]) == (jst["steps"], jst["ticks"])


def test_quant_mode_is_checked_as_the_jax_engine_checks_it(models):
    (jm, tm), _ = models
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, quant="int4", **ENGINE)
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, quant="int4", device="cpu", **ENGINE)
    assert str(got.value) == str(want.value)
    assert "quant" not in ServingEngine(tm, device="cpu",
                                        **ENGINE).stats()


def test_quant_engine_is_a_snapshot_of_the_model():
    """Edits of the live model after construction do not reach the
    engine; the twin's logits are the dequantized model's."""
    _, tm = _pair("gpt")
    mix = _shared_mix
    eng = ServingEngine(tm, quant="int8", device="cpu", **ENGINE)
    for p in eng.model.parameters():
        assert all(p.data_ptr() != q.data_ptr() for q in tm.parameters())
    before, _ = _serve(ServingEngine, Request, tm, mix, quant="int8",
                       device="cpu")
    reqs = [eng.add_request(Request(**m)) for m in mix()]
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(-1.0)
    eng.run()
    assert [list(r.output_ids) for r in reqs] == before
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(-1.0)
    # the twin computes the dequantized model's function
    twin, snap = tquant.quantize_model(tm, "fp8")
    ref = GPTForCausalLM(gpt3_tiny(), device="cpu")
    keys = sorted(tm.state_dict())
    ref.load_state_dict(dict(zip(keys, tquant.dequant_values(snap.values,
                                                             snap.axes))))
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        1, 1024, (2, 24)))
    with torch.no_grad():
        torch.testing.assert_close(twin(ids), ref(ids), atol=1e-5, rtol=0)


def test_replayed_program_counts_weight_only_launches():
    """``counters()`` names every count a capture records and each replay
    adds again: both weight-only kernels' launches and the dequantize
    routes are among them."""
    fn = wo.weight_only_matmul
    assert (fn, "launches") in graphs.counters()
    assert (fn, "dequant_calls") in graphs.counters()
    assert (wo.weight_only_gemm, "launches") in graphs.counters()


class _StubLibrary:
    """The kernel library off the card: records the entry points called
    (``meta`` tensors reach it with the wrappers' checks passed)."""

    def __init__(self):
        self.calls = []

    def ptt_weight_only_matmul(self, *args):
        self.calls.append("weight_only_matmul")
        return 0

    def ptt_weight_only_gemm(self, *args):
        self.calls.append("weight_only_gemm")
        self.gemm_args = args
        return 0


@pytest.fixture
def stub_library(monkeypatch):
    """The library a stub and the card an H100's 132 SMs."""
    from paddle_tpu_torch.ops import _build
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    return lib


def _three_callers(x, q, s, N):
    """One product through each caller: ``WeightOnlyLinear``, the tied
    head ``WeightOnlyEmbedding.attend`` and ``nn.quant.weight_only_linear``
    (Paddle's ``[K, N]`` codes)."""
    bias = torch.zeros((N,), dtype=s.dtype, device=s.device)
    ys = [tquant.WeightOnlyLinear(q, s, bias)(x),
          tquant.WeightOnlyEmbedding(q, s).attend(x),
          tnq.weight_only_linear(x, q.t(), None, s)]
    for y in ys:
        assert y.shape == (*x.shape[:-1], N) and y.device == x.device
    return ys


@pytest.mark.parametrize("rows", [(128,), (129,), (3, 43)])
def test_wide_products_take_the_callers_dequant_route(stub_library, rows):
    """The callers' three ways off the CPU (here on ``meta``, the library a
    stub): at most 128 rows launch ``weight_only_matmul``; more rows launch
    ``weight_only_gemm`` in bfloat16 and take the counted dequantize route
    in float32 (``dequant_calls``, never a launch).  Each wrapper raises
    for the other's rows.  A CPU tensor never takes the route."""
    K, N = 32, 24
    wide = math.prod(rows) > wo.KERNEL_MAX_ROWS
    q = torch.zeros((N, K), dtype=torch.int8, device="meta")
    assert not wo.dequant_route(torch.empty(*rows, K), q)
    for dtype in (torch.float32, torch.bfloat16):
        s = torch.ones((N,), dtype=dtype, device="meta")
        x = torch.empty(*rows, K, dtype=dtype, device="meta")
        routed = wide and dtype == torch.float32
        assert wo.dequant_route(x, q) == routed
        mm, gemm = wo.weight_only_matmul, wo.weight_only_gemm
        n = (mm.launches, gemm.launches, mm.dequant_calls)
        del stub_library.calls[:]
        _three_callers(x, q, s, N)
        if routed:
            want, grew = [], (0, 0, 3)
        elif wide:
            want, grew = ["weight_only_gemm"] * 3, (0, 3, 0)
        else:
            want, grew = ["weight_only_matmul"] * 3, (3, 0, 0)
        assert stub_library.calls == want
        assert (mm.launches - n[0], gemm.launches - n[1],
                mm.dequant_calls - n[2]) == grew
        mm.launches, gemm.launches, mm.dequant_calls = n
        wrong, match = (mm, "at most 128") if wide else \
            (gemm, "more than 128")
        with pytest.raises(ValueError, match=match):
            wrong(x, q, s)


# (N, K) of Llama-2 7B's and GPT-3 1.3B's linear layers (q/k/v/o, gate/up,
# down, head; qkv, proj, fc1, fc2, head)
GEMM_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096),
               (6144, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
               (50304, 2048)]
GEMM_ROWS = [129, 200, 256, 300, 512, 1000, 1024, 2047, 2048, 4096]


def _gemm_units(M, N, K, sched):
    """The work of each unit as csrc/weight_only_gemm.cu walks it (its
    ``wg_unit``): ``(block, m0, m1, n0, n1, k0, k1)``; block b takes
    units b, b + blocks, ...; a unit's index has the tile's rows of x
    fastest, then its channels, then the split."""
    nk = -(-K // wo.GEMM_K_STEP)
    m_tiles, n_tiles = -(-M // sched.rows), -(-N // wo.GEMM_CHANNELS)
    units = m_tiles * n_tiles * sched.splits
    out = []
    for b in range(sched.blocks):
        for u in range(b, units, sched.blocks):
            mt, rest = u % m_tiles, u // m_tiles
            nt, split = rest % n_tiles, rest // n_tiles
            m0, n0 = mt * sched.rows, nt * wo.GEMM_CHANNELS
            kb = split * sched.k_steps
            ke = min(nk, kb + sched.k_steps)
            out.append((b, m0, min(M, m0 + sched.rows), n0,
                        min(N, n0 + wo.GEMM_CHANNELS), kb * wo.GEMM_K_STEP,
                        min(K, ke * wo.GEMM_K_STEP)))
    return out


def _covers_once(M, N, K, sched):
    """The units' rectangles tile [0, M) x [0, N) x [0, K) exactly: the
    rows and channels of the tiles partition M and N, and each tile's k
    ranges, one per split, partition K."""
    units = _gemm_units(M, N, K, sched)
    tiles = -(-M // sched.rows) * -(-N // wo.GEMM_CHANNELS)
    assert len(units) == tiles * sched.splits
    assert {u[0] for u in units} == set(range(sched.blocks))

    def partition(ranges, end):
        ranges = sorted(set(ranges))
        assert ranges[0][0] == 0 and ranges[-1][1] == end
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo < hi for lo, hi in ranges)

    partition([(u[1], u[2]) for u in units], M)
    partition([(u[3], u[4]) for u in units], N)
    ks = {}
    for _, m0, _, n0, _, k0, k1 in units:
        ks.setdefault((m0, n0), []).append((k0, k1))
    assert len(ks) == tiles
    for spans in ks.values():
        assert len(spans) == sched.splits
        partition(spans, K)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("N,K", GEMM_SHAPES)
def test_gemm_schedule_is_pure_and_covers_every_output_and_k_once(N, K,
                                                                  sms):
    """``gemm_schedule`` is a function of (M, N, K, SMs) alone (a captured
    launch replays the same schedule) and its units, walked as the kernel
    walks them, cover every output element and every k exactly once, with
    at most one block per SM, a tile height the kernel has and every
    split non-empty; a split only where the tiles leave SMs idle."""
    for M in GEMM_ROWS:
        sched = wo.gemm_schedule(M, N, K, sms)
        assert sched == wo.gemm_schedule(M, N, K, sms)
        assert sched.rows in wo.GEMM_ROWS and 1 <= sched.blocks <= sms
        tiles = -(-M // sched.rows) * -(-N // wo.GEMM_CHANNELS)
        assert sched.blocks == min(tiles * sched.splits, sms)
        assert sched.splits == 1 or tiles < sms
        _covers_once(M, N, K, sched)


@pytest.mark.parametrize("shape", [(129, 96, 4112), (300, 1000, 4096),
                                   (256, 4096, 11008), (2048, 4100, 4112),
                                   (64, 11008, 4096), (1, 33, 16)])
def test_gemm_units_cover_edges_once(shape):
    """The same at the kernel's edges: N below a tile, K off the 64-deep
    step with a shorter last split, one row, and the crossover's rows
    below the wrapper's (the raw kernel takes any M)."""
    M, N, K = shape
    for sms in (132, 114, 1):
        _covers_once(M, N, K, wo.gemm_schedule(M, N, K, sms))


@pytest.mark.parametrize("shape", [(256, 4096, 11008), (2048, 11008, 4096)])
def test_weight_only_gemm_passes_its_schedule(stub_library, shape):
    """Off the CPU (``meta``, the library a stub) the wrapper hands the
    kernel ``gemm_schedule``'s tile height, splits, steps and blocks for
    the card's SMs, and a workspace exactly when K is split."""
    M, N, K = shape
    q = torch.zeros((N, K), dtype=torch.int8, device="meta")
    s = torch.ones((N,), dtype=torch.bfloat16, device="meta")
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    n = wo.weight_only_gemm.launches
    y = wo.weight_only_gemm(x, q, s)
    wo.weight_only_gemm.launches = n
    assert y.shape == (M, N)
    sched = wo.gemm_schedule(M, N, K, 132)
    args = stub_library.gemm_args
    assert args[6:14] == (M, N, K, 0, sched.rows, sched.splits,
                          sched.k_steps, sched.blocks)
    assert (args[5] is None) == (sched.splits == 1)


# x of each shape or type no kernel takes on the card, and bf16 past the
# narrow kernel's rows (the GEMM's: not routed)
ROUTE_CASES = {
    "k72": dict(rows=(8,), K=72, dtype=torch.bfloat16, routed=True),
    "k72-wide": dict(rows=(130,), K=72, dtype=torch.bfloat16, routed=True),
    "float16": dict(rows=(8,), K=64, dtype=torch.float16, routed=True),
    "fp32-129": dict(rows=(129,), K=64, dtype=torch.float32, routed=True),
    "non-contiguous": dict(rows=(8,), K=64, dtype=torch.bfloat16,
                           routed=True, layout="transposed"),
    "misaligned": dict(rows=(8,), K=64, dtype=torch.bfloat16, routed=True,
                       layout="offset"),
    "bf16-129": dict(rows=(129,), K=64, dtype=torch.bfloat16, routed=False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_decision_from_the_whole_shape(stub_library, case):
    """``dequant_route(x, q)`` on ``meta`` tensors (the wrappers' off-CPU
    path up to the launch): K 72, float16, float32 past 128 rows, a
    non-contiguous or misaligned x compute through the plain version in
    all three callers, each counted in ``dequant_calls`` and never
    launched; bf16 at 129 rows with K 64 goes to ``weight_only_gemm``.
    The wrappers themselves raise for every routed case."""
    c = ROUTE_CASES[case]
    K, N = c["K"], 40
    q = torch.zeros((N, K), dtype=torch.int8, device="meta")
    s = torch.ones((N,), dtype=c["dtype"], device="meta")
    layout = c.get("layout")
    if layout == "transposed":
        x = torch.empty(K, *c["rows"], dtype=c["dtype"], device="meta").t()
    elif layout == "offset":
        x = torch.empty(math.prod(c["rows"]) * K + 1, dtype=c["dtype"],
                        device="meta")[1:].view(*c["rows"], K)
    else:
        x = torch.empty(*c["rows"], K, dtype=c["dtype"], device="meta")
    assert wo.dequant_route(x, q) == c["routed"]
    mm, gemm = wo.weight_only_matmul, wo.weight_only_gemm
    n = (mm.launches, gemm.launches, mm.dequant_calls)
    _three_callers(x, q, s, N)
    grew = (mm.launches - n[0], gemm.launches - n[1],
            mm.dequant_calls - n[2])
    mm.launches, gemm.launches, mm.dequant_calls = n
    if not c["routed"]:
        assert grew == (0, 3, 0)
        assert stub_library.calls == ["weight_only_gemm"] * 3
        return
    assert grew == (0, 0, 3) and stub_library.calls == []
    wrapper = gemm if math.prod(c["rows"]) > wo.KERNEL_MAX_ROWS else mm
    with pytest.raises((ValueError, TypeError)):
        wrapper(x, q, s)
    assert stub_library.calls == []


# ------------------------------------------------------------- QAT, PTQ

def _mlp_pair():
    """A small MLP as a JAX Sequential and a torch one, same weights."""
    paddle.seed(3)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 4))
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))
    with torch.no_grad():
        for i in (0, 2):
            tnet[i].weight.copy_(torch.from_numpy(
                np.asarray(jnet[i].weight._value).T.copy()))
            tnet[i].bias.copy_(torch.from_numpy(
                np.array(jnet[i].bias._value)))
    return jnet, tnet


def _x(seed, n=6):
    return (np.random.RandomState(seed).standard_normal((n, 8)) * 2) \
        .astype(np.float32)


def test_qat_matches_jax():
    """Two training forwards (the scale's first value, then its EMA),
    the straight-through gradients, then an eval forward.  float32 sums in
    another order than XLA's: atol 1e-5 and rtol 1e-5 (outputs and
    gradients up to ~40)."""
    jnet, tnet = _mlp_pair()
    jcfg = jq.QuantConfig(activation=jq.FakeQuanterWithAbsMaxObserver,
                          weight=jq.FakeQuanterWithAbsMaxObserver)
    tcfg = tq.QuantConfig(activation=tq.FakeQuanterWithAbsMaxObserver,
                          weight=tq.FakeQuanterWithAbsMaxObserver)
    jqn, tqn = jq.QAT(jcfg).quantize(jnet), tq.QAT(tcfg).quantize(tnet)
    assert isinstance(tqn[0], tq.QuantedLinear)
    assert isinstance(tnet[0], torch.nn.Linear)          # original kept
    jqn.train()
    tqn.train()
    for seed in (0, 1):
        jx = paddle.to_tensor(_x(seed), stop_gradient=False)
        tx = torch.from_numpy(_x(seed)).requires_grad_()
        jy, ty = jqn(jx), tqn(tx)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy._value),
                                   atol=1e-5, rtol=1e-5)
        paddle.sum(jy * jy).backward()
        (ty * ty).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(),
                                   np.asarray(jx.grad._value), atol=1e-5,
                                   rtol=1e-5)
        for i in (0, 2):
            np.testing.assert_allclose(
                tqn[i].weight.grad.numpy().T,
                np.asarray(jqn[i].weight.grad._value), atol=1e-5, rtol=1e-5)
            for name in ("weight_quanter", "activation_quanter"):
                np.testing.assert_allclose(
                    float(getattr(tqn[i], name).scale),
                    float(getattr(jqn[i], name).scale._value), rtol=1e-6)
        jqn.clear_gradients()
        tqn.zero_grad()
    jqn.eval()
    tqn.eval()
    np.testing.assert_allclose(
        tqn(torch.from_numpy(_x(2))).detach().numpy(),
        np.asarray(jqn(paddle.to_tensor(_x(2)))._value), atol=1e-5,
        rtol=1e-5)


def test_ste_masks_gradients_outside_the_clip_range():
    x = np.array([-5.0, -1.0, 0.5, 1.0, 5.0], np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jy = jq.quantize_dequantize(jx, paddle.to_tensor(np.float32(1.0)))
    ty = tq.quantize_dequantize(tx, torch.tensor(1.0))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy._value))
    paddle.sum(jy).backward()
    ty.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jx.grad._value))
    np.testing.assert_array_equal(tx.grad.numpy(), [0, 1, 1, 1, 0])
    np.testing.assert_array_equal(
        tq.fake_quantize_absmax(torch.from_numpy(x)).numpy(),
        np.asarray(jq.fake_quantize_absmax(paddle.to_tensor(x))._value))


def test_ptq_matches_jax():
    """Calibration over an iterable of (input, label) batches: the
    observers' scales; then `convert` freezes them into fake quant."""
    jnet, tnet = _mlp_pair()
    jcfg = jq.QuantConfig(activation=jq.AbsmaxObserver,
                          weight=jq.AbsmaxObserver)
    tcfg = tq.QuantConfig(activation=tq.AbsmaxObserver,
                          weight=tq.AbsmaxObserver)
    jp, tp = jq.PTQ(jcfg), tq.PTQ(tcfg)
    jqn, tqn = jp.quantize(jnet), tp.quantize(tnet)
    batches = [(_x(s), np.zeros((6,), np.int64)) for s in (3, 4, 5)]
    jp.calibrate(jqn, [tuple(paddle.to_tensor(a) for a in b)
                       for b in batches], num_batches=2)
    tp.calibrate(tqn, [tuple(torch.from_numpy(a) for a in b)
                       for b in batches], num_batches=2)
    for i in (0, 2):
        # the weights' absmax exactly; the activations' after a float32
        # product summed in another order than XLA's
        assert float(tqn[i].weight_quanter.scale) == \
            float(jqn[i].weight_quanter.scale._value)
        np.testing.assert_allclose(
            float(tqn[i].activation_quanter.scale),
            float(jqn[i].activation_quanter.scale._value), rtol=1e-6)
    x = _x(6)
    # observing passes the signal through (and observes, on both sides)
    observing = tqn(torch.from_numpy(x)).detach().numpy()
    jqn(paddle.to_tensor(x))
    np.testing.assert_allclose(observing, tnet(torch.from_numpy(x))
                               .detach().numpy(), atol=1e-6, rtol=0)
    jfinal, tfinal = jp.convert(jqn), tp.convert(tqn)
    got = tfinal(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jfinal(
        paddle.to_tensor(x))._value), atol=1e-5, rtol=1e-5)
    assert not np.allclose(got, observing)
