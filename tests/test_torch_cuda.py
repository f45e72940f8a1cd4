"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (they build the kernels); where
there is none they skip.  Run them on the card with

    python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports jax, which the card's
machine need not have; this file imports only the port.)

Tolerances: fp32 atol 2e-5, rtol 1e-4; bf16 against the plain version in
fp32 on the same bf16 inputs, atol 2e-2 (one bf16 rounding of the output).
"""

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _tables(gen, B, maxb, lens, bs):
    perm = torch.randperm(B * maxb, generator=gen, device="cuda") + 1
    t = torch.zeros((B, maxb), dtype=torch.int32, device="cuda")
    for b, n in enumerate(lens):
        live = min(-(-n // bs), maxb)
        t[b, :live] = perm[b * maxb:b * maxb + live].int()
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_fwd(gen, dtype, hd):
    for B, Sq, Sk, nh, nkv in [(2, 77, 77, 4, 4), (1, 40, 130, 4, 2),
                               (1, 70, 50, 2, 2)]:
        q = _randn(gen, (B, Sq, nh, hd), dtype)
        k = _randn(gen, (B, Sk, nkv, hd), dtype)
        v = _randn(gen, (B, Sk, nkv, hd), dtype)
        before = fa.flash_attention_fwd.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        assert fa.flash_attention_fwd.launches == before + 1
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), causal=True)
        torch.testing.assert_close(out.float(), ref, **TOL[dtype])
        torch.testing.assert_close(lse, ref_lse, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode(gen, dtype):
    B, nh, hd, bs, maxb = 6, 4, 128, 16, 6
    lens = [0, 1, 16, 17, 50, 96]
    k = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    v = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    tables = _tables(gen, B, maxb, lens, bs)
    q = _randn(gen, (B, nh, hd), dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = pa.paged_attention(q, k, v, tables, sl)
    ref = pa.paged_attention_reference(q.float(), k.float(), v.float(),
                                       tables, sl)
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
    assert not out[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_chunk(gen, dtype):
    B, s, nh, hd, bs, maxb = 3, 70, 2, 64, 16, 8
    starts = [0, 21, 100]          # the last runs past the 128-key table
    k = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    v = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    tables = _tables(gen, B, maxb, [x + s for x in starts], bs)
    q = _randn(gen, (B, s, nh, hd), dtype)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    out = pa.paged_chunk_attention(q, k, v, tables, st)
    ref = pa.paged_chunk_attention_reference(q.float(), k.float(),
                                             v.float(), tables, st)
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])


@pytest.mark.parametrize("bad", [-1, 10 ** 6])
def test_paged_kernels_drop_out_of_pool_entries(gen, bad):
    nh, hd, bs, maxb = 2, 128, 16, 6
    k = _randn(gen, (nh, 8, bs, hd), torch.float32)
    v = _randn(gen, (nh, 8, bs, hd), torch.float32)
    tables = torch.tensor([[bad, 3, 5, 0, 0, 0], [2, bad, 7, 1, bad, 4]],
                          dtype=torch.int32, device="cuda")
    sl = torch.tensor([40, 96], dtype=torch.int32, device="cuda")
    q = _randn(gen, (2, nh, hd), torch.float32)
    torch.testing.assert_close(
        pa.paged_attention(q, k, v, tables, sl),
        pa.paged_attention_reference(q, k, v, tables, sl),
        **TOL[torch.float32])
    qc = _randn(gen, (2, 40, nh, hd), torch.float32)
    st = torch.tensor([0, 50], dtype=torch.int32, device="cuda")
    out = pa.paged_chunk_attention(qc, k, v, tables, st)
    torch.testing.assert_close(
        out, pa.paged_chunk_attention_reference(qc, k, v, tables, st),
        **TOL[torch.float32])
    assert not out[0, :bs].any()        # rows that saw only dropped keys


def test_serving_streams_match_the_cpu(gen):
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    cfg = gpt3_tiny(num_heads=2)                  # hd 64
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    card = GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    prompts = [list(range(1, 40)), list(range(7, 20)), list(range(3, 90))]
    streams = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        for chunk in (0, 32):
            eng = ServingEngine(model, max_batch=2, max_context=128,
                                block_size=16, steps_per_tick=4,
                                prefill_chunk=chunk, device=dev)
            reqs = [eng.add_request(Request(p, max_new_tokens=8))
                    for p in prompts]
            eng.run()
            streams.append([r.output_ids for r in reqs])
    assert all(s == streams[0] for s in streams)
