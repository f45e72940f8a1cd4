"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (they build the kernels); where
there is none they skip.  Run them on the card with

    python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports jax, which the card's
machine need not have; this file imports only the port.)

Tolerances: fp32 atol 2e-5, rtol 1e-4 for outputs and atol 1e-4 for
gradients (sums over a whole sequence in another order); bf16 against the
plain version in fp32 on the same bf16 inputs, atol 2e-2 (one bf16
rounding of the output), and for gradients also rtol 1e-2 (a gradient of
a key sums over every query that sees it, and one bf16 rounding is 2^-8
of its size).
"""

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
# (B, Sq, Sk, nh, nkv, causal): ragged tiles, GQA, Sq < Sk, Sq > Sk
# (rows that see no key), non-causal
FLASH_CASES = [(2, 77, 77, 4, 4, True), (1, 40, 130, 4, 2, True),
               (1, 70, 50, 2, 2, True), (2, 65, 100, 4, 1, False)]


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


def _flash_inputs(gen, B, Sq, Sk, nh, nkv, hd, dtype):
    q = _randn(gen, (B, Sq, nh, hd), dtype)
    k = _randn(gen, (B, Sk, nkv, hd), dtype)
    v = _randn(gen, (B, Sk, nkv, hd), dtype)
    mask = (torch.rand((B, Sk), generator=gen, device="cuda") > 0.3).int()
    mask[-1] = 0                      # one batch row sees no key at all
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_fwd_kv_mask_and_dropout(gen, dtype, hd):
    for B, Sq, Sk, nh, nkv, causal in FLASH_CASES:
        q, k, v, mask = _flash_inputs(gen, B, Sq, Sk, nh, nkv, hd, dtype)
        for kv_mask, rate in ((mask, 0.0), (None, 0.1), (mask, 0.25)):
            out, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask,
                                              rate, seed=1234)
            ref, ref_lse = fa.flash_attention_fwd_reference(
                q.float(), k.float(), v.float(), causal, kv_mask, rate,
                seed=1234)
            torch.testing.assert_close(out.float(), ref, **TOL[dtype])
            torch.testing.assert_close(lse, ref_lse, **TOL[dtype])
        assert not out[-1].any() and torch.all(lse[-1] == -1e30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_bwd(gen, dtype, hd):
    for B, Sq, Sk, nh, nkv, causal in FLASH_CASES:
        q, k, v, mask = _flash_inputs(gen, B, Sq, Sk, nh, nkv, hd, dtype)
        do = _randn(gen, (B, Sq, nh, hd), dtype)
        for kv_mask, rate in ((None, 0.0), (mask, 0.0), (mask, 0.2)):
            out, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask,
                                              rate, seed=77)
            n_dq = fa.flash_attention_bwd_dq.launches
            n_dkv = fa.flash_attention_bwd_dkv.launches
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                         kv_mask, rate, seed=77)
            assert fa.flash_attention_bwd_dq.launches == n_dq + 1
            assert fa.flash_attention_bwd_dkv.launches == n_dkv + 1
            want = fa.flash_attention_bwd_reference(
                q.float(), k.float(), v.float(), out.float(), lse,
                do.float(), causal, kv_mask, rate, seed=77)
            for name, g, w, x in zip("qkv", got, want, (q, k, v)):
                assert g.dtype == x.dtype and g.shape == x.shape, name
                torch.testing.assert_close(g.float(), w, **GRAD_TOL[dtype],
                                           msg=lambda m: f"d{name}: {m}")


# bf16 on the tensor-core kernels (flash_fwd_tc_kernel,
# flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel): (B, Sq, Sk, nh, nkv,
# causal, kv mask, dropout)
# over Sq, Sk in {1, 63, 65, 127, 129, 1000}, Sq > Sk (rows that see no
# key), GQA groups 1, 4 and 16, a kv mask whose last batch row is fully
# masked, dropout 0.1
TC_CASES = [(1, 1, 1, 2, 2, True, False, 0.0),
            (1, 1, 1000, 4, 1, True, False, 0.0),
            (2, 63, 63, 2, 2, True, False, 0.0),
            (2, 65, 129, 4, 4, True, True, 0.0),
            (1, 127, 65, 4, 4, True, False, 0.0),
            (2, 129, 127, 16, 1, False, False, 0.1),
            (2, 1000, 1000, 4, 1, True, True, 0.1),
            (1, 1000, 63, 2, 2, True, False, 0.0)]


def _tc_inputs(gen, case, hd):
    B, Sq, Sk, nh, nkv, causal, masked, rate = case
    q, k, v, mask = _flash_inputs(gen, B, Sq, Sk, nh, nkv, hd,
                                  torch.bfloat16)
    return q, k, v, (causal, mask if masked else None, rate, 99)


def _no_key_rows(case):
    """Query rows that see no key: Sq > Sk under the causal mask, and the
    fully masked batch row of a kv mask."""
    B, Sq, Sk, _, _, causal, masked, _ = case
    rows = torch.zeros((B, Sq), dtype=torch.bool, device="cuda")
    if causal and Sq > Sk:
        rows[:, :Sq - Sk] = True
    if masked:
        rows[-1] = True
    return rows


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_fwd_bf16_tensor_cores(gen, case, hd):
    q, k, v, args = _tc_inputs(gen, case, hd)
    n = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    assert fa.flash_attention_fwd.launches == n + 1
    ref, ref_lse = fa.flash_attention_fwd_reference(q.float(), k.float(),
                                                    v.float(), *args)
    torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.bfloat16])
    empty = _no_key_rows(case)
    assert not out[empty].any()
    assert torch.all(lse.transpose(1, 2)[empty] == -1e30)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_bwd_dq_bf16_tensor_cores(gen, case, hd):
    q, k, v, args = _tc_inputs(gen, case, hd)
    do = _randn(gen, q.shape, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    n = fa.flash_attention_bwd_dq.launches
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
    assert fa.flash_attention_bwd_dq.launches == n + 1
    want = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        *args, parts=("dq",))[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    torch.testing.assert_close(dq.float(), want, **GRAD_TOL[torch.bfloat16])
    assert not dq[_no_key_rows(case)].any()


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_bwd_dkv_bf16_tensor_cores(gen, case, hd):
    """flash_bwd_dkv_tc_kernel against the fp32 plain version; a key no
    query sees (masked out by the kv mask) has zero gradient."""
    q, k, v, args = _tc_inputs(gen, case, hd)
    do = _randn(gen, q.shape, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    n = fa.flash_attention_bwd_dkv.launches
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, *args)
    assert fa.flash_attention_bwd_dkv.launches == n + 1
    want = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        *args, parts=("dkv",))
    for name, got, w, x in (("dk", dk, want[1], k), ("dv", dv, want[2], v)):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape, name
        torch.testing.assert_close(got.float(), w,
                                   **GRAD_TOL[torch.bfloat16],
                                   msg=lambda m: f"{name}: {m}")
    mask = args[1]
    if mask is not None:
        unseen = mask == 0
        assert not dk[unseen].any() and not dv[unseen].any()


@pytest.mark.parametrize("hd", [32, 96, 512])
def test_flash_bf16_unsupported_head_dim_raises(gen, hd):
    q = _randn(gen, (1, 64, 2, hd), torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device="cuda")
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    n = [fn.launches for fn in counted]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse, q, True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse, q, True)
    assert [fn.launches for fn in counted] == n


def test_flash_attention_function_matches_autograd(gen):
    """The autograd Function on the kernels against autograd through the
    plain forward, with the kv mask and dropout."""
    B, S, nh, hd = 2, 96, 4, 64
    q, k, v, mask = _flash_inputs(gen, B, S, S, nh, nh, hd, torch.float32)
    do = _randn(gen, (B, S, nh, hd), torch.float32)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_fwd_reference):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*x, True, mask, 0.1, 5)
        out = out[0] if isinstance(out, tuple) else out
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in x])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **GRAD_TOL[torch.float32])


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
def test_paged_decode_split_edges(gen, dtype):
    """Lengths at the edges of paged_decode's 256-key splits, 0 and the
    full table, and an out-of-pool table entry: empty splits and an
    all-empty row merge to the right answer (zeros for length 0)."""
    nh, hd, bs, maxb = 4, 128, 64, 16
    lens = [0, 1, 255, 256, 257, 511, 512, maxb * bs]
    B = len(lens)
    assert pa.decode_split(maxb, bs) == (4, 4)
    k = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    v = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    tables = _tables(gen, B, maxb, lens, bs)
    q = _randn(gen, (B, nh, hd), dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = pa.paged_attention.launches
    out = pa.paged_attention(q, k, v, tables, sl)
    assert pa.paged_attention.launches == n + 1
    ref = pa.paged_attention_reference(q.float(), k.float(), v.float(),
                                       tables, sl)
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
    assert not out[0].any()
    bad = tables.clone()
    bad[4, 1], bad[7, 9] = -1, 10 ** 6     # dropped keys inside a split
    torch.testing.assert_close(
        pa.paged_attention(q, k, v, bad, sl).float(),
        pa.paged_attention_reference(q.float(), k.float(), v.float(), bad,
                                     sl), **TOL[dtype])


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


def _chunk_case(gen, B, s, nh, hd, bs, maxb, starts, dtype):
    """Pools, tables of shuffled blocks covering each chunk (a chunk past
    the table keeps every column live) and chunk queries."""
    k = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    v = _randn(gen, (nh, B * maxb + 1, bs, hd), dtype)
    tables = _tables(gen, B, maxb, [x + s for x in starts], bs)
    q = _randn(gen, (B, s, nh, hd), dtype)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, k, v, tables, st


def _check_chunk(q, k, v, tables, st, dtype):
    n = pa.paged_chunk_attention.launches
    out = pa.paged_chunk_attention(q, k, v, tables, st)
    assert pa.paged_chunk_attention.launches == n + 1
    ref = pa.paged_chunk_attention_reference(q.float(), k.float(),
                                             v.float(), tables, st)
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
    return out


@pytest.mark.parametrize("s", [1, 4, 70, 256])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_chunk_bf16_tensor_cores(gen, hd, bs, s):
    """paged_chunk_tc_kernel (split or not, as chunk_split picks) at every
    head dim it takes, two block sizes and verify-sized to serving-sized
    chunks: starts 0, ragged, at a tile edge, and a chunk running past the
    512-key table (its rows attend the whole table), then the same with
    out-of-pool table entries (dropped keys)."""
    nh, maxb = 2, 512 // bs
    starts = [0, 37, 128, 500]
    q, k, v, tables, st = _chunk_case(gen, len(starts), s, nh, hd, bs, maxb,
                                      starts, torch.bfloat16)
    _check_chunk(q, k, v, tables, st, torch.bfloat16)
    bad = tables.clone()
    bad[1, 0], bad[2, 3], bad[3, maxb - 1] = -1, 10 ** 6, -7
    _check_chunk(q, k, v, bad, st, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_keys", [64, 128, 256, 1 << 30])
def test_paged_chunk_split_edges(gen, monkeypatch, dtype, split_keys):
    """The key axis in splits of 64 .. 256 keys and unsplit: rows whose
    keys end one before, at and one past a split edge, a chunk whose keys
    all lie in the first split, rows that see only dropped keys (zeros),
    and splits past every row's keys (merged as empty)."""
    monkeypatch.setattr(pa, "_CHUNK_SPLIT_KEYS", split_keys)
    nh, hd, bs, maxb, s = 2, 128, 16, 32, 70
    # last keys of the rows: 0..69, 57..126, 186..255, 187..256,
    # 188..257 (across the edges at 64, 128, 192 and 256), 480..549 (past
    # the 512-key table)
    starts = [0, 57, 186, 187, 188, 480]
    q, k, v, tables, st = _chunk_case(gen, len(starts), s, nh, hd, bs, maxb,
                                      starts, dtype)
    per, n_split = pa.chunk_split(len(starts), nh, s, maxb, bs)
    assert n_split == -(-maxb * bs // per) and per % 64 == 0
    _check_chunk(q, k, v, tables, st, dtype)
    bad = tables.clone()
    bad[0, :2] = -1              # rows 0..31 of sequence 0 see no key
    out = _check_chunk(q, k, v, bad, st, dtype)
    assert not out[0, :2 * bs].any()


@pytest.mark.parametrize("hd", [32, 96])
def test_paged_chunk_unsupported_head_dim_raises(gen, hd):
    q, k, v, tables, st = _chunk_case(gen, 1, 8, 2, hd, 16, 4, [3],
                                      torch.bfloat16)
    n = pa.paged_chunk_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_chunk_attention(q, k, v, tables, st)
    assert pa.paged_chunk_attention.launches == n


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


def test_training_steps_match_the_cpu(gen):
    """Three AdamW steps of a tiny GPT (hd 64) with dropout 0 on the card
    (kernels) and on the CPU (plain versions): losses within 1e-4, and the
    flash kernels launched once per layer and step."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt3_tiny(num_heads=2)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    card = GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    losses = []
    for model in (cpu, card):
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        x = ids.to(model.device)
        n = fa.flash_attention_bwd_dkv.launches
        run = []
        for _ in range(3):
            loss = model.compute_loss(x, x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    assert fa.flash_attention_bwd_dkv.launches == n + 3 * cfg.num_layers
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), atol=1e-4, rtol=0.0)
    assert losses[1][-1] < losses[1][0]


def test_hd32_serves_and_trains_on_the_plain_routes(gen):
    """gpt3_tiny (hd 32, which no attention kernel takes) on the card: one
    greedy request with whole-prompt and chunked prefill, and 2 AdamW
    steps, through the kernels' plain versions, counted in plain_calls and
    never in launches; streams equal the CPU's, losses within 1e-4."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt3_tiny()
    assert cfg.hidden_size // cfg.num_heads == 32
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    card = GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    counted = (fa.flash_attention_fwd, pa.paged_attention,
               pa.paged_chunk_attention)
    launches = [fn.launches for fn in counted]
    plain = [fn.plain_calls for fn in counted]
    prompt = list(range(5, 60))
    streams = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        for chunk in (0, 16):
            eng = ServingEngine(model, max_batch=1, max_context=128,
                                block_size=16, steps_per_tick=4,
                                prefill_chunk=chunk, device=dev)
            req = eng.add_request(Request(prompt, max_new_tokens=10))
            eng.run()
            streams.append(req.output_ids)
    assert all(s == streams[0] for s in streams)
    ids = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    losses = []
    for model in (cpu, card):
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        x = ids.to(model.device)
        run = []
        for _ in range(2):
            loss = model.compute_loss(x, x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), atol=1e-4, rtol=0.0)
    assert [fn.launches for fn in counted] == launches
    assert all(fn.plain_calls > n for fn, n in zip(counted, plain))


# --------------------------------------------------------------------- MoE

def _moe_routing(T, M, E=4, dtype=torch.float32, training=True, seed=0):
    """A GShard routing of T random tokens (drops and empty slots at the
    training capacity 1.2) and the dispatch/combine inputs on the card."""
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    from paddle_tpu_torch.ops import moe as mo
    g = torch.Generator().manual_seed(seed)
    gate = GShardGate(M, E, generator=g).cuda().train(training)
    x = torch.randn((T, M), generator=g).cuda()
    with torch.no_grad():
        eid, slot, keep, w, cap, _ = gate.forward_indices(x)
    flat, inv = mo.routing_indices(eid, slot, keep, E, cap)
    rows = torch.randn((E * cap, M), generator=g).cuda()
    return x.to(dtype), rows.to(dtype), w, flat, inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,M,training", [(1000, 256, True), (8, 2048, False),
                                          (333, 136, True)])
def test_moe_dispatch_and_combine(gen, dtype, T, M, training):
    """Dispatch exact; combine exact against the plain version on the same
    inputs (float32 products and sums in the same order, one rounding to
    the rows' type)."""
    from paddle_tpu_torch.ops import moe as mo
    x, rows, w, flat, inv = _moe_routing(T, M, dtype=dtype,
                                         training=training)
    nd, nc = mo.moe_dispatch.launches, mo.moe_combine.launches
    out = mo.moe_dispatch(x, inv)
    assert torch.equal(out, mo.moe_dispatch_reference(x, inv))
    assert not out[inv == T].any()
    got = mo.moe_combine(rows, w, flat)
    assert torch.equal(got, mo.moe_combine_reference(rows, w, flat))
    assert (mo.moe_dispatch.launches, mo.moe_combine.launches) == \
        (nd + 1, nc + 1)
    # every choice dropped: zeros
    none = torch.full_like(flat, rows.shape[0])
    assert not mo.moe_combine(rows, w, none).any()
    assert not mo.moe_dispatch(x, torch.full_like(inv, T)).any()


def test_moe_layer_grads_match_the_cpu(gen):
    """MoELayer forward and backward on the card (kernels) and the CPU
    (plain versions), one set of weights and uniforms: atol 1e-5."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    torch.manual_seed(0)
    cpu = MoELayer(64, num_expert=4, d_hidden=128, gate="gshard",
                   device="cpu")
    card = MoELayer(64, num_expert=4, d_hidden=128, gate="gshard")
    card.load_state_dict(cpu.state_dict())
    u = torch.rand(300)
    x = torch.randn(3, 100, 64)
    r = torch.randn(3, 100, 64)
    got = []
    for layer in (cpu, card):
        dev = next(layer.parameters()).device
        layer.gate.uniforms = lambda n, device: u[:n].to(device)
        xi = x.to(dev).clone().requires_grad_()
        out = layer(xi)
        ((out * r.to(dev)).sum() + layer.l_aux).backward()
        got.append([out.detach().cpu(), xi.grad.cpu()]
                   + [p.grad.cpu() for p in layer.parameters()])
    for a, b in zip(*got):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)


def test_moe_gpt_serving_and_training_match_the_cpu(gen):
    """A tiny GPT-MoE (hd 64): greedy streams equal card and CPU, and
    three AdamW steps with random routing agree (losses within 1e-4);
    each MoE block launches both kernels once per forward."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.ops import moe as mo
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt3_tiny(num_heads=2, moe_num_experts=4)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    card = GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    prompts = [list(range(1, 40)), list(range(7, 20)), list(range(3, 90))]
    streams = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        model.eval()
        eng = ServingEngine(model, max_batch=2, max_context=128,
                            block_size=16, steps_per_tick=4, device=dev)
        reqs = [eng.add_request(Request(p, max_new_tokens=8))
                for p in prompts]
        eng.run()
        streams.append([r.output_ids for r in reqs])
    assert streams[0] == streams[1]
    ids = torch.randint(0, cfg.vocab_size, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    u = torch.rand(3, 200)
    losses = []
    for model in (cpu, card):
        model.train()
        draws = iter(u)
        model.gpt.blocks[1].mlp.gate.uniforms = \
            lambda n, device: next(draws)[:n].to(device)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        x = ids.to(model.device)
        n = mo.moe_combine.launches
        run = []
        for _ in range(3):
            loss = model.compute_loss(x, x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    assert mo.moe_combine.launches == n + 3
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), atol=1e-4, rtol=0.0)
    assert losses[1][-1] < losses[1][0]
