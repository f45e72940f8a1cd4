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
of its size); fp16 likewise at atol 4e-3, rtol 2e-3 (one fp16 rounding
is 2^-11).
"""

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0),
       torch.float16: dict(atol=4e-3, rtol=2e-3)}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [1, 4, 70, 256])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_chunk_bf16_tensor_cores(gen, hd, bs, s, dtype):
    """paged_chunk_tc_kernel (bf16 and fp16; split or not, as chunk_split
    picks) at every head dim it takes, two block sizes and verify-sized to
    serving-sized chunks: starts 0, ragged, at a tile edge, and a chunk
    running past the 512-key table (its rows attend the whole table), then
    the same with out-of-pool table entries (dropped keys)."""
    nh, maxb = 2, 512 // bs
    starts = [0, 37, 128, 500]
    q, k, v, tables, st = _chunk_case(gen, len(starts), s, nh, hd, bs, maxb,
                                      starts, dtype)
    _check_chunk(q, k, v, tables, st, dtype)
    bad = tables.clone()
    bad[1, 0], bad[2, 3], bad[3, maxb - 1] = -1, 10 ** 6, -7
    _check_chunk(q, k, v, bad, st, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


VERIFY_STARTS = [0, 0, 63, 64, 700, 1023, 1500, 2040]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_paged_verify_at_the_verify_shape(gen, dtype, s):
    """paged_verify_attention at the spec tick's shape: 8 slots of nh 16,
    hd 128 over a 2048-key table of 64-key blocks (bf16: 128 blocks, fewer
    than the card's SMs, so the keys are split and merged), k = s rows at
    mixed starts.  Rows 0 and 1 are free slots (start 0 on an all-zero
    table row: the pad block), row 2 crosses a block edge, row 7 ends at
    the table's last key; then the same with out-of-pool entries."""
    nh, hd, bs, maxb = 16, 128, 64, 32
    q, k, v, tables, st = _chunk_case(gen, len(VERIFY_STARTS), s, nh, hd,
                                      bs, maxb, VERIFY_STARTS, dtype)
    tables[:2] = 0
    if dtype != torch.float32:
        assert pa.chunk_split(8, nh, s, maxb, bs)[1] > 1
    for tbl in (tables, tables.clone()):
        if tbl is not tables:
            tbl[3, 1], tbl[5, 4], tbl[7, maxb - 1] = -1, 10 ** 6, -7
        n = (pa.paged_verify_attention.launches,
             pa.paged_chunk_attention.launches)
        out = pa.paged_verify_attention(q, k, v, tbl, st)
        assert (pa.paged_verify_attention.launches,
                pa.paged_chunk_attention.launches) == (n[0] + 1, n[1])
        ref = pa.paged_chunk_attention_reference(q.float(), k.float(),
                                                 v.float(), tbl, st)
        torch.testing.assert_close(out.float(), ref, **TOL[dtype])


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


def _prefix_spec_mix():
    """Three requests sharing a 32-token prompt (a miss, a hit, and the
    prompt alone: a hit that copies its last block on write), one
    repetitive prompt for the n-gram drafter, and a sampled request."""
    shared = list(range(3, 35))
    return [dict(prompt_ids=shared + list(range(60, 71)), max_new_tokens=9),
            dict(prompt_ids=shared + list(range(80, 100)),
                 max_new_tokens=7),
            dict(prompt_ids=shared, max_new_tokens=6),
            dict(prompt_ids=[5, 9, 14, 2] * 8, max_new_tokens=10),
            dict(prompt_ids=list(range(40, 63)), max_new_tokens=8,
                 do_sample=True, temperature=1.2, seed=21)]


def _serve_prefix_spec(model, draft, dev, **kw):
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    eng = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device=dev,
                        draft_model=draft if kw.get("spec_draft") == "model"
                        else None, **kw)
    reqs = [eng.add_request(Request(**m)) for m in _prefix_spec_mix()]
    eng.run()
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert st["prefix_cache"]["hits"] == 2
    return [r.output_ids for r in reqs]


SPEC_RUNS = [dict(), dict(spec_decode=True, spec_draft="ngram"),
             dict(spec_decode=True, spec_draft="ngram", spec_adaptive=True),
             dict(spec_decode=True, spec_draft="model", spec_k=3)]


def test_token_write_past_the_table_goes_to_the_pad_block(gen):
    """The card's decode write at a position past the table (a draft's
    step beyond a slot's budget) lands in the pad block, as on the CPU."""
    k = torch.randn((4, 9, 16, 64), generator=gen, device="cuda")
    v = torch.randn_like(k)
    tables = torch.tensor([[3, 1, 7, 4], [2, 8, 5, 6]], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([64, 70], dtype=torch.int32, device="cuda")
    step = torch.randn((2, 4, 64), generator=gen, device="cuda")
    want = [x.cpu() for x in (k, v)]
    pa.paged_write_token(*want, tables.cpu(), lens.cpu(), step.cpu(),
                         step.cpu())
    pa.paged_write_token(k, v, tables, lens, step, step)
    torch.cuda.synchronize()
    assert torch.equal(k.cpu(), want[0]) and torch.equal(v.cpu(), want[1])
    assert torch.equal(k[:, 0, 0].cpu(), step[0].cpu())


@pytest.mark.parametrize("hd", [32, 64])
def test_prefix_and_spec_streams_match_the_cpu(gen, hd):
    """gpt3_tiny with a prefix hit, a copy on write, n-gram and model-draft
    speculation (a 1-layer draft) on the card and on the CPU: equal
    streams, and the greedy ones equal to plain decoding's.  hd 64 runs
    the kernels (paged_chunk for the suffix prefills,
    paged_verify_attention for the verify); hd 32, which no kernel takes,
    runs their plain versions, each counted in plain_calls and no kernel
    launched."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    cfg = gpt3_tiny(num_heads=128 // hd)
    dcfg = gpt3_tiny(num_heads=128 // hd, num_layers=1)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    dcpu = GPTForCausalLM(dcfg, device="cpu", seed=4)
    card = GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    dcard = GPTForCausalLM(dcfg, device="cuda")
    dcard.load_state_dict(dcpu.state_dict())
    counted = (fa.flash_attention_fwd, pa.paged_attention,
               pa.paged_chunk_attention, pa.paged_verify_attention)
    launches = [fn.launches for fn in counted]
    plain = [fn.plain_calls for fn in counted]
    greedy = []
    for kw in SPEC_RUNS:
        want = _serve_prefix_spec(cpu, dcpu, "cpu", **kw)
        assert _serve_prefix_spec(card, dcard, "cuda", **kw) == want
        greedy.append(want[:4])
    # greedy speculation is lossless: the plain decode's streams
    assert all(g == greedy[0] for g in greedy)
    grew = [fn.launches > n for fn, n in zip(counted, launches)]
    took_plain = [fn.plain_calls > n for fn, n in zip(counted, plain)]
    if hd == 32:
        assert not any(grew) and all(took_plain)
    else:
        assert all(grew) and not any(took_plain)


# --------------------------------------------------------------------- MoE
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


# ------------------------------------------------- serving programs, graphs

def _graph_mix(sampled):
    """Five requests for two slots (admissions and evictions change the
    tables between replays), 24 new tokens each from prompts of 10 to 45
    tokens: every stream crosses a 16-token block boundary.  Sampled:
    every other request samples, with filters."""
    lens = (10, 30, 45, 17, 26)
    g = torch.Generator().manual_seed(11)
    return [dict(prompt_ids=torch.randint(1, 1024, (n,), generator=g)
                 .tolist(), max_new_tokens=24,
                 do_sample=sampled and i % 2 == 1, temperature=0.9,
                 top_k=40, top_p=0.95, seed=100 + i)
            for i, n in enumerate(lens)]


def _prefix_graph_mix():
    """A shared 32-token prompt: a miss, two hits (one copied on write)
    and a repetitive prompt for the n-gram drafter."""
    shared = list(range(3, 35))
    return [dict(prompt_ids=shared + list(range(60, 71)), max_new_tokens=20),
            dict(prompt_ids=shared + list(range(80, 100)),
                 max_new_tokens=24),
            dict(prompt_ids=shared, max_new_tokens=18, do_sample=True,
                 temperature=1.2, seed=21),
            dict(prompt_ids=[5, 9, 14, 2] * 8, max_new_tokens=24)]


def _tiny_card(**kw):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    return GPTForCausalLM(gpt3_tiny(num_heads=2, **kw), device="cuda",
                          seed=3).eval()


def _serve_card(model, mix, max_context=128, **kw):
    """Serve ``mix`` on the card (block 16, 2 slots, 4 steps a tick);
    returns the streams, every wrapper count's growth over the run (the
    warmup's not included) and the stats."""
    from paddle_tpu_torch.inference import graphs
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    eng = ServingEngine(model, max_batch=2, max_context=max_context,
                        block_size=16, steps_per_tick=4, device="cuda", **kw)
    if eng.cuda_graphs:
        eng.warmup()
    before = graphs.snapshot()
    reqs = [eng.add_request(Request(**m)) for m in mix]
    eng.run()
    torch.cuda.synchronize()
    grew = {(fn.__name__, a): getattr(fn, a) - v for fn, a, v in before}
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert [len(r.output_ids) for r in reqs] == \
        [m["max_new_tokens"] for m in mix]
    return [list(r.output_ids) for r in reqs], grew, st


def _graphs_against_eager(model, mix, **kw):
    """Graphs (the default) against eager programs on the card, overlap
    off in both: bit-identical streams and equal launch counts."""
    want, want_n, _ = _serve_card(model, mix, cuda_graphs=False,
                                  overlap=False, **kw)
    got, got_n, st = _serve_card(model, mix, overlap=False, **kw)
    assert got == want
    assert got_n == want_n and any(got_n.values())
    assert st["warmup"]["programs"] > 0 and st["graphs"]["replays"] > 0
    assert st["graphs"]["captured"] == st["warmup"]["programs"]
    return st


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunk", [0, 32])
def test_graph_ticks_match_eager(gen, chunk, sampled):
    _graphs_against_eager(_tiny_card(), _graph_mix(sampled),
                          prefill_chunk=chunk)


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_graph_spec_ticks_match_eager(gen, draft):
    kw = dict(spec_decode=True, spec_draft=draft, spec_k=3)
    if draft == "model":
        kw["draft_model"] = _tiny_card(num_layers=1)
    st = _graphs_against_eager(_tiny_card(), _graph_mix(True)[:4]
                               + _prefix_graph_mix()[3:], **kw)
    assert st["speculative"]["ticks"] > 0


@pytest.mark.parametrize("chunk", [0, 32])
def test_graph_prompt_programs_match_eager(gen, chunk):
    """The prefill and prefill_cont programs: a prefix mix served, and
    one program's logits row against the eager one's."""
    import numpy as np
    from paddle_tpu_torch.inference.serving import ServingEngine
    model = _tiny_card()
    st = _graphs_against_eager(model, _prefix_graph_mix(),
                               prefill_chunk=chunk)
    assert st["prefix_cache"]["hits"] == 2
    toks = torch.randint(1, 1024, (70,),
                         generator=torch.Generator().manual_seed(2)).tolist()
    row = np.arange(1, 9, dtype=np.int32)
    for kind, start in (("prefill", 0), ("prefill_cont", 40)):
        rows = []
        for graphs_on in (False, True):
            eng = ServingEngine(model, max_batch=2, max_context=128,
                                block_size=16, device="cuda",
                                cuda_graphs=graphs_on)
            if start:
                eng._forward_prompt("prefill", row, toks[:start], 0)
            rows.append(eng._forward_prompt(kind, row, toks[start:],
                                            start).clone())
            assert all((p.graph is not None) == graphs_on
                       for p in eng._programs.values())
        assert torch.equal(rows[0], rows[1])


def test_graph_moe_serving_matches_eager(gen):
    _graphs_against_eager(_tiny_card(moe_num_experts=4), _graph_mix(True))


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=16),
                                dict(spec_decode=True, spec_draft="model",
                                     spec_k=3)],
                         ids=["whole", "chunked", "model-draft"])
def test_overlap_on_and_off_give_equal_streams(gen, kw):
    model = _tiny_card()
    if kw.get("spec_draft") == "model":
        kw = dict(kw, draft_model=_tiny_card(num_layers=1))
    mix = _graph_mix(True)[:2]          # two requests: ticks chain
    off, off_n, _ = _serve_card(model, mix, overlap=False, **kw)
    on, on_n, st = _serve_card(model, mix, **kw)
    assert on == off and st["overlapped_ticks"] > 0
    if not kw.get("spec_decode"):
        # a chained spec tick's caps are upper bounds: its ticks differ
        assert on_n == off_n


def test_a_failed_capture_raises(gen, monkeypatch):
    """A program that cannot be captured (here: a host read inside it)
    raises from warmup() and from run(); no eager program stands in."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    def host_read(model, pools, bs, k, sampled):
        def tick(i, o):
            o["toks"].fill_(int(i["lens"].sum().item()))
        return tick
    monkeypatch.setattr(serving, "_tick_fn", host_read)
    eng = ServingEngine(_tiny_card(), max_batch=2, max_context=128,
                        block_size=16, steps_per_tick=4, device="cuda")
    with pytest.raises(RuntimeError):
        eng.warmup()
    assert not any(p.graph is None for p in eng._programs.values())
    eng.add_request(Request([1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.run()
    torch.cuda.synchronize()


# ------------------------------------------------ crash-only serving

def _same_nans(out, ref, dtype):
    """NaN exactly where the plain version has NaN, and some; the rest
    equal within the dtype's tolerance."""
    bad = torch.isnan(ref)
    assert bad.any() and torch.equal(torch.isnan(out.float()), bad)
    torch.testing.assert_close(out.float()[~bad], ref[~bad], **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", ["k", "v"])
def test_nan_keys_and_values_reach_what_reads_them(gen, dtype, pool):
    """A NaN key or value reaches exactly the outputs that read it, as in
    the plain versions (the crash-only watchdog sees a corrupted block);
    a row that sees no key still gives zeros.  paged_decode over several
    splits, paged_chunk split (B 1) and not, flash_fwd."""
    nh, hd = 2, 64

    def poison(t, head, blk):
        t[head, blk] = float("nan")
    k = _randn(gen, (nh, 49, 64, hd), dtype)
    v = _randn(gen, (nh, 49, 64, hd), dtype)
    tables = _tables(gen, 3, 16, [0, 100, 700], 64)
    sl = torch.tensor([0, 100, 700], dtype=torch.int32, device="cuda")
    poison(k if pool == "k" else v, 0, int(tables[2, 3]))
    q = _randn(gen, (3, nh, hd), dtype)
    out = pa.paged_attention(q, k, v, tables, sl)
    _same_nans(out, pa.paged_attention_reference(
        q.float(), k.float(), v.float(), tables, sl), dtype)
    assert not out[0].any()
    for B, starts in ((1, [300]), (2, [0, 90])):
        q, k, v, tables, st = _chunk_case(gen, B, 64, nh, hd, 16, 32,
                                          starts, dtype)
        poison(k if pool == "k" else v, 1, int(tables[B - 1, 5]))
        out = pa.paged_chunk_attention(q, k, v, tables, st)
        _same_nans(out, pa.paged_chunk_attention_reference(
            q.float(), k.float(), v.float(), tables, st), dtype)
    q, k, v = (_randn(gen, (1, 80, nh, hd), dtype) for _ in range(3))
    (k if pool == "k" else v)[0, 10, 0] = float("nan")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_fwd_reference(
        q.float(), k.float(), v.float(), causal=True)
    _same_nans(out, ref, dtype)
    assert torch.equal(torch.isnan(lse), torch.isnan(ref_lse))


def test_decode_program_graph_matches_eager(gen):
    """Host sampling (``device_sampling=False``): the ``decode`` program
    is in the warmup grid and captured; served mixes (greedy and
    host-sampled rows) and one replay's tokens and logits are bit-equal
    to the eager program's, with equal launch counts."""
    import numpy as np
    from paddle_tpu_torch.inference.serving import ServingEngine
    model = _tiny_card()
    st = _graphs_against_eager(model, _graph_mix(True),
                               device_sampling=False)
    assert {"program": "decode", "steps_per_tick": 1} in \
        st["warmup"]["grid"]
    outs = []
    tables = np.zeros((2, 8), np.int32)
    tables[0, :2], tables[1, :1] = (1, 2), (3,)
    for graphs_on in (False, True):
        eng = ServingEngine(model, max_batch=2, max_context=128,
                            block_size=16, device="cuda",
                            cuda_graphs=graphs_on, device_sampling=False)
        eng._forward_prompt("prefill", tables[0], list(range(1, 21)), 0)
        eng._forward_prompt("prefill", tables[1], list(range(7, 15)), 0)
        prog = eng._program(("decode",))
        assert (prog.graph is not None) == graphs_on
        prog.load(tables=tables, lens=np.array([20, 8], np.int32),
                  last=np.array([5, 9], np.int64))
        prog.replay()
        outs.append(prog.fetch("toks", "logits").wait())
    assert np.array_equal(outs[0]["toks"], outs[1]["toks"])
    assert np.array_equal(outs[0]["logits"], outs[1]["logits"])
    assert np.isfinite(outs[1]["logits"]).all()


def test_device_nan_evicts_its_slot_on_the_card(gen):
    """NaN keys written into one running request's private block on the
    card: that slot alone ends ``error`` at its next tick (the watchdog
    on, host sampling), the other slot's stream is the fault-free one."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.observability import flight_recorder
    model = _tiny_card()

    def serve(poison):
        eng = ServingEngine(model, max_batch=2, max_context=128,
                            block_size=16, steps_per_tick=1, device="cuda",
                            device_sampling=False, blocksan=True)
        eng.warmup()
        reqs = [eng.add_request(Request(list(range(3 + i, 40 + i)),
                                        max_new_tokens=10))
                for i in range(2)]
        eng.step()
        if poison:
            blk = int(eng.tables[reqs[1].slot, 37 // 16])
            for kk, _ in eng.pools:
                kk[:, blk] = float("nan")
        eng.run()
        assert eng.stats()["free_blocks"] == eng.num_blocks
        return reqs
    old = flight_recorder.set_enabled(True)
    try:
        want, got = serve(False), serve(True)
    finally:
        flight_recorder.set_enabled(old)
    assert [r.outcome for r in got] == ["finished", "error"]
    assert got[0].output_ids == want[0].output_ids
    assert len(got[1].output_ids) == 2


def _sys_hit(model, root):
    """Serve the shared prompt with a suffix, then the hit, drain and
    export under ``root``; returns the hit's stream and the engine."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    eng = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device="cuda",
                        prefix_export_dir=root)
    shared = list(range(1, 40))
    for suffix in ([77], [88]):
        req = eng.add_request(Request(shared + suffix, max_new_tokens=8))
        eng.run()
    assert eng.stats()["prefix_cache"]["hits"] == 1
    assert eng.drain()["export"]["blocks"] == 2
    return req, eng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_import_into_captured_pools(gen, tmp_path, dtype):
    """An export imported into an engine whose grid is already captured:
    every pool keeps its address (the graphs read them there), the blocks
    are the exporter's bit for bit (bf16 through its 16-bit words), and
    the replayed prefix-hit stream equals the exporter's."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    model = _tiny_card().to(dtype)
    root = str(tmp_path / "export")
    hit, src = _sys_hit(model, root)
    eng = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device="cuda")
    eng.warmup()
    ptrs = [t.data_ptr() for pair in eng.pools for t in pair]
    eng._import_prefix_cache(root)
    assert eng.stats()["prefix_cache"]["import"] == \
        {"step": 1, "blocks": 2, "skipped_corrupt": 0}
    assert [t.data_ptr() for pair in eng.pools for t in pair] == ptrs
    shared = list(range(1, 40))
    a = src.prefix.lookup(shared + [88]).blocks
    b = eng.prefix.lookup(shared + [88]).blocks
    assert len(a) == len(b) == 2
    for (sk, sv), (dk, dv) in zip(src.pools, eng.pools):
        assert torch.equal(sk[:, a], dk[:, b])
        assert torch.equal(sv[:, a], dv[:, b])
    before = pa.paged_chunk_attention.launches
    req = eng.add_request(Request(shared + [88], max_new_tokens=8))
    eng.run()
    assert req.output_ids == hit.output_ids
    assert pa.paged_chunk_attention.launches > before
    assert eng.stats()["graphs"]["replays"] > 0
    assert eng._prefix_fingerprint()["dtype"] == str(dtype)[6:]


def test_tick_timeout_leaves_the_turn_unblocked(gen, monkeypatch):
    """A tick whose copies wait behind a spinning kernel: the watchdog
    fails it, the guard abandons both ticks in flight (their fetch turns
    get fresh buffers), a fetch of the same turn returns at once while
    the card still spins, and after it the engine serves the fault-free
    stream."""
    import time
    from paddle_tpu_torch.inference import graphs
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    model = _tiny_card()
    ref = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device="cuda")
    want = ref.add_request(Request([5, 6, 7], max_new_tokens=12))
    ref.run()
    # cycles of torch.cuda._sleep in one second on this card
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    per_s = 10 ** 8 / (start.elapsed_time(end) / 1e3)
    eng = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device="cuda", tick_timeout_s=0.3)
    eng.warmup()
    fetch, hung = graphs.Program.fetch, []

    def stalled(prog, *names):
        if not hung and "toks" in names:
            torch.cuda._sleep(int(6 * per_s))
            hung.append((prog, fetch(prog, *names)))
            return hung[-1][1]
        return fetch(prog, *names)
    monkeypatch.setattr(graphs.Program, "fetch", stalled)
    req = eng.add_request(Request([5, 6, 7], max_new_tokens=12))
    t0 = time.monotonic()
    eng.run()
    assert time.monotonic() - t0 < 4.0
    assert req.outcome == "error" and eng.tick_errors == 1
    prog, f = hung[0]
    assert not f.event.query()              # the card still spins
    for _ in range(2):                      # both turns, without waiting
        t0 = time.monotonic()
        prog.replay()
        prog.fetch("toks")
        assert time.monotonic() - t0 < 0.1
    torch.cuda.synchronize()
    again = eng.add_request(Request([5, 6, 7], max_new_tokens=12))
    eng.run()
    assert again.outcome == "finished"
    assert again.output_ids == want.output_ids
    assert eng.stats()["free_blocks"] == eng.num_blocks


@pytest.mark.parametrize("entry", ["ptt_flash_fwd", "ptt_paged_decode"])
def test_a_failed_launch_stops_run_unretried(gen, monkeypatch, entry):
    """A kernel whose launch returns a CUDA error (as a refused launch, or
    the sticky fault of an earlier kernel, does) stops `run()` with its
    wrapper's `KernelLaunchError`: the crash-only guard neither retries
    nor absorbs it, with eager programs as with graphs."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.ops import _build
    calls = []

    def failing(*args):
        calls.append(1)
        return 700                  # cudaErrorIllegalAddress
    monkeypatch.setattr(_build.library(), entry, failing)
    eng = ServingEngine(_tiny_card(), max_batch=2, max_context=128,
                        block_size=16, steps_per_tick=4, device="cuda",
                        cuda_graphs=False, dispatch_retries=2)
    req = eng.add_request(Request([5, 6, 7], max_new_tokens=8))
    with pytest.raises(_build.KernelLaunchError, match="illegal memory"):
        eng.run()
    assert len(calls) == 1 and req.outcome is None
    assert eng.dispatch_retries == 0 and eng.tick_errors == 0


def _train_card_vs_cpu(cpu, card, batch, steps=2):
    """``steps`` AdamW steps with clipping on each model from one state;
    returns the losses (CPU, card) and the largest parameter difference."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    card.load_state_dict(cpu.state_dict())
    losses = []
    for model in (cpu, card):
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        run = []
        for _ in range(steps):
            loss = model.compute_loss(*(x.to(model.device)
                                        if torch.is_tensor(x) else x
                                        for x in batch))
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    cpu_p, card_p = cpu.state_dict(), card.state_dict()
    err = max((card_p[k].cpu() - cpu_p[k]).abs().max().item() for k in cpu_p)
    return losses, err


def test_llama_gqa_serves_and_trains_like_the_cpu(gen):
    """Llama with hd 64 and GQA (4 query heads over 2 kv heads): one
    greedy request with whole-prompt and chunked prefill on the card
    (flash_fwd, paged_decode, paged_chunk over the repeated kv heads in
    the pools) equals the CPU's stream; 2 AdamW steps (the flash kernels
    reading kv head h // 2) within 1e-4 of the CPU's losses and 2 x lr x
    steps of its parameters."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    cfg = llama_tiny(hidden_size=256, num_heads=4, num_kv_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    n = [fn.launches for fn in (fa.flash_attention_fwd, pa.paged_attention,
                                pa.paged_chunk_attention)]
    prompt = list(range(5, 90))
    streams = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        for chunk in (0, 32):
            eng = ServingEngine(model, max_batch=2, max_context=128,
                                block_size=16, steps_per_tick=4,
                                prefill_chunk=chunk, device=dev)
            reqs = [eng.add_request(Request(p, max_new_tokens=10))
                    for p in (prompt, prompt[:33])]
            eng.run()
            streams.append([r.output_ids for r in reqs])
    assert all(s == streams[0] for s in streams)
    assert all(fn.launches > c for fn, c in zip(
        (fa.flash_attention_fwd, pa.paged_attention,
         pa.paged_chunk_attention), n))
    ids = torch.randint(0, cfg.vocab_size, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    before = fa.flash_attention_bwd_dkv.launches
    losses, err = _train_card_vs_cpu(cpu, card, (ids, ids))
    assert fa.flash_attention_bwd_dkv.launches == before + 2 * cfg.num_layers
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), atol=1e-4, rtol=0.0)
    assert err <= 2 * 1e-4 * 2


def test_bert_with_a_padding_mask_trains_like_the_cpu(gen):
    """A small BERT at hd 64 (non-causal flash with the kv mask), padded
    rows, labels ignored off 15% of the tokens: the MLM logits equal the
    CPU's (atol 1e-4), and 2 AdamW steps within 1e-4 of its losses and 2 x
    lr x steps of its parameters; the pooler takes no step."""
    from paddle_tpu_torch.models.bert import BertForMaskedLM, bert_tiny
    cfg = bert_tiny(hidden_size=128, num_heads=2, dropout=0.0)
    cpu = BertForMaskedLM(cfg, device="cpu", seed=3)
    card = BertForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (3, 100), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 70:] = 0
    mask[2, 9:] = 0
    labels = torch.where(torch.rand(ids.shape, generator=g) < 0.15, ids,
                         torch.full_like(ids, -100))
    with torch.no_grad():
        want = cpu.eval()(ids, None, mask)
        got = card.eval()(ids.cuda(), None, mask.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0.0)
    pooler = cpu.bert.pooler.weight.detach().clone()
    before = fa.flash_attention_fwd.launches
    losses, err = _train_card_vs_cpu(cpu, card, (ids, labels, -100, None,
                                                 mask))
    assert fa.flash_attention_fwd.launches == before + 2 * cfg.num_layers
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), atol=1e-4, rtol=0.0)
    assert err <= 2 * 1e-4 * 2
    assert torch.equal(card.bert.pooler.weight.cpu(), pooler)


# ----------------------------------------------------- weight-only matmul

# (M, N, K): single rows to the kernel's largest row count, N and K off
# the 16- and 32-channel slabs and the 64-code chunk (N 8500 takes the
# 32-channel slab), and Llama-2 7B's gate_proj at the decode batch and at
# the 128-row prompt bucket (8 row tiles on 32-channel slabs)
WO_CASES = [(1, 40, 48), (8, 4100, 4112), (40, 1000, 2064), (72, 96, 512),
            (127, 33, 80), (128, 257, 1040), (3, 8500, 2064),
            (8, 11008, 4096), (128, 11008, 4096)]


def _wo_case(gen, M, N, K, dtype, mode, bias=True):
    from paddle_tpu_torch.quantization import weight_only as two
    quantize = two.quantize_absmax_int8 if mode == "int8" \
        else two.quantize_absmax_fp8
    w = _randn(gen, (N, K), torch.float32) * 0.02
    w[3] = 0.0                                  # an all-zero channel
    q, s = quantize(w.to(dtype), axis=1)
    x = _randn(gen, (M, K), dtype)
    b = _randn(gen, (N,), dtype) if bias else None
    return x, q, s.reshape(-1), b


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizers_on_the_card_equal_the_cpu(gen, dtype, mode):
    """Codes and scales quantized on the card are the CPU's, bit for bit
    (so a quantized engine on the card serves the CPU's weights)."""
    from paddle_tpu_torch.quantization import weight_only as two
    quantize = two.quantize_absmax_int8 if mode == "int8" \
        else two.quantize_absmax_fp8
    w = (_randn(gen, (512, 1024), torch.float32)
         * torch.rand((1, 1024), generator=gen, device="cuda") * 3).to(dtype)
    w[:, 7] = 0.0
    def raw(t):                       # fp8 has no equality: its bytes
        return t.cpu().view(torch.uint8) if t.element_size() == 1 \
            else t.cpu()
    for axis in (0, 1):
        got = quantize(w, axis=axis)
        want = quantize(w.cpu(), axis=axis)
        assert all(torch.equal(raw(g), raw(t)) for g, t in zip(got, want))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WO_CASES)
def test_weight_only_matmul(gen, case, dtype, mode):
    """The kernel against its plain version computed in float32 on the
    same codes and inputs (the dequantized weight rounded to x's type, as
    the kernel rounds it): fp32 at TOL; bf16 atol 2e-2, rtol 1e-2 (one
    bf16 rounding of the output, sums in another order)."""
    from paddle_tpu_torch.ops import weight_only as wo
    M, N, K = case
    x, q, s, b = _wo_case(gen, M, N, K, dtype, mode, bias=M % 2 == 0)
    n = wo.weight_only_matmul.launches
    got = wo.weight_only_matmul(x, q, s, b)
    want = wo.weight_only_matmul_reference(
        x.float(), q, s, None if b is None else b.float())
    torch.cuda.synchronize()
    assert wo.weight_only_matmul.launches == n + 1
    assert got.dtype == dtype and got.shape == (M, N)
    tol = TOL[torch.float32] if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


def _wo_counts():
    from paddle_tpu_torch.ops import weight_only as wo
    return (wo.weight_only_matmul.launches, wo.weight_only_gemm.launches,
            wo.weight_only_matmul.dequant_calls)


def test_weight_only_matmul_routes(gen):
    """The callers' three ways on the card: 129 bf16 rows launch
    ``weight_only_gemm`` (``weight_only_matmul`` raises for them); fp32 at
    129 rows, K 72 at M 8 and float16 take the counted dequantize route
    against the plain version (the wrappers raise for each); K 72 raises
    in both wrappers."""
    from paddle_tpu_torch.inference.quant import WeightOnlyLinear
    from paddle_tpu_torch.ops import weight_only as wo
    x, q, s, b = _wo_case(gen, 129, 64, 128, torch.bfloat16, "int8")
    n = _wo_counts()
    got = WeightOnlyLinear(q, s, b)(x.view(3, 43, 128))
    assert got.shape == (3, 43, 64)
    assert _wo_counts() == (n[0], n[1] + 1, n[2])
    torch.testing.assert_close(
        got.reshape(129, 64).float(), wo.weight_only_matmul_reference(
            x.float(), q, s, b.float()), atol=2e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="at most 128"):
        wo.weight_only_matmul(x, q, s, b)
    with pytest.raises(ValueError, match="more than 128"):
        wo.weight_only_gemm(x[:128].contiguous(), q, s, b)
    routed = [_wo_case(gen, 129, 64, 128, torch.float32, "int8"),
              _wo_case(gen, 8, 64, 72, torch.bfloat16, "fp8"),
              _wo_case(gen, 8, 64, 72, torch.float32, "int8"),
              _wo_case(gen, 130, 64, 72, torch.bfloat16, "int8"),
              _wo_case(gen, 8, 64, 128, torch.float16, "int8")]
    for x, q, s, b in routed:
        n = _wo_counts()
        got = WeightOnlyLinear(q, s, b)(x)
        assert _wo_counts() == (n[0], n[1], n[2] + 1)
        torch.testing.assert_close(
            got, wo.weight_only_matmul_reference(x, q, s, b), atol=0.0,
            rtol=0.0)
    x, q, s, b = routed[0]
    with pytest.raises(TypeError, match="bfloat16"):
        wo.weight_only_gemm(x, q, s, b)
    for x, q, s, b in routed[1:4]:
        wrapper = wo.weight_only_gemm if len(x) > 128 \
            else wo.weight_only_matmul
        with pytest.raises(ValueError, match="multiple of 16"):
            wrapper(x, q, s, b)
    x, q, s, b = routed[4]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wo.weight_only_matmul(x, q, s, b)


# (M, N, K): past the narrow kernel's 128 rows; Llama-2 7B's gate/up and
# down at a 129-row, a 256-row (chunk) and a 2048-row prompt (688 tiles:
# each persistent block walks several); N and K off the tiles and the
# 64-code step (N 4100, K 4112, with a bias); odd N and N below one
# 128-channel tile; and each kind of schedule (ops/weight_only.py
# gemm_schedule at 132 SMs): tiles of 256, 128 and 64 rows of x, K whole
# or split in 2, 3 or 4, the last split as long as the others or shorter
WG_CASES = [(129, 11008, 4096), (256, 4096, 11008), (2048, 11008, 4096),
            (2048, 4096, 11008), (129, 4100, 4112), (256, 4100, 4112),
            (2048, 4100, 4112), (300, 33, 80), (130, 257, 1040),
            (1000, 96, 512), (129, 4096, 11008), (256, 2048, 8192),
            (129, 2048, 4112), (300, 1000, 4096), (129, 96, 4112),
            (300, 1000, 2048), (129, 6144, 4112)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("case", WG_CASES)
def test_weight_only_gemm(gen, case, mode):
    """The wide-M kernel against its plain version computed in float32 on
    the same codes and bf16 inputs (the dequantized weight rounded to bf16,
    as the kernel rounds it): atol 2e-2, rtol 1e-2 (one bf16 rounding of
    the output, sums in another order)."""
    from paddle_tpu_torch.ops import weight_only as wo
    M, N, K = case
    x, q, s, b = _wo_case(gen, M, N, K, torch.bfloat16, mode,
                          bias=N == 4100 or M % 2 == 1)
    n = wo.weight_only_gemm.launches
    got = wo.weight_only_gemm(x, q, s, b)
    want = wo.weight_only_matmul_reference(
        x.float(), q, s, None if b is None else b.float())
    torch.cuda.synchronize()
    assert wo.weight_only_gemm.launches == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=1e-2)


def _all_codes(mode, channels):
    """Codes [channels, 256]: every int8 code, or every finite e4m3 code
    (the two NaNs as 0), in each channel, rolled by the channel's index;
    scales of many magnitudes (bf16), one a channel."""
    k = torch.arange(256)
    rows = torch.stack([(k + c) % 256 for c in range(channels)])
    if mode == "int8":
        q = (rows - 128).to(torch.int8)
    else:
        rows[(rows == 0x7F) | (rows == 0xFF)] = 0
        q = rows.to(torch.uint8).view(torch.float8_e4m3fn)
    mags = torch.tensor([2.0 ** -20, 1e-4, 3.3e-3, 7.8e-3, 0.031, 0.5, 1.0,
                         1.7, 7.3, 100.0, 6.1e-5, 0.25, 2.0 ** -7])
    s = mags[torch.arange(channels) % len(mags)].to(torch.bfloat16)
    return q.cuda(), s.cuda()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
# (rows of x, channels): tiles of 64, 128 and 256 rows of x at 132 SMs
@pytest.mark.parametrize("shape", [(256, 13), (512, 4100), (2048, 4100)])
def test_weight_only_gemm_weights_are_dequantize_bit_for_bit(gen, mode,
                                                             shape):
    """Every code at several scales: with x the 256 x 256 identity
    (stacked), row m of y is column m % 256 of the bf16 weight the kernel
    multiplied, and it equals ``dequantize(q, s)`` in bf16 exactly (a zero
    of either sign compares equal: a sum of zeros keeps no sign)."""
    from paddle_tpu_torch.ops import weight_only as wo
    M, channels = shape
    q, s = _all_codes(mode, channels)
    x = torch.eye(256, dtype=torch.bfloat16, device="cuda").repeat(
        M // 256, 1)
    got = wo.weight_only_gemm(x, q, s)
    want = wo.dequantize(q, s[:, None]).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want.t().repeat(M // 256, 1))


@pytest.mark.parametrize("case", [(2048, 4100, 4112), (129, 4096, 11008),
                                  (300, 1000, 4096)])
def test_weight_only_gemm_launches_and_replays_are_bit_equal(gen, case):
    """Two launches, and a CUDA graph's replay against an eager launch,
    give the same bits: one unsplit and two split schedules (the fp32
    partials summed in split order, no atomics)."""
    from paddle_tpu_torch.ops import weight_only as wo
    M, N, K = case
    x, q, s, b = _wo_case(gen, M, N, K, torch.bfloat16, "int8")
    first = wo.weight_only_gemm(x, q, s, b)
    second = wo.weight_only_gemm(x, q, s, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wo.weight_only_gemm(x, q, s, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = wo.weight_only_gemm(x, q, s, b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)


def test_weight_only_k72_serves_like_the_cpu(gen):
    """A quantized fp32 GPT cut whose hidden width (72) no weight-only
    kernel takes serves on the card through the counted dequantize route,
    its streams those of the CPU quant engine."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.ops import weight_only as wo
    cfg = gpt3_tiny(hidden_size=72, num_heads=1, num_layers=1)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3).eval()
    card = GPTForCausalLM(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    n = _wo_counts()
    want = _serve_prefix_spec(cpu, None, "cpu", quant="int8")
    got = _serve_prefix_spec(card, None, "cuda", quant="int8")
    assert got == want
    assert _wo_counts()[2] > n[2]


def test_activation_fake_quant_on_the_card_equals_the_cpu(gen):
    """An activation quanter in training (the first call's absmax, then
    the EMA) on the card and on the CPU over the same activations: scales
    and codes equal bit for bit, the round trip within one float32
    rounding (its last division is by a Python number, a product with the
    reciprocal on the card), the straight-through gradients equal."""
    from paddle_tpu_torch.quantization import FakeQuanterWithAbsMaxObserver
    card = FakeQuanterWithAbsMaxObserver().cuda().train()
    cpu = FakeQuanterWithAbsMaxObserver().train()
    for i in range(3):
        x = _randn(gen, (2, 256, 512), torch.float32) * (1.0 + i)
        x[0, 0, 0] = 100.0 if i == 2 else x[0, 0, 0]  # outside the EMA
        xc, xh = x.clone().requires_grad_(), x.cpu().requires_grad_()
        yc, yh = card(xc), cpu(xh)
        assert torch.equal(card.scale.cpu(), cpu.scale)
        codes = [torch.round(y.detach().cpu() / s * 127.0)
                 for y, s in ((yc, card.scale.cpu()), (yh, cpu.scale))]
        assert torch.equal(codes[0], codes[1])
        torch.testing.assert_close(yc.detach().cpu(), yh.detach(),
                                   atol=0.0, rtol=2.4e-7)
        yc.sum().backward()
        yh.sum().backward()
        assert torch.equal(xc.grad.cpu(), xh.grad)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_graph_quant_serving_matches_eager(gen, mode):
    """A quantized engine's graphs against its eager programs, bit for
    bit, with the tick's products on the weight-only kernel."""
    st = _graphs_against_eager(_tiny_card(), _graph_mix(True), quant=mode,
                               prefill_chunk=32)
    assert st["quant"]["mode"] == mode


def _wide_mix():
    """Prompts of 140 and 200 tokens (the 256-row bucket), one sampled."""
    g = torch.Generator().manual_seed(12)
    return [dict(prompt_ids=torch.randint(1, 1024, (n,), generator=g)
                 .tolist(), max_new_tokens=24, do_sample=i == 1,
                 temperature=0.9, top_k=40, top_p=0.95, seed=200 + i)
            for i, n in enumerate((140, 200, 150))]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_graph_quant_wide_prompts_match_eager(gen, mode):
    """A quantized bf16 ``gpt3_tiny`` whose prompts exceed 128 rows: the
    prompt products launch ``weight_only_gemm``, none takes the dequantize
    route, and graphs equal eager programs bit for bit."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    model = GPTForCausalLM(gpt3_tiny(num_heads=2), device="cuda",
                           dtype=torch.bfloat16, seed=3).eval()
    want, want_n, _ = _serve_card(model, _wide_mix(), max_context=256,
                                  cuda_graphs=False, overlap=False,
                                  quant=mode)
    got, got_n, st = _serve_card(model, _wide_mix(), max_context=256,
                                 overlap=False, quant=mode)
    assert got == want and got_n == want_n
    assert st["graphs"]["replays"] > 0 and st["quant"]["mode"] == mode
    assert got_n["weight_only_gemm", "launches"] > 0
    assert got_n["weight_only_matmul", "launches"] > 0
    assert got_n["weight_only_matmul", "dequant_calls"] == 0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_serving_matches_the_cpu(gen, mode):
    """gpt3_tiny at hd 64 in fp32, quantized: whole-prompt, chunked and
    n-gram speculative streams on the card equal the CPU's, and the card
    launched the weight-only kernel."""
    from paddle_tpu_torch.ops import weight_only as wo
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    cfg = gpt3_tiny(num_heads=2)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3).eval()
    card = GPTForCausalLM(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    runs = (dict(), dict(prefill_chunk=16),
            dict(spec_decode=True, spec_draft="ngram", spec_k=3))
    n = wo.weight_only_matmul.launches
    for kw in runs:
        want = _serve_prefix_spec(cpu, None, "cpu", quant=mode, **kw)
        got = _serve_prefix_spec(card, None, "cuda", quant=mode, **kw)
        assert got == want, kw
    assert wo.weight_only_matmul.launches > n


def _sse_stream(url, body):
    """POST /generate; the token ids and the terminal frame."""
    import json
    import urllib.request
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, event = [], None
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                d = json.loads(line[6:])
                if event is not None:
                    return toks, event, d
                toks.append(d["token"])
    raise AssertionError("the stream ended without a terminal frame")


def test_http_frontend_over_a_captured_engine(gen):
    """``serve_forever`` on a thread behind the HTTP endpoint, its grid
    captured: each of three concurrent SSE streams equals ``run()``'s
    stream of the same request (one sampled), every token came from a
    graph replay, and nothing leaks after a drain."""
    import threading
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.observability import http as obs_http
    model = _tiny_card().to(torch.bfloat16)
    mix = [dict(prompt_ids=list(range(1, 30)), max_new_tokens=12),
           dict(prompt_ids=list(range(7, 60)), max_new_tokens=9,
                do_sample=True, temperature=0.9, top_k=40, top_p=0.95,
                seed=5),
           dict(prompt_ids=[5, 9, 14, 2] * 5, max_new_tokens=16)]
    want, _, _ = _serve_card(model, mix)
    eng = ServingEngine(model, max_batch=2, max_context=128, block_size=16,
                        steps_per_tick=4, device="cuda")
    srv = obs_http.MetricsServer(0, "127.0.0.1", engine=eng)
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_forever, args=(stop,),
                            daemon=True)
    out = [None] * len(mix)

    def client(i):
        out[i] = _sse_stream(srv.url, dict(mix[i], timeout_s=120))
    try:
        loop.start()
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(mix))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(120)
            assert not t.is_alive()
        eng.request_drain()
        loop.join(60)
        assert not loop.is_alive()
    finally:
        stop.set()
        srv.close()
    assert [o[0] for o in out] == want
    assert [o[1] for o in out] == ["done"] * len(mix)
    st = eng.stats()
    assert st["graphs"]["replays"] > 0 and st["tick_errors"] == 0
    assert st["free_blocks"] == eng.num_blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cow_program_replay_equals_the_eager_copy(gen, dtype):
    """The captured ``cow`` program, replayed at a partial-block prefix
    hit, leaves every pool (the draft's too) equal, bit for bit, to the
    eager copy of the same block (bf16 compared as 16-bit words); the
    hit's stream equals an eager engine's."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    model = _tiny_card().to(dtype)
    draft = _tiny_card(num_layers=1).to(dtype)
    shared = list(range(1, 33))              # two full blocks of 16

    def serve(cuda_graphs):
        eng = ServingEngine(model, max_batch=2, max_context=128,
                            block_size=16, steps_per_tick=4, device="cuda",
                            cuda_graphs=cuda_graphs, draft_model=draft,
                            spec_decode=True, spec_k=2)
        if cuda_graphs:
            eng.warmup()
        first = eng.add_request(Request(shared + [77, 78],
                                        max_new_tokens=6))
        eng.run()
        hit = eng.add_request(Request(shared, max_new_tokens=6))
        eng.run()
        return eng, first, hit
    eng, _, hit = serve(True)
    ref, _, ref_hit = serve(False)
    prog = eng._programs[("cow",)]
    assert prog.graph is not None and prog.replays == 1
    assert hit.output_ids == ref_hit.output_ids
    assert eng.stats()["prefix_cache"]["hits"] == 1
    # the copy itself: a replay against the eager indexed copy
    src = int(eng.prefix.lookup(shared).blocks[-1])
    dst = int(eng.free_blocks[0])
    pools = eng.pools + eng.dpools
    want = [(k.clone(), v.clone()) for k, v in pools]
    for k, v in want:
        k[:, dst] = k[:, src]
        v[:, dst] = v[:, src]
    eng._cow(src, dst)
    torch.cuda.synchronize()

    def words(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for (k, v), (wk, wv) in zip(pools, want):
        assert torch.equal(words(k), words(wk))
        assert torch.equal(words(v), words(wv))
    assert prog.replays == 2


# ------------------------------------------------------------ fused_adamw

# shapes: a vector, a ragged length (scalar tail), one past a chunk of
# 64 Ki elements, a matrix
FUSED_SHAPES = [(7,), (1029,), (65536 + 3,), (96, 130)]


def _fused_case(gen, o2, sizes=None, wd=0.01, low=None):
    """Parameters (float32, or ``low`` (bfloat16 by default) with float32
    masters), Adam's two
    states, and a misaligned parameter (a view one element into a
    buffer: the scalar loop).  ``sizes``: per parameter the size of its
    clipped gradient (``_clipped_rms``); the states are then drawn to it,
    m about an eighth of it and v >= m^2 with v about m^2 + sizes^2 / 64,
    so that both states change by much more than a float32 ulp in a step
    (else m about 0.005, v about 5e-5)."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    params, masters, states = [], [], []
    for i, shape in enumerate(FUSED_SHAPES + [(33,)]):
        w = torch.randn(shape, generator=gen, device="cuda") * 0.1
        if i == len(FUSED_SHAPES):
            buf = torch.empty(w.numel() + 1, device="cuda")
            w = buf[1:].view(shape).copy_(w)
        masters.append(w.clone() if o2 else None)
        params.append(w.to(low or torch.bfloat16) if o2 else w)
        if sizes is None:
            states.append([
                torch.rand(shape, generator=gen, device="cuda") * 0.01,
                torch.rand(shape, generator=gen, device="cuda") * 1e-4])
        else:
            q = sizes[i] / 8
            m = torch.randn(shape, generator=gen, device="cuda") * q
            states.append([m, m * m + (0.5 + torch.rand(
                shape, generator=gen, device="cuda")) * q * q])
    n = len(params)
    table = fo.FusedTable(params, masters, states,
                          [wd * (i % 2) for i in range(n)],
                          [1.0, 0.5] * (n // 2) + [1.0] * (n % 2),
                          [i != 1 for i in range(n)])
    return table


def _clipped_rms(grads, clip, need_clip, scale=1.0):
    """Each gradient's root mean square after the unscale and the clip
    (the JAX package's rules, in float32)."""
    us = [g.float() / scale for g in grads]
    kind = clip and clip[0]
    if kind == "global":
        norm = torch.sqrt(sum((u * u).sum() for u, c in zip(us, need_clip)
                              if c))
        coef = clip[1] / torch.clamp(norm, min=clip[1])
        us = [u * coef if c else u for u, c in zip(us, need_clip)]
    elif kind == "norm":
        us = [u * torch.clamp(clip[1] / u.norm(), max=1.0) if c else u
              for u, c in zip(us, need_clip)]
    elif kind == "value":
        us = [torch.clamp(u, clip[1], clip[2]) if c else u
              for u, c in zip(us, need_clip)]
    return [float(u.pow(2).mean().sqrt()) for u in us]


def _step_change_err(got, got0, want, want0):
    """How far the kernels' change of a tensor in one step lies from the
    plain version's, relative to the plain version's (2-norms)."""
    dk = got.float() - got0.float()
    dr = want.float() - want0.float()
    return float((dk - dr).norm() / dr.norm())


def _clone_table(table):
    from paddle_tpu_torch.ops import fused_optimizer as fo
    return fo.FusedTable([p.clone() for p in table.params],
                         [None if m is None else m.clone()
                          for m in table.masters],
                         [[None if s is None else s.clone() for s in st]
                          for st in table.states],
                         table.wds, table.lr_ratios, table.need_clip)


def _table_tensors(table):
    """Masters and states (float32) first, then the parameters."""
    out = [m for m in table.masters if m is not None]
    out += [s for st in table.states for s in st if s is not None]
    return out + list(table.params)


@pytest.mark.parametrize("o2", [False, True])
@pytest.mark.parametrize("clip", [None, ("global", 1.0), ("norm", 0.5),
                                  ("value", -0.01, 0.02)])
@pytest.mark.parametrize("scaled", [None, "finite", "inf"])
def test_fused_adamw_matches_its_plain_version(gen, o2, clip, scaled):
    """Three steps of the kernel pair against ``fused_adamw_reference``
    on copies of the same tensors, at lr 1e-2 with decay 0.1 on every
    other tensor and the states drawn to the clipped gradients' size.
    Exactly: the step count, the scaler's scale and counts, and an
    overflow step, which leaves every tensor bit-identical.  The clip
    coefficients within rtol 1e-6 (the norms are summed in other
    orders); phase 2 of the plain version then takes the kernels'
    coefficients, so that a coefficient one ulp apart cannot round a
    clipped bf16 gradient (O2) to its neighbour.  Each float32 tensor's
    change in a step (weight or master, m, v) within 1e-4 of the plain
    version's, in 2-norm: the decay's share of a weight's change is
    checked to be above 100 times that, and both states change by much
    more than an ulp.  bfloat16 copies within one bf16 step (2^-7 of the
    value: masters 1e-6 apart may round to neighbours)."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    lr, rtol = 1e-2, 1e-4
    shapes = FUSED_SHAPES + [(33,)]
    pdt = torch.bfloat16 if o2 else torch.float32
    gscale = 1024.0 if scaled else 1.0
    all_grads = [[torch.randn(s, generator=gen, device="cuda").to(pdt)
                  * gscale for s in shapes] for _ in range(3)]
    need_clip = [i != 1 for i in range(len(shapes))]
    table = _fused_case(gen, o2, _clipped_rms(all_grads[0], clip, need_clip,
                                              gscale), wd=0.1)
    ref = _clone_table(table)
    steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    scalers = None
    if scaled:
        scalers = [(torch.full((1,), gscale, device="cuda"),
                    torch.tensor([0, 1, 0, 0], dtype=torch.int32,
                                 device="cuda"),
                    fo.ScalerConfig(2.0, 0.5, 2, 1, True))
                   for _ in range(2)]
    for it, grads in enumerate(all_grads):
        if scaled == "inf" and it == 1:
            grads[2].view(-1)[65537] = float("inf")
        before = [t.clone() for t in _table_tensors(table)]
        ref_before = [t.clone() for t in _table_tensors(ref)]
        # copies taken first: with a scaler the kernels write the
        # unscaled gradients back over ``grads``
        ref_grads = [g.clone() for g in grads]
        n = fo.fused_adamw.launches
        fo.fused_adamw(table, grads, lr, steps[0], clip=clip,
                       scaler=scalers and scalers[0])
        assert fo.fused_adamw.launches == n + 1
        fo.fused_adamw_reference(ref, ref_grads, lr, steps[1], clip=clip,
                                 scaler=scalers and scalers[1],
                                 coef=table.coef)
        torch.cuda.synchronize()
        assert torch.equal(steps[0], steps[1])
        if scaled:
            assert torch.equal(scalers[0][0], scalers[1][0])
            assert torch.equal(scalers[0][1], scalers[1][1])
        torch.testing.assert_close(table.coef, ref.coef, atol=0.0,
                                   rtol=1e-6)
        if scaled == "inf" and it == 1:
            assert int(scalers[0][1][0]) == 1            # found_inf
            for b, t in zip(before, _table_tensors(table)):
                assert torch.equal(b.view(torch.uint8) if b.dtype ==
                                   torch.bfloat16 else b, t.view(torch.uint8)
                                   if t.dtype == torch.bfloat16 else t)
            continue
        for got, got0, want, want0 in zip(_table_tensors(table), before,
                                          _table_tensors(ref), ref_before):
            if got.dtype == torch.bfloat16:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=1e-6, rtol=2 ** -7)
            else:
                assert _step_change_err(got, got0, want, want0) <= rtol
        # the float32 weights: the masters (first) at O2, else the
        # parameters (last)
        n = len(ref.params)
        first = 0 if o2 else len(ref_before) - n
        for i in range(n):
            if ref.wds[i]:
                w0 = ref_before[first + i]
                w = _table_tensors(ref)[first + i]
                decay = lr * ref.lr_ratios[i] * ref.wds[i] * w0
                assert float(decay.norm() / (w - w0).norm()) > 100 * rtol
    assert int(steps[0]) == (2 if scaled == "inf" else 3)


@pytest.mark.parametrize("rule", ["sgd", "momentum"])
def test_fused_sgd_and_momentum_match_their_plain_version(gen, rule):
    from paddle_tpu_torch.ops import fused_optimizer as fo
    table = _fused_case(gen, False)
    if rule == "sgd":
        for st in table.states:
            st[:] = [None, None]
        table = fo.FusedTable(table.params, table.masters, table.states,
                              table.wds, table.lr_ratios, table.need_clip)
    else:
        for st in table.states:
            st[1] = None
        table = fo.FusedTable(table.params, table.masters, table.states,
                              table.wds, table.lr_ratios, table.need_clip)
    ref = _clone_table(table)
    steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=gen, device="cuda")
                 for p in table.params]
        for t, s in ((table, steps[0]), (ref, steps[1])):
            (fo.fused_adamw if t is table else fo.fused_adamw_reference)(
                t, grads, 0.1, s, rule=rule, momentum=0.9, nesterov=True,
                clip=("global", 1.0))
    for got, want in zip(_table_tensors(table), _table_tensors(ref)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0.0)


def test_fused_step_refuses_what_it_does_not_take(gen):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_optimizer as fo
    p = torch.zeros(8, device="cuda")
    with pytest.raises(_build.KernelTypeError):
        fo.FusedTable([p.bfloat16()], [None], [[None, None]], [0.0], [1.0],
                      [True])
    table = fo.FusedTable([p], [None], [[None, None]], [0.0], [1.0], [True])
    step = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(_build.KernelTypeError):
        fo.fused_adamw(table, [p.bfloat16()], 0.1, step, rule="sgd")
    with pytest.raises(_build.KernelValueError):
        fo.fused_adamw(table, [torch.zeros(9, device="cuda")], 0.1, step,
                       rule="sgd")


def test_scaler_step_makes_no_host_sync_and_skips_an_overflow(gen):
    """A GradScaler step through the kernels under the sync debug mode
    "error": found_inf, the scale and the step count stay on the card;
    an injected inf leaves the parameters, moments and masters
    bit-identical, halves the scale and keeps global_step."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(gpt3_tiny(hidden_size=256), device="cuda")
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ids = torch.randint(0, 1024, (2, 64), generator=gen, device="cuda")
    for it in range(3):
        with amp.auto_cast(True, level="O2"):
            loss = model.compute_loss(ids, ids)
        scaler.scale(loss).backward()
        if it == 2:
            next(model.parameters()).grad.view(-1)[0] = float("inf")
        state = {k: v.clone() for k, v in opt.state_dict().items()
                 if torch.is_tensor(v)} if it == 2 else None
        params = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scaler.step(opt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        opt.clear_grad()
    assert scaler._scale == 2.0 ** 9 and scaler._bad_steps == 0
    assert opt.state_dict()["global_step"] == 2
    for p, q in zip(model.parameters(), params):
        assert torch.equal(p.view(torch.int16) if p.dtype == torch.bfloat16
                           else p, q.view(torch.int16)
                           if q.dtype == torch.bfloat16 else q)
    after = opt.state_dict()
    for k, v in state.items():
        assert torch.equal(after[k], v), k


# ---------------------------------------------------------------- float16
# fp16 on the tensor-core kernels, against the plain version in float32 on
# the same fp16 inputs.  One fp16 rounding of P, dS and the output is
# 2^-11 relative (bf16's 2^-8, eight times finer), so the bf16 limits of
# TOL and GRAD_TOL shrink about five-fold: atol 4e-3, rtol 2e-3.
FP16_TOL = dict(atol=4e-3, rtol=2e-3)


def _fp16_inputs(gen, case, hd):
    B, Sq, Sk, nh, nkv, causal, masked, rate = case
    q, k, v, mask = _flash_inputs(gen, B, Sq, Sk, nh, nkv, hd,
                                  torch.float16)
    return q, k, v, (causal, mask if masked else None, rate, 99)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_fwd_fp16_tensor_cores(gen, case, hd):
    q, k, v, args = _fp16_inputs(gen, case, hd)
    n = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    assert fa.flash_attention_fwd.launches == n + 1
    assert out.dtype == torch.float16
    ref, ref_lse = fa.flash_attention_fwd_reference(q.float(), k.float(),
                                                    v.float(), *args)
    torch.testing.assert_close(out.float(), ref, **FP16_TOL)
    torch.testing.assert_close(lse, ref_lse, **FP16_TOL)
    empty = _no_key_rows(case)
    assert not out[empty].any()
    assert torch.all(lse.transpose(1, 2)[empty] == -1e30)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_bwd_fp16_tensor_cores(gen, case, hd):
    """dq, dk and dv of the fp16 kernels against the fp32 plain version;
    rows that see no key get dq 0, keys no query sees dk = dv = 0."""
    q, k, v, args = _fp16_inputs(gen, case, hd)
    do = _randn(gen, q.shape, torch.float16)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    n = (fa.flash_attention_bwd_dq.launches,
         fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, *args)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    want = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        *args)
    for name, got, w, x in (("dq", dq, want[0], q), ("dk", dk, want[1], k),
                            ("dv", dv, want[2], v)):
        assert got.dtype == torch.float16 and got.shape == x.shape, name
        torch.testing.assert_close(got.float(), w, **FP16_TOL,
                                   msg=lambda m: f"{name}: {m}")
    assert not dq[_no_key_rows(case)].any()
    if args[1] is not None:
        unseen = args[1] == 0
        assert not dk[unseen].any() and not dv[unseen].any()


def test_flash_attention_function_fp16(gen):
    """The autograd Function in fp16 (the O1 path of phase 22) against
    autograd through the fp32 plain forward on the same fp16 inputs."""
    B, S, nh, hd = 2, 192, 4, 128
    q, k, v, mask = _flash_inputs(gen, B, S, S, nh, nh, hd, torch.float16)
    do = _randn(gen, (B, S, nh, hd), torch.float16)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*x, True, mask, 0.1, 5)
    out.backward(do)
    y = [t.float().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_fwd_reference(*y, True, mask, 0.1, 5)[0]
    ref.backward(do.float())
    torch.testing.assert_close(out.float(), ref, **FP16_TOL)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad.float(), b.grad, **FP16_TOL)


def test_kernels_without_fp16_refuse_it_before_launch(gen):
    """Both weight-only kernels raise KernelTypeError for float16 on the
    card, and nothing is launched or counted (their callers route fp16 to
    ``dequant_route`` first); paged_decode, paged_chunk and the MoE pair
    launch their fp16 instances, each once, and agree with their plain
    versions in fp32 on the same fp16 inputs."""
    from paddle_tpu_torch.ops import _build, moe, weight_only
    h = torch.float16
    q = _randn(gen, (2, 4, 64), h)
    pool = _randn(gen, (4, 5, 16, 64), h)
    tables = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    lens = torch.full((2,), 3, dtype=torch.int32, device="cuda")
    x = _randn(gen, (6, 64), h)
    inv = torch.zeros(4, dtype=torch.int32, device="cuda")
    w = torch.ones((6, 2), device="cuda")
    flat = torch.zeros((6, 2), dtype=torch.int32, device="cuda")
    codes = torch.zeros((64, 64), dtype=torch.int8, device="cuda")
    scale = torch.ones(64, dtype=h, device="cuda")
    calls = [
        (pa.paged_attention, lambda: pa.paged_attention(q, pool, pool,
                                                        tables, lens)),
        (pa.paged_chunk_attention, lambda: pa.paged_chunk_attention(
            q[:, None], pool, pool, tables, lens)),
        (moe.moe_dispatch, lambda: moe.moe_dispatch(x, inv)),
        (moe.moe_combine, lambda: moe.moe_combine(x, w, flat)),
        (weight_only.weight_only_matmul, lambda: weight_only
         .weight_only_matmul(x, codes, scale)),
        (weight_only.weight_only_gemm, lambda: weight_only
         .weight_only_gemm(_randn(gen, (256, 64), h), codes, scale)),
    ]
    refs = [
        lambda: pa.paged_attention_reference(q.float(), pool.float(),
                                             pool.float(), tables, lens),
        lambda: pa.paged_chunk_attention_reference(
            q[:, None].float(), pool.float(), pool.float(), tables, lens),
        lambda: moe.moe_dispatch_reference(x, inv),
        lambda: moe.moe_combine_reference(x, w, flat)]
    for i, (fn, call) in enumerate(calls):
        n = fn.launches
        if i < len(refs):
            got = call()
            assert fn.launches == n + 1, fn.__name__
            assert got.dtype == h
            torch.testing.assert_close(got.float(), refs[i]().float(),
                                       **TOL[h])
            continue
        with pytest.raises(_build.KernelTypeError):
            call()
        assert fn.launches == n, fn.__name__


def test_fused_adamw_writes_back_unscaled_gradients(gen):
    """With a scaler the update launch writes g * (1 / scale), rounded to
    the gradient's type, over each gradient, applied step or skipped,
    bit for bit the plain version's; without one it leaves them as
    they were.  float32, bfloat16 and float16 parameters (the 16-bit ones
    with float32 masters)."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    for low in (None, torch.bfloat16, torch.float16):
        for scaled, inf in ((False, False), (True, False), (True, True)):
            table = _fused_case(gen, low is not None, low=low)
            ref = _clone_table(table)
            grads = [torch.randn(p.shape, generator=gen, device="cuda")
                     .to(p.dtype) * 1000 for p in table.params]
            if inf:
                grads[2].view(-1)[7] = float("inf")
            rgrads = [g.clone() for g in grads]
            before = [g.clone() for g in grads]
            scalers = [(torch.full((1,), 1024.0, device="cuda"),
                        torch.zeros(4, dtype=torch.int32, device="cuda"),
                        fo.ScalerConfig()) for _ in range(2)] \
                if scaled else [None, None]
            steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
                     for _ in range(2)]
            fo.fused_adamw(table, grads, 1e-3, steps[0],
                           clip=("global", 1.0), scaler=scalers[0])
            fo.fused_adamw_reference(ref, rgrads, 1e-3, steps[1],
                                     clip=("global", 1.0),
                                     scaler=scalers[1], coef=table.coef)
            torch.cuda.synchronize()
            for g, r, b in zip(grads, rgrads, before):
                if scaled:
                    assert torch.equal(g.view(torch.uint8),
                                       r.view(torch.uint8)), (low, inf)
                    assert not torch.equal(g, b)
                else:
                    assert torch.equal(g, b)


def test_fused_adamw_fp16_parameters_match_their_plain_version(gen):
    """O2 in float16: float16 parameters with float32 masters, three
    scaled steps with the global clip, against the plain version on the
    kernels' coefficients.  Each float32 tensor's change within 1e-4 of
    the plain version's, float16 copies within one fp16 step (2^-10)."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    lr = 1e-2
    table = _fused_case(gen, True, low=torch.float16)
    ref = _clone_table(table)
    assert all(p.dtype == torch.float16 for p in table.params)
    steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    scalers = [(torch.full((1,), 1024.0, device="cuda"),
                torch.tensor([0, 1, 0, 0], dtype=torch.int32,
                             device="cuda"),
                fo.ScalerConfig(2.0, 0.5, 2, 1, True)) for _ in range(2)]
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen, device="cuda")
                 .half() * 1024 for p in table.params]
        before = [t.clone() for t in _table_tensors(table)]
        ref_before = [t.clone() for t in _table_tensors(ref)]
        ref_grads = [g.clone() for g in grads]
        fo.fused_adamw(table, grads, lr, steps[0], clip=("global", 1.0),
                       scaler=scalers[0])
        fo.fused_adamw_reference(ref, ref_grads, lr, steps[1],
                                 clip=("global", 1.0), scaler=scalers[1],
                                 coef=table.coef)
        torch.cuda.synchronize()
        assert torch.equal(steps[0], steps[1])
        assert torch.equal(scalers[0][0], scalers[1][0])
        for got, got0, want, want0 in zip(_table_tensors(table), before,
                                          _table_tensors(ref), ref_before):
            if got.dtype == torch.float16:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=1e-6, rtol=2 ** -10)
            else:
                assert _step_change_err(got, got0, want, want0) <= 1e-4
    assert int(steps[0]) == 3


def test_static_cache_captured_step_equals_eager(gen):
    """generate() with the static and paged caches: the captured decode
    step replayed (a CUDA graph) gives the eager step's tokens, the same
    as the dense host loop's, bit for bit, with the same launches; the
    step replays once a token."""
    from paddle_tpu_torch.inference import graphs
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    model = GPTForCausalLM(gpt3_tiny(hidden_size=256), device="cuda")
    ids = torch.randint(0, 1024, (3, 40), generator=gen, device="cuda")
    dense = model.generate(ids, max_new_tokens=12, cache_impl="dense")
    for impl in ("static", "paged"):
        n = fa.flash_attention_fwd.launches
        got = model.generate(ids, max_new_tokens=12, cache_impl=impl)
        assert model.last_generate["captured"]
        assert model.last_generate["replays"] == 12
        assert torch.equal(got, dense), impl
        assert fa.flash_attention_fwd.launches > n
    # the eager run of the same step: graphs off (Program on the host
    # path), by hand
    orig = graphs.Program.capture
    try:
        graphs.Program.capture = lambda self, pool: None
        eager = model.generate(ids, max_new_tokens=12, cache_impl="static")
    finally:
        graphs.Program.capture = orig
    assert not model.last_generate["captured"]
    assert torch.equal(eager, dense)
    sampled = [model.generate(ids, max_new_tokens=12, do_sample=True,
                              top_k=50, top_p=0.9, cache_impl="static")
               for _ in range(2)]
    from paddle_tpu_torch.core import random as trandom
    trandom.seed(3)
    a = model.generate(ids, max_new_tokens=12, do_sample=True, top_k=50,
                       top_p=0.9, cache_impl="static")
    trandom.seed(3)
    try:
        graphs.Program.capture = lambda self, pool: None
        b = model.generate(ids, max_new_tokens=12, do_sample=True,
                           top_k=50, top_p=0.9, cache_impl="static")
    finally:
        graphs.Program.capture = orig
    assert torch.equal(a, b)
    assert not torch.equal(sampled[0], sampled[1])


def test_block_kv_cache_decodes_through_paged_decode(gen):
    """BlockKVCache (the host allocator) on the card: a prefill of 37
    tokens and 20 appends against the plain decode over the dense keys;
    each attend launches paged_decode once."""
    from paddle_tpu_torch.models.kv_cache import BlockKVCache
    B, nh, hd, bs = 2, 4, 128, 16
    cache = BlockKVCache(2 * 8 + 1, bs, nh, hd, B, 8, torch.bfloat16,
                         "cuda")
    k = _randn(gen, (B, 37, nh, hd), torch.bfloat16)
    v = _randn(gen, (B, 37, nh, hd), torch.bfloat16)
    cache.append_prefill(k, v)
    assert cache._lens == [37, 37] and cache._owned[0] == [1, 3, 5]
    for _ in range(20):
        kt = _randn(gen, (B, nh, hd), torch.bfloat16)
        vt = _randn(gen, (B, nh, hd), torch.bfloat16)
        cache.append(kt, vt)
        k = torch.cat([k, kt[:, None]], 1)
        v = torch.cat([v, vt[:, None]], 1)
        q = _randn(gen, (B, nh, hd), torch.bfloat16)
        n = pa.paged_attention.launches
        out = cache.attend(q)
        assert pa.paged_attention.launches == n + 1
        ref = fa.flash_attention_fwd_reference(
            q[:, None].float(), k.float(), v.float())[0][:, 0]
        torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])
    cache.free(0)
    assert cache._lens[0] == 0 and int(cache.seq_lens[0]) == 0


def test_fp16_generate_takes_flash_and_refuses_the_paged_pool(gen):
    """A float16 model generates on the dense and static caches (the
    flash kernels) and on the paged ones (the fp16 ``paged_decode``): the
    captured paged step gives the host loop's tokens bit for bit, and
    every paged token step launches ``paged_decode`` once a layer."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    model = GPTForCausalLM(gpt3_tiny(hidden_size=256), device="cuda",
                           dtype=torch.float16)
    ids = torch.randint(0, 1024, (2, 24), generator=gen, device="cuda")
    dense = model.generate(ids, max_new_tokens=6, cache_impl="dense")
    static = model.generate(ids, max_new_tokens=6, cache_impl="static")
    assert dense.shape == static.shape == (2, 30)
    got = {}
    for impl in ("paged", "paged_eager"):
        n = pa.paged_attention.launches
        got[impl] = model.generate(ids, max_new_tokens=6, cache_impl=impl)
        assert pa.paged_attention.launches - n >= \
            5 * model.cfg.num_layers, impl
        assert got[impl].shape == (2, 30)
        assert torch.equal(got[impl][:, :24], ids)
    assert torch.equal(got["paged"], got["paged_eager"])


# ------------------------------------------- slice 17: fp16, io, custom lists

def test_fp16_captured_decode_program_equals_eager(gen):
    """An fp16 gpt3_tiny (hd 64) served on captured programs against the
    eager programs: bit-identical streams and equal launch counts, the
    paged kernels' fp16 instances on both."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    model = GPTForCausalLM(gpt3_tiny(num_heads=2), device="cuda",
                           dtype=torch.float16, seed=3).eval()
    n = pa.paged_chunk_attention.launches
    st = _graphs_against_eager(model, _graph_mix(True), prefill_chunk=16)
    assert st["graphs"]["replays"] > 0
    assert pa.paged_chunk_attention.launches > n


class _Rows:
    def __init__(self, n=22):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np
        return (np.full((5,), float(i), np.float32), np.int64(i))


def test_dataloader_prefetch_equals_a_synchronous_copy(gen):
    """The card loader (pinned memory, side-stream copies one batch ahead,
    the step's stream waiting on an event) gives the CPU loader's batches
    copied synchronously, shuffled from one numpy seed; a collate that
    refills one buffer still yields distinct batches on the card."""
    import numpy as np
    from paddle_tpu_torch import io
    np.random.seed(3)
    want = [[t.cuda() for t in b] for b in io.DataLoader(
        _Rows(), batch_size=4, shuffle=True, device="cpu")]
    np.random.seed(3)
    got = list(io.DataLoader(_Rows(), batch_size=4, shuffle=True))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a[0].is_cuda and a[0].dtype == torch.float32
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    buf = np.zeros(4, np.float32)

    def collate(samples):
        for j, s in enumerate(samples):
            buf[j] = s[0][0]
        return buf

    held = list(io.DataLoader(_Rows(12), batch_size=4, collate_fn=collate))
    torch.cuda.synchronize()
    assert [float(b[0]) for b in held] == [0.0, 4.0, 8.0]


def test_custom_list_mode_on_the_card(gen):
    """The custom-list policy on the card: a white-listed ``add`` in
    bf16, a black-listed ``matmul`` in fp32, and gpt3_tiny's loss under
    the PaddleNLP-style lists equal to the CPU's within the bf16 training
    tolerance, every mapped op in the same type on both."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    x = torch.randn(4, 4, device="cuda")
    with amp.auto_cast(True, custom_white_list={"add"}):
        assert (x + x).dtype == torch.bfloat16
    with amp.auto_cast(True, custom_black_list={"matmul"}):
        assert torch.matmul(x.bfloat16(), x).dtype == torch.float32
    lists = dict(custom_black_list={"divide"},
                 custom_white_list={"embedding"})
    ids = torch.randint(0, 1024, (2, 64), generator=gen, device="cuda")
    cfg = gpt3_tiny(num_heads=2)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=4)
    card = GPTForCausalLM(cfg, device="cuda", seed=5)
    card.load_state_dict(cpu.state_dict())
    out = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        with amp.auto_cast(True, device=dev, **lists) as ctx:
            loss = model.compute_loss(ids.to(dev), ids.to(dev))
        out.append((loss.item(), dict(ctx.mode.ran)))
    assert out[0][1] == out[1][1]
    assert abs(out[0][0] - out[1][0]) <= 2e-2 + 1e-2 * abs(out[0][0])


# ------------------------------------------------ distributed (slice 18)
@pytest.fixture(scope="module")
def card_world():
    """Two ranks sharing card 0 over gloo (the machine has one card: NCCL
    cannot put two ranks on it), ``tests/test_torch_distributed.py``'s
    rank processes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import test_torch_distributed as td
    w = td.World(2, devices="0")
    yield w
    w.close()


def test_collectives_on_cuda_tensors_equal_the_cpu_results(card_world):
    """Every collective of the slice on CUDA tensors (staged through the
    host, and counted so) gives its CPU result; prints which of
    ``torch.distributed``'s own gloo collectives take CUDA tensors."""
    import numpy as np
    cpu = card_world.run("task_collectives", "cpu")
    cuda = card_world.run("task_collectives", "cuda")
    for r, (c, g) in enumerate(zip(cpu, cuda)):
        for k, v in c.items():
            if k in ("calls", "bytes", "host_staged"):
                continue
            if k == "subgroup":
                np.testing.assert_array_equal(g[k][0], v[0])
                assert g[k][1:] == v[1:]
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
        assert c["host_staged"] is None or not c["host_staged"]["series"]
        staged = {x["labels"]["op"] for x in g["host_staged"]["series"]}
        assert staged >= {"all_reduce", "all_gather", "broadcast",
                          "alltoall", "scatter", "send", "recv",
                          "reduce_scatter"}
    print("gloo with CUDA tensors:",
          card_world.run("task_gloo_cuda_probe")[0])


def test_data_parallel_on_the_card_equals_the_cpu(card_world):
    import numpy as np
    rng = np.random.RandomState(0)
    init = [rng.randn(8, 4).astype(np.float32) * 0.5,
            rng.randn(8).astype(np.float32) * 0.1,
            rng.randn(1, 8).astype(np.float32) * 0.5,
            rng.randn(1).astype(np.float32) * 0.1]
    X = rng.rand(16, 4).astype(np.float32)
    Y = X.sum(axis=1, keepdims=True)
    cpu = card_world.run("task_dp_mlp", init, X, Y, "cpu")
    cuda = card_world.run("task_dp_mlp", init, X, Y, "cuda")
    for a, b in zip(cpu, cuda):
        np.testing.assert_allclose(b, a, rtol=1e-5)


# ------------------------------------------- pipeline parallelism (slice 20)
@pytest.fixture(scope="module")
def pipe_world():
    """Two ranks sharing card 0 over gloo: ``tests/test_torch_pipeline.py``
    run as rank scripts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import test_torch_pipeline as tp
    w = tp.World(2, tp.__file__, devices="0")
    yield w
    w.close()


def test_ring_permute_on_cuda_tensors(pipe_world):
    """The ring permute's autograd function on CUDA tensors across two
    ranks: each receives the other's tensor, the backward returns each
    cotangent to its sender, and both p2p calls are staged through the
    host (gloo)."""
    for r, (y, g, staged) in enumerate(pipe_world.run("task_ring", "cuda",
                                                      timeout=120)):
        assert y == [float(1 - r)] * 3
        assert g == [10.0 + (1 - r)] * 3
        assert staged == ["recv", "send"]


@pytest.fixture(scope="module")
def hybrid_world():
    """Two ranks sharing card 0 over gloo:
    ``tests/test_torch_hybrid_step.py`` run as rank scripts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import test_torch_hybrid_step as th
    w = th.World(2, th.__file__, devices="0")
    yield w
    w.close()


def test_hybrid_step_on_the_card_matches_the_serial_step(hybrid_world, gen):
    """A tiny ``make_hybrid_train_step`` at pp 2 x vpp 2 on the card (hd
    64: the flash kernels, no plain route) against ``serial_train_step``
    on the card in this process: losses within rtol 2e-4 / atol 2e-5,
    parameters within 2 lr steps, every rank launching the three flash
    kernels, and the ranks' gathered parameters bit-equal."""
    import numpy as np
    import test_torch_hybrid_step as th
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    kw = dict(vocab_size=256, hidden_size=128, num_layers=4, num_heads=2,
              seq_len=64, n_microbatches=4, learning_rate=1e-3)
    cfg = T.HybridConfig(pp=1, mp=1, dp=1, **kw)
    params = T.init_gpt_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(20), device="cuda")
    ids = np.random.RandomState(20).randint(0, 256, (4, 2, 64))
    zeros = T.tree_map(torch.zeros_like, params)
    state, losses = (params, zeros, zeros), []
    for i in range(3):
        loss, *state = T.serial_train_step(
            *state, float(i + 1), torch.from_numpy(ids).cuda(), cfg)
        losses.append(float(loss))
    ref = dict(losses=losses, after=hybrid_params_to_numpy(state[0]))
    res = hybrid_world.run("task_hybrid",
                           dict(kw, pp=2, vpp=2, dp=1, mp=1),
                           hybrid_params_to_numpy(params), ids, 3, "cuda",
                           timeout=300)
    for got_losses, got_params, launches, plain in res:
        th._assert_matches(got_losses, got_params, ref)
        assert all(n > 0 for n in launches) and plain == 0
    th._assert_replicas_equal([r[1] for r in res])


# ------------------------------------------------- tensor parallelism
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_mask_heads_give_slices_of_the_whole_launch(gen, dtype, hd):
    """A launch over heads 2..3 of 4 (kv head 1 of 2: GQA) with
    ``mask_heads=(2, 4)`` draws the whole launch's dropout masks for
    those heads: its output, lse, dq, dk and dv are the whole launch's
    slices, bit for bit, and its plain version agrees."""
    B, S, nh, nkv, rate, seed = 2, 130, 4, 2, 0.2, 99
    q, k, v, mask = _flash_inputs(gen, B, S, S, nh, nkv, hd, dtype)
    do = _randn(gen, (B, S, nh, hd), dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, True, mask, rate, seed)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, True, mask,
                                        rate, seed)
    part = [t[:, :, 2:].contiguous() for t in (q, do)]
    kv = [t[:, :, 1:].contiguous() for t in (k, v)]
    o2, lse2 = fa.flash_attention_fwd(part[0], *kv, True, mask, rate, seed,
                                      mask_heads=(2, 4))
    g2 = fa.flash_attention_bwd(part[0], *kv, o2, lse2, part[1], True, mask,
                                rate, seed, mask_heads=(2, 4))
    assert torch.equal(o2, out[:, :, 2:]) and torch.equal(lse2, lse[:, 2:])
    for got, want in zip(g2, (dq[:, :, 2:], dk[:, :, 1:], dv[:, :, 1:])):
        assert torch.equal(got, want)
    ref, ref_lse = fa.flash_attention_fwd_reference(
        part[0].float(), *(t.float() for t in kv), True, mask, rate, seed,
        mask_heads=(2, 4))
    torch.testing.assert_close(o2.float(), ref, **TOL[dtype])
    torch.testing.assert_close(lse2, ref_lse, **TOL[dtype])
    with pytest.raises(fa.KernelValueError):
        fa.flash_attention_fwd(part[0], *kv, True, mask, rate, seed,
                               mask_heads=(3, 4))


@pytest.mark.parametrize("low", [None, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("clip", [("global", 1.0), ("norm", 0.5), None])
@pytest.mark.parametrize("scaled", [None, "finite", "inf"])
def test_fused_adamw_split_norm_matches_its_plain_version(gen, low, clip,
                                                          scaled):
    """The split norm (tensor parallelism, ZeRO) as two like ranks would
    run it: every other tensor weighted 1/2 (held alike by both), the
    rest 1 (split), and the reduction doubling the sums (the other rank's
    equal part).  Three steps against the plain version with the same
    weights and reduction: step counts, the scaler's scale and counts
    exact (an overflow skips), the coefficients within rtol 1e-6, each
    float32 tensor's change within 1e-4 of the plain version's (on the
    kernels' coefficients), 16-bit copies within one step of their
    type; one launch of the pair a step."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    lr, o2 = 1e-2, low is not None
    pdt = low or torch.float32
    gscale = 1024.0 if scaled else 1.0
    shapes = FUSED_SHAPES + [(33,)]
    need_clip = [i != 1 for i in range(len(shapes))]
    all_grads = [[torch.randn(s, generator=gen, device="cuda").to(pdt)
                  * gscale for s in shapes] for _ in range(3)]
    base = _fused_case(gen, o2, _clipped_rms(all_grads[0], clip, need_clip,
                                             gscale), wd=0.1, low=low)
    weights = [0.5 if i % 2 else 1.0 for i in range(len(shapes))]

    def weighted(t):
        return fo.FusedTable(t.params, t.masters, t.states, t.wds,
                             t.lr_ratios, t.need_clip, weights)
    table, ref = weighted(base), weighted(_clone_table(base))
    reduce = lambda v: v.mul_(2.0)  # noqa: E731
    steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    scalers = None
    if scaled:
        scalers = [(torch.full((1,), gscale, device="cuda"),
                    torch.tensor([0, 1, 0, 0], dtype=torch.int32,
                                 device="cuda"),
                    fo.ScalerConfig(2.0, 0.5, 2, 1, True))
                   for _ in range(2)]
    for it, grads in enumerate(all_grads):
        if scaled == "inf" and it == 1:
            grads[2].view(-1)[65537] = float("inf")
        before = [t.clone() for t in _table_tensors(table)]
        ref_before = [t.clone() for t in _table_tensors(ref)]
        ref_grads = [g.clone() for g in grads]
        n = fo.fused_adamw.launches
        fo.fused_adamw(table, grads, lr, steps[0], clip=clip,
                       scaler=scalers and scalers[0], reduce=reduce)
        assert fo.fused_adamw.launches == n + 1
        fo.fused_adamw_reference(ref, ref_grads, lr, steps[1], clip=clip,
                                 scaler=scalers and scalers[1],
                                 coef=table.coef, reduce=reduce)
        torch.cuda.synchronize()
        assert torch.equal(steps[0], steps[1])
        if scaled:
            assert torch.equal(scalers[0][0], scalers[1][0])
            assert torch.equal(scalers[0][1], scalers[1][1])
        torch.testing.assert_close(table.coef, ref.coef, atol=0.0,
                                   rtol=1e-6)
        if scaled == "inf" and it == 1:
            assert int(scalers[0][1][0]) == 1
            continue
        for got, got0, want, want0 in zip(_table_tensors(table), before,
                                          _table_tensors(ref), ref_before):
            if got.dtype != torch.float32:
                torch.testing.assert_close(
                    got.float(), want.float(), atol=1e-6,
                    rtol=2 ** -7 if got.dtype == torch.bfloat16
                    else 2 ** -10)
            else:
                assert _step_change_err(got, got0, want, want0) <= 1e-4
    assert int(steps[0]) == (2 if scaled == "inf" else 3)
