"""The port's attention ops against the JAX package's kernels, on the CPU.

The same numpy inputs go through the Pallas kernels of
``paddle_tpu/ops/pallas_paged.py`` and ``pallas_flash.py`` (in interpret
mode, as the JAX package's own tests run them) and through the port's
wrappers with CPU tensors, where the wrappers take their plain PyTorch
versions.  Tolerance: fp32, atol 1e-5 (XLA and PyTorch sum in different
orders).  Also here: the pool writes and the chunk view's write path, that
a non-CPU tensor goes to the kernel route and never to the plain version,
that entry points refuse to fall back to the CPU, and that the port
imports nothing of JAX or of the JAX package.  The flash backward's cases
are in ``tests/test_torch_train.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops import pallas_flash as jflash
from paddle_tpu.ops import pallas_paged as jpp
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x)


def _paged_case(B, nh, hd, bs, lens, max_blocks, seed=0):
    """Random pools and tables with blocks shuffled across sequences, so
    a wrong table lookup reads another sequence's keys."""
    rng = np.random.RandomState(seed)
    npool = B * max_blocks + 1
    k = rng.standard_normal((nh, npool, bs, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((nh, npool, bs, hd)).astype(np.float32) * 0.5
    perm = rng.permutation(np.arange(1, npool))
    tables = np.zeros((B, max_blocks), np.int32)
    for b, n in enumerate(lens):
        live = min(-(-n // bs), max_blocks)
        tables[b, :live] = perm[b * max_blocks:b * max_blocks + live]
    return k, v, tables


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize("lens", [(0, 1, 8, 13), (16, 31, 5, 0)])
def test_paged_attention_matches_pallas_decode(lens):
    B, nh, hd, bs, maxb = 4, 2, 16, 8, 5
    k, v, tables = _paged_case(B, nh, hd, bs, lens, maxb)
    q = np.random.RandomState(1).standard_normal((B, nh, hd)).astype(
        np.float32)
    lens = np.asarray(lens, np.int32)
    want = jpp.paged_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(tables),
                               jnp.asarray(lens), interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(tables),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    # a length-0 row reads nothing and gives zeros
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


def _split_merge_decode(q, k, v, tables, lens):
    """A plain model of the card's paged_decode: the table's keys cut into
    the splits of ``decode_split``, each split's partial softmax state
    (m, l, acc) from its live keys (a split at or past the row's length:
    the empty state m = -inf, l = 0; one whose keys were all dropped: m =
    -1e30, l = 0), merged by their maxima in split order, skipping empty
    splits, zeros where l == 0."""
    B, nh, hd = q.shape
    bs, maxb = k.shape[2], tables.shape[1]
    per, n_split = tpa.decode_split(maxb, bs)
    keys, in_pool = tpa._gather_table(k, tables)       # [B, K, nh, hd]
    vals, _ = tpa._gather_table(v, tables)
    s = torch.einsum("bhd,bkhd->bhk", q, keys) / np.sqrt(hd)
    out = torch.zeros_like(q)
    for b in range(B):
        end = min(int(lens[b]), maxb * bs)
        for h in range(nh):
            parts = []
            for sp in range(n_split):
                lo, hi = sp * per * bs, min((sp + 1) * per * bs, end)
                if lo >= hi:
                    parts.append((-np.inf, 0.0, None))
                    continue
                live = in_pool[b, lo:hi]
                sc = s[b, h, lo:hi]
                m = max(-1e30, sc[live].max().item()) if live.any() else -1e30
                p = torch.where(live, torch.exp(sc - m), 0.0)
                parts.append((m, p.sum().item(), p @ vals[b, lo:hi, h]))
            mall = max(m for m, _, _ in parts)
            w = [0.0 if m == -np.inf else np.exp(m - mall)
                 for m, _, _ in parts]
            lall = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            acc = sum(wi * a for wi, (_, _, a) in zip(w, parts) if wi != 0.0)
            if lall > 0:
                out[b, h] = acc / lall
    return out


@pytest.mark.parametrize("bs", [16, 64])
def test_paged_decode_split_and_merge(bs):
    """The split-and-merge algebra of the card's paged_decode against the
    plain version and the JAX reference, at lengths on the split edges, 0,
    1 and the full table: empty splits, and rows all of whose splits are
    empty, merge to the right answer (zeros for length 0).  An out-of-pool
    table entry drops its keys inside a split (against the plain version:
    the JAX reference reads such an entry as a clamped index)."""
    nh, hd, maxb = 2, 16, 512 // bs
    lens = (0, 1, 255, 256, 257, 512)
    assert tpa.decode_split(maxb, bs) == (256 // bs, 2)
    k, v, tables = _paged_case(len(lens), nh, hd, bs, lens, maxb)
    q = np.random.RandomState(6).standard_normal(
        (len(lens), nh, hd)).astype(np.float32)
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, k, v, tables))
    tl = torch.tensor(lens, dtype=torch.int32)
    model = _split_merge_decode(tq, tk, tv, tt, tl)
    want = jpp.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(np.asarray(lens, np.int32)))
    np.testing.assert_allclose(model.numpy(), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        model.numpy(), tpa.paged_attention(tq, tk, tv, tt, tl).numpy(),
        atol=ATOL, rtol=0)
    assert not model[0].any()
    bad = tt.clone()
    # row 4: a key dropped in split 0, and split 1's one key (256) dropped
    bad[4, 1], bad[4, 256 // bs], bad[5, maxb - 1] = -1, -1, 10 ** 6
    np.testing.assert_allclose(
        _split_merge_decode(tq, tk, tv, bad, tl).numpy(),
        tpa.paged_attention(tq, tk, tv, bad, tl).numpy(), atol=ATOL, rtol=0)


# ------------------------------------------------------------------- chunk

@pytest.fixture
def pallas_load(monkeypatch):
    """`_chunk_fused_kernel` calls `pl.load` (and the MoE kernels also
    `pl.store`), which this jax release no longer has; ref indexing and
    assignment replace them.  Put them back for the test only, so the
    kernels run in interpret mode as written."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)
    if not hasattr(pl, "store"):
        monkeypatch.setattr(pl, "store",
                            lambda ref, idx, v: ref.__setitem__(idx, v),
                            raising=False)


CHUNK_CASES = [
    dict(s=5, starts=(0, 0)),          # fresh prefill chunk
    dict(s=6, starts=(7, 16)),         # suffix chunks, ragged start
    dict(s=4, starts=(30, 36)),        # rows past the 5 x 8 table
]


@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_paged_chunk_attention_matches_pallas(case, strategy, pallas_load):
    B, nh, hd, bs, maxb = 2, 2, 16, 8, 5
    s, starts = case["s"], np.asarray(case["starts"], np.int32)
    k, v, tables = _paged_case(B, nh, hd, bs, starts + s, maxb)
    q = np.random.RandomState(2).standard_normal((B, s, nh, hd)).astype(
        np.float32)
    args = [jnp.asarray(a) for a in (q, k, v, tables, starts)]
    want = jpp.paged_chunk_attention(*args, interpret=True,
                                     strategy=strategy)
    targs = [torch.from_numpy(a) for a in (q, k, v, tables, starts)]
    got = tpa.paged_chunk_attention(*targs)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    # verify is the same contract on the same kernel
    np.testing.assert_array_equal(tpa.paged_verify_attention(*targs).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("s", [2, 4])
def test_paged_verify_attention_matches_pallas_at_the_verify_shape(
        s, pallas_load):
    """The spec tick's verify: k = s rows per slot at mixed starts, the
    first two slots free (start 0 on an all-zero table row: the pad
    block), one row across a block edge, one at the table's end; the
    port's CPU route against the JAX ``paged_verify_attention``."""
    B, nh, hd, bs, maxb = 6, 2, 16, 8, 5
    starts = np.array([0, 0, 7, 15, 21, 40 - s], np.int32)
    k, v, tables = _paged_case(B, nh, hd, bs, starts + s, maxb, seed=4)
    tables[:2] = 0
    q = np.random.RandomState(6).standard_normal((B, s, nh, hd)).astype(
        np.float32)
    args = [jnp.asarray(a) for a in (q, k, v, tables, starts)]
    want = jpp.paged_verify_attention(*args, interpret=True)
    targs = [torch.from_numpy(a) for a in (q, k, v, tables, starts)]
    n = tpa.paged_verify_attention.launches
    got = tpa.paged_verify_attention(*targs)
    assert tpa.paged_verify_attention.launches == n       # the CPU route
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    # the view the engine verifies through writes, then attends
    view = tkv.PagedVerifyKernelView.from_parts(
        targs[1].clone(), targs[2].clone(), targs[3], targs[4], bs)
    jview = jkv.PagedVerifyKernelView.from_parts(
        args[1], args[2], args[3], args[4], bs)
    kn = np.random.RandomState(7).standard_normal(q.shape).astype(
        np.float32)
    new, out = view.update_and_attend(targs[0], torch.from_numpy(kn),
                                      torch.from_numpy(kn))
    jnew, jout = jview.update_and_attend(args[0], jnp.asarray(kn),
                                         jnp.asarray(kn))
    np.testing.assert_allclose(new.k.numpy(), _np(jnew.k), atol=0, rtol=0)
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=ATOL, rtol=0)
    assert new.seq_lens.tolist() == (starts + s).tolist()


@pytest.mark.parametrize("bad", [-1, 99])
def test_out_of_pool_table_entries_are_dropped(bad):
    """A table entry outside the pool drops its keys in both ops, the rule
    both kernels keep: no read of another block, no zero key in the
    softmax, and a row left with no key gives zeros."""
    nh, hd, bs = 2, 16, 8
    k, v, _ = _paged_case(1, nh, hd, bs, (), 3)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    q = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (1, 3 * bs, nh, hd)).astype(np.float32))
    table = torch.tensor([[1, bad, 2]], dtype=torch.int32)

    def decode(tbl, n, j=None):       # query row j (default n - 1)
        j = n - 1 if j is None else j
        return tpa.paged_attention(q[:, j], k, v, tbl,
                                   torch.tensor([n], dtype=torch.int32))[0]

    # the middle block's keys are gone: as if the table skipped it
    np.testing.assert_allclose(
        decode(table, 3 * bs, 0).numpy(),
        decode(torch.tensor([[1, 2, 0]], dtype=torch.int32), 2 * bs,
               0).numpy(),
        atol=ATOL, rtol=0)
    chunk = tpa.paged_chunk_attention(q, k, v, table,
                                      torch.zeros(1, dtype=torch.int32))[0]
    for j in range(3 * bs):
        np.testing.assert_allclose(chunk[j].numpy(),
                                   decode(table, j + 1).numpy(),
                                   atol=ATOL, rtol=0)
    # every key of the first block dropped: those rows are zeros
    first = torch.tensor([[bad, 1, 2]], dtype=torch.int32)
    chunk = tpa.paged_chunk_attention(q, k, v, first,
                                      torch.zeros(1, dtype=torch.int32))[0]
    assert not chunk[:bs].any()
    assert not decode(first, bs).any()


# ------------------------------------------------------------------- flash

@pytest.mark.parametrize("Sq,Sk,nh,nkv", [(16, 16, 4, 4), (12, 12, 4, 2),
                                          (8, 24, 2, 2)])
def test_flash_attention_fwd_matches_pallas(Sq, Sk, nh, nkv):
    B, hd = 2, 32
    rng = np.random.RandomState(3)
    q = rng.standard_normal((B, Sq, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    out_j, lse_j = jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True)
    out_t, lse_t = tflash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=ATOL, rtol=0)
    # the JAX lse carries each row across 128 lanes; the port keeps one
    assert lse_t.shape == (B, nh, Sq)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse_j)[..., 0], atol=ATOL,
                               rtol=0)


def test_flash_reference_fully_masked_rows_are_zero():
    # Sq > Sk end-aligned: the first Sq - Sk rows see no key
    q = torch.randn(1, 6, 2, 64)
    k = torch.randn(1, 4, 2, 64)
    out, lse = tflash.flash_attention_fwd(q, k, k, causal=True)
    assert not out[:, :2].any()
    assert torch.all(lse[..., :2] == -1e30)


def test_flash_rejects_what_belongs_to_training(monkeypatch):
    """The training slice's arguments of flash_fwd: the kv mask and
    dropout now run, against the JAX kernel (interpret mode, one tile,
    the `_hash_bits` keep mask: bit-identical), and malformed ones are
    rejected."""
    monkeypatch.setattr(jflash, "_resolve_interpret", lambda i, r: True)
    B, S, nh, hd = 2, 24, 2, 32
    rng = np.random.RandomState(7)
    q, k, v = (rng.standard_normal((B, S, nh, hd)).astype(np.float32)
               for _ in range(3))
    mask = (rng.uniform(size=(B, S)) > 0.4).astype(np.int32)
    mask[1] = 0
    out_j, lse_j = jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, kv_mask=jnp.asarray(mask), dropout_rate=0.2,
        seed=jnp.int32(9))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out_t, lse_t = tflash.flash_attention_fwd(
        tq, tk, tv, causal=True, kv_mask=torch.from_numpy(mask),
        dropout_rate=0.2, seed=9)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse_j)[..., 0],
                               atol=ATOL, rtol=0)
    assert not out_t[1].any() and torch.all(lse_t[1] == -1e30)
    with pytest.raises(ValueError, match="seed"):
        tflash.flash_attention_fwd(tq, tk, tv, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        tflash.flash_attention_fwd(tq, tk, tv, dropout_rate=1.0, seed=1)
    with pytest.raises(ValueError, match="kv_mask"):
        tflash.flash_attention_fwd(tq, tk, tv, kv_mask=torch.ones(B, S + 1))


# ------------------------------------------------------------------ writes

def test_pool_writes_match_jax():
    nh, npool, bs, hd, B = 2, 9, 4, 8, 2
    rng = np.random.RandomState(4)
    pool = rng.standard_normal((nh, npool, bs, hd)).astype(np.float32)
    tables = np.asarray([[3, 1, 7, 0], [2, 8, 5, 0]], np.int32)
    lens = np.asarray([5, 11], np.int32)
    kt = rng.standard_normal((B, nh, hd)).astype(np.float32)
    jk, _ = jpp.paged_write_token(jnp.asarray(pool), jnp.asarray(pool),
                                  jnp.asarray(tables), jnp.asarray(lens),
                                  jnp.asarray(kt), jnp.asarray(kt))
    tk = torch.from_numpy(pool.copy())
    tpa.paged_write_token(tk, tk.clone(), torch.from_numpy(tables),
                          torch.from_numpy(lens), torch.from_numpy(kt),
                          torch.from_numpy(kt))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))

    kp = rng.standard_normal((B, 10, nh, hd)).astype(np.float32)
    jk, _ = jpp.paged_write_prefill(jnp.asarray(pool), jnp.asarray(pool),
                                    jnp.asarray(tables), jnp.asarray(kp),
                                    jnp.asarray(kp))
    tk = torch.from_numpy(pool.copy())
    tpa.paged_write_prefill(tk, tk.clone(), torch.from_numpy(tables),
                            torch.from_numpy(kp), torch.from_numpy(kp))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))


def test_token_write_past_the_table_goes_to_the_pad_block():
    """A draft model's steps past a slot's budget write positions past its
    table: the pad block 0 takes them, no live block changes."""
    nh, npool, bs, hd = 2, 9, 4, 8
    rng = np.random.RandomState(5)
    pool = torch.from_numpy(
        rng.standard_normal((nh, npool, bs, hd)).astype(np.float32))
    tables = torch.tensor([[3, 1, 7, 4], [2, 8, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([16, 13], dtype=torch.int32)    # 16: past the table
    kt = torch.from_numpy(rng.standard_normal((2, nh, hd)).astype(np.float32))
    k, v = pool.clone(), pool.clone()
    tpa.paged_write_token(k, v, tables, lens, kt, kt)
    want = pool.clone()
    want[:, 0, 0] = kt[0]
    want[:, 6, 1] = kt[1]
    torch.testing.assert_close(k, want, rtol=0, atol=0)
    torch.testing.assert_close(v, want, rtol=0, atol=0)
    # the JAX write clamps the column instead: row 0's token lands in its
    # last live block (4) at offset 16 % 4, over a cached position
    jk, _ = jpp.paged_write_token(*(jnp.asarray(x.numpy()) for x in (
        pool, pool, tables, lens, kt, kt)))
    jwant = pool.clone()
    jwant[:, 4, 0] = kt[0]
    jwant[:, 6, 1] = kt[1]
    np.testing.assert_array_equal(_np(jk), jwant.numpy())


def test_chunk_view_writes_and_attends_like_jax():
    """GQA head repeat, table-routed write, overflow positions to the pad
    block: the JAX `PagedChunkView` and the port's, on one pool."""
    nh, nkv, bs, hd, maxb = 4, 2, 4, 8, 3
    rng = np.random.RandomState(5)
    pool = rng.standard_normal((nh, 7, bs, hd)).astype(np.float32)
    tables = np.asarray([[2, 4, 6], [1, 3, 5]], np.int32)
    starts = np.asarray([3, 9], np.int32)       # row 1 runs past the table
    s = 5
    q = rng.standard_normal((2, s, nh, hd)).astype(np.float32)
    kv = rng.standard_normal((2, s, nkv, hd)).astype(np.float32)
    jv = jkv.PagedChunkView.from_parts(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(tables),
        jnp.asarray(starts), bs)
    jnew, jout = jv.update_and_attend(jnp.asarray(q), jnp.asarray(kv),
                                      jnp.asarray(kv))
    outs = []
    for cls in (tkv.PagedChunkView, tkv.PagedChunkKernelView):
        tk = torch.from_numpy(pool.copy())
        tv = cls.from_parts(tk, tk.clone(), torch.from_numpy(tables),
                            torch.from_numpy(starts), bs)
        tnew, tout = tv.update_and_attend(torch.from_numpy(q),
                                          torch.from_numpy(kv),
                                          torch.from_numpy(kv))
        np.testing.assert_array_equal(tk.numpy(), _np(jnew.k))
        np.testing.assert_array_equal(tnew.seq_lens.numpy(),
                                      _np(jnew.seq_lens))
        np.testing.assert_allclose(tout.numpy(), _np(jout), atol=ATOL,
                                   rtol=0)
        outs.append(tout)
    # the pad block took the overflow writes, the real blocks kept theirs
    assert not np.array_equal(pool[:, 0], _np(jnew.k)[:, 0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=ATOL)


# ------------------------------------------------------- no quiet fallback

class _KernelRoute(Exception):
    pass


def test_non_cpu_tensors_take_the_kernel_route(monkeypatch):
    """A tensor off the CPU goes to the kernel library (here a stub that
    raises) and never to the plain version."""
    def stub():
        raise _KernelRoute()
    monkeypatch.setattr(_build, "library", stub)
    m = dict(device="meta")
    pool = torch.empty(2, 5, 8, 64, **m)
    tables = torch.empty(2, 3, dtype=torch.int32, **m)
    lens = torch.empty(2, dtype=torch.int32, **m)
    calls = [
        lambda: tpa.paged_attention(torch.empty(2, 2, 64, **m), pool, pool,
                                    tables, lens),
        lambda: tpa.paged_chunk_attention(torch.empty(2, 4, 2, 64, **m),
                                          pool, pool, tables, lens),
        lambda: tpa.paged_verify_attention(torch.empty(2, 4, 2, 64, **m),
                                           pool, pool, tables, lens),
        lambda: tflash.flash_attention_fwd(
            *(torch.empty(1, 8, 2, 64, **m),) * 3, causal=True),
        lambda: tflash.flash_attention_fwd(
            *(torch.empty(1, 8, 2, 64, **m),) * 3, causal=True,
            kv_mask=torch.empty(1, 8, dtype=torch.int32, **m),
            dropout_rate=0.1, seed=3),
    ]
    x = torch.empty(1, 8, 2, 64, **m)
    lse = torch.empty(1, 2, 8, **m)
    bwd = (x, x, x, x, lse, x, True)
    calls += [lambda: tflash.flash_attention_bwd_dq(*bwd),
              lambda: tflash.flash_attention_bwd_dkv(*bwd),
              lambda: tflash.flash_attention_bwd(*bwd),
              lambda: tflash.flash_attention(*(x,) * 3, True)]
    for call in calls:
        with pytest.raises(_KernelRoute):
            call()


def test_wrappers_check_what_the_kernels_take():
    m = dict(device="meta")
    q = torch.empty(1, 8, 2, 64, **m)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.empty(1, 8, 2, 48, **m)
        tflash.flash_attention_fwd(x, x, x)
    with pytest.raises(TypeError, match="dtypes"):
        tflash.flash_attention_fwd(q, q.to(torch.bfloat16),
                                   q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.empty(1, 2, 8, 64, **m).transpose(1, 2)
        tflash.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_attention_bwd_dq(q, q, q, q, torch.empty(1, 2, 8, **m)
                                      .to(torch.bfloat16), q)
    with pytest.raises(TypeError, match="int32"):
        pool = torch.empty(2, 5, 8, 64, **m)
        tpa.paged_attention(torch.empty(2, 2, 64, **m), pool, pool,
                            torch.empty(2, 3, dtype=torch.int64, **m),
                            torch.empty(2, dtype=torch.int32, **m))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(gpt3_tiny(num_layers=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(gpt3_tiny(num_layers=2, moe_num_experts=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MoELayer(16, num_expert=4, d_hidden=32)
    layer = MoELayer(16, num_expert=4, d_hidden=32, device="cpu")
    assert {p.device.type for p in layer.parameters()} == {"cpu"}
    model = GPTForCausalLM(gpt3_tiny(num_layers=1), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model)
    assert resolve_device("cpu").type == "cpu"
    ServingEngine(model, device="cpu")


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|paddle_tpu)\b|\bpaddle_tpu\.",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_the_jax_package():
    """`import jax`, `from jax`, `paddle_tpu.` and `from paddle_tpu`
    appear nowhere in the port or in chip_smoke.py (`paddle_tpu_torch`
    does not match: the port names its JAX counterparts by file path),
    the distributed modules and the tensor-parallel worker's module
    included (the spawned ranks' own imports are checked at run time in
    tests/test_torch_distributed.py and tests/test_torch_serving_tp.py)."""
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"paddle_tpu_torch/ops/flash_attention.py",
            "paddle_tpu_torch/nn/functional/attention.py",
            "paddle_tpu_torch/nn/clip.py",
            "paddle_tpu_torch/amp/auto_cast.py",
            "paddle_tpu_torch/optimizer/optimizer.py",
            "paddle_tpu_torch/observability/flops.py",
            "paddle_tpu_torch/models/convert.py",
            "paddle_tpu_torch/ops/moe.py",
            "paddle_tpu_torch/incubate/distributed/models/moe/gate.py",
            "paddle_tpu_torch/incubate/distributed/models/moe/moe_layer.py",
            "paddle_tpu_torch/observability/metrics.py",
            "paddle_tpu_torch/observability/descriptions.py",
            "paddle_tpu_torch/observability/quantiles.py",
            "paddle_tpu_torch/observability/export.py",
            "paddle_tpu_torch/observability/http.py",
            "paddle_tpu_torch/observability/tracing.py",
            "paddle_tpu_torch/observability/chrome.py",
            "paddle_tpu_torch/observability/flight_recorder.py",
            "paddle_tpu_torch/distributed/env.py",
            "paddle_tpu_torch/distributed/collective.py",
            "paddle_tpu_torch/distributed/parallel.py",
            "paddle_tpu_torch/distributed/launch/main.py",
            "paddle_tpu_torch/inference/tp.py",
            "paddle_tpu_torch/inference/tp_worker.py",
            "paddle_tpu_torch/distributed/fleet/pp_layers.py",
            "paddle_tpu_torch/distributed/fleet/pipeline_parallel.py",
            "paddle_tpu_torch/distributed/fleet/spmd_pipeline.py",
            "paddle_tpu_torch/distributed/fleet/hybrid_step.py",
            "paddle_tpu_torch/distributed/fleet/utils/"
            "sequence_parallel_utils.py",
            "paddle_tpu_torch/distributed/checkpoint/utils.py",
            "paddle_tpu_torch/distributed/checkpoint/metadata.py",
            "paddle_tpu_torch/distributed/checkpoint/save_state_dict.py",
            "paddle_tpu_torch/distributed/checkpoint/load_state_dict.py",
            "paddle_tpu_torch/core/native/__init__.py",
            "paddle_tpu_torch/distributed/store.py",
            "paddle_tpu_torch/distributed/watchdog.py",
            "paddle_tpu_torch/distributed/fleet/elastic/__init__.py",
            "paddle_tpu_torch/distributed/fleet/elastic/manager.py",
            "paddle_tpu_torch/distributed/fleet/elastic/loop.py",
            "paddle_tpu_torch/distributed/rpc/__init__.py",
            } <= names
    for f in files:
        hits = [m.group(0) for m in _FORBIDDEN.finditer(f.read_text())]
        assert not hits, f"{f.relative_to(ROOT)}: {hits}"


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_head_dims_route_before_any_launch(monkeypatch, hd):
    """Off the CPU (here ``meta`` tensors, the library a stub that
    raises), a head dim the kernels do not take goes to the plain
    versions in every caller and is counted in ``plain_calls``, never in
    ``launches``; a head dim they take reaches the kernel library."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    def stub():
        raise _KernelRoute()
    monkeypatch.setattr(_build, "library", stub)
    m = dict(device="meta")
    B, s, nh = 2, 4, 2
    q = torch.empty(B, s, nh, hd, **m)
    cache = tkv.PagedKVCache(B, 48, nh, hd, block_size=16, device="meta")
    chunk = tkv.PagedChunkKernelView.from_parts(
        cache.k, cache.v, cache.tables, cache.seq_lens + 3, 16)
    verify = tkv.PagedVerifyKernelView.from_parts(
        cache.k, cache.v, cache.tables, cache.seq_lens + 3, 16)
    calls = [(tflash.flash_attention_fwd,
              lambda: scaled_dot_product_attention(q, q, q, is_causal=True)),
             (tflash.flash_attention_fwd,
              lambda: cache.update_and_attend(q, q, q)),
             (tpa.paged_attention,
              lambda: cache.update_and_attend(*(q[:, :1],) * 3)),
             (tpa.paged_chunk_attention,
              lambda: chunk.update_and_attend(q, q, q)),
             (tpa.paged_verify_attention,
              lambda: verify.update_and_attend(q, q, q))]
    counted = (tflash.flash_attention_fwd, tpa.paged_attention,
               tpa.paged_chunk_attention, tpa.paged_verify_attention)
    for fn in counted:
        monkeypatch.setattr(fn, "plain_calls", 0)
        monkeypatch.setattr(fn, "launches", 0)
    for fn, call in calls:
        before = fn.plain_calls
        if hd in tflash.KERNEL_HEAD_DIMS:
            with pytest.raises(_KernelRoute):
                call()
            assert fn.plain_calls == before
        else:
            out = call()
            out = out[1] if isinstance(out, tuple) else out
            assert out.shape[-1] == hd and out.device.type == "meta"
            assert fn.plain_calls == before + 1
    assert all(fn.launches == 0 for fn in counted)
    assert tflash.plain_route(q) == (hd not in (64, 128, 256))
    assert not tflash.plain_route(torch.empty(B, s, nh, hd))   # the CPU


def test_chunk_split_comes_from_the_shapes():
    """bf16 paged_chunk splits its key axis only when the grid (sequence x
    head x 128 rows) is smaller than the card's 132 SMs; splits are
    multiples of the 64-key tile, at most 64 of them, and cover the
    table."""
    assert tpa.chunk_split(1, 16, 256, 32, 64) == (256, 8)   # serving path
    assert tpa.chunk_split(8, 16, 256, 32, 64) == (2048, 1)
    assert tpa.chunk_split(1, 2, 70, 8, 16) == (128, 1)      # small table
    assert tpa.chunk_split(1, 16, 4, 2048, 16) == (512, 64)
    for B, nh, s, maxb, bs in [(1, 16, 1, 100, 16), (2, 4, 300, 7, 48),
                               (1, 1, 1000, 3000, 64)]:
        per, n = tpa.chunk_split(B, nh, s, maxb, bs)
        assert per % 64 == 0 and n <= 64 and (n - 1) * per < maxb * bs \
            <= n * per
