"""Attention over the paged KV pool: the ``paged_decode`` and
``paged_chunk`` CUDA kernels, their plain PyTorch versions, and the pool
writes.

Counterpart of ``paddle_tpu/ops/pallas_paged.py``.  Layouts are the JAX
package's: pools ``[nh, num_blocks, bs, hd]`` (block 0 is the pad block),
block tables ``[B, max_blocks]`` int32, lengths and starts ``[B]`` int32.
The kernels are ``paddle_tpu_torch/csrc/paged_decode.cu`` and
``paddle_tpu_torch/csrc/paged_chunk.cu``.

The JAX package returns new pools from its writes (functional scatters);
here ``paged_write_token`` and ``paged_write_prefill`` update the pools in
place, which keeps one copy of each pool on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from ._build import KernelValueError
from .flash_attention import KERNEL_HEAD_DIMS

__all__ = ["paged_attention", "paged_attention_reference", "decode_split",
           "chunk_split", "paged_chunk_attention",
           "paged_chunk_attention_reference", "paged_verify_attention",
           "paged_write_token", "paged_write_prefill"]

_NEG_INF = -1e30
_DECODE_MAX_TABLE = 8192    # the widest block table paged_decode takes
_DECODE_SPLIT_KEYS = 256    # keys one block of paged_decode streams
_DECODE_MAX_SPLITS = 128
_CHUNK_SPLIT_KEYS = 256     # keys one block of 16-bit paged_chunk takes
_CHUNK_MAX_SPLITS = 64
_CHUNK_FILL_BLOCKS = 132    # the H100's SMs: fewer blocks split the keys


def decode_split(max_blocks: int, bs: int):
    """``(blocks_per_split, n_split)`` of ``paged_decode`` for a table of
    ``max_blocks`` blocks of ``bs`` keys: splits of about 256 keys (a whole
    number of pool blocks), at most 128 of them.  They come from the
    table's width alone, never from the lengths: those live on the card,
    and reading them would synchronise the host at every layer of every
    decode step."""
    per = max(1, _DECODE_SPLIT_KEYS // bs,
              -(-max_blocks // _DECODE_MAX_SPLITS))
    return per, -(-max_blocks // per)


def chunk_split(B: int, nh: int, s: int, max_blocks: int, bs: int):
    """``(keys_per_split, n_split)`` of bf16 or fp16 ``paged_chunk`` for ``B``
    sequences of ``s`` chunk rows and ``nh`` heads over a table of
    ``max_blocks`` blocks of ``bs`` keys.  A grid of fewer blocks (one per
    sequence x head x 128 rows) than the card has SMs splits the key axis
    into runs of about 256 keys (a multiple of the kernel's 64-key tile, at
    most 64 runs), whose partial states a merge combines; otherwise one
    split covers the whole table.  From the shapes alone, never from the
    starts: they live on the card, and reading them would synchronise the
    host at every layer of every chunk."""
    table_keys = max_blocks * bs
    whole = -(-table_keys // 64) * 64
    if B * nh * -(-s // 128) >= _CHUNK_FILL_BLOCKS:
        return whole, 1
    per = max(_CHUNK_SPLIT_KEYS,
              -(-table_keys // (64 * _CHUNK_MAX_SPLITS)) * 64)
    per = min(-(-per // 64) * 64, whole)
    return per, -(-table_keys // per)


def _check_pool(q, k_cache, v_cache, tables, lens, name):
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise KernelValueError(
            f"{name}: pools must be [nh, num_blocks, bs, hd] "
            f"and alike, got {tuple(k_cache.shape)} and "
            f"{tuple(v_cache.shape)}")
    B, nh, hd = q.shape[0], q.shape[-2], q.shape[-1]
    if k_cache.shape[0] != nh or k_cache.shape[3] != hd:
        raise KernelValueError(f"{name}: q heads/hd ({nh}, {hd}) do not match "
                               f"the pool {tuple(k_cache.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or lens.shape != (B,):
        raise KernelValueError(
            f"{name}: tables {tuple(tables.shape)} and lengths "
            f"{tuple(lens.shape)} must be [{B}, max_blocks] "
            f"and [{B}]")


# ------------------------------------------------------------------ decode

def paged_attention(q, k_cache, v_cache, block_tables, seq_lens):
    """Decode attention: one query token per sequence over its block table.

    q ``[B, nh, hd]``; pools ``[nh, num_blocks, bs, hd]``; block_tables
    ``[B, max_blocks]`` int32 (pad with 0); seq_lens ``[B]`` int32.
    Returns ``[B, nh, hd]``.  Positions ``>= seq_lens[b]`` are masked; a
    row with length 0 gives zeros.  Keys whose table entry lies outside the
    pool are dropped, on the card and on the CPU alike.

    CUDA tensors (float32, bfloat16 or float16, hd in 64/128/256) launch
    ``paged_decode`` (a split kernel over runs of about 256 keys, then a
    merge of their partial softmax states, :func:`decode_split`; one
    launch in the count); CPU tensors take
    :func:`paged_attention_reference`.
    """
    _check_pool(q, k_cache, v_cache, block_tables, seq_lens,
                "paged_attention")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache, block_tables,
                                         seq_lens)
    _build.check_device_tensors("paged_decode", (q, k_cache, v_cache),
                                (block_tables, seq_lens), _build.FP16_DTYPES)
    B, nh, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise KernelValueError(f"paged_decode: head dim {hd} not in "
                               f"{KERNEL_HEAD_DIMS}")
    if block_tables.shape[1] > _DECODE_MAX_TABLE:
        raise KernelValueError(
            f"paged_decode: a table of {block_tables.shape[1]} "
            f"blocks exceeds the kernel's {_DECODE_MAX_TABLE}")
    _, num_blocks, bs, _ = k_cache.shape
    max_blocks = block_tables.shape[1]
    per, n_split = decode_split(max_blocks, bs)
    out = torch.empty_like(q)
    # each split's partial state: acc[hd], m, l
    work = torch.empty((B, nh, n_split, hd + 2), dtype=torch.float32,
                       device=q.device)
    err = _build.library().ptt_paged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, nh, hd, num_blocks, bs, max_blocks, per,
        _build.dtype_code(q.dtype, _build.FP16_DTYPES),
        _build.stream(q.device))
    _build.check(err, "paged_decode")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.plain_calls = 0     # callers' plain routes (plain_route)


def _gather_table(pool, tables):
    """[nh, NB, bs, hd] through [B, maxb] -> [B, maxb * bs, nh, hd] and
    the key positions ``[B, maxb * bs]`` whose table entry lies in the
    pool.  An entry outside the pool is read as block 0 and its keys are
    dropped by the caller, as both kernels drop them."""
    nh, nb, bs, hd = pool.shape
    B, maxb = tables.shape
    t = tables.long()
    in_pool = (t >= 0) & (t < nb)
    g = pool[:, torch.where(in_pool, t, 0)]         # [nh, B, maxb, bs, hd]
    return (g.permute(1, 2, 3, 0, 4).reshape(B, maxb * bs, nh, hd),
            in_pool[:, :, None].expand(B, maxb, bs).reshape(B, maxb * bs))


def paged_attention_reference(q, k_cache, v_cache, block_tables, seq_lens):
    """The plain version of ``paged_decode``: gather every table block,
    masked softmax in float32."""
    B, nh, hd = q.shape
    k, in_pool = _gather_table(k_cache, block_tables)
    v, _ = _gather_table(v_cache, block_tables)
    k, v = k.float(), v.float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) / math.sqrt(hd)
    pos = torch.arange(k.shape[1], device=q.device)
    live = ((pos[None, :] < seq_lens[:, None].long()) & in_pool)[:, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    # length 0: every position masked -> zeros, not a mean over pad rows
    p = torch.where(live, torch.softmax(s, dim=-1), torch.zeros_like(s))
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


# ------------------------------------------------------------------- chunk

def _chunk_checks(q, k_cache, v_cache, block_tables, start_lens, name):
    if q.dim() != 4:
        raise KernelValueError(f"{name}: q must be [B, s, nh, hd], got "
                               f"{tuple(q.shape)}")
    _check_pool(q, k_cache, v_cache, block_tables, start_lens, name)


def _launch_chunk(q, k_cache, v_cache, block_tables, start_lens):
    _build.check_device_tensors("paged_chunk", (q, k_cache, v_cache),
                                (block_tables, start_lens), _build.FP16_DTYPES)
    B, s, nh, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise KernelValueError(f"paged_chunk: head dim {hd} not in "
                               f"{KERNEL_HEAD_DIMS}")
    _, num_blocks, bs, _ = k_cache.shape
    max_blocks = block_tables.shape[1]
    per, n_split, work = 64, 1, None
    if q.dtype != torch.float32:        # the tensor-core kernel
        per, n_split = chunk_split(B, nh, s, max_blocks, bs)
    if n_split > 1:
        # each split's partial states: acc [hd] and (m, l) per row
        work = torch.empty(n_split * B * nh * s * (hd + 2),
                           dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _build.library().ptt_paged_chunk(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), start_lens.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, s, nh, hd,
        num_blocks, bs, max_blocks, per,
        _build.dtype_code(q.dtype, _build.FP16_DTYPES), _build.stream(q.device))
    _build.check(err, "paged_chunk")
    return out


def paged_chunk_attention(q, k_cache, v_cache, block_tables, start_lens):
    """Chunked-prefill attention over the paged pool.

    q ``[B, s, nh, hd]``: chunk queries at absolute positions
    ``start_lens[b] + j``; pools ``[nh, num_blocks, bs, hd]`` with the
    chunk ALREADY written; block_tables ``[B, max_blocks]`` int32;
    start_lens ``[B]`` int32 (the cached prefix length).  Query j attends
    keys ``0 .. start + j`` (offset causal).  Rows past the table attend
    the whole table; the caller discards them.  Keys whose table entry lies
    outside the pool are dropped, as in :func:`paged_attention`.  Returns
    ``[B, s, nh, hd]``.

    CUDA tensors (float32, bfloat16 or float16, hd in 64/128/256) launch
    ``paged_chunk`` (16-bit: ``paged_chunk_tc_kernel`` on the tensor
    cores, its key axis split as :func:`chunk_split` says and the splits
    merged by ``paged_chunk_merge_kernel``, one launch in the count;
    float32: ``paged_chunk_kernel`` on FMAs); CPU tensors take
    :func:`paged_chunk_attention_reference`.
    """
    _chunk_checks(q, k_cache, v_cache, block_tables, start_lens,
                  "paged_chunk_attention")
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(q, k_cache, v_cache,
                                               block_tables, start_lens)
    out = _launch_chunk(q, k_cache, v_cache, block_tables, start_lens)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0
paged_chunk_attention.plain_calls = 0   # callers' plain routes


def paged_verify_attention(q, k_cache, v_cache, block_tables, start_lens):
    """Spec-decode verify attention: the chunk contract with s = k
    candidate positions (``[last, d_1 .. d_{k-1}]`` at each slot's length;
    free slots at start 0 on an all-zero table row), on the same
    ``paged_chunk`` kernel.  It keeps its own launch and plain-route
    counts, apart from :func:`paged_chunk_attention`'s."""
    _chunk_checks(q, k_cache, v_cache, block_tables, start_lens,
                  "paged_verify_attention")
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(q, k_cache, v_cache,
                                               block_tables, start_lens)
    out = _launch_chunk(q, k_cache, v_cache, block_tables, start_lens)
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
paged_verify_attention.plain_calls = 0  # callers' plain routes


def paged_chunk_attention_reference(q, k_cache, v_cache, block_tables,
                                    start_lens):
    """The plain version of ``paged_chunk``: the table linearized, the
    offset causal mask, softmax in float32."""
    B, s, nh, hd = q.shape
    k, in_pool = _gather_table(k_cache, block_tables)  # [B, K, nh, hd]
    v, _ = _gather_table(v_cache, block_tables)
    k, v = k.float(), v.float()
    pos = start_lens[:, None].long() + torch.arange(s, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = (kpos[None, None, :] <= pos[:, :, None]) \
        & in_pool[:, None, :]                          # [B, s, K]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(hd)
    logits = logits.masked_fill(~mask[:, None], _NEG_INF)
    # a row with no key left gives zeros, as the kernel's l == 0 guard does
    probs = torch.softmax(logits, dim=-1) * mask[:, None]
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


# ------------------------------------------------------------------ writes

def paged_write_token(k_pool, v_pool, tables, seq_lens, k_step, v_step):
    """Write one decode token per sequence IN PLACE at position
    ``seq_lens[b]`` through its table.  k_step/v_step ``[B, nh, hd]``.
    A position past the table (a draft model's steps beyond a slot's
    budget) writes the pad block 0."""
    bs = k_pool.shape[2]
    nb = tables.shape[1]
    lens = seq_lens.long()
    rows = torch.arange(k_step.shape[0], device=k_step.device)
    cols = lens // bs
    blk = tables.long()[rows, cols.clamp(max=nb - 1)]
    blk = torch.where(cols < nb, blk, torch.zeros_like(blk))
    off = lens % bs
    k_pool[:, blk, off] = k_step.transpose(0, 1).to(k_pool.dtype)
    v_pool[:, blk, off] = v_step.transpose(0, 1).to(v_pool.dtype)


def paged_write_prefill(k_pool, v_pool, tables, k, v):
    """Bulk prefill write from empty sequences, IN PLACE: k/v
    ``[B, S, nh, hd]`` into each sequence's first ceil(S / bs) table
    blocks.  The tail of the last block is written with zeros and masked
    by the lengths at attend time."""
    bs = k_pool.shape[2]
    B, S, nh, hd = k.shape
    nb = -(-S // bs)
    pad = nb * bs - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    blks = tables[:, :nb].reshape(-1).long()
    k_pool[:, blks] = k.reshape(B * nb, bs, nh, hd).permute(2, 0, 1, 3) \
        .to(k_pool.dtype)
    v_pool[:, blks] = v.reshape(B * nb, bs, nh, hd).permute(2, 0, 1, 3) \
        .to(v_pool.dtype)
