#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port, ``paddle_tpu_torch``.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``paddle_tpu_torch/csrc/`` (at first use,
into ``build/paddle_tpu_torch/``), then runs ten phases on card 0:

1. Kernels against their plain PyTorch versions, at the shapes the serving
   engine and the train step below give them (nh 16, hd 128, block 64,
   batch 8; training B 4 x S 2048 causal), with ``flash_fwd`` also at hd 64
   and 256 and at Sq > Sk (rows that see no key: zeros, lse -1e30), and
   the training cases at Sq > Sk too.  float32: atol 2e-5, rtol 1e-4
   for outputs, atol 1e-4, rtol 1e-4 for gradients.  bfloat16: against the
   plain version computed in float32 on the same bfloat16 inputs, atol
   2e-2, and for gradients also rtol 1e-2 (one bf16 rounding of a
   gradient that sums over a whole sequence).  ``paged_decode`` also at
   the edges of its 256-key splits (255, 256, 257, 511, 512), 0 and the
   full table, and with out-of-pool table entries; the bf16 training
   cases also at hd 64 and 256.  ``paged_chunk`` (bf16:
   ``paged_chunk_tc_kernel`` on the tensor cores, its key axis split)
   with 256-row chunks at many starts and past the table, chunks of 1, 4
   and 70 rows, bs 16, hd 64 and 256, out-of-pool entries, and splits of
   64 .. 512 keys and none around their edges; timed at the serving
   path's shape (B 1, s 256, start 1024) at several split lengths, with
   TFLOP/s and two yardsticks that do not read the pool: ``flash_fwd``
   and ``F.scaled_dot_product_attention`` with the offset-causal mask on
   a contiguous copy of the same keys.  Kernel, plain version and the
   ``F.scaled_dot_product_attention`` yardstick (flash only; for the
   backward pair, sdpa's backward timed on its own) are timed with CUDA
   events (``paged_decode``, whose two kernels take less time than the
   host's launch, from a replayed CUDA graph of 200 calls, beside the eager
   loop's time and its time at other split lengths); the flash lines print
   the achieved TFLOP/s and the ratio to sdpa.  Before it, the
   ``-Xptxas -v`` reports give every kernel's registers and spills; the
   tensor-core kernels (bf16 ``flash_fwd``, ``flash_bwd_dq``,
   ``flash_bwd_dkv``) must not spill at hd 64 and 128.
2. Serving at full width: GPT-3 1.3B in bfloat16 with random weights from a
   seed, 8 requests (prompts of 100 to 1500 tokens, 64 new tokens each,
   half greedy, half sampled) through ``ServingEngine`` with whole-prompt
   prefill, then through a second engine with 256-token chunked prefill.
   Each run starts with every kernel's launch count at 0 and must launch
   its kernels.  A third whole-prompt run under ``torch.profiler`` prints
   the card's busy share, the kernels that take its time, and the decode
   kernels by name (``paged_decode_split_kernel``,
   ``paged_decode_merge_kernel``); a fourth, chunked, profiled the same
   way, in which every bf16 ``paged_chunk`` launch must be
   ``paged_chunk_tc_kernel`` (with ``paged_chunk_merge_kernel`` when the
   keys are split) by name and none the FMA kernel; the profiled runs
   also give ms per decode step (the card synchronised before each
   tick).  No full-width serving or training run may take a plain route
   (``plain_calls``).  Then ``sample_rows`` (the tick's token choice, the
   threefry draw for sampled rows) timed on the card at [8, vocab].
3. Card against CPU: a 4-layer cut of GPT-3 1.3B in float32 serves one
   greedy request on the card (kernels) and on the CPU (plain versions)
   from one state dict; the token streams must match and the first-token
   logits agree to atol 1e-3.
4. Training at full width: GPT-3 1.3B, float32 weights, ``auto_cast`` O1
   bfloat16, AdamW (lr 1e-4, weight decay 0.01) with global-norm clipping
   at 1.0, 6 steps on one fixed batch of B 4 x S 2048 random tokens.  Every
   loss finite, the last below the first, and each flash kernel launched
   exactly 24 x 6 times.  Prints step time, tokens/s, MFU and peak memory,
   then profiles one more step (after an unrecorded warm-up step of the
   profiler), in which every flash launch must be the
   tensor-core kernel by name (24 each of forward, dq and dk/dv, none on
   the FMA kernels), then trains 2 steps with dropout 0.1.
5. Card against CPU for training: a 4-layer fp32 cut, 2 AdamW steps on
   the card (kernels) and on the CPU (plain versions) from one state dict;
   losses within atol 1e-4, parameters within 2 x lr x steps.
6. MoE kernels (in phase 1's run): ``moe_dispatch`` and ``moe_combine``
   against their plain versions in float32 and bfloat16 at the training
   shape (T 8192, M 2048, E 4, k 2, C 2458, routed by the port's GShard
   gate on random tokens: random routing at capacity 1.2 drops choices
   and leaves slots empty), a decode shape (T 8, eval capacity) and every
   choice dropped.  Dispatch exact; combine exact against the plain
   version on the same inputs and within one bf16 rounding (rtol 2^-8)
   of the float32 result.  Timed after phase 8, on the routing, gate
   input and expert rows of the first MoE block in a forward of the
   train step (checked the same way first), in float32 (the training
   path's type) beside ``F.embedding`` and ``F.embedding_bag``, the
   library calls computing the same functions; every MoE block's kept
   choices and filled slots in that forward are printed.
7. GPT-MoE serving at full width: ``gpt3_1p3b(moe_num_experts=4)`` (12 of
   24 blocks MoE, 2.52 B parameters) in bf16, the same 8 requests with
   whole-prompt prefill; flash_fwd, paged_decode and both MoE kernels
   launch, dispatch as often as combine.
8. GPT-MoE training at full width: the same model, phase 4's train step,
   6 steps at B 4 x S 2048 and one profiled step (checked by kernel name
   as in phase 4).  Losses finite and
   falling; each flash kernel launched 24 x 6 times and each MoE kernel
   12 x 6 (the MoE backward runs plain index ops, no kernel).  MFU both
   by 6N + 12LHS over all experts and by the work the step does (each
   expert over its C of the E x C rows).
9. Card against CPU for GPT-MoE: a 4-layer fp32 cut (blocks 1 and 3 MoE)
   serves one greedy request (streams equal, first-token logits atol
   1e-3) and trains 2 AdamW steps with the same routing uniforms fed to
   both (losses atol 1e-4, parameters within 2 x lr x steps).

10. Head dims no kernel takes (run after phase 3): ``gpt3_tiny`` (hd 32)
   serves one greedy request (whole-prompt and chunked prefill) and
   trains 2 AdamW steps on the card through the kernels' plain versions;
   streams equal the CPU's, losses and parameters as in phase 5, every
   plain route counted (``plain_calls``) and no kernel launched.

Any failure raises and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA card is present or the package is not
beside it.  The line before the last is a JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

MEM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"torch.bfloat16": 989e12,   # dense bf16 tensor-core rate
            "torch.float32": 67e12}     # fp32 outside the tensor cores
NH, HD, BS, BATCH, MAX_CONTEXT = 16, 128, 64, 8, 2048
TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 4, 2048, 6, 1e-4
MOE_E = 4                            # experts of the GPT-MoE phases
TOL = {"torch.float32": dict(atol=2e-5, rtol=1e-4),
       "torch.bfloat16": dict(atol=2e-2, rtol=0.0)}
GRAD_TOL = {"torch.float32": dict(atol=1e-4, rtol=1e-4),
            "torch.bfloat16": dict(atol=2e-2, rtol=1e-2)}
# the two kernels of a paged_decode launch, by name on the card's timeline
DECODE_KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")
# paged_chunk's: bf16 on the tensor cores (and the merge of its key
# splits), the FMA kernel only for fp32
CHUNK_KERNELS = ("paged_chunk_tc_kernel", "paged_chunk_merge_kernel",
                 "paged_chunk_kernel")


def _log(*a):
    print(*a, flush=True)


def _time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters):
    """Time of one call of ``fn`` on the card alone: ``iters`` calls
    captured in a CUDA graph and replayed, timed with CUDA events.  For a
    kernel whose launch costs the host more than the card takes, which the
    eager loop of ``_time_ms`` would measure instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, dtype):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_OPS[str(dtype)]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def _compare(name, got, want, dtype, tol=TOL):
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **tol[str(dtype)],
                               msg=lambda m: f"{name} {dtype}: {m}")
    return err


# --------------------------------------------------------------- phase 1

def _pool_case(gen, lens, dtype, extra_cols=0, nh=NH, hd=HD, bs=BS):
    """Pools of random K/V and tables of shuffled blocks, as the engine
    lays them out: [nh, num_blocks, bs, hd], block 0 the pad block, a
    table of MAX_CONTEXT keys per sequence."""
    import numpy as np
    import torch
    B = len(lens)
    maxb = MAX_CONTEXT // bs
    nb = B * maxb + 1
    k = torch.randn((nh, nb, bs, hd), generator=gen, device="cuda")
    v = torch.randn((nh, nb, bs, hd), generator=gen, device="cuda")
    rng = np.random.RandomState(0)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, maxb), np.int32)
    for b, n in enumerate(lens):
        live = min(-(-(n + extra_cols) // bs), maxb)
        tables[b, :live] = perm[b * maxb:b * maxb + live]
    return (k.to(dtype), v.to(dtype),
            torch.as_tensor(tables, device="cuda"))


def kernel_checks(path_lens):
    """Each kernel against its plain version; returns per-kernel numbers
    (times of the bfloat16 case at the main path's shapes)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    bf16 = torch.bfloat16

    # --- paged_decode: edge lengths (0, block edges, the edges of the
    # 256-key splits, full table), the same with out-of-pool table entries
    # (dropped keys), then the main path's lengths (the prompts, 32
    # tokens into decoding)
    edge = [0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 1000, 2047, 2048]
    path = [n + 32 for n in path_lens]
    for dtype in (torch.float32, bf16):
        for lens, bad in ((edge, False), (edge, True), (path, False)):
            k, v, tables = _pool_case(gen, lens, dtype)
            if bad:                 # rows 256, 511 and 2048: dropped keys
                tables[6, 2], tables[8, 7], tables[12, 20] = -1, -1, 10 ** 6
            q = torch.randn((len(lens), NH, HD), generator=gen,
                            device="cuda").to(dtype)
            sl = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
            out = pa.paged_attention(q, k, v, tables, sl)
            ref = pa.paged_attention_reference(q.float(), k.float(),
                                               v.float(), tables, sl)
            torch.cuda.synchronize()
            err = _compare("paged_decode", out, ref, dtype)
            if lens[0] == 0 and out[0].abs().max().item() != 0.0:
                raise AssertionError("paged_decode: a len-0 row is not zero")
            _log(f"paged_decode {dtype} lens={lens}"
                 + (" out-of-pool entries" if bad else "")
                 + f": max_abs_err={err:.3e}")
    e = 2
    nbytes = (2 * BATCH * NH * HD + sum(path) * NH * HD * 2) * e \
        + tables.numel() * 4 + BATCH * 4
    flops = 4 * NH * HD * sum(path)
    # its two kernels take less than the host's launch (workspace, ctypes):
    # the card's time from a replayed CUDA graph, the eager loop's beside
    # it as host_ms
    def decode():
        return pa.paged_attention(q, k, v, tables, sl)

    ms = _graph_ms(decode, 200)
    host_ms = _time_ms(decode, 200)
    plain = _time_ms(lambda: pa.paged_attention_reference(
        q, k, v, tables, sl), 10)
    bound, by = _bound(nbytes, flops, bf16)
    # the same launch at other split lengths (the wrapper's keys per
    # split; the table's 32 blocks of 64 keys)
    by_split = {}
    default = pa._DECODE_SPLIT_KEYS
    try:
        for keys in (64, 128, 256, 512):
            pa._DECODE_SPLIT_KEYS = keys
            by_split[keys] = _graph_ms(decode, 200)
    finally:
        pa._DECODE_SPLIT_KEYS = default
    _log(f"paged_decode bf16 card ms by keys per split (default "
         f"{default}): " + ", ".join(f"{n}: {t:.4f}"
                                     for n, t in by_split.items()))
    rows["paged_decode"] = dict(max_abs_err=err, ms=ms, host_ms=host_ms,
                                plain_ms=plain, bound_ms=bound, bound_by=by,
                                library_ms=None,
                                ms_by_split_keys=by_split)

    # --- flash_fwd: the largest prefill bucket (one 2048-token prompt),
    # a ragged length, a GQA group, Sq < Sk, hd 64 and 256, and Sq > Sk
    # (its first Sq - Sk rows see no key: zeros, lse -1e30)
    cases = [(1, 2048, 2048, NH, NH, HD), (2, 1000, 1000, NH, NH, HD),
             (1, 300, 1000, NH, 4, HD), (1, 2048, 2048, 2 * NH, 2 * NH, 64),
             (1, 1000, 1000, NH // 2, NH // 4, 256),
             (2, 700, 300, NH, NH, HD)]
    for dtype in (torch.float32, bf16):
        for B, Sq, Sk, nh, nkv, hd in cases:
            q = torch.randn((B, Sq, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn((B, Sk, nkv, hd), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((B, Sk, nkv, hd), generator=gen,
                            device="cuda").to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            ref, ref_lse = fa.flash_attention_fwd_reference(
                q.float(), k.float(), v.float(), causal=True)
            torch.cuda.synchronize()
            err = _compare("flash_fwd", out, ref, dtype)
            lerr = _compare("flash_fwd lse", lse, ref_lse, dtype)
            if Sq > Sk and (out[:, :Sq - Sk].abs().max().item() != 0.0 or
                            (lse[..., :Sq - Sk] != -1e30).any().item()):
                raise AssertionError("flash_fwd: rows that see no key are "
                                     "not zeros with lse -1e30")
            _log(f"flash_fwd {dtype} B={B} Sq={Sq} Sk={Sk} nh={nh} "
                 f"nkv={nkv} hd={hd}: max_abs_err={err:.3e} "
                 f"lse_err={lerr:.3e}")
            if (dtype, B, Sq, hd) == (bf16, 1, 2048, HD):
                timed = (q, k, v, err)
    q, k, v, err = timed
    S = q.shape[1]
    nbytes = 4 * S * NH * HD * 2 + NH * S * 4
    flops = 4 * HD * NH * S * (S + 1) // 2
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True), 20)
    plain = _time_ms(lambda: fa.flash_attention_fwd_reference(
        q, k, v, causal=True), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    bound, by = _bound(nbytes, flops, bf16)
    rows["flash_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=lib,
                             tflops=flops / ms / 1e9)

    rows["paged_chunk"] = paged_chunk_checks(gen)
    for name, r in rows.items():
        _log(f"{name} bf16 timing: ms={r['ms']:.4f}"
             + (f" (host loop {r['host_ms']:.4f})" if "host_ms" in r else "")
             + f" plain_ms="
             f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
             f"({r['bound_by']}) library_ms={r['library_ms']}"
             + _rate(r))
    return rows


def _chunk_case(gen, starts, s, dtype, bad=False, **shape):
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    nh, hd = shape.get("nh", NH), shape.get("hd", HD)
    k, v, tables = _pool_case(gen, starts, dtype, extra_cols=s, **shape)
    if bad:            # dropped keys: an entry below and one past the pool
        tables[0, 0], tables[-1, 1] = -1, 10 ** 6
    q = torch.randn((len(starts), s, nh, hd), generator=gen,
                    device="cuda").to(dtype)
    st = torch.as_tensor(starts, dtype=torch.int32, device="cuda")
    out = pa.paged_chunk_attention(q, k, v, tables, st)
    ref = pa.paged_chunk_attention_reference(q.float(), k.float(), v.float(),
                                             tables, st)
    torch.cuda.synchronize()
    return (q, k, v, tables, st), _compare("paged_chunk", out, ref, dtype)


def paged_chunk_checks(gen):
    """paged_chunk against its plain version (fp32 on the FMA kernel,
    bf16 on the tensor-core kernel, its keys split as the wrapper picks),
    then timed at the serving path's shape, one sequence, a 256-token
    chunk at start 1024, beside the same work without the table: the
    port's flash_fwd (Sq 256, Sk 1280, causal: its end-aligned mask is
    this offset mask) and scaled_dot_product_attention with the boolean
    offset-causal mask, both on a contiguous copy of the same keys.
    Returns the kernel's numbers."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    bf16 = torch.bfloat16
    # (label, starts, s, pool shape): 256-row chunks at many starts and one
    # running past the table (its rows attend the whole table), verify-
    # sized and ragged chunks, bs 16, hd 64 and 256, dropped keys
    cases = [("serving chunks", [0, 64, 100, 256, 700, 1000, 1500, 1792],
              256, {}),
             ("past the table", [1900], 256, {}),
             ("s 1", [0, 5, 1023, 2047], 1, {}),
             ("s 4", [0, 61, 700, 2046], 4, {}),
             ("s 70", [0, 37, 190, 1990], 70, {}),
             ("bs 16", [0, 100, 1024, 1900], 256, dict(bs=16)),
             ("hd 64", [0, 300, 1024], 256, dict(nh=2 * NH, hd=64)),
             ("hd 256", [0, 300, 1024], 256, dict(nh=NH // 2, hd=256))]
    for dtype in (torch.float32, bf16):
        for label, starts, s, shape in cases:
            for bad in (False, True):
                _, err = _chunk_case(gen, starts, s, dtype, bad, **shape)
                _log(f"paged_chunk {dtype} {label} s={s} starts={starts} "
                     f"{shape or ''}" + (" out-of-pool entries" if bad
                                         else "")
                     + f": max_abs_err={err:.3e}")
    # the split's edges: splits of 64 .. 512 keys and none; rows whose
    # keys end one before, at and one past a split edge, a chunk inside
    # the first split, splits past every row's keys
    default = pa._CHUNK_SPLIT_KEYS
    try:
        for keys in (64, 128, 512, 1 << 30):
            pa._CHUNK_SPLIT_KEYS = keys
            for dtype in (torch.float32, bf16):
                _, err = _chunk_case(gen, [0, 187, 441, 953], 70, dtype,
                                     bad=True)
                _log(f"paged_chunk {dtype} split edges, {keys} keys per "
                     f"split: max_abs_err={err:.3e}")
    finally:
        pa._CHUNK_SPLIT_KEYS = default

    # the serving path's shape
    (q, k, v, tables, st), err = _chunk_case(gen, [1024], 256, bf16)
    s, start = 256, 1024
    keys = [min(start + j + 1, MAX_CONTEXT) for j in range(s)]
    nbytes = 2 * s * NH * HD * 2 + min(start + s, MAX_CONTEXT) * NH * HD \
        * 2 * 2 + tables.numel() * 4 + 4
    flops = 4 * NH * HD * sum(keys)

    def chunk():
        return pa.paged_chunk_attention(q, k, v, tables, st)

    ms = _time_ms(chunk, 50)
    plain = _time_ms(lambda: pa.paged_chunk_attention_reference(
        q, k, v, tables, st), 5)
    bound, by = _bound(nbytes, flops, bf16)
    by_split = {}
    try:
        for n in (128, 256, 512, 1 << 30):
            pa._CHUNK_SPLIT_KEYS = n
            label = "none" if n == 1 << 30 else n
            by_split[label] = (_time_ms(chunk, 50), pa.chunk_split(
                1, NH, s, tables.shape[1], BS)[1])
    finally:
        pa._CHUNK_SPLIT_KEYS = default
    _log(f"paged_chunk bf16 path shape ms by keys per split (default "
         f"{default}): " + ", ".join(f"{n} ({sp} splits): {t:.4f}"
                                     for n, (t, sp) in by_split.items()))
    # yardsticks without the table: the same keys, contiguous
    kc, _ = pa._gather_table(k, tables)
    vc, _ = pa._gather_table(v, tables)
    kc, vc = kc[:, :start + s].contiguous(), vc[:, :start + s].contiguous()
    want = chunk()
    got = fa.flash_attention_fwd(q, kc, vc, causal=True)[0]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=0.0)
    flash_ms = _time_ms(lambda: fa.flash_attention_fwd(q, kc, vc,
                                                       causal=True), 50)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    allowed = (torch.arange(start + s, device="cuda")[None, :]
               <= start + torch.arange(s, device="cuda")[:, None])
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
    torch.testing.assert_close(sdpa.transpose(1, 2).float(), want.float(),
                               atol=2e-2, rtol=0.0)
    sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed), 50)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
               bound_by=by, library_ms=None, tflops=flops / ms / 1e9,
               ms_by_split_keys={str(n): t for n, (t, _) in
                                 by_split.items()},
               yardsticks_without_table={
                   "flash_fwd_contiguous_ms": flash_ms,
                   "sdpa_offset_causal_mask_ms": sdpa_ms})
    _log(f"paged_chunk bf16 path shape B=1 s={s} start={start} nh={NH} "
         f"hd={HD}: {flops / 1e9:.3f} GFLOP on {nbytes / 1e6:.2f} MB, "
         f"{row['tflops']:.1f} TFLOP/s, {ms / bound:.1f}x the bound; not "
         f"reading the pool (contiguous copy of the same keys): flash_fwd "
         f"Sq 256 Sk 1280 causal {flash_ms:.4f} ms, sdpa with the offset-"
         f"causal mask {sdpa_ms:.4f} ms")
    return row


def _rate(r):
    """Achieved TFLOP/s and the ratio to the library call, where there
    are both."""
    if r.get("tflops") is None or r.get("library_ms") is None:
        return ""
    return (f"; {r['tflops']:.1f} TFLOP/s, {r['ms'] / r['library_ms']:.2f}x "
            "the library call")


def _train_flash_case(gen, B, Sq, Sk, nkv, dtype, masked, hd=HD):
    import torch
    q = torch.randn((B, Sq, NH, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, nkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, nkv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, Sq, NH, hd), generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, Sk), generator=gen, device="cuda")
                > 0.2).int()
        mask[-1] = 0                    # a batch row that sees no key
    return q, k, v, do, mask


def flash_train_checks(rows):
    """flash_fwd (with its kv mask and dropout), flash_bwd_dq and
    flash_bwd_dkv against their plain versions; times at the training
    shape (bf16, B 4, S 2048, causal).  Updates ``rows``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    # (label, B, Sq, Sk, nkv, causal, masked, dropout rate)
    cases = [("training shape", TRAIN_B, TRAIN_S, TRAIN_S, NH, True, False,
              0.0),
             ("ragged", 2, 1000, 1000, NH, True, False, 0.0),
             ("GQA", 1, 1024, 1024, 4, True, False, 0.0),
             ("Sq < Sk", 2, 300, 1000, NH, True, False, 0.0),
             ("Sq > Sk", 2, 1000, 300, NH, True, False, 0.0),
             ("kv mask", 2, 512, 512, NH, False, True, 0.0),
             ("dropout 0.1", 2, 1024, 1024, NH, True, False, 0.1)]
    # every case at hd 128 in both types, and bf16 (the tensor-core
    # kernels) at hd 64 and 256 too, the training shape aside
    runs = [(dtype, HD, case) for dtype in (torch.float32, bf16)
            for case in cases]
    runs += [(bf16, hd, case) for hd in (64, 256) for case in cases[1:]]
    for dtype, hd, (label, B, Sq, Sk, nkv, causal, masked, rate) in runs:
        q, k, v, do, mask = _train_flash_case(gen, B, Sq, Sk, nkv, dtype,
                                              masked, hd)
        args = (causal, mask, rate, 12345)
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, *args)
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), *args)
        want = fa.flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), out.float(), lse,
            do.float(), *args)
        torch.cuda.synchronize()
        errs = [_compare("flash_fwd", out, ref, dtype),
                _compare("flash_fwd lse", lse, ref_lse, dtype)]
        for name, got, w in (("flash_bwd_dq dq", dq, want[0]),
                             ("flash_bwd_dkv dk", dk, want[1]),
                             ("flash_bwd_dkv dv", dv, want[2])):
            errs.append(_compare(name, got, w, dtype, GRAD_TOL))
        if masked and (out[-1].abs().max().item() != 0.0
                       or dk[-1].abs().max().item() != 0.0
                       or dv[-1].abs().max().item() != 0.0):
            raise AssertionError("flash: a fully masked batch row is "
                                 "not zero")
        _log(f"flash train {label} {dtype} B={B} Sq={Sq} Sk={Sk} "
             f"nkv={nkv} hd={hd} causal={causal} rate={rate}: "
             f"max_abs_err out="
             f"{errs[0]:.3e} lse={errs[1]:.3e} dq={errs[2]:.3e} "
             f"dk={errs[3]:.3e} dv={errs[4]:.3e}")
        if (dtype, label) == (bf16, "training shape"):
            timed = (q, k, v, do, out, lse, errs)
        del q, k, v, do, out, lse, dq, dk, dv, ref, ref_lse, want
        torch.cuda.empty_cache()

    q, k, v, do, out, lse, errs = timed
    B, S, e = TRAIN_B, TRAIN_S, 2
    pairs = B * NH * S * (S + 1) // 2            # causal (query, key) pairs
    qbytes = B * S * NH * HD * e                 # one tensor like q
    lse_b = B * NH * S * 4
    plain_fwd = _time_ms(lambda: fa.flash_attention_fwd_reference(
        q, k, v, True), 3)
    fwd = dict(ms=_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 10),
               plain_ms=plain_fwd, max_abs_err=errs[0])
    fwd["bound_ms"], fwd["bound_by"] = _bound(4 * qbytes + lse_b,
                                              4 * HD * pairs, bf16)
    fwd["tflops"] = 4 * HD * pairs / fwd["ms"] / 1e9
    dq = dict(ms=_time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, out, lse, do, True), 10),
        plain_ms=_time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, True, parts=("dq",)), 3),
        max_abs_err=errs[2])
    dq["bound_ms"], dq["bound_by"] = _bound(6 * qbytes + lse_b,
                                            6 * HD * pairs, bf16)
    dq["tflops"] = 6 * HD * pairs / dq["ms"] / 1e9
    dkv = dict(ms=_time_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, out, lse, do, True), 10),
        plain_ms=_time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, True, parts=("dkv",)), 3),
        max_abs_err=max(errs[3], errs[4]))
    dkv["bound_ms"], dkv["bound_by"] = _bound(7 * qbytes + lse_b,
                                              8 * HD * pairs, bf16)
    dkv["tflops"] = 8 * HD * pairs / dkv["ms"] / 1e9
    # the library yardstick: scaled_dot_product_attention forward, and its
    # backward on its own for the pair (autograd.grad on one forward kept
    # alive)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 10)
    fwd["library_ms"] = lib_fwd
    dq["library_ms"] = dkv["library_ms"] = lib_bwd
    # the same kernels with dropout 0.1: the keep bits' cost
    drop = (True, None, 0.1, 12345)
    fwd["dropout_ms"] = _time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, *drop), 10)
    dq["dropout_ms"] = _time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, out, lse, do, *drop), 10)
    dkv["dropout_ms"] = _time_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, out, lse, do, *drop), 10)
    # hd 256 splits dK/dV's columns over two blocks that each recompute
    # S^T and dP^T: its cost at the training shape's operations (nh 8)
    x256 = [torch.randn((B, S, NH // 2, 256), generator=gen,
                        device="cuda").to(bf16) for _ in range(4)]
    o256, lse256 = fa.flash_attention_fwd(*x256[:3], True)
    dkv["hd256_ms"] = _time_ms(lambda: fa.flash_attention_bwd_dkv(
        *x256[:3], o256, lse256, x256[3], True), 10)
    del x256, o256, lse256
    dq["library_covers"] = dkv["library_covers"] = (
        "dq+dkv: scaled_dot_product_attention's backward on its own")
    fwd["serving"] = {key: rows["flash_fwd"][key] for key in
                      ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "max_abs_err", "tflops")}
    rows["flash_fwd"] = fwd
    rows["flash_bwd_dq"] = dq
    rows["flash_bwd_dkv"] = dkv
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = rows[name]
        _log(f"{name} bf16 timing B={B} S={S} causal: ms={r['ms']:.4f} "
             f"(dropout 0.1: {r['dropout_ms']:.4f}) "
             f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
             f"({r['bound_by']}) library_ms={r['library_ms']:.4f}"
             + (f" (sdpa backward, dq+dkv); {r['tflops']:.1f} TFLOP/s"
                if "library_covers" in r else _rate(r)))
    _log(f"flash_bwd_dkv bf16 at nh 8 x hd 256 (the same operations): "
         f"{dkv['hd256_ms']:.4f} ms, {dkv['hd256_ms'] / dkv['ms']:.2f}x hd "
         "128")
    pair = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    _log(f"flash_bwd_dq + flash_bwd_dkv = {pair:.4f} ms beside the sdpa "
         f"backward on its own {lib_bwd:.4f} ms: {pair / lib_bwd:.2f}x")
    del timed, q, k, v, do, out, lse, qt, kt, vt, lib_out
    torch.cuda.empty_cache()


def _moe_case(T, M, training, seed):
    """Routing of T random tokens by the port's GShard gate on the card
    (the training or eval capacity; random routing in training), and
    random expert rows.  At the training capacity 1.2 random routing
    alone drops choices and leaves slots empty."""
    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    from paddle_tpu_torch.ops import moe as mo
    gen = torch.Generator().manual_seed(seed)
    gate = GShardGate(M, MOE_E, generator=gen).cuda().train(training)
    x = torch.randn((T, M), generator=gen).cuda()
    with torch.no_grad():
        eid, slot, keep, w, cap, _ = gate.forward_indices(x)
    flat, inv = mo.routing_indices(eid, slot, keep, MOE_E, cap)
    rows = torch.randn((MOE_E * cap, M), generator=gen).cuda()
    return x, rows, w, flat, inv, cap


def _moe_exact(label, x, r, w, flat, inv):
    """Dispatch and combine against their plain versions on the same
    inputs (both exact), and the combine within one bf16 rounding of the
    float32 sum (exact in float32); returns the first two errors."""
    import torch
    from paddle_tpu_torch.ops import moe as mo
    out = mo.moe_dispatch(x, inv)
    got = mo.moe_combine(r, w, flat)
    want = mo.moe_combine_reference(r, w, flat)
    want32 = mo.moe_combine_reference(r.float(), w, flat)
    torch.cuda.synchronize()
    errs = ((out.float() - mo.moe_dispatch_reference(x, inv).float())
            .abs().max().item(),
            (got.float() - want.float()).abs().max().item())
    if errs != (0.0, 0.0):
        raise AssertionError(f"moe {label} {x.dtype}: dispatch and combine "
                             f"differ from their plain versions by {errs}")
    torch.testing.assert_close(
        got.float(), want32, atol=0.0,
        rtol=0.0 if x.dtype == torch.float32 else 2.0 ** -8,
        msg=lambda msg: f"moe_combine {label} {x.dtype}: {msg}")
    return errs, (got.float() - want32).abs().max().item()


def moe_kernel_checks():
    """moe_dispatch and moe_combine against their plain versions at the
    training shape, a decode shape and every choice dropped (they are
    timed on the train step's own routing, ``moe_kernel_timing``)."""
    import torch
    from paddle_tpu_torch.ops import moe as mo

    cases = [("training shape", TRAIN_B * TRAIN_S, 2048, True),
             ("decode shape", BATCH, 2048, False)]
    for label, t, m, training in cases:
        x32, r32, w, flat, inv, cap = _moe_case(t, m, training, 3)
        EC = MOE_E * cap
        n_empty = int((inv == t).sum())
        n_drop = int((flat == EC).sum())
        for dtype in (torch.float32, torch.bfloat16):
            _, err = _moe_exact(label, x32.to(dtype), r32.to(dtype), w, flat,
                                inv)
            _log(f"moe {label} {dtype} T={t} M={m} C={cap}: dispatch "
                 f"exact, combine exact vs plain, max_abs_err vs fp32 "
                 f"{err:.3e}; {n_drop} of {flat.numel()} choices dropped, "
                 f"{n_empty} of {EC} slots empty")
    # every choice dropped
    none_flat = torch.full_like(flat, EC)
    if mo.moe_combine(r32, w, none_flat).any() or \
            mo.moe_dispatch(x32, torch.full_like(inv, t)).any():
        raise AssertionError("moe: every choice dropped is not zeros")
    _log("moe every choice dropped: zeros")
    del x32, r32, w, flat, inv, none_flat
    torch.cuda.empty_cache()


def moe_kernel_timing(rows_out, rec):
    """moe_dispatch and moe_combine timed on the first MoE block's
    routing, gate input and expert rows from a forward of the train step
    (``_record_routing``), beside their plain versions and ``F.embedding``
    / ``F.embedding_bag``; float32, the training path's type, and bf16.
    Updates ``rows_out``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import moe as mo

    x, r, w, flat, inv, cap = (rec[k] for k in ("x", "rows", "w", "flat",
                                                "inv", "cap"))
    (T, M), EC, e = x.shape, MOE_E * cap, 4
    errs, _ = _moe_exact("train step routing", x, r, w, flat, inv)
    xb, rb = x.to(torch.bfloat16), r.to(torch.bfloat16)
    _moe_exact("train step routing", xb, rb, w, flat, inv)
    filled = int((inv < T).sum())
    kept = int((flat < EC).sum())
    x_pad = torch.cat([x, x.new_zeros((1, M))])
    r_pad = torch.cat([r, r.new_zeros((1, M))])
    lib = F.embedding_bag(flat.long(), r_pad, per_sample_weights=w,
                          mode="sum")
    torch.testing.assert_close(lib, mo.moe_combine(r, w, flat), atol=1e-5,
                               rtol=1e-5)
    disp = dict(ms=_time_ms(lambda: mo.moe_dispatch(x, inv), 50),
                plain_ms=_time_ms(lambda: mo.moe_dispatch_reference(x, inv),
                                  10),
                library_ms=_time_ms(lambda: F.embedding(inv.long(), x_pad),
                                    50),
                max_abs_err=errs[0],
                library_call="F.embedding(inv, x_pad)",
                rows_filled=filled, rows=EC)
    disp["bound_ms"], disp["bound_by"] = _bound(
        (filled + EC) * M * e + EC * 4, 0, torch.float32)
    comb = dict(ms=_time_ms(lambda: mo.moe_combine(r, w, flat), 50),
                plain_ms=_time_ms(lambda: mo.moe_combine_reference(r, w,
                                                                   flat), 10),
                library_ms=_time_ms(lambda: F.embedding_bag(
                    flat.long(), r_pad, per_sample_weights=w, mode="sum"),
                    50),
                max_abs_err=errs[1],
                library_call="F.embedding_bag(flat, rows_pad, "
                             "per_sample_weights=w, mode='sum')",
                choices_kept=kept, choices=flat.numel())
    comb["bound_ms"], comb["bound_by"] = _bound(
        (kept + T) * M * e + flat.numel() * 8, 2 * kept * M, torch.float32)
    disp["bf16_ms"] = _time_ms(lambda: mo.moe_dispatch(xb, inv), 50)
    comb["bf16_ms"] = _time_ms(lambda: mo.moe_combine(rb, w, flat), 50)
    rows_out["moe_dispatch"] = disp
    rows_out["moe_combine"] = comb
    for name in ("moe_dispatch", "moe_combine"):
        r_ = rows_out[name]
        _log(f"{name} fp32 timing on the train step's block-1 routing "
             f"T={T} M={M} E={MOE_E} C={cap} ({kept} of {flat.numel()} "
             f"choices kept, {filled} of {EC} slots filled): ms="
             f"{r_['ms']:.4f} (bf16 {r_['bf16_ms']:.4f}) plain_ms="
             f"{r_['plain_ms']:.4f} bound_ms={r_['bound_ms']:.4f} "
             f"({r_['bound_by']}) library_ms={r_['library_ms']:.4f} "
             f"({r_['library_call']})")
    del x, r, w, flat, inv, x_pad, r_pad, xb, rb, lib
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 2

def _counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import moe as mo
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"flash_fwd": fa.flash_attention_fwd,
            "paged_decode": pa.paged_attention,
            "paged_chunk": pa.paged_chunk_attention,
            "moe_dispatch": mo.moe_dispatch,
            "moe_combine": mo.moe_combine}


def _plain_counters():
    """The callers' plain routes (head dims no kernel takes), counted
    apart from the launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"flash_fwd": fa.flash_attention_fwd,
            "paged_decode": pa.paged_attention,
            "paged_chunk": pa.paged_chunk_attention}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0
    for fn in _plain_counters().values():
        fn.plain_calls = 0


def _plain_calls():
    return {name: fn.plain_calls for name, fn in _plain_counters().items()}


def serve(model, prompts, chunk, time_ticks=False):
    """Serve the 8 requests on one engine, every launch count and plain
    route count at 0 first; returns the run's numbers.  ``time_ticks``
    synchronises the card before each decode tick and sums the ticks' wall
    time (each tick ends in a host round trip), for ms per decode step
    beside chunked prefill."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    eng = ServingEngine(model, max_batch=BATCH, max_context=MAX_CONTEXT,
                        block_size=BS, steps_per_tick=8,
                        prefill_chunk=chunk, device="cuda")
    reqs = [Request(p, max_new_tokens=64, do_sample=bool(i % 2),
                    temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i)
            for i, p in enumerate(prompts)]
    tick_s = [0.0]
    if time_ticks:
        tick = eng._tick

        def timed_tick(k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tick(k)
            tick_s[0] += time.perf_counter() - t
            return out
        eng._tick = timed_tick
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    plain = _plain_calls()
    if any(plain.values()):
        raise AssertionError(f"serving at full width took plain routes: "
                             f"{plain}")
    vocab = model.cfg.vocab_size
    for r in reqs:
        if not r.done or len(r.output_ids) != 64:
            raise AssertionError(f"request {r.rid}: {len(r.output_ids)} of "
                                 "64 tokens")
        if not all(0 <= t < vocab for t in r.output_ids):
            raise AssertionError(f"request {r.rid}: token out of range")
    st = eng.stats()
    if st["free_blocks"] != eng.num_blocks or st["reserved"] != 0:
        raise AssertionError(f"blocks leaked: {st}")
    n_tok = sum(len(r.output_ids) for r in reqs)
    ttfts = [r.t_first - r.t_enqueue for r in reqs]
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                ttft_mean_s=sum(ttfts) / len(ttfts),
                ttft_max_s=max(ttfts), steps=st["steps"], ticks=st["ticks"],
                prefill_chunks=st["prefill_chunks"], launches=launches,
                plain_calls=plain, tick_s=tick_s[0],
                streams=[list(r.output_ids) for r in reqs])


def serving_phase(lens):
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    runs = {}
    for label, chunk, need in (("whole-prompt prefill", 0,
                                ("flash_fwd", "paged_decode")),
                               ("256-token chunked prefill", 256,
                                ("paged_chunk", "paged_decode"))):
        run = serve(model, prompts, chunk)
        for name in need:
            if run["launches"][name] <= 0:
                raise AssertionError(f"{label}: {name} never launched")
        _log(f"serving gpt3_1p3b bf16, {label}: {run['tokens']} tokens in "
             f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s, "
             f"mean TTFT {run['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
             f"{run['ttft_max_s'] * 1e3:.1f} ms, {run['steps']} decode "
             f"steps in {run['ticks']} ticks, {run['prefill_chunks']} "
             f"chunks, launches {run['launches']}")
        runs[chunk] = run
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(runs[0]["streams"],
                                      runs[256]["streams"]))
    _log(f"streams equal across the two prefill modes: {same} of {BATCH} "
         "(bf16 numerics of two attention kernels; informational)")
    for chunk in (0, 256):
        where_the_time_goes(model, prompts, chunk)
    sampling_cost(cfg.vocab_size)
    return runs


def sampling_cost(vocab):
    """The decode tick's token choice on the card at the serving batch:
    ``sample_rows`` over [8, vocab] logits with the engine's filters, four
    rows sampled (the threefry draw) and none (the argmax alone); CUDA
    events over an eager loop, as the tick runs it."""
    import torch
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.models.generation import sample_rows

    gen = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn((BATCH, vocab), generator=gen, device="cuda")
    on = torch.arange(BATCH, device="cuda") % 2 == 1
    args = (torch.full((BATCH,), 0.9, device="cuda"),
            torch.full((BATCH,), 40, device="cuda"),
            torch.full((BATCH,), 0.95, device="cuda"))
    keys = torch.stack(threefry.fold_in(
        threefry.key(1000 + torch.arange(BATCH)),
        torch.full((BATCH,), 17))).cuda()
    sampled = _time_ms(lambda: sample_rows(logits, on, *args, keys, True),
                       50)
    greedy = _time_ms(lambda: sample_rows(logits, torch.zeros_like(on),
                                          *args, None, False), 50)
    _log(f"sample_rows on the card, [{BATCH}, {vocab}] logits: 4 rows "
         f"sampled (filters + threefry draw) {sampled:.4f} ms, all greedy "
         f"{greedy:.4f} ms (CUDA events over an eager loop of 50)")


def _device_kernels(prof):
    """The profile's kernels on the card, without the ranges that
    ``record_function`` marks on the card's timeline (the optimizer's step,
    for one): those overlap the kernels they enclose."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _profiled(fn, warm):
    """``fn()`` under ``torch.profiler`` after a warm-up cycle that runs
    ``warm()`` with the card's tracing already on and discards its
    records (a cycle's first kernel records can otherwise go missing: a
    profiled train step once showed 23 of its 24 forward launches).
    Returns ``fn``'s result and the active cycle's kernels on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    return out, _device_kernels(prof)


def _by_name(kernels, names):
    """Launches and device time (us) of the kernels whose names contain
    each of ``names``."""
    out = {}
    for name in names:
        hits = [e for e in kernels if name in e.key]
        out[name] = (sum(e.count for e in hits),
                     sum(e.self_device_time_total for e in hits))
    return out


def where_the_time_goes(model, prompts, chunk):
    """A profiled serving run (warm) with whole-prompt (``chunk`` 0) or
    chunked prefill: the card's busy time against the wall clock, the
    kernels that take it, the decode kernels by name and, chunked, every
    bf16 paged_chunk launch by name: the tensor-core kernel (and its
    merge when the wrapper splits the keys), never the FMA kernel."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa

    label = "chunked" if chunk else "whole-prompt"
    run, kernels = _profiled(
        lambda: serve(model, prompts, chunk, time_ticks=True),
        lambda: torch.ones((256, 256), device="cuda").matmul(
            torch.ones((256, 256), device="cuda")))
    busy_us = sum(e.self_device_time_total for e in kernels)
    n = sum(e.count for e in kernels)
    wall = run["wall_s"]
    step_ms = run["tick_s"] / max(run["steps"], 1) * 1e3
    _log(f"profiled {label} run: {run['steps']} decode steps in "
         f"{run['tick_s']:.3f} s of ticks = {step_ms:.2f} ms per decode "
         f"step (card synchronised before each tick); max TTFT "
         f"{run['ttft_max_s']:.3f} s")
    idle = 1 - busy_us / 1e6 / wall
    _log(f"profiled {label} run: wall {wall:.3f} s, card busy "
         f"{busy_us / 1e6:.3f} s in {n} kernel launches, idle share "
         f"{idle:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
             f"{e.key[:90]}")
    decode = _by_name(kernels, DECODE_KERNELS)
    for name, (c, _) in decode.items():
        if c == 0:
            raise AssertionError(f"profiled {label} run: {name} never ran")
    _log(f"profiled {label} run, decode kernels by name: " + ", ".join(
        f"{n} {c}x {us / 1e3:.2f} ms" for n, (c, us) in decode.items()))
    if chunk:
        calls = run["launches"]["paged_chunk"]
        split = pa.chunk_split(1, NH, chunk, MAX_CONTEXT // BS, BS)[1] > 1
        got = _by_name(kernels, CHUNK_KERNELS)
        want = {"paged_chunk_tc_kernel": calls,
                "paged_chunk_merge_kernel": calls if split else 0,
                "paged_chunk_kernel": 0}
        if {k: c for k, (c, _) in got.items()} != want or calls == 0:
            raise AssertionError(f"profiled chunked run: paged_chunk "
                                 f"launches by kernel {got}, want {want}")
        chunk_us = sum(us for c, us in got.values())
        _log(f"profiled chunked run, paged_chunk kernels by name: "
             + ", ".join(f"{n} {c}x {us / 1e3:.2f} ms"
                         for n, (c, us) in got.items())
             + f"; {chunk_us / 1e3:.2f} ms of device time in {calls} "
             f"launches")


# --------------------------------------------------------------- phase 3

def card_vs_cpu(cfg, label="gpt3_1p3b 4 layers fp32"):
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cpu = GPTForCausalLM(cfg, device="cpu", seed=1).eval()
    card = GPTForCausalLM(cfg, device="cuda", seed=2).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (96,), generator=gen)
    streams, first = [], []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        eng = ServingEngine(model, max_batch=1, max_context=128,
                            block_size=BS, steps_per_tick=8, device=dev)
        req = eng.add_request(Request(prompt.tolist(), max_new_tokens=16))
        eng.run()
        streams.append(list(req.output_ids))
        caches = model.init_caches(1, 128, BS)
        with torch.no_grad():
            logits, _ = model.forward_with_cache(prompt[None].to(dev),
                                                 caches, 0)
        first.append(logits[0, -1].float().cpu())
    err = (first[0] - first[1]).abs().max().item()
    torch.testing.assert_close(first[0], first[1], atol=1e-3, rtol=0.0)
    if streams[0] != streams[1]:
        raise AssertionError(f"card stream {streams[0]} != CPU stream "
                             f"{streams[1]}")
    _log(f"card vs CPU, {label}: first-token logits "
         f"max_abs_err={err:.3e}, 16-token greedy streams equal")


# -------------------------------------------------------------- phase 10

def plain_route_phase():
    """gpt3_tiny, whose head dim 32 no attention kernel takes, on the card
    through the kernels' plain versions: one greedy request with
    whole-prompt and chunked prefill, its streams equal to the CPU's, and
    2 AdamW steps card against CPU; every plain route counted, no kernel
    launched."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

    cfg = gpt3_tiny()
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3).eval()
    card = GPTForCausalLM(cfg, device="cuda", seed=4).eval()
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(1, cfg.vocab_size, (95,),
                           generator=torch.Generator().manual_seed(3))
    _zero_counts()
    streams = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        for chunk in (0, 32):
            eng = ServingEngine(model, max_batch=1, max_context=160,
                                block_size=16, steps_per_tick=4,
                                prefill_chunk=chunk, device=dev)
            req = eng.add_request(Request(prompt.tolist(),
                                          max_new_tokens=16))
            eng.run()
            streams[dev, chunk] = list(req.output_ids)
    serve_plain = _plain_calls()
    serve_launches = {n: fn.launches for n, fn in _counters().items()}
    if len({tuple(x) for x in streams.values()}) != 1:
        raise AssertionError(f"gpt3_tiny hd 32: card and CPU streams "
                             f"differ: {streams}")
    if not all(n > 0 for n in serve_plain.values()) or \
            any(serve_launches.values()):
        raise AssertionError(f"gpt3_tiny hd 32 serving: plain routes "
                             f"{serve_plain}, launches {serve_launches}")
    _zero_counts()
    for fn in _train_counters().values():
        fn.launches = 0
    train_card_vs_cpu(cfg, "gpt3_tiny (hd 32) on the plain routes")
    train_plain = _plain_calls()
    train_launches = {n: fn.launches for n, fn in _train_counters().items()}
    if train_plain["flash_fwd"] <= 0 or any(train_launches.values()):
        raise AssertionError(f"gpt3_tiny hd 32 training: plain routes "
                             f"{train_plain}, launches {train_launches}")
    _log(f"gpt3_tiny hd 32 on the card: greedy streams (whole-prompt and "
         f"chunked) equal to the CPU's; plain routes serving "
         f"{serve_plain}, training {train_plain}; kernel launches "
         f"{serve_launches}, {train_launches}")


# --------------------------------------------------------------- phase 4

def _train_setup(cfg, device, seed, B, S):
    """The model, AdamW with global-norm clipping, and one fixed batch of
    random tokens from a numpy seed."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    model.train()
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    rng = np.random.RandomState(seed)
    ids, labels = (torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, S)),
                                   device=device) for _ in range(2))
    return model, opt, ids, labels


def _train_step(model, opt, ids, labels, autocast):
    """bench.py's train step: loss under auto_cast O1 bf16, backward,
    AdamW step, clear the gradients."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(autocast, level="O1", dtype="bfloat16",
                       device=ids.device):
        loss = model.compute_loss(ids, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _train_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import moe as mo
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
            "moe_dispatch": mo.moe_dispatch,
            "moe_combine": mo.moe_combine}


def _n_moe_blocks(cfg):
    return sum(1 for i in range(cfg.num_layers) if cfg.moe_num_experts > 0
               and (i + 1) % cfg.moe_every_n_layers == 0)


def _check_train_launches(label, cfg, launches, steps):
    """Each flash kernel once per layer and step; each MoE kernel once per
    MoE block and step (the MoE backward launches no kernel)."""
    for name, n in launches.items():
        per_step = (_n_moe_blocks(cfg) if name.startswith("moe_")
                    else cfg.num_layers)
        if n != per_step * steps:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"want {per_step} x {steps}")


# the flash kernels by name on the card's timeline: bf16 on the tensor
# cores, the FMA kernels only for fp32
FLASH_KERNELS = ("flash_fwd_tc_kernel", "flash_fwd_kernel",
                 "flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_kernel")


def _check_flash_kernels(label, cfg, kernels):
    """The profiled bf16 step launched every flash kernel on the
    tensor cores and none on the FMA ones; prints each flash kernel's
    launches and device time."""
    count = dict.fromkeys(FLASH_KERNELS, 0)
    us = dict.fromkeys(FLASH_KERNELS, 0.0)
    for e in kernels:
        for name in FLASH_KERNELS:
            if name in e.key:
                count[name] += e.count
                us[name] += e.self_device_time_total
    want = {"flash_fwd_tc_kernel": cfg.num_layers, "flash_fwd_kernel": 0,
            "flash_bwd_dq_tc_kernel": cfg.num_layers,
            "flash_bwd_dq_kernel": 0,
            "flash_bwd_dkv_tc_kernel": cfg.num_layers,
            "flash_bwd_dkv_kernel": 0}
    if count != want:
        raise AssertionError(f"{label}: flash launches by kernel {count}, "
                             f"want {want}")
    _log(f"profiled {label} step, flash kernels by name: " + ", ".join(
        f"{n} {count[n]}x {us[n] / 1e3:.2f} ms" for n in FLASH_KERNELS))


def _run_train(model, opt, ids, labels, steps):
    """``steps`` timed steps, every flash launch count at 0 first;
    returns losses, step times (s) and the counts."""
    import torch
    for fn in _train_counters().values():
        fn.launches = 0
    for fn in _plain_counters().values():
        fn.plain_calls = 0
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _train_step(model, opt, ids, labels, True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {name: fn.launches for name, fn in _train_counters().items()}
    if any(_plain_calls().values()):
        raise AssertionError(f"training at full width took plain routes: "
                             f"{_plain_calls()}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: a loss is not finite: {losses}")
    return losses, times, launches


def _expert_params(model):
    return sum(p.numel() for n, p in model.named_parameters()
               if ".experts." in n)


def _record_routing(model, ids, labels):
    """One forward of the train step (training mode, auto_cast O1, random
    routing) with every MoE block's routing read: per block the kept
    choices and filled slots, and the first block's gate input, routing
    and expert rows (the inputs of its dispatch and combine)."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.ops import moe as mo

    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    counts, first = [], {}

    def recorder(gate, keep_inputs):
        fwd = gate.forward_indices

        def forward_indices(x):
            out = fwd(x)
            eid, slot, keep, w, cap, _ = out
            E = gate.tot_expert
            flat, inv = mo.routing_indices(eid, slot, keep, E, cap)
            counts.append(((flat < E * cap).sum(), flat.numel(),
                           (inv < x.shape[0]).sum(), E * cap))
            if keep_inputs:
                first.update(x=x.detach().clone(), w=w.detach().clone(),
                             flat=flat, inv=inv, cap=cap)
            return out
        return forward_indices

    for i, layer in enumerate(layers):
        layer.gate.forward_indices = recorder(layer.gate, i == 0)
    hook = layers[0].experts.register_forward_hook(
        lambda m, a, out: first.update(
            rows=out.detach().reshape(-1, out.shape[-1]).contiguous()))
    with torch.no_grad(), amp.auto_cast(True, level="O1", dtype="bfloat16",
                                        device=ids.device):
        model.compute_loss(ids, labels)
    hook.remove()
    for layer in layers:
        del layer.gate.forward_indices
    kept = [int(c[0]) for c in counts]
    filled = [int(c[2]) for c in counts]
    _log(f"routing of a train-step forward, {len(layers)} MoE blocks: "
         f"choices kept of {counts[0][1]}: {kept}; slots filled of "
         f"{counts[0][3]}: {filled}")
    first.update(kept_by_block=kept, filled_by_block=filled)
    return first


def train_full_width(cfg, label):
    """6 timed steps of ``cfg`` at B 4 x S 2048 from launch counts of 0,
    checked, then one profiled step after a warm-up step; returns the
    numbers (the model and optimizer are freed)."""
    import statistics

    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import capacity

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, ids, labels = _train_setup(cfg, "cuda", 0, TRAIN_B, TRAIN_S)
    losses, times, launches = _run_train(model, opt, ids, labels,
                                         TRAIN_STEPS)
    _check_train_launches(label, cfg, launches, TRAIN_STEPS)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    tokens = TRAIN_B * TRAIN_S
    fpt = model.flops_per_token(TRAIN_S)
    mfu = tokens / step_s * fpt / PEAK_OPS["torch.bfloat16"]
    # the work the step does: each expert runs over its C rows of the
    # E x C buffer, not over every token
    n_exp = _expert_params(model)
    fpt_work = fpt
    if n_exp:
        cap = capacity(tokens, cfg.moe_num_experts, 1, 1.2)
        fpt_work = fpt - 6 * n_exp * (1 - cap / tokens)
    mfu_work = tokens / step_s * fpt_work / PEAK_OPS["torch.bfloat16"]
    peak = torch.cuda.max_memory_allocated()
    _log(f"{label} ({model.num_params()} parameters, {n_exp} in experts) "
         f"fp32 weights, auto_cast O1 bf16, AdamW, B={TRAIN_B} S={TRAIN_S}: "
         f"losses {[round(x, 4) for x in losses]}")
    _log(f"{label}: step times (s) {[round(t, 4) for t in times]}; median "
         f"of steps 2-{TRAIN_STEPS} {step_s * 1e3:.1f} ms = "
         f"{tokens / step_s:.1f} tokens/s, {fpt / 1e9:.3f} GFLOP/token by "
         f"6N + 12LHS: MFU {mfu:.4f}; {fpt_work / 1e9:.3f} GFLOP/token by "
         f"the work done: MFU {mfu_work:.4f} (of 989 TFLOP/s bf16); peak "
         f"memory {peak / 2 ** 30:.2f} GiB; launches {launches}")

    # two more steps, the second profiled: the card's busy share and its
    # top kernels
    def step():
        t0 = time.perf_counter()
        _train_step(model, opt, ids, labels, True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    wall, kernels = _profiled(step, step)
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    moe_us = sum(e.self_device_time_total for e in kernels
                 if "moe_" in e.key)
    idle = 1 - busy_us / 1e6 / wall
    _check_flash_kernels(label, cfg, kernels)
    _log(f"profiled {label} step: wall {wall * 1e3:.1f} ms, card busy "
         f"{busy_us / 1e3:.1f} ms in {sum(e.count for e in kernels)} "
         f"kernel launches, idle share {idle:.3f}; flash kernels "
         f"{flash_us / 1e3:.1f} ms = {flash_us / max(busy_us, 1):.3f} of "
         f"busy time; MoE kernels {moe_us / 1e3:.2f} ms = "
         f"{moe_us / max(busy_us, 1):.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:24]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
             f"{e.key[:90]}")
    routing = _record_routing(model, ids, labels) if n_exp else None
    del model, opt
    torch.cuda.empty_cache()
    return dict(step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
                mfu_work=mfu_work, peak_bytes=peak, idle_share=idle,
                launches=launches, losses=losses, routing=routing)


def training_phase():
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    run = train_full_width(gpt3_1p3b(), "training gpt3_1p3b")
    # dropout 0.1 at the same width: the kernels' dropout on the path
    model, opt, ids, labels = _train_setup(gpt3_1p3b(dropout=0.1), "cuda",
                                           1, TRAIN_B, TRAIN_S)
    d_losses, _, d_launches = _run_train(model, opt, ids, labels, 2)
    if not all(n > 0 for k, n in d_launches.items() if k.startswith("flash")):
        raise AssertionError(f"dropout training: launches {d_launches}")
    _log(f"training gpt3_1p3b dropout 0.1, 2 steps: losses "
         f"{[round(x, 4) for x in d_losses]}, launches {d_launches}")
    del model, opt
    torch.cuda.empty_cache()
    return run


# --------------------------------------------------------------- phase 5

def _feed_uniforms(model, uniforms):
    """Every GShard gate of ``model`` draws its random-routing uniforms,
    in call order, from the host tensors ``uniforms``."""
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    draws = iter(uniforms)
    for m in model.modules():
        if isinstance(m, GShardGate):
            m.uniforms = lambda n, device: next(draws)[:n].to(device)


def train_card_vs_cpu(cfg, label="gpt3_1p3b 4 layers fp32"):
    """2 AdamW steps of a 4-layer fp32 cut on the card and on the CPU from
    one state dict (and, for MoE, one set of routing uniforms).  Losses
    within atol 1e-4.  Parameters within 2 x lr x steps: Adam divides by
    sqrt(v), so a weight whose gradient is rounding noise (the key third of
    each qkv bias has a zero gradient in exact arithmetic) moves by up to
    about lr per step on either side."""
    import torch

    steps, init, runs = 2, None, []
    uniforms = torch.rand((steps * _n_moe_blocks(cfg), 256),
                          generator=torch.Generator().manual_seed(5))
    for dev in ("cpu", "cuda"):
        model, opt, ids, labels = _train_setup(cfg, dev, 2, 1, 256)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        _feed_uniforms(model, uniforms)
        losses = [_train_step(model, opt, ids, labels, False).item()
                  for _ in range(steps)]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              model.state_dict().items()}))
        del model, opt
    (cpu_l, cpu_p), (card_l, card_p) = runs
    torch.testing.assert_close(torch.tensor(card_l), torch.tensor(cpu_l),
                               atol=1e-4, rtol=0.0)
    err = max((card_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    if err > 2 * LR * steps:
        raise AssertionError(f"train card vs CPU: parameters {err:.3e} "
                             f"apart, limit {2 * LR * steps:.1e}")
    _log(f"train card vs CPU, {label}, B=1 S=256, {steps} "
         f"AdamW steps: losses card {card_l} cpu {cpu_l}, parameters max "
         f"abs diff {err:.3e}")


# ------------------------------------------------------------ phases 7-9

def moe_serving_phase(lens):
    """GPT-3 1.3B with 4 experts in every second block, bf16, in eval mode
    (the eval capacity, no random routing), the 8 requests with
    whole-prompt prefill."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b(moe_num_experts=MOE_E)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=0).eval()
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    run = serve(model, prompts, 0)
    n = run["launches"]
    for name in ("flash_fwd", "paged_decode", "moe_dispatch", "moe_combine"):
        if n[name] <= 0:
            raise AssertionError(f"MoE serving: {name} never launched")
    if n["moe_dispatch"] != n["moe_combine"]:
        raise AssertionError(f"MoE serving: dispatch and combine launched "
                             f"{n['moe_dispatch']} and {n['moe_combine']}")
    _log(f"serving gpt3_1p3b MoE {MOE_E} experts ({model.num_params()} "
         f"parameters) bf16, whole-prompt prefill: {run['tokens']} tokens in "
         f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s, "
         f"mean TTFT {run['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
         f"{run['ttft_max_s'] * 1e3:.1f} ms, {run['steps']} decode steps in "
         f"{run['ticks']} ticks, launches {n}")
    del model
    torch.cuda.empty_cache()
    return run


def moe_phases(lens, rows_out):
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    serve_run = moe_serving_phase(lens)
    train_run = train_full_width(gpt3_1p3b(moe_num_experts=MOE_E),
                                 "training gpt3_1p3b MoE")
    moe_kernel_timing(rows_out, train_run.pop("routing"))
    cut = gpt3_1p3b(num_layers=4, moe_num_experts=MOE_E)
    label = "gpt3_1p3b MoE 4 layers (blocks 1, 3 MoE) fp32"
    card_vs_cpu(cut, label)
    train_card_vs_cpu(cut, label)
    return serve_run, train_run


# ------------------------------------------------------------------ main

def ptxas_report(build_dir):
    """Registers and spills of every kernel from the ``-Xptxas -v``
    reports; the tensor-core kernels must not spill at hd 64 and 128.
    Returns {kernel: {hd: "N registers, S spill stores, L spill loads"}}
    for the tensor-core kernels."""
    import re
    tc = {}
    for f in sorted(build_dir.glob("*.ptxas.txt")):
        entry = None
        for line in f.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if not m:
                continue
            name = re.search(r"ptt\d+(\w+?_kernel)", entry)
            name = name.group(1) if name else entry
            hd = re.search(r"Li(\d+)E", entry)
            hd = int(hd.group(1)) if hd else None
            text = (f"{m.group(1)} registers, {spills[0]} bytes spill "
                    f"stores, {spills[1]} bytes spill loads")
            _log(f"  {f.name.split('.')[0]}: {name} hd {hd}: {text}")
            if name.endswith("_tc_kernel"):
                tc.setdefault(name, {})[hd] = text
                if hd in (64, 128) and spills != (0, 0):
                    raise AssertionError(f"{name} hd {hd} spills: {text}")
            entry = None
    for name in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                 "flash_bwd_dkv_tc_kernel", "paged_chunk_tc_kernel"):
        if sorted(tc.get(name, {})) != [64, 128, 256]:
            raise AssertionError(f"ptxas report: {name} at hd "
                                 f"{sorted(tc.get(name, {}))}")
    return tc


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    _log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    tc_regs = ptxas_report(_build.BUILD_DIR)

    lens = [100 + 200 * i for i in range(BATCH)]       # 100 .. 1500
    rows = kernel_checks(lens)
    flash_train_checks(rows)
    moe_kernel_checks()
    runs = serving_phase(lens)
    card_vs_cpu(gpt3_1p3b(num_layers=4))
    plain_route_phase()
    train = training_phase()
    train_card_vs_cpu(gpt3_1p3b(num_layers=4))
    moe_serve, moe_train = moe_phases(lens, rows)

    sources = {"flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                             "paddle_tpu/ops/pallas_flash.py:159"),
               "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                                "paddle_tpu/ops/pallas_flash.py:340"),
               "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                                 "paddle_tpu/ops/pallas_flash.py:403"),
               "paged_decode": ("paddle_tpu_torch/csrc/paged_decode.cu",
                                "paddle_tpu/ops/pallas_paged.py:57"),
               "paged_chunk": ("paddle_tpu_torch/csrc/paged_chunk.cu",
                               "paddle_tpu/ops/pallas_paged.py:229"),
               "moe_dispatch": ("paddle_tpu_torch/csrc/moe.cu",
                                "paddle_tpu/ops/pallas_moe.py:85"),
               "moe_combine": ("paddle_tpu_torch/csrc/moe.cu",
                               "paddle_tpu/ops/pallas_moe.py:133")}
    # each path's counts are its own run's, read from 0; `launches` is the
    # count of the first path that runs the kernel
    paths = {"whole_prompt": runs[0]["launches"],
             "chunked": runs[256]["launches"],
             "train": train["launches"],
             "moe_serve": moe_serve["launches"],
             "moe_train": moe_train["launches"]}
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        path = next(p for p, n in by_path.items() if n > 0)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": by_path[path],
                        "launches_path": path, "launches_by_path": by_path,
                        **rows[name]})
        tc_name = name + "_tc_kernel"
        if tc_name in tc_regs:
            kernels[-1]["bf16_kernel"] = tc_name
            kernels[-1]["ptxas_by_hd"] = tc_regs[tc_name]
    _log(card)
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
