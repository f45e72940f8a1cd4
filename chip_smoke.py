#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port, ``paddle_tpu_torch``.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``paddle_tpu_torch/csrc/`` (at first use,
into ``build/paddle_tpu_torch/``), then runs twenty-seven phases on card 0:

1. Kernels against their plain PyTorch versions, at the shapes the serving
   engine and the train step below give them (nh 16, hd 128, block 64,
   batch 8; training B 4 x S 2048 causal), with ``flash_fwd`` also at hd 64
   and 256 and at Sq > Sk (rows that see no key: zeros, lse -1e30), and
   the training cases at Sq > Sk too.  float32: atol 2e-5, rtol 1e-4
   for outputs, atol 1e-4, rtol 1e-4 for gradients.  bfloat16: against the
   plain version computed in float32 on the same bfloat16 inputs, atol
   2e-2, and for gradients also rtol 1e-2 (one bf16 rounding of a
   gradient that sums over a whole sequence).  float16 (the flash
   kernels, on the same tensor-core kernels): every training case and
   BERT-base's shape as bf16 runs them, against the plain version in
   float32 on the same fp16 inputs, atol 4e-3 and rtol 2e-3 (one fp16
   rounding is 2^-11, bf16's 2^-8); the three kernels timed in fp16 at
   the training shape beside bf16 and beside
   ``F.scaled_dot_product_attention`` in fp16 (forward; backward
   alone).  ``paged_decode`` also at Llama-2 7B's serving shape (nh
   32, timed beside its bound), the three flash kernels also at
   BERT-base's training shape (B 8, S 512, nh 12, hd 64, non-causal,
   padded rows through the kv mask, dropout 0.1; timed
   beside ``F.scaled_dot_product_attention`` with the same mask and
   rate), and ``paged_decode`` at
   the edges of its 256-key splits (255, 256, 257, 511, 512), 0 and the
   full table, and with out-of-pool table entries, and at phase 12's
   draft shape (hd 64, the draft's lengths, with and without out-of-pool
   entries); ``flash_fwd`` also at the draft's prompt (nh 16, hd 64,
   1024 keys); the bf16 training
   cases also at hd 64 and 256.  ``paged_chunk`` (bf16:
   ``paged_chunk_tc_kernel`` on the tensor cores, its key axis split)
   with 256-row chunks at many starts and past the table, chunks of 1, 4
   and 70 rows, bs 16, hd 64 and 256, out-of-pool entries, and splits of
   64 .. 512 keys and none around their edges; timed at the serving
   path's shape (B 1, s 256, start 1024) at several split lengths, with
   TFLOP/s and two yardsticks that do not read the pool: ``flash_fwd``
   and ``F.scaled_dot_product_attention`` with the offset-causal mask on
   a contiguous copy of the same keys.  ``paged_chunk`` also at the
   speculative verify's shape, through ``paged_verify_attention``: 8
   slots, s = k in 2, 4, 8, starts 0, 0, 63, 64, 700, 1023, 1500, 2040
   with the first two slots free (all-zero table rows), with and without
   out-of-pool entries, fp32 and bf16; timed in bf16 at s 4 with the
   serving lengths + 64 as starts, beside ``paged_decode`` (one decode
   step) at the same lengths.  Kernel, plain version and the
   ``F.scaled_dot_product_attention`` yardstick (flash only; for the
   backward pair, sdpa's backward timed on its own) are timed with CUDA
   events (``paged_decode``, whose two kernels take less time than the
   host's launch, from a replayed CUDA graph of 200 calls, beside the eager
   loop's time and its time at other split lengths); the flash lines print
   the achieved TFLOP/s and the ratio to sdpa.  Before it, the
   ``-Xptxas -v`` reports give every kernel's registers and spills; the
   tensor-core kernels (bf16 and fp16 ``flash_fwd``, ``flash_bwd_dq``,
   ``flash_bwd_dkv``) must not spill at hd 64 and 128, and none of the
   six ``weight_only_gemm_kernel`` instances may spill or have its
   ``wgmma``s serialised by ptxas.
2. Serving at full width: GPT-3 1.3B in bfloat16 with random weights from a
   seed, 8 requests (prompts of 100 to 1500 tokens, 64 new tokens each,
   half greedy, half sampled) through ``ServingEngine`` with whole-prompt
   prefill, then through a second engine with 256-token chunked prefill.
   Every serving engine of this script is the default one unless a phase
   says otherwise: its program grid captured as CUDA graphs by
   ``warmup()`` before the clock starts, and the overlapped tick loop;
   each must have captured programs and replayed them.  Each run starts
   with every kernel's launch count at 0 (replays count what their
   capture launched) and must launch its kernels.  A chunked run under
   ``torch.profiler`` prints the card's busy share, the kernels that
   take its time, the decode kernels by name
   (``paged_decode_split_kernel``, ``paged_decode_merge_kernel``), and
   every bf16 ``paged_chunk`` launch must be ``paged_chunk_tc_kernel``
   (with ``paged_chunk_merge_kernel`` when the keys are split) by name
   and none the FMA kernel.  No full-width serving or training run may
   take a plain route (``plain_calls``).  Then phase 13, and
   ``sample_rows`` (the tick's token choice, the threefry draw for
   sampled rows) timed on the card at [8, vocab].
13. Graphs and overlap (in phase 2's run): phase 2's whole-prompt mix on
   the eager programs (``cuda_graphs=False``), on CUDA graphs with the
   overlapped loop off, and on the default engine, one run each.
   Streams equal in all three runs, launch counts of eager and graphs
   equal; medians of tokens/s and mean TTFT, ms per decode step with
   overlap off (the card synchronised before each tick), the idle share
   of one profiled run each (decode kernels by name, as above), the
   warmup's time and grid.
19. Crash-only serving (in phase 2's run, after phase 13, on its model):
   a. ``serve_forever`` on a thread; the main thread adds a request whose
   prompt dispatch chaos fails twice (``serving.prefill.dispatch``), then
   one whose prompt row ``nan_logits`` poisons under the NaN watchdog,
   phase 2's 8 requests at priorities 0 and 1 and two on phase 11's
   system prompt (the second a prefix hit), cancels one running request
   after its 16th token and asks for a drain, which exports the prefix
   cache under ``build/crash_only_export``.  Both poisoned requests end
   ``poisoned`` with ``tick_errors`` exactly 4, the cancelled one
   ``cancelled`` on a prefix of its fault-free stream, every other one
   ``finished`` with the stream of the same request served by a
   fault-free engine's ``run()``; no block leaks; ``flash_fwd``,
   ``paged_decode`` and ``paged_chunk`` launch (the ``crash_only`` path).
   b. With ``device_sampling=False`` (the ``decode`` program, replayed
   from its graph) and the watchdog on, NaN written on the card into the
   keys of one running request's first private block in every layer:
   that slot alone ends ``error`` at its next tick, the other 7 streams
   equal a fault-free run's.  c. ``tick_timeout_s=0.5`` against a 3 s
   stall of the first harvest (``delay_at("serving.harvest")``): the tick
   fails (``error``, blocks freed), ``run()`` returns, and the same engine
   then serves the fault-free stream.  d. A new engine with the same
   export directory imports part a's export: the hit streams as part a's
   did, on ``paged_chunk``, the pools keep their addresses; the export's
   blocks, bytes and seconds, the construction's seconds with and
   without the import, and the hit's TTFT against a cold miss are
   printed with the card's name and power limit.  e. A 2-layer fp32 cut,
   card against CPU, the block ledger armed on both, through the CPU
   tests' fault schedule (poison, a decode NaN, a failed tick, a drain
   with its export, the import): outcomes, streams, strikes, ``stats()``
   and the drain report (without seconds, paths and the graph counters)
   equal.
20. Observability and the scheduler's budget (in phase 2's run, after
   phase 19, on its model and mix): a. phase 13's default engine and its
   overlap-off twin with the metrics gate on and off, one run each in
   turns (one capture per engine; the prefix index emptied between
   runs): median tokens/s, mean TTFT and ms per decode step of each,
   streams equal.  b. ``serve_forever`` behind ``http_port``: 8 clients
   ``POST /generate`` the mix at once; every SSE stream equals ``run()``'s,
   the ``/metrics`` scrape counts 8 TTFTs and every token, ``/requests``
   8 finished records; a client that hangs up after 10 tokens ends
   ``cancelled`` with its blocks back; ``/healthz`` 200, then 503
   ``draining`` after ``POST /drain``.  c. 256-token chunks at chunk
   budgets 1, 2 and the controller (at most 4, ``tpot_slo_ms`` 1.5 x part
   a's step): streams and chunks equal; mean TTFT, p99 TPOT, ticks.  d.
   ``ttft_slo_ms=1e-6``, ``shed_queue_depth=2``: after one request, the 8
   queued through ``POST /generate`` at priorities 0 and 1; the shed ones
   are the JAX rule's and end in ``error`` frames with reason
   ``slo_shed``, the others stream as ``run()``.  e. Phase 11's system
   prompt alone after its registration (1023 tokens reused): the ``cow``
   program replays from its graph, streams equal ``cuda_graphs=False``'s.
   f. A 2-layer fp32 cut, card against CPU: chunk budget 2, shedding and
   the trace records (without seconds) equal.  ``flash_fwd``,
   ``paged_chunk`` and ``paged_decode`` launch in parts b, c and e (the
   ``observability`` path).
3. Card against CPU: a 2-layer cut of GPT-3 1.3B in float32 serves one
   greedy request on the card (kernels; the default engine and the eager
   programs) and on the CPU (plain versions) from one state dict; the
   token streams must match and the first-token logits agree to atol
   1e-3.
4. Training at full width: GPT-3 1.3B, float32 weights, ``auto_cast`` O1
   bfloat16, AdamW (lr 1e-4, weight decay 0.01) with global-norm clipping
   at 1.0, 6 steps on one fixed batch of B 4 x S 2048 random tokens.  Every
   loss finite, the last below the first, and each flash kernel launched
   exactly 24 x 6 times.  Prints step time, tokens/s, MFU and peak memory,
   then profiles one more step (after an unrecorded warm-up step of the
   profiler), in which every flash launch must be the
   tensor-core kernel by name (24 each of forward, dq and dk/dv, none on
   the FMA kernels), then trains 2 steps with dropout 0.1.
5. Card against CPU for training: a 2-layer fp32 cut, 2 AdamW steps on
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
9. Card against CPU for GPT-MoE: a 2-layer fp32 cut (block 1 MoE)
   serves one greedy request (streams equal, first-token logits atol
   1e-3) and trains 2 AdamW steps with the same routing uniforms fed to
   both (losses atol 1e-4, parameters within 2 x lr x steps).

10. Head dims no kernel takes (run after phase 12): ``gpt3_tiny`` (hd 32)
   serves one greedy request (whole-prompt and chunked prefill, and with
   n-gram speculation) and trains 2 AdamW steps on the card through the
   kernels' plain versions;
   streams equal the CPU's, losses and parameters as in phase 5, every
   plain route counted (``plain_calls``) and no kernel launched.

11. The prefix cache (run after phase 3, on a second GPT-3 1.3B in bf16):
   8 requests sharing a 1024-token system prompt (16 full blocks), each
   with its own suffix of 37 + 64 i tokens, and a ninth that is the
   system prompt alone (its last block copied on write), 64 new tokens
   each, odd ones sampled; served with the prefix cache off, on with
   whole-prompt prefill, and on with 256-token chunks, one run each
   (tokens/s, mean TTFT of all and of the first 8).
   Every budget met, hits > 0, ``paged_chunk``
   launched in the whole-prompt hit run, no plain route, no leaked block;
   how far the greedy streams agree with prefix off's, and the logit gap
   at the first divergence (bf16 near-ties), printed.  Then one prefill
   program (a replayed graph), a miss (2048
   bucket) against hits (suffixes of 512 and 64 at 1024): wall, host
   enqueue and card busy time.
12. Speculative decoding on the same model: 8 prompts of 400 .. 1000
   tokens, each a random 48-token pattern repeated, 64 new tokens each,
   odd ones sampled; plain decoding, n-gram drafts at k 4, n-gram with
   the adaptive ladder 2, 4, 8, and a GPT-3 350M draft (hd 64, random
   weights from a seed) at k 4, and the target as its own draft at k 4
   (acceptance near 1: it must exceed 0.5), one run each.  Every
   spec run launches ``paged_verify_attention``; budgets met, no leak;
   the acceptance rate, ``k_now``, ``k_switches`` and the greedy
   streams' agreement with plain decoding printed; the n-gram
   run once more under the profiler (idle share, every verify launch on
   ``paged_chunk_tc_kernel`` by name).  Then a
   2-layer fp32 cut, card (default engine and eager programs) against
   CPU: greedy streams with the prefix (a miss, a hit, a copy on write)
   equal those without it, and n-gram and same-weights-draft speculation
   equal plain decoding.

14. Llama-2 7B serving at full width (run after phase 9, every GPT model
   and engine freed first): ``llama2_7b(num_layers=LLAMA_SERVE_LAYERS)``
   (hidden 4096, 4 of its 32 layers for the time limit, 32 heads, hd
   128, vocab 32000) in
   bfloat16 with random
   weights from a seed, on phase 2's requests and engine settings:
   whole-prompt prefill (one run, one more with the overlapped
   loop off for ms per decode step, one profiled for the idle share),
   256-token chunks and phase 11's shared-prefix mix with the prefix cache
   (one profiled run each).  In the profiled runs every prompt's
   ``flash_fwd`` is ``flash_fwd_tc_kernel``, decode runs the split and
   merge kernels and every ``paged_chunk`` launch (chunks and hits) is
   ``paged_chunk_tc_kernel``, by name; no plain route, budgets met, no
   leaked block, the program grid captured and replayed.  Prints tokens/s,
   mean TTFT, ms per decode step, idle share, warmup, the top kernels and
   peak memory.
15. Llama card against CPU: a 2-layer fp32 cut of ``llama2_7b(num_kv_heads
   =4)`` (Llama-2-70B's group of 8 query heads per kv head) serves one
   greedy 260-token request whole-prompt and in 256-token chunks (card:
   default engine and eager programs) with phase 3's checks; a 2-layer
   cut takes 2 AdamW steps card against CPU at B 1 x S 256 with phase 5's
   (the card's fp32 FMA flash kernels reading kv head h // 8).
16. Llama training at a layer cut: ``llama2_7b(num_layers=8)`` at full
   width (1.88 B parameters: fp32 weights, gradients and AdamW moments
   take 30 GB; all 32 layers would take 108 GB), phase 4's step at B 1 x
   S 4096, 6 steps and one profiled; each flash kernel launched 8 x 6
   times, on the tensor-core kernels by name.
17. BERT-base MLM training at full width (``bench.py``'s
   ``bench_bert_base``: B 8 x S 512, dropout 0.1, labels on 15% of the
   tokens, -100 elsewhere): phase 4's step, 6 steps without a mask and 6
   with every second row padded from a random length in [128, 512); each
   flash kernel (hd 64, non-causal, kv mask, dropout) launched 12 x 6
   times per run, on the tensor-core kernels by name in a profiled step.
   Then a 2-layer fp32 cut with padded rows, 2 AdamW steps card against
   CPU at B 2 x S 128 with phase 5's tolerances.
18. Weight-only quantized serving (the kernel and the serving run after
   phase 14 on its model, the cuts after phase 17):
   ``weight_only_matmul`` (int8 and fp8 codes) against its plain version
   computed in float32 on the same codes and inputs (bf16: atol 2e-2, rtol
   1e-2; fp32: phase 1's) at Llama-2 7B's and GPT-3 1.3B's linear shapes,
   bf16 at M 8, 40 and 128, fp32 at 4096 x 4096, and M 1, 127, 128 with
   N 4100 and K 4112 (off the kernel's tiles) and a bias; timed at M 8 from
   replayed graphs over weights that do not fit in L2, beside its bound,
   ``dequantize`` + ``torch.matmul`` (the plain version) and
   ``torch.matmul`` on the bf16 weight, and summed over one Llama-2 7B
   decode step.  ``weight_only_gemm`` (the prompts' wide products) the
   same way at every one of those shapes at M 256, 512, 1024 and 2048 and
   at the edges M 129, 300, 2047 with N 4100, K 4112 and a bias; timed at
   each shape (from replayed graphs, past L2) with TFLOP/s and
   the tile schedule chosen, and summed over one 2048-row Llama-2 7B
   prompt; the crossover against ``weight_only_matmul`` at M 64, 128,
   256; and every schedule the kernel takes at Llama's shapes, M 256 to
   1024, beside the chosen one.  Then ``llama2_7b`` served
   with ``quant="int8"`` and ``"fp8"`` on phase 14's mix: whole-prompt
   (int8 and fp8: one run each, and one with the overlapped
   loop off for ms per decode step, one profiled: idle share, weight-only
   launches on ``weight_only_mma_kernel`` and ``weight_only_gemm_kernel``
   by name), and in int8 also 256-token chunks and the shared prefix;
   every decode step's 225 linear layers launch ``weight_only_matmul``
   (counted under replay), every run launches ``weight_only_gemm`` for its
   prompts and none takes the dequantize route (``dequant_calls`` 0),
   budgets met, no leaked block; prints ``stats()["quant"]``, the twin's
   resident bytes, peak memory and the twin's largest logit deviation from
   bf16 on one prompt (informational: random weights). Then an activation
   quanter's scales, codes and gradients card against CPU; phase 3's GPT
   cut and phase 15's Llama cut (2 layers) quantized int8 and fp8, card
   (default engine and eager programs) against the CPU quant engine, 8 new
   tokens, whole-prompt, the Llama int8 cut also chunked and the GPT int8
   cut also with n-gram speculation, with phase 3's checks; and a 2-layer
   fp32 GPT cut under ``QAT`` (fake-quantized weights), 2 AdamW steps card
   against CPU with phase 5's tolerances.
21. The rest of training (after phase 5): a. GPT-3 1.3B at B 4 x S 2048,
   O1 bf16, AdamW (weight decay 0.01) under ``LinearWarmup`` into
   ``CosineAnnealingDecay``, ``ClipGradByGlobalNorm(1.0)``, a dynamic
   ``GradScaler`` and the fused step on the ``fused_adamw`` kernels, 6
   steps with a ``StepTimeline`` record each: step time, tokens/s, MFU,
   peak memory; ``optimizer.fused`` hits and no fallback; one profiled
   step (idle share, the fused kernels' device time against their
   bound); then the kernel pair alone at GPT-3 1.3B's 292 tensors against
   its bound, its plain version and the library call (``_foreach_norm``
   clip + ``torch.optim.AdamW(fused=True)``), the path a step the fused
   one declines takes (the list rules behind the same clip), and whole
   steps with
   ``torch.optim.AdamW`` foreach (phase 4's former optimizer) and fused.
   b. Three more steps, an inf in one gradient at the third, every scaler
   step under ``set_sync_debug_mode("error")``: parameters and moments
   bit-identical, the scale halved, ``global_step`` kept.  c. Recompute
   off, full and ``dots_with_no_batch_dims_saveable``, 3 steps each: peak
   memory, step time, flash forwards per step (24, 48, 48), losses equal
   to the run without recompute (bit for bit, else within GRAD_TOL, said
   which); with dropout 0.1, off and full, losses and the generator's
   position equal.  d. O2 ``decorate``: bf16 parameters with float32
   masters, 6 steps, step time and peak memory against a.  e. A 2-layer
   fp32 cut with full recompute, card against CPU, 2 steps with the
   scheduler, scaler and fused step: losses within 1e-4, parameters
   within 2 x lr x steps.  f. ``fused_adamw`` against its plain version
   at GPT-3 1.3B's parameter list, O1, O2 bf16 and O2 fp16, clip none /
   global 1.0 / norm / value, scaler finite / overflow / none, lr 1e-2
   and decay 0.1, the states drawn to the clipped gradients' size: skips
   bit for bit, the gradients after the step bit for bit (a scaler's
   step writes them back unscaled, applied or skipped), clip
   coefficients within rtol 1e-6 (the plain version's phase 2 then takes
   the kernels'), each float32 tensor's change in the step within 1e-4 of
   the plain version's (2-norm), the decay above 100 times that share of
   every weight's change, 16-bit copies within one step of their type.
   The scaler step's time in a includes the write-back.
22. float16 training (after phase 21): a. GPT-3 1.3B, phase 4's setup and
   batch under ``auto_cast(dtype="float16")`` O1 with ``GradScaler()`` at
   its defaults (65536), 8 steps: every loss finite, at least half the
   steps applied (the skipped ones and the final scale printed), each
   flash kernel 24 x 8 launches, on the fp16 tensor-core instances by
   name in a profiled step, ``fused_adamw`` every step with no fallback;
   step time, tokens/s, MFU and peak memory beside 21a's bf16.  b. O2
   ``decorate(dtype="float16")``, 2 steps, no fallback.  c. A 2-layer
   fp32-weights cut under fp16 O1, card against CPU, 2 steps: losses
   within 5e-3, scale and applied steps equal.
23. ``generate`` (after phase 22; c inside phase 14's model lifetime, d
   after phase 15): a. a 2-layer fp32 cut of GPT-3 1.3B, card against
   CPU: 4 prompts of uneven content at 64 tokens, 32 new, each of
   ``dense``, ``static``, ``paged`` and ``paged_eager`` on the card:
   greedy streams equal to the CPU's, sampled ones (seed 7, top-k 50,
   top-p 0.9) equal to the CPU's of the same draw scheme, prompt logits
   within 1e-3 (equal, or parted at a near-tie under 1e-3, printed).
   b. GPT-3 1.3B in bf16, B 4, a 512-token prompt, 128 new tokens, each
   implementation: ms per new
   token, tokens/s, ``flash_fwd`` and ``paged_decode`` launches, no plain
   route; ``static`` and ``paged`` replay one captured decode step per
   token.  c. Llama-2 7B in bf16, B 1, a 256-token prompt, 32 new,
   ``static`` and ``paged``.  d. a's checks on phase 15's GQA cut (2
   layers).
24. Custom autocast lists (after phase 23): a. GPT-3 1.3B, phase 4's
   setup, 6 steps under ``torch.autocast`` and 6 under
   ``custom_black_list={"divide"}``, ``custom_white_list={"embedding"}``
   (the JAX per-op policy in a function mode) on one model: medians of
   steps 2-6, losses, peak, one profiled step each (idle share, every
   flash launch on the tensor-core kernels by name), the mode's torch
   function calls per step, ``fused_adamw`` on every step.  b. A 2-layer
   fp32 cut card against CPU at B 1 x S 128, 2 AdamW steps under those
   lists and under
   a black-listed ``matmul``: losses within atol 2e-2, rtol 1e-2 (bf16),
   every mapped op in the same type, the parameters' difference printed.
25. The MoE dense path (after phase 8): a. a 2-layer fp32 cut of GPT-MoE,
   dense and fused, card and CPU, on one set of weights, batch and
   routing uniforms: loss (atol 1e-5), each block's ``l_aux`` (1e-6) and
   every gradient (1e-4) against the CPU's fused path; no MoE launch on
   the dense path.  b. Phase 8's step on the dense path, 4 steps: the
   (T, E, C) tensors' bytes, the peak, the step beside phase 8's.
26. ``hapi.Model.fit`` (after phase 24): GPT-3 1.3B at 4 of its 24
   layers (the time limit), fp32 weights, O1
   bf16, AdamW under a cosine schedule, clip 1.0, a ``DataLoader`` of 2
   spawned workers over 32 of 64 synthetic samples of 2048 token ids
   (shuffled), 8 steps with ``ProgBarLogger``, ``LRScheduler`` and
   ``ModelCheckpoint`` (``build/hapi_ckpt``, removed after), beside the
   hand-written step on the same batches: losses (within 1e-4; bit for
   bit said), step time (timeline, median of the last 6), tokens/s,
   MFU, peak, the idle share of a profiled ``train_batch`` with every
   flash launch on the tensor-core kernels, 8 timeline records,
   ``fused_adamw`` on every step; the final checkpoint loaded into a
   fresh model gives the same logits bit for bit; ``evaluate`` and
   ``predict`` on 4 batches; 4 steps with ``amp_configs={"level": "O1",
   "dtype": "float16", "init_loss_scaling": 65536}`` (skipped steps and
   the final scale printed).
27. float16 serving (after phase 26; d inside phase 14's model lifetime):
   a. GPT-3 1.3B in fp16, phase 2's 8 requests whole-prompt and in
   256-token chunks on the default engine (a second chunked run profiled:
   every paged launch on the fp16 instances by name, none on the FMA
   chunk kernel), on eager programs (streams equal bit for bit), ticks
   timed with overlap off; tokens/s, mean TTFT and ms per decode step
   beside phase 2's bf16 numbers; the first decode step's logits (paged)
   against a dense fp32 forward of the same fp16 weights (atol 5e-2,
   rtol 5e-2: fp16 rounding compounded over 24 layers).  b. A prefix hit
   (phase 11's prompts) and n-gram spec verify (phase 12's) in fp16.  c.
   ``generate`` paged and paged_eager in fp16 at 23b's shape beside 23b's
   bf16; GPT-MoE in fp16 on 4 requests (the fp16 MoE kernels).  d.
   Llama-2 7B's weights rounded to fp16, one whole-prompt run of phase
   14's mix.  e. A 2-layer fp16 cut, card against CPU (the CPU's fp16
   products in fp32 rounded once): streams compared, a token that parts
   reported with its top-2 logit gap.
   Phase 1 runs ``paged_decode`` (edge, draft and path lengths, hd 64,
   128 and 256, nh 32), ``paged_chunk`` (every bf16 case and split edge),
   ``paged_verify_attention`` and the MoE pair in fp16 too, against the
   plain version in fp32 on the same fp16 inputs (atol 4e-3, rtol 2e-3;
   the dispatch exact, the combine within one fp16 rounding), each fp16
   kernel timed beside bf16 at the path shape.
28. Tensor-parallel serving (inside phase 2's run, after phase 20, on its
   model): GPT-3 1.3B in bf16 at ``tp_degree=2``, both ranks on card 0
   over gloo (the machine has one card; NCCL cannot put two ranks on
   it), programs eager.  a. Phase 2's 8 requests (16 new tokens) with
   whole prompts, ticks timed with overlap off: ms per decode step,
   tokens/s, collectives and bytes per tick, the share of the ticks in
   collectives; the greedy streams against phase 2's degree-1 streams
   (the first differing token printed: cuBLAS's algorithm for a column
   slice may round otherwise); each rank's weight and pool bytes against
   degree 1's (about and exactly half).  b. One engine, int8
   (``quantize_plan``), 256-token chunks, n-gram speculation: phase 2's
   first two requests and two on a shared 1024-token prefix (the second
   hits).  c. A 4-layer fp32 cut at ``tp_degree=2`` on the card against
   the CPU: greedy streams equal.  Every rank launches ``flash_fwd`` and
   ``paged_decode`` (a), ``paged_chunk``, the verify and both weight-only
   kernels (b), with pools at 8 heads, no plain route, no leaked block,
   neither jax nor ``paddle_tpu`` imported.
29. ``DataParallel`` (after phase 2): two ranks on card 0 over gloo,
   started by ``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 2 --devices 0,0`` (this script with ``--hybrid-rank``,
   the launch phases 30-31 share),
   GPT-3 1.3B at full width cut to 2 layers, O1 bf16, AdamW (the fused
   step), B 2 x S 2048 a rank from ``DistributedBatchSampler`` (rank and
   world from the environment), 2 steps: the mean loss within 2e-2 of
   one process on the concatenated batches, the two ranks' parameters
   bit-equal after the steps, every gradient's bytes all-reduced once a
   step, rank 0's parameters within 2 x lr x steps of one process's,
   flash and ``fused_adamw`` launches on each rank; the step times, the
   all-reduce's share, each rank's peak.
30. Tensor-parallel training (after phase 29): first the new kernel
   entries against their plain versions (flash over a rank's heads with
   ``mask_heads`` equal to the whole launch's slices, ``fused_adamw``'s
   split norm), then two ranks on card 0 over gloo through the launcher
   (``--hybrid-rank``) under ``fleet.init`` at mp 2: GPT-3 1.3B
   (``tensor_parallel=True``, 4 of 24 layers, 8 heads a rank), O1 bf16,
   AdamW on the fused step with ``ClipGradByGlobalNorm(1.0)`` and a
   GradScaler through ``fleet.distributed_optimizer``, B 2 x S 2048, 3
   steps (dropout 0.1 in the last); then one step of Llama-2 7B (2 of 32
   layers) at mp 2.  Against one process from the same seed on the same
   batches (run first, its parameters saved): losses within 2e-2,
   gathered parameters (``models/convert.py`` ``full_state_dict``) within
   2 x lr x steps; each rank holds under 0.6 of the weights' bytes;
   flash and ``fused_adamw`` launches on each rank, ``optimizer.fused``
   without ``fallback``; step time, the collectives' share and count.
31. ZeRO (same ranks, ``fleet.init`` at sharding 2): GPT-3 1.3B (2
   layers) under ``group_sharded_parallel`` at ``os``, ``os_g`` and
   ``p_g_os``, B 2 a rank, 2 steps each, against one process on the
   concatenated batches: losses and parameters as phase 30's bounds;
   a rank's moments about half of one process's, gradients half from
   ``os_g``, parameters half at ``p_g_os``.
32. Pipeline, tensor-sequence and ZeRO-3 parallelism of the hybrid step
   (same ranks, ``distributed/fleet/hybrid_step.py``), GPT-3 1.3B's
   widths (H 2048, 16 heads, I 8192, V 50304, S 2048) in float32, random
   weights from a seed on the card: a. ``make_hybrid_train_step`` at
   pp 2 x vpp 2, 4 layers (one a chunk), 4 micro-batches of 1 row; b. at
   mp 2 with sequence parallelism, 2 layers, the same batch shape; c.
   ``make_zero3_train_step`` at dp 2 (grain 0), 2 layers, 1 row a rank x
   2 micro-batches; 2 Adam steps each, against ``serial_train_step`` run
   first in one process on the card from the same parameters and
   batches: losses within rtol 2e-4 / atol 2e-5, the ranks' gathered
   parameters bit-equal (a SHA-256 each) and within 2 x lr x steps of
   one process's; the three flash kernels launched on every rank
   (and ``fused_adamw``, once a step, in c), no plain route.  Each part
   prints its step times, per rank the ring's sends and receives with
   their bytes and time, the collectives' count, bytes and share of the
   step, and ``bubble_fraction`` beside the schedule's tick count.

Any failure raises and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA card is present or the package is not
beside it.  The line before the last is a JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time

MEM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"torch.bfloat16": 989e12,   # dense bf16 tensor-core rate
            "torch.float16": 989e12,    # dense fp16 tensor-core rate
            "torch.float32": 67e12}     # fp32 outside the tensor cores
NH, HD, BS, BATCH, MAX_CONTEXT = 16, 128, 64, 8, 2048
TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 4, 2048, 6, 1e-4
MOE_E = 4                            # experts of the GPT-MoE phases
# serving runs per configuration of phases 13, 14, 18 and 20, and rounds
# of phases 11-12: one since phases 24-27 joined the run (the script's
# time limit; 3 and 2 before them)
REPEATS = 1
EXTRAS_REPEATS = 1
SPEC_LENS = [400 + 600 * i // (BATCH - 1) for i in range(BATCH)]  # phase 12
LLAMA_NH = 32                        # llama2_7b's heads (phase 14)
LLAMA_TRAIN_LAYERS, LLAMA_TRAIN_S = 8, 4096    # phase 16
# Llama-2 7B served at full width in phases 14, 18, 23c and 27d: 4 of
# its 32 layers (the script's time limit; 8 before phases 30-31 joined)
LLAMA_SERVE_LAYERS = 4
# the fp32 cuts held card against CPU, GPT-3 1.3B's and Llama-2 7B's (the
# time limit: their CPU sides); phase 28c's at tp_degree=2 is deeper
CUT_LAYERS = 2
TP_CUT_LAYERS = 4
CUT_LABEL = f"gpt3_1p3b {CUT_LAYERS} layers fp32"
MOE_CUT_LAYERS = 2                   # GPT-MoE's cuts: block 1 is the MoE one
BERT_B, BERT_S = 8, 512              # phase 17, bench.py's bench_bert_base
# fp16: one rounding of P, dS and the output is 2^-11 relative, bf16's
# 2^-8 eight times finer: bf16's limits about five-fold tighter
TOL = {"torch.float32": dict(atol=2e-5, rtol=1e-4),
       "torch.bfloat16": dict(atol=2e-2, rtol=0.0),
       "torch.float16": dict(atol=4e-3, rtol=2e-3)}
GRAD_TOL = {"torch.float32": dict(atol=1e-4, rtol=1e-4),
            "torch.bfloat16": dict(atol=2e-2, rtol=1e-2),
            "torch.float16": dict(atol=4e-3, rtol=2e-3)}
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
    # (dropped keys), the draft model's shape in phase 12 (gpt3_350m: hd
    # 64, its prompts 32 tokens into decoding, with and without dropped
    # keys), then the main path's lengths (the prompts, 32 tokens into
    # decoding)
    edge = [0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 1000, 2047, 2048]
    draft = [n + 32 for n in SPEC_LENS]
    path = [n + 32 for n in path_lens]
    # (row, table column, entry): rows 256, 511 and 2048 of `edge`, and
    # three rows of `draft`, lose keys
    edge_bad = ((6, 2, -1), (8, 7, -1), (12, 20, 10 ** 6))
    draft_bad = ((0, 3, -1), (4, 9, 10 ** 6), (7, 16, -1))
    errs, path_case = {}, {}
    for dtype in (torch.float32, bf16, torch.float16):
        # fp16: bf16's cases and hd 256 (the fp16 instances' third width)
        extra = ((edge, edge_bad, 256),) if dtype == torch.float16 else ()
        for lens, bad, hd in ((edge, (), HD), (edge, edge_bad, HD),
                              (draft, (), 64), (draft, draft_bad, 64),
                              *extra, (path, (), HD)):
            k, v, tables = _pool_case(gen, lens, dtype, hd=hd)
            for r, c, entry in bad:
                tables[r, c] = entry
            q = torch.randn((len(lens), NH, hd), generator=gen,
                            device="cuda").to(dtype)
            sl = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
            out = pa.paged_attention(q, k, v, tables, sl)
            ref = pa.paged_attention_reference(q.float(), k.float(),
                                               v.float(), tables, sl)
            torch.cuda.synchronize()
            err = _compare("paged_decode", out, ref, dtype)
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            if lens[0] == 0 and out[0].abs().max().item() != 0.0:
                raise AssertionError("paged_decode: a len-0 row is not zero")
            _log(f"paged_decode {dtype} hd={hd} lens={lens}"
                 + (" out-of-pool entries" if bad else "")
                 + f": max_abs_err={err:.3e}")
        path_case[dtype] = (q, k, v, tables, sl, err)
    q, k, v, tables, sl, err = path_case[bf16]
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
    q16, k16, v16, t16, sl16, _ = path_case[torch.float16]
    fp16_ms = _graph_ms(lambda: pa.paged_attention(q16, k16, v16, t16, sl16),
                        200)
    _log(f"paged_decode fp16 at the path shape: card {fp16_ms:.4f} ms "
         f"beside bf16 {ms:.4f} ms (x{fp16_ms / ms:.3f}); fp16 max_abs_err "
         f"over its cases {errs[torch.float16]:.3e}")
    rows["paged_decode"] = dict(max_abs_err=err, ms=ms, host_ms=host_ms,
                                plain_ms=plain, bound_ms=bound, bound_by=by,
                                library_ms=None,
                                ms_by_split_keys=by_split, fp16_ms=fp16_ms,
                                fp16_max_abs_err=errs[torch.float16])
    del path_case, q16, k16, v16, t16, sl16

    # --- flash_fwd: the largest prefill bucket (one 2048-token prompt),
    # a ragged length, a GQA group, Sq < Sk, hd 64 and 256, Sq > Sk (its
    # first Sq - Sk rows see no key: zeros, lse -1e30), and the phase-12
    # draft model's prompt (gpt3_350m: nh 16, hd 64, a 1024 bucket)
    cases = [(1, 2048, 2048, NH, NH, HD), (2, 1000, 1000, NH, NH, HD),
             (1, 300, 1000, NH, 4, HD), (1, 2048, 2048, 2 * NH, 2 * NH, 64),
             (1, 1000, 1000, NH // 2, NH // 4, 256),
             (2, 700, 300, NH, NH, HD), (1, 1024, 1024, NH, NH, 64)]
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
    rows["paged_chunk"]["verify_shape"] = verify_checks(gen, path_lens)
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

    bf16, fp16 = torch.bfloat16, torch.float16
    fp16_err = 0.0
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
    for dtype in (torch.float32, bf16, fp16):
        for label, starts, s, shape in cases:
            for bad in (False, True):
                _, err = _chunk_case(gen, starts, s, dtype, bad, **shape)
                if dtype == fp16:
                    fp16_err = max(fp16_err, err)
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
            for dtype in (torch.float32, bf16, fp16):
                _, err = _chunk_case(gen, [0, 187, 441, 953], 70, dtype,
                                     bad=True)
                if dtype == fp16:
                    fp16_err = max(fp16_err, err)
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
    (q16, k16, v16, t16, st16), _ = _chunk_case(gen, [1024], 256, fp16)

    def chunk16():
        return pa.paged_chunk_attention(q16, k16, v16, t16, st16)
    fp16_ms = _time_ms(chunk16, 50)
    # the card's time alone (a replayed graph: the eager loop's ~0.03 ms
    # launches are the host's)
    graph_ms, fp16_graph_ms = _graph_ms(chunk, 200), _graph_ms(chunk16, 200)
    _log(f"paged_chunk fp16 at the serving path's shape: {fp16_ms:.4f} ms "
         f"beside bf16 {ms:.4f} ms (x{fp16_ms / ms:.3f}) in an eager loop; "
         f"from a replayed graph {fp16_graph_ms:.4f} beside "
         f"{graph_ms:.4f} ms (x{fp16_graph_ms / graph_ms:.3f}); fp16 "
         f"max_abs_err over its cases {fp16_err:.3e}")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
               bound_by=by, library_ms=None, tflops=flops / ms / 1e9,
               fp16_ms=fp16_ms, fp16_max_abs_err=fp16_err,
               graph_ms=graph_ms, fp16_graph_ms=fp16_graph_ms,
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


def _verify_case(gen, starts, s, dtype, free=0, bad=False):
    """``paged_verify_attention`` against the plain version at the spec
    tick's shape: one row of s verify positions per slot at ``starts``,
    the first ``free`` rows free slots (start 0 on an all-zero table row:
    the pad block)."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    k, v, tables = _pool_case(gen, starts, dtype, extra_cols=s)
    tables[:free] = 0
    if bad:            # dropped keys, in a live row and at the table's end
        tables[3, 1], tables[-1, -1] = -1, 10 ** 6
    q = torch.randn((len(starts), s, NH, HD), generator=gen,
                    device="cuda").to(dtype)
    st = torch.as_tensor(starts, dtype=torch.int32, device="cuda")
    n = pa.paged_verify_attention.launches
    out = pa.paged_verify_attention(q, k, v, tables, st)
    if pa.paged_verify_attention.launches != n + 1:
        raise AssertionError("paged_verify_attention did not count its "
                             "launch")
    ref = pa.paged_chunk_attention_reference(q.float(), k.float(), v.float(),
                                             tables, st)
    torch.cuda.synchronize()
    return (q, k, v, tables, st), _compare("paged_verify", out, ref, dtype)


def verify_checks(gen, path_lens):
    """paged_chunk at the speculative verify's shape (through
    ``paged_verify_attention``): 8 slots, s = k in 2, 4, 8, mixed starts
    with two free slots on all-zero table rows, a row across a block edge
    and a row ending at the table's last key, with and without out-of-pool
    entries, in fp32 and bf16 (bf16: 8 x 16 x 1 = 128 blocks, fewer than
    the card's SMs, so the keys are split and merged).  Then timed in bf16
    at s 4 with the serving lengths + 64 as starts (a verify 64 tokens
    into decoding), beside ``paged_decode`` (one decode step) at the same
    lengths.  Returns the numbers."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa

    bf16, fp16 = torch.bfloat16, torch.float16
    fp16_err = 0.0
    starts = [0, 0, 63, 64, 700, 1023, 1500, 2040]
    for dtype in (torch.float32, bf16, fp16):
        for s in (2, 4, 8):
            for bad in (False, True):
                _, err = _verify_case(gen, starts, s, dtype, free=2, bad=bad)
                if dtype == fp16:
                    fp16_err = max(fp16_err, err)
                _log(f"paged_verify {dtype} s={s} starts={starts}, rows 0-1 "
                     f"free" + (", out-of-pool entries" if bad else "")
                     + f": max_abs_err={err:.3e}")
    s = 4
    starts = [n + 64 for n in path_lens]
    (q, k, v, tables, st), err = _verify_case(gen, starts, s, bf16)
    per, n_split = pa.chunk_split(len(starts), NH, s, tables.shape[1], BS)
    keys = [st0 + j + 1 for st0 in starts for j in range(s)]
    nbytes = 2 * len(starts) * s * NH * HD * 2 \
        + sum(st0 + s for st0 in starts) * NH * HD * 2 * 2 \
        + tables.numel() * 4 + len(starts) * 4
    flops = 4 * NH * HD * sum(keys)

    def verify():
        return pa.paged_verify_attention(q, k, v, tables, st)

    ms = _graph_ms(verify, 200)
    host_ms = _time_ms(verify, 200)
    plain = _time_ms(lambda: pa.paged_chunk_attention_reference(
        q, k, v, tables, st), 10)
    bound, by = _bound(nbytes, flops, bf16)
    q1 = q[:, 0].contiguous()
    decode_ms = _graph_ms(lambda: pa.paged_attention(q1, k, v, tables, st),
                          200)
    (q16, k16, v16, t16, st16), _ = _verify_case(gen, starts, s, fp16)
    fp16_ms = _graph_ms(lambda: pa.paged_verify_attention(
        q16, k16, v16, t16, st16), 200)
    _log(f"paged_verify fp16 at the verify shape: card {fp16_ms:.4f} ms "
         f"beside bf16 {ms:.4f} ms (x{fp16_ms / ms:.3f}); fp16 max_abs_err "
         f"{fp16_err:.3e}")
    row = dict(B=len(starts), s=s, starts=starts, keys_per_split=per,
               n_split=n_split, max_abs_err=err, ms=ms, host_ms=host_ms,
               fp16_ms=fp16_ms, fp16_max_abs_err=fp16_err,
               plain_ms=plain, bound_ms=bound, bound_by=by,
               tflops=flops / ms / 1e9,
               paged_decode_same_lengths_ms=decode_ms)
    _log(f"paged_chunk bf16 at the verify shape B={len(starts)} s={s} "
         f"starts={starts} ({n_split} splits of {per} keys): card "
         f"{ms:.4f} ms (host loop {host_ms:.4f}), plain {plain:.4f} ms, "
         f"bound {bound:.4f} ms ({by}), {ms / bound:.1f}x the bound, "
         f"{row['tflops']:.2f} TFLOP/s; paged_decode at the same lengths "
         f"(one decode step) {decode_ms:.4f} ms")
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
    flash_bwd_dkv against their plain versions in fp32, bf16 and fp16;
    times at the training shape (bf16, B 4, S 2048, causal), and in fp16
    beside bf16 and beside ``F.scaled_dot_product_attention`` in fp16 on
    the same inputs.  Updates ``rows``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp16 = torch.bfloat16, torch.float16
    # (label, B, Sq, Sk, nkv, causal, masked, dropout rate)
    cases = [("training shape", TRAIN_B, TRAIN_S, TRAIN_S, NH, True, False,
              0.0),
             ("ragged", 2, 1000, 1000, NH, True, False, 0.0),
             ("GQA", 1, 1024, 1024, 4, True, False, 0.0),
             ("Sq < Sk", 2, 300, 1000, NH, True, False, 0.0),
             ("Sq > Sk", 2, 1000, 300, NH, True, False, 0.0),
             ("kv mask", 2, 512, 512, NH, False, True, 0.0),
             ("dropout 0.1", 2, 1024, 1024, NH, True, False, 0.1)]
    # every case at hd 128 in the three types, and bf16 and fp16 (the
    # tensor-core kernels) at hd 64 and 256 too, the training shape aside
    runs = [(dtype, HD, case) for dtype in (torch.float32, bf16, fp16)
            for case in cases]
    runs += [(dtype, hd, case) for dtype in (bf16, fp16) for hd in (64, 256)
             for case in cases[1:]]
    fp16_errs = {}
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
        if dtype == fp16:
            for key, e in zip(("out", "lse", "dq", "dk", "dv"), errs):
                fp16_errs[key] = max(fp16_errs.get(key, 0.0), e)
        if (dtype, label) == (bf16, "training shape"):
            timed = (q, k, v, do, out, lse, errs)
        if (dtype, label) == (fp16, "training shape"):
            timed16 = (q, k, v, do, out, lse)
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
    # float16 at the training shape: the same tensor-core kernels on fp16
    # tiles, beside bf16 (same bound: 2-byte operands, the same rate) and
    # beside sdpa in fp16 on the same inputs
    q, k, v, do, out, lse = timed16
    fp16_ms = {
        "flash_fwd": _time_ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                              10),
        "flash_bwd_dq": _time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, True), 10),
        "flash_bwd_dkv": _time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, out, lse, do, True), 10)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib16_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib16_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
    errs16 = {"flash_fwd": max(fp16_errs["out"], fp16_errs["lse"]),
              "flash_bwd_dq": fp16_errs["dq"],
              "flash_bwd_dkv": max(fp16_errs["dk"], fp16_errs["dv"])}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = rows[name]
        r["fp16_ms"] = fp16_ms[name]
        r["fp16_max_abs_err"] = errs16[name]
        r["fp16_library_ms"] = lib16_fwd if name == "flash_fwd" \
            else lib16_bwd
        _log(f"{name} fp16 timing B={B} S={S} causal: ms={r['fp16_ms']:.4f}"
             f" (bf16 {r['ms']:.4f}: x{r['fp16_ms'] / r['ms']:.3f}) "
             f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) fp16 "
             f"library_ms={r['fp16_library_ms']:.4f}"
             + (" (sdpa backward, dq+dkv)" if name != "flash_fwd" else "")
             + f"; worst fp16 error over every case {errs16[name]:.3e} "
             f"(atol {TOL['torch.float16']['atol']}, rtol "
             f"{TOL['torch.float16']['rtol']})")
    pair16 = fp16_ms["flash_bwd_dq"] + fp16_ms["flash_bwd_dkv"]
    _log(f"fp16 flash_bwd_dq + flash_bwd_dkv = {pair16:.4f} ms beside the "
         f"fp16 sdpa backward on its own {lib16_bwd:.4f} ms: "
         f"{pair16 / lib16_bwd:.2f}x")
    del timed16, q, k, v, do, out, lse, qt, kt, vt, lib_out
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
    inputs (both exact), and the combine within one 16-bit rounding of the
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
    # one rounding of the float32 sum: relative 2^-8 (bf16), 2^-11
    # (fp16; absolute 2^-25, half the spacing of fp16's subnormals)
    torch.testing.assert_close(
        got.float(), want32,
        atol=2.0 ** -25 if x.dtype == torch.float16 else 0.0,
        rtol={torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
              torch.float16: 2.0 ** -11}[x.dtype],
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
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    xh, rh = x.to(torch.float16), r.to(torch.float16)
    _, fp16_err32 = _moe_exact("train step routing", xh, rh, w, flat, inv)
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
    disp["fp16_ms"] = _time_ms(lambda: mo.moe_dispatch(xh, inv), 50)
    comb["fp16_ms"] = _time_ms(lambda: mo.moe_combine(rh, w, flat), 50)
    # the 16-bit types also from replayed graphs (the card's time alone)
    for row, fn, args in ((disp, mo.moe_dispatch, ((xb, inv), (xh, inv))),
                          (comb, mo.moe_combine, ((rb, w, flat),
                                                  (rh, w, flat)))):
        for ty, a in zip(("bf16", "fp16"), args):
            row[f"{ty}_graph_ms"] = _graph_ms(lambda: fn(*a), 100)
    # fp16 dispatch is exact (_moe_exact); combine against the float32
    # sum of the same fp16 rows: one fp16 rounding
    disp["fp16_max_abs_err"] = 0.0
    comb["fp16_max_abs_err"] = fp16_err32
    # the 16-bit bounds: the same rows in 2 bytes an element
    disp["fp16_bound_ms"], _ = _bound((filled + EC) * M * 2 + EC * 4, 0,
                                      torch.float16)
    comb["fp16_bound_ms"], _ = _bound(
        (kept + T) * M * 2 + flat.numel() * 8, 2 * kept * M, torch.float32)
    rows_out["moe_dispatch"] = disp
    rows_out["moe_combine"] = comb
    for name in ("moe_dispatch", "moe_combine"):
        r_ = rows_out[name]
        _log(f"{name} fp32 timing on the train step's block-1 routing "
             f"T={T} M={M} E={MOE_E} C={cap} ({kept} of {flat.numel()} "
             f"choices kept, {filled} of {EC} slots filled): ms="
             f"{r_['ms']:.4f} (bf16 {r_['bf16_ms']:.4f}, fp16 "
             f"{r_['fp16_ms']:.4f}; from replayed graphs bf16 "
             f"{r_['bf16_graph_ms']:.4f}, fp16 {r_['fp16_graph_ms']:.4f}) "
             f"plain_ms="
             f"{r_['plain_ms']:.4f} bound_ms={r_['bound_ms']:.4f} "
             f"({r_['bound_by']}) library_ms={r_['library_ms']:.4f} "
             f"({r_['library_call']})")
    del x, r, w, flat, inv, x_pad, r_pad, xb, rb, xh, rh, lib
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 2

def _counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import moe as mo
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import weight_only as wo
    return {"flash_fwd": fa.flash_attention_fwd,
            "paged_decode": pa.paged_attention,
            "paged_chunk": pa.paged_chunk_attention,
            "paged_verify_attention": pa.paged_verify_attention,
            "moe_dispatch": mo.moe_dispatch,
            "moe_combine": mo.moe_combine,
            "weight_only_matmul": wo.weight_only_matmul,
            "weight_only_gemm": wo.weight_only_gemm}


def _plain_counters():
    """The callers' plain routes (head dims no kernel takes), counted
    apart from the launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"flash_fwd": fa.flash_attention_fwd,
            "paged_decode": pa.paged_attention,
            "paged_chunk": pa.paged_chunk_attention,
            "paged_verify_attention": pa.paged_verify_attention}


def _zero_counts():
    from paddle_tpu_torch.ops import weight_only as wo
    for fn in _counters().values():
        fn.launches = 0
    for fn in _plain_counters().values():
        fn.plain_calls = 0
    wo.weight_only_matmul.dequant_calls = 0


def _plain_calls():
    return {name: fn.plain_calls for name, fn in _plain_counters().items()}


def serve(model, prompts, chunk, time_ticks=False, profile=False,
          **engine_kw):
    """Serve one request per prompt (64 new tokens, odd ones sampled) on
    one engine with the serving settings (8 slots, block 64, context 2048,
    8 steps per tick; ``engine_kw`` adds to them: by default CUDA graphs
    and the overlapped loop are on), every launch count and plain route
    count at 0 first; returns the run's numbers.  The program grid is
    captured (``warmup()``) before the clock starts, as a server does
    before traffic; its time is ``warmup_s``.  ``time_ticks`` (overlap off
    only) synchronises the card before each decode tick (plain or
    speculative) and sums the ticks' wall time to their harvest, for ms
    per decode step beside the prefills.  ``profile`` runs the traffic
    (not the warmup) under ``torch.profiler`` (:func:`_profiled`) and adds
    its kernels on the card to the result, with the kernel records the
    profile lost (:func:`_lost_records`, the graphs counted by
    :func:`_counted_graphs`)."""
    counting = _counted_graphs() if profile else contextlib.nullcontext()
    with counting as tally:
        return _serve(model, prompts, chunk, time_ticks, profile, tally,
                      **engine_kw)


def _serve(model, prompts, chunk, time_ticks, profile, tally, **engine_kw):
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    eng = ServingEngine(model, max_batch=BATCH, max_context=MAX_CONTEXT,
                        block_size=BS, steps_per_tick=8,
                        prefill_chunk=chunk, device="cuda", **engine_kw)
    reqs = [Request(p, max_new_tokens=64, do_sample=bool(i % 2),
                    temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i)
            for i, p in enumerate(prompts)]
    tick_s = [0.0]
    if time_ticks:
        if eng.overlap:
            raise ValueError("ticks are timed with overlap off")
        dispatch, harvest, t = eng._dispatch_tick, eng._harvest, [0.0]

        def timed_dispatch(*a):
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
            return dispatch(*a)

        def timed_harvest(*a):
            out = harvest(*a)
            tick_s[0] += time.perf_counter() - t[0]
            return out
        eng._dispatch_tick, eng._harvest = timed_dispatch, timed_harvest
    warm = eng.warmup() if eng.cuda_graphs else None
    _zero_counts()

    def traffic():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    kernels, lost = None, None
    if profile:
        events = []

        def counted_traffic():
            tally["kernels"] = 0
            return traffic()
        wall, kernels = _profiled(counted_traffic, lambda: torch.ones(
            (256, 256), device="cuda").matmul(torch.ones((256, 256),
                                                         device="cuda")),
                                  events)
        lost = _lost_records(events, tally["kernels"])
        del events
    else:
        wall = traffic()
    if time_ticks:
        # the wrappers hold the engine's bound methods: drop them, so the
        # engine (its pools and graphs) goes with its last reference and
        # not with the cyclic collector, after the next engine is built
        del eng._dispatch_tick, eng._harvest
    from paddle_tpu_torch.ops import weight_only as wo
    launches = {name: fn.launches for name, fn in _counters().items()}
    dequant_calls = wo.weight_only_matmul.dequant_calls
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
    _check_graphs(eng, st)
    n_tok = sum(len(r.output_ids) for r in reqs)
    ttfts = [r.t_first - r.t_enqueue for r in reqs]
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                ttft_mean_s=sum(ttfts) / len(ttfts), ttfts=ttfts,
                ttft_max_s=max(ttfts), steps=st["steps"], ticks=st["ticks"],
                prefill_chunks=st["prefill_chunks"], launches=launches,
                plain_calls=plain, dequant_calls=dequant_calls,
                tick_s=tick_s[0], stats=st,
                warmup=warm, replays=st["graphs"]["replays"],
                overlapped=st["overlapped_ticks"], kernels=kernels,
                lost_records=lost,
                streams=[list(r.output_ids) for r in reqs])


def _check_graphs(eng, st):
    """A default engine on the card captured its grid and replayed it."""
    if eng.cuda_graphs and not (st["warmup"]["programs"] > 0
                                and st["graphs"]["replays"] > 0):
        raise AssertionError(f"CUDA graphs: warmup {st.get('warmup')}, "
                             f"graphs {st['graphs']}")


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
             f"steps in {run['ticks']} ticks ({run['overlapped']} chained), "
             f"{run['prefill_chunks']} chunks, {run['replays']} graph "
             f"replays after a warmup of {run['warmup']['programs']} "
             f"programs in {run['warmup']['warmup_s']:.2f} s, launches "
             f"{run['launches']}")
        runs[chunk] = run
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(runs[0]["streams"],
                                      runs[256]["streams"]))
    _log(f"streams equal across the two prefill modes: {same} of {BATCH} "
         "(bf16 numerics of two attention kernels; informational); greedy "
         "streams' leading tokens equal: "
         f"{_agreement(runs[256]['streams'], runs[0]['streams'])} of 64")
    # the whole-prompt run is profiled in graphs_phase, per engine mode
    where_the_time_goes(model, prompts, 256)
    runs["graphs"] = graphs_phase(model, prompts)
    t = time.perf_counter()
    runs["crash_only"] = crash_only_phase(model, prompts)
    _log(f"[phase 19: {time.perf_counter() - t:.1f} s]")
    t = time.perf_counter()
    runs["observability"] = observability_phase(model, prompts)
    _log(f"[phase 20: {time.perf_counter() - t:.1f} s]")
    t = time.perf_counter()
    runs["tp"] = tp_phase(model, prompts, runs)
    _log(f"[phase 28: {time.perf_counter() - t:.1f} s]")
    sampling_cost(cfg.vocab_size)
    return runs


def graphs_phase(model, prompts):
    """Phase 2's whole-prompt mix three ways, ``REPEATS`` runs each in
    turns: the eager programs (``cuda_graphs=False``), CUDA graphs with
    the overlapped loop off, and the default engine (graphs and overlap).
    Streams must be equal across all its runs and the launch counts of
    the eager and graph runs equal.  Medians of tokens/s and mean TTFT; ms
    per decode step where overlap is off (the card synchronised before
    each tick, the tick's wall to its harvest); the idle share from one
    profiled run each; the warmup's time and grid."""
    configs = (("eager", "eager programs", True,
                dict(cuda_graphs=False, overlap=False)),
               ("graphs", "CUDA graphs, overlap off", True,
                dict(overlap=False)),
               ("overlap", "CUDA graphs, overlap on (default)", False, {}))
    runs = {key: [] for key, _, _, _ in configs}
    for _ in range(REPEATS):
        for key, _, timed, kw in configs:
            runs[key].append(serve(model, prompts, 0, time_ticks=timed,
                                   **kw))
    base = runs["eager"][0]
    for key, rs in runs.items():
        for r in rs:
            if r["streams"] != base["streams"]:
                raise AssertionError(f"graphs phase: {key} streams differ "
                                     "from the eager programs'")
        if key != "overlap" and rs[0]["launches"] != base["launches"]:
            raise AssertionError(f"graphs phase: {key} launches "
                                 f"{rs[0]['launches']} != eager "
                                 f"{base['launches']}")
    out = {}
    for key, name, timed, kw in configs:
        rs = runs[key]
        r = dict(rs[0])
        r["tokens_per_s_runs"] = [x["tokens_per_s"] for x in rs]
        r["tokens_per_s"] = _median(r["tokens_per_s_runs"])
        r["ttft_mean_s"] = _median([x["ttft_mean_s"] for x in rs])
        r["ms_per_step"] = _median([x["tick_s"] / max(x["steps"], 1) * 1e3
                                    for x in rs]) if timed else None
        r["warmup_s"] = _median([x["warmup"]["warmup_s"] for x in rs]) \
            if rs[0]["warmup"] else None
        r["profile"] = where_the_time_goes(model, prompts, 0, key, **kw)
        step = "not timed (overlap on)" if r["ms_per_step"] is None \
            else f"{r['ms_per_step']:.3f} ms per decode step"
        warm = "no warmup" if r["warmup"] is None else (
            f"warmup {r['warmup_s']:.3f} s for {r['warmup']['programs']} "
            f"programs ({len(r['warmup']['grid'])} grid entries)")
        _log(f"graphs phase, {name}: median of {REPEATS} runs "
             f"{r['tokens_per_s']:.1f} tokens/s (runs "
             + ", ".join(f"{x:.1f}" for x in r["tokens_per_s_runs"])
             + f"), mean TTFT {r['ttft_mean_s'] * 1e3:.1f} ms, {step}, "
             f"idle share {r['profile']['idle']:.3f}; {warm}; "
             f"{r['steps']} steps in {r['ticks']} ticks "
             f"({r['overlapped']} chained), {r['replays']} replays")
        out[key] = r
    _log("graphs phase: streams equal in all runs; tokens/s against the "
         "eager programs: graphs {:.2f}x, graphs with overlap {:.2f}x".format(
             out["graphs"]["tokens_per_s"] / out["eager"]["tokens_per_s"],
             out["overlap"]["tokens_per_s"] / out["eager"]["tokens_per_s"]))
    return out


# -------------------------------------------------------------- phase 19

def _wait(cond, what, timeout=300.0):
    """Poll ``cond`` until it holds; raises after ``timeout`` seconds."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"crash-only phase: timed out waiting for "
                                 f"{what}")
        time.sleep(0.005)


def _crash_requests(prompts, vocab):
    """Phase 19's traffic: phase 2's 8 requests (64 new tokens, odd ones
    sampled) at priorities 0 and 1, then two greedy requests on phase 11's
    1024-token system prompt: with a 101-token suffix (it registers the
    prompt's 17 full blocks), then with a 37-token one (it hits the 16
    blocks of the system prompt, and so does it again after an import)."""
    from paddle_tpu_torch.inference.serving import Request
    system = _prefix_prompts(vocab)[1::-1]
    return ([Request(p, max_new_tokens=64, do_sample=bool(i % 2),
                     temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i,
                     priority=i % 2) for i, p in enumerate(prompts)]
            + [Request(p, max_new_tokens=32, seed=1100 + i)
               for i, p in enumerate(system)])


def _engine(model, **kw):
    from paddle_tpu_torch.inference.serving import ServingEngine
    kw = {"steps_per_tick": 8, **kw}
    return ServingEngine(model, max_batch=BATCH, max_context=MAX_CONTEXT,
                         block_size=BS, device="cuda", **kw)


def _no_leak(label, eng):
    st = eng.stats()
    if st["free_blocks"] != eng.num_blocks or st["reserved"] != 0:
        raise AssertionError(f"{label}: blocks leaked: {st}")
    return st


def crash_only_phase(model, prompts):
    """Phase 19: crash-only serving of GPT-3 1.3B in bf16 (phase 2's
    model), parts a-e of the module docstring.  Returns the launches of
    part a's run (the ``crash_only`` path) and the printed numbers."""
    import shutil
    import threading
    import torch
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.testing import chaos

    vocab = model.cfg.vocab_size
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "crash_only_export")
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator().manual_seed(19)
    bad_prompts = [torch.randint(1, vocab, (n,), generator=gen).tolist()
                   for n in (200, 260)]

    # the fault-free reference: the same requests through run()
    ref = _crash_requests(prompts, vocab)
    eng = _engine(model)
    for r in ref:
        eng.add_request(r)
    eng.run()
    _no_leak("phase 19 reference", eng)
    want = [list(r.output_ids) for r in ref]
    del eng

    # a. quarantine, cancellation and drain through serve_forever
    reqs = _crash_requests(prompts, vocab)
    target = reqs[2]                       # cancelled after 16 tokens
    eng = _engine(model, prefix_export_dir=root)
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_forever, args=(stop,),
                            daemon=True)
    old = flight_recorder.set_enabled(True)
    try:
        loop.start()
        _wait(lambda: eng.ready, "warmup")
        _zero_counts()
        bad1 = Request(bad_prompts[0], max_new_tokens=16, seed=7)
        with chaos.fail_at("serving.prefill.dispatch", on_calls=[1, 2],
                           exc=RuntimeError) as fault:
            eng.add_request(bad1)
            _wait(lambda: bad1.outcome is not None, "the first poison")
        bad2 = Request(bad_prompts[1], max_new_tokens=16, seed=8,
                       priority=1)
        with chaos.nan_logits("serving.prefill", rids=[bad2.rid]) as nan:
            eng.add_request(bad2)
            for r in reqs:
                eng.add_request(r)
            _wait(lambda: len(target.output_ids) >= 16, "16 tokens")
            target.cancel()
            _wait(lambda: bad2.outcome is not None
                  and all(r.outcome is not None for r in reqs),
                  "every request")
        eng.request_drain()
        loop.join(120)
        if loop.is_alive():
            raise AssertionError("serve_forever did not return after the "
                                 "drain")
    finally:
        flight_recorder.set_enabled(old)
        stop.set()
    launches = {name: fn.launches for name, fn in _counters().items()}
    if any(_plain_calls().values()):
        raise AssertionError(f"phase 19a took plain routes: "
                             f"{_plain_calls()}")
    st = _no_leak("phase 19a", eng)
    drain = st["drain"]
    if (bad1.outcome, bad2.outcome, fault.fires, nan.fires) != \
            ("poisoned", "poisoned", 2, 2) or st["tick_errors"] != 4 \
            or st["poisoned_requests"] != 2:
        raise AssertionError(f"phase 19a: poison {bad1.outcome} "
                             f"{bad2.outcome}, fires {fault.fires} "
                             f"{nan.fires}, stats {st}")
    if target.outcome != "cancelled" or \
            target.output_ids != want[2][:len(target.output_ids)]:
        raise AssertionError(f"phase 19a: cancelled request "
                             f"{target.outcome}, {target.output_ids}")
    for i, r in enumerate(reqs):
        if r is not target and (r.outcome != "finished"
                                or r.output_ids != want[i]):
            raise AssertionError(f"phase 19a: request {i} {r.outcome}, "
                                 "stream differs from the fault-free run")
    for name in ("flash_fwd", "paged_decode", "paged_chunk"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 19a: {name} never launched")
    export = drain["export"]
    if export is None or "error" in export or export["blocks"] <= 0 \
            or st["prefix_cache"]["hits"] < 1:
        raise AssertionError(f"phase 19a: export {export}, "
                             f"{st['prefix_cache']}")
    hit_stream = reqs[-1].output_ids
    _log(f"phase 19a, serve_forever: 2 poisoned (tick_errors "
         f"{st['tick_errors']}), 1 cancelled after "
         f"{len(target.output_ids)} tokens, {BATCH + 1} finished equal to "
         f"the fault-free run; drain {drain['drained_s']:.3f} s (cancelled "
         f"waiting {drain['cancelled_waiting']}, evicted "
         f"{drain['evicted_running']}); export of {export['blocks']} "
         f"blocks, {export['bytes']} bytes in {export['export_s']:.3f} s; "
         f"launches {launches} ({card_name()})")
    del eng, loop

    # b. a real NaN on the card, attributed to its slot by the decode
    # program (host sampling), the watchdog on
    from paddle_tpu_torch.ops import paged_attention
    pa_decode = paged_attention.paged_attention

    def nan_run(poison):
        eng = _engine(model, steps_per_tick=1, device_sampling=False)
        eng.warmup()
        rs = [Request(p, max_new_tokens=16, do_sample=bool(i % 2),
                      temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i)
              for i, p in enumerate(prompts)]
        for r in rs:
            eng.add_request(r)
        before = pa_decode.launches
        old = flight_recorder.set_enabled(True)
        try:
            eng.step()
            if poison:
                victim = rs[3]
                col = len(victim.prompt_ids) // BS
                blk = int(eng.tables[victim.slot, col])
                for kk, _ in eng.pools:
                    kk[:, blk] = float("nan")
            eng.run()
        finally:
            flight_recorder.set_enabled(old)
        prog = eng._programs[("decode",)]
        if prog.graph is None or prog.replays <= 0 or \
                pa_decode.launches <= before:
            raise AssertionError("phase 19b: the decode program was not "
                                 "replayed from its graph")
        # a decode row's NaN evicts its slot at the harvest: no tick fails
        if _no_leak("phase 19b", eng)["tick_errors"] != 0:
            raise AssertionError("phase 19b: a tick failed")
        return rs
    clean = nan_run(False)
    hit = nan_run(True)
    for i, (a, b) in enumerate(zip(clean, hit)):
        ok = (b.outcome == "error" and len(b.output_ids) == 2) if i == 3 \
            else (b.outcome == "finished" and b.output_ids == a.output_ids)
        if not ok:
            raise AssertionError(f"phase 19b: request {i} {b.outcome} "
                                 f"after {len(b.output_ids)} tokens")
    _log(f"phase 19b, NaN keys in one slot's block on the card: that slot "
         f"alone ended error after 2 tokens (no tick failed), the other "
         f"{BATCH - 1} streams equal the fault-free run's; decode program "
         "replayed from its graph")

    # c. the tick watchdog
    eng = _engine(model, tick_timeout_s=0.5)
    eng.warmup()
    first = Request(prompts[0], max_new_tokens=64, seed=1000)
    eng.add_request(first)
    t0 = time.perf_counter()
    with chaos.delay_at("serving.harvest", 3.0, on_calls=[1]) as delay:
        eng.run()
    took = time.perf_counter() - t0
    again = Request(prompts[0], max_new_tokens=64, seed=1000)
    eng.add_request(again)
    eng.run()
    _no_leak("phase 19c", eng)
    if (first.outcome, delay.fires, eng.tick_errors, again.outcome) != \
            ("error", 1, 1, "finished") or again.output_ids != want[0]:
        raise AssertionError(f"phase 19c: {first.outcome}, "
                             f"{eng.tick_errors} tick errors, then "
                             f"{again.outcome}")
    _log(f"phase 19c, tick watchdog 0.5 s against a 3 s harvest stall: the "
         f"tick failed (error, blocks freed) and run() returned in "
         f"{took:.3f} s; the same engine then served the fault-free stream "
         f"({card_name()})")
    del eng

    # d. import, against a cold engine
    t0 = time.perf_counter()
    cold = _engine(model)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = _engine(model, prefix_export_dir=root)
    ctor_s = time.perf_counter() - t0
    imp = eng.stats()["prefix_cache"].get("import")
    if imp is None or imp["blocks"] != export["blocks"] \
            or imp["skipped_corrupt"] != 0:
        raise AssertionError(f"phase 19d: import {imp}")
    ptrs = [t.data_ptr() for pair in eng.pools for t in pair]
    ttft = {}
    for key, e in (("cold", cold), ("import", eng)):
        e.warmup()
        _zero_counts()
        r = Request(reqs[-1].prompt_ids, max_new_tokens=32, seed=1101)
        e.add_request(r)
        e.run()
        ttft[key] = r.t_first - r.t_enqueue
        if key == "import":
            if r.output_ids != hit_stream:
                raise AssertionError("phase 19d: the imported hit's stream "
                                     "differs from the warm engine's")
            if paged_attention.paged_chunk_attention.launches <= 0 or \
                    e.stats()["prefix_cache"]["hits"] != 1:
                raise AssertionError("phase 19d: no prefix hit on paged_chunk")
    if [t.data_ptr() for pair in eng.pools for t in pair] != ptrs:
        raise AssertionError("phase 19d: a pool moved")
    if eng.stats()["tick_errors"] or cold.stats()["tick_errors"]:
        raise AssertionError("phase 19d: a tick failed")
    _log(f"phase 19d, import: {imp['blocks']} blocks; engine construction "
         f"with the import {ctor_s:.3f} s, without {cold_s:.3f} s; the "
         f"hit streams as the warm engine's; TTFT of the "
         f"{len(reqs[-1].prompt_ids)}-token prompt {ttft['import'] * 1e3:.1f}"
         f" ms (hit on imported blocks) against {ttft['cold'] * 1e3:.1f} ms "
         f"(cold miss) ({card_name()})")
    del eng, cold
    gc.collect()
    torch.cuda.empty_cache()

    # e. the CPU tests' fault schedule, card against CPU
    cpu, card = _cut_models(gpt3_1p3b(num_layers=CUT_LAYERS))
    got = [crash_schedule(m, dev, os.path.join(root, f"cut_{dev}"))
           for m, dev in ((card, "cuda"), (cpu, "cpu"))]
    if got[0] != got[1]:
        raise AssertionError(f"phase 19e: card {got[0]} != CPU {got[1]}")
    _log(f"phase 19e, the fault schedule on a {CUT_LAYERS}-layer fp32 cut: "
         f"card equal to CPU (outcomes, streams, counters, stats, drain "
         f"report): "
         f"{json.dumps(got[0]['summary'])}")
    return dict(launches=launches, tick_errors=st["tick_errors"],
                export=export, import_=imp, ttft=ttft, ctor_s=ctor_s,
                cold_s=cold_s, watchdog_s=took)


_SECONDS = ("drained_s", "export_s", "path", "warmup", "graphs",
            "latency")


# -------------------------------------------------------------- phase 20

def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, path, body=None, timeout=300):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse(url, body, stop_after=None):
    """POST /generate and read the stream: the token ids and the terminal
    ``(event, payload)``; with ``stop_after`` the client hangs up after
    that many tokens (no terminal frame)."""
    toks, event = [], None
    resp = _post(url, "/generate", body)
    try:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                d = json.loads(line[6:])
                if event is not None:
                    return toks, (event, d)
                toks.append(d["token"])
                if stop_after is not None and len(toks) >= stop_after:
                    return toks, None
    finally:
        resp.close()
    raise AssertionError("an SSE stream ended without a terminal frame")


def _get(url, path):
    import urllib.error
    import urllib.request
    try:
        r = urllib.request.urlopen(url + path, timeout=60)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _bodies(prompts, **kw):
    """Phase 2's 8 requests as ``POST /generate`` bodies."""
    return [dict(prompt_ids=p, max_new_tokens=64, do_sample=bool(i % 2),
                 temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i,
                 timeout_s=300, **kw) for i, p in enumerate(prompts)]


def _add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def _gate_runs(model, prompts):
    """20a: phase 13's default engine (graphs, overlap) and its overlap-off
    twin (ms per decode step), each warmed once; ``REPEATS`` rounds of the
    mix with the metrics gate on and off in turns.  Between runs the
    prefix index lets go of every block, so each run starts as a fresh
    engine's would, without a second capture."""
    import torch
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.observability import metrics

    engines = {"overlap": _engine(model),
               "timed": _engine(model, overlap=False)}
    for eng in engines.values():
        eng.warmup()
    eng = engines["timed"]
    dispatch, harvest, tick = eng._dispatch_tick, eng._harvest, [0.0, 0.0]

    def timed_dispatch(*a):
        torch.cuda.synchronize()
        tick[0] = time.perf_counter()
        return dispatch(*a)

    def timed_harvest(*a):
        out = harvest(*a)
        tick[1] += time.perf_counter() - tick[0]
        return out
    eng._dispatch_tick, eng._harvest = timed_dispatch, timed_harvest

    def traffic(eng):
        eng.release_exported_prefix()
        reqs = [Request(p, max_new_tokens=64, do_sample=bool(i % 2),
                        temperature=0.9, top_k=40, top_p=0.95,
                        seed=1000 + i) for i, p in enumerate(prompts)]
        steps0, tick[1] = eng.steps, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _no_leak("phase 20a", eng)
        n = sum(len(r.output_ids) for r in reqs)
        return dict(tokens_per_s=n / wall,
                    ttft_mean_s=sum(r.t_first - r.t_enqueue for r in reqs)
                    / len(reqs),
                    ms_per_step=tick[1] / max(eng.steps - steps0, 1) * 1e3,
                    streams=[list(r.output_ids) for r in reqs])
    runs = {True: [], False: []}
    old = metrics.enabled()
    try:
        for _ in range(REPEATS):
            for gate in (True, False):
                metrics.set_enabled(gate)
                runs[gate].append((traffic(engines["overlap"]),
                                   traffic(engines["timed"])))
    finally:
        metrics.set_enabled(old)
        del eng._dispatch_tick, eng._harvest
    base = runs[True][0][0]["streams"]
    for gate, rs in runs.items():
        for a, b in rs:
            if a["streams"] != base or b["streams"] != base:
                raise AssertionError("phase 20a: streams differ between "
                                     "runs or gates")
    out = {}
    for gate, rs in runs.items():
        out[gate] = dict(
            tokens_per_s=_median([a["tokens_per_s"] for a, _ in rs]),
            tokens_per_s_runs=[a["tokens_per_s"] for a, _ in rs],
            ttft_mean_s=_median([a["ttft_mean_s"] for a, _ in rs]),
            ms_per_step=_median([b["ms_per_step"] for _, b in rs]))
    out["streams"] = base
    return out


def observability_phase(model, prompts):
    """Phase 20: the serving engine's observability and its scheduler's
    budget on GPT-3 1.3B in bf16 (phase 2's model and mix), parts a-f of
    the module docstring.  Returns the launches of parts b, c and e (the
    ``observability`` path) and the printed numbers."""
    import threading
    import torch
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.observability import export, metrics

    card = card_name()
    launches = {}

    # a. the metrics gate's cost on phase 13's run
    t = time.perf_counter()
    gate = _gate_runs(model, prompts)
    on, off = gate[True], gate[False]
    _log(f"phase 20a, metrics gate on / off, median of {REPEATS} runs each "
         f"in turns: {on['tokens_per_s']:.1f} / {off['tokens_per_s']:.1f} "
         f"tokens/s (on/off {on['tokens_per_s'] / off['tokens_per_s']:.4f};"
         " runs on " + ", ".join(f"{x:.1f}" for x in on["tokens_per_s_runs"])
         + "; off " + ", ".join(f"{x:.1f}" for x in off["tokens_per_s_runs"])
         + f"), mean TTFT {on['ttft_mean_s'] * 1e3:.2f} / "
         f"{off['ttft_mean_s'] * 1e3:.2f} ms, {on['ms_per_step']:.3f} / "
         f"{off['ms_per_step']:.3f} ms per decode step (overlap off); "
         f"streams equal in all runs ({time.perf_counter() - t:.1f} s; "
         f"{card})")
    want = gate["streams"]

    # b. the HTTP frontend: serve_forever behind http_port
    metrics.reset()
    export.clear_requests()
    port = _free_port()
    eng = _engine(model, http_port=port)
    url = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_forever, args=(stop,),
                            daemon=True)
    bodies = _bodies(prompts)
    out = [None] * len(bodies)
    errors = []

    def client(i):
        try:
            out[i] = _sse(url, bodies[i])
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
    try:
        loop.start()
        _wait(lambda: eng.ready, "warmup")
        _zero_counts()
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(300)
        sse_s = time.perf_counter() - t0
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"phase 20b: clients failed: {errors}")
        _, scrape = _get(url, "/metrics")
        _, recent = _get(url, "/requests")
        code_ok, _ = _get(url, "/healthz")
        # a client that hangs up after 10 tokens
        gone, _ = _sse(url, dict(bodies[0], seed=77, max_new_tokens=min(
            512, MAX_CONTEXT - len(prompts[0]))), stop_after=10)
        _wait(lambda: eng.stats()["running"] == 0, "the cancelled request")
        cancelled = eng.finished[-1]
        st_cancel = eng.stats()
        drain = _post(url, "/drain")
        drain_code = drain.status
        drain.close()
        code_drain, health = _get(url, "/healthz")
        loop.join(120)
        if loop.is_alive():
            raise AssertionError("phase 20b: serve_forever did not return "
                                 "after POST /drain")
    finally:
        stop.set()
        from paddle_tpu_torch.observability import http as obs_http
        obs_http.stop()
    _add_launches(launches, {n: fn.launches
                             for n, fn in _counters().items()})
    streams = [o[0] for o in out]
    if streams != want or [o[1][0] for o in out] != ["done"] * BATCH:
        raise AssertionError(
            "phase 20b: SSE streams differ from run()'s: "
            f"{sum(a == b for a, b in zip(streams, want))} of {BATCH} equal")
    n_tok = sum(len(s) for s in streams)
    lines = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
             for ln in scrape.splitlines() if not ln.startswith("#")}
    records = json.loads(recent)
    if lines.get("serving_ttft_seconds_count") != BATCH or \
            lines.get("serving_tokens_out") != n_tok or \
            [r["outcome"] for r in records] != ["finished"] * BATCH:
        raise AssertionError(
            f"phase 20b: scrape ttft count "
            f"{lines.get('serving_ttft_seconds_count')}, tokens "
            f"{lines.get('serving_tokens_out')} of {n_tok}, records "
            f"{[r['outcome'] for r in records]}")
    if cancelled.outcome != "cancelled" or len(gone) != 10 or \
            st_cancel["free_blocks"] != eng.num_blocks:
        raise AssertionError(f"phase 20b: the hung-up request "
                             f"{cancelled.outcome}, {st_cancel}")
    if code_ok != 200 or drain_code != 202 or code_drain != 503 or \
            json.loads(health)["reason"] != "draining":
        raise AssertionError(f"phase 20b: healthz {code_ok}, drain "
                             f"{drain_code}, then {code_drain} {health}")
    _no_leak("phase 20b", eng)
    if any(_plain_calls().values()):
        raise AssertionError(f"phase 20b took plain routes: "
                             f"{_plain_calls()}")
    p99 = {q: lines.get(f'serving_ttft_seconds{{quantile="{q}"}}')
           for q in ("0.5", "0.99")}
    _log(f"phase 20b, POST /generate x {BATCH} concurrent on serve_forever: "
         f"every SSE stream equals run()'s, {n_tok} tokens in {sse_s:.3f} s; "
         f"/metrics: serving_ttft_seconds_count {BATCH}, p50 / p99 "
         f"{p99['0.5']} / {p99['0.99']} s, tokens {n_tok}; /requests "
         f"{BATCH} finished; a client gone after 10 tokens ended "
         f"{cancelled.outcome} with its blocks back; /healthz 200, then "
         f"503 draining after POST /drain ({card})")
    del eng, loop

    # c. 256-token chunks at chunk budgets 1, 2 and auto
    step_ms = on["ms_per_step"]
    budgets = (("1", dict(prefill_chunks_per_tick=1)),
               ("2", dict(prefill_chunks_per_tick=2)),
               ("auto", dict(prefill_chunks_per_tick=4,
                             chunks_per_tick_auto=True,
                             tpot_slo_ms=1.5 * step_ms)))
    chunked = {}
    for label, kw in budgets:
        metrics.reset()
        run = serve(model, prompts, 256, **kw)
        _add_launches(launches, run["launches"])
        lat = run["stats"]["latency"]
        chunked[label] = dict(run, tpot_p99_s=lat["tpot"]["p99"],
                              budget=run["stats"]["chunk_budget"])
    base = chunked["1"]
    for label, r in chunked.items():
        if r["streams"] != base["streams"] or \
                r["prefill_chunks"] != base["prefill_chunks"]:
            raise AssertionError(f"phase 20c: budget {label}: streams or "
                                 "chunks differ from budget 1's")
    _log("phase 20c, 256-token chunks by budget (streams and "
         f"{base['prefill_chunks']} chunks equal): " + "; ".join(
             f"{label}: mean TTFT {r['ttft_mean_s'] * 1e3:.1f} ms, p99 TPOT "
             f"{r['tpot_p99_s'] * 1e3:.3f} ms, {r['ticks']} ticks, "
             f"{r['tokens_per_s']:.1f} tokens/s, budget at the end "
             f"{r['budget']}" for label, r in chunked.items())
         + f" (auto: tpot_slo_ms {1.5 * step_ms:.3f} = 1.5 x 20a's step; "
         f"{card})")

    # d. SLO shedding through POST /generate
    metrics.reset()
    eng = _engine(model, slo_shed=True, ttft_slo_ms=1e-6,
                  shed_queue_depth=2)
    eng.warmup()
    eng.add_request(Request(prompts[0], max_new_tokens=8, seed=1))
    eng.run()                                  # primes the TTFT sketch
    from paddle_tpu_torch.observability import http as obs_http
    srv = obs_http.MetricsServer(0, "127.0.0.1", engine=eng)
    bodies = _bodies(prompts)
    for i, b in enumerate(bodies):
        b["priority"] = i % 2
    out = [None] * len(bodies)
    errors = []

    def client_d(i):
        try:
            out[i] = _sse(srv.url, bodies[i])
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
    try:
        clients = []
        for i in range(len(bodies)):
            # one at a time, so the queue's order is the bodies' order
            clients.append(threading.Thread(target=client_d, args=(i,),
                                            daemon=True))
            clients[-1].start()
            _wait(lambda: len(eng.waiting) == i + 1, "an enqueue")
        eng.run()
        for c in clients:
            c.join(300)
    finally:
        srv.close()
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"phase 20d: clients failed: {errors}")
    # the JAX rule: while more than 2 wait, the newest of the lowest
    # priority goes
    queue = list(range(len(bodies)))
    victims = []
    while len(queue) > 2:
        v = len(queue) - 1
        for j in range(len(queue) - 2, -1, -1):
            if bodies[queue[j]]["priority"] < bodies[queue[v]]["priority"]:
                v = j
        victims.append(queue.pop(v))
    shed = [i for i, o in enumerate(out) if o[1][0] == "error"]
    st = _no_leak("phase 20d", eng)
    if sorted(victims) != shed or st["slo_sheds"] != len(victims) or any(
            out[i][1][1]["reason"] != "slo_shed" for i in shed) or any(
            out[i][0] != want[i] for i in queue):
        raise AssertionError(f"phase 20d: shed {shed}, the rule's "
                             f"{sorted(victims)}, slo_sheds "
                             f"{st['slo_sheds']}")
    _log(f"phase 20d, ttft_slo_ms 1e-6 with one request served: 8 queued "
         f"at priorities 0/1, depth 2: shed {shed} (the JAX rule's), each "
         f"ending in an SSE error frame with reason slo_shed; slo_sheds "
         f"{st['slo_sheds']}; {queue} streamed as run()'s")
    del eng

    # e. the cow program at a partial-block prefix hit
    system = _prefix_prompts(model.cfg.vocab_size)
    cow = {}
    for graphs_on in (True, False):
        e = _engine(model, cuda_graphs=graphs_on)
        if graphs_on:
            e.warmup()
            _zero_counts()
        rs = []
        for p in (system[0], system[-1]):
            rs.append(e.add_request(Request(p, max_new_tokens=32,
                                            seed=2000)))
            e.run()
        prog = e._programs[("cow",)]
        cow[graphs_on] = dict(streams=[r.output_ids for r in rs],
                              replays=prog.replays,
                              captured=prog.graph is not None,
                              hits=e.stats()["prefix_cache"]["hits"])
        if graphs_on:
            _add_launches(launches, {n: fn.launches
                                     for n, fn in _counters().items()})
        _no_leak("phase 20e", e)
        del e
    if cow[True]["streams"] != cow[False]["streams"] or \
            not cow[True]["captured"] or cow[True]["replays"] <= 0 or \
            cow[True]["hits"] != 1:
        raise AssertionError(f"phase 20e: {cow}")
    _log(f"phase 20e, the {len(system[-1])}-token system prompt after its "
         f"registration (1023 tokens reused, its last block copied on "
         f"write): the cow program replayed {cow[True]['replays']} time "
         "from its graph; streams equal cuda_graphs=False's")

    # f. card against CPU on a 1-layer fp32 cut
    gc.collect()
    torch.cuda.empty_cache()
    cpu, cut = _cut_models(gpt3_1p3b(num_layers=CUT_LAYERS))
    got = [observability_schedule(m, dev) for m, dev in ((cut, "cuda"),
                                                         (cpu, "cpu"))]
    if got[0] != got[1]:
        raise AssertionError(f"phase 20f: card {got[0]} != CPU {got[1]}")
    _log(f"phase 20f, chunk budget 2, shedding and tracing on a "
         f"{CUT_LAYERS}-layer fp32 cut: card equal to CPU (streams, "
         f"outcomes, stats, trace "
         f"records without seconds): {json.dumps(got[0]['summary'])}")
    for name in ("flash_fwd", "paged_chunk", "paged_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"phase 20: {name} never launched")
    return dict(launches=launches, gate=gate, chunked={
        k: {f: v[f] for f in ("ttft_mean_s", "tpot_p99_s", "ticks",
                              "tokens_per_s", "budget")}
        for k, v in chunked.items()}, shed=shed, cow=cow[True])


_TRACE_SECONDS = ("queue_wait_s", "prefill_s", "ttft_s", "tpot_mean_s",
                  "e2e_s", "unix_time")


def observability_schedule(model, dev):
    """Phase 20f on one device: 3 requests in 64-token chunks at budget 2,
    then shedding (ttft_slo_ms 1e-6, depth 1) of 4 queued requests after
    one primes the sketch; returns what must be equal on card and CPU."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.observability import metrics

    gen = torch.Generator().manual_seed(29)
    vocab = model.cfg.vocab_size
    ps = [torch.randint(1, vocab, (n,), generator=gen).tolist()
          for n in (150, 70, 100, 40, 60, 80, 90)]
    out = {}

    def record(key, eng, reqs):
        st = _plain(eng.stats())
        out[key] = dict(
            streams=[list(r.output_ids) for r in reqs],
            outcomes=[r.outcome for r in reqs], stats=st,
            traces=[None if r.trace is None else
                    {k: (v == r.rid if k == "rid" else v)
                     for k, v in r.trace.items() if k not in _TRACE_SECONDS}
                    for r in reqs])
        if st["free_blocks"] != eng.num_blocks:
            raise AssertionError(f"{key} on {dev}: blocks leaked")

    metrics.reset()
    eng = ServingEngine(model, max_batch=2, max_context=256, block_size=BS,
                        steps_per_tick=8, device=dev, prefill_chunk=64,
                        prefill_chunks_per_tick=2)
    reqs = [eng.add_request(Request(p, max_new_tokens=12, seed=3 + i,
                                    do_sample=i == 1))
            for i, p in enumerate(ps[:3])]
    eng.run()
    record("budget2", eng, reqs)
    metrics.reset()
    eng = ServingEngine(model, max_batch=2, max_context=256, block_size=BS,
                        steps_per_tick=8, device=dev, slo_shed=True,
                        ttft_slo_ms=1e-6, shed_queue_depth=1)
    eng.add_request(Request(ps[3], max_new_tokens=4))
    eng.run()
    reqs = [eng.add_request(Request(p, max_new_tokens=8, priority=i % 2))
            for i, p in enumerate(ps[3:])]
    eng.run()
    record("shed", eng, reqs)
    out["summary"] = {k: v["outcomes"] for k, v in out.items()}
    return out




def _plain(doc):
    """A stats or drain document without its seconds (the latency
    sketches' too), paths and the card's graph counters."""
    if isinstance(doc, dict):
        return {k: _plain(v) for k, v in doc.items() if k not in _SECONDS}
    return doc


def crash_schedule(model, dev, root):
    """The fault schedule of ``tests/test_torch_chaos.py`` on one device,
    the block ledger armed: poison by two dispatch failures, a decode NaN
    (host sampling, the watchdog on), a failed tick, a drain with a
    waiting request and the export, then the import and its hit.  Returns
    everything that must be equal on the card and the CPU."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.testing import chaos

    gen = torch.Generator().manual_seed(23)
    vocab = model.cfg.vocab_size
    ps = [torch.randint(1, vocab, (n,), generator=gen).tolist()
          for n in (70, 90, 100, 60)]
    system = torch.randint(1, vocab, (128,), generator=gen).tolist()
    out = {}

    def engine(**kw):
        kw = {"steps_per_tick": 8, **kw}
        return ServingEngine(model, max_batch=2, max_context=256,
                             block_size=BS, device=dev, blocksan=True, **kw)

    injected = dict(poison=2, decode_nan=0, tick_failure=1, drain=0,
                    import_=0)

    def record(key, eng, reqs):
        st = eng.stats()
        out[key] = dict(outcomes=[r.outcome for r in reqs],
                        streams=[list(r.output_ids) for r in reqs],
                        strikes=[r._strikes for r in reqs],
                        stats=_plain(st))
        if st["free_blocks"] != eng.num_blocks:
            raise AssertionError(f"{key} on {dev}: blocks leaked")
        if st["tick_errors"] != injected[key]:
            raise AssertionError(f"{key} on {dev}: tick_errors "
                                 f"{st['tick_errors']}, {injected[key]} "
                                 "injected")

    eng = engine()
    bad = eng.add_request(Request(ps[0], max_new_tokens=8))
    with chaos.fail_at("serving.prefill.dispatch", on_calls=[1, 2],
                       exc=RuntimeError):
        eng.run()
    ok = eng.add_request(Request(ps[1], max_new_tokens=8))
    eng.run()
    record("poison", eng, [bad, ok])
    old = flight_recorder.set_enabled(True)
    try:
        eng = engine(device_sampling=False, steps_per_tick=1)
        reqs = [eng.add_request(Request(p, max_new_tokens=8,
                                        do_sample=i == 1, seed=5 + i))
                for i, p in enumerate(ps[1:])]
        with chaos.nan_logits("serving.decode", rids=[reqs[0].rid]):
            eng.run()
        record("decode_nan", eng, reqs)
    finally:
        flight_recorder.set_enabled(old)
    eng = engine()
    reqs = [eng.add_request(Request(p, max_new_tokens=8)) for p in ps[:2]]
    with chaos.fail_at("serving.tick.dispatch", on_calls=[1],
                       exc=RuntimeError):
        eng.run()
    record("tick_failure", eng, reqs)
    eng = engine(prefix_export_dir=root)
    reqs = [eng.add_request(Request(system + p[:9], max_new_tokens=8))
            for p in ps[:2]]
    eng.run()
    reqs.append(eng.add_request(Request(ps[2], max_new_tokens=8)))
    eng.request_drain()
    out["drain_report"] = _plain(eng.drain())
    record("drain", eng, reqs)
    eng = engine(prefix_export_dir=root)
    reqs = [eng.add_request(Request(system + ps[1][:9], max_new_tokens=8))]
    eng.run()
    record("import_", eng, reqs)
    out["summary"] = {k: v["outcomes"] for k, v in out.items()
                      if isinstance(v, dict) and "outcomes" in v}
    out["summary"]["tick_errors"] = sum(
        v["stats"]["tick_errors"] for v in out.values()
        if isinstance(v, dict) and "stats" in v)
    return out


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


def _profiled(fn, warm, events=None):
    """``fn()`` under ``torch.profiler`` after a warm-up cycle that runs
    ``warm()`` with the card's tracing already on and discards its
    records (a cycle's first kernel records can otherwise go missing: a
    profiled train step once showed 23 of its 24 forward launches).
    Returns ``fn``'s result and the active cycle's kernels on the card;
    ``events``, a list, receives the cycle's events for
    :func:`_lost_records`."""
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
    if events is not None:
        events.extend(prof.events())
    return out, _device_kernels(prof)


def _graph_kernel_nodes(graph) -> int:
    """The kernel nodes of a kept CUDA graph (``raw_cuda_graph``), child
    graphs' included, through the driver API: what one replay must show
    the profiler."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def count(handle):
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        total, kind, child = 0, ctypes.c_int(), ctypes.c_void_p()
        for node in nodes:
            if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)):
                raise RuntimeError("cuGraphNodeGetType failed")
            if kind.value == 0:            # CU_GRAPH_NODE_TYPE_KERNEL
                total += 1
            elif kind.value == 4:          # CU_GRAPH_NODE_TYPE_GRAPH
                if cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node),
                                                    ctypes.byref(child)):
                    raise RuntimeError("cuGraphChildGraphNodeGetGraph "
                                       "failed")
                total += count(ctypes.c_void_p(child.value))
        return total
    return count(ctypes.c_void_p(graph.raw_cuda_graph()))


@contextlib.contextmanager
def _counted_graphs():
    """Inside: every CUDA graph the engine captures is kept and its kernel
    nodes counted at capture (then instantiated as before), and every
    replay of an engine program adds its graph's count to the yielded
    tally's ``"kernels"``: the kernel records a complete profile of the
    replays holds."""
    import torch
    from paddle_tpu_torch.inference import graphs

    tally = {"kernels": 0}

    class CountedGraph(torch.cuda.CUDAGraph):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

        def capture_end(self):
            super().capture_end()
            self.kernel_nodes = _graph_kernel_nodes(self)
            self.instantiate()

    replay = graphs.Program.replay

    def counted_replay(prog):
        replay(prog)
        if prog.graph is not None:
            tally["kernels"] += prog.graph.kernel_nodes

    saved = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph, graphs.Program.replay = CountedGraph, counted_replay
    try:
        yield tally
    finally:
        torch.cuda.CUDAGraph, graphs.Program.replay = saved, replay


def _lost_records(events, graph_kernels):
    """Kernel records a profile lacks: of the graph replays, the tally of
    their kernel nodes (:func:`_counted_graphs`) less the kernel records
    that carry a ``cudaGraphLaunch``'s correlation id; of the kernels
    launched one by one, the launches with no kernel record of their
    id.  Returns ``(lost, expected, extra)``: ``extra``, records of graph
    replays beyond the tally, counts as no loss."""
    import collections

    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    seen = collections.Counter(
        e.id for e in events if e.device_type == cuda
        and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(("Memcpy", "Memset")))
    graph_ids = {e.id for e in events
                 if e.device_type == cpu and "GraphLaunch" in e.name}
    direct = [e.id for e in events
              if e.device_type == cpu and "LaunchKernel" in e.name]
    in_graphs = sum(seen[i] for i in graph_ids)
    lost = max(graph_kernels - in_graphs, 0) + sum(
        1 for i in direct if not seen[i])
    return lost, graph_kernels + len(direct), max(in_graphs - graph_kernels,
                                                  0)


def _check_by_name(label, got, want, lost):
    """Launches by kernel name (``got``: name -> (count, us)) against the
    wrappers' counts (``want``: name -> count), within what the profile
    measurably lost: no name shows more than its count, and the shortfall
    over all names is at most ``lost`` records (0: exact)."""
    short = {n: want[n] - got[n][0] for n in want}
    if any(v < 0 for v in short.values()) or sum(short.values()) > lost:
        raise AssertionError(f"{label}: launches by kernel {got}, want "
                             f"{want} (the profile lost {lost} records)")


def _by_name(kernels, names):
    """Launches and device time (us) of the kernels whose names contain
    each of ``names``."""
    out = {}
    for name in names:
        hits = [e for e in kernels if name in e.key]
        out[name] = (sum(e.count for e in hits),
                     sum(e.self_device_time_total for e in hits))
    return out


def where_the_time_goes(model, prompts, chunk, label=None, nh=NH, **kw):
    """A profiled serving run (warm) with whole-prompt (``chunk`` 0) or
    chunked prefill on the engine ``kw`` asks for (by default graphs and
    overlap), with the kernel records its profile lost (of replayed
    graphs: the profiler loses a few, more the more profiles a process
    has taken; in whole runs of this script checks by name saw 231 of
    232 and 463 of 464 ``paged_chunk`` launches, 127 of 128 and 15 of 16
    ``flash_fwd``), against which the checks by name are held
    (:func:`_check_by_name`: exact when none was lost).  The card's
    busy time against the wall clock, the kernels that take it, the
    decode kernels by name, every bf16 flash_fwd launch of the prompts by
    name on the tensor-core kernel (none on the FMA one) and, chunked,
    every bf16 paged_chunk launch by name: the tensor-core kernel (and
    its merge when the wrapper splits the keys over ``nh`` heads'
    blocks), never the FMA kernel; every paged_chunk launch of prefix
    hits likewise on the tensor-core kernel.  Kernels replayed in a CUDA graph
    show on the timeline one by one.  Returns the idle share, busy and
    wall seconds, the kernel launches and the run."""
    from paddle_tpu_torch.ops import paged_attention as pa

    label = label or ("chunked" if chunk else "whole-prompt")
    run = serve(model, prompts, chunk, profile=True, **kw)
    lost, expected, extra = run["lost_records"]
    kernels = run["kernels"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n = sum(e.count for e in kernels)
    wall = run["wall_s"]
    idle = 1 - busy_us / 1e6 / wall
    _log(f"profiled {label} run: wall {wall:.3f} s, card busy "
         f"{busy_us / 1e6:.3f} s in {n} kernel launches, idle share "
         f"{idle:.3f}; max TTFT {run['ttft_max_s']:.3f} s; the profile "
         f"lost {lost} of {expected} kernel records ({extra} beyond the "
         f"graphs' nodes)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
             f"{e.key[:90]}")
    decode = _by_name(kernels, DECODE_KERNELS)
    for name, (c, _) in decode.items():
        if c == 0:
            raise AssertionError(f"profiled {label} run: {name} never ran")
    _log(f"profiled {label} run, decode kernels by name: " + ", ".join(
        f"{n} {c}x {us / 1e3:.2f} ms" for n, (c, us) in decode.items()))
    if run["launches"]["flash_fwd"]:
        flash = _by_name(kernels, ("flash_fwd_tc_kernel", "flash_fwd_kernel"))
        _check_by_name(f"profiled {label} run: flash_fwd", flash,
                       {"flash_fwd_tc_kernel": run["launches"]["flash_fwd"],
                        "flash_fwd_kernel": 0}, lost)
        _log(f"profiled {label} run, prompt kernels by name: " + ", ".join(
            f"{n} {c}x {us / 1e3:.2f} ms" for n, (c, us) in flash.items()))
    if not chunk and run["launches"]["paged_chunk"]:
        hits = _by_name(kernels, CHUNK_KERNELS)
        _check_by_name(f"profiled {label} run: prefix hits' paged_chunk",
                       hits, {"paged_chunk_tc_kernel":
                              run["launches"]["paged_chunk"],
                              "paged_chunk_kernel": 0}, lost)
        _log(f"profiled {label} run, prefix hits' kernels by name: "
             + ", ".join(f"{n} {c}x {us / 1e3:.2f} ms"
                         for n, (c, us) in hits.items()))
    if chunk:
        calls = run["launches"]["paged_chunk"]
        split = pa.chunk_split(1, nh, chunk, MAX_CONTEXT // BS, BS)[1] > 1
        got = _by_name(kernels, CHUNK_KERNELS)
        want = {"paged_chunk_tc_kernel": calls,
                "paged_chunk_merge_kernel": calls if split else 0,
                "paged_chunk_kernel": 0}
        if calls == 0:
            raise AssertionError(f"profiled {label} run: no paged_chunk "
                                 "launch")
        _check_by_name(f"profiled {label} run: paged_chunk", got, want, lost)
        chunk_us = sum(us for c, us in got.values())
        _log(f"profiled chunked run, paged_chunk kernels by name: "
             + ", ".join(f"{n} {c}x {us / 1e3:.2f} ms"
                         for n, (c, us) in got.items())
             + f"; {chunk_us / 1e3:.2f} ms of device time in {calls} "
             f"launches")
    return dict(idle=idle, busy_s=busy_us / 1e6, wall_s=wall,
                kernel_launches=n, run=run)


# --------------------------------------------------------------- phase 3

def card_vs_cpu(cfg, label=CUT_LABEL, prompt_len=96,
                chunks=(0,), quant=None, specs=(False,), new_tokens=16,
                models=None):
    """One greedy request of ``prompt_len`` tokens (``new_tokens`` new
    ones) served with each
    prefill chunk of ``chunks`` (0: whole-prompt), and with n-gram
    speculation where ``specs`` asks for it, on the card (the default
    engine and the eager programs) and on the CPU, from one state dict,
    weight-only quantized in ``quant`` mode if given: all streams equal,
    first-token logits (of the quantized twin, if quantized) within atol
    1e-3.  ``models``: the CPU and card pair of :func:`_cut_models`, if
    built already."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    cpu, card = models or _cut_models(cfg)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (prompt_len,), generator=gen)
    ctx = -(-(prompt_len + new_tokens) // BS) * BS
    streams, first = {}, []
    # the default card engine (graphs, overlap), the eager card programs,
    # the CPU
    for model, dev, graphs in ((card, "cuda", True), (card, "cuda", False),
                               (cpu, "cpu", False)):
        for chunk in chunks:
            for spec in specs:
                eng = ServingEngine(model, max_batch=1, max_context=ctx,
                                    block_size=BS, steps_per_tick=8,
                                    device=dev, cuda_graphs=graphs,
                                    prefill_chunk=chunk, quant=quant,
                                    spec_decode=spec, spec_draft="ngram")
                req = eng.add_request(Request(prompt.tolist(),
                                              max_new_tokens=new_tokens))
                eng.run()
                _check_graphs(eng, eng.stats())
                streams[dev, graphs, chunk, spec] = list(req.output_ids)
        if graphs:
            continue
        # the last engine's model: the quantized twin, if quantized
        caches = model.init_caches(1, cache_impl="paged", max_context=ctx,
                                   block_size=BS)
        with torch.no_grad():
            logits, _ = eng.model.forward_with_cache(prompt[None].to(dev),
                                                     caches, 0)
        first.append(logits[0, -1].float().cpu())
        del eng
    err = (first[0] - first[1]).abs().max().item()
    torch.testing.assert_close(first[0], first[1], atol=1e-3, rtol=0.0)
    if len({str(x) for x in streams.values()}) != 1:
        raise AssertionError(f"card and CPU streams differ (device, graphs, "
                             f"chunk, n-gram spec): {streams}")
    _log(f"card vs CPU, {label}: first-token logits "
         f"max_abs_err={err:.3e}, {new_tokens}-token greedy streams of a "
         f"{prompt_len}-token prompt equal (card graphs, card eager, CPU; "
         f"prefill chunks {list(chunks)}; n-gram spec {list(specs)})")


# -------------------------------------------------------------- phase 10

def plain_route_phase():
    """gpt3_tiny, whose head dim 32 no attention kernel takes, on the card
    through the kernels' plain versions: one greedy request with
    whole-prompt and chunked prefill and with n-gram speculation, its
    streams equal to the CPU's (and to each other), and
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
        for chunk, spec in ((0, False), (32, False), (0, True)):
            # the n-gram spec run verifies through paged_verify_attention
            eng = ServingEngine(model, max_batch=1, max_context=160,
                                block_size=16, steps_per_tick=4,
                                prefill_chunk=chunk, device=dev,
                                spec_decode=spec, spec_draft="ngram")
            req = eng.add_request(Request(prompt.tolist(),
                                          max_new_tokens=16))
            eng.run()
            _check_graphs(eng, eng.stats())
            streams[dev, chunk, spec] = list(req.output_ids)
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
    # the plain routes are attention's; the optimizer step is the fused
    # kernel's whatever the head dim
    if train_plain["flash_fwd"] <= 0 or train_launches["fused_adamw"] \
            != 2 or any(n for k, n in train_launches.items()
                         if k != "fused_adamw"):
        raise AssertionError(f"gpt3_tiny hd 32 training: plain routes "
                             f"{train_plain}, launches {train_launches}")
    _log(f"gpt3_tiny hd 32 on the card: greedy streams (whole-prompt, "
         f"chunked, n-gram spec) equal to the CPU's; plain routes serving "
         f"{serve_plain}, training {train_plain}; kernel launches "
         f"{serve_launches}, {train_launches}")


# ---------------------------------------------------------- phases 11-12

def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _interleaved(label, model, prompts, configs):
    """``EXTRAS_REPEATS`` rounds of one serving run per configuration, in turns
    (so a drift of the card or the host spreads over all of them); each
    configuration's first run gives the launches and stats (each run
    counts from 0), its runs the medians of tokens/s and mean TTFT (of all
    requests, and of the first ``BATCH``, admitted at once).  The engines
    are the default ones (graphs and overlap): no tick is timed on its
    own.  ``configs``: (key, label, chunk, engine keywords)."""
    runs = {key: [] for key, _, _, _ in configs}
    for _ in range(EXTRAS_REPEATS):
        for key, _, chunk, kw in configs:
            runs[key].append(serve(model, prompts, chunk, **kw))
    out = {}
    for key, name, _, _ in configs:
        rs = runs[key]
        r = dict(rs[0])
        r["tokens_per_s_runs"] = [x["tokens_per_s"] for x in rs]
        r["tokens_per_s"] = _median(r["tokens_per_s_runs"])
        r["ttft_mean_s"] = _median([x["ttft_mean_s"] for x in rs])
        r["ttft_first_mean_s"] = _median(
            [sum(x["ttfts"][:BATCH]) / BATCH for x in rs])
        _log(f"{label}, {name}: {r['tokens']} tokens, median of "
             f"{EXTRAS_REPEATS} "
             f"runs {r['tokens_per_s']:.1f} tokens/s (runs "
             + ", ".join(f"{x:.1f}" for x in r["tokens_per_s_runs"])
             + f"), mean TTFT {r['ttft_mean_s'] * 1e3:.1f} ms (the first "
             f"{BATCH}: {r['ttft_first_mean_s'] * 1e3:.1f} ms); "
             f"{r['steps']} decode steps in {r['ticks']} ticks "
             f"({r['overlapped']} chained), {r['prefill_chunks']} chunks, "
             f"{r['replays']} replays, warmup {r['warmup']['programs']} "
             f"programs in {r['warmup']['warmup_s']:.2f} s, launches "
             f"{r['launches']}")
        _log("  mean TTFT of the first {} by run: {}".format(
            BATCH, ", ".join(f"{sum(x['ttfts'][:BATCH]) / BATCH * 1e3:.1f}"
                             for x in rs)))
        out[key] = r
    return out


def _agreement(streams, base):
    """How far each greedy request's stream (the even ones; odd ones
    sample) agrees with ``base``'s: the common leading tokens, of 64."""
    out = []
    for i in range(0, len(base), 2):
        n = 0
        while n < len(base[i]) and n < len(streams[i]) \
                and streams[i][n] == base[i][n]:
            n += 1
        out.append(n)
    return out


def _divergence_gaps(model, prompts, streams, base):
    """Where a greedy stream first leaves ``base``'s, the dense forward's
    logit of ``base``'s token minus that of the stream's, on the prompt
    and ``base``'s tokens before it: a gap near 0 against the logits' std
    is a near-tie that bf16 rounding flips.  Returns (gaps, std)."""
    import torch
    gaps, stds = [], []
    n = _agreement(streams, base)
    with torch.no_grad():
        for i, d in zip(range(0, len(base), 2), n):
            if d >= len(base[i]):
                continue
            ids = torch.as_tensor([prompts[i] + base[i][:d]], device="cuda")
            logits = model(ids)[0, -1].float()
            gaps.append(round((logits[base[i][d]]
                               - logits[streams[i][d]]).item(), 4))
            stds.append(logits.std().item())
    return gaps, (sum(stds) / len(stds) if stds else 0.0)


def _prefix_prompts(vocab):
    """Phase 11's mix: 8 prompts on one 1024-token system prompt with
    suffixes of 37 + 64 i tokens, and the system prompt alone."""
    import torch
    gen = torch.Generator().manual_seed(5)
    system = torch.randint(1, vocab, (1024,), generator=gen).tolist()
    return [system + torch.randint(1, vocab, (37 + 64 * i,),
                                   generator=gen).tolist()
            for i in range(BATCH)] + [system]


def prefix_phase(model):
    """The prefix cache at full width: 8 requests sharing a 1024-token
    system prompt (16 full blocks), each with its own suffix of 37 + 64 i
    tokens, and a ninth that is the system prompt alone (fully cached and
    block-aligned: its last block is copied on write); prefix off,
    prefix on with whole-prompt prefill, and on with 256-token chunks.
    Then the cost of one prefill, miss against hit."""
    prompts = _prefix_prompts(model.cfg.vocab_size)
    runs = _interleaved(
        "serving gpt3_1p3b bf16, shared 1024-token prefix", model, prompts,
        [("off", "prefix off, whole-prompt", 0, dict(prefix_cache=False)),
         ("whole", "prefix on, whole-prompt", 0, dict(prefix_cache=True)),
         ("chunked", "prefix on, 256-token chunks", 256,
          dict(prefix_cache=True))])
    for key, run in runs.items():
        pc = run["stats"].get("prefix_cache")
        if key == "off":
            if pc is not None:
                raise AssertionError(f"prefix off: the cache is on: {pc}")
            continue
        if pc["hits"] <= 0:
            raise AssertionError(f"prefix on ({key}): no hit: {pc}")
        _log(f"  prefix on ({key}): hits {pc['hits']}, misses "
             f"{pc['misses']}, blocks shared {pc['blocks_shared']}, "
             f"entries {pc['entries']}, evictions {pc['evictions']}; "
             f"greedy streams' leading tokens equal to prefix off's: "
             f"{_agreement(run['streams'], runs['off']['streams'])} of 64; "
             "logit gaps at the first divergence {} (logits' std "
             "{:.3f})".format(*_divergence_gaps(
                 model, prompts, run["streams"], runs["off"]["streams"])))
    if runs["whole"]["launches"]["paged_chunk"] <= 0:
        raise AssertionError("prefix hits ran no paged_chunk launch")
    runs["prefill_cost"] = prefill_cost(model)
    return runs


def profiled_serving(label, model, prompts, chunk, **kw):
    """One serving run under ``torch.profiler`` (after a warm-up cycle):
    the card's busy share of the wall clock, the kernels that take its
    time, and every bf16 ``paged_chunk`` launch (chunk and verify) by
    name (within the records the profile lost, :func:`_check_by_name`):
    the tensor-core kernel, never the FMA one.  Returns (idle share,
    busy s, wall s)."""
    run = serve(model, prompts, chunk, profile=True, **kw)
    kernels = run["kernels"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    idle = 1 - busy / run["wall_s"]
    _log(f"  profiled {label}: wall {run['wall_s']:.3f} s, card busy "
         f"{busy:.3f} s in {sum(e.count for e in kernels)} launches, idle "
         f"share {idle:.3f}, {run['ticks']} ticks; the profile lost "
         f"{run['lost_records'][0]} of {run['lost_records'][1]} kernel "
         "records")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        _log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x"
             f"  {e.key[:80]}")
    calls = run["launches"]["paged_chunk"] \
        + run["launches"]["paged_verify_attention"]
    got = _by_name(kernels, CHUNK_KERNELS)
    lost = run["lost_records"][0]
    _check_by_name(f"profiled {label}: paged_chunk", got,
                   {"paged_chunk_tc_kernel": calls, "paged_chunk_kernel": 0},
                   lost)
    _log(f"    paged_chunk kernels by name: " + ", ".join(
        f"{n} {c}x {us / 1e3:.2f} ms" for n, (c, us) in got.items()))
    return idle, busy, run["wall_s"]


def prefill_cost(model):
    """One prompt program of the serving engine (a CUDA graph replayed)
    at the prefix phase's shapes: a miss (the whole prompt in its 2048
    bucket, ``prefill``: ``flash_fwd``) against hits (a 512- and a
    64-token suffix at start 1024, ``prefill_cont``: ``paged_chunk``):
    wall time with the card synchronised, the host's time to enqueue it
    (the inputs' copies and the replay), and the card's busy time in one
    profiled call.  Returns {label: (wall ms, host ms, device ms)}."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine

    eng = ServingEngine(model, max_batch=1, max_context=MAX_CONTEXT,
                        block_size=BS, device="cuda")
    row = np.arange(1, MAX_CONTEXT // BS + 1, dtype=np.int32)
    rng = np.random.RandomState(8)
    out = {}
    for label, kind, s, start in (
            ("miss, whole prompt 2048", "prefill", 2048, 0),
            ("hit, suffix 512 at 1024", "prefill_cont", 512, 1024),
            ("hit, suffix 64 at 1024", "prefill_cont", 64, 1024)):
        ids = rng.randint(1, model.cfg.vocab_size, (s,)).tolist()

        def call():
            return eng._forward_prompt(kind, row, ids, start)
        call()
        walls, hosts = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            hosts.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        _, kernels = _profiled(call, call)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        out[label] = (_median(walls) * 1e3, _median(hosts) * 1e3, busy)
        _log(f"  prefill {label}: wall {out[label][0]:.2f} ms, host "
             f"{out[label][1]:.2f} ms to enqueue, card busy {busy:.2f} ms "
             f"(median of 5; busy from one profiled call)")
    del eng
    return out


def _repetitive_prompts(vocab):
    """8 prompts of 400 .. 1000 tokens, each a random 48-token pattern
    repeated: the n-gram drafter's traffic."""
    import torch
    gen = torch.Generator().manual_seed(6)
    out = []
    for n in SPEC_LENS:
        pat = torch.randint(1, vocab, (48,), generator=gen).tolist()
        out.append((pat * (n // 48 + 1))[:n])
    return out


def spec_phase(model, draft):
    """Speculative decoding at full width: 8 repetitive prompts, plain
    decoding against n-gram drafts at k 4, n-gram with the adaptive ladder
    2, 4, 8, the draft model (GPT-3 350M, hd 64, random weights: low
    acceptance, so the rejections and residual draws run) at k 4, and the
    target as its own draft at k 4 (acceptance near 1: the accept and
    advance path in bf16)."""
    prompts = _repetitive_prompts(model.cfg.vocab_size)
    runs = _interleaved(
        "serving gpt3_1p3b bf16, repetitive prompts", model, prompts,
        [("plain", "plain decoding", 0, {}),
         ("ngram", "n-gram draft k 4", 0,
          dict(spec_decode=True, spec_draft="ngram", spec_k=4)),
         ("ngram_adaptive", "n-gram draft, adaptive k over 2,4,8", 0,
          dict(spec_decode=True, spec_draft="ngram", spec_adaptive=True,
               spec_k_ladder="2,4,8")),
         ("model", "draft model gpt3_350m k 4", 0,
          dict(spec_decode=True, spec_draft="model", spec_k=4,
               draft_model=draft)),
         ("self", "the target as its own draft k 4", 0,
          dict(spec_decode=True, spec_draft="model", spec_k=4,
               draft_model=model))])
    for key, run in runs.items():
        if key == "plain":
            continue
        sp = run["stats"]["speculative"]
        if run["launches"]["paged_verify_attention"] <= 0:
            raise AssertionError(f"spec {key}: no verify launch")
        _log(f"  spec {key}: accept rate {sp['accept_rate']}, accepted "
             f"{sp['accepted_tokens']} of {sp['proposed_tokens']}, k_now "
             f"{sp['k_now']}, k_switches {sp['k_switches']}, spec ticks "
             f"{sp['ticks']}, capped slots {sp['ineligible_slots']}; "
             f"greedy streams' leading tokens equal to plain decoding's: "
             f"{_agreement(run['streams'], runs['plain']['streams'])} of 64; "
             "logit gaps at the first divergence {} (logits' std "
             "{:.3f})".format(*_divergence_gaps(
                 model, prompts, run["streams"], runs["plain"]["streams"])))
    # the same weights propose what the target would choose, up to the
    # rounding between the decode and the chunk kernel: a rate far below
    # 1 means the accept path rejects what it should keep
    rate = runs["self"]["stats"]["speculative"]["accept_rate"]
    if not rate > 0.5:
        raise AssertionError(f"spec self: accept rate {rate}, want near 1")
    # one profile (its post-processing costs ~0.7 ms a launch, and the
    # draft model's run has four times the n-gram run's launches)
    runs["ngram"]["profile"] = profiled_serving(
        "spec ngram", model, prompts, 0, spec_decode=True,
        spec_draft="ngram", spec_k=4)
    return runs


def _cut_models(cfg):
    """The fp32 cut of ``cfg``'s family on the CPU and on the card from
    one state dict."""
    cpu = _model(cfg, "cpu", 1).eval()
    card = _model(cfg, "cuda", 2).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _cut_streams(model, dev, prompts, **kw):
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    eng = ServingEngine(model, max_batch=2, max_context=256, block_size=BS,
                        steps_per_tick=8, device=dev, **kw)
    reqs = [eng.add_request(Request(p, max_new_tokens=16)) for p in prompts]
    eng.run()
    st = eng.stats()
    if st["free_blocks"] != eng.num_blocks or st["reserved"] != 0:
        raise AssertionError(f"blocks leaked: {st}")
    _check_graphs(eng, st)
    return [list(r.output_ids) for r in reqs], st


def cut_checks(cfg, label=CUT_LABEL):
    """The prefix cache and speculation on a 2-layer fp32 cut, card
    against CPU: greedy streams with the prefix (a miss, a hit, and the
    128-token shared prompt alone, copied on write) equal the streams
    without it; n-gram and same-weights-draft speculation equal plain
    decoding; all equal on the card and the CPU."""
    import torch
    cpu, card = _cut_models(cfg)
    vocab = cfg.vocab_size
    gen = torch.Generator().manual_seed(7)
    system = torch.randint(1, vocab, (128,), generator=gen).tolist()
    shared = [system + torch.randint(1, vocab, (n,), generator=gen).tolist()
              for n in (40, 70)] + [system]
    pat = torch.randint(1, vocab, (48,), generator=gen).tolist()
    rep = [(pat * 5)[:200], torch.randint(1, vocab, (150,),
                                          generator=gen).tolist()]
    streams = {}
    # the default card engine (graphs, overlap), the eager card programs,
    # the CPU
    for model, dev, graphs in ((card, "cuda", True), (card, "cuda", False),
                               (cpu, "cpu", False)):
        where = dev + (" graphs" if graphs else "")
        for on in (False, True):
            out, st = _cut_streams(model, dev, shared, prefix_cache=on,
                                   cuda_graphs=graphs)
            if on and st["prefix_cache"]["hits"] != 2:
                raise AssertionError(f"cut: prefix stats {st}")
            streams["prefix", on, where] = out
        for key, kw in (("plain", {}),
                        ("ngram", dict(spec_decode=True, spec_draft="ngram")),
                        ("model", dict(spec_decode=True, spec_draft="model",
                                       draft_model=model))):
            out, st = _cut_streams(model, dev, rep, cuda_graphs=graphs, **kw)
            streams["spec", key, where] = out
            if kw:
                _log(f"  cut {key} spec on {where}: accept rate "
                     f"{st['speculative']['accept_rate']}")
    for kind in ("prefix", "spec"):
        got = {k: v for k, v in streams.items() if k[0] == kind}
        if len({str(v) for v in got.values()}) != 1:
            raise AssertionError(f"cut {kind} streams differ: {got}")
    _log(f"card vs CPU, {label}: greedy streams with and without the "
         f"prefix (hit, miss, copy on write) equal; n-gram and same-weights "
         f"draft speculation equal plain decoding; card (graphs and eager) "
         f"equal to CPU")


def serving_extras_phase():
    """Phases 11 and 12 on one GPT-3 1.3B (bf16, seed 0), then the 2-layer
    fp32 cut."""
    import torch
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt3_1p3b,
                                             gpt3_350m)
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    draft = GPTForCausalLM(gpt3_350m(max_seq_len=MAX_CONTEXT),
                           device="cuda", dtype=torch.bfloat16, seed=9)
    prefix = prefix_phase(model)
    spec = spec_phase(model, draft)
    del model, draft
    torch.cuda.empty_cache()
    cut_checks(gpt3_1p3b(num_layers=CUT_LAYERS))
    return prefix, spec


# --------------------------------------------------------------- phase 4

def _model(cfg, device, seed, dtype=None):
    """The port's model of ``cfg``'s family (GPT, Llama, or BERT with its
    MLM head), random weights from ``seed``."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cls = (GPTForCausalLM if isinstance(cfg, GPTConfig) else
           BertForMaskedLM if isinstance(cfg, BertConfig) else
           LlamaForCausalLM)
    return cls(cfg, device=device, seed=seed,
               **({} if dtype is None else dict(dtype=dtype)))


def _train_setup(cfg, device, seed, B, S, masked=False, wrap=None):
    """The model, AdamW with global-norm clipping, and one fixed batch of
    random tokens from a numpy seed: the arguments of ``compute_loss``.
    GPT and Llama: random labels.  BERT (MLM): a label on 15% of the
    tokens (the token itself), -100 elsewhere; ``masked`` pads every second
    row from a random length in [S / 4, S) (``attention_mask`` 0 there,
    and no label).  ``wrap`` (QAT) rewrites the model before the optimizer
    takes its parameters."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = _model(cfg, device, seed)
    if wrap is not None:
        model = wrap(model)
    model.train()
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    rng = np.random.RandomState(seed)
    ids, labels = (rng.randint(0, cfg.vocab_size, (B, S)) for _ in range(2))
    if not isinstance(cfg, BertConfig):
        return model, opt, tuple(torch.as_tensor(x, device=device)
                                 for x in (ids, labels))
    mask = np.ones((B, S), np.int64)
    if masked:
        for b in range(1, B, 2):
            mask[b, rng.randint(S // 4, S):] = 0
    labels = np.where((rng.uniform(size=(B, S)) < 0.15) & (mask > 0), ids,
                      -100)
    return model, opt, (torch.as_tensor(ids, device=device),
                        torch.as_tensor(labels, device=device), -100, None,
                        torch.as_tensor(mask, device=device)
                        if masked else None)


def _train_step(model, opt, batch, autocast):
    """bench.py's train step: loss under auto_cast O1 bf16, backward,
    AdamW step, clear the gradients."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(autocast, level="O1", dtype="bfloat16",
                       device=batch[0].device):
        loss = model.compute_loss(*batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _train_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.ops import moe as mo
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
            "moe_dispatch": mo.moe_dispatch,
            "moe_combine": mo.moe_combine,
            "fused_adamw": fo.fused_adamw}


def _n_moe_blocks(cfg):
    return sum(1 for i in range(cfg.num_layers)
               if getattr(cfg, "moe_num_experts", 0) > 0
               and (i + 1) % cfg.moe_every_n_layers == 0)


def _check_train_launches(label, cfg, launches, steps):
    """Each flash kernel once per layer and step; each MoE kernel once per
    MoE block and step (the MoE backward launches no kernel); the fused
    optimizer step once per step."""
    for name, n in launches.items():
        per_step = (_n_moe_blocks(cfg) if name.startswith("moe_")
                    else 1 if name == "fused_adamw" else cfg.num_layers)
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


def _flash_shortfall(cfg, kernels):
    """The tensor-core flash kernels a profile shows fewer times than
    ``cfg``'s layers, when it shows no FMA flash kernel and none too many
    times (records the profiler dropped); else {}."""
    count = dict.fromkeys(FLASH_KERNELS, 0)
    for e in kernels:
        for name in FLASH_KERNELS:
            if name in e.key:
                count[name] += e.count
    tc = [n for n in FLASH_KERNELS if "_tc_" in n]
    if any(count[n] for n in FLASH_KERNELS if n not in tc) or \
            any(count[n] > cfg.num_layers for n in tc):
        return {}
    return {n: count[n] for n in tc if count[n] < cfg.num_layers}


def _profiled_flash(label, cfg, step, takes=3):
    """``_profiled(step, step)`` with its flash kernels checked by name
    (:func:`_check_flash_kernels`), the step profiled again (up to
    ``takes`` times) while the profile shows fewer tensor-core flash
    records than the step's layers and nothing else amiss: torch.profiler
    drops kernel records (of replayed graphs, and once 2 of an eager
    train step's 24 forward launches).  The check holds exactly on the
    take it passes."""
    for take in range(1, takes + 1):
        wall, kernels = _profiled(step, step)
        short = _flash_shortfall(cfg, kernels)
        if not short or take == takes:
            break
        _log(f"{label}: profile {take} showed flash records {short} of "
             f"{cfg.num_layers} each (records dropped); profiled again")
    _check_flash_kernels(label, cfg, kernels)
    return wall, kernels


def _run_train(model, opt, batch, steps):
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
        loss = _train_step(model, opt, batch, True)
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


def train_full_width(cfg, label, B=TRAIN_B, S=TRAIN_S, masked=False):
    """6 timed steps of ``cfg`` at B x S (by default 4 x 2048; ``masked``:
    BERT's padded rows) from launch counts of 0, checked, then one
    profiled step after a warm-up step; returns the numbers (the model and
    optimizer are freed)."""
    import statistics

    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import capacity

    # the serving phases' engines, models and graphs are gone before the
    # peak is reset: the peak is the training step's alone
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _log(f"{label}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
         f"allocated before the model is built")
    model, opt, batch = _train_setup(cfg, "cuda", 0, B, S, masked)
    losses, times, launches = _run_train(model, opt, batch, TRAIN_STEPS)
    _check_train_launches(label, cfg, launches, TRAIN_STEPS)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    tokens = B * S
    fpt = model.flops_per_token(S)
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
         f"fp32 weights, auto_cast O1 bf16, AdamW, B={B} S={S}: "
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
        _train_step(model, opt, batch, True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    wall, kernels = _profiled_flash(label, cfg, step)
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    moe_us = sum(e.self_device_time_total for e in kernels
                 if "moe_" in e.key)
    idle = 1 - busy_us / 1e6 / wall
    _log(f"profiled {label} step: wall {wall * 1e3:.1f} ms, card busy "
         f"{busy_us / 1e3:.1f} ms in {sum(e.count for e in kernels)} "
         f"kernel launches, idle share {idle:.3f}; flash kernels "
         f"{flash_us / 1e3:.1f} ms = {flash_us / max(busy_us, 1):.3f} of "
         f"busy time; MoE kernels {moe_us / 1e3:.2f} ms = "
         f"{moe_us / max(busy_us, 1):.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:24]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
             f"{e.key[:90]}")
    routing = _record_routing(model, *batch) if n_exp else None
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
    model, opt, batch = _train_setup(gpt3_1p3b(dropout=0.1), "cuda", 1,
                                     TRAIN_B, TRAIN_S)
    d_losses, _, d_launches = _run_train(model, opt, batch, 2)
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


def train_card_vs_cpu(cfg, label=CUT_LABEL, B=1, S=256,
                      masked=False, wrap=None):
    """2 AdamW steps of an fp32 cut on the card and on the CPU at B x S
    from one state dict (and, for MoE, one set of routing uniforms).  Losses
    within atol 1e-4.  Parameters within 2 x lr x steps: Adam divides by
    sqrt(v), so a weight whose gradient is rounding noise (the key third of
    each qkv bias has a zero gradient in exact arithmetic) moves by up to
    about lr per step on either side."""
    import torch

    steps, init, runs = 2, None, []
    uniforms = torch.rand((steps * _n_moe_blocks(cfg), 256),
                          generator=torch.Generator().manual_seed(5))
    for dev in ("cpu", "cuda"):
        model, opt, batch = _train_setup(cfg, dev, 2, B, S, masked, wrap)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        _feed_uniforms(model, uniforms)
        losses = [_train_step(model, opt, batch, False).item()
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
    _log(f"train card vs CPU, {label}, B={B} S={S}, {steps} "
         f"AdamW steps: losses card {card_l} cpu {cpu_l}, parameters max "
         f"abs diff {err:.3e}")


# -------------------------------------------------------------- phase 21

REST_STEPS = 6                        # 21a and 21d


def _fused_counts():
    """The ``optimizer.fused`` counter by kind (the port's registry)."""
    from paddle_tpu_torch.observability import metrics
    c = metrics.get("optimizer.fused")
    return {k: int(c.value(kind=k)) if c else 0
            for k in ("hit", "miss", "fallback")}


def _rest_setup(cfg, device="cuda", seed=0, level="O1", B=TRAIN_B,
                S=TRAIN_S):
    """Phase 21's training setup: the model, AdamW (weight decay 0.01)
    under ``LinearWarmup`` (2 steps from 0) into ``CosineAnnealingDecay``
    (100 steps), ``ClipGradByGlobalNorm(1.0)``, a dynamic GradScaler
    (2^12), and at O2 ``amp.decorate`` (bf16 parameters, float32
    masters); a fixed batch of random tokens from a numpy seed."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod

    model = _model(cfg, device, seed)
    model.train()
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(LR, 100), 2,
                                0.0, LR)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12)
    rng = np.random.RandomState(seed)
    batch = tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, S)),
                                  device=device) for _ in range(2))
    return model, opt, sched, scaler, batch


def _rest_step(model, opt, sched, scaler, batch, level="O1", inject=False,
               no_sync=False):
    """One step: the loss under ``auto_cast`` at ``level`` (O0: float32),
    the scaled backward, ``scaler.step`` (the fused step), the scheduler.
    ``inject`` puts an inf into the first gradient; ``no_sync`` runs the
    scaler's step under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch
    from paddle_tpu_torch import amp
    with amp.auto_cast(level != "O0", level=level if level != "O0"
                       else "O1", dtype="bfloat16", device=batch[0].device):
        loss = model.compute_loss(*batch)
    scaler.scale(loss).backward()
    if inject:
        next(p for p in model.parameters()
             if p.grad is not None).grad.view(-1)[0] = float("inf")
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        scaler.step(opt)
    finally:
        if no_sync:
            torch.cuda.set_sync_debug_mode("default")
    opt.clear_grad()
    sched.step()
    return loss.detach()


def _rest_run(model, opt, sched, scaler, batch, steps, level="O1",
              timeline=None):
    """``steps`` timed steps from launch counts of 0 (each bracketed by the
    StepTimeline, synchronised inside); returns losses, step seconds,
    the launches and the ``optimizer.fused`` counts of the run."""
    import torch
    for fn in _train_counters().values():
        fn.launches = 0
    fused0 = _fused_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if timeline is not None:
            with timeline.step(tokens=batch[0].numel(), mode=level) as st:
                loss = _rest_step(model, opt, sched, scaler, batch, level)
                torch.cuda.synchronize()
                st.annotate(synced=True)
        else:
            loss = _rest_step(model, opt, sched, scaler, batch, level)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if timeline is not None:
            st.annotate(loss=losses[-1])
    launches = {n: fn.launches for n, fn in _train_counters().items()}
    fused = {k: v - fused0[k] for k, v in _fused_counts().items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 21: a loss is not finite: {losses}")
    return losses, times, launches, fused


def _fused_table(opt):
    (table,) = opt._fused_tables.values()
    return table


def _opt_tensors(model, opt):
    """Every tensor a step writes: parameters, masters, moments."""
    out = [p.detach() for p in model.parameters()]
    for store in opt._accumulators.values():
        out.extend(store.values())
    return out


def _equal_bits(a, b):
    """Equal bit for bit (infinities and NaNs included)."""
    import torch
    if a.dtype != b.dtype:
        return False
    ints = {2: torch.int16, 4: torch.int32}.get(a.element_size())
    if ints is not None:
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


def overflow_phase(model, opt, sched, scaler, batch):
    """21b: three more steps, an inf in one gradient at the third; every
    scaler step under the sync debug mode "error".  The overflow step
    leaves parameters, moments and masters bit-identical, halves the
    scale and keeps ``global_step``."""
    import torch
    for i in range(3):
        if i == 2:
            before = [t.clone() for t in _opt_tensors(model, opt)]
            scale, step = scaler._scale, opt._global_step
        _rest_step(model, opt, sched, scaler, batch, inject=(i == 2),
                   no_sync=True)
    torch.cuda.synchronize()
    after = _opt_tensors(model, opt)
    changed = sum(not _equal_bits(a, b) for a, b in zip(before, after))
    if changed or scaler._scale != scale / 2 or \
            opt._global_step != step or not scaler._found_inf:
        raise AssertionError(
            f"21b: {changed} of {len(after)} tensors changed, scale "
            f"{scale} -> {scaler._scale}, global_step {step} -> "
            f"{opt._global_step}, found_inf {scaler._found_inf}")
    del before
    _log(f"21b overflow: an inf in one gradient at the third step: "
         f"{len(after)} tensors (parameters, moments) bit-identical, scale "
         f"{scale} -> {scaler._scale}, global_step {step} kept; the three "
         f"scaler steps under set_sync_debug_mode('error'): no host sync")


def _optimizer_yardsticks(model, opt, batch):
    """On 21a's model: the fused kernel pair alone (CUDA events over 10
    calls at GPT-3 1.3B's parameter list: O1, global clip, a scaler), its
    bound and plain version; the path a declined step takes (the list
    rules, ``torch._foreach_*``, behind the global clip); the library call (``torch._foreach_norm``
    clip plus ``torch.optim.AdamW(fused=True)``); and whole train steps
    with phase 4's former optimizer (``torch.optim.AdamW(foreach=True)``
    behind the same clip) and with the library one."""
    import statistics

    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import fused_optimizer as fo

    dev = batch[0].device
    with amp.auto_cast(True, level="O1", dtype="bfloat16", device=dev):
        model.compute_loss(*batch).backward()
    table = _fused_table(opt)
    grads = [p.grad for p in table.params]
    step = torch.zeros(1, dtype=torch.int32, device=dev)
    scale = torch.full((1,), 1.0, device=dev)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    sc = (scale, counts, fo.ScalerConfig())
    clip = ("global", 1.0)
    n0 = fo.fused_adamw.launches
    ms = _time_ms(lambda: fo.fused_adamw(table, grads, LR, step, clip=clip,
                                         scaler=sc), 10)
    plain_ms = _time_ms(lambda: fo.fused_adamw_reference(
        table, grads, LR, step, clip=clip, scaler=sc), 2)
    fo.fused_adamw.launches = n0           # comparisons are not the path's
    # the path a step the fused one declines takes (a clip subclass, L1
    # decay, ...): the list rules behind the same clip
    work, all_pg = opt._collect_work()
    declined_ms = _time_ms(lambda: opt._apply_per_leaf(
        [list(w) for w in work], all_pg), 3)
    nbytes = fo.table_bytes(table, grads, clip, sc)
    bound_ms, bound_by = _bound(nbytes, 0, "torch.float32")
    n_chunks = table.n_chunks
    # the port's optimizer is done: its state makes room for torch's
    opt._accumulators.clear()
    opt._fused_tables.clear()
    del table
    torch.cuda.empty_cache()
    params = [p for p in model.parameters() if p.grad is not None]
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, tensors=len(grads),
               chunks=n_chunks, declined_ms=declined_ms)
    for mode in ("fused", "foreach"):
        topt = torch.optim.AdamW(params, lr=LR, weight_decay=0.01,
                                 **{mode: True})

        def lib_step():
            # the global clip in place, in torch's list ops (the port's
            # clips give new tensors)
            grads = [p.grad for p in params]
            total = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, 1.0 / total.clamp_min(1.0))
            topt.step()
        if mode == "fused":
            out["library_ms"] = _time_ms(lib_step, 10)
        # whole train steps with this optimizer (O1, no scaler)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(True, level="O1", dtype="bfloat16",
                               device=dev):
                loss = model.compute_loss(*batch)
            loss.backward()
            lib_step()
            topt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"{mode}_step_ms"] = statistics.median(times[1:]) * 1e3
        del topt
        torch.cuda.empty_cache()
    opt.clear_grad()
    _log(f"21a optimizer step alone at gpt3_1p3b's {len(grads)} tensors "
         f"({n_chunks} chunks of {fo.CHUNK}; O1, global clip, "
         f"scaler): fused_adamw {ms:.3f} ms (CUDA events over 10), bound "
         f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB by bytes), plain "
         f"version {plain_ms:.3f} ms, the declined path (list rules "
         f"behind the same clip) {declined_ms:.3f} ms, library "
         f"(_foreach_norm clip + "
         f"torch.optim.AdamW(fused=True)) {out['library_ms']:.3f} ms; "
         f"whole steps: torch AdamW foreach {out['foreach_step_ms']:.1f} "
         f"ms, fused=True {out['fused_step_ms']:.1f} ms")
    return out


def rest_of_training_phase():
    """21a-21d at GPT-3 1.3B, B 4 x S 2048 (see the module docstring)."""
    import statistics

    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.observability import flops as tflops
    from paddle_tpu_torch.observability import telemetry
    from paddle_tpu_torch.ops import fused_optimizer as fo

    cfg = gpt3_1p3b()
    tokens = TRAIN_B * TRAIN_S
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, sched, scaler, batch = _rest_setup(cfg)
    kind = torch.cuda.get_device_name(0)
    tl = telemetry.StepTimeline(name="rest_of_training",
                                flops_per_token=model.flops_per_token(
                                    TRAIN_S), device_kind=kind)
    losses, times, launches, fused = _rest_run(model, opt, sched, scaler,
                                               batch, REST_STEPS,
                                               timeline=tl)
    _check_train_launches("21a", cfg, launches, REST_STEPS)
    if fused["hit"] <= 0 or fused["fallback"]:
        raise AssertionError(f"21a: optimizer.fused {fused}")
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    summary = tl.summary()
    mfu = tokens / step_s * model.flops_per_token(TRAIN_S) / \
        tflops.peak_flops(kind)
    keys = sorted(tl.records[-1])
    _log(f"21a gpt3_1p3b O1 bf16, AdamW under LinearWarmup -> "
         f"CosineAnnealingDecay, clip 1.0, GradScaler, fused step, B="
         f"{TRAIN_B} S={TRAIN_S}: losses {[round(x, 4) for x in losses]}; "
         f"step times (s) {[round(t, 4) for t in times]}, median of steps "
         f"2-{REST_STEPS} {step_s * 1e3:.1f} ms = {tokens / step_s:.1f} "
         f"tokens/s, MFU {mfu:.4f}; peak memory {peak / 2 ** 30:.2f} GiB; "
         f"launches {launches}; optimizer.fused {fused}")
    _log(f"21a StepTimeline: {len(tl.records)} records (keys {keys}); "
         f"summary steps {summary['steps']}, steady {summary['steady_steps']}"
         f", synced {summary['synced_steps']}, tokens/s "
         f"{summary['tokens_per_sec']}, mfu {summary.get('mfu')}, step "
         f"seconds {summary['step_seconds']}, compile_s "
         f"{summary['compile_s']}, fractions {summary['fractions']}")

    def step():
        t0 = time.perf_counter()
        _rest_step(model, opt, sched, scaler, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    wall, kernels = _profiled(step, step)
    busy_us = sum(e.self_device_time_total for e in kernels)
    fk = _by_name(kernels, ("fused_norm_kernel", "fused_update_kernel",
                            "table_upload_kernel"))
    fused_us = sum(us for _, us in fk.values())
    # a gradient has its parameter's shape and type
    table = _fused_table(opt)
    nbytes = fo.table_bytes(table, table.params, ("global", 1.0), scaler)
    bound_ms = nbytes / MEM_BYTES_PER_S * 1e3
    idle = 1 - busy_us / 1e6 / wall
    if fk["fused_norm_kernel"][0] != 1 or fk["fused_update_kernel"][0] != 1:
        raise AssertionError(f"21a profiled step: fused kernels {fk}")
    _log(f"21a profiled step: wall {wall * 1e3:.1f} ms, card busy "
         f"{busy_us / 1e3:.1f} ms, idle share {idle:.3f}; fused step on the "
         f"card {fused_us / 1e3:.3f} ms ("
         + ", ".join(f"{n} {c}x {us / 1e3:.3f} ms" for n, (c, us)
                     in fk.items())
         + f") against a {bound_ms:.3f} ms bound ({nbytes / 1e9:.2f} GB)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
             f"{e.key[:90]}")
    del table                # it holds the parameters and moments
    overflow_phase(model, opt, sched, scaler, batch)
    yard = _optimizer_yardsticks(model, opt, batch)
    names = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()
    run = dict(step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
               peak_bytes=peak, idle_share=idle, launches=launches,
               fused=fused, losses=losses, profiled_fused_ms=fused_us / 1e3,
               **yard)
    run["recompute"] = recompute_phase(cfg)
    run["o2"] = o2_phase(cfg, run)
    return run, names


def recompute_phase(cfg):
    """21c: recompute off, full and ``dots_with_no_batch_dims_saveable`` at
    21a's shape: peak memory, step ms, a profiled step's card time and
    idle share, and flash launches per step; the
    losses against the run without recompute; then dropout 0.1 off and
    full, losses and the generator's position equal."""
    import dataclasses
    import statistics

    import torch

    modes = {"off": {}, "full": dict(use_recompute=True),
             "selective": dict(use_recompute=True, recompute_policy=(
                 "dots_with_no_batch_dims_saveable"))}
    out = {}
    for name, kw in modes.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, sched, scaler, batch = _rest_setup(
            dataclasses.replace(cfg, **kw))
        losses, times, launches, _ = _rest_run(model, opt, sched, scaler,
                                               batch, 3)
        per_step = launches["flash_fwd"] / 3
        want = cfg.num_layers * (2 if kw else 1)
        if per_step != want or launches["flash_bwd_dkv"] != \
                3 * cfg.num_layers or launches["fused_adamw"] != 3:
            raise AssertionError(f"21c {name}: launches {launches}")
        peak = torch.cuda.max_memory_allocated()

        def step():
            t0 = time.perf_counter()
            _rest_step(model, opt, sched, scaler, batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        wall, kernels = _profiled(step, step)
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        out[name] = dict(losses=losses, step_s=statistics.median(times[1:]),
                         peak_bytes=peak, flash_fwd_per_step=per_step,
                         idle_share=1 - busy / wall, busy_s=busy)
        del model, opt, scaler
    base = out["off"]["losses"]
    for name in ("full", "selective"):
        got = out[name]["losses"]
        if got[0] != base[0]:
            raise AssertionError(f"21c {name}: first loss {got[0]} against "
                                 f"{base[0]} (the forwards differ)")
        exact = got == base
        if not exact:
            torch.testing.assert_close(torch.tensor(got), torch.tensor(base),
                                       **GRAD_TOL["torch.bfloat16"])
        out[name]["bit_equal"] = exact
    for name, r in out.items():
        _log(f"21c recompute {name}: peak memory "
             f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, step "
             f"{r['step_s'] * 1e3:.1f} ms (profiled: card busy "
             f"{r['busy_s'] * 1e3:.1f} ms, idle share "
             f"{r['idle_share']:.3f}), flash_fwd launches per step "
             f"{r['flash_fwd_per_step']:.0f}, losses "
             f"{[round(x, 6) for x in r['losses']]}"
             + ("" if name == "off" else
                f", {'bit for bit' if r['bit_equal'] else 'within GRAD_TOL'}"
                " of the run without recompute"))
    # dropout 0.1: the recomputed forward replays the generator's draws
    drop = {}
    for name in ("off", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        model, opt, sched, scaler, batch = _rest_setup(
            dataclasses.replace(cfg, dropout=0.1, **modes[name]), seed=1)
        losses, _, _, _ = _rest_run(model, opt, sched, scaler, batch, 2)
        drop[name] = (losses, model.generator.get_state())
        del model, opt, scaler
    (l_off, g_off), (l_full, g_full) = drop["off"], drop["full"]
    if l_full[0] != l_off[0] or not torch.equal(g_off, g_full):
        raise AssertionError(f"21c dropout 0.1: losses {l_off} / {l_full}, "
                             f"generators equal {torch.equal(g_off, g_full)}")
    if l_full != l_off:
        torch.testing.assert_close(torch.tensor(l_full), torch.tensor(l_off),
                                   **GRAD_TOL["torch.bfloat16"])
    out["dropout"] = dict(off=l_off, full=l_full, bit_equal=l_full == l_off)
    _log(f"21c dropout 0.1, 2 steps: losses off {l_off}, full recompute "
         f"{l_full} ({'bit for bit' if l_full == l_off else 'GRAD_TOL'}); "
         f"the model generator's position equal after both")
    return out


def o2_phase(cfg, o1):
    """21d: O2 ``decorate`` (bf16 parameters, LayerNorms float32, float32
    masters) through the kernel's O2 form: step ms and peak memory
    against 21a."""
    import statistics

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, sched, scaler, batch = _rest_setup(cfg, level="O2")
    losses, times, launches, fused = _rest_run(model, opt, sched, scaler,
                                               batch, REST_STEPS, level="O2")
    _check_train_launches("21d", cfg, launches, REST_STEPS)
    table = _fused_table(opt)
    n_masters = sum(m is not None for m in table.masters)
    if fused["fallback"] or not n_masters or not losses[-1] < losses[0]:
        raise AssertionError(f"21d: optimizer.fused {fused}, {n_masters} "
                             f"masters, losses {losses}")
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    _log(f"21d O2 decorate: {n_masters} of {len(table.masters)} tensors "
         f"bf16 with float32 masters; losses "
         f"{[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms "
         f"(21a O1 {o1['step_s'] * 1e3:.1f} ms, x{step_s / o1['step_s']:.3f})"
         f", peak memory {peak / 2 ** 30:.2f} GiB (21a "
         f"{o1['peak_bytes'] / 2 ** 30:.2f}); optimizer.fused {fused}")
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=step_s, peak_bytes=peak, losses=losses,
                launches=launches)


def rest_card_vs_cpu(cfg):
    """21e: the fp32 2-layer cut, card against CPU: two steps with the
    scheduler, the scaler, the fused step (the kernels on the card, the
    plain version on the CPU) and full recompute, B 1 x S 256, from one
    state dict.  Losses within 1e-4, parameters within 2 x lr x steps."""
    import dataclasses

    import torch
    cfg = dataclasses.replace(cfg, use_recompute=True)
    steps, init, runs = 2, None, []
    for dev in ("cpu", "cuda"):
        model, opt, sched, scaler, batch = _rest_setup(cfg, dev, 2, B=1,
                                                       S=256)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        losses = [_rest_step(model, opt, sched, scaler, batch,
                             level="O0").item() for _ in range(steps)]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              model.state_dict().items()},
                     scaler._scale, opt._global_step))
        del model, opt
    (cpu_l, cpu_p, cpu_s, cpu_g), (card_l, card_p, card_s, card_g) = runs
    torch.testing.assert_close(torch.tensor(card_l), torch.tensor(cpu_l),
                               atol=1e-4, rtol=0.0)
    err = max((card_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    if err > 2 * LR * steps or (card_s, card_g) != (cpu_s, cpu_g):
        raise AssertionError(f"21e: parameters {err:.3e} apart (limit "
                             f"{2 * LR * steps:.1e}), scale {card_s} / "
                             f"{cpu_s}, global_step {card_g} / {cpu_g}")
    _log(f"21e card vs CPU, {CUT_LABEL}, full recompute, "
         f"scheduler + scaler + fused step, B=1 S=256, {steps} steps: "
         f"losses card {card_l} cpu {cpu_l}, parameters max abs diff "
         f"{err:.3e}, scale {card_s}, global_step {card_g} on both")


FUSED_LR, FUSED_WD, FUSED_RTOL = 1e-2, 0.1, 1e-4      # 21f


def _clipped_rms(grads, clip, scale):
    """Each gradient's root mean square after the unscale and the clip
    (float32, one gradient at a time)."""
    import torch
    kind = clip and clip[0]
    sq = [float((g.float() / scale).pow(2).sum()) for g in grads]
    coef = [1.0] * len(grads)
    if kind == "global":
        coef = [min(1.0, clip[1] / math.sqrt(sum(sq)))] * len(grads)
    elif kind == "norm":
        coef = [min(1.0, clip[1] / math.sqrt(x)) for x in sq]
    out = [math.sqrt(x / g.numel()) * c for x, g, c in zip(sq, grads, coef)]
    if kind == "value":
        out = [float(torch.clamp(g.float() / scale, clip[1], clip[2])
                     .pow(2).mean().sqrt()) for g in grads]
    return out


def _fused_draw(seed, shape, size):
    """One tensor's weight (about 0.1), m (about size / 8) and v >= m^2
    (about m^2 + size^2 / 64), from a generator of its own: drawn again
    after the step, they are the values before it."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(shape, generator=gen, device="cuda") * 0.1
    q = size / 8
    m = torch.randn(shape, generator=gen, device="cuda") * q
    v = m * m + (0.5 + torch.rand(shape, generator=gen, device="cuda")) \
        * q * q
    return w, m, v


def fused_kernel_checks(names):
    """21f: ``fused_adamw`` against ``fused_adamw_reference`` on the card
    at GPT-3 1.3B's parameter list (``names``: 21a's shapes), float32
    (O1), bf16 with float32 masters (O2) and fp16 with float32 masters
    (O2 in float16), each clip kind (global 1.0, as 21a and 21d run it),
    with a scaler whose step is finite or overflows, and without a
    scaler; lr 1e-2, decay 0.1 on every tensor, weights about 0.1, the
    states drawn to the clipped gradients' size (so that m and v each
    change by much more than a float32 ulp).  Each version gets its own
    copy of the gradients.

    Exactly: the skip (every tensor bit-identical to its value before the
    step), the scaler's scale and counts, the step count, and the
    gradients after the step (with a scaler both write ``g * (1 /
    scale)`` back over them, applied or skipped, ROADMAP §C.8; without
    one both leave them).  The clip
    coefficients within rtol 1e-6 (the norms are summed in other orders);
    phase 2 of the plain version then takes the kernels' coefficients, so
    that a coefficient one ulp apart cannot round a clipped bf16 gradient
    (O2) to its neighbour.  Each float32 tensor's change in the step
    (weight or master, m, v) within 1e-4 of the plain version's, in
    2-norm, with the decay's share of every weight's change above 100
    times that; 16-bit copies within one step of their type (rtol 2^-7
    for bf16, 2^-10 for fp16)."""
    import torch
    from paddle_tpu_torch.ops import fused_optimizer as fo

    gc.collect()
    torch.cuda.empty_cache()
    shapes = [s for _, s in names]
    n = len(shapes)
    err = change_err = 0.0
    share = math.inf
    cases = 0
    n0 = fo.fused_adamw.launches
    for pdt in (torch.float32, torch.bfloat16, torch.float16):
        o2 = pdt != torch.float32
        one_step = 2 ** -7 if pdt == torch.bfloat16 else 2 ** -10
        kind = {torch.float32: "O1", torch.bfloat16: "O2",
                torch.float16: "O2 fp16"}[pdt]

        def tensors():
            params = [torch.empty(s, dtype=pdt, device="cuda")
                      for s in shapes]
            masters = [torch.empty(s, device="cuda") if o2 else None
                       for s in shapes]
            states = [[torch.empty(s, device="cuda") for _ in range(2)]
                      for s in shapes]
            return params, masters, states
        kp, km, ks = tensors()
        rp, rm, rs = tensors()
        grads = [torch.empty(s, dtype=pdt, device="cuda") for s in shapes]
        rgrads = [torch.empty_like(g) for g in grads]
        kt = fo.FusedTable(kp, km, ks, [FUSED_WD] * n, [1.0] * n, [True] * n)
        rt = fo.FusedTable(rp, rm, rs, [FUSED_WD] * n, [1.0] * n, [True] * n)
        combos = [(c, s) for c in (None, "global", "norm", "value")
                  for s in ("finite", "inf")] + [("global", None)]
        for case, (clip, scaled) in enumerate(combos):
            gscale = 2.0 ** 12 if scaled else 1.0
            gen = torch.Generator(device="cuda").manual_seed(21 + case)
            for g in grads:
                g.copy_(torch.randn(g.shape, generator=gen, device="cuda")
                        * gscale)
            c = {None: None, "global": ("global", 1.0),
                 "norm": ("norm", 0.5), "value": ("value", -1e-3, 1e-3)}[clip]
            sizes = _clipped_rms(grads, c, gscale)
            seed0 = 1000 * (case + 1) + 100000 * o2
            for i, s in enumerate(shapes):
                w, m, v = _fused_draw(seed0 + i, s, sizes[i])
                kp[i].copy_(w)
                if o2:
                    km[i].copy_(w)
                ks[i][0].copy_(m)
                ks[i][1].copy_(v)
            if scaled == "inf":
                grads[n // 2].view(-1)[-1] = float("inf")
            for a, b in zip(_table_all(kt) + grads,
                            _table_all(rt) + rgrads):
                b.copy_(a)
            steps = [torch.full((1,), 4, dtype=torch.int32, device="cuda")
                     for _ in range(2)]
            scalers = [None, None] if scaled is None else [
                (torch.full((1,), gscale, device="cuda"),
                 torch.zeros(4, dtype=torch.int32, device="cuda"),
                 fo.ScalerConfig(2.0, 0.5, 2, 1, True)) for _ in range(2)]
            fo.fused_adamw(kt, grads, FUSED_LR, steps[0], clip=c,
                           scaler=scalers[0])
            fo.fused_adamw_reference(rt, rgrads, FUSED_LR, steps[1], clip=c,
                                     scaler=scalers[1], coef=kt.coef)
            torch.cuda.synchronize()
            label = f"21f {kind} clip {clip} {scaled}"
            # the gradients after the step: the same bits in both, the
            # unscaled ones with a scaler (the draw again without one)
            g_bad = sum(not _equal_bits(a, b) for a, b in zip(grads, rgrads))
            if scaled is None:
                gen = torch.Generator(device="cuda").manual_seed(21 + case)
                g_bad += sum(not _equal_bits(g, torch.randn(
                    g.shape, generator=gen, device="cuda").to(pdt))
                    for g in grads)
            if g_bad:
                raise AssertionError(f"{label}: {g_bad} gradients differ "
                                     "after the step")
            if not torch.equal(steps[0], steps[1]) or (scaled and not (
                    torch.equal(scalers[0][0], scalers[1][0])
                    and torch.equal(scalers[0][1], scalers[1][1]))):
                raise AssertionError(f"{label}: step {steps}, scaler "
                                     f"{scalers}")
            if not torch.allclose(kt.coef, rt.coef, rtol=1e-6, atol=0.0):
                raise AssertionError(f"{label}: clip coefficients "
                                     f"{kt.coef} / {rt.coef}")
            # per tensor: the values before the step, drawn again
            worst, bad16, changed = 0.0, 0, 0
            for i, s in enumerate(shapes):
                w0, m0, v0 = _fused_draw(seed0 + i, s, sizes[i])
                p0 = w0.to(pdt)
                kw, rw = (km[i], rm[i]) if o2 else (kp[i], rp[i])
                trip = [(kw, rw, w0), (ks[i][0], rs[i][0], m0),
                        (ks[i][1], rs[i][1], v0)]
                if scaled == "inf":
                    changed += sum(not _equal_bits(a, b0) for a, _, b0 in
                                   trip + [(kp[i], None, p0)])
                    continue
                for a, b, b0 in trip:
                    d = b - b0
                    worst = max(worst, float(((a - b0) - d).norm()
                                             / d.norm()))
                    err = max(err, float((a - b).abs().max()))
                dw = (rw - w0).norm()
                share = min(share, float(FUSED_LR * FUSED_WD * w0.norm()
                                         / dw))
                if o2:
                    bad16 += int(((kp[i].float() - rp[i].float()).abs()
                                  > 1e-6 + one_step * rp[i].float().abs())
                                 .sum())
            if changed:
                raise AssertionError(f"{label}: the skipped step wrote "
                                     f"{changed} tensors")
            if worst > FUSED_RTOL or bad16:
                raise AssertionError(f"{label}: a step's change "
                                     f"{worst:.3e} from the plain "
                                     f"version's (limit {FUSED_RTOL}), "
                                     f"{bad16} {pdt} values beyond one "
                                     "step of their type")
            change_err = max(change_err, worst)
            cases += 1
        del kp, km, ks, rp, rm, rs, grads, rgrads, kt, rt
        gc.collect()
        torch.cuda.empty_cache()
    if not share > 100 * FUSED_RTOL:
        raise AssertionError(f"21f: the decay's share of a weight's "
                             f"change {share:.3e} is too small to check")
    fo.fused_adamw.launches = n0       # comparisons are not a path's
    _log(f"21f fused_adamw against fused_adamw_reference at gpt3_1p3b's "
         f"{n} tensors: {cases} cases (O1, O2 bf16 and O2 fp16; clip none, "
         f"global 1.0, norm, value; scaler finite, overflow, none; lr "
         f"{FUSED_LR}, decay {FUSED_WD}): skips bit for bit, the gradients "
         f"after every step bit for bit (unscaled with a scaler, written "
         f"back by the update launch); each float32 tensor's "
         f"change in the step within {change_err:.3e} of the plain "
         f"version's (2-norm, limit {FUSED_RTOL}), the decay at least "
         f"{share:.3e} of every weight's change; float32 values max abs "
         f"err {err:.3e}")
    return err


def _table_all(table):
    out = list(table.params)
    out += [m for m in table.masters if m is not None]
    return out + [s for st in table.states for s in st if s is not None]


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
         f"{run['ticks']} ticks ({run['overlapped']} chained), "
         f"{run['replays']} graph replays after a warmup of "
         f"{run['warmup']['programs']} programs in "
         f"{run['warmup']['warmup_s']:.2f} s, launches {n}")
    del model
    torch.cuda.empty_cache()
    return run


def moe_phases(lens, rows_out):
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    serve_run = moe_serving_phase(lens)
    train_run = train_full_width(gpt3_1p3b(moe_num_experts=MOE_E),
                                 "training gpt3_1p3b MoE")
    moe_kernel_timing(rows_out, train_run.pop("routing"))
    cut = gpt3_1p3b(num_layers=MOE_CUT_LAYERS, moe_num_experts=MOE_E)
    label = f"gpt3_1p3b MoE {MOE_CUT_LAYERS} layers (block 1 MoE) fp32"
    card_vs_cpu(cut, label)
    train_card_vs_cpu(cut, label)
    return serve_run, train_run


# --------------------------------------------------------- phases 14-17

def llama_decode_checks(path_lens):
    """paged_decode at Llama-2 7B's serving shape (nh 32, hd 128, the
    serving lengths 32 tokens into decoding) against its plain version in
    fp32 and bf16; the bf16 launch timed from a replayed CUDA graph beside
    its bound.  Returns the numbers."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(4)
    nh, lens = LLAMA_NH, [n + 32 for n in path_lens]
    fp16_err = None
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        k, v, tables = _pool_case(gen, lens, dtype, nh=nh)
        q = torch.randn((len(lens), nh, HD), generator=gen,
                        device="cuda").to(dtype)
        sl = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        out = pa.paged_attention(q, k, v, tables, sl)
        ref = pa.paged_attention_reference(q.float(), k.float(), v.float(),
                                           tables, sl)
        torch.cuda.synchronize()
        err = _compare("paged_decode nh 32", out, ref, dtype)
        if dtype == torch.float16:
            fp16_err = err
        _log(f"paged_decode {dtype} nh={nh} hd={HD} lens={lens}: "
             f"max_abs_err={err:.3e}")
    nbytes = (2 * len(lens) * nh * HD + sum(lens) * nh * HD * 2) * 2 \
        + tables.numel() * 4 + len(lens) * 4
    bound, by = _bound(nbytes, 4 * nh * HD * sum(lens), torch.bfloat16)
    row = dict(nh=nh, max_abs_err=err, fp16_max_abs_err=fp16_err,
               ms=_graph_ms(lambda: pa.paged_attention(q, k, v, tables, sl),
                            200),
               plain_ms=_time_ms(lambda: pa.paged_attention_reference(
                   q, k, v, tables, sl), 10),
               bound_ms=bound, bound_by=by, library_ms=None)
    _log(f"paged_decode bf16 at llama2_7b's shape (nh {nh}): card "
         f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
         f"{bound:.4f} ms ({by}), {row['ms'] / bound:.2f}x the bound")
    del q, k, v, tables
    torch.cuda.empty_cache()
    return row


def bert_flash_checks(rows):
    """The three flash kernels at BERT-base's training shape (B 8, S 512,
    nh 12, hd 64, non-causal, every second row padded from a random length
    in [128, 512) through the kv mask, dropout 0.1) against their plain
    versions in fp32 and bf16, and timed in bf16 beside
    ``F.scaled_dot_product_attention`` with the same boolean mask and
    dropout rate (its backward on its own for the pair).  The bound counts
    the (query, key) pairs the mask keeps.  Adds ``bert_shape`` to each
    flash row."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, nh, hd, rate = 8, 512, 12, 64, 0.1
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    lengths = torch.randint(128, S, (B,), generator=gen, device="cuda")
    for b in range(1, B, 2):
        mask[b, int(lengths[b]):] = 0
    args = (False, mask, rate, 12345)
    # bf16 last: its tensors are the ones timed below
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        q, k, v, do = (torch.randn((B, S, nh, hd), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, *args)
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), *args)
        want = fa.flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), out.float(), lse, do.float(),
            *args)
        torch.cuda.synchronize()
        errs = [_compare("flash_fwd bert", out, ref, dtype),
                _compare("flash_fwd bert lse", lse, ref_lse, dtype)]
        for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]),
                             ("dv", dv, want[2])):
            errs.append(_compare(f"flash bert {name}", got, w, dtype,
                                 GRAD_TOL))
        _log(f"flash at BERT-base's shape {dtype} B={B} S={S} nh={nh} "
             f"hd={hd} non-causal kv mask dropout {rate}: max_abs_err out="
             f"{errs[0]:.3e} lse={errs[1]:.3e} dq={errs[2]:.3e} "
             f"dk={errs[3]:.3e} dv={errs[4]:.3e}")
        if dtype == torch.float16:
            errs16 = {"flash_fwd": max(errs[:2]), "flash_bwd_dq": errs[2],
                      "flash_bwd_dkv": max(errs[3:])}
    kept = int(mask.sum()) * nh * S                # (query, key) pairs
    qbytes, lse_b = B * S * nh * hd * 2, B * nh * S * 4
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    keep = mask.bool()[:, None, None, :]
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, dropout_p=rate), 20)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                             dropout_p=rate)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20)
    timed = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, *args),
                      lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                               *args),
                      4 * qbytes + lse_b, 4, errs[0], lib_fwd),
        "flash_bwd_dq": (lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, *args),
            lambda: fa.flash_attention_bwd_reference(
                q, k, v, out, lse, do, *args, parts=("dq",)),
            6 * qbytes + lse_b, 6, errs[2], lib_bwd),
        "flash_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(
            q, k, v, out, lse, do, *args),
            lambda: fa.flash_attention_bwd_reference(
                q, k, v, out, lse, do, *args, parts=("dkv",)),
            7 * qbytes + lse_b, 8, max(errs[3], errs[4]), lib_bwd)}
    for name, (fn, plain, nbytes, per_pair, err, lib) in timed.items():
        ms = _time_ms(fn, 20)
        bound, by = _bound(nbytes + mask.numel() * 4, per_pair * hd * kept,
                           torch.bfloat16)
        r = dict(B=B, S=S, nh=nh, hd=hd, causal=False, dropout=rate,
                 keys_kept=int(mask.sum()), max_abs_err=err, ms=ms,
                 plain_ms=_time_ms(plain, 3), bound_ms=bound, bound_by=by,
                 library_ms=lib, tflops=per_pair * hd * kept / ms / 1e9)
        r["fp16_max_abs_err"] = errs16[name]
        rows[name]["bert_shape"] = r
        _log(f"{name} bf16 at BERT-base's shape: ms={ms:.4f} plain_ms="
             f"{r['plain_ms']:.4f} bound_ms={bound:.4f} ({by}) library_ms="
             f"{lib:.4f}{' (sdpa backward, dq+dkv)' if 'bwd' in name else ''}"
             f"; {r['tflops']:.1f} TFLOP/s")
    del q, k, v, do, out, lse, qt, kt, vt, lib_out
    torch.cuda.empty_cache()


def llama_serving_phase(model, lens):
    """Phase 14: Llama-2 7B at full width in bf16 (``model``: 6.74 B
    parameters, random weights from seed 0) on phase 2's mix and engine
    settings:
    whole-prompt prefill (median of ``REPEATS`` runs; one more with the
    overlapped loop off for ms per decode step; one profiled), 256-token
    chunks (one profiled run) and phase 11's shared-prefix mix with the
    prefix cache (one profiled run).  Every run launches its kernels (the
    profiled ones by name on the tensor-core and split kernels), takes no
    plain route and leaks no block."""
    import torch

    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    label = f"serving llama2_7b bf16 ({model.num_params()} parameters)"
    whole = [serve(model, prompts, 0) for _ in range(REPEATS)]
    for run in whole:
        for name in ("flash_fwd", "paged_decode"):
            if run["launches"][name] <= 0:
                raise AssertionError(f"{label}: {name} never launched")
    ticks = serve(model, prompts, 0, time_ticks=True, overlap=False)
    out = dict(whole[0])
    out["tokens_per_s_runs"] = [r["tokens_per_s"] for r in whole]
    out["tokens_per_s"] = _median(out["tokens_per_s_runs"])
    out["ttft_mean_s"] = _median([r["ttft_mean_s"] for r in whole])
    out["ms_per_step"] = ticks["tick_s"] / ticks["steps"] * 1e3
    out["profile"] = where_the_time_goes(model, prompts, 0,
                                         "llama2_7b whole-prompt",
                                         nh=cfg.num_heads)
    _log(f"{label}, whole-prompt prefill: median of {REPEATS} runs "
         f"{out['tokens_per_s']:.1f} tokens/s (runs "
         + ", ".join(f"{x:.1f}" for x in out["tokens_per_s_runs"])
         + f"), mean TTFT {out['ttft_mean_s'] * 1e3:.1f} ms, "
         f"{out['ms_per_step']:.3f} ms per decode step (overlap off), idle "
         f"share {out['profile']['idle']:.3f}, warmup "
         f"{out['warmup']['programs']} programs in "
         f"{out['warmup']['warmup_s']:.2f} s, {out['steps']} steps in "
         f"{out['ticks']} ticks ({out['overlapped']} chained), launches "
         f"{out['launches']}")
    runs = {"whole": out}
    for key, name, chunk, ps, kw in (
            ("chunked", "256-token chunks", 256, prompts, {}),
            ("prefix", "shared 1024-token prefix, prefix cache on", 0,
             _prefix_prompts(cfg.vocab_size), dict(prefix_cache=True))):
        prof = where_the_time_goes(model, ps, chunk, f"llama2_7b {name}",
                                   nh=cfg.num_heads, **kw)
        run = prof["run"]
        need = ("paged_chunk", "paged_decode")
        if any(run["launches"][n] <= 0 for n in need):
            raise AssertionError(f"{label}, {name}: launches "
                                 f"{run['launches']}")
        pc = run["stats"].get("prefix_cache")
        if kw and pc["hits"] <= 0:
            raise AssertionError(f"{label}, {name}: no hit: {pc}")
        _log(f"{label}, {name} (one profiled run): {run['tokens']} tokens "
             f"in {run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s"
             f", mean TTFT {run['ttft_mean_s'] * 1e3:.1f} ms, idle share "
             f"{prof['idle']:.3f}, {run['prefill_chunks']} chunks, launches "
             f"{run['launches']}" + (f", prefix hits {pc['hits']}" if kw
                                     else ""))
        runs[key] = dict(run, profile=prof)
    peak = torch.cuda.max_memory_allocated()
    runs["peak_bytes"] = peak
    _log(f"{label}: peak memory {peak / 2 ** 30:.2f} GiB (weights "
         f"{model.num_params() * 2 / 2 ** 30:.2f} GiB)")
    return runs


def llama_phases(lens):
    """Phases 14-16 and 18's kernel and serving parts: Llama-2 7B served
    at full width in bf16, the weight-only kernel's checks and the int8
    and fp8 serving on the same model, the GQA fp32 cuts card against
    CPU, and the 8-layer cut trained at full width."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(llama2_7b(num_layers=LLAMA_SERVE_LAYERS),
                             device="cuda", dtype=torch.bfloat16, seed=0)
    serving = llama_serving_phase(model, lens)
    t = time.perf_counter()
    llama_gen = generate_runs(model, "23c generate llama2_7b bf16", 1,
                              LLAMA_GEN_PROMPT, LLAMA_GEN_NEW,
                              ("static", "paged"), 25)
    _log(f"[phase 23c, llama2_7b generate: {time.perf_counter() - t:.1f} s]")
    t = time.perf_counter()
    wo_row = weight_only_checks()
    t1 = time.perf_counter()
    wg_row = weight_only_gemm_checks()
    t2 = time.perf_counter()
    quant = llama_quant_phase(model, lens)
    _log(f"[phase 18, weight_only_matmul: {t1 - t:.1f} s; weight_only_gemm:"
         f" {t2 - t1:.1f} s; llama2_7b serving: "
         f"{time.perf_counter() - t2:.1f} s]")
    t = time.perf_counter()
    llama16 = llama_fp16_serving(model, lens, serving["whole"])
    _log(f"[phase 27d: {time.perf_counter() - t:.1f} s]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # four kv heads over 32 query heads: Llama-2-70B's group of 8
    card_vs_cpu(llama2_7b(num_layers=CUT_LAYERS, num_kv_heads=4),
                f"llama2_7b {CUT_LAYERS} layers, 4 kv heads, fp32",
                prompt_len=260, chunks=(0, 256))
    train_card_vs_cpu(llama2_7b(num_layers=CUT_LAYERS, num_kv_heads=4),
                      "llama2_7b 2 layers, 4 kv heads, fp32")
    generate_card_vs_cpu(llama2_7b(num_layers=CUT_LAYERS, num_kv_heads=4),
                         "llama2_7b 2 layers, 4 kv heads, fp32")
    train = train_full_width(llama2_7b(num_layers=LLAMA_TRAIN_LAYERS),
                             f"training llama2_7b {LLAMA_TRAIN_LAYERS} "
                             "layers", B=1, S=LLAMA_TRAIN_S)
    return serving, train, quant, wo_row, wg_row, llama_gen, llama16


def bert_phase():
    """Phase 17: BERT-base MLM at full width (bench.py's ``bench_bert_base``
    step), unmasked and with padded rows, then a 2-layer fp32 cut card
    against CPU with a padding mask."""
    from paddle_tpu_torch.models.bert import bert_base

    runs = {masked: train_full_width(
        bert_base(), "training bert_base MLM" + (", padded rows" if masked
                                                else ""),
        B=BERT_B, S=BERT_S, masked=masked) for masked in (False, True)}
    train_card_vs_cpu(bert_base(num_layers=2, dropout=0.0),
                      "bert_base 2 layers fp32, padded rows", B=2, S=128,
                      masked=True)
    return runs


# -------------------------------------------------------------- phase 18

# (N, K) of the linear layers, with their launches in one Llama-2 7B
# decode step or prompt (q, k, v, o: 4 a layer; gate, up: 2; down: 1; the
# head)
WO_SHAPES = {"llama2_7b q/k/v/o_proj": (4096, 4096, 4 * 32),
             "llama2_7b gate/up_proj": (11008, 4096, 2 * 32),
             "llama2_7b down_proj": (4096, 11008, 32),
             "llama2_7b lm_head": (32000, 4096, 1),
             "gpt3_1p3b qkv": (6144, 2048, 0),
             "gpt3_1p3b proj": (2048, 2048, 0),
             "gpt3_1p3b fc1": (8192, 2048, 0),
             "gpt3_1p3b fc2": (2048, 8192, 0),
             "gpt3_1p3b head": (50304, 2048, 0)}
WO_ROW_SHAPE = "llama2_7b gate/up_proj"    # the kernels line's row
WO_TOL = dict(atol=2e-2, rtol=1e-2)        # bf16 against fp32 on the codes
WO_NAMES = ("weight_only_mma_kernel", "weight_only_fma_kernel",
            "weight_only_gemm_kernel")
WG_ROWS = (256, 512, 1024, 2048)    # the chunk and the prompt buckets
WG_ROW = 2048                       # the kernels line's weight_only_gemm
QUANT_MODES = ("int8", "fp8")


def _wo_operands(gen, M, N, K, dtype, mode, copies=1):
    """``copies`` sets of codes and scales of an N x K weight (N(0, 0.02)
    in ``dtype``, quantized per output channel) and an x of M rows."""
    import torch
    from paddle_tpu_torch.quantization import weight_only as two
    quantize = two.quantize_absmax_int8 if mode == "int8" \
        else two.quantize_absmax_fp8
    ops = []
    for _ in range(copies):
        w = (torch.randn((N, K), generator=gen, device="cuda") * 0.02) \
            .to(dtype)
        q, s = quantize(w, axis=1)
        ops.append((w, q, s.reshape(-1)))
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    return x, ops


def _cycle(call, operands):
    """A function that calls ``call`` on the next of ``operands`` (together
    past the 50 MB L2 cache: each call reads its weight from device
    memory, as the layers of a step or a prompt do)."""
    i = [0]

    def fn():
        call(operands[i[0] % len(operands)])
        i[0] += 1
    return fn


def _cold_ms(call, operands, iters=60):
    """ms per ``call(operand)`` from a replayed CUDA graph that cycles
    through ``operands``."""
    return _graph_ms(_cycle(call, operands), iters)


def weight_only_checks():
    """Phase 18, the kernel: ``weight_only_matmul`` against its plain
    version computed in float32 on the same codes and inputs (bf16: atol
    2e-2, rtol 1e-2; fp32: phase 1's), int8 and fp8 codes, at Llama-2 7B's
    and GPT-3 1.3B's linear shapes (bf16 at M 8, 40 and 128, the 128-row
    prompt bucket; fp32 at one shape) and at the edges M 1, 127, 128 with
    N and K off the kernel's tiles.  Timed at M 8 in bf16 from replayed
    graphs over weights that do not fit in L2, beside its bound, the plain
    version (``dequantize`` then ``torch.matmul``) and ``torch.matmul`` on
    the bf16 weight.  Returns the kernels line's row."""
    import torch
    from paddle_tpu_torch.ops import weight_only as wo

    gen = torch.Generator(device="cuda").manual_seed(18)
    errs, shapes = [], []

    def check(label, x, q, s, dtype, bias=None):
        got = wo.weight_only_matmul(x, q, s, bias)
        want = wo.weight_only_matmul_reference(
            x.float(), q, s, None if bias is None else bias.float())
        torch.cuda.synchronize()
        tol = TOL if dtype == torch.float32 else \
            {str(torch.bfloat16): WO_TOL}
        err = _compare(f"weight_only_matmul {label}", got, want, dtype, tol)
        errs.append(err)
        return err

    for mode in QUANT_MODES:
        for name, (N, K, _) in WO_SHAPES.items():
            x, [(w, q, s)] = _wo_operands(gen, 128, N, K, torch.bfloat16,
                                          mode)
            for M in (8, 40, 128):
                check(f"{name} {mode} M {M}", x[:M].contiguous(), q, s,
                      torch.bfloat16)
            del w, q, s, x
        x, [(w, q, s)] = _wo_operands(gen, 8, 4096, 4096, torch.float32,
                                      mode)
        err = check(f"fp32 {mode} 4096 x 4096", x, q, s, torch.float32)
        _log(f"weight_only_matmul fp32 {mode} M 8 N 4096 K 4096: "
             f"max_abs_err={err:.3e}")
        for M in (1, 127, 128):
            x, [(w, q, s)] = _wo_operands(gen, M, 4100, 4112,
                                          torch.bfloat16, mode)
            bias = torch.randn((4100,), generator=gen,
                               device="cuda").to(torch.bfloat16)
            err = check(f"edge {mode} M {M}", x, q, s, torch.bfloat16, bias)
            _log(f"weight_only_matmul bf16 {mode} edge M {M} N 4100 K 4112 "
                 f"(bias): max_abs_err={err:.3e}")
    _log(f"weight_only_matmul: {len(errs)} cases within tolerance, largest "
         f"max_abs_err {max(errs):.3e}")

    M = BATCH
    for name, (N, K, per_step) in WO_SHAPES.items():
        copies = max(1, math.ceil(120e6 / (N * K)))
        for mode in QUANT_MODES:
            x, ops = _wo_operands(gen, M, N, K, torch.bfloat16, mode, copies)
            ms = _cold_ms(lambda o: wo.weight_only_matmul(x, o[1], o[2]),
                          ops)
            plain = _cold_ms(lambda o: wo.weight_only_matmul_reference(
                x, o[1], o[2]), ops, 20)
            lib = _cold_ms(lambda o: torch.matmul(x, o[0].t()), ops)
            nbytes = N * K + N * 2 + M * K * 2 + M * N * 2
            bound, by = _bound(nbytes, 2 * M * N * K, torch.bfloat16)
            shapes.append(dict(shape=name, N=N, K=K, M=M, mode=mode, ms=ms,
                               plain_ms=plain, library_ms=lib,
                               bound_ms=bound, bound_by=by,
                               per_decode_step=per_step,
                               gbytes_per_s=nbytes / ms / 1e6))
            _log(f"weight_only_matmul {mode} {name} (N {N}, K {K}) at M {M}"
                 f": {ms:.4f} ms = {nbytes / ms / 1e6:.0f} GB/s, bound "
                 f"{bound:.4f} ms ({by}), {ms / bound:.2f}x the bound; "
                 f"dequantize + torch.matmul {plain:.4f} ms; torch.matmul "
                 f"on the bf16 weight {lib:.4f} ms ({lib / ms:.2f}x the "
                 "kernel's time)")
            del x, ops
    torch.cuda.empty_cache()
    step = {}
    for mode in QUANT_MODES:
        rows = [r for r in shapes if r["mode"] == mode
                and r["per_decode_step"]]
        step[mode] = {k: sum(r[k] * r["per_decode_step"] for r in rows)
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        _log(f"weight_only_matmul {mode}, one llama2_7b decode step's "
             f"{sum(r['per_decode_step'] for r in rows)} linear layers at M "
             f"{M}: {step[mode]['ms']:.3f} ms, bound "
             f"{step[mode]['bound_ms']:.3f} ms, dequantize + torch.matmul "
             f"{step[mode]['plain_ms']:.3f} ms, torch.matmul bf16 "
             f"{step[mode]['library_ms']:.3f} ms")
    row = next(r for r in shapes if r["shape"] == WO_ROW_SHAPE
               and r["mode"] == "int8")
    return dict(max_abs_err=max(errs), ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                library_call="torch.matmul on the bf16 weight",
                plain_call="dequantize, then torch.matmul",
                timed_at=f"{WO_ROW_SHAPE} int8, M {M}", shapes=shapes,
                llama_decode_step=step)


def _gemm_raw(x, q, s, sched=None):
    """``weight_only_gemm``'s kernel at any row count and on any schedule
    (default: ``gemm_schedule``'s), called outside the wrapper (which takes
    only more than 128 rows and its own schedule) and counted nowhere: the
    crossover sweep's GEMM below 129 rows, the schedule sweep."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import weight_only as wo
    (M, K), N = x.shape, q.shape[0]
    if sched is None:
        sched = wo.gemm_schedule(M, N, K, _build.sm_count(x.device))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = None if sched.splits == 1 else torch.empty(
        (sched.splits, M, N), dtype=torch.float32, device=x.device)
    _build.check(_build.library().ptt_weight_only_gemm(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), None, y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K,
        wo.CODE_DTYPES[q.dtype], sched.rows, sched.splits, sched.k_steps,
        sched.blocks, _build.stream(x.device)), "weight_only_gemm")
    return y


def _sched_text(sched):
    return (f"{sched.rows}-row tiles x {sched.splits} split"
            f"{'s' if sched.splits > 1 else ''} of {sched.k_steps} steps, "
            f"{sched.blocks} blocks")


def _schedules(M, N, K, sms):
    """Every schedule the kernel takes for this shape: each tile height
    at 1, 2, 3 and 4 K splits (each split non-empty), on all SMs."""
    from paddle_tpu_torch.ops import weight_only as wo
    nk = -(-K // wo.GEMM_K_STEP)
    out = []
    for rows in wo.GEMM_ROWS:
        m_tiles, n_tiles = -(-M // rows), -(-N // wo.GEMM_CHANNELS)
        for want in range(1, 5):
            k_steps = -(-nk // want)
            splits = -(-nk // k_steps)
            if splits == want:
                units = m_tiles * n_tiles * splits
                out.append(wo.GemmSchedule(rows, splits, k_steps,
                                           min(units, sms)))
    return out


def weight_only_gemm_checks():
    """Phase 18, the wide-M kernel: ``weight_only_gemm`` against its plain
    version computed in float32 on the same codes and bf16 inputs (atol
    2e-2, rtol 1e-2), int8 and fp8 codes, at every ``WO_SHAPES`` shape at
    M 256 (a chunk), 512, 1024 and 2048 (prompt buckets), and at the edges
    M 129, 300 and 2047 with N 4100, K 4112 and a bias.  Each shape timed
    from a replayed CUDA graph that cycles through copies of the weight
    past the L2 (the card's time: an eager loop of the smaller shapes
    times the host's launches), beside its bound, the plain version
    (``dequantize`` then ``torch.matmul``, an eager loop) and
    ``torch.matmul`` on the bf16 weight (replayed), with
    TFLOP/s and the schedule ``gemm_schedule`` chose; one 2048-row
    Llama-2 7B prompt's 225 products summed.  Then the crossover:
    ``weight_only_matmul`` at M 64 and 128 against the GEMM's kernel at M
    64, 128 and 256 (replayed graphs) at Llama's gate/up and q/k/v; and
    every schedule the kernel takes (tile heights x K splits) at Llama's
    q/k/v/o, gate/up and down, M 256, 512 and 1024, int8, beside the one
    chosen.  Returns the kernels line's row (gate/up, int8, M 2048)."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import weight_only as wo

    gen = torch.Generator(device="cuda").manual_seed(181)
    tol = {str(torch.bfloat16): WO_TOL}
    errs, shapes = [], []
    sms = _build.sm_count(torch.device("cuda"))

    def check(label, x, q, s, bias=None):
        got = wo.weight_only_gemm(x, q, s, bias)
        want = wo.weight_only_matmul_reference(
            x.float(), q, s, None if bias is None else bias.float())
        torch.cuda.synchronize()
        errs.append(_compare(f"weight_only_gemm {label}", got, want,
                             torch.bfloat16, tol))
        return errs[-1]

    for mode in QUANT_MODES:
        for name, (N, K, per_prompt) in WO_SHAPES.items():
            copies = max(1, math.ceil(120e6 / (N * K)))
            x, ops = _wo_operands(gen, max(WG_ROWS), N, K, torch.bfloat16,
                                  mode, copies)
            for M in WG_ROWS:
                xm = x[:M]
                check(f"{name} {mode} M {M}", xm, ops[0][1], ops[0][2])
                ms = _cold_ms(
                    lambda o: wo.weight_only_gemm(xm, o[1], o[2]), ops, 20)
                plain = _time_ms(_cycle(
                    lambda o: wo.weight_only_matmul_reference(
                        xm, o[1], o[2]), ops), 10)
                lib = _cold_ms(lambda o: torch.matmul(xm, o[0].t()), ops,
                               20)
                flops = 2 * M * N * K
                nbytes = N * K + N * 2 + M * K * 2 + M * N * 2
                bound, by = _bound(nbytes, flops, torch.bfloat16)
                sched = wo.gemm_schedule(M, N, K, sms)
                shapes.append(dict(shape=name, N=N, K=K, M=M, mode=mode,
                                   ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bound, bound_by=by,
                                   per_prompt=per_prompt,
                                   tflops=flops / ms / 1e9,
                                   schedule=sched._asdict()))
                _log(f"weight_only_gemm {mode} {name} (N {N}, K {K}) at M "
                     f"{M} [{_sched_text(sched)}]: {ms:.4f} ms = "
                     f"{flops / ms / 1e9:.1f} TFLOP/s, "
                     f"bound {bound:.4f} ms ({by}), {ms / bound:.2f}x the "
                     f"bound; dequantize + torch.matmul {plain:.4f} ms; "
                     f"torch.matmul on the bf16 weight {lib:.4f} ms = "
                     f"{flops / lib / 1e9:.1f} TFLOP/s ({ms / lib:.2f}x "
                     "its time)")
            del x, ops
        for M in (129, 300, 2047):
            x, [(w, q, s)] = _wo_operands(gen, M, 4100, 4112,
                                          torch.bfloat16, mode)
            bias = torch.randn((4100,), generator=gen,
                               device="cuda").to(torch.bfloat16)
            err = check(f"edge {mode} M {M}", x, q, s, bias)
            _log(f"weight_only_gemm {mode} edge M {M} N 4100 K 4112 (bias):"
                 f" max_abs_err={err:.3e}")
    torch.cuda.empty_cache()
    _log(f"weight_only_gemm: {len(errs)} cases within tolerance, largest "
         f"max_abs_err {max(errs):.3e}")
    prompt = {}
    for mode in QUANT_MODES:
        rows = [r for r in shapes if r["mode"] == mode and r["M"] == WG_ROW
                and r["per_prompt"]]
        prompt[mode] = {k: sum(r[k] * r["per_prompt"] for r in rows)
                        for k in ("ms", "plain_ms", "library_ms",
                                  "bound_ms")}
        _log(f"weight_only_gemm {mode}, one {WG_ROW}-row llama2_7b "
             f"prompt's {sum(r['per_prompt'] for r in rows)} linear layers:"
             f" {prompt[mode]['ms']:.3f} ms, bound "
             f"{prompt[mode]['bound_ms']:.3f} ms, dequantize + torch.matmul"
             f" {prompt[mode]['plain_ms']:.3f} ms, torch.matmul bf16 "
             f"{prompt[mode]['library_ms']:.3f} ms")

    sweep = []
    for name in ("llama2_7b gate/up_proj", "llama2_7b q/k/v/o_proj"):
        N, K, _ = WO_SHAPES[name]
        copies = max(1, math.ceil(120e6 / (N * K)))
        for mode in QUANT_MODES:
            x, ops = _wo_operands(gen, 256, N, K, torch.bfloat16, mode,
                                  copies)
            for M in (64, 128, 256):
                xm = x[:M]
                r = dict(shape=name, mode=mode, M=M, gemm_ms=_cold_ms(
                    lambda o: _gemm_raw(xm, o[1], o[2]), ops, 30),
                    library_ms=_cold_ms(
                        lambda o: torch.matmul(xm, o[0].t()), ops, 30))
                if M <= wo.KERNEL_MAX_ROWS:
                    r["matmul_ms"] = _cold_ms(
                        lambda o: wo.weight_only_matmul(xm, o[1], o[2]),
                        ops, 30)
                sweep.append(r)
                _log(f"crossover {mode} {name} at M {M}: weight_only_gemm's"
                     f" kernel {r['gemm_ms']:.4f} ms, weight_only_matmul "
                     + (f"{r['matmul_ms']:.4f} ms" if "matmul_ms" in r
                        else "(takes at most 128 rows)")
                     + f", torch.matmul bf16 {r['library_ms']:.4f} ms")
            del x, ops
    torch.cuda.empty_cache()

    # every schedule the kernel takes, at the chunk and the smaller prompt
    # buckets, against gemm_schedule's choice
    alternatives = []
    for name in ("llama2_7b q/k/v/o_proj", "llama2_7b gate/up_proj",
                 "llama2_7b down_proj"):
        N, K, _ = WO_SHAPES[name]
        copies = max(1, math.ceil(120e6 / (N * K)))
        x, ops = _wo_operands(gen, 1024, N, K, torch.bfloat16, "int8",
                              copies)
        for M in (256, 512, 1024):
            xm = x[:M]
            chosen = wo.gemm_schedule(M, N, K, sms)
            times = []
            for sched in _schedules(M, N, K, sms):
                times.append((_cold_ms(
                    lambda o: _gemm_raw(xm, o[1], o[2], sched), ops, 20),
                    sched))
            best_ms, best = min(times, key=lambda r: r[0])
            chosen_ms = next(ms for ms, sc in times if sc == chosen)
            alternatives.append(dict(
                shape=name, M=M, chosen=chosen._asdict(),
                chosen_ms=chosen_ms, fastest=best._asdict(),
                fastest_ms=best_ms,
                all=[dict(ms=ms, **sc._asdict()) for ms, sc in times]))
            _log(f"schedules int8 {name} at M {M}: chosen "
                 f"[{_sched_text(chosen)}] {chosen_ms:.4f} ms, fastest "
                 f"[{_sched_text(best)}] {best_ms:.4f} ms; all: "
                 + "; ".join(f"{sc.rows}x{sc.splits} {ms:.4f}"
                             for ms, sc in times))
        del x, ops
    torch.cuda.empty_cache()
    row = next(r for r in shapes if r["shape"] == WO_ROW_SHAPE
               and r["mode"] == "int8" and r["M"] == WG_ROW)
    return dict(max_abs_err=max(errs), ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                library_call="torch.matmul on the bf16 weight",
                plain_call="dequantize, then torch.matmul",
                timed_at=f"{WO_ROW_SHAPE} int8, M {WG_ROW}", shapes=shapes,
                llama_prompt=prompt, crossover=sweep,
                schedules=alternatives)


def llama_quant_phase(model, lens):
    """Phase 18, serving: ``llama2_7b`` (phase 14's bf16 model) served
    through ``ServingEngine(model, quant=...)`` in int8 and in fp8 on
    phase 14's mix.  int8: whole-prompt (median of ``REPEATS`` runs, one
    more with the overlapped loop off for ms per decode step, one
    profiled: the idle share, and every weight-only launch on the
    tensor-core kernel by name), 256-token chunks and phase 11's shared
    prefix (one run each).  fp8, whose engine differs only in the codes'
    type: one whole-prompt run, the run with the overlapped loop off and
    the profiled run.
    Every decode step's linear layers launch ``weight_only_matmul``
    (counted under replay); every run's prompts launch ``weight_only_gemm``
    and none takes the dequantize route (``dequant_calls`` 0: bf16
    activations).  Also the twin's resident bytes and its logits' largest
    deviation from bf16 on one prompt (informational: random weights)."""
    import torch
    from paddle_tpu_torch.inference.quant import quantize_model

    cfg = model.cfg
    per_step = sum(n for _, _, n in WO_SHAPES.values()
                   if n) if cfg.num_layers == 32 else None
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    ids = torch.tensor(prompts[1], device="cuda")[None]
    with torch.no_grad():
        ref = model(ids).float()
    out = {}
    for mode in QUANT_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        label = f"serving llama2_7b {mode}"
        base = torch.cuda.memory_allocated()
        twin, snap = quantize_model(model, mode)
        resident = torch.cuda.memory_allocated() - base
        with torch.no_grad():
            dev = (twin(ids).float() - ref).abs().max().item()
        del twin
        bf16_gib = model.num_params() * 2 / 2 ** 30
        _log(f"{label}: the twin holds {resident / 2 ** 30:.3f} GiB on the "
             f"card against the bf16 model's {bf16_gib:.3f} GiB; stats "
             f"{snap.stats()}; logits' largest deviation from "
             f"bf16 on a {ids.shape[1]}-token prompt {dev:.4f} (bf16 "
             f"logits up to {ref.abs().max().item():.3f}; random weights, "
             "informational)")
        del snap
        full = mode == QUANT_MODES[0]
        whole = [serve(model, prompts, 0, quant=mode)
                 for _ in range(REPEATS if full else 1)]
        ticks = serve(model, prompts, 0, time_ticks=True, overlap=False,
                      quant=mode)
        prof = where_the_time_goes(model, prompts, 0, f"{label} whole-prompt",
                                   nh=cfg.num_heads, quant=mode)
        names = _by_name(prof["run"]["kernels"], WO_NAMES)
        if names["weight_only_mma_kernel"][0] == 0 or \
                names["weight_only_gemm_kernel"][0] == 0 or \
                names["weight_only_fma_kernel"][0] != 0:
            raise AssertionError(f"{label}: weight-only launches by kernel "
                                 f"{names}")
        extra = {}
        if full:
            extra["256-token chunks"] = serve(model, prompts, 256,
                                              quant=mode)
            extra["shared 1024-token prefix, prefix cache on"] = serve(
                model, _prefix_prompts(cfg.vocab_size), 0,
                prefix_cache=True, quant=mode)
        runs = whole + [ticks, prof["run"]] + list(extra.values())
        for run in runs:
            n = run["launches"]["weight_only_matmul"]
            if per_step is not None and n < run["steps"] * per_step:
                raise AssertionError(
                    f"{label}: {n} weight-only launches for "
                    f"{run['steps']} decode steps of {per_step} linear "
                    f"layers")
            if n <= 0 or run["launches"]["paged_decode"] <= 0 or \
                    run["launches"]["weight_only_gemm"] <= 0:
                raise AssertionError(f"{label}: launches {run['launches']}")
            if run["dequant_calls"] != 0:
                raise AssertionError(f"{label}: {run['dequant_calls']} "
                                     "products took the dequantize route")
            if run["stats"]["quant"]["mode"] != mode:
                raise AssertionError(f"{label}: {run['stats']['quant']}")
        prefix = extra.get("shared 1024-token prefix, prefix cache on")
        if prefix is not None and \
                prefix["stats"]["prefix_cache"]["hits"] <= 0:
            raise AssertionError(f"{label}: no prefix hit")
        r = dict(whole[0])
        r["tokens_per_s_runs"] = [x["tokens_per_s"] for x in whole]
        r["tokens_per_s"] = _median(r["tokens_per_s_runs"])
        r["ttft_mean_s"] = _median([x["ttft_mean_s"] for x in whole])
        r["ms_per_step"] = ticks["tick_s"] / ticks["steps"] * 1e3
        r.update(idle=prof["idle"], weight_only_by_name=names,
                 resident_bytes=resident, logit_deviation=dev, extra=extra,
                 peak_bytes=torch.cuda.max_memory_allocated())
        _log(f"{label}, whole-prompt prefill: median of {len(whole)} runs "
             f"{r['tokens_per_s']:.1f} tokens/s (runs "
             + ", ".join(f"{x:.1f}" for x in r["tokens_per_s_runs"])
             + f"), mean TTFT {r['ttft_mean_s'] * 1e3:.1f} ms, "
             f"{r['ms_per_step']:.3f} ms per decode step (overlap off), idle "
             f"share {r['idle']:.3f}, weight-only kernels by name "
             + ", ".join(f"{n} {c}x {us / 1e3:.2f} ms"
                         for n, (c, us) in names.items())
             + f", warmup {r['warmup']['programs']} programs in "
             f"{r['warmup']['warmup_s']:.2f} s, {r['steps']} steps in "
             f"{r['ticks']} ticks, dequant_calls {r['dequant_calls']}, "
             f"stats()['quant'] {r['stats']['quant']}, launches "
             f"{r['launches']}")
        for key, run in extra.items():
            _log(f"{label}, {key} (one run): {run['tokens']} tokens in "
                 f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} "
                 f"tokens/s, mean TTFT {run['ttft_mean_s'] * 1e3:.1f} ms, "
                 f"{run['prefill_chunks']} chunks, dequant_calls "
                 f"{run['dequant_calls']}, launches {run['launches']}")
        _log(f"{label}: peak memory {r['peak_bytes'] / 2 ** 30:.2f} GiB")
        out[mode] = r
    return out


def activation_fake_quant_check():
    """Phase 18: an activation quanter (``FakeQuanterWithAbsMaxObserver``
    in training: the first call's absmax, then the EMA) on the card and on
    the CPU over the same float32 activations of a GPT-3 1.3B hidden state
    (B 2 x S 256 x 2048, a value past the EMA in the last call): scales
    and codes equal bit for bit, the round trip within 2.4e-7 relative
    (its last division is by a Python number, which the card computes as
    a product with the reciprocal), the straight-through gradients
    equal."""
    import torch
    from paddle_tpu_torch.quantization import FakeQuanterWithAbsMaxObserver

    gen = torch.Generator().manual_seed(18)
    card = FakeQuanterWithAbsMaxObserver().cuda().train()
    cpu = FakeQuanterWithAbsMaxObserver().train()
    for i in range(3):
        x = torch.randn((2, 256, 2048), generator=gen) * (1.0 + i)
        if i == 2:
            x[0, 0, 0] = 100.0
        xc, xh = x.cuda().requires_grad_(), x.clone().requires_grad_()
        yc, yh = card(xc), cpu(xh)
        if not torch.equal(card.scale.cpu(), cpu.scale):
            raise AssertionError(f"activation quanter: scale "
                                 f"{card.scale.item()!r} on the card, "
                                 f"{cpu.scale.item()!r} on the CPU")
        codes = [torch.round(y.detach().cpu() / sc * 127.0)
                 for y, sc in ((yc, card.scale.cpu()), (yh, cpu.scale))]
        if not torch.equal(codes[0], codes[1]):
            raise AssertionError("activation quanter: codes differ")
        torch.testing.assert_close(yc.detach().cpu(), yh.detach(),
                                   atol=0.0, rtol=2.4e-7)
        yc.sum().backward()
        yh.sum().backward()
        if not torch.equal(xc.grad.cpu(), xh.grad):
            raise AssertionError("activation quanter: STE gradients differ")
    _log(f"activation fake quant, card vs CPU: 3 training calls on "
         f"{tuple(x.shape)} fp32 activations, scales (last "
         f"{cpu.scale.item():.6f}) and codes equal, round trip within "
         "2.4e-7 relative, STE gradients equal")


def quant_cuts_phase():
    """Phase 18, card against CPU: an activation quanter
    (:func:`activation_fake_quant_check`); phase 3's GPT cut and phase
    15's GQA Llama cut (``CUT_LAYERS``; each built once for both modes)
    quantized int8 and fp8, 8 new tokens, whole-prompt, in 256-token
    chunks (Llama int8) and with n-gram speculation (GPT int8): the CPU's
    plain version dequantizes every weight at every step, ten times the
    fp32 model's time; then the fp32 GPT cut under ``QAT`` for 2 AdamW
    steps."""
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.models.llama import llama2_7b
    from paddle_tpu_torch.quantization import (QAT,
                                               FakeQuanterWithAbsMaxObserver,
                                               QuantConfig)
    activation_fake_quant_check()
    for cfg, label, prompt_len, int8_only in (
            (gpt3_1p3b(num_layers=CUT_LAYERS), CUT_LABEL, 96,
             dict(specs=(False, True))),
            (llama2_7b(num_layers=CUT_LAYERS, num_kv_heads=4),
             f"llama2_7b {CUT_LAYERS} layers, 4 kv heads, fp32", 260,
             dict(chunks=(0, 256)))):
        t = time.perf_counter()
        models = _cut_models(cfg)
        for mode in QUANT_MODES:
            card_vs_cpu(cfg, f"{label}, {mode}", prompt_len, quant=mode,
                        new_tokens=8, models=models,
                        **(int8_only if mode == "int8" else {}))
        del models
        _log(f"[{label}, int8 and fp8: {time.perf_counter() - t:.1f} s]")
    # fake-quantized weights: identical on both sides, so their codes are.
    # Activations would be rounded on the card's and the CPU's sums, which
    # differ in the last bits: a discontinuity that moves this cut's fp32
    # loss by ~4e-4 on the CPU alone (fp32 against fp64), past phase 5's
    # 1e-4 (the CPU tests hold activation fake quant against JAX, and
    # activation_fake_quant_check the quanter alone card against CPU)
    t = time.perf_counter()
    cfg = QuantConfig(weight=FakeQuanterWithAbsMaxObserver)
    train_card_vs_cpu(gpt3_1p3b(num_layers=CUT_LAYERS),
                      f"{CUT_LABEL} under QAT (weights)",
                      wrap=lambda m: QAT(cfg).quantize(m, inplace=True))
    _log(f"[QAT cut: {time.perf_counter() - t:.1f} s]")


# -------------------------------------------------------------- phase 22

FP16_STEPS = 8                        # 22a
FP16_O2_STEPS = 2                     # 22b
FP16_CUT_LOSS_ATOL = 5e-3             # 22c


def _fp16_step(model, opt, scaler, batch, level="O1"):
    """One float16 step: the loss under ``auto_cast(dtype="float16")`` at
    ``level``, the scaled backward, ``scaler.step`` (the fused step),
    clear the gradients."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(True, level=level, dtype="float16",
                       device=batch[0].device):
        loss = model.compute_loss(*batch)
    scaler.scale(loss).backward()
    scaler.step(opt)
    opt.clear_grad()
    return loss.detach()


def _fp16_run(model, opt, scaler, batch, steps, level="O1"):
    """``steps`` timed float16 steps from launch counts of 0; returns
    losses, step seconds, launches and the ``optimizer.fused`` counts."""
    import torch
    for fn in _train_counters().values():
        fn.launches = 0
    for fn in _plain_counters().values():
        fn.plain_calls = 0
    fused0 = _fused_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _fp16_step(model, opt, scaler, batch, level)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {n: fn.launches for n, fn in _train_counters().items()}
    fused = {k: v - fused0[k] for k, v in _fused_counts().items()}
    if any(_plain_calls().values()):
        raise AssertionError(f"fp16 training took plain routes: "
                             f"{_plain_calls()}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fp16 training: a loss is not finite: "
                             f"{losses}")
    return losses, times, launches, fused


def fp16_training_phase(o1):
    """Phase 22: float16 training of GPT-3 1.3B at full width.  a. Phase
    4's setup (fp32 weights, AdamW lr 1e-4, decay 0.01, global clip 1.0,
    its batch of B 4 x S 2048) under ``auto_cast(dtype="float16")`` O1
    with ``GradScaler()`` at its defaults (65536), 8 steps: every loss
    finite, at least half the steps applied, the skipped ones and the
    final scale printed; each flash kernel launched 24 x 8 times, on the
    fp16 tensor-core kernels by name in one profiled step; ``fused_adamw``
    every step with no fallback; step time, tokens/s, MFU and peak memory
    beside 21a's bf16 numbers (``o1``).  b. O2 ``decorate(dtype=
    "float16")``: 2 steps, ``fused_adamw`` hits, no fallback.  c. A
    2-layer fp32-weights cut under fp16 O1, card against CPU, 2 steps with
    a default scaler: losses within FP16_CUT_LOSS_ATOL (the card's fp16
    products sum in other orders than the CPU's: their fp16 activations
    part by an ulp here and there), the scale and applied steps equal.
    The CPU's fp16 matrix products run under
    :func:`_half_products_in_fp32` (see there)."""
    import statistics

    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.observability import flops as tflops

    cfg = gpt3_1p3b()
    tokens = TRAIN_B * TRAIN_S
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, batch = _train_setup(cfg, "cuda", 0, TRAIN_B, TRAIN_S)
    scaler = amp.GradScaler()
    init_scale = scaler._scale
    losses, times, launches, fused = _fp16_run(model, opt, scaler, batch,
                                               FP16_STEPS)
    _check_train_launches("22a", cfg, launches, FP16_STEPS)
    applied = opt._global_step
    skipped = FP16_STEPS - applied
    if fused["fallback"] or fused["hit"] + fused["miss"] != FP16_STEPS \
            or 2 * applied < FP16_STEPS:
        raise AssertionError(f"22a: optimizer.fused {fused}, {applied} of "
                             f"{FP16_STEPS} steps applied")
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    kind = torch.cuda.get_device_name(0)
    mfu = tokens / step_s * model.flops_per_token(TRAIN_S) / \
        tflops.peak_flops(kind)
    _log(f"22a gpt3_1p3b fp32 weights, auto_cast O1 float16, AdamW, clip "
         f"1.0, GradScaler() (init {init_scale}), B={TRAIN_B} S={TRAIN_S},"
         f" {FP16_STEPS} steps: losses {[round(x, 4) for x in losses]}; "
         f"{applied} applied, {skipped} skipped, final scale "
         f"{scaler._scale}; step times (s) {[round(t, 4) for t in times]}, "
         f"median of steps 2-{FP16_STEPS} {step_s * 1e3:.1f} ms = "
         f"{tokens / step_s:.1f} tokens/s, MFU {mfu:.4f}; peak memory "
         f"{peak / 2 ** 30:.2f} GiB; against 21a's bf16 "
         f"{o1['step_s'] * 1e3:.1f} ms (x{step_s / o1['step_s']:.3f}), "
         f"{o1['tokens_per_s']:.1f} "
         f"tokens/s, MFU {o1['mfu']:.4f}, {o1['peak_bytes'] / 2 ** 30:.2f} "
         f"GiB; launches {launches}; optimizer.fused {fused}")

    def step():
        t0 = time.perf_counter()
        _fp16_step(model, opt, scaler, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    wall, kernels = _profiled_flash("22a fp16", cfg, step)
    tc = [e for e in kernels if "flash_" in e.key and "_tc_kernel" in e.key]
    if not tc or any("__half" not in e.key for e in tc):
        raise AssertionError("22a: flash launches not on the fp16 "
                             "tensor-core instances: "
                             + "; ".join(e.key[:80] for e in tc))
    busy_us = sum(e.self_device_time_total for e in kernels)
    idle = 1 - busy_us / 1e6 / wall
    _log(f"22a profiled step: wall {wall * 1e3:.1f} ms, card busy "
         f"{busy_us / 1e3:.1f} ms, idle share {idle:.3f}; flash on "
         + ", ".join(sorted({e.key.split('(')[0][-60:] for e in tc})))
    run = dict(step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
               peak_bytes=peak, idle_share=idle, launches=launches,
               fused=fused, losses=losses, applied=applied,
               skipped=skipped, final_scale=scaler._scale)
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()

    # b. O2 in float16
    torch.cuda.reset_peak_memory_stats()
    model, opt, batch = _train_setup(cfg, "cuda", 0, TRAIN_B, TRAIN_S)
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler()
    losses, times, launches, fused = _fp16_run(model, opt, scaler, batch,
                                               FP16_O2_STEPS, level="O2")
    table = _fused_table(opt)
    n16 = sum(p.dtype == torch.float16 for p in table.params)
    if fused["fallback"] or fused["hit"] + fused["miss"] != FP16_O2_STEPS \
            or launches["fused_adamw"] != FP16_O2_STEPS or not n16:
        raise AssertionError(f"22b: optimizer.fused {fused}, launches "
                             f"{launches}, {n16} fp16 tensors")
    _check_train_launches("22b", cfg, launches, FP16_O2_STEPS)
    run["o2"] = dict(losses=losses, step_s=times[-1], launches=launches,
                     fused=fused, peak_bytes=torch.cuda.max_memory_allocated(),
                     applied=opt._global_step, scale=scaler._scale)
    _log(f"22b O2 decorate float16: {n16} of {len(table.params)} tensors "
         f"fp16 with float32 masters; losses {[round(x, 4) for x in losses]}"
         f", {opt._global_step} applied, scale {scaler._scale}; last step "
         f"{times[-1] * 1e3:.1f} ms (21d O2 bf16 "
         f"{o1['o2']['step_s'] * 1e3:.1f} ms); peak "
         f"{run['o2']['peak_bytes'] / 2 ** 30:.2f} GiB; launches {launches};"
         f" optimizer.fused {fused}")
    del model, opt, scaler, table
    gc.collect()
    torch.cuda.empty_cache()

    # c. card against CPU on a 2-layer cut
    cut = gpt3_1p3b(num_layers=CUT_LAYERS)
    init, runs = None, []
    rate = _cpu_fp16_gemm_rate()
    for dev in ("cpu", "cuda"):
        t = time.perf_counter()
        model, opt, batch = _train_setup(cut, dev, 2, 1, 256)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        scaler = amp.GradScaler()
        with _half_products_in_fp32() if dev == "cpu" else \
                contextlib.nullcontext():
            ls = [_fp16_step(model, opt, scaler, batch).item()
                  for _ in range(2)]
        runs.append((ls, scaler._scale, opt._global_step))
        _log(f"22c {dev}: 2 steps in {time.perf_counter() - t:.1f} s")
        del model, opt
    (cpu_l, cpu_s, cpu_g), (card_l, card_s, card_g) = runs
    diff = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    if diff > FP16_CUT_LOSS_ATOL or (card_s, card_g) != (cpu_s, cpu_g):
        raise AssertionError(f"22c: losses card {card_l} cpu {cpu_l}, scale "
                             f"{card_s} / {cpu_s}, applied {card_g} / "
                             f"{cpu_g}")
    _log(f"22c card vs CPU, gpt3_1p3b {CUT_LAYERS} layers fp32 weights under "
         f"fp16 O1, GradScaler(), B=1 S=256, 2 steps: losses card {card_l} "
         f"cpu "
         f"{cpu_l} ({diff:.3e} apart, limit {FP16_CUT_LOSS_ATOL}), scale "
         f"{card_s}, {card_g} applied on both (the host's own fp16 GEMM: "
         f"{rate:.2f} GFLOP/s at 64 x 2048 x 2048)")
    run["card_vs_cpu_loss_diff"] = diff
    return run


def _half_products_in_fp32():
    """A dispatch mode for the CPU side of phases 22c, 24b and 27e: each
    fp16 or bf16 matrix product (``mm``, ``addmm``, ``bmm``) runs on its
    inputs converted to float32 and rounds its result to that 16-bit type
    once, which is what a 16-bit GEMM with float32 accumulation (cuBLAS's
    on the card) computes, up to the order of its sums.  The CPU's own
    fp16 GEMM gives the same values but runs far slower on some hosts
    (``_cpu_fp16_gemm_rate``): on the H100 machine's host a run of 22c
    without it took most of 1055 s."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    products = (aten.mm.default, aten.addmm.default, aten.bmm.default)

    half = (torch.float16, torch.bfloat16)

    def fp32(a):
        return a.float() if isinstance(a, torch.Tensor) and \
            a.dtype in half else a

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            low = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                        and a.dtype in half), None)
            if func in products and low is not None:
                return func(*map(fp32, args), **kwargs).to(low)
            return func(*args, **kwargs)
    return Mode()


def _cpu_fp16_gemm_rate():
    """The host's own fp16 GEMM rate, GFLOP/s, at 64 x 2048 x 2048."""
    import torch
    a = torch.randn(64, 2048).half()
    b = torch.randn(2048, 2048).half()
    a @ b
    t = time.perf_counter()
    a @ b
    return 2 * 64 * 2048 * 2048 / (time.perf_counter() - t) / 1e9


# -------------------------------------------------------------- phase 23

GEN_IMPLS = ("dense", "static", "paged", "paged_eager")
GEN_CUT_B, GEN_CUT_PROMPT, GEN_CUT_NEW = 4, 64, 32
GEN_B, GEN_PROMPT, GEN_NEW = 4, 512, 128
LLAMA_GEN_PROMPT, LLAMA_GEN_NEW = 256, 32


def _gen_prompts(vocab, B, S, seed):
    """``B`` prompts of ``S`` tokens of uneven content: row b draws from
    the vocabulary's first ``vocab >> b`` tokens."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randint(1, max(2, vocab >> b), (S,),
                                      generator=gen) for b in range(B)])


def _top2_gap(model, ids):
    """The gap between the two largest logits of the next token of each
    row of ``ids`` (a full forward)."""
    import torch
    with torch.no_grad():
        top = model(ids)[:, -1].float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def _same_stream(label, model, a, b, prompt_len):
    """Streams ``a`` and ``b`` equal, or at their first divergence a
    near-tie: the two top logits of ``model`` there within 1e-3 (the
    logits' tolerance); returns the number of rows that part."""
    if a.shape == b.shape and bool((a.cpu() == b.cpu()).all()):
        return 0
    parted = 0
    for r in range(a.shape[0]):
        x, y = a[r].cpu(), b[r].cpu()
        n = min(len(x), len(y))
        diff = (x[:n] != y[:n]).nonzero()
        if len(diff) == 0:
            continue
        i = int(diff[0])
        gap = _top2_gap(model, x[None, :i].to(model.device))[0]
        if gap > 1e-3:
            raise AssertionError(f"{label}: row {r} parts at token "
                                 f"{i - prompt_len} with a top-2 logit gap "
                                 f"{gap:.3e} (> 1e-3)")
        _log(f"{label}: row {r} parts at new token {i - prompt_len}, a "
             f"near-tie (top-2 logit gap {gap:.3e})")
        parted += 1
    return parted


def generate_card_vs_cpu(cfg, label):
    """23a: ``generate`` on an fp32 cut, card (kernels) against CPU (plain
    versions), from one state dict: 4 prompts of uneven content at 64
    tokens, 32 new ones, each cache implementation on the card; greedy:
    the four card streams equal one another and the CPU's (its dense
    loop's; the CPU tests hold the four equal there); sampled (seed 7,
    top-k 50, top-p 0.9): each card stream equal to the CPU's of the
    same draw scheme (``dense`` and ``paged_eager`` draw one key a token,
    ``static`` and ``paged`` ``fold_in(key, step)``: the CPU's dense and
    static runs); the prompt's logits within atol 1e-3.  (Equal, or
    parted at a near-tie of the logits, which is printed:
    :func:`_same_stream`.)"""
    import torch
    from paddle_tpu_torch.core import random as trandom

    t = time.perf_counter()
    cpu, card = _cut_models(cfg)
    ids = _gen_prompts(cfg.vocab_size, GEN_CUT_B, GEN_CUT_PROMPT, 23)
    with torch.no_grad():
        lc = card.forward_with_cache(ids.cuda(), card.init_caches(
            GEN_CUT_B), 0)[0]
        lh = cpu.forward_with_cache(ids, cpu.init_caches(GEN_CUT_B), 0)[0]
    err = (lc.cpu() - lh).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"23a {label}: prompt logits {err:.3e} apart")
    sample = dict(do_sample=True, top_k=50, top_p=0.9)
    cpu_greedy = cpu.generate(ids, GEN_CUT_NEW, cache_impl="dense")
    cpu_sampled = {}
    for impl in ("dense", "static"):
        trandom.seed(7)
        cpu_sampled[impl] = cpu.generate(ids, GEN_CUT_NEW, cache_impl=impl,
                                         **sample)
    parted, replays = 0, {}
    for impl in GEN_IMPLS:
        got = card.generate(ids.cuda(), GEN_CUT_NEW, cache_impl=impl)
        replays[impl] = dict(card.last_generate)
        parted += _same_stream(f"23a {label} greedy {impl} card against "
                               "CPU", cpu, got, cpu_greedy, GEN_CUT_PROMPT)
        trandom.seed(7)
        got = card.generate(ids.cuda(), GEN_CUT_NEW, cache_impl=impl,
                            **sample)
        want = cpu_sampled["static" if impl in ("static", "paged")
                           else "dense"]
        parted += _same_stream(f"23a {label} sampled {impl} card against "
                               "CPU", cpu, got, want, GEN_CUT_PROMPT)
    for impl in ("static", "paged"):
        if not (replays[impl]["captured"] and
                replays[impl]["replays"] == GEN_CUT_NEW):
            raise AssertionError(f"23a {label} {impl}: {replays[impl]}")
    _log(f"23a generate card vs CPU, {label}: {GEN_CUT_B} prompts of "
         f"{GEN_CUT_PROMPT} tokens, {GEN_CUT_NEW} new, cache_impl "
         f"{', '.join(GEN_IMPLS)}: greedy streams of the four equal on the "
         f"card and to the CPU's, sampled (seed 7, top-k 50, top-p 0.9) "
         f"card equal to CPU for each, {parted} rows parted at near-ties; "
         f"prompt logits max abs diff {err:.3e} (limit 1e-3); static and "
         f"paged replayed their captured step {GEN_CUT_NEW} times "
         f"[{time.perf_counter() - t:.1f} s]")
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()


def _gen_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"flash_fwd": fa.flash_attention_fwd,
            "paged_decode": pa.paged_attention}


def generate_runs(model, label, B, prompt_len, new, impls, seed):
    """``generate`` at full width with each of ``impls``: the counts from
    0 (replays count their capture's launches), no plain route; the
    static and paged programs captured and replayed once a token.  Timed
    on the host clock, synchronised: the whole call, and ms per new token
    as the difference against a call of 1 new token over ``new - 1`` (the
    prompt and the capture cancel).  Returns per implementation the
    launches and times."""
    import torch
    ids = _gen_prompts(model.cfg.vocab_size, B, prompt_len, seed).cuda()
    out = {}
    for impl in impls:
        walls = {}
        for n in (1, new):
            for fn in _gen_counters().values():
                fn.launches = 0
            for fn in _plain_counters().values():
                fn.plain_calls = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = model.generate(ids, n, cache_impl=impl)
            torch.cuda.synchronize()
            walls[n] = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in _gen_counters().items()}
        plain = _plain_calls()
        last = dict(model.last_generate)
        need = ("flash_fwd",) + (("paged_decode",)
                                 if impl.startswith("paged") else ())
        if any(plain.values()) or toks.shape != (B, prompt_len + new) or \
                any(launches[k] <= 0 for k in need):
            raise AssertionError(f"{label} {impl}: launches {launches}, "
                                 f"plain_calls {plain}, shape "
                                 f"{tuple(toks.shape)}")
        if impl in ("static", "paged") and not (
                last["captured"] and last["replays"] == new):
            raise AssertionError(f"{label} {impl}: {last}")
        ms_tok = (walls[new] - walls[1]) / (new - 1) * 1e3
        out[impl] = dict(launches=launches, plain_calls=plain,
                         wall_s=walls[new], wall_1_s=walls[1],
                         ms_per_token=ms_tok,
                         tokens_per_s=B * (new - 1) / (walls[new]
                                                       - walls[1]),
                         replays=last["replays"],
                         captured=last["captured"])
        _log(f"{label} {impl}: B={B} prompt {prompt_len}, {new} new tokens "
             f"in {walls[new]:.3f} s (1 new token: {walls[1]:.3f} s): "
             f"{ms_tok:.3f} ms per new token (a step of {B} rows) = "
             f"{out[impl]['tokens_per_s']:.1f} tokens/s; captured "
             f"{last['captured']}, replays {last['replays']}; launches "
             f"{launches}; plain_calls {plain}")
    return out


def generate_phase():
    """Phase 23 (GPT): 23a the fp32 2-layer cut card against CPU, then
    23b GPT-3 1.3B in bf16 at full width: B 4, a 512-token prompt, 128
    new tokens, each cache implementation."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    generate_card_vs_cpu(gpt3_1p3b(num_layers=CUT_LAYERS), CUT_LABEL)
    gc.collect()
    torch.cuda.empty_cache()
    model = _model(gpt3_1p3b(), "cuda", 0, torch.bfloat16).eval()
    runs = generate_runs(model, "23b generate gpt3_1p3b bf16", GEN_B,
                         GEN_PROMPT, GEN_NEW, GEN_IMPLS, 24)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------------ main

# ------------------------------------------------------------ phase 24

# PaddleNLP-style lists in this repo's op names (phase 24)
CUSTOM_LISTS = dict(custom_black_list={"divide"},
                    custom_white_list={"embedding"})
LISTS_STEPS = 6


def _lists_step(model, opt, batch, lists):
    """bench.py's step (O1 bf16) with ``lists`` given to ``auto_cast``
    (none: torch's autocast); returns the loss and the context."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(True, level="O1", dtype="bfloat16",
                       device=batch[0].device, **lists) as ctx:
        loss = model.compute_loss(*batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach(), ctx


def custom_lists_phase():
    """Phase 24a: GPT-3 1.3B, phase 4's step, 6 steps under torch's
    autocast and 6 under the custom lists on one model, launch counts
    from 0 each; the median of steps 2-6, the losses, the peak, one
    profiled step each (idle share, the flash kernels by name), the
    mode's torch-function calls per step; ``fused_adamw`` takes every
    step.  Returns the custom-list run's numbers."""
    import statistics

    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    cfg = gpt3_1p3b()
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, batch = _train_setup(cfg, "cuda", 0, TRAIN_B, TRAIN_S)
    out = {}
    for key, lists in (("default", {}), ("lists", CUSTOM_LISTS)):
        for fn in _train_counters().values():
            fn.launches = 0
        fused0 = _fused_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(LISTS_STEPS):
            t0 = time.perf_counter()
            loss, ctx = _lists_step(model, opt, batch, lists)
            losses.append(loss.item())
            times.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in _train_counters().items()}
        fused = {k: v - fused0[k] for k, v in _fused_counts().items()}
        _check_train_launches(f"24a {key}", cfg, launches, LISTS_STEPS)
        if fused["fallback"] or fused["hit"] + fused["miss"] != LISTS_STEPS:
            raise AssertionError(f"24a {key}: optimizer.fused {fused}")
        peak = torch.cuda.max_memory_allocated()

        def step():
            t0 = time.perf_counter()
            _lists_step(model, opt, batch, lists)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        wall, kernels = _profiled_flash(f"24a {key}", cfg, step)
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        run = dict(step_s=statistics.median(times[1:]), losses=losses,
                   peak_bytes=peak, idle_share=1 - busy / wall,
                   launches=launches, fused=fused)
        if ctx.mode is not None:
            run["mode_calls_per_step"] = ctx.mode.calls
            run["mapped"] = {f"{n} {str(d)[6:]}": c
                             for (n, d), c in sorted(ctx.mode.ran.items())}
        out[key] = run
        _log(f"24a gpt3_1p3b O1 bf16, {key} "
             f"({'torch.autocast' if not lists else lists}): losses "
             f"{[round(x, 4) for x in losses]}; step times (s) "
             f"{[round(t, 4) for t in times]}, median of steps 2-"
             f"{LISTS_STEPS} {run['step_s'] * 1e3:.1f} ms; peak "
             f"{peak / 2 ** 30:.2f} GiB; idle share of a profiled step "
             f"{run['idle_share']:.3f}; launches {launches}; "
             f"optimizer.fused {fused}"
             + (f"; the mode saw {run['mode_calls_per_step']} torch "
                f"function calls in a step, mapped ops by type "
                f"{run['mapped']}" if "mapped" in run else ""))
    ratio = out["lists"]["step_s"] / out["default"]["step_s"]
    _log(f"24a custom lists against torch.autocast, same call: "
         f"{out['lists']['step_s'] * 1e3:.1f} against "
         f"{out['default']['step_s'] * 1e3:.1f} ms a step (x{ratio:.3f}); "
         f"idle share {out['lists']['idle_share']:.3f} against "
         f"{out['default']['idle_share']:.3f}")
    out["lists"]["ratio"] = ratio
    out["lists"]["default"] = out["default"]
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    lists_card_vs_cpu()
    return out["lists"]


def lists_card_vs_cpu():
    """Phase 24b: a 2-layer fp32 cut, card against CPU, two AdamW steps
    under the phase's lists and under a black-listed ``matmul``: the
    losses and parameters within phase 5's bounds and the bf16 training
    tolerance of ``tests/test_torch_train.py`` (the loss of each step,
    atol 2e-2, rtol 1e-2: bf16 products in other orders), and the type
    each mapped op ran in counted the same on both sides."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    cut = gpt3_1p3b(num_layers=CUT_LAYERS)
    for lists in (CUSTOM_LISTS, dict(custom_black_list={"matmul"})):
        init, runs = None, []
        for dev in ("cpu", "cuda"):
            model, opt, batch = _train_setup(cut, dev, 2, 1, 128)
            if init is None:
                init = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(init)
            losses, ran = [], None
            # the CPU's bf16 products in fp32 rounded once (the host's own
            # 16-bit GEMM may crawl: _half_products_in_fp32)
            with _half_products_in_fp32() if dev == "cpu" else \
                    contextlib.nullcontext():
                for _ in range(2):
                    loss, ctx = _lists_step(model, opt, batch, lists)
                    losses.append(loss.item())
                    ran = ctx.mode.ran if ran is None else ran
            runs.append((losses, ran, {k: v.detach().float().cpu() for k, v
                                       in model.state_dict().items()}))
            del model, opt
        (cpu_l, cpu_r, cpu_p), (card_l, card_r, card_p) = runs
        torch.testing.assert_close(torch.tensor(card_l), torch.tensor(cpu_l),
                                   atol=2e-2, rtol=1e-2)
        if card_r != cpu_r:
            raise AssertionError(f"24b {lists}: mapped ops by type card "
                                 f"{dict(card_r)} cpu {dict(cpu_r)}")
        err = max((card_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
        _log(f"24b custom lists {lists} card vs CPU, gpt3_1p3b {CUT_LAYERS} "
             f"layers fp32 weights, O1 bf16, B=1 S=128, 2 AdamW steps: "
             f"losses card "
             f"{card_l} cpu {cpu_l}; parameters max abs diff {err:.3e} "
             f"(printed: a bf16 gradient's sign may flip between card and "
             f"CPU, and Adam then moves the weight ~lr the other way); "
             f"mapped ops by type equal: "
             f"{ {f'{n} {str(d)[6:]}': c for (n, d), c in cpu_r.items()} }")
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 25

def moe_dense_phase(fused_train):
    """Phase 25: a. a 2-layer fp32 cut of GPT-MoE, the dense
    (``moe_fused_dispatch=False``) and fused paths, card against CPU, on
    the same weights, batch and routing uniforms: the loss (with the aux
    term), each block's ``l_aux`` and every gradient against the CPU's
    fused path (fp32: loss atol 1e-5, gradients atol 1e-4), no MoE kernel
    on the dense path.  b. Phase 8's full-width step on the dense path, 4
    steps: the (T, E, C) tensors' bytes, the peak, the step beside phase
    8's fused step (``fused_train``), MoE launches 0 and the flash kernels
    once a layer."""
    import statistics

    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import (MoELayer,
                                                                  capacity)
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    uniforms = torch.rand((2, 256), generator=torch.Generator()
                          .manual_seed(5))
    init, got = None, {}
    for dev in ("cpu", "cuda"):
        for fused in (True, False):
            cut = gpt3_1p3b(num_layers=MOE_CUT_LAYERS, moe_num_experts=MOE_E,
                            moe_fused_dispatch=fused)
            model, _, batch = _train_setup(cut, dev, 2, 1, 256)
            if init is None:
                init = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(init)
            _feed_uniforms(model, uniforms)
            for fn in _train_counters().values():
                fn.launches = 0
            loss = model.compute_loss(*batch)
            loss.backward()
            moe = [m for m in model.modules() if isinstance(m, MoELayer)]
            got[dev, fused] = dict(
                loss=loss.item(), aux=[m.l_aux.item() for m in moe],
                grads={n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()},
                launches={k: fn.launches
                          for k, fn in _train_counters().items()})
            del model
    want = got["cpu", True]
    for key, run in got.items():
        if abs(run["loss"] - want["loss"]) > 1e-5 or max(
                abs(a - b) for a, b in zip(run["aux"], want["aux"])) > 1e-6:
            raise AssertionError(f"25a {key}: loss {run['loss']} aux "
                                 f"{run['aux']} against {want['loss']} "
                                 f"{want['aux']}")
        err = max((run["grads"][n] - g).abs().max().item()
                  for n, g in want["grads"].items())
        if err > 1e-4:
            raise AssertionError(f"25a {key}: gradients {err:.3e} apart")
        run["grad_err"] = err
    dense_card = got["cuda", False]["launches"]
    if dense_card["moe_dispatch"] or dense_card["moe_combine"] or \
            got["cuda", True]["launches"]["moe_dispatch"] <= 0:
        raise AssertionError(f"25a launches: dense {dense_card}, fused "
                             f"{got['cuda', True]['launches']}")
    _log(f"25a GPT-MoE {MOE_CUT_LAYERS} layers fp32, B=1 S=256, dense and "
         f"fused "
         "paths card against CPU (the CPU's fused path the reference): "
         + "; ".join(
             f"{dev} {'fused' if f else 'dense'} loss {r['loss']:.6f} aux "
             f"{[round(a, 6) for a in r['aux']]} gradients {r['grad_err']:.2e}"
             for (dev, f), r in got.items())
         + f"; card dense launches {dense_card}")
    del got, init
    gc.collect()
    torch.cuda.empty_cache()

    # b. full width on the dense path
    cfg = gpt3_1p3b(moe_num_experts=MOE_E, moe_fused_dispatch=False)
    torch.cuda.reset_peak_memory_stats()
    model, opt, batch = _train_setup(cfg, "cuda", 0, TRAIN_B, TRAIN_S)
    steps = 4
    losses, times, launches = _run_train(model, opt, batch, steps)
    peak = torch.cuda.max_memory_allocated()
    blocks = _n_moe_blocks(cfg)
    if launches["moe_dispatch"] or launches["moe_combine"] or any(
            launches[k] != cfg.num_layers * steps
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        raise AssertionError(f"25b launches {launches}")
    T = TRAIN_B * TRAIN_S
    cap = capacity(T, MOE_E, 1, 1.2)
    tec = T * MOE_E * cap * 4
    step_s = statistics.median(times[1:])
    _log(f"25b GPT-MoE gpt3_1p3b dense path, B={TRAIN_B} S={TRAIN_S}, "
         f"{steps} steps: losses {[round(x, 4) for x in losses]}; step times "
         f"(s) {[round(t, 4) for t in times]}, median of steps 2-{steps} "
         f"{step_s * 1e3:.1f} ms beside phase 8's fused step "
         f"{fused_train['step_s'] * 1e3:.1f} ms (x"
         f"{step_s / fused_train['step_s']:.3f}); (T, E, C) = ({T}, {MOE_E}, "
         f"{cap}): combine and dispatch {tec / 2 ** 20:.1f} MiB each in "
         f"float32, {2 * tec * blocks / 2 ** 30:.2f} GiB over the {blocks} "
         f"MoE blocks; peak {peak / 2 ** 30:.2f} GiB (phase 8 fused "
         f"{fused_train['peak_bytes'] / 2 ** 30:.2f} GiB); launches "
         f"{launches}")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=step_s, peak_bytes=peak, launches=launches,
                tec_bytes=tec)


# ------------------------------------------------------------ phase 26

class _TokenData:
    """Phase 26's synthetic dataset: ``n`` samples of ``S`` random token
    ids and labels from a numpy seed (module level: the DataLoader's
    spawned workers unpickle it)."""

    def __init__(self, n, S, vocab, seed):
        import numpy as np
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, vocab, (n, S))
        self.labels = rng.randint(0, vocab, (n, S))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


HAPI_STEPS, HAPI_WORKERS = 8, 2
# GPT-3 1.3B at 4 of its 24 layers (the time limit: the two checkpoints
# of the full depth, 15.6 GB each, took ~40 s; 8 layers before phases
# 30-31 joined the run)
HAPI_LAYERS = 4
HAPI_DIR = os.path.join("build", "hapi_ckpt")


def _hapi_parts(cfg, seed):
    """The model, AdamW (weight decay 0.01, clip 1.0) under a cosine
    schedule, and the LM loss of ``hapi.Model``."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod
    model = _model(cfg, "cuda", seed)
    model.train()
    sched = lr_mod.CosineAnnealingDecay(LR, 100)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))

    def lm_loss(logits, labels):
        return cross_entropy(logits.reshape(-1, cfg.vocab_size),
                             labels.reshape(-1))
    return model, opt, sched, lm_loss


def hapi_phase():
    """Phase 26: ``hapi.Model.fit`` on GPT-3 1.3B (fp32 weights, O1 bf16)
    over a ``DataLoader`` of 2 spawned workers, 8 shuffled steps, with
    ``ProgBarLogger``, ``LRScheduler`` and ``ModelCheckpoint``, beside
    the hand-written step (phase 4's) on the same batches (the same numpy
    seed before each loader): the losses, the step time (median of the
    last 6), tokens/s, MFU, the peak, the idle share of a profiled
    ``train_batch``, the flash kernels by name, 8 timeline records,
    ``fused_adamw`` on every step; then ``evaluate`` and ``predict`` on 4
    batches, the final checkpoint loaded into a fresh model (the same
    logits), and 4 fp16 steps with a GradScaler at 65536."""
    import shutil
    import statistics

    import numpy as np
    import torch
    from paddle_tpu_torch import hapi, io
    from paddle_tpu_torch.hapi.callbacks import (LRScheduler,
                                                 ModelCheckpoint,
                                                 ProgBarLogger)
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    from paddle_tpu_torch.observability import telemetry

    cfg = gpt3_1p3b(num_layers=HAPI_LAYERS)
    data = _TokenData(64, TRAIN_S, cfg.vocab_size, 0)
    train = io.Subset(data, range(HAPI_STEPS * TRAIN_B))
    held = io.Subset(data, range(48, 52))
    tokens = TRAIN_B * TRAIN_S
    gc.collect()
    torch.cuda.empty_cache()

    # the hand-written step on the same batches
    model, opt, sched, _ = _hapi_parts(cfg, 0)
    # the same sampler draws in the main process (fit spawns the workers)
    np.random.seed(1)
    loader = io.DataLoader(train, batch_size=TRAIN_B, shuffle=True)
    hand, hand_t = [], []
    torch.cuda.synchronize()
    t_hand = time.perf_counter()
    for ids, labels in loader:
        t0 = time.perf_counter()
        loss = _train_step(model, opt, (ids, labels), True)
        hand.append(loss.item())
        hand_t.append(time.perf_counter() - t0)
        sched.step()
    t_hand = time.perf_counter() - t_hand
    del model, opt, sched, loader
    gc.collect()
    torch.cuda.empty_cache()

    # the same under hapi.Model.fit
    model, opt, sched, lm_loss = _hapi_parts(cfg, 0)
    hm = hapi.Model(model)
    hm.prepare(optimizer=opt, loss=lm_loss, amp_configs="O1")
    tl = telemetry.default_timeline()
    tl.reset()
    tl.configure(flops_per_token=model.flops_per_token(TRAIN_S),
                 device_kind=torch.cuda.get_device_name(0))
    shutil.rmtree(HAPI_DIR, ignore_errors=True)
    for fn in _train_counters().values():
        fn.launches = 0
    fused0 = _fused_counts()
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(1)
    t_fit = time.perf_counter()
    hm.fit(train, batch_size=TRAIN_B, epochs=1, shuffle=True,
           num_workers=HAPI_WORKERS, verbose=0,
           callbacks=[ProgBarLogger(verbose=0), LRScheduler(),
                      ModelCheckpoint(save_dir=HAPI_DIR)])
    t_fit = time.perf_counter() - t_fit
    launches = {k: fn.launches for k, fn in _train_counters().items()}
    fused = {k: v - fused0[k] for k, v in _fused_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    recs = tl.records
    fit = [r["loss"] for r in recs]
    _check_train_launches("26 fit", cfg, launches, HAPI_STEPS)
    if len(recs) != HAPI_STEPS or not all(r["synced"] for r in recs) or \
            fused["fallback"] or fused["hit"] + fused["miss"] != HAPI_STEPS:
        raise AssertionError(f"26 fit: {len(recs)} records, fused {fused}")
    diff = max(abs(a - b) for a, b in zip(fit, hand))
    if diff > 1e-4:
        raise AssertionError(f"26: fit losses {fit} against the hand-"
                             f"written step's {hand}")
    step_s = statistics.median(r["wall_s"] for r in recs[2:])
    period = statistics.median(r["wall_s"] + r["gap_s"] for r in recs[2:])
    hand_s = statistics.median(hand_t[2:])
    mfu = statistics.median(r["mfu"] for r in recs[2:])
    ids, labels = next(iter(io.DataLoader(train, batch_size=TRAIN_B)))
    # the final checkpoint into a fresh model: the same logits
    fresh, fresh_opt, _, _ = _hapi_parts(cfg, 5)
    hm2 = hapi.Model(fresh)
    hm2.prepare(optimizer=fresh_opt, loss=lm_loss)
    t0 = time.perf_counter()
    hm2.load(os.path.join(HAPI_DIR, "final"))
    t_load = time.perf_counter() - t0
    a, b = hm.predict_batch([ids[:1]])[0], hm2.predict_batch([ids[:1]])[0]
    if not np.array_equal(a, b):
        raise AssertionError("26: the loaded model's logits differ")
    del a, b
    ev = hm.evaluate(held, batch_size=1, verbose=0)
    pred = hm.predict(held, batch_size=1, verbose=0)
    if len(pred[0]) != 4 or pred[0][0].shape != (1, TRAIN_S,
                                                 cfg.vocab_size) or \
            not np.isfinite(ev["loss"]):
        raise AssertionError(f"26 evaluate {ev}, predict "
                             f"{[p.shape for p in pred[0]]}")
    del pred

    def step():
        t0 = time.perf_counter()
        hm.train_batch([ids], [labels])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall, kernels = _profiled_flash("26 fit", cfg, step)
    idle = 1 - sum(e.self_device_time_total for e in kernels) / 1e6 / wall
    _log(f"26 hapi.Model.fit gpt3_1p3b fp32 weights, O1 bf16, AdamW under "
         f"a cosine schedule, clip 1.0, B={TRAIN_B} S={TRAIN_S}, "
         f"{HAPI_WORKERS} workers, {HAPI_STEPS} steps: losses "
         f"{[round(x, 5) for x in fit]} (the hand-written step's on the same"
         f" batches {[round(x, 5) for x in hand]}, max diff {diff:.3e}, "
         f"{'bit for bit' if diff == 0 else 'not bit for bit'}); step "
         f"(timeline wall, median of the last 6) {step_s * 1e3:.1f} ms = "
         f"{tokens / step_s:.1f} tokens/s, MFU {mfu:.4f}, with the loader's "
         f"gap {period * 1e3:.1f} ms; the hand-written step {hand_s * 1e3:.1f}"
         f" ms (x{step_s / hand_s:.3f}); whole fit {t_fit:.1f} s (two "
         f"checkpoints in it), hand-written loop {t_hand:.1f} s; peak "
         f"{peak / 2 ** 30:.2f} GiB; idle share of a profiled train_batch "
         f"{idle:.3f}; launches {launches}; optimizer.fused {fused}; "
         f"{len(recs)} timeline records")
    del hm, model, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"26 evaluate (4 batches): {ev}; predict: 4 batches of [1, "
         f"{TRAIN_S}, {cfg.vocab_size}]; the final checkpoint loaded into "
         f"a fresh model in {t_load:.1f} s: logits bit for bit")

    # fp16: 4 steps with a GradScaler at 65536 on the loaded model
    hm2.prepare(optimizer=fresh_opt, loss=lm_loss,
                amp_configs={"level": "O1", "dtype": "float16",
                             "init_loss_scaling": 65536})
    for fn in _train_counters().values():
        fn.launches = 0
    g0 = int(fresh_opt._global_step)
    tl.reset()
    hm2.fit(io.Subset(data, range(16)), batch_size=TRAIN_B, epochs=1,
            shuffle=False, verbose=0)
    launches16 = {k: fn.launches for k, fn in _train_counters().items()}
    st = hm2._scaler.state_dict()
    applied = int(fresh_opt._global_step) - g0
    losses16 = [r["loss"] for r in tl.records]
    if not all(np.isfinite(losses16)) or launches16["flash_fwd"] <= 0 or \
            launches16["fused_adamw"] != 4:
        raise AssertionError(f"26 fp16: losses {losses16}, launches "
                             f"{launches16}")
    _log(f"26 fit fp16 O1, GradScaler(init_loss_scaling=65536), 4 steps: "
         f"losses {[round(x, 4) for x in losses16]}; {4 - applied} steps "
         f"skipped, final scale {st['scale']}; launches {launches16}")
    del hm2, fresh, fresh_opt
    shutil.rmtree(HAPI_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=step_s, hand_step_s=hand_s, tokens_per_s=tokens /
                step_s, mfu=mfu, peak_bytes=peak, idle_share=idle,
                launches=launches, fp16_launches=launches16,
                loss_diff=diff)


# ------------------------------------------------------------ phase 27

FP16_LOGIT_TOL = dict(atol=5e-2, rtol=5e-2)


def _fp16_names(label, kernels):
    """Every paged launch of an fp16 run on the fp16 instances by name:
    the split decode and its merge, the tensor-core chunk kernel (and
    its merge), never the FMA chunk kernel."""
    names = ("paged_decode_split_kernel<__half", "paged_decode_merge_"
             "kernel<__half", "paged_chunk_tc_kernel<__half",
             "paged_chunk_merge_kernel<__half", "paged_chunk_kernel<",
             "flash_fwd_tc_kernel<__half")
    got = _by_name(kernels, names)
    if got["paged_chunk_kernel<"][0] or \
            got["paged_decode_split_kernel<__half"][0] == 0:
        raise AssertionError(f"{label}: kernels by name {got}")
    _log(f"{label}, fp16 kernels by name: " + ", ".join(
        f"{n} {c}x {us / 1e3:.2f} ms" for n, (c, us) in got.items()))
    return got


def _first_decode_logits(model, prompt):
    """The logits of the first decode step through a paged cache (the
    fp16 prompt on flash_fwd, the step on paged_decode)."""
    import torch
    caches = model.init_caches(1, cache_impl="paged", block_size=BS,
                               max_context=MAX_CONTEXT)
    ids = torch.tensor([prompt], device="cuda")
    with torch.no_grad():
        logits, caches = model.forward_with_cache(ids, caches)
        nxt = logits[:, -1:].argmax(-1)
        step, _ = model.forward_with_cache(nxt, caches,
                                           pos_offset=len(prompt))
    return step[0, -1].float(), nxt


def fp16_serving_phase(lens, bf16):
    """Phase 27a-c (GPT): GPT-3 1.3B in fp16 served whole-prompt and in
    256-token chunks (default engine; the chunked run profiled), on eager
    programs (streams equal), with the ticks timed (overlap off); the
    first decode step's logits against a dense fp32 forward of the same
    fp16 weights; a prefix hit and n-gram spec verify; GPT-MoE in fp16
    on 4 requests; ``generate`` paged and paged_eager in fp16.  ``bf16``:
    phase 2's runs and phase 23b's, for the same-call comparison."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float16,
                           seed=0).eval()
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    out = {}
    out["whole"] = serve(model, prompts, 0)
    out["chunked"] = serve(model, prompts, 256)
    _fp16_names("27a chunked fp16 (a second, profiled run)",
                serve(model, prompts, 256, profile=True)["kernels"])
    eager = serve(model, prompts, 0, cuda_graphs=False)
    if eager["streams"] != out["whole"]["streams"]:
        raise AssertionError("27a: graphs' fp16 streams differ from the "
                             "eager programs'")
    ticks = serve(model, prompts, 0, time_ticks=True, overlap=False)
    ms_step = ticks["tick_s"] / max(ticks["steps"], 1) * 1e3
    for key, need in (("whole", ("flash_fwd", "paged_decode")),
                      ("chunked", ("paged_chunk", "paged_decode"))):
        if any(out[key]["launches"][n] <= 0 for n in need):
            raise AssertionError(f"27a {key}: {out[key]['launches']}")
    b_whole, b_chunk = bf16["runs"][0], bf16["runs"][256]
    b_step = bf16["runs"]["graphs"]["graphs"]["ms_per_step"]
    b13 = bf16["runs"]["graphs"]["overlap"]
    _log(f"27a bf16 yardsticks of the same call: phase 13's default engine "
         f"(median of {REPEATS}) {b13['tokens_per_s']:.1f} tokens/s, mean "
         f"TTFT {b13['ttft_mean_s'] * 1e3:.1f} ms")
    for key, b in (("whole", b_whole), ("chunked", b_chunk)):
        r = out[key]
        _log(f"27a serving gpt3_1p3b fp16, {key}: {r['tokens_per_s']:.1f} "
             f"tokens/s (bf16 {b['tokens_per_s']:.1f}, x"
             f"{r['tokens_per_s'] / b['tokens_per_s']:.3f}), mean TTFT "
             f"{r['ttft_mean_s'] * 1e3:.1f} ms (bf16 "
             f"{b['ttft_mean_s'] * 1e3:.1f}), launches {r['launches']}, "
             f"plain_calls {r['plain_calls']}")
    _log(f"27a fp16 ms per decode step (graphs, overlap off, one run) "
         f"{ms_step:.3f} against bf16's {b_step:.3f} (x{ms_step / b_step:.3f}"
         f"); streams equal to the eager programs' (cuda_graphs=False)")
    # the first decode step against a dense fp32 forward of the same
    # fp16 weights
    got, nxt = _first_decode_logits(model, prompts[0])
    ref = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = ref(torch.tensor([prompts[0] + [int(nxt)]],
                                device="cuda"))[0, -1]
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **FP16_LOGIT_TOL)
    _log(f"27a the first decode step's logits (fp16, paged) against a dense "
         f"fp32 forward of the same fp16 weights: max abs diff {err:.3e} "
         f"(logits' max {want.abs().max().item():.3f}; limit atol "
         f"{FP16_LOGIT_TOL['atol']} rtol {FP16_LOGIT_TOL['rtol']})")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # b. a prefix hit and spec verify
    out["prefix"] = serve(model, _prefix_prompts(cfg.vocab_size), 0,
                          prefix_cache=True)
    out["spec"] = serve(model, _repetitive_prompts(cfg.vocab_size), 0,
                        spec_decode=True, spec_draft="ngram", spec_k=4)
    pc = out["prefix"]["stats"]["prefix_cache"]
    sp = out["spec"]["stats"]["speculative"]
    if pc["hits"] <= 0 or out["prefix"]["launches"]["paged_chunk"] <= 0 or \
            out["spec"]["launches"]["paged_verify_attention"] <= 0:
        raise AssertionError(f"27b: prefix {pc}, launches "
                             f"{out['prefix']['launches']}, spec "
                             f"{out['spec']['launches']}")
    _log(f"27b fp16 prefix hits {pc['hits']} (paged_chunk "
         f"{out['prefix']['launches']['paged_chunk']} launches), n-gram "
         f"spec accept rate {sp['accept_rate']} (paged_verify_attention "
         f"{out['spec']['launches']['paged_verify_attention']} launches)")
    # c. generate in fp16, then GPT-MoE
    out["generate"] = generate_runs(model, "27c generate gpt3_1p3b fp16",
                                    GEN_B, GEN_PROMPT, GEN_NEW,
                                    ("paged", "paged_eager"), 24)
    for impl, r in out["generate"].items():
        b = bf16["generate"][impl]["ms_per_token"]
        _log(f"27c generate {impl} fp16 {r['ms_per_token']:.3f} ms per new "
             f"token against bf16's {b:.3f} (x{r['ms_per_token'] / b:.3f})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe = GPTForCausalLM(gpt3_1p3b(moe_num_experts=MOE_E), device="cuda",
                         dtype=torch.float16, seed=0).eval()
    out["moe"] = serve(moe, prompts[:4], 0)
    n = out["moe"]["launches"]
    if n["moe_dispatch"] <= 0 or n["moe_dispatch"] != n["moe_combine"]:
        raise AssertionError(f"27c GPT-MoE fp16: launches {n}")
    _log(f"27c serving GPT-MoE fp16, 4 requests: "
         f"{out['moe']['tokens_per_s']:.1f} tokens/s, launches {n}")
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    fp16_cut_card_vs_cpu()
    return out


def llama_fp16_serving(model, lens, bf16_whole):
    """Phase 27d, inside phase 14's model lifetime: the Llama-2 7B weights
    rounded to fp16, one whole-prompt run of phase 14's mix."""
    import torch
    model.half()
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in lens]
    run = serve(model, prompts, 0)
    if any(run["launches"][k] <= 0 for k in ("flash_fwd", "paged_decode")):
        raise AssertionError(f"27d: launches {run['launches']}")
    _log(f"27d serving llama2_7b fp16 (the bf16 weights rounded to fp16), "
         f"whole-prompt: {run['tokens_per_s']:.1f} tokens/s (bf16 "
         f"{bf16_whole['tokens_per_s']:.1f}), mean TTFT "
         f"{run['ttft_mean_s'] * 1e3:.1f} ms (bf16 "
         f"{bf16_whole['ttft_mean_s'] * 1e3:.1f}), launches "
         f"{run['launches']}")
    return run


def fp16_cut_card_vs_cpu():
    """Phase 27e: a 2-layer cut of GPT-3 1.3B in fp16 serves the same
    greedy prompts on the card (default engine) and on the CPU (its fp16
    products in fp32 rounded once, ``_half_products_in_fp32``): streams
    compared; each token that differs is reported with the top-2 logit
    gap where the streams part (ROADMAP.md reference fact 10: rounding, to
    be reported, not tuned away)."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    cpu, card = _cut_models(gpt3_1p3b(num_layers=CUT_LAYERS))
    cpu.half()
    card.half()
    gen = torch.Generator().manual_seed(8)
    prompts = [torch.randint(1, 50000, (n,), generator=gen).tolist()
               for n in (60, 150)]
    got, _ = _cut_streams(card, "cuda", prompts)
    with _half_products_in_fp32():
        want, _ = _cut_streams(cpu, "cpu", prompts)
    parted = []
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = _top2_gap(card, torch.tensor([p + a[:i]], device="cuda"))[0]
        parted.append((i, gap))
    _log(f"27e gpt3_1p3b {CUT_LAYERS} layers fp16, card against CPU, "
         f"{len(prompts)} greedy streams of 16 tokens: "
         f"{len(prompts) - len(parted)} equal"
         + (f"; parted at (token, top-2 logit gap on the card) {parted}"
            if parted else ""))
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()


def ptxas_report(build_dir):
    """Registers and spills of every kernel from the ``-Xptxas -v``
    reports; the tensor-core kernels must not spill at hd 64 and 128, and
    no instance of ``weight_only_gemm_kernel`` (int8 and fp8 codes, tiles
    of 64, 128 and 256 rows) may spill, keep a stack frame or have its
    ``wgmma`` serialised by ptxas (C7513/C7515).  Returns ({kernel: {hd:
    "N registers, S spill stores, L spill loads"}} for the tensor-core
    kernels, {"int8/fp8 BM rows": text} for the GEMM)."""
    import re
    tc, gemm = {}, {}
    for f in sorted(build_dir.glob("*.ptxas.txt")):
        entry = None
        for line in f.read_text().splitlines():
            if "serialized" in line and "weight_only_gemm" in line:
                raise AssertionError(f"ptxas serialises wgmma: {line}")
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = int(m.group(1))
                spills = (int(m.group(2)), int(m.group(3)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if not m:
                continue
            name = re.search(r"ptt\d+(\w+?_kernel)", entry)
            name = name.group(1) if name else entry
            hd = re.search(r"Li(\d+)E", entry)
            hd = int(hd.group(1)) if hd else None
            # the tensor-core kernels' element type (T = __half or
            # __nv_bfloat16 in the mangled name)
            ty = "fp16" if "6__half" in entry else "bf16"
            text = (f"{m.group(1)} registers, {spills[0]} bytes spill "
                    f"stores, {spills[1]} bytes spill loads")
            _log(f"  {f.name.split('.')[0]}: {name} {ty} hd {hd}: {text}, "
                 f"{frame} bytes stack frame")
            if name.endswith("_tc_kernel"):
                tc.setdefault(name, {})[f"{ty} hd {hd}"] = text
                if hd in (64, 128) and spills != (0, 0):
                    raise AssertionError(f"{name} {ty} hd {hd} spills: "
                                         f"{text}")
            if name == "weight_only_gemm_kernel":
                qt, rows = re.search(r"ILi(\d)ELi(\d+)E", entry).groups()
                key = f"{('int8', 'fp8')[int(qt)]} {rows} rows"
                gemm[key] = text
                if spills != (0, 0) or frame:
                    raise AssertionError(f"{name} {key}: {text}, {frame} "
                                         "bytes stack frame")
            entry = None
    for name in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                 "flash_bwd_dkv_tc_kernel", "paged_chunk_tc_kernel"):
        want = sorted(f"{t} hd {hd}" for t in ("bf16", "fp16")
                      for hd in (64, 128, 256))
        if sorted(tc.get(name, {})) != want:
            raise AssertionError(f"ptxas report: {name} instances "
                                 f"{sorted(tc.get(name, {}))}")
    if len(gemm) != 6:
        raise AssertionError(f"ptxas report: weight_only_gemm_kernel "
                             f"instances {sorted(gemm)}")
    return tc, gemm


# -------------------------------------------------------------- phase 28

TP_DEVICES = ["cuda:0", "cuda:0"]   # two ranks share the one card (gloo)
TP_NEW = 16                          # phase 28a's new tokens a request


def tp_serve(model, prompts, chunk, extra=(), devices=None, dev="cuda",
             new_tokens=64, max_batch=BATCH, max_context=MAX_CONTEXT,
             **engine_kw):
    """Phase 2's requests (``new_tokens`` new, odd ones sampled), then the
    ``extra`` prompts (greedy, one after another), on an engine at
    ``tp_degree=2`` (ranks on ``devices``, card 0 twice by default: gloo,
    eager programs, overlap off), with every rank's counters at 0 first.
    Decode ticks are timed (the card synchronised at each dispatch, the
    clock stopped at the harvest) with the collectives inside them.
    Returns the numbers and every rank's report; the workers are stopped
    before it returns."""
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    t0 = time.perf_counter()
    eng = ServingEngine(model, max_batch=max_batch, max_context=max_context,
                        block_size=BS, steps_per_tick=8,
                        prefill_chunk=chunk, device=dev, tp_degree=2,
                        tp_devices=devices or TP_DEVICES, overlap=False,
                        **engine_kw)
    start_s = time.perf_counter() - t0
    try:
        m = eng.model
        tick = dict(s=0.0, steps=0, n=0, comm_s=0.0, comm_calls=0,
                    comm_bytes=0)
        mark = {}
        dispatch, harvest = eng._dispatch_tick, eng._harvest

        def sync():
            if dev == "cuda":
                torch.cuda.synchronize()

        def timed_dispatch(*a):
            sync()
            mark.update(t=time.perf_counter(), c=(m.comm_s, m.comm_calls,
                                                  m.comm_bytes))
            return dispatch(*a)

        def timed_harvest(pend):
            out = harvest(pend)
            tick["s"] += time.perf_counter() - mark["t"]
            tick["n"] += 1
            tick["steps"] += pend.k
            tick["comm_s"] += m.comm_s - mark["c"][0]
            tick["comm_calls"] += m.comm_calls - mark["c"][1]
            tick["comm_bytes"] += m.comm_bytes - mark["c"][2]
            return out
        eng._dispatch_tick, eng._harvest = timed_dispatch, timed_harvest
        eng.tp_reset_counters()
        reqs = [Request(p, max_new_tokens=new_tokens, do_sample=bool(i % 2),
                        temperature=0.9, top_k=40, top_p=0.95, seed=1000 + i)
                for i, p in enumerate(prompts)]
        sync()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run()
        sync()
        wall = time.perf_counter() - t0
        ext = []
        for p in extra:
            ext.append(eng.add_request(Request(p, max_new_tokens=16)))
            eng.run()
        report = eng.tp_report()
        st = eng.stats()
        del eng._dispatch_tick, eng._harvest
    finally:
        eng.shutdown()
    vocab = model.cfg.vocab_size
    for r in reqs + ext:
        want = r.max_new_tokens
        if not r.done or len(r.output_ids) != want:
            raise AssertionError(f"TP request {r.rid}: "
                                 f"{len(r.output_ids)} of {want} tokens")
        if not all(0 <= t < vocab for t in r.output_ids):
            raise AssertionError(f"TP request {r.rid}: token out of range")
    if st["free_blocks"] != eng.num_blocks or st["reserved"] != 0:
        raise AssertionError(f"TP engine leaked blocks: {st}")
    if st["graphs"]["enabled"]:
        raise AssertionError("a tensor-parallel engine captured graphs")
    for r, rep in enumerate(report):
        plain = {k: v for k, v in rep["counters"].items()
                 if k.endswith("plain_calls") and v}
        if plain:
            raise AssertionError(f"TP rank {r} took plain routes: {plain}")
        if rep.get("modules"):
            raise AssertionError(f"TP rank {r} imported {rep['modules']}")
    n_tok = sum(len(r.output_ids) for r in reqs)
    return dict(wall_s=wall, start_s=start_s, tokens=n_tok,
                tokens_per_s=n_tok / wall, tick=tick, stats=st,
                report=report, streams=[list(r.output_ids) for r in reqs],
                extra=[list(r.output_ids) for r in ext])


def _rank_launches(run, names):
    """Each rank's launch counts of the kernels ``names`` (the wrappers'
    function names)."""
    return [{n: rep["counters"].get(f"{n}.launches", 0) for n in names}
            for rep in run["report"]]


def _first_divergence(streams, base):
    """(request, position) of each greedy request's first differing
    token, None where the stream equals ``base``'s."""
    out = []
    for i in range(0, len(base), 2):
        n = next((j for j, (a, b) in enumerate(zip(streams[i], base[i]))
                  if a != b), None)
        out.append((i, n))
    return out


def tp_phase(model, prompts, runs):
    """Phase 28: tensor-parallel serving of GPT-3 1.3B in bf16 at full
    width, ``tp_degree=2`` with both ranks on card 0 over gloo.  a. Phase
    2's mix, whole prompts, ``TP_NEW`` new tokens: ms per decode step,
    tokens/s, collectives and bytes per tick, their share of the tick,
    the greedy streams against degree 1's (phase 2), each rank's resident
    bytes against degree 1's.  b. The first two requests of the mix
    (greedy and sampled) and two on a shared 1024-token prefix (the
    second hits), int8 (``quantize_plan``), 256-token chunks and n-gram
    speculation in one engine.  c. The 4-layer fp32 cut card against
    CPU.  On every rank: the kernels launched, the pools at 8 heads, no
    plain route, no leaked block."""
    import torch
    cfg = model.cfg
    need = {"whole": ("flash_attention_fwd", "paged_attention"),
            "int8_chunked_prefix_spec": (
                "paged_chunk_attention", "paged_verify_attention",
                "paged_attention", "weight_only_matmul",
                "weight_only_gemm")}
    gen = torch.Generator().manual_seed(11)
    shared = torch.randint(1, cfg.vocab_size, (1024,), generator=gen).tolist()
    out = {}
    for name, prm, new, kw, extra in (
            ("whole", prompts, TP_NEW, {}, ()),
            ("int8_chunked_prefix_spec", prompts[:2], 16,
             dict(prefill_chunk=256, quant="int8", spec_decode=True,
                  spec_draft="ngram", spec_k=4),
             [shared + [7, 8, 9], shared + [10, 11]])):
        chunk = kw.pop("prefill_chunk", 0)
        run = tp_serve(model, prm, chunk, extra, new_tokens=new, **kw)
        for r, counts in enumerate(_rank_launches(run, need[name])):
            bad = [n for n, c in counts.items() if c <= 0]
            if bad:
                raise AssertionError(f"phase 28 {name}: rank {r} never "
                                     f"launched {bad}: {counts}")
        heads = {rep["pool_heads"] for rep in run["report"]}
        if heads != {cfg.num_heads // 2}:
            raise AssertionError(f"phase 28 {name}: pools hold {heads} heads")
        if name != "whole" and run["stats"]["prefix_cache"]["hits"] < 1:
            raise AssertionError("phase 28: the shared prefix never hit")
        tk = run["tick"]
        ms_step = tk["s"] / max(tk["steps"], 1) * 1e3
        _log(f"phase 28 gpt3_1p3b bf16 tp_degree=2 (2 ranks on card 0, "
             f"gloo), {name}: {run['tokens']} tokens in "
             f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s; "
             f"{tk['steps']} decode steps in {tk['n']} ticks, "
             f"{ms_step:.2f} ms per decode step; collectives per tick "
             f"{tk['comm_calls'] / max(tk['n'], 1):.1f} "
             f"({tk['comm_calls'] / max(tk['steps'], 1):.1f} a step), bytes "
             f"gathered per tick {tk['comm_bytes'] / max(tk['n'], 1):.0f}, "
             f"share of the ticks in collectives "
             f"{tk['comm_s'] / max(tk['s'], 1e-9):.3f}; engine start "
             f"{run['start_s']:.1f} s; {run['stats']['prefix_cache']} ; "
             f"{run['stats'].get('speculative', {}).get('accept_rate')} "
             f"accept rate; launches by rank "
             f"{_rank_launches(run, need[name])}")
        out[name] = run
        torch.cuda.empty_cache()
    got, ref = out["whole"]["streams"], [s[:TP_NEW]
                                         for s in runs[0]["streams"]]
    _log(f"phase 28 whole: greedy streams' leading tokens equal to degree "
         f"1's (phase 2, same prompts): {_agreement(got, ref)} of {TP_NEW}; "
         f"first differing token (request, position): "
         f"{_first_divergence(got, ref)}")
    # resident bytes per rank against degree 1 (the same engine settings)
    w1 = sum(p.numel() * p.element_size() for p in model.parameters())
    hd = cfg.hidden_size // cfg.num_heads
    blocks = BATCH * -(-MAX_CONTEXT // BS) + 1
    p1 = 2 * cfg.num_layers * cfg.num_heads * blocks * BS * hd * 2
    for r, rep in enumerate(out["whole"]["report"]):
        _log(f"phase 28 rank {r}: weights {rep['weight_bytes'] / 2**30:.3f} "
             f"GiB ({rep['weight_bytes'] / w1:.3f} of degree 1's "
             f"{w1 / 2**30:.3f}), pools {rep['pool_bytes'] / 2**30:.3f} GiB "
             f"({rep['pool_bytes'] / p1:.3f} of degree 1's "
             f"{p1 / 2**30:.3f}), {rep['pool_heads']} heads")
        if not 0.45 < rep["weight_bytes"] / w1 < 0.55 or \
                rep["pool_bytes"] * 2 != p1:
            raise AssertionError(f"phase 28 rank {r}: not half of degree "
                                 "1's bytes")
    tp_card_vs_cpu()
    return {name: dict(launches=run["report"][0]["counters"],
                       by_rank=run["report"], tokens_per_s=run["tokens_per_s"],
                       tick=run["tick"]) for name, run in out.items()}


def tp_card_vs_cpu():
    """Phase 28c: the 4-layer fp32 cut (``TP_CUT_LAYERS``) at
    ``tp_degree=2`` on the card (both ranks on card 0), 64-token chunks,
    against the CPU's plain model: two greedy streams equal."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    cpu, card = _cut_models(gpt3_1p3b(num_layers=TP_CUT_LAYERS))
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, cpu.cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in (96, 200)]
    # the first prompt in the timed mix (greedy), the second after it
    run = tp_serve(card, prompts[:1], 64, prompts[1:], new_tokens=16,
                   max_batch=2, max_context=512)
    got = run["streams"] + run["extra"]
    want = _cut_streams(cpu, "cpu", prompts, prefill_chunk=64)[0]
    if got != want:
        raise AssertionError(f"phase 28 cut: the card at tp_degree=2 gave "
                             f"{got}, the CPU {want}")
    _log(f"phase 28 card vs CPU, gpt3_1p3b {TP_CUT_LAYERS} layers fp32: "
         "both greedy streams at tp_degree=2 on the card (64-token "
         "chunks) equal the CPU's")


# -------------------------------------------------------------- phase 29

# 2 layers since phases 30-31 joined the run (the time limit; 4 before)
DDP_LAYERS, DDP_B, DDP_S, DDP_STEPS = 2, 2, 2048, 2


def _ddp_data(cfg, world):
    import numpy as np
    rng = np.random.RandomState(29)
    n = world * DDP_B * DDP_STEPS
    return (rng.randint(0, cfg.vocab_size, (n, DDP_S)),
            rng.randint(0, cfg.vocab_size, (n, DDP_S)))


def ddp_rank(env, out_dir):
    """Phase 29 on a rank of the phases' launch (``hybrid_rank``): GPT-3
    1.3B at full width, ``DDP_LAYERS`` layers, O1 bf16, AdamW (the fused
    step), ``DDP_STEPS`` steps under ``DataParallel`` on the batches
    ``DistributedBatchSampler`` gives this rank from the environment;
    returns its numbers and its parameters' digest (and rank 0 saves its
    parameters)."""
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    dev = env.device
    cuda = torch.device(dev).type == "cuda"
    cfg = gpt3_1p3b(num_layers=DDP_LAYERS)
    ids, labels = _ddp_data(cfg, env.world_size)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # every rank builds from its own seed: the broadcast makes rank 0's win
    model, opt, _ = _train_setup(cfg, dev, env.rank, 1, 8)
    dp = dist.DataParallel(model)
    sampler = DistributedBatchSampler(range(len(ids)), DDP_B)
    for fn in _train_counters().values():
        fn.launches = 0
    losses, times, comm = [], [], []
    for idx in sampler:
        batch = (torch.as_tensor(ids[idx], device=dev),
                 torch.as_tensor(labels[idx], device=dev))
        _sync(dev)
        t0 = time.perf_counter()
        c0 = dp.comm.seconds
        loss = _train_step(dp, opt, batch, True)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        comm.append(dp.comm.seconds - c0)
        mean = loss.float().clone()
        dist.all_reduce(mean, "avg")
        losses.append(mean.item())
    launches = {n: fn.launches for n, fn in _train_counters().items()}
    # the parameters' bits: a missing or partial all-reduce parts the ranks
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().reshape(-1).contiguous()
                      .view(torch.uint8).cpu().numpy().tobytes())
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters() if p.requires_grad)
    res = dict(rank=env.rank, world=env.world_size, losses=losses,
               step_s=times, allreduce_s=comm, launches=launches,
               buckets=dp.comm.calls, allreduce_bytes=dp.comm.bytes,
               grad_bytes=grad_bytes, params_sha256=digest.hexdigest(),
               peak_bytes=torch.cuda.max_memory_allocated(dev)
               if cuda else 0,
               batches=[list(b) for b in sampler],
               backend=dist.get_group().backend,
               modules=sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "paddle_tpu")))
    if env.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict()
                    .items()}, os.path.join(out_dir, "params.pt"))
    del model, opt, dp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def ddp_phase(out_dir, ranks, launch_s):
    """Phase 29's checks: the ranks' ``DataParallel`` results (the launch
    of phases 29-31, two ranks sharing card 0 over gloo) against one
    process on the concatenated batches."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt3_1p3b

    # one process on the concatenated batches, from rank 0's seed
    cfg = gpt3_1p3b(num_layers=DDP_LAYERS)
    ids, labels = _ddp_data(cfg, 2)
    dev = HYBRID["device"]
    model, opt, _ = _train_setup(cfg, dev, 0, 1, 8)
    ref = []
    for step in range(DDP_STEPS):
        idx = sum((rk["batches"][step] for rk in ranks), [])
        batch = (torch.as_tensor(ids[idx], device=dev),
                 torch.as_tensor(labels[idx], device=dev))
        ref.append(_train_step(model, opt, batch, True).item())
    got = torch.load(os.path.join(out_dir, "params.pt"))
    worst = 0.0
    for k, v in model.state_dict().items():
        worst = max(worst, (got[k] - v.detach().cpu()).abs().max().item())
    bound = 2 * LR * DDP_STEPS
    del model, opt, got
    if dev == "cuda":
        torch.cuda.empty_cache()
    for rk in ranks:
        if rk["modules"]:
            raise AssertionError(f"phase 29 rank {rk['rank']} imported "
                                 f"{rk['modules']}")
        if rk["backend"] != "gloo":
            raise AssertionError(f"phase 29: backend {rk['backend']}")
        bad = [n for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                           "fused_adamw") if rk["launches"][n] <= 0]
        if bad:
            raise AssertionError(f"phase 29 rank {rk['rank']} never "
                                 f"launched {bad}")
        for a, b in zip(rk["losses"], ref):
            if not abs(a - b) <= 2e-2:
                raise AssertionError(f"phase 29 losses {rk['losses']} "
                                     f"against one process {ref}")
        # every step all-reduces every gradient once, in buckets
        want = rk["grad_bytes"] * DDP_STEPS
        if rk["buckets"] < DDP_STEPS or rk["allreduce_bytes"] != want:
            raise AssertionError(
                f"phase 29 rank {rk['rank']}: {rk['buckets']} buckets, "
                f"{rk['allreduce_bytes']} bytes all-reduced; the gradients "
                f"of {DDP_STEPS} steps are {want}")
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        raise AssertionError("phase 29: the ranks' parameters differ after "
                             "the steps")
    if not worst <= bound:
        raise AssertionError(f"phase 29: parameters differ by {worst} "
                             f"(bound 2 lr steps = {bound})")
    r0 = ranks[0]
    step_s = r0["step_s"][-1]
    _log(f"phase 29 DataParallel gpt3_1p3b {DDP_LAYERS} layers, O1 bf16, "
         f"AdamW, 2 ranks on card 0 over {r0['backend']} (launcher "
         f"{launch_s:.1f} s), B {DDP_B} x S {DDP_S} a rank: losses "
         f"{[rk['losses'] for rk in ranks]} against one process on the "
         f"concatenated batches {ref}; the ranks' parameters bit-equal, "
         f"rank 0's within {worst:.3e} of one process's (bound "
         f"{bound:.0e}); step times (s) by rank "
         f"{[[round(t, 3) for t in rk['step_s']] for rk in ranks]}, "
         f"all-reduce share of the last step "
         f"{[round(r['allreduce_s'][-1] / r['step_s'][-1], 3) for r in ranks]}"
         f" ({r0['buckets']} buckets, {r0['allreduce_bytes'] / 2**30:.2f} "
         f"GiB all-reduced in {DDP_STEPS} steps); peak memory by rank "
         f"{[round(rk['peak_bytes'] / 2**30, 2) for rk in ranks]} GiB; "
         f"launches by rank {[rk['launches'] for rk in ranks]}")
    return dict(launches=r0["launches"], step_s=step_s, ranks=ranks,
                ref=ref, worst=worst)


# ---------------------------------------------------------- phases 30, 31

# phase 30: GPT-3 1.3B at mp 2 (4 of 24 layers), then Llama-2 7B at mp 2
# (2 of 32 layers); phase 31: GPT-3 1.3B (2 layers) at ZeRO degree 2.
# Full width; depths cut for the script's time limit.
HYBRID = dict(gpt_layers=4, llama_layers=2, zero_layers=2, B=2, S=2048,
              tp_steps=3, zero_steps=2, llama_B=1, device="cuda",
              devices="0,0", gpt="gpt3_1p3b", llama="llama2_7b")
ZERO_LEVELS = ("os", "os_g", "p_g_os")
HYBRID_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                  "fused_adamw")
HYBRID_SCALE = 1024.0                # the GradScaler's loss scale


def _hybrid_cfgs():
    from paddle_tpu_torch.models import gpt, llama
    g, ll = getattr(gpt, HYBRID["gpt"]), getattr(llama, HYBRID["llama"])
    return (g(num_layers=HYBRID["gpt_layers"], dropout=0.1),
            ll(num_layers=HYBRID["llama_layers"]),
            g(num_layers=HYBRID["zero_layers"]))


def _hybrid_batches(vocab, n, B, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, vocab, (B, HYBRID["S"])) for _ in range(2))
            for _ in range(n)]


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class _CommTimer:
    """The port's collectives of this process, wrapped: calls, payload
    bytes (the largest tensor argument) and seconds, the card
    synchronised before and after each call (so a collective's time is
    its own, not the kernels' it waits for)."""

    NAMES = ("all_reduce", "all_gather", "all_gather_concat",
             "reduce_scatter", "broadcast")

    def __init__(self, dev):
        from paddle_tpu_torch.distributed import collective
        self.dev, self.calls, self.bytes, self.seconds = dev, 0, 0, 0.0
        for name in self.NAMES:
            setattr(collective, name, self._wrap(getattr(collective, name)))

    def _wrap(self, fn):
        import torch

        from paddle_tpu_torch.distributed.collective import Group

        def call(*a, **k):
            groups = [g for g in (*a, *k.values()) if isinstance(g, Group)]
            if groups and groups[0].nranks == 1:    # moves nothing
                return fn(*a, **k)
            sizes = [t.numel() * t.element_size() for t in a
                     if isinstance(t, torch.Tensor)]
            _sync(self.dev)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                _sync(self.dev)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self.bytes += max(sizes, default=0)
        return call

    def take(self):
        out = (self.calls, self.bytes, self.seconds)
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        return out


def _hybrid_opt(params, scaled=True):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=LR, parameters=params, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return opt, (amp.GradScaler(init_loss_scaling=HYBRID_SCALE)
                 if scaled else None)


def _hybrid_step(model, opt, scaler, ids, labels, dev):
    """One O1 bf16 step (a GradScaler when given): the loss."""
    import torch
    from paddle_tpu_torch import amp
    ids = torch.as_tensor(ids, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    with amp.auto_cast(True, level="O1", dtype="bfloat16",
                       device=torch.device(dev)):
        loss = model.compute_loss(ids, labels)
    (scaler.scale(loss) if scaler is not None else loss).backward()
    if scaler is not None:
        scaler.step(opt)
    else:
        opt.step()
    opt.clear_grad()
    return loss.detach().float()


def _param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _global_bytes(model):
    return sum(4 * math.prod(getattr(p, "global_shape", None) or p.shape)
               for p in model.parameters())


def _worst(full, ref_path):
    """The largest difference of ``full`` (global tensors) from the one
    process's parameters saved at ``ref_path``."""
    import torch
    ref = torch.load(ref_path, mmap=True)
    return max((full[k].float() - v.float()).abs().max().item()
               for k, v in ref.items())


def _hybrid_reference(root):
    """Phases 30-31's one process, before the ranks start: the same
    models from the same seed on the same batches (the ranks' data
    concatenated), their losses and (saved) parameters."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    dev = HYBRID["device"]
    out_dir = os.path.join(root, "build", "hybrid_phase")
    gcfg, lcfg, zcfg = _hybrid_cfgs()
    ref = {}

    def run(name, model, batches, scaled, dropout_steps=()):
        opt, scaler = _hybrid_opt(model.parameters(), scaled)
        losses = []
        for i, (ids, labels) in enumerate(batches):
            model.train(i in dropout_steps)
            losses.append(_hybrid_step(model, opt, scaler, ids, labels,
                                       dev).item())
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()},
                   os.path.join(out_dir, f"ref_{name}.pt"))
        ref[name] = losses
        del model, opt
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    run("tp", GPTForCausalLM(gcfg, device=dev, seed=0),
        _hybrid_batches(gcfg.vocab_size, HYBRID["tp_steps"], HYBRID["B"],
                        30), True, dropout_steps=(HYBRID["tp_steps"] - 1,))
    run("llama", LlamaForCausalLM(lcfg, device=dev, seed=0),
        _hybrid_batches(lcfg.vocab_size, 1, HYBRID["llama_B"], 31), True)
    run("zero", GPTForCausalLM(zcfg, device=dev, seed=0),
        _hybrid_batches(zcfg.vocab_size, HYBRID["zero_steps"],
                        2 * HYBRID["B"], 32), False)
    return ref


def _counts_reset():
    from paddle_tpu_torch.observability import metrics
    for name in HYBRID_KERNELS:
        _train_counters()[name].launches = 0
    for fn in _plain_counters().values():
        fn.plain_calls = 0
    metrics.reset()


def _counts():
    from paddle_tpu_torch.observability import metrics
    snap = metrics.snapshot().get("optimizer.fused") or {"series": []}
    if any(_plain_calls().values()):
        raise AssertionError(f"a hybrid rank took plain routes: "
                             f"{_plain_calls()}")
    return ({n: _train_counters()[n].launches for n in HYBRID_KERNELS},
            {x["labels"]["kind"]: x["value"] for x in snap["series"]})


def _hybrid_train(model, opt, scaler, batches, dev, timer, rows,
                  dropout_steps=()):
    """Timed steps on this rank's ``rows`` of each batch: the losses
    (averaged over ``rows``' group by the caller), step seconds and each
    step's collectives."""
    losses, steps = [], []
    for i, (ids, labels) in enumerate(batches):
        model.train(i in dropout_steps)
        timer.take()
        _sync(dev)
        t0 = time.perf_counter()
        loss = _hybrid_step(model, opt, scaler, ids[rows], labels[rows],
                            dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        calls, nbytes, comm = timer.take()
        steps.append(dict(s=dt, comm_s=comm, calls=calls, bytes=nbytes))
        losses.append(loss)
    return losses, steps


def _tp_rank(dev, timer, out_dir, rank):
    """Phase 30 on this rank: the tensor-parallel GPT and Llama steps."""
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.convert import full_state_dict
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=1, mp_degree=2, pp_degree=1,
                            sharding_degree=1, sep_degree=1)
    hcg = fleet.init(is_collective=True, strategy=s)
    mp = hcg.get_model_parallel_group()
    gcfg, lcfg, _ = _hybrid_cfgs()
    out = {}
    for name, cls, cfg, n, B, seed, drop in (
            ("tp_train", GPTForCausalLM, gcfg, HYBRID["tp_steps"],
             HYBRID["B"], 30, (HYBRID["tp_steps"] - 1,)),
            ("tp_llama", LlamaForCausalLM, lcfg, 1, HYBRID["llama_B"], 31,
             ())):
        cfg.tensor_parallel = True
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = cls(cfg, device=dev, seed=0)
        opt, scaler = _hybrid_opt(list(model.named_parameters()))
        opt = fleet.distributed_optimizer(opt)
        batches = _hybrid_batches(cfg.vocab_size, n, B, seed)
        _counts_reset()
        losses, steps = _hybrid_train(model, opt, scaler, batches, dev,
                                      timer, slice(None), drop)
        launches, kinds = _counts()
        full = full_state_dict(model)
        ref = "ref_llama.pt" if name == "tp_llama" else "ref_tp.pt"
        worst = _worst(full, os.path.join(out_dir, ref)) \
            if rank == 0 else None
        for x in losses:               # every rank saw the whole loss
            y = x.clone()
            dist.all_reduce(y, "max", mp)
            if y.item() != x.item():
                raise AssertionError(f"{name}: the ranks' losses differ")
        out[name] = dict(
            losses=[x.item() for x in losses], steps=steps,
            launches=launches, kinds=kinds, worst=worst,
            param_bytes=_param_bytes(model),
            global_bytes=_global_bytes(model),
            heads=model.gpt.blocks[0].attn.num_heads
            if name == "tp_train" else
            model.model.layers[0].self_attn.num_heads,
            peak=torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
        del model, opt, full
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _zero_rank(dev, timer, out_dir, rank):
    """Phase 31 on this rank: GPT at each ZeRO level over 2 ranks."""
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.sharding import state_bytes
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.convert import full_state_dict
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=1, mp_degree=1, pp_degree=1,
                            sharding_degree=2, sep_degree=1)
    hcg = fleet.init(is_collective=True, strategy=s)
    g = hcg.get_sharding_parallel_group()
    _, _, cfg = _hybrid_cfgs()
    B = HYBRID["B"]
    batches = _hybrid_batches(cfg.vocab_size, HYBRID["zero_steps"], 2 * B,
                              32)
    rows = slice(g.rank * B, (g.rank + 1) * B)
    out = {}
    for level in ZERO_LEVELS:
        model = GPTForCausalLM(cfg, device=dev, seed=0)
        full_bytes = _param_bytes(model)
        opt, _ = _hybrid_opt(list(model.named_parameters()), scaled=False)
        model, opt, _ = group_sharded_parallel(model, opt, level)
        _counts_reset()
        grad_bytes = []
        orig_step = opt._inner.step

        def step_and_count():
            orig_step()
            held = {id(t): t.grad for t in list(model.parameters())
                    + opt._parameter_list if t.grad is not None}
            grad_bytes.append(sum(t.numel() * t.element_size()
                                  for t in held.values()))
        opt._inner.step = step_and_count
        losses, steps = _hybrid_train(model, opt, None, batches, dev, timer,
                                      rows)
        launches, kinds = _counts()
        for x in losses:
            dist.all_reduce(x, "avg", g)
        full = full_state_dict(model)
        worst = _worst(full, os.path.join(out_dir, "ref_zero.pt")) \
            if rank == 0 else None
        out[level] = dict(
            losses=[x.item() for x in losses], steps=steps,
            launches=launches, kinds=kinds, worst=worst,
            state_bytes=state_bytes(opt), grad_bytes=grad_bytes[-1],
            param_bytes=_param_bytes(model), full_bytes=full_bytes)
        del model, opt, full
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 32
# GPT-3 1.3B's widths in float32 (HybridConfig's type); depths cut for the
# script's time limit (PERF.md section 4): a. 4 of 24 layers at pp 2 x vpp 2
# (one a chunk), b. 2 at mp 2 with SP, c. 2 under ZeRO-3 at dp 2.
PIPE_WIDTH = dict(vocab_size=50304, hidden_size=2048, num_heads=16,
                  intermediate_size=8192, seq_len=2048)
PIPE_PARTS = {
    "a": dict(pp=2, vpp=2, dp=1, mp=1, num_layers=4, n_microbatches=4,
              sequence_parallel=False),
    "b": dict(pp=1, dp=1, mp=2, num_layers=2, n_microbatches=4,
              sequence_parallel=True),
    "c": dict(pp=1, dp=2, mp=1, num_layers=2, n_microbatches=2,
              sequence_parallel=False, zero_stage=3)}
PIPE_B = {"a": 1, "b": 1, "c": 2}    # rows of a micro-batch (c: 1 a rank)
PIPE_STEPS, PIPE_SEED = 2, 32


def _pipe_cfg(part):
    from paddle_tpu_torch.distributed.fleet.hybrid_step import HybridConfig
    return HybridConfig(**PIPE_WIDTH, **PIPE_PARTS[part])


def _pipe_params(cfg, dev):
    """The part's serial parameters, drawn on ``dev`` from the seed (the
    one process and every rank draw the same)."""
    import torch
    from paddle_tpu_torch.distributed.fleet.hybrid_step import init_gpt_params
    gen = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    return init_gpt_params(cfg, gen, device=dev)


def _pipe_ids(cfg, part, dev):
    import numpy as np
    import torch
    rng = np.random.RandomState(PIPE_SEED)
    return torch.as_tensor(rng.randint(
        0, cfg.vocab_size, (cfg.n_microbatches, PIPE_B[part], cfg.seq_len)),
        device=dev)


def _free(dev):
    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _pipeline_reference(out_dir):
    """Phase 32's one process, before the ranks start: each part's
    ``serial_train_step`` steps on the same parameters and batches; the
    losses, and the parameters saved (``flatten`` order)."""
    import torch
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    dev = HYBRID["device"]
    ref = {}
    for part in PIPE_PARTS:
        cfg = _pipe_cfg(part)
        params = _pipe_params(cfg, dev)
        ids = _pipe_ids(cfg, part, dev)
        zeros = T.tree_map(torch.zeros_like, params)
        state, losses = (params, zeros, T.tree_map(torch.zeros_like, params)), []
        for i in range(PIPE_STEPS):
            loss, *state = T.serial_train_step(*state, float(i + 1), ids,
                                               cfg)
            losses.append(loss.item())
        torch.save([t.cpu() for t in T.flatten(state[0])[0]],
                   os.path.join(out_dir, f"ref_pipe_{part}.pt"))
        ref[part] = losses
        del params, zeros, state
        _free(dev)
    return ref


class _P2PTimer:
    """The pipeline ring's hops on this rank (``spmd_pipeline._exchange``,
    one send and one receive of equal bytes), wrapped: hops, bytes a
    direction and seconds, the card synchronised before and after."""

    def __init__(self, dev):
        from paddle_tpu_torch.distributed.fleet import spmd_pipeline as sp
        self.dev, self.hops, self.bytes, self.seconds = dev, 0, 0, 0.0
        inner = sp._exchange

        def hop(x, group, shift):
            _sync(self.dev)
            t0 = time.perf_counter()
            try:
                return inner(x, group, shift)
            finally:
                _sync(self.dev)
                self.seconds += time.perf_counter() - t0
                self.hops += 1
                self.bytes += x.numel() * x.element_size()
        sp._exchange = hop

    def take(self):
        out = (self.hops, self.bytes, self.seconds)
        self.hops, self.bytes, self.seconds = 0, 0, 0.0
        return out


def _pipeline_rank(dev, timer, out_dir, rank):
    """Phase 32 on this rank: each part's hybrid (a, b) or ZeRO-3 (c) steps
    on this rank's shard, timed; the gathered parameters against the one
    process's (rank 0)."""
    import torch
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    p2p = _P2PTimer(dev)
    cuda = torch.device(dev).type == "cuda"
    out = {}
    for part in PIPE_PARTS:
        cfg = _pipe_cfg(part)
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(dp_degree=cfg.dp, mp_degree=cfg.mp,
                                pp_degree=cfg.pp, sharding_degree=1,
                                sep_degree=1)
        hcg = fleet.init(is_collective=True, strategy=s)
        params = _pipe_params(cfg, dev)
        if part == "c":
            state = T.init_zero3_state(params, cfg.dp,
                                       hcg.get_data_parallel_rank())
            step = T.make_zero3_train_step(hcg, cfg, grain=0)
        else:
            local = T.hybrid_local_params(T.stack_for_pipeline(params, cfg),
                                          cfg, hcg.get_stage_id(),
                                          hcg.get_model_parallel_rank())
            state = (local,) + T.init_zero_state(
                local, T.hybrid_param_specs(cfg), cfg.dp)[:2]
            step = T.make_hybrid_train_step(hcg, cfg)
        del params
        _free(dev)
        ids = _pipe_ids(cfg, part, dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _counts_reset()
        losses, steps = [], []
        for i in range(PIPE_STEPS):
            timer.take()
            p2p.take()
            _sync(dev)
            t0 = time.perf_counter()
            loss, *state = step(*state, float(i + 1), ids)
            losses.append(loss.item())
            dt = time.perf_counter() - t0
            calls, nbytes, comm = timer.take()
            hops, hbytes, hs = p2p.take()
            steps.append(dict(s=dt, comm_s=comm, calls=calls, bytes=nbytes,
                              p2p_hops=hops, p2p_bytes=hbytes, p2p_s=hs))
        launches, _ = _counts()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if part == "c":
            g = hcg.get_data_parallel_group()
            full = T.zero3_unflatten(T.tree_map(
                lambda t: coll.all_gather_concat(t, 0, g), state[0]), cfg)
        else:
            full = T.unstack_for_pipeline(
                T.gather_hybrid_params(state[0], cfg, hcg), cfg)
        # the gathered tree's bits: the leaves no axis splits are each
        # rank's own copy, so a missing or partial gradient sum over pp,
        # mp or dp parts the ranks (within the 2 lr-steps bound)
        digest = hashlib.sha256()
        for leaf in T.flatten(full)[0]:
            digest.update(leaf.detach().reshape(-1).contiguous()
                          .view(torch.uint8).cpu().numpy().tobytes())
        worst = None
        if rank == 0:
            ref = torch.load(os.path.join(out_dir, f"ref_pipe_{part}.pt"),
                             mmap=True)
            worst = max((a - b.to(a.device)).abs().max().item()
                        for a, b in zip(T.flatten(full)[0], ref))
            del ref
        out[part] = dict(
            losses=losses, steps=steps, launches=launches, worst=worst,
            params_sha256=digest.hexdigest(), peak=peak, ticks=cfg.n_microbatches * cfg.vpp + cfg.pp - 1,
            bubble=T.bubble_fraction(cfg.pp, cfg.vpp, cfg.n_microbatches),
            buckets=len(getattr(step, "buckets", ())))
        del state, full, step
        _free(dev)
    return out


def _check_pipeline(ranks, ref):
    """Phase 32's checks and lines."""
    bound = 2 * _pipe_cfg("a").learning_rate * PIPE_STEPS
    for rk in ranks:
        for part, res in rk["pipe"].items():
            label = f"phase 32{part} rank {rk['rank']}"
            bad = [n for n in HYBRID_KERNELS[:3] if res["launches"][n] <= 0]
            if bad:
                raise AssertionError(f"{label} never launched {bad}")
            fused = res["launches"]["fused_adamw"]
            if fused != (PIPE_STEPS if part == "c" else 0):
                raise AssertionError(f"{label}: fused_adamw launched "
                                     f"{fused} times")
            for a, b in zip(res["losses"], ref[part]):
                if not abs(a - b) <= 2e-5 + 2e-4 * abs(b):
                    raise AssertionError(f"{label} losses {res['losses']} "
                                         f"against one process {ref[part]}")
            if res["worst"] is not None and not res["worst"] <= bound:
                raise AssertionError(f"{label}: gathered parameters differ "
                                     f"by {res['worst']} (bound {bound})")
    for part in PIPE_PARTS:
        if len({rk["pipe"][part]["params_sha256"] for rk in ranks}) != 1:
            raise AssertionError(f"phase 32{part}: the ranks' gathered "
                                 "parameters differ after the steps")
    what = {"a": "make_hybrid_train_step at pp 2 x vpp 2, 4 layers, M 4 x "
                 "B 1",
            "b": "make_hybrid_train_step at mp 2 with sequence "
                 "parallelism, 2 layers, M 4 x B 1",
            "c": "make_zero3_train_step at dp 2 (grain 0), 2 layers, M 2 x "
                 "B 1 a rank"}
    for part in PIPE_PARTS:
        r0 = ranks[0]["pipe"][part]
        _log(f"phase 32{part} {what[part]}, GPT-3 1.3B widths float32, Adam "
             f"(lr {_pipe_cfg(part).learning_rate:g}), 2 ranks on card 0: "
             f"losses by rank {[rk['pipe'][part]['losses'] for rk in ranks]}"
             f" against one process {ref[part]}; the ranks' gathered "
             f"parameters bit-equal, within {r0['worst']:.3e} of one "
             f"process's (bound {bound:.0e}); step times (ms) by "
             f"rank {[[round(x['s'] * 1e3, 1) for x in rk['pipe'][part]['steps']] for rk in ranks]}; "
             f"last step by rank: ring sends = receives "
             f"{[rk['pipe'][part]['steps'][-1]['p2p_hops'] for rk in ranks]}"
             f" of {r0['steps'][-1]['p2p_bytes'] / max(r0['steps'][-1]['p2p_hops'], 1) / 2**20:.1f} MiB, "
             f"{[round(rk['pipe'][part]['steps'][-1]['p2p_s'] / rk['pipe'][part]['steps'][-1]['s'], 3) for rk in ranks]}"
             f" of the step; collectives "
             f"{[rk['pipe'][part]['steps'][-1]['calls'] for rk in ranks]} "
             f"calls, {[round(rk['pipe'][part]['steps'][-1]['bytes'] / 2**20, 1) for rk in ranks]} MiB, "
             f"{[round(rk['pipe'][part]['steps'][-1]['comm_s'] / rk['pipe'][part]['steps'][-1]['s'], 3) for rk in ranks]}"
             f" of the step; "
             + (f"{r0['buckets']} gather buckets" if part == "c" else
                f"{r0['ticks']} ticks, bubble_fraction {r0['bubble']:.4f}")
             + f"; peak by rank "
             f"{[round(rk['pipe'][part]['peak'] / 2**30, 2) for rk in ranks]}"
             f" GiB; launches by rank "
             f"{[rk['pipe'][part]['launches'] for rk in ranks]}")


def tp_kernel_checks():
    """Phase 30's kernel entries on the card against their plain
    versions: a flash launch over heads 8..15 of 16 with ``mask_heads``
    (the rank-1 shape of phase 30: B 2, S 2048, hd 128, bf16, dropout
    0.1) gives the whole launch's slices of out, lse, dq, dk and dv bit
    for bit, and its plain version within bf16's limit; ``fused_adamw``'s
    split norm (weights 1 and 1/2, the reduction doubling the sums as two
    like ranks would) against the plain version with the same weights
    and reduction, three scaled steps with the global clip: the step
    count and scale exact, coefficients within rtol 1e-6, parameters
    within 1e-6."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_optimizer as fo
    gen = torch.Generator(device="cuda").manual_seed(30)
    B, S, nh, hd, rate, seed = 2, 2048, NH, HD, 0.1, 12345
    q, k, v, do = (torch.randn((B, S, nh, hd), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, rate, seed)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, rate,
                                   seed)
    h = nh // 2
    part = [t[:, :, h:].contiguous() for t in (q, k, v, do)]
    o2, lse2 = fa.flash_attention_fwd(*part[:3], True, None, rate, seed,
                                      mask_heads=(h, nh))
    g2 = fa.flash_attention_bwd(*part[:3], o2, lse2, part[3], True, None,
                                rate, seed, mask_heads=(h, nh))
    if not (torch.equal(o2, out[:, :, h:]) and torch.equal(lse2, lse[:, h:])
            and all(torch.equal(a, b[:, :, h:]) for a, b in zip(g2, grads))):
        raise AssertionError("flash with mask_heads: not the whole "
                             "launch's slices")
    ref, ref_lse = fa.flash_attention_fwd_reference(
        *(t.float() for t in part[:3]), True, None, rate, seed,
        mask_heads=(h, nh))
    flash_err = (o2.float() - ref).abs().max().item()
    _compare("flash_fwd mask_heads", o2.float(), ref, torch.bfloat16)
    del q, k, v, do, out, lse, grads, part, o2, g2, ref
    shapes = [(2048, 2048), (4096,), (25152, 64)]
    weights = [1.0, 0.5, 1.0]

    def table():
        g = torch.Generator(device="cuda").manual_seed(31)
        ps = [torch.randn(s, generator=g, device="cuda") * 0.02
              for s in shapes]
        st = [[torch.zeros(s, device="cuda"), torch.zeros(s, device="cuda")]
              for s in shapes]
        return fo.FusedTable(ps, [None] * 3, st, [0.01] * 3, [1.0] * 3,
                             [True] * 3, weights)
    tk, tr = table(), table()
    steps = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    sc = [(torch.full((1,), 1024.0, device="cuda"),
           torch.zeros(4, dtype=torch.int32, device="cuda"),
           fo.ScalerConfig()) for _ in range(2)]
    reduce = lambda vec: vec.mul_(2.0)  # noqa: E731
    split_err = 0.0
    for i in range(3):
        gs = [torch.randn(s, generator=gen, device="cuda") * 1024 * 0.1
              for s in shapes]
        gr = [x.clone() for x in gs]
        fo.fused_adamw(tk, gs, LR, steps[0], clip=("global", 1.0),
                       scaler=sc[0], reduce=reduce)
        fo.fused_adamw_reference(tr, gr, LR, steps[1], clip=("global", 1.0),
                                 scaler=sc[1], coef=tk.coef, reduce=reduce)
        torch.cuda.synchronize()
        if not (torch.equal(steps[0], steps[1])
                and torch.equal(sc[0][0], sc[1][0])
                and torch.allclose(tk.coef, tr.coef, atol=0, rtol=1e-6)):
            raise AssertionError("fused_adamw split norm: step, scale or "
                                 "coefficients differ from the plain "
                                 "version")
        split_err = max(split_err, max(
            (a - b).abs().max().item() for a, b in zip(tk.params,
                                                       tr.params)))
    if not split_err <= 1e-6:
        raise AssertionError(f"fused_adamw split norm: parameters "
                             f"{split_err} from the plain version")
    _log(f"phase 30 kernel entries: flash mask_heads (B {B}, S {S}, heads "
         f"{h}..{nh - 1} of {nh}, bf16, dropout {rate}) equal the whole "
         f"launch's slices bit for bit, plain version within {flash_err:.3e};"
         f" fused_adamw split norm within {split_err:.3e} of its plain "
         f"version over 3 scaled, clipped steps")
    return dict(mask_heads_max_abs_err=flash_err,
                split_norm_max_abs_err=split_err)


def hybrid_rank(out_dir):
    """A rank of phases 29-32 (``chip_smoke.py --hybrid-rank DIR`` under
    the launcher): the DataParallel steps, the tensor-parallel steps,
    the ZeRO levels, then the hybrid steps; writes its numbers."""
    import torch
    from paddle_tpu_torch import distributed as dist
    env = dist.init_parallel_env()
    dev = HYBRID["device"] if env.device.type == "cpu" else env.device
    if torch.device(dev).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ddp = ddp_rank(env, out_dir)
    timer = _CommTimer(dev)
    res = dict(rank=env.rank, backend=dist.get_group().backend, ddp=ddp,
               tp=_tp_rank(dev, timer, out_dir, env.rank),
               zero=_zero_rank(dev, timer, out_dir, env.rank),
               pipe=_pipeline_rank(dev, timer, out_dir, env.rank),
               modules=sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "paddle_tpu")))
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _launch_ranks(root, out_dir, role, label, timeout=900):
    """Two ranks of this script (``role``) through the port's launcher,
    sharing ``HYBRID["devices"]``; their JSON results."""
    import signal
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--devices", HYBRID["devices"],
           "--log_dir", out_dir, "--job_id", "hybrid",
           os.path.abspath(__file__), role, out_dir]
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(cmd, cwd=root, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    if rc != 0:
        for r in range(2):
            path = os.path.join(out_dir, f"hybrid.rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    _log(f"--- {label} rank {r} log tail ---\n"
                         f"{f.read()[-3000:]}")
        raise AssertionError(f"{label}: the launch returned {rc}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _check_hybrid_path(label, res, ref_losses, bound, steps):
    bad = [n for n in HYBRID_KERNELS if res["launches"][n] <= 0]
    if bad:
        raise AssertionError(f"{label} never launched {bad}")
    if res["launches"]["fused_adamw"] != steps:
        raise AssertionError(f"{label}: fused_adamw launched "
                             f"{res['launches']['fused_adamw']} times in "
                             f"{steps} steps")
    if res["kinds"].get("fallback", 0):
        raise AssertionError(f"{label}: optimizer.fused {res['kinds']}")
    for a, b in zip(res["losses"], ref_losses):
        if not abs(a - b) <= 2e-2:
            raise AssertionError(f"{label} losses {res['losses']} against "
                                 f"one process {ref_losses}")
    if res["worst"] is not None and not res["worst"] <= bound:
        raise AssertionError(f"{label}: parameters differ by "
                             f"{res['worst']} (bound {bound})")


def hybrid_phase(root):
    """Phases 29-32: DataParallel, tensor-parallel training, ZeRO and the
    hybrid steps, two ranks sharing one card over gloo through one launch
    of the port's launcher, against one process on the same batches."""
    import shutil

    import torch
    out_dir = os.path.join(root, "build", "hybrid_phase")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    gc.collect()
    if HYBRID["device"] == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = _hybrid_reference(root)
    t_ref = time.perf_counter() - t0
    pipe_ref = _pipeline_reference(out_dir)
    t_pipe = time.perf_counter() - t0 - t_ref
    _log(f"phase 32 one process: {t_pipe:.1f} s")
    t0 += t_pipe
    ranks = _launch_ranks(root, out_dir, "--hybrid-rank", "phases 29-32")
    launch_s = time.perf_counter() - t0 - t_ref
    ddp = ddp_phase(out_dir, [rk["ddp"] for rk in ranks], launch_s)
    for rk in ranks:
        if rk["modules"]:
            raise AssertionError(f"phases 30-31 rank {rk['rank']} "
                                 f"imported {rk['modules']}")
        tp, zero = rk["tp"], rk["zero"]
        _check_hybrid_path(f"phase 30 rank {rk['rank']}", tp["tp_train"],
                           ref["tp"], 2 * LR * HYBRID["tp_steps"],
                           HYBRID["tp_steps"])
        _check_hybrid_path(f"phase 30 Llama rank {rk['rank']}",
                           tp["tp_llama"], ref["llama"], 2 * LR, 1)
        for name in ("tp_train", "tp_llama"):
            if not tp[name]["param_bytes"] < 0.6 * tp[name]["global_bytes"]:
                raise AssertionError(f"phase 30 {name}: a rank holds "
                                     f"{tp[name]['param_bytes']} of "
                                     f"{tp[name]['global_bytes']} bytes")
        for level, z in zero.items():
            _check_hybrid_path(f"phase 31 {level} rank {rk['rank']}", z,
                               ref["zero"], 2 * LR * HYBRID["zero_steps"],
                               HYBRID["zero_steps"])
            full = z["full_bytes"]
            want = dict(state=(0.45, 0.55),
                        grad=(0.45, 0.55) if level != "os" else (0.95, 1.6),
                        param=(0.45, 0.55) if level == "p_g_os"
                        else (0.99, 1.01))
            got = dict(state=z["state_bytes"] / (2 * full),
                       grad=z["grad_bytes"] / full,
                       param=z["param_bytes"] / full)
            for k, (lo, hi) in want.items():
                if not lo <= got[k] <= hi:
                    raise AssertionError(
                        f"phase 31 {level}: {k} bytes {got[k]:.3f} of "
                        f"one process's, want [{lo}, {hi}]")
            z["shares"] = got
    _check_pipeline(ranks, pipe_ref)
    r0 = ranks[0]

    def summary(res):
        last = res["steps"][-1]
        return (f"step {last['s'] * 1e3:.1f} ms, collectives "
                f"{last['comm_s'] / last['s']:.3f} of it "
                f"({last['calls']} calls, {last['bytes'] / 2**20:.1f} MiB)")
    tp = r0["tp"]["tp_train"]
    _log(f"phase 30 tensor parallelism, {HYBRID['gpt']} "
         f"{HYBRID['gpt_layers']} layers at mp 2, {tp['heads']} heads a rank, O1 bf16, AdamW "
         f"(fused, split norm) + ClipGradByGlobalNorm(1.0) + GradScaler, "
         f"B {HYBRID['B']} x S {HYBRID['S']}, dropout 0.1 in the last of "
         f"{HYBRID['tp_steps']} steps, 2 ranks on card 0 over "
         f"{r0['backend']} (one process {t_ref:.1f} s, launch "
         f"{launch_s:.1f} s): losses by rank "
         f"{[rk['tp']['tp_train']['losses'] for rk in ranks]} against one "
         f"process {ref['tp']}; gathered parameters within "
         f"{tp['worst']:.3e} (bound {2 * LR * HYBRID['tp_steps']:.0e}); "
         f"steps by rank {[[round(x['s'] * 1e3, 1) for x in rk['tp']['tp_train']['steps']] for rk in ranks]} ms; "
         f"{summary(tp)}; parameter bytes a rank "
         f"{tp['param_bytes']} of {tp['global_bytes']} "
         f"({tp['param_bytes'] / tp['global_bytes']:.3f}); launches by rank "
         f"{[rk['tp']['tp_train']['launches'] for rk in ranks]}; "
         f"optimizer.fused {tp['kinds']}; peak {tp['peak'] / 2**30:.2f} GiB")
    ll = r0["tp"]["tp_llama"]
    _log(f"phase 30 {HYBRID['llama']} {HYBRID['llama_layers']} layers at "
         f"mp 2, "
         f"{ll['heads']} heads a rank, one step B {HYBRID['llama_B']} x S "
         f"{HYBRID['S']}: loss {[rk['tp']['tp_llama']['losses'] for rk in ranks]} "
         f"against {ref['llama']}, parameters within {ll['worst']:.3e}; "
         f"{summary(ll)}; parameter bytes a rank {ll['param_bytes']} of "
         f"{ll['global_bytes']} ({ll['param_bytes'] / ll['global_bytes']:.3f});"
         f" launches {ll['launches']}; optimizer.fused {ll['kinds']}")
    for level, z in r0["zero"].items():
        _log(f"phase 31 ZeRO {level}, {HYBRID['gpt']} "
             f"{HYBRID['zero_layers']} layers, sharding 2 (B {HYBRID['B']} a rank), AdamW (fused, "
             f"split norm) + ClipGradByGlobalNorm(1.0), O1 bf16: losses "
             f"{[rk['zero'][level]['losses'] for rk in ranks]} against one "
             f"process on the concatenated batches {ref['zero']}; "
             f"parameters within {z['worst']:.3e}; steps "
             f"{[round(x['s'] * 1e3, 1) for x in z['steps']]} ms; "
             f"{summary(z)}; a rank's bytes over one process's: moments "
             f"and masters {z['shares']['state']:.3f}, gradients "
             f"{z['shares']['grad']:.3f}, parameters "
             f"{z['shares']['param']:.3f}; launches {z['launches']}; "
             f"optimizer.fused {z['kinds']}")
    return dict(ranks=ranks, ref=ref, ddp=ddp, pipe_ref=pipe_ref)


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


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
    card = card_name()
    t0 = time.perf_counter()
    _build.library()
    _log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    tc_regs, gemm_regs = ptxas_report(_build.BUILD_DIR)

    lens = [100 + 200 * i for i in range(BATCH)]       # 100 .. 1500

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        _log(f"[{name}: {time.perf_counter() - t:.1f} s; "
             f"{time.perf_counter() - t0:.1f} s since the build began]")
        return out
    rows = timed("kernel checks", kernel_checks, lens)
    rows["paged_decode"]["llama_shape"] = timed(
        "paged_decode at llama2_7b's shape", llama_decode_checks, lens)
    timed("flash training checks", flash_train_checks, rows)
    timed("flash at BERT-base's shape", bert_flash_checks, rows)
    timed("MoE kernel checks", moe_kernel_checks)
    runs = timed("serving", serving_phase, lens)
    tpk = timed("phase 30 kernel entries", tp_kernel_checks)
    rows["flash_fwd"]["mask_heads_max_abs_err"] = \
        tpk["mask_heads_max_abs_err"]
    hybrid = timed("DataParallel, tensor parallelism, ZeRO and the hybrid "
                   "steps (phases 29-32)", hybrid_phase, root)
    ddp = hybrid["ddp"]
    timed("card vs CPU", card_vs_cpu, gpt3_1p3b(num_layers=CUT_LAYERS))
    prefix, spec = timed("prefix and spec", serving_extras_phase)
    timed("plain routes", plain_route_phase)
    train = timed("training", training_phase)
    timed("training card vs CPU", train_card_vs_cpu,
          gpt3_1p3b(num_layers=CUT_LAYERS))
    rest, shapes = timed("rest of training", rest_of_training_phase)
    timed("rest of training card vs CPU", rest_card_vs_cpu,
          gpt3_1p3b(num_layers=CUT_LAYERS))
    fused_err = timed("fused_adamw checks", fused_kernel_checks, shapes)
    rows["fused_adamw"] = dict(
        split_norm_max_abs_err=tpk["split_norm_max_abs_err"],
        max_abs_err=fused_err, ms=rest["ms"], plain_ms=rest["plain_ms"],
        bound_ms=rest["bound_ms"], bound_by=rest["bound_by"],
        library_ms=rest["library_ms"],
        profiled_step_ms=rest["profiled_fused_ms"],
        step_ms_fused_foreach_library=[rest["step_s"] * 1e3,
                                       rest["foreach_step_ms"],
                                       rest["fused_step_ms"]])
    fp16 = timed("float16 training", fp16_training_phase, rest)
    gen = timed("generate", generate_phase)
    lists = timed("custom autocast lists", custom_lists_phase)
    hapi = timed("hapi.Model.fit", hapi_phase)
    serve16 = timed("float16 serving", fp16_serving_phase, lens,
                    dict(runs=runs, generate=gen))
    moe_serve, moe_train = timed("MoE", moe_phases, lens, rows)
    dense = timed("MoE dense path", moe_dense_phase, moe_train)
    llama, llama_train, quant, wo_row, wg_row, llama_gen, llama16 = timed(
        "Llama", llama_phases, lens)
    bert = timed("BERT", bert_phase)
    timed("quantized cuts card vs CPU, QAT", quant_cuts_phase)
    rows["weight_only_matmul"] = wo_row
    rows["weight_only_gemm"] = wg_row

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
                               "paddle_tpu/ops/pallas_moe.py:133"),
               "weight_only_matmul": (
                   "paddle_tpu_torch/csrc/weight_only.cu",
                   "paddle_tpu/quantization/weight_only.py:90 (dequantize,"
                   " fused by XLA into the consuming matmul)"),
               "weight_only_gemm": (
                   "paddle_tpu_torch/csrc/weight_only_gemm.cu",
                   "paddle_tpu/quantization/weight_only.py:90 (dequantize,"
                   " fused by XLA into the consuming matmul)"),
               "fused_adamw": (
                   "paddle_tpu_torch/csrc/fused_adamw.cu",
                   "paddle_tpu/optimizer/fused.py:192 (_build_program: the"
                   " whole-tree optimizer step as one XLA program; no "
                   "Pallas kernel)")}
    # each path's counts are its own run's, read from 0; `launches` is the
    # count of the first path that runs the kernel
    paths = {"whole_prompt": runs[0]["launches"],
             "chunked": runs[256]["launches"],
             "crash_only": runs["crash_only"]["launches"],
             "observability": runs["observability"]["launches"],
             "train": train["launches"],
             "rest_of_training": rest["launches"],
             "rest_o2": rest["o2"]["launches"],
             "moe_serve": moe_serve["launches"],
             "moe_train": moe_train["launches"],
             "prefix_whole": prefix["whole"]["launches"],
             "prefix_chunked": prefix["chunked"]["launches"],
             "spec_ngram": spec["ngram"]["launches"],
             "spec_ngram_adaptive": spec["ngram_adaptive"]["launches"],
             "spec_model": spec["model"]["launches"],
             "spec_self": spec["self"]["launches"],
             "llama_whole": llama["whole"]["launches"],
             "llama_chunked": llama["chunked"]["launches"],
             "llama_prefix": llama["prefix"]["launches"],
             "llama_train": llama_train["launches"],
             "bert_train": bert[False]["launches"],
             "bert_train_masked": bert[True]["launches"],
             "llama_int8": quant["int8"]["launches"],
             "llama_fp8": quant["fp8"]["launches"],
             "llama_int8_chunked":
                 quant["int8"]["extra"]["256-token chunks"]["launches"],
             "llama_int8_prefix": quant["int8"]["extra"][
                 "shared 1024-token prefix, prefix cache on"]["launches"],
             "train_fp16": fp16["launches"],
             "train_fp16_o2": fp16["o2"]["launches"],
             "generate_dense": gen["dense"]["launches"],
             "generate_static": gen["static"]["launches"],
             "generate_paged": gen["paged"]["launches"],
             "generate_paged_eager": gen["paged_eager"]["launches"],
             "llama_generate_static": llama_gen["static"]["launches"],
             "llama_generate_paged": llama_gen["paged"]["launches"],
             "train_custom_lists": lists["launches"],
             "moe_dense_train": dense["launches"],
             "hapi_fit": hapi["launches"],
             "hapi_fit_fp16": hapi["fp16_launches"],
             "serve_fp16_whole": serve16["whole"]["launches"],
             "serve_fp16_chunked": serve16["chunked"]["launches"],
             "serve_fp16_prefix": serve16["prefix"]["launches"],
             "serve_fp16_spec": serve16["spec"]["launches"],
             "moe_serve_fp16": serve16["moe"]["launches"],
             "generate_paged_fp16":
                 serve16["generate"]["paged"]["launches"],
             "generate_paged_eager_fp16":
                 serve16["generate"]["paged_eager"]["launches"],
             "llama_serve_fp16": llama16["launches"]}
    # phase 28's paths, each rank's counts (the wrappers' function names
    # mapped to the kernels'), and phase 29's ranks
    names = {fn.__name__: k for k, fn in _counters().items()}
    for name, run in runs["tp"].items():
        for r, rep in enumerate(run["by_rank"]):
            paths[f"tp_{name}_rank{r}"] = {
                names[f]: v for f, v in (
                    (k.rsplit(".", 1)[0], v)
                    for k, v in rep["counters"].items()
                    if k.endswith(".launches")) if f in names}
    for rk in ddp["ranks"]:
        paths[f"ddp_rank{rk['rank']}"] = rk["launches"]
    for rk in hybrid["ranks"]:
        r = rk["rank"]
        for name in ("tp_train", "tp_llama"):
            paths[f"{name}_rank{r}"] = rk["tp"][name]["launches"]
        for level, z in rk["zero"].items():
            paths[f"zero_{level}_rank{r}"] = z["launches"]
        for part, res in rk["pipe"].items():
            paths[f"pipe_{part}_rank{r}"] = res["launches"]
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        # the fused step's main path is phase 21a's (phase 4 runs it too)
        path = "rest_of_training" if name == "fused_adamw" else \
            next(p for p, n in by_path.items() if n > 0)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": by_path[path],
                        "launches_path": path, "launches_by_path": by_path,
                        **rows[name]})
        if name == "paged_chunk":
            # the verify's launches, counted apart (paged_verify_attention)
            kernels[-1]["verify_launches"] = {
                p: paths[p]["paged_verify_attention"]
                for p in ("spec_ngram", "spec_ngram_adaptive", "spec_model",
                          "spec_self", "serve_fp16_spec",
                          "tp_int8_chunked_prefix_spec_rank0",
                          "tp_int8_chunked_prefix_spec_rank1")}
        if name == "weight_only_gemm":
            kernels[-1]["ptxas_by_instance"] = gemm_regs
        tc_name = name + "_tc_kernel"
        if tc_name in tc_regs:
            kernels[-1]["bf16_kernel"] = tc_name
            kernels[-1]["fp16_kernel"] = tc_name
            kernels[-1]["ptxas_by_hd"] = tc_regs[tc_name]
    _log(card)
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hybrid-rank"]:
        sys.exit(hybrid_rank(sys.argv[2]))
    sys.exit(main())
