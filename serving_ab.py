#!/usr/bin/env python3
"""Serving throughput of two trees of the port, in turns on one card.

    python3 serving_ab.py [--runs N] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for a change against its
parent: unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and give ``parent . . parent``).  For each ROOT in
turn a fresh process imports that tree's ``paddle_tpu_torch``, builds its
kernels, and serves ``chip_smoke.py``'s request mix on card 0: GPT-3 1.3B
in bfloat16 with random weights from seed 0, 8 requests of 100 to 1500
prompt tokens and 64 new tokens each, the odd ones sampled (temperature
0.9, top-k 40, top-p 0.95), 8 slots, block 64, 8 steps per tick.  After
one warm-up run of each mode it serves the mix N times (default 3) with
whole-prompt prefill and N times with 256-token chunks, and prints for
each run the output tokens per second (wall clock from the first
``add_request`` to the last token) and, whole-prompt, the ms per decode
step ((wall - the largest time to first token) / decode steps: every
prefill runs before the decode ticks there).  The last lines give the
medians per ROOT, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LENS = [100 + 200 * i for i in range(8)]


def _one(root: str, runs: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops import _build

    _build.library()
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in LENS]

    def serve(chunk):
        eng = ServingEngine(model, max_batch=8, max_context=2048,
                            block_size=64, steps_per_tick=8,
                            prefill_chunk=chunk, device="cuda")
        reqs = [Request(p, max_new_tokens=64, do_sample=bool(i % 2),
                        temperature=0.9, top_k=40, top_p=0.95,
                        seed=1000 + i) for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.output_ids) for r in reqs)
        if tokens != 64 * len(reqs):
            raise AssertionError(f"{root}: {tokens} tokens of "
                                 f"{64 * len(reqs)}")
        run = dict(tokens_per_s=tokens / wall)
        if not chunk:
            ttft_max = max(r.t_first - r.t_enqueue for r in reqs)
            run["ms_per_decode_step"] = ((wall - ttft_max)
                                         / eng.stats()["steps"] * 1e3)
        return run

    out = {"root": root}
    for label, chunk in (("whole_prompt", 0), ("chunked", 256)):
        serve(chunk)                                   # warm-up
        out[label] = [serve(chunk) for _ in range(runs)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args.roots[0], args.runs)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: CUDA is not available", file=sys.stderr)
        return 2
    results = []
    for root in args.roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "--runs", str(args.runs), root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        results.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    for root in dict.fromkeys(args.roots):
        mine = [r for r in results if r["root"] == root]
        med = {}
        for label in ("whole_prompt", "chunked"):
            runs = [x for r in mine for x in r[label]]
            med[label] = {key: statistics.median(x[key] for x in runs)
                          for key in runs[0]}
        print(f"{root}: medians of {len(mine)} x {args.runs} runs: "
              + json.dumps(med), flush=True)
    print(subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
