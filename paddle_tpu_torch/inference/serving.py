"""Continuous-batching serving engine over paged KV pools.

Counterpart of ``paddle_tpu/inference/serving.py:ServingEngine``, the
part that serves one model on one card:

* a host block allocator with free lists and block refcounts (table
  references plus one per prefix-index entry); block 0 of every pool is
  the pad block;
* admission of the oldest waiting request when a slot and its worst-case
  blocks are free: a whole-prompt prefill padded to a bucket of the pad
  ladder, or, with ``prefill_chunk > 0``, chunks of at most that many
  tokens run one per scheduler boundary between decode ticks;
* the prefix cache (``prefix_cache=True``, the default, as the JAX
  flag's): a prompt's longest resident chain of full blocks is reused by
  reference (``inference/prefix_cache.py``) and only the suffix runs
  forward, through ``paged_chunk`` at the cached length; a shared block
  that must take the recomputed last prompt token is copied first
  (copy-on-write); under pool pressure index-only blocks are evicted,
  leaf first, in LRU order;
* the k-step decode tick: k forward steps over every slot with sampling on
  the card, one host round trip per tick;
* speculative decoding (``spec_decode=True``): each tick a draft model or
  the host's n-gram table proposes k tokens per slot and one k-row verify
  forward judges them (``inference/speculative.py``), with per-slot caps
  at the remaining budgets and, with ``spec_adaptive``, k moving along a
  ladder with the acceptance rate;
* eviction of finished requests, releasing their block references.

    engine = ServingEngine(model, max_batch=4, max_context=512)
    engine.add_request(Request([1, 2, 3], max_new_tokens=16))
    finished = engine.run()          # or engine.step() incrementally

The device programs are the JAX engine's: the tick of ``steps_per_tick``
or 1 steps, greedy or sampled; the spec tick per ladder rung; the prompt
programs per pad-ladder bucket (``prefill`` from an empty sequence through
``flash_fwd``, ``prefill_cont`` at an offset through ``paged_chunk``).
Each is a function of static buffers (``inference/graphs.py``): on the
card a CUDA graph captured once and replayed (``cuda_graphs=True``, the
default), on the CPU a direct call; with ``device_sampling=False`` the
JAX engine's host-sampling ``decode`` program takes the k = 1 ticks (the
logits come to the host, which samples the sampled rows).
:meth:`ServingEngine.warmup` captures the whole grid before traffic;
``run()`` calls it on the card.  With
``overlap`` (default on, the JAX flag ``serving_overlap``) ``run()`` keeps
one tick in flight: tick t+1 is replayed on the lengths and last tokens
tick t left on the card before t is harvested, and non-final prefill
chunks ride behind it (the JAX flag ``serving_chunk_overlap``'s
default).  Streams depend on neither.  ``quant="int8"`` or ``"fp8"``
serves a weight-only quantized twin of the model (``inference/quant.py``):
its linear layers run the ``weight_only_matmul`` kernel.

Serving is crash-only, as the JAX engine's: ``run()``, ``serve_forever()``
and ``drain()`` drive every boundary and tick under a guard.  A request
whose prompt program raises or whose prompt logits are not finite (with
the flight recorder's watchdog on) is struck and queued again, and
quarantined (``outcome="poisoned"``) at its second strike; a failed tick
evicts the slots it covered (``outcome="error"``); with
``device_sampling=False`` a non-finite decode row evicts its slot alone.
``dispatch_retries`` retries a failed dispatch in place, and
``tick_timeout_s`` bounds the wait for a tick's harvest
(:class:`TickTimeout`).  The guard never absorbs a CUDA error
(``torch.AcceleratorError``: the context is lost), a kernel wrapper's
(``ops/_build.py``'s ``KernelError``: a failed launch, which also reports
an earlier kernel's sticky fault, or arguments a kernel does not take) or
the block ledger's (``testing/blocksan.py``).  ``Request.cancel()`` and
``priority`` act at the next boundary; ``request_drain()`` (SIGTERM under
``serve_forever``) closes admission and drains, exporting the prefix
cache when ``prefix_export_dir`` is set, and an engine built with that
directory imports the newest valid export.

The scheduler spends up to ``prefill_chunks_per_tick`` chunks per
boundary (``chunks_per_tick_auto`` walks that budget from the live TPOT
against ``tpot_slo_ms``) and, with ``slo_shed``, rejects the newest
lowest-priority waiting requests while the TTFT or TPOT p99 is over its
target and more than ``shed_queue_depth`` wait.  Every request's life is
traced into the process's metrics registry (``observability/metrics.py``:
the ``serving.*`` counters, gauges, histograms and the TTFT / TPOT / e2e /
queue-wait sketches), the engine's flight recorder and the ``/requests``
ring, unless ``metrics.set_enabled(False)`` turns the gate off, which
leaves no per-request tracing work at all; ``http_port`` serves the
engine as ``POST /generate`` (``observability/http.py``).  Tensor
parallelism is a later slice (see ROADMAP.md).
"""

from __future__ import annotations

import json
import math
import os
import signal
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..core import threefry
from ..core.device import resolve_device
from ..distributed.checkpoint import manager as _ckpt
from ..distributed.checkpoint.io_retry import call_with_retries
from ..incubate.distributed.models.moe import MoELayer
from ..models.generation import _process_logits_rows, sample_rows
from ..models.kv_cache import PagedChunkKernelView, PagedKVCache
from ..observability import export as _export
from ..observability import flight_recorder as _flight
from ..observability import metrics as _metrics
from ..observability import quantiles as _quantiles
from ..ops import _build
from ..testing import blocksan as _blocksan
from ..testing import chaos as _chaos
from . import graphs, speculative, tp as _tp
from .drafting import NGramDraft
from .prefix_cache import PrefixCache
from .quant import plan_stats, quantize_model, quantize_plan

__all__ = ["Request", "ServingEngine", "TickTimeout", "NonFiniteLogits"]

# failures the crash-only guard never absorbs or retries: a CUDA error
# (sticky: the context is lost, every later launch fails), a kernel
# wrapper's (a failed launch or build, or arguments a kernel does not
# take: the program's fault, never a request's) and the block ledger's
# findings
_LOUD = (torch.AcceleratorError, _build.KernelError,
         _blocksan.BlocksanError, _tp.TPWorkerError)


_M_ADMISSIONS = _metrics.counter(
    "serving.admissions", "requests admitted into a decode slot")
_M_REJECTIONS = _metrics.counter(
    "serving.rejections",
    "requests rejected or stalled, by reason: over_context (prompt + "
    "budget exceed max_context), capacity (worst-case blocks exceed the "
    "whole pool: can never fit), pool_exhausted (admission deferred "
    "because the pool is currently drained; counted once per request), "
    "error (admission failed mid-flight), poisoned, slo_shed, draining")
_M_TICKS = _metrics.counter(
    "serving.ticks", "scheduler ticks that ran a decode program")
_M_TOKENS = _metrics.counter(
    "serving.tokens_out", "tokens emitted to requests")
_M_TICK_S = _metrics.histogram(
    "serving.tick_seconds", "wall time of one decode tick (k decode "
    "steps + host scheduling)")
_M_POOL = _metrics.gauge(
    "serving.pool_occupancy", "fraction of physical KV blocks in use")
_M_SLOTS = _metrics.gauge(
    "serving.slot_occupancy", "fraction of batch slots holding a request")
_M_TPS = _metrics.gauge(
    "serving.tokens_per_sec", "decode tokens/sec over the last tick")
_M_SAMPLED = _metrics.counter(
    "serving.sampled_tokens", "tokens drawn by the sampler (card or host) "
    "rather than argmax")
_M_OVERLAP = _metrics.counter(
    "serving.overlap_dispatches", "ticks dispatched before the previous "
    "tick was harvested (the double-buffered loop)")
_M_PREFIX_HITS = _metrics.counter(
    "serving.prefix_hits", "admissions whose prompt prefix was resident "
    "in the shared-block index (prefill skipped for those blocks)")
_M_PREFIX_MISSES = _metrics.counter(
    "serving.prefix_misses", "admissions that found no resident prefix "
    "(full prefill ran); counted only with the prefix cache on")
_M_PREFIX_SHARED = _metrics.counter(
    "serving.prefix_blocks_shared", "physical KV blocks reused from the "
    "prefix index instead of recomputed (incl. copy-on-write sources)")
_M_SPEC_PROPOSED = _metrics.counter(
    "serving.spec_proposed_tokens", "draft tokens proposed to the "
    "speculative verify (k per live slot per spec tick); the acceptance "
    "rate is spec_accepted_tokens / spec_proposed_tokens")
_M_SPEC_ACCEPTED = _metrics.counter(
    "serving.spec_accepted_tokens", "draft tokens accepted by the verify "
    "(greedy argmax match or rejection-sampling accept)")
_M_SPEC_INELIGIBLE = _metrics.counter(
    "serving.spec_ineligible_slots", "active slots dispatched into a spec "
    "tick with an emit cap below the tick's k (remaining budget under k): "
    "they ride the same program capped")
_M_SPEC_K = _metrics.gauge(
    "serving.spec_k_now", "speculative k of the most recent spec dispatch "
    "(steps through spec_k_ladder when spec_adaptive drives it)")
_M_SPEC_SLOT_ACC = _metrics.gauge(
    "serving.spec_slot_accept_rate", "per-slot lifetime draft acceptance "
    "rate of the slot's current request (labelled slot=i)")
_M_PREFILL_CHUNKS = _metrics.counter(
    "serving.prefill_chunks", "chunk prefill programs dispatched by the "
    "scheduler (prefill_chunk > 0: an arriving prompt is absorbed in "
    "bounded chunks between decode ticks)")
_M_SLO_SHEDS = _metrics.counter(
    "serving.slo_sheds", "waiting requests rejected by SLO-aware load "
    "shedding (slo_shed: live TTFT/TPOT p99 over target and the queue "
    "past shed_queue_depth); every shed also counts on "
    "serving.rejections{reason=slo_shed}")
_M_TICK_ERRORS = _metrics.counter(
    "serving.tick_errors", "tick-loop failures absorbed by the crash-only "
    "guard: a dispatch or harvest exception or a tick-watchdog timeout "
    "that evicted the slots it covered (outcome=error) or struck an "
    "admission-stage request")
_M_POISONED = _metrics.counter(
    "serving.poisoned_requests", "requests quarantined after two "
    "admission-stage strikes (program raised, or prompt logits "
    "non-finite under the NaN watchdog)")
_M_DISPATCH_RETRIES = _metrics.counter(
    "serving.dispatch_retries", "transient program dispatch failures "
    "retried in place (dispatch_retries, labelled site=)")
_M_PREFIX_IMPORT = _metrics.counter(
    "serving.prefix_import_blocks", "physical KV blocks restored from a "
    "drain-time prefix-cache export at engine construction")
_M_PREFIX_IMPORT_SKIP = _metrics.counter(
    "serving.prefix_import_skipped_corrupt", "prefix-cache export "
    "versions skipped at import, by reason=corrupt (manifest, sentinel or "
    "sha256 check failed) | mismatch (another engine's geometry, type or "
    "quant mode) | unreadable (payload failed to parse); a skipped "
    "version is never loaded")

# request lifecycle tracing: enqueue -> admit (queue wait) -> prefill ->
# first token -> decode ticks -> finish, into streaming quantile sketches
# (p50/p90/p99 at any moment from stats(), the snapshot or /metrics);
# gated with everything else (off: no timestamps are taken)
_M_TTFT = _metrics.quantile(
    "serving.ttft_seconds", "time to first token: request enqueue to the "
    "first output token on the host (queue wait + prefill)")
_M_TPOT = _metrics.quantile(
    "serving.tpot_seconds", "inter-token latency (TPOT): per decoded "
    "token, the harvest-to-harvest gap divided by the tokens it yielded")
_M_E2E = _metrics.quantile(
    "serving.e2e_seconds", "end-to-end request latency: enqueue to the "
    "token that finished the request")
_M_QWAIT = _metrics.quantile(
    "serving.queue_wait_seconds", "enqueue to admission start (deferred "
    "requests accumulate their pool-exhausted wait here)")
_M_SLO = _metrics.counter(
    "serving.slo_violations", "latency SLO breaches, by metric=ttft (per "
    "request, against ttft_slo_ms) or metric=tpot (per token, against "
    "tpot_slo_ms); targets of 0 turn the checks off")
_M_QUEUE_DEPTH = _metrics.gauge(
    "serving.queue_depth", "requests inside the engine (admission queue "
    "+ running slots)")
_M_RUNNING = _metrics.gauge(
    "serving.running", "batch slots currently holding a request")
_M_WAITING = _metrics.gauge(
    "serving.waiting", "requests queued for admission")
_M_OUTCOMES = _metrics.counter(
    "serving.request_outcomes", "terminal request outcomes, by outcome= "
    "finished | cancelled | error | drained | rejected:<reason>")


class TickTimeout(RuntimeError):
    """A tick's harvest did not arrive within ``tick_timeout_s``: a hung
    device program.  The guard absorbs it (the tick's slots end
    ``outcome="error"``)."""


class NonFiniteLogits(RuntimeError):
    """A request's prompt logits went NaN/Inf (the watchdog's probe): a
    poison strike."""


class Request:
    """One generation request; tokens accumulate in ``output_ids``.

    A sampled request's stream is a function of its ``seed`` and token
    positions alone: the same seed gives the same tokens whatever the tick
    size, batch or slot, and the JAX engine's tokens.  As there, the first
    token is drawn on the host from ``numpy.random.RandomState(seed)``
    (:meth:`_sample`), the decode tokens on the card from
    ``fold_in(key(seed), position)`` (``sample_rows``).  ``t_enqueue``
    and ``t_first`` are host ``perf_counter`` stamps at ``add_request``
    and at the first token, always taken (the engine's readiness
    evidence); the lifecycle trace's ``_t_enqueue`` / ``_t_admit`` /
    ``_t_first`` / ``_t_last`` are taken only while the metrics gate is
    on, and ``trace`` is the request's record once it ended.

    A higher ``priority`` is admitted first (FIFO within a priority).
    :meth:`cancel` drops the request at the engine's next boundary, from
    any thread.  ``outcome`` is None while the request lives, then
    ``"finished"``, ``"cancelled"``, ``"error"``, ``"poisoned"``,
    ``"slo_shed"`` (``shed`` is set) or ``"drained"``.  ``trace_id`` and
    ``parent_span`` (the ``X-Graft-Trace`` header of ``POST /generate``)
    tag every record of the request."""

    _counter = 0

    def __init__(self, prompt_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None, priority: int = 0,
                 trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None):
        Request._counter += 1
        self.rid = Request._counter
        self.prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) if seed is not None else self.rid
        self._rng = np.random.RandomState(self.seed)
        self.output_ids: List[int] = []
        self.done = False
        self.slot: Optional[int] = None
        self.t_enqueue: Optional[float] = None
        self.t_first: Optional[float] = None
        self.priority = int(priority)
        self.cancelled = False          # a bare bool store: thread-safe
        self.shed = False               # rejected by SLO load shedding
        self.outcome: Optional[str] = None
        self._strikes = 0               # admission-stage poison strikes
        # engine-owned admission state
        self._growth_left = 0
        self._prefilling = False
        self._prefill_chunks = 0
        self._chunk_row: Optional[np.ndarray] = None  # shadow table row
        self._chunk_off = 0                           # prompt tokens written
        self._chunk_t_admit: Optional[float] = None
        self._deferral_counted = False  # pool_exhausted, once a request
        # the token stream's listener (POST /generate): each emitted token
        # id, then None when the request ends
        self._stream_q = None
        # the lifecycle trace (perf_counter), stamped only while the
        # metrics gate is on: None means "not traced"
        self._t_enqueue: Optional[float] = None
        self._t_admit: Optional[float] = None
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._ticks = 0
        self._prefix_blocks = 0         # shared blocks reused at admission
        self.trace_id: Optional[str] = trace_id
        self.parent_span: Optional[str] = parent_span
        self.trace: Optional[dict] = None   # the final record
        # the prefix-cache lookup, cached within one index epoch
        self._prefix_match = None
        self._prefix_epoch = -1
        # speculative decoding: draft tokens proposed for this request and
        # accepted by the verify, and its n-gram table (spec_draft="ngram")
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._drafter: Optional[NGramDraft] = None

    def cancel(self) -> None:
        """Ask the engine to drop this request at its next boundary
        (waiting: dropped; mid-chunked-prefill: aborted; running: evicted,
        its blocks released)."""
        self.cancelled = True

    def _trace_ctx(self) -> dict:
        """``{trace_id, parent_span}`` when traced, else ``{}``: the splat
        that tags a record with this request's trace."""
        if self.trace_id is None:
            return {}
        ctx = {"trace_id": self.trace_id}
        if self.parent_span is not None:
            ctx["parent_span"] = self.parent_span
        return ctx

    def _stream_push(self, tok: Optional[int]) -> None:
        q = self._stream_q
        if q is not None:
            q.put(tok)

    def _sample(self, row) -> int:
        """The first token from the prompt's last logits row ``[V]``:
        greedy the argmax; sampled a draw of the host ``RandomState`` over
        the filtered distribution, as the JAX package's
        ``Request._sample`` (float32 probabilities, ``choice``)."""
        if not self.do_sample:
            return int(row.argmax())
        filtered = _process_logits_rows(
            row[None].float(),
            torch.tensor([self.temperature], device=row.device),
            torch.tensor([max(0, self.top_k)], device=row.device),
            torch.tensor([self.top_p], device=row.device))[0].cpu().numpy()
        p = np.exp(filtered - filtered.max())
        p = p / p.sum()
        return int(self._rng.choice(len(p), p=p))


def _tag(exc: BaseException, req: Request) -> None:
    """Name the request an admission-stage failure belongs to: the guard
    strikes it instead of failing the tick."""
    try:
        exc._serving_req = req
    except AttributeError:      # an exception type without a __dict__
        pass


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16, which numpy lacks, as its
    16-bit words."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_to_host` for a pool of ``dtype``."""
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 blocks stored as {a.dtype}")
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype:
        raise ValueError(f"{dtype} blocks stored as {t.dtype}")
    return t


def _bucket(n: int, minimum: int) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b




def _parse_spec_ladder(spec) -> tuple:
    """``spec_k_ladder``: a comma-separated string or a sequence of ints;
    sorted, deduplicated, every rung >= 2 (a rung of 1 emits one token a
    verify, the plain tick's job)."""
    if isinstance(spec, str):
        vals = [int(s) for s in (c.strip() for c in spec.split(",")) if s]
    else:
        vals = [int(v) for v in spec]
    if not vals or any(v < 2 for v in vals):
        raise ValueError(f"spec_k_ladder needs at least one rung, all "
                         f">= 2: {vals}")
    return tuple(sorted(set(vals)))


# ------------------------------------------------------------ programs
# The functions of the device programs take only the models, pools and
# block size they use, never the engine: the engine holds the programs,
# and a program holding the engine would make a reference cycle that keeps
# an engine (its pools and its CUDA graphs) alive until the cyclic
# collector runs.

def _prompt_fn(kind: str, model, pools, draft, dpools, bs: int):
    """The counterparts of ``_prefill_program`` and
    ``_prefill_cont_program``: the prompt forward (with a draft model,
    the draft's too, for its KV) and the last real token's row."""
    cont = kind == "prefill_cont"
    view_cls = PagedChunkKernelView if cont else PagedKVCache

    def prompt(i, o):
        table, ids = i["table"], i["ids"]
        if cont:
            lens, off = i["start"].view(1), i["start"]
        else:
            lens, off = torch.zeros((1,), dtype=torch.int32,
                                    device=ids.device), 0
        logits, _ = model.forward_with_cache(
            ids, [view_cls.from_parts(k, v, table, lens, bs)
                  for k, v in pools], pos_offset=off)
        if draft is not None:
            draft.forward_with_cache(
                ids, [view_cls.from_parts(k, v, table, lens, bs)
                      for k, v in dpools], pos_offset=off)
        o["row"].copy_(logits[0].index_select(0, i["idx"].view(1))[0])
    return prompt


def _tick_fn(model, pools, bs: int, k: int, sampled: bool):
    """The counterpart of ``_tick_program``: k decode steps over every
    slot with sampling on the card.  Free slots run with length 0 on
    all-zero table rows: they write and read the pad block and emit 0.
    A sampled program draws each step's token from ``fold_in(key(seed),
    position)``; a greedy one (no slot samples: the host's knowledge,
    baked in) skips the filters and the draw.  The final lengths and
    last tokens go back into the inputs, for a chained tick."""
    def tick(i, o):
        tables, lens, last = i["tables"], i["lens"], i["last"]
        samp = (i["do_s"], i["temp"], i["topk"], i["topp"])
        keys = None
        if sampled:
            pos = i["tok_pos"][None] + torch.arange(
                k, device=lens.device)[:, None]
            keys = torch.stack(threefry.fold_in(
                threefry.key(i["seeds"]), pos))          # [2, k, B]
        toks = []
        for j in range(k):
            views = [PagedKVCache.from_parts(kp, vp, tables, lens, bs)
                     for kp, vp in pools]
            logits, _ = model.forward_with_cache(
                last[:, None], views, pos_offset=lens[:, None])
            nxt = sample_rows(logits[:, -1], *samp,
                              None if keys is None else keys[:, j], sampled)
            active = lens > 0
            nxt = torch.where(active, nxt, torch.zeros_like(nxt))
            lens = torch.where(active, lens + 1, torch.zeros_like(lens))
            last = nxt
            toks.append(nxt)
        o["toks"].copy_(torch.stack(toks, dim=1))
        i["lens"].copy_(lens)
        i["last"].copy_(last)
    return tick


def _decode_fn(model, pools, bs: int):
    """The counterpart of ``_decode_program``, the host-sampling tick
    (``device_sampling=False``): one decode step over every slot, its
    greedy tokens ``[B, 1]`` and its logits ``[B, V]`` in float32 for
    the host to screen and sample.  Free slots as in :func:`_tick_fn`."""
    def decode(i, o):
        tables, lens, last = i["tables"], i["lens"], i["last"]
        views = [PagedKVCache.from_parts(kp, vp, tables, lens, bs)
                 for kp, vp in pools]
        logits, _ = model.forward_with_cache(last[:, None], views,
                                             pos_offset=lens[:, None])
        logits = logits[:, -1].float()
        active = lens > 0
        nxt = torch.where(active, logits.argmax(-1), torch.zeros_like(last))
        o["toks"].copy_(nxt[:, None])
        o["logits"].copy_(logits)
        i["lens"].copy_(torch.where(active, lens + 1, torch.zeros_like(lens)))
        i["last"].copy_(nxt)
    return decode


def _pools_for(model, num_blocks: int, bs: int, device) -> list:
    """One (K, V) pair of pools ``[heads, num_blocks + 1, bs, hd]`` per
    layer of ``model``, in its dtype: a tensor-parallel rank's model
    holds ``pool_heads`` of them (its share of the heads)."""
    cfg = model.cfg
    nh = getattr(model, "pool_heads", cfg.num_heads)
    hd = cfg.hidden_size // cfg.num_heads

    def pool():
        return torch.zeros((nh, num_blocks + 1, bs, hd), dtype=model.dtype,
                           device=device)
    return [(pool(), pool()) for _ in range(cfg.num_layers)]


def _program_parts(key, model, pools, draft, dpools, bs: int, B: int,
                   nb: int, device):
    """``(fn, inputs, outputs, inert)`` of the device program ``key``
    (see ``ServingEngine._build``): the engine's and, for a
    tensor-parallel engine, every worker rank's, each over its own model
    and pools."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    V = model.cfg.vocab_size
    kind = key[0]
    if kind in ("prefill", "prefill_cont"):
        ins = dict(table=z((1, nb), torch.int32),
                   ids=z((1, key[1]), torch.int64),
                   idx=z((), torch.int64))
        if kind == "prefill_cont":
            ins["start"] = z((), torch.int32)
        outs = dict(row=z((V,), model.dtype))
        return _prompt_fn(kind, model, pools, draft, dpools, bs), ins, \
            outs, None
    if kind == "cow":
        # inert: block 0 copied onto itself
        return _cow_fn(pools, dpools), dict(
            src=z((1,), torch.int64), dst=z((1,), torch.int64)), {}, None
    if kind == "decode":
        ins = dict(tables=z((B, nb), torch.int32),
                   lens=z((B,), torch.int32), last=z((B,), torch.int64))
        outs = dict(toks=z((B, 1), torch.int64),
                    logits=z((B, V), torch.float32))
        return _decode_fn(model, pools, bs), ins, outs, None
    _, k, sampled = key
    ins = dict(tables=z((B, nb), torch.int32),
               lens=z((B,), torch.int32), last=z((B,), torch.int64),
               do_s=z((B,), torch.bool), temp=z((B,), torch.float32),
               topk=z((B,), torch.int64), topp=z((B,), torch.float32),
               seeds=z((B,), torch.int64))
    if kind == "tick":
        ins["tok_pos"] = z((B,), torch.int64)
        outs = dict(toks=z((B, k), torch.int64))
        fn = _tick_fn(model, pools, bs, k, sampled)
    else:
        ins["kcap"] = z((B,), torch.int64)
        if draft is None:
            ins["dtoks"] = z((B, k), torch.int64)
        outs = dict(out=z((B, k + 2), torch.int64))
        fn = speculative.build_spec_tick(model, pools, draft, dpools, bs,
                                         k, sampled)
    return fn, ins, outs, dict(temp=1.0, topp=1.0)


def _cow_fn(pools, dpools):
    """The counterpart of ``_cow_program``: block ``src`` copied to
    ``dst`` in every layer's K and V pools, the draft's too.  ``src`` and
    ``dst`` are one-element index tensors on the card, so a captured copy
    reads them at replay and nothing touches the host."""
    def cow(i, o):
        src, dst = i["src"], i["dst"]
        for kk, vv in list(pools) + list(dpools or ()):
            kk.index_copy_(1, dst, kk.index_select(1, src))
            vv.index_copy_(1, dst, vv.index_select(1, src))
    return cow


class _RetryCounter:
    """Counts the engine's dispatch retries (``io_retry``'s counter)."""

    __slots__ = ("_engine",)

    def __init__(self, engine):
        self._engine = engine

    def inc(self, **labels):
        self._engine.dispatch_retries += 1
        _M_DISPATCH_RETRIES.inc(**labels)


class _Pending:
    """One tick in flight (the JAX engine's ``_PendingTick``): the slots it
    decodes, its k, the slot -> request map at dispatch, for a spec tick
    the per-slot caps, its program (a chained tick reads what it left on
    the card), the pending copy of its tokens to the host, when its
    dispatch began, the step count after it, whether it was chained, the
    chunks run at its boundary and its host phases (boundary schedule,
    chunk dispatch, its own dispatch; seconds, taken with the metrics
    gate on)."""

    __slots__ = ("active", "k", "reqs", "spec", "kcap", "prog", "fetch",
                 "t0", "step_no", "overlapped", "chunks", "ph_sched",
                 "ph_chunk", "ph_dispatch")

    def __init__(self, active, k, reqs, spec, kcap, prog, fetch, t0,
                 step_no):
        self.t0 = t0
        self.active = active
        self.k = k
        self.reqs = reqs
        self.spec = spec
        self.kcap = kcap
        self.prog = prog
        self.fetch = fetch
        self.step_no = step_no
        self.overlapped = False
        self.chunks = 0
        self.ph_sched = 0.0
        self.ph_chunk = 0.0
        self.ph_dispatch = 0.0


class ServingEngine:
    """Continuous batching over a model with ``forward_with_cache``.

    ``device`` is where the pools live and the model must live: ``cuda``
    by default (raises without CUDA unless ``device="cpu"``).  A model with
    MoE blocks must be in eval mode (``model.eval()``): its gates' capacity
    and random routing follow ``training``, and the engine refuses to
    serve it in training mode.

    ``prefix_cache`` (default on, as the JAX package's
    ``FLAGS_serving_prefix_cache``) shares resident prompt prefixes.
    ``spec_decode`` turns speculative decoding on: ``spec_draft="model"``
    proposes with ``draft_model`` (same vocabulary, ``max_seq_len`` at
    least ``max_context``, on the same device), ``"ngram"`` with the
    host's n-gram table; ``spec_k`` tokens a tick, or, with
    ``spec_adaptive``, a rung of ``spec_k_ladder`` chosen by the
    acceptance rate.

    ``quant`` (the JAX engine's ``quant`` argument, ``None`` by default)
    serves weight-only ``"int8"`` or ``"fp8"`` codes: the engine quantizes
    the model (and a draft model) at construction into a serving twin
    (``inference/quant.py:quantize_model``), so later edits of the live
    model do not reach it, and ``stats()["quant"]`` gives the snapshot's
    byte counts.

    ``overlap`` is the JAX flag ``serving_overlap`` (on by default):
    ``run()`` dispatches tick t+1 before it harvests tick t, and
    non-final prefill chunks ride behind such a tick (the JAX flag
    ``serving_chunk_overlap``'s default).  ``cuda_graphs``
    (default on) captures every device program into a CUDA graph on the
    card; only a caller that wants the eager programs on the card turns
    it off, and the engine never does so on its own: a failed capture
    raises.  The CPU runs the programs eagerly.

    The crash-only arguments are the JAX flags of the same names:
    ``dispatch_retries`` (transient dispatch failures retried in place,
    0 by default), ``tick_timeout_s`` (the tick watchdog, off at 0.0),
    ``device_sampling`` (on; off, the k = 1 ticks run the ``decode``
    program and sample on the host), ``blocksan`` (``enable_jaxsan``:
    the block ledger, off), ``drain_timeout_s`` (30 s) and
    ``prefix_export_dir`` (None: no export at drain, no import at
    construction).

    The scheduler's and the frontend's arguments are the JAX flags of the
    same names too: ``prefill_chunks_per_tick`` (1: chunks spent per
    boundary), ``chunks_per_tick_auto`` (off: walk that budget in [1,
    prefill_chunks_per_tick] from the live TPOT p90 against
    ``tpot_slo_ms``), ``ttft_slo_ms`` and ``tpot_slo_ms`` (0.0: no
    target), ``slo_shed`` (off) with ``shed_queue_depth`` (8),
    ``http_port`` and ``metrics_port`` (0: off; the serve and scrape
    endpoints on loopback, started by ``run()`` and ``serve_forever()``)
    and ``flight_recorder`` (None: the process's default recorder; give
    each engine of a process its own to keep their rings apart)."""

    # the adaptive-k controller: a rung up while the acceptance EWMA is at
    # least _ADAPT_UP, down at most _ADAPT_DOWN, after at least
    # _ADAPT_MIN_TICKS spec ticks on the rung
    _ADAPT_UP = 0.75
    _ADAPT_DOWN = 0.35
    _ADAPT_MIN_TICKS = 2
    _EWMA_BETA = 0.5

    def __init__(self, model, max_batch: int = 4,
                 max_context: Optional[int] = None, block_size: int = 64,
                 num_blocks: Optional[int] = None, steps_per_tick: int = 1,
                 pad_buckets=None, prefill_chunk: int = 0,
                 prefix_cache: bool = True, draft_model=None,
                 spec_decode: bool = False, spec_k: int = 4,
                 spec_draft: str = "model", spec_adaptive: bool = False,
                 spec_k_ladder="2,4,8", quant: Optional[str] = None,
                 overlap: bool = True, cuda_graphs: bool = True,
                 dispatch_retries: int = 0, tick_timeout_s: float = 0.0,
                 device_sampling: bool = True, blocksan: bool = False,
                 drain_timeout_s: float = 30.0,
                 prefix_export_dir: Optional[str] = None,
                 prefill_chunks_per_tick: int = 1,
                 chunks_per_tick_auto: bool = False,
                 ttft_slo_ms: float = 0.0, tpot_slo_ms: float = 0.0,
                 slo_shed: bool = False, shed_queue_depth: int = 8,
                 http_port: int = 0, metrics_port: int = 0,
                 flight_recorder: Optional[_flight.FlightRecorder] = None,
                 tp_degree: int = 1, tp_devices=None,
                 device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.tp = int(tp_degree)
        if self.tp < 1:
            raise ValueError(f"tp_degree must be >= 1: {self.tp}")
        self._tp_world = None
        self._tp_devices = None
        # weight-only quantization: a twin of the model over the codes,
        # built once; like the JAX engine's snapshot, later edits of the
        # live model do not reach it
        self.quant_mode = str(quant or "")
        self._quant_stats = None
        if self.tp > 1:
            self._tp_devices = _tp.resolve_tp_devices(
                self.device, self.tp, tp_devices)
            if prefix_export_dir:
                raise ValueError("the prefix cache's export and import "
                                 "are not ported at tp_degree > 1")
            # quantized before sharding: per-channel scales keep their
            # reduced axis, so each rank's (codes, scale) shard is an
            # exact slice of the full quantized matrix
            plan = _tp.build_plan(model, self.tp)
            if self.quant_mode:
                quantize_plan(plan, self.quant_mode)
                self._quant_stats = plan_stats(plan)
        elif self.quant_mode:
            model, snap = quantize_model(model, self.quant_mode)
            self._quant_stats = snap.stats()
        self.model = model
        cfg = model.cfg
        self.B = int(max_batch)
        self.bs = int(block_size)
        self.max_context = int(max_context or cfg.max_seq_len)
        self.nb_per_seq = math.ceil(self.max_context / self.bs)
        if num_blocks is None:
            num_blocks = self.B * self.nb_per_seq
        self.num_blocks = int(num_blocks)
        self._init_spec(draft_model, spec_decode, spec_k, spec_draft,
                        spec_adaptive, spec_k_ladder)
        if self.tp > 1:
            self._tp_start(plan, tick_timeout_s,
                           draft_model if self.spec_model else None)
            model = self.model
        self._moe = any(isinstance(mod, MoELayer) for m in self._models()
                        for mod in m.modules())
        self._check_mode()
        self.pools = self._pools(model)
        # the draft keeps its own pools, indexed by the same tables
        self.dpools = self._pools(self.draft) if self.spec_model else None
        # host-side scheduler state
        self.tables = np.zeros((self.B, self.nb_per_seq), np.int32)
        self.seq_lens = np.zeros((self.B,), np.int32)
        self.last_tok = np.zeros((self.B,), np.int64)
        # per-slot sampling parameters (free slots: greedy, no filters)
        self.samp_do = np.zeros((self.B,), bool)
        self.samp_temp = np.ones((self.B,), np.float32)
        self.samp_topk = np.zeros((self.B,), np.int64)
        self.samp_topp = np.ones((self.B,), np.float32)
        self.samp_seed = np.zeros((self.B,), np.int64)
        # tokens emitted per slot: the sampler's stream position
        self.tok_pos = np.zeros((self.B,), np.int64)
        self.free_blocks = deque(range(1, self.num_blocks + 1))
        # references per physical block: its table and one per prefix
        # index entry (1 everywhere with the cache off)
        self.block_rc = np.zeros((self.num_blocks + 1,), np.int64)
        # the block ledger, fed by every _alloc/_ref/_release_block
        self._blocksan = _blocksan.block_ledger(self.num_blocks, blocksan)
        self.prefix = PrefixCache(self.bs) if prefix_cache else None
        self.free_slots = deque(range(self.B))
        self.reserved = 0                      # growth blocks promised
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.waiting: deque = deque()
        self.prefilling: deque = deque()       # chunked admissions, oldest first
        self.finished: List[Request] = []
        self.steps = 0
        self.ticks = 0
        self.tokens_out = 0
        self.prefill_chunks_total = 0
        self.steps_per_tick = max(1, int(steps_per_tick))
        cap = self.nb_per_seq * self.bs
        if pad_buckets:
            vals = [int(b) for b in pad_buckets]
            if any(b <= 0 for b in vals):
                raise ValueError(f"pad_buckets must be positive: {vals}")
            self.pad_ladder = tuple(sorted({min(b, cap) for b in vals}))
        else:
            self.pad_ladder = self._default_ladder()
        self.chunk = int(prefill_chunk)
        if self.chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0: {self.chunk}")
        self.overlap = bool(overlap)
        self.overlapped_ticks = 0          # ticks dispatched on a chain
        self.overlap_chunks = 0            # chunks run behind such a tick
        # the scheduler's chunk budget and SLO shedding
        self.chunks_per_tick = max(1, int(prefill_chunks_per_tick))
        self.chunks_per_tick_auto = bool(chunks_per_tick_auto)
        self.ttft_slo_ms = float(ttft_slo_ms)
        self.tpot_slo_ms = float(tpot_slo_ms)
        self.slo_shed = bool(slo_shed)
        self.shed_queue_depth = int(shed_queue_depth)
        self.slo_sheds = 0
        self._chunk_budget_now: Optional[int] = None   # the controller's
        self._chunks_this_boundary = 0
        self._chunk_s_this_boundary = 0.0
        self.http_port = int(http_port)
        self.metrics_port = int(metrics_port)
        self._flight_rec = flight_recorder
        # the device programs by key: ("tick", k, sampled), ("spec_tick",
        # k, sampled), ("prefill", L_pad), ("prefill_cont", L_pad)
        # a tensor-parallel engine's programs run eagerly (a gloo
        # collective cannot be captured)
        self.cuda_graphs = bool(cuda_graphs) and \
            self.device.type == "cuda" and self.tp == 1
        self._programs: dict = {}
        self._pool = None                  # the graphs' shared memory pool
        self._warmup_info: Optional[dict] = None
        # crash-only serving
        self.retries = max(0, int(dispatch_retries))
        self.tick_timeout_s = float(tick_timeout_s)
        self.device_sampling = bool(device_sampling)
        self.drain_timeout_s = float(drain_timeout_s)
        self.tick_errors = 0
        self.poisoned_requests = 0
        self.dispatch_retries = 0          # retries taken
        # add_request may run on other threads than the loop: the lock
        # covers the waiting queue's rebuilds and the drain's closing
        self._lock = threading.Lock()
        self._ready = False
        self._t_serve_start: Optional[float] = None
        self._draining = False
        self._drain_requested = False      # a bare bool store: thread-safe
        self._drain_info: Optional[dict] = None
        # readiness evidence, always on (whatever the metrics gate): recent
        # admissions and TTFTs; the tick-level TPOT sketch over every
        # harvest (one harvest's gap imputed to the tokens it yielded: no
        # per-request timing); terminal outcomes, TTFT-SLO violations,
        # finished requests and their tokens
        self._admit_times: deque = deque(maxlen=64)
        self._ttft_recent: deque = deque(maxlen=64)
        self._ev_tpot = _quantiles.QuantileSketch()
        self._ev_outcomes: dict = {}
        self._ev_slo_viol = 0
        self._ev_finished = 0
        self._ev_finished_tokens = 0
        self._last_harvest_t: Optional[float] = None
        self._export_dir = str(prefix_export_dir or "")
        self._prefix_import_info: Optional[dict] = None
        if self.prefix is not None and self._export_dir:
            self._import_prefix_cache(self._export_dir)

    def _init_spec(self, draft_model, spec_decode, spec_k, spec_draft,
                   spec_adaptive, spec_k_ladder) -> None:
        """Speculative decoding's settings, checked as the JAX engine
        checks them."""
        self.spec = bool(spec_decode)
        self.spec_k = int(spec_k)
        self.spec_kind = str(spec_draft or "model")
        if self.spec_kind not in ("model", "ngram"):
            raise ValueError(f"spec_draft supports 'model' or 'ngram'; got "
                             f"{self.spec_kind!r}")
        self.spec_adaptive = bool(spec_adaptive)
        self.spec_model = self.spec and self.spec_kind == "model"
        self.draft = draft_model if self.spec_model else None
        self.spec_ticks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_ineligible_slots = 0
        self.spec_k_switches = 0
        self.spec_ladder: tuple = ()
        self.spec_k_now = 0
        self._accept_ewma: Optional[float] = None
        self._spec_ticks_since_adapt = 0
        if not self.spec:
            return
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1: {self.spec_k}")
        self.spec_ladder = (_parse_spec_ladder(spec_k_ladder)
                            if self.spec_adaptive else (self.spec_k,))
        # the lowest rung first: stepping up on observed acceptance risks
        # nothing, starting high wastes whole verify chunks
        self.spec_k_now = self.spec_ladder[0]
        if not self.spec_model:
            if draft_model is not None:
                raise ValueError("spec_draft='ngram' is model-free; drop "
                                 "draft_model= (or select "
                                 "spec_draft='model')")
            return
        if draft_model is None:
            raise ValueError("speculative decoding needs a draft model: "
                             "ServingEngine(model, draft_model=...), or "
                             "spec_draft='ngram'")
        dcfg = draft_model.cfg
        if dcfg.vocab_size != self.model.cfg.vocab_size:
            raise ValueError(f"draft vocab_size {dcfg.vocab_size} != target "
                             f"{self.model.cfg.vocab_size}")
        if dcfg.max_seq_len < self.max_context:
            raise ValueError(f"draft max_seq_len {dcfg.max_seq_len} < engine "
                             f"max_context {self.max_context}")
        if draft_model.device.type != self.device.type:
            raise ValueError(f"the draft model is on {draft_model.device}, "
                             f"the engine on {self.device}")
        if self.quant_mode:
            self.draft, _ = quantize_model(draft_model, self.quant_mode)

    def _tp_start(self, plan, tick_timeout_s, draft) -> None:
        """Start the worker ranks and hand them their shards, and the
        draft model (replicated) when one speculates; rank 0's own shards
        become ``self.model``.  The ranks run over gloo when two share a
        card or run on the CPU, over NCCL when each has its own card
        (``distributed.parallel.choose_backend``)."""
        from ..distributed.parallel import choose_backend
        backend = choose_backend(self._tp_devices)
        timeout = float(tick_timeout_s) if tick_timeout_s else 120.0
        world = _tp.TPWorld(self.tp, self._tp_devices, backend, timeout)
        self._tp_world = world
        weakref.finalize(self, world.close)
        try:
            rank0 = _tp.TPShardModel(plan.meta, _tp.shard_plan(plan, 0),
                                     world.group, 0, self.device)
            rank0.on_error = world.failed
            world.setup(
                dict(meta=plan.meta, B=self.B, nb=self.nb_per_seq,
                     bs=self.bs, num_blocks=self.num_blocks,
                     quant=self.quant_mode,
                     draft_cfg=None if draft is None else draft.cfg,
                     draft_dtype=None if draft is None else draft.dtype),
                {r: _tp.shard_plan(plan, r) for r in range(1, self.tp)},
                None if draft is None else {
                    k: v.detach() for k, v in draft.state_dict().items()})
        except BaseException:
            world.close()
            raise
        self.model = rank0

    def shutdown(self) -> None:
        """Stop a tensor-parallel engine's worker ranks (also done when
        the engine is collected); a no-op at degree 1."""
        if self._tp_world is not None:
            self._tp_world.close()

    def tp_report(self) -> list:
        """Every rank's kernel counters, resident weight and pool bytes,
        its pools' head count and collective counts (calls, bytes,
        seconds), rank 0 first; at degree 1 rank 0's alone."""
        m = self.model
        local = {"counters": _tp._counter_snapshot(),
                 "weight_bytes": sum(
                     t.numel() * t.element_size()
                     for t in list(m.parameters()) + list(m.buffers())),
                 "pool_bytes": sum(t.numel() * t.element_size()
                                   for kv in self.pools for t in kv),
                 "pool_heads": self.pools[0][0].shape[0],
                 "comm_calls": getattr(m, "comm_calls", 0),
                 "comm_bytes": getattr(m, "comm_bytes", 0),
                 "comm_s": getattr(m, "comm_s", 0.0)}
        if self._tp_world is None:
            return [local]
        return self._tp_world.report(local)

    def tp_reset_counters(self) -> None:
        """Zero every rank's kernel and collective counters."""
        graphs.restore([(fn, a, 0) for fn, a in graphs.counters()])
        m = self.model
        if self._tp_world is not None:
            m.comm_calls = m.comm_bytes = 0
            m.comm_s = 0.0
            self._tp_world.reset_counters()

    def _models(self):
        return [self.model] + ([self.draft] if self.draft is not None
                               else [])

    def _pools(self, model) -> list:
        return _pools_for(model, self.num_blocks, self.bs, self.device)

    # ----------------------------------------------------------- buckets
    def _default_ladder(self) -> tuple:
        """Powers of two from block_size up, clamped to the table."""
        cap = self.nb_per_seq * self.bs
        out, b = [], max(self.bs, 1)
        while b < cap:
            out.append(b)
            b *= 2
        out.append(cap)
        return tuple(out)

    def _pad_bucket(self, L: int) -> int:
        """Smallest ladder bucket that fits, clamped to the table."""
        for b in self.pad_ladder:
            if L <= b:
                return b
        return min(_bucket(L, self.bs), self.nb_per_seq * self.bs)

    def _blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.bs)

    # --------------------------------------------------- block refcounts
    def _alloc_block(self) -> int:
        blk = int(self.free_blocks.popleft())
        if self._blocksan is not None:
            self._blocksan.alloc(blk)
        self.block_rc[blk] = 1
        return blk

    def _ref_block(self, blk: int) -> None:
        if self._blocksan is not None:
            self._blocksan.ref(blk)
        self.block_rc[blk] += 1

    def _release_block(self, blk: int) -> bool:
        """Drop one reference; the block is freed (True) only when none
        is left: a shared block outlives each of its holders."""
        if self._blocksan is not None:
            self._blocksan.release(blk)
        self.block_rc[blk] -= 1
        if self.block_rc[blk] <= 0:
            self.block_rc[blk] = 0
            self.free_blocks.append(int(blk))
            return True
        return False

    # ------------------------------------------------ the crash-only guard
    _POISON_STRIKES = 2
    _DISPATCH_BACKOFF_S = 0.05
    _ABANDON_S = 1.0

    def _dispatch_call(self, site: str, call):
        """One program dispatch through the chaos site and, with
        ``dispatch_retries``, the retry policy: a ``RuntimeError`` or
        ``OSError`` retries in place with exponential backoff before it
        reaches the guard; a CUDA or kernel error never retries."""
        def attempt():
            _chaos.inject(site)
            return call()
        if self.retries <= 0:
            return attempt()
        return call_with_retries(
            attempt, retries=self.retries,
            backoff_s=self._DISPATCH_BACKOFF_S, site=site,
            retry_on=(RuntimeError, OSError), never=_LOUD,
            counter=_RetryCounter(self))

    def _screen_row(self, row, slot: int, req: Request):
        """A prompt's last logits row: chaos may make it NaN, and with the
        watchdog on a non-finite row raises :class:`NonFiniteLogits`
        before the prompt registers in the prefix index or emits a token.
        The probe is one host sync; with the watchdog off the row is
        returned untouched."""
        if _chaos.nan_payload("serving.prefill", slot=slot, rid=req.rid):
            row = torch.full_like(row, float("nan"))
        if _flight.enabled() and not _flight.check_finite(
                row.float().sum().item(), site="serving.prefill.logits"):
            raise NonFiniteLogits(
                f"prefill logits non-finite for rid={req.rid}")
        return row

    def _screen_decode_logits(self, pend: "_Pending", logits) -> dict:
        """The ``decode`` program's host logits ``[B, V]``: chaos may make
        a row NaN (in place), and with the watchdog on a non-finite row
        names its slot.  Returns ``{slot: error}``."""
        if not _flight.enabled() and not _chaos.active_faults():
            return {}
        bad = {}
        for slot in pend.active:
            req = pend.reqs[slot]
            if req is None or req.done:
                continue
            if _chaos.nan_payload("serving.decode", slot=slot, rid=req.rid):
                logits[slot] = np.nan
            if _flight.enabled() and not _flight.check_finite(
                    float(np.sum(logits[slot])),
                    site="serving.decode.logits"):
                bad[slot] = "non-finite decode logits"
        return bad

    def _materialize(self, fetch) -> dict:
        """Wait for a tick's outputs, under the tick watchdog: with
        ``tick_timeout_s`` > 0 the wait runs on a helper thread, and a
        harvest that does not arrive in time raises :class:`TickTimeout`
        instead of wedging the loop.  The host copies run on this thread
        after the wait."""
        if self.tick_timeout_s <= 0:
            _chaos.maybe_delay("serving.harvest")
            return fetch.wait()
        box = {}

        def work():
            try:
                _chaos.maybe_delay("serving.harvest")
                fetch.sync()
            except BaseException as e:  # noqa: BLE001 - raised below
                box["exc"] = e
        t = threading.Thread(target=work, name="serving-harvest",
                             daemon=True)
        t.start()
        t.join(self.tick_timeout_s)
        if t.is_alive():
            raise TickTimeout(
                f"tick harvest did not arrive within tick_timeout_s="
                f"{self.tick_timeout_s}s: device program hung")
        if "exc" in box:
            raise box["exc"]
        return fetch.copy()

    def _error_evict(self, slot: int, error: str) -> None:
        """A running (or mid-chunked-prefill) slot ends ``outcome="error"``,
        its blocks released."""
        req = self.slot_req[slot]
        if req is None:
            return
        self._flightrec().record_event(
            "slot_error", slot=slot, rid=req.rid, error=error[:200])
        if req._prefilling:
            self._abort_prefill(req, outcome="error")
            return
        self._terminal_trace(req, "error")
        self._evict(slot)
        req._stream_push(None)

    def _strike(self, req: Request, error: str) -> None:
        """An admission-stage strike: the request's prompt program raised
        or its logits were not finite.  The first strike queues it again
        at the back; the second (or any while cancelled or draining)
        quarantines it, ``outcome="poisoned"``."""
        req._strikes += 1
        if req._strikes >= self._POISON_STRIKES or req.cancelled \
                or self._draining:
            self.poisoned_requests += 1
            _M_POISONED.inc()
            _M_REJECTIONS.inc(reason="poisoned")
            req.outcome = "poisoned"
            if _metrics.enabled():
                self._reject_trace(req, "poisoned")
            self._flightrec().record_event(
                "poison_quarantine", rid=req.rid, strikes=req._strikes,
                error=error[:200])
            self.finished.append(req)
            req._stream_push(None)
        else:
            self.waiting.append(req)
        self._update_pressure()

    def _abandon(self, pend: "_Pending") -> None:
        """A tick that will never be harvested: wait briefly for its
        device work, so its blocks are not reused under a running
        program, and leave its fetch turn (``Program.abandon``) so the
        next fetch of that turn does not wait on a hung event."""
        pend.prog.abandon(pend.fetch, self._ABANDON_S)

    def _absorb_failure(self, exc: BaseException, pends) -> bool:
        """The guard's decision.  False (propagate) for a CUDA error or
        a block-ledger finding.  An admission-stage failure (tagged with
        ``_serving_req``) strikes its request alone.  Any other failure
        is the tick's: the ticks in flight are abandoned and the slots
        they covered end ``outcome="error"`` (all occupied slots when no
        tick was in flight)."""
        if isinstance(exc, _LOUD):
            return False
        self.tick_errors += 1
        _M_TICK_ERRORS.inc()
        err = f"{type(exc).__name__}: {exc}"[:200]
        req = getattr(exc, "_serving_req", None)
        self._flightrec().record_event(
            "tick_error", error=err,
            scope="request" if req is not None else "tick",
            rid=getattr(req, "rid", None))
        if req is not None:
            self._strike(req, err)
            return True
        slots = set()
        for p in pends:
            if p is not None:
                self._abandon(p)
                slots.update(p.active)
        if not slots:
            slots = {s for s in range(self.B)
                     if self.slot_req[s] is not None}
        for slot in sorted(slots):
            r = self.slot_req[slot]
            if r is None:
                continue
            if r.done:
                self._evict(slot)
            else:
                self._error_evict(slot, err)
        self._last_harvest_t = None
        self._update_occupancy()
        return True

    # --------------------------------------------------------- admission
    def add_request(self, req: Request) -> Request:
        """Queue a request; raises ``ValueError`` if it can never be
        served here or while the engine drains (admission is closed)."""
        L, n = len(req.prompt_ids), req.max_new_tokens
        traced = _metrics.enabled()
        with self._lock:
            if self._draining or self._drain_requested:
                self._reject(req, "draining", traced)
                raise ValueError("engine is draining: admission closed "
                                 "(retry against another replica)")
            if L == 0:
                raise ValueError("empty prompt")
            if L + n > self.max_context:
                self._reject(req, "over_context", traced)
                raise ValueError(f"request needs {L + n} tokens > "
                                 f"max_context {self.max_context}")
            worst = self._blocks_for(self._pad_bucket(L)) + max(
                0, self._blocks_for(L + n) - self._blocks_for(L))
            if worst > self.num_blocks:
                self._reject(req, "capacity", traced)
                raise ValueError(f"request needs {worst} blocks worst-case "
                                 f"but the pool has {self.num_blocks}")
            if traced:
                req._t_enqueue = time.perf_counter()
            req.t_enqueue = time.perf_counter()
            self.waiting.append(req)
        self._update_pressure()
        return req

    # ------------------------------------------------------ the instruments
    def _flightrec(self) -> _flight.FlightRecorder:
        """This engine's flight recorder: the one it was given, else the
        process's default."""
        rec = self._flight_rec
        return rec if rec is not None else _flight.default_recorder()

    def _ev_note(self, outcome: str) -> None:
        """The always-on tally of terminal outcomes, and its counter."""
        self._ev_outcomes[outcome] = self._ev_outcomes.get(outcome, 0) + 1
        _M_OUTCOMES.inc(outcome=outcome)

    def _reject(self, req: Request, reason: str, traced: bool) -> None:
        """A request refused at ``add_request``."""
        _M_REJECTIONS.inc(reason=reason)
        self._ev_note(f"rejected:{reason}")
        if traced:
            self._reject_trace(req, reason)

    def _record(self, req: Request, rec: dict) -> None:
        req.trace = rec
        self._flightrec().record_event("request", **rec)
        _export.record_request(rec)

    def _reject_trace(self, req: Request, reason: str) -> None:
        """A rejection is a lifecycle end too: ``/requests`` shows why
        traffic bounced."""
        req.outcome = reason
        self._record(req, {"rid": req.rid, "outcome": f"rejected:{reason}",
                           "prompt_len": len(req.prompt_ids),
                           "max_new_tokens": req.max_new_tokens,
                           **req._trace_ctx()})

    def _terminal_trace(self, req: Request, outcome: str) -> None:
        """Ends other than finishing (cancelled, error, drained): the
        outcome always (the SSE frame needs it), the record with the
        metrics gate on."""
        req.outcome = outcome
        self._ev_note(outcome)
        if not _metrics.enabled():
            return
        self._record(req, {"rid": req.rid, "outcome": outcome,
                           "prompt_len": len(req.prompt_ids),
                           "max_new_tokens": req.max_new_tokens,
                           "tokens_out": len(req.output_ids),
                           **req._trace_ctx()})

    def _finish_trace(self, req: Request) -> None:
        """The request's last token: e2e into its sketch, its record into
        the flight ring and the ``/requests`` ring."""
        t = time.perf_counter()
        e2e = t - req._t_enqueue
        _M_E2E.observe(e2e)
        n_out = len(req.output_ids)
        rec = {"rid": req.rid, "outcome": "finished",
               "prompt_len": len(req.prompt_ids), "tokens_out": n_out,
               "ticks": req._ticks,
               "queue_wait_s": round(req._t_admit - req._t_enqueue, 6),
               "prefill_s": round(req._t_first - req._t_admit, 6),
               "ttft_s": round(req._t_first - req._t_enqueue, 6),
               "tpot_mean_s": round((t - req._t_first)
                                    / max(n_out - 1, 1), 6),
               "e2e_s": round(e2e, 6),
               "prefix_blocks": req._prefix_blocks,
               "prefill_chunks": req._prefill_chunks,
               **req._trace_ctx()}
        if self.spec:
            rec["spec_accept_rate"] = round(
                req._spec_accepted / max(req._spec_proposed, 1), 4)
            rec["spec_draft"] = self.spec_kind
        self._record(req, rec)

    def _free_capacity(self) -> int:
        """Free blocks, with those the prefix index alone holds (reclaimed
        on demand): what an admission could get."""
        free = len(self.free_blocks)
        if self.prefix is not None:
            free += self.prefix.reclaimable(self.block_rc)
        return free

    def _update_occupancy(self) -> None:
        if not _metrics.enabled():
            return
        _M_POOL.set(round(1.0 - self._free_capacity()
                          / max(self.num_blocks, 1), 4))
        _M_SLOTS.set(round(1.0 - len(self.free_slots) / max(self.B, 1), 4))
        self._update_pressure()

    def _update_pressure(self) -> None:
        running = self.B - len(self.free_slots)
        _M_RUNNING.set(running)
        _M_WAITING.set(len(self.waiting))
        _M_QUEUE_DEPTH.set(running + len(self.waiting))

    def _lookup(self, req: Request):
        """The request's resident prefix chain, looked up once per index
        epoch (a deferred request retries every boundary; an eviction
        could free and reuse a matched block, and bumps the epoch)."""
        match = req._prefix_match
        if match is None or req._prefix_epoch != self.prefix.epoch:
            match = self.prefix.lookup(req.prompt_ids)
            req._prefix_match = match
            req._prefix_epoch = self.prefix.epoch
        return match

    def _try_admit(self) -> bool:
        """Admit the oldest waiting request if a slot and its worst-case
        blocks are free (reclaiming index-only blocks if need be): its
        resident prefix by reference, the rest of the prompt forward, or,
        chunked, queued for the boundaries' chunks."""
        if not self.waiting or not self.free_slots:
            return False
        self._promote_waiting()
        req = self.waiting[0]
        L = len(req.prompt_ids)
        chunked = self.chunk > 0
        # reuse is capped at L - 1: at least one prompt token runs forward
        # (its logits give the first token).  So copy-on-write is the
        # fully cached, block-aligned case: the last prompt token is
        # recomputed into a block the index still shares.
        chain: List[int] = []
        cached_len = 0
        if self.prefix is not None:
            chain = self._lookup(req).blocks
            cached_len = min(len(chain) * self.bs, L - 1)
            if cached_len <= 0:
                chain, cached_len = [], 0
        split_col = cached_len // self.bs
        cow_src = chain[split_col] if chain and cached_len % self.bs \
            else None
        if chain or chunked:
            # suffix and chunk writes past the prompt route to the pad
            # block: the real span is all they need
            need_now = self._blocks_for(L) - split_col
        else:
            L_pad = self._pad_bucket(L)
            need_now = self._blocks_for(L_pad)
        growth = max(0, self._blocks_for(L + req.max_new_tokens)
                     - self._blocks_for(L))
        # pin the reused blocks before any eviction can free them
        pinned = chain[:split_col] + ([cow_src] if cow_src is not None
                                      else [])
        for b in pinned:
            self._ref_block(b)
        short = need_now + growth - (len(self.free_blocks) - self.reserved)
        if short > 0 and self.prefix is not None:
            # index-only blocks are reclaimable: evict leaf entries (LRU),
            # skipping blocks a table still holds
            self.prefix.evict(short, self._release_block,
                              lambda b: int(self.block_rc[b]) == 1)
            short = need_now + growth \
                - (len(self.free_blocks) - self.reserved)
        if short > 0:
            for b in pinned:
                self._release_block(b)
            # admission deferred on a drained pool: counted once a request
            if not req._deferral_counted:
                req._deferral_counted = True
                _M_REJECTIONS.inc(reason="pool_exhausted")
            return False
        self.waiting.popleft()
        # admission starts now: everything before was queue wait
        t_admit = time.perf_counter() if _metrics.enabled() else None
        slot = self.free_slots.popleft()
        row = np.zeros((self.nb_per_seq,), np.int32)
        row[:split_col] = chain[:split_col]
        for col in range(split_col, split_col + need_now):
            row[col] = self._alloc_block()
        req._growth_left = growth
        self.reserved += growth
        shared = split_col + (cow_src is not None)
        cow_done = False
        try:
            if cow_src is not None:
                self._cow(cow_src, int(row[split_col]))
                self._release_block(cow_src)       # copied; pin over
                cow_done = True
            if chunked:
                # the table row stays on the request until the last chunk,
                # so ticks meanwhile see an all-zero row and write the pad
                # block
                req.slot = slot
                req._chunk_row = row
                req._chunk_off = cached_len
                req._chunk_t_admit = t_admit
                req._prefilling = True
                req._prefill_chunks = 0
                self.slot_req[slot] = req
                self.prefilling.append(req)
                self._count_prefix(req, bool(chain), shared)
                self._update_occupancy()
                return True
            self.tables[slot, :] = row
            if chain:
                first_row = self._forward_prompt(
                    "prefill_cont", row, req.prompt_ids[cached_len:],
                    cached_len)
            else:
                first_row = self._forward_prompt("prefill", row,
                                                 req.prompt_ids, 0)
            # screened before the prefix index registers anything: a
            # poisoned prompt never enters the index
            first_row = self._screen_row(first_row, slot, req)
        except BaseException as e:
            # undo every host-side draw: references (shared blocks survive
            # their other holders), the slot, the growth reservation; the
            # error names the request, which the guard strikes
            for b in row:
                if b:
                    self._release_block(int(b))
            if cow_src is not None and not cow_done:
                self._release_block(cow_src)
            self.tables[slot, :] = 0
            self.free_slots.appendleft(slot)
            self.reserved -= growth
            req._growth_left = 0
            _M_REJECTIONS.inc(reason="error")
            _tag(e, req)
            raise
        if not chain:
            # blocks of the pad bucket beyond the prompt go back to the pool
            for col in range(self._blocks_for(L), need_now):
                self._release_block(int(self.tables[slot, col]))
                self.tables[slot, col] = 0
        self._register(req, slot)
        self._count_prefix(req, bool(chain), shared)
        self._finish_admission(req, slot, first_row, t_admit)
        return True

    def _count_prefix(self, req: Request, hit: bool, shared: int) -> None:
        if self.prefix is None:
            return
        req._prefix_blocks = shared
        if hit:
            self.prefix.hits += 1
            _M_PREFIX_HITS.inc()
            self.prefix.blocks_shared += shared
            if shared:
                _M_PREFIX_SHARED.inc(shared)
        else:
            self.prefix.misses += 1
            _M_PREFIX_MISSES.inc()

    def _register(self, req: Request, slot: int) -> None:
        """The prompt's full blocks become shareable (one index reference
        each for the new entries).  They are never written again: decode
        starts at position L, in a column the index does not hold."""
        if self.prefix is None:
            return
        fullb = len(req.prompt_ids) // self.bs
        self.prefix.register(
            req.prompt_ids, [int(self.tables[slot, c]) for c in range(fullb)],
            self._ref_block, match=req._prefix_match)
        _blocksan.blocksan_snapshot(self)

    def _cow(self, src: int, dst: int) -> None:
        """Copy block ``src`` to ``dst`` in every layer's K and V pools,
        the draft's too, through the ``cow`` program (captured at warmup
        on the card): the suffix's write must land in a private block."""
        prog = self._program(("cow",))
        prog.load(src=src, dst=dst)
        prog.replay()

    def _forward_prompt(self, kind: str, row, tokens, start: int):
        """One prompt program over a single sequence: ``tokens`` at
        positions ``start..`` through the table ``row``, padded to their
        ladder bucket; ``kind`` "prefill" (from an empty sequence, so
        ``start`` is 0) or "prefill_cont" (at an offset: prefix hits and
        chunks).  Returns the last real token's logits row ``[V]``: the
        program's static output, valid until its next replay.  The
        dispatch is the chaos site ``serving.prefill.dispatch``."""
        n = len(tokens)
        ids = np.zeros((1, self._pad_bucket(n)), np.int64)
        ids[0, :n] = tokens
        prog = self._program((kind, ids.shape[1]))
        arrays = dict(table=row[None], ids=ids, idx=n - 1)
        if kind == "prefill_cont":
            arrays["start"] = start

        def dispatch():
            prog.load(**arrays)
            prog.replay()
        self._dispatch_call("serving.prefill.dispatch", dispatch)
        return prog.outputs["row"]

    def _prefill_chunk_step(self, req: Request) -> None:
        """One chunk of a chunked admission: prompt tokens [off, off + n)
        padded to their bucket; the last chunk's logits give the first
        token.  With the metrics gate on, its host dispatch time adds to
        the boundary's chunk phase and a ``prefill_chunk`` event goes to
        the flight ring."""
        L = len(req.prompt_ids)
        off = req._chunk_off
        n = min(self.chunk, L - off)
        slot = req.slot
        t_c0 = time.perf_counter() if _metrics.enabled() else None
        try:
            row = self._forward_prompt("prefill_cont", req._chunk_row,
                                       req.prompt_ids[off:off + n], off)
            if off + n >= L:
                # the last chunk is screened before the row installs and
                # the prompt registers
                row = self._screen_row(row, slot, req)
        except BaseException as e:
            self._abort_prefill(req)
            _M_REJECTIONS.inc(reason="error")
            _tag(e, req)
            raise
        if t_c0 is not None:
            self._chunk_s_this_boundary += time.perf_counter() - t_c0
        req._chunk_off = off + n
        req._prefill_chunks += 1
        self.prefill_chunks_total += 1
        self._chunks_this_boundary += 1
        _M_PREFILL_CHUNKS.inc()
        if _metrics.enabled():
            self._flightrec().record_event(
                "prefill_chunk", rid=req.rid, slot=slot, start=off,
                tokens=n, done=req._chunk_off >= L)
        if req._chunk_off >= L:
            # the last chunk: the shadow row installs, and only now may
            # the prompt's blocks be registered (each chunk writes blocks
            # the one before filled)
            self.tables[slot, :] = req._chunk_row
            req._chunk_row = None
            req._prefilling = False
            self._register(req, slot)
            self._finish_admission(req, slot, row, req._chunk_t_admit)

    def _finish_admission(self, req: Request, slot: int, row,
                          t_admit: Optional[float]) -> None:
        """First token from the prompt's last logits row (position 0 of
        the request's sampling stream); the slot joins the decode ticks.
        ``t_admit`` (the metrics gate on at admission) stamps the queue
        wait and TTFT into their sketches."""
        first = req._sample(row)
        _M_ADMISSIONS.inc()
        t_now = time.perf_counter()
        if t_admit is not None:
            # the sample above read the row on the host: the first token
            # exists now
            req._t_admit, req._t_first = t_admit, t_now
            req._t_last = t_now
            if req._t_enqueue is not None:
                ttft = t_now - req._t_enqueue
                _M_QWAIT.observe(t_admit - req._t_enqueue)
                _M_TTFT.observe(ttft)
                if self.ttft_slo_ms > 0 and ttft * 1e3 > self.ttft_slo_ms:
                    _M_SLO.inc(metric="ttft")
        req.t_first = t_now
        self._admit_times.append(t_now)
        ttft_ev = t_now - req.t_enqueue
        self._ttft_recent.append(ttft_ev)
        if self.ttft_slo_ms > 0 and ttft_ev * 1e3 > self.ttft_slo_ms:
            self._ev_slo_viol += 1
        req.output_ids.append(first)
        req._stream_push(first)
        req.slot = slot
        self.slot_req[slot] = req
        self.seq_lens[slot] = len(req.prompt_ids)
        self.last_tok[slot] = first
        self.samp_do[slot] = req.do_sample
        self.samp_temp[slot] = req.temperature
        self.samp_topk[slot] = max(0, req.top_k)
        self.samp_topp[slot] = req.top_p
        self.samp_seed[slot] = req.seed & 0xFFFFFFFF
        self.tok_pos[slot] = 1
        self.tokens_out += 1
        _M_TOKENS.inc()
        self._update_occupancy()
        self._maybe_finish(req, first)

    def _maybe_finish(self, req: Request, tok: int) -> None:
        if req.done:
            return
        if (req.eos_token_id is not None and tok == req.eos_token_id) or \
                len(req.output_ids) >= req.max_new_tokens:
            req.done = True
            req.outcome = "finished"
            self._ev_note("finished")
            self._ev_finished += 1
            self._ev_finished_tokens += len(req.output_ids)
            req._stream_push(None)      # the end of the token stream
            # trace only whole timelines (the gate may have flipped)
            if _metrics.enabled() and req._t_enqueue is not None \
                    and req._t_first is not None:
                self._finish_trace(req)

    def _evict(self, slot: int) -> None:
        req = self.slot_req[slot]
        # the growth this request never drew (early eos)
        self.reserved -= req._growth_left
        req._growth_left = 0
        for col in range(self.nb_per_seq):
            if self.tables[slot, col]:
                # blocks shared with the index or another slot survive
                self._release_block(int(self.tables[slot, col]))
                self.tables[slot, col] = 0
        self.seq_lens[slot] = 0
        self.last_tok[slot] = 0
        self.samp_do[slot] = False
        self.samp_temp[slot] = 1.0
        self.samp_topk[slot] = 0
        self.samp_topp[slot] = 1.0
        self.samp_seed[slot] = 0
        self.tok_pos[slot] = 0
        self.slot_req[slot] = None
        self.free_slots.append(slot)
        self.finished.append(req)
        self._update_occupancy()

    def _evict_done(self) -> None:
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is not None and not req._prefilling and req.done:
                self._evict(slot)

    def _abort_prefill(self, req: Request,
                       outcome: Optional[str] = None) -> None:
        """Tear down a chunked admission mid-prompt: every shadow-row
        reference, the slot and the growth reservation come back.  With
        ``outcome`` the request ends there (into ``finished``)."""
        for b in req._chunk_row:
            if b:
                self._release_block(int(b))
        req._chunk_row = None
        req._prefilling = False
        self.reserved -= req._growth_left
        req._growth_left = 0
        self.slot_req[req.slot] = None
        self.free_slots.appendleft(req.slot)
        req.slot = None
        if req in self.prefilling:
            self.prefilling.remove(req)
        if outcome is not None:
            self._terminal_trace(req, outcome)
            self.finished.append(req)
            req._stream_push(None)
        self._update_occupancy()

    def _promote_waiting(self) -> None:
        """Move the highest-priority waiting request (the oldest among
        equals) to the head of the queue."""
        if len(self.waiting) < 2:
            return
        best = 0
        for i in range(1, len(self.waiting)):
            if self.waiting[i].priority > self.waiting[best].priority:
                best = i
        if best:
            req = self.waiting[best]
            del self.waiting[best]
            self.waiting.appendleft(req)

    def _cancel_requested(self) -> None:
        """Cancellations take effect at a boundary: a running request is
        evicted, a chunked admission aborted, a waiting one dropped; each
        ends ``outcome="cancelled"``."""
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None or not req.cancelled:
                continue
            if req._prefilling:
                self._abort_prefill(req, outcome="cancelled")
            elif not req.done:
                self._terminal_trace(req, "cancelled")
                self._evict(slot)
                req._stream_push(None)
        with self._lock:
            if not any(r.cancelled for r in self.waiting):
                return
            kept = deque()
            for r in self.waiting:
                if r.cancelled:
                    self._terminal_trace(r, "cancelled")
                    self.finished.append(r)
                    r._stream_push(None)
                else:
                    kept.append(r)
            self.waiting = kept
        self._update_pressure()

    def _slo_breached(self) -> bool:
        """Is a live p99 sketch over its target?  Shedding reads observed
        violation, not a prediction; with the metrics gate off the
        sketches stay empty and nothing sheds."""
        if self.ttft_slo_ms > 0 and _M_TTFT.count() \
                and _M_TTFT.quantile(0.99) * 1e3 > self.ttft_slo_ms:
            return True
        if self.tpot_slo_ms > 0 and _M_TPOT.count() \
                and _M_TPOT.quantile(0.99) * 1e3 > self.tpot_slo_ms:
            return True
        return False

    def _shed_waiting(self) -> None:
        """SLO-aware load shedding (``slo_shed``): while a target is
        already breached and more than ``shed_queue_depth`` requests wait,
        reject the newest lowest-priority waiting ones (``outcome=
        "slo_shed"``) down to that depth."""
        if not self.waiting or not self.slo_shed:
            return
        if len(self.waiting) <= self.shed_queue_depth \
                or not self._slo_breached():
            return
        with self._lock:
            while len(self.waiting) > self.shed_queue_depth:
                # the victim: lowest priority, newest within it (the
                # oldest keep their queue-time investment)
                victim = len(self.waiting) - 1
                for i in range(len(self.waiting) - 2, -1, -1):
                    if self.waiting[i].priority \
                            < self.waiting[victim].priority:
                        victim = i
                req = self.waiting[victim]
                del self.waiting[victim]
                req.shed = True
                req.outcome = "slo_shed"
                self.slo_sheds += 1
                _M_SLO_SHEDS.inc()
                _M_REJECTIONS.inc(reason="slo_shed")
                if _metrics.enabled():
                    self._reject_trace(req, "slo_shed")
                self.finished.append(req)
                req._stream_push(None)
        self._update_pressure()

    def _active_slots(self) -> List[int]:
        # mid-chunked-prefill slots are occupied but not decodable yet
        return [s for s in range(self.B)
                if self.slot_req[s] is not None
                and not self.slot_req[s]._prefilling
                and not self.slot_req[s].done]

    def _boundary_schedule(self) -> None:
        """Cancellations first, then SLO shedding.  Whole-prompt: admit
        every waiting request that fits, then evict the finished (the JAX
        engine's order: a slot freed here takes a request at the next
        boundary).  Chunked: evict first (their slots and blocks fund the
        boundary), then up to the chunk budget of chunks, finishing the
        oldest chunked admission before starting the next; beginning an
        admission costs no budget, its first chunk does."""
        self._cancel_requested()
        self._shed_waiting()
        if self.chunk <= 0:
            while self._try_admit():
                pass
            self._evict_done()
            return
        self._evict_done()
        budget = self.chunks_per_tick
        if self.chunks_per_tick_auto:
            budget = self._auto_chunk_budget(budget)
        spent = 0
        while spent < budget:
            if self.prefilling:
                req = self.prefilling[0]
                self._prefill_chunk_step(req)
                if not req._prefilling and self.prefilling \
                        and self.prefilling[0] is req:
                    self.prefilling.popleft()
                spent += 1
                continue
            if not self._try_admit():
                break

    def _auto_chunk_budget(self, max_budget: int) -> int:
        """The chunk budget's controller (``chunks_per_tick_auto``): one
        step at a time inside [1, ``max_budget``] from the always-on TPOT
        sketch against ``tpot_slo_ms``: its p90 over the target spends
        one chunk fewer per boundary, under half the target one more.
        No target or fewer than 16 samples: the budget holds.  Only the
        budget moves; the programs and the warmup grid do not."""
        cur = self._chunk_budget_now
        if cur is None:
            cur = max_budget
        cur = min(cur, max_budget)
        if self.tpot_slo_ms > 0 and self._ev_tpot.count >= 16:
            p90 = self._ev_tpot.quantile(0.9)
            if p90 is not None:
                if p90 * 1e3 > self.tpot_slo_ms:
                    cur = max(1, cur - 1)
                elif p90 * 1e3 < 0.5 * self.tpot_slo_ms:
                    cur = min(max_budget, cur + 1)
        self._chunk_budget_now = cur
        return cur

    # ---------------------------------------------------------- programs
    def _program(self, key) -> graphs.Program:
        """The device program ``key``, built at first use and, on the
        card, captured into a CUDA graph in the engine's shared pool."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._build(key)
            if self.cuda_graphs:
                if self._pool is None:
                    # built before any capture: nvcc and the module load
                    # must not run inside one
                    _build.library()
                    self._pool = torch.cuda.graph_pool_handle()
                prog.capture(self._pool)
            self._programs[key] = prog
        return prog

    def _build(self, key) -> graphs.Program:
        """The static buffers and the function of one program.  Prompt
        programs: the table row ``[1, nb]``, the padded ids ``[1, L_pad]``,
        the last real token's index, and for ``prefill_cont`` the start;
        out the logits row ``[V]``.  Ticks: tables ``[B, nb]``, lengths,
        last tokens, the sampling arrays, the seeds and (plain) the stream
        positions or (spec) the per-slot caps and the host's proposals;
        out the tokens ``[B, k]`` (spec: with the counts and accepts).
        The ``decode`` program: tables, lengths and last tokens; out the
        greedy tokens ``[B, 1]`` and the logits ``[B, V]``.  The ``cow``
        program: the source and destination blocks, no output."""
        fn, ins, outs, inert = _program_parts(
            key, self.model, self.pools, self.draft, self.dpools, self.bs,
            self.B, self.nb_per_seq, self.device)
        if self._tp_world is not None:
            return _tp.TPProgram(self._tp_world, key, fn, ins, outs, inert)
        return graphs.Program(fn, ins, outs, inert)

    def warmup(self) -> dict:
        """Build (on the card: capture) the whole program grid before
        traffic, on inert inputs: all-zero tables and lengths send every
        write to the pad block 0.  The grid is the JAX engine's, with its
        host-sampling ``decode`` program only when the engine samples on
        the host (``device_sampling=False``): the tick per size in
        {steps_per_tick, 1}, the decode program, the spec tick per ladder
        rung, per pad-ladder bucket the ``prefill`` program (whole-prompt
        engines) and the ``prefill_cont`` one (prefix cache or chunks),
        and with the prefix cache the ``cow`` block copy.  A tick and
        a spec tick are two programs each, greedy and sampled.  The
        warm-up runs' launches are not counted.  Idempotent; returns, and
        ``stats()["warmup"]`` keeps, ``{warmup_s, programs, grid}``."""
        if self._warmup_info is not None:
            return self._warmup_info
        t0 = time.perf_counter()
        snap = graphs.snapshot()
        grid = []

        def warm(key):
            built = key in self._programs
            prog = self._program(key)
            if not built and prog.graph is None:
                prog.warm()
        for k in sorted({self.steps_per_tick, 1}, reverse=True):
            for sampled in (False, True):
                warm(("tick", k, sampled))
            grid.append({"program": "tick", "steps_per_tick": k})
        if not self.device_sampling:
            warm(("decode",))
            grid.append({"program": "decode", "steps_per_tick": 1})
        for sk in self.spec_ladder:
            for sampled in (False, True):
                warm(("spec_tick", sk, sampled))
            grid.append({"program": "spec_tick", "spec_k": sk,
                         "draft": self.spec_kind})
        if self.chunk <= 0:
            for L_pad in self.pad_ladder:
                warm(("prefill", L_pad))
                grid.append({"program": "prefill", "L_pad": L_pad})
        if self.prefix is not None or self.chunk > 0:
            for L_pad in self.pad_ladder:
                warm(("prefill_cont", L_pad))
                grid.append({"program": "prefill_cont", "L_pad": L_pad})
            if self.prefix is not None:
                warm(("cow",))
                grid.append({"program": "cow"})
        graphs.restore(snap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmup_info = {
            "warmup_s": round(time.perf_counter() - t0, 4),
            "programs": len(self._programs), "grid": grid}
        return self._warmup_info

    # ------------------------------------------------------------- ticks
    def _tick_size(self, active) -> int:
        """Steps this tick: ``steps_per_tick`` if every active request's
        remaining budget allows it, else 1 (the JAX engine's two tick
        programs; no request decodes past its reservation); 1 whenever
        the host samples a row (``device_sampling=False``)."""
        k = self.steps_per_tick
        for slot in active:
            req = self.slot_req[slot]
            if req.do_sample and not self.device_sampling:
                return 1             # the host samples: the decode program
            k = min(k, req.max_new_tokens - int(self.tok_pos[slot]))
        return k if k >= self.steps_per_tick else 1

    def _draw_blocks(self, slot: int, n: int) -> None:
        """A physical block for every position of the next ``n`` this slot
        writes, drawn from its admission's reservation."""
        start = int(self.seq_lens[slot])
        for pos in range(start, start + n):
            col = pos // self.bs
            if pos % self.bs == 0 and self.tables[slot, col] == 0:
                self.tables[slot, col] = self._alloc_block()
                self.reserved -= 1
                self.slot_req[slot]._growth_left -= 1

    def _samp_arrays(self) -> dict:
        return dict(tables=self.tables, do_s=self.samp_do,
                    temp=self.samp_temp, topk=self.samp_topk,
                    topp=self.samp_topp, seeds=self.samp_seed)

    def _dispatch(self, boundary: bool = True, chain=None):
        """The JAX engine's ``_dispatch_tick``: at a ``boundary`` the
        scheduler's work first, then one tick launched and returned in
        flight (None when no slot decodes).  ``chain`` is the tick in
        flight before it (overlap): its kind continues, and what it left
        on the card feeds this one."""
        timed = _metrics.enabled()
        ph_sched = ph_chunk = 0.0
        if boundary:
            self._check_mode()
            empty = not any(r is not None for r in self.slot_req)
            t_b0 = time.perf_counter() if timed else 0.0
            self._chunk_s_this_boundary = 0.0
            self._boundary_schedule()
            if timed:
                # the boundary's host phases: the chunks' dispatch time,
                # and the rest (cancel, shed, admit, evict)
                ph_chunk = self._chunk_s_this_boundary
                ph_sched = max(0.0, time.perf_counter() - t_b0 - ph_chunk)
        active = self._active_slots()
        if not active:
            if boundary and empty and self.waiting and \
                    not self.prefilling and \
                    all(r is None for r in self.slot_req):
                err = RuntimeError("the waiting request cannot be admitted "
                                   "into an empty engine")
                _tag(err, self.waiting.popleft())
                raise err
            return None
        t0 = time.perf_counter()
        pend = self._dispatch_tick(active, t0, chain)
        pend.chunks = self._chunks_this_boundary
        self._chunks_this_boundary = 0
        pend.ph_sched, pend.ph_chunk = ph_sched, ph_chunk
        if timed:
            pend.ph_dispatch = time.perf_counter() - t0
        return pend

    def _dispatch_tick(self, active, t0: float,
                       chain=None) -> "_Pending":
        """Launch a plain or speculative tick over ``active``; the host's
        lengths and stream positions advance now (a spec tick's by each
        slot's cap, refunded at harvest), so a chained dispatch sees the
        in-flight state."""
        spec = chain.spec if chain is not None \
            else self._spec_eligible(active)
        if spec:
            return self._dispatch_spec(active, t0, chain)
        k = self._tick_size(active)
        for slot in active:
            self._draw_blocks(slot, k)
        # host sampling: the k = 1 ticks run the decode program, whose
        # logits come to the host
        decode = not self.device_sampling and k == 1
        if decode:
            prog = self._program(("decode",))
            arrays = dict(tables=self.tables, lens=self.seq_lens)
            outs = ("toks", "logits")
        else:
            prog = self._program(("tick", k, bool(self.samp_do.any())))
            arrays = self._samp_arrays()
            arrays.update(lens=self.seq_lens, tok_pos=self.tok_pos)
            outs = ("toks",)
        if chain is None:
            arrays["last"] = self.last_tok

        def dispatch():
            prog.load(**arrays)
            if chain is not None:
                # the last tokens live on the card until the harvest
                prog.carry(chain.prog, "last")
            prog.replay()
        with _flight.guard("serving.tick"):
            self._dispatch_call("serving.tick.dispatch", dispatch)
        self.steps += k
        pend = _Pending(active, k, list(self.slot_req), False, None, prog,
                        prog.fetch(*outs), t0, self.steps)
        for slot in active:
            self.seq_lens[slot] += k
            self.tok_pos[slot] += k
        return pend

    def _dispatch_spec(self, active, t0: float,
                       chain=None) -> "_Pending":
        """One speculative tick in flight: per-slot caps ``kcap = min(k,
        remaining budget)`` with their blocks, the proposals, one verify.
        A chained tick (model drafts only) keeps its predecessor's k and
        reads the lengths and last tokens it left on the card."""
        k = chain.k if chain is not None else self._adapt_k()
        kcap = np.zeros((self.B,), np.int64)
        ineligible = 0
        for slot in active:
            req = self.slot_req[slot]
            cap = min(k, req.max_new_tokens - int(self.tok_pos[slot]))
            kcap[slot] = cap
            if cap < k:
                ineligible += 1
            self._draw_blocks(slot, cap)
        if ineligible:
            self.spec_ineligible_slots += ineligible
            _M_SPEC_INELIGIBLE.inc(ineligible)
        _M_SPEC_K.set(k)
        prog = self._program(("spec_tick", k, bool(self.samp_do.any())))
        arrays = self._samp_arrays()
        arrays["kcap"] = kcap
        if not self.spec_model:
            # the host's n-gram proposals: a few dict probes per slot
            dtoks = np.zeros((self.B, k), np.int64)
            for slot in active:
                req = self.slot_req[slot]
                if req._drafter is None:
                    req._drafter = NGramDraft()
                dtoks[slot] = req._drafter.propose_stream(
                    req.prompt_ids, req.output_ids, k)
            arrays["dtoks"] = dtoks
        if chain is None:
            arrays.update(lens=self.seq_lens, last=self.last_tok)

        def dispatch():
            prog.load(**arrays)
            if chain is not None:
                prog.carry(chain.prog, "lens", "last")
            prog.replay()
        with _flight.guard("serving.tick"):
            self._dispatch_call("serving.tick.dispatch", dispatch)
        self.steps += k + 1 if self.spec_model else 1
        pend = _Pending(active, k, list(self.slot_req), True, kcap, prog,
                        prog.fetch("out"), t0, self.steps)
        for slot in active:
            self.seq_lens[slot] += int(kcap[slot])
            self.tok_pos[slot] += int(kcap[slot])
        return pend

    def _harvest(self, pend: "_Pending") -> None:
        """The JAX engine's ``_harvest_tick``: wait for the tick's tokens
        (under the tick watchdog) and feed the requests and their token
        streams.  ``pend.reqs`` is the slot's request at dispatch: one
        that finished, or left its slot, while this tick was in flight has
        its rows discarded.  A ``decode`` tick's rows are screened (a
        non-finite row evicts its slot, ``outcome="error"``) and its
        sampled rows sampled here.  Then the tick's evidence: the
        always-on TPOT sketch, and with the metrics gate on the per-token
        TPOT, the tick counters and gauges and the tick's flight
        record."""
        timed = _metrics.enabled()
        t_h0 = time.perf_counter() if timed else 0.0
        with _flight.guard("serving.tick"):
            out = self._materialize(pend.fetch)
        t_wait_end = time.perf_counter() if timed else 0.0
        before = self.tokens_out
        bad = {}
        harvested_by = []      # (request, its tokens before this tick)
        sampled = accepted = 0
        if pend.spec:
            sampled, accepted = self._harvest_spec(pend, out["out"],
                                                   harvested_by)
        else:
            toks, logits = out["toks"], out.get("logits")
            if logits is not None:
                bad = self._screen_decode_logits(pend, logits)
            for slot in pend.active:
                req = pend.reqs[slot]
                if req.done or slot in bad or self.slot_req[slot] is not req:
                    continue
                harvested_by.append((req, len(req.output_ids)))
                req._ticks += 1
                if logits is not None and req.do_sample:
                    tok = req._sample(torch.from_numpy(logits[slot]))
                    self.last_tok[slot] = tok
                    sampled += self._emit(req, [tok])
                    continue
                self.last_tok[slot] = int(toks[slot, -1])
                sampled += self._emit(req, toks[slot])
        self.ticks += 1
        # the wall time this tick accounts for: from the last harvest (a
        # chained tick was dispatched before it), or from its dispatch
        t_done = time.perf_counter()
        t_from = pend.t0 if self._last_harvest_t is None \
            else max(pend.t0, self._last_harvest_t)
        self._last_harvest_t = t_done
        dt = t_done - t_from
        harvested = self.tokens_out - before
        if harvested > 0 and dt > 0:
            # always on: one harvest's gap imputed to the k tokens of each
            # slot, weighted by the tokens it yielded
            self._ev_tpot.add(dt / max(pend.k, 1), weight=harvested)
        if timed:
            self._trace_harvest(pend, harvested_by, t_done, dt, harvested,
                                sampled, accepted, t_wait_end - t_h0,
                                t_done - t_wait_end)
        for slot, err in bad.items():
            self._error_evict(slot, err)
        _blocksan.blocksan_verify(self)

    def _trace_harvest(self, pend, harvested_by, t_done, dt, harvested,
                       sampled, accepted, ph_wait, ph_emit) -> None:
        """The metrics-gated part of a harvest: each request's new tokens
        take an equal share of the gap since its last token (TPOT, and
        the TPOT SLO), the tick counters and gauges, and the tick's
        record with its phases in the flight ring."""
        for req, n_before in harvested_by:
            n_new = len(req.output_ids) - n_before
            if n_new <= 0 or req._t_last is None:
                continue
            gap = (t_done - req._t_last) / n_new
            req._t_last = t_done
            _M_TPOT.observe(gap, weight=n_new)
            if self.tpot_slo_ms > 0 and gap * 1e3 > self.tpot_slo_ms:
                _M_SLO.inc(n_new, metric="tpot")
        _M_TICKS.inc()
        _M_TICK_S.observe(dt)
        _M_TOKENS.inc(harvested)
        if sampled:
            _M_SAMPLED.inc(sampled)
        if dt > 0:
            _M_TPS.set(round(harvested / dt, 1))
        self._update_occupancy()
        rec = {"timeline": "serving", "step": pend.step_no,
               "t_unix": round(time.time(), 6),
               "wall_s": round(dt, 6), "decode_steps": pend.k,
               "tokens": harvested, "overlap": pend.overlapped,
               "tokens_per_sec": round(harvested / dt, 1) if dt else 0.0,
               "active": len(pend.active), "waiting": len(self.waiting),
               "free_blocks": self._free_capacity(),
               "phases": {
                   "schedule_ms": round(pend.ph_sched * 1e3, 4),
                   "chunk_prefill_ms": round(pend.ph_chunk * 1e3, 4),
                   "dispatch_ms": round(pend.ph_dispatch * 1e3, 4),
                   "harvest_wait_ms": round(ph_wait * 1e3, 4),
                   "emit_ms": round(ph_emit * 1e3, 4),
                   "host_ms": round((pend.ph_sched + pend.ph_chunk
                                     + pend.ph_dispatch + ph_emit) * 1e3,
                                    4),
                   "device_wait_ms": round(ph_wait * 1e3, 4)}}
        if pend.spec:
            rec["spec"] = True
            rec["spec_kind"] = self.spec_kind
            rec["spec_k"] = pend.k
            rec["spec_accepted"] = accepted
        if pend.chunks:
            rec["prefill_chunks"] = pend.chunks
        tids = sorted({r.trace_id for r, _ in harvested_by if r.trace_id})
        if tids:
            rec["trace_ids"] = tids
        self._flightrec().record_step(rec)

    def _harvest_spec(self, pend: "_Pending", out, harvested_by) -> tuple:
        """A spec tick's rows; returns the tokens sampled and the drafts
        accepted."""
        k = pend.k
        toks, counts, accepts = out[:, :k], out[:, k], out[:, k + 1]
        proposed = accepted = sampled = 0
        for slot in pend.active:
            req = pend.reqs[slot]
            c, a = int(counts[slot]), int(accepts[slot])
            # the dispatch advanced by the cap; the emitted count is true
            refund = int(pend.kcap[slot]) - c
            self.seq_lens[slot] -= refund
            self.tok_pos[slot] -= refund
            if req.done:
                continue
            harvested_by.append((req, len(req.output_ids)))
            req._ticks += 1
            # acceptance counts all k proposals (the drafter's quality,
            # which the controller reads), whatever the slot's cap
            proposed += k
            accepted += a
            req._spec_proposed += k
            req._spec_accepted += a
            if _metrics.enabled():
                _M_SPEC_SLOT_ACC.set(
                    round(req._spec_accepted / max(req._spec_proposed, 1),
                          4), slot=slot)
            self.last_tok[slot] = int(toks[slot, c - 1])
            sampled += self._emit(req, toks[slot, :c])
        self.spec_ticks += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        if proposed:
            _M_SPEC_PROPOSED.inc(proposed)
            rate = accepted / proposed
            self._accept_ewma = rate if self._accept_ewma is None else (
                self._EWMA_BETA * self._accept_ewma
                + (1.0 - self._EWMA_BETA) * rate)
            self._spec_ticks_since_adapt += 1
        if accepted:
            _M_SPEC_ACCEPTED.inc(accepted)
        return sampled, accepted

    def _emit(self, req: Request, toks) -> int:
        """Append a tick's tokens to the request and its stream; returns
        how many were sampled."""
        n = 0
        for tok in toks:
            if req.done:
                break        # tokens past eos are discarded
            req.output_ids.append(int(tok))
            req._stream_push(int(tok))
            self.tokens_out += 1
            n += req.do_sample
            self._maybe_finish(req, int(tok))
        return n

    # ------------------------------------------------------ speculation
    def _spec_eligible(self, active) -> bool:
        """A spec tick needs one active slot able to take more than one
        token (at rung 1, one token); a short-budget slot rides it capped
        at its own budget."""
        if not self.spec or not self.device_sampling:
            return False             # the verify samples on the card
        need = min(2, self.spec_k_now)
        return any(self.slot_req[s].max_new_tokens - int(self.tok_pos[s])
                   >= need for s in active)

    def _adapt_step(self) -> int:
        """The rung step the controller wants now (+1, -1 or 0), from the
        acceptance EWMA with hysteresis."""
        if not self.spec_adaptive or self._accept_ewma is None \
                or self._spec_ticks_since_adapt < self._ADAPT_MIN_TICKS:
            return 0
        i = self.spec_ladder.index(self.spec_k_now)
        if self._accept_ewma >= self._ADAPT_UP \
                and i + 1 < len(self.spec_ladder):
            return 1
        if self._accept_ewma <= self._ADAPT_DOWN and i > 0:
            return -1
        return 0

    def _adapt_k(self) -> int:
        step = self._adapt_step()
        if step:
            i = self.spec_ladder.index(self.spec_k_now)
            self.spec_k_now = self.spec_ladder[i + step]
            self.spec_k_switches += 1
            self._spec_ticks_since_adapt = 0
        return self.spec_k_now

    def _check_mode(self) -> None:
        if self._moe and any(m.training for m in self._models()):
            raise ValueError(
                "an MoE model is served in eval mode: call model.eval() "
                "(in training mode its gates route at random, at the "
                "training capacity)")

    # ------------------------------------------------------------ overlap
    def _can_overlap(self, pend: "_Pending") -> bool:
        """May tick t+1 be dispatched before tick t (``pend``) is
        harvested?  Not while a request waits (admissions join at a real
        boundary) or chunk work needs one; not past an active request's
        budget or a finished one; a chained tick continues ``pend``'s
        kind, and a spec tick chains only with a model draft (n-gram
        proposals need the harvested tokens) and no rung step due."""
        if self.waiting:
            return False
        if self.prefilling and not self._chunk_overlap_ok():
            return False
        if pend.spec:
            if not self.spec_model or self._adapt_step():
                return False
        elif not self.device_sampling and any(
                pend.reqs[s].do_sample for s in pend.active):
            return False         # the host samples the next last token
        elif self.spec and self._spec_eligible(pend.active):
            return False         # plain -> spec: a boundary first
        for slot in pend.active:
            req = self.slot_req[slot]
            if req is None or req.done:
                return False
            if req.max_new_tokens - int(self.tok_pos[slot]) < 1:
                return False
        return True

    def _chunk_overlap_ok(self) -> bool:
        """Only non-final chunks ride behind a chained tick: the final one
        reads its logits row on the host and installs the table row,
        boundary work."""
        if self.chunk <= 0:
            return False
        req = self.prefilling[0]
        return len(req.prompt_ids) - req._chunk_off > self.chunk

    def _overlap_chunk_work(self, nxt: "_Pending") -> None:
        """Non-final chunks of the head chunked admission, enqueued behind
        the chained tick ``nxt``: their writes land in the admission's own
        blocks, apart from every decoding slot's, so the order commutes.
        As the JAX engine does, this spends ``prefill_chunks_per_tick``
        (the argument, not the controller's budget); the chunks count in
        ``nxt``'s record."""
        if not self.prefilling or not self._chunk_overlap_ok():
            return
        req = self.prefilling[0]
        self._chunks_this_boundary = 0
        self._chunk_s_this_boundary = 0.0
        spent = 0
        while spent < self.chunks_per_tick \
                and len(req.prompt_ids) - req._chunk_off > self.chunk:
            self._prefill_chunk_step(req)
            spent += 1
            self.overlap_chunks += 1
        nxt.chunks += self._chunks_this_boundary
        nxt.ph_chunk += self._chunk_s_this_boundary
        self._chunks_this_boundary = 0
        self._chunk_s_this_boundary = 0.0

    def step(self) -> bool:
        """One scheduler boundary and one decode tick (a speculative one
        when some slot can take more than one token), harvested before it
        returns.  Returns True while work remains."""
        return self._step([])

    def _step(self, in_flight: list) -> bool:
        """:meth:`step`, appending the tick it dispatches to
        ``in_flight`` (the guard abandons it if the harvest fails)."""
        pend = self._dispatch(boundary=True)
        if pend is None:
            return bool(self.waiting or self.prefilling
                        or any(r is not None for r in self.slot_req))
        in_flight.append(pend)
        self._harvest(pend)
        return True

    def _guarded_step(self) -> bool:
        """:meth:`step` under the crash-only guard."""
        in_flight = []
        try:
            return self._step(in_flight)
        except Exception as e:  # noqa: BLE001 - the guard's whole job
            if not self._absorb_failure(e, in_flight):
                raise
            return True

    def run(self) -> List[Request]:
        """Drive until every queued request finishes or ends otherwise;
        returns them in completion order.  On the card the program grid
        is captured first (:meth:`warmup`).  With ``overlap`` one tick
        stays in flight: tick t+1 is dispatched, then t harvested.  Every
        boundary and tick runs under the crash-only guard; a failure
        between a chained dispatch and the harvest (a non-final chunk
        behind the chained tick included) drops both ticks in flight
        unharvested, their tokens with them, as the JAX engine does.  The
        engine is attached to the HTTP endpoint, which starts on
        ``metrics_port`` / ``http_port`` when they are set."""
        self._start_http()
        if self.cuda_graphs:
            self.warmup()
        self._mark_ready()
        pend = None
        while True:
            if pend is None:
                if not (self.waiting or self.prefilling
                        or self._active_slots()):
                    break
                try:
                    pend = self._dispatch(boundary=True)
                except Exception as e:  # noqa: BLE001 - the guard
                    if not self._absorb_failure(e, ()):
                        raise
                    continue
                if pend is None:
                    continue
            nxt = None
            try:
                if self.overlap and self._can_overlap(pend):
                    nxt = self._dispatch(boundary=False, chain=pend)
                    if nxt is not None:
                        nxt.overlapped = True
                        self.overlapped_ticks += 1
                        _M_OVERLAP.inc()
                        self._overlap_chunk_work(nxt)
                self._harvest(pend)
            except Exception as e:  # noqa: BLE001 - the guard
                if not self._absorb_failure(e, (pend, nxt)):
                    raise
                pend = None
                continue
            pend = nxt
        self._evict_done()
        _blocksan.blocksan_verify(self)
        return self.finished

    def _start_http(self) -> None:
        """Attach this engine to the HTTP endpoint (``POST /generate``,
        ``/healthz``); start the scrape and serve endpoints on their
        ports when set.  Never raises (a busy port does not stop
        serving)."""
        from ..observability import http as _http
        _http.start_metrics(self.metrics_port)
        _http.attach_engine(self)
        _http.start_serving(self.http_port)

    def serve_forever(self, stop_event, idle_s: float = 0.002) -> None:
        """Serve requests added from other threads until ``stop_event``
        (a ``threading.Event``) is set, napping ``idle_s`` when idle; a
        requested drain (:meth:`request_drain`, or SIGTERM when this runs
        on the main thread) drains and returns.  The grid is captured
        before admission opens; every step is synchronous (admissions and
        cancellations at every boundary) and guarded.  The HTTP endpoint
        is attached (and started) as by :meth:`run`."""
        self._start_http()
        old_handler = None
        try:
            old_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_drain())
        except ValueError:
            pass                     # not the main thread
        try:
            if self.cuda_graphs:
                self.warmup()
            self._mark_ready()
            while not stop_event.is_set():
                if self._drain_requested and not self._draining:
                    self.drain()
                    return
                if self.waiting or self.prefilling \
                        or any(r is not None for r in self.slot_req):
                    self._guarded_step()
                else:
                    time.sleep(idle_s)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

    # ------------------------------------------------------------- drain
    def request_drain(self) -> None:
        """Ask the engine to drain at its next boundary; admission closes
        now.  A bare bool store: safe from a signal handler or another
        thread."""
        self._drain_requested = True

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Graceful drain: admission closes, the waiting queue ends
        ``outcome="drained"``, the running requests tick under the guard
        until they finish or ``deadline_s`` (``drain_timeout_s``) passes,
        stragglers end ``"drained"``, the ledger is verified, and the
        prefix cache is exported when ``prefix_export_dir`` is set.
        Idempotent; returns (and ``stats()`` keeps) the report."""
        if self._drain_info is not None:
            return self._drain_info
        if deadline_s is None:
            deadline_s = self.drain_timeout_s
        t0 = time.monotonic()
        with self._lock:
            self._drain_requested = True
            self._draining = True
            waiting, self.waiting = list(self.waiting), deque()
        self._flightrec().record_event(
            "drain_start", waiting=len(waiting),
            running=self.B - len(self.free_slots))
        for r in waiting:
            self._terminal_trace(r, "drained")
            self.finished.append(r)
            r._stream_push(None)
        self._update_pressure()
        deadline = t0 + max(float(deadline_s), 0.0)
        while (self.prefilling or self._active_slots()) \
                and time.monotonic() < deadline:
            self._guarded_step()
        evicted = 0
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            if req._prefilling:
                self._abort_prefill(req, outcome="drained")
                evicted += 1
            elif req.done:
                self._evict(slot)
            else:
                self._terminal_trace(req, "drained")
                self._evict(slot)
                req._stream_push(None)
                evicted += 1
        _blocksan.blocksan_verify(self)
        export = None
        if self.prefix is not None and self._export_dir:
            try:
                export = self.export_prefix_cache(self._export_dir)
            except _LOUD:
                raise
            except Exception as e:  # noqa: BLE001 - the drain must end
                export = {"error": f"{type(e).__name__}: {e}"[:200]}
                self._flightrec().record_event(
                    "prefix_export_failed", error=export["error"])
        self._drain_info = {
            "drained_s": round(time.monotonic() - t0, 4),
            "deadline_s": float(deadline_s),
            "cancelled_waiting": len(waiting),
            "evicted_running": evicted,
            "export": export}
        self._flightrec().record_event(
            "drain_complete", **{k: v for k, v in self._drain_info.items()
                                 if k != "export"})
        return self._drain_info

    # ------------------------------------- the prefix cache's persistence
    def _prefix_fingerprint(self) -> dict:
        """What an export's blocks are a function of, besides the prompt
        tokens: the pools' geometry and type, the quantization and the
        draft's geometry; the JAX engine's keys and values (the type as
        numpy names it), so either package reads the other's exports.
        Weights are not fingerprinted: restarting with other weights
        under the same geometry is the operator's contract."""
        cfg = self.model.cfg
        nh, _, _, hd = self.pools[0][0].shape
        fp = {"num_layers": int(cfg.num_layers), "nh": int(nh),
              "hd": int(hd), "block_size": self.bs,
              "vocab_size": int(cfg.vocab_size),
              "dtype": str(self.pools[0][0].dtype).replace("torch.", ""),
              "quant": self.quant_mode, "draft": bool(self.spec_model)}
        if self.spec_model:
            dcfg = self.draft.cfg
            fp["draft_layers"] = int(dcfg.num_layers)
            fp["draft_nh"] = int(dcfg.num_heads)
            fp["draft_hd"] = int(dcfg.hidden_size // dcfg.num_heads)
        return fp

    def export_prefix_cache(self, root: str) -> dict:
        """Write the prefix index and the KV contents of every block it
        references (every layer's pools, the draft's too) as an atomic,
        integrity-checked version under ``root``
        (``distributed/checkpoint/manager.py``: a reader never sees a torn
        export).  The blocks are gathered on the card (``index_select``,
        outside every graph) and only they cross to the host; bfloat16
        blocks are stored as their 16-bit words.  Returns ``{step, path,
        entries, blocks, bytes, export_s}``."""
        if self.prefix is None:
            raise ValueError("prefix cache is disabled on this engine")
        if self.tp > 1:
            raise ValueError("the prefix cache's export is not ported at "
                             "tp_degree > 1")
        t0 = time.perf_counter()
        index = self.prefix.export_state()
        blocks = sorted({e["block"] for e in index["entries"]})
        ids = np.asarray(blocks, np.int64)
        idx = torch.as_tensor(ids, device=self.device)
        arrays = {"block_ids": ids}
        for tag, pools in (("", self.pools), ("d", self.dpools or ())):
            for li, (kk, vv) in enumerate(pools):
                arrays[f"{tag}k{li}"] = _to_host(kk.index_select(1, idx))
                arrays[f"{tag}v{li}"] = _to_host(vv.index_select(1, idx))
        index["meta"] = self._prefix_fingerprint()
        step = max(_ckpt.all_steps(root), default=0) + 1

        def write(tmp):
            with _chaos.checked_open(
                    os.path.join(tmp, "prefix_index.json"), "w") as f:
                json.dump(index, f)
            with _chaos.checked_open(
                    os.path.join(tmp, "prefix_blocks.npz"), "wb") as f:
                np.savez(f, **arrays)
            return ["prefix_index.json", "prefix_blocks.npz"]

        path = _ckpt.commit_single_rank(root, step, write)
        info = {"step": step, "path": path,
                "entries": len(index["entries"]), "blocks": len(blocks),
                "bytes": int(sum(a.nbytes for a in arrays.values())),
                "export_s": round(time.perf_counter() - t0, 4)}
        self._flightrec().record_event("prefix_export", **info)
        return info

    def release_exported_prefix(self) -> int:
        """The export side of a handoff: drop every index-only entry, so
        the blocks just exported return to the pool (entries a running
        request still references stay).  Returns the blocks freed."""
        if self.prefix is None:
            return 0
        freed = self.prefix.evict(self.num_blocks, self._release_block,
                                  lambda b: int(self.block_rc[b]) == 1)
        _blocksan.blocksan_verify(self)
        self._flightrec().record_event("prefix_handoff_release",
                                                blocks=freed)
        return freed

    def _import_prefix_cache(self, root: str) -> None:
        """Construction-time warm restart: the newest version under
        ``root`` that validates and matches this engine's fingerprint
        rebuilds the index; every entry takes a fresh block through
        ``_alloc_block``.  Versions that fail are skipped and counted in
        ``stats()["prefix_cache"]["import"]["skipped_corrupt"]``, never
        loaded."""
        skipped = 0
        for step in reversed(_ckpt.all_steps(root)):
            path = os.path.join(root, _ckpt.step_dir(step))
            reason = _ckpt.verify_version(path)
            kind = "corrupt"
            if reason is None:
                try:
                    with open(os.path.join(path,
                                           "prefix_index.json")) as f:
                        index = json.load(f)
                    if index.get("meta") != self._prefix_fingerprint():
                        reason, kind = "engine fingerprint mismatch", \
                            "mismatch"
                    else:
                        n = self._install_prefix_export(path, index)
                except _LOUD:
                    raise
                except Exception as e:  # noqa: BLE001 - restart must live
                    reason, kind = f"{type(e).__name__}: {e}"[:200], \
                        "unreadable"
            if reason is not None:
                skipped += 1
                _M_PREFIX_IMPORT_SKIP.inc(reason=kind)
                self._flightrec().record_event(
                    "prefix_import_skip", step=step, reason=reason)
                continue
            if n:
                _M_PREFIX_IMPORT.inc(n)
            self._prefix_import_info = {
                "step": step, "blocks": n, "skipped_corrupt": skipped}
            self._flightrec().record_event(
                "prefix_import", step=step, blocks=n, skipped=skipped)
            _blocksan.blocksan_snapshot(self)
            return
        if skipped:
            self._prefix_import_info = {
                "step": None, "blocks": 0, "skipped_corrupt": skipped}

    def _install_prefix_export(self, path: str, index: dict) -> int:
        """Rebuild the index and the blocks' contents from one valid
        version; returns the blocks imported.  Every array is checked
        before the index changes, so a malformed version leaves the
        engine as it was.  The contents are written into the existing
        pools in place (one host-to-card copy per pool): captured graphs
        read the pools at their addresses."""
        data = np.load(os.path.join(path, "prefix_blocks.npz"),
                       allow_pickle=False)
        pos = {int(b): i for i, b in enumerate(data["block_ids"])}
        if any(int(e["block"]) not in pos for e in index["entries"]):
            raise ValueError("an index entry's block is not exported")
        pools = [(f"{tag}{name}{li}", pool)
                 for tag, ps in (("", self.pools), ("d", self.dpools or ()))
                 for li, (kk, vv) in enumerate(ps)
                 for name, pool in (("k", kk), ("v", vv))]
        host = []
        for key, pool in pools:
            blocks = _from_host(data[key], pool.dtype)
            want = (pool.shape[0], len(pos)) + tuple(pool.shape[2:])
            if tuple(blocks.shape) != want:
                raise ValueError(f"{key}: blocks {tuple(blocks.shape)}, "
                                 f"the pool takes {want}")
            host.append(blocks)
        mapping: dict = {}

        def alloc():
            return self._alloc_block() if self.free_blocks else None

        n = self.prefix.import_state(index, alloc, mapping.__setitem__)
        if not mapping:
            return 0
        src = torch.as_tensor([pos[old] for old in mapping])
        dst = torch.as_tensor(list(mapping.values()), device=self.device)
        for (_, pool), blocks in zip(pools, host):
            pool[:, dst] = blocks[:, src].to(pool.device)
        return n

    # ------------------------------------------------------------ health
    def _mark_ready(self) -> None:
        """Admission is open and (on the card) the grid captured."""
        if not self._ready:
            self._ready = True
            self._t_serve_start = time.monotonic()

    @property
    def ready(self) -> bool:
        return self._ready

    def health(self) -> dict:
        """The readiness document (the JAX engine's ``/healthz``): not
        ready with ``reason="warmup"`` until ``run()`` or
        ``serve_forever()`` opened admission, ``reason="draining"`` with
        the in-flight and waiting counts once a drain was asked for, else
        ready with the queue, uptime and TTFT evidence.  Reads host
        counters only: safe from other threads."""
        if not self._ready:
            return {"ready": False, "reason": "warmup"}
        running = self.B - len(self.free_slots)
        if self._draining or self._drain_requested:
            doc = {"ready": False, "reason": "draining",
                   "in_flight": running, "waiting": len(self.waiting),
                   "prefilling": len(self.prefilling)}
            if self._drain_info is not None:
                doc["drained"] = True
                doc["drained_s"] = self._drain_info["drained_s"]
            return doc
        doc = {"ready": True, "running": running,
               "waiting": len(self.waiting),
               "queue_depth": running + len(self.waiting),
               "slots": self.B, "free_slots": len(self.free_slots),
               "prefilling": len(self.prefilling),
               "uptime_s": round(time.monotonic() - self._t_serve_start, 3),
               "ttft_evidence": self._ttft_evidence()}
        if self._warmup_info is not None:
            doc["warmup"] = {k: self._warmup_info[k]
                             for k in ("warmup_s", "programs")}
        return doc

    def _ttft_evidence(self) -> dict:
        """Recent admission rate and median TTFT (over the last 64), the
        median tick-level seconds per token (the always-on sketch over
        every harvest, weighted by the tokens each yielded: the JAX
        engine's), and the mean length of finished requests."""
        ev = {"admit_rate_per_s": 0.0, "ttft_p50_s": 0.0,
              "samples": len(self._ttft_recent)}
        times = list(self._admit_times)
        if len(times) >= 2 and times[-1] > times[0]:
            ev["admit_rate_per_s"] = round(
                (len(times) - 1) / (times[-1] - times[0]), 4)
        if self._ttft_recent:
            srt = sorted(self._ttft_recent)
            ev["ttft_p50_s"] = round(srt[len(srt) // 2], 6)
        if self._ev_tpot.count > 0:
            ev["tpot_p50_s"] = round(self._ev_tpot.quantile(0.5), 6)
        if self._ev_finished:
            ev["avg_tokens_out"] = round(
                self._ev_finished_tokens / self._ev_finished, 3)
        return ev

    def telemetry_snapshot(self) -> dict:
        """The engine's always-on evidence (``/metrics/snapshot``):
        terminal outcomes, TTFT-SLO violations, finished requests and
        tokens, the TPOT sketch's state and the TTFT evidence.  Host
        numbers only, whatever the metrics gate."""
        return {"outcomes": dict(self._ev_outcomes),
                "slo_violations_ttft": self._ev_slo_viol,
                "finished": self._ev_finished,
                "finished_tokens": self._ev_finished_tokens,
                "tpot_sketch": self._ev_tpot.to_state(),
                "ttft_evidence": self._ttft_evidence()}

    def stats(self) -> dict:
        """Counters.  ``free_blocks`` counts the blocks the prefix index
        alone holds (reclaimable on demand), so a drained engine that
        leaked nothing reads ``free_blocks == num_blocks``.  ``latency``
        holds p50 / p90 / p99 of the TTFT, TPOT, e2e and queue-wait
        sketches, which are process-wide (every engine of the process
        feeds them, as the ``/metrics`` scrape reads them)."""
        reclaim = self.prefix.reclaimable(self.block_rc) \
            if self.prefix is not None else 0
        running = self.B - len(self.free_slots)
        out = {"steps": self.steps, "ticks": self.ticks,
               "tokens_out": self.tokens_out,
               "free_blocks": len(self.free_blocks) + reclaim,
               "reserved": self.reserved,
               "active": len(self._active_slots()),
               "running": running,
               "waiting": len(self.waiting),
               "queue_depth": running + len(self.waiting),
               "prefilling": len(self.prefilling),
               "prefill_chunk": self.chunk,
               "prefill_chunks": self.prefill_chunks_total,
               "chunk_budget": (self.chunks_per_tick
                                if self._chunk_budget_now is None
                                else self._chunk_budget_now),
               "slo_sheds": self.slo_sheds,
               "pad_buckets": list(self.pad_ladder),
               "tp_degree": self.tp,
               "overlapped_ticks": self.overlapped_ticks,
               "overlap_chunks": self.overlap_chunks,
               "tick_errors": self.tick_errors,
               "poisoned_requests": self.poisoned_requests,
               "dispatch_retries": self.dispatch_retries,
               "draining": bool(self._draining or self._drain_requested),
               "graphs": {
                   "enabled": self.cuda_graphs,
                   "captured": sum(p.graph is not None
                                   for p in self._programs.values()),
                   "replays": sum(p.replays for p in self._programs.values()
                                  if p.graph is not None)}}
        if self._warmup_info is not None:
            out["warmup"] = dict(self._warmup_info)
        if self._drain_info is not None:
            out["drain"] = dict(self._drain_info)
        if self.spec:
            per_slot = {slot: round(r._spec_accepted / r._spec_proposed, 4)
                        for slot, r in enumerate(self.slot_req)
                        if r is not None and r._spec_proposed}
            out["speculative"] = {
                "spec_k": self.spec_k,
                "k_now": self.spec_k_now,
                "ladder": list(self.spec_ladder),
                "adaptive": self.spec_adaptive,
                "k_switches": self.spec_k_switches,
                "draft": self.spec_kind,
                "ticks": self.spec_ticks,
                "proposed_tokens": self.spec_proposed,
                "accepted_tokens": self.spec_accepted,
                "accept_rate": round(
                    self.spec_accepted / max(self.spec_proposed, 1), 4),
                "accept_ewma": (None if self._accept_ewma is None
                                else round(self._accept_ewma, 4)),
                "ineligible_slots": self.spec_ineligible_slots,
                "per_slot_accept_rate": per_slot}
        if self._quant_stats is not None:
            out["quant"] = dict(self._quant_stats)
        if self.prefix is not None:
            out["prefix_cache"] = {
                "entries": len(self.prefix),
                "hits": self.prefix.hits,
                "misses": self.prefix.misses,
                "blocks_shared": self.prefix.blocks_shared,
                "evictions": self.prefix.evictions,
                "reclaimable_blocks": reclaim}
            if self._prefix_import_info is not None:
                out["prefix_cache"]["import"] = dict(self._prefix_import_info)
        lat = {}
        for key, sk in (("ttft", _M_TTFT), ("tpot", _M_TPOT),
                        ("e2e", _M_E2E), ("queue_wait", _M_QWAIT)):
            if sk.count():
                lat[key] = {f"p{round(q * 100)}": round(sk.quantile(q), 6)
                            for q in (0.5, 0.9, 0.99)}
        if lat:
            out["latency"] = lat
        return out
