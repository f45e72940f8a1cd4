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

The JAX engine compiles each program with XLA; here PyTorch runs eagerly
and the attention goes through the port's CUDA kernels.  The tick loop
has no overlap: every tick is harvested before the next is dispatched,
which the JAX engine's streams do not depend on.  The prefix cache's
export and import, quantization, tensor parallelism, the overlapped tick
loop, warmup, crash-only handling, drain, the HTTP endpoint and telemetry
are later slices (see ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..core import threefry
from ..core.device import resolve_device
from ..incubate.distributed.models.moe import MoELayer
from ..models.generation import _process_logits_rows, sample_rows
from ..models.kv_cache import PagedChunkKernelView, PagedKVCache
from . import speculative
from .drafting import NGramDraft
from .prefix_cache import PrefixCache

__all__ = ["Request", "ServingEngine"]


class Request:
    """One generation request; tokens accumulate in ``output_ids``.

    A sampled request's stream is a function of its ``seed`` and token
    positions alone: the same seed gives the same tokens whatever the tick
    size, batch or slot, and the JAX engine's tokens.  As there, the first
    token is drawn on the host from ``numpy.random.RandomState(seed)``
    (:meth:`_sample`), the decode tokens on the card from
    ``fold_in(key(seed), position)`` (``sample_rows``).  ``t_enqueue``
    and ``t_first`` are host ``perf_counter`` stamps at ``add_request``
    and at the first token."""

    _counter = 0

    def __init__(self, prompt_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None):
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
        # engine-owned admission state
        self._growth_left = 0
        self._prefilling = False
        self._prefill_chunks = 0
        self._chunk_row: Optional[np.ndarray] = None  # shadow table row
        self._chunk_off = 0                           # prompt tokens written
        # the prefix-cache lookup, cached within one index epoch
        self._prefix_match = None
        self._prefix_epoch = -1
        # speculative decoding: draft tokens proposed for this request and
        # accepted by the verify, and its n-gram table (spec_draft="ngram")
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._drafter: Optional[NGramDraft] = None

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
    acceptance rate."""

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
                 spec_k_ladder="2,4,8", device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
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

    def _models(self):
        return [self.model] + ([self.draft] if self.draft is not None
                               else [])

    def _pools(self, model) -> list:
        """One (K, V) pair of pools ``[nh, num_blocks + 1, bs, hd]`` per
        layer of ``model``, in its dtype."""
        cfg = model.cfg
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh

        def pool():
            return torch.zeros((nh, self.num_blocks + 1, self.bs, hd),
                               dtype=model.dtype, device=self.device)
        return [(pool(), pool()) for _ in range(cfg.num_layers)]

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
        self.block_rc[blk] = 1
        return blk

    def _ref_block(self, blk: int) -> None:
        self.block_rc[blk] += 1

    def _release_block(self, blk: int) -> bool:
        """Drop one reference; the block is freed (True) only when none
        is left: a shared block outlives each of its holders."""
        self.block_rc[blk] -= 1
        if self.block_rc[blk] <= 0:
            self.block_rc[blk] = 0
            self.free_blocks.append(int(blk))
            return True
        return False

    # --------------------------------------------------------- admission
    def add_request(self, req: Request) -> Request:
        L = len(req.prompt_ids)
        if L == 0:
            raise ValueError("empty prompt")
        if L + req.max_new_tokens > self.max_context:
            raise ValueError(f"request needs {L + req.max_new_tokens} tokens "
                             f"> max_context {self.max_context}")
        worst = self._blocks_for(self._pad_bucket(L)) + max(
            0, self._blocks_for(L + req.max_new_tokens) - self._blocks_for(L))
        if worst > self.num_blocks:
            raise ValueError(f"request needs {worst} blocks worst-case but "
                             f"the pool has {self.num_blocks}")
        req.t_enqueue = time.perf_counter()
        self.waiting.append(req)
        return req

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
            return False
        self.waiting.popleft()
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
                req._prefilling = True
                self.slot_req[slot] = req
                self.prefilling.append(req)
                self._count_prefix(bool(chain), shared)
                return True
            self.tables[slot, :] = row
            if chain:
                Ls = L - cached_len
                ids = np.zeros((1, self._pad_bucket(Ls)), np.int64)
                ids[0, :Ls] = req.prompt_ids[cached_len:]
                logits = self._forward_prompt(PagedChunkKernelView, row,
                                              ids, cached_len)
                first_row = logits[0, Ls - 1]
            else:
                ids = np.zeros((1, L_pad), np.int64)
                ids[0, :L] = req.prompt_ids
                logits = self._forward_prompt(PagedKVCache, row, ids, 0)
                first_row = logits[0, L - 1]
        except BaseException:
            # undo every host-side draw: references (shared blocks survive
            # their other holders), the slot, the growth reservation
            for b in row:
                if b:
                    self._release_block(int(b))
            if cow_src is not None and not cow_done:
                self._release_block(cow_src)
            self.tables[slot, :] = 0
            self.free_slots.appendleft(slot)
            self.reserved -= growth
            req._growth_left = 0
            raise
        if not chain:
            # blocks of the pad bucket beyond the prompt go back to the pool
            for col in range(self._blocks_for(L), need_now):
                self._release_block(int(self.tables[slot, col]))
                self.tables[slot, col] = 0
        self._register(req, slot)
        self._count_prefix(bool(chain), shared)
        self._finish_admission(req, slot, first_row)
        return True

    def _count_prefix(self, hit: bool, shared: int) -> None:
        if self.prefix is None:
            return
        if hit:
            self.prefix.hits += 1
            self.prefix.blocks_shared += shared
        else:
            self.prefix.misses += 1

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

    def _cow(self, src: int, dst: int) -> None:
        """Copy block ``src`` to ``dst`` in every layer's K and V pools,
        the draft's too: the suffix's write must land in a private
        block."""
        for pools in (self.pools, self.dpools or ()):
            for kk, vv in pools:
                kk[:, dst] = kk[:, src]
                vv[:, dst] = vv[:, src]

    def _forward_prompt(self, view_cls, row, ids, start: int):
        """One prompt program over a single sequence: ``ids`` [1, L_pad]
        at positions start.., through views with lengths [start].  With a
        draft model, the draft runs the same tokens for their KV (its
        logits are discarded: the first token is the target's)."""
        table = torch.as_tensor(row[None], device=self.device)
        lens = torch.full((1,), start, dtype=torch.int32, device=self.device)
        ids = torch.as_tensor(ids, device=self.device)
        with torch.no_grad():
            logits, _ = self.model.forward_with_cache(
                ids, [view_cls.from_parts(k, v, table, lens, self.bs)
                      for k, v in self.pools], pos_offset=start)
            if self.spec_model:
                self.draft.forward_with_cache(
                    ids, [view_cls.from_parts(k, v, table, lens, self.bs)
                          for k, v in self.dpools], pos_offset=start)
        return logits

    def _prefill_chunk_step(self, req: Request) -> None:
        """One chunk of a chunked admission: prompt tokens [off, off + n)
        padded to their bucket; the last chunk's logits give the first
        token."""
        L = len(req.prompt_ids)
        off = req._chunk_off
        n = min(self.chunk, L - off)
        ids = np.zeros((1, self._pad_bucket(n)), np.int64)
        ids[0, :n] = req.prompt_ids[off:off + n]
        logits = self._forward_prompt(PagedChunkKernelView, req._chunk_row,
                                      ids, off)
        req._chunk_off = off + n
        req._prefill_chunks += 1
        self.prefill_chunks_total += 1
        if req._chunk_off >= L:
            # the last chunk: the shadow row installs, and only now may
            # the prompt's blocks be registered (each chunk writes blocks
            # the one before filled)
            self.tables[req.slot, :] = req._chunk_row
            req._chunk_row = None
            req._prefilling = False
            self._register(req, req.slot)
            self._finish_admission(req, req.slot, logits[0, n - 1])

    def _finish_admission(self, req: Request, slot: int, row) -> None:
        """First token from the prompt's last logits row (position 0 of
        the request's sampling stream); the slot joins the decode ticks."""
        first = req._sample(row)
        req.t_first = time.perf_counter()
        req.output_ids.append(first)
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
        self._maybe_finish(req, first)

    def _maybe_finish(self, req: Request, tok: int) -> None:
        if req.done:
            return
        if (req.eos_token_id is not None and tok == req.eos_token_id) or \
                len(req.output_ids) >= req.max_new_tokens:
            req.done = True

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

    def _evict_done(self) -> None:
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is not None and not req._prefilling and req.done:
                self._evict(slot)

    def _active_slots(self) -> List[int]:
        # mid-chunked-prefill slots are occupied but not decodable yet
        return [s for s in range(self.B)
                if self.slot_req[s] is not None
                and not self.slot_req[s]._prefilling
                and not self.slot_req[s].done]

    def _boundary_schedule(self) -> None:
        """Whole-prompt: admit every waiting request that fits, then evict
        the finished (the JAX engine's order: a slot freed here takes a
        request at the next boundary).  Chunked: evict first, then one
        prefill chunk per boundary, finishing the oldest chunked admission
        before starting the next."""
        if self.chunk <= 0:
            while self._try_admit():
                pass
            self._evict_done()
            return
        self._evict_done()
        while True:
            if self.prefilling:
                req = self.prefilling[0]
                self._prefill_chunk_step(req)
                if not req._prefilling:
                    self.prefilling.popleft()
                return
            if not self._try_admit():
                return

    # ------------------------------------------------------------- ticks
    def _tick_size(self, active) -> int:
        """Steps this tick: the configured tick size, cut to the smallest
        remaining budget so no request decodes past its reservation."""
        k = self.steps_per_tick
        for slot in active:
            req = self.slot_req[slot]
            k = min(k, req.max_new_tokens - int(self.tok_pos[slot]))
        return max(1, k)

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

    def _tick(self, k: int) -> np.ndarray:
        """k decode steps over every slot, sampling on the card; one host
        round trip at the end.  Free slots run with length 0 on all-zero
        table rows: they write and read the pad block and emit 0."""
        dev = self.device
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tables, lens, last = t(self.tables), t(self.seq_lens), \
            t(self.last_tok)
        do_s, temp, topk, topp = (
            t(self.samp_do), t(self.samp_temp), t(self.samp_topk),
            t(self.samp_topp))
        any_sample = bool(self.samp_do.any())
        keys = None
        if any_sample:
            # the draw's keys fold_in(key(seed), position) of all k steps,
            # on the host (tiny) and in one copy: [2, k, B]
            pos = (torch.as_tensor(self.tok_pos)[None]
                   + torch.arange(k)[:, None])
            keys = t(torch.stack(threefry.fold_in(
                threefry.key(torch.as_tensor(self.samp_seed)), pos)))
        toks = []
        with torch.no_grad():
            for j in range(k):
                views = [PagedKVCache.from_parts(kp, vp, tables, lens,
                                                 self.bs)
                         for kp, vp in self.pools]
                logits, _ = self.model.forward_with_cache(
                    last[:, None], views, pos_offset=lens[:, None])
                nxt = sample_rows(logits[:, -1], do_s, temp, topk, topp,
                                  None if keys is None else keys[:, j],
                                  any_sample)
                active = lens > 0
                nxt = torch.where(active, nxt, torch.zeros_like(nxt))
                lens = torch.where(active, lens + 1, torch.zeros_like(lens))
                last = nxt
                toks.append(nxt)
        return torch.stack(toks, dim=1).cpu().numpy()

    # ------------------------------------------------------ speculation
    def _spec_eligible(self, active) -> bool:
        """A spec tick needs one active slot able to take more than one
        token (at rung 1, one token); a short-budget slot rides it capped
        at its own budget."""
        if not self.spec:
            return False
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

    def _spec_step(self, active) -> None:
        """One speculative tick: per-slot caps ``kcap = min(k, remaining
        budget)`` with their blocks, the proposals, one verify, and the
        harvest of each slot's emitted tokens and accepts."""
        k = self._adapt_k()
        kcap = np.zeros((self.B,), np.int64)
        for slot in active:
            req = self.slot_req[slot]
            cap = min(k, req.max_new_tokens - int(self.tok_pos[slot]))
            kcap[slot] = cap
            if cap < k:
                self.spec_ineligible_slots += 1
            self._draw_blocks(slot, cap)
        dtoks = None
        if not self.spec_model:
            # the host's n-gram proposals: a few dict probes per slot
            dtoks = np.zeros((self.B, k), np.int64)
            for slot in active:
                req = self.slot_req[slot]
                if req._drafter is None:
                    req._drafter = NGramDraft()
                dtoks[slot] = req._drafter.propose_stream(
                    req.prompt_ids, req.output_ids, k)
        toks, counts, accepts = self._spec_tick(k, kcap, dtoks)
        self.steps += k + 1 if self.spec_model else 1
        self.ticks += 1
        proposed = accepted = 0
        for slot in active:
            req = self.slot_req[slot]
            c, a = int(counts[slot]), int(accepts[slot])
            # the emitted count: where the JAX engine's advance by kcap at
            # dispatch lands after its refund at harvest (no tick is in
            # flight here to need the upper bound)
            self.seq_lens[slot] += c
            self.tok_pos[slot] += c
            # acceptance counts all k proposals (the drafter's quality,
            # which the controller reads), whatever the slot's cap
            proposed += k
            accepted += a
            req._spec_proposed += k
            req._spec_accepted += a
            self.last_tok[slot] = int(toks[slot, c - 1])
            for j in range(c):
                if req.done:
                    break        # tokens past eos are discarded
                tok = int(toks[slot, j])
                req.output_ids.append(tok)
                self.tokens_out += 1
                self._maybe_finish(req, tok)
        self.spec_ticks += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        if proposed:
            rate = accepted / proposed
            self._accept_ewma = rate if self._accept_ewma is None else (
                self._EWMA_BETA * self._accept_ewma
                + (1.0 - self._EWMA_BETA) * rate)
            self._spec_ticks_since_adapt += 1

    def _spec_tick(self, k: int, kcap, dtoks):
        """The card's side of a spec tick: the draft model's k steps (or
        the host's proposals ``dtoks``), the verify forward and the accept
        tail; one host round trip.  Returns ``(tokens [B, k], counts [B],
        accepts [B])``."""
        dev = self.device
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tables, lens, last = t(self.tables), t(self.seq_lens), \
            t(self.last_tok)
        samp = (t(self.samp_do), t(self.samp_temp), t(self.samp_topk),
                t(self.samp_topp))
        any_sample = bool(self.samp_do.any())
        u = resid_keys = draft_keys = None
        if any_sample:
            # every key and uniform is a function of the host's lengths:
            # drawn here, copied once
            seeds = torch.as_tensor(self.samp_seed)
            base = torch.as_tensor(self.seq_lens).long()
            u, resid_keys = (t(x) for x in speculative.host_draws(
                seeds, base, k))
            if self.spec_model:
                draft_keys = t(torch.stack([
                    torch.stack(speculative.keys_at(
                        seeds, base + j, speculative.DRAFT_FOLD))
                    for j in range(k)], dim=1))
        with torch.no_grad():
            if self.spec_model:
                dt, dprobs = speculative.draft_phase(
                    self.draft, self.dpools, self.bs, tables, lens, last,
                    samp, draft_keys, any_sample, k)
            else:
                dt = t(dtoks)
                # a host proposal is the point mass at its token
                dprobs = (torch.nn.functional.one_hot(
                    dt, self.model.cfg.vocab_size).float()
                    if any_sample else None)
            logits = speculative.verify_logits(
                self.model, self.pools, self.bs, tables, lens, last, dt)
            chosen, counts, accepts = speculative.finish(
                logits, dt, dprobs, samp, lens, t(kcap), u, resid_keys,
                any_sample)
        out = torch.cat([chosen, counts[:, None], accepts[:, None]],
                        dim=1).cpu().numpy()
        return out[:, :k], out[:, k], out[:, k + 1]

    def _check_mode(self) -> None:
        if self._moe and any(m.training for m in self._models()):
            raise ValueError(
                "an MoE model is served in eval mode: call model.eval() "
                "(in training mode its gates route at random, at the "
                "training capacity)")

    def step(self) -> bool:
        """One scheduler boundary and one decode tick (a speculative one
        when some slot can take more than one token).  Returns True while
        work remains."""
        self._check_mode()
        empty = not any(r is not None for r in self.slot_req)
        self._boundary_schedule()
        active = self._active_slots()
        if not active:
            if empty and self.waiting and not self.prefilling and \
                    all(r is None for r in self.slot_req):
                raise RuntimeError("the waiting request cannot be admitted "
                                   "into an empty engine")
            return bool(self.waiting or self.prefilling
                        or any(r is not None for r in self.slot_req))
        if self._spec_eligible(active):
            self._spec_step(active)
            return True
        k = self._tick_size(active)
        for slot in active:
            self._draw_blocks(slot, k)
        toks = self._tick(k)
        self.steps += k
        self.ticks += 1
        for slot in active:
            req = self.slot_req[slot]
            self.seq_lens[slot] += k
            self.tok_pos[slot] += k
            self.last_tok[slot] = int(toks[slot, -1])
            for j in range(k):
                if req.done:
                    break        # tokens past eos are discarded
                tok = int(toks[slot, j])
                req.output_ids.append(tok)
                self.tokens_out += 1
                self._maybe_finish(req, tok)
        return True

    def run(self) -> List[Request]:
        """Drive until every queued request finishes; returns them in
        completion order."""
        while self.step():
            pass
        self._evict_done()
        return self.finished

    def stats(self) -> dict:
        """Counters.  ``free_blocks`` counts the blocks the prefix index
        alone holds (reclaimable on demand), so a drained engine that
        leaked nothing reads ``free_blocks == num_blocks``."""
        reclaim = self.prefix.reclaimable(self.block_rc) \
            if self.prefix is not None else 0
        out = {"steps": self.steps, "ticks": self.ticks,
               "tokens_out": self.tokens_out,
               "free_blocks": len(self.free_blocks) + reclaim,
               "reserved": self.reserved,
               "active": len(self._active_slots()),
               "waiting": len(self.waiting),
               "prefilling": len(self.prefilling),
               "prefill_chunks": self.prefill_chunks_total,
               "pad_buckets": list(self.pad_ladder)}
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
        if self.prefix is not None:
            out["prefix_cache"] = {
                "entries": len(self.prefix),
                "hits": self.prefix.hits,
                "misses": self.prefix.misses,
                "blocks_shared": self.prefix.blocks_shared,
                "evictions": self.prefix.evictions,
                "reclaimable_blocks": reclaim}
        return out
