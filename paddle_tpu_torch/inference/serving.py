"""Continuous-batching serving engine over paged KV pools.

Counterpart of ``paddle_tpu/inference/serving.py:ServingEngine``, the
part that serves one model on one card:

* a host block allocator with free lists; block 0 of every pool is the pad
  block;
* admission of the oldest waiting request when a slot and its worst-case
  blocks are free: a whole-prompt prefill padded to a bucket of the pad
  ladder, or, with ``prefill_chunk > 0``, chunks of at most that many
  tokens run one per scheduler boundary between decode ticks;
* the k-step decode tick: k forward steps over every slot with sampling on
  the card, one host round trip per tick;
* eviction of finished requests, returning their blocks.

    engine = ServingEngine(model, max_batch=4, max_context=512)
    engine.add_request(Request([1, 2, 3], max_new_tokens=16))
    finished = engine.run()          # or engine.step() incrementally

The JAX engine compiles each program with XLA; here PyTorch runs eagerly
and the attention goes through the port's CUDA kernels.  Prefix cache,
spec decode, quantization, tensor parallelism, the overlapped tick loop,
warmup, crash-only handling, drain, the HTTP endpoint and telemetry are
later slices (see ROADMAP.md).
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


class ServingEngine:
    """Continuous batching over a model with ``forward_with_cache``.

    ``device`` is where the pools live and the model must live: ``cuda``
    by default (raises without CUDA unless ``device="cpu"``).  A model with
    MoE blocks must be in eval mode (``model.eval()``): its gates' capacity
    and random routing follow ``training``, and the engine refuses to
    serve it in training mode."""

    def __init__(self, model, max_batch: int = 4,
                 max_context: Optional[int] = None, block_size: int = 64,
                 num_blocks: Optional[int] = None, steps_per_tick: int = 1,
                 pad_buckets=None, prefill_chunk: int = 0, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self._moe = any(isinstance(m, MoELayer) for m in model.modules())
        self._check_mode()
        cfg = model.cfg
        self.B = int(max_batch)
        self.bs = int(block_size)
        self.max_context = int(max_context or cfg.max_seq_len)
        self.nb_per_seq = math.ceil(self.max_context / self.bs)
        if num_blocks is None:
            num_blocks = self.B * self.nb_per_seq
        self.num_blocks = int(num_blocks)
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh

        def pool():
            return torch.zeros((nh, self.num_blocks + 1, self.bs, hd),
                               dtype=model.dtype, device=self.device)
        self.pools = [(pool(), pool()) for _ in range(cfg.num_layers)]
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

    def _try_admit(self) -> bool:
        if not self.waiting or not self.free_slots:
            return False
        req = self.waiting[0]
        L = len(req.prompt_ids)
        if self.chunk > 0:
            # chunk writes past the prompt route to the pad block, so the
            # real span is all a chunked admission needs
            need_now = self._blocks_for(L)
        else:
            L_pad = self._pad_bucket(L)
            need_now = self._blocks_for(L_pad)
        growth = max(0, self._blocks_for(L + req.max_new_tokens)
                     - self._blocks_for(L))
        if need_now + growth > len(self.free_blocks) - self.reserved:
            return False
        self.waiting.popleft()
        slot = self.free_slots.popleft()
        row = np.zeros((self.nb_per_seq,), np.int32)
        for col in range(need_now):
            row[col] = self.free_blocks.popleft()
        req._growth_left = growth
        self.reserved += growth
        if self.chunk > 0:
            # the table row stays on the request until the last chunk, so
            # ticks meanwhile see an all-zero row and write the pad block
            req.slot = slot
            req._chunk_row = row
            req._chunk_off = 0
            req._prefilling = True
            self.slot_req[slot] = req
            self.prefilling.append(req)
            return True
        self.tables[slot, :] = row
        prompt = np.zeros((1, L_pad), np.int64)
        prompt[0, :L] = req.prompt_ids
        logits = self._forward_prompt(PagedKVCache, row, prompt, 0)
        # blocks of the pad bucket beyond the prompt go back to the pool
        for col in range(self._blocks_for(L), need_now):
            self.free_blocks.append(int(self.tables[slot, col]))
            self.tables[slot, col] = 0
        self._finish_admission(req, slot, logits[0, L - 1])
        return True

    def _forward_prompt(self, view_cls, row, ids, start: int):
        """One prompt program over a single sequence: ``ids`` [1, L_pad]
        at positions start.., through views with lengths [start]."""
        table = torch.as_tensor(row[None], device=self.device)
        lens = torch.full((1,), start, dtype=torch.int32, device=self.device)
        views = [view_cls.from_parts(k, v, table, lens, self.bs)
                 for k, v in self.pools]
        with torch.no_grad():
            logits, _ = self.model.forward_with_cache(
                torch.as_tensor(ids, device=self.device), views,
                pos_offset=start)
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
            self.tables[req.slot, :] = req._chunk_row
            req._chunk_row = None
            req._prefilling = False
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
                self.free_blocks.append(int(self.tables[slot, col]))
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
        """Evict finished requests, then admit: every waiting request that
        fits (whole-prompt prefill), or one prefill chunk per boundary,
        finishing the oldest chunked admission before starting the next."""
        self._evict_done()
        if self.chunk <= 0:
            while self._try_admit():
                pass
            return
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

    def _check_mode(self) -> None:
        if self._moe and self.model.training:
            raise ValueError(
                "an MoE model is served in eval mode: call model.eval() "
                "(in training mode its gates route at random, at the "
                "training capacity)")

    def step(self) -> bool:
        """One scheduler boundary and one decode tick.  Returns True while
        work remains."""
        self._check_mode()
        self._boundary_schedule()
        active = self._active_slots()
        if not active:
            if self.waiting and not self.prefilling and \
                    all(r is None for r in self.slot_req):
                raise RuntimeError("the waiting request cannot be admitted "
                                   "into an empty engine")
            return bool(self.waiting or self.prefilling
                        or any(r is not None for r in self.slot_req))
        k = self._tick_size(active)
        # a physical block for every position this tick writes (drawn from
        # the admission's reservation)
        for slot in active:
            start = int(self.seq_lens[slot])
            for pos in range(start, start + k):
                col = pos // self.bs
                if pos % self.bs == 0 and self.tables[slot, col] == 0:
                    self.tables[slot, col] = self.free_blocks.popleft()
                    self.reserved -= 1
                    self.slot_req[slot]._growth_left -= 1
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
        return {"steps": self.steps, "ticks": self.ticks,
                "tokens_out": self.tokens_out,
                "free_blocks": len(self.free_blocks),
                "reserved": self.reserved,
                "active": len(self._active_slots()),
                "waiting": len(self.waiting),
                "prefilling": len(self.prefilling),
                "prefill_chunks": self.prefill_chunks_total,
                "pad_buckets": list(self.pad_ladder)}
