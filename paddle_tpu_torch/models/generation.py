"""Autoregressive generation and token choice.

Counterpart of ``paddle_tpu/models/generation.py``: ``GenerationMixin``
(``generate`` over dense, static and paged KV caches) and the scalar
``_process_logits``; the row-wise ``_process_logits_rows`` and
``_process_logits_tokens`` (its k-row twin for the speculative verify)
and the serving engine's per-row sampler, the draw of
``paddle_tpu/inference/serving.py:_next_tokens``.

``generate`` takes the JAX package's four cache implementations:

- ``"dense"`` and ``"paged_eager"`` (the host-allocated ``BlockKVCache``)
  are the host loop: the prompt once, then one forward per token; the
  loop stops early once every row has produced ``eos_token_id``.  A
  sampled token is ``categorical(next_key(), filtered)`` with the port's
  seeded key source (``core/random.py``), as the JAX loop draws;
- ``"static"`` (``StaticKVCache`` over ``max_seq_len``) and ``"paged"``
  (a ``PagedKVCache`` pool sized by the prompt and the new tokens) are the
  counterpart of the JAX whole-generation program (``_compiled_generate``,
  a ``lax.scan``): the prompt runs once, and one decode step (choose the
  token, with ``fold_in(key, step)`` of ONE ``next_key()`` draw when
  sampling; forward it) is a ``Program`` of ``inference/graphs.py``,
  captured once as a CUDA graph on the card and replayed per token.  The
  step, the logits, the finished flags and the cache lengths stay on the
  card; rows past eos are padded with eos to the full length.  On the
  CPU the same step runs eagerly.

Every draw is ``jax.random``'s bit for bit (``core/threefry.py``), so a
seeded sampled stream equals the JAX package's for the same seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import random as _random
from ..core import threefry
from .kv_cache import StaticKVCache

__all__ = ["GenerationMixin", "_process_logits", "_process_logits_rows",
           "_process_logits_tokens", "sample_rows", "CACHE_IMPLS"]

CACHE_IMPLS = ("dense", "static", "paged", "paged_eager")


def _process_logits(logits, temperature: float, top_k: int, top_p: float):
    """The JAX package's scalar ``_process_logits``: logits ``[B, V]``
    divided by the temperature, then the top-k filter, then top-p (the
    smallest set of cumulative probability ``>= top_p``) on the
    top-k-filtered logits; removed entries are -inf.  Only fills and
    kernels on the logits' device (a captured decode step runs it)."""
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        V = logits.shape[-1]
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.exp(sorted_l - sorted_l.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = (cum < top_p).sum(dim=-1).clamp(max=V - 1)
        kth = sorted_l.gather(-1, cutoff[:, None])
        logits = torch.where(logits < kth, neg_inf, logits)
    return logits


def _process_logits_rows(logits, temperature, top_k, top_p):
    """Row-wise filtering: every parameter is a ``[B]`` tensor, so one
    call filters a batch whose rows carry different temperature, top-k and
    top-p.  Rows with ``top_k <= 0`` or ``top_p >= 1`` skip that filter;
    top-p is cut on the already top-k-filtered logits, in the JAX order.

    logits ``[B, V]`` float; temperature, top_p float ``[B]``; top_k int
    ``[B]``.  Returns the filtered logits (removed entries are -inf).
    """
    V = logits.shape[-1]
    # a fill on the logits' device, no host copy: the serving engine
    # captures this function into CUDA graphs
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    logits = logits / temperature.clamp_min(1e-6)[:, None]
    # top-k: threshold at the k-th largest (ascending index V - k)
    asc = torch.sort(logits, dim=-1).values
    kth = asc.gather(-1, (V - top_k.long()).clamp(0, V - 1)[:, None])
    logits = torch.where((top_k > 0)[:, None] & (logits < kth), neg_inf,
                         logits)
    # top-p: smallest set with cumulative probability >= top_p
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.exp(sorted_l - sorted_l.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = (cum < top_p[:, None]).sum(dim=-1).clamp(0, V - 1)
    pth = sorted_l.gather(-1, cutoff[:, None])
    return torch.where((top_p < 1.0)[:, None] & (logits < pth), neg_inf,
                       logits)


def _process_logits_tokens(logits, temperature, top_k, top_p):
    """:func:`_process_logits_rows` over the speculative verify's
    ``[B, S, V]`` logits: each slot's parameters apply to all of its S
    positions (row-major, slot b's position s is row ``b * S + s``).
    Returns the filtered logits, same shape."""
    B, S, V = logits.shape
    rows = _process_logits_rows(
        logits.reshape(B * S, V), temperature.repeat_interleave(S),
        top_k.repeat_interleave(S), top_p.repeat_interleave(S))
    return rows.reshape(B, S, V)


def sample_rows(logits, do_sample, temperature, top_k, top_p, keys,
                any_sample: bool):
    """One token per row of ``logits [B, V]``: greedy rows take the
    argmax; sampling rows draw ``jax.random.categorical(key, filtered)``
    over their filtered logits with ``keys``, the pair of ``[B]`` threefry
    key words of ``fold_in(key(seed), position)``
    (:func:`..core.threefry.fold_in`).  That is the draw of the JAX
    package's ``_next_tokens``, bit for bit, so a stream is a function of
    (seed, position) alone and the JAX engine's for the same seed.
    ``any_sample`` is the host's knowledge that some row samples: without
    it the [B, V] sort and draw are skipped (and ``keys`` may be None).
    Returns int64 ``[B]``."""
    greedy = logits.argmax(dim=-1)
    if not any_sample:
        return greedy
    filtered = _process_logits_rows(logits.float(), temperature, top_k,
                                    top_p)
    drawn = threefry.categorical(keys, filtered)
    return torch.where(do_sample, drawn, greedy)


def _choose(logits, do_sample, temperature, top_k, top_p, key):
    """One token per row: the argmax (the first index on ties, as
    ``jnp.argmax``), or ``categorical(key, filtered)`` with one key for
    the whole ``[B, V]`` draw."""
    if not do_sample:
        return logits.argmax(dim=-1)
    filtered = _process_logits(logits.float(), temperature, top_k, top_p)
    return threefry.categorical_shaped(key, filtered)


def _carry(caches, new_caches) -> None:
    """Bring a step's advanced paged views back into the caches the
    program reads (their lengths, in place); static caches advance their
    own."""
    for c, nc in zip(caches, new_caches):
        if nc is not c:
            c.seq_lens.copy_(nc.seq_lens)


def _decode_step(model, caches, prompt_len, do_sample, temperature, top_k,
                 top_p, eos_token_id):
    """The body of the whole-generation program (the JAX ``lax.scan``
    body) as a ``Program`` function: inputs ``logits`` ``[B, V]`` float32
    (the last position's), ``step`` ``[1]`` int64, ``finished`` ``[B]``
    bool and the key words ``k1``, ``k2``; output ``tokens`` ``[B, n]``.
    It reads nothing from the host."""
    def fn(inputs, outputs):
        step = inputs["step"]
        key = threefry.fold_in((inputs["k1"], inputs["k2"]), step[0]) \
            if do_sample else None
        nxt = _choose(inputs["logits"], do_sample, temperature, top_k,
                      top_p, key)
        if eos_token_id is not None:
            finished = inputs["finished"]
            nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                              nxt)
            finished.copy_(finished | (nxt == eos_token_id))
        outputs["tokens"].index_copy_(1, step, nxt[:, None])
        logits, new = model.forward_with_cache(nxt[:, None], caches,
                                               pos_offset=step + prompt_len)
        _carry(caches, new)
        inputs["logits"].copy_(logits[:, -1].float())
        step.add_(1)
    return fn


class GenerationMixin:
    """``generate`` for a model with ``forward_with_cache(input_ids,
    caches, pos_offset) -> (logits, caches)`` and ``init_caches(
    batch_size, cache_impl=, max_context=)``, ``cfg.max_seq_len``,
    ``device`` and ``dtype``.  After a call, ``last_generate`` says what
    it ran: ``cache_impl``, ``captured`` (the decode step as a CUDA
    graph), ``replays`` of that step and ``steps`` (tokens chosen)."""

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 cache_impl: str = "dense") -> torch.Tensor:
        """Returns ``[B, prompt_len + n]`` token ids (int64, on the
        model's device): the prompt and up to ``max_new_tokens`` new ones.
        After a row produces ``eos_token_id`` it is padded with eos; the
        host loops (``"dense"``, ``"paged_eager"``) stop once every row
        has, the captured program (``"static"``, ``"paged"``) runs all
        ``max_new_tokens`` steps.  Puts the model in eval mode and back."""
        if cache_impl not in CACHE_IMPLS:
            raise ValueError(f"cache_impl {cache_impl!r} not in "
                             f"{CACHE_IMPLS}")
        was_training = self.training
        self.eval()
        try:
            ids = torch.as_tensor(np.asarray(input_ids) if not
                                  isinstance(input_ids, torch.Tensor)
                                  else input_ids)
            ids = ids.to(device=self.device, dtype=torch.int64)
            if ids.dim() == 1:
                ids = ids[None, :]
            if cache_impl in ("static", "paged"):
                return self._compiled_generate(
                    ids, max_new_tokens, do_sample, temperature, top_k,
                    top_p, eos_token_id, cache_impl)
            return self._host_generate(
                ids, max_new_tokens, do_sample, temperature, top_k, top_p,
                eos_token_id, "paged" if cache_impl == "paged_eager"
                else "dense")
        finally:
            if was_training:
                self.train()

    def _key(self):
        k1, k2 = _random.next_key()
        return k1.to(self.device), k2.to(self.device)

    def _host_generate(self, ids, max_new_tokens, do_sample, temperature,
                       top_k, top_p, eos_token_id, cache_impl):
        B, prompt_len = ids.shape
        caches = self.init_caches(B, cache_impl=cache_impl)
        logits, caches = self.forward_with_cache(ids, caches, pos_offset=0)
        logits = logits[:, -1, :]
        out = [ids]
        finished = torch.zeros((B,), dtype=torch.bool, device=ids.device)
        for step in range(max_new_tokens):
            nxt = _choose(logits, do_sample, temperature, top_k, top_p,
                          self._key() if do_sample else None)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(
                    nxt, eos_token_id), nxt)
                finished = finished | (nxt == eos_token_id)
            out.append(nxt[:, None])
            if eos_token_id is not None and bool(finished.all()):
                break
            logits, caches = self.forward_with_cache(
                nxt[:, None], caches, pos_offset=prompt_len + step)
            logits = logits[:, -1, :]
        self.last_generate = dict(cache_impl=cache_impl, captured=False,
                                  replays=0, steps=len(out) - 1)
        return torch.cat(out, dim=1)

    def _compiled_generate(self, ids, max_new_tokens, do_sample,
                           temperature, top_k, top_p, eos_token_id,
                           cache_impl):
        """The prompt once, then the decode step as one program replayed
        ``max_new_tokens`` times (see the module's head).  On the card the
        step is captured BEFORE the prompt runs, while the caches are
        empty (the capture's warm-up run writes position 0, which the
        prompt then overwrites), and the caches are reset after it."""
        from ..inference.graphs import Program
        B, prompt_len = ids.shape
        cap = self.cfg.max_seq_len
        if prompt_len + max_new_tokens > cap:
            # the captured step checks no capacity: check before capture
            # (position embeddings bound both cache kinds), as the JAX
            # package does before compiling
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len ({cap})")
        kw = {"cache_impl": cache_impl}
        if cache_impl == "paged":
            kw["max_context"] = prompt_len + max_new_tokens
        caches = self.init_caches(B, **kw)
        dev = ids.device
        k1, k2 = self._key() if do_sample else threefry.key(
            torch.zeros((), dtype=torch.int64, device=dev))
        inputs = {
            "logits": torch.zeros((B, self.cfg.vocab_size),
                                  dtype=torch.float32, device=dev),
            "step": torch.zeros((1,), dtype=torch.int64, device=dev),
            "finished": torch.zeros((B,), dtype=torch.bool, device=dev),
            "k1": k1.reshape(()).clone(), "k2": k2.reshape(()).clone()}
        outputs = {"tokens": torch.zeros((B, max_new_tokens),
                                         dtype=torch.int64, device=dev)}
        _lengths_on_device(caches)
        prog = Program(_decode_step(self, caches, prompt_len, do_sample,
                                    temperature, top_k, top_p,
                                    eos_token_id), inputs, outputs)
        if prog.cuda and max_new_tokens:
            prog.capture(None)
        _reset(caches)
        logits, new = self.forward_with_cache(ids, caches, pos_offset=0)
        _carry(caches, new)
        _lengths_on_device(caches)
        inputs["logits"].copy_(logits[:, -1].float())
        for _ in range(max_new_tokens):
            prog.replay()
        self.last_generate = dict(cache_impl=cache_impl,
                                  captured=prog.graph is not None,
                                  replays=prog.replays,
                                  steps=max_new_tokens)
        return torch.cat([ids, outputs["tokens"]], dim=1)


def _lengths_on_device(caches) -> None:
    """The static caches' lengths from now on only on the card (the
    decode step's mode; paged views keep theirs there always)."""
    for c in caches:
        if isinstance(c, StaticKVCache):
            c.on_device()


def _reset(caches) -> None:
    """Empty the caches (after the capture's warm-up run wrote into them),
    the static caches' lengths back on the host for the prompt."""
    for c in caches:
        if isinstance(c, StaticKVCache):
            c.reset()
        else:
            c.seq_lens.zero_()
