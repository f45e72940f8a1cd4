"""Draft/verify speculative decoding on the serving engine's tick.

Counterpart of ``paddle_tpu/inference/speculative.py``.  One tick
(:func:`build_spec_tick`) serves one card and a tensor-parallel rank
alike: over a rank's ``tp.TPShardModel`` it is the JAX
``build_tp_spec_tick`` (a draft model) or ``build_tp_hostdraft_tick``
(n-gram proposals), the verify forward on the rank's heads.  A proposer
offers ``k`` tokens per slot, the target model judges all of them in ONE
k-row chunk forward through ``PagedVerifyKernelView`` (the
``paged_chunk`` kernel at each slot's length), and per-slot accept masks
keep the stream lossless (Leviathan et al. 2023 rejection sampling).
Two proposers:

* a draft MODEL (:func:`draft_phase`): k decode steps over the
  draft's own paged pools, indexed by the SAME block tables as the
  target's, so one allocator, one refcount and one prefix path cover
  both models;
* the host's n-gram table (``inference/drafting.py``): the k tokens
  come in from the host, and the proposal is the point mass
  ``one_hot(d)``.

The verify chunk is ``[last, d_1 .. d_{k-1}]``: position j's logits
judge ``d_{j+1}``.  With ``a`` leading accepts a slot emits ``m = 1 +
min(a, k - 1)`` tokens, capped at its ``kcap`` (its remaining budget):
the accepted prefix and one token chosen from the target's logits at the
first position not emitted.  Rejected positions roll back by
construction: only the lengths advance by ``m``; the stale writes past
them are masked and overwritten by the next chunk.

Greedy rows accept iff the draft token is the target's argmax, so their
streams equal plain decoding's.  Sampled rows accept ``d`` when ``u *
q(d) <= p(d)`` (``u`` uniform; ``p``, ``q`` the target's and the
draft's filtered distributions) and otherwise draw from ``max(p - q,
0)``.  Every draw comes from ``fold_in(fold_in(key(seed), tag),
position)`` with one tag per stream (draft, accept, residual), so a
sampled stream is a function of the request's seed alone: the JAX
engine's, draw for draw (``core/threefry.py``).

The JAX package compiles each tick as one program; the serving engine
captures it as one (``inference/graphs.py``: a CUDA graph on the card),
and the keys and accept uniforms are computed in it from the lengths on
the card, as in the JAX program, since a chained tick's lengths exist
only there.
"""

from __future__ import annotations

import torch

from ..core import threefry
from ..models.generation import (_process_logits_rows,
                                 _process_logits_tokens)
from ..models.kv_cache import PagedKVCache, PagedVerifyKernelView

__all__ = ["DRAFT_FOLD", "ACCEPT_FOLD", "RESID_FOLD", "keys_at",
           "host_draws", "accept_and_choose", "finish", "draft_phase",
           "verify_logits", "build_spec_tick"]

# disjoint stream tags: fold_in(fold_in(key(seed), TAG), position)
DRAFT_FOLD = 0x51
ACCEPT_FOLD = 0x52
RESID_FOLD = 0x53


def keys_at(seeds, pos, tag):
    """The keys ``fold_in(fold_in(key(seed), tag), position)``: seeds
    ``[B]`` against positions ``[B]`` or ``[B, k]``; a pair of int64
    tensors of the positions' shape."""
    k1, k2 = threefry.fold_in(threefry.key(seeds), tag)
    if pos.dim() == 2:
        k1, k2 = k1[:, None], k2[:, None]
    return threefry.fold_in((k1, k2), pos)


def host_draws(seeds, seq_lens, k):
    """One tick's draws at positions ``seq_lens + j`` (``[B]`` int64
    tensors, on the host or in the tick's program on the card): the accept
    uniforms ``[B, k]`` and the residual keys (a ``[2, B, k]`` tensor)."""
    pos = seq_lens[:, None] + torch.arange(k, device=seq_lens.device)
    u = threefry.uniform(keys_at(seeds, pos, ACCEPT_FOLD))
    return u, torch.stack(keys_at(seeds, pos, RESID_FOLD))


def accept_and_choose(tlogits, dtoks, dprobs, do_sample, temperature,
                      top_k, top_p, u, resid_keys, any_sample: bool):
    """Accept masks and token choice over one verify forward.

    tlogits ``[B, S >= k, V]`` (position j judges ``d_{j+1}``; the first k
    positions are read); dtoks ``[B, k]``; dprobs ``[B, k, V]`` the
    draft's filtered softmax (``one_hot(dtoks)`` for a host draft; None
    when no row samples); ``u [B, k]`` the accept uniforms and
    ``resid_keys`` the residual draws' keys (:func:`host_draws`; None
    when no row samples).  ``any_sample`` is the host's knowledge that some row
    samples: without it the [B, k, V] filters and draws are skipped.
    Returns ``(chosen [B, k], m [B], a [B], new_last [B])``: the tokens
    chosen at each position, the emitted count ``1 + min(a, k - 1)``, the
    leading-accept count and the token at the new head.  Callers mask
    inactive rows."""
    B, k = dtoks.shape
    tl = tlogits[:, :k]
    t_greedy = tl.argmax(dim=-1)
    acc = dtoks == t_greedy
    corr = t_greedy
    if any_sample:
        p = torch.softmax(_process_logits_tokens(
            tl.float(), temperature, top_k, top_p), dim=-1)
        pd = p.gather(-1, dtoks[..., None])[..., 0]
        qd = dprobs.gather(-1, dtoks[..., None])[..., 0]
        # u < p(d) / q(d) without the division (d was drawn from q)
        acc_s = u * qd <= pd
        resid = (p - dprobs).clamp_min(0.0)
        # an all-zero residual after a rejection needs p == q, where the
        # accept is certain; in floats it can happen: draw from p then
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, p)
        corr_s = threefry.categorical((resid_keys[0], resid_keys[1]),
                                      torch.log(resid))
        ds = do_sample[:, None]
        acc = torch.where(ds, acc_s, acc)
        corr = torch.where(ds, corr_s, corr)
    chosen = torch.where(acc, dtoks, corr)
    a = acc.long().cumprod(dim=1).sum(dim=1)
    m = 1 + a.clamp_max(k - 1)
    new_last = chosen.gather(1, (m - 1)[:, None])[:, 0]
    return chosen, m, a, new_last


def finish(tlogits, dtoks, dprobs, samp, seq_lens, kcap, u, resid_keys,
           any_sample: bool):
    """The accept tail of both spec ticks: the emitted count capped at
    each slot's ``kcap`` (a short-budget slot emits at most its remaining
    budget while the others ride the full k), inactive rows (length 0)
    masked.  ``samp`` is ``(do_sample, temperature, top_k, top_p)`` on
    the card.  Returns ``(chosen [B, k], counts [B], accepts [B])``."""
    chosen, m, a, _ = accept_and_choose(tlogits, dtoks, dprobs, *samp, u,
                                        resid_keys, any_sample)
    m = torch.minimum(m, kcap.clamp_min(1))
    active = seq_lens > 0
    zero = torch.zeros_like(m)
    return chosen, torch.where(active, m, zero), torch.where(active, a, zero)


def draft_phase(draft, dpools, bs, tables, seq_lens, last_tok, samp,
                draft_keys, any_sample: bool, k: int):
    """k decode steps of the draft model over its own pools: one
    proposed token per slot a step, greedy or drawn with the keys
    ``draft_keys [2, k, B]`` (tag ``DRAFT_FOLD`` at each step's length).
    Free slots (length 0) stay at 0 and write the pad block.  Returns
    ``(dtoks [B, k], dprobs [B, k, V] or None)``: the draft's filtered
    softmax, which the accept test needs only when a row samples."""
    do_s, temp, topk, topp = samp
    lens, last = seq_lens, last_tok
    toks, probs = [], []
    for j in range(k):
        views = [PagedKVCache.from_parts(kk, vv, tables, lens, bs)
                 for kk, vv in dpools]
        logits, _ = draft.forward_with_cache(last[:, None], views,
                                             pos_offset=lens[:, None])
        logits = logits[:, -1]
        nxt = logits.argmax(dim=-1)
        if any_sample:
            filt = _process_logits_rows(logits.float(), temp, topk, topp)
            drawn = threefry.categorical(
                (draft_keys[0, j], draft_keys[1, j]), filt)
            nxt = torch.where(do_s, drawn, nxt)
            probs.append(torch.softmax(filt, dim=-1))
        active = lens > 0
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        lens = torch.where(active, lens + 1, torch.zeros_like(lens))
        last = nxt
        toks.append(nxt)
    return (torch.stack(toks, dim=1),
            torch.stack(probs, dim=1) if any_sample else None)


def verify_logits(model, pools, bs, tables, seq_lens, last_tok, dtoks):
    """The target's k-row verify forward: the chunk ``[last, d_1 ..
    d_{k-1}]`` at each slot's length through ``PagedVerifyKernelView``
    (writes at positions ``n .. n + k - 1``; the max emit ``m = k`` needs
    no more).  Returns the logits ``[B, k, V]``."""
    chunk = torch.cat([last_tok[:, None], dtoks[:, :-1]], dim=1)
    views = [PagedVerifyKernelView.from_parts(kk, vv, tables, seq_lens, bs)
             for kk, vv in pools]
    logits, _ = model.forward_with_cache(chunk, views,
                                         pos_offset=seq_lens[:, None])
    return logits


def build_spec_tick(model, pools, draft, dpools, bs: int, k: int,
                    sampled: bool):
    """The serving engine's spec program function (``inference/graphs.py``
    ``Program``): the counterparts of the JAX ``build_spec_tick`` (the
    draft model's k steps; ``draft`` given) and ``build_hostdraft_tick``
    (the host's proposals ``dtoks``; ``draft`` None), then the verify and
    the accept tail.  Every key and uniform comes from the lengths on the
    card (a chained tick's exist only there).  The new lengths and last
    tokens go back into the inputs."""
    def spec(i, o):
        tables, lens, last = i["tables"], i["lens"], i["last"]
        samp = (i["do_s"], i["temp"], i["topk"], i["topp"])
        u = resid_keys = draft_keys = None
        if sampled:
            seeds, base = i["seeds"], lens.long()
            u, resid_keys = host_draws(seeds, base, k)
            if draft is not None:
                draft_keys = torch.stack([
                    torch.stack(keys_at(seeds, base + j, DRAFT_FOLD))
                    for j in range(k)], dim=1)
        if draft is not None:
            dt, dprobs = draft_phase(draft, dpools, bs, tables, lens, last,
                                     samp, draft_keys, sampled, k)
        else:
            dt = i["dtoks"]
            # a host proposal is the point mass at its token
            dprobs = torch.zeros(
                dt.shape + (model.cfg.vocab_size,),
                dtype=torch.float32, device=dt.device).scatter_(
                    -1, dt[..., None], 1.0) if sampled else None
        logits = verify_logits(model, pools, bs, tables, lens, last, dt)
        chosen, counts, accepts = finish(
            logits, dt, dprobs, samp, lens, i["kcap"], u, resid_keys,
            sampled)
        new_last = chosen.gather(1, (counts.clamp_min(1) - 1)[:, None])
        o["out"].copy_(torch.cat([chosen, counts[:, None],
                                  accepts[:, None]], dim=1))
        i["last"].copy_(torch.where(lens > 0, new_last[:, 0],
                                    torch.zeros_like(new_last[:, 0])))
        i["lens"].copy_(lens + counts)
    return spec
