"""Token choice for serving: row-wise temperature / top-k / top-p
filtering and the per-row sampler.

Counterpart of ``paddle_tpu/models/generation.py:_process_logits_rows``
and ``_process_logits_tokens`` (its k-row twin for the speculative
verify), and of the draw in ``paddle_tpu/inference/serving.py:_next_tokens``.
"""

from __future__ import annotations

import torch

from ..core import threefry

__all__ = ["_process_logits_rows", "_process_logits_tokens",
           "sample_rows"]


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
