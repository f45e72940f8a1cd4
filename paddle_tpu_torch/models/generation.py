"""Token choice for serving: row-wise temperature / top-k / top-p
filtering and the per-row sampler.

Counterpart of ``paddle_tpu/models/generation.py:_process_logits_rows``
and of the draw in ``paddle_tpu/inference/serving.py:_next_tokens``.
"""

from __future__ import annotations

import torch

__all__ = ["_process_logits_rows", "sample_rows"]

_MASK32 = 0xFFFFFFFF


def _process_logits_rows(logits, temperature, top_k, top_p):
    """Row-wise filtering: every parameter is a ``[B]`` tensor, so one
    call filters a batch whose rows carry different temperature, top-k and
    top-p.  Rows with ``top_k <= 0`` or ``top_p >= 1`` skip that filter;
    top-p is cut on the already top-k-filtered logits, in the JAX order.

    logits ``[B, V]`` float; temperature, top_p float ``[B]``; top_k int
    ``[B]``.  Returns the filtered logits (removed entries are -inf).
    """
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
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


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 tensors
    holding values in [0, 2^32); every product stays below 2^63."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x6C8E9CF5) & _MASK32
    return x ^ (x >> 16)


def _uniform_rows(seeds, positions, V: int):
    """``[B, V]`` float32 uniforms in (0, 1), a pure function of
    (seed, token position, vocabulary index): the same request draws the
    same numbers at the same position on any device, whatever the batch,
    slot or tick it runs in."""
    row = _mix32((seeds.long() & _MASK32)
                 ^ _mix32((positions.long() * 0x9E3779B1) & _MASK32))
    cols = torch.arange(V, device=row.device, dtype=torch.long)
    bits = _mix32((row[:, None] + cols[None, :] * 0x2545F491) & _MASK32)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_rows(logits, do_sample, temperature, top_k, top_p, seeds,
                positions, any_sample: bool):
    """One token per row of ``logits [B, V]``: greedy rows take the
    argmax; sampling rows draw from their filtered distribution by the
    Gumbel-max trick with the noise of :func:`_uniform_rows`, so a stream
    is a function of (seed, position) alone.  ``any_sample`` is the
    host's knowledge that some row samples: without it the [B, V] sort is
    skipped.  Returns int64 ``[B]``."""
    greedy = logits.argmax(dim=-1)
    if not any_sample:
        return greedy
    filtered = _process_logits_rows(logits.float(), temperature, top_k,
                                    top_p)
    u = _uniform_rows(seeds, positions, logits.shape[-1])
    drawn = (filtered - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(do_sample, drawn, greedy)
