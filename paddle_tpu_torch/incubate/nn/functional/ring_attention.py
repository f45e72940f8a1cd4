"""Ring attention and Ulysses attention: exact attention over a sequence
split across the ranks of a group.

Counterpart of ``paddle_tpu/incubate/nn/functional/ring_attention.py``.
The JAX module runs one SPMD program under ``shard_map`` over a mesh axis.
The port is process-granular: every rank of a group (the port's
``Group``; by default the sep group of ``fleet.init``'s topology) holds
its slice of the sequence and calls the ``_local`` function with the
group.

- **Ring** (:func:`ring_attention_local`): n hops.  Each hop is one call
  of the flash kernels (``ops/flash_attention.py``: ``flash_fwd``, and in
  the backward ``flash_bwd_dq`` and ``flash_bwd_dkv``) of this rank's
  queries against the key / value chunk resident after i hops, which
  started on rank ``(rank - i) % n``.  A causal rank skips the chunks
  after its own (no launch), runs its own chunk causally (the diagonal:
  the kernels' causal is end-aligned, and a hop's queries and keys are
  equally long) and the earlier chunks in full.  The hops' partial
  outputs, cast to float32, merge by their log-sum-exps.  K and V travel
  together, one exchange a hop with the next rank
  (``spmd_pipeline.ring_permute``).  The forward makes n - 1 exchanges:
  the JAX scan's n-th only brings the buffers home, and its result is
  discarded.  The backward re-runs the ring: each hop's gradients come
  from the backward kernels against the GLOBAL output and log-sum-exp
  (FlashAttention-2's identities hold chunkwise under the global
  normaliser), dq accumulates in float32 at home, and float32 dk / dv
  travel with their chunk.  K and V move n - 1 times, dk / dv n times:
  the n-th exchange brings each chunk's gradient home.
- **Ulysses** (:func:`ulysses_attention_local`): a head all-to-all makes
  the sequence whole on ``H / n`` heads, the port's ``flash_attention``
  runs there, and the reverse all-to-all splits the sequence again
  (``mp_layers.all_to_all``, differentiable).
- **One process** (:func:`ring_attention_chunked`): one ring member's hop
  program with the rotation replaced by a loop over the resident chunks.

Layout: the public functions take ``(batch, heads, seq, head_dim)``; the
kernels run in ``[B, S, nh, hd]``.  GQA: the kv heads travel unexpanded
(the kernels read kv head ``h // (nh // nkv)``).  A custom ``scale`` is
folded into q (the kernels scale by ``1 / sqrt(hd)``).  A head dim no
kernel takes goes, on the card, to the kernels' plain versions, counted
in ``flash_attention_fwd.plain_calls`` (``ops.flash_attention.plain_route``),
where the JAX package takes its jnp online-softmax path; the math is the
same.  ``ring_attention_chunked``'s misaligned chunks take the JAX
module's exact online-softmax path (counted there too).

Not ported: the op-registry registration (the JAX ``_register``): the
port has no op registry until ROADMAP.md A.9, and these functions take
torch tensors and differentiate through torch autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ....distributed.fleet import spmd_pipeline as _pipe
from ....distributed.fleet.mp_layers import all_to_all
from ....distributed.fleet.utils import sequence_parallel_utils as _sp
from ....ops import flash_attention as _fa

__all__ = ["ring_attention_local", "ring_attention",
           "ring_attention_chunked", "ulysses_attention_local",
           "ulysses_attention"]

_NEG = -1e30

# hop kinds: this rank's queries against the resident chunk
_SKIP, _FULL, _DIAG = 0, 1, 2


def _check_gqa(nh: int, nkv: int) -> None:
    if nkv == 0 or nh % nkv:
        raise ValueError(
            f"GQA: num_heads ({nh}) must be a multiple of kv heads "
            f"({nkv})")


def _sep_group(group):
    """``group``, else the sep group of ``fleet.init``'s topology, else
    None (one rank)."""
    if group is not None:
        return group
    from ....distributed.fleet.fleet import _fleet_state
    hcg = _fleet_state["hcg"]
    return None if hcg is None else hcg.get_sep_parallel_group()


def _size_rank(group):
    if group is None or group.nranks == 1:
        return 1, 0
    return group.nranks, group.rank


def _causal_hop_idx(src: int, rank: int) -> int:
    """The hop kind of a causal rank against the chunk that started on
    rank ``src``: earlier chunks in full, its own the diagonal, later
    ones skipped."""
    return _DIAG if src == rank else _FULL if src < rank else _SKIP


def _bhsd_to_bshd(x):
    return x.transpose(1, 2).contiguous()


def _fold_scale(qs, scale):
    D = qs.shape[-1]
    if scale is not None and scale != D ** -0.5:
        qs = qs * (scale * D ** 0.5)
    return qs


# --------------------------------------------------------------- one hop

def _hop_fwd(q, kc, vc, causal):
    """One hop's flash forward: the normalised partial output in float32
    ``[B, Sq, nh, hd]`` and its log-sum-exp ``[B, nh, Sq]``."""
    if _fa.plain_route(q):
        _fa.flash_attention_fwd.plain_calls += 1
        o, lse = _fa.flash_attention_fwd_reference(q, kc, vc, causal)
    else:
        o, lse = _fa.flash_attention_fwd(q, kc, vc, causal)
    return o.float(), lse


def _hop_bwd(q, kc, vc, out, lse, g, causal):
    """One hop's gradients against the global ``out`` and ``lse``, each
    in float32."""
    fn = _fa.flash_attention_bwd_reference if _fa.plain_route(q) else \
        _fa.flash_attention_bwd
    return tuple(t.float() for t in fn(q, kc, vc, out, lse, g, causal))


def _merge(out_a, lse_a, out_b, lse_b):
    """The two-softmax combine of normalised partials ``[B, S, nh, hd]``
    (float32) by their log-sum-exps ``[B, nh, S]``."""
    lse_m = torch.logaddexp(lse_a, lse_b)

    def weight(lse):
        return torch.exp(lse - lse_m).transpose(1, 2)[..., None]
    return out_a * weight(lse_a) + out_b * weight(lse_b), lse_m


def _start(q):
    B, S, nh, hd = q.shape
    return (torch.zeros((B, S, nh, hd), dtype=torch.float32,
                        device=q.device),
            torch.full((B, nh, S), _NEG, dtype=torch.float32,
                       device=q.device))


# ------------------------------------------------------------ the ring

class _Ring(torch.autograd.Function):
    """The ring over ``group`` in ``[B, S, nh, hd]``: the JAX
    ``_ring_core`` with its custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, rank = _size_rank(group)
        out, lse = _start(q)
        kv = torch.stack((k, v))
        for i in range(n):
            if i:
                kv = _pipe.ring_permute(kv, group)
            kind = _causal_hop_idx((rank - i) % n, rank) if causal \
                else _FULL
            if kind != _SKIP:
                out, lse = _merge(out, lse,
                                  *_hop_fwd(q, kv[0], kv[1], kind == _DIAG))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, rank = _size_rank(group)
        g = g.to(out.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        kv = torch.stack((k, v))
        for i in range(n):
            if i:
                kv = _pipe.ring_permute(kv, group)
            kind = _causal_hop_idx((rank - i) % n, rank) if ctx.causal \
                else _FULL
            if kind != _SKIP:
                dq_h, dk_h, dv_h = _hop_bwd(q, kv[0], kv[1], out, lse, g,
                                            kind == _DIAG)
                dq += dq_h
                dkv[0] += dk_h
                dkv[1] += dv_h
            dkv = _pipe.ring_permute(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention_local(q, k, v, group=None, causal: bool = False,
                         scale: Optional[float] = None):
    """Exact attention of this rank's queries over the whole sequence,
    which the ranks of ``group`` (default: ``fleet``'s sep group; None
    and no topology: one rank) hold in order, a slice each.

    q ``(B, H, S_local, D)``, k and v ``(B, H_kv, S_local, D)`` (H a
    multiple of H_kv); returns ``(B, H, S_local, D)``.  Every rank of the
    group calls it with the same shapes, ``causal`` and ``scale``."""
    group = _sep_group(group)
    _check_gqa(q.shape[1], k.shape[1])
    qs, ks, vs = (_bhsd_to_bshd(x) for x in (q, k, v))
    out = _Ring.apply(_fold_scale(qs, scale), ks, vs, group, causal)
    return out.transpose(1, 2)


def _whole(local_fn, q, k, v, group, causal, scale):
    """A ``_local`` function over the whole ``(B, H, S, D)`` tensors that
    every rank passes: this rank's sequence slice in (backward: the
    ranks' slices gathered), the output gathered on S (backward: this
    rank's slice)."""
    group = _sep_group(group)
    n, _ = _size_rank(group)
    if n == 1:
        return local_fn(q, k, v, None, causal, scale)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"the sequence ({q.shape[2]}) must divide by the "
                         f"group size ({n})")
    q, k, v = (_sp.ScatterOp.apply(x, 2, group) for x in (q, k, v))
    return _sp.GatherOp.apply(local_fn(q, k, v, group, causal, scale), 2,
                              group)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None):
    """:func:`ring_attention_local` over whole tensors: every rank of
    ``group`` passes the same ``(B, H, S, D)`` q, k and v (S divisible by
    the group size) and gets the whole output; the gradients that reach
    q, k and v are whole on every rank (the JAX wrapper's global
    arrays)."""
    return _whole(ring_attention_local, q, k, v, group, causal, scale)


# ------------------------------------------- one member, one process

class _Chunked(torch.autograd.Function):
    """One member's query chunk (global chunk index ``ja``, ``[B, C, nh,
    hd]``) against every resident chunk of k and v ``[B, n C, nkv,
    hd]``: the ring's hop program with a loop for the rotation (the JAX
    ``_chunk_core``)."""

    @staticmethod
    def forward(ctx, q, k, v, n_chunks, ja, causal):
        C = k.shape[1] // n_chunks
        out, lse = _start(q)
        for i in range(n_chunks):
            kind = _causal_hop_idx(i, ja) if causal else _FULL
            if kind != _SKIP:
                sl = slice(i * C, (i + 1) * C)
                out, lse = _merge(out, lse, *_hop_fwd(
                    q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                    kind == _DIAG))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_chunks, ctx.ja, ctx.causal = n_chunks, ja, causal
        return out

    @staticmethod
    def backward(ctx, g):
        """Each key chunk's dk / dv come from this member's queries alone;
        dq accumulates in float32."""
        q, k, v, out, lse = ctx.saved_tensors
        C = k.shape[1] // ctx.n_chunks
        g = g.to(out.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(ctx.n_chunks):
            kind = _causal_hop_idx(i, ctx.ja) if ctx.causal else _FULL
            if kind == _SKIP:
                continue
            sl = slice(i * C, (i + 1) * C)
            dq_h, dk[:, sl], dv[:, sl] = _hop_bwd(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), out, lse, g,
                kind == _DIAG)
            dq += dq_h
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _block_update(q, k, v, acc, m, l, q_off, k_off, causal, scale):
    """One online-softmax step on a ``(S_q, S_k)`` block, float32 (the JAX
    ``_block_update``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return acc * alpha[..., None] + pv, m_new, l_new


def _chunked_plain(q, k, v, n_chunks, causal, scale, q_off):
    """The exact online-softmax member program (the JAX ``_chunked_jnp``)
    for chunks the hop program cannot align; one plain call a chunk."""
    rep = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    B, H, Sq, D = q.shape
    C = k.shape[2] // n_chunks
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        if q.device.type != "cpu":
            _fa.flash_attention_fwd.plain_calls += 1
        sl = slice(i * C, (i + 1) * C)
        acc, m, l = _block_update(q, k[:, :, sl], v[:, :, sl], acc, m, l,
                                  q_off, i * C, causal, scale)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def ring_attention_chunked(q, k, v, n_chunks: int, causal: bool = False,
                           scale: Optional[float] = None, q_off: int = 0):
    """One ring member in one process: q ``(B, H, S_q, D)`` is the
    member's query slice, starting at absolute position ``q_off`` (for
    the causal mask); k and v ``(B, H_kv, S_k, D)`` hold the whole
    context, S_k divisible by ``n_chunks``.  The same hop program as
    :func:`ring_attention_local`, the rotation replaced by a loop over
    the resident chunks, when the chunks align (``S_q`` and ``q_off``
    multiples of the chunk, and a causal member within the keys);
    otherwise the exact online-softmax path."""
    _check_gqa(q.shape[1], k.shape[1])
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    C = Sk // n_chunks
    aligned = (C > 0 and Sq % C == 0 and q_off % C == 0
               and (not causal or q_off + Sq <= Sk))
    if not aligned:
        return _chunked_plain(q, k, v, n_chunks, causal,
                              D ** -0.5 if scale is None else scale, q_off)
    qs = _fold_scale(_bhsd_to_bshd(q), scale)
    ks, vs = _bhsd_to_bshd(k), _bhsd_to_bshd(v)
    outs = [_Chunked.apply(qs[:, a * C:(a + 1) * C].contiguous(), ks, vs,
                           n_chunks, q_off // C + a, causal)
            for a in range(Sq // C)]
    return torch.cat(outs, dim=1).transpose(1, 2)


# --------------------------------------------- Ulysses (head all-to-all)

def ulysses_attention_local(q, k, v, group=None, causal: bool = False,
                            scale: Optional[float] = None):
    """Ulysses (segment-parallel) attention: q, k and v ``(B, H, S_local,
    D)`` arrive split on the sequence over ``group`` (default:
    ``fleet``'s sep group); an all-to-all regroups them to ``H / n``
    heads over the whole sequence, the port's flash attention runs
    there, and the reverse all-to-all splits the sequence again.  H and
    the kv heads must divide by the group size.  Returns ``(B, H,
    S_local, D)``."""
    group = _sep_group(group)
    n, _ = _size_rank(group)
    H, nkv = q.shape[1], k.shape[1]
    if H % n or nkv % n:
        raise ValueError(
            f"ulysses_attention: num_heads ({H}) and kv heads ({nkv}) "
            f"must be divisible by the group size ({n}); use "
            "ring_attention instead")
    _check_gqa(H, nkv)
    qs, ks, vs = (_bhsd_to_bshd(all_to_all(x, group, 1, 2))
                  for x in (q, k, v))                 # [B, S, H/n, D]
    qs = _fold_scale(qs, scale)
    if _fa.plain_route(qs):
        _fa.flash_attention_fwd.plain_calls += 1
        out = _fa.flash_attention_fwd_reference(qs, ks, vs, causal)[0]
    else:
        out = _fa.flash_attention(qs, ks, vs, causal)
    return all_to_all(out.transpose(1, 2), group, 2, 1)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      scale: Optional[float] = None):
    """:func:`ulysses_attention_local` over whole tensors, as
    :func:`ring_attention`."""
    return _whole(ulysses_attention_local, q, k, v, group, causal, scale)
