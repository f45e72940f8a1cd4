"""Paged KV caches for serving.

Counterpart of ``paddle_tpu/models/kv_cache.py:98-306``.  A cache view
holds one layer's pools ``[nh, num_blocks, bs, hd]`` (block 0 is the pad
block), the block tables ``[B, max_blocks]`` int32 and the lengths ``[B]``
int32.  The JAX views are immutable and ``update_and_attend`` returns new
arrays; here the pools are written IN PLACE and the returned view shares
them, with the lengths advanced.

Head dims the port's kernels do not take (``plain_route``: outside 64,
128, 256) attend on the card through the kernels' plain versions, counted
in each wrapper's ``plain_calls``.  The JAX package does the same for its
flash prefill (a jnp oracle), but its paged kernels take any head dim:
there the plain route is a gap of the port's paged kernels (ROADMAP.md).

``StaticKVCache`` and the host-side ``BlockKVCache`` of the JAX package
belong to a later slice.
"""

from __future__ import annotations

import torch

from ..ops import flash_attention, paged_attention as pa

__all__ = ["PagedKVCache", "PagedChunkView", "PagedChunkKernelView"]


class PagedKVCache:
    """Paged cache view: ``s == 1`` writes the token and runs the
    ``paged_decode`` kernel; ``s > 1`` is a prefill from EMPTY sequences
    (the caller's contract, as in the JAX package): a bulk write and
    causal attention within the chunk through the ``flash_fwd`` kernel.
    Appending several tokens to non-empty sequences is
    :class:`PagedChunkView`'s job.  A head dim the kernels do not take
    attends through their plain versions, counted in ``plain_calls``: for
    decode a gap of the port's ``paged_decode``, where the JAX package's
    decode kernel takes any head dim."""

    def __init__(self, batch: int, max_context: int, num_heads: int,
                 head_dim: int, dtype=torch.float32, block_size: int = 64,
                 device=None):
        """A fresh pool for ``batch`` sequences of ``max_context`` tokens:
        sequence b owns blocks ``1 + b * nb .. (b + 1) * nb``."""
        nb = -(-max_context // block_size)
        self.bs = block_size
        self.k = torch.zeros((num_heads, batch * nb + 1, block_size,
                              head_dim), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.tables = (1 + torch.arange(batch * nb, dtype=torch.int32,
                                        device=device)).reshape(batch, nb)
        self.seq_lens = torch.zeros((batch,), dtype=torch.int32,
                                    device=device)

    @classmethod
    def from_parts(cls, k, v, tables, seq_lens, block_size):
        """A view over existing pools (the serving engine's per-call
        views)."""
        c = cls.__new__(cls)
        c.k, c.v, c.tables, c.seq_lens, c.bs = k, v, tables, seq_lens, \
            block_size
        return c

    def _advanced(self, s):
        return type(self).from_parts(self.k, self.v, self.tables,
                                     self.seq_lens + s, self.bs)

    def update_and_attend(self, q, k, v):
        """q/k/v ``[B, s, nh, hd]``.  Returns ``(view, out [B, s, nh, hd])``."""
        if q.shape[1] == 1:
            pa.paged_write_token(self.k, self.v, self.tables, self.seq_lens,
                                 k[:, 0], v[:, 0])
            new = self._advanced(1)
            attend = pa.paged_attention
            if flash_attention.plain_route(q):
                pa.paged_attention.plain_calls += 1
                attend = pa.paged_attention_reference
            out = attend(q[:, 0].contiguous(), self.k, self.v, self.tables,
                         new.seq_lens)
            return new, out[:, None]
        pa.paged_write_prefill(self.k, self.v, self.tables, k, v)
        return self._advanced(q.shape[1]), _dense_causal(q, k, v)


class PagedChunkView(PagedKVCache):
    """Offset-aware chunk prefill: ``s > 1`` new tokens appended to
    sequences that already hold ``seq_lens`` tokens, attending the cached
    prefix and the chunk.  Token j is written at absolute position
    ``seq_lens + j`` through the table; positions past the table write the
    pad block 0.  Kv heads fewer than the query heads (GQA) are repeated to
    the pool's per-query-head layout before the write.  Decode steps
    (``s == 1``) take the base class's path.

    This view attends with the dense linearized-table math (the JAX
    ``PagedChunkView``'s), the oracle the kernel view is held against;
    the serving engine uses :class:`PagedChunkKernelView`."""

    def update_and_attend(self, q, k, v):
        if q.shape[1] == 1:
            return super().update_and_attend(q, k, v)
        new = self._write_chunk(q, k, v)
        return new, self._attend_chunk(q)

    def _write_chunk(self, q, k, v):
        nh, s = q.shape[2], q.shape[1]
        if k.shape[2] != nh:
            if nh % k.shape[2]:
                raise ValueError(f"kv heads {k.shape[2]} do not divide "
                                 f"query heads {nh}")
            rep = nh // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        nb = self.tables.shape[1]
        pos = self.seq_lens[:, None].long() + torch.arange(
            s, device=q.device)                           # [B, s]
        cols = pos // self.bs
        blk = self.tables.long().gather(1, cols.clamp(0, nb - 1))
        # past the table: the pad block, never a clipped write into the
        # last real block
        blk = torch.where(cols < nb, blk, torch.zeros_like(blk))
        slot = pos % self.bs
        self.k[:, blk, slot] = k.permute(2, 0, 1, 3).to(self.k.dtype)
        self.v[:, blk, slot] = v.permute(2, 0, 1, 3).to(self.v.dtype)
        return self._advanced(s)

    def _attend_chunk(self, q):
        return pa.paged_chunk_attention_reference(q, self.k, self.v,
                                                  self.tables, self.seq_lens)


class PagedChunkKernelView(PagedChunkView):
    """:class:`PagedChunkView` attending through ``paged_chunk_attention``
    (the ``paged_chunk`` kernel on the card).  The write path is
    inherited unchanged.  A head dim the kernel does not take attends
    through ``paged_chunk_attention_reference`` (counted in its
    ``plain_calls``): a gap of the port's kernel, where the JAX package's
    chunk kernel takes any head dim."""

    def _attend_chunk(self, q):
        if flash_attention.plain_route(q):
            pa.paged_chunk_attention.plain_calls += 1
            return super()._attend_chunk(q)
        return pa.paged_chunk_attention(q.contiguous(), self.k, self.v,
                                        self.tables, self.seq_lens)


def _dense_causal(q, k, v):
    """Prefill attention: the prompt is the whole context, so no cache
    read is needed.  The ``flash_fwd`` wrapper, which takes any sequence
    length; a head dim it does not take goes to its plain version (the
    JAX package's jnp oracle), counted in its ``plain_calls``."""
    if flash_attention.plain_route(q):
        flash_attention.flash_attention_fwd.plain_calls += 1
        return flash_attention.flash_attention_fwd_reference(
            q, k, v, causal=True)[0]
    return flash_attention.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True)[0]
