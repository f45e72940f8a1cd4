"""KV caches for generation and serving.

Counterpart of ``paddle_tpu/models/kv_cache.py`` (``StaticKVCache``,
``PagedKVCache`` and its chunk and verify views) and of the host-side
``BlockKVCache`` of ``paddle_tpu/ops/pallas_paged.py:457``.  Each cache
takes ``update_and_attend(q, k, v)`` (``[B, s, nh, hd]``, after RoPE) and
returns ``(cache, out [B, s, nh, hd])``; the models' dense caches are
``(k, v)`` tuples, concatenated in the attention layers.  The JAX caches
are immutable and return new arrays; here the buffers are written IN
PLACE (the paged views return a view over the same pools with the
lengths advanced, the static and block caches return themselves).

- :class:`StaticKVCache`: ``[B, max_len, nh, hd]`` buffers and one length
  for the batch; writes at ``length``, query i attends keys ``<= length +
  i`` (the JAX package's masked einsum, plain XLA there).  Here the
  ``flash_fwd`` kernel computes it: eagerly, with the length known on the
  host, over keys ``[:length + s]`` under flash's end-aligned causal mask
  (exactly the JAX mask); in a captured decode step, with the length only
  on the card, one token against all ``max_len`` keys under the kv mask
  ``arange(max_len) < length + 1`` built on the card, and the length
  advanced there.
- :class:`PagedKVCache`: one layer's pools ``[nh, num_blocks, bs, hd]``
  (block 0 is the pad block), the block tables ``[B, max_blocks]`` int32
  and the lengths ``[B]`` int32; decode through the ``paged_decode``
  kernel, prefill from empty through ``flash_fwd``.
- :class:`BlockKVCache`: the host allocator over a pool (free list,
  blocks owned per sequence, host lengths), decode through
  ``paged_decode``.

Head dims the port's kernels do not take (``plain_route``: outside 64,
128, 256) attend on the card through the kernels' plain versions, counted
in each wrapper's ``plain_calls``.  The JAX package does the same for its
flash prefill (a jnp oracle), but its paged kernels take any head dim:
there the plain route is a gap of the port's paged kernels (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..ops import flash_attention, paged_attention as pa

__all__ = ["StaticKVCache", "PagedKVCache", "PagedChunkView",
           "PagedChunkKernelView", "PagedVerifyKernelView", "BlockKVCache"]


class StaticKVCache:
    """Fixed-capacity cache of one layer: ``k``, ``v`` ``[B, max_len, nh,
    hd]`` and the length of every sequence (one for the batch, the JAX
    cache's), kept on the device in ``length`` (int64, 0-d) and, while
    the host knows it, in ``host_length``.

    With ``host_length`` an int (eager prefill, chunks, eager decode) any
    ``s`` new tokens are written at ``[length, length + s)`` and attend
    keys ``[:length + s]``; past the capacity raises ``ValueError`` as the
    JAX cache does.  With ``host_length`` None (:meth:`on_device`: a
    captured decode step, which must not read the host) one token is
    written at ``length`` with ``index_copy_`` and attends the whole
    buffer under a kv mask built on the card; nothing there checks the
    capacity, so the caller checks ``prompt + new tokens <= max_len``
    first (``GenerationMixin.generate``)."""

    def __init__(self, batch: int, max_len: int, num_heads: int,
                 head_dim: int, dtype=torch.float32, device=None):
        self.k = torch.zeros((batch, max_len, num_heads, head_dim),
                             dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.length = torch.zeros((), dtype=torch.int64, device=device)
        self.host_length = 0

    def reset(self) -> None:
        """Empty again, the length on the host (the buffers keep their
        stale values: nothing reads past the length)."""
        self.length.zero_()
        self.host_length = 0

    def on_device(self) -> None:
        """From now on the length lives only on the card."""
        self.host_length = None

    def update_and_attend(self, q, k, v):
        B, s, L = q.shape[0], q.shape[1], self.k.shape[1]
        if s > L:
            raise ValueError(f"prefill of {s} tokens exceeds cache "
                             f"capacity {L}")
        if self.host_length is not None:
            n = self.host_length
            if n + s > L:
                raise ValueError(f"decode past cache capacity: length {n} "
                                 f"+ {s} new > {L}")
            self.k[:, n:n + s] = k.to(self.k.dtype)
            self.v[:, n:n + s] = v.to(self.v.dtype)
            self.host_length = n + s
            self.length.fill_(n + s)
            # query i at n + i sees keys <= n + i: flash's end-aligned
            # causal mask over the first n + s keys
            return self, _attend(q, self.k[:, :n + s], self.v[:, :n + s],
                                 causal=True)
        if s != 1:
            raise ValueError("a static cache whose length is on the card "
                             f"takes one token a step, got {s}")
        idx = self.length.reshape(1)
        self.k.index_copy_(1, idx, k.to(self.k.dtype))
        self.v.index_copy_(1, idx, v.to(self.v.dtype))
        keys = torch.arange(L, device=self.k.device)
        mask = (keys <= self.length).to(torch.int32).expand(B, L)
        out = _attend(q, self.k, self.v, causal=False,
                      kv_mask=mask.contiguous())
        self.length.add_(1)
        return self, out


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
    through ``paged_chunk_attention_reference`` (counted in the wrapper's
    ``plain_calls``): a gap of the port's kernel, where the JAX package's
    chunk kernel takes any head dim."""

    _attend = staticmethod(pa.paged_chunk_attention)

    def _attend_chunk(self, q):
        if flash_attention.plain_route(q):
            self._attend.plain_calls += 1
            return super()._attend_chunk(q)
        return self._attend(q.contiguous(), self.k, self.v, self.tables,
                            self.seq_lens)


class PagedVerifyKernelView(PagedChunkKernelView):
    """The spec-verify twin of :class:`PagedChunkKernelView`: the k
    candidate positions are an offset-causal chunk on the same kernel,
    attended through ``paged_verify_attention``, which counts its own
    launches and plain routes.  The JAX engine picks this view with
    ``FLAGS_serving_pallas_verify``; the port's engine always does."""

    _attend = staticmethod(pa.paged_verify_attention)


def _attend(q, k, v, causal, kv_mask=None):
    """Attention of q ``[B, s, nh, hd]`` over k, v ``[B, Sk, nh, hd]``
    through the ``flash_fwd`` wrapper (end-aligned causal, or a kv mask),
    which takes any sequence length; a head dim it does not take goes to
    its plain version (the JAX package's jnp oracle), counted in its
    ``plain_calls``."""
    if flash_attention.plain_route(q):
        flash_attention.flash_attention_fwd.plain_calls += 1
        return flash_attention.flash_attention_fwd_reference(
            q, k, v, causal, kv_mask)[0]
    return flash_attention.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        kv_mask)[0]


def _dense_causal(q, k, v):
    """Prefill attention: the prompt is the whole context, so no cache
    read is needed."""
    return _attend(q, k, v, causal=True)


class BlockKVCache:
    """Host-side block allocator and device block pool of one layer
    (``paddle_tpu/ops/pallas_paged.py:457``, the role of the reference's
    block-table manager around ``block_multihead_attention``).

    Pools ``[nh, num_blocks, bs, hd]`` with block 0 the pad block, tables
    ``[B, max_blocks_per_seq]`` int32 and lengths ``[B]`` int32 on the
    device; on the host the free list ``_free`` (popped from the end, so
    block 1 first), each sequence's blocks ``_owned`` and lengths
    ``_lens`` (a mirror: no device read per token).  :meth:`append` writes
    one token per sequence, taking a fresh block when the last one is
    full; :meth:`append_prefill` bulk-inserts a prompt; :meth:`attend`
    runs ``paged_decode``; :meth:`free` returns a sequence's blocks.  Out
    of blocks, or past ``max_blocks_per_seq``, raises ``RuntimeError``."""

    def __init__(self, num_blocks: int, block_size: int, num_heads: int,
                 head_dim: int, batch: int, max_blocks_per_seq: int,
                 dtype=torch.float32, device=None):
        self.bs = block_size
        self.k = torch.zeros((num_heads, num_blocks, block_size, head_dim),
                             dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.tables = torch.zeros((batch, max_blocks_per_seq),
                                  dtype=torch.int32, device=device)
        self.seq_lens = torch.zeros((batch,), dtype=torch.int32,
                                    device=device)
        self._free = list(range(num_blocks - 1, 0, -1))  # block 0 = pad
        self._owned = [[] for _ in range(batch)]
        self._lens = [0] * batch

    def _alloc(self, b: int) -> int:
        if not self._free:
            raise RuntimeError("BlockKVCache: out of physical blocks")
        slot = len(self._owned[b])
        if slot >= self.tables.shape[1]:
            raise RuntimeError(
                f"BlockKVCache: sequence {b} exceeds max_blocks_per_seq="
                f"{self.tables.shape[1]}")
        blk = self._free.pop()
        self._owned[b].append(blk)
        self.tables[b, slot] = blk
        return blk

    def append(self, k_step, v_step):
        """k_step, v_step ``[B, nh, hd]``: one token per sequence."""
        rows, cols = [], []
        for b in range(k_step.shape[0]):
            pos = self._lens[b]
            if pos % self.bs == 0:
                self._alloc(b)
            rows.append(self._owned[b][pos // self.bs])
            cols.append(pos % self.bs)
            self._lens[b] = pos + 1
        dev = self.k.device
        rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        cols = torch.tensor(cols, dtype=torch.int64, device=dev)
        self.k[:, rows, cols] = k_step.transpose(0, 1).to(self.k.dtype)
        self.v[:, rows, cols] = v_step.transpose(0, 1).to(self.v.dtype)
        self.seq_lens.add_(1)

    def append_prefill(self, k, v):
        """Bulk-insert a whole prompt, k, v ``[B, S, nh, hd]``: every
        sequence at one length (the prefill case), one write per block
        column; a start inside a block appends token by token."""
        B, S = k.shape[0], k.shape[1]
        if len(set(self._lens)) != 1:
            raise RuntimeError("append_prefill needs equal sequence lengths")
        start = self._lens[0]
        if start % self.bs != 0:
            for t in range(S):
                self.append(k[:, t], v[:, t])
            return
        nb = -(-S // self.bs)
        pad = nb * self.bs - S
        if pad:
            zeros = k.new_zeros((B, pad) + tuple(k.shape[2:]))
            k = torch.cat([k, zeros], dim=1)
            v = torch.cat([v, zeros.to(v.dtype)], dim=1)
        # [B, nb, bs, nh, hd] -> per block column [nh, B, bs, hd]
        kb = k.reshape(B, nb, self.bs, *k.shape[2:]).permute(3, 0, 1, 2, 4)
        vb = v.reshape(B, nb, self.bs, *v.shape[2:]).permute(3, 0, 1, 2, 4)
        for blk in range(nb):
            rows = torch.tensor([self._alloc(b) for b in range(B)],
                                dtype=torch.int64, device=self.k.device)
            self.k[:, rows] = kb[:, :, blk].to(self.k.dtype)
            self.v[:, rows] = vb[:, :, blk].to(self.v.dtype)
        self._lens = [start + S] * B
        self.seq_lens.fill_(start + S)

    def attend(self, q):
        """q ``[B, nh, hd]`` against each sequence's cached tokens through
        ``paged_decode`` (its plain version for a head dim it does not
        take, counted in ``plain_calls``); ``[B, nh, hd]`` out."""
        attend = pa.paged_attention
        if flash_attention.plain_route(q):
            pa.paged_attention.plain_calls += 1
            attend = pa.paged_attention_reference
        return attend(q.contiguous(), self.k, self.v, self.tables,
                      self.seq_lens)

    def free(self, b: int) -> None:
        """Return sequence b's blocks to the pool."""
        self._free.extend(reversed(self._owned[b]))
        self._owned[b] = []
        self._lens[b] = 0
        self.tables[b] = 0
        self.seq_lens[b] = 0

    def update_and_attend(self, q, k, v):
        """The models' cache call (the JAX models' ``_paged_forward``):
        ``s == 1`` appends and attends through ``paged_decode``; ``s > 1``
        is a prefill from empty sequences (dense causal flash and a bulk
        insert).  A chunk against non-empty sequences raises
        ``NotImplementedError``, as in the JAX models."""
        if q.shape[1] == 1:
            self.append(k[:, 0], v[:, 0])
            return self, self.attend(q[:, 0])[:, None]
        if self._lens and self._lens[0] != 0:
            raise NotImplementedError(
                "chunked prefill against a paged cache; prefill in one "
                "chunk or use cache_impl='dense'")
        self.append_prefill(k, v)
        return self, _dense_causal(q, k, v)
