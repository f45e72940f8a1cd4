"""Refcounted prompt-prefix index over the serving block table.

Counterpart of ``paddle_tpu/inference/prefix_cache.py`` (a copy: the port
imports nothing of the JAX package).  Most serving traffic shares a long
system prompt, and the KV of a prompt PREFIX is a function of the prefix
tokens alone (causal attention), so the prefill of a resident prefix is
a copy of block-table entries, not a forward pass.

* The unit of sharing is one FULL physical block of ``block_size``
  tokens.  An entry maps a hash CHAIN over the prompt's blocks,
  ``h_i = blake2b(h_{i-1} || int64 token bytes of block i)`` (digest 16
  bytes, the JAX package's chain byte for byte), to the physical block
  holding those tokens' KV.  A chain entry means "this exact prefix".
* Blocks are REFCOUNTED by the engine (table references plus one per
  entry).  The index never frees a block itself: eviction drops the
  entry's reference through the engine's callback, and the engine frees
  the block when no reference is left.
* Entries are evicted leaf-first in LRU order (a parent counts its
  children; only childless entries are evictable).
* Registered blocks are never written again: the engine registers only
  blocks whose every position is a prompt token, and copies on write a
  shared block it must write into.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["PrefixCache", "Match"]

# the JAX package's export format, by name: an index exported by one
# engine reads in the other
SCHEMA = "paddle_tpu" + ".prefix/v1"


class _Entry:
    __slots__ = ("block", "parent", "children")

    def __init__(self, block: int, parent: Optional[bytes]):
        self.block = int(block)
        self.parent = parent
        self.children = 0


def _chain(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class Match:
    """One lookup's result: the resident chain's physical blocks plus
    the chain hashes, so a later :meth:`PrefixCache.register` of the
    same prompt resumes the chain instead of re-hashing it."""

    __slots__ = ("blocks", "hashes")

    def __init__(self):
        self.blocks: List[int] = []
        self.hashes: List[bytes] = []


class PrefixCache:
    """Hash-chain index of shared prompt-prefix blocks.

    The engine owns block refcounts; the cache calls ``deref`` (engine
    callback) when an entry is evicted and reports how many blocks that
    actually freed."""

    def __init__(self, block_size: int):
        self.bs = int(block_size)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._block_arr = None   # lazy cache for reclaimable()
        # bumped on every entry eviction: lookup results (Match) cached
        # across deferred-admission retries are valid only within one
        # epoch — a freed-and-reallocated block must never be aliased
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.blocks_shared = 0
        self.evictions = 0

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt_ids: Sequence[int]) -> Match:
        """Longest resident chain of full-block prefixes of the prompt:
        returns a :class:`Match` with the physical block ids in prefix
        order (and the chain hashes, for register() to resume).
        Matched entries (and their ancestors, by construction) are
        LRU-touched."""
        out = Match()
        h = b""
        for i in range(len(prompt_ids) // self.bs):
            h = _chain(h, prompt_ids[i * self.bs:(i + 1) * self.bs])
            ent = self._entries.get(h)
            if ent is None:
                break
            self._entries.move_to_end(h)
            out.blocks.append(ent.block)
            out.hashes.append(h)
        return out

    def resident_blocks(self) -> List[int]:
        return [e.block for e in self._entries.values()]

    def reclaimable(self, block_rc: "np.ndarray") -> int:
        """Blocks held ONLY by the index (refcount 1): freeable on
        demand by :meth:`evict`, so the engine counts them as free
        capacity in its accounting.  Called per tick (occupancy gauge,
        flight records), so it is one vectorized numpy read over a
        lazily rebuilt block-id array — not a Python loop."""
        if self._block_arr is None:
            self._block_arr = np.fromiter(
                (e.block for e in self._entries.values()), np.int64,
                count=len(self._entries))
        if not self._block_arr.size:
            return 0
        return int(np.count_nonzero(block_rc[self._block_arr] == 1))

    # ---------------------------------------------------------- persistence
    def export_state(self) -> dict:
        """The index as a serializable structure: entries in CHAIN-DEPTH
        order (every parent precedes its children, so import can rebuild
        the child counters in one pass) with hex hashes and the
        exporting engine's physical block ids.  Block ids are only
        meaningful next to the exported block CONTENTS — the engine's
        export bundles both and import remaps ids onto freshly
        allocated blocks."""
        depth: dict = {}
        for h, ent in self._entries.items():
            d, cur = 0, ent.parent
            while cur is not None:
                d += 1
                cur = self._entries[cur].parent
            depth[h] = d
        order = sorted(self._entries.items(), key=lambda kv: depth[kv[0]])
        return {"schema": SCHEMA,
                "block_size": self.bs,
                "entries": [{"hash": h.hex(),
                             "parent": (e.parent.hex()
                                        if e.parent else None),
                             "block": e.block} for h, e in order]}

    def import_state(self, state: dict, alloc: Callable[[], Optional[int]],
                     assign: Callable[[int, int], None]) -> int:
        """Rebuild an exported index into this (empty) cache.

        ``alloc()`` returns a fresh physical block id — the entry's one
        index reference, drawn through the engine's ordinary
        ``_alloc_block`` path — or None when the pool has no room (the
        import stops; index blocks are reclaimable-on-demand, so a
        partial import is just a smaller warm set).  ``assign(old, new)``
        tells the caller to install the exported block ``old``'s KV
        contents into physical block ``new``.  Entries whose parent was
        not imported (capacity cut, or a parent the exporter already
        evicted) are SKIPPED — the chain invariant (no orphan-parent
        entries) survives any truncation.  Returns entries imported."""
        if int(state.get("block_size", -1)) != self.bs:
            raise ValueError(
                f"prefix export block_size {state.get('block_size')} != "
                f"engine block_size {self.bs}")
        n = 0
        for rec in state["entries"]:
            parent = (bytes.fromhex(rec["parent"])
                      if rec.get("parent") else None)
            if parent is not None and parent not in self._entries:
                continue
            h = bytes.fromhex(rec["hash"])
            if h in self._entries:
                continue
            blk = alloc()
            if blk is None:
                break
            ent = _Entry(blk, parent)
            if parent is not None:
                self._entries[parent].children += 1
            self._entries[h] = ent
            self._block_arr = None
            assign(int(rec["block"]), blk)
            n += 1
        return n

    # ------------------------------------------------------------ mutations
    def register(self, prompt_ids: Sequence[int], blocks: Sequence[int],
                 ref: Callable[[int], None],
                 match: Optional[Match] = None) -> int:
        """Walk the prompt's full blocks; add an index entry (taking one
        reference via ``ref``) for each chain position not yet present.
        ``blocks[i]`` is the physical block the caller's table holds at
        column i.  Existing entries are KEPT (their block may differ
        from the caller's — a copy-on-write column keeps the original as
        the shared one).  ``match`` (this prompt's lookup() result)
        supplies the already-computed chain hashes for its depth, so an
        admission hashes each block at most once.  Returns the number of
        new entries."""
        added = 0
        h = b""
        for i in range(min(len(prompt_ids) // self.bs, len(blocks))):
            parent = h
            if match is not None and i < len(match.hashes):
                h = match.hashes[i]
            else:
                h = _chain(h, prompt_ids[i * self.bs:(i + 1) * self.bs])
            ent = self._entries.get(h)
            if ent is not None:
                self._entries.move_to_end(h)
                continue
            ent = _Entry(blocks[i], parent or None)
            if parent:
                par = self._entries.get(parent)
                if par is None:
                    # the parent chain was evicted mid-walk (cannot
                    # happen from the engine's single thread, but keep
                    # the invariant: no orphan-parent entries)
                    break
                par.children += 1
            self._entries[h] = ent
            self._block_arr = None
            ref(ent.block)
            added += 1
        return added

    def evict(self, want_blocks: int, deref: Callable[[int], bool],
              freeable: Optional[Callable[[int], bool]] = None) -> int:
        """Free up to ``want_blocks`` physical blocks by dropping index
        entries, leaf-first in LRU order.  ``deref`` releases one block
        reference and returns True iff the block became free;
        ``freeable`` pre-checks whether dropping the entry's reference
        WOULD free the block — entries whose block is still referenced
        by a running request are SKIPPED, not destroyed: deleting them
        frees no capacity (index-only blocks are already counted as
        reclaimable), it would only throw away a hot prefix.

        One forward pass evicts every current freeable leaf in LRU
        order (O(n), not a rescan per victim); entries whose children
        were all just evicted become leaves for the NEXT pass, so deep
        chains unwind in at most chain-depth passes — and only while
        still short."""
        freed = 0
        progress = True
        while freed < want_blocks and progress:
            progress = False
            for h in list(self._entries.keys()):   # oldest-first
                if freed >= want_blocks:
                    break
                ent = self._entries.get(h)
                if ent is None or ent.children:
                    continue
                if freeable is not None and not freeable(ent.block):
                    continue
                del self._entries[h]
                self._block_arr = None
                self.epoch += 1
                if ent.parent:
                    par = self._entries.get(ent.parent)
                    if par is not None:
                        par.children -= 1
                self.evictions += 1
                progress = True
                if deref(ent.block):
                    freed += 1
        return freed
