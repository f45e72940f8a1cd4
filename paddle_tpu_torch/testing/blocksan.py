"""blocksan: a shadow ledger of the serving engine's KV block references.

Counterpart of the block-ledger half of ``paddle_tpu/testing/jaxsan.py``
(:class:`BlocksanError` for its ``JaxsanError``).  The engine, built with
``blocksan=True`` (the JAX flag ``enable_jaxsan``), reports every
``_alloc_block`` / ``_ref_block`` / ``_release_block`` to a
:class:`BlockLedger`, and :func:`blocksan_verify` reconciles the ledger
with the engine's own structures at every boundary: a double release
raises where it happens, a reference nothing holds is a leak, a
structural reference the ledger never saw is untracked, and the free
list must be exactly the blocks with no reference.  Blocks the prefix
index registered also carry byte digests (:func:`blocksan_snapshot`),
checked again at every verify: registered blocks are immutable.

The JAX module's other half, the host-buffer shield, guards against
``jax.device_put`` aliasing host arrays that the engine mutates while a
program reads them; the port's programs copy host arrays into their own
static buffers, so it has no counterpart here.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

__all__ = ["BlocksanError", "BlockLedger", "block_ledger",
           "blocksan_snapshot", "blocksan_verify"]


class BlocksanError(RuntimeError):
    """A block-ledger invariant was violated (the loud failure: the
    serving engine's crash-only guard never absorbs it)."""


def _violation(kind: str, message: str) -> None:
    raise BlocksanError(f"blocksan [{kind}]: {message}")


class BlockLedger:
    """The independent book of one engine's block references.
    ``digests`` maps a registered block to the sha1 of its bytes in every
    pool (the draft's too); a digest dies with the block's last
    reference."""

    __slots__ = ("rc", "num_blocks", "digests", "verifies")

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self.rc = np.zeros((num_blocks + 1,), np.int64)
        self.digests: dict = {}
        self.verifies = 0

    def alloc(self, blk: int) -> None:
        if self.rc[blk] != 0:
            _violation(
                "free_list_corrupt",
                f"block {blk} allocated while the ledger still holds "
                f"{int(self.rc[blk])} reference(s): the free list handed "
                "out a live block")
        self.rc[blk] = 1
        self.digests.pop(blk, None)

    def ref(self, blk: int) -> None:
        if self.rc[blk] <= 0:
            _violation(
                "untracked_reference",
                f"block {blk} re-referenced while the ledger holds no "
                "reference: pinning a block nobody owns aliases the free "
                "pool")
        self.rc[blk] += 1

    def release(self, blk: int) -> None:
        if self.rc[blk] <= 0:
            _violation(
                "double_release",
                f"block {blk} released while the ledger holds no "
                "reference: a double release frees a block another "
                "holder still reads")
        self.rc[blk] -= 1
        if self.rc[blk] == 0:
            self.digests.pop(blk, None)


def block_ledger(num_blocks: int, armed: bool) -> Optional[BlockLedger]:
    """A ledger when ``armed``, else None (every call site checks for
    None, so the disarmed engine pays one check per call)."""
    return BlockLedger(num_blocks) if armed else None


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _block_digest(engine, blk: int) -> bytes:
    h = hashlib.sha1()
    for pools in (engine.pools, engine.dpools or ()):
        for kk, vv in pools:
            h.update(_host_bytes(kk[:, blk]))
            h.update(_host_bytes(vv[:, blk]))
    return h.digest()


def blocksan_snapshot(engine) -> None:
    """Digest every prefix-registered block the ledger has no digest for,
    right after registration, when its bytes are right by construction."""
    led = engine._blocksan
    if led is None or engine.prefix is None:
        return
    for blk in engine.prefix.resident_blocks():
        if blk not in led.digests:
            led.digests[blk] = _block_digest(engine, blk)


def blocksan_verify(engine) -> None:
    """The boundary's reconciliation, four invariants:

    1. the engine's ``block_rc`` equals the ledger (no path bypassed the
       accessors);
    2. the free list is exactly the blocks with no reference, without
       duplicates;
    3. the ledger equals the structural count: table rows, chunked
       admissions' shadow rows and one per prefix-index entry;
    4. every registered block still has its registration-time digest.
    """
    led = engine._blocksan
    if led is None:
        return
    led.verifies += 1
    n = engine.num_blocks
    if not np.array_equal(led.rc[1:], engine.block_rc[1:]):
        bad = int(np.nonzero(led.rc[1:] != engine.block_rc[1:])[0][0]) + 1
        _violation(
            "accounting_mismatch",
            f"block {bad}: engine block_rc={int(engine.block_rc[bad])} "
            f"but the ledger saw {int(led.rc[bad])}: a path changed "
            "refcounts without _alloc/_ref/_release_block")
    free = [int(b) for b in engine.free_blocks]
    if len(free) != len(set(free)):
        dup = sorted(b for b in set(free) if free.count(b) > 1)[0]
        _violation("free_list_corrupt",
                   f"block {dup} appears twice in free_blocks: the next "
                   "two allocations alias one block")
    want_free = {b for b in range(1, n + 1) if led.rc[b] == 0}
    if set(free) != want_free:
        ghost = sorted(set(free) ^ want_free)[0]
        _violation(
            "free_list_corrupt",
            f"free_blocks disagrees with the ledger at block {ghost}: "
            f"in the free list={ghost in set(free)}, ledger "
            f"rc={int(led.rc[ghost])}")
    expected = np.zeros((n + 1,), np.int64)
    live = engine.tables[engine.tables > 0]
    np.add.at(expected, live.reshape(-1), 1)
    for req in engine.slot_req:
        row = req._chunk_row if req is not None else None
        if row is not None:
            np.add.at(expected, row[row > 0].reshape(-1), 1)
    if engine.prefix is not None:
        for blk in engine.prefix.resident_blocks():
            expected[blk] += 1
    if not np.array_equal(led.rc[1:], expected[1:]):
        idx = np.nonzero(led.rc[1:] != expected[1:])[0] + 1
        leaks = [int(b) for b in idx if led.rc[b] > expected[b]]
        if leaks:
            b = leaks[0]
            _violation(
                "block_leak",
                f"block {b} holds {int(led.rc[b])} ledger reference(s) "
                f"but only {int(expected[b])} structural holder(s): a "
                "release is missing")
        b = int(idx[0])
        _violation(
            "untracked_reference",
            f"block {b} is referenced by {int(expected[b])} "
            f"structure(s) but the ledger saw {int(led.rc[b])} "
            "acquisition(s): a block id was installed without the "
            "accounting path")
    for blk, digest in list(led.digests.items()):
        if _block_digest(engine, blk) != digest:
            _violation(
                "registered_block_mutation",
                f"prefix-registered block {blk} no longer has its "
                "registration-time bytes: a write landed in an immutable "
                "shared block")
