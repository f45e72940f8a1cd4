"""Deterministic fault injection for fault-tolerance testing.

Counterpart of ``paddle_tpu/testing/chaos.py``, with the same sites, so
a test arms one schedule on both packages by name.  Crash-hardened paths
funnel their file opens through :func:`checked_open` and call
:func:`inject`, :func:`nan_payload` and :func:`maybe_delay` at named
sites.  With no fault armed each is one truthiness check.  Tests arm
faults through context managers:

* :func:`truncate_writes` - a file opened for writing whose path contains
  ``match`` takes only the first ``at_byte`` bytes, then raises (a process
  killed mid-``np.savez``).
* :func:`fail_open` - the Nth matching :func:`checked_open` call raises.
* :func:`fail_at` - the Nth :func:`inject(site)` call raises.  The serving
  engine's sites are ``serving.prefill.dispatch`` (every prompt program:
  whole prompts, prefix hits, chunks) and ``serving.tick.dispatch``
  (every decode tick).
* :func:`nan_logits` - non-finite logits for given slots and/or request
  ids at ``serving.prefill`` (a prompt's last row) or ``serving.decode``
  (the host-sampling decode program's rows).
* :func:`delay_at` / :func:`maybe_delay` - stall a site
  (``serving.harvest``) for a fixed time: the hung harvest the engine's
  tick watchdog must catch.
* :func:`flip_bytes` / :func:`truncate_file` - corrupt a file on disk
  (bit rot, a torn tail) for the prefix cache's import to skip.

Each armed fault counts how often it fired (``fires``), so a test can
assert that the injection happened.
"""

from __future__ import annotations

import builtins
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Fault", "checked_open", "inject", "active_faults",
    "truncate_writes", "fail_open", "fail_at",
    "flip_bytes", "truncate_file",
    "nan_logits", "nan_payload", "delay_at", "maybe_delay",
]

_lock = threading.Lock()


class Fault:
    """One armed fault.  ``fires`` counts actual injections."""

    def __init__(self, kind: str, match: str = "", at_byte: int = 0,
                 on_calls: Optional[Sequence[int]] = None,
                 exc_factory: Optional[Callable[[], BaseException]] = None):
        self.kind = kind                # truncate | open | site | nan | delay
        self.match = match
        self.at_byte = at_byte
        # 1-based call numbers that fire; None: every matching call
        self.on_calls = set(on_calls) if on_calls is not None else None
        self.exc_factory = exc_factory or (
            lambda: OSError(f"chaos: injected fault ({kind}:{match})"))
        self.calls = 0
        self.fires = 0

    def should_fire(self) -> bool:
        self.calls += 1
        hit = self.on_calls is None or self.calls in self.on_calls
        if hit:
            self.fires += 1
        return hit


_open_faults: List[Fault] = []
_site_faults: Dict[str, Fault] = {}
_nan_faults: List[Fault] = []
_delay_faults: Dict[str, Fault] = {}


def active_faults() -> int:
    return (len(_open_faults) + len(_site_faults) + len(_nan_faults)
            + len(_delay_faults))


class _TruncatingFile:
    """A file that takes ``at_byte`` bytes, then raises: the write that
    crosses the limit is cut exactly there first, so the file on disk is
    a mid-write crash, not a clean short file."""

    def __init__(self, f, at_byte: int, exc_factory):
        self._f = f
        self._room = at_byte
        self._exc_factory = exc_factory
        self._dead = False

    def write(self, data):
        if self._dead:
            return 0      # the crash already propagated; cleanup writes vanish
        n = len(data)
        if n <= self._room:
            self._room -= n
            return self._f.write(data)
        if self._room > 0:
            self._f.write(data[:self._room])
            self._room = 0
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dead = True
        raise self._exc_factory()

    def seek(self, *a, **kw):
        if self._dead or self._f.closed:
            return 0      # zipfile's cleanup after the crash
        return self._f.seek(*a, **kw)

    def tell(self):
        if self._dead or self._f.closed:
            return 0
        return self._f.tell()

    def flush(self):
        if not (self._dead or self._f.closed):
            self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __getattr__(self, name):
        return getattr(self._f, name)


def checked_open(path, mode: str = "rb", **kw):
    """``open`` with the armed file faults applied."""
    if _open_faults:
        spath = os.fspath(path)
        with _lock:
            for fault in list(_open_faults):
                if fault.match not in spath:
                    continue
                if fault.kind == "open":
                    if fault.should_fire():
                        raise fault.exc_factory()
                elif fault.kind == "truncate" and any(
                        c in mode for c in "wxa+"):
                    if fault.should_fire():
                        return _TruncatingFile(
                            builtins.open(path, mode, **kw),
                            fault.at_byte, fault.exc_factory)
    return builtins.open(path, mode, **kw)


def inject(site: str) -> None:
    """Raise at an instrumented site if a fault is armed there."""
    if not _site_faults:
        return
    with _lock:
        fault = _site_faults.get(site)
        fire = fault is not None and fault.should_fire()
    if fire:
        raise fault.exc_factory()


@contextmanager
def _armed(registry, fault, key=None):
    with _lock:
        if key is None:
            registry.append(fault)
        elif key in registry:
            raise RuntimeError(f"chaos: site {key!r} already armed")
        else:
            registry[key] = fault
    try:
        yield fault
    finally:
        with _lock:
            if key is None:
                registry.remove(fault)
            else:
                registry.pop(key, None)


def truncate_writes(match: str, at_byte: int,
                    on_calls: Optional[Sequence[int]] = None,
                    exc: type = OSError):
    """Arm a mid-write truncation of files whose path contains ``match``."""
    return _armed(_open_faults, Fault(
        "truncate", match, at_byte, on_calls,
        lambda: exc(f"chaos: write truncated at byte {at_byte} ({match})")))


def fail_open(match: str, on_calls: Optional[Sequence[int]] = None,
              exc: type = OSError):
    """Arm an open-time failure for paths containing ``match`` (1-based
    matching-call numbers in ``on_calls``; None: every call)."""
    return _armed(_open_faults, Fault(
        "open", match, 0, on_calls,
        lambda: exc(f"chaos: open failed ({match})")))


def fail_at(site: str, on_calls: Optional[Sequence[int]] = None,
            exc: type = OSError):
    """Arm :func:`inject(site)` to raise on the given call numbers."""
    return _armed(_site_faults, Fault(
        "site", site, 0, on_calls,
        lambda: exc(f"chaos: injected failure at {site!r}")), site)


def nan_logits(site: str = "", slots: Sequence[int] = (),
               rids: Sequence[int] = (),
               on_calls: Optional[Sequence[int]] = None):
    """Arm non-finite logits for the given slots and/or request ids at
    ``site`` ('' matches every site): the engine's screens call
    :func:`nan_payload` and make a matching row NaN."""
    fault = Fault("nan", site, 0, on_calls)
    fault.slots = set(int(s) for s in slots)
    fault.rids = set(int(r) for r in rids)
    return _armed(_nan_faults, fault)


def nan_payload(site: str, slot: Optional[int] = None,
                rid: Optional[int] = None) -> bool:
    """Should the caller's logits row for (slot, rid) go non-finite?"""
    if not _nan_faults:
        return False
    with _lock:
        for fault in _nan_faults:
            if fault.match and fault.match != site:
                continue
            if (slot in fault.slots) or (rid in fault.rids):
                if fault.should_fire():
                    return True
    return False


def delay_at(site: str, seconds: float,
             on_calls: Optional[Sequence[int]] = None):
    """Arm a wall-clock stall at a :func:`maybe_delay` site."""
    fault = Fault("delay", site, 0, on_calls)
    fault.seconds = float(seconds)
    return _armed(_delay_faults, fault, site)


def maybe_delay(site: str) -> None:
    """Sleep at an instrumented site if a delay is armed there."""
    if not _delay_faults:
        return
    with _lock:
        fault = _delay_faults.get(site)
        fire = fault is not None and fault.should_fire()
        seconds = fault.seconds if fire else 0.0
    if fire:
        time.sleep(seconds)


def flip_bytes(path: str, offset: int, count: int = 1,
               xor: int = 0xFF) -> None:
    """XOR ``count`` bytes at ``offset`` in place (bit rot)."""
    with builtins.open(path, "r+b") as f:
        f.seek(offset)
        data = bytearray(f.read(count))
        if not data:
            raise ValueError(f"{path}: offset {offset} is past EOF")
        for i in range(len(data)):
            data[i] ^= xor
        f.seek(offset)
        f.write(bytes(data))


def truncate_file(path: str, nbytes: int) -> None:
    """Truncate a file on disk to ``nbytes`` (a torn tail)."""
    with builtins.open(path, "r+b") as f:
        f.truncate(nbytes)
