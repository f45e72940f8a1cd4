"""Atomic, versioned, integrity-checked checkpoints and the resume policy:
counterpart of ``paddle_tpu/distributed/checkpoint/manager.py``, with the
same layout, so either package reads the other's versions:

    root/
      step_00000042.tmp/     while saving (never read)
        0_0.distcp           a rank's data (save_state_dict's layout)
        0.metadata
        extra_0.pkl          the leaves that are not arrays (coordinator)
        manifest_0.json      sha256 and size of each of the rank's files
      step_00000042/         committed: the tmp dir renamed
        ... + COMPLETE       written after every manifest validates

Every rank writes its files and manifest into the tmp dir; the
coordinator waits for every rank's manifest, re-hashes every listed file,
renames tmp to final and only then writes the ``COMPLETE`` sentinel.  A
reader (:func:`verify_version`, :func:`latest_complete`) accepts a version
only if the sentinel exists and every file still matches its manifest, so
truncation, bit flips and torn tails are found, skipped and reported,
never loaded.  :func:`commit_single_rank` is the same protocol for one
process's export (the serving engine's prefix cache).

:class:`CheckpointManager` owns the policy: a save every K steps, an
async save after a synchronous device-to-host snapshot (the caller may
overwrite its tensors once ``save()`` returns), keep-last-N rotation with
periodic keeps, transient-I/O retries with doubling backoff, and
preemption (SIGTERM / SIGINT set a flag; the train loop finishes its
step, takes an emergency checkpoint and stops).  The JAX flags
``ckpt_io_retries``, ``ckpt_io_backoff_s`` and ``ckpt_commit_timeout_s``
are this module's ``IO_RETRIES``, ``IO_BACKOFF_S`` and
``COMMIT_TIMEOUT_S``, at the flags' defaults.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import re
import shutil
import signal as _signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ...testing.chaos import checked_open
from .. import env as _env
from . import save_state_dict as _sd
from .io_retry import call_with_retries
from .load_state_dict import load_state_dict, read_state_dict
from .save_state_dict import ShardedLeaf

__all__ = [
    "CheckpointManager", "latest_complete", "all_steps", "verify_version",
    "step_dir", "COMPLETE_SENTINEL", "MANIFEST_SCHEMA",
    "commit_single_rank",
    "preemption_requested", "request_preemption", "clear_preemption",
]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

COMPLETE_SENTINEL = "COMPLETE"
MANIFEST_SCHEMA = "paddle_tpu_torch.ckpt/v1"   # readers check the files only
IO_RETRIES = 3                              # the JAX flags' defaults
IO_BACKOFF_S = 0.1
COMMIT_TIMEOUT_S = 300.0
_STEP_RE = re.compile(r"^step_(\d{8})$")
_MANIFEST_RE = re.compile(r"^manifest_\d+\.json$")

_M_SAVES = _metrics.counter(
    "ckpt.saves", "checkpoint save outcomes "
    "(result=committed|failed|skipped_existing)")
_M_BYTES = _metrics.counter(
    "ckpt.bytes_written", "checkpoint payload bytes written (data files)")
_M_RETRIES = _metrics.counter(
    "ckpt.io_retries", "transient-I/O retries during checkpoint writes "
    "(labels: site)")
_M_SKIP = _metrics.counter(
    "ckpt.skipped_corrupt", "checkpoint versions skipped by "
    "latest_complete (reason=incomplete|corrupt)")
_M_ROTATED = _metrics.counter(
    "ckpt.rotated", "checkpoint versions deleted by keep-last-N rotation")
_M_PREEMPT = _metrics.counter(
    "preempt.signals", "SIGTERM/SIGINT preemption requests observed")
_H_SAVE_S = _metrics.histogram(
    "ckpt.save_seconds", "wall seconds per committed checkpoint save "
    "(snapshot + write + validate + commit)")
_H_RESTORE_S = _metrics.histogram(
    "ckpt.restore_seconds", "wall seconds per checkpoint restore")


# --------------------------------------------------------------- preemption

_preempt_lock = threading.Lock()
_preempt = {"requested": False, "signum": None}


def preemption_requested() -> bool:
    return _preempt["requested"]


def request_preemption(signum: Optional[int] = None) -> None:
    """Mark the process as preempted (the signal handlers, and tests)."""
    with _preempt_lock:
        first = not _preempt["requested"]
        _preempt["requested"] = True
        _preempt["signum"] = signum
    if first:
        _M_PREEMPT.inc()
        _flight.default_recorder().record_event("preempt_signal",
                                                signum=signum)
        logger.warning("preemption requested (signal %s): will checkpoint "
                       "after the in-flight step and exit", signum)


def clear_preemption() -> None:
    with _preempt_lock:
        _preempt["requested"] = False
        _preempt["signum"] = None


# ----------------------------------------------------------------- layout

def step_dir(step: int) -> str:
    return f"step_{int(step):08d}"


def all_steps(root: str) -> List[int]:
    """Committed-looking version numbers under ``root``, ascending (not
    validated; ``.tmp`` directories are never included)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def _sha256(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _sha256_many(paths: List[str]) -> List[str]:
    """:func:`_sha256` of each path, the files hashed side by side
    (hashlib and file reads release the GIL)."""
    if len(paths) <= 1:
        return [_sha256(p) for p in paths]
    with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)) as pool:
        return list(pool.map(_sha256, paths))


def _write_manifest(path: str, rank: int, step: int,
                    files: List[str]) -> Dict[str, Any]:
    digests = _sha256_many([os.path.join(path, name) for name in files])
    manifest = {"schema": MANIFEST_SCHEMA, "step": int(step),
                "rank": int(rank),
                "files": {name: {"sha256": digest,
                                 "bytes": os.path.getsize(
                                     os.path.join(path, name))}
                          for name, digest in zip(files, digests)}}
    tmp = os.path.join(path, f"manifest_{rank}.json.part")
    with checked_open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, f"manifest_{rank}.json"))
    return manifest


def verify_version(path: str, need_sentinel: bool = True) -> Optional[str]:
    """Check one version directory: None when valid, else the reason.
    Every file of every manifest must exist with its size and sha256."""
    if not os.path.isdir(path):
        return "missing directory"
    if need_sentinel and not os.path.exists(
            os.path.join(path, COMPLETE_SENTINEL)):
        return "no COMPLETE sentinel (uncommitted or interrupted save)"
    manifests = sorted(f for f in os.listdir(path) if _MANIFEST_RE.match(f))
    if not manifests:
        return "no rank manifests"
    # the files before the first other fault, in manifest order, are
    # hashed side by side; the first fault in that order is the reason
    hashed: List[Tuple[str, str, str]] = []
    fault = None
    for mf in manifests:
        try:
            with open(os.path.join(path, mf)) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            fault = f"unreadable manifest {mf}: {type(e).__name__}"
            break
        for name, want in files.items():
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                fault = f"missing file {name}"
            elif os.path.getsize(fp) != want["bytes"]:
                fault = (f"size mismatch for {name}: "
                         f"{os.path.getsize(fp)} != {want['bytes']}")
            if fault is not None:
                break
            hashed.append((name, fp, want["sha256"]))
        if fault is not None:
            break
    digests = _sha256_many([fp for _, fp, _ in hashed])
    for (name, _, want), got in zip(hashed, digests):
        if got != want:
            return f"checksum mismatch for {name}"
    return fault


def latest_complete(root: str,
                    before: Optional[int] = None) -> Optional[int]:
    """The newest step under ``root`` that is committed and valid.
    Partial, uncommitted and corrupt versions are skipped, counted
    (``ckpt.skipped_corrupt``), logged and recorded in the flight
    recorder, never loaded."""
    for step in reversed(all_steps(root)):
        if before is not None and step >= before:
            continue
        path = os.path.join(root, step_dir(step))
        reason = verify_version(path)
        if reason is None:
            return step
        kind = "incomplete" if "sentinel" in reason else "corrupt"
        _M_SKIP.inc(reason=kind)
        _flight.default_recorder().record_event(
            "ckpt_skip_corrupt", step=step, reason=reason)
        logger.warning("skipping checkpoint %s: %s", path, reason)
    return None


def _commit_dir(tmp: str, final: str, step: int, ranks: int) -> None:
    """Rename a validated tmp dir to ``final``, then write the
    sentinel."""
    if os.path.isdir(final):
        shutil.rmtree(final)      # a stale uncommitted leftover
    os.replace(tmp, final)
    with checked_open(os.path.join(final, COMPLETE_SENTINEL), "w") as f:
        json.dump({"step": int(step), "ranks": int(ranks),
                   "committed_unix": time.time()}, f)


def commit_single_rank(root: str, step: int,
                       write_files: Callable[[str], List[str]],
                       retries: int = IO_RETRIES,
                       backoff: float = IO_BACKOFF_S) -> str:
    """Commit one version from a single process: ``write_files`` fills
    ``step_<N>.tmp`` (opening through :func:`checked_open`) and returns the
    file names; then the manifest, a re-hash of every file, the rename and
    the ``COMPLETE`` sentinel.  Transient ``OSError``s retry (a retry starts
    the version again).  Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, step_dir(step) + ".tmp")
    final = os.path.join(root, step_dir(step))

    def attempt():
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_manifest(tmp, 0, step, list(write_files(tmp)))

    call_with_retries(attempt, retries=retries, backoff_s=backoff,
                      site=f"export.step_{step}", counter=_M_RETRIES)
    reason = verify_version(tmp, need_sentinel=False)
    if reason is not None:
        raise ValueError(
            f"export validation failed for step {step}: {reason}")
    call_with_retries(lambda: _commit_dir(tmp, final, step, 1),
                      retries=retries, backoff_s=backoff,
                      site=f"export.commit.step_{step}", counter=_M_RETRIES)
    return final


# ------------------------------------------------------------- tree splits

def _is_array_leaf(v) -> bool:
    return isinstance(v, (torch.Tensor, ShardedLeaf, np.ndarray, np.generic))


def _split_tree(state: Dict) -> Tuple[Dict, Dict]:
    """A nested dict split into (array leaves, everything else).  Arrays
    take the sharded save; the rest is pickled by the coordinator
    (``extra_<rank>.pkl``)."""
    arrays: Dict = {}
    extra: Dict = {}
    for k, v in state.items():
        if isinstance(v, dict):
            a, e = _split_tree(v)
            if a:
                arrays[k] = a
            if e:
                extra[k] = e
        elif _is_array_leaf(v):
            arrays[k] = v
        else:
            extra[k] = v
    return arrays, extra


def _deep_merge(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# ------------------------------------------------------------------ manager

class CheckpointManager:
    """The policy of atomic, versioned checkpoints under one root.

    ``save_interval`` paces :meth:`maybe_save` (every K optimizer steps);
    ``keep_last`` committed versions survive rotation, and so does every
    version whose step is a multiple of ``keep_period`` (0: none).
    ``async_save=True`` snapshots synchronously, then writes and commits
    on a background thread; a failed async save raises at the NEXT
    :meth:`save` or :meth:`wait`.  Every rank of a job saves through its
    own manager on one root; the ``coordinator_rank`` commits once every
    rank's manifest is there (``COMMIT_TIMEOUT_S``); a transient
    ``OSError`` retries (``IO_RETRIES``, ``IO_BACKOFF_S``).

    ``last_save`` describes this rank's newest save once written: its
    ``step``, payload ``bytes``, ``snapshot_s`` (the host copy) and
    ``write_s`` (files, manifest and, on the coordinator, the wait for
    the other ranks, the re-hash and the commit)."""

    def __init__(self, root: str, save_interval: int = 1,
                 keep_last: int = 2, keep_period: int = 0,
                 async_save: bool = False, coordinator_rank: int = 0):
        if save_interval < 0:
            raise ValueError("save_interval must be >= 0")
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.root = str(root)
        self.save_interval = int(save_interval)
        self.keep_last = int(keep_last)
        self.keep_period = int(keep_period)
        self.async_save = bool(async_save)
        self.coordinator_rank = int(coordinator_rank)
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._old_handlers: Dict[int, Any] = {}
        self.last_save: Dict[str, Any] = {}

    # ------------------------------------------------------------ discovery
    def step_path(self, step: int) -> str:
        return os.path.join(self.root, step_dir(step))

    def all_steps(self) -> List[int]:
        return all_steps(self.root)

    def latest_complete(self) -> Optional[int]:
        return latest_complete(self.root)

    # ----------------------------------------------------------------- save
    def wait(self) -> None:
        """Join an async save in flight; re-raise its failure."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "async checkpoint save failed; the newest durable "
                "checkpoint is older than you think") from err

    def maybe_save(self, step: int, state, wait: bool = False) -> bool:
        """Save iff ``step`` is on the save-interval grid.  ``state`` is a
        dict or a callable that returns one (built only on a step that
        saves)."""
        if self.save_interval <= 0 or step % self.save_interval != 0:
            return False
        if callable(state):
            state = state()
        return self.save(step, state, wait=wait)

    def _failed(self, step: int, e: BaseException) -> None:
        _M_SAVES.inc(result="failed")
        _flight.default_recorder().record_event(
            "ckpt_save_failed", step=step,
            error=f"{type(e).__name__}: {e}"[:200])

    def save(self, step: int, state: Dict, wait: bool = False) -> bool:
        """Snapshot ``state`` (synchronously) and commit it as version
        ``step``; False when that version is already committed.  With
        ``async_save`` the write and commit run on a background thread
        unless ``wait=True``."""
        self.wait()     # after the previous async save; surface its error
        if os.path.exists(os.path.join(self.step_path(step),
                                       COMPLETE_SENTINEL)):
            _M_SAVES.inc(result="skipped_existing")
            return False
        t0 = time.perf_counter()
        _flight.default_recorder().record_event("ckpt_save_start", step=step)
        arrays, extra = _split_tree(state)
        # the device-to-host snapshot, synchronous: after plan_save the
        # caller may overwrite every tensor
        plan = _sd.plan_save(arrays)
        extra_blob = pickle.dumps(extra) \
            if plan.rank == self.coordinator_rank else None
        snapshot_s = time.perf_counter() - t0

        if self.async_save and not wait:
            def job():
                try:
                    self._write_version(step, plan, extra_blob, t0,
                                        snapshot_s)
                except BaseException as e:  # noqa: BLE001 - next save()
                    self._error = e
                    self._failed(step, e)
            self._thread = threading.Thread(
                target=job, name=f"ckpt-save-{step}", daemon=True)
            self._thread.start()
            return True
        try:
            self._write_version(step, plan, extra_blob, t0, snapshot_s)
        except BaseException as e:
            self._failed(step, e)
            raise
        return True

    def _write_version(self, step: int, plan: "_sd.SavePlan",
                       extra_blob: Optional[bytes], t0: float,
                       snapshot_s: float) -> None:
        """One rank's write and (coordinator) validation, commit and
        rotation, under the transient-I/O retries."""
        tmp = self.step_path(step) + ".tmp"
        final = self.step_path(step)
        rank = plan.rank
        t_write = time.perf_counter()

        def attempt():
            # a retry restarts this rank's files: nothing of a failed
            # attempt may reach the manifest (the tmp dir is shared)
            os.makedirs(tmp, exist_ok=True)
            for name in (plan.data_file, plan.metadata_file,
                         f"extra_{rank}.pkl", f"manifest_{rank}.json"):
                p = os.path.join(tmp, name)
                if os.path.exists(p):
                    os.remove(p)
            written = _sd.write_planned(tmp, plan)
            if extra_blob is not None:
                with checked_open(os.path.join(tmp, f"extra_{rank}.pkl"),
                                  "wb") as f:
                    f.write(extra_blob)
                written.append(f"extra_{rank}.pkl")
            _write_manifest(tmp, rank, step, written)

        call_with_retries(attempt, retries=IO_RETRIES,
                          backoff_s=IO_BACKOFF_S,
                          site=f"ckpt.save.step_{step}", counter=_M_RETRIES)
        if rank == self.coordinator_rank:
            self._commit(step, tmp, final)
        self.last_save = dict(step=int(step), bytes=plan.nbytes,
                              snapshot_s=snapshot_s,
                              write_s=time.perf_counter() - t_write)
        if rank != self.coordinator_rank:
            return
        _M_SAVES.inc(result="committed")
        _M_BYTES.inc(plan.nbytes)
        dt = time.perf_counter() - t0
        _H_SAVE_S.observe(dt)
        _flight.default_recorder().record_event(
            "ckpt_commit", step=step, bytes=plan.nbytes,
            seconds=round(dt, 4))
        self.rotate(protect=step)

    def _commit(self, step: int, tmp: str, final: str) -> None:
        """Coordinator: wait for every rank's manifest, validate every
        file, rename, then write the sentinel."""
        n_ranks = _env.get_world_size()
        deadline = time.monotonic() + COMMIT_TIMEOUT_S
        while True:
            have = [f for f in os.listdir(tmp) if _MANIFEST_RE.match(f)]
            if len(have) >= n_ranks:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint commit for step {step}: only "
                    f"{len(have)}/{n_ranks} rank manifests appeared")
            time.sleep(0.05)
        reason = verify_version(tmp, need_sentinel=False)
        if reason is not None:
            raise ValueError(
                f"checkpoint validation failed for step {step}: {reason}")
        call_with_retries(lambda: _commit_dir(tmp, final, step, n_ranks),
                          retries=IO_RETRIES, backoff_s=IO_BACKOFF_S,
                          site=f"ckpt.commit.step_{step}",
                          counter=_M_RETRIES)

    # ------------------------------------------------------------- rotation
    def rotate(self, protect: Optional[int] = None) -> List[int]:
        """Delete committed versions beyond ``keep_last``, keeping every
        multiple of ``keep_period`` (and ``protect``).  Returns the steps
        deleted."""
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:])
        if protect is not None:
            keep.add(protect)
        if self.keep_period > 0:
            keep.update(s for s in steps
                        if s > 0 and s % self.keep_period == 0)
        deleted = []
        for s in steps:
            if s in keep:
                continue
            for path in (self.step_path(s), self.step_path(s) + ".tmp"):
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
            deleted.append(s)
            _M_ROTATED.inc()
            _flight.default_recorder().record_event("ckpt_rotate", step=s)
        return deleted

    # ----------------------------------------------------------------- load
    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            found = self.latest_complete()
            if found is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {self.root!r}")
            return found
        reason = verify_version(self.step_path(step))
        if reason is not None:
            raise ValueError(
                f"checkpoint step {step} under {self.root!r} is not "
                f"loadable: {reason}")
        return step

    def _load_extra(self, path: str) -> Dict:
        extra: Dict = {}
        for f in sorted(os.listdir(path)):
            if re.match(r"^extra_\d+\.pkl$", f):
                with open(os.path.join(path, f), "rb") as fh:
                    extra = _deep_merge(extra, pickle.load(fh))
        return extra

    def load(self, step: Optional[int] = None) -> Dict:
        """Template-free restore of version ``step`` (default: the newest
        complete one) as a nested dict: numpy arrays for the array
        leaves, the saved Python values for the rest."""
        t0 = time.perf_counter()
        step = self._resolve(step)
        path = self.step_path(step)
        out = _deep_merge(read_state_dict(path), self._load_extra(path))
        _H_RESTORE_S.observe(time.perf_counter() - t0)
        return out

    def restore_into(self, state: Dict, step: Optional[int] = None,
                     resize_trailing: bool = False) -> Tuple[Dict, Dict]:
        """Restore in place: every array leaf of ``state`` is loaded with
        resharding (``load_state_dict``'s semantics: the target's box,
        device and dtype win).  Returns ``(arrays, extra)``: ``arrays``
        mirrors the array leaves of ``state`` with the loaded tensors (a
        tensor leaf itself, a ``ShardedLeaf``'s ``local``, a numpy leaf
        as a new CPU tensor), ``extra`` the checkpoint's other leaves.

        ``resize_trailing=True`` lets a leaf's LAST dimension differ from
        the saved one (truncated or zero-filled): the elastic ZeRO-3
        re-plan, where flat ``(Fp,)`` leaves change only their
        dp-dependent pad."""
        t0 = time.perf_counter()
        step = self._resolve(step)
        path = self.step_path(step)
        arrays, _ = _split_tree(state)

        def wrap(node):
            if isinstance(node, dict):
                return {k: wrap(v) for k, v in node.items()}
            if isinstance(node, (torch.Tensor, ShardedLeaf)):
                return node
            return torch.from_numpy(np.array(node, copy=True))
        wrapped = wrap(arrays)
        load_state_dict(wrapped, path, resize_trailing=resize_trailing)

        def unwrap(node):
            if isinstance(node, dict):
                return {k: unwrap(v) for k, v in node.items()}
            return node.local if isinstance(node, ShardedLeaf) else node
        out = unwrap(wrapped)
        extra = self._load_extra(path)
        _H_RESTORE_S.observe(time.perf_counter() - t0)
        return out, extra

    # ------------------------------------------------------------ preemption
    @property
    def preempted(self) -> bool:
        return preemption_requested()

    def install_signal_handlers(self, signals=(
            _signal.SIGTERM, _signal.SIGINT)) -> None:
        """SIGTERM / SIGINT set the preemption flag instead of ending the
        process; the train loop reads :attr:`preempted` after each step,
        saves and stops.  :meth:`uninstall_signal_handlers` puts the old
        handlers back (``fit`` does both)."""
        for sig in signals:
            if sig in self._old_handlers:
                continue
            try:
                self._old_handlers[sig] = _signal.signal(
                    sig, lambda signum, frame: request_preemption(signum))
            except ValueError:
                # not the main thread: the default handlers stay, and the
                # caller can still request_preemption() itself
                logger.warning("cannot install signal handlers off the "
                               "main thread; preemption flag only")
                break

    def uninstall_signal_handlers(self) -> None:
        for sig, old in self._old_handlers.items():
            _signal.signal(sig, old)
        self._old_handlers.clear()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        try:
            self.wait()
        finally:
            self.uninstall_signal_handlers()
        return False
