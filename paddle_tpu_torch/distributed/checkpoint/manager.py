"""Atomic, versioned, integrity-checked directories.

Counterpart of the version machinery of
``paddle_tpu/distributed/checkpoint/manager.py`` (its ``CheckpointManager``
is not ported yet), with the same layout, so either package reads the
other's versions:

    root/
      step_00000042.tmp/     while writing (never read)
        <files>
        manifest_0.json      sha256 and size of every file
      step_00000042/         committed: the tmp dir renamed
        <files>, manifest_0.json, COMPLETE

:func:`commit_single_rank` writes the files, then the manifest, re-hashes
every file, renames the directory and only then writes the ``COMPLETE``
sentinel.  A reader (:func:`verify_version`, :func:`latest_complete`)
accepts a version only if the sentinel exists and every file still
matches its manifest, so truncation, bit flips and torn tails are found
and skipped, never loaded.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from ...observability import flight_recorder as _flight
from ...testing.chaos import checked_open
from .io_retry import call_with_retries

__all__ = ["latest_complete", "all_steps", "verify_version", "step_dir",
           "commit_single_rank", "COMPLETE_SENTINEL", "MANIFEST_SCHEMA"]

COMPLETE_SENTINEL = "COMPLETE"
MANIFEST_SCHEMA = "paddle_tpu_torch.ckpt/v1"   # readers check the files only
IO_RETRIES = 3                              # the JAX flags' defaults
IO_BACKOFF_S = 0.1
_STEP_RE = re.compile(r"^step_(\d{8})$")


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


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _write_manifest(path: str, rank: int, step: int,
                    files: List[str]) -> Dict[str, Any]:
    manifest = {"schema": MANIFEST_SCHEMA, "step": int(step),
                "rank": int(rank),
                "files": {name: {"sha256": _sha256(os.path.join(path, name)),
                                 "bytes": os.path.getsize(
                                     os.path.join(path, name))}
                          for name in files}}
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
    manifests = sorted(f for f in os.listdir(path)
                       if re.match(r"^manifest_\d+\.json$", f))
    if not manifests:
        return "no rank manifests"
    for mf in manifests:
        try:
            with open(os.path.join(path, mf)) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            return f"unreadable manifest {mf}: {type(e).__name__}"
        for name, want in files.items():
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                return f"missing file {name}"
            if os.path.getsize(fp) != want["bytes"]:
                return (f"size mismatch for {name}: "
                        f"{os.path.getsize(fp)} != {want['bytes']}")
            if _sha256(fp) != want["sha256"]:
                return f"checksum mismatch for {name}"
    return None


def latest_complete(root: str,
                    before: Optional[int] = None) -> Optional[int]:
    """The newest step under ``root`` that is committed and valid; the
    others are skipped and recorded in the flight recorder."""
    for step in reversed(all_steps(root)):
        if before is not None and step >= before:
            continue
        reason = verify_version(os.path.join(root, step_dir(step)))
        if reason is None:
            return step
        _flight.default_recorder().record_event(
            "ckpt_skip_corrupt", step=step, reason=reason)
    return None


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
                      site=f"export.step_{step}")
    reason = verify_version(tmp, need_sentinel=False)
    if reason is not None:
        raise ValueError(
            f"export validation failed for step {step}: {reason}")

    def do_commit():
        if os.path.isdir(final):
            shutil.rmtree(final)      # a stale uncommitted leftover
        os.replace(tmp, final)
        with checked_open(os.path.join(final, COMPLETE_SENTINEL),
                          "w") as f:
            json.dump({"step": int(step), "ranks": 1,
                       "committed_unix": time.time()}, f)

    call_with_retries(do_commit, retries=retries, backoff_s=backoff,
                      site=f"export.commit.step_{step}")
    return final
