"""The comm watchdog, rank heartbeats and the cross-rank meta check.

Counterpart of ``paddle_tpu/distributed/watchdog.py`` (Paddle's
``comm_task_manager.h:37`` ``CommTaskManager`` and
``check/static_check.h:24`` ``CommStaticCheck``).

The watchdog guards the host waits where a multi-process job wedges: the
collective module registers a task around each (``comm_task``), and a
daemon thread, alive only while tasks are, reports a task older than
``COMM_WATCHDOG_TIMEOUT_S`` once: to the log, with the ranks whose
heartbeat (``Heartbeat``, a sequence number on the launcher's store)
stopped moving, and to the hang hooks.  The last 64 finished tasks stay
for a post-mortem.  :func:`static_check_meta` (``COMM_STATIC_CHECK``)
makes every rank publish the shape and dtype it brings to a collective,
and rank 0 names the rank that differs before the collective runs.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["CommTaskManager", "comm_task", "static_check_meta",
           "Heartbeat", "dead_peers", "ENABLE_COMM_WATCHDOG",
           "COMM_WATCHDOG_TIMEOUT_S", "COMM_STATIC_CHECK"]

ENABLE_COMM_WATCHDOG = True     # the JAX flags' defaults
COMM_WATCHDOG_TIMEOUT_S = 300.0
COMM_STATIC_CHECK = False


@dataclass
class CommTask:
    task_id: int
    name: str
    meta: Dict[str, Any]
    started: float = field(default_factory=time.monotonic)
    stack: str = ""
    done: bool = False
    error: Optional[str] = None


class CommTaskManager:
    """The process's host comm tasks, and the scan thread that reports
    hangs (one instance, :meth:`instance`).  A task costs two dict
    operations; the thread wakes once a second while tasks are live."""

    _instance: Optional["CommTaskManager"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._tasks: Dict[int, CommTask] = {}
        self._history: List[CommTask] = []
        self._next_id = 0
        self._tlock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._hang_hooks: List[Any] = []
        self._reported: set = set()

    @classmethod
    def instance(cls) -> "CommTaskManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def start_task(self, name: str, **meta) -> int:
        if not ENABLE_COMM_WATCHDOG:
            return -1
        with self._tlock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = CommTask(
                tid, name, meta,
                stack="".join(traceback.format_stack(limit=8)))
            self._ensure_thread_locked()
        return tid

    def end_task(self, tid: int, error: Optional[str] = None):
        if tid < 0:
            return
        with self._tlock:
            task = self._tasks.pop(tid, None)
            if task is not None:
                task.done = True
                task.error = error
                self._history.append(task)
                del self._history[:-64]

    def live_tasks(self) -> List[CommTask]:
        with self._tlock:
            return list(self._tasks.values())

    def history(self) -> List[CommTask]:
        with self._tlock:
            return list(self._history)

    def add_hang_hook(self, fn):
        """``fn(task)``, once a task, when it outlives the timeout."""
        self._hang_hooks.append(fn)

    def _ensure_thread_locked(self):
        """Caller holds ``_tlock``.  The scan loop gives its slot back
        (``_thread = None``) under the same lock before it exits, so the
        loop either saw this task or is gone and a new one starts."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._scan_loop,
                                            name="comm-watchdog",
                                            daemon=True)
            self._thread.start()

    def _scan_loop(self):
        while not self._stop.wait(1.0):
            timeout = float(COMM_WATCHDOG_TIMEOUT_S)
            now = time.monotonic()
            with self._tlock:
                if not self._tasks:
                    self._thread = None     # idle: start_task restarts it
                    break
                overdue = [t for t in self._tasks.values()
                           if now - t.started > timeout
                           and t.task_id not in self._reported]
                for t in overdue:
                    self._reported.add(t.task_id)
            for t in overdue:
                self._report_hang(t)

    def _report_hang(self, task: CommTask):
        missing = ""
        store = task.meta.get("store")
        if store is not None:
            dead = dead_peers(store, task.meta.get("world_size", 0),
                              task.meta.get("generation", "0"))
            if dead:
                missing = f"; ranks without heartbeat: {dead}"
        shown = {k: v for k, v in task.meta.items() if k != "store"}
        msg = (f"[comm watchdog] task '{task.name}' (meta={shown}) has "
               f"been blocked for {time.monotonic() - task.started:.0f}s"
               f"{missing}\nstarted at:\n{task.stack}")
        logging.getLogger("paddle_tpu_torch.distributed").error(msg)
        for fn in self._hang_hooks:
            try:
                fn(task)
            except Exception:   # noqa: BLE001 - a hook never stops the scan
                pass

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class comm_task:
    """Context manager: a host comm task registered with the watchdog."""

    def __init__(self, name: str, **meta):
        self._name = name
        self._meta = meta
        self._tid = -1

    def __enter__(self):
        self._tid = CommTaskManager.instance().start_task(
            self._name, **self._meta)
        return self

    def __exit__(self, exc_type, exc, tb):
        CommTaskManager.instance().end_task(
            self._tid, error=repr(exc) if exc is not None else None)
        return False


class Heartbeat:
    """This rank's liveness on the store, every ``interval`` seconds: a
    sequence number, not a clock reading, so hosts' clocks need not
    agree (a rank is live while its number moves)."""

    def __init__(self, store, rank: int, generation: str = "0",
                 interval: float = 5.0):
        self._store = store
        self._rank = rank
        self._generation = generation
        self._interval = interval
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat-r{rank}")

    def key(self) -> str:
        return f"__hb__/{self._generation}/{self._rank}"

    def start(self):
        self.beat()
        self._thread.start()
        return self

    def beat(self):
        self._seq += 1
        self._store.set(self.key(), str(self._seq).encode())

    def _loop(self):
        failures = 0
        while not self._stop.wait(self._interval):
            try:
                self.beat()
                failures = 0
            except Exception:   # noqa: BLE001
                # a store outage must not stop a live rank's beat for
                # good (later reports would call it dead): back off, at
                # most 8 intervals, and go on while the rank lives
                failures += 1
                extra = self._interval * min(2 ** min(failures, 3) - 1, 8)
                if self._stop.wait(extra):
                    return

    def stop(self):
        self._stop.set()


def _read_heartbeats(store, world_size: int, generation: str):
    seqs = {}
    for r in range(world_size):
        key = f"__hb__/{generation}/{r}"
        try:
            if store.check(key):
                seqs[r] = int(store.get(key).decode())
        except Exception:   # noqa: BLE001 - an unreadable beat is absent
            pass
    return seqs


def dead_peers(store, world_size: int, generation: str = "0",
               probe: float = 12.0) -> List[int]:
    """Ranks with no heartbeat key, or whose number does not move within
    ``probe`` seconds (over twice the default beat).  It blocks: it runs
    from hang reports, after minutes of stall."""
    before = _read_heartbeats(store, world_size, generation)
    missing = [r for r in range(world_size) if r not in before]
    if len(missing) == world_size:
        return missing      # nobody ever beat: do not hold the report
    time.sleep(probe)
    after = _read_heartbeats(store, world_size, generation)
    return [r for r in range(world_size)
            if r not in after or after[r] <= before.get(r, -1)]


def static_check_meta(store, rank: int, world_size: int, op: str, seq: int,
                      shape, dtype, generation: str = "0",
                      timeout: float = 60.0) -> None:
    """Every rank brings the same (shape, dtype) to collective ``op``
    (its ``seq``-th call), or the error names the rank that differs.

    Each rank publishes its meta under the call's key; rank 0 reads them
    all and publishes the verdict.  The keys go a round late, with no
    extra barrier: a rank's own meta of ``seq - 1`` (rank 0 has read it
    before verdict ``seq - 1`` existed), and verdict ``seq - 2`` (a slow
    rank may still wait on ``seq - 1``'s while rank 0 enters ``seq``)."""
    me = json.dumps({"shape": list(shape), "dtype": str(dtype)})
    base = f"__meta__/{generation}/{op}/{seq}"
    try:
        if seq > 0:
            store.delete_key(f"__meta__/{generation}/{op}/{seq - 1}/{rank}")
        if rank == 0 and seq > 1:
            store.delete_key(f"__meta__/{generation}/{op}/{seq - 2}/verdict")
    except Exception:   # noqa: BLE001 - the sweep is best-effort
        pass
    store.set(f"{base}/{rank}", me.encode())
    if rank == 0:
        metas = {}
        for r in range(world_size):
            store.wait(f"{base}/{r}", timeout=timeout)
            metas[r] = json.loads(store.get(f"{base}/{r}").decode())
        ref = metas[0]
        for r, m in metas.items():
            if m != ref:
                store.set(f"{base}/verdict",
                          f"rank {r} meta {m} != rank 0 meta {ref}".encode())
                raise RuntimeError(
                    f"comm_static_check failed for '{op}' seq {seq}: "
                    f"rank {r} brings {m}, rank 0 brings {ref}")
        store.set(f"{base}/verdict", b"ok")
    else:
        store.wait(f"{base}/verdict", timeout=timeout)
        verdict = store.get(f"{base}/verdict")
        if verdict != b"ok":
            raise RuntimeError(
                f"comm_static_check failed for '{op}' seq {seq}: "
                f"{verdict.decode()}")
