"""paddle.distributed.rpc: named-worker remote procedure calls over the
rendezvous store.

Counterpart of ``paddle_tpu/distributed/rpc/__init__.py`` (Paddle's
``rpc/rpc.py``: ``init_rpc`` :73, ``rpc_sync`` :143, ``rpc_async`` :183,
``shutdown`` :276, ``get_worker_info`` :307).  Requests and replies are
pickled mailbox entries under the same ``__rpc__/`` keys on the same
store protocol, and a daemon thread a worker serves its mailbox, so a
worker of this package and one of the JAX package call each other over
one store.  It is a control-plane channel (coordination, evaluation
tasks): payloads move through the host.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]

_DEFAULT_TIMEOUT = 180.0


@dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int
    ip: str = "127.0.0.1"
    port: int = 0


class _RpcAgent:
    def __init__(self, name: str, rank: int, world_size: int, store):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = store
        self._send_seq: Dict[str, int] = {}
        self._send_lock = threading.Lock()
        self._recv_seq = 0
        self._stop = threading.Event()
        self._server = threading.Thread(target=self._serve, daemon=True,
                                        name=f"rpc-{name}")
        self.workers: Dict[str, WorkerInfo] = {}

    # ------------------------------------------------------------ registry
    def register(self):
        info = WorkerInfo(self.name, self.rank)
        self.store.set(f"__rpc__/info/{self.rank}",
                       pickle.dumps(info))
        for r in range(self.world_size):
            self.store.wait(f"__rpc__/info/{r}")
            w: WorkerInfo = pickle.loads(self.store.get(f"__rpc__/info/{r}"))
            self.workers[w.name] = w
        self._server.start()

    # -------------------------------------------------------------- server
    def _serve(self):
        while not self._stop.is_set():
            key = f"__rpc__/call/{self.rank}/{self._recv_seq}"
            try:
                if not self.store.check(key):
                    time.sleep(0.02)
                    continue
                msg = pickle.loads(self.store.get(key))
                self.store.delete_key(key)
            except Exception:
                if self._stop.is_set():
                    return
                time.sleep(0.1)
                continue
            self._recv_seq += 1
            reply_key = msg["reply"]
            try:
                fn = msg["fn"]
                out = fn(*msg.get("args", ()), **(msg.get("kwargs") or {}))
                payload = {"ok": True, "value": out}
            except Exception as e:  # noqa: BLE001
                payload = {"ok": False, "error": e}
            try:
                self.store.set(reply_key, pickle.dumps(payload))
            except Exception as e:  # noqa: BLE001
                # unpicklable return value / exception: degrade the payload
                # so the caller's Future fails fast with a message instead
                # of hanging to its timeout
                try:
                    fallback = {"ok": False, "error": RuntimeError(
                        f"rpc reply could not be serialized: {e!r}; "
                        f"original payload repr: {payload!r:.500}")}
                    self.store.set(reply_key, pickle.dumps(fallback))
                except Exception:  # noqa: BLE001 - store itself is down
                    pass

    # -------------------------------------------------------------- client
    def invoke(self, to: str, fn, args, kwargs,
               timeout: float) -> Future:
        if to not in self.workers:
            raise ValueError(f"unknown rpc worker {to!r}; known: "
                             f"{sorted(self.workers)}")
        dst = self.workers[to].rank
        with self._send_lock:  # rpc_async invites concurrent callers
            seq = self._send_seq.get(to, 0)
            self._send_seq[to] = seq + 1
        reply_key = f"__rpc__/reply/{dst}/{self.rank}/{seq}"
        # pickle BEFORE allocating the mailbox slot: an unpicklable fn
        # (lambda/closure) must fail client-side without consuming a slot
        # the receiver's in-order server would then wait on forever
        payload = pickle.dumps(
            {"fn": fn, "args": args, "kwargs": kwargs, "reply": reply_key})
        # receivers pop calls in sequence order: the call index must be the
        # DESTINATION's next mailbox slot, allocated atomically via ADD
        slot = self.store.add(f"__rpc__/mailbox/{dst}", 1) - 1
        self.store.set(f"__rpc__/call/{dst}/{slot}", payload)
        fut: Future = Future()

        def waiter():
            try:
                self.store.wait(reply_key, timeout=timeout)
                payload = pickle.loads(self.store.get(reply_key))
                self.store.delete_key(reply_key)
                if payload["ok"]:
                    fut.set_result(payload["value"])
                else:
                    fut.set_exception(payload["error"])
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)
        threading.Thread(target=waiter, daemon=True).start()
        return fut

    def shutdown(self):
        self._stop.set()


_agent: Optional[_RpcAgent] = None


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None, store=None):
    """Join the RPC group as `name` (`rpc.py:73`).

    In a launcher job rank/world_size/master default from the PADDLE_*
    env; `store` injects an existing TCPStore (tests)."""
    global _agent
    if _agent is not None:
        raise RuntimeError("rpc already initialized; call shutdown() first")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0")) \
        if rank is None else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) \
        if world_size is None else world_size
    if store is None:
        from ..store import TCPStore
        endpoint = master_endpoint or os.environ.get("PADDLE_MASTER")
        if endpoint is None:
            # single-process self-hosting (rank 0 owns the server)
            store = TCPStore(is_master=(rank == 0), world_size=world_size)
        else:
            host, port = endpoint.rsplit(":", 1)
            store = TCPStore(host=host, port=int(port),
                             is_master=False, world_size=world_size)
    _agent = _RpcAgent(name, rank, world_size, store)
    _agent.register()
    return _agent


def rpc_sync(to: str, fn, args=None, kwargs=None,
             timeout: float = _DEFAULT_TIMEOUT):
    """Blocking remote call (`rpc.py:143`)."""
    return rpc_async(to, fn, args, kwargs, timeout).result(timeout)


def rpc_async(to: str, fn, args=None, kwargs=None,
              timeout: float = _DEFAULT_TIMEOUT) -> Future:
    """Non-blocking remote call returning a Future (`rpc.py:183`);
    `fut.result()`/`fut.exception()` like the reference's FutureWrapper."""
    if _agent is None:
        raise RuntimeError("call init_rpc first")
    return _agent.invoke(to, fn, tuple(args or ()), dict(kwargs or {}),
                         timeout)


def shutdown():
    """Tear the agent down (`rpc.py:276`)."""
    global _agent
    if _agent is not None:
        _agent.shutdown()
        _agent = None


def get_worker_info(name: str) -> WorkerInfo:
    if _agent is None:
        raise RuntimeError("call init_rpc first")
    return _agent.workers[name]


def get_all_worker_infos():
    if _agent is None:
        raise RuntimeError("call init_rpc first")
    return sorted(_agent.workers.values(), key=lambda w: w.rank)
