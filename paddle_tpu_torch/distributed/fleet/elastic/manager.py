"""The elastic manager: node heartbeats, the roster and its watch, over
the rendezvous store.

Counterpart of ``paddle_tpu/distributed/fleet/elastic/manager.py``
(Paddle's ``fleet/elastic/manager.py:124``).  Paddle's manager beats into
etcd; here the store is the launcher's ``TCPStore``
(``distributed/store.py``), and ``python -m
paddle_tpu_torch.distributed.launch --max_restart N`` executes restarts.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import List, Optional

from ...store import Store

__all__ = ["ElasticManager", "ElasticStatus"]


class ElasticStatus(enum.Enum):
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"       # waiting for nodes
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Per-node heartbeat + liveness watch.

    Each node publishes `heartbeat/<gen>/<node_id>` every `interval`
    seconds; `dead_nodes()` reports nodes whose beat is older than
    `2.5 * interval`.  The launcher polls `should_restart()` to decide on a
    re-rendezvous.
    """

    def __init__(self, store: Store, node_id: int, nnodes: int,
                 generation: int = 0, interval: float = 2.0,
                 min_nodes: int = 0):
        self.store = store
        self.node_id = node_id
        self.nnodes = nnodes
        self.generation = generation
        self.interval = interval
        self.min_nodes = min_nodes  # elastic lower bound (0 = fixed size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ heartbeat
    def _key(self, node: int) -> str:
        return f"heartbeat/{self.generation}/{node}"

    def start(self):
        def beat():
            while not self._stop.wait(self.interval):
                self.store.set(self._key(self.node_id),
                               repr(time.time()).encode())
        self.store.set(self._key(self.node_id), repr(time.time()).encode())
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval * 2)

    # -------------------------------------------------------------- watching
    def last_beat(self, node: int) -> Optional[float]:
        if not self.store.check(self._key(node)):
            return None
        return float(self.store.get(self._key(node),
                                    timeout=5.0).decode())

    def _counter_key(self) -> str:
        return f"nodes/{self.generation}/next_id"

    def _allocated(self) -> int:
        """Highest allocated id bound (read-only — no counter write)."""
        k = self._counter_key()
        alloc = (int(self.store.get(k, timeout=5.0).decode())
                 if self.store.check(k) else 0)
        return max(self.nnodes, alloc)

    def _roster(self) -> List[int]:
        """Member ids of the current generation: every allocated id that
        actually registered an endpoint or published a heartbeat.  The
        join counter only *allocates* ids — `register()`'s
        atomic-increment advancement can overshoot under races, so
        allocated-but-never-claimed ids are NOT members (they would
        otherwise read as permanently dead phantom nodes).  Statically
        assigned ids likewise only become members once seen, so a
        generation rescale (`next_generation(nnodes=k)`) isn't haunted by
        a lost low id."""
        members = []
        for i in range(self._allocated()):
            if (self.store.check(self._node_key(i))
                    or self.store.check(self._key(i))):
                members.append(i)
        return members

    def dead_nodes(self, grace: Optional[float] = None,
                   roster: Optional[List[int]] = None) -> List[int]:
        grace = grace if grace is not None else 2.5 * self.interval
        now = time.time()
        dead = []
        for n in (self._roster() if roster is None else roster):
            beat = self.last_beat(n)
            if beat is None or now - beat > grace:
                dead.append(n)
        return dead

    def should_restart(self) -> bool:
        return len(self.dead_nodes()) > 0

    def status(self) -> ElasticStatus:
        roster = self._roster()
        if not roster:
            return ElasticStatus.HOLD  # fresh generation: nobody joined yet
        dead = self.dead_nodes(roster=roster)
        alive = len(roster) - len(dead)
        if not dead:
            return ElasticStatus.COMPLETED
        if alive == 0:
            return ElasticStatus.EXIT
        if self.min_nodes and alive < self.min_nodes:
            return ElasticStatus.HOLD  # wait for replacements to join
        return ElasticStatus.RESTART

    # ------------------------------------------------- membership registry
    # Parity: the reference's etcd node registry (`elastic/manager.py:124`
    # — np_path node entries, watch callbacks, endpoint rewriting).  The
    # TCPStore plays etcd: nodes JOIN by taking an id off an atomic
    # counter and publishing their endpoint; the launcher COLLECTS the
    # roster, and `watch()` fires on membership change so the launcher
    # can re-rendezvous with a rewritten endpoint list.

    def _node_key(self, node: int) -> str:
        return f"nodes/{self.generation}/{node}"

    def register(self, endpoint: str) -> None:
        """Publish this node's endpoint in the current generation, and
        advance the id counter past ours so later join()ers never collide
        with a statically-assigned id."""
        self.store.set(self._node_key(self.node_id), endpoint.encode())
        cur = self.store.add(self._counter_key(), 0)
        if cur < self.node_id + 1:
            # atomic increments only: overshoot under races just skips ids
            # (skipped ids are never members — see _roster())
            self.store.add(self._counter_key(), self.node_id + 1 - cur)

    def join(self, endpoint: str) -> int:
        """A NEW node (scale-up / replacement) takes the next free node id
        and registers; returns the assigned id."""
        self.node_id = self.store.add(self._counter_key(), 1) - 1
        self.nnodes = max(self.nnodes, self.node_id + 1)
        self.register(endpoint)
        return self.node_id

    def endpoints(self, roster: Optional[List[int]] = None) -> List[str]:
        """The registered endpoint roster (index = node id; '' = absent)."""
        roster = self._roster() if roster is None else roster
        out = ["" for _ in range(max(roster) + 1 if roster else 0)]
        for n in roster:
            k = self._node_key(n)
            if self.store.check(k):
                out[n] = self.store.get(k, timeout=5.0).decode()
        return out

    def collect_endpoints(self, timeout: float = 60.0) -> List[str]:
        """Block until `nnodes` members have registered; returns the roster
        (the rendezvous the launcher turns into PADDLE_TRAINER_ENDPOINTS).

        The wait is on the registered COUNT, not on specific ids, so a
        rescaled generation whose survivors keep non-contiguous ids (e.g.
        0,1,3 after losing 2) still completes.  If the full size never
        arrives but `min_nodes` is satisfied at the deadline, the partial
        roster is returned — the elastic lower bound.  The satisfied
        condition must hold for two consecutive polls so a joiner between
        its counter allocation and its register() isn't silently dropped
        from the rendezvous."""
        deadline = time.time() + timeout
        want = max(self.nnodes, 1)
        prev = None
        while time.time() < deadline:
            roster = self._roster()
            eps = self.endpoints(roster=roster)
            done = [n for n in roster if eps[n]]
            if len(done) >= want and len(done) == len(roster):
                if prev == eps:
                    return eps
                prev = eps
            else:
                prev = None
            time.sleep(0.1)
        roster = self._roster()
        eps = self.endpoints(roster=roster)
        done = [n for n in roster if eps[n]]
        if len(done) >= want and len(done) == len(roster):
            return eps  # complete at the deadline: no confirmation needed
        if self.min_nodes and len(done) >= self.min_nodes:
            # the elastic lower bound: proceed with who actually registered
            # (a heartbeat-only member that died before register() must not
            # block the degraded rendezvous)
            return eps
        raise TimeoutError(
            f"elastic rendezvous: only {len(done)}/{want} nodes "
            f"registered within {timeout}s")

    def next_generation(self, nnodes: Optional[int] = None) -> int:
        """Advance to a fresh generation (after a membership change the
        launcher re-rendezvouses under the new namespace — the endpoint
        REWRITE: survivors re-register, replacements join).  Pass `nnodes`
        to rescale the static expectation (e.g. continuing smaller after
        an unrecovered loss); otherwise the original size is kept."""
        self.generation += 1
        if nnodes is not None:
            self.nnodes = nnodes
        return self.generation

    def watch(self, on_change, poll: float = 1.0) -> threading.Event:
        """Daemon watch loop: calls `on_change(dead_nodes, endpoints)`
        whenever the dead set or the roster changes (the reference's etcd
        watch).  Returns the Event that stops the loop."""
        stop = threading.Event()
        state = {"dead": None, "eps": None}

        def loop():
            while not stop.wait(poll):
                roster = self._roster()
                dead = tuple(self.dead_nodes(roster=roster))
                eps = tuple(self.endpoints(roster=roster))
                if dead != state["dead"] or eps != state["eps"]:
                    changed = state["dead"] is not None
                    state["dead"], state["eps"] = dead, eps
                    if changed:
                        try:
                            on_change(list(dead), list(eps))
                        except Exception:  # noqa: BLE001 - watcher survives
                            pass
        threading.Thread(target=loop, daemon=True).start()
        return stop
