"""``python -m paddle_tpu_torch.distributed.launch``: the collective
launcher, elastic.

Counterpart of ``paddle_tpu/distributed/launch/main.py`` (Paddle's
``launch/main.py``, ``launch/controllers/collective.py`` and the restart
policy of ``fleet/elastic/manager.py:124``)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        [--master HOST:PORT] [--rank R] [--nnodes N | MIN:MAX] \\
        [--max_restart K] [--elastic_timeout S] \\
        [--devices 0,1 | 0,0 | cpu] [--log_dir log] [--job_id default] \\
        script.py [script args]

Each node's launcher starts ``nproc_per_node`` processes of the script
with the ``PADDLE_*`` environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``,
``PADDLE_NNODES``, ``PADDLE_MASTER``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_JOB_ID``,
``PADDLE_RESTART_GENERATION``, ``FLAGS_selected_gpus``,
``PADDLE_WORLD_DEVICES``, ``COORDINATOR_ADDRESS``), writes each rank's
output to ``<log_dir>/<job_id>.rank<r>.log``, and returns 0 once every
local rank succeeds, else the code of the first that failed (the others
stopped) when no restart is left.

**Rendezvous.**  Node 0 hosts the port's ``TCPStore``
(``distributed/store.py``) at ``--master`` (a free local port without
it), and every node joins it: the hosting node claims node slot 0,
then opens the ``rank_gate/{gen}`` gate for auto-ranked nodes
(``--rank -1``).  ``--nnodes MIN:MAX`` is elastic: node 0 counts joins
until MAX came or MIN came and ``--elastic_timeout`` passed, and every
node adopts the settled count (``_settle_world``), so a generation after
a node loss comes up smaller; a node that joins after its generation
settled asks for a scale-up restart (``_LateJoin``).  Node 0 publishes a
fresh ``host:port`` for each generation (``coordinator/{gen}``), passed
as ``COORDINATOR_ADDRESS``: the workers' rank 0 hosts the process
group's ``torch.distributed.TCPStore`` there, so a restarted world never
meets the gloo keys of the world before it (``parallel.init_parallel_env``).
Node 0 deletes generation N-2's keys.

**Supervision.**  A worker that fails restarts the node's workers in the
next generation, up to ``--max_restart`` times, and tells the other
nodes (``restart_generation``); they restart too (``PEER_RESTART``).
Every launcher of a multi-node world bumps its lease
(``lease/{gen}/{node}``) every ``ELASTIC_LEASE_INTERVAL_S``; a peer whose
lease has not moved for ``ELASTIC_LEASE_TIMEOUT_S`` of this node's clock
(after one such grace from the rendezvous) is dead, and the generation is
bumped.  With ``ELASTIC_STALL_TIMEOUT_S`` > 0 a local worker whose step
heartbeat (``progress/{gen}/{rank}``, ``fleet.elastic.ProgressReporter``)
stops moving that long is killed (a hang becomes a crash).  Node 0 hosts
the store, so its loss ends the job.  The lease and stall constants are
the JAX flags' defaults, read from ``FLAGS_<name>`` when set.

``--devices`` gives each local rank its card (``0,1``), lets ranks share
one (``0,0``), or runs them on the CPU (``cpu``); without it every rank
takes a card of its own, and fewer cards than ranks raises.  Each node
publishes its list, and ``PADDLE_WORLD_DEVICES`` is the nodes' lists in
node order (``parallel.choose_backend`` picks gloo where a card id
repeats).  The JAX launcher's TPU pod detection has no meaning here.
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ...testing import chaos as _chaos
from ..store import TCPStore

__all__ = ["launch", "parse_args", "CollectiveController", "Proc",
           "ELASTIC_LEASE_INTERVAL_S", "ELASTIC_LEASE_TIMEOUT_S",
           "ELASTIC_STALL_TIMEOUT_S"]


def _flag(name: str, default: float) -> float:
    return float(os.environ.get("FLAGS_" + name, default))


ELASTIC_LEASE_INTERVAL_S = _flag("elastic_lease_interval_s", 1.0)
ELASTIC_LEASE_TIMEOUT_S = _flag("elastic_lease_timeout_s", 5.0)
ELASTIC_STALL_TIMEOUT_S = _flag("elastic_stall_timeout_s", 0.0)


def _free_port(host: str = "") -> int:
    """A free TCP port below the kernel's ephemeral range, for a server
    whose clients may connect before it binds: a loopback client given a
    port in the range may connect to itself on the server's port (and
    any outgoing connection may take it meanwhile); below the range
    neither can happen."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768     # the kernel's default
    rng = random.SystemRandom()
    for _ in range(100):
        port = rng.randrange(max(1024, low // 2), low)
        with socket.socket() as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port below the ephemeral range ({low})")


def _metric(kind: str, name: str, value: float, help_: str) -> None:
    """A counter's increment or a gauge's value on the port's registry."""
    if kind == "gauge":
        _metrics.gauge(name, help_).set(value)
    else:
        _metrics.counter(name, help_).inc(value)


def _event(kind: str, **info) -> None:
    """A flight-recorder event (the fleet's trace)."""
    _flight.default_recorder().record_event(kind, **info)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch collective launcher")
    p.add_argument("--master", default=None,
                   help="host:port of the rendezvous store (default: a "
                        "free local port)")
    p.add_argument("--rank", type=int, default=-1, help="node rank")
    p.add_argument("--nnodes", type=str, default="1",
                   help="number of nodes (N, or MIN:MAX for elastic)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", default=None,
                   help="each local rank's card id (comma list), or cpu")
    p.add_argument("--run_mode", default="collective",
                   choices=["collective"])
    p.add_argument("--max_restart", type=int, default=0,
                   help="restarts allowed after a worker fails")
    p.add_argument("--elastic_timeout", type=float, default=30.0)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _rank_devices(spec, nproc: int) -> List[str]:
    """Each local rank's device as the environment writes it: a card id
    or ``cpu``."""
    if spec:
        devs = [d.strip() for d in spec.split(",") if d.strip()]
        if devs == ["cpu"]:
            return ["cpu"] * nproc
        if len(devs) != nproc:
            raise ValueError(f"--devices names {len(devs)} devices for "
                             f"{nproc} ranks")
        return devs
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < nproc:
        raise ValueError(
            f"--nproc_per_node {nproc} needs {nproc} cards, this machine "
            f"has {n}; name the devices (--devices 0,0 to share one, "
            "--devices cpu for CPU ranks)")
    return [str(i) for i in range(nproc)]


class _LateJoin(Exception):
    """This node joined a generation after its world settled: retry the
    rendezvous at ``generation`` (the scale-up restart it asked for)."""

    def __init__(self, generation: int):
        super().__init__(f"late join; retry at generation {generation}")
        self.generation = generation


class Proc:
    def __init__(self, popen: subprocess.Popen, rank: int, log_path: str,
                 log_file):
        self.popen = popen
        self.rank = rank
        self.log_path = log_path
        self.log_file = log_file


class CollectiveController:
    """One node's workers: rendezvous, start, watch, restart."""

    PEER_RESTART = -1

    def __init__(self, args):
        self.args = args
        spec = str(args.nnodes or "1")
        lo, _, hi = spec.partition(":")
        self.nnodes_min = int(lo)
        self.nnodes_max = int(hi) if hi else self.nnodes_min
        assert self.nnodes_max >= self.nnodes_min > 0, \
            f"bad --nnodes {spec!r}"
        self.nnodes = self.nnodes_min
        self.node_rank = max(args.rank, 0)
        self.nproc = int(args.nproc_per_node)
        if self.nproc < 1:
            raise ValueError(f"--nproc_per_node {self.nproc}")
        self.devices = _rank_devices(args.devices, self.nproc)
        self.world_devices = list(self.devices)
        self.world_size = self.nnodes * self.nproc
        self.procs: List[Proc] = []
        self.store: Optional[TCPStore] = None
        self.master = args.master
        self.coordinator = None
        self.restarts = 0
        self.store_host = False
        # {rank: (value last seen, this node's time it last changed)}:
        # only a value's motion counts, so peers' clocks never matter
        self._lease_seen = {}
        self._progress_seen = {}
        self._lease_seq = 0
        self._gen_started = 0.0

    @property
    def elastic(self) -> bool:
        return self.nnodes_max > self.nnodes_min

    # ------------------------------------------------------------ rendezvous
    def rendezvous(self):
        """Host (node 0) or join the store, take a node rank, settle the
        world and publish the generation's process-group address.

        Repeatable across generations: the store outlives the workers,
        only the generation's keys change.  Node ranks: the hosting node
        claims slot 0 of ``node_rank/{gen}`` and opens ``rank_gate/{gen}``;
        auto-ranked nodes wait at the gate, then draw from the counter,
        so the host is node 0 and survivors stay dense (explicit non-zero
        ranks beside auto-ranked nodes are not supported).  A node that
        drew a rank past the settled world retries at the next
        generation, at most 8 times."""
        for _ in range(8):
            try:
                return self._rendezvous_once()
            except _LateJoin as lj:
                self.restarts = max(lj.generation, self._peer_generation())
        raise TimeoutError(
            "elastic rendezvous: this node kept joining after the world "
            "had settled; giving up after 8 scale-up attempts")

    def _open_store(self):
        if self.master is None:
            self.store = TCPStore(is_master=True, world_size=self.nnodes)
            self.master = f"127.0.0.1:{self.store.port}"
            self.store_host = True
        else:
            host, port = self.master.rsplit(":", 1)
            # an explicit --rank 0 hosts the store at --master, and so
            # does the one node of a fixed one-node job; an auto-ranked
            # node of a larger job joins it
            self.store_host = self.args.rank == 0 or (
                self.args.rank < 0 and self.nnodes_max == 1)
            self.store = TCPStore(host=host, port=int(port),
                                  is_master=self.store_host,
                                  world_size=self.nnodes)
        if self.store_host:
            kind = "native" if self.store.is_native else "Python"
            sys.stderr.write(f"[launch] hosting the rendezvous store at "
                             f"{self.master} ({kind} server)\n")

    def _rendezvous_once(self):
        if self.store is None:
            self._open_store()
        store = self.store
        gen = self.restarts
        self._gen_started = time.time()
        self._lease_seen = {}
        self._lease_seq = 0
        if self.store_host:
            if self.args.rank < 0:
                self.node_rank = store.add(f"node_rank/{gen}", 1) - 1
            else:
                self.node_rank = self.args.rank
                store.add(f"node_rank/{gen}", 1)    # slot 0 is ours
            # not per generation: tells auto-ranked joiners that a gate
            # opens every generation, so they wait for it rather than
            # race the counter while the host still stops its workers
            store.set("rank_gate_hosted", b"1")
            store.set(f"rank_gate/{gen}", b"1")
        elif self.args.rank < 0:
            try:
                hosted = store.check("rank_gate_hosted")
            except (OSError, TimeoutError):
                hosted = False
            # a hosted gate can lag a restarted generation by the host's
            # worker teardown (up to 10 s) and a poll: wait well past it
            gate_timeout = (self.args.elastic_timeout * 2 + 15 if hosted
                            else min(self.args.elastic_timeout, 5.0))
            try:
                store.wait(f"rank_gate/{gen}", timeout=gate_timeout)
            except (TimeoutError, OSError):
                pass    # an external store with no rank-0 claimant
            self.node_rank = store.add(f"node_rank/{gen}", 1) - 1
        else:
            self.node_rank = self.args.rank
        if self.elastic:
            self._settle_world(store, gen)
        store.set(f"devices/{gen}/{self.node_rank}", ",".join(self.devices))
        store.barrier(f"rendezvous/{gen}", self.nnodes,
                      timeout=self.args.elastic_timeout)
        self.world_devices = [
            d for r in range(self.nnodes)
            for d in store.get(f"devices/{gen}/{r}",
                               timeout=self.args.elastic_timeout)
            .decode().split(",")]
        # the process group's store, a new one each generation: node 0
        # takes a free port and publishes it (another server may bind it
        # between this probe and the workers' rank 0; that fails the
        # worker, and the restart path takes it)
        host = self.master.rsplit(":", 1)[0]
        if self.node_rank == 0:
            self.coordinator = f"{host}:{_free_port()}"
            store.set(f"coordinator/{gen}", self.coordinator.encode())
        else:
            self.coordinator = store.get(
                f"coordinator/{gen}",
                timeout=self.args.elastic_timeout).decode()
        _metric("gauge", "elastic.generation", gen,
                "current elastic restart generation of this launcher")
        self._gc_generation(gen - 2)

    def _gc_generation(self, gen: int) -> None:
        """Delete a generation's keys (node 0 only, and only N-2: N-1
        may still have nodes adopting the bump).  The protocol has no
        LIST, so the names are rebuilt; deleting a missing key is free."""
        if gen < 0 or self.node_rank != 0 or self.store is None:
            return
        keys = [f"node_rank/{gen}", f"rank_gate/{gen}", f"join/{gen}",
                f"world/{gen}", f"coordinator/{gen}",
                f"__barrier__/rendezvous/{gen}/count",
                f"__barrier__/rendezvous/{gen}/go"]
        for r in range(self.nnodes_max):
            keys += [f"lease/{gen}/{r}", f"devices/{gen}/{r}"]
        for r in range(self.nnodes_max * self.nproc):
            keys.append(f"progress/{gen}/{r}")
        for key in keys:
            try:
                self.store.delete_key(key)
            except (OSError, TimeoutError):
                return  # store trouble: the next generation sweeps again

    def _settle_world(self, store, gen: int):
        """The counted join window of a MIN:MAX rendezvous.

        Every node adds itself to ``join/{gen}``; node 0 admits joins
        until MAX came, or MIN came and ``--elastic_timeout`` passed,
        and publishes the count on ``world/{gen}``, which every node
        adopts (``PADDLE_TRAINERS_NUM`` and ``PADDLE_NNODES`` follow)."""
        store.add(f"join/{gen}", 1)
        key = f"world/{gen}"
        if self.node_rank == 0:
            deadline = time.time() + self.args.elastic_timeout
            while True:
                n = store.add(f"join/{gen}", 0)
                if n >= self.nnodes_max:
                    break
                if time.time() >= deadline:
                    if n >= self.nnodes_min:
                        break
                    raise TimeoutError(
                        f"elastic rendezvous gen {gen}: only {n} of the "
                        f"required minimum {self.nnodes_min} nodes "
                        f"joined within {self.args.elastic_timeout}s")
                time.sleep(0.05)
            store.set(key, str(min(n, self.nnodes_max)))
        else:
            # node 0 publishes after its whole window, and nodes enter a
            # restarted generation up to a poll and a teardown apart:
            # wait the window and more
            store.wait(key, timeout=self.args.elastic_timeout * 2 + 15)
        settled = int(store.get(key, timeout=self.args.elastic_timeout))
        if self.node_rank >= settled:
            # the window closed without us: running anyway would split
            # the world, so ask for a scale-up restart and retry
            if settled >= self.nnodes_max:
                raise TimeoutError(
                    f"elastic rendezvous gen {gen}: world already full "
                    f"at {settled} nodes; hot spares are unsupported")
            sys.stderr.write(
                f"[launch] joined generation {gen} after it settled at "
                f"{settled} nodes — requesting a scale-up restart\n")
            try:
                if self._peer_generation() <= gen:
                    store.set("restart_generation", str(gen + 1))
                    _event("elastic_restart_generation",
                           generation=gen + 1, cause="late_join",
                           node=self.node_rank)
            except (OSError, TimeoutError):
                pass    # the survivors admit us at their next restart
            raise _LateJoin(gen + 1)
        if settled != self.nnodes:
            sys.stderr.write(
                f"[launch] elastic world settled at {settled} nodes "
                f"(was {self.nnodes}, generation {gen})\n")
        self.nnodes = settled
        self.world_size = self.nnodes * self.nproc

    # --------------------------------------------------------------- workers
    def _worker_env(self, local_rank: int):
        env = dict(os.environ)
        rank = self.node_rank * self.nproc + local_rank
        host = self.master.rsplit(":", 1)[0]
        base = int(self.master.rsplit(":", 1)[1])
        eps = [f"{host}:{base + 1 + r}" for r in range(self.world_size)]
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.world_size),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_LOCAL_SIZE": str(self.nproc),
            "PADDLE_NNODES": str(self.nnodes),
            "PADDLE_MASTER": self.master,
            "PADDLE_CURRENT_ENDPOINT": eps[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
            "PADDLE_JOB_ID": self.args.job_id,
            "PADDLE_RESTART_GENERATION": str(self.restarts),
            "FLAGS_selected_gpus": self.devices[local_rank],
            "PADDLE_WORLD_DEVICES": ",".join(self.world_devices),
        })
        if self.coordinator:
            env["COORDINATOR_ADDRESS"] = self.coordinator
        return env

    def start_workers(self):
        os.makedirs(self.args.log_dir, exist_ok=True)
        self.procs = []
        self._progress_seen = {}
        for lr in range(self.nproc):
            rank = self.node_rank * self.nproc + lr
            log_path = os.path.join(self.args.log_dir,
                                    f"{self.args.job_id}.rank{rank}.log")
            logf = open(log_path, "ab")
            cmd = [sys.executable, "-u", self.args.training_script,
                   *self.args.training_script_args]
            popen = subprocess.Popen(cmd, env=self._worker_env(lr),
                                     stdout=logf, stderr=subprocess.STDOUT)
            self.procs.append(Proc(popen, rank, log_path, logf))

    def stop_workers(self, sig=signal.SIGTERM, grace_s: float = 10.0):
        for p in self.procs:
            if p.popen.poll() is None:
                try:
                    p.popen.send_signal(sig)
                except OSError:
                    pass
        deadline = time.time() + grace_s
        for p in self.procs:
            try:
                p.popen.wait(max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.popen.kill()
                p.popen.wait()
            p.log_file.close()

    # ------------------------------------------------------------------ run
    def _peer_generation(self) -> int:
        try:
            if self.store.check("restart_generation"):
                return int(self.store.get("restart_generation",
                                          timeout=5.0))
        except (OSError, TimeoutError):
            pass
        return self.restarts

    def _publish_lease(self, gen: int) -> None:
        """Bump this node's lease for ``gen``: an opaque sequence, timed
        by its peers on their own clocks.  The ``elastic.lease.publish``
        chaos site silences it (a node's sudden death, in tests)."""
        self._lease_seq += 1
        try:
            _chaos.inject("elastic.lease.publish")
            self.store.set(f"lease/{gen}/{self.node_rank}",
                           str(self._lease_seq))
        except (OSError, TimeoutError):
            pass    # a store hiccup: the next interval publishes

    def _check_peer_leases(self, gen: int) -> bool:
        """True (after bumping the generation) when a peer's lease has not
        moved for ``ELASTIC_LEASE_TIMEOUT_S``.  The first timeout after a
        rendezvous is a grace: peers may still be starting their workers.
        A node that joined but died before its first lease ages out like
        any other."""
        timeout = float(ELASTIC_LEASE_TIMEOUT_S)
        now = time.time()
        if timeout <= 0 or now - self._gen_started < timeout:
            return False
        for rank in range(self.nnodes):
            if rank == self.node_rank:
                continue
            key = f"lease/{gen}/{rank}"
            try:
                val = (self.store.get(key, timeout=5.0)
                       if self.store.check(key) else None)
            except (OSError, TimeoutError):
                return False    # an unreachable store is no evidence
            seen = self._lease_seen.get(rank)
            if seen is None or seen[0] != val:
                self._lease_seen[rank] = (val, now)
                continue
            if now - seen[1] > timeout:
                self._on_lease_expired(gen, rank, now - seen[1])
                return True
        return False

    def _on_lease_expired(self, gen: int, rank: int, age: float) -> None:
        if self._peer_generation() > self.restarts:
            return      # another survivor bumped already; watch adopts it
        sys.stderr.write(
            f"[launch] node {rank} lease expired "
            f"({age:.1f}s without a heartbeat, generation {gen}) — "
            f"declaring it dead and re-rendezvousing\n")
        _metric("counter", "elastic.lease_expiries_total", 1,
                "peer launcher leases declared expired (node deaths "
                "detected by the heartbeat-lease protocol)")
        _event("elastic_lease_expired", generation=gen, node=rank,
               age_s=round(age, 3))
        try:
            self.store.set("restart_generation", str(self.restarts + 1))
            _event("elastic_restart_generation",
                   generation=self.restarts + 1, cause="lease_expiry",
                   dead_node=rank)
        except (OSError, TimeoutError):
            pass    # store trouble: the next watch poll retries

    def _check_stalls(self, gen: int) -> None:
        """Kill a local worker whose step heartbeat has not moved for
        ``ELASTIC_STALL_TIMEOUT_S``; a rank arms at its first heartbeat,
        so a script that never reports is never killed."""
        timeout = float(ELASTIC_STALL_TIMEOUT_S)
        if timeout <= 0 or self.store is None:
            return
        now = time.time()
        for p in self.procs:
            if p.popen.poll() is not None:
                continue
            key = f"progress/{gen}/{p.rank}"
            try:
                if not self.store.check(key):
                    continue
                val = self.store.get(key, timeout=5.0)
            except (OSError, TimeoutError):
                continue
            seen = self._progress_seen.get(p.rank)
            if seen is None or seen[0] != val:
                self._progress_seen[p.rank] = (val, now)
                continue
            if now - seen[1] > timeout:
                stalled = now - seen[1]
                sys.stderr.write(
                    f"[launch] rank {p.rank} stalled at step "
                    f"{val.decode(errors='replace')} for {stalled:.1f}s "
                    f"(> {timeout}s) — killing it for restart\n")
                _metric("counter", "elastic.stall_kills_total", 1,
                        "workers SIGKILLed by the progress watchdog "
                        "(stalled step heartbeat)")
                _event("elastic_stall_kill", generation=gen, rank=p.rank,
                       step=val.decode(errors="replace"),
                       stalled_s=round(stalled, 3))
                try:
                    p.popen.kill()
                except OSError:
                    pass
                self._progress_seen.pop(p.rank, None)

    def watch(self) -> int:
        """Until every local worker exits (0), one fails (its code), or
        the generation was bumped (``PEER_RESTART``: by a failing peer,
        or by this node seeing a peer's lease expire).  Publishes this
        node's lease and runs the stall watchdog meanwhile."""
        last_poll = 0.0
        last_lease = 0.0
        lease_iv = max(0.05, float(ELASTIC_LEASE_INTERVAL_S))
        gen = self.restarts
        while True:
            alive = False
            for p in self.procs:
                rc = p.popen.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    sys.stderr.write(f"[launch] rank {p.rank} exited with "
                                     f"code {rc}; stopping the others\n")
                    return rc
            if not alive:
                return 0
            now = time.time()
            if self.nnodes > 1 and self.store is not None:
                if now - last_lease >= lease_iv:
                    last_lease = now
                    self._publish_lease(gen)
                if now - last_poll > min(1.0, lease_iv):
                    last_poll = now
                    if self._peer_generation() > self.restarts:
                        return self.PEER_RESTART
                    if self._check_peer_leases(gen):
                        return self.PEER_RESTART
            self._check_stalls(gen)
            time.sleep(0.05)

    def run(self) -> int:
        self.rendezvous()
        while True:
            self.start_workers()
            rc = self.watch()
            self.stop_workers()
            if rc == 0:
                return 0
            if rc == self.PEER_RESTART:
                # a peer asked for the restart (or this node did, on a
                # peer's expired lease): adopt the published generation
                self.restarts = max(self._peer_generation(),
                                    self.restarts + 1)
                sys.stderr.write(f"[launch] peer requested restart "
                                 f"(generation {self.restarts})\n")
            else:
                sys.stderr.write(
                    f"[launch] worker failed rc={rc} "
                    f"(restart {self.restarts}/{self.args.max_restart})\n")
                if self.restarts >= self.args.max_restart:
                    return rc
                self.restarts += 1
                # tell the other nodes to rejoin at the new generation
                self.store.set("restart_generation", str(self.restarts))
                _event("elastic_restart_generation",
                       generation=self.restarts, cause="worker_exit", rc=rc)
            self.rendezvous()


def launch(argv=None) -> int:
    controller = CollectiveController(parse_args(argv))

    def handler(sig, frame):
        controller.stop_workers(signal.SIGTERM)
        sys.exit(128 + sig)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    return controller.run()


if __name__ == "__main__":
    sys.exit(launch())
