"""The port's rendezvous store, comm watchdog and RPC against the JAX
package's, in one process on the CPU.

The store: both of the port's servers (the C++ one, built from
``paddle_tpu_torch/core/native/tcp_store.cc`` into ``build/``, and the
Python one) pass the JAX tests' ``_exercise_store`` sequence; a client of
either package works on a server of the other with the same bytes back;
the retry counters move as the JAX package's on one scripted fault
sequence.  The watchdog: ``tests/test_watchdog.py``'s seven cases on both
packages, the static check's error texts equal.  RPC: ``tests/test_rpc.py``'s
two cases on the port, and calls between a port agent and a JAX agent on
one store.  Ranks are threads, as in the JAX tests.
"""

import importlib
import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_launch_store import _exercise_store  # noqa: E402  (the JAX sequence)

from paddle_tpu_torch.distributed import store as PS  # noqa: E402
from paddle_tpu_torch.distributed import watchdog as PW  # noqa: E402

PKGS = ("jax", "port")


def _mods(pkg):
    """(store, watchdog, chaos, metrics, rpc) modules of a package."""
    base = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
    return [importlib.import_module(f"{base}.{m}") for m in (
        "distributed.store", "distributed.watchdog", "testing.chaos",
        "observability.metrics", "distributed.rpc")]


def _stop(*stores):
    for s in stores:
        server = getattr(s, "_server", None)
        if server is not None:
            server.stop()


# ---------------------------------------------------------------- store
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_both_servers_pass_the_jax_sequence(native, monkeypatch):
    if not native:
        monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    s = PS.TCPStore(is_master=True, world_size=2)
    # g++ is here, so the C++ server must build (no quiet Python server)
    assert s.is_native == native
    assert isinstance(s._server, PS._NativeServer if native
                      else PS._PyServer)
    c = PS.TCPStore(port=s.port, world_size=2)
    _exercise_store(s, c)
    _stop(s)


def test_the_native_server_builds_into_the_build_directory():
    from paddle_tpu_torch.core import native
    lib = native.build("tcp_store")
    assert lib is not None
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert native.BUILD_DIR.parts[-3:] == ("build", "paddle_tpu_torch",
                                           "native")


def _replies(client):
    """One op script's answers through ``client``."""
    blob = bytes(range(256)) * 3
    client.set("bin", blob)
    out = [client.get("bin"), client.check("bin"), client.check("nope"),
           client.add("ctr", 5), client.add("ctr", -2), client.get("ctr")]
    client.delete_key("bin")
    out.append(client.check("bin"))
    client.set("s", "text")
    out += [client.get("s"), client.add("fresh", 0)]
    client.wait("s", timeout=5.0)
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("server_pkg", PKGS)
def test_a_client_of_either_package_on_a_server_of_the_other(
        server_pkg, native, monkeypatch):
    if not native:
        monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    S = _mods(server_pkg)[0]
    C = _mods("port" if server_pkg == "jax" else "jax")[0]
    s = S.TCPStore(is_master=True, world_size=2)
    assert s.is_native == native
    other = C.TCPStore(port=s.port, world_size=2)
    _exercise_store(s, other)
    got = []
    for client in (S.TCPStore(port=s.port), other):
        for k in ("bin", "ctr", "s", "fresh"):
            s.delete_key(k)
        got.append(_replies(client))
    assert got[1] == got[0]
    _stop(s)


class _DropServer:
    """Reads each request whole, counts it by command, and closes the
    socket without an answer (a server lost after the bytes arrived)."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.seen = []
        self.running = True
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        self.sock.settimeout(0.1)
        while self.running:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._one, args=(conn,),
                             daemon=True).start()

    def _one(self, conn):
        with conn:
            try:
                head = PS._recv_exact(conn, 5)
                klen = struct.unpack("<I", head[1:])[0]
                PS._recv_exact(conn, klen)
                vlen = struct.unpack("<Q", PS._recv_exact(conn, 8))[0]
                PS._recv_exact(conn, vlen)
                self.seen.append(head[0])
            except (OSError, ConnectionError):
                pass    # a connect with no request (the client's first)

    def close(self):
        self.running = False
        self.sock.close()


def _retry_script(pkg):
    S, _, chaos, metrics, _ = _mods(pkg)

    def count(name):
        m = metrics.get(name)
        return 0 if m is None else m.total()
    r0, c0 = count("store.retries"), count("store.reconnects")
    s = S.TCPStore(is_master=True)
    s.set("k", b"v")
    c = S.TCPStore(port=s.port)
    assert c.get("k") == b"v"
    out = {}
    with chaos.fail_at("store.request", on_calls=[1]) as fault:
        out["absorbed"] = c.get("k")
    out["fires"] = fault.fires
    with chaos.fail_at("store.request"):
        with pytest.raises(OSError):
            c.get("k")
    out["after"] = c.get("k")
    t0 = time.time()
    with pytest.raises(TimeoutError):
        s.get("never-set", timeout=0.3)
    out["one_wait"] = time.time() - t0 < 2.0
    drop = _DropServer()
    try:
        d = S.TCPStore(port=drop.port)
        with pytest.raises(OSError) as e:
            d.add("n", 1)               # on the wire: not replayed
        out["add"] = (type(e.value).__name__, list(drop.seen))
        drop.seen.clear()
        with pytest.raises(OSError):
            d.set("x", b"1")            # idempotent: retried
        out["set"] = list(drop.seen)
    finally:
        drop.close()
    out["retries"] = count("store.retries") - r0
    out["reconnects"] = count("store.reconnects") - c0
    _stop(s)
    return out


def test_retries_count_as_the_jax_packages():
    """One transient fault absorbed, a persistent one raised, a GET
    timeout raised once (not retried), an ADD whose bytes went out not
    replayed, a SET retried: the same answers and counter moves."""
    got = {pkg: _retry_script(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["absorbed"] == g["after"] == b"v" and g["fires"] == 1
    assert g["one_wait"]
    assert g["add"] == ("ConnectionError", [PS._ADD])
    assert g["set"] == [PS._SET] * PS.STORE_RETRIES
    # 1 absorbed + 2 before the persistent fault's raise + 2 of the SET
    assert g["retries"] == 5


# ------------------------------------------------------------- watchdog
def _set_timeout(pkg, seconds):
    if pkg == "jax":
        import paddle_tpu as paddle
        paddle.set_flags({"comm_watchdog_timeout_s": seconds})
    else:
        PW.COMM_WATCHDOG_TIMEOUT_S = seconds


def _ranks(fn, n=2):
    ts = [threading.Thread(target=fn, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)


def _case_lifecycle(pkg, S, W):
    mgr = W.CommTaskManager.instance()
    tid = mgr.start_task("barrier#test", rank=0, world_size=2)
    assert any(t.task_id == tid for t in mgr.live_tasks())
    mgr.end_task(tid)
    assert all(t.task_id != tid for t in mgr.live_tasks())
    assert any(t.task_id == tid and t.done for t in mgr.history())
    assert len(mgr.history()) <= 64


def _case_hang_hook(pkg, S, W):
    mgr = W.CommTaskManager.instance()
    fired = []
    mgr.add_hang_hook(lambda task: fired.append(task.name))
    _set_timeout(pkg, 0.5)
    try:
        with W.comm_task("recv(0->1)#hang", rank=1, world_size=2):
            deadline = time.monotonic() + 6
            while not fired and time.monotonic() < deadline:
                time.sleep(0.1)
    finally:
        _set_timeout(pkg, 300.0)
        mgr._hang_hooks.clear()
    assert "recv(0->1)#hang" in fired


def _case_error(pkg, S, W):
    mgr = W.CommTaskManager.instance()
    with pytest.raises(ValueError):
        with W.comm_task("failing-op", rank=0, world_size=1):
            raise ValueError("boom")
    last = mgr.history()[-1]
    assert last.name == "failing-op" and "boom" in last.error


def _case_heartbeat(pkg, S, W):
    store = S.TCPStore(is_master=True, world_size=1)
    hb0 = W.Heartbeat(store, 0, interval=0.2).start()
    try:
        time.sleep(0.3)
        assert W.dead_peers(store, 2, probe=0.6) == [1]
    finally:
        hb0.stop()
    assert 0 in W.dead_peers(store, 2, probe=0.6)
    _stop(store)


def _case_static_match(pkg, S, W):
    store = S.TCPStore(is_master=True, world_size=1)
    errs = []

    def rank_fn(r):
        try:
            W.static_check_meta(store, r, 2, "all_reduce", 0,
                                shape=(4, 8), dtype="float32")
        except Exception as e:  # noqa: BLE001
            errs.append((r, e))
    _ranks(rank_fn)
    assert not errs
    _stop(store)


MISMATCH_TEXTS = {
    0: "comm_static_check failed for 'all_gather' seq 1: rank 1 brings "
       "{'shape': [4, 9], 'dtype': 'float32'}, rank 0 brings "
       "{'shape': [4, 8], 'dtype': 'float32'}",
    1: "comm_static_check failed for 'all_gather' seq 1: rank 1 meta "
       "{'shape': [4, 9], 'dtype': 'float32'} != rank 0 meta "
       "{'shape': [4, 8], 'dtype': 'float32'}"}


def _case_static_mismatch(pkg, S, W):
    store = S.TCPStore(is_master=True, world_size=1)
    errs = {}

    def rank_fn(r):
        try:
            W.static_check_meta(store, r, 2, "all_gather", 1,
                                shape=(4, 8) if r == 0 else (4, 9),
                                dtype="float32")
        except Exception as e:  # noqa: BLE001
            errs[r] = str(e)
    _ranks(rank_fn)
    assert errs == MISMATCH_TEXTS       # the same texts on both packages
    _stop(store)


def _case_static_gc(pkg, S, W):
    store = S.TCPStore(is_master=True, world_size=1)
    for seq in range(3):
        def rank_fn(r, s=seq):
            W.static_check_meta(store, r, 2, "all_reduce", s,
                                shape=(2,), dtype="float32")
        _ranks(rank_fn)
    assert not store.check("__meta__/0/all_reduce/0/0")
    assert not store.check("__meta__/0/all_reduce/0/verdict")
    assert not store.check("__meta__/0/all_reduce/1/1")
    _stop(store)


WATCHDOG_CASES = {"lifecycle": _case_lifecycle, "hang_hook": _case_hang_hook,
                  "error": _case_error, "heartbeat": _case_heartbeat,
                  "static_match": _case_static_match,
                  "static_mismatch": _case_static_mismatch,
                  "static_gc": _case_static_gc}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", sorted(WATCHDOG_CASES))
def test_watchdog_cases_on_both_packages(case, pkg):
    S, W = _mods(pkg)[:2]
    WATCHDOG_CASES[case](pkg, S, W)


def test_the_watchdog_constants_are_the_jax_defaults():
    from paddle_tpu import flags
    assert (PW.ENABLE_COMM_WATCHDOG, PW.COMM_WATCHDOG_TIMEOUT_S,
            PW.COMM_STATIC_CHECK) == (
        flags.get_flag("enable_comm_watchdog"),
        flags.get_flag("comm_watchdog_timeout_s"),
        flags.get_flag("comm_static_check")) == (True, 300.0, False)
    assert (PS.STORE_RETRIES, PS.STORE_RETRY_BACKOFF_S) == (
        flags.get_flag("store_retries"),
        flags.get_flag("store_retry_backoff_s"))


def test_destroy_process_group_stops_the_rank_heartbeat(monkeypatch):
    """A re-initialised job beats on its own store: the rank's heartbeat
    stops with its process group and is forgotten, so the next
    ``init_parallel_env`` starts one on the new store."""
    from paddle_tpu_torch.distributed import collective, parallel
    s = PS.TCPStore(is_master=True, world_size=1)
    hb = PW.Heartbeat(s, 0, interval=0.02).start()
    monkeypatch.setattr(parallel, "_heartbeat", hb)
    collective.destroy_process_group()
    assert parallel._heartbeat is None
    hb._thread.join(timeout=5)
    assert not hb._thread.is_alive()
    seq = s.get(hb.key())
    time.sleep(0.1)
    assert s.get(hb.key()) == seq
    s.stop()


# ------------------------------------------------------------------ rpc
def _add(x, y):
    return x + y


def _boom():
    raise ValueError("remote boom")


def _pair(pkg_a, pkg_b):
    """Agents alice (rank 0, ``pkg_a``) and bob (rank 1, ``pkg_b``) on one
    port store; each agent talks through a client of its package."""
    s = PS.TCPStore(is_master=True, world_size=1)
    agents = []
    for name, rank, pkg in (("alice", 0, pkg_a), ("bob", 1, pkg_b)):
        S, rpc = _mods(pkg)[0], _mods(pkg)[4]
        agents.append(rpc._RpcAgent(name, rank, 2, S.TCPStore(port=s.port)))
    t = threading.Thread(target=agents[0].register)
    t.start()
    agents[1].register()
    t.join(timeout=30)
    return s, agents


def test_rpc_sync_roundtrip_and_registry():
    from paddle_tpu_torch.distributed.rpc import WorkerInfo
    s, (a, b) = _pair("port", "port")
    try:
        assert a.workers["bob"] == WorkerInfo("bob", 1)
        assert a.invoke("bob", _add, (2, 3), {}, timeout=30).result(30) == 5
        fut = b.invoke("alice", _add, (np.arange(3), 10), {}, timeout=30)
        np.testing.assert_array_equal(fut.result(30), [10, 11, 12])
    finally:
        a.shutdown()
        b.shutdown()
        _stop(s)


def test_rpc_async_many_and_exception():
    s, (a, b) = _pair("port", "port")
    try:
        futs = [a.invoke("bob", _add, (i, i), {}, timeout=30)
                for i in range(8)]
        assert [f.result(30) for f in futs] == [0, 2, 4, 6, 8, 10, 12, 14]
        exc = a.invoke("bob", _boom, (), {}, timeout=30).exception(30)
        assert isinstance(exc, ValueError) and "remote boom" in str(exc)
    finally:
        a.shutdown()
        b.shutdown()
        _stop(s)


def test_rpc_between_a_port_agent_and_a_jax_agent():
    """Same keys, same wire: the port's alice calls the JAX package's bob
    and back, errors included."""
    s, (a, b) = _pair("port", "jax")
    try:
        assert [w.name for w in (a.workers["alice"], a.workers["bob"])] == \
            ["alice", "bob"]
        assert a.invoke("bob", _add, (2, 3), {}, timeout=30).result(30) == 5
        got = b.invoke("alice", _add, (np.arange(3), 10), {}, timeout=30)
        np.testing.assert_array_equal(got.result(30), [10, 11, 12])
        exc = b.invoke("alice", _boom, (), {}, timeout=30).exception(30)
        assert isinstance(exc, ValueError) and "remote boom" in str(exc)
    finally:
        a.shutdown()
        b.shutdown()
        _stop(s)


def test_rpc_module_surface(monkeypatch):
    """``init_rpc`` on an injected store, the worker registry, ``rpc_sync``
    to itself, ``shutdown``."""
    from paddle_tpu_torch.distributed import rpc
    s = PS.TCPStore(is_master=True, world_size=1)
    try:
        rpc.init_rpc("solo", rank=0, world_size=1, store=s)
        assert rpc.get_worker_info("solo").rank == 0
        assert [w.name for w in rpc.get_all_worker_infos()] == ["solo"]
        assert rpc.rpc_sync("solo", _add, args=(4, 5)) == 9
        assert rpc.rpc_async("solo", _add, args=(1, 1)).result(30) == 2
        with pytest.raises(RuntimeError, match="already"):
            rpc.init_rpc("again", rank=0, world_size=1, store=s)
    finally:
        rpc.shutdown()
        _stop(s)
    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("solo", _add, args=(1, 2))
