"""TCPStore: the rendezvous and control-plane key-value store.

Counterpart of ``paddle_tpu/distributed/store.py`` (Paddle's
``tcp_store.h:121``: ADD / GET / CHECK / SET / WAIT, and DEL), on the
same wire, byte for byte: a client of either package talks to a server of
either.

The server is the C++ poll loop of ``core/native/tcp_store.cc`` (built
with g++ at first use; WAIT and GET park the socket rather than a
thread), else a Python thread server speaking the same protocol.  Each
client thread has a socket of its own, so a thread parked in ``wait``
never blocks another thread's ``set``.

A request survives a transient socket error (a reset, a broken pipe): it
is retried ``STORE_RETRIES`` times in all, ``STORE_RETRY_BACKOFF_S``
doubling between attempts.  A semantic timeout (the server is up, the key
never came) is never retried: it goes to the caller, the elastic
machinery.  ADD is retried only when it failed before any byte of it can
have reached the wire (a replayed ADD counts twice).  Every request
passes the ``store.request`` chaos site; retries and lazy (re)connects
count on ``store.retries`` and ``store.reconnects``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, Optional

from ..observability import metrics as _metrics
from ..testing import chaos as _chaos

__all__ = ["Store", "TCPStore", "STORE_RETRIES", "STORE_RETRY_BACKOFF_S"]

STORE_RETRIES = 3               # the JAX flags' defaults
STORE_RETRY_BACKOFF_S = 0.05

_ADD, _GET, _CHECK, _SET, _WAIT, _STOP, _DEL = range(7)

_M_RETRIES = _metrics.counter(
    "store.retries",
    "TCPStore requests retried after a transient socket error")
_M_RECONNECTS = _metrics.counter(
    "store.reconnects",
    "TCPStore client sockets (re)established lazily: a thread's first "
    "connect or a post-drop reconnect")


class Store:
    """The store interface (Paddle's ``store.h``)."""

    def set(self, key: str, value: bytes):  # noqa: A003
        raise NotImplementedError

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, key: str, timeout: Optional[float] = None):
        raise NotImplementedError

    def check(self, key: str) -> bool:
        raise NotImplementedError

    def delete_key(self, key: str) -> None:
        raise NotImplementedError

    def barrier(self, name: str, world_size: Optional[int] = None,
                timeout: Optional[float] = None) -> None:
        """Every one of ``world_size`` processes blocks until all arrived."""
        n = world_size or self.world_size
        arrived = self.add(f"__barrier__/{name}/count", 1)
        if arrived == n:
            self.set(f"__barrier__/{name}/go", b"1")
        self.wait(f"__barrier__/{name}/go", timeout=timeout)


def _recv_exact(conn, n: int) -> bytes:
    """Exactly ``n`` bytes, or ConnectionError (a clean EOF included)."""
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-message ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf


def _send_value(conn, val: bytes):
    conn.sendall(struct.pack("<Q", len(val)) + val)


class _PyServer(threading.Thread):
    """The Python server: ``tcp_store.cc``'s protocol, a thread a client."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._store: Dict[str, bytes] = {}
        self._cv = threading.Condition()
        self._running = True
        self.start()

    def run(self):
        while self._running:
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def _park(self, key: str) -> bool:
        """Caller holds ``_cv``: wait for ``key``; False once stopped."""
        while key not in self._store:
            self._cv.wait(0.1)
            if not self._running:
                return False
        return True

    def _serve(self, conn):
        try:
            while True:
                cmd = _recv_exact(conn, 1)[0]
                klen = struct.unpack("<I", _recv_exact(conn, 4))[0]
                key = _recv_exact(conn, klen).decode()
                vlen = struct.unpack("<Q", _recv_exact(conn, 8))[0]
                val = _recv_exact(conn, vlen) if vlen else b""
                if cmd == _ADD:
                    with self._cv:
                        cur = int(self._store.get(key, b"0")) + int(val)
                        self._store[key] = str(cur).encode()
                        self._cv.notify_all()
                    _send_value(conn, str(cur).encode())
                elif cmd == _SET:
                    with self._cv:
                        self._store[key] = val
                        self._cv.notify_all()
                    conn.sendall(b"\x01")
                elif cmd == _CHECK:
                    conn.sendall(b"\x01" if key in self._store else b"\x00")
                elif cmd == _GET:
                    with self._cv:
                        if not self._park(key):
                            return
                        out = self._store[key]
                    _send_value(conn, out)
                elif cmd == _WAIT:
                    with self._cv:
                        if not self._park(key):
                            return
                    conn.sendall(b"\x01")
                elif cmd == _DEL:
                    with self._cv:
                        self._store.pop(key, None)
                    conn.sendall(b"\x01")
                elif cmd == _STOP:
                    conn.sendall(b"\x01")
                    self._running = False
                    return
        except (OSError, ConnectionError, struct.error, ValueError):
            return
        finally:
            conn.close()

    def stop(self):
        self._running = False


class _NativeServer:
    """The C++ server of ``core/native/tcp_store.cc``."""

    def __init__(self, port: int):
        import ctypes

        from ..core import native
        lib = native.build("tcp_store")
        if lib is None:
            raise OSError("native build unavailable")
        lib.pts_start.argtypes = [ctypes.c_int]
        lib.pts_start.restype = ctypes.c_int
        lib.pts_port.argtypes = [ctypes.c_int]
        lib.pts_port.restype = ctypes.c_int
        lib.pts_stop.argtypes = [ctypes.c_int]
        lib.pts_stop.restype = None
        self._lib = lib
        self._handle = lib.pts_start(port)
        if self._handle < 0:
            raise OSError(f"pts_start failed: {self._handle}")
        self.port = lib.pts_port(self._handle)

    def stop(self):
        if self._handle is not None:
            self._lib.pts_stop(self._handle)
            self._handle = None


class TCPStore(Store):
    """A client of the store, and with ``is_master`` its server.

    ``TCPStore(host, port, is_master=False, world_size=1, timeout=900)``:
    the master starts the server (C++ where g++ builds it, else Python)
    on ``port`` (0: a free one, then in ``.port``); every process, the
    master included, connects one socket per calling thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 900.0):
        self.host = host
        self.world_size = world_size
        self.timeout = timeout
        self._server = None
        if is_master:
            try:
                self._server = _NativeServer(port)
            except OSError:
                self._server = _PyServer(port)
            port = self._server.port
        if port == 0:
            raise ValueError("non-master TCPStore needs the master's port")
        self.port = port
        self._tls = threading.local()
        self._connect()     # fail fast, from the constructing thread

    @property
    def is_native(self) -> bool:
        return isinstance(self._server, _NativeServer)

    def _connect(self):
        deadline = time.time() + min(self.timeout, 60.0)
        last = None
        while time.time() < deadline:
            try:
                c = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
                c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._tls.conn = c
                return c
            except OSError as e:
                last = e
                time.sleep(0.05)
        raise TimeoutError(f"cannot reach TCPStore at "
                           f"{self.host}:{self.port}: {last}")

    def _conn_for_thread(self):
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = self._connect()
            _M_RECONNECTS.inc()
        return conn

    def _drop_conn(self):
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._tls.conn = None

    def _request(self, cmd: int, key: str, val: bytes = b"",
                 timeout: Optional[float] = None) -> bytes:
        kb = key.encode()
        msg = struct.pack("<BI", cmd, len(kb)) + kb + \
            struct.pack("<Q", len(val)) + val
        retries = max(1, int(STORE_RETRIES))
        attempt = 0
        while True:
            wired = False   # may any byte of this attempt be on the wire?
            try:
                conn = self._conn_for_thread()
                _chaos.inject("store.request")
                conn.settimeout(
                    timeout if timeout is not None else self.timeout)
                wired = True
                conn.sendall(msg)
                if cmd in (_ADD, _GET):
                    ln = struct.unpack("<Q", _recv_exact(conn, 8))[0]
                    return _recv_exact(conn, ln) if ln else b""
                return _recv_exact(conn, 1)
            except socket.timeout:
                if not wired:
                    raise   # _connect spent its own bounded deadline
                # a semantic timeout: the server answers, the key never
                # came.  A retry cannot help and would hide a dead peer;
                # the socket is out of step, so it goes
                self._drop_conn()
                raise TimeoutError(
                    f"TCPStore request cmd={cmd} key={key!r} timed out")
            except (OSError, ConnectionError):
                self._drop_conn()
                attempt += 1
                if (cmd == _ADD and wired) or attempt >= retries:
                    raise
                _M_RETRIES.inc()
                time.sleep(STORE_RETRY_BACKOFF_S * (2 ** (attempt - 1)))

    def set(self, key: str, value) -> None:  # noqa: A003
        if isinstance(value, str):
            value = value.encode()
        self._request(_SET, key, bytes(value))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        return self._request(_GET, key, timeout=timeout)

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._request(_ADD, key, str(int(amount)).encode()))

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        self._request(_WAIT, key, timeout=timeout)

    def check(self, key: str) -> bool:
        return self._request(_CHECK, key) == b"\x01"

    def delete_key(self, key: str) -> None:
        self._request(_DEL, key)

    def stop(self) -> None:
        """Stop this process's server (a no-op for a client)."""
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __del__(self):
        try:
            self._drop_conn()
            if self._server is not None:
                self._server.stop()
        except Exception:   # noqa: BLE001 - interpreter teardown
            pass

