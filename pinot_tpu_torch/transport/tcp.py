"""TCP data-plane transport with 4-byte length framing.

The reference's data plane is Netty TCP with a
``LengthFieldBasedFrameDecoder``/``Prepender`` (4-byte prefix,
``NettyTCPServer.java:93-94``) and async keyed connection pools
(``transport/pool/AsyncPoolImpl.java``).  The equivalent here:
threaded socket server + per-server blocking-socket pools, with the
broker fanning requests out on a thread pool (``scatter_gather.py``).
Queries between processes ride this; the heavy lifting (the query
itself) is on-device, so the transport's job is framing, pooling,
timeouts, and failure isolation.

(Copy of ``pinot_tpu.transport.tcp``.)
"""
from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

MAX_FRAME = 1 << 30


logger = logging.getLogger(__name__)


class TransportError(Exception):
    pass


_BIG_FRAME = 1 << 16


def send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) < _BIG_FRAME:
        sock.sendall(struct.pack(">I", len(payload)) + payload)
    else:
        # large frames (columnar ingest blocks, shuffle exchanges):
        # never concat-copy megabytes just to prepend 4 bytes — two
        # sendalls cost one extra syscall, not an extra full copy
        sock.sendall(struct.pack(">I", len(payload)))
        sock.sendall(payload)


def recv_frame(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 4)
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME:
        raise TransportError(f"frame too large: {n}")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # recv_into a preallocated buffer: no per-chunk append/copy churn
    # on multi-megabyte frames (columnar ingest blocks)
    buf = bytearray(n)
    view = memoryview(buf)
    pos = 0
    while pos < n:
        got = sock.recv_into(view[pos:], n - pos)
        if not got:
            raise TransportError("connection closed")
        pos += got
    return bytes(buf)


class TcpServer:
    """Length-framed request/response server; one thread per connection
    (the NettyServer.RequestHandler analog, ``NettyServer.java:80``)."""

    def __init__(self, handler: Callable[[bytes], bytes], host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._threads: List[threading.Thread] = []

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> None:
        self._running = True
        self._sock.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError as e:
                if self._running:
                    # transient failure (e.g. EMFILE under fd pressure)
                    # must not kill the accept loop — only shutdown does
                    logger.warning("accept failed on %s: %s", self.address, e)
                    import time as _time

                    _time.sleep(0.05)
                    continue
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    payload = recv_frame(conn)
                except TransportError:
                    return
                try:
                    reply = self.handler(payload)
                except Exception as e:  # handler errors must not kill the conn
                    reply = b"ERR:" + str(e).encode("utf-8", "replace")
                send_frame(conn, reply)
        finally:
            conn.close()

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class _Pool:
    """Blocking-socket pool for one server (KeyedPoolImpl analog)."""

    def __init__(self, address: Tuple[str, int], max_size: int = 8):
        self.address = address
        self.max_size = max_size
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()

    def checkout(self, timeout: float) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        sock = socket.create_connection(self.address, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if len(self._idle) < self.max_size:
                self._idle.append(sock)
                return
        sock.close()

    def destroy(self, sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass


class TcpTransport:
    """Client side: pooled request/response to named servers."""

    def __init__(self) -> None:
        self._pools: Dict[Tuple[str, int], _Pool] = {}
        self._lock = threading.Lock()

    def _pool(self, address: Tuple[str, int]) -> _Pool:
        with self._lock:
            pool = self._pools.get(address)
            if pool is None:
                pool = _Pool(address)
                self._pools[address] = pool
            return pool

    def request(self, address: Tuple[str, int], payload: bytes, timeout: float = 15.0) -> bytes:
        pool = self._pool(address)
        sock = pool.checkout(timeout)
        try:
            sock.settimeout(timeout)
            send_frame(sock, payload)
            reply = recv_frame(sock)
        except (OSError, TransportError) as e:
            pool.destroy(sock)
            raise TransportError(str(e)) from e
        pool.checkin(sock)
        if reply[:4] == b"ERR:":
            raise TransportError(reply[4:].decode("utf-8", "replace"))
        return reply
