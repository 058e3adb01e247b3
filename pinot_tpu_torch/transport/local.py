"""In-process transport: direct handler dispatch.

Used by the single-process quickstart and the in-process cluster tests
(the reference's integration tests also run all roles in one JVM,
``PerfBenchmarkDriver.java:160-162``); same interface as TcpTransport so
broker code is transport-agnostic.

(Copy of ``pinot_tpu.transport.local``.)
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

from pinot_tpu_torch.transport.tcp import TransportError


class LocalTransport:
    def __init__(self) -> None:
        self._handlers: Dict[Tuple[str, int], Callable[[bytes], bytes]] = {}
        self._lock = threading.Lock()
        self._down: set = set()

    def register(self, address: Tuple[str, int], handler: Callable[[bytes], bytes]) -> None:
        with self._lock:
            self._handlers[address] = handler

    def set_down(self, address: Tuple[str, int], down: bool = True) -> None:
        """Simulate a dead server (for partial-failure tests)."""
        with self._lock:
            if down:
                self._down.add(address)
            else:
                self._down.discard(address)

    def request(self, address: Tuple[str, int], payload: bytes, timeout: float = 15.0) -> bytes:
        with self._lock:
            if address in self._down:
                raise TransportError(f"server {address} unreachable")
            handler = self._handlers.get(address)
        if handler is None:
            raise TransportError(f"no handler at {address}")
        reply = handler(payload)
        if reply[:4] == b"ERR:":
            raise TransportError(reply[4:].decode("utf-8", "replace"))
        return reply
