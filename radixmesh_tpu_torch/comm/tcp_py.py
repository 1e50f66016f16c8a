"""Pure-Python TCP transport (the JAX package's ``comm/tcp_py.py``).

Frames are ``[4-byte big-endian length][payload]``, the JAX package's and
its native transport's, so a port node and a JAX node talk over it. A
sender raises on a payload above ``max_msg_bytes``; a reader drops a
connection that announces a larger frame.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable

from radixmesh_tpu_torch.comm.communicator import Communicator
from radixmesh_tpu_torch.config import DEFAULT_MAX_MSG_BYTES, parse_addr
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["PyTcpCommunicator"]

_LEN = struct.Struct(">I")


class PyTcpCommunicator(Communicator):
    def __init__(
        self,
        bind_addr: str | None,
        target_addr: str | None,
        max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES,
    ):
        self._log = get_logger("comm.tcp_py")
        self._bind = bind_addr
        self._target = target_addr
        self._max_msg = max_msg_bytes
        self._callback: Callable[[bytes], None] | None = None
        self._closed = threading.Event()
        self._send_lock = threading.Lock()
        self._send_sock: socket.socket | None = None
        self._listen_sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []

        if bind_addr is not None:
            host, port = parse_addr(bind_addr)
            self._listen_sock = socket.create_server((host, port), backlog=64)
            t = threading.Thread(target=self._accept_loop, daemon=True, name="tcp-py-accept")
            t.start()
            self._threads.append(t)

    # ---- receive path ----

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listen_sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            t = threading.Thread(target=self._handle_conn, args=(conn,), daemon=True,
                                 name="tcp-py-reader")
            t.start()
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                hdr = self._recv_all(conn, 4)
                if hdr is None:
                    return
                (length,) = _LEN.unpack(hdr)
                if length == 0 or length > self._max_msg:
                    self._log.error("dropping conn: bad frame length %d", length)
                    return
                payload = self._recv_all(conn, length)
                if payload is None:
                    return
                cb = self._callback
                if cb is not None:
                    try:
                        cb(payload)
                    except Exception:  # noqa: BLE001 — a bad callback must not kill the reader
                        self._log.exception("receive callback failed")
        finally:
            conn.close()

    @staticmethod
    def _recv_all(conn: socket.socket, n: int) -> bytes | None:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                r = conn.recv_into(view[got:], n - got)
            except OSError:
                return None
            if r == 0:
                return None
            got += r
        return bytes(buf)

    # ---- send path ----

    def _connect(self, deadline: float | None = None) -> socket.socket | None:
        host, port = parse_addr(self._target)
        while not self._closed.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                return None
            try:
                timeout = 5.0
                if deadline is not None:
                    timeout = min(timeout, max(0.05, deadline - time.monotonic()))
                s = socket.create_connection((host, port), timeout=timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(None)
                return s
            except OSError:
                # meshcheck: ok[sleep-audit] reconnect backoff between
                # bounded create_connection attempts (peer not up yet).
                time.sleep(0.1)
        raise RuntimeError("communicator closed while connecting")

    def send(self, data: bytes) -> None:
        # Retries (reconnecting) until delivered or closed: at-least-once.
        if not self._send_impl(data, deadline=None):
            raise RuntimeError("communicator closed while sending")

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        return self._send_impl(data, deadline=time.monotonic() + timeout_s)

    def _send_impl(self, data: bytes, deadline: float | None) -> bool:
        if self._closed.is_set():
            raise RuntimeError("communicator closed")
        if self._target is None:
            raise RuntimeError("send-only target not configured")
        if len(data) > self._max_msg:
            raise ValueError(
                f"message of {len(data)} bytes exceeds max_msg_bytes={self._max_msg}"
            )
        frame = _LEN.pack(len(data)) + data
        with self._send_lock:
            while not self._closed.is_set():
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                try:
                    if self._send_sock is None:
                        self._send_sock = self._connect(deadline)
                        if self._send_sock is None:
                            return False  # deadline hit while connecting
                    self._send_sock.sendall(frame)
                    return True
                except OSError:
                    if self._send_sock is not None:
                        self._send_sock.close()
                        self._send_sock = None
                    # meshcheck: ok[sleep-audit] reconnect backoff after a
                    # send failure; the outer loop is deadline-bounded.
                    time.sleep(0.05)
            if deadline is None:
                raise RuntimeError("communicator closed while sending")
            return False

    def retarget(self, target_addr: str | None) -> None:
        """Switch the send channel; the next send connects to the new
        target."""
        with self._send_lock:
            if self._send_sock is not None:
                self._send_sock.close()
                self._send_sock = None
            self._target = target_addr

    def connected(self) -> bool:
        return self._send_sock is not None

    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        self._callback = fn

    def is_ordered(self) -> bool:
        return True

    def target_address(self) -> str | None:
        return self._target

    def close(self) -> None:
        self._closed.set()
        if self._send_sock is not None:
            self._send_sock.close()
        if self._listen_sock is not None:
            self._listen_sock.close()
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
