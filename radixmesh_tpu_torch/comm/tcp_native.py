"""ctypes binding to the native C++ transport (``native/transport.cpp``,
the JAX package's source, copied).

The shared library is compiled with ``g++`` at first use (plain C ABI and
ctypes, no pybind11) into ``ops/_build/`` (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads straight away. Each build writes a temporary file and renames it
into place, so processes that build at once do not collide. A failed
build raises: the transport is never swapped for ``tcp-py``.

Length-framed ordered delivery (``[4-byte big-endian length][payload]``,
the framing of ``tcp_py.py``, so the two interoperate), a persistent
auto-reconnecting sender, a listener thread pool, and asymmetric
listen-only / send-only endpoints.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

from radixmesh_tpu_torch.comm.communicator import Communicator
from radixmesh_tpu_torch.config import DEFAULT_MAX_MSG_BYTES, parse_addr
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["NativeTcpCommunicator", "load_native_lib"]

_SRC = Path(__file__).resolve().parent / "native" / "transport.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build"
_GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_CALLBACK_T = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_void_p
)

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libtransport-{digest}.so"


def _build(lib: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the native transport builds from {_SRC} at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    r = subprocess.run([gxx, *_GXX_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native transport from {_SRC} failed (g++ exit {r.returncode}):\n{r.stderr}"
        )
    os.replace(tmp, lib)


def load_native_lib() -> ctypes.CDLL:
    """Load the native transport library, building it first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.rm_listener_create.restype = ctypes.c_void_p
        lib.rm_listener_create.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_uint64,
            _CALLBACK_T,
            ctypes.c_void_p,
        ]
        lib.rm_listener_close.argtypes = [ctypes.c_void_p]
        lib.rm_sender_create.restype = ctypes.c_void_p
        lib.rm_sender_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
        lib.rm_send.restype = ctypes.c_int
        lib.rm_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.rm_sender_connected.restype = ctypes.c_int
        lib.rm_sender_connected.argtypes = [ctypes.c_void_p]
        lib.rm_sender_flush.argtypes = [ctypes.c_void_p]
        lib.rm_sender_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeTcpCommunicator(Communicator):
    def __init__(
        self,
        bind_addr: str | None,
        target_addr: str | None,
        max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES,
    ):
        self._lib = load_native_lib()
        self._log = get_logger("comm.tcp")
        self._bind = bind_addr
        self._target = target_addr
        self._max_msg = max_msg_bytes
        self._callback: Callable[[bytes], None] | None = None
        self._listener = None
        self._sender = None
        self._closed = False

        # Keep a reference to the ctypes callback trampoline for the life of
        # the listener — if it's collected, the C side calls freed memory.
        def _trampoline(data, length, _user):
            cb = self._callback
            if cb is None:
                return
            try:
                cb(ctypes.string_at(data, length))
            except Exception:  # noqa: BLE001 — receiver bugs must not kill the reader thread
                self._log.exception("receive callback failed")

        self._c_callback = _CALLBACK_T(_trampoline)

        if bind_addr is not None:
            host, port = parse_addr(bind_addr)
            self._listener = self._lib.rm_listener_create(
                host.encode(), port, max_msg_bytes, self._c_callback, None
            )
            if not self._listener:
                raise OSError(f"failed to bind native listener on {bind_addr}")
        if target_addr is not None:
            host, port = parse_addr(target_addr)
            self._sender = self._lib.rm_sender_create(host.encode(), port, max_msg_bytes)
            if not self._sender:
                raise OSError(f"failed to create native sender to {target_addr}")

    def send(self, data: bytes) -> None:
        if self._closed:
            raise RuntimeError("communicator closed")
        if self._sender is None:
            raise RuntimeError("send-only target not configured")
        if len(data) > self._max_msg:
            raise ValueError(
                f"message of {len(data)} bytes exceeds max_msg_bytes={self._max_msg}"
            )
        rc = self._lib.rm_send(self._sender, data, len(data))
        if rc != 0:
            raise RuntimeError(f"native send failed (rc={rc})")

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        """Failure-detection send. The native sender connects LAZILY — its
        background thread only dials once the queue is non-empty — so the
        frame must be enqueued FIRST, then the connection awaited: polling
        ``connected`` before enqueueing would wait on a dial that never
        starts. ``connected`` is a liveness signal, not a per-message
        delivery ack; a frame accepted here is delivered at-least-once by
        the background retry loop if the peer is ever reachable. On False
        the frame stays queued: callers either retarget (dropping the old
        handle and its queue) or back off and let the backlog drain when
        the peer appears."""
        if self._closed:
            raise RuntimeError("communicator closed")
        if self._sender is None:
            raise RuntimeError("send-only target not configured")
        self.send(data)
        deadline = time.monotonic() + timeout_s
        while not self._lib.rm_sender_connected(self._sender):
            if self._closed:
                raise RuntimeError("communicator closed")
            if time.monotonic() >= deadline:
                return False
            # meshcheck: ok[sleep-audit] bounded connect poll against the
            # native library's connected flag (no readiness callback).
            time.sleep(0.01)
        return True

    def retarget(self, target_addr: str | None) -> None:
        """Swap the native sender for one aimed at the new target. Caller
        (the mesh sender thread) serializes with sends."""
        old, self._sender = self._sender, None
        if old is not None:
            self._lib.rm_sender_close(old)
        self._target = target_addr
        if target_addr is not None:
            host, port = parse_addr(target_addr)
            sender = self._lib.rm_sender_create(host.encode(), port, self._max_msg)
            if not sender:
                raise OSError(f"failed to create native sender to {target_addr}")
            self._sender = sender

    def connected(self) -> bool:
        return self._sender is not None and bool(
            self._lib.rm_sender_connected(self._sender)
        )

    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        self._callback = fn

    def is_ordered(self) -> bool:
        return True

    def target_address(self) -> str | None:
        return self._target

    def flush(self) -> None:
        if self._sender is not None:
            self._lib.rm_sender_flush(self._sender)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._sender is not None:
            self._lib.rm_sender_close(self._sender)
            self._sender = None
        if self._listener is not None:
            self._lib.rm_listener_close(self._listener)
            self._listener = None
