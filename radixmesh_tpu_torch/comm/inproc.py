"""In-process transport hub (the JAX package's ``comm/inproc.py``): no
sockets and no ports. Messages are delivered on one worker thread per hub,
which keeps per-link FIFO order as TCP does."""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from radixmesh_tpu_torch.comm.communicator import Communicator
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["InprocCommunicator", "InprocHub"]


class InprocHub:
    """Shared registry of listening endpoints plus one delivery thread."""

    _default: "InprocHub | None" = None
    _default_lock = threading.Lock()

    def __init__(self):
        self._listeners: dict[str, InprocCommunicator] = {}
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True, name="inproc-hub")
        self._thread.start()

    @classmethod
    def default(cls) -> "InprocHub":
        with cls._default_lock:
            if cls._default is None:
                cls._default = cls()
            return cls._default

    @classmethod
    def reset_default(cls) -> None:
        with cls._default_lock:
            hub, cls._default = cls._default, None
        if hub is not None:
            hub._q.put(None)

    def register(self, addr: str, comm: "InprocCommunicator") -> None:
        with self._lock:
            if addr in self._listeners:
                raise ValueError(f"address {addr!r} already bound")
            self._listeners[addr] = comm

    def unregister(self, addr: str) -> None:
        with self._lock:
            self._listeners.pop(addr, None)

    def post(self, target: str, data: bytes) -> None:
        self._q.put((target, data))

    def has_listener(self, addr: str) -> bool:
        with self._lock:
            return addr in self._listeners

    def _run(self) -> None:
        while True:
            # meshcheck: ok[timeout-audit] the hub's delivery pump blocks
            # on its OWN queue and is woken by a None shutdown sentinel —
            # no peer is involved, so there is nothing to deadline.
            item = self._q.get()
            if item is None:
                return
            target, data = item
            with self._lock:
                comm = self._listeners.get(target)
            if comm is not None and comm._callback is not None:
                try:
                    comm._callback(data)
                except Exception:  # noqa: BLE001 — a bad callback must not kill delivery
                    get_logger("comm").exception("inproc receive callback failed")


class InprocCommunicator(Communicator):
    def __init__(self, bind_addr: str | None, target_addr: str | None, hub: InprocHub | None = None):
        self._hub = hub or InprocHub.default()
        self._bind = bind_addr
        self._target = target_addr
        self._callback: Callable[[bytes], None] | None = None
        self._closed = False
        if bind_addr is not None:
            self._hub.register(bind_addr, self)

    def send(self, data: bytes) -> None:
        if self._closed:
            raise RuntimeError("communicator closed")
        if self._target is None:
            raise RuntimeError("send-only target not configured")
        self._hub.post(self._target, bytes(data))

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        """Delivery fails if the target has no live listener, after polling
        for ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while not self._closed:
            if self._hub.has_listener(self._target):
                self._hub.post(self._target, bytes(data))
                return True
            if time.monotonic() >= deadline:
                return False
            # meshcheck: ok[sleep-audit] bounded listener-appearance poll
            # inside a deadline loop; the hub has no registration event.
            time.sleep(0.005)
        raise RuntimeError("communicator closed")

    def retarget(self, target_addr: str | None) -> None:
        self._target = target_addr

    def connected(self) -> bool:
        return self._target is not None and self._hub.has_listener(self._target)

    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        self._callback = fn

    def is_ordered(self) -> bool:
        return True

    def target_address(self) -> str | None:
        return self._target

    def close(self) -> None:
        self._closed = True
        if self._bind is not None:
            self._hub.unregister(self._bind)
