"""Transport abstraction for the oplog ring.

Capability parity with the reference's ``communication/communicator.py:14-29``
``Communicator`` ABC (``send``, ``register_rcv_callback``, ``is_ordered``,
``target_address``) and its ``create_communicator`` factory
(``communicator.py:273-276``) — with two deliberate fixes:

- Transports carry **opaque bytes**; oplog serialization lives in
  ``cache/oplog.py``. (The reference couples the JSON serializer into the
  transport, inheriting its GC-field-dropping bug.)
- Protocol names are honest: ``tcp`` is the native C++ transport, ``tcp-py``
  the pure-Python fallback, ``inproc`` the in-process test hub. (The
  reference routes every protocol except the literal string ``'test'`` to
  the half-implemented mooncake RDMA path, including its own default
  ``'tcp'`` — ``communicator.py:273-276`` vs ``cache_config.py:14``.)

Asymmetric endpoints are allowed exactly as in the reference
(``communicator.py:146-157``): a node may listen without a send target
(router) or send without listening.
"""

from __future__ import annotations

import abc
from typing import Callable

from radixmesh_tpu_torch.config import DEFAULT_MAX_MSG_BYTES

__all__ = ["Communicator", "create_communicator"]


class Communicator(abc.ABC):
    """One directed edge of the replication topology: this node's inbound
    listener plus (optionally) a persistent channel to one target node."""

    @abc.abstractmethod
    def send(self, data: bytes) -> None:
        """Queue ``data`` for delivery to the target (async, ordered)."""

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        """Attempt delivery, giving up after ``timeout_s``. Returns False
        on timeout — the failure-detection primitive: a ring predecessor
        is the only node positioned to observe its successor's death
        (``policy/topology.py``). Default: delegate to :meth:`send`."""
        self.send(data)
        return True

    def retarget(self, target_addr: str | None) -> None:
        """Atomically switch the send channel to a new target (ring
        re-formation after a view change). Default: unsupported."""
        raise NotImplementedError(f"{type(self).__name__} cannot retarget")

    def connected(self) -> bool:
        """Best-effort: is the send channel currently live? Failure
        detection only *suspects* peers it has seen connected at least
        once — a slow-starting peer must never be declared dead before
        first contact. Default: True (transports without the signal)."""
        return True

    @abc.abstractmethod
    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        """Register the function invoked with each received message's
        payload. Must be called before messages arrive."""

    @abc.abstractmethod
    def is_ordered(self) -> bool:
        """True if the transport preserves per-link FIFO order (the ring
        replication protocol assumes it — reference ``radix_mesh.py:404-409``)."""

    @abc.abstractmethod
    def target_address(self) -> str | None: ...

    @abc.abstractmethod
    def close(self) -> None: ...


def create_communicator(
    protocol: str,
    bind_addr: str | None,
    target_addr: str | None,
    max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES,
    src_hint: str | None = None,
) -> Communicator:
    """Build a transport endpoint. ``bind_addr=None`` → send-only;
    ``target_addr=None`` → listen-only.

    This factory is ALSO the chaos seam (``comm/faults.py``): when a
    :class:`~radixmesh_tpu_torch.comm.faults.FaultPlan` is installed, the
    returned endpoint is wrapped in a ``FaultyCommunicator`` that drops,
    delays, duplicates, reorders, partitions, or crashes sends per the
    plan's seeded schedule — product code above this seam never knows.
    ``src_hint`` names the owning node for send-only channels (whose
    ``bind_addr`` is None), so symmetric partitions cut their outbound
    traffic too; it has no effect without an armed plan."""
    if protocol == "inproc":
        from radixmesh_tpu_torch.comm.inproc import InprocCommunicator

        comm: Communicator = InprocCommunicator(bind_addr, target_addr)
    elif protocol == "tcp-py":
        from radixmesh_tpu_torch.comm.tcp_py import PyTcpCommunicator

        comm = PyTcpCommunicator(bind_addr, target_addr, max_msg_bytes)
    elif protocol == "tcp":
        from radixmesh_tpu_torch.comm.tcp_native import NativeTcpCommunicator

        comm = NativeTcpCommunicator(bind_addr, target_addr, max_msg_bytes)
    else:
        raise ValueError(
            f"unknown protocol {protocol!r}; known: inproc, tcp, tcp-py"
        )
    from radixmesh_tpu_torch.comm import faults

    return faults.maybe_wrap(comm, src=bind_addr or src_hint, dst=target_addr)
