"""Transport abstraction (the JAX package's ``comm/communicator.py``).

Transports carry opaque bytes. Protocol names are the JAX package's:
``inproc`` is the in-process hub (``comm/inproc.py``), ``tcp-py`` the
pure-Python TCP transport (``comm/tcp_py.py``) and ``tcp`` the native C++
transport, which the port does not have yet: it is refused by name and
never replaced by ``tcp-py`` quietly. A node may listen without a send
target or send without listening.

``DEFAULT_MAX_MSG_BYTES`` and :func:`parse_addr` are copies of the JAX
package's ``config.py`` entries of the same names.
"""

from __future__ import annotations

import abc
from typing import Callable

__all__ = ["Communicator", "create_communicator", "DEFAULT_MAX_MSG_BYTES", "parse_addr"]

DEFAULT_MAX_MSG_BYTES = 16 * 1024 * 1024


def parse_addr(addr: str) -> tuple[str, int]:
    """``"host:port"`` → ``(host, port)``."""
    host, _, port = addr.rpartition(":")
    return host, int(port)


class Communicator(abc.ABC):
    """One directed edge: this node's inbound listener plus (optionally) a
    persistent channel to one target node."""

    @abc.abstractmethod
    def send(self, data: bytes) -> None:
        """Queue ``data`` for delivery to the target (ordered)."""

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        """Attempt delivery, giving up after ``timeout_s``; False on
        timeout. Default: delegate to :meth:`send`."""
        self.send(data)
        return True

    def retarget(self, target_addr: str | None) -> None:
        """Switch the send channel to a new target. Default: unsupported."""
        raise NotImplementedError(f"{type(self).__name__} cannot retarget")

    def connected(self) -> bool:
        """Best-effort: is the send channel live? Default: True."""
        return True

    @abc.abstractmethod
    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        """Register the function called with each received payload. Must be
        called before messages arrive."""

    @abc.abstractmethod
    def is_ordered(self) -> bool:
        """True if the transport keeps per-link FIFO order."""

    @abc.abstractmethod
    def target_address(self) -> str | None: ...

    @abc.abstractmethod
    def close(self) -> None: ...


def create_communicator(
    protocol: str,
    bind_addr: str | None,
    target_addr: str | None,
    max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES,
) -> Communicator:
    """Build a transport endpoint. ``bind_addr=None`` → send-only;
    ``target_addr=None`` → listen-only. The JAX factory's fault-injection
    wrapper (``comm/faults.py``) is not ported yet."""
    if protocol == "inproc":
        from radixmesh_tpu_torch.comm.inproc import InprocCommunicator

        return InprocCommunicator(bind_addr, target_addr)
    if protocol == "tcp-py":
        from radixmesh_tpu_torch.comm.tcp_py import PyTcpCommunicator

        return PyTcpCommunicator(bind_addr, target_addr, max_msg_bytes)
    if protocol == "tcp":
        raise NotImplementedError(
            "protocol 'tcp' (the native C++ transport) is not ported to the PyTorch port "
            "yet (see ROADMAP.md, queue A item 7); 'tcp-py' speaks the same frames"
        )
    raise ValueError(f"unknown protocol {protocol!r}; known: inproc, tcp, tcp-py")
