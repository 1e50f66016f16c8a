"""The port's transports (``radixmesh_tpu_torch/comm/``): twins of
``tests/test_comm.py``'s in-process and Python-TCP cases, plus the native
``tcp`` protocol (built from the repo's source with ``g++`` at first use,
raising if the build fails) and the frames of both packages' transports
interoperating. Every socket test runs under its own timeout. The whole of
``tests/test_comm.py`` also runs against the port in
``test_torch_transport_twin.py``."""

import functools
import socket
import threading
import time

import pytest

from radixmesh_tpu_torch.comm.communicator import create_communicator
from radixmesh_tpu_torch.comm.inproc import InprocHub
from radixmesh_tpu_torch.config import DEFAULT_MAX_MSG_BYTES, parse_addr

# Wall-clock limit of each socket test (seconds).
SOCKET_TIMEOUT_S = 30


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def bounded(fn):
    """Run a socket test body on a daemon thread with a deadline, so a hung
    socket fails the test instead of hanging the suite."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        err: list = []

        def run():
            try:
                fn(*args, **kw)
            except BaseException as e:  # noqa: BLE001 — re-raised on the test thread
                err.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(SOCKET_TIMEOUT_S)
        assert not t.is_alive(), f"{fn.__name__} did not finish in {SOCKET_TIMEOUT_S} s"
        if err:
            raise err[0]

    return wrapper


class Collector:
    def __init__(self):
        self.messages = []
        self.lock = threading.Lock()

    def __call__(self, data: bytes):
        with self.lock:
            self.messages.append(data)

    def __len__(self):
        with self.lock:
            return len(self.messages)


@pytest.fixture(autouse=True)
def fresh_inproc_hub():
    InprocHub.reset_default()
    yield
    InprocHub.reset_default()


def test_config_copies_match_the_jax_package():
    from radixmesh_tpu import config

    assert DEFAULT_MAX_MSG_BYTES == config.DEFAULT_MAX_MSG_BYTES
    for addr in ("127.0.0.1:5000", "node-a:61234", "::1:80"):
        assert parse_addr(addr) == config.parse_addr(addr)


class TestInproc:
    def test_roundtrip(self):
        rx = Collector()
        a = create_communicator("inproc", "nodeA", "nodeB")
        b = create_communicator("inproc", "nodeB", "nodeA")
        b.register_rcv_callback(rx)
        a.send(b"hello")
        assert wait_for(lambda: len(rx) == 1)
        assert rx.messages[0] == b"hello"
        a.close()
        b.close()

    def test_ordering(self):
        rx = Collector()
        a = create_communicator("inproc", None, "nodeB")
        b = create_communicator("inproc", "nodeB", None)
        b.register_rcv_callback(rx)
        for i in range(100):
            a.send(bytes([i]))
        assert wait_for(lambda: len(rx) == 100)
        assert [m[0] for m in rx.messages] == list(range(100))

    def test_double_bind_rejected(self):
        a = create_communicator("inproc", "nodeA", None)
        with pytest.raises(ValueError):
            create_communicator("inproc", "nodeA", None)
        a.close()

    def test_unknown_protocol(self):
        with pytest.raises(ValueError, match="unknown protocol"):
            create_communicator("rdma-over-pigeon", None, None)

    def test_try_send_times_out_without_a_listener(self):
        a = create_communicator("inproc", None, "nobody")
        t = time.monotonic()
        assert a.try_send(b"x", timeout_s=0.05) is False
        assert time.monotonic() - t < 2.0
        assert not a.connected()

    def test_native_tcp_refused_by_name(self):
        """``tcp`` was refused by name until the native transport was
        ported; now it is the native transport, never ``tcp-py``."""
        from radixmesh_tpu_torch.comm.tcp_native import NativeTcpCommunicator

        c = create_communicator("tcp", None, "127.0.0.1:1")
        try:
            assert isinstance(c, NativeTcpCommunicator)
        finally:
            c.close()

    def test_failed_native_build_raises(self, tmp_path, monkeypatch):
        """A source that does not compile raises with the compiler's
        message; the factory never falls back to ``tcp-py``."""
        from radixmesh_tpu_torch.comm import tcp_native

        broken = tmp_path / "transport.cpp"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(tcp_native, "_SRC", broken)
        monkeypatch.setattr(tcp_native, "_BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(tcp_native, "_lib", None)
        with pytest.raises(RuntimeError, match="building the native transport .* failed"):
            create_communicator("tcp", None, "127.0.0.1:1")
        assert not list((tmp_path / "build").glob("*"))


class TestPyTcp:
    @bounded
    def test_roundtrip_and_ordering(self):
        port = free_port()
        rx = Collector()
        listener = create_communicator("tcp-py", f"127.0.0.1:{port}", None)
        listener.register_rcv_callback(rx)
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{port}")
        msgs = [bytes([i]) * (i + 1) for i in range(50)]
        for m in msgs:
            sender.send(m)
        assert wait_for(lambda: len(rx) == 50)
        assert rx.messages == msgs
        sender.close()
        listener.close()

    @bounded
    def test_large_message(self):
        port = free_port()
        rx = Collector()
        listener = create_communicator("tcp-py", f"127.0.0.1:{port}", None)
        listener.register_rcv_callback(rx)
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{port}")
        big = bytes(range(256)) * 4096  # 1 MiB
        sender.send(big)
        assert wait_for(lambda: len(rx) == 1)
        assert rx.messages[0] == big
        sender.close()
        listener.close()

    @bounded
    def test_oversized_message_rejected(self):
        port = free_port()
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{port}", max_msg_bytes=1024)
        with pytest.raises(ValueError, match="exceeds max_msg_bytes"):
            sender.send(b"x" * 2048)
        sender.close()

    @bounded
    def test_sender_before_listener_connects_later(self):
        port = free_port()
        rx = Collector()
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{port}")
        t = threading.Thread(target=lambda: sender.send(b"early"), daemon=True)
        t.start()
        time.sleep(0.3)
        listener = create_communicator("tcp-py", f"127.0.0.1:{port}", None)
        listener.register_rcv_callback(rx)
        assert wait_for(lambda: len(rx) == 1, timeout=10)
        assert rx.messages[0] == b"early"
        t.join(10)
        assert not t.is_alive()
        sender.close()
        listener.close()

    @bounded
    def test_try_send_times_out_and_retarget_delivers(self):
        dead, live = free_port(), free_port()
        rx = Collector()
        listener = create_communicator("tcp-py", f"127.0.0.1:{live}", None)
        listener.register_rcv_callback(rx)
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{dead}")
        assert sender.try_send(b"lost", timeout_s=0.3) is False
        sender.retarget(f"127.0.0.1:{live}")
        assert sender.try_send(b"found", timeout_s=5.0) is True
        assert wait_for(lambda: len(rx) == 1)
        assert rx.messages == [b"found"] and sender.connected()
        sender.close()
        listener.close()

    @bounded
    def test_many_small_messages(self):
        port = free_port()
        rx = Collector()
        listener = create_communicator("tcp-py", f"127.0.0.1:{port}", None)
        listener.register_rcv_callback(rx)
        sender = create_communicator("tcp-py", None, f"127.0.0.1:{port}")
        n = 2000
        for i in range(n):
            sender.send(i.to_bytes(4, "big"))
        assert wait_for(lambda: len(rx) == n, timeout=20)
        assert [int.from_bytes(m, "big") for m in rx.messages] == list(range(n))
        sender.close()
        listener.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@bounded
def test_frames_interoperate_with_the_jax_transport(direction):
    """The port's Python TCP transport and the JAX package's speak one
    framing: either sends to the other."""
    from radixmesh_tpu.comm.tcp_py import PyTcpCommunicator as JaxTcp
    from radixmesh_tpu_torch.comm.tcp_py import PyTcpCommunicator as PortTcp

    listen_cls, send_cls = (JaxTcp, PortTcp) if direction == "port_to_jax" else (PortTcp, JaxTcp)
    port = free_port()
    rx = Collector()
    listener = listen_cls(f"127.0.0.1:{port}", None)
    listener.register_rcv_callback(rx)
    sender = send_cls(None, f"127.0.0.1:{port}")
    msgs = [b"cross-impl", bytes(range(256)) * 64]
    for m in msgs:
        sender.send(m)
    assert wait_for(lambda: len(rx) == 2)
    assert rx.messages == msgs
    sender.close()
    listener.close()
