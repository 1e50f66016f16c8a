"""A group of port ranks for the CPU tests of ``radixmesh_tpu_torch.parallel``.

:class:`RankGroup` starts ``world`` worker processes once per test file.
Each joins one gloo job through ``init_multihost`` over a ``FileStore`` (a
file under the test's temporary directory: no port is freed and reused),
then serves calls from the test process over a Unix socket (in the abstract
namespace: no file, no path-length limit):
``group.run("module:function", *args)`` runs ``function(*args)`` on every
rank at once and returns the per-rank results. The functions live in
modules that import torch and the port only (``tests/_torch_parallel_cases.py``),
so the workers never load JAX; the test process holds the JAX references.

Every collective of the job times out (``COLLECTIVE_TIMEOUT_S``) and every
call is waited on with a deadline, so a rank whose host decisions drift
fails the test instead of hanging it. A call that raised on a rank
re-raises here with that rank's traceback.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import traceback
import uuid
from multiprocessing.connection import Client, Listener

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60.0
CALL_TIMEOUT_S = 240.0
_AUTH = b"radixmesh-torch-ranks"


class RankGroup:
    def __init__(self, world: int, store_dir: str, local_device_count: int | None = None):
        self.world = world
        sock = f"radixmesh-torch-ranks-{os.getpid()}-{uuid.uuid4().hex}"
        self._listener = Listener("\0" + sock, family="AF_UNIX", authkey=_AUTH)
        self._listener._listener._socket.settimeout(CALL_TIMEOUT_S)
        store = os.path.join(store_dir, "torch-ranks-store")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.logs = [os.path.join(store_dir, f"rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import tests._torch_ranks as m; m.worker()", str(r),
                     str(world), store, sock, str(local_device_count or 0)],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        self.conns = [None] * world
        try:
            for _ in range(world):
                conn = self._listener.accept()
                self.conns[conn.recv()] = conn
        except Exception:
            self.close()
            raise RuntimeError("a rank did not connect:\n" + self._tails())

    def _tails(self) -> str:
        out = []
        for r, path in enumerate(self.logs):
            try:
                with open(path) as f:
                    out.append(f"--- rank {r} ---\n" + f.read()[-3000:])
            except OSError:
                pass
        return "\n".join(out)

    def run(self, fn: str, *args, timeout: float = CALL_TIMEOUT_S, **kw) -> list:
        """``fn(*args, **kw)`` on every rank; the results by rank."""
        for c in self.conns:
            c.send((fn, args, kw))
        results, errors = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(timeout):
                self.close()
                raise TimeoutError(f"rank {r} gave no answer to {fn} in {timeout} s:\n" + self._tails())
            status, value = c.recv()
            if status == "error":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError(f"{fn} raised on {len(errors)} rank(s):\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for c in self.conns:
            if c is not None:
                try:
                    c.send(None)
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in self.conns:
            if c is not None:
                c.close()
        self._listener.close()


def worker() -> None:
    rank, world, store, sock, local = sys.argv[1:6]
    rank, world, local = int(rank), int(world), int(local) or None
    import torch

    torch.set_num_threads(1)
    conn = Client("\0" + sock, family="AF_UNIX", authkey=_AUTH)
    conn.send(rank)
    from radixmesh_tpu_torch.parallel import init_multihost

    init_multihost(f"file://{store}", world, rank, local, backend="gloo",
                   timeout_s=COLLECTIVE_TIMEOUT_S)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args, kw = msg
        module, fn = name.split(":")
        try:
            value = getattr(importlib.import_module(module), fn)(*args, **kw)
            conn.send(("ok", value))
        except BaseException:  # noqa: BLE001 — reported to the test process
            conn.send(("error", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()
