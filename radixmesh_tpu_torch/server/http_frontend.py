"""HTTP serving frontend over the port's engine (the JAX package's
``server/http_frontend.py``: ``EngineRunner`` and ``ServingFrontend``).

- ``POST /generate``: ``input_ids`` (list of ints) or ``text`` (a string,
  tokenized server-side; needs a frontend built with a ``tokenizer``, else
  400), ``max_tokens``, ``temperature``, ``top_p``, ``top_k``,
  ``stop_token_ids`` (``text`` callers stop at the tokenizer's EOS unless
  they send their own, even an empty list), optional ``timeout`` (seconds).
  Replies ``{"output_ids", "cached_tokens", "rid", "ttft_s", "e2e_s"}``,
  plus ``"text"`` (the output decoded) with a tokenizer and ``"cancelled":
  true`` when cancelled.
- ``POST /cancel`` ``{"rid"}``; ``GET /healthz``; ``GET /stats`` (the
  engine's counters; ``spec``, speculative acceptance per prompt-length
  bucket; ``waves``, the wave mix under mixed waves; ``decode_dispatch``,
  the last paged-vs-dense decision; with KV tiers, ``host_fill``,
  ``host_tier`` (arena occupancy, write-back and restore counters),
  ``kv_transfer`` (the plane's ``stats()`` and its parked requests) and
  ``kv_tier`` — the JAX frontend's key names; ``kernels``, the attention
  kernels' launches and their plain versions' calls in this process).

Fields of the JAX API whose features are not ported yet — ``seed``
(seeded replay), ``stream`` (SSE), ``resume_tokens``, ``trace_id``,
and the SLO fields ``tenant``, ``ttft_deadline_ms``,
``deadline_ms`` — are refused with a 400, never ignored.

Threading model: one :class:`EngineRunner` thread owns the engine and
steps it while work exists; HTTP handler threads only submit requests and
wait on their per-request condition.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.ops.paged_attention import launch_counts
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["EngineRunner", "ServingFrontend"]

# /generate fields of features that are not ported yet.
_NOT_PORTED_FIELDS = {
    "seed": "seeded replay",
    "stream": "SSE streaming",
    "resume_tokens": "resume admission",
    "trace_id": "request tracing",
    "tenant": "SLO control",
    "ttft_deadline_ms": "SLO control",
    "deadline_ms": "SLO control",
}


class EngineRunner:
    """Exclusive owner of an :class:`Engine`: a single thread steps the
    scheduler while work exists; other threads submit and wait.
    Submissions pass through an inbox the runner drains before every
    step, so a request that arrives while the engine is busy joins the
    next step (a mixed wave, with ``prefill_inline_budget``) instead of
    waiting for the engine lock, which the runner takes back between
    steps before a waiting thread can."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._inbox: queue.SimpleQueue[Request] = queue.SimpleQueue()
        self._inbox_lock = threading.Lock()  # orders submit against close
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine-runner")
        self.log = get_logger("engine.runner")

    def start(self) -> "EngineRunner":
        self._thread.start()
        return self

    def close(self, drain_s: float = 0.0) -> None:
        """Stop the scheduler thread. With ``drain_s`` > 0, give in-flight
        requests that long to finish first; stragglers are cancelled so no
        waiter blocks forever."""
        deadline = time.monotonic() + drain_s
        while drain_s > 0 and time.monotonic() < deadline:
            with self._lock:
                self._take_inbox()
                if not self.engine.has_work():
                    break
            time.sleep(0.02)
        with self._inbox_lock:
            self._closed = True
        with self._lock:
            self._take_inbox()
            self.engine.cancel_all()
        self._stop.set()
        self._wake.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)

    def submit(self, prompt: Sequence[int], sampling: SamplingParams | None = None) -> Request:
        # make_request only validates and reads the engine's configuration.
        req = self.engine.make_request(prompt, sampling)
        with self._inbox_lock:
            if self._closed:
                raise RuntimeError("engine runner is shut down")
            self._inbox.put(req)
        self._wake.set()
        return req

    def cancel(self, rid: int) -> bool:
        with self._lock:
            self._take_inbox()
            return self.engine.cancel(rid)

    def _take_inbox(self) -> None:
        """Queue every submitted request on the engine (hold ``_lock``)."""
        while True:
            try:
                self.engine.enqueue(self._inbox.get_nowait())
            except queue.Empty:
                return

    def wait(self, req: Request, timeout: float | None = None) -> list[int]:
        """Block until ``req`` finishes; returns its generated tokens."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with req.cond:
            while req.state is not RequestState.FINISHED:
                remaining = 1.0 if deadline is None else deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"request {req.rid} not finished in time")
                req.cond.wait(timeout=min(remaining, 1.0))
        return req.generated

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self._take_inbox()
                has_work = self.engine.has_work()
                if has_work:
                    try:
                        self.engine.step()
                    except Exception:  # noqa: BLE001 — a bad request must not kill serving
                        self.log.exception("engine step failed")
            if not has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()


def _json_response(handler: BaseHTTPRequestHandler, code: int, obj: dict) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _read_json(handler: BaseHTTPRequestHandler) -> dict:
    length = int(handler.headers.get("Content-Length", 0))
    if length <= 0 or length > 64 * 1024 * 1024:
        raise ValueError("missing or oversized body")
    obj = json.loads(handler.rfile.read(length))
    if not isinstance(obj, dict):
        raise ValueError("body must be a JSON object")
    return obj


def _int_list(x, what: str) -> list[int]:
    if not isinstance(x, list) or not all(
        isinstance(t, int) and not isinstance(t, bool) for t in x
    ):
        raise ValueError(f"{what} must be a list of ints")
    return x


def _ids_from_body(body: dict, tokenizer) -> list[int]:
    """Token ids from a request body: ``text`` (tokenized server-side) or
    raw ``input_ids``."""
    if "text" in body:
        if tokenizer is None:
            raise ValueError(
                "server has no tokenizer (start with --tokenizer); send input_ids instead"
            )
        if not isinstance(body["text"], str):
            raise ValueError("text must be a string")
        return tokenizer.encode(body["text"])
    return _int_list(body["input_ids"], "input_ids")


def _stats(engine: Engine) -> dict:
    """``GET /stats``: lock-free snapshot reads of the engine's counters."""
    s = engine.stats
    out = {
        "hit_rate": s.hit_rate,
        "p50_ttft_s": s.p50_ttft_s,
        "prompt_tokens": s.prompt_tokens,
        "cached_tokens": s.cached_tokens,
        "generated_tokens": s.generated_tokens,
        "finished": s.finished,
        "preemptions": s.preemptions,
        "evicted_tokens": s.evicted_tokens,
        "decode_steps": s.decode_steps,
        "prefill_chunks": s.prefill_chunks,
        "spec_proposed": s.spec_proposed,
        "spec_accepted": s.spec_accepted,
        "spec_rejected": s.spec_rejected,
        "spec": engine.spec_report(),
    }
    if engine.waves is not None:
        out["waves"] = {**engine.waves.snapshot(), "inline_backlog": len(engine._inline)}
    if engine._last_dispatch is not None:
        out["decode_dispatch"] = engine._last_dispatch
    tel = engine.telemetry()
    if hasattr(engine.tree, "host"):
        out["host_fill"] = tel["host_fill"]
        out["host_tier"] = engine.tree.stats()
    if engine.kv_transfer is not None:
        out["kv_transfer"] = {
            **engine.kv_transfer.stats(), "restoring_requests": len(engine._restoring),
        }
    if tel["kv_tier"] is not None:
        out["kv_tier"] = tel["kv_tier"]
    out["kernels"] = launch_counts()
    return out


class _FrontendServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ServingFrontend:
    """HTTP API over one serving engine. ``port=0`` binds a free port
    (read it back from ``.port``). ``tokenizer`` (``server/tokenizer.py``)
    lets clients send ``text`` and get ``text`` back."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None):
        self.tokenizer = tokenizer
        self.runner = EngineRunner(engine).start()
        self.log = get_logger("http.serve")
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                frontend.log.debug(fmt, *args)

            def do_GET(self):
                if self.path == "/healthz":
                    _json_response(self, 200, {"status": "ok"})
                elif self.path == "/stats":
                    _json_response(self, 200, _stats(frontend.runner.engine))
                else:
                    _json_response(self, 404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/cancel":
                    try:
                        rid = int(_read_json(self)["rid"])
                    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                        _json_response(self, 400, {"error": str(e)})
                        return
                    _json_response(self, 200, {"cancelled": frontend.runner.cancel(rid)})
                    return
                if self.path != "/generate":
                    _json_response(self, 404, {"error": "not found"})
                    return
                try:
                    body = _read_json(self)
                    refused = sorted(k for k in body if k in _NOT_PORTED_FIELDS)
                    if refused:
                        raise ValueError(
                            "not supported by the PyTorch port yet: "
                            + ", ".join(f"{k} ({_NOT_PORTED_FIELDS[k]})" for k in refused)
                        )
                    ids = _ids_from_body(body, frontend.tokenizer)
                    stop_ids = tuple(_int_list(body.get("stop_token_ids", []), "stop_token_ids"))
                    if (
                        "text" in body
                        and "stop_token_ids" not in body
                        and frontend.tokenizer.eos_id is not None
                    ):
                        # Text callers expect generation to end at EOS
                        # without knowing the id space; an explicit (even
                        # empty) stop_token_ids opts out.
                        stop_ids = (frontend.tokenizer.eos_id,)
                    sampling = SamplingParams(
                        temperature=float(body.get("temperature", 0.0)),
                        top_p=float(body.get("top_p", 1.0)),
                        top_k=int(body.get("top_k", 0)),
                        max_new_tokens=int(body.get("max_tokens", 16)),
                        stop_token_ids=stop_ids,
                    )
                    timeout = float(body.get("timeout", 300.0))
                    req = frontend.runner.submit(ids, sampling)
                except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                    _json_response(self, 400, {"error": str(e)})
                    return
                except RuntimeError as e:  # submit raced shutdown
                    _json_response(self, 503, {"error": str(e)})
                    return
                try:
                    tokens = frontend.runner.wait(req, timeout=timeout)
                except TimeoutError as e:
                    frontend.runner.cancel(req.rid)
                    _json_response(self, 504, {"error": str(e), "rid": req.rid})
                    return
                reply = {
                    "output_ids": tokens,
                    "cached_tokens": req.prefix_len,
                    "rid": req.rid,
                    "ttft_s": (
                        req.first_token_time - req.submit_time
                        if req.first_token_time else None
                    ),
                    "e2e_s": (
                        req.finish_time - req.submit_time if req.finish_time else None
                    ),
                }
                if frontend.tokenizer is not None:
                    reply["text"] = frontend.tokenizer.decode(tokens)
                if req.cancelled:
                    reply["cancelled"] = True
                _json_response(self, 200, reply)

        self._server = _FrontendServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http-serve"
        )
        self._thread.start()
        self.log.info("serving frontend on %s:%d", host, self.port)

    def close(self, drain_s: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.runner.close(drain_s=drain_s)
        self.runner.engine.close()
