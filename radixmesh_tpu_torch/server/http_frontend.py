"""HTTP serving frontend over the port's engine (the JAX package's
``server/http_frontend.py``: ``EngineRunner`` and ``ServingFrontend``).

- ``POST /generate``: ``input_ids`` (list of ints), ``max_tokens``,
  ``temperature``, ``top_p``, ``top_k``, ``stop_token_ids``, optional
  ``timeout`` (seconds). Replies ``{"output_ids", "cached_tokens", "rid",
  "ttft_s", "e2e_s"}`` (plus ``"cancelled": true`` when cancelled).
- ``POST /cancel`` ``{"rid"}``; ``GET /healthz``; ``GET /stats``.

Fields of the JAX API whose features are not ported yet — ``seed``
(seeded replay), ``stream`` (SSE), ``resume_tokens``, ``trace_id``,
``text`` (tokenizer), and the SLO fields ``tenant``, ``ttft_deadline_ms``,
``deadline_ms`` — are refused with a 400, never ignored.

Threading model: one :class:`EngineRunner` thread owns the engine and
steps it while work exists; HTTP handler threads only submit requests and
wait on their per-request condition.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["EngineRunner", "ServingFrontend"]

# /generate fields of features that are not ported yet.
_NOT_PORTED_FIELDS = {
    "seed": "seeded replay",
    "stream": "SSE streaming",
    "resume_tokens": "resume admission",
    "trace_id": "request tracing",
    "text": "server-side tokenization",
    "tenant": "SLO control",
    "ttft_deadline_ms": "SLO control",
    "deadline_ms": "SLO control",
}


class EngineRunner:
    """Exclusive owner of an :class:`Engine`: a single thread steps the
    scheduler while work exists; other threads submit and wait."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._lock = threading.Lock()
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
                if not self.engine.has_work():
                    break
            time.sleep(0.02)
        with self._lock:
            self._closed = True
            self.engine.cancel_all()
        self._stop.set()
        self._wake.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)

    def submit(self, prompt: Sequence[int], sampling: SamplingParams | None = None) -> Request:
        with self._lock:
            if self._closed:
                raise RuntimeError("engine runner is shut down")
            req = self.engine.add_request(prompt, sampling)
        self._wake.set()
        return req

    def cancel(self, rid: int) -> bool:
        with self._lock:
            return self.engine.cancel(rid)

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


class _FrontendServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ServingFrontend:
    """HTTP API over one serving engine. ``port=0`` binds a free port
    (read it back from ``.port``)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 0):
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
                    s = frontend.runner.engine.stats
                    _json_response(
                        self,
                        200,
                        {
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
                        },
                    )
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
                    ids = _int_list(body["input_ids"], "input_ids")
                    sampling = SamplingParams(
                        temperature=float(body.get("temperature", 0.0)),
                        top_p=float(body.get("top_p", 1.0)),
                        top_k=int(body.get("top_k", 0)),
                        max_new_tokens=int(body.get("max_tokens", 16)),
                        stop_token_ids=tuple(
                            _int_list(body.get("stop_token_ids", []), "stop_token_ids")
                        ),
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
