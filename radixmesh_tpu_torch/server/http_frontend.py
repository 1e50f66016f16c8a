"""HTTP serving frontend over the port's engine (the JAX package's
``server/http_frontend.py``: ``EngineRunner``, ``ServingFrontend`` and the
router node's ``RouterFrontend``).

- ``POST /generate``: ``input_ids`` (list of ints) or ``text`` (a string,
  tokenized server-side; needs a frontend built with a ``tokenizer``, else
  400), ``max_tokens``, ``temperature``, ``top_p``, ``top_k``,
  ``stop_token_ids`` (``text`` callers stop at the tokenizer's EOS unless
  they send their own, even an empty list), optional ``timeout`` (seconds),
  ``seed`` (an int: seeded replay, ``engine/engine.py``), ``stream``
  (true: server-sent events, one ``data: {"token": t}`` event per token
  and a last ``{"done": true, "output_ids": [...]}`` event),
  ``resume_tokens`` (a list of ints a prior life of the request already
  delivered: replayed through prefill, never re-emitted) and ``trace_id``
  (a nonzero 64-bit int, or its ``0x`` hex string, adopted for this
  request's spans), and the SLO fields ``tenant``, ``ttft_deadline_ms``
  and ``deadline_ms`` (end to end), which a frontend built with ``slo=``
  enforces (``slo/``: overload answers 429 or 503 with ``Retry-After``,
  a request dropped from the queue answers 503 with ``"shed": true``) and
  a plain frontend accepts and ignores. Replies ``{"output_ids",
  "cached_tokens", "rid", "ttft_s", "e2e_s"}``, plus ``"resumed_from"`` (the tokens delivered
  before) for a resumed request, ``"trace_id"`` for a traced one,
  ``"text"`` (the output decoded) with a tokenizer, ``"cancelled":
  true`` when cancelled and ``"shed": true`` with its ``"reason"`` when
  the control plane cut it short.
- ``POST /cancel`` ``{"rid"}``; ``GET /healthz``; ``GET /stats`` (the
  engine's counters; ``spec``, speculative acceptance per prompt-length
  bucket; ``waves``, the wave mix under mixed waves; ``decode_dispatch``,
  the last paged-vs-dense decision; with KV tiers, ``host_fill``,
  ``host_tier`` (arena occupancy, write-back and restore counters),
  ``kv_transfer`` (the plane's ``stats()`` and its parked requests) and
  ``kv_tier`` — the JAX frontend's key names; ``slo``, the controller's
  snapshot, with SLO control on; ``kernels``, the attention kernels'
  launches and their plain versions' calls in this process).
- ``GET /metrics``: the port's registry (``obs/metrics.py``) in Prometheus
  text exposition: the engine's, the KV tiers' and the wave scheduler's
  series under the JAX package's names.
- ``GET /debug/trace`` (the flight recorder as Chrome trace-event JSON;
  ``?drain=1`` consumes it, ``?format=spans`` serves the raw span export),
  ``GET /debug/requests`` (the in-flight request table), ``GET
  /debug/state`` (the engine-side planes: scheduler, pool, tiers,
  speculation ledger, waves, step accounting, recorder, SLO, and with a
  cache mesh the node's ``membership``), ``GET /cluster/telemetry`` (with a
  cache mesh: every gossiped fleet digest and the fingerprint-convergence
  audit, ``obs/fleet_plane.py``), ``GET
  /debug/tokens`` (the token timeline, speculation ledger and goodput;
  ``?limit=N``; 404 with the timeline off), ``GET /debug/timeseries``
  (the telemetry history's rings, ``obs/timeseries.py``: ``?family=``
  prefix, ``?since=`` cursor, ``?limit=`` points; 404 with the history
  off) and ``GET /debug/waterfall`` (the phase attributor's p50/p99
  breakdown, per-shape table and recent waterfalls,
  ``obs/attribution.py``).
- ``POST /admin/blackbox``: flush the black box (``obs/blackbox.py``) now;
  404 without a ``blackbox_dir``. ``POST /admin/drain`` (optional
  ``{"deadline_s"}``): start the node's graceful drain
  (``policy/lifecycle.py``), 202 or 200 with ``accepted``, ``state``,
  ``router`` and ``deadline_s``; 404 without a lifecycle plane. While a
  node drains, ``/generate`` answers 503 with the router to retry through
  (and ``Retry-After`` with SLO control on).
- ``GET /cluster/health`` (with a cache mesh: per-node health scores, the
  convergence summary and the autoscale recommendation), ``GET
  /cluster/doctor`` (the mesh doctor's ranked findings, ``obs/doctor.py``),
  ``GET /cluster/timeseries`` (the fleet aggregator's node-labeled store,
  with ``/debug/timeseries``'s cursor; 404 where no aggregator is hosted)
  and ``GET /cluster/slo`` (true fleet TTFT and e2e quantiles per tenant
  from merged bucket counts, ``obs/aggregator.py``; 404 likewise). A
  router started with aggregator peers hosts the aggregator.
- ``POST /profile`` ``{"seconds": N}`` and ``GET /debug/profile?seconds=N``:
  one ``torch.profiler`` window (CUDA activity on the card) written as a
  Chrome trace into a fresh numbered directory under the frontend's
  ``profile_dir`` (403 without one: clients never choose paths).

Fields of the JAX API whose features are not ported yet are refused by
name with a 400, never ignored (``_NOT_PORTED_FIELDS``; none is left).

Threading model: one :class:`EngineRunner` thread owns the engine and
steps it while work exists; HTTP handler threads only submit requests and
wait on their per-request condition.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence
from urllib.parse import parse_qs, urlsplit

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.obs.aggregator import FleetAggregator, HttpPeer
from radixmesh_tpu_torch.obs.attribution import ensure_attributor
from radixmesh_tpu_torch.obs.blackbox import BlackBox
from radixmesh_tpu_torch.obs.doctor import MeshDoctor
from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.ops.paged_attention import launch_counts
from radixmesh_tpu_torch.policy.retry import jittered_retry_after
from radixmesh_tpu_torch.slo.control import RequestShed
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["EngineRunner", "RouterFrontend", "ServingFrontend"]

# /generate fields of features that are not ported yet, by name -> feature.
_NOT_PORTED_FIELDS: dict[str, str] = {}


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
        # Graceful drain (policy/lifecycle.py): once set, new submits are
        # refused retriably while in-flight work keeps stepping.
        self._draining = False
        self._drain_retry_after_s = 1.0
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
            # meshcheck: ok[sleep-audit] deadline-bounded drain poll;
            # completion is engine.has_work() under the runner lock —
            # no condition crosses the engine seam.
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

    def submit(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        resume_tokens: Sequence[int] | None = None,
        trace_id: int | None = None,
    ) -> Request:
        # make_request only validates, reads the engine's configuration
        # and opens the request's trace (the recorder locks itself).
        req = self.engine.make_request(
            prompt, sampling, resume_tokens=resume_tokens, trace_id=trace_id
        )
        with self._inbox_lock:
            if self._closed:
                raise RuntimeError("engine runner is shut down")
            if self._draining:
                raise RuntimeError("node is draining — retry via the router")
            self._inbox.put(req)
        self._wake.set()
        return req

    def cancel(self, rid: int) -> bool:
        with self._lock:
            self._take_inbox()
            return self.engine.cancel(rid)

    # -- graceful drain (driven by policy/lifecycle.py) ------------------

    def begin_drain(self, retry_after_s: float = 1.0) -> None:
        """Close the admission window: new submits are refused retriably
        (clients re-route via the router) while in-flight work keeps
        stepping. The engine also stops converting PREFETCH hints: a
        restore nobody will be routed here to use must not open tickets on
        a departing node."""
        with self._inbox_lock:
            self._draining = True
            self._drain_retry_after_s = retry_after_s
        with self._lock:
            self.engine.draining = True

    def drain_requeue(self) -> int:
        """Cancel and flag every queued and parked-RESTORING request for
        requeue at the router (they have produced nothing; bouncing them
        loses no work). Returns the number flagged."""
        with self._lock:
            self._take_inbox()
            return self.engine.drain_requeue_waiting()

    def drain_wait_idle(self, deadline_s: float, poll_s: float = 0.02) -> bool:
        """Let in-flight decodes run to completion, bounded by
        ``deadline_s``; stragglers past it are cancelled (partial output
        returns, flagged). True = everything finished on its own."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            with self._lock:
                self._take_inbox()
                if not self.engine.has_work():
                    return True
            # meshcheck: ok[sleep-audit] deadline-bounded drain poll
            # (same seam as above: has_work() is the only signal).
            time.sleep(poll_s)
        with self._lock:
            n = self.engine.cancel_all()
        if n:
            self.log.warning("drain deadline (%.1fs): cancelled %d straggler(s)", deadline_s, n)
        return False

    def drain_flush(self) -> tuple[int, bool]:
        """Write hot prefixes back to the host tier (the fused write-back
        lane) and wait for the arena writes to land: the last step before
        LEAVE, so a warm rejoin finds its working set. Returns ``(tokens
        written back, landed)``; ``landed`` is False when the write barrier
        timed out or an awaited write-back failed."""
        with self._lock:
            n = self.engine.drain_flush_hot()
        plane = self.engine.kv_transfer
        landed = True
        if plane is not None:
            landed = plane.wait_host_ready()
            if not landed:
                self.log.warning("drain write-back barrier failed or timed out: hot prefixes "
                                 "may not have landed in the host tier")
        return n, landed

    def drain_flush_disk(self) -> tuple[int, bool]:
        """Drain step 5d (policy/lifecycle.py): flush the hot subtrees one
        tier further, host arena to durable disk extents. (0, True) without
        a tier. Runs after :meth:`drain_flush`."""
        with self._lock:
            return self.engine.drain_flush_disk()

    def tokens_so_far(self, req: Request) -> list[int]:
        # Handler threads only read the append-only list; a torn read costs
        # one token of staleness, never corruption.
        return list(req.output_tokens)

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

    def _pre_step(self) -> None:
        """Subclass hook run every scheduler iteration with the step lock
        held, after the inbox is taken and before the has-work check (the
        SLO runner pumps its admission queue here)."""

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self._take_inbox()
                self._pre_step()
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


def _discard_body(handler: BaseHTTPRequestHandler) -> None:
    """Read a request body the endpoint does not use: closing the socket
    with unread bytes resets the connection, and the reset can drop the
    response before the client has read it."""
    length = int(handler.headers.get("Content-Length", 0) or 0)
    if 0 < length <= 64 * 1024 * 1024:
        handler.rfile.read(length)


def _int_list(x, what: str) -> list[int]:
    if not isinstance(x, list) or not all(
        isinstance(t, int) and not isinstance(t, bool) for t in x
    ):
        raise ValueError(f"{what} must be a list of ints")
    return x


def _ids_from_body(body: dict, tokenizer, who: str = "server") -> list[int]:
    """Token ids from a request body: ``text`` (tokenized server-side) or
    raw ``input_ids``; one implementation for the serving and router
    frontends."""
    if "text" in body:
        if tokenizer is None:
            raise ValueError(
                f"{who} has no tokenizer (start with --tokenizer); send input_ids instead"
            )
        if not isinstance(body["text"], str):
            raise ValueError("text must be a string")
        return tokenizer.encode(body["text"])
    return _int_list(body["input_ids"], "input_ids")


def _trace_id_from_body(body: dict) -> int | None:
    """``trace_id``: an int or its string form (``0x`` hex allowed),
    nonzero and below 2**64."""
    trace_id = body.get("trace_id")
    if trace_id is None:
        return None
    if isinstance(trace_id, bool) or not isinstance(trace_id, (int, str)):
        raise ValueError("trace_id must be an int or a string")
    trace_id = int(str(trace_id), 0)
    if not 0 < trace_id < (1 << 64):
        raise ValueError("trace_id must be a nonzero 64-bit int")
    return trace_id


def _request_row(req: Request, now: float) -> dict:
    """One ``/debug/requests`` row: identity and per-phase elapsed times
    from the stamps the scheduler keeps."""
    ft = req.first_token_time
    return {
        "rid": req.rid,
        "state": req.state.value,
        "tenant": req.tenant,
        "prompt_tokens": len(req.prompt),
        "output_tokens": len(req.output_tokens),
        "kv_len": req.kv_len,
        "prefix_hit_tokens": req.prefix_len,
        "resume_offset": req.resume_offset,
        "row": req.row,
        "trace_id": getattr(req.trace, "trace_id", None),
        "elapsed_s": {
            "total": round(now - req.submit_time, 6) if req.submit_time else None,
            "slo_queue": round(req.admit_time - req.submit_time, 6) if req.admit_time else None,
            "to_first_token": round(ft - req.submit_time, 6) if ft else None,
            "decoding": (
                round(now - ft, 6) if ft and req.state is RequestState.RUNNING else None
            ),
        },
    }


def _debug_requests(engine: Engine) -> dict:
    """``GET /debug/requests``: lock-free snapshots of the queues (a torn
    read costs a beat of staleness, never a wedge behind a long step)."""
    now = time.monotonic()
    waiting = list(engine.waiting)
    restoring = [r for r, _ in list(engine._restoring)]
    inline = [j.req for j in list(engine._inline)]
    running = [r for r in list(engine._rows) if r is not None]
    return {
        "requests": [_request_row(r, now) for r in waiting + restoring + inline + running],
        "waiting": len(waiting),
        "restoring": len(restoring),
        "inline": len(inline),
        "running": len(running),
    }


def _membership_state(mesh) -> dict:
    """The node's place in the cache mesh's membership view."""
    return {
        "role": mesh.role.value,
        "rank": mesh.rank,
        "view_epoch": mesh.view.epoch,
        "alive": list(mesh.view.alive),
        "master_rank": mesh.view.master_rank(),
        "successor_rank": mesh._succ_rank,
    }


def _cluster_telemetry(mesh) -> dict:
    """``GET /cluster/telemetry``: every gossiped NodeDigest plus the
    pairwise fingerprint-convergence audit (``obs/fleet_plane.py``)."""
    if mesh is None:
        return {"nodes": {}, "note": "no cache mesh attached to this node"}
    snap = mesh.fleet.snapshot()
    if "shard_heat" in snap:
        snap["shard_heat"] = mesh.shard_heat_report()
    snap["self"] = _membership_state(mesh)
    return snap


def _cluster_health(mesh) -> dict:
    """``GET /cluster/health``: per-node 0..1 health scores with the
    detector reasons that capped them, the fleet-wide convergence summary
    and the autoscale recommendation (``policy/lifecycle.py``)."""
    if mesh is None:
        return {"nodes": {}, "note": "no cache mesh attached to this node"}
    from radixmesh_tpu_torch.policy.lifecycle import AutoscalePolicy

    health = mesh.fleet.health()
    scores = [h["score"] for h in health.values()]
    return {
        "nodes": {str(r): h for r, h in sorted(health.items())},
        "min_score": min(scores, default=1.0),
        "convergence": mesh.fleet.convergence(),
        "autoscale": AutoscalePolicy().recommend(mesh.fleet, alive_ring=len(mesh.view.alive)),
        "self": _membership_state(mesh),
    }


def _cluster_timeseries(aggregator, query: dict) -> tuple[int, dict]:
    """``GET /cluster/timeseries``: the fleet store, every peer's rings
    folded into one node-labeled :class:`TelemetryHistory`, with
    ``/debug/timeseries``'s cursor pagination and the aggregator's
    ``stats()``; 404 on a node that hosts no aggregator."""
    if aggregator is None:
        return 404, {"error": "no fleet aggregator hosted here — query a router started with "
                              "--agg-interval > 0 (serving nodes export /debug/timeseries only)"}
    code, body = _debug_timeseries(aggregator.store, query)
    if code == 200:
        body["aggregator"] = aggregator.stats()
    return code, body


def _cluster_slo(aggregator) -> tuple[int, dict]:
    """``GET /cluster/slo``: per-tenant fleet p50/p99 TTFT and e2e from
    merged histogram bucket counts, each tail quantile with its bucket and
    exemplar (``FleetAggregator.fleet_slo``); 404 without an aggregator."""
    if aggregator is None:
        return 404, {"error": "no fleet aggregator hosted here — query a router started with "
                              "--agg-interval > 0"}
    return 200, aggregator.fleet_slo()


def _debug_state(engine: Engine, ctl=None, lifecycle=None) -> dict:
    """``GET /debug/state``: the engine-side planes, with SLO control
    (``ctl``, the runner's controller) its snapshot, with a cache mesh the
    node's membership, and with a lifecycle plane its state and drain
    record (the JAX frontend's sections)."""
    tree = engine.tree
    state = {
        "engine": {
            "name": engine.name,
            "batch_rows_active": sum(1 for r in engine._rows if r is not None),
            "max_batch": engine.max_batch,
            "waiting": len(engine.waiting),
            "pressure": engine._pressure,
            "prefills": engine.stats.prefills,
            "decode_steps": engine.stats.decode_steps,
            "finished": engine.stats.finished,
            "preemptions": engine.stats.preemptions,
            "hit_rate": round(engine.stats.hit_rate, 4),
            # Histogram-derived (interpolated within buckets).
            "p50_ttft_s": round(engine._m_ttft.quantile(0.5), 6),
            "p99_ttft_s": round(engine._m_ttft.quantile(0.99), 6),
            "p50_tpot_s": round(engine._m_tpot.quantile(0.5), 6),
        },
        "pool": {
            "num_slots": engine.pool.num_slots,
            "free_slots": engine.pool.free_slots,
            "page_size": engine.pool.page_size,
            "quant": engine.pool.quant,
        },
        "cache": {
            "evictable_tokens": getattr(tree, "evictable_size_", None),
            "protected_tokens": getattr(tree, "protected_size_", None),
        },
        "spec": engine.spec_ledger.report(),
        "trace": get_recorder().stats(),
        "exemplars": get_registry().exemplars(),
    }
    if engine.mesh is not None:
        state["membership"] = _membership_state(engine.mesh)
    if hasattr(tree, "host"):
        state["host_tier"] = tree.stats()
    if engine.kv_transfer is not None:
        state["kv_transfer"] = {
            **engine.kv_transfer.stats(), "restoring_requests": len(engine._restoring),
        }
    tel = engine.telemetry()
    if tel["kv_tier"] is not None:
        state["kv_tier"] = tel["kv_tier"]
    if engine.step_acct is not None:
        state["step_accounting"] = engine.step_acct.report()
    if engine.waves is not None:
        state["waves"] = {**engine.waves.snapshot(), "inline_backlog": len(engine._inline)}
    if engine._last_dispatch is not None:
        state["decode_dispatch"] = engine._last_dispatch
    if engine.timeline is not None:
        tl = engine.timeline.snapshot(limit=0)
        state["timeline"] = {k: v for k, v in tl.items() if k != "recent"}
    if ctl is not None:
        state["slo"] = ctl.snapshot()
    if lifecycle is not None:
        state["lifecycle"] = lifecycle.status()
    return state


def _debug_tokens(engine: Engine, query: dict) -> tuple[int, dict]:
    """``GET /debug/tokens``: the change-compressed per-token ITL ring with
    stall causes, the speculation ledger and the goodput decomposition.
    ``?limit=N`` bounds the ring tail (default 256); 404 when the engine
    runs without a timeline."""
    if engine.timeline is None:
        return 404, {"error": "token timeline disabled on this engine "
                              "(token_timeline_capacity=0)"}
    try:
        limit = int(query.get("limit", ["256"])[-1])
    except ValueError:
        return 400, {"error": "limit must be an integer"}
    return 200, {
        "timeline": engine.timeline.snapshot(limit=max(0, limit)),
        "spec": engine.spec_ledger.report(),
        "goodput": engine.goodput.report(step_acct=engine.step_acct, spec=engine.spec_ledger),
    }


def _debug_timeseries(history, query: dict) -> tuple[int, dict]:
    """``GET /debug/timeseries``: the telemetry-history rings with cursor
    pagination. ``?family=`` prefix-filters series, ``?since=`` is the
    sample-sequence cursor from a previous page's ``next_since``,
    ``?limit=`` bounds the points of a page (cut on a sample boundary)."""
    if history is None:
        return 404, {"error": "telemetry history disabled (--telemetry-history-interval 0)"}
    try:
        family = query.get("family", [""])[-1] or None
        since = int(query.get("since", ["-1"])[-1])
        limit = int(query.get("limit", ["2000"])[-1])
    except ValueError:
        return 400, {"error": "since/limit must be integers"}
    return 200, history.query(family=family, since=since, limit=limit)


def _admin_blackbox(blackbox) -> tuple[int, dict]:
    """``POST /admin/blackbox``: flush the black box now (the operator's
    snapshot before a restart; the same artifact shutdown and the watchdog
    write)."""
    if blackbox is None:
        return 404, {"error": "no black box on this node (start with --blackbox-dir)"}
    try:
        res = blackbox.flush("admin")
    except OSError as e:
        return 500, {"error": str(e)}
    return 200, {"flushed": True, **res}


def _admin_drain(handler: BaseHTTPRequestHandler, lifecycle) -> tuple[int, dict]:
    """``POST /admin/drain`` (optional ``{"deadline_s"}``): start the
    DRAINING → LEFT sequence of the lifecycle plane (``policy/lifecycle.py``)
    in the background; 202 when this call started it, 200 when a drain was
    already under way or done. 404 without a lifecycle plane."""
    if lifecycle is None:
        return 404, {"error": "no lifecycle plane attached to this node (start via launch.py node)"}
    try:
        length = int(handler.headers.get("Content-Length", 0) or 0)
        body = _read_json(handler) if length > 0 else {}
        deadline = body.get("deadline_s")
        deadline = None if deadline is None else float(deadline)
    except (TypeError, ValueError, json.JSONDecodeError) as e:
        return 400, {"error": str(e)}
    accepted = lifecycle.request_drain(deadline_s=deadline)
    return 202 if accepted else 200, {
        "accepted": accepted,
        "state": lifecycle.state.value,
        # Where shed clients should retry.
        "router": lifecycle.router_hint(),
        "deadline_s": deadline if deadline is not None else lifecycle.cfg.drain_timeout_s,
    }


def _stats(engine: Engine, ctl=None) -> dict:
    """``GET /stats``: lock-free snapshot reads of the engine's counters
    (and the SLO controller's snapshot with SLO control on)."""
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
        "resurrections": s.resurrections,
        "replayed_tokens": s.replayed_tokens,
        "replayed_cached_tokens": s.replayed_cached_tokens,
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
    if ctl is not None:
        out["slo"] = ctl.snapshot()
    out["kernels"] = launch_counts()
    return out


def _metrics_response(handler: BaseHTTPRequestHandler) -> None:
    """``GET /metrics``: the registry in Prometheus text exposition."""
    body = get_registry().render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _debug_trace(query: dict) -> dict:
    """``GET /debug/trace``: the flight recorder as Chrome trace-event JSON
    (``?format=spans``: the raw span export), read-only unless the caller
    opts into draining it (``?drain=1``)."""
    drain = query.get("drain", ["0"])[-1].lower() in ("1", "true", "yes")
    rec = get_recorder()
    if query.get("format", [""])[-1].lower() == "spans":
        return rec.export_spans(drain=drain)
    return rec.chrome_trace(drain=drain)


def _sse(handler: BaseHTTPRequestHandler, event: dict) -> None:
    handler.wfile.write(f"data: {json.dumps(event)}\n\n".encode())


class _FrontendServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # The listen backlog (socketserver's default is 5, the JAX frontend's):
    # a burst of more simultaneous connections than the backlog holds is
    # reset by the kernel before the SLO plane can answer it 429 or 503.
    request_queue_size = 1024


class ServingFrontend:
    """HTTP API over one serving engine. ``port=0`` binds a free port
    (read it back from ``.port``). ``tokenizer`` (``server/tokenizer.py``)
    lets clients send ``text`` and get ``text`` back. ``profile_dir``
    enables ``/profile`` captures under that directory. ``slo`` (an
    :class:`~radixmesh_tpu_torch.slo.control.SLOConfig`) puts the overload
    control plane in the admission path (:class:`SLORunner`). ``lifecycle``
    (a :class:`~radixmesh_tpu_torch.policy.lifecycle.LifecyclePlane`, also
    settable after construction, since the plane needs this frontend's
    runner) enables ``POST /admin/drain``, points drain sheds at the router
    and adds its section to ``/debug/state``. ``history_interval_s`` > 0 samples the telemetry history every that
    many seconds into rings of ``history_capacity`` points (0 disables
    it); ``blackbox_dir`` arms the black box there, committing a history
    segment at every sample, with the watchdog at ``blackbox_watchdog_s``
    (0 = off)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, profile_dir: str | None = None, slo=None, lifecycle=None,
                 history_interval_s: float = 1.0, history_capacity: int = 900,
                 blackbox_dir: str | None = None, blackbox_watchdog_s: float = 0.0):
        self.tokenizer = tokenizer
        # Handlers read the attribute on every call: launch.py attaches
        # the plane after construction.
        self.lifecycle = lifecycle
        if slo is not None:
            # slo.runner imports this module for EngineRunner.
            from radixmesh_tpu_torch.slo.runner import SLORunner

            self.runner = SLORunner(engine, slo).start()
        else:
            self.runner = EngineRunner(engine).start()
        self.slo_enabled = slo is not None
        ctl = self.runner.ctl if self.slo_enabled else None
        self.log = get_logger("http.serve")
        # /profile writes only under this operator-configured directory
        # (None = endpoint disabled): a client never chooses a path.
        self.profile_dir = profile_dir
        if profile_dir is not None:
            from radixmesh_tpu_torch.obs.tracing import prime_profiler

            prime_profiler()  # captures run on handler threads
        self._profile_lock = threading.Lock()
        self._profile_seq = 0
        # The phase attributor installs on the recorder's span-retire hook
        # now, so phase histograms accumulate from the first traced request
        # (a swapped recorder gets a fresh one through ensure_attributor).
        ensure_attributor()
        # Telemetry history: bounded rings over every plane (with a cache
        # mesh, its fleet health and shard heat), sampled on its own thread.
        self.history = None
        if history_interval_s > 0:
            self.history = TelemetryHistory(
                interval_s=history_interval_s, capacity=history_capacity, mesh=engine.mesh,
                engine=engine, slo=ctl, node=engine.name,
            )
        # A serving node hosts no fleet aggregator (the router does): the
        # attribute lets /cluster/{timeseries,slo} answer with a pointer.
        self.aggregator = None
        # The mesh doctor persists across GETs: its burn-rate windows need
        # continuity (the history's sampler feeds them).
        self.doctor = MeshDoctor(mesh=engine.mesh, engine=engine, slo=ctl,
                                 attributor=ensure_attributor, history=self.history)
        # The black box: crash-surviving dumps of the history, waterfalls,
        # spans, doctor findings and state. A segment commits at every
        # sample, so a kill -9 loses at most one sample interval; the
        # segments on disk span the ring's own window.
        self.blackbox = None
        if blackbox_dir:
            self.blackbox = BlackBox(
                blackbox_dir, history=self.history, doctor=self.doctor, recorder=get_recorder,
                attributor_fn=ensure_attributor,
                state_fn=lambda: _debug_state(engine, ctl, self.lifecycle),
                node=engine.name, segment_every=1, max_segments=history_capacity,
                watchdog_timeout_s=blackbox_watchdog_s,
            )
        if self.history is not None:
            # Started after the black box installed its segment hook, so
            # the first samples are already crash-durable.
            self.history.start()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                frontend.log.debug(fmt, *args)

            def do_GET(self):
                path = urlsplit(self.path).path
                query = parse_qs(urlsplit(self.path).query)
                engine = frontend.runner.engine
                if path == "/healthz":
                    _json_response(self, 200, {"status": "ok"})
                elif path == "/stats":
                    _json_response(self, 200, _stats(engine, ctl))
                elif path == "/metrics":
                    _metrics_response(self)
                elif path == "/debug/trace":
                    _json_response(self, 200, _debug_trace(query))
                elif path == "/debug/requests":
                    _json_response(self, 200, _debug_requests(engine))
                elif path == "/debug/state":
                    _json_response(self, 200, _debug_state(engine, ctl, frontend.lifecycle))
                elif path == "/cluster/telemetry":
                    _json_response(self, 200, _cluster_telemetry(engine.mesh))
                elif path == "/debug/tokens":
                    _json_response(self, *_debug_tokens(engine, query))
                elif path == "/debug/timeseries":
                    _json_response(self, *_debug_timeseries(frontend.history, query))
                elif path == "/debug/waterfall":
                    _json_response(self, 200, ensure_attributor().report())
                elif path == "/cluster/health":
                    _json_response(self, 200, _cluster_health(engine.mesh))
                elif path == "/cluster/doctor":
                    _json_response(self, 200, frontend.doctor.diagnose())
                elif path == "/cluster/timeseries":
                    _json_response(self, *_cluster_timeseries(frontend.aggregator, query))
                elif path == "/cluster/slo":
                    _json_response(self, *_cluster_slo(frontend.aggregator))
                elif path == "/debug/profile":
                    try:
                        seconds = float(query.get("seconds", ["3.0"])[-1])
                    except ValueError:
                        _json_response(self, 400, {"error": "seconds must be a number"})
                        return
                    _json_response(self, *frontend._run_profile(seconds))
                else:
                    _json_response(self, 404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/admin/blackbox":
                    _discard_body(self)
                    _json_response(self, *_admin_blackbox(frontend.blackbox))
                    return
                if self.path == "/admin/drain":
                    # The drain runs on the plane's own thread: the handler
                    # must not block for the whole drain deadline.
                    _json_response(self, *_admin_drain(self, frontend.lifecycle))
                    return
                if self.path == "/profile":
                    try:
                        seconds = float(_read_json(self).get("seconds", 3.0))
                    except (TypeError, ValueError, json.JSONDecodeError) as e:
                        _json_response(self, 400, {"error": str(e)})
                        return
                    _json_response(self, *frontend._run_profile(seconds))
                    return
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
                    seed = body.get("seed")
                    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
                        raise ValueError("seed must be an int")
                    sampling = SamplingParams(
                        temperature=float(body.get("temperature", 0.0)),
                        top_p=float(body.get("top_p", 1.0)),
                        top_k=int(body.get("top_k", 0)),
                        max_new_tokens=int(body.get("max_tokens", 16)),
                        stop_token_ids=stop_ids,
                        seed=seed,
                    )
                    # Resume admission: output a prior life delivered,
                    # replayed through prefill and never re-emitted.
                    resume_tokens = body.get("resume_tokens")
                    if resume_tokens is not None:
                        resume_tokens = _int_list(resume_tokens, "resume_tokens")
                    trace_id = _trace_id_from_body(body)
                    timeout = float(body.get("timeout", 300.0))
                    slo_kw = {}
                    if frontend.slo_enabled:
                        # SLO fields (ignored without a control plane: a
                        # plain runner has neither tenants nor deadlines
                        # to enforce them with).
                        slo_kw["tenant"] = str(body.get("tenant", "default"))
                        if "ttft_deadline_ms" in body:
                            slo_kw["ttft_deadline_s"] = float(body["ttft_deadline_ms"]) / 1e3
                        if "deadline_ms" in body:
                            slo_kw["e2e_deadline_s"] = float(body["deadline_ms"]) / 1e3
                except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                    _json_response(self, 400, {"error": str(e)})
                    return
                try:
                    req = frontend.runner.submit(
                        ids, sampling, resume_tokens=resume_tokens, trace_id=trace_id, **slo_kw
                    )
                except RequestShed as e:  # the overload control plane refused it
                    self._shed(e)
                    return
                except ValueError as e:  # e.g. prompt too long
                    _json_response(self, 400, {"error": str(e)})
                    return
                except RuntimeError as e:  # submit raced shutdown or a drain
                    extra = {}
                    lc = frontend.lifecycle
                    if lc is not None and "draining" in str(e):
                        extra["router"] = lc.router_hint()
                    _json_response(self, 503, {"error": str(e), **extra})
                    return
                if body.get("stream"):
                    self._stream(req)
                    return
                try:
                    tokens = frontend.runner.wait(req, timeout=timeout)
                except TimeoutError as e:
                    frontend.runner.cancel(req.rid)
                    _json_response(self, 504, {"error": str(e), "rid": req.rid})
                    return
                tr = req.trace
                if tr is not None:
                    # The outermost span of the request's flight: submit
                    # to response ready (streams record theirs when the
                    # done event flushes).
                    tr.add("http_request", req.submit_time, time.monotonic() - req.submit_time,
                           cat="http", output_tokens=len(tokens))
                if req.shed and not tokens:
                    # Dropped from the SLO queue before any work ran (the
                    # dispatch-time deadline check or the shutdown flush).
                    _json_response(self, 503, {"error": f"request shed ({req.shed_reason})",
                                               "shed": True, "reason": req.shed_reason})
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
                if req.resume_offset:
                    # output_ids holds only the tokens after the delivered ones.
                    reply["resumed_from"] = req.resume_offset
                if tr is not None:
                    reply["trace_id"] = tr.trace_id
                if frontend.tokenizer is not None:
                    reply["text"] = frontend.tokenizer.decode(tokens)
                if req.cancelled:
                    reply["cancelled"] = True
                if req.shed:
                    reply["shed"] = True
                    reply["reason"] = req.shed_reason
                _json_response(self, 200, reply)

            def _shed(self, e: RequestShed) -> None:
                """429 (rate limited), 413 (a prompt the tenant's bucket can
                never hold) or 503, with ``Retry-After`` where the shed is
                retriable. The advertised wait carries bounded jitter, so
                a herd shed in one instant does not return in one."""
                body = {"error": str(e), "shed": True, "reason": e.reason}
                # A drain shed points the client at the router: the fleet
                # still has capacity, just not here.
                hint = (
                    {"router": frontend.lifecycle.router_hint()}
                    if e.reason == "draining" and frontend.lifecycle is not None else {}
                )
                if e.retry_after_s is None:
                    _json_response(self, e.http_status, {**body, **hint})
                    return
                retry_s = jittered_retry_after(e.retry_after_s)
                raw = json.dumps({**body, "retry_after_s": round(retry_s, 4), **hint}).encode()
                self.send_response(e.http_status)
                self.send_header("Content-Type", "application/json")
                # Before end_headers, as every header must be.
                self.send_header("Retry-After", str(max(1, int(round(retry_s)))))
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _stream(self, req: Request) -> None:
                """Server-sent events: one ``data:`` event per new token,
                then the ``done`` event."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                sent = 0
                while True:
                    tokens = frontend.runner.tokens_so_far(req)
                    for t in tokens[sent:]:
                        _sse(self, {"token": t})
                    sent = len(tokens)
                    self.wfile.flush()
                    if req.state is RequestState.FINISHED:
                        final = frontend.runner.tokens_so_far(req)
                        for t in final[sent:]:
                            _sse(self, {"token": t})
                        done = {"done": True, "output_ids": final}
                        if req.resume_offset:
                            done["resumed_from"] = req.resume_offset
                        if frontend.tokenizer is not None:
                            done["text"] = frontend.tokenizer.decode(final)
                        if req.cancelled:
                            done["cancelled"] = True
                        _sse(self, done)
                        self.wfile.flush()
                        tr = req.trace
                        if tr is not None:
                            tr.add("http_request", req.submit_time,
                                   time.monotonic() - req.submit_time, cat="http", stream=True,
                                   output_tokens=len(final))
                        return
                    # Park until the next token lands or the request
                    # finishes: the engine notifies per consumed token, so
                    # first-token latency is not quantized by a poll. The
                    # 0.5 s re-check covers a notify racing the read above.
                    with req.cond:
                        if (
                            len(req.output_tokens) <= sent
                            and req.state is not RequestState.FINISHED
                        ):
                            req.cond.wait(timeout=0.5)

        self._server = _FrontendServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http-serve"
        )
        self._thread.start()
        self.log.info("serving frontend on %s:%d", host, self.port)

    def _run_profile(self, seconds: float) -> tuple[int, dict]:
        """One ``torch.profiler`` window of live serving into a fresh
        numbered directory under ``profile_dir`` (``obs/tracing.py``).
        Shared by ``POST /profile`` and ``GET /debug/profile``."""
        if self.profile_dir is None:
            return 403, {"error": "profiling disabled (no --profile-dir)"}
        if not 0.0 < seconds <= 60.0:
            return 400, {"error": "seconds must be in (0, 60]"}
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"error": "profile already running"}
        try:
            from radixmesh_tpu_torch.obs.tracing import profile

            # The lock is held: the sequence needs none of its own. The
            # time stamp keeps directories unique across restarts.
            self._profile_seq += 1
            logdir = os.path.join(
                self.profile_dir, f"capture-{int(time.time())}-{self._profile_seq:04d}"
            )
            with profile(logdir) as info:
                # meshcheck: ok[sleep-audit] the sleep IS the
                # requested torch.profiler capture window.
                time.sleep(seconds)
        except Exception as e:  # noqa: BLE001 — report, don't kill the handler
            return 500, {"error": str(e)}
        finally:
            self._profile_lock.release()
        return 200, {"profiled_s": seconds, "logdir": logdir, **info}

    def close(self, drain_s: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self.blackbox is not None:
            # A graceful shutdown writes one last final (each final is
            # complete; the loader takes the newest).
            self.blackbox.close(flush_cause="shutdown")
        if self.history is not None:
            self.history.close()
        self.runner.close(drain_s=drain_s)
        self.runner.engine.close()


class RouterFrontend:
    """HTTP API over a router node's cache-aware router
    (:class:`~radixmesh_tpu_torch.router.cache_aware_router.CacheAwareRouter`).

    ``POST /route`` ``{"input_ids"}`` (or ``{"text"}`` with a tokenizer, which
    must be the serving nodes' own) answers where to send the request:
    ``prefill_addr``/``decode_addr`` (cache addresses, null when no node of
    that role is alive), ``prefill_serve_addr``/``decode_serve_addr`` (their
    serving HTTP endpoints), ``prefill_cache_hit``/``decode_cache_hit`` and
    ``match_len``. Also ``GET /healthz``, ``/metrics``, ``/debug/{trace,
    requests,state,timeseries,waterfall}``, ``/cluster/telemetry`` and
    ``POST /admin/blackbox``, as the serving frontend answers them; the
    history samples the router's mesh replica. ``/cluster/{health,doctor}``
    judge the fleet-facing seams (a router holds no engine or SLO
    controller). With ``aggregator_peers`` (``(name, base_url[, rank])``;
    the rank lets the doctor's ``telemetry_gap`` rule tell a dead node from
    a dead sampler) the router hosts the :class:`FleetAggregator`, pulling
    each peer's ``/debug/timeseries`` every ``aggregator_interval_s`` into
    the store that ``/cluster/{timeseries,slo}`` serve and the doctor's
    fleet rules read."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0, tokenizer=None,
                 history_interval_s: float = 1.0, history_capacity: int = 900,
                 blackbox_dir: str | None = None, blackbox_watchdog_s: float = 0.0,
                 aggregator_peers: Sequence[tuple] = (), aggregator_interval_s: float = 2.0):
        self.router = router
        self.tokenizer = tokenizer
        self.log = get_logger("http.route")
        ensure_attributor()
        node_label = f"router@{router.mesh_cache.rank}"
        self.history = None
        if history_interval_s > 0:
            self.history = TelemetryHistory(
                interval_s=history_interval_s, capacity=history_capacity,
                mesh=router.mesh_cache, node=node_label,
            )
        self.aggregator = None
        if aggregator_peers:
            self.aggregator = FleetAggregator(
                peers=[HttpPeer(p[0], p[1], rank=p[2] if len(p) > 2 else None)
                       for p in aggregator_peers],
                interval_s=aggregator_interval_s, capacity=history_capacity, node=node_label,
                registry=get_registry(),
            )
        self.doctor = MeshDoctor(mesh=router.mesh_cache, attributor=ensure_attributor,
                                 history=self.history, aggregator=self.aggregator)
        self.blackbox = None
        if blackbox_dir:
            self.blackbox = BlackBox(
                blackbox_dir, history=self.history, doctor=self.doctor, recorder=get_recorder,
                attributor_fn=ensure_attributor, state_fn=self._debug_state, node=node_label,
                segment_every=1, max_segments=history_capacity,
                watchdog_timeout_s=blackbox_watchdog_s,
            )
        if self.history is not None:
            self.history.start()
        if self.aggregator is not None:
            self.aggregator.start()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                frontend.log.debug(fmt, *args)

            def do_GET(self):
                path = urlsplit(self.path).path
                query = parse_qs(urlsplit(self.path).query)
                if path == "/healthz":
                    _json_response(self, 200, {"status": "ok"})
                elif path == "/metrics":
                    _metrics_response(self)
                elif path == "/debug/trace":
                    _json_response(self, 200, _debug_trace(query))
                elif path == "/debug/requests":
                    # Routing is one stateless tree walk per call: the empty
                    # table (not a 404) keeps fleet tooling uniform.
                    _json_response(self, 200, {
                        "requests": [],
                        "note": "router node — see a serving node's /debug/requests for "
                                "in-flight requests",
                    })
                elif path == "/debug/state":
                    _json_response(self, 200, frontend._debug_state())
                elif path == "/debug/timeseries":
                    _json_response(self, *_debug_timeseries(frontend.history, query))
                elif path == "/debug/waterfall":
                    _json_response(self, 200, ensure_attributor().report())
                elif path == "/cluster/telemetry":
                    _json_response(self, 200, _cluster_telemetry(frontend.router.mesh_cache))
                elif path == "/cluster/health":
                    _json_response(self, 200, _cluster_health(frontend.router.mesh_cache))
                elif path == "/cluster/doctor":
                    _json_response(self, 200, frontend.doctor.diagnose())
                elif path == "/cluster/timeseries":
                    _json_response(self, *_cluster_timeseries(frontend.aggregator, query))
                elif path == "/cluster/slo":
                    _json_response(self, *_cluster_slo(frontend.aggregator))
                else:
                    _json_response(self, 404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/admin/blackbox":
                    _discard_body(self)
                    _json_response(self, *_admin_blackbox(frontend.blackbox))
                    return
                if self.path != "/route":
                    _json_response(self, 404, {"error": "not found"})
                    return
                try:
                    ids = _ids_from_body(_read_json(self), frontend.tokenizer, "router")
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    _json_response(self, 400, {"error": str(e)})
                    return
                res = frontend.router.cache_aware_route(ids)
                cfg = frontend.router.config
                _json_response(self, 200, {
                    # A null address: no node of that role is alive now.
                    "prefill_addr": res.prefill_addr,
                    "decode_addr": res.decode_addr,
                    # Where to POST /generate: the routed node's serving
                    # endpoint (cache port + serve_port_offset).
                    "prefill_serve_addr": cfg.serve_addr(res.prefill_addr),
                    "decode_serve_addr": cfg.serve_addr(res.decode_addr),
                    "prefill_cache_hit": res.prefill_cache_hit,
                    "decode_cache_hit": res.decode_cache_hit,
                    "match_len": res.match_len,
                })

        self._server = _FrontendServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http-route"
        )
        self._thread.start()
        self.log.info("router frontend on %s:%d", host, self.port)

    def _debug_state(self) -> dict:
        r = self.router
        with r._alive_lock:
            alive = {k: sorted(v) for k, v in r._alive.items()}
        return {
            "router": {
                "warm_up": r._warm_up,
                "alive": alive,
                "estimated_load": {
                    addr: round(r._loads.load(addr), 3)
                    for role_addrs in alive.values()
                    for addr in role_addrs
                },
            },
            "membership": _membership_state(r.mesh_cache),
            "trace": get_recorder().stats(),
            "exemplars": get_registry().exemplars(),
        }

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self.aggregator is not None:
            # Before the history: a pull sweep racing the shutdown must not
            # ingest into a store whose owner is tearing down.
            self.aggregator.close()
        if self.blackbox is not None:
            self.blackbox.close(flush_cause="shutdown")
        if self.history is not None:
            self.history.close()
