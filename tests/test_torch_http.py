"""The port's HTTP frontend over a tiny CPU engine: ``/generate`` answers
what ``Engine.generate`` answers on the same weights, ``/healthz`` and
``/stats`` serve (with the kernels' launch counts), a plain frontend (no
SLO control) accepts and ignores ``tenant``, ``ttft_deadline_ms`` and
``deadline_ms`` as the JAX frontend does and streams for ``stream``,
``seed``, ``resume_tokens`` and ``trace_id`` are accepted, and ``text`` is answered 400 without a
tokenizer and with ``text`` by a frontend that has one. A
frontend over an engine with speculative decode and mixed waves answers
the JAX engine's greedy tokens and reports both in ``/stats``. A frontend
over an engine with the three KV tiers serves a prefix evicted under pool
pressure as a host hit and reports the tiers in ``/stats``. ``POST
/admin/blackbox`` reads the request body it does not use."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, device="cpu")


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def served():
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(cfg, seed=3, device="cpu")
    fe = ServingFrontend(Engine(cfg, params, **ENGINE_KW), port=0)
    yield cfg, params, fe
    fe.close(drain_s=0.0)


def test_generate_matches_engine(served):
    cfg, params, fe = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (9, 21)]
    ref = Engine(cfg, params, **ENGINE_KW).generate(
        prompts, SamplingParams(max_new_tokens=6)
    )
    for prompt, want in zip(prompts, ref):
        code, body = _post(fe.port, "/generate", {"input_ids": prompt, "max_tokens": 6})
        assert code == 200, body
        assert body["output_ids"] == want
        assert body["ttft_s"] > 0 and body["e2e_s"] >= body["ttft_s"]
    # The same prompt again is a prefix-cache hit with the same tokens.
    code, body = _post(fe.port, "/generate", {"input_ids": prompts[1], "max_tokens": 6})
    assert code == 200 and body["cached_tokens"] > 0
    assert body["output_ids"] == ref[1]


def test_stop_token_and_sampling_fields(served):
    cfg, _, fe = served
    code, first = _post(fe.port, "/generate", {"input_ids": [1, 2, 3, 4, 5], "max_tokens": 4})
    assert code == 200
    stop = first["output_ids"][1]
    code, body = _post(
        fe.port, "/generate",
        {"input_ids": [1, 2, 3, 4, 5], "max_tokens": 4, "stop_token_ids": [stop]},
    )
    assert code == 200 and body["output_ids"] == first["output_ids"][:1]
    code, body = _post(
        fe.port, "/generate",
        {"input_ids": [7, 8, 9], "max_tokens": 3, "temperature": 0.9, "top_k": 5, "top_p": 0.8},
    )
    assert code == 200 and len(body["output_ids"]) == 3


def test_health_stats_and_refusals(served):
    _, _, fe = served
    assert _get(fe.port, "/healthz") == (200, {"status": "ok"})
    code, stats = _get(fe.port, "/stats")
    assert code == 200 and {"hit_rate", "finished", "prefill_chunks", "kernels"} <= set(stats)
    # CPU tensors: the plain versions ran, no kernel launched.
    assert stats["kernels"]["paged_decode_fused_kernel"] == 0
    # A plain frontend (no SLO control) accepts the SLO fields and ignores
    # them, as the JAX frontend does; "stream" answers server-sent events.
    code, plain = _post(fe.port, "/generate", {"input_ids": [1, 2, 3], "max_tokens": 2})
    assert code == 200
    for extra in ({"tenant": "a"}, {"deadline_ms": 100}, {"ttft_deadline_ms": 1},
                  {"tenant": "whoever", "ttft_deadline_ms": 1, "deadline_ms": 1}):
        code, body = _post(fe.port, "/generate", {"input_ids": [1, 2, 3], "max_tokens": 2, **extra})
        assert code == 200 and body["output_ids"] == plain["output_ids"], body
        assert "shed" not in body
    req = urllib.request.Request(
        f"http://127.0.0.1:{fe.port}/generate",
        data=json.dumps({"input_ids": [1, 2, 3], "max_tokens": 2, "stream": True}).encode(),
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = [json.loads(line[len(b"data: "):]) for line in r if line.startswith(b"data: ")]
    assert events == [{"token": t} for t in plain["output_ids"]] + [
        {"done": True, "output_ids": plain["output_ids"]}]
    assert "slo" not in stats
    # text without a tokenizer: 400, with the JAX frontend's message.
    code, body = _post(fe.port, "/generate", {"text": "hello"})
    assert code == 400 and "no tokenizer" in body["error"], body
    code, body = _post(fe.port, "/generate", {"input_ids": "nope"})
    assert code == 400
    code, body = _post(fe.port, "/generate", {"input_ids": [1, 10_000]})
    assert code == 400


def test_cancel_endpoint(served):
    _, _, fe = served
    assert _post(fe.port, "/cancel", {"rid": 10**9}) == (200, {"cancelled": False})
    code, _ = _post(fe.port, "/cancel", {"id": 1})
    assert code == 400


def test_spec_and_mixed_waves_over_http():
    import jax
    import jax.numpy as jnp

    from radixmesh_tpu.engine.engine import Engine as JEngine
    from radixmesh_tpu.engine.request import SamplingParams as JSampling
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu_torch.models.convert import params_from_jax

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    kw = dict(ENGINE_KW, spec_decode_tokens=2, prefill_inline_budget=32)
    fe = ServingFrontend(Engine(cfg, params, **kw), port=0)
    try:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, 512, 5).tolist() * 3, rng.integers(1, 512, 70).tolist()]
        kw.pop("device")
        want = JEngine(jcfg, jparams, **kw).generate(prompts, JSampling(max_new_tokens=12))
        for prompt, w in zip(prompts, want):
            code, body = _post(fe.port, "/generate", {"input_ids": prompt, "max_tokens": 12})
            assert code == 200 and body["output_ids"] == w, body
        code, stats = _get(fe.port, "/stats")
        assert code == 200
        assert stats["spec_proposed"] > 0
        assert stats["spec_proposed"] == stats["spec_accepted"] + stats["spec_rejected"]
        assert sum(c["proposed"] for c in stats["spec"].values()) == stats["spec_proposed"]
        assert {"budget", "counts", "inline_tokens", "inline_backlog"} <= set(stats["waves"])
        assert stats["decode_dispatch"]["path"] in ("dense", "paged")
    finally:
        fe.close(drain_s=0.0)


def test_submission_joins_a_busy_engine():
    """A request submitted while the runner steps a long decode is queued
    on the engine at the next step, not after the engine goes idle."""
    from radixmesh_tpu_torch.server.http_frontend import EngineRunner

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    engine = Engine(cfg, init_params(cfg, seed=3, device="cpu"), **ENGINE_KW)
    runner = EngineRunner(engine).start()
    try:
        long = runner.submit(list(range(1, 20)), SamplingParams(max_new_tokens=400))
        while len(long.output_tokens) < 2:
            time.sleep(0.001)
        short = runner.submit([5, 6, 7], SamplingParams(max_new_tokens=1))
        runner.wait(short, timeout=60)
        assert long.state.value == "running", "the short request waited for the long one"
        runner.wait(long, timeout=120)
        assert len(long.output_tokens) == 400
    finally:
        runner.close()


def test_tiered_engine_reports_a_host_hit(tmp_path):
    """Pool pressure evicts the first prompt to the host tier;
    its repeat parks for a staged restore and answers the same tokens with
    ``cached_tokens`` > 0; ``/stats`` carries ``host_fill``, ``host_tier``,
    ``kv_transfer`` and ``kv_tier`` (the JAX key names)."""
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    kw = dict(ENGINE_KW, num_slots=160, max_batch=2, host_cache_slots=1024,
              kv_transfer_async=True, kv_transfer_chunk_tokens=16, kv_tier_dir=str(tmp_path))
    fe = ServingFrontend(Engine(cfg, init_params(cfg, seed=3, device="cpu"), **kw), port=0)
    try:
        rng = np.random.default_rng(2)
        a, b, c = (rng.integers(0, cfg.vocab_size, size=60).tolist() for _ in range(3))
        replies = []
        for prompt in (a, b, c, a):
            code, body = _post(fe.port, "/generate", {"input_ids": prompt, "max_tokens": 8})
            assert code == 200, body
            replies.append(body)
        assert replies[0]["cached_tokens"] == 0
        assert replies[3]["cached_tokens"] > 0, "the repeat should hit through the host tier"
        assert replies[3]["output_ids"] == replies[0]["output_ids"]
        code, stats = _get(fe.port, "/stats")
        assert code == 200
        assert 0.0 < stats["host_fill"] <= 1.0
        assert stats["host_tier"]["backup_tokens"] > 0
        assert stats["host_tier"]["restore_tokens"] >= replies[3]["cached_tokens"]
        assert stats["kv_transfer"]["restored_tokens"] >= replies[3]["cached_tokens"]
        assert stats["kv_transfer"]["restoring_requests"] == 0
        assert stats["kv_tier"]["dir"] == str(tmp_path)
    finally:
        fe.close(drain_s=0.0)


def test_text_with_a_tokenizer():
    from radixmesh_tpu_torch.server.tokenizer import ByteTokenizer

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tok = ByteTokenizer()
    fe = ServingFrontend(Engine(cfg, init_params(cfg, seed=4, device="cpu"), **ENGINE_KW), port=0,
                         tokenizer=tok)
    try:
        code, body = _post(fe.port, "/generate", {"text": "hello over http", "max_tokens": 5,
                                                  "stop_token_ids": []})
        assert code == 200 and len(body["output_ids"]) == 5
        assert body["text"] == tok.decode(body["output_ids"])
        code, again = _post(fe.port, "/generate", {"input_ids": tok.encode("hello over http"),
                                                   "max_tokens": 5})
        assert code == 200 and again["output_ids"] == body["output_ids"]
        assert again["cached_tokens"] > 0
    finally:
        fe.close(drain_s=0.0)


def _get_text(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def test_seed_resume_and_trace_id_are_accepted(tmp_path):
    """``seed``, ``resume_tokens`` and ``trace_id`` are served: the same
    seed twice gives the same tokens, a resume returns the continuation
    with ``resumed_from``, an adopted trace id comes back in the reply and
    on the recorder's spans; bad values are a 400."""
    from radixmesh_tpu_torch.obs.trace_plane import FlightRecorder, get_recorder, set_recorder

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(cfg, seed=5, device="cpu")
    old = get_recorder()
    set_recorder(FlightRecorder(capacity=4096, sample=1.0))
    fe = ServingFrontend(Engine(cfg, params, name="http-replay", **ENGINE_KW), port=0,
                         profile_dir=str(tmp_path / "prof"))
    try:
        body = {"input_ids": list(range(3, 30)), "max_tokens": 8, "temperature": 0.9,
                "top_p": 0.95, "seed": 4242}
        code, a = _post(fe.port, "/generate", body)
        assert code == 200, a
        code, b = _post(fe.port, "/generate", {**body, "trace_id": "0xbeef"})
        assert code == 200 and b["output_ids"] == a["output_ids"]
        assert b["trace_id"] == 0xBEEF and "resumed_from" not in b
        assert any(s.trace_id == 0xBEEF for s in get_recorder().snapshot())
        code, r = _post(fe.port, "/generate", {**body, "resume_tokens": a["output_ids"][:3]})
        assert code == 200 and r["resumed_from"] == 3
        assert r["output_ids"] == a["output_ids"][3:]
        for bad in ({"seed": "x"}, {"seed": True}, {"resume_tokens": [1, "2"]},
                    {"trace_id": 0}, {"trace_id": 1 << 64},
                    {"resume_tokens": a["output_ids"]}):  # covers the whole budget
            code, err = _post(fe.port, "/generate", {**body, **bad})
            assert code == 400, (bad, err)
        code, stats = _get(fe.port, "/stats")
        assert stats["resurrections"] == 1 and stats["replayed_tokens"] == 27 + 3
        code, text = _get_text(fe.port, "/metrics")
        assert code == 200
        # The counter agrees with /stats (decode tokens: 7 + 7 + 4).
        assert stats["generated_tokens"] == 18
        assert 'radixmesh_engine_generated_tokens_total{engine="http-replay"} 18' in text
        assert 'radixmesh_engine_ttft_seconds_count{engine="http-replay"} 3' in text
        code, reqs = _get(fe.port, "/debug/requests")
        assert code == 200 and reqs["running"] == reqs["waiting"] == 0
        code, state = _get(fe.port, "/debug/state")
        assert state["engine"]["name"] == "http-replay" and state["trace"]["enabled"]
        assert state["timeline"]["appends"] == 7 + 7 + 4
        code, toks = _get(fe.port, "/debug/tokens?limit=2")
        assert code == 200 and len(toks["timeline"]["recent"]) <= 2
        assert toks["goodput"]["useful_tokens"] == 8 + 8 + 5
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(fe.port, "/debug/tokens?limit=x")
        assert e.value.code == 400
        code, trace = _get(fe.port, "/debug/trace")
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
        assert {"prefix_match", "prefill_wave", "decode_chunk", "first_token", "publish",
                "http_request", "request_done"} <= names
        code, prof = _post(fe.port, "/profile", {"seconds": 0.2})
        assert code == 200 and (tmp_path / "prof").exists(), prof
        assert json.load(open(prof["trace"]))["traceEvents"]
        code, _ = _post(fe.port, "/profile", {"seconds": 0})
        assert code == 400
        code, prof = _get(fe.port, "/debug/profile?seconds=0.1")
        assert code == 200 and prof["logdir"].startswith(str(tmp_path / "prof"))
    finally:
        fe.close(drain_s=0.0)
        set_recorder(old)


def test_debug_tokens_404_without_timeline_and_profile_403_without_dir():
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(cfg, seed=5, device="cpu")
    fe = ServingFrontend(Engine(cfg, params, token_timeline_capacity=0, **ENGINE_KW), port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(fe.port, "/debug/tokens")
        assert e.value.code == 404
        code, body = _post(fe.port, "/profile", {"seconds": 1})
        assert code == 403 and "profile-dir" in body["error"]
    finally:
        fe.close(drain_s=0.0)


def _post_raw(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_slo_frontend_sheds_and_reports():
    """With ``slo=``: a rate-limited tenant's second prompt answers 429
    with ``Retry-After``; a request whose end-to-end deadline passes while
    it waits in the SLO queue answers 503 with the shed body; ``/stats``
    and ``/debug/state`` carry the controller's snapshot, ``/debug/requests``
    the tenant and the SLO-queue wait; ``/debug/timeseries`` serves the
    ``radixmesh_slo_*`` series and ``/debug/waterfall`` the attributor."""
    import threading

    from radixmesh_tpu_torch.slo import SLOConfig, TenantConfig

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    slo = SLOConfig(tenants={"c": TenantConfig(rate_tokens_per_s=0.1, burst_tokens=24)})
    fe = ServingFrontend(Engine(cfg, init_params(cfg, seed=3, device="cpu"), **ENGINE_KW), port=0,
                         slo=slo, history_interval_s=0.05)
    try:
        code, _, body = _post_raw(fe.port, {"input_ids": list(range(1, 20)), "max_tokens": 3,
                                            "tenant": "c"})
        assert code == 200 and len(body["output_ids"]) == 3
        code, headers, body = _post_raw(fe.port, {"input_ids": list(range(1, 20)), "max_tokens": 3,
                                                  "tenant": "c"})
        assert code == 429 and int(headers["Retry-After"]) >= 1, body
        assert body["shed"] and body["reason"] == "rate_limited" and body["retry_after_s"] > 0
        # Hold the step lock so the next request waits in the SLO queue
        # past its 1 ms end-to-end deadline.
        got = {}
        with fe.runner._lock:
            t = threading.Thread(target=lambda: got.update(zip(
                ("code", "headers", "body"),
                _post_raw(fe.port, {"input_ids": [4, 5, 6], "max_tokens": 2, "deadline_ms": 1}))))
            t.start()
            deadline = time.monotonic() + 30
            while fe.runner.ctl.snapshot()["queued_requests"] == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(0.02)
        t.join(timeout=60)
        assert got["code"] == 503 and got["body"]["shed"], got
        assert got["body"]["reason"] == "e2e_deadline_expired_in_queue"
        code, stats = _get(fe.port, "/stats")
        assert stats["slo"]["total_admitted"] == 1 and stats["slo"]["total_shed"] == 2
        code, state = _get(fe.port, "/debug/state")
        assert state["slo"]["tenants"]["c"]["admitted_tokens"] == 19
        long = threading.Thread(target=_post_raw, args=(fe.port, {"input_ids": [7, 8, 9], "max_tokens": 300,
                                                                 "tenant": "b"}))
        long.start()
        deadline = time.monotonic() + 30
        rows = []
        while not rows and time.monotonic() < deadline:
            rows = [r for r in _get(fe.port, "/debug/requests")[1]["requests"] if r["tenant"] == "b"]
        assert rows and rows[0]["elapsed_s"]["slo_queue"] is not None
        long.join(timeout=60)
        time.sleep(0.1)
        code, page = _get(fe.port, "/debug/timeseries?family=radixmesh_slo_shed&limit=50")
        assert code == 200 and any("rate_limited" in n for n in page["series"])
        code, wf = _get(fe.port, "/debug/waterfall")
        assert code == 200 and "slo_queue" in wf["phases"]
    finally:
        fe.close(drain_s=0.0)


def test_admin_blackbox_reads_the_body_it_ignores():
    """``POST /admin/blackbox`` consumes its request body before answering:
    a socket closed with unread bytes resets the connection, which can drop
    the reply before the client reads it."""
    import io
    import types

    from radixmesh_tpu_torch.server.http_frontend import _discard_body

    body = io.BytesIO(b"{}next")
    _discard_body(types.SimpleNamespace(headers={"Content-Length": "2"}, rfile=body))
    assert body.tell() == 2
    _discard_body(types.SimpleNamespace(headers={}, rfile=body))
    assert body.tell() == 2
