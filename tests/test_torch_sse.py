"""SSE streaming on the port's frontend held against the JAX frontend's
(tiny config, float32, CPU, the same weights, greedy): for the legacy
schedule, multi-step decode (k = 4) and speculative decode (γ = 4), each
prompt streamed gives the JAX frontend's event sequence exactly (one
``data: {"token": t}`` event per token, then the ``done`` event with
``output_ids``), the ``done`` event's ``output_ids`` are the events'
tokens in order and equal the non-streamed reply; a resumed stream carries
``resumed_from`` and continues with the tokens after the delivered ones;
a frontend with a tokenizer adds ``text`` to the ``done`` event."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.server.http_frontend import ServingFrontend as JFrontend
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend as TFrontend

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128)
SCHEDULES = {
    "legacy": {},
    "multi-step": dict(decode_steps_per_launch=4),
    "spec": dict(spec_decode_tokens=4),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if not body.get("stream"):
            return json.loads(r.read())
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = []
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
                if events[-1].get("done"):
                    break
        return events


def _serve_all(port, prompts):
    """Each prompt streamed and not; then the first resumed after 3
    delivered tokens, streamed."""
    out = []
    for p in prompts:
        events = _post(port, {"input_ids": p, "max_tokens": 12, "stream": True})
        plain = _post(port, {"input_ids": p, "max_tokens": 12})
        out.append((events, plain["output_ids"]))
    resumed = _post(port, {"input_ids": prompts[0], "max_tokens": 12, "stream": True,
                           "resume_tokens": out[0][1][:3]})
    return out, resumed


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_streams_equal_the_jax_frontends(weights, schedule):
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, 23).tolist(), rng.integers(1, 512, 6).tolist() * 4]
    kw = {**ENGINE_KW, **SCHEDULES[schedule]}
    runs = {}
    for name, fe in (("jax", JFrontend(JEngine(jcfg, jparams, **kw), port=0, history_interval_s=0.0)),
                     ("torch", TFrontend(TEngine(tcfg, tparams, device="cpu", **kw), port=0))):
        try:
            runs[name] = _serve_all(fe.port, prompts)
        finally:
            fe.close(drain_s=0.0)
    assert runs["torch"] == runs["jax"]
    served, resumed = runs["torch"]
    for events, plain in served:
        tokens = [e["token"] for e in events[:-1]]
        assert all(set(e) == {"token"} for e in events[:-1])
        assert events[-1] == {"done": True, "output_ids": tokens}
        assert tokens == plain and len(tokens) == 12
    full = served[0][1]
    assert resumed[-1] == {"done": True, "output_ids": full[3:], "resumed_from": 3}
    assert [e["token"] for e in resumed[:-1]] == full[3:]


def test_done_event_carries_text_with_a_tokenizer(weights):
    from radixmesh_tpu_torch.server.tokenizer import ByteTokenizer

    _, _, tcfg, tparams = weights
    tok = ByteTokenizer()
    fe = TFrontend(TEngine(tcfg, tparams, device="cpu", **ENGINE_KW), port=0, tokenizer=tok,
                   history_interval_s=0.0)
    try:
        events = _post(fe.port, {"text": "stream me", "max_tokens": 5, "stop_token_ids": [],
                                 "stream": True})
    finally:
        fe.close(drain_s=0.0)
    tokens = [e["token"] for e in events[:-1]]
    assert events[-1] == {"done": True, "output_ids": tokens, "text": tok.decode(tokens)}
