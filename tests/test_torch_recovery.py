"""The request-recovery plane in the port (``policy/retry.py``,
``server/recovery.py``): the cases of ``tests/test_recovery.py``, run
against ``radixmesh_tpu_torch``.

Dropped:
- ``TestEngineResume``: its cases reach the JAX engine; their twins on the
  port's engine are ``tests/test_torch_seeded_replay.py::TestEngineResume``.
- ``TestHttpResume``: it builds the JAX engine and frontend. Its twin is
  below, on the port's ``ServingFrontend`` over the tiny model with params
  converted from the JAX init, in float32, next to the JAX frontend on the
  same params: the resumed request continues from token ``k``, never
  re-emits the delivered prefix, is served from the cache, and both
  frontends give the same tokens."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import load_twin

load_twin("test_recovery", globals(), drop=("TestEngineResume", "TestHttpResume"))


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


class TestHttpResume:
    @pytest.fixture(scope="class")
    def frontends(self):
        from radixmesh_tpu.engine.engine import Engine as JEngine
        from radixmesh_tpu.models import llama as jl
        from radixmesh_tpu.server.http_frontend import ServingFrontend as JFrontend
        from radixmesh_tpu_torch.engine.engine import Engine
        from radixmesh_tpu_torch.models.convert import params_from_jax
        from radixmesh_tpu_torch.models.llama import ModelConfig
        from radixmesh_tpu_torch.server.http_frontend import ServingFrontend

        torch.set_num_threads(1)
        jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
        jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
        kw = dict(num_slots=512, page_size=4, max_batch=2, name="resume-http")
        jf = JFrontend(JEngine(jcfg, jparams, **kw), port=0)
        tf = ServingFrontend(Engine(tcfg, tparams, device="cpu", **kw), port=0)
        yield jf, tf
        tf.close(drain_s=0.5)
        jf.close(drain_s=0.5)

    def test_generate_resumes_over_http(self, frontends):
        jf, tf = frontends
        prompt = list(range(1, 25))
        _, full = _post(tf.port, {"input_ids": prompt, "max_tokens": 8})
        _, jfull = _post(jf.port, {"input_ids": prompt, "max_tokens": 8})
        assert full["output_ids"] == jfull["output_ids"]
        k = 3
        body = {"input_ids": prompt, "max_tokens": 8, "resume_tokens": full["output_ids"][:k]}
        status, out = _post(tf.port, body)
        _, jout = _post(jf.port, body)
        assert status == 200
        assert out["resumed_from"] == k == jout["resumed_from"]
        # Continues from token k, never re-emits the delivered prefix, and
        # the replay was served from the cache.
        assert out["output_ids"] == full["output_ids"][k:] == jout["output_ids"]
        assert out["cached_tokens"] > 0
