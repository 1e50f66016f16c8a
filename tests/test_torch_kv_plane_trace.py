"""The async KV-movement plane's trace events and in-flight gauge, against
the JAX package's plane (``ROADMAP.md`` C6): both packages' engines (tiny,
float32, host and disk tiers, the plane armed) run one script — a
write-back, a spill to disk, a staged restore from the host arena and a
staged handoff block — with a sampling flight recorder and a fresh
registry each. The events on the plane's ``kv:`` lane (names, categories,
token counts, restore sources) and the
``radixmesh_kv_transfer_inflight_tokens`` series (one per lane, back at 0
once the plane settles) must be the same in both.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.obs import metrics as j_metrics
from radixmesh_tpu.obs import trace_plane as j_trace
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.obs import metrics
from radixmesh_tpu_torch.obs import trace_plane

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(dtype=torch.float32)
PROMPT = list(range(1, 70))
GAUGE = "radixmesh_kv_transfer_inflight_tokens"
KW = dict(name="twin", num_slots=512, page_size=4, max_batch=2, host_cache_slots=512,
          kv_tier_watermark=0.0, kv_tier_destage_budget=64, kv_tier_destage_interval_s=0.0,
          kv_transfer_chunk_tokens=16)


def _settle(eng, timeout=15.0):
    plane = eng.kv_transfer
    assert plane.wait_host_ready()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        eng.step()
        if plane.spills_idle() and not plane.has_engine_work():
            return
        plane.wait_progress(0.01)
    raise AssertionError("the plane never settled")


def _script(eng, sampling):
    """Write-back, spill, restore, handoff block; the plane settled after
    each."""
    eng.generate([PROMPT], sampling)
    assert eng.tree.evict(1 << 20) > 0  # device -> host: the write-back lane
    _settle(eng)
    eng.tree.destage_cold(force=True, budget=1 << 20)  # host -> disk: the spill lane
    _settle(eng)
    out = eng.generate([PROMPT], sampling)  # host -> device: a staged restore
    _settle(eng)
    eng.kv_transfer.note_handoff(12, eng.pool, 0.001)  # the handoff lane
    return out


def _run(mod_metrics, mod_trace, make):
    old_reg, old_rec = mod_metrics.get_registry(), mod_trace.get_recorder()
    mod_metrics.set_registry(mod_metrics.Registry())
    mod_trace.set_recorder(mod_trace.FlightRecorder(capacity=4096, sample=1.0))
    try:
        eng, sampling = make()
        try:
            out = _script(eng, sampling)
        finally:
            eng.kv_transfer.close()
        events = sorted(
            (s.name, s.cat, int(s.args["tokens"]), str(s.args.get("source")))
            for s in mod_trace.get_recorder().snapshot() if s.lane == "kv:twin")
        gauge = {k: v for k, v in mod_metrics.get_registry().snapshot().items() if k.startswith(GAUGE)}
        return out, events, gauge
    finally:
        mod_metrics.set_registry(old_reg)
        mod_trace.set_recorder(old_rec)


def test_plane_events_and_gauge_match_the_jax_plane(tmp_path):
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), TCFG, "cpu")
    want = _run(j_metrics, j_trace, lambda: (
        JEngine(JCFG, jparams, kv_tier_dir=str(tmp_path / "jax"), **KW), JSampling(max_new_tokens=4)))
    got = _run(metrics, trace_plane, lambda: (
        Engine(TCFG, tparams, device="cpu", kv_tier_dir=str(tmp_path / "port"), **KW),
        SamplingParams(max_new_tokens=4)))
    assert got[0] == want[0]
    assert got[1] == want[1]
    names = {e[0] for e in got[1]}
    assert names == {"kv_writeback", "kv_spill", "kv_restore", "kv_handoff_stage"}
    assert all(e[1] == "kv" for e in got[1])
    assert got[2] == want[2]
    assert sorted(got[2]) == sorted(f'{GAUGE}{{lane="{ln}",plane="twin"}}'
                                    for ln in ("restore", "writeback", "handoff", "spill"))
    assert set(got[2].values()) == {0.0}


@pytest.mark.parametrize("attr,kw", [
    ("page_size", dict(page_size=8)),
    ("num_layers", dict(num_layers=3)),
    ("num_kv_heads", dict(num_kv_heads=1)),
    ("head_dim", dict(head_dim=16)),
    ("quant", dict(quant="int8")),
    ("dtype", dict(dtype="bfloat16")),
])
def test_external_pool_checks_match_the_jax_engine(attr, kw):
    """``Engine(pool=...)`` (``ROADMAP.md`` C7): the JAX engine's checks, with
    its message, on a pool of the wrong geometry or dtype."""
    from radixmesh_tpu.cache.kv_pool import PagedKVPool as JPool
    from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool

    base = dict(num_slots=256, num_layers=JCFG.n_layers, num_kv_heads=JCFG.n_kv_heads,
                head_dim=JCFG.head_dim, page_size=4)
    jkw = {**base, **kw, "dtype": jnp.bfloat16 if kw.get("dtype") else jnp.float32}
    tkw = {**base, **kw, "dtype": torch.bfloat16 if kw.get("dtype") else torch.float32}
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), TCFG, "cpu")
    with pytest.raises(ValueError, match="external pool") as want:
        JEngine(JCFG, jparams, pool=JPool(**jkw), page_size=4)
    with pytest.raises(ValueError, match="external pool") as got:
        Engine(TCFG, tparams, pool=PagedKVPool(device="cpu", **tkw), page_size=4)
    assert f"external pool {attr}=" in str(got.value)
    assert str(want.value).split("=")[0] == str(got.value).split("=")[0]
