"""The port's metrics registry (``radixmesh_tpu_torch/obs/metrics.py``):
twins of ``tests/test_metrics.py`` (metric semantics, the exposition
format, the profiler helpers, the oplog's send timestamp, the engine's
series and the cache mesh's). Plus: the same observations render the same
exposition text from the JAX package's registry and the port's, and the
engine's registry counters agree with its ``EngineStats``.
"""

import threading

import numpy as np
import pytest

from radixmesh_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_registry,
)
from radixmesh_tpu_torch.obs.tracing import annotate, timed

pytestmark = pytest.mark.quick


@pytest.fixture(autouse=True)
def fresh_registry():
    """Isolate the process-wide registry per test."""
    old = get_registry()
    reg = set_registry(Registry())
    yield reg
    set_registry(old)


class TestCounter:
    def test_inc(self):
        c = Counter("c")
        c.inc()
        c.inc(4)
        assert c.value == 5

    def test_negative_rejected(self):
        with pytest.raises(ValueError):
            Counter("c").inc(-1)

    def test_labels(self):
        c = Counter("c", label_names=("op",))
        c.labels(op="a").inc()
        c.labels(op="a").inc()
        c.labels(op="b").inc(7)
        assert c.labels(op="a").value == 2
        assert c.labels(op="b").value == 7

    def test_wrong_labels_rejected(self):
        c = Counter("c", label_names=("op",))
        with pytest.raises(ValueError):
            c.labels(other="x")


class TestGauge:
    def test_set_inc_dec(self):
        g = Gauge("g")
        g.set(10)
        g.inc(2)
        g.dec(5)
        assert g.value == 7


class TestHistogram:
    def test_cumulative_buckets(self):
        h = Histogram("h", buckets=(1.0, 10.0))
        for v in (0.5, 0.7, 5.0, 100.0):
            h.observe(v)
        assert h.count == 4
        assert h.sum == pytest.approx(106.2)
        text = Registry().render()  # empty registry renders fine
        assert text == "\n"

    def test_quantile_interpolates_within_bucket(self):
        # p50 used to snap to the bucket's upper bound (2.0 here); the
        # interpolated estimate assumes uniform mass within the bucket.
        h = Histogram("h", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 1.7, 3.0):
            h.observe(v)
        # target = 2 of 4 samples; bucket (1, 2] holds samples #2-3, so
        # the estimate is 1 + (2-1) * (2-1)/2.
        assert h.quantile(0.5) == pytest.approx(1.5)
        assert h.quantile(1.0) == pytest.approx(4.0)

    def test_quantile_first_bucket_interpolates_from_zero(self):
        h = Histogram("h", buckets=(10.0, 20.0))
        for _ in range(4):
            h.observe(5.0)
        # All mass in (0, 10]: the p50 estimate is 10 * 0.5, not the
        # bucket edge.
        assert h.quantile(0.5) == pytest.approx(5.0)

    def test_quantile_overflow_returns_largest_finite_bound(self):
        h = Histogram("h", buckets=(1.0, 2.0))
        h.observe(100.0)  # lands in +Inf
        assert h.quantile(0.5) == 2.0

    def test_observe_bucket_edges_match_cumulative_semantics(self):
        # value == upper bound must land IN that bucket (<= semantics);
        # the bisect rewrite must not flip edges to the next bucket.
        h = Histogram("h", buckets=(1.0, 2.0, 4.0))
        for v in (1.0, 2.0, 4.0, 4.1):
            h.observe(v)
        assert h._counts == [1, 1, 1, 1]

    def test_timer(self):
        h = Histogram("h")
        with h.time():
            pass
        assert h.count == 1


class TestRegistry:
    def test_idempotent_registration(self, fresh_registry):
        reg = fresh_registry
        a = reg.counter("x_total", "help")
        b = reg.counter("x_total")
        assert a is b

    def test_type_clash_rejected(self, fresh_registry):
        reg = fresh_registry
        reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")

    def test_render_exposition(self, fresh_registry):
        reg = fresh_registry
        reg.counter("req_total", "requests", ("code",)).labels(code="200").inc(3)
        reg.gauge("temp").set(1.5)
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(5.0)
        text = reg.render()
        assert "# TYPE req_total counter" in text
        assert 'req_total{code="200"} 3' in text
        assert "# TYPE temp gauge" in text
        assert "temp 1.5" in text
        assert 'lat_seconds_bucket{le="0.1"} 1' in text
        assert 'lat_seconds_bucket{le="1"} 1' in text
        assert 'lat_seconds_bucket{le="+Inf"} 2' in text
        assert "lat_seconds_count 2" in text

    def test_snapshot(self, fresh_registry):
        reg = fresh_registry
        reg.counter("a").inc(2)
        reg.histogram("h").observe(1.0)
        snap = reg.snapshot()
        assert snap["a"] == 2
        assert snap["h_count"] == 1

    def test_thread_safety_smoke(self, fresh_registry):
        c = fresh_registry.counter("c")

        def worker():
            for _ in range(1000):
                c.inc()

        ts = [threading.Thread(target=worker) for _ in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert c.value == 8000


class TestTracing:
    def test_annotate_noop(self):
        with annotate("span"):
            pass

    def test_timed_observes(self):
        h = Histogram("h")
        with timed(h, "x"):
            pass
        assert h.count == 1


class TestOplogTimestamp:
    def test_ts_round_trips(self):
        from radixmesh_tpu_torch.cache.oplog import Oplog, OplogType, deserialize, serialize

        op = Oplog(
            op_type=OplogType.INSERT,
            origin_rank=1,
            logic_id=7,
            ttl=3,
            key=np.arange(4, dtype=np.int32),
            value=np.arange(4, dtype=np.int32),
            value_rank=1,
            ts=1234.5,
        )
        assert deserialize(serialize(op)).ts == 1234.5


class TestEngineMetrics:
    def test_engine_populates_registry(self, fresh_registry):
        from radixmesh_tpu_torch.engine.engine import Engine
        from radixmesh_tpu_torch.models.llama import ModelConfig, init_params

        cfg = ModelConfig.tiny()
        params = init_params(cfg, seed=0, device="cpu")
        eng = Engine(cfg, params, num_slots=512, page_size=4, max_batch=2, name="e0",
                     device="cpu")
        prompt = list(range(1, 20))
        eng.generate([prompt], max_steps=30)
        eng.generate([prompt], max_steps=30)  # second pass hits the cache
        snap = fresh_registry.snapshot()
        k = '{engine="e0"}'
        assert snap[f"radixmesh_engine_prompt_tokens_total{k}"] == 2 * len(prompt)
        assert snap[f"radixmesh_engine_cached_tokens_total{k}"] > 0
        assert snap[f"radixmesh_engine_generated_tokens_total{k}"] > 0
        assert snap[f"radixmesh_engine_ttft_seconds{k}_count"] == 2
        assert snap[f"radixmesh_engine_tpot_seconds{k}_count"] >= 1
        # counter == stats (the stop-token path must not diverge)
        assert snap[f"radixmesh_engine_generated_tokens_total{k}"] == eng.stats.generated_tokens
        assert snap[f"radixmesh_engine_cached_tokens_total{k}"] == eng.stats.cached_tokens
        assert snap[f"radixmesh_engine_prefix_hit_tokens{k}_count"] == 2
        assert snap['radixmesh_request_ttft_seconds{tenant="default"}_count'] == 2
        assert snap['radixmesh_request_e2e_seconds{tenant="default"}_count'] == 2
        for cause in ("capacity", "ttl", "preempt", "mesh_trim"):
            assert snap[f'radixmesh_cache_evicted_tokens_total{{cause="{cause}",node="e0"}}'] == 0

    def test_evictions_and_preemptions_by_cause(self, fresh_registry):
        """A pool too small for the traffic: capacity evictions at
        admission land on the registry, and the counters agree with the
        engine's."""
        import torch

        from radixmesh_tpu_torch.engine.engine import Engine
        from radixmesh_tpu_torch.models.llama import ModelConfig, init_params

        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"), num_slots=96, page_size=4,
                     max_batch=2, name="tight", device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.generate([rng.integers(1, 500, 40).tolist()])
        snap = fresh_registry.snapshot()
        evicted = sum(snap[f'radixmesh_cache_evicted_tokens_total{{cause="{c}",node="tight"}}']
                      for c in ("capacity", "preempt"))
        assert evicted == eng.stats.evicted_tokens > 0
        assert snap['radixmesh_engine_preemptions_total{engine="tight"}'] == eng.stats.preemptions


class TestMeshMetrics:
    def test_ring_populates_lag_and_counters(self, fresh_registry):
        """``tests/test_mesh_cache.py``'s cluster (3 prefill + 2 decode + 1
        router, in process) with the port's nodes and pools: one insert
        replicates everywhere, and the ring's lag histogram and oplog
        counters land on the registry."""
        import time

        from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
        from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
        from radixmesh_tpu_torch.comm.inproc import InprocHub
        from radixmesh_tpu_torch.config import MeshConfig, NodeRole

        def wait_for(pred, timeout=10.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and not pred():
                time.sleep(0.01)
            return pred()

        prefill, decode, router = ["p0", "p1", "p2"], ["d0", "d1"], ["r0"]
        InprocHub.reset_default()
        nodes = []
        try:
            for addr in prefill + decode + router:
                cfg = MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=router,
                                 local_addr=addr, protocol="inproc", tick_interval_s=0.05, gc_interval_s=30.0)
                pool = None if cfg.local_role is NodeRole.ROUTER else PagedKVPool(
                    num_slots=256, num_layers=1, num_kv_heads=1, head_dim=2, device="cpu")
                nodes.append(MeshCache(cfg, pool=pool))
            for n in nodes:
                n.start()
            for n in nodes:
                assert n.wait_ready(timeout=10), f"node {n.rank} never became ready"
            ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
            prefill_node = nodes[1]
            prefill_node.insert([1, 2, 3], prefill_node.pool.alloc(3))
            assert wait_for(lambda: all(n.match_prefix([1, 2, 3]).length == 3 for n in ring))
            snap = fresh_registry.snapshot()
            lag = [v for k, v in snap.items()
                   if k.startswith("radixmesh_mesh_oplog_lag_seconds") and k.endswith("_count")]
            assert sum(lag) > 0
            sent = [v for k, v in snap.items() if k.startswith("radixmesh_mesh_oplogs_sent")]
            assert sum(sent) > 0
            assert prefill_node.metrics["oplogs_sent"] > 0
            assert [k for k in snap if k.startswith("radixmesh_mesh_oplogs_received_total") and "INSERT" in k]
        finally:
            for n in nodes:
                n.close()
            InprocHub.reset_default()


class TestAgainstJaxRegistry:
    def test_same_observations_same_exposition(self):
        """The port's copy renders exactly the JAX registry's text for the
        same sequence of registrations and observations (escaping, bucket
        order, integer and float values)."""
        from radixmesh_tpu.obs import metrics as jm
        from radixmesh_tpu_torch.obs import metrics as tm

        texts = []
        for mod in (jm, tm):
            reg = mod.Registry()
            c = reg.counter("req_total", "requests", ("code", "who"))
            c.labels(code="200", who='a "quoted"\\name').inc(3)
            c.labels(code="500", who="b").inc(0.5)
            reg.gauge("temp_celsius", "temperature").set(-1.25)
            h = reg.histogram("lat_seconds", "latency", ("op",), buckets=mod.DEFAULT_BUCKETS)
            for v in (0.0005, 0.003, 0.2, 7.0, 120.0):
                h.labels(op="read").observe(v)
            h.labels(op="write").observe(0.01)
            t = reg.histogram("hit_tokens", "hit lengths", buckets=mod.TOKEN_LEN_BUCKETS)
            for v in (0, 3, 17, 4096, 1 << 20):
                t.observe(v)
            texts.append(reg.render())
        assert texts[0] == texts[1]
        assert tm.TOKEN_LEN_BUCKETS == jm.TOKEN_LEN_BUCKETS
        assert tm.TRANSFER_SECONDS_BUCKETS == jm.TRANSFER_SECONDS_BUCKETS
        assert tm.DEFAULT_BUCKETS == jm.DEFAULT_BUCKETS

    def test_port_registry_is_separate(self, fresh_registry):
        from radixmesh_tpu.obs import metrics as jm

        fresh_registry.counter("only_in_the_port_total").inc()
        assert "only_in_the_port_total" not in jm.get_registry().render()


class TestExpositionStrictParse:
    """Strict parse of ``Registry.render()``: a Prometheus scrape is
    all-or-nothing — ONE malformed line poisons every series in the
    exposition — so the format contract is pinned here line by line
    (escaping round-trip, ``le`` ordering, cumulative monotonicity,
    ``_sum``/``_count`` consistency)."""

    import re as _re

    _SAMPLE = _re.compile(
        r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(?:\{(?P<labels>.*)\})?"
        r" (?P<value>[^ ]+)$"
    )

    @staticmethod
    def _parse_labels(raw: str) -> dict:
        """Char-by-char label parser honoring the exposition escapes
        (\\\\, \\", \\n) — a regex split would tear on escaped quotes."""
        labels: dict[str, str] = {}
        i = 0
        while i < len(raw):
            eq = raw.index("=", i)
            key = raw[i:eq]
            assert raw[eq + 1] == '"', raw
            j = eq + 2
            val: list[str] = []
            while raw[j] != '"':
                if raw[j] == "\\":
                    val.append({"\\": "\\", '"': '"', "n": "\n"}[raw[j + 1]])
                    j += 2
                else:
                    val.append(raw[j])
                    j += 1
            labels[key] = "".join(val)
            i = j + 1
            if i < len(raw):
                assert raw[i] == ",", raw
                i += 1
        return labels

    def _parse(self, text: str) -> list[tuple[str, dict, float]]:
        """Every non-comment line must match the sample grammar."""
        samples = []
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("#"):
                assert line.startswith(("# HELP ", "# TYPE ")), line
                continue
            m = self._SAMPLE.match(line)
            assert m is not None, f"unparseable sample line: {line!r}"
            labels = self._parse_labels(m.group("labels") or "")
            raw_v = m.group("value")
            value = float("inf") if raw_v == "+Inf" else float(raw_v)
            samples.append((m.group("name"), labels, value))
        return samples

    def test_label_escaping_round_trips(self, fresh_registry):
        reg = fresh_registry
        nasty = 'he said "hi\\there"\nand left'
        reg.counter("x_total", "t", ("who",)).labels(who=nasty).inc(3)
        samples = self._parse(reg.render())
        assert samples == [("x_total", {"who": nasty}, 3.0)]

    def test_histogram_le_ordering_and_monotonicity(self, fresh_registry):
        reg = fresh_registry
        h = reg.histogram(
            "lat_seconds", "t", ("op",), buckets=(0.1, 1.0, 10.0)
        )
        for op, values in (
            ("read", (0.05, 0.5, 0.5, 5.0, 50.0)),
            ("write", (0.01, 20.0)),
        ):
            child = h.labels(op=op)
            for v in values:
                child.observe(v)
        samples = self._parse(reg.render())
        by_series: dict[str, list[tuple[float, float]]] = {}
        for name, labels, value in samples:
            if name != "lat_seconds_bucket":
                continue
            le = labels.pop("le")
            key = repr(sorted(labels.items()))
            by_series.setdefault(key, []).append(
                (float("inf") if le == "+Inf" else float(le), value)
            )
        assert len(by_series) == 2
        for series in by_series.values():
            les = [le for le, _ in series]
            counts = [c for _, c in series]
            # le values rendered in ascending order, +Inf last...
            assert les == sorted(les) and les[-1] == float("inf")
            # ...and cumulative counts never decrease along them.
            assert counts == sorted(counts)

    def test_sum_count_consistency(self, fresh_registry):
        reg = fresh_registry
        h = reg.histogram("lat_seconds", "t", buckets=(1.0, 2.0))
        values = (0.5, 1.5, 7.0)
        for v in values:
            h.observe(v)
        samples = {
            (name, tuple(sorted(labels.items()))): value
            for name, labels, value in self._parse(reg.render())
        }
        count = samples[("lat_seconds_count", ())]
        total = samples[("lat_seconds_sum", ())]
        inf_bucket = samples[("lat_seconds_bucket", (("le", "+Inf"),))]
        assert count == len(values)
        assert count == inf_bucket  # +Inf bucket IS the count
        assert total == pytest.approx(sum(values))

    def test_every_kind_renders_parseable(self, fresh_registry):
        reg = fresh_registry
        reg.counter("a_total", "help text", ("x",)).labels(x="1").inc()
        reg.gauge("b_bytes", "gauge").set(-2.5)
        reg.histogram("c_seconds", "hist").observe(0.3)
        samples = self._parse(reg.render())  # asserts per line
        names = {name for name, _, _ in samples}
        assert {
            "a_total", "b_bytes", "c_seconds_bucket",
            "c_seconds_sum", "c_seconds_count",
        } <= names
