"""Disaggregated prefill→decode in the port (``radixmesh_tpu_torch/
engine/disagg.py``): twins of ``tests/test_disagg.py`` on the CPU (tiny
float32 model, page 4; the ICI cases wait for the port's parallelism),
each run through both packages on the same weights and prompts, the port's
greedy tokens equal to the JAX package's; and the cross-package wire test:
the same packet packed by either package is the same bytes (float32, bf16,
int8 with scales, whole and chunked), each package unpacks the other's
bytes to equal fields, and a handoff crosses the packages both ways."""

import threading
import time
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.comm.inproc import InprocCommunicator, InprocHub
from radixmesh_tpu_torch.engine import (
    DecodeWorker,
    Engine,
    PrefillWorker,
    SamplingParams,
    pack_handoff,
    unpack_handoff,
)
from radixmesh_tpu_torch.engine.disagg import HandoffPacket
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4


@pytest.fixture(scope="module")
def sides():
    """The port and the JAX package, each with the same tiny float32
    weights, behind one interface: ``prefill(**kw)``, ``decode(**kw)``,
    ``sampling(**kw)``, ``collocated(prompts, n_new, **kw)``, ``pack``,
    ``unpack`` and ``plane(name)``."""
    from radixmesh_tpu.cache.kv_transfer import KVTransferPlane as JPlane
    from radixmesh_tpu.engine import disagg as jd
    from radixmesh_tpu.engine.engine import Engine as JEngine
    from radixmesh_tpu.engine.request import SamplingParams as JSampling
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")

    def make(name, cfg, params, prefill_cls, decode_cls, engine_cls, sampling_cls, pack, unpack,
             plane_cls, extra):
        def engine_kw(kw, max_batch):
            kw = dict(num_slots=512, page_size=PAGE, max_batch=max_batch, max_seq_len=128) | kw
            return kw | extra

        def decode(comm=None, stage_layers=0, **kw):
            return decode_cls(engine_cls(cfg, params, **engine_kw(kw, 4)), comm=comm,
                              stage_layers=stage_layers)

        def collocated(prompts, n_new, **kw):
            return engine_cls(cfg, params, **engine_kw(kw, 4)).generate(
                prompts, sampling_cls(max_new_tokens=n_new))

        return types.SimpleNamespace(
            name=name, cfg=cfg,
            prefill=lambda **kw: prefill_cls(cfg, params, **engine_kw(kw, 2)),
            decode=decode, sampling=sampling_cls, collocated=collocated, pack=pack, unpack=unpack,
            plane=lambda name: plane_cls(name=name),
        )

    port = make("port", cfg, params, PrefillWorker, DecodeWorker, Engine, SamplingParams, pack_handoff,
                unpack_handoff, KVTransferPlane, {"device": "cpu"})
    jax_side = make("jax", jcfg, jparams, jd.PrefillWorker, jd.DecodeWorker, JEngine, JSampling,
                    jd.pack_handoff, jd.unpack_handoff, JPlane, {})
    return port, jax_side


def both(sides, scenario):
    """``scenario(side)`` on the port and on the JAX package; returns
    ``(port result, jax result)``."""
    return scenario(sides[0]), scenario(sides[1])


def _bits(kv) -> np.ndarray:
    """A packet payload's bit patterns as numpy (bf16 as int16)."""
    if isinstance(kv, torch.Tensor):
        return (kv.view(torch.int16) if kv.dtype == torch.bfloat16 else kv).numpy()
    a = np.asarray(kv)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


class TestHandoff:
    def test_disagg_matches_collocated(self, sides):
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, 64, size=n).tolist() for n in (9, 17, 5)]

        def run(s):
            pw, dw = s.prefill(), s.decode()
            reqs = [dw.submit(pw.prefill_handoff(p, s.sampling(max_new_tokens=8))) for p in prompts]
            dw.run_until_drained()
            return [r.generated for r in reqs], s.collocated(prompts, 8)

        (got, want), (jgot, jwant) = both(sides, run)
        assert got == want == jgot == jwant

    def test_wire_roundtrip(self, sides):
        def run(s):
            pkt = s.prefill().prefill_handoff([1, 2, 3, 4, 5, 6, 7], s.sampling(max_new_tokens=4))
            pkt2 = s.unpack(s.pack(pkt))
            assert np.array_equal(pkt.prompt, pkt2.prompt)
            assert pkt.first_token == pkt2.first_token
            assert pkt.sampling == pkt2.sampling
            np.testing.assert_array_equal(_bits(pkt2.kv), _bits(pkt.kv))
            return pkt.first_token, _bits(pkt.kv)

        (tok, kv), (jtok, jkv) = both(sides, run)
        assert tok == jtok
        np.testing.assert_allclose(kv, jkv, rtol=1e-5, atol=1e-5)

    def test_handoff_over_communicator(self, sides):
        port = sides[0]
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        InprocHub.reset_default()
        try:
            rx = InprocCommunicator("decode:0", None)
            tx = InprocCommunicator(None, "decode:0")
            dw = port.decode(comm=rx)
            pkt = port.prefill().prefill_handoff(prompt, SamplingParams(max_new_tokens=6))
            tx.send(pack_handoff(pkt))
            deadline = time.monotonic() + 10
            while not dw.has_work() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert dw.has_work(), "packet never arrived"
            req = dw._pending[0][0]
            dw.run_until_drained()
            assert dw.engine.stats.finished == 1
        finally:
            InprocHub.reset_default()
        assert req.generated == sides[1].collocated([prompt], 6)[0]

    def test_decode_side_prefix_reuse(self, sides):
        """A second handoff sharing a long prefix reuses the decode node's
        cached pages instead of rewriting the shipped KV."""
        base = list(range(1, 25))

        def run(s):
            pw, dw = s.prefill(), s.decode()
            r1 = dw.submit(pw.prefill_handoff(base + [30], s.sampling(max_new_tokens=3)))
            dw.run_until_drained()
            r2 = dw.submit(pw.prefill_handoff(base + [31], s.sampling(max_new_tokens=3)))
            dw.run_until_drained()
            assert dw.engine.stats.cached_tokens >= 24 // PAGE * PAGE
            return [r1.generated, r2.generated], dw.engine.stats.cached_tokens

        (got, cached), (jgot, jcached) = both(sides, run)
        assert got == jgot == sides[1].collocated([base + [30], base + [31]], 3)
        assert cached == jcached

    def test_tail_only_handoff(self, sides):
        """skip_prefix ships only the uncached tail's KV; generation is
        unchanged and the packet is smaller."""
        base = list(range(1, 25))

        def run(s):
            pw, dw = s.prefill(), s.decode()
            dw.submit(pw.prefill_handoff(base + [30], s.sampling(max_new_tokens=3)))
            dw.run_until_drained()
            skip = dw.cached_prefix_len(base + [31])
            assert skip >= 24 // PAGE * PAGE
            full = pw.prefill_handoff(base + [31], s.sampling(max_new_tokens=3))
            pkt = pw.prefill_handoff(base + [31], s.sampling(max_new_tokens=3), skip_prefix=skip)
            assert pkt.kv.shape[2] == len(base) + 1 - skip
            assert len(s.pack(pkt)) < len(s.pack(full))
            r = dw.submit(pkt)
            dw.run_until_drained()
            assert dw.dropped == 0
            return r.generated, skip

        (got, skip), (jgot, jskip) = both(sides, run)
        assert got == jgot == sides[1].collocated([base + [31]], 3)[0]
        assert skip == jskip

    def test_tail_only_handoff_dropped_when_prefix_gone(self, sides):
        """A tail-only packet whose advertised prefix is not cached is
        dropped loudly, not decoded from garbage."""

        def run(s):
            pw, dw = s.prefill(), s.decode()
            pkt = pw.prefill_handoff(list(range(1, 20)), s.sampling(max_new_tokens=3), skip_prefix=8)
            r = dw.submit(pkt)  # the decode cache is empty
            dw.run_until_drained()
            assert r.state.value == "finished"
            assert dw.engine.stats.finished == 0  # dropped, not completed
            return dw.dropped, pkt.first_token, dw.engine.pool.free_slots

        port, jax_side = both(sides, run)
        assert port == jax_side and port[0] == 1

    def test_prefill_side_prefix_reuse(self, sides):
        """The prefill worker's own radix cache serves shared prompts."""
        base = list(range(40, 70))

        def run(s):
            pw = s.prefill()
            a = pw.prefill_handoff(base + [1], s.sampling(max_new_tokens=1))
            b = pw.prefill_handoff(base + [2], s.sampling(max_new_tokens=1))
            assert pw.stats.cached_tokens >= len(base) // PAGE * PAGE
            return pw.stats.cached_tokens, a.first_token, b.first_token

        port, jax_side = both(sides, run)
        assert port == jax_side


class TestQuantizedHandoff:
    """Int8 pools ship their stored representation (int8 + scales) and an
    int8 receiver stores it verbatim."""

    def test_quant_to_quant_matches_collocated_quant(self, sides):
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, 64, size=n).tolist() for n in (9, 14)]

        def run(s):
            pw, dw = s.prefill(kv_quant="int8"), s.decode(kv_quant="int8")
            reqs = [dw.submit(pw.prefill_handoff(p, s.sampling(max_new_tokens=8))) for p in prompts]
            dw.run_until_drained()
            return [r.generated for r in reqs], s.collocated(prompts, 8, kv_quant="int8")

        (got, want), (jgot, jwant) = both(sides, run)
        assert got == want == jgot == jwant

    def test_quant_wire_roundtrip_preserves_ints_and_scales(self, sides):
        port = sides[0]
        pkt = port.prefill(kv_quant="int8").prefill_handoff([1, 2, 3, 4, 5, 6, 7],
                                                            SamplingParams(max_new_tokens=4))
        assert pkt.kv.dtype == torch.int8 and pkt.kv_scale is not None
        pkt2 = unpack_handoff(pack_handoff(pkt))
        assert torch.equal(pkt.kv, pkt2.kv) and torch.equal(pkt.kv_scale, pkt2.kv_scale)
        # int8 + f32 scales: at most (1 + 4/D)/4 of the f32 payload.
        assert pkt.kv_scale.numel() * 4 * 4 <= pkt.kv.numel()
        jpkt = sides[1].prefill(kv_quant="int8").prefill_handoff([1, 2, 3, 4, 5, 6, 7],
                                                                 sides[1].sampling(max_new_tokens=4))
        np.testing.assert_array_equal(pkt.kv.numpy(), np.asarray(jpkt.kv))
        np.testing.assert_allclose(pkt.kv_scale.numpy(), np.asarray(jpkt.kv_scale), rtol=1e-6)

    @pytest.mark.parametrize("sender,receiver", [("int8", None), (None, "int8")],
                             ids=["quant sender fp receiver", "fp sender quant receiver"])
    def test_mixed_pools(self, sides, sender, receiver):
        """A full-precision receiver dequantizes shipped ints; an int8
        receiver quantizes shipped floats on store."""
        prompt = [3, 1, 4, 1, 5, 9, 2, 6] if sender else [2, 7, 1, 8, 2, 8]

        def run(s):
            dw = s.decode(kv_quant=receiver)
            req = dw.submit(s.prefill(kv_quant=sender).prefill_handoff(prompt, s.sampling(max_new_tokens=6)))
            dw.run_until_drained()
            assert len(req.generated) == 6
            return req.generated

        got, jgot = both(sides, run)
        assert got == jgot


class TestTopKHandoff:
    def test_top_k_survives_the_wire(self, sides):
        pw = sides[0].prefill()
        pkt = pw.prefill_handoff([1, 2, 3, 4, 5],
                                 SamplingParams(temperature=1.3, top_k=1, max_new_tokens=4))
        assert unpack_handoff(pack_handoff(pkt)).sampling.top_k == 1
        # The JAX package reads the same field.
        assert sides[1].unpack(pack_handoff(pkt)).sampling.top_k == 1

    def test_disagg_top_k_one_matches_greedy(self, sides):
        """k = 1 at a high temperature stays greedy across the handoff."""
        prompt = [7, 7, 2, 9, 1]

        def run(s):
            pw, dw = s.prefill(), s.decode()
            req = dw.submit(pw.prefill_handoff(
                prompt, s.sampling(temperature=1.3, top_k=1, max_new_tokens=6)))
            dw.run_until_drained()
            return req.generated

        got, jgot = both(sides, run)
        assert got == jgot == sides[1].collocated([prompt], 6)[0]


class TestSpecOnDecodeWorker:
    def test_decode_worker_with_spec_matches_plain(self, sides):
        """Speculative decode on the decode worker: the greedy output of a
        spec-off decode worker, with speculation engaged."""
        prompt = [5, 1, 5, 1, 5, 1, 5, 1]

        def run(s):
            plain = s.decode()
            want = plain.submit(s.prefill().prefill_handoff(prompt, s.sampling(max_new_tokens=10)))
            plain.run_until_drained()
            spec = s.decode(spec_decode_tokens=3)
            got = spec.submit(s.prefill().prefill_handoff(prompt, s.sampling(max_new_tokens=10)))
            spec.run_until_drained()
            assert got.generated == want.generated
            assert spec.engine.stats.spec_proposed > 0
            return got.generated

        got, jgot = both(sides, run)
        assert got == jgot


class TestStagedStreamedHandoff:
    """Layer-block staging and the chunk-streamed wire path generate what
    the whole packet does."""

    def test_layer_staged_packet_matches_monolithic(self, sides):
        prompt = list(range(1, 60))

        def run(s):
            sp = s.sampling(max_new_tokens=6)
            pkt = s.unpack(s.pack(s.prefill().prefill_handoff(prompt, sp)))
            ref = s.decode()
            r0 = ref.submit(pkt)
            ref.run_until_drained()
            staged = s.decode(stage_layers=1)
            r1 = staged.submit(pkt)
            staged.run_until_drained()
            assert r1.generated == r0.generated
            return r1.generated

        got, jgot = both(sides, run)
        assert got == jgot

    @pytest.mark.parametrize("order", ["in order", "reversed"])
    def test_streamed_chunks_match_monolithic(self, sides, order):
        """Chunks reassemble by ``chunk_seq``, in whatever order they land."""
        prompt = list(range(1, 70))

        def run(s):
            pw = s.prefill()
            sp = s.sampling(max_new_tokens=6)
            ref = s.decode()
            r0 = ref.submit(pw.prefill_handoff(prompt, sp))
            ref.run_until_drained()
            wire: list[bytes] = []
            n = pw.prefill_handoff_stream(prompt, sp, send=wire.append, chunk_tokens=16)
            assert n == len(wire) > 1
            dw = s.decode()
            for frame in (wire if order == "in order" else reversed(wire)):
                dw._on_packet(frame)
            req = dw._pending[0][0]
            dw.run_until_drained()
            assert req.generated == r0.generated
            return req.generated, wire

        (got, wire), (jgot, jwire) = both(sides, run)
        assert got == jgot
        assert [unpack_handoff(f).kv_start for f in wire] == [sides[1].unpack(f).kv_start for f in jwire]

    def test_streamed_through_plane_pipeline(self, sides):
        """send runs on the plane's worker (pipelined with later gathers);
        the chunks equal the inline loop's and, to float tolerance, the JAX
        package's."""
        port = sides[0]
        pw = port.prefill()
        prompt = list(range(1, 50))
        sp = SamplingParams(max_new_tokens=4)
        inline: list[bytes] = []
        pw.prefill_handoff_stream(prompt, sp, send=inline.append, chunk_tokens=16)
        plane = port.plane("handoff-test")
        try:
            piped: list[bytes] = []
            done = threading.Event()
            pw.prefill_handoff_stream(prompt, sp, send=piped.append, chunk_tokens=16, plane=plane)
            plane.submit_task(done.set)  # FIFO: fires after every send
            assert done.wait(10)
            assert plane.stats()["lane_bytes"]["handoff"] > 0
        finally:
            plane.close()
        jwire: list[bytes] = []
        sides[1].prefill().prefill_handoff_stream(prompt, sides[1].sampling(max_new_tokens=4),
                                                  send=jwire.append, chunk_tokens=16)
        assert len(piped) == len(inline) == len(jwire)
        # The second serve hits the page-aligned prefix and recomputes the
        # tail through another launch shape: float tolerance, as in JAX.
        for a, b, c in zip(piped, inline, jwire):
            pa, pb, pc = unpack_handoff(a), unpack_handoff(b), sides[1].unpack(c)
            assert (pa.chunk_seq, pa.chunk_of, pa.kv_start) == (pb.chunk_seq, pb.chunk_of, pb.kv_start) \
                == (pc.chunk_seq, pc.chunk_of, pc.kv_start)
            np.testing.assert_allclose(pa.kv.numpy(), pb.kv.numpy(), rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(pb.kv.numpy(), np.asarray(pc.kv), rtol=1e-3, atol=1e-4)

    def test_fully_skipped_stream_still_delivers_request(self, sides):
        """skip_prefix over the whole prompt still ships one empty-KV chunk;
        the receiver resolves it as an over-skipped packet (a loud drop)."""
        prompt = list(range(1, 41))

        def run(s):
            pw, dw = s.prefill(), s.decode()
            wire: list[bytes] = []
            n = pw.prefill_handoff_stream(prompt, s.sampling(max_new_tokens=4), send=wire.append,
                                          chunk_tokens=16, skip_prefix=len(prompt))
            assert n == len(wire) == 1
            dw._on_packet(wire[0])
            req = dw._pending[0][0]
            dw.run_until_drained()
            assert req.state.value == "finished"
            return dw.dropped, wire[0]

        (dropped, frame), (jdropped, jframe) = both(sides, run)
        assert dropped == jdropped == 1
        assert unpack_handoff(frame).first_token == sides[1].unpack(jframe).first_token


# ---------------------------------------------------------------------------
# cross-package wire compatibility
# ---------------------------------------------------------------------------

L_W, N_W, H_W, D_W = 2, 5, 2, 8


def _contents(dtype: str, chunk: bool):
    """One packet's contents as numpy (bf16 as 16-bit patterns)."""
    rng = np.random.default_rng(2 * ("float32", "bfloat16", "int8").index(dtype) + chunk)
    shape = (2, L_W, N_W, H_W, D_W)
    if dtype == "float32":
        kv = rng.standard_normal(shape).astype(np.float32)
    elif dtype == "bfloat16":
        kv = rng.standard_normal(shape).astype(ml_dtypes.bfloat16).view(np.int16)
    else:
        kv = rng.integers(-127, 128, shape).astype(np.int8)
    scale = rng.random(shape[:-1]).astype(np.float32) if dtype == "int8" else None
    return dict(
        prompt=np.arange(3, 3 + 12, dtype=np.int32), first_token=77, kv=kv, kv_scale=scale,
        rid=41, submit_time=1234.5, first_token_time=1236.25, kv_start=4 if chunk else 0,
        traced=chunk, trace_id=(1 << 60) + 3 if chunk else 0,
        chunk_seq=1 if chunk else -1, chunk_of=3 if chunk else 0,
        sampling=dict(temperature=0.7, top_p=0.9, top_k=5, max_new_tokens=9, stop_token_ids=(2, 11)),
    )


def _port_packet(c):
    kv = torch.from_numpy(c["kv"])
    if c["kv"].dtype == np.int16:
        kv = kv.view(torch.bfloat16)
    fields = {k: v for k, v in c.items() if k not in ("kv", "kv_scale", "sampling")}
    return HandoffPacket(kv=kv, kv_scale=None if c["kv_scale"] is None else torch.from_numpy(c["kv_scale"]),
                         sampling=SamplingParams(**c["sampling"]), **fields)


def _jax_packet(c):
    from radixmesh_tpu.engine.disagg import HandoffPacket as JPacket
    from radixmesh_tpu.engine.request import SamplingParams as JSampling

    kv = c["kv"].view(ml_dtypes.bfloat16) if c["kv"].dtype == np.int16 else c["kv"]
    fields = {k: v for k, v in c.items() if k not in ("kv", "sampling")}
    return JPacket(kv=kv, sampling=JSampling(**c["sampling"]), **fields)


def _fields(pkt) -> dict:
    """A packet's fields, payloads as bit patterns, for comparing across
    the packages."""
    sp = pkt.sampling
    return dict(
        prompt=np.asarray(pkt.prompt).tolist(), first_token=pkt.first_token, kv=_bits(pkt.kv).tolist(),
        kv_dtype=_bits(pkt.kv).dtype.name, kv_shape=tuple(pkt.kv.shape),
        kv_scale=None if pkt.kv_scale is None else np.asarray(pkt.kv_scale).tolist(),
        rid=pkt.rid, submit_time=pkt.submit_time, first_token_time=pkt.first_token_time,
        kv_start=pkt.kv_start, traced=pkt.traced, trace_id=pkt.trace_id, chunk_seq=pkt.chunk_seq,
        chunk_of=pkt.chunk_of,
        sampling=(sp.temperature, sp.top_p, sp.top_k, sp.max_new_tokens, tuple(sp.stop_token_ids)),
    )


@pytest.mark.parametrize("chunk", [False, True], ids=["whole", "chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_packets_are_byte_identical_across_packages(dtype, chunk):
    from radixmesh_tpu.engine import disagg as jd

    c = _contents(dtype, chunk)
    port_bytes = pack_handoff(_port_packet(c))
    jax_bytes = jd.pack_handoff(_jax_packet(c))
    assert port_bytes == jax_bytes
    # Each package reads the other's bytes to the same fields.
    want = _fields(_jax_packet(c))
    assert _fields(unpack_handoff(jax_bytes)) == want
    assert _fields(jd.unpack_handoff(port_bytes)) == want
    assert _fields(unpack_handoff(port_bytes)) == _fields(jd.unpack_handoff(jax_bytes))


@pytest.mark.parametrize("prefill_side", ["jax", "port"])
def test_handoff_across_packages(sides, prefill_side):
    """A JAX prefill node's packet decoded by a port decode node, and the
    other way round, over the wire bytes: the JAX collocated tokens."""
    port, jax_side = sides
    src, dst = (jax_side, port) if prefill_side == "jax" else (port, jax_side)
    prompts = [list(range(5, 27)), [9, 8, 7, 6, 5, 4, 3]]
    dw = dst.decode()
    pw = src.prefill()
    for p in prompts:
        dw._on_packet(src.pack(pw.prefill_handoff(p, src.sampling(max_new_tokens=7))))
    pending = [r for r, _, _ in dw._pending]
    dw.run_until_drained()
    assert [r.generated for r in pending] == jax_side.collocated(prompts, 7)
