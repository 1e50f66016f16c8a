"""The decode kernels' split over the context (flash-decoding), the chunk
kernel's query blocks, and the port's device defaults, on the CPU.

- ``decode_splits`` (the host-side choice of splits and span, from shapes
  alone) covers every context token exactly once for page-table widths
  16…4096 tokens, ``B * Hkv`` from 1 to 512 and 114 or 132 SMs, with spans
  of whole 64-token tiles and at least four tiles a split, and never takes
  ``lengths``: the wrappers hold no host-device sync. The SM count is read
  once per device.
- A plain version of the split and the log-sum-exp combine (test-only,
  here) equals ``paged_decode_fused_plain`` / ``paged_attention_pool_plain``
  and, through them, the JAX package's Pallas kernels in interpret mode,
  for S in {1, 2, 7, 32} splits, with empty splits, rows of length 0 and 1,
  and NaN-poisoned pad pages (for int8 pools the NaN sits in the scales).
  Tolerance: float32 atol 1e-5 (summation order).
- The chunk kernel's query blocks give valid blocks for every engine
  bucket C in {16 … 512} and G in {1, 2, 4, 8}: ``chunk_query_block`` for
  the CUDA-core body, ``chunk_tc_query_block`` for the tensor-core body.
- ``init_params``, ``params_from_jax`` and ``PagedKVPool`` default to CUDA:
  each raises where torch has none, unless it is passed ``device="cpu"``.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import (
    paged_attention_pool_kernel as j_pool_kernel,
    paged_decode_fused_kernel as j_decode_kernel,
)
from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.ops import paged_attention as tpa
from radixmesh_tpu_torch.ops.quant import dequantize_kv, quantize_kv

torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5
MASK = tpa._MASK


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


# ---------------------------------------------------------------------------
# the split choice
# ---------------------------------------------------------------------------


class TestDecodeSplits:
    @pytest.mark.parametrize("n_ctx", [16, 32, 48, 64, 128, 256, 512, 1024, 2048, 4096])
    def test_covers_every_context_token_once(self, n_ctx):
        for sms, rows in ((sms, rows) for sms in (114, 132) for rows in range(1, 513)):
            splits, span = tpa.decode_splits(n_ctx, rows, sms)
            assert splits >= 1 and span > 0 and span % 64 == 0
            # Split s attends [s*span, (s+1)*span): together they cover
            # [0, n_ctx) once, and no split starts past the context.
            covered = np.zeros(splits * span, np.int32)
            for s in range(splits):
                covered[s * span : (s + 1) * span] += 1
            assert (covered[:n_ctx] == 1).all()
            assert (splits - 1) * span < n_ctx
            assert splits <= max(1, -(-n_ctx // 64) // 4)  # at least four tiles a split

    def test_small_batches_split_and_a_full_card_does_not(self):
        assert tpa.decode_splits(4096, 8, 132) == (16, 256)  # B=1, Hkv 8: 4 tiles a split
        assert tpa.decode_splits(4096, 64, 132) == (8, 512)  # B=8, Hkv 8
        assert tpa.decode_splits(1024, 32, 132) == (4, 256)  # 4 x 600 on its 64-page bucket
        assert tpa.decode_splits(2048, 64, 132) == (8, 256)  # 8 x 2000 on its 128-page bucket
        assert tpa.decode_splits(64, 8, 132) == (1, 64)  # one tile: one split
        for rows in (528, 2112, 4096, 8192):
            assert tpa.decode_splits(4096, rows, 132) == (1, 4096)
        # A card with fewer SMs fills with fewer splits.
        assert tpa.decode_splits(4096, 64, 66) == (5, 832)
        assert tpa.decode_splits(4096, 1056, 66) == (1, 4096)

    def test_sm_count_is_read_once_per_device(self, monkeypatch):
        reads = []

        class Props:
            multi_processor_count = 114

        def props(device):
            reads.append(device)
            return Props()

        monkeypatch.setattr(torch.cuda, "get_device_properties", props)
        monkeypatch.setattr(tpa, "_SM_COUNTS", {})
        dev = torch.device("cuda", 0)
        assert tpa.sm_count(dev) == tpa.sm_count(dev) == 114
        assert reads == [dev]

    def test_never_needs_lengths_or_a_sync(self):
        """The choice takes shapes only, and the decode wrappers read no
        tensor back to the host."""
        assert list(inspect.signature(tpa.decode_splits).parameters) == ["n_ctx", "rows", "sms"]
        for fn in (tpa.paged_decode_fused_kernel, tpa.paged_attention_pool_kernel,
                   tpa.decode_splits, tpa._split_workspace, tpa._counters, tpa._launch):
            src = inspect.getsource(fn)
            for call in (".item()", ".cpu()", ".tolist()", ".numpy()"):
                assert call not in src, f"{fn.__name__} calls {call}"


# ---------------------------------------------------------------------------
# the split and the combine, plain
# ---------------------------------------------------------------------------


def split_partials(q, kv_pages, page_table, n_tok, layer, kv_scales, splits, span):
    """What the worker launch computes: per split s, the online-softmax
    state of each query head over tokens ``[s*span, (s+1)*span)`` below
    ``n_tok[b]``: ``m``, ``l`` ``[B, Hkv, G, S]`` and unnormalised ``acc``
    ``[B, Hkv, G, S, D]`` (empty splits: ``m = MASK``, ``l = acc = 0``)."""
    B, Hq, D = q.shape
    k = tpa._gather_rows(kv_pages, 0, layer, page_table, kv_scales)  # [B, ctx, Hkv, D]
    v = tpa._gather_rows(kv_pages, 1, layer, page_table, kv_scales)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k)
    pos = torch.arange(k.shape[1])
    m = torch.full((B, Hkv, G, splits), MASK)
    l = torch.zeros(B, Hkv, G, splits)
    acc = torch.zeros(B, Hkv, G, splits, D)
    for sp in range(splits):
        valid = (pos >= sp * span) & (pos < (sp + 1) * span) & (pos[None, :] < n_tok[:, None])
        ok = valid[:, None, None, :]
        sm = torch.where(ok, s, MASK)
        mx = sm.amax(dim=-1)
        p = torch.where(ok, torch.exp(sm - mx[..., None]), 0.0)
        vz = torch.where(valid[:, :, None, None], v, 0.0)
        m[..., sp] = mx
        l[..., sp] = p.sum(dim=-1)
        acc[..., sp, :] = torch.einsum("bhgk,bkhd->bhgd", p, vz)
    return m, l, acc


def combine(m, l, acc, cur=None):
    """What the combine launch computes: the log-sum-exp merge of the
    partials, then (fused) the current token's score and V folded in.
    Returns ``[B, Hkv, G, D]`` with zeros where the denominator is 0."""
    mx = m.amax(dim=-1)
    w = torch.exp(m - mx[..., None])
    den = (w * l).sum(dim=-1)
    out = (w[..., None] * acc).sum(dim=-2)
    if cur is not None:
        s_cur, v_cur = cur  # [B, Hkv, G], [B, Hkv, D]
        m2 = torch.maximum(mx, s_cur)
        corr, p = torch.exp(mx - m2), torch.exp(s_cur - m2)
        out = out * corr[..., None] + p[..., None] * v_cur[:, :, None]
        den = den * corr + p
    return torch.where(den[..., None] > 0, out / den.clamp_min(1e-30)[..., None], 0.0)


def split_decode_fused(q, k_new, v_new, kv_pages, page_table, lengths, layer, kv_scales,
                       splits, span):
    """Attention output of the fused decode by split and combine."""
    B, Hq, D = q.shape
    Hkv = k_new.shape[1]
    n_ctx = page_table.shape[1] * kv_pages.shape[4]
    n_tok = (lengths.long() - 1).clamp(0, n_ctx)
    m, l, acc = split_partials(q, kv_pages, page_table, n_tok, layer, kv_scales, splits, span)
    if kv_scales is not None:  # attention sees the stored row's float32 twin
        k_cur = dequantize_kv(*quantize_kv(k_new))
        v_cur = dequantize_kv(*quantize_kv(v_new))
    else:
        k_cur, v_cur = k_new.float(), v_new.float()
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D) * (1.0 / math.sqrt(D))
    s_cur = torch.einsum("bhgd,bhd->bhg", qg, k_cur)
    out = combine(m, l, acc, (s_cur, v_cur)).reshape(B, Hq, D)
    return torch.where((lengths > 0)[:, None, None], out, 0.0)


def split_pool(q, kv_pages, page_table, lengths, layer, kv_scales, splits, span):
    B, Hq, D = q.shape
    n_ctx = page_table.shape[1] * kv_pages.shape[4]
    n_tok = lengths.long().clamp(0, n_ctx)
    m, l, acc = split_partials(q, kv_pages, page_table, n_tok, layer, kv_scales, splits, span)
    return combine(m, l, acc).reshape(B, Hq, D)


def _case(seed, lengths, kind, Hq=8, Hkv=2, D=32, page=8, maxp=4, L=2):
    """Disjoint permuted pages per row; page-table pads point at a NaN page
    and every slot at or past each row's bound in its last page is NaN
    (K/V for float32 pools, the scales for int8 pools)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * maxp + 1
    nan_page = P - 1
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k_new = (rng.normal(size=(B, Hkv, D)) * 2).astype(np.float32)
    v_new = rng.normal(size=(B, Hkv, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, P, page, D)).astype(np.float32)
    pt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    scales = None
    if kind == "int8":
        q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
        kv, scales = np.asarray(q8), np.array(sc)
    poisoned = scales if kind == "int8" else kv
    for b in range(B):
        # Fused rows own the current token's slot (position length-1).
        n = int(lengths[b])
        used = -(-max(n, 1) // page)
        pt[b, used:] = nan_page
        # Pool rows read n tokens; fused rows n - 1 and fold in the slot of
        # position n - 1 from k_new/v_new.
        if n % page:
            poisoned[:, :, :, pt[b, used - 1], n % page:] = np.nan
    poisoned[:, :, :, nan_page] = np.nan
    pos = np.maximum(lengths - 1, 0)
    slots = (pt[np.arange(B), pos // page] * page + pos % page).astype(np.int32)
    return q, k_new, v_new, kv, scales, slots, pt, lengths


LENGTHS = [0, 1, 11, 32, 9]


class TestPlainSplitCombine:
    @pytest.mark.parametrize("splits", [1, 2, 7, 32])
    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_fused_equals_plain_and_pallas(self, splits, kind):
        q, k_new, v_new, kv, sc, slots, pt, lengths = _case(splits, LENGTHS, kind)
        layer, n_ctx = 1, pt.shape[1] * kv.shape[4]
        span = -(-n_ctx // splits)  # S = 32 over 32 tokens: one token a split
        want_j = j_decode_kernel(
            *(jnp.asarray(a) for a in (q, k_new, v_new, kv, slots, pt, lengths)), layer,
            interpret=True, kv_scales=None if sc is None else jnp.asarray(sc),
        )[0]
        plain = tpa.paged_decode_fused_plain(
            _t(q), _t(k_new), _t(v_new), _t(kv), _t(slots), _t(pt), _t(lengths), layer, _t(sc)
        )
        got = split_decode_fused(_t(q), _t(k_new), _t(v_new), _t(kv), _t(pt), _t(lengths),
                                 layer, _t(sc), splits, span)
        assert torch.isfinite(got).all()
        assert torch.count_nonzero(got[0]) == 0  # length 0 → zeros
        _close(got, plain)
        _close(got, want_j)

    @pytest.mark.parametrize("splits", [1, 2, 7, 32])
    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_pool_equals_plain_and_pallas(self, splits, kind):
        q, _, _, kv, sc, _, pt, lengths = _case(10 + splits, LENGTHS, kind)
        layer, n_ctx = 0, pt.shape[1] * kv.shape[4]
        span = -(-n_ctx // splits)
        want_j = j_pool_kernel(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(pt), jnp.asarray(lengths), layer,
            interpret=True, kv_scales=None if sc is None else jnp.asarray(sc),
        )
        plain = tpa.paged_attention_pool_plain(_t(q), _t(kv), _t(pt), _t(lengths), layer, _t(sc))
        got = split_pool(_t(q), _t(kv), _t(pt), _t(lengths), layer, _t(sc), splits, span)
        assert torch.isfinite(got).all()
        assert torch.count_nonzero(got[0]) == 0
        _close(got, plain)
        _close(got, want_j)

    def test_kernel_choice_at_a_long_table(self):
        """The split the wrappers choose for a 2048-token table (8 rows of
        one kv head: S = 32, span 64), most splits empty for short rows."""
        lengths = [0, 1, 2, 65, 700, 1500, 2047, 2048]
        q, k_new, v_new, kv, sc, slots, pt, ln = _case(
            21, lengths, "float32", Hkv=1, Hq=4, D=16, maxp=256)
        splits, span = tpa.decode_splits(pt.shape[1] * kv.shape[4], len(lengths) * 1, 132)
        assert splits > 1
        plain = tpa.paged_decode_fused_plain(
            _t(q), _t(k_new), _t(v_new), _t(kv), _t(slots), _t(pt), _t(ln), 0)
        got = split_decode_fused(_t(q), _t(k_new), _t(v_new), _t(kv), _t(pt), _t(ln), 0,
                                 None, splits, span)
        _close(got, plain)


# ---------------------------------------------------------------------------
# chunk query blocks
# ---------------------------------------------------------------------------


class TestChunkQueryBlock:
    @pytest.mark.parametrize("G", [1, 2, 4, 8])
    def test_valid_for_every_engine_bucket(self, G):
        rows = tpa.CHUNK_ROWS[torch.float32]  # the CUDA-core body
        for C in (16, 32, 64, 128, 256, 512):
            cblk = tpa.chunk_query_block(C, G, rows)
            assert cblk >= 1 and cblk & (cblk - 1) == 0, (C, cblk)
            assert C % cblk == 0 and cblk * G <= rows
            # the largest such block: doubling breaks a rule
            assert C % (2 * cblk) or 2 * cblk * G > rows
        # The tensor-core body: all C queries while C * G fits its rows,
        # else as many as fit, the last block ragged.
        rows = tpa.CHUNK_ROWS[torch.bfloat16]
        for C in (16, 32, 64, 128, 256, 512):
            cblk = tpa.chunk_tc_query_block(C, G)
            assert cblk == min(C, rows // G)
            assert cblk * G <= rows and (cblk == C or (cblk + 1) * G > rows)
        assert tpa.chunk_query_block(512, 4, tpa.CHUNK_ROWS[torch.float32]) == 32
        assert tpa.chunk_tc_query_block(512, 4) == 32
        assert tpa.chunk_tc_query_block(16, 1) == 16


# ---------------------------------------------------------------------------
# device defaults
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestDeviceDefaults:
    def test_init_params(self, no_cuda):
        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            init_params(cfg, seed=0)
        assert init_params(cfg, seed=0, device="cpu")["embed"].device.type == "cpu"

    def test_params_from_jax(self, no_cuda):
        jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
        tree = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            params_from_jax(tree, cfg)
        assert params_from_jax(tree, cfg, device="cpu")["embed"].device.type == "cpu"

    def test_paged_kv_pool(self, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            PagedKVPool(16, 1, 1, 8, page_size=4)
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            PagedKVPool(16, 1, 1, 8, page_size=4, quant="int8")
        pool = PagedKVPool(16, 1, 1, 8, page_size=4, device="cpu", quant="int8")
        assert pool.kv.device.type == "cpu" and pool.kv_scale.device.type == "cpu"
