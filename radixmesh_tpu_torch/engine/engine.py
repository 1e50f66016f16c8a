"""Continuous-batching serving engine over the radix prefix cache (the JAX
package's ``engine/engine.py``: the legacy schedule and its fast
schedules).

One ``step()`` is one compute wave. The legacy schedule (every schedule
argument at its default) admits queued requests (prefix match in the radix
tree, lock, page allocation with LRU eviction under pressure), prefills
them to completion, then runs one batched decode step for every running
row. Prefill takes one of two routes, as in the JAX engine:

- ``_prefill_dense``: a lone request of at most ``long_prefill_threshold``
  new tokens runs ``Llama.prefill_forward`` (plain attention) against its
  gathered, right-aligned cached prefix (bf16/f32 pools only).
- ``_prefill_group``: concurrent arrivals or long prompts run
  ``Llama.prefill_chunk_paged`` chunk by chunk (the chunk kernel), every
  row with its own positions and kv length; exhausted and padded rows ride
  the scratch slot. Int8 pools (``kv_quant="int8"``) always take this
  route: it attends the quantized K/V it stores, where the dense route
  attends full precision and quantizes only at the write, which would
  break the rule that a prefix is attended as it is stored.

Decode runs ``Llama.decode_step`` (the fused decode kernel) over fixed
``[max_batch]`` rows: inactive rows carry ``length = 1`` and the reserved
scratch slot, and their outputs are ignored. Finished sequences publish
back into the tree (``_publish``), which owns slot lifetime from then on.

The fast schedules, each off by default:

- ``decode_steps_per_launch = k > 1``: multi-step decode
  (``Llama.decode_multi``), k tokens per row per host round trip, k shrunk
  to the binding row's budget and headroom, and no fusing while a waiting
  request could admit.
- ``paged_min_batch``: the paged-vs-dense crossover (``select_paged``).
  Narrower decode waves, and every wave where ``default_use_kernel`` is
  false (the CPU; head dims that are not a multiple of 128), take the
  compact working set (``Llama.decode_multi_compact``), which on the card
  still runs the decode kernel, over the gathered sub-pool.
- ``spec_decode_tokens = γ > 0``: speculative decode. Drafts come from
  the radix tree's published continuation (a replayed request) or from
  the row's n-gram tail; one ``prefill_chunk_paged`` call verifies every
  row's ``[fed token, draft...]`` window (C = γ + 1) and
  ``spec_verify_sample`` accepts per row, exactly. ``spec_adaptive``
  steers γ per request class (``obs/spec_ledger.py``).
- ``prefill_inline_budget > 0``: mixed waves (``engine/waves.py``). While
  decode rows run, admitted prompts park in an inline backlog and ride
  budget-bounded slices of their prefill on the decode launch itself (one
  chunk call, C a power of two ≥ 16), so a long prompt no longer convoys
  running streams; boost waves catch a deep backlog up, at most
  ``prefill_inline_max_defer`` in a row.

The KV tiers, each off by default (``cache/host_cache.py``,
``cache/kv_transfer.py``, ``cache/kv_tier.py``):

- ``host_cache_slots > 0``: a host-RAM tier (pinned behind a CUDA pool).
  Eviction writes device KV back to it, and a later hit restores it
  instead of recomputing the prefix.
- ``kv_transfer_async``: the async KV-movement plane. An admission whose
  match extends into the host or disk tier parks in ``RESTORING`` while the
  plane stages the pages on its copy stream and the engine keeps decoding;
  write-backs leave the engine thread. Restores shorter than
  ``kv_transfer_min_restore_tokens`` stay synchronous.
- ``kv_tier_dir``: a durable disk tier below the host tier (it needs one,
  and arms the plane). Cold host copies spill to checksummed extent files
  past ``kv_tier_watermark``; at construction the directory is scanned and
  every verified prefix is grafted back (cold-cell resurrection).
  ``drain_flush_hot`` and ``drain_flush_disk`` push the working set down
  the tiers before a node leaves.

Seeded replay and resume admission (crash recovery):

- ``SamplingParams(seed=...)``: a seeded row's token is a pure function of
  (seed, absolute position) whenever every row of the launch is seeded.
  The key material is the JAX engine's, bit for bit (``_mix64``); each
  draw is one ``[1, V]`` ``sample_tokens`` call on a ``torch.Generator``
  seeded with it. The generator is not JAX's threefry, and the CPU's
  MT19937 and CUDA's Philox differ, so replay is exact within the port on
  one device type, not against the JAX package or between CPU and card.
  An all-seeded batch takes no speculation, no multi-step fusing and not
  the compact dense leg (each draws from the engine's stream), and its
  mixed waves run as two launches, decode then the inline slice. Mixed
  batches draw from the engine's stream (best-effort, as in JAX).
- Routing: the JAX engine sends a seeded decode step through the chunk
  path at C = 1 because its decode step does not return logits; the
  port's ``decode_step`` does, so a seeded decode keeps the decode kernel.
  Every row's token is drawn on the device and the step copies them to
  the host once, as the unseeded path does.
- ``make_request(resume_tokens=...)``: tokens a prior life delivered ride
  in the prompt (a cache hit where that life published them, from any
  tier) and are never re-emitted; the output budget is conserved across
  lives. ``stream_publish_tokens = N`` publishes prompt + generated tokens
  every N tokens, so a crash loses at most N tokens of that hit.

Observability (``obs/``): the engine registers the JAX engine's series on
the port's registry (``obs/metrics.py``: TTFT, TPOT, prompt, cached and
generated tokens, prefix-hit length, speculation, preemptions, evictions
by cause), records request-flight spans when the recorder samples
(``obs/trace_plane.py``), feeds the token timeline and goodput ledger
(``token_timeline_capacity > 0``, the default; ``obs/token_timeline.py``)
and, with ``step_accounting``, per-wave MFU and padding
(``obs/step_plane.py``). Each is one ``is not None`` branch when off.

W8A16 weights (``weight_quant="int8"``, ``ops/wquant.py``) and the
disaggregated handoff's decode-side admission (``_install_running``, driven
by ``engine/disagg.py``) are the JAX engine's.

Cache mesh (``cache/mesh_cache.py``): pass ``mesh=MeshCache(...)`` and every
publish also advertises its page-aligned prefix around the ring (with the
request's trace id), so the router learns which node holds which prefix.
The engine's tree owns slot lifetime; the mesh replica of a serving node
is advertisement-only (built with ``pool=None``). An eviction that
destroys KV retracts the prefix ring-wide (``_unadvertise``), and
``announce_resurrected`` re-announces a disk tier's grafted prefixes.
``telemetry()`` carries the signals the fleet digest reads.

Multi-device serving (``device_mesh=`` a ``parallel.sharding.ProcessMesh``):
one process per device, every rank running this same engine code with the
same arguments (``generate`` called alike on each), as the JAX engine runs
one scheduler over its device mesh. The params are quantized (W8A16) and
then sharded over tp (``param_logical_axes``), each rank's pool holds its
``n_kv_heads // tp`` heads, and the model gathers the float32 logits over
tp, so every rank samples the same tokens from the same logits and its
host state (tree, allocator, waves) evolves identically. A fresh prompt of
at least ``sp_prefill_threshold`` tokens on a mesh with sp > 1 prefills
sequence-parallel (``_prefill_sp``: ring attention over sp, the K/V
all-gathered over sp into every rank's pool), unless the pool is int8.

Pipeline parallelism (a mesh with pp > 1, ``parallel/pp_serving.py``): each
rank holds one stage, its ``L/pp`` layers (tp-sharded where tp > 1) and a
pool of the same layers, and the scheduler runs unchanged above it, as in
the JAX engine. Every prefill chunk (group prefill, speculative verify,
mixed waves) goes through ``pp_forward_chunk`` (``_forward_chunk``, with
``_pp_n_micro`` microbatches); there is no dense or sequence-parallel
prefill under pp. A multi-step launch runs ``pp_decode_multi`` (only when
``max_batch`` divides by pp), and a plain decode step ``pp_decode_step``:
B1 in each stage, where the JAX engine sends this step through the chunk
path at C = 1. Every rank gets the same logits, so every rank's host state
evolves alike.

The KV tiers and a pool-bound mesh replica on a mesh (tp, pp or both):

- Each rank's host arena holds its shard (its heads, its layers), sized
  from its pool; write-back and restore move only that shard. The
  synchronous host tier needs nothing more: the scheduler decides it alike
  on every rank.
- The async plane, the disk tier, a ``DecodeWorker`` (``engine/disagg.py``)
  and a mesh replica bound to the pool bring inputs that are not the same
  on every rank (a copy event, a worker's spill, a packet, a replica's
  free, a wall-clock cadence). With any of them bound, the ranks agree on
  them once per scheduler pass (``parallel/step_sync.py``: one small
  all-reduce at ``has_work`` or at the top of ``_pump_kv_transfer``,
  whichever comes first): a restore unit or spill counts as done when it
  is done on every rank, the leader (engine index 0) decides the destage
  cadence and takes in hints, packets and the replica's frees, and the
  tree's clock is the leader's. Without them no agreement runs.
- The disk tier writes each rank's extents under ``kv_tier_dir/rank<i>/``
  beside a manifest of the mesh shape and the shard
  (``cache/kv_tier.rank_tier_dir``), each rank with ``1/(pp·sp·tp)`` of
  ``kv_tier_capacity_bytes``; a directory written at another shape is
  refused by name, and at boot only the extents that verify on every rank
  are grafted.
- Only the leader holds the mesh replica (pass ``mesh=`` there alone: the
  ring has one node per engine) and only it advertises. A replica bound to
  the pool (``MeshCache(cfg, pool=pool)`` with ``Engine(pool=pool)`` on
  every rank) sees a :class:`~radixmesh_tpu_torch.parallel.step_sync.
  MeshPoolProxy`: its frees apply on every rank's allocator at the next
  pass.

An external ``pool`` (a :class:`PagedKVPool`) is adopted after the JAX
engine's checks (page size, layers, kv heads, quantization, dtype when not
quantized), its geometry that of this rank's shard (``n_layers // pp``
layers, ``n_kv_heads // tp`` heads); the engine's device defaults to the
pool's.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from dataclasses import replace as dataclass_replace
from typing import Iterable, Sequence

import numpy as np
import torch

from radixmesh_tpu_torch.cache.host_cache import HierarchicalCache, HostKVStore
from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
from radixmesh_tpu_torch.cache.kv_tier import DiskKVTier, rank_tier_dir
from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane
from radixmesh_tpu_torch.cache.radix_tree import RadixTree
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.engine.waves import WaveScheduler
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, param_logical_axes
from radixmesh_tpu_torch.obs.attribution import shape_bucket
from radixmesh_tpu_torch.obs.fleet_plane import eviction_counters
from radixmesh_tpu_torch.obs.metrics import TOKEN_LEN_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.spec_ledger import SpecLedger
from radixmesh_tpu_torch.obs.step_plane import StepAccounting
from radixmesh_tpu_torch.obs.token_timeline import STALL_CAUSES, GoodputLedger, TokenTimeline
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.ops.attention import default_use_kernel, last_dispatch, select_paged
from radixmesh_tpu_torch.ops.sampling import sample_tokens, spec_verify_sample
from radixmesh_tpu_torch.ops.wquant import quantize_params
from radixmesh_tpu_torch.parallel.collectives import all_gather
from radixmesh_tpu_torch.parallel.pp_serving import pp_decode_multi, pp_decode_step, pp_forward_chunk
from radixmesh_tpu_torch.parallel.sharding import shard_params
from radixmesh_tpu_torch.parallel.step_sync import MeshPoolProxy, Source, StepSync
from radixmesh_tpu_torch.utils.device import resolve_device
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["Engine", "EngineStats"]

# Per-process engine sequence: each engine's registry series carry its
# name, so engines in one process keep separate series.
_engine_seq = itertools.count()

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer (the JAX engine's, bit for bit): turns (seed,
    position) into sampling-key material."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _pow2_at_least(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


# Pages per attention KV block of the chunked launches: chunk page tables
# are pow2-padded with this as the floor (the JAX engine's constant).
_KV_BLOCK_PAGES = 32


@dataclass
class _InlineJob:
    """One partially prefilled request of the mixed-wave backlog. Its
    slots and batch row were acquired up front by admission
    (``_acquire_prompt_slots``); only the compute advances chunk by chunk.
    ``pos`` is the exact resume offset: prompt tokens whose K/V is in the
    pool."""

    req: Request
    row: int
    reuse: int
    own: np.ndarray
    token_slots: np.ndarray  # slot per prompt position (prefix + own)
    pos: int  # next prompt offset to prefill (starts at reuse)
    total: int  # len(prompt)


@dataclass
class EngineStats:
    """Hit-rate, throughput and path counters. ``decode_steps`` counts
    decode iterations as the JAX engine does (a k-step launch adds k, a
    verify launch one); ``decode_forwards`` counts the decode passes that
    ran the decode kernel (``decode_step``, and each step of
    ``decode_multi``/``_compact``), each one launch per layer."""

    prompt_tokens: int = 0
    cached_tokens: int = 0  # reused from the radix cache at prefill
    generated_tokens: int = 0
    prefills: int = 0
    decode_steps: int = 0
    finished: int = 0
    preemptions: int = 0
    evicted_tokens: int = 0  # tree tokens evicted under pool pressure
    prefill_chunks: int = 0  # prefill_chunk_paged launches of group prefill
    prefill_chunks_with_prior: int = 0  # ... where some row had pool context
    spec_proposed: int = 0  # draft tokens offered for verification
    spec_accepted: int = 0  # draft tokens accepted (KV kept, step skipped)
    spec_rejected: int = 0  # draft tokens rejected by verification
    decode_forwards: int = 0  # decode passes through the decode kernel
    multi_step_launches: int = 0  # decode_multi calls over the whole pool
    compact_launches: int = 0  # decode_multi_compact calls
    # Fused chunk launches (_decode_spec_once), by what rode them: decode
    # rows only (speculative verify), decode rows and inline prefill
    # (mixed waves), inline prefill only (prefill and boost waves).
    verify_launches: int = 0
    mixed_launches: int = 0
    inline_launches: int = 0
    resurrections: int = 0  # resume-mode admissions (crash recovery)
    replayed_tokens: int = 0  # already-delivered tokens re-prefilled
    replayed_cached_tokens: int = 0  # ... of which the cache served
    ttft_s: list[float] = field(default_factory=list)

    @property
    def hit_rate(self) -> float:
        return self.cached_tokens / self.prompt_tokens if self.prompt_tokens else 0.0

    @property
    def p50_ttft_s(self) -> float:
        return float(np.median(self.ttft_s)) if self.ttft_s else 0.0


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict | Llama,
        *,
        num_slots: int = 4096,
        page_size: int = 16,
        max_batch: int = 8,
        max_seq_len: int | None = None,
        rng_seed: int = 0,
        prefill_chunk: int = 512,
        prefill_wave_tokens: int = 4096,
        long_prefill_threshold: int = 1024,
        decode_steps_per_launch: int = 1,
        prefill_inline_budget: int = 0,
        prefill_inline_max_defer: int = 2,
        paged_min_batch: int = 0,
        spec_decode_tokens: int = 0,
        spec_ngram: int = 3,
        spec_adaptive: bool = False,
        device: str | torch.device | None = None,
        kv_quant: str | None = None,
        host_cache_slots: int = 0,
        pool: PagedKVPool | None = None,
        kv_transfer_async: bool = False,
        kv_transfer_chunk_tokens: int = 512,
        kv_transfer_min_restore_tokens: int = 0,
        kv_tier_dir: str | None = None,
        kv_tier_capacity_bytes: int = 1 << 30,
        kv_tier_watermark: float = 0.7,
        kv_tier_min_heat: float = 0.0,
        kv_tier_destage_budget: int = 16,
        kv_tier_destage_interval_s: float = 0.25,
        name: str | None = None,
        stream_publish_tokens: int = 0,
        token_timeline_capacity: int = 4096,
        token_stall_threshold_s: float = 0.05,
        step_accounting: bool = False,
        peak_tflops: float | None = None,
        weight_quant: str | None = None,
        mesh=None,
        device_mesh=None,
        sp_prefill_threshold: int = 4096,
    ):
        """``params`` is a param tree (``init_params`` / ``params_from_jax``)
        or a built :class:`Llama`. ``device`` defaults to CUDA and raises
        where torch has none; pass ``"cpu"`` for the plain CPU path.
        ``kv_quant="int8"`` stores the KV pool as int8 with per-token
        scales. The schedule and tier arguments take the JAX engine's
        defaults, which run the legacy schedule with one tier (module
        docstring). ``name`` labels the engine's registry series (default
        ``engine<N>``); ``stream_publish_tokens``, the token timeline and
        step accounting are as in the JAX engine. ``weight_quant="int8"``
        serves W8A16 weights (``ops/wquant.py``): a param tree or a
        full-precision ``Llama`` is quantized before the model is built; a
        ``Llama`` that is already W8A16 is taken as it is. ``mesh`` is this
        node's ``MeshCache`` replica (module docstring); its page size
        must divide ``page_size``. ``device_mesh`` is this rank's
        ``ProcessMesh`` (module docstring): a full param tree (or a
        ``Llama`` without a mesh) is quantized, then sharded; a tree of this
        rank's shards (``init_params(..., mesh=)``) or a ``Llama`` built on
        the mesh is taken as it is (its shards, W8A16 or not, are the
        caller's). Fresh prompts of at least ``sp_prefill_threshold``
        tokens prefill sequence-parallel where the mesh has sp > 1; a pp
        axis serves through the pipeline (module docstring). ``pool``: an
        external pool to adopt instead of building one (module docstring);
        ``device`` then defaults to its device."""
        if page_size & (page_size - 1):
            raise ValueError("page_size must be a power of two")
        if kv_tier_dir is not None and host_cache_slots <= 0:
            raise ValueError(
                "kv_tier_dir requires a host tier (host_cache_slots > 0): the disk tier "
                "demotes from and restores through host RAM"
            )
        self.log = get_logger("engine")
        self.name = name or f"engine{next(_engine_seq)}"
        self.device = resolve_device(device if device is not None or pool is None else pool.device)
        self.cfg = cfg
        self.device_mesh = device_mesh
        self._tp = 1
        # Pipeline-parallel serving (parallel/pp_serving.py): a pp axis shards
        # the layer axis of the params and the pool.
        pp = 1 if device_mesh is None else dict(device_mesh.shape).get("pp", 1)
        self._pp = pp > 1
        if device_mesh is not None:
            self._tp = device_mesh.shape["tp"]
            if cfg.n_kv_heads % self._tp or cfg.n_heads % self._tp:
                raise ValueError(
                    f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} must divide tp={self._tp}"
                )
            if cfg.n_layers % pp:
                raise ValueError(f"n_layers={cfg.n_layers} is not divisible by pp={pp}")
        # An engine over several ranks (module docstring): its step agreement,
        # bound once an asynchronous source is.
        self._ranks = 1 if device_mesh is None else device_mesh.engine_size
        self._sync: StepSync | None = None
        self._agreed = None  # this pass's agreement, until the pump applies it
        self._sync_hints: list[np.ndarray] = []
        if mesh is not None and self._ranks > 1 and device_mesh.engine_index != 0:
            raise ValueError(
                f"only the leader rank of an engine over {self._ranks} ranks holds the mesh replica "
                f"(this is rank {device_mesh.engine_index} of the engine): pass mesh=None here"
            )
        self.sp_prefill_threshold = sp_prefill_threshold
        self.mesh = mesh
        mesh_page = getattr(mesh, "page", 1) if mesh is not None else 1
        if mesh_page > 1 and page_size % mesh_page:
            # Publishes are aligned at engine pages, so the mesh page must
            # divide the engine page.
            raise ValueError(f"mesh page_size {mesh_page} must divide engine page_size {page_size}")
        sharded = self._tp > 1 or self._pp
        if isinstance(params, Llama) and sharded and params.mesh is None:
            params = params.param_tree()  # full leaves: quantized and sharded below
        # A tree already holding this rank's shards (init_params(mesh=...),
        # params_from_jax(mesh=...)) is taken as it is.
        presharded = (not isinstance(params, Llama) and sharded
                      and tuple(params["layers"]["wq"].shape)
                      == (cfg.n_layers // pp, cfg.hidden, cfg.n_heads * cfg.head_dim // self._tp))
        if weight_quant is not None:
            if weight_quant != "int8":
                raise ValueError(f"unknown weight quantization {weight_quant!r}")
            is_llama = isinstance(params, Llama)
            if (params.weight_quant is None if is_llama else params["layers"]["wq"].dtype != torch.int8):
                # Before sharding: a row-parallel weight's scale spans its
                # whole contraction axis.
                if presharded or (is_llama and (params._tp or params._pp)):
                    raise ValueError(
                        "W8A16 must quantize before sharding: pass a full param tree, or "
                        "init_params(..., mesh=..., weight_quant='int8')"
                    )
                params = quantize_params(params.param_tree() if is_llama else params)
        if not isinstance(params, Llama) and sharded and not presharded:
            params = shard_params(params, param_logical_axes(cfg, params), device_mesh)
        model = params if isinstance(params, Llama) else Llama(cfg, params, mesh=device_mesh)
        if (model._tp or model._pp) and (device_mesh is None or model.mesh.shape != device_mesh.shape):
            raise ValueError(f"the model is sharded over {model.mesh.shape}; device_mesh is "
                             f"{None if device_mesh is None else device_mesh.shape}")
        self.model = model.to(self.device)
        self.weight_quant = model.weight_quant
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.max_pages = -(-self.max_seq_len // page_size)
        # Prompts with more than ``long_prefill_threshold`` uncached tokens
        # (or concurrent arrivals) prefill in ``prefill_chunk``-token chunks
        # against the paged pool.
        self.prefill_chunk = prefill_chunk
        # Sub-waves are sliced to at most prefill_wave_tokens // chunk rows,
        # so a cold burst finalizes first tokens as slices complete.
        self.prefill_wave_tokens = prefill_wave_tokens
        self.long_prefill_threshold = long_prefill_threshold
        # Multi-step decode: k decode steps per launch, sampled on the
        # device (1 = one step per launch).
        self.decode_steps_per_launch = decode_steps_per_launch
        # Speculative decode: draft up to γ tokens (tree continuation, then
        # n-gram prompt lookup) and verify them in one chunk launch.
        self.spec_decode_tokens = spec_decode_tokens
        self.spec_ngram = max(2, spec_ngram)
        # Mixed waves: > 0 parks prompts admitted while decode rows run in
        # an inline backlog that rides up to this many prefill tokens per
        # wave on the decode launch.
        self.prefill_inline_budget = max(0, prefill_inline_budget)
        self.prefill_inline_max_defer = max(0, prefill_inline_max_defer)
        # Paged-vs-dense crossover: decode waves narrower than this take
        # the compact working set (0 = always paged where the policy
        # allows).
        self.paged_min_batch = max(0, paged_min_batch)
        # The last decode dispatch decision (select_paged), for /stats.
        self._last_dispatch: dict | None = None
        # Under tp each rank's pool holds its kv-head shard of every page
        # (the head-major layout makes it one slab per layer), under pp its
        # stage's layers; the allocator and slot ids are the same on every
        # rank.
        if pool is not None:
            expected = dict(page_size=page_size, num_layers=self.model.n_layers,
                            num_kv_heads=self.model.n_kv_heads, head_dim=cfg.head_dim, quant=kv_quant)
            if kv_quant is None:
                expected["dtype"] = cfg.dtype
            for attr, want in expected.items():
                got = getattr(pool, attr)
                if got != want:
                    raise ValueError(
                        f"external pool {attr}={got!r} incompatible with model/engine {attr}={want!r}"
                    )
            if pool.device != self.device:
                raise ValueError(f"external pool on {pool.device}, engine on {self.device}")
            self.pool = pool
        else:
            self.pool = PagedKVPool(
                num_slots=num_slots,
                num_layers=self.model.n_layers,
                num_kv_heads=self.model.n_kv_heads,
                head_dim=cfg.head_dim,
                page_size=page_size,
                dtype=cfg.dtype,
                device=self.device,
                quant=kv_quant,
            )
        self._kv_tier = None
        if host_cache_slots > 0:
            # Hierarchical cache: evicted prefixes fall back to a host-RAM
            # arena (pinned behind a CUDA pool) and are restored on a hit.
            host_store = HostKVStore(
                num_slots=host_cache_slots,
                num_layers=self.pool.num_layers,
                num_kv_heads=self.pool.num_kv_heads,
                head_dim=cfg.head_dim,
                page_size=page_size,
                dtype=self.pool.dtype,
                quant=self.pool.quant,
                pin_memory=self.device.type == "cuda",
            )
            if kv_tier_dir is not None:
                # One directory per rank of a multi-rank engine, its shard's
                # extents beside a manifest (cache/kv_tier.rank_tier_dir).
                self._kv_tier = DiskKVTier(
                    rank_tier_dir(kv_tier_dir, self._tier_manifest(page_size)),
                    capacity_bytes=kv_tier_capacity_bytes // self._ranks, page_size=page_size,
                    name=self.name,
                )
                # Disk I/O runs only on the plane's worker: a tier without
                # the plane would be write-only, so arm it.
                if not kv_transfer_async:
                    kv_transfer_async = True
                    self.log.info(
                        "kv_tier_dir set: arming the async KV-movement plane (disk restores "
                        "and spills are staged only)"
                    )
            self.tree: RadixTree = HierarchicalCache(self.pool, host_store, disk_tier=self._kv_tier)
        else:
            self.tree = RadixTree(page_size=page_size, on_free=self.pool.free)
        self._kv_tier_watermark = float(kv_tier_watermark)
        self._kv_tier_min_heat = float(kv_tier_min_heat)
        self._kv_tier_destage_budget = int(kv_tier_destage_budget)
        # The destage walk is O(tree nodes) of engine-thread Python, so it
        # runs at most this often (0 = every pump).
        self._kv_tier_destage_interval_s = float(kv_tier_destage_interval_s)
        self._kv_tier_last_destage = 0.0
        # Async KV-movement plane: staged restores (requests park in
        # RESTORING), write-backs off the engine thread, prefetch hints.
        self.kv_transfer = None
        self._kv_min_restore = max(0, kv_transfer_min_restore_tokens)
        self._restoring: list[tuple[Request, object]] = []
        # Set while the node drains: prefetch hints stop opening restores.
        self.draining = False
        if kv_transfer_async:
            self.kv_transfer = KVTransferPlane(chunk_tokens=kv_transfer_chunk_tokens,
                                               name=self.name)
            # The pinned staging ring and the copy stream, allocated now
            # rather than inside the first restore.
            self.kv_transfer.bind(self.pool)
            if isinstance(self.tree, HierarchicalCache):
                self.tree.plane = self.kv_transfer
            if self._ranks > 1:
                self._bind_step_sync()
        self._mesh_proxy = None
        if self._ranks > 1 and pool is not None:
            # An external pool may be the one the leader's mesh replica is
            # bound to; only the leader knows, so the ranks ask it once.
            bound = getattr(mesh, "pool", None) is pool
            if (self._sync or StepSync(device_mesh, self.device)).any_rank(bound):
                self._bind_step_sync()
                proxy = MeshPoolProxy(self.pool)
                if bound:
                    mesh.pool = proxy
                self._sync.add_source("mesh_frees", proxy)
                self._mesh_proxy = proxy
        # Cold-cell resurrection: graft the directory's verified extents
        # back as disk-resident nodes (boot-time file I/O, a cold path),
        # those that verify on every rank of a multi-rank engine.
        self.resurrected = {"extents": 0, "grafted_nodes": 0, "grafted_tokens": 0,
                            "orphaned": 0, "keys": []}
        if self._kv_tier is not None:
            self.resurrected = self.tree.resurrect_from_disk(
                common=None if self._sync is None else self._sync.common)
        # Reserved scratch page: inactive decode rows write/read here.
        scratch = self.pool.alloc(page_size)
        assert scratch is not None
        self._scratch_slot = int(scratch[0])
        self._scratch_page = self._scratch_slot // page_size

        self.waiting: list[Request] = []
        # SLO seam (slo/runner.py): called with the request right after its
        # first token is recorded, the control plane's prefill service-rate
        # feedback. None = no control plane.
        self.on_first_token = None
        # Called as on_first_logits(req, logits_row) for every request
        # whose first token is sampled (a debugging/verification seam).
        self.on_first_logits = None
        # Pressure latch: set on preemption, cleared when a request
        # finishes (or the batch drains); admission pauses meanwhile so
        # surviving rows finish instead of thrashing the pool.
        self._pressure = False
        self._rows: list[Request | None] = [None] * max_batch
        self._tokens = np.zeros(max_batch, dtype=np.int32)
        # One backing buffer, width padded to the KV block; _page_table is
        # the live [:, :max_pages] view every in-place write flows through.
        maxp_b = _pow2_at_least(self.max_pages, floor=_KV_BLOCK_PAGES)
        self._page_table_padded = np.full(
            (max_batch, maxp_b), self._scratch_page, dtype=np.int32
        )
        self._page_table = self._page_table_padded[:, : self.max_pages]
        self._temps = np.zeros(max_batch, dtype=np.float32)
        self._top_ps = np.ones(max_batch, dtype=np.float32)
        self._top_ks = np.zeros(max_batch, dtype=np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # Mid-decode publish cadence (crash recovery): every N generated
        # tokens the request's grown prefix publishes to the tree, so a
        # resumed request's re-prefill is a near-pure hit. 0 = publish only
        # at finish and preemption.
        self.stream_publish_tokens = max(0, stream_publish_tokens)
        self.stats = EngineStats()
        # Decode seconds per token, an EWMA for the fleet digest.
        self._decode_ewma = 0.0
        self._register_series()
        # Token-level speed plane: the per-token ITL ring with stall
        # attribution and the per-tenant goodput ledger (one branch in
        # _consume_token when off).
        self.timeline = None
        self.goodput = None
        if token_timeline_capacity > 0:
            self.timeline = TokenTimeline(
                capacity=token_timeline_capacity,
                stall_threshold_s=token_stall_threshold_s,
                node=self.name,
            )
            self.goodput = GoodputLedger(node=self.name)
        # Stall-attribution hints: the instant the last whole prefill wave
        # and the last inline prefill chunk ran, and a one-shot cause latch
        # external planes set through hint_stall().
        self._last_prefill_t = 0.0
        self._last_inline_prefill_t = 0.0
        self._stall_hint: str | None = None
        # Flight-recorder lane for engine-scope events (evictions).
        self._trace_lane = f"engine:{self.name}"
        # Step attribution (per-wave tokens, padding, MFU estimate), off by
        # default; _wave_padded is the padded token count of the last
        # prefill launch, stamped by whichever prefill path ran.
        self.step_acct = None
        self._wave_padded = 0
        if step_accounting:
            n_params = sum(p.numel() for p in self.model.parameters())
            self.step_acct = StepAccounting(
                self.name, n_params, peak_tflops=peak_tflops, device=self.device
            )
        # Speculative acceptance per prompt-length bucket ([proposed,
        # accepted]) for spec_report(), and the per-class ledger with the
        # adaptive-γ controller (it always exists: its counts must stay
        # conserved whether or not the controller steers).
        self._spec_shape: dict[str, list[int]] = {}
        self.spec_ledger = SpecLedger(adaptive=spec_adaptive, node=self.name)
        # Mixed-wave state: the inline prefill backlog and the batch rows
        # it reserves (kept out of _rows until install, so every decode
        # path over _rows stays oblivious to them).
        self._inline: list[_InlineJob] = []
        self._inline_rows: set[int] = set()
        self.waves = None
        if self.prefill_inline_budget > 0:
            self.waves = WaveScheduler(
                inline_budget=self.prefill_inline_budget,
                max_defer=self.prefill_inline_max_defer,
                chunk=self.prefill_chunk,
                boost_tokens=self.prefill_wave_tokens,
                node=self.name,
            )

    def _tier_manifest(self, page_size: int) -> dict | None:
        """The disk tier's manifest of this rank's shard (None on one rank)."""
        mesh = self.device_mesh
        if self._ranks == 1:
            return None
        cfg, L, H = self.cfg, self.model.n_layers, self.model.n_kv_heads
        return {
            "tp": mesh.size("tp"), "pp": mesh.size("pp"), "sp": mesh.size("sp"),
            "rank": mesh.engine_index, "n_layers": cfg.n_layers, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "page_size": page_size, "dtype": str(self.pool.dtype),
            "quant": self.pool.quant,
            "layers": [mesh.index("pp") * L, (mesh.index("pp") + 1) * L],
            "kv_heads": [mesh.index("tp") * H, (mesh.index("tp") + 1) * H],
        }

    def _bind_step_sync(self) -> StepSync:
        """The step agreement of a multi-rank engine (module docstring),
        built at the first asynchronous source: the tree's clock becomes the
        agreed one, the plane reports to it and its hints arrive through
        it. Every rank binds the same sources in the same order."""
        if self._sync is None:
            sync = self._sync = StepSync(self.device_mesh, self.device)
            self.tree._time = sync.clock
            plane = self.kv_transfer
            if plane is not None:
                plane.strict = True
                sync.add_source("hints", Source(
                    pending=lambda: len(plane._hints), take=plane.take_hints,
                    apply=self._sync_hints.extend))
        return self._sync

    def _agree(self, stop: bool = False) -> tuple[list[int], list[int]]:
        """One pass of the step agreement: the plane scatters what landed
        here and reports it, the leader decides the destage cadence (and
        ``stop``, a drain's deadline), and every source's arrivals apply.
        Supersedes an agreement not yet applied (its counts only grew)."""
        plane = self.kv_transfer
        local = []
        if plane is not None:
            plane.pump(self.tree)
            local = plane.sync_local()
        self._agreed = self._sync.agree(local, [int(self._destage_due()), int(stop)])
        return self._agreed

    def _destage_due(self) -> bool:
        """Whether the write-behind destage runs this pass: at most once per
        ``kv_tier_destage_interval_s`` (the walk is O(tree nodes))."""
        if self._kv_tier is None or self.draining:
            return False
        now = time.monotonic()
        if now - self._kv_tier_last_destage < self._kv_tier_destage_interval_s:
            return False
        self._kv_tier_last_destage = now
        return True

    def _register_series(self) -> None:
        """The JAX engine's registry series, labeled by this engine's name
        (the per-tenant request histograms by tenant)."""
        reg = get_registry()
        lbl = {"engine": self.name}
        self._m_prompt = reg.counter(
            "radixmesh_engine_prompt_tokens_total", "prompt tokens admitted", ("engine",)
        ).labels(**lbl)
        self._m_cached = reg.counter(
            "radixmesh_engine_cached_tokens_total", "prompt tokens served from the radix cache",
            ("engine",),
        ).labels(**lbl)
        self._m_generated = reg.counter(
            "radixmesh_engine_generated_tokens_total", "tokens produced by decode", ("engine",)
        ).labels(**lbl)
        self._m_preempt = reg.counter(
            "radixmesh_engine_preemptions_total", "requests preempted under pool pressure",
            ("engine",),
        ).labels(**lbl)
        self._m_spec_proposed = reg.counter(
            "radixmesh_engine_spec_proposed_tokens_total",
            "draft tokens offered to speculative verification",
            ("engine",),
        ).labels(**lbl)
        self._m_spec_accepted = reg.counter(
            "radixmesh_engine_spec_accepted_tokens_total",
            "draft tokens accepted by speculative verification",
            ("engine",),
        ).labels(**lbl)
        self._m_spec_rejected = reg.counter(
            "radixmesh_engine_spec_rejected_tokens_total",
            "draft tokens rejected by speculative verification "
            "(conservation: proposed == accepted + rejected)",
            ("engine",),
        ).labels(**lbl)
        self._m_ttft = reg.histogram(
            "radixmesh_engine_ttft_seconds", "submit-to-first-token latency", ("engine",)
        ).labels(**lbl)
        self._m_tpot = reg.histogram(
            "radixmesh_engine_tpot_seconds",
            "batched decode step latency (== per-token latency for each active request)",
            ("engine",),
        ).labels(**lbl)
        # Per-tenant request latency, observed with the request's trace id
        # as exemplar.
        self._m_req_ttft = reg.histogram(
            "radixmesh_request_ttft_seconds",
            "submit-to-first-token latency per tenant (fleet-mergeable "
            "buckets; exemplars carry trace ids)",
            ("tenant",),
        )
        self._m_req_e2e = reg.histogram(
            "radixmesh_request_e2e_seconds",
            "submit-to-finish latency per tenant (fleet-mergeable "
            "buckets; exemplars carry trace ids)",
            ("tenant",),
        )
        self._m_hit_len = reg.histogram(
            "radixmesh_engine_prefix_hit_tokens",
            "prefix-cache hit length per admitted request (tokens)",
            ("engine",),
            buckets=TOKEN_LEN_BUCKETS,
        ).labels(**lbl)
        # Evictions by cause: the engine evicts for admission (capacity)
        # and for mid-decode page growth (preempt).
        self._m_evicted = eviction_counters(self.name)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def make_request(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        *,
        tenant: str = "default",
        ttft_deadline_s: float | None = None,
        e2e_deadline_s: float | None = None,
        resume_tokens: Sequence[int] | None = None,
        trace_id: int | None = None,
    ) -> Request:
        """Build + validate a request without queueing it: the admission
        seam the SLO control plane (``slo/``) holds requests behind before
        it enqueues or sheds them. ``tenant`` and the two deadlines
        (seconds from submit) are the control plane's.

        ``resume_tokens`` switches on resume admission: the tokens are
        output a prior life of this request already delivered. They are
        appended to the prompt, so prefill replays them against the radix
        cache and the first sampled token is the continuation at position
        ``len(prompt) + len(resume_tokens)``, but they are never re-emitted:
        ``output_tokens`` starts empty and ``max_new_tokens`` is debited by
        the tokens delivered, so the output budget is the same across
        lives. ``trace_id`` adopts an upstream 64-bit trace id for this
        request's spans."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, dtype=np.int32)
        resume_offset = 0
        if resume_tokens is not None and len(resume_tokens) > 0:
            resume = np.asarray(resume_tokens, dtype=np.int32)
            resume_offset = len(resume)
            if resume_offset >= sampling.max_new_tokens:
                # The delivered tokens cover the whole budget: admitting
                # would sample a token past the requested cap.
                raise ValueError(
                    f"resume_tokens ({resume_offset}) cover the full "
                    f"max_new_tokens budget ({sampling.max_new_tokens}) "
                    "— the stream is already complete"
                )
            prompt = np.concatenate([prompt, resume])
            sampling = dataclass_replace(
                sampling, max_new_tokens=sampling.max_new_tokens - resume_offset
            )
        req = Request(
            prompt=prompt,
            sampling=sampling,
            tenant=tenant,
            ttft_deadline_s=ttft_deadline_s,
            e2e_deadline_s=e2e_deadline_s,
            resume_offset=resume_offset,
        )
        if not (0 < len(req.prompt) < self.max_seq_len):
            raise ValueError(f"prompt length {len(req.prompt)} out of range")
        if int(req.prompt.min()) < 0 or int(req.prompt.max()) >= self.cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.cfg.vocab_size})")
        req.submit_time = time.monotonic()
        # None when tracing is off or the request lost the sampling coin
        # flip: every span site is then one ``is not None`` branch.
        req.trace = get_recorder().trace(f"req:{req.rid}", trace_id=trace_id, node=self.name)
        return req

    def enqueue(self, req: Request) -> Request:
        """Queue a built request (the engine thread, or its runner's lock)."""
        if req.resume_offset:
            self.stats.resurrections += 1
            # The whole resumed prompt is replay: the original prompt and
            # the delivered tokens all re-prefill here.
            self.stats.replayed_tokens += len(req.prompt)
        self.waiting.append(req)
        return req

    def add_request(
        self, prompt: Sequence[int], sampling: SamplingParams | None = None, **kw
    ) -> Request:
        return self.enqueue(self.make_request(prompt, sampling, **kw))

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request. Running requests release
        their batch row; their computed KV publishes as usual. Returns
        False for unknown/finished rids. Not thread-safe against ``step``;
        serialize through the owner (``EngineRunner.cancel``)."""
        for i, req in enumerate(self.waiting):
            if req.rid == rid:
                self.waiting.pop(i)
                req.cancelled = True
                req.state = RequestState.FINISHED
                self.stats.finished += 1
                return True
        for req in self._rows:
            if req is not None and req.rid == rid:
                req.cancelled = True
                req.state = RequestState.FINISHED
                self.stats.finished += 1
                self._release(req)
                self._pressure = False  # freed a row: resume admission
                return True
        for i, (req, ticket) in enumerate(self._restoring):
            if req.rid == rid:
                # Mid-restore: unlink the request; the ticket runs to
                # completion (the landed KV is a valid cache entry) and the
                # pump auto-releases its eviction shields.
                req.cancelled = True
                req.state = RequestState.FINISHED
                self.stats.finished += 1
                ticket.auto_release = True
                self._restoring.pop(i)
                return True
        for i, job in enumerate(self._inline):
            if job.req.rid == rid:
                # Mid-inline prefill: nothing was published, so release the
                # row reservation, the prefix lock and the acquired pages
                # (their partial chunk K/V goes with them).
                self._inline.pop(i)
                self._inline_rows.discard(job.row)
                req = job.req
                if job.own.size:
                    self.pool.free(job.own)
                if req.lock_node is not None:
                    self.tree.dec_lock_ref(req.lock_node)
                    req.lock_node = None
                req.cancelled = True
                req.state = RequestState.FINISHED
                self.stats.finished += 1
                return True
        return False

    def cancel_all(self) -> int:
        """Abort every queued, running, parked and inline-prefilling
        request; returns the count."""
        rids = (
            [r.rid for r in self.waiting]
            + [r.rid for r in self._rows if r is not None]
            + [r.rid for r, _ in self._restoring]
            + [j.req.rid for j in self._inline]
        )
        return sum(1 for rid in rids if self.cancel(rid))

    def close(self) -> None:
        """Stop the KV-transfer plane's worker (its staging buffers go with
        the plane). The engine is not used afterwards."""
        if self.kv_transfer is not None:
            self.kv_transfer.close()

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------

    def drain_requeue_waiting(self) -> int:
        """Cancel and flag for requeue every QUEUED, parked (RESTORING) and
        mid-inline-prefill request: none has produced a token, so bouncing
        it to another node loses no work. RUNNING rows are left to finish.
        Restore tickets flip to auto-release (the cancel path)."""
        victims = list(self.waiting) + [r for r, _ in self._restoring] + [j.req for j in self._inline]
        n = 0
        for req in victims:
            req.shed = True
            req.shed_reason = "drain_requeue"
            if self.cancel(req.rid):
                n += 1
        return n

    def drain_flush_hot(self) -> int:
        """Write every unlocked device-resident prefix back to the host tier
        (the fused write-back lane does the moving), so a warm rejoin finds
        the working set. Returns tokens written back; 0 without a host
        tier. Run after in-flight decodes finish: eviction skips locked
        entries."""
        tree = self.tree
        if not isinstance(tree, HierarchicalCache):
            return 0
        total = 0
        while tree.evictable_size_ > 0:
            freed = tree.evict(tree.evictable_size_)
            if freed <= 0:
                break
            total += freed
        return total

    def drain_flush_disk(self, timeout_s: float = 30.0) -> tuple[int, bool]:
        """Force-destage every host-resident prefix to extents and wait for
        the commits, so the working set survives a whole-cell power loss.
        Returns ``(spills submitted, all committed)``; ``(0, True)`` without
        a disk tier. Run after :meth:`drain_flush_hot`."""
        plane = self.kv_transfer
        if self._kv_tier is None or plane is None:
            return 0, True
        submitted = self.tree.destage_cold(force=True, budget=1 << 30)
        deadline = time.monotonic() + timeout_s
        if self._sync is not None:
            # Every rank commits the same spills in the same pass; the
            # leader's clock decides the deadline.
            while True:
                local, (_, stop) = self._agree(stop=time.monotonic() >= deadline)
                self._agreed = None
                plane.apply_agreed(self.tree, local)
                if plane.spills_idle():
                    return submitted, True
                if stop:
                    return submitted, False
                plane.wait_progress(0.02)
        while time.monotonic() < deadline:
            plane.pump(self.tree)  # spill commits land on this thread
            if plane.spills_idle():
                return submitted, True
            plane.wait_progress(0.02)
        plane.pump(self.tree)
        return submitted, plane.spills_idle()

    def announce_resurrected(self) -> int:
        """Re-announce the disk tier's resurrected prefixes to the mesh:
        each grafted key is inserted as an advertisement (this node serves
        it through a staged disk restore; the placeholder indices are never
        freed into the pool). Call after the mesh transport is up. Returns
        the keys announced."""
        keys = self.resurrected.get("keys") or []
        if self.mesh is None or not keys:
            return 0
        n = 0
        for key in keys:
            key = np.asarray(key, dtype=np.int32)
            if len(key):
                self.mesh.insert(key, np.arange(len(key), dtype=np.int32), advertise=True)
                n += 1
        return n

    def _note_decode_time(self, per_token_s: float) -> None:
        """Every decode-latency sample: the TPOT histogram keeps the
        distribution; the EWMA is the fleet digest's latency signal."""
        self._m_tpot.observe(per_token_s)
        if self._decode_ewma == 0.0:
            self._decode_ewma = per_token_s
        else:
            self._decode_ewma += 0.2 * (per_token_s - self._decode_ewma)

    def telemetry(self) -> dict:
        """Point-in-time engine signals for the fleet digest
        (``obs/fleet_plane.py``), read without locks so that a wedged engine
        can still be described. Parked and inline-prefilling requests count
        as waiting."""
        rows = sum(1 for r in self._rows if r is not None)
        host = getattr(self.tree, "host", None)
        return {
            "batch_occupancy": rows / max(1, self.max_batch),
            "waiting": len(self.waiting) + len(self._restoring) + len(self._inline),
            "decode_steps": self.stats.decode_steps,
            "decode_ewma_s": self._decode_ewma,
            "cache_hit_rate": self.stats.hit_rate,
            "pool_fill": 1.0 - self.pool.fill_free_fraction(),
            "host_fill": 0.0 if host is None else 1.0 - host.free_slots / host.num_slots,
            "evictions": {c: int(m.value) for c, m in self._m_evicted.items()},
            "spec": self.spec_report(),
            "kv_tier": None if self._kv_tier is None else self._kv_tier.stats(),
        }

    def step(self) -> None:
        """One scheduler iteration, one compute wave. Legacy schedule
        (``prefill_inline_budget == 0``): admit and prefill queued requests
        to completion, then one decode launch for everything running.
        Mixed schedule: while decode rows run, admission parks new prompts
        in the inline backlog and each wave packs the decode step and a
        budget-bounded slice of their prefill into one chunk launch (two
        launches, decode then the slice, when every decode row is
        seeded)."""
        with torch.inference_mode():
            self._admit()
            if self._inline:
                self._wave_step()
            elif any(r is not None for r in self._rows):
                self._decode_once()
            elif not self.waiting and (
                self._restoring
                or (self.kv_transfer is not None and self.kv_transfer.has_engine_work())
            ):
                # Nothing to decode or admit: the only live work is an
                # in-flight restore. Yield to the plane's worker instead of
                # spinning against it.
                self.kv_transfer.wait_progress()

    def has_work(self) -> bool:
        """Whether anything is queued, running, parked or in the plane.
        With a step agreement bound it runs a fresh agreement for the pass
        (superseding one a previous call left unapplied), so every rank
        answers alike and sees what arrived since."""
        if self._sync is not None:
            self._agree()
        return (
            bool(self._sync_hints)
            or bool(self.waiting)
            or bool(self._inline)
            or bool(self._restoring)
            or any(r is not None for r in self._rows)
            or (self.kv_transfer is not None and self.kv_transfer.has_engine_work())
        )

    def _wave_step(self) -> None:
        """One wave while the inline backlog is non-empty: the wave
        scheduler decides its composition. Decode-bearing plans fuse the
        inline chunks into the decode launch; prefill and boost plans
        advance the backlog alone (boost waves count against the
        starvation bound). An all-seeded batch keeps its canonical per-row
        decode draw, so its wave runs as two launches: decode, then the
        budgeted inline slice."""
        decode_rows = sum(1 for r in self._rows if r is not None)
        plan = self.waves.plan(decode_rows, [j.total - j.pos for j in self._inline])
        if plan.decode and decode_rows:
            if self._seeded_launch(self._rows):
                self._decode_once()
                self._inline_advance(plan.allot)
            else:
                self._decode_once(inline_allot=plan.allot)
        else:
            self._inline_advance(plan.allot)
        self.waves.note(plan)

    def _inline_advance(self, allot: list[int]) -> None:
        """Advance the inline backlog without a decode step (prefill and
        boost waves, and the second launch of an all-seeded mixed wave):
        the same fused chunk launch, decode off."""
        if any(allot):
            self._decode_spec_once(0, {}, None, inline=allot, decode=False)

    def spec_report(self) -> dict:
        """Speculative acceptance per prompt-length bucket: proposed and
        accepted draft tokens and their ratio. Snapshots the dict before
        iterating (the scheduler thread grows it)."""
        cells = list(self._spec_shape.items())
        return {
            shape: {
                "proposed": int(p),
                "accepted": int(a),
                "acceptance": round(a / p, 4) if p else 0.0,
            }
            for shape, (p, a) in sorted(cells)
        }

    def generate(
        self,
        prompts: Iterable[Sequence[int]],
        sampling: SamplingParams | None = None,
        max_steps: int = 100_000,
    ) -> list[list[int]]:
        reqs = [self.add_request(p, sampling) for p in prompts]
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        unfinished = [r.rid for r in reqs if r.state is not RequestState.FINISHED]
        if unfinished:
            raise RuntimeError(
                f"generate() exhausted max_steps={max_steps} with requests "
                f"{unfinished} unfinished (pool too small for the workload, "
                f"or a scheduling stall)"
            )
        return [r.generated for r in reqs]

    # ------------------------------------------------------------------
    # admission + prefill
    # ------------------------------------------------------------------

    def _free_row(self) -> int:
        for i, r in enumerate(self._rows):
            # A row reserved by an inline prefill job holds a batch seat
            # but no Request until its final chunk installs it.
            if r is None and i not in self._inline_rows:
                return i
        return -1

    def _alloc_pages(self, n_pages: int, cause: str = "capacity") -> np.ndarray | None:
        """Whole-page allocation with evict-under-pressure retry. ``cause``
        labels any eviction it forces: "capacity" (admission) or
        "preempt" (mid-decode page growth)."""
        n = n_pages * self.page_size
        slots = self.pool.alloc(n)
        if slots is None:
            rec = get_recorder()
            t_ev = time.monotonic() if rec.enabled else 0.0
            if self.mesh is not None:
                # An eviction that destroys KV retracts the prefix
                # ring-wide, or the router keeps sending its requests here.
                # A host tier calls the hook only where write-back failed
                # (a written-back prefix stays servable by a restore).
                freed = self.tree.evict(n - self.pool.free_slots, on_evict=self._unadvertise)
            else:
                freed = self.tree.evict(n - self.pool.free_slots)
            self.stats.evicted_tokens += freed
            if freed:
                self._m_evicted[cause].inc(freed)
            slots = self.pool.alloc(n)
            if rec.enabled:
                rec.event(
                    self._trace_lane, "evict", t_ev, time.monotonic() - t_ev, cat="cache",
                    need_slots=int(n), satisfied=bool(slots is not None),
                )
        return slots

    def _unadvertise(self, node) -> None:
        """Evict hook: free the node's pool slots (``on_evict`` replaces the
        tree's ``on_free``) and retract its prefix ring-wide, best effort:
        a replica applies the DELETE only where the key ends on an unlocked
        leaf, so a prefix another node extended survives."""
        self.pool.free(np.asarray(node.value, dtype=np.int32))
        parts = []
        while node is not None and node.parent is not None:
            parts.append(node.key)
            node = node.parent
        if parts:
            self.mesh.delete(np.concatenate(parts[::-1]))

    def _admit(self) -> None:
        """Admit waiting requests into free rows. Concurrent arrivals
        prefill as one batched chunked-paged group + one batched sample; a
        lone short request keeps the dense path. A match that extends into
        the host or disk tier parks the request for a staged restore (with
        the plane) or restores it synchronously."""
        self._pump_kv_transfer()
        if self._pressure and any(r is not None for r in self._rows):
            return
        self._pressure = False  # batch drained: safe to admit again
        made_progress = True
        while self.waiting and made_progress:
            # Mixed waves: while decode rows run, acquired prompts park in
            # the inline backlog instead of prefilling here; with no decode
            # rows the bulk sub-wave path below keeps its full-width TTFT.
            mix = self.waves is not None and any(r is not None for r in self._rows)
            group: list[tuple] = []
            idx = 0
            while idx < len(self.waiting):
                row = self._free_row()
                if row < 0:
                    break
                req = self.waiting[idx]
                tr = req.trace
                t_match = time.monotonic() if tr is not None else 0.0
                if isinstance(self.tree, HierarchicalCache):
                    match = None
                    if self.kv_transfer is not None:
                        match = self.tree.match_prefix(req.prompt)
                        if match.host_nodes or match.disk_nodes:
                            # Disk extensions always park (extent reads are
                            # staged only); host-only ones past the
                            # min-restore threshold.
                            if match.disk_nodes or (
                                match.host_length + match.disk_length >= self._kv_min_restore
                            ):
                                if self._park_for_restore(req, match):
                                    self.waiting.pop(idx)
                                    continue  # parked; don't advance idx
                                # begin_restore may have evicted for room:
                                # the walked match can be stale, re-walk.
                                match = None
                            else:
                                # Small restore, tree untouched since the
                                # walk: the synchronous path reuses it.
                                match = self.tree.match_and_load(req.prompt, match=match)
                    if match is None:
                        match = self.tree.match_and_load(req.prompt)
                else:
                    match = self.tree.match_prefix(req.prompt)
                if tr is not None:
                    tr.add(
                        "prefix_match", t_match, time.monotonic() - t_match,
                        cached_tokens=int(match.length), prompt_tokens=len(req.prompt),
                    )
                if self._defer_for_prefix_wave(req, match.length, group):
                    # A groupmate is about to publish this prefix: next
                    # wave it is a cache hit instead of a recompute.
                    idx += 1
                    continue
                acquired = self._acquire_prompt_slots(req, match)
                if acquired is None:
                    break  # pool exhausted even after evict: wait for finishes
                self.waiting.pop(idx)
                if tr is not None:
                    # Queue wait: from submission or the preemption requeue,
                    # whichever was last, to the instant a row was secured.
                    t_start = max(req.requeue_time, req.submit_time)
                    tr.add("admission_wait", t_start, time.monotonic() - t_start, cat="queue")
                reuse, prefix_slots, own = acquired
                self._rows[row] = req  # reserve the row; re-set on install
                group.append((req, row, reuse, prefix_slots, own))
            for _, row, *_ in group:
                self._rows[row] = None
            made_progress = bool(group)
            if not group:
                break
            if mix:
                for req, row, reuse, prefix_slots, own in group:
                    total = len(req.prompt)
                    self._inline.append(_InlineJob(
                        req=req, row=row, reuse=reuse, own=own,
                        token_slots=np.concatenate([prefix_slots, own[: total - reuse]]),
                        pos=reuse, total=total,
                    ))
                    # The seat is reserved without a Request in it: the
                    # request stays QUEUED until its final chunk installs
                    # it RUNNING.
                    self._inline_rows.add(row)
                continue

            # Sub-waves by prefill-size bucket, shortest first, each sliced
            # at the compute-saturating width and finalized on its own.
            def bucket(member):
                return _pow2_at_least(len(member[0].prompt) - member[2], floor=16)

            group.sort(key=bucket)
            subwaves: list[list[tuple]] = []
            start = 0
            for i in range(1, len(group) + 1):
                if i == len(group) or bucket(group[i]) != bucket(group[start]):
                    sub = group[start:i]
                    start = i
                    per_chunk = min(bucket(sub[0]), self.prefill_chunk)
                    rows = max(1, self.prefill_wave_tokens // per_chunk)
                    subwaves.extend(sub[j : j + rows] for j in range(0, len(sub), rows))
            for sub in subwaves:
                traced = [m[0].trace for m in sub if m[0].trace is not None]
                acct = self.step_acct
                t_wave = time.monotonic() if traced or acct is not None else 0.0
                self._wave_padded = 0
                # A pp engine prefills through the chunk path alone: it is the
                # pipelined one.
                if self.pool.quant is None and not self._pp and len(sub) == 1 and self._sp_capable(sub[0]):
                    pending = [self._prefill_sp(*sub[0])]
                elif (
                    self.pool.quant is None
                    and not self._pp
                    and len(sub) == 1
                    and len(sub[0][0].prompt) - sub[0][2] <= self.long_prefill_threshold
                ):
                    pending = [self._prefill_dense(*sub[0])]
                else:
                    pending = self._prefill_group(sub)
                self._finalize_first_tokens(pending)
                if traced or acct is not None:
                    # The first-token copy synchronized: the wall covers
                    # the sub-wave's device work.
                    dur = time.monotonic() - t_wave
                    new_tok = sum(len(m[0].prompt) - m[2] for m in sub)
                    if acct is not None:
                        acct.note_wave("prefill", new_tok, self._wave_padded, dur, rows=len(sub))
                    for tr in traced:
                        tr.add("prefill_wave", t_wave, dur, cat="prefill", wave_rows=len(sub),
                               wave_new_tokens=int(new_tok))

    # ------------------------------------------------------------------
    # async KV-movement plane seams (cache/kv_transfer.py)
    # ------------------------------------------------------------------

    def _pump_kv_transfer(self) -> None:
        """The plane's engine-thread service point, at the top of every
        admission pass: apply staged restore chunks whose copies have
        landed, convert prefetch hints, run the write-behind destage, and
        re-queue parked requests whose pages are in. With a step agreement
        bound, this pass's agreement decides what landed, the hints and the
        destage cadence."""
        plane = self.kv_transfer
        if self._sync is not None:
            local, (destage, _) = self._agreed or self._agree()
            self._agreed = None
            if plane is None:
                return
            plane.apply_agreed(self.tree, local)
            hints, self._sync_hints[:] = list(self._sync_hints), []
        else:
            if plane is None:
                return
            plane.pump(self.tree)
            hints = plane.take_hints()
            destage = self._destage_due()
        for key in hints:
            self._apply_prefetch_hint(key)
        if destage and not self.draining:
            # Past the arena watermark, cold host prefixes spill to disk on
            # the worker, so later arena pressure demotes instead of
            # dropping them. Submission only, cadence-throttled.
            self.tree.destage_cold(
                watermark=self._kv_tier_watermark,
                min_heat=self._kv_tier_min_heat,
                budget=self._kv_tier_destage_budget,
            )
        if not self._restoring:
            return
        still: list[tuple[Request, object]] = []
        for req, ticket in self._restoring:
            if not ticket.done:
                still.append((req, ticket))
                continue
            plane.finish_ticket(self.tree, ticket)
            req.state = RequestState.QUEUED
            self.waiting.insert(0, req)
            tr = req.trace
            if tr is not None:
                tr.add("kv_restore", ticket.t0, time.monotonic() - ticket.t0, cat="kv",
                       tokens=int(ticket.tokens))
        self._restoring = still

    def _restore_alloc(self, n_tokens: int) -> np.ndarray | None:
        """Pool slots for a staged restore, evicting (plain drop, no
        write-back: ``evict_no_writeback``) under pressure."""
        dev = self.pool.alloc(n_tokens)
        if dev is None:
            freed = self.tree.evict_no_writeback(n_tokens - self.pool.free_slots)
            self.stats.evicted_tokens += freed
            if freed:
                self._m_evicted["capacity"].inc(freed)
            dev = self.pool.alloc(n_tokens)
        return dev

    def _park_for_restore(self, req: Request, match) -> bool:
        """Move ``req`` into RESTORING behind a staged-restore ticket. False
        when nothing could be restored (the caller takes the synchronous
        path, which degrades to a shorter hit)."""
        ticket = self.kv_transfer.begin_restore(self.tree, match, alloc=self._restore_alloc)
        if ticket is None:
            return False
        req.state = RequestState.RESTORING
        self._restoring.append((req, ticket))
        return True

    def _apply_prefetch_hint(self, key: np.ndarray) -> None:
        """Start a no-request restore of a prefix hinted ahead of its
        request. Hints are weaker than admissions: a read-only match (no
        node splits), allocation from the free list only (never evicts),
        joined with any in-flight restore of the same nodes."""
        plane = self.kv_transfer
        if not isinstance(self.tree, HierarchicalCache):
            return
        if self.draining:
            plane.count_hint("draining")
            return
        match = self.tree.match_prefix(key, split_partial=False)
        if not match.host_nodes and not match.disk_nodes:
            plane.count_hint("noop")
            return
        ticket = plane.begin_restore(self.tree, match, alloc=self.pool.alloc, auto_release=True)
        plane.count_hint("started" if ticket is not None else "noop")

    def _defer_for_prefix_wave(
        self, req: Request, cached: int, group: list[tuple]
    ) -> bool:
        """True if ``req`` shares at least one page of not-yet-cached
        prefix (beyond its ``cached`` match) with a request already
        collected this wave or parked in the inline backlog: that one
        publishes it, so waiting turns the recompute into a hit."""
        peers = [g[0] for g in group] + [j.req for j in self._inline]
        if not peers:
            return False
        prompt = req.prompt
        span = cached - cached % self.page_size + self.page_size
        if len(prompt) < span:
            return False
        head = prompt[:span]
        return any(
            len(p.prompt) >= span and np.array_equal(p.prompt[:span], head)
            for p in peers
        )

    def _acquire_prompt_slots(
        self, req: Request, match
    ) -> tuple[int, np.ndarray, np.ndarray] | None:
        """Lock the longest cached prefix of ``req.prompt`` and allocate
        pages for the remainder. Returns ``(reuse, prefix_slots, own)``, or
        None after rollback if the pool can't satisfy it. Reuse is
        page-aligned and leaves at least one token uncached, so prefill
        has logits to sample the first output token from."""
        prompt = req.prompt
        reuse = min(match.length, (len(prompt) - 1) // self.page_size * self.page_size)
        prefix_slots = match.indices()[:reuse]
        self.tree.inc_lock_ref(match.last_node)
        req.lock_node = match.last_node
        own = self._alloc_pages(-(-(len(prompt) - reuse) // self.page_size))
        if own is None:
            self.tree.dec_lock_ref(req.lock_node)
            req.lock_node = None
            return None
        return reuse, prefix_slots, own

    def _install_prefilled(self, req: Request, row: int, reuse: int, inline: bool = False) -> None:
        """Mark RUNNING, record stats, publish the prompt, wire the decode
        row. ``req.kv_len``/``token_slots``/``own_slots`` must be set.
        ``inline``: the final chunk rode a mixed wave."""
        req.prefix_len = reuse
        req.state = RequestState.RUNNING
        req.row = row
        self.stats.prefills += 1
        # Stall attribution: a decode gap spanning this instant is a
        # prefill convoy, or an inline chunk's bounded cost.
        if inline:
            self._last_inline_prefill_t = time.monotonic()
        else:
            self._last_prefill_t = time.monotonic()
        self.stats.prompt_tokens += len(req.prompt)
        self.stats.cached_tokens += reuse
        self._m_prompt.inc(len(req.prompt))
        self._m_cached.inc(reuse)
        self._m_hit_len.observe(reuse)
        if req.resume_offset:
            # The whole resumed prompt is replay; the cache served reuse.
            self.stats.replayed_cached_tokens += reuse
        self._publish(req, len(req.prompt))
        self._rows[row] = req
        self._temps[row] = req.sampling.temperature
        self._top_ps[row] = req.sampling.top_p
        self._top_ks[row] = req.sampling.top_k
        self._page_table[row] = self._scratch_page
        n_pages = -(-req.kv_len // self.page_size)
        self._page_table[row, :n_pages] = req.token_slots[:: self.page_size] // self.page_size

    def _install_running(self, req: Request, row: int, reuse: int) -> None:
        """Admission's tail for a request whose first token is already
        known (the disaggregated handoff, ``engine/disagg.py``): install,
        seed the decode row with that token and record the TTFT."""
        self._install_prefilled(req, row, reuse)
        self._tokens[row] = req.output_tokens[-1]
        self._record_first_token(req)

    @staticmethod
    def _seeded_launch(rows: Iterable[Request | None]) -> bool:
        """True when every row is seeded: the replay contract's scope. A
        mixed batch samples from the engine's stream (best-effort): the
        contract is per launch, never an entanglement across requests."""
        rows = [r for r in rows if r is not None]
        return bool(rows) and all(r.sampling.seed is not None for r in rows)

    @staticmethod
    def _seed_key(req: Request) -> int:
        """The canonical per-row key material, the JAX engine's bit for bit:
        a pure function of (seed, absolute position of the token about to
        be drawn). A resumed request's delivered tokens ride in the prompt,
        so positions line up across lives. The seed is mixed before the
        position, so its top bits matter."""
        return _mix64(_mix64(int(req.sampling.seed) & _M64) ^ req.num_tokens)

    @staticmethod
    def _sample_seeded_row(req: Request, logit_row: torch.Tensor) -> torch.Tensor:
        """The canonical seeded draw: one ``[1, V]`` ``sample_tokens`` call
        on a generator seeded with ``_seed_key``, the same shape at every
        site (first token, each decode step), so a request resumed on
        another engine of the same device type redraws the same
        continuation. Returns the token as a 0-d device tensor (the caller
        copies every row's to the host at once); a greedy row draws
        nothing."""
        sp = req.sampling
        gen = None
        if sp.temperature > 0:
            gen = torch.Generator(device=logit_row.device)
            gen.manual_seed(Engine._seed_key(req))
        return sample_tokens(
            logit_row[None, :], gen,
            temperature=np.float32(sp.temperature), top_p=np.float32(sp.top_p),
            top_k=np.int64(sp.top_k),
        )[0]

    @staticmethod
    def _sample_seeded_rows(pending: list[tuple[Request, torch.Tensor]]) -> np.ndarray:
        """``_sample_seeded_row`` for every ``(request, logit row)``, copied
        to the host in one transfer."""
        return torch.stack([Engine._sample_seeded_row(r, logit) for r, logit in pending]).cpu().numpy()

    def _record_first_token(self, req: Request) -> None:
        ttft = req.first_token_time - req.submit_time
        self.stats.ttft_s.append(ttft)
        self._m_ttft.observe(ttft)
        self._m_req_ttft.labels(tenant=req.tenant).observe(
            ttft, trace_id=getattr(req.trace, "trace_id", None)
        )
        tr = req.trace
        if tr is not None:
            tr.add("first_token", req.first_token_time, 0.0, cat="scheduler",
                   ttft_s=round(ttft, 6))
        if self.on_first_token is not None:
            self.on_first_token(req)

    def _finalize_first_tokens(self, pending: list[tuple]) -> None:
        """One batched sample + one device→host copy for every request of
        the sub-wave; an all-seeded sub-wave draws each row through the
        canonical ``(seed, position)`` path instead (still one copy)."""
        reqs = [r for r, _ in pending]
        if self._seeded_launch(reqs):
            sampled = self._sample_seeded_rows(pending)
        else:
            sampled = sample_tokens(
                torch.stack([logit for _, logit in pending]),
                self._gen,
                temperature=np.asarray([r.sampling.temperature for r in reqs], np.float32),
                top_p=np.asarray([r.sampling.top_p for r in reqs], np.float32),
                top_k=np.asarray([r.sampling.top_k for r in reqs], np.int64),
            ).cpu().numpy()
        now = time.monotonic()
        for (req, logit), tok in zip(pending, sampled):
            if self.on_first_logits is not None:
                self.on_first_logits(req, logit)
            req.first_token_time = now
            req.output_tokens = [int(tok)]
            self._tokens[req.row] = int(tok)
            # The inter-token clock starts here: the first token's latency
            # is TTFT, but it is useful output.
            if self.goodput is not None:
                req.last_token_time = now
                self.goodput.note_token(req.tenant)
            self._record_first_token(req)
            req.note_progress()

    def _prefill_dense(
        self, req: Request, row: int, reuse: int, prefix_slots: np.ndarray, own: np.ndarray
    ) -> tuple:
        """Single-request dense prefill against the gathered right-aligned
        prefix. Returns ``(req, final logit row)``."""
        cfg = self.cfg
        prompt = req.prompt
        n_new = len(prompt) - reuse
        s_b = _pow2_at_least(n_new)
        p_b = _pow2_at_least(reuse, floor=self.page_size) if reuse else 0
        tokens = np.zeros((1, s_b), dtype=np.int64)
        tokens[0, :n_new] = prompt[reuse:]
        positions = (reuse + np.arange(s_b, dtype=np.int64))[None]
        self._wave_padded = s_b  # launch shape (step accounting)
        kv_shape = (cfg.n_layers, 1, p_b, self.model.n_kv_heads, cfg.head_dim)
        cached_k = torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device)
        cached_v = torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device)
        if reuse:
            g = self.pool.gather(prefix_slots)  # [2, L, n, Hkv, D]
            cached_k[:, 0, p_b - reuse :] = g[0]
            cached_v[:, 0, p_b - reuse :] = g[1]
        logits, new_k, new_v = self.model.prefill_forward(
            self._dev(tokens),
            self._dev(positions),
            cached_k,
            cached_v,
            torch.full((1,), reuse, dtype=torch.int64, device=self.device),
        )
        self.pool.write(own[:n_new], new_k[:, 0, :n_new], new_v[:, 0, :n_new])
        req.output_tokens = []
        req.kv_len = len(prompt)
        req.token_slots = np.concatenate([prefix_slots, own[:n_new]])
        req.own_slots = own
        self._install_prefilled(req, row, reuse)
        return (req, logits[0, n_new - 1])

    def _sp_capable(self, member: tuple) -> bool:
        """A fresh (no cached prefix) long prompt on a mesh with an sp axis
        prefills sequence-sharded."""
        req, _, reuse, *_ = member
        return (
            self.device_mesh is not None
            and self.device_mesh.shape["sp"] > 1
            and reuse == 0
            and len(req.prompt) >= self.sp_prefill_threshold
        )

    def _prefill_sp(
        self, req: Request, row: int, reuse: int, prefix_slots: np.ndarray, own: np.ndarray
    ) -> tuple:
        """Sequence-parallel prefill of one fresh prompt: the whole span in
        one ``prefill_forward_sp`` call, each sp rank running its sequence
        block, ring attention between them. The blocks' K/V are all-gathered
        over sp and written into this rank's pool (replicated over sp,
        sharded over tp). Returns ``(req, final logit row)``."""
        prompt = req.prompt
        n = len(prompt)
        sp = self.device_mesh.shape["sp"]
        s_b = _pow2_at_least(n, floor=max(16, sp))
        s_b = -(-s_b // sp) * sp  # the sequence must divide by sp
        self._wave_padded = s_b  # launch shape (step accounting)
        tokens = np.zeros((1, s_b), dtype=np.int64)
        tokens[0, :n] = prompt
        positions = np.arange(s_b, dtype=np.int64)[None]
        logits, new_k, new_v = self.model.prefill_forward_sp(
            self._dev(tokens), self._dev(positions), self.device_mesh,
            logits_at=torch.tensor([n - 1], device=self.device),
        )
        new_k = all_gather(new_k, self.device_mesh, "sp", dim=2)
        new_v = all_gather(new_v, self.device_mesh, "sp", dim=2)
        self.pool.write(own[:n], new_k[:, 0, :n], new_v[:, 0, :n])
        req.output_tokens = []
        req.kv_len = n
        req.token_slots = own[:n].copy()
        req.own_slots = own
        self._install_prefilled(req, row, reuse)
        return (req, logits[0, 0])

    def _prefill_group(self, group: list[tuple]) -> list[tuple]:
        """Batched chunked-paged prefill: all rows advance through
        ``prefill_chunk_paged`` in lockstep (shapes bucketed to powers of
        two), each chunk writing K/V into the pool in place and attending
        through the page table. Ragged offsets are exact: every row carries
        its own positions and kv length; exhausted/padded rows ride the
        scratch slot."""
        N = len(group)
        ps = self.page_size
        prompts = [g[0].prompt for g in group]
        reuses = [g[2] for g in group]
        totals = [len(p) for p in prompts]
        token_slots_all = [
            np.concatenate([g[3], g[4][: totals[i] - reuses[i]]])
            for i, g in enumerate(group)
        ]
        n_new_max = max(t - r for t, r in zip(totals, reuses))
        C = _pow2_at_least(min(n_new_max, self.prefill_chunk), floor=16)
        B = _pow2_at_least(N, floor=1)
        maxp = _pow2_at_least(max(-(-t // ps) for t in totals), floor=_KV_BLOCK_PAGES)
        pt = np.full((B, maxp), self._scratch_page, dtype=np.int32)
        for i, ts in enumerate(token_slots_all):
            n_pages = -(-totals[i] // ps)
            pt[i, :n_pages] = ts[::ps] // ps
        pt_dev = self._dev(pt)
        self._wave_padded = B * C * -(-n_new_max // C)  # launch shape (step accounting)

        final_logits: list = [None] * N
        for ci in range(-(-n_new_max // C)):
            toks = np.zeros((B, C), dtype=np.int64)
            sl = np.full((B, C), self._scratch_slot, dtype=np.int64)
            poss = np.zeros((B, C), dtype=np.int32)
            kvlen = np.zeros((B,), dtype=np.int32)
            lastpos = np.full((N,), -1, dtype=np.int32)
            for i in range(N):
                start = reuses[i] + ci * C
                nv = min(max(totals[i] - start, 0), C)
                poss[i] = np.clip(start + np.arange(C, dtype=np.int32), 0, self.max_seq_len - 1)
                if nv > 0:
                    toks[i, :nv] = prompts[i][start : start + nv]
                    sl[i, :nv] = token_slots_all[i][start : start + nv]
                    kvlen[i] = start + nv
                    if start + nv == totals[i]:
                        lastpos[i] = nv - 1  # this chunk holds the last token
                else:
                    kvlen[i] = totals[i]
            self.stats.prefill_chunks += 1
            if np.any(np.minimum(poss[:, 0], kvlen) > 0):
                self.stats.prefill_chunks_with_prior += 1
            logits = self._forward_chunk(toks, poss, sl, pt_dev, kvlen)
            for i in range(N):
                if lastpos[i] >= 0:
                    final_logits[i] = logits[i, lastpos[i]]

        out = []
        for i, (req, row, reuse, prefix_slots, own) in enumerate(group):
            req.output_tokens = []
            req.kv_len = totals[i]
            req.token_slots = token_slots_all[i]
            req.own_slots = own
            self._install_prefilled(req, row, reuse)
            out.append((req, final_logits[i]))
        return out

    def _pp_n_micro(self, batch: int) -> int:
        """GPipe microbatches of a pp launch: one per stage when the batch
        divides, else one (the JAX engine's rule)."""
        pp = self.device_mesh.shape["pp"]
        return pp if batch % pp == 0 else 1

    def _forward_chunk(self, toks, poss, sl, pt, kvlen) -> torch.Tensor:
        """One chunk forward (host arrays, or a device page table ``pt``):
        ``pp_forward_chunk`` under pp, ``prefill_chunk_paged`` otherwise.
        Group prefill and the fused verify/mixed launch share it, so their
        dispatch cannot drift apart."""
        args = (self._dev(toks), self._dev(poss), self.pool.kv, self._dev(sl), self._dev(pt),
                self._dev(kvlen))
        if self._pp:
            return pp_forward_chunk(self.model, *args, page_size=self.page_size,
                                    n_micro=self._pp_n_micro(toks.shape[0]), kv_scale=self.pool.kv_scale)
        return self.model.prefill_chunk_paged(*args, page_size=self.page_size, kv_scale=self.pool.kv_scale)

    def _decode_step(self, tokens, slots, page_table, lengths) -> torch.Tensor:
        """One decode step's logits ``[max_batch, V]``: ``pp_decode_step``
        under pp, ``decode_step`` otherwise (B1 either way)."""
        args = (self._dev(tokens), self.pool.kv, self._dev(slots), self._dev(page_table),
                self._dev(lengths))
        if self._pp:
            return pp_decode_step(self.model, *args, page_size=self.page_size,
                                  n_micro=self._pp_n_micro(len(tokens)), kv_scale=self.pool.kv_scale)
        return self.model.decode_step(*args, page_size=self.page_size, kv_scale=self.pool.kv_scale)

    # ------------------------------------------------------------------
    # publish / release
    # ------------------------------------------------------------------

    def _sequence_key(self, req: Request, key_len: int) -> np.ndarray:
        if key_len <= len(req.prompt):
            return req.prompt[:key_len]
        return np.concatenate(
            [
                req.prompt,
                np.asarray(req.output_tokens[: key_len - len(req.prompt)], dtype=np.int32),
            ]
        )

    def _publish(self, req: Request, key_len: int) -> None:
        """Insert the first ``key_len`` tokens (whose KV is in the pool)
        into the tree; canonicalize shared prefixes; move the lock to the
        deepest published node."""
        tr = req.trace
        t_pub = time.monotonic() if tr is not None else 0.0
        key = self._sequence_key(req, key_len)
        matched = self.tree.insert(key, req.token_slots[:key_len].copy())
        m2 = self.tree.match_prefix(key)
        new_lock = m2.last_node
        if matched > req.prefix_len:
            # Over [prefix_len, matched) the tree kept already-present
            # slots; where another request published the same tokens first,
            # ours are duplicates — point at the canonical slots and free
            # only the differing ones.
            canon = m2.indices()
            old = req.token_slots[: len(canon)].copy()
            dup = old[old != canon]
            if dup.size:
                req.token_slots[: len(canon)] = canon
                req.own_slots = np.setdiff1d(req.own_slots, dup)
                self.pool.free(dup)
        # Slots now referenced by tree nodes are tree-owned.
        aligned = key_len - key_len % self.page_size
        tree_owned = req.token_slots[matched:aligned]
        if tree_owned.size:
            req.own_slots = np.setdiff1d(req.own_slots, tree_owned)
        if new_lock is not req.lock_node:
            self.tree.inc_lock_ref(new_lock)
            if req.lock_node is not None:
                self.tree.dec_lock_ref(req.lock_node)
            req.lock_node = new_lock
        if self.mesh is not None and aligned > 0:
            # Advertise only the page-aligned prefix: the residue slots are
            # freed at release, and advertising them would promise hits this
            # node cannot serve. A traced request's id rides the frames.
            self.mesh.insert(
                key[:aligned], req.token_slots[:aligned],
                trace_id=tr.trace_id if tr is not None else 0,
            )
        if tr is not None:
            tr.add("publish", t_pub, time.monotonic() - t_pub, cat="cache", tokens=int(key_len),
                   ring_advertised=bool(self.mesh is not None and aligned > 0))

    def _release(self, req: Request) -> None:
        """Publish the full sequence, free unpublished residue, release the
        lock, free the row."""
        self._publish(req, req.kv_len)
        if req.own_slots.size:
            self.pool.free(req.own_slots)
            req.own_slots = np.empty(0, dtype=np.int32)
        if req.lock_node is not None:
            self.tree.dec_lock_ref(req.lock_node)
            req.lock_node = None
        if req.row >= 0:
            self._rows[req.row] = None
            self._page_table[req.row] = self._scratch_page
            self._tokens[req.row] = 0
            req.row = -1

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode_pt_bucket(self, headroom: int, floor: int = 4) -> np.ndarray:
        """Length-bucketed page-table slice for one decode launch: wide
        enough for every active row plus ``headroom`` tokens, bucketed to a
        power of two, so short batches don't attend the full table."""
        need = 1
        for req in self._rows:
            if req is not None:
                need = max(need, (req.kv_len + headroom - 1) // self.page_size + 1)
        maxp = min(_pow2_at_least(need, floor=floor), self._page_table_padded.shape[1])
        return self._page_table_padded[:, :maxp]

    def _decode_once(self, inline_allot: list[int] | None = None) -> None:
        """One decode launch for every running row, by the first schedule
        that applies: the fused chunk launch (speculative verify with at
        least one draft, or a mixed wave's ``inline_allot``), multi-step
        decode, the compact dense leg of the crossover, or one
        ``decode_step``. An all-seeded batch takes none of the first three
        (each draws from the engine's stream) and draws each row through
        ``_sample_seeded_row`` from the ``decode_step`` logits."""
        g = self.spec_decode_tokens
        spec = g > 0 and self._spec_ok()
        if spec or inline_allot is not None:
            # Draft before committing to the wide verify launch: with no
            # draft anywhere the plain path emits the same tokens cheaper.
            # A mixed wave always takes the fused launch: drafted rows
            # verify, undrafted rows ride as width-1 windows and the inline
            # chunks fill the rest of the width.
            drafts: dict[int, np.ndarray] = {}
            sources: dict[int, str] = {}
            for row, req in enumerate(self._rows):
                if req is None:
                    continue
                if spec and self._spec_row_ok(req, g):
                    drafts[row], sources[row] = self._draft_for(req)
                else:
                    drafts[row], sources[row] = req.prompt[:0], "none"
            if inline_allot is not None or any(len(d) for d in drafts.values()):
                self._decode_spec_once(g if spec else 0, drafts, sources, inline=inline_allot)
                return
        k = self.decode_steps_per_launch
        if k > 1:
            k_eff = self._multi_step_k(k)
            if k_eff > 1:
                self._decode_multi_once(k_eff)
                return
        seeded = self._seeded_launch(self._rows)
        n_rows = sum(1 for r in self._rows if r is not None)
        use_paged = select_paged(
            n_rows, self.cfg.head_dim, self.device, min_batch=self.paged_min_batch,
            max_len=max((r.kv_len for r in self._rows if r is not None), default=0),
        )
        self._last_dispatch = last_dispatch()
        if not self._pp and not use_paged and not seeded:
            # The dense leg: one step over the compact working set (the
            # decode kernel over a gathered sub-pool on the card). Seeded
            # batches skip it: its sampler draws inside the fused loop from
            # the engine's stream.
            self._decode_multi_once(1, force_compact=True)
            return
        slots = np.full(self.max_batch, self._scratch_slot, dtype=np.int32)
        lengths = np.ones(self.max_batch, dtype=np.int32)
        preempted: list[Request] = []
        for row, req in enumerate(self._rows):
            if req is None:
                continue
            page_idx, offset = divmod(req.kv_len, self.page_size)
            if offset == 0:  # crossing into a fresh page
                new = self._alloc_pages(1, cause="preempt")
                if new is None:
                    preempted.append(req)
                    continue
                req.own_slots = np.concatenate([req.own_slots, new])
                self._page_table[row, page_idx] = new[0] // self.page_size
                slot = int(new[0])
            else:
                slot = int(self._page_table[row, page_idx] * self.page_size + offset)
            slots[row] = slot
            lengths[row] = req.kv_len + 1
        for req in preempted:
            self._preempt(req)

        active = [(row, r) for row, r in enumerate(self._rows) if r is not None]
        if not active:
            return
        step_t0 = time.monotonic()
        logits = self._decode_step(self._tokens, slots, np.ascontiguousarray(self._decode_pt_bucket(1)),
                                   lengths)
        if seeded:
            sampled = np.zeros(self.max_batch, dtype=np.int64)
            sampled[[row for row, _ in active]] = self._sample_seeded_rows(
                [(req, logits[row]) for row, req in active]
            )
        else:
            sampled = sample_tokens(
                logits, self._gen, temperature=self._temps, top_p=self._top_ps, top_k=self._top_ks
            ).cpu().numpy()
        self.stats.decode_steps += 1
        self.stats.decode_forwards += 1
        # The sampled tokens reached the host: this spans the step's
        # dispatch and device time, the TPOT every active request sees.
        elapsed = time.monotonic() - step_t0
        self._note_decode_time(elapsed)
        if self.step_acct is not None:
            self.step_acct.note_wave("decode", len(active), self.max_batch, elapsed,
                                     rows=len(active))
        for _, req in active:
            tr = req.trace
            if tr is not None:
                tr.add("decode_chunk", step_t0, elapsed, cat="decode", k_steps=1,
                       batch_rows=len(active))
        for row, req in active:
            self._consume_token(req, row, int(slots[row]), int(sampled[row]))

    def _multi_step_k(self, k: int) -> int:
        """The largest fusable step count ≤ ``k`` for this launch, bounded
        by every active row's sequence and page headroom and its remaining
        output budget (a row past its budget would discard the launch's
        tail). 1 while a waiting request could admit: admission happens
        between launches; 1 when any row is seeded: the fused launch draws
        its tokens from one in-launch stream, not per (seed, position)."""
        if self.waiting and self._free_row() >= 0:
            return 1
        if self._pp and self.max_batch % self.device_mesh.shape["pp"]:
            return 1  # pp_decode_multi rotates pp microbatches of rows
        for req in self._rows:
            if req is None:
                continue
            if req.sampling.seed is not None:
                return 1
            k = min(k, self.max_seq_len - req.kv_len)
            k = min(k, self.max_pages * self.page_size - req.kv_len)
            k = min(k, req.sampling.max_new_tokens - len(req.output_tokens))
            if k <= 1:
                return 1
        return k

    def _compact_decode_tables(self, active: list[tuple], k: int) -> tuple[np.ndarray, np.ndarray]:
        """The compact working set of ``decode_multi_compact``: the unique
        live pages of every active row (with ``k`` tokens of headroom) and
        the scratch page, padded to a power of two (≥ 8) by duplicating the
        scratch page — the one page where duplicate scatter-back targets
        are harmless — and the bucketed page table rewritten into compact
        indices (inactive rows on the scratch page's)."""
        ps = self.page_size
        need = [(row, (req.kv_len + k - 1) // ps + 1) for row, req in active]
        uniq = np.unique(np.concatenate(
            [self._page_table[row, :n] for row, n in need]
            + [np.asarray([self._scratch_page], dtype=np.int32)]
        )).astype(np.int32)
        n_c = _pow2_at_least(len(uniq), floor=8)
        compact = np.full(n_c, self._scratch_page, dtype=np.int32)
        compact[: len(uniq)] = uniq
        scratch_idx = int(np.searchsorted(uniq, self._scratch_page))
        maxp = self._decode_pt_bucket(k).shape[1]
        pt_c = np.full((self.max_batch, maxp), scratch_idx, dtype=np.int32)
        for row, n in need:
            pt_c[row, :n] = np.searchsorted(uniq, self._page_table[row, :n])
        return compact, pt_c

    def _decode_multi_once(self, k: int, force_compact: bool = False) -> None:
        """One ``decode_multi`` launch: ``k`` tokens per active row with a
        single host round trip. ``force_compact`` (the crossover's dense
        leg), or a device/head dim outside ``default_use_kernel``, runs it
        over the compact working set."""
        lengths = np.ones(self.max_batch, dtype=np.int32)
        active = self._provision_rows(k - 1)
        if not active:
            return
        for row, req in active:
            lengths[row] = req.kv_len + 1
        step_t0 = time.monotonic()
        common = dict(
            generator=self._gen, temperatures=self._temps, top_ps=self._top_ps,
            page_size=self.page_size, k_steps=k, kv_scale=self.pool.kv_scale,
            top_ks=self._top_ks,
        )
        if self._pp:
            sampled = pp_decode_multi(
                self.model, self._dev(self._tokens), self.pool.kv,
                self._dev(np.ascontiguousarray(self._decode_pt_bucket(k))), self._dev(lengths), **common,
            )
            self.stats.multi_step_launches += 1
        elif force_compact or not default_use_kernel(self.cfg.head_dim, self.device):
            compact, pt_c = self._compact_decode_tables(active, k)
            sampled = self.model.decode_multi_compact(
                self._dev(self._tokens), self.pool.kv, self._dev(compact), self._dev(pt_c),
                self._dev(lengths), **common,
            )
            self.stats.compact_launches += 1
        else:
            sampled = self.model.decode_multi(
                self._dev(self._tokens), self.pool.kv,
                self._dev(np.ascontiguousarray(self._decode_pt_bucket(k))),
                self._dev(lengths), **common,
            )
            self.stats.multi_step_launches += 1
        sampled = sampled.cpu().numpy()  # [k, B]: the one round trip
        self.stats.decode_steps += k
        self.stats.decode_forwards += k
        elapsed = time.monotonic() - step_t0
        for _ in range(k):
            self._note_decode_time(elapsed / k)
        if self.step_acct is not None:
            self.step_acct.note_wave("decode", k * len(active), k * self.max_batch, elapsed,
                                     rows=len(active))
        for _, req in active:
            tr = req.trace
            if tr is not None:
                tr.add("decode_chunk", step_t0, elapsed, cat="decode", k_steps=k,
                       batch_rows=len(active))
        ps = self.page_size
        for row, req in active:
            base = req.kv_len
            for i in range(k):
                pos = base + i
                slot = int(self._page_table[row, pos // ps] * ps + pos % ps)
                if self._consume_token(req, row, slot, int(sampled[i, row])):
                    break  # finished mid-launch: the surplus is discarded

    def _spec_ok(self) -> bool:
        """Speculation is considered whenever rows run and no request
        waits for admission (a wide verify launch would delay its
        prefill). Stochastic rows verify by exact rejection sampling, so
        temperature does not turn it off; per-row limits are
        ``_spec_row_ok``'s. Off when any row is seeded: the verify
        resample draws from the launch-wide stream, not per (seed,
        position)."""
        if self.waiting:
            return False
        if any(r is not None and r.sampling.seed is not None for r in self._rows):
            return False
        return any(req is not None for req in self._rows)

    def _spec_row_ok(self, req: Request, g: int) -> bool:
        """Per-row gate: the verify window needs γ + 1 positions of
        sequence and page-table headroom, and a row within one token of its
        budget gains nothing from a draft. A failing row rides the launch
        with an empty draft (exactly a plain step for it)."""
        if req.kv_len + g + 1 > self.max_seq_len:
            return False
        if (req.kv_len + g) // self.page_size >= self.max_pages:
            return False
        return req.sampling.max_new_tokens - len(req.output_tokens) >= 2

    # Draft lookup scans at most this many trailing history tokens, so a
    # long generation puts no O(context) host work between launches.
    _SPEC_WINDOW = 1024

    def _draft_for(self, req: Request) -> tuple[np.ndarray, str]:
        """``(draft, source)``, source one of ``DRAFT_SOURCES``: the radix
        tree's published continuation of the row's history first (a
        replayed request finds its previous generation), then the n-gram
        tail. The tree walk is O(context), so it runs only for requests
        admitted as near-full prefix hits (or re-armed by a newer
        ``draft_ready_epoch``) and stops the first time it comes back
        empty. γ is the class's (``spec_ledger.gamma_for``)."""
        gamma = self.spec_ledger.gamma_for(
            req.tenant, shape_bucket(len(req.prompt)), self.spec_decode_tokens
        )
        hist = self._sequence_key(req, req.kv_len + 1)
        # The KV-transfer plane bumps the epoch when a restore installs
        # continuation KV this request's earlier peek did not see.
        epoch = getattr(self.tree, "draft_ready_epoch", 0)
        promoted = epoch > req.draft_epoch
        if promoted:
            req.tree_draft_ok = True
            req.draft_epoch = epoch
        if req.tree_draft_ok and (
            promoted or req.prefix_len >= max(0, len(req.prompt) - self.page_size)
        ):
            cont = self.tree.peek_continuation(hist, gamma)
            if len(cont):
                return cont, "tree"
            req.tree_draft_ok = False
        draft = self._ngram_draft(hist[-self._SPEC_WINDOW :], gamma, self.spec_ngram)
        return draft, ("ngram" if len(draft) else "none")

    @staticmethod
    def _ngram_draft(hist: np.ndarray, gamma: int, n: int) -> np.ndarray:
        """Prompt-lookup draft: the ``gamma`` tokens that followed the most
        recent previous occurrence of the tail n-gram (falling back to
        shorter n-grams, down to bigrams). Empty when the history never
        repeats its tail."""
        L = len(hist)
        for nn in range(n, 1, -1):
            if L <= nn:
                continue
            tail = hist[L - nn :]
            win = np.lib.stride_tricks.sliding_window_view(hist, nn)
            hits = np.nonzero((win[: L - nn] == tail).all(axis=1))[0]
            if hits.size:
                j = int(hits[-1]) + nn  # the continuation of the match
                return hist[j : j + gamma]
        return hist[:0]

    def _provision_rows(self, extra: int, extras: dict[int, int] | None = None) -> list[tuple[int, Request]]:
        """Make every active row's page table cover positions ``kv_len ..
        kv_len + extra`` (``extras`` overrides the bound per row, so a row
        with an empty draft is never preempted for headroom it will not
        write); preempt rows the pool cannot cover. Returns the surviving
        ``(row, request)`` pairs."""
        ps = self.page_size
        preempted: list[Request] = []
        for row, req in enumerate(self._rows):
            if req is None:
                continue
            row_extra = extra if extras is None else extras.get(row, extra)
            for p_idx in range(req.kv_len // ps, (req.kv_len + row_extra) // ps + 1):
                if self._page_table[row, p_idx] != self._scratch_page:
                    continue  # page already provisioned
                new = self._alloc_pages(1, cause="preempt")
                if new is None:
                    preempted.append(req)
                    break
                req.own_slots = np.concatenate([req.own_slots, new])
                self._page_table[row, p_idx] = new[0] // ps
        for req in preempted:
            self._preempt(req)
        return [(row, r) for row, r in enumerate(self._rows) if r is not None]

    def _decode_spec_once(
        self,
        g: int,
        drafts: dict[int, np.ndarray],
        sources: dict[int, str] | None = None,
        inline: list[int] | None = None,
        decode: bool = True,
    ) -> None:
        """One fused chunk launch (``prefill_chunk_paged``): decode rows
        verify ``[fed token, draft...]`` (``w = len(draft) + 1`` live
        positions; ``w = 1`` is a plain step) and inline prefill jobs ride
        the same call with their allotted prompt slice as the live window
        (``inline``, tokens per backlog job). Decode rows accept through
        ``spec_verify_sample`` and emit one bonus token. The pass writes
        the fed positions' K/V itself; rejected positions hold stale K/V
        that a later launch overwrites and attention never reads (masked
        by length); positions past a row's window write to the scratch
        slot. A job whose final chunk lands here installs and samples its
        first token in the same wave. ``decode=False`` advances the
        backlog alone (prefill and boost waves)."""
        ps = self.page_size
        jobs = (
            [(job, w) for job, w in zip(self._inline, inline) if w > 0 and job.pos < job.total]
            if inline is not None
            else []
        )
        if inline is None:
            C = g + 1  # a pure verify launch
        else:
            # Wide enough for the widest live window this wave, a power of
            # two (the group prefill's chunk floor).
            C = _pow2_at_least(max([g + 1] + [w for _, w in jobs]), floor=16)
        # Provision only each row's own verify window; inline jobs acquired
        # all their pages at admission.
        active = (
            self._provision_rows(g, extras={row: len(d) for row, d in drafts.items()})
            if decode
            else []
        )
        if not active and not jobs:
            return
        step_t0 = time.monotonic()

        B = self.max_batch
        maxp = _pow2_at_least(
            max(
                [(r.kv_len + len(drafts.get(row, r.prompt[:0]))) // ps + 1 for row, r in active]
                + [(job.pos + w) // ps + 1 for job, w in jobs]
            ),
            floor=_KV_BLOCK_PAGES,
        )
        toks = np.zeros((B, C), dtype=np.int64)
        draft_len = np.zeros((B,), dtype=np.int64)
        sl = np.full((B, C), self._scratch_slot, dtype=np.int64)
        poss = np.zeros((B, C), dtype=np.int32)
        kvlen = np.zeros((B,), dtype=np.int32)
        pt = np.full((B, maxp), self._scratch_page, dtype=np.int32)
        for row, req in active:
            draft = drafts.get(row, req.prompt[:0])
            drafts[row] = draft
            w = len(draft) + 1  # this row's live verify window
            toks[row, 0] = self._tokens[row]
            toks[row, 1:w] = draft
            pos = req.kv_len + np.arange(C)
            poss[row] = np.minimum(pos, self.max_seq_len - 1)
            n_pages = min((req.kv_len + len(draft)) // ps + 1, self.max_pages)
            pt[row, :n_pages] = self._page_table[row, :n_pages]
            sl[row, :w] = pt[row, pos[:w] // ps] * ps + pos[:w] % ps
            kvlen[row] = req.kv_len + w
            draft_len[row] = len(draft)
            # Conservation: a draft counts as proposed iff its row survived
            # provisioning to this verify, where every proposed token is
            # then accounted accepted or rejected.
            self.stats.spec_proposed += len(draft)
            self._m_spec_proposed.inc(len(draft))
            if len(draft):
                self._spec_shape.setdefault(shape_bucket(len(req.prompt)), [0, 0])[0] += len(draft)
        for job, w in jobs:
            # An inline row's live window is its allotted slice [pos, pos+w)
            # of the prompt: one _prefill_group chunk for one row. Its
            # draft_len stays 0, and its bonus sample is never consumed.
            row, pos, prompt = job.row, job.pos, job.req.prompt
            toks[row, :w] = prompt[pos : pos + w]
            poss[row] = np.minimum(pos + np.arange(C), self.max_seq_len - 1)
            sl[row, :w] = job.token_slots[pos : pos + w]
            kvlen[row] = pos + w
            npg = min(-(-job.total // ps), maxp)
            pt[row, :npg] = job.token_slots[::ps][:npg] // ps

        logits = self._forward_chunk(toks, poss, sl, pt, kvlen)
        if active and jobs:
            self.stats.mixed_launches += 1
        elif active:
            self.stats.verify_launches += 1
        else:
            self.stats.inline_launches += 1
        if active:
            accept_len, bonus = spec_verify_sample(
                logits, self._dev(toks[:, 1:]), self._dev(draft_len), self._gen,
                self._dev(self._temps), self._dev(self._top_ps), self._dev(self._top_ks),
            )
            accept_len = accept_len.cpu().numpy()  # one sync
            bonus = bonus.cpu().numpy()
            self.stats.decode_steps += 1

        emitted_total = 0
        for row, req in active:
            draft = drafts[row]
            a = int(accept_len[row])
            rejected = len(draft) - a
            self.stats.spec_accepted += a
            self.stats.spec_rejected += rejected
            self._m_spec_accepted.inc(a)
            if rejected:
                self._m_spec_rejected.inc(rejected)
            # The rejected tail: the gap before this row's next token
            # re-decodes it (the spec_verify_miss stall cause).
            req.spec_miss = rejected
            if a:
                self._spec_shape.setdefault(shape_bucket(len(req.prompt)), [0, 0])[1] += a
            if len(draft):
                self.spec_ledger.note_wave(
                    req.tenant, shape_bucket(len(req.prompt)),
                    sources.get(row, "ngram") if sources else "ngram",
                    len(draft), a, len(draft),
                )
            base = req.kv_len
            for i in range(a + 1):  # a accepted drafts, then the bonus token
                pos = base + i
                slot = int(self._page_table[row, pos // ps] * ps + pos % ps)
                token = int(draft[i]) if i < a else int(bonus[row])
                emitted_total += 1
                if self._consume_token(req, row, slot, token):
                    break
        inline_tok = 0
        pending: list[tuple] = []
        for job, w in jobs:
            start = job.pos
            job.pos += w  # the exact resume offset for the next wave
            inline_tok += w
            tr = job.req.trace
            if tr is not None:
                tr.add("prefill_inline", step_t0, time.monotonic() - step_t0, cat="prefill",
                       chunk_tokens=int(w), resume_offset=int(start))
            if job.pos >= job.total:
                # Final chunk: install, and hand the last prompt position's
                # logits to the first-token sampler (one batched sample for
                # every job finishing this wave).
                req = job.req
                req.output_tokens = []
                req.kv_len = job.total
                req.token_slots = job.token_slots
                req.own_slots = job.own
                self._inline_rows.discard(job.row)
                self._install_prefilled(req, job.row, job.reuse, inline=True)
                pending.append((req, logits[job.row, w - 1]))
        if jobs:
            # Stall attribution: an inline chunk advanced in this wave, so
            # a decode gap spanning it is prefill_inline.
            self._last_inline_prefill_t = time.monotonic()
            self._inline = [j for j in self._inline if j.pos < j.total]
        if pending:
            self._finalize_first_tokens(pending)
        elapsed = time.monotonic() - step_t0
        if active:
            for _ in range(max(emitted_total, 1)):
                self._note_decode_time(elapsed / max(emitted_total, 1))
        if self.step_acct is not None:
            # B·C positions launched; useful work is the decode tokens
            # emitted plus the inline prefill tokens advanced.
            self.step_acct.note_wave("decode" if active else "prefill",
                                     emitted_total + inline_tok, B * C, elapsed,
                                     rows=len(active) + len(jobs))
        for row, req in active:
            tr = req.trace
            if tr is not None:
                tr.add("decode_chunk", step_t0, elapsed, cat="decode", k_steps=1,
                       batch_rows=len(active), speculative=True,
                       draft_tokens=int(draft_len[row]), accepted_tokens=int(accept_len[row]))

    def hint_stall(self, cause: str) -> None:
        """One-shot stall-cause latch for external planes: the next
        over-threshold inter-token gap is attributed to ``cause``."""
        if cause not in STALL_CAUSES:
            raise ValueError(f"unknown stall cause {cause!r}")
        self._stall_hint = cause

    def _stall_cause(self, req: Request, now: float, gap_s: float) -> str:
        """Attribute one over-threshold inter-token gap to its single most
        likely cause, in ``STALL_CAUSES`` priority order."""
        hint = self._stall_hint
        if hint is not None:
            self._stall_hint = None
            return hint
        if self._restoring:
            return "restore_park"
        if now - self._last_prefill_t <= gap_s:
            return "prefill_convoy"  # a whole prefill wave ran in the gap
        if now - self._last_inline_prefill_t <= gap_s:
            return "prefill_inline"  # a budget-bounded inline chunk did
        if req.spec_miss:
            req.spec_miss = 0
            return "spec_verify_miss"
        return "scheduler_wait"

    def _note_token_time(self, req: Request) -> None:
        """Per-emitted-token timeline and goodput accounting: the gap since
        the request's previous token (its first token only stamps the
        clock), with over-threshold gaps attributed to a stall cause. The
        stamp is the host's, after the step's device-to-host copy; the
        tokens of one multi-step or speculative launch share it."""
        now = time.monotonic()
        prev = req.last_token_time
        req.last_token_time = now
        self.goodput.note_token(req.tenant)
        if not prev:
            return
        gap = now - prev
        cause = None
        if gap >= self.timeline.stall_threshold_s:
            cause = self._stall_cause(req, now, gap)
            self.goodput.note_stall(req.tenant, gap)
        self.timeline.note_token(
            req.rid, req.tenant, gap, cause,
            trace_id=getattr(req.trace, "trace_id", None), now=now,
        )

    def _consume_token(self, req: Request, row: int, slot: int, token: int) -> bool:
        """Account one decode iteration for ``req``: the fed token's KV
        landed at ``slot``, ``token`` was sampled. Returns True when the
        request finished (stop token / length cap) and was released."""
        req.token_slots = np.append(req.token_slots, slot)
        req.kv_len += 1
        req.output_tokens.append(token)
        self.stats.generated_tokens += 1
        if self.timeline is not None:  # one branch when off
            self._note_token_time(req)
        if req.is_finished_by(token) or req.num_tokens >= self.max_seq_len:
            # Don't count the terminal token as output if it's a stop.
            if token in req.sampling.stop_token_ids:
                req.output_tokens.pop()
                self.stats.generated_tokens -= 1
            else:
                self._m_generated.inc()
            req.finish_time = time.monotonic()
            if req.submit_time:
                self._m_req_e2e.labels(tenant=req.tenant).observe(
                    req.finish_time - req.submit_time,
                    trace_id=getattr(req.trace, "trace_id", None),
                )
            req.state = RequestState.FINISHED
            self.stats.finished += 1
            self._release(req)
            self._pressure = False  # freed memory: resume admission
            return True
        self._m_generated.inc()
        self._tokens[row] = token
        if (
            self.stream_publish_tokens > 0
            and len(req.output_tokens) % self.stream_publish_tokens == 0
        ):
            # Mid-decode publish: the grown prefix (prompt + generated so
            # far) lands in the tree every N tokens, so a crash loses at
            # most N tokens of a resumed request's cache hit. Idempotent
            # for prefixes already published.
            self._publish(req, req.kv_len)
        req.note_progress()
        return False

    def _preempt(self, req: Request) -> None:
        """Pool exhausted mid-decode even after eviction: publish what we
        have, free the row, and requeue from scratch (generated tokens are
        discarded; the published KV makes the retry a long prefix hit)."""
        self.stats.preemptions += 1
        self._m_preempt.inc()
        self._pressure = True
        req.requeue_time = time.monotonic()
        tr = req.trace
        if tr is not None:
            tr.add("preempt", req.requeue_time, 0.0, cat="scheduler", kv_len=int(req.kv_len),
                   output_tokens=len(req.output_tokens))
        self._release(req)
        req.state = RequestState.QUEUED
        req.output_tokens = []
        # The timeline's clock restarts with the life: the retry's first
        # token is TTFT again, not a long gap.
        req.last_token_time = 0.0
        req.kv_len = 0
        req.prefix_len = 0
        req.token_slots = np.empty(0, dtype=np.int32)
        req.spec_miss = 0
        # The retry re-admits against its own just-published generation,
        # the ideal tree-draft replay: re-arm tree drafting.
        req.tree_draft_ok = True
        self.waiting.insert(0, req)
