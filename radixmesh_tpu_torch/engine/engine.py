"""Continuous-batching serving engine over the radix prefix cache (the
legacy schedule of the JAX package's ``engine/engine.py``).

One ``step()`` is one compute wave: admit queued requests (prefix match in
the radix tree, lock, page allocation with LRU eviction under pressure),
prefill them to completion, then one batched decode step for every running
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

Not ported yet, and refused rather than ignored: speculative decode, mixed
waves, multi-step and compact decode, seeded replay, host/disk tiers and KV
transfer, the cache mesh, pp/sp/tp, W8A16 weights, SLO control and the
observability planes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
from radixmesh_tpu_torch.cache.radix_tree import RadixTree
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig
from radixmesh_tpu_torch.ops.sampling import sample_tokens
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["Engine", "EngineStats"]


def _pow2_at_least(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


# Pages per attention KV block of the chunked launches: chunk page tables
# are pow2-padded with this as the floor (the JAX engine's constant).
_KV_BLOCK_PAGES = 32


@dataclass
class EngineStats:
    """Hit-rate, throughput and path counters."""

    prompt_tokens: int = 0
    cached_tokens: int = 0  # reused from the radix cache at prefill
    generated_tokens: int = 0
    prefills: int = 0
    decode_steps: int = 0
    finished: int = 0
    preemptions: int = 0
    evicted_tokens: int = 0  # tree tokens evicted under pool pressure
    prefill_chunks: int = 0  # prefill_chunk_paged launches
    prefill_chunks_with_prior: int = 0  # ... where some row had pool context
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
        device: str | torch.device | None = None,
        kv_quant: str | None = None,
    ):
        """``params`` is a param tree (``init_params`` / ``params_from_jax``)
        or a built :class:`Llama`. ``device`` defaults to CUDA and raises
        where torch has none; pass ``"cpu"`` for the plain CPU path.
        ``kv_quant="int8"`` stores the KV pool as int8 with per-token
        scales."""
        if page_size & (page_size - 1):
            raise ValueError("page_size must be a power of two")
        self.device = resolve_device(device)
        self.cfg = cfg
        model = params if isinstance(params, Llama) else Llama(cfg, params)
        self.model = model.to(self.device)
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
        self.pool = PagedKVPool(
            num_slots=num_slots,
            num_layers=cfg.n_layers,
            num_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim,
            page_size=page_size,
            dtype=cfg.dtype,
            device=self.device,
            quant=kv_quant,
        )
        self.tree = RadixTree(page_size=page_size, on_free=self.pool.free)
        # Reserved scratch page: inactive decode rows write/read here.
        scratch = self.pool.alloc(page_size)
        assert scratch is not None
        self._scratch_slot = int(scratch[0])
        self._scratch_page = self._scratch_slot // page_size

        self.waiting: list[Request] = []
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
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def make_request(
        self, prompt: Sequence[int], sampling: SamplingParams | None = None
    ) -> Request:
        """Build + validate a request without queueing it."""
        sampling = sampling or SamplingParams()
        if sampling.seed is not None:
            raise ValueError(
                "seeded sampling (per-request replay) is not ported to the "
                "PyTorch engine yet"
            )
        req = Request(prompt=np.asarray(prompt, dtype=np.int32), sampling=sampling)
        if not (0 < len(req.prompt) < self.max_seq_len):
            raise ValueError(f"prompt length {len(req.prompt)} out of range")
        if int(req.prompt.min()) < 0 or int(req.prompt.max()) >= self.cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.cfg.vocab_size})")
        req.submit_time = time.monotonic()
        return req

    def enqueue(self, req: Request) -> Request:
        self.waiting.append(req)
        return req

    def add_request(
        self, prompt: Sequence[int], sampling: SamplingParams | None = None
    ) -> Request:
        return self.enqueue(self.make_request(prompt, sampling))

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
        return False

    def cancel_all(self) -> int:
        """Abort every queued and running request; returns the count."""
        rids = [r.rid for r in self.waiting] + [
            r.rid for r in self._rows if r is not None
        ]
        return sum(1 for rid in rids if self.cancel(rid))

    def step(self) -> None:
        """One scheduler iteration: admit + prefill queued requests, then
        one batched decode step for everything running."""
        with torch.inference_mode():
            self._admit()
            if any(r is not None for r in self._rows):
                self._decode_once()

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self._rows)

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
            if r is None:
                return i
        return -1

    def _alloc_pages(self, n_pages: int) -> np.ndarray | None:
        """Whole-page allocation with evict-under-pressure retry."""
        n = n_pages * self.page_size
        slots = self.pool.alloc(n)
        if slots is None:
            self.stats.evicted_tokens += self.tree.evict(n - self.pool.free_slots)
            slots = self.pool.alloc(n)
        return slots

    def _admit(self) -> None:
        """Admit waiting requests into free rows. Concurrent arrivals
        prefill as one batched chunked-paged group + one batched sample; a
        lone short request keeps the dense path."""
        if self._pressure and any(r is not None for r in self._rows):
            return
        self._pressure = False  # batch drained: safe to admit again
        made_progress = True
        while self.waiting and made_progress:
            group: list[tuple] = []
            idx = 0
            while idx < len(self.waiting):
                row = self._free_row()
                if row < 0:
                    break
                req = self.waiting[idx]
                match = self.tree.match_prefix(req.prompt)
                if self._defer_for_prefix_wave(req, match.length, group):
                    # A groupmate is about to publish this prefix: next
                    # wave it is a cache hit instead of a recompute.
                    idx += 1
                    continue
                acquired = self._acquire_prompt_slots(req, match)
                if acquired is None:
                    break  # pool exhausted even after evict: wait for finishes
                self.waiting.pop(idx)
                reuse, prefix_slots, own = acquired
                self._rows[row] = req  # reserve the row; re-set on install
                group.append((req, row, reuse, prefix_slots, own))
            for _, row, *_ in group:
                self._rows[row] = None
            made_progress = bool(group)
            if not group:
                break

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
                if (
                    self.pool.quant is None
                    and len(sub) == 1
                    and len(sub[0][0].prompt) - sub[0][2] <= self.long_prefill_threshold
                ):
                    pending = [self._prefill_dense(*sub[0])]
                else:
                    pending = self._prefill_group(sub)
                self._finalize_first_tokens(pending)

    def _defer_for_prefix_wave(
        self, req: Request, cached: int, group: list[tuple]
    ) -> bool:
        """True if ``req`` shares at least one page of not-yet-cached
        prefix (beyond its ``cached`` match) with a request already
        collected this wave: that one publishes it, so waiting turns the
        recompute into a hit."""
        if not group:
            return False
        prompt = req.prompt
        span = cached - cached % self.page_size + self.page_size
        if len(prompt) < span:
            return False
        head = prompt[:span]
        return any(
            len(g[0].prompt) >= span and np.array_equal(g[0].prompt[:span], head)
            for g in group
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

    def _install_prefilled(self, req: Request, row: int, reuse: int) -> None:
        """Mark RUNNING, record stats, publish the prompt, wire the decode
        row. ``req.kv_len``/``token_slots``/``own_slots`` must be set."""
        req.prefix_len = reuse
        req.state = RequestState.RUNNING
        req.row = row
        self.stats.prefills += 1
        self.stats.prompt_tokens += len(req.prompt)
        self.stats.cached_tokens += reuse
        self._publish(req, len(req.prompt))
        self._rows[row] = req
        self._temps[row] = req.sampling.temperature
        self._top_ps[row] = req.sampling.top_p
        self._top_ks[row] = req.sampling.top_k
        self._page_table[row] = self._scratch_page
        n_pages = -(-req.kv_len // self.page_size)
        self._page_table[row, :n_pages] = req.token_slots[:: self.page_size] // self.page_size

    def _finalize_first_tokens(self, pending: list[tuple]) -> None:
        """One batched sample + one device→host copy for every request of
        the sub-wave."""
        logits = torch.stack([logit for _, logit in pending])
        reqs = [r for r, _ in pending]
        sampled = sample_tokens(
            logits,
            self._gen,
            temperature=self._dev(np.asarray([r.sampling.temperature for r in reqs], np.float32)),
            top_p=self._dev(np.asarray([r.sampling.top_p for r in reqs], np.float32)),
            top_k=self._dev(np.asarray([r.sampling.top_k for r in reqs], np.int64)),
        ).cpu().numpy()
        now = time.monotonic()
        for (req, logit), tok in zip(pending, sampled):
            if self.on_first_logits is not None:
                self.on_first_logits(req, logit)
            req.first_token_time = now
            req.output_tokens = [int(tok)]
            self._tokens[req.row] = int(tok)
            self.stats.ttft_s.append(now - req.submit_time)
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
        kv_shape = (cfg.n_layers, 1, p_b, cfg.n_kv_heads, cfg.head_dim)
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
            logits = self.model.prefill_chunk_paged(
                self._dev(toks),
                self._dev(poss),
                self.pool.kv,
                self._dev(sl),
                pt_dev,
                self._dev(kvlen),
                page_size=ps,
                kv_scale=self.pool.kv_scale,
            )
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

    def _decode_once(self) -> None:
        slots = np.full(self.max_batch, self._scratch_slot, dtype=np.int32)
        lengths = np.ones(self.max_batch, dtype=np.int32)
        preempted: list[Request] = []
        for row, req in enumerate(self._rows):
            if req is None:
                continue
            page_idx, offset = divmod(req.kv_len, self.page_size)
            if offset == 0:  # crossing into a fresh page
                new = self._alloc_pages(1)
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
        logits = self.model.decode_step(
            self._dev(self._tokens),
            self.pool.kv,
            self._dev(slots),
            self._dev(np.ascontiguousarray(self._decode_pt_bucket(1))),
            self._dev(lengths),
            page_size=self.page_size,
            kv_scale=self.pool.kv_scale,
        )
        sampled = sample_tokens(
            logits,
            self._gen,
            temperature=self._dev(self._temps),
            top_p=self._dev(self._top_ps),
            top_k=self._dev(self._top_ks),
        ).cpu().numpy()
        self.stats.decode_steps += 1
        for row, req in active:
            self._consume_token(req, row, int(slots[row]), int(sampled[row]))

    def _consume_token(self, req: Request, row: int, slot: int, token: int) -> bool:
        """Account one decode iteration for ``req``: the fed token's KV
        landed at ``slot``, ``token`` was sampled. Returns True when the
        request finished (stop token / length cap) and was released."""
        req.token_slots = np.append(req.token_slots, slot)
        req.kv_len += 1
        req.output_tokens.append(token)
        self.stats.generated_tokens += 1
        if req.is_finished_by(token) or req.num_tokens >= self.max_seq_len:
            # Don't count the terminal token as output if it's a stop.
            if token in req.sampling.stop_token_ids:
                req.output_tokens.pop()
                self.stats.generated_tokens -= 1
            req.finish_time = time.monotonic()
            req.state = RequestState.FINISHED
            self.stats.finished += 1
            self._release(req)
            self._pressure = False  # freed memory: resume admission
            return True
        self._tokens[row] = token
        req.note_progress()
        return False

    def _preempt(self, req: Request) -> None:
        """Pool exhausted mid-decode even after eviction: publish what we
        have, free the row, and requeue from scratch (generated tokens are
        discarded; the published KV makes the retry a long prefix hit)."""
        self.stats.preemptions += 1
        self._pressure = True
        self._release(req)
        req.state = RequestState.QUEUED
        req.output_tokens = []
        req.kv_len = 0
        req.prefix_len = 0
        req.token_slots = np.empty(0, dtype=np.int32)
        self.waiting.insert(0, req)
