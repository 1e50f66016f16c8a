#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``radixmesh_tpu_torch``) on one
NVIDIA H100 — the quickest proof that the port builds and serves on the
card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Environment: the card's name and power limit, torch/CUDA versions, the
   build of every CUDA kernel from ``radixmesh_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together; ``ptxas`` reports to
   ``chip_out/ptxas.txt``; phase 16 (b) and the port's meshcheck over its
   tree run on the host meanwhile), and ``cuobjdump -sass`` (beside phase
   2) of the tensor-core
   chunk library, which must hold HGMMA (wgmma) instructions, and of the
   CUDA-core chunk body's, which must hold LDGSTS (cp.async) and LDS.128.
   The CUDA-core body's registers, spill bytes and shared memory are
   printed per instantiation; at D 128 none may spill.
2. Kernels: each kernel body and pool dtype against its plain PyTorch
   version on the card at the Llama-3-8B attention shapes (Hq 32, Hkv 8,
   D 128, page 16): the split decode and pool kernels at B=1 and B=8 over a
   256-page table (many splits) and at B=8 over a 4-page table (one
   split), ragged lengths up to 4096; the chunk kernel's tensor-core body
   (bf16 queries) and CUDA-core body (float32 queries) at C = 512 (priors
   0, 2500 and B=8 ragged) and C = 64 with priors > 0. Permuted page
   tables, a NaN-poisoned page behind every page-table pad and page tail
   (for int8 pools the NaN sits in the scales), length-0 and length-1
   rows on the scratch slot. float32 (atol 1e-4), bf16 and int8 pools
   with bf16 queries (atol 2e-2 on the bf16 output, and row by row
   ||got - want|| <= 2e-2 ||want|| over each query head's D values),
   int8 pools with float32 queries (atol 1e-4); the decode pool contents
   (int8: payload and scales, each bit-equal) after the write. Three
   faults planted in the chunk cases' inputs at C = 512 (a skipped prior
   key, a skipped 64-key prior tile, one wrong prior page) must each fail
   the row check (tensor cores) or the 1e-4 check (CUDA cores). The fast
   schedules' shapes: the chunk kernel at C = 5 (a γ = 4 speculative
   verify: one query per CTA, 4 of 128 rows live) and C = 16 (a mixed
   wave's floor: 64 rows), both bodies, float32, bf16 and int8 pools,
   ragged priors, live windows w in {1, 3, 5, 16} and an all-padding row,
   with the longest row's last prior page read from the scratch page as a
   planted fault at C = 5; the decode kernel over a 16-page compact
   sub-pool. The serving path's own shapes: decode 4 x 600 and 8 x 2000
   (three readings each) and the 8 x 2000 prefill's four chunks. Pages of
   1, 3 and 4 tokens (gathered row by row; 4 timed) and of 24 and 64
   (TMA boxes of 8 and 64 rows): decode, pool and both chunk bodies.
   Times with CUDA events (L2 flushed before each launch, the
   host's launch time kept out, the median of the timed calls) beside the
   bound, the plain version and one library call
   (``scaled_dot_product_attention`` over the gathered dense K/V).
3. Serving, three times on one set of weights: Llama-3-8B at full width,
   random bf16 weights from a seed, a 65536-slot pool, behind the HTTP
   frontend — with a bf16 pool, with an int8 pool (``kv_quant="int8"``),
   and with a bf16 pool and the fast schedules on (``SCHEDULES``:
   speculative decode γ = 4, mixed waves with a 64-token budget, 4 decode
   steps per launch, one-row waves on the compact leg). Each: 4
   concurrent prompts (group prefill through the chunk kernel), a
   ~3000-token prompt (chunks with prior > 0), a follow-up that must hit
   the cache, and a repeated greedy request that must return the same
   tokens; the scheduled run adds a 3000-token prompt that arrives while
   the 4 rows decode (mixed waves) and must accept tree drafts on the
   repeat. Kernel launch counts are zeroed just before and read just
   after; the pool's split decode and tensor-core chunk kernels (the int8
   variants for the int8 pool) must have run once per layer per decode
   pass and per chunk launch, the CUDA-core chunk body and the plain
   attention versions never.
4. Pool path over the served state: after each serving run, the read-only
   pool kernel (``paged_attention_pool_bucketed``) over every layer of the
   published prefixes' pages, counted alone and held against its plain
   version.
5. Whole path: a 2-layer float32 copy of the same widths through the
   ``Engine`` on the card and on the CPU with the same weights, with a
   float32 pool (first-token logits within atol 1e-3) and with an int8
   pool (atol 1e-2: a float32 difference upstream can flip one int8 value
   by one step); identical greedy tokens either way. A third float32 run
   has the fast schedules on (multi-step, compact, speculative verify and
   mixed-wave launches each > 0 on the card). The card runs count the
   launches of the CUDA-core chunk body (float32 queries).

6. Tiers: Llama-3-8B at full width on an 8192-slot pool with a pinned
   32768-slot host tier, the async KV-movement plane and a disk tier in a
   temporary directory, with a bf16 pool and then an int8 pool. A
   3000-token prompt served alone as a miss, as a device hit (twice: the
   first warms the dense path at that prefix), as a host hit
   after three other 3000-token prompts evicted it, and as a disk hit on a
   new ``Engine`` over the same directory after ``drain_flush_hot`` and
   ``drain_flush_disk`` (cold-cell resurrection): its pages (int8: payload
   and scales) bit-equal after the host and the disk restore to what they
   were before eviction, and the same greedy tokens from the device, host
   and disk hits. A second host restore while a 1000-token request
   decodes: decode steps are taken while it is parked in ``RESTORING``,
   and their wall is printed beside the same batch's steps with no restore
   in flight. Rates: a 3008-token write-back (gather, copy to the pinned
   arena) and restore (arena → pinned ring → copy stream → scatter) in
   GB/s beside a plain pinned ``copy_`` of the same bytes each way, and
   the gather's and the scatter's device time. Then ``launch.py serve``
   with ``--host-cache-slots``, ``--kv-transfer-async`` and
   ``--kv-tier-dir`` (bf16, and ``--kv-quant int8``; each in a child
   process, the two started together) must start,
   answer ``/generate`` (the repeat a cache hit) and report the tiers in
   ``/stats``. The decode and chunk
   kernels' launches are counted, and no plain attention version may run.
   The float32 whole path (phase 5) gains a run with a host tier and the
   async plane, card vs CPU.
7. GQA groups that are not powers of two: every kernel at G 3 (Hq 24 over
   Hkv 8, llama3.2-3b) and G 7 (Hq 28 over Hkv 4, Qwen2-7B) against its
   plain version with phase 2's tolerances, row check and planted faults:
   decode and pool at B=8 ragged, the tensor-core chunk body at C = 512,
   verify C = 5 and mixed C = 16 (bf16 and int8 pools), the CUDA-core body
   at the same three shapes (float32 and int8 pools, timed, with the
   planted faults); the tensor-core body at G 4 and G 8 over 4 kv heads is
   timed beside G 7 per query row (at G 3 and 7 a CTA's 128 rows are not
   all live, and every tile takes the masked path).
8. Qwen2-7B at full width and depth (28 layers, random bf16 weights with
   planted QKV biases) served over HTTP as in phase 3 with a bf16 pool,
   then the pool kernel over its pages: the decode and chunk kernels run at
   G 7 and no plain attention version.
9. An HF checkpoint: Qwen2-7B at full width and 2 layers written by the
   port's ``save_hf_state_dict`` in 256 MiB shards with an index, read
   back by ``load_hf_checkpoint``: params bit-equal, the same greedy tokens.
10. ``launch.py serve --model llama3.2-3b --weights DIR --tokenizer byte``
   over a full llama3.2-3b checkpoint the port writes: a ``text`` request
   answered with ``text``, its repeat a prefix hit, and ``/stats`` showing
   the decode and chunk kernels launched (G 3) and no plain call. It runs
   beside phase 15's ``serve --weight-quant int8``.
11. A 2-layer float32 Qwen2-7B (planted biases) through the ``Engine`` on
   the card and on the CPU, as phase 5: the same greedy tokens, the decode
   kernel and the CUDA-core chunk body at G 7.
12. Seeded replay, resume admission and the observability planes. In
   phase 5's configuration (2-layer float32): a seeded stochastic stream
   resumed on new card engines at crash points 1 and 5 must continue
   token for token, and greedy seeded rows must give the CPU's tokens.
   Decode-step walls (4 rows of 600 tokens, the median of three 8-step
   windows, one round): unseeded with every plane off, at the defaults
   (the token timeline), with every plane on, and seeded. Llama-3-8B bf16
   over HTTP with the planes on: 4 seeded requests at once (temperature
   0.9, top-p 0.95), each seed alone twice (the same tokens), each resumed
   at crash points 1 and 5 (the share of continuations equal to the alone
   run's is printed, not asserted), one ``/profile`` window whose Chrome
   trace must name the decode and chunk kernels, ``/metrics`` counters
   equal to ``/stats``, ``/debug/tokens`` gaps, and the MFU reading over
   the card's peak.
13. The serving edge: Llama-3-8B bf16 at full depth on a 65536-slot pool
   behind the frontend as ``serve --slo --slo-tenant a=3 --slo-tenant b=1
   --slo-tenant c=1:2000 --blackbox-dir D`` builds it (the history at
   1.0 s). SSE under the legacy schedule, multi-step k = 4 and spec
   gamma = 4, each in its own engine: four 600-token greedy prompts, each
   streamed alone (a prefix miss), then sent twice at once, streamed and
   not, dispatched into one batch (the same tokens, asserted), with the
   first-event delay (client receipt of the first ``data:`` event less
   the engine's ``first_token_time``) and the inter-event gaps. Light
   load, one request at a time: TTFT and decode step wall through the
   plain runner and through ``SLORunner`` in interleaved rounds.
   Overload (spec gamma = 4): a calibration wave of 8 x 2000-token
   prompts (and, on a second frontend, the same 8 one at a time), then a
   burst of 24 + 24 deadline prompts (tenants a and b,
   1500 ms TTFT) and 16 without a deadline: the EWMA prefill rate (first
   fold and steady), admitted and shed by tenant and reason with their
   HTTP codes and ``Retry-After``, the share of admitted deadline requests
   within 1500 ms, the tiers reached with spec decode off at tier >= 1 and
   back after the hold, requests dispatched at tier >= 2 capped at 64
   tokens; tenant c's burst shed with 429 and ``Retry-After``;
   ``/debug/timeseries`` serving the engine's series and ``POST
   /admin/blackbox`` a dump ``load_blackbox`` reads. Decode step wall (the
   median of three 8-step windows) with the history off, sampling at 1.0 s
   and at 0.1 s (interleaved), and the
   sampler's ``radixmesh_history_sample_seconds`` p50 / p99. The decode
   and chunk kernels' launches are counted and no plain attention version
   may run. Last, ``launch.py serve --blackbox-dir D`` in a child process,
   traffic, ``kill -9``: every completed segment loads, the newest sample
   is at most 2 intervals older than the kill, and no final exists. The
   port's ``entry()`` runs on the card first (finite logits).
14. The disaggregated handoff: Llama-3-8B bf16 at full depth (phase 3's
   weights), a ``PrefillWorker`` and a ``DecodeWorker`` with their own
   32768-slot pools, 8 ragged prompts of 500–3000 tokens, 32 greedy tokens,
   over four transports, each with fresh workers: direct ``submit``, an
   ``InprocCommunicator`` (whole packets, decode side staged in blocks of 8
   layers), a ``PyTcpCommunicator`` on loopback streamed through the KV
   plane's handoff lane in packets of at most 120 tokens (under the 16 MiB
   frame limit), and ``device_kv=True``. For every transport the decode
   pool's KV at each request's slots is bit-equal (int16 patterns) to the
   prefill pool's ``gather_raw`` of it, every transport gives the same
   tokens, the chunk kernel ran once per layer per prefill chunk on the
   prefill worker and the decode kernel never, the decode kernel once per
   layer per decode pass on the decode worker, and no plain version. Printed:
   per-stage walls and GB/s, the decode side's TTFT, decode tokens/s per
   request and the share of tokens equal to a collocated engine's. A
   tail-only handoff (``skip_prefix`` from ``cached_prefix_len``), an int8
   sender into an int8 receiver (ints and scales bit-equal) and into a
   bf16 receiver (the dequantized values), and a 2-layer float32 leg
   (disaggregated equals collocated on the card, card equals CPU).
15. W8A16 weights: Llama-3-8B quantized on the card (resident bytes bf16
   against int8, the quantize peak); decode step 4 x 600 and prefill step 8
   x 2000 walls, bf16 against W8A16 in one kept round after a warm-up;
   first-token logits and 32 greedy tokens against bf16 (printed); a
   2-layer float32 W8A16 engine's tokens equal card against CPU; and
   ``launch.py serve --weight-quant int8`` answering ``/generate``. The
   W8A16 runs' decode and chunk launches are counted.
16. The LM head and the cache mesh. The head of a decode step
   (``Llama._logits`` at B = 4 and 8) with its float32-output product
   against the bf16 product widened afterwards: device time, the logits'
   difference (off the bf16 grid), and the greedy tokens of four bf16
   requests served with each. Then Llama-3-8B bf16 at full width (phase
   3's weights) as two engines on the card, p0 (prefill) and d0 (decode),
   each with its own 65536-slot pool and an advertisement-only
   ``MeshCache`` replica, and a router replica r0 with
   ``CacheAwareRouter``, all three in this process, mesh page 16. (a) On
   each transport (``inproc``, native ``tcp`` on localhost, ``tcp-py``):
   8 prompts of 2000 tokens served on p0; the lag from the end of p0's
   publish to r0 attributing each prompt to p0; the 8 prompts plus 64 new
   tokens each routed by r0 to p0 as hits of at least 2000 tokens and
   served there alone, then served alone on d0 as misses: TTFT of each,
   ``cached_tokens``, the share of equal greedy tokens; the decode and
   chunk kernels must run on both engines and no plain version. A 2-layer
   float32 leg (inproc) must give equal hit and miss tokens. (b) While the
   kernels build (phase 1), p0, d0
   and r0 in three processes, over native ``tcp`` and ``tcp-py``: p0
   advertises 800 prefixes of 2000 tokens (1.6M tokens): inserts applied
   per second at r0 and d0, bytes per insert, apply lag, r0's
   ``match_prefix`` time and each replica's RSS growth. (c) The decode
   step wall of 4 x 600 on p0 with the mesh on (d0 advertising 50
   prefixes a second) and off, one round, the median of three 8-step
   windows each, over native ``tcp`` and ``tcp-py``. (d)
   After the weights are freed, two ``python
   -m radixmesh_tpu_torch.launch node`` processes (prefill and decode, a
   16384-slot pool each) over native ``tcp`` from JSON configs with
   ``--fleet-digest-interval 0.5``: ``POST /generate`` to the prefill
   node, then the decode node's ``radixmesh_mesh_oplogs_received_total``
   must rise and its ``/cluster/telemetry`` must hold the prefill node's
   digest with the prefill node's own fingerprint.
17. The fleet (``fleet_leg``): four ``launch.py node`` processes over
   native ``tcp`` — routers r0 and r1 (model-less, ``POST /route``) and
   Llama-3-8B serving nodes p0 and d0 (random bf16 weights, 32768 slots,
   ``max_batch`` 4) — with ``--fleet-digest-interval 0.5 --repair-interval
   1.0 --drain-timeout 30``; the client here is a ``RouterFrontDoor`` over
   both routers and a ``RecoveryCoordinator`` over streamed ``/generate``.
   First d0's decode step with the repair plane armed, on its fresh
   process. (a) 8 miss prompts of 2000 tokens served where routed, then
   each plus 64 tokens routed back as a p0 hit and served with 2000 cached
   tokens (``/route`` p50/p99, hit and miss TTFT). (b) ``kill -9`` r0
   between two routes: the front door fails over to r1 and loses none
   (failover wall, ``radixmesh_frontdoor_*_total``); r0 restarts
   meanwhile. (c) 4 greedy requests of 600 + 128 tokens on p0, ``kill -9``
   p0 once each delivered 8: all finish on d0 with ``resumed_from`` = k and
   nothing re-emitted (recovery seconds, and the share equal to an
   undisturbed run that is a prefix hit on p0 as they are: a bf16
   reading). (d) p0 restarts from its config: BOOTSTRAPPING → ACTIVE from
   donor d0, the routers' withheld hits rise meanwhile, the fingerprints
   agree, and p0's prefix routes to p0 again. (e) ``POST /admin/drain`` to
   d0 while 4 requests decode: they finish, 4 arrivals get 503 with the
   router and no ``Retry-After`` (the plain runner's answer, as in the JAX
   package), the routers see DRAINING then drop d0, and SIGTERM exits 0
   within the drain timeout. Last d0's decode step unarmed, on a fresh d0
   process started without the repair plane. p0's and d0's ``/stats`` must
   show the decode and chunk kernels and no plain version. (f) Fleet
   diagnosis: both routers run with ``--agg-interval 0.5`` and r1 with a
   black box. After (a), r1's ``/cluster/timeseries`` holds series of
   prefill0 and decode1 (the topology's names), the growth of its merged
   TTFT buckets over (a) counts (a)'s 16 requests and puts its p50 in the
   bucket that holds the client's own p50; ``/cluster/slo``'s fleet p50 and
   p99 are printed beside the client's, with the aggregator's stats. After
   the ``kill -9`` of p0 in (c), r1's ``/cluster/doctor`` must name
   ``telemetry_gap`` for prefill0 with the dead-node verdict before p0
   restarts (seconds from the kill), and the finding must clear within 10
   pull intervals of p0's ACTIVE. After (d), d0's doctor runs the engine
   rules with none crashed, r1's flushed black box holds a ``doctor``
   section, and ``python -m radixmesh_tpu_torch.doctor --blackbox --json``
   over it exits 0 or 1 (its findings printed).
18. Tensor- and sequence-parallel serving, the ranks as processes on the
   one card over gloo (NCCL refuses two ranks on one device; gloo's
   collectives move through host memory). (a) In this process, B1, B2
   (both bodies) and B3 at a tp = 2 rank's head counts, Llama-3-8B (Hq 16,
   Hkv 4) and Qwen2-7B (Hq 14, Hkv 2, G 7), against their plain versions
   with phase 2's limits, timed. (b) Two ranks (this script with
   ``--parallel-rank``), each drawing phase 3's weights (seed 0) layer by
   layer and keeping its tp shard: Llama-3-8B at full width, 8 layers deep
   (``PAR["layers"]``), bf16, through the unchanged ``Engine`` with
   ``device_mesh`` — a bf16 pool, an int8 pool, the fast schedules
   (``SCHEDULES``), W8A16 weights with an int8 pool; each leg four prompts
   (the two long ones one chunk-kernel group) and a prefix hit (cached >=
   the shared prefix), the decode (B1) and chunk (B2) launches counted per
   rank, and B3 through its sharded wrapper over the hit's pages. The
   ranks' tokens and stats must be equal; the bf16 and int8 legs'
   first-token and first-decode-step logit rows are held row by row
   against a single-device engine on the same weights (``ROW_RTOL``), and
   4 layers of the same widths in float32 must give the single device's
   greedy tokens. (c) sp = 2, the whole model on each rank: a fresh
   8192-token prompt prefilled with ring attention across the ranks; its
   last-position logits and the pool's K/V at layers 0, 4 and 7 against
   the single-device chunked prefill (``ROW_RTOL``), TTFT beside TTFT. (d)
   The nccl backend at world size 1: ``init_multihost``, one all-reduce,
   one greedy generate on the mesh equal to the engine's without it. (e)
   pp = 2 in the same two ranks, each one pipeline stage (4 of the 8
   layers, drawn from the same seed layer by layer) behind the unchanged
   ``Engine``: a bf16 pool, an int8 pool, ``decode_steps_per_launch`` = 4
   (``pp_decode_multi``) and speculative decode (verify through
   ``pp_forward_chunk``), each leg (b)'s script; the ranks' tokens and stats
   equal, B1 and B2 launched inside the stages, the bf16 and int8 legs'
   logit rows held against the single device (``ROW_RTOL``), 4 layers in
   float32 equal to the single device's greedy tokens; each leg's p2p
   calls, seconds and bytes printed. (f) ``IciHandoff`` between the two
   ranks over gloo: rank 0 a ``PrefillWorker`` with ``device_kv=True``,
   rank 1 a ``DecodeWorker``; the moved block bit-equal to the source's
   (bf16, and int8 with its scales), the tokens equal to a collocated
   engine's, the bytes and rate (gloo's host bounce) printed. (a) also
   times B1 and B2 at a pp stage's microbatch (4 of phase 2's 8 rows).
   (g) The KV tiers on the two ranks, at tp = 2 and at pp = 2, bf16 and
   int8 (``PAR["g"]``: 200-token prompts a, b, a in a pool that holds one):
   the host tier, host + disk and host + plane, each run's first-token
   rows and tokens bit-equal to the same mesh without tiers (where the
   second a is a device hit), the hicache and disk counters > 0 and equal
   on both ranks, B1 and B2 launched on every rank; the restore, write-back
   and spill GB/s and the step agreement's calls a pass printed. A
   ``PrefillWorker`` on each mesh: the leader's packet slices equal each
   rank's pool shard, and this process decodes the packet on one device
   (first decode row against the single device's own, ``ROW_RTOL``); a
   single-device packet decoded by a tp = 2 ``DecodeWorker``. A pool-bound
   ``MeshCache`` replica on the leader, in a native tcp ring with one in
   this process: both hold each other's prefix, a free through the
   replica's proxy lands on both ranks, and both ranks' slots balance.
   (h) Training and checkpoints on the two ranks, (a)–(g) freed
   (``TRAIN``): two AdamW steps of Llama-3-8B's widths, 2 layers, bf16,
   2 x 513 tokens on each of tp = 2, sp = 2, dp = 2 and pp = 2 (two
   microbatches): the losses and global gradient norms equal on both ranks
   and held against phase 19's step 1 (loss within 5e-3, norm within 2 %),
   the replicated leaves' fingerprints equal on both ranks; a
   ``save_params`` checkpoint of the whole tree loaded with
   ``load_params(mesh=)`` bit-equal to ``shard_params`` on tp = 2 and pp =
   2; a pp engine's tree snapshot (``save_tree(..., mesh=)``) restored into
   a fresh pp engine on both ranks: the prompt grown by two tokens hits,
   the prompt replays its tokens.
   (b)–(h) start beside Qwen2-7B serving (phase 8), the checkpoint round
   trip and the whole-path checks; each rank's readings land in
   ``chip_out/par-*.json`` and ``.log``.
19. Training and checkpoints on one device, after phase 18 (``TRAIN``):
   three AdamW steps of Llama-3-8B's widths, 2 layers, bf16, 2 x 513
   tokens: finite losses, the third below the first, no B1, B2 or B3 launch
   (training attends with the plain attention), the LM head's bf16
   product's backward through ``_MmF32``; step wall, tokens/s, the card's
   peak memory and an analytic MFU printed. ``tiny()`` in float32: one SGD
   step on the card equal to the CPU's within 1e-5 (loss, every leaf).
   ``save_params`` / ``load_params`` of the trained tree bit-equal, write
   and read GB/s. (c), before phase 16 frees phase 3's serving model: a
   256-token prompt served, ``save_tree`` / ``load_tree`` with the pool
   into a second engine over the same weights: a hit of at least 240
   tokens, the same greedy continuation.
20. The engine-driven workloads (``radixmesh_tpu_torch/workload.py``,
   ``WL``). (a) and (b) on phase 3's model before phase 16 frees it, one
   engine (page 16, 65536 slots, 16 rows): (a) the north-star multi-turn
   traffic (16 conversations x 4 turns, a 1024-token system prompt, 64-token
   turns, 32 new tokens) through ``run_engine_workload``: hit rate >= 0.70
   and <= the ceiling + 0.02, TTFT p50 and p99 printed; (b) open-loop
   overload across two tenants through an ``SLORunner`` over the same
   engine (1024-token prompts, half shared, 16 new; offered at twice the
   prompt-token capacity a 2 s deadline-free run measures, a TTFT deadline
   of ten times the unloaded TTFT, 4 s of arrivals): every arrival
   admitted, shed or timed out, none timed out. (d)-(h) while phase 18
   (h)'s ranks train, each through its command line in this process
   (``radixmesh_tpu_torch/scripts/``: ``specbench``, ``convoybench``,
   ``kvflowbench``, ``tierbench``; ``python -m radixmesh_tpu_torch.doctor
   --workload``), at their default Llama-3-8B widths, 2 layers, each
   writing ``chip_out/<KIND>_torch.json``, read back and held to its
   schema (``reports.validate_<kind>``): (d) speculative
   decoding (drafts conserved, the seeded stall found), (e) the prefill
   convoy in float32 (both arms' tokens equal, the carrier's starvation
   bounded, the small-batch dispatch, B3 in the crossover sweep at D 64
   within 1e-4 of the dense leg in float32), (f) the
   async KV plane (decode steps while a restore is parked, none without the
   plane, one gather per write-back sweep, every restore parked), (g) the
   disk tier (extents in a temporary directory, removed: resumed streams
   byte-identical, both corrupt extents detected and none served), (h) the
   mesh doctor (no finding when healthy; hot shard, prefill convoy and
   parked restore lane each named with the seeded evidence; the
   attributor's sums exact; the benchdiff sentinel's self-check proven).
   Then the HTTP soak (``scripts.soak``, ``WL["soak_s"]`` seconds of
   multi-turn clients at the same widths): no failed request, B1 and B2
   launched. Each leg's B1, B2 and B3 launches; no plain version runs.
21. The mesh-only and fleet workloads (``workload.py``, ``FLEET_WL``). (i)
   fleet churn (digest fan-in, convergence under churn and after an
   injected divergence, a stalled node demoted) and (j) chaos, sharded (rf
   2), with its four phases (loss and a partition repaired, a drain and a
   cold rejoin, a decode node killed mid-stream, a rebalance under a zipf
   storm, a router killed) run in a child process of this script that
   never touches the card, started with phase 18's ranks and joined with
   them ((i) through ``scripts.fleetbench``; (j) at reduced sizes the JAX
   script's flags cannot express, its report built by ``reports.py``):
   no request lost or failed, every stream resumed byte-identical
   from a replicated cache (hit ratio >= 0.8), the storm's skew dropped.
   (k) the observability scenario with its step-attribution engine, (l)
   the black box and (m) the fleet aggregator, each with an engine at
   Llama-3-8B's widths, 2 layers, bf16, in a second child process started
   with phase 18's ranks, which waits for (h)'s gate and runs beside (d)-(h)
   while the ranks train: the stitched trace on >= 3 node tracks, the hot shard named from
   gossip and by the post-mortem from the dumps, the victim's drop (its
   window holding the kill) and truncation named, the straggler by rank,
   the p99 exemplar stitched to the straggler's span, the killed node as
   a gap; each through its command line (``obsbench``, ``blackboxbench``,
   ``aggbench``). (k)'s three short prompts each prefill alone, on the
   engine's dense route as in the JAX engine: (k) launches B1, (l) and (m)
   B1 and B2; no plain version runs. Every report of phases 20 and 21
   passes its validator but for the verdicts that read the wall clock
   (BLACKBOX's sampler and AGG's pull overhead budgets, SPEC's adaptive
   goodput ratio), which are printed; the command line's exit code is the
   validator's; and the port's benchdiff compares each report with itself
   clean (exit 0).
Checkpoints and profiles are written under ``chip_out/`` and removed.

Prints a ``{"kernels": [...]}`` line (each kernel's launches per path in
``launches_by_path``, their sum in ``launches``, the fast schedules'
shapes in ``other_shapes``; the entries named ``... G=7`` and ``... G=3``
are the kernels at those groups, launched by phases 8, 10 and 11), the
card line, and last
``{"ok": true, "device": {...}}``. Details go to ``chip_out/``.
Exits 2 without printing a result where torch has no CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import gc
import importlib
import json
import math
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts import _cli
from radixmesh_tpu_torch.cache.kv_transfer import kv_token_bytes
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.models import get_config
from radixmesh_tpu_torch.models.convert import hf_state_dict
from radixmesh_tpu_torch.models.hf_io import load_hf_checkpoint, save_hf_state_dict
from radixmesh_tpu_torch.models.llama import Llama, init_params
from radixmesh_tpu_torch.ops import _build
from radixmesh_tpu_torch.ops import paged_attention as pa
from radixmesh_tpu_torch.ops.attention import paged_attention_pool_bucketed
from radixmesh_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend
from radixmesh_tpu_torch.utils.cuda_timing import bound, dense_context, kv_bytes, sdpa_inputs, time_ms

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_out"
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 outputs are also held row by row (one query head's D values):
# ||got - want|| <= ROW_RTOL ||want||, a limit that scales with outputs of
# a few hundredths at long contexts, where 2e-2 is about a typical value.
# P rounded to bf16 for the P.V products moves an output by up to 2^-8 of
# the attended |v|, which where few keys cancel exceeds any per-element
# limit relative to the output; per row it stays under 1 %.
ROW_RTOL = 2e-2
HQ, HKV, D, PAGE, LAYERS = 32, 8, 128, 16, 2
# Live windows per row of the verify (C = 5) and mixed-wave (C = 16) chunk
# cases over the ragged priors [0, 16, 300, 1000, 1777, 2500, 3000, 3500]:
# row 3 is all padding (kv_lengths = prior).
VERIFY_FILL = [1, 3, 5, 0, 5, 3, 1, 5]
MIXED_FILL = [16, 1, 3, 0, 5, 16, 5, 3]
# Decode over a compact working set: 14 pages of rows and a scratch and a
# NaN page make a 16-page pool (two rows inactive).
COMPACT_LENGTHS = [1, 17, 33, 40, 5, 60, 0, 0]
# The serving path's own shapes (``serve_profile``'s 4 x 600 and 8 x 2000
# cells): decode over the engine's power-of-two page-table buckets (64 and
# 128 pages), and the 8 x 2000 prefill's chunks of 512 at priors 0, 512,
# 1024 and 1536 (the last chunk 464 tokens).
DECODE_4X600 = [601, 606, 611, 616]
DECODE_8X2000 = [2001, 2003, 2005, 2007, 2009, 2011, 2013, 2015]
PREFILL_8X2000 = ((0, 512), (512, 512), (1024, 512), (1536, 464))
# The fast schedules' flags for the whole-path and serving checks.
SCHEDULES = dict(spec_decode_tokens=4, prefill_inline_budget=64, decode_steps_per_launch=4,
                 paged_min_batch=2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def _dtype_name(dtype, quant) -> str:
    return "int8" if quant else str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pool_and_tables(rng, row_tokens, maxp, dtype, dev, quant=False, hkv=HKV, page=PAGE):
    """A random 2-layer pool with disjoint, permuted pages per row. Returns
    (kv_pages, kv_scales or None, page_table, scratch_page, nan_page);
    page-table pads point at the NaN page, and every slot of a row's last
    page at or past ``row_tokens[b]`` is NaN — in the K/V for bf16/f32
    pools, in the scales for int8 pools (whose payload has no NaN)."""
    need = [-(-max(int(n), 0) // page) for n in row_tokens]
    P = sum(need) + 2
    perm = rng.permutation(P)
    scratch_page, nan_page = int(perm[0]), int(perm[1])
    kv = torch.randn(2, LAYERS, hkv, P, page, D, generator=torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    scales = None
    if quant:
        kv, scales = quantize_kv(kv)
        kv, scales = kv.to(dev), scales.to(dev)
        poison = scales
    else:
        kv = kv.to(dtype=dtype, device=dev)
        poison = kv
    poison[:, :, :, nan_page] = float("nan")
    pt = np.full((len(row_tokens), maxp), nan_page, np.int32)
    nxt = 2
    for b, n in enumerate(row_tokens):
        pt[b, : need[b]] = perm[nxt : nxt + need[b]]
        nxt += need[b]
        if need[b] == 0:
            pt[b, 0] = scratch_page
        elif n % page:
            poison[:, :, :, int(pt[b, need[b] - 1]), n % page :] = float("nan")
    return kv, scales, torch.as_tensor(pt, device=dev), scratch_page, nan_page


def _row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over rows of the last axis (a
    zero row of ``want`` must come back zero)."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / (want.norm(dim=-1) + 1e-6)).max().item()


def _check_close(name, got, want, dtype) -> dict:
    """Hold a kernel's output to its plain version: atol ATOL[dtype], and
    for bf16 outputs the row limit ROW_RTOL too. Returns the readings."""
    err = (got.float() - want.float()).abs().max().item()
    check(err <= ATOL[dtype], f"{name}: max |kernel - plain| = {err} > {ATOL[dtype]}")
    res = {"max_abs_err": err}
    if dtype == torch.bfloat16:
        res["row_rel_err"] = _row_rel_err(got, want)
        check(res["row_rel_err"] <= ROW_RTOL, f"{name}: a row's ||kernel - plain|| is "
              f"{res['row_rel_err']} of ||plain|| > {ROW_RTOL}")
    return res


def _equal(a, b):
    eq = a == b
    if a.is_floating_point():
        eq |= a.isnan() & b.isnan()
    return eq


def decode_case(name, lengths, dtype, dev, timed, seed, quant=False, maxp=256, pool_pages=None,
                heads=(HQ, HKV), page=PAGE, readings=1):
    hq, hkv = heads
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    B, layer = len(lengths), 1
    # Pool tokens per row: the context before the current token plus the
    # current token's own slot (it lands in the row's pages).
    kv, sc, pt, scratch_page, _ = _pool_and_tables(rng, np.maximum(lengths, 0), maxp, dtype, dev, quant, hkv,
                                                   page)
    check(pool_pages is None or kv.shape[3] == pool_pages, f"{name}: pool of {kv.shape[3]} pages")
    pos = np.maximum(lengths - 1, 0)
    pt_np = pt.cpu().numpy()
    slots = pt_np[np.arange(B), pos // page] * page + pos % page
    scratch_slot = scratch_page * page
    slots = np.where(lengths <= 1, scratch_slot, slots).astype(np.int32)
    pt_np[lengths <= 1] = scratch_page
    pt = torch.as_tensor(pt_np, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, hq, D, generator=g, device=dev).to(dtype)
    k_new = torch.randn(B, hkv, D, generator=g, device=dev).to(dtype)
    v_new = torch.randn(B, hkv, D, generator=g, device=dev).to(dtype)
    sl, ln = torch.as_tensor(slots, device=dev), torch.as_tensor(lengths, device=dev)

    kv_p, kv_k = kv.clone(), kv.clone()
    sc_p, sc_k = (None, None) if sc is None else (sc.clone(), sc.clone())
    want = pa.paged_decode_fused_plain(q, k_new, v_new, kv_p, sl, pt, ln, layer, sc_p)
    got = pa.paged_decode_fused_kernel(q, k_new, v_new, kv_k, sl, pt, ln, layer, sc_k)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    close = _check_close(name, got, want, dtype)
    zero_rows = torch.as_tensor(lengths == 0, device=dev)
    check(torch.count_nonzero(got[zero_rows]).item() == 0, f"{name}: length-0 rows must output zeros")
    # Pool (and scales): bit-equal everywhere but the scratch page, whose
    # slot holds, element by element, a value one of the racing writers
    # wrote — payload and scale each on its own, for they are two writes.
    pairs = [("payload", kv_k, kv_p)] + ([] if sc is None else [("scales", sc_k, sc_p)])
    for what, a, b in pairs:
        same = _equal(a, b)
        same[:, :, :, scratch_page] = True
        check(bool(same.all()), f"{name}: pool {what} differ from the plain version after the write")
    writers = np.nonzero(lengths == 1)[0]
    if len(writers):
        for which, new in ((0, k_new), (1, v_new)):
            held = {"payload": kv_k[which, layer, :, scratch_page, 0]}
            if sc is None:
                wrote = {"payload": [new[w] for w in writers]}
            else:
                qs = [quantize_kv(new[w]) for w in writers]
                wrote = {"payload": [x for x, _ in qs], "scale": [s for _, s in qs]}
                held["scale"] = sc_k[which, layer, :, scratch_page, 0]
            for what, values in wrote.items():
                hit = torch.stack([held[what] == x for x in values]).any(dim=0)
                check(bool(hit.all()), f"{name}: scratch slot {what} holds a value no writer wrote")
    res = {"case": name, "dtype": _dtype_name(dtype, quant), "q_dtype": str(dtype),
           "splits": pa.decode_splits(maxp * page, B * hkv, pa.sm_count(dev))[0],
           "pool_pages": int(kv.shape[3]), **close}
    if timed:
        es = q.element_size()
        live = lengths > 0
        ctx = np.maximum(lengths - 1, 0)
        nbytes = (
            2 * q.numel() * es + 2 * k_new.numel() * es  # q, out; k_new, v_new
            + kv_bytes(int(live.sum()), kv, quant)  # the rows written
            + kv_bytes(int(ctx.sum()), kv, quant)  # K/V pages read
            + 4 * int(np.sum(-(-ctx // page))) + 8 * B  # page table, slots, lengths
        )
        flops = 4 * hq * D * int(lengths[live].sum())
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
        # ``readings`` medians of 20 calls each; ``ms`` is their median.
        ms = [time_ms(lambda: pa.paged_decode_fused_kernel(q, k_new, v_new, kv_k, sl, pt, ln, layer, sc_k), 20)
              for _ in range(readings)]
        res["ms"] = sorted(ms)[len(ms) // 2]
        if readings > 1:
            res["ms_readings"] = ms
        res["shape"] = f"B={B} Hq={hq} Hkv={hkv} D={D} page={page} maxp={maxp} lengths={lengths.tolist()}"
        res["plain_ms"] = time_ms(lambda: pa.paged_decode_fused_plain(q, k_new, v_new, kv_p, sl, pt, ln, layer, sc_p), 5)
        # Library yardstick: SDPA over the gathered dense context (+ the
        # current token), heads expanded to Hq; length-0 rows see key 0.
        kd, vd = dense_context(kv_k, sc_k, pt, layer, ctx, int(lengths.max()), dtype)
        mask = torch.zeros(B, 1, 1, kd.shape[1], dtype=torch.bool, device=dev)
        for b in range(B):
            if lengths[b] > 0:
                kd[b, ctx[b]], vd[b, ctx[b]] = k_new[b], v_new[b]
            mask[b, 0, 0, : max(int(lengths[b]), 1)] = True
        kx, vx = sdpa_inputs(kd, vd, hq // hkv)
        qx = q[:, :, None, :]
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask), 20)
        lib = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask)[:, :, 0]
        res["library_max_abs_diff"] = (lib.float() - want.float())[torch.as_tensor(live, device=dev)].abs().max().item()
    return res


def pool_case(name, lengths, dtype, dev, timed, seed, quant=False, maxp=256, heads=(HQ, HKV), page=PAGE):
    hq, hkv = heads
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    B, layer = len(lengths), 1
    kv, sc, pt, _, _ = _pool_and_tables(rng, np.maximum(lengths, 0), maxp, dtype, dev, quant, hkv, page)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, hq, D, generator=g, device=dev).to(dtype)
    ln = torch.as_tensor(lengths, device=dev)
    kv_before = kv.clone()
    want = pa.paged_attention_pool_plain(q, kv, pt, ln, layer, sc)
    got = pa.paged_attention_pool_kernel(q, kv, pt, ln, layer, sc)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    close = _check_close(name, got, want, dtype)
    zero_rows = torch.as_tensor(lengths <= 0, device=dev)
    check(torch.count_nonzero(got[zero_rows]).item() == 0, f"{name}: length-0 rows must output zeros")
    check(bool(_equal(kv, kv_before).all()), f"{name}: the read-only kernel changed the pool")
    res = {"case": name, "dtype": _dtype_name(dtype, quant), "q_dtype": str(dtype),
           "splits": pa.decode_splits(maxp * page, B * hkv, pa.sm_count(dev))[0], **close}
    if timed:
        es = q.element_size()
        n = np.maximum(lengths, 0)
        nbytes = (2 * q.numel() * es + kv_bytes(int(n.sum()), kv, quant)
                  + 4 * int(np.sum(-(-n // page))) + 4 * B)
        flops = 4 * hq * D * int(n.sum())
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
        res["ms"] = time_ms(lambda: pa.paged_attention_pool_kernel(q, kv, pt, ln, layer, sc), 20)
        res["shape"] = f"B={B} Hq={hq} Hkv={hkv} D={D} page={page} maxp={maxp} lengths={lengths.tolist()}"
        res["plain_ms"] = time_ms(lambda: pa.paged_attention_pool_plain(q, kv, pt, ln, layer, sc), 5)
        kd, vd = dense_context(kv, sc, pt, layer, n, int(n.max()), dtype)
        mask = torch.zeros(B, 1, 1, kd.shape[1], dtype=torch.bool, device=dev)
        for b in range(B):
            mask[b, 0, 0, : max(int(n[b]), 1)] = True
        kx, vx = sdpa_inputs(kd, vd, hq // hkv)
        qx = q[:, :, None, :]
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask), 20)
    return res


def chunk_case(name, prior, n_dense, dtype, dev, timed, seed, C=512, quant=False, faults=None,
               heads=(HQ, HKV), page=PAGE):
    hq, hkv = heads
    rng = np.random.default_rng(seed)
    prior = np.asarray(prior, np.int32)
    n_dense = np.asarray(n_dense, np.int32)
    B, layer = len(prior), 1
    maxp = 1 << int(math.ceil(math.log2(max(32, -(-int((prior + C).max()) // page)))))
    kv, sc, pt, scratch_page, _ = _pool_and_tables(rng, prior, maxp, dtype, dev, quant, hkv, page)
    g = torch.Generator(device=dev).manual_seed(seed)
    # int8 pools take the chunk's K/V already dequantized, in float32.
    cur_dtype = torch.float32 if quant else dtype
    q = torch.randn(B, C, hq, D, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, C, hkv, D, generator=g, device=dev).to(cur_dtype)
    vc = torch.randn(B, C, hkv, D, generator=g, device=dev).to(cur_dtype)
    pr = torch.as_tensor(prior, device=dev)
    kl = torch.as_tensor(prior + n_dense, device=dev)
    want = pa.paged_chunk_attention_plain(q, kc, vc, kv, pt, pr, kl, layer, sc)
    got = pa.paged_chunk_attention_kernel(q, kc, vc, kv, pt, pr, kl, layer, sc)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    res = {"case": name, "dtype": _dtype_name(dtype, quant), "q_dtype": str(dtype),
           "body": "tensor cores" if dtype == torch.bfloat16 else "CUDA cores",
           **_check_close(name, got, want, dtype)}
    # The query block of the body that ran.
    res["cblk"] = (pa.chunk_tc_query_block(C, hq // hkv) if dtype == torch.bfloat16
                   else pa.chunk_query_block(C, hq // hkv, pa.CHUNK_ROWS[dtype]))
    if prior.max() >= 64 and (dtype == torch.bfloat16 or C == 512 or faults):
        res["planted_faults"] = planted_faults(
            name, want, (q, kc, vc, kv, pt, pr, kl, layer, sc), int(np.argmax(prior)),
            int(prior.max()), scratch_page, faults or FAULTS[:3], page)
    if timed:
        es = q.element_size()
        nbytes = (
            2 * q.numel() * es + 2 * kc.numel() * kc.element_size()  # q, out; chunk K/V
            + kv_bytes(int(prior.sum()), kv, quant)  # prior K/V pages read
            + 4 * int(np.sum(-(-prior // page))) + 8 * B
        )
        n = n_dense.astype(np.int64)
        keys = int(np.sum(n * prior + n * (n + 1) // 2))
        flops = 4 * hq * D * keys
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
        res["ms"] = time_ms(lambda: pa.paged_chunk_attention_kernel(q, kc, vc, kv, pt, pr, kl, layer, sc), 10)
        res["shape"] = (f"B={B} C={C} Hq={hq} Hkv={hkv} D={D} page={page} "
                        f"prior={prior.tolist()} chunk_valid={n_dense.tolist()}")
        res["plain_ms"] = time_ms(lambda: pa.paged_chunk_attention_plain(q, kc, vc, kv, pt, pr, kl, layer, sc), 3)
        # Library yardstick: SDPA over [prior context ++ chunk], one bool
        # mask carrying the prior bound, causality and the kv bound.
        ctx = int(prior.max())
        kp, vp = dense_context(kv, sc, pt, layer, prior, ctx, dtype)
        kd = torch.cat([kp[:, :ctx], kc.to(dtype)], dim=1)
        vd = torch.cat([vp[:, :ctx], vc.to(dtype)], dim=1)
        kpos = torch.arange(ctx, device=dev)
        c = torch.arange(C, device=dev)
        prior_ok = (kpos[None, :] < pr[:, None])[:, None, :].expand(B, C, ctx)
        dense_ok = (c[None, None, :] <= c[None, :, None]) & (c[None, None, :] < (kl - pr)[:, None, None])
        mask = torch.cat([prior_ok, dense_ok], dim=2)[:, None]
        kx, vx = sdpa_inputs(kd, vd, hq // hkv)
        qx = q.permute(0, 2, 1, 3).contiguous()
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask), 10)
    return res


FAULTS = ("last prior key skipped", "last 64 prior keys skipped", "one prior page wrong",
          "last prior page wrong")


def planted_faults(name, want, args, b, prior_b, scratch_page, which, page=PAGE) -> dict:
    """The check must tell a wrong chunk body from a right one: faults
    (``which``, of ``FAULTS``) made in the inputs of the row ``b`` with the
    longest prior — its last prior key skipped, its last 64 prior keys
    skipped (one K tile), one page in the middle of its prior or its last
    prior page read from the scratch page — must each fail it: the row
    check for bf16 outputs, max |kernel - plain| <= ATOL for float32 ones.
    Returns each fault's readings."""
    q, kc, vc, kv, pt, pr, kl, layer, sc = args

    def cut(n):
        c = torch.zeros_like(pr)
        c[b] = n
        return c

    def wrong_page(i):
        t = pt.clone()
        t[b, i] = scratch_page
        return t

    faults = {"last prior key skipped": lambda: (pt, pr - cut(1), kl - cut(1)),
              "last 64 prior keys skipped": lambda: (pt, pr - cut(64), kl - cut(64)),
              "one prior page wrong": lambda: (wrong_page(prior_b // page // 2), pr, kl),
              "last prior page wrong": lambda: (wrong_page((prior_b - 1) // page), pr, kl)}
    out = {}
    for fault in which:
        pt_f, pr_f, kl_f = faults[fault]()
        got = pa.paged_chunk_attention_kernel(q, kc, vc, kv, pt_f, pr_f, kl_f, layer, sc)
        rel = _row_rel_err(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if q.dtype == torch.bfloat16:
            check(rel > ROW_RTOL, f"{name}: the row check misses a planted fault ({fault}): "
                  f"row error {rel}")
        else:
            check(err > ATOL[q.dtype], f"{name}: the {ATOL[q.dtype]} check misses a planted "
                  f"fault ({fault}): max |kernel - plain| {err}")
        out[fault] = {"row_rel_err": rel, "max_abs_err": err}
    return out


# Page sizes of phase 2's page cases, and their planted fault.
PAGES = (4, 1, 3, 24, 64)
PAGE_FAULTS = ("last 64 prior keys skipped",)
# The B=8 ragged shapes of the kernel phases: decode and pool lengths,
# chunk priors and live chunk tokens per row (C = 512).
RAGGED = [0, 1, 1, 17, 513, 1500, 3001, 4096]
CHUNK_PRIOR = [0, 16, 300, 1000, 1777, 2500, 3000, 3500]
CHUNK_FILL = [512, 512, 200, 512, 1, 512, 0, 333]


def _runner(results: dict, tag: str):
    def run(kernel, case_fn, *args, **kw):
        r = case_fn(*args, **kw)
        print(f"[{tag}] {kernel}: " + json.dumps(r), flush=True)
        results.setdefault(kernel, []).append(r)
    return run


def kernel_phase(dev) -> dict:
    results: dict[str, list] = {}
    run = _runner(results, "kernel")
    f32, bf16 = torch.float32, torch.bfloat16
    ragged, chunk_prior, chunk_fill = RAGGED, CHUNK_PRIOR, CHUNK_FILL
    short = [0, 1, 17, 33, 48, 64, 5, 60]  # a 4-page table: one split
    # Decode and pool: splits > 1 at B=1 and B=8 over a 256-page table, one
    # split over a 4-page table; float32, bf16 and int8 pools (bf16 and
    # float32 queries for int8).
    for quant, dtypes in ((False, (f32, bf16)), (True, (bf16, f32))):
        sfx = "[int8]" if quant else ""
        for dtype in dtypes:
            tag = (" int8" if quant else "") + (" f32 queries" if quant and dtype == f32 else "")
            timed = dtype == bf16
            run("paged_decode_fused" + sfx, decode_case, "decode B=1" + tag, [4001], dtype, dev,
                timed, 1, quant=quant)
            run("paged_decode_fused" + sfx, decode_case, "decode B=8 ragged" + tag, ragged, dtype,
                dev, timed, 2, quant=quant)
            run("paged_decode_fused" + sfx, decode_case, "decode B=8 one split" + tag, short, dtype,
                dev, False, 3, quant=quant, maxp=4)
            run("paged_attention_pool" + sfx, pool_case, "pool B=1" + tag, [4001], dtype, dev, timed,
                6, quant=quant)
            run("paged_attention_pool" + sfx, pool_case, "pool B=8 ragged" + tag, ragged, dtype, dev,
                timed, 7, quant=quant)
            run("paged_attention_pool" + sfx, pool_case, "pool B=8 one split" + tag, short, dtype,
                dev, False, 8, quant=quant, maxp=4)
    # Chunk: the tensor-core body (bf16 queries; bf16 and int8 pools) and
    # the CUDA-core body (float32 queries; float32 and int8 pools), at
    # C = 512 (prior 0, prior 2500, B=8 ragged) and the engine's small
    # bucket C = 64 with prior > 0.
    for quant in (False, True):
        for dtype in (bf16, f32):
            tag = (" int8" if quant else "") + (" f32 queries" if quant and dtype == f32 else "")
            name = ("paged_chunk_attention" + ("[int8]" if quant else "") if dtype == bf16
                    else "paged_chunk_attention[f32]")
            run(name, chunk_case, "chunk B=1 prior=0" + tag, [0], [512], dtype, dev, False, 3,
                quant=quant)
            run(name, chunk_case, "chunk B=1 prior=2500" + tag, [2500], [512], dtype, dev, True, 4,
                quant=quant)
            run(name, chunk_case, "chunk B=8 ragged" + tag, chunk_prior, chunk_fill, dtype, dev,
                True, 5, quant=quant)
            run(name, chunk_case, "chunk C=64 prior" + tag, [0, 37, 300, 1000], [64, 20, 64, 0],
                dtype, dev, False, 12, C=64, quant=quant)
    # The fast schedules' shapes. Chunk: a γ=4 speculative verify (C = 5,
    # one query per CTA: R = 4 rows of 128) and a mixed wave's floor
    # (C = 16: R = 64), both bodies, bf16, float32 and int8 pools, ragged
    # priors, live windows w in {1, 3, 5, 16} and one all-padding row
    # (w = 0); the R = 4 cases must also fail their check with the longest
    # row's last prior page read from the scratch page. Decode: a compact
    # working set, the whole pool 16 pages (the dense leg's sub-pool).
    for quant in (False, True):
        sfx, tag = ("[int8]", " int8") if quant else ("", "")
        run("paged_chunk_attention" + sfx, chunk_case, "chunk verify C=5" + tag, chunk_prior,
            VERIFY_FILL, bf16, dev, True, 21, C=5, quant=quant, faults=("last prior page wrong",))
        run("paged_chunk_attention" + sfx, chunk_case, "chunk mixed C=16" + tag, chunk_prior,
            MIXED_FILL, bf16, dev, True, 22, C=16, quant=quant)
        tag += " f32 queries" if quant else ""
        run("paged_chunk_attention[f32]", chunk_case, "chunk verify C=5" + tag, chunk_prior,
            VERIFY_FILL, f32, dev, True, 21, C=5, quant=quant, faults=("last prior page wrong",))
        run("paged_chunk_attention[f32]", chunk_case, "chunk mixed C=16" + tag, chunk_prior,
            MIXED_FILL, f32, dev, True, 22, C=16, quant=quant)
        run("paged_decode_fused" + sfx, decode_case, "decode B=8 compact 16 pages" + tag, COMPACT_LENGTHS,
            bf16, dev, True, 23, quant=quant, maxp=4, pool_pages=16)
    # The serving path's shapes: decode 4 x 600 and 8 x 2000 on the
    # engine's page-table buckets (bf16 and int8 pools), the 8 x 2000
    # prefill's four chunk launches (bf16).
    for quant in (False, True):
        sfx, tag = ("[int8]", " int8") if quant else ("", "")
        run("paged_decode_fused" + sfx, decode_case, "decode 4x600" + tag, DECODE_4X600, bf16, dev, True,
            24, quant=quant, maxp=64, readings=3)
        run("paged_decode_fused" + sfx, decode_case, "decode 8x2000" + tag, DECODE_8X2000, bf16, dev, True,
            25, quant=quant, maxp=128, readings=3)
    for i, (prior, fill) in enumerate(PREFILL_8X2000):
        run("paged_chunk_attention", chunk_case, f"chunk 8x2000 prior={prior}", [prior] * 8, [fill] * 8,
            bf16, dev, True, 26 + i)
    # Pages other than 16 tokens: the engine takes any power of two, the
    # kernels any size. Pages of 1, 3 and 4 tokens are gathered row by row
    # (4, the smallest the engine is often run with, timed: the same shapes
    # at page 16 are the rows above); 24 and 64 come by TMA boxes of 8 and
    # 64 rows. The planted fault is one that no page size hides (a fault
    # in one page of one token would sit inside the row limit).
    for page in PAGES:
        timed = page == 4
        for quant in (False, True):
            sfx, tag = ("[int8]", " int8") if quant else ("", "")
            tag += f" page={page}"
            run("paged_decode_fused" + sfx, decode_case, "decode B=8 ragged" + tag, RAGGED, bf16, dev, timed,
                41, quant=quant, maxp=-(-max(RAGGED) // page), page=page)
            run("paged_attention_pool" + sfx, pool_case, "pool B=8 ragged" + tag, RAGGED, bf16, dev,
                timed and not quant, 42, quant=quant, maxp=-(-max(RAGGED) // page), page=page)
            run("paged_chunk_attention" + sfx, chunk_case, "chunk B=8 ragged" + tag, CHUNK_PRIOR, CHUNK_FILL,
                bf16, dev, timed, 43, quant=quant, faults=PAGE_FAULTS, page=page)
            run("paged_chunk_attention" + sfx, chunk_case, "chunk verify C=5" + tag, CHUNK_PRIOR, VERIFY_FILL,
                bf16, dev, timed and not quant, 44, C=5, quant=quant, faults=PAGE_FAULTS, page=page)
        run("paged_chunk_attention[f32]", chunk_case, f"chunk B=8 ragged page={page}", CHUNK_PRIOR, CHUNK_FILL,
            f32, dev, False, 45, faults=PAGE_FAULTS, page=page)
    return results


# GQA groups that are not powers of two: llama3.2-3b's (Hq 24, Hkv 8: G 3)
# and Qwen2-7B's (Hq 28, Hkv 4: G 7). Groups 4 and 8 over 4 kv heads are
# the yardstick of the chunk body's cost per query row at G 7 (cblk 16:
# 112 of 128 rows live, every tile masked) against full CTAs.
GROUP_HEADS = {3: (24, 8), 7: (28, 4)}
ROW_COST_HEADS = {4: (16, 4), 8: (32, 4)}


def group_kernel_phase(dev) -> dict:
    """Each kernel at G 3 and G 7 against its plain version, with the
    kernel phase's tolerances, row check and planted faults: the decode
    (B1) and pool (B3) kernels at B=8 ragged, both chunk bodies (B2) at
    C = 512, verify C = 5 and mixed C = 16 (the tensor cores over bf16 and
    int8 pools, the CUDA cores over float32 and int8 pools). Then the
    tensor-core body at G 4 and G 8 over 4 kv heads, timed beside G 7 per
    query row."""
    results: dict[str, list] = {}
    run = _runner(results, "kernel G")
    f32, bf16 = torch.float32, torch.bfloat16
    for G, heads in GROUP_HEADS.items():
        for quant in (False, True):
            sfx = "[int8]" if quant else ""
            tag = f" G={G}" + (" int8" if quant else "")
            run("paged_decode_fused" + sfx, decode_case, "decode B=8 ragged" + tag, RAGGED, bf16, dev,
                True, 31, quant=quant, heads=heads)
            run("paged_attention_pool" + sfx, pool_case, "pool B=8 ragged" + tag, RAGGED, bf16, dev,
                True, 32, quant=quant, heads=heads)
            run("paged_chunk_attention" + sfx, chunk_case, "chunk B=8 ragged" + tag, CHUNK_PRIOR,
                CHUNK_FILL, bf16, dev, True, 33, quant=quant, heads=heads)
            run("paged_chunk_attention" + sfx, chunk_case, "chunk verify C=5" + tag, CHUNK_PRIOR,
                VERIFY_FILL, bf16, dev, True, 34, C=5, quant=quant, heads=heads,
                faults=("last prior page wrong",))
            run("paged_chunk_attention" + sfx, chunk_case, "chunk mixed C=16" + tag, CHUNK_PRIOR,
                MIXED_FILL, bf16, dev, True, 35, C=16, quant=quant, heads=heads)
            tag += " f32 queries" if quant else ""
            run("paged_chunk_attention[f32]", chunk_case, "chunk B=8 ragged" + tag, CHUNK_PRIOR,
                CHUNK_FILL, f32, dev, True, 36, quant=quant, heads=heads)
            run("paged_chunk_attention[f32]", chunk_case, "chunk verify C=5" + tag, CHUNK_PRIOR,
                VERIFY_FILL, f32, dev, True, 37, C=5, quant=quant, heads=heads,
                faults=("last prior page wrong",))
            run("paged_chunk_attention[f32]", chunk_case, "chunk mixed C=16" + tag, CHUNK_PRIOR,
                MIXED_FILL, f32, dev, True, 38, C=16, quant=quant, heads=heads)
    for G, heads in ROW_COST_HEADS.items():
        for C, fill in ((512, CHUNK_FILL), (5, VERIFY_FILL)):
            run("paged_chunk_attention", chunk_case, f"chunk {'B=8 ragged' if C == 512 else 'verify C=5'} "
                f"G={G} Hkv=4", CHUNK_PRIOR, fill, bf16, dev, True, 33 if C == 512 else 34, C=C,
                heads=heads)
    # Cost per query row (Hq * B * C rows; every CTA runs its prior tiles).
    for rows in results["paged_chunk_attention"]:
        hq = int(rows["shape"].split("Hq=")[1].split()[0])
        C = int(rows["shape"].split("C=")[1].split()[0])
        rows["us_per_query_row"] = rows["ms"] * 1e3 / (hq * len(CHUNK_PRIOR) * C)
    print("[kernel G] chunk body, us per query row: " + ", ".join(
        f"{r['case']} {r['us_per_query_row']:.5f}" for r in results["paged_chunk_attention"]), flush=True)
    return results


def sass_check() -> dict:
    """The tensor-core chunk body issues wgmma fed by TMA on an mbarrier
    ring: ``cuobjdump -sass`` of its library shows HGMMA, UTMALDG (TMA
    loads) and SYNCS (mbarrier) instructions (the HGMMA lines saved to
    ``chip_out/hgmma.txt``). The CUDA-core body copies K/V tiles with
    cp.async and reads its fragments 16 bytes at a time: its library shows
    LDGSTS and LDS.128 (those lines saved to ``chip_out/f32_body_sass.txt``).
    The decode library loads pages by TMA on an mbarrier ring and runs
    mma.sync on ldmatrix fragments: UTMALDG, SYNCS, HMMA and LDSM."""
    tc = _build.sass("paged_chunk_tc")
    lines = [line.strip() for line in tc.splitlines() if "HGMMA" in line]
    (OUT_DIR / "hgmma.txt").write_text("\n".join(lines) + "\n")
    tc_ops = {op: tc.count(op) for op in ("HGMMA", "UTMALDG", "SYNCS")}
    check(all(tc_ops.values()), f"the tensor-core chunk library lacks HGMMA, UTMALDG or SYNCS: {tc_ops}")
    print(f"[env] cuobjdump -sass paged_chunk_tc: {tc_ops}, e.g. {lines[0]}", flush=True)
    dec = _build.sass("paged_decode")
    dec_ops = {op: dec.count(op) for op in ("UTMALDG", "SYNCS", "HMMA", "LDSM")}
    check(all(dec_ops.values()), f"the decode library lacks UTMALDG, SYNCS, HMMA or LDSM: {dec_ops}")
    print(f"[env] cuobjdump -sass paged_decode: {dec_ops}", flush=True)
    f32_body = _build.sass("paged_chunk")
    ops = {op: f32_body.count(op) for op in ("LDGSTS", "LDS.128", "FFMA ", "SHFL.BFLY")}
    (OUT_DIR / "f32_body_sass.txt").write_text("".join(
        line.strip() + "\n" for line in f32_body.splitlines() if "LDGSTS" in line or "LDS.128" in line))
    check(ops["LDGSTS"] > 0 and ops["LDS.128"] > 0,
          f"the CUDA-core chunk library lacks LDGSTS or LDS.128: {ops}")
    print(f"[env] cuobjdump -sass paged_chunk: {ops}", flush=True)
    return {"hgmma_instructions": len(lines), "example": lines[0], "tensor_core_body": tc_ops,
            "decode": dec_ops, "f32_body": ops}


def f32_body_resources(ptxas: str) -> dict:
    """Registers, spill bytes and shared memory of each instantiation of
    the CUDA-core chunk body, from its ``ptxas -v`` report and the
    library's own count of the dynamic shared memory it launches with; no
    instantiation at D 128 may spill."""
    lib = _build.load_library("paged_chunk")
    lib.paged_chunk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.paged_chunk_smem_bytes.restype = ctypes.c_int
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"paged_chunk_kernelIf([fa])fLi(\d+)ELi(\d+)E", m.group(1))
            name = None if k is None else (("int8" if k.group(1) == "a" else "float32"),
                                           int(k.group(2)), int(k.group(3)))
            if name:
                out[name] = {"smem_bytes": lib.paged_chunk_smem_bytes(name[1], 2 if name[0] == "int8" else 0)}
        elif name and "spill stores" in line:
            out[name]["spill_bytes"] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    check(len(out) == 32, f"ptxas reported {len(out)} CUDA-core chunk instantiations, not 32")
    for (pool, d, g), r in sorted(out.items()):
        print(f"[env] ptxas paged_chunk {pool} pool D {d} G {g}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled, {r['smem_bytes']} bytes of shared memory", flush=True)
    spills = {k: v for k, v in out.items() if k[1] == 128 and v["spill_bytes"]}
    check(not spills, f"the CUDA-core chunk body spills at D 128: {spills}")
    return {f"{pool} D{d} G{g}": r for (pool, d, g), r in out.items()}


# ---------------------------------------------------------------------------
# phase 3: serving Llama-3-8B over HTTP; phase 4: the pool path over it
# ---------------------------------------------------------------------------


def _post(port, body, timeout=180):
    # The server cancels and answers 504 after ``timeout`` too, so a
    # failing engine step surfaces here as an HTTP error, not a hang.
    body = {**body, "timeout": timeout - 30}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"/generate returned {r.status}")
        return json.loads(r.read())


def pool_path_phase(engine, seqs, tag, dev) -> dict:
    """The read-only pool kernel over every layer of the pages the engine
    published for ``seqs`` (bucketed: an off-bucket batch pads to the next
    power of two), counted alone, then held against its plain version."""
    cfg = engine.cfg
    tables, lengths = [], []
    for seq in seqs:
        m = engine.tree.match_prefix(np.asarray(seq, np.int32))
        check(m.length > 0, f"pool path {tag}: a served sequence is not in the tree")
        tables.append(engine.pool.page_table(m.indices()[: m.length]))
        lengths.append(m.length)
    maxp = 1 << max(len(t) for t in tables).bit_length()
    pt = np.full((len(seqs), maxp), engine._scratch_page, np.int32)
    for b, t in enumerate(tables):
        pt[b, : len(t)] = t
    pt, ln = torch.as_tensor(pt, device=dev), torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(len(seqs), cfg.n_heads, cfg.head_dim, generator=g, device=dev).to(cfg.dtype)
    kv, sc = engine.pool.pages(), engine.pool.scale_pages()
    torch.cuda.synchronize()
    pa.reset_counters()
    outs = [paged_attention_pool_bucketed(q, kv, pt, ln, layer, sc) for layer in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches = pa.paged_attention_pool_kernel.launches + pa.paged_attention_pool_kernel.launches_int8
    check(launches == cfg.n_layers, f"pool path {tag}: {launches} launches for {cfg.n_layers} layers")
    err = 0.0
    for layer, out in enumerate(outs):
        check(bool(torch.isfinite(out).all()), f"pool path {tag}: non-finite output")
        want = pa.paged_attention_pool_plain(q, kv, pt, ln, layer, sc)
        err = max(err, (out.float() - want.float()).abs().max().item())
    check(err <= ATOL[cfg.dtype], f"pool path {tag}: max |kernel - plain| = {err}")
    print(f"[pool-path] {tag}: {len(seqs)} published prefixes of {lengths} tokens, "
          f"{launches} launches, max|kernel-plain|={err:.3e}", flush=True)
    return {"launches": launches, "lengths": lengths, "max_abs_err": err}


_SCHED_FIELDS = ("decode_steps", "decode_forwards", "prefill_chunks", "prefill_chunks_with_prior",
                 "spec_proposed", "spec_accepted", "spec_rejected", "multi_step_launches",
                 "compact_launches", "verify_launches", "mixed_launches", "inline_launches")


def _chunk_by_c() -> dict:
    """The chunk kernel's launches by chunk length C since the last reset."""
    return dict(sorted(pa.paged_chunk_attention_kernel.launches_by_c.items()))


def _counts(engine) -> dict:
    """The engine's path counters (``EngineStats``) that the checks read."""
    return {k: getattr(engine.stats, k) for k in _SCHED_FIELDS}


def _b2_by_schedule(counts, n_layers) -> dict:
    """Chunk-kernel launches by the schedule that made them: group prefill
    chunks, speculative verify, mixed waves, inline-only waves."""
    return {"group prefill": n_layers * counts["prefill_chunks"],
            "verify": n_layers * counts["verify_launches"],
            "mixed": n_layers * counts["mixed_launches"], "inline": n_layers * counts["inline_launches"]}


def serving_phase(dev, model, kv_quant=None, schedules=None, legacy=None, name="llama3-8b") -> dict:
    """One serving run of model ``name`` over HTTP. ``schedules``
    (``SCHEDULES``) turns on the fast schedules: the group then decodes 48
    tokens, a 3000-token prompt arrives while its 4 rows decode (mixed
    waves), and the run's outputs are compared with ``legacy``'s
    (information only)."""
    cfg = model.cfg
    tag = ("" if name == "llama3-8b" else name + " ") + (kv_quant or "bf16") + (
        " schedules" if schedules else "")
    engine = Engine(cfg, model, num_slots=65536, page_size=16, max_batch=8, device=dev,
                    kv_quant=kv_quant, **(schedules or {}))
    torch.cuda.synchronize()
    print(f"[serve {tag}] {name} engine ready; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    fe = ServingFrontend(engine, port=0)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, size=n).tolist()

    max_tokens = 16
    group_tokens = 48 if schedules else max_tokens
    results: dict[str, dict] = {}

    def send(name, ids, n=max_tokens):
        t = time.monotonic()
        r = _post(fe.port, {"input_ids": ids, "max_tokens": n})
        r["client_s"] = time.monotonic() - t
        r["prompt_tokens"] = len(ids)
        r["ids"] = ids
        r["max_tokens"] = n
        results[name] = r

    def late_arrival(ids, prefills):
        # Sent once the four group requests are prefilled, while their rows
        # decode, so it is admitted into the inline backlog of a running
        # batch.
        deadline = time.monotonic() + 120
        while engine.stats.prefills < prefills + 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        send("late3000", ids)

    suffix = "" if kv_quant is None else f"[{kv_quant}]"
    try:
        # Warm-up outside the counted window (cuBLAS handles, allocator).
        send("warmup", prompt(64))
        torch.cuda.synchronize()
        pa.reset_counters()
        counts0 = _counts(engine)
        group = {f"group{i}": prompt(600 + 10 * i) for i in range(4)}
        threads = [threading.Thread(target=send, args=(k, v, group_tokens)) for k, v in group.items()]
        if schedules:
            # Its own generator, so every other prompt is the legacy run's.
            late = np.random.default_rng(1).integers(0, cfg.vocab_size, size=3000).tolist()
            threads.append(threading.Thread(target=late_arrival, args=(late, engine.stats.prefills)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        send("long3000", prompt(3000))
        follow = group["group0"] + results["group0"]["output_ids"] + prompt(40)
        send("followup", follow)
        accepted0 = engine.stats.spec_accepted
        send("repeat_a", group["group1"], group_tokens)
        repeat_accepted = engine.stats.spec_accepted - accepted0
        send("repeat_b", group["group1"], group_tokens)
        torch.cuda.synchronize()
        attr = "launches" if kv_quant is None else "launches_int8"
        launches = {
            "paged_decode_fused" + suffix: getattr(pa.paged_decode_fused_kernel, attr),
            "paged_chunk_attention" + suffix: getattr(pa.paged_chunk_attention_kernel, attr),
        }
        other = "launches_int8" if kv_quant is None else "launches"
        other_launches = (getattr(pa.paged_decode_fused_kernel, other)
                          + getattr(pa.paged_chunk_attention_kernel, other))
        f32_body = pa.paged_chunk_attention_kernel.launches_f32_body
        plain_calls = pa.plain_calls()
        by_c = _chunk_by_c()
        st = {k: v - counts0[k] for k, v in _counts(engine).items()}
        waves = None if engine.waves is None else engine.waves.snapshot()
    finally:
        fe.close(drain_s=0.0)
    for name, r in results.items():
        n = len(r["output_ids"])
        tps = (n - 1) / (r["e2e_s"] - r["ttft_s"]) if n > 1 and r["e2e_s"] > r["ttft_s"] else None
        print(f"[serve {tag}] {name}: prompt={r['prompt_tokens']} cached={r['cached_tokens']} "
              f"out={n} ttft_s={r['ttft_s']:.4f} e2e_s={r['e2e_s']:.4f} "
              f"decode_tok_s={tps if tps is None else round(tps, 2)}", flush=True)
        check(n == r["max_tokens"], f"{tag} {name}: {n} tokens, expected {r['max_tokens']}")
        check(all(0 <= t < cfg.vocab_size for t in r["output_ids"]), f"{tag} {name}: token out of range")
    L = cfg.n_layers
    b2 = _b2_by_schedule(st, L)
    print(f"[serve {tag}] launches={launches} other_pool_dtype_launches={other_launches} "
          f"cuda_core_chunk_body_launches={f32_body} chunk_launches_by_c={by_c} "
          f"plain_calls={plain_calls} decode_steps={st['decode_steps']} decode_forwards={st['decode_forwards']} "
          f"prefill_chunks={st['prefill_chunks']} chunks_with_prior={st['prefill_chunks_with_prior']} "
          f"group_cached={[results[k]['cached_tokens'] for k in group]}", flush=True)
    check(launches["paged_decode_fused" + suffix] == L * st["decode_forwards"] > 0,
          f"{tag}: decode kernel must launch once per layer per decode pass")
    check(launches["paged_chunk_attention" + suffix] == sum(b2.values()) > 0,
          f"{tag}: chunk kernel must launch once per layer per chunk launch ({b2})")
    check(other_launches == 0, f"{tag}: kernels of the other pool dtype launched")
    check(f32_body == 0, f"{tag}: bf16 queries ran the CUDA-core chunk body")
    check(st["prefill_chunks_with_prior"] >= 1, f"{tag}: no prefill chunk attended pool context (prior > 0)")
    check(plain_calls == 0, f"{tag}: {plain_calls} plain attention calls on the card")
    check(results["followup"]["cached_tokens"] > 0, f"{tag}: follow-up did not hit the cache")
    check(results["repeat_a"]["cached_tokens"] == results["repeat_b"]["cached_tokens"] > 0,
          f"{tag}: repeats should hit the same cached prefix")
    if not schedules:
        check(results["repeat_a"]["output_ids"] == results["repeat_b"]["output_ids"],
              f"{tag}: repeated greedy request returned different tokens")
    sched = None
    if schedules:
        sched = {**st, "repeat_a_spec_accepted": repeat_accepted, "waves": waves,
                 "b2_launches_by_schedule": b2, "b1_launches": launches["paged_decode_fused" + suffix],
                 "spec_report": engine.spec_report()}
        print(f"[serve {tag}] spec proposed={st['spec_proposed']} accepted={st['spec_accepted']} "
              f"rejected={st['spec_rejected']} (repeat_a accepted {repeat_accepted}); waves={waves['counts']} "
              f"inline_tokens={waves['inline_tokens']}; multi-step launches={st['multi_step_launches']} "
              f"compact launches={st['compact_launches']}; B2 launches by schedule={b2}", flush=True)
        check(st["spec_proposed"] == st["spec_accepted"] + st["spec_rejected"], f"{tag}: draft counts not conserved")
        check(repeat_accepted > 0, f"{tag}: the repeat of a finished request accepted no tree draft")
        check(waves["counts"]["mixed"] > 0 and st["mixed_launches"] > 0, f"{tag}: no mixed wave ran")
        check(st["multi_step_launches"] > 0, f"{tag}: no multi-step decode launch")
        # Information only: a token may come from the decode kernel in one
        # run and from a verify or mixed-wave chunk launch in another, and
        # the two round differently in bf16, which can flip a near-tie of
        # random weights' logits; token-exactness of the schedules is
        # checked in float32 (the whole path, and the CPU tests).
        def first_diff(a, b):
            return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)

        same = {k: first_diff(r["output_ids"], legacy["requests"][k]["output_ids"])
                for k, r in results.items() if k in legacy["requests"]}
        repeats = {k: first_diff(results[k]["output_ids"], results["group1"]["output_ids"])
                   for k in ("repeat_a", "repeat_b")}
        print(f"[serve {tag}] first differing token against the legacy run's (None: equal): {same}; "
              f"repeats against group1: {repeats}", flush=True)
        sched["first_diff_vs_legacy"] = same
        sched["repeat_first_diff_vs_group1"] = repeats
    else:
        # Not asserted: with a bf16 pool the cold run prefilled through the
        # chunk kernel and the cached repeat through the dense path, which
        # round differently in bf16 and can flip a near-tie of random
        # weights' logits (int8 pools always prefill through the chunk path).
        print(f"[serve {tag}] cold run vs cached repeat identical (informational): "
              f"{results['group1']['output_ids'] == results['repeat_a']['output_ids']}", flush=True)
    published = [r["ids"] + r["output_ids"] for k, r in results.items()
                 if k.startswith("group") or k in ("long3000", "followup")]
    pool_path = None if schedules else pool_path_phase(engine, published, tag, dev)
    del engine
    torch.cuda.empty_cache()
    for r in results.values():
        del r["ids"]
    return {"launches": launches, "chunk_by_c": by_c, "requests": results, "pool_path": pool_path,
            "schedules": sched}


# ---------------------------------------------------------------------------
# phase 6: the KV tiers (host RAM, disk) and the async KV-movement plane
# ---------------------------------------------------------------------------

TIER_KW = dict(num_slots=8192, page_size=16, max_batch=8, host_cache_slots=32768,
               kv_transfer_async=True, kv_tier_capacity_bytes=16 << 30,
               # No write-behind destage in the run: drain_flush_disk spills.
               kv_tier_watermark=2.0)
TIER_PROMPT = 3000
TIER_BUSY = 1000  # the prompt that decodes while a restore is parked
TIER_DRILL = 3008  # tokens of the write-back and restore rate drill


def _serve_alone(engine, prompt, max_new=16):
    """One request through ``Engine.step`` until it finishes; returns
    ``(tokens, cached tokens, TTFT s, parked, TTFT parts)``. The parts split
    a parked request's TTFT at step boundaries: the step that parked it,
    the steps that waited for its restore, and the step that re-admitted
    it (the pump landing the last chunks, then its prefill)."""
    req = engine.add_request(prompt, SamplingParams(max_new_tokens=max_new))
    parked = False
    parts = {"park_step_s": 0.0, "wait_steps": 0, "wait_s": 0.0, "admit_step_s": 0.0,
             "admit_pump_s": 0.0}
    # The host wall of each step's plane pump (its first call, at the top of
    # admission): the re-admitting step's share that lands the last chunks.
    pump_walls = []

    def timed_pump(_pump=engine._pump_kv_transfer):
        t0 = time.perf_counter()
        _pump()
        pump_walls.append(time.perf_counter() - t0)

    engine._pump_kv_transfer = timed_pump
    try:
        while req.state is not RequestState.FINISHED:
            was_parked = req.state is RequestState.RESTORING
            t = time.perf_counter()
            engine.step()
            wall = time.perf_counter() - t
            now_parked = req.state is RequestState.RESTORING
            if now_parked and not was_parked:
                parts["park_step_s"] = wall
            elif now_parked:
                parts["wait_steps"] += 1
                parts["wait_s"] += wall
            elif was_parked:
                parts["admit_step_s"] = wall
                parts["admit_pump_s"] = pump_walls[-1]
            parked |= now_parked
    finally:
        del engine._pump_kv_transfer
    return (list(req.generated), int(req.prefix_len), req.first_token_time - req.submit_time, parked,
            parts)


def _raw_pages(engine, prompt):
    """``(n, kv, scales)``: the pool's stored K/V of the prompt's matched
    prefix, brought to the host, and the match length."""
    m = engine.tree.match_prefix(np.asarray(prompt, np.int32))
    kv, sc = engine.pool.gather_raw(m.indices()[: m.length])
    return m.length, kv.cpu(), None if sc is None else sc.cpu()


def _bit_equal(a, b) -> bool:
    return a[0] == b[0] and torch.equal(a[1].view(torch.uint8), b[1].view(torch.uint8)) and (
        (a[2] is None and b[2] is None) or torch.equal(a[2], b[2]))


def _timed_wall(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _lane_rates(engine, dev) -> dict:
    """A ``TIER_DRILL``-token write-back and restore through the plane, wall-clocked
    from the engine thread (gather + copy + arena write; ring copy + copy
    stream + scatter), beside a plain pinned ``copy_`` of the same bytes
    each way and the gather's and scatter's device time. The synthetic
    prefix is the only device-resident node when it runs."""
    tree, plane, pool = engine.tree, engine.kv_transfer, engine.pool
    n = TIER_DRILL
    key = np.random.default_rng(9).integers(0, engine.cfg.vocab_size, size=n).astype(np.int32)
    slots = pool.alloc(n)
    g = torch.Generator(device=dev).manual_seed(9)
    shape = (2, pool.num_layers, n, pool.num_kv_heads, pool.head_dim)
    if pool.quant is None:
        kv = torch.randn(shape, generator=g, device=dev).to(pool.dtype)
        sc = None
    else:
        kv = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(shape[:-1], generator=g, device=dev)
    pool.write_raw(slots, kv, sc)
    tree.insert(key, slots)
    check(tree.evictable_size_ == n, f"lane drill: {tree.evictable_size_} evictable tokens, not {n}")
    nbytes = n * kv_token_bytes(pool)
    wb_s = _timed_wall(lambda: (tree.evict(n), plane.wait_host_ready()))
    m = tree.match_prefix(key)
    check(m.length == 0 and m.host_length == n, "lane drill: the write-back did not land in the host tier")

    def restore():
        ticket = plane.begin_restore(tree, m, alloc=engine._restore_alloc, auto_release=True)
        while not ticket.released:
            plane.pump(tree)
            plane.wait_progress(0.0005)

    rs_s = _timed_wall(restore)
    m2 = tree.match_prefix(key)
    kv2, sc2 = pool.gather_raw(m2.indices()[: m2.length])
    check(m2.length == n and torch.equal(kv2.view(torch.uint8), kv.view(torch.uint8))
          and (sc is None or torch.equal(sc2, sc)), "lane drill: restored pages differ")
    h = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    idx = m2.indices()[: m2.length]
    out = {
        "tokens": n, "bytes": nbytes, "token_bytes": kv_token_bytes(pool),
        "writeback_s": wb_s, "writeback_GBps": nbytes / wb_s / 1e9,
        "restore_s": rs_s, "restore_GBps": nbytes / rs_s / 1e9,
        "pinned_h2d_ms": time_ms(lambda: d.copy_(h, non_blocking=True), 5),
        "pinned_d2h_ms": time_ms(lambda: h.copy_(d, non_blocking=True), 5),
        # Device time of one gather / scatter, the slot list's upload included.
        "gather_ms": time_ms(lambda: pool.gather_raw(idx), 5),
        "scatter_ms": time_ms(lambda: pool.write_raw(idx, kv, sc), 5),
        "plane_lane_seconds": plane.stats()["lane_seconds"],
    }
    out["pinned_h2d_GBps"] = nbytes / out["pinned_h2d_ms"] / 1e6
    out["pinned_d2h_GBps"] = nbytes / out["pinned_d2h_ms"] / 1e6
    return out


def tier_phase(dev, model, kv_quant=None) -> dict:
    """Phase 6 for one pool dtype (module docstring)."""
    cfg = model.cfg
    tag = kv_quant or "bf16"
    OUT_DIR.mkdir(exist_ok=True)
    tier_dir = tempfile.mkdtemp(prefix="kv-tier-", dir=OUT_DIR)
    rng = np.random.default_rng(3)
    p, q1, q2, q3 = (rng.integers(0, cfg.vocab_size, size=TIER_PROMPT).tolist() for _ in range(4))
    bg = rng.integers(0, cfg.vocab_size, size=TIER_BUSY).tolist()
    out: dict = {}
    try:
        t = time.monotonic()
        engine = Engine(cfg, model, device=dev, kv_quant=kv_quant, kv_tier_dir=tier_dir, **TIER_KW)
        out["engine_build_s"] = time.monotonic() - t
        check(engine.tree.host.pinned and engine.kv_transfer.pinned and
              engine.kv_transfer.stats()["copy_stream"], f"tiers {tag}: arena or ring not pinned")
        torch.cuda.synchronize()
        pa.reset_counters()
        counts0 = _counts(engine)
        hits = {}
        hits["miss"] = _serve_alone(engine, p)
        # Two device hits: the first is the first dense prefill over a
        # 2992-token prefix in the process (bf16: allocations, GEMM shapes);
        # the second is the one compared with the host and disk hits.
        hits["device_first"] = _serve_alone(engine, p)
        hits["device"] = _serve_alone(engine, p)
        before = _raw_pages(engine, p)
        for q in (q1, q2, q3):
            _serve_alone(engine, q)
        m = engine.tree.match_prefix(np.asarray(p, np.int32))
        check(m.length == 0 and m.host_length >= before[0],
              f"tiers {tag}: pool pressure did not move the prompt to the host tier ({m.length}, {m.host_length})")
        hits["host"] = _serve_alone(engine, p)
        after_host = _raw_pages(engine, p)
        check(_bit_equal(before, after_host), f"tiers {tag}: pages differ after the host restore")
        # A host restore while a 1000-token request decodes.
        engine.drain_flush_hot()
        check(engine.kv_transfer.wait_host_ready(), f"tiers {tag}: write-back barrier failed")
        busy = engine.add_request(bg, SamplingParams(max_new_tokens=48))
        while len(busy.output_tokens) < 2:
            engine.step()
        plain_walls = [_timed_wall(engine.step) for _ in range(8)]
        # The engine thread's share of the parking step: begin_restore's wall.
        plane = engine.kv_transfer
        begin_s = []

        def timed_begin(*a, _begin=plane.begin_restore, **k):
            t0 = time.perf_counter()
            ticket = _begin(*a, **k)
            begin_s.append(time.perf_counter() - t0)
            return ticket

        plane.begin_restore = timed_begin
        req = engine.add_request(p, SamplingParams(max_new_tokens=16))
        parked_walls, parked_steps = [], 0
        while req.state is not RequestState.FINISHED:
            d0 = engine.stats.decode_steps
            wall = _timed_wall(engine.step)
            # The restore was in flight through this whole step: the pump at
            # its start did not land it (the step that parks counts too).
            if req.state is RequestState.RESTORING:
                parked_walls.append(wall)
                parked_steps += engine.stats.decode_steps - d0
        del plane.begin_restore
        check(parked_steps > 0, f"tiers {tag}: no decode step while the restore was parked")
        hits["host_while_decoding"] = (list(req.generated), int(req.prefix_len),
                                       req.first_token_time - req.submit_time, True, None)
        while engine.has_work():
            engine.step()
        out["decode_during_restore"] = {
            "decode_steps_while_parked": parked_steps, "step_walls_parked_s": parked_walls,
            "step_walls_no_restore_s": plain_walls,
            "median_parked_s": float(np.median(parked_walls)),
            "median_no_restore_s": float(np.median(plain_walls)),
            "begin_restore_s": begin_s,
        }
        engine.drain_flush_hot()
        check(engine.kv_transfer.wait_host_ready(), f"tiers {tag}: write-back barrier failed")
        out["lanes"] = _lane_rates(engine, dev)
        engine.drain_flush_hot()
        check(engine.kv_transfer.wait_host_ready(), f"tiers {tag}: write-back barrier failed")
        t = time.monotonic()
        spilled, committed = engine.drain_flush_disk(timeout_s=120.0)
        out["drain_flush_disk"] = {"spills": spilled, "committed": committed,
                                   "seconds": time.monotonic() - t, **engine._kv_tier.stats()}
        check(spilled > 0 and committed, f"tiers {tag}: drain_flush_disk did not commit ({spilled})")
        out["host_tier"] = engine.tree.stats()
        out["plane"] = engine.kv_transfer.stats()
        counts = {k: v - counts0[k] for k, v in _counts(engine).items()}
        engine.close()
        del engine
        torch.cuda.empty_cache()
        # Cold-cell resurrection: a new engine on the same directory.
        engine = Engine(cfg, model, device=dev, kv_quant=kv_quant, kv_tier_dir=tier_dir, **TIER_KW)
        res = {k: v for k, v in engine.resurrected.items() if k != "keys"}
        m = engine.tree.match_prefix(np.asarray(p, np.int32))
        check(res["grafted_nodes"] > 0 and m.disk_length >= before[0],
              f"tiers {tag}: the prompt was not resurrected from disk ({res}, {m.disk_length})")
        hits["disk"] = _serve_alone(engine, p)
        # Where the disk hit's time went: the extent reads with their CRC
        # checks and decode, and the worker's whole staging of the units.
        out["disk_hit"] = {"tier": engine._kv_tier.stats(),
                           "restore_lane_s": engine.kv_transfer.stats()["lane_seconds"]["restore"]}
        after_disk = _raw_pages(engine, p)
        check(_bit_equal(before, after_disk), f"tiers {tag}: pages differ after the disk restore")
        counts2 = _counts(engine)
        counts = {k: counts[k] + counts2[k] for k in counts}
        out["resurrected"] = res
        engine.close()
        del engine
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tier_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    attr = "launches" if kv_quant is None else "launches_int8"
    suffix = "" if kv_quant is None else f"[{kv_quant}]"
    launches = {"paged_decode_fused" + suffix: getattr(pa.paged_decode_fused_kernel, attr),
                "paged_chunk_attention" + suffix: getattr(pa.paged_chunk_attention_kernel, attr)}
    out["chunk_by_c"] = _chunk_by_c()
    plain_calls = pa.plain_calls()
    L = cfg.n_layers
    check(plain_calls == 0, f"tiers {tag}: {plain_calls} plain attention calls on the card")
    check(launches["paged_decode_fused" + suffix] == L * counts["decode_forwards"] > 0,
          f"tiers {tag}: decode kernel launches != layers x decode passes")
    check(launches["paged_chunk_attention" + suffix] == L * counts["prefill_chunks"] > 0,
          f"tiers {tag}: chunk kernel launches != layers x chunk launches")
    for name in ("host", "disk"):
        check(hits[name][3] and hits[name][1] >= before[0] - 16,
              f"tiers {tag}: the {name} hit did not park and restore ({hits[name][1]} cached)")
    check(hits["host_while_decoding"][1] >= before[0] - 16, f"tiers {tag}: the restore under decode missed")
    check(hits["device_first"][0] == hits["device"][0] == hits["host"][0] == hits["disk"][0],
          f"tiers {tag}: device, host and disk hits returned different tokens")
    ttft = {k: v[2] for k, v in hits.items()}
    parts = {k: hits[k][4] for k in ("host", "disk")}
    lanes = out["lanes"]
    dd = out["decode_during_restore"]
    print(f"[tiers {tag}] TTFT of a {TIER_PROMPT}-token prompt alone: miss {ttft['miss']:.4f}s, "
          f"device hit {ttft['device']:.4f}s (first {ttft['device_first']:.4f}s), host hit {ttft['host']:.4f}s, disk hit {ttft['disk']:.4f}s; "
          f"cached {[v[1] for v in hits.values()]}; same tokens device/host/disk: True; the restore "
          f"under decode (its decode steps batched with another row) the same tokens too (informational): "
          f"{hits['host_while_decoding'][0] == hits['device'][0]}", flush=True)
    for k, v in parts.items():
        print(f"[tiers {tag}] the {k} hit's TTFT at step boundaries: park step {v['park_step_s'] * 1e3:.2f} ms, "
              f"{v['wait_steps']} waiting steps {v['wait_s'] * 1e3:.2f} ms, re-admitting step "
              f"{v['admit_step_s'] * 1e3:.2f} ms (its pump {v['admit_pump_s'] * 1e3:.2f} ms, then the "
              f"prefill)", flush=True)
    print(f"[tiers {tag}] {lanes['token_bytes']} B/token; {lanes['tokens']} tokens = {lanes['bytes']} B: "
          f"write-back {lanes['writeback_GBps']:.2f} GB/s ({lanes['writeback_s'] * 1e3:.2f} ms), "
          f"restore {lanes['restore_GBps']:.2f} GB/s ({lanes['restore_s'] * 1e3:.2f} ms); pinned copy_ "
          f"H2D {lanes['pinned_h2d_GBps']:.2f} GB/s ({lanes['pinned_h2d_ms']:.3f} ms), D2H "
          f"{lanes['pinned_d2h_GBps']:.2f} GB/s ({lanes['pinned_d2h_ms']:.3f} ms); gather "
          f"{lanes['gather_ms']:.3f} ms, scatter {lanes['scatter_ms']:.3f} ms (device)", flush=True)
    dh = out["disk_hit"]
    print(f"[tiers {tag}] decode while a {TIER_PROMPT}-token restore was parked: "
          f"{dd['decode_steps_while_parked']} steps, median wall {dd['median_parked_s'] * 1e3:.2f} ms/step "
          f"({len(dd['step_walls_parked_s'])} steps; begin_restore {sum(dd['begin_restore_s']) * 1e3:.2f} ms "
          f"of them) vs {dd['median_no_restore_s'] * 1e3:.2f} ms/step with no restore; disk hit: extent "
          f"read + verify {dh['tier']['io_seconds']['read']:.3f}s for {dh['tier']['bytes_read']} B, worker "
          f"staging {dh['restore_lane_s']:.3f}s; drain_flush_disk {out['drain_flush_disk']['spills']} extents, "
          f"{out['drain_flush_disk']['bytes_written']} B in {out['drain_flush_disk']['seconds']:.2f}s; "
          f"resurrected {out['resurrected']}; launches {launches}, plain calls {plain_calls}", flush=True)
    out.update(ttft_s=ttft, ttft_parts=parts, cached={k: v[1] for k, v in hits.items()}, launches=launches,
               engine_counts=counts, tokens=hits["device"][0])
    return out


def _together(*calls) -> list:
    """Run the zero-argument ``calls`` in threads at once; their results in
    order, or the first call's failure raised once all have ended."""
    results: list = [None] * len(calls)
    errors: list = [None] * len(calls)

    def one(i):
        try:
            results[i] = calls[i]()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(calls))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def launcher_phase(kv_quant=None, weight_quant=None) -> dict:
    """``python -m radixmesh_tpu_torch.launch serve`` with the three tiers
    (``--host-cache-slots``, ``--kv-transfer-async``, ``--kv-tier-dir``) in
    a child process: it must start on the card, answer ``/generate`` (the
    repeat a cache hit) and report the tiers in
    ``/stats``; it is terminated after. With ``weight_quant`` it serves
    ``--weight-quant`` W8A16 weights instead, without the tiers."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tier_dir = tempfile.mkdtemp(prefix="kv-tier-serve-", dir=OUT_DIR)
    cmd = [sys.executable, "-m", "radixmesh_tpu_torch.launch", "serve", "--model", "llama3-8b",
           "--http-port", str(port), "--kv-slots", "8192"]
    if weight_quant:
        cmd += ["--weight-quant", weight_quant]
    else:
        cmd += ["--host-cache-slots", "8192", "--kv-transfer-async", "--kv-tier-dir", tier_dir]
    if kv_quant:
        cmd += ["--kv-quant", kv_quant]
    tag = weight_quant and f"weights {weight_quant}" or kv_quant or "bf16"
    log = open(OUT_DIR / f"serve_{tag}.log", "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    try:
        while True:
            check(proc.poll() is None, f"serve {tag} exited with {proc.returncode} (chip_out/serve_{tag}.log)")
            check(time.monotonic() - t0 < 240, f"serve {tag} did not answer /healthz in 240 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
        ready_s = time.monotonic() - t0
        ids = np.random.default_rng(4).integers(0, 128256, size=600).tolist()
        first = _post(port, {"input_ids": ids, "max_tokens": 8})
        again = _post(port, {"input_ids": ids, "max_tokens": 8})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(tier_dir, ignore_errors=True)
    check(len(first["output_ids"]) == 8 and again["cached_tokens"] > 0,
          f"serve {tag}: /generate answered {first} / {again}")
    if weight_quant:
        print(f"[serve-cli {tag}] launch.py serve --weight-quant {weight_quant}: /healthz after "
              f"{ready_s:.1f}s; /generate cached {first['cached_tokens']} then {again['cached_tokens']}; "
              f"kernels {stats.get('kernels')}", flush=True)
        return {"ready_s": ready_s, "cached": [first["cached_tokens"], again["cached_tokens"]],
                "kernels": stats.get("kernels")}
    check({"host_fill", "host_tier", "kv_transfer", "kv_tier"} <= set(stats)
          and stats["host_tier"]["pinned"] and stats["kv_transfer"]["pinned"],
          f"serve {tag}: /stats lacks the tiers or they are not pinned: {sorted(stats)}")
    print(f"[serve-cli {tag}] launch.py serve with --host-cache-slots 8192 --kv-transfer-async "
          f"--kv-tier-dir: /healthz after {ready_s:.1f}s; /generate cached {first['cached_tokens']} then "
          f"{again['cached_tokens']} (same tokens, informational: {again['output_ids'] == first['output_ids']}); "
          f"/stats host_fill {stats['host_fill']:.4f}, pinned arena and ring", flush=True)
    return {"ready_s": ready_s, "cached": [first["cached_tokens"], again["cached_tokens"]],
            "kv_transfer": stats["kv_transfer"], "host_tier": stats["host_tier"]}


# ---------------------------------------------------------------------------
# phases 8-10: Qwen2-7B served; an HF checkpoint written and read back; the
# launcher serving a checkpoint with text
# ---------------------------------------------------------------------------


def plant_biases(params: dict, seed: int, scale: float = 0.5) -> dict:
    """Non-zero QKV biases in place (``init_params`` starts them at zero,
    as the JAX package does, which would leave the bias path untested)."""
    g = torch.Generator(device=params["layers"]["bq"].device).manual_seed(seed)
    for name in ("bq", "bk", "bv"):
        leaf = params["layers"][name]
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=leaf.device) * scale)
    return params


def qwen2_serving_phase(dev) -> dict:
    """Qwen2-7B at full width and depth (28 layers, Hq 28 over Hkv 4: GQA
    group 7), random bf16 weights from a seed with planted QKV biases,
    served over HTTP on a 65536-slot bf16 pool as phase 3 serves Llama-3-8B
    (4 concurrent ~600-token prompts, a 3000-token prompt, a follow-up that
    hits the prefix, repeats), then the pool kernel over its pages."""
    # Earlier phases' frontends sit in reference cycles (handler closures):
    # collect them so their engines release the Llama-3-8B weights first.
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    cfg = get_config("qwen2-7b")
    with torch.inference_mode():
        model = Llama(cfg, plant_biases(init_params(cfg, seed=0, device=dev), 0))
    torch.cuda.synchronize()
    weights_s = time.monotonic() - t
    print(f"[serve qwen2-7b] weights built in {weights_s:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    out = serving_phase(dev, model, name="qwen2-7b")
    del model
    torch.cuda.empty_cache()
    return {**out, "weights_s": weights_s}


def _leaves(params: dict):
    for name, t in params.items():
        if name == "layers":
            yield from ((f"layers.{k}", v) for k, v in t.items())
        else:
            yield name, t


def checkpoint_phase(dev) -> dict:
    """Qwen2-7B at full width and 2 layers (bf16, planted biases) written by
    the port's ``save_hf_state_dict`` in 256 MiB shards with an index, under
    ``chip_out/`` (removed after), and read back by ``load_hf_checkpoint``
    onto the card: every param bit-equal to what was written, and the same
    greedy tokens from the loaded weights as from the in-memory ones
    (a 700-token prompt through the chunk kernel, then 16 decode steps)."""
    cfg = get_config("qwen2-7b", n_layers=2)
    params = plant_biases(init_params(cfg, seed=3, device=dev), 3)
    ckpt = tempfile.mkdtemp(prefix="hf-ckpt-", dir=OUT_DIR)
    try:
        t = time.monotonic()
        save_hf_state_dict(hf_state_dict(cfg, params), ckpt, max_shard_bytes=256 << 20)
        write_s = time.monotonic() - t
        files = sorted(os.listdir(ckpt))
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        t = time.monotonic()
        loaded = load_hf_checkpoint(ckpt, cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    shards = [f for f in files if f.endswith(".safetensors")]
    check("model.safetensors.index.json" in files and len(shards) > 1,
          f"checkpoint: expected an index and several shards, got {files}")
    want, got = dict(_leaves(params)), dict(_leaves(loaded))
    check(set(want) == set(got), f"checkpoint: leaves {sorted(got)} != {sorted(want)}")
    for name, t in want.items():
        check(got[name].dtype == t.dtype and torch.equal(got[name].view(torch.int16), t.view(torch.int16)),
              f"checkpoint: {name} not bit-equal after the round trip")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=700).tolist()
    tokens = {}
    for tag, p in (("in-memory", params), ("loaded", loaded)):
        eng = Engine(cfg, p, num_slots=4096, page_size=16, max_batch=2, device=dev,
                     long_prefill_threshold=256)
        tokens[tag] = eng.generate([prompt], SamplingParams(max_new_tokens=16))[0]
        del eng
    check(tokens["loaded"] == tokens["in-memory"], f"checkpoint: greedy tokens differ: {tokens}")
    print(f"[checkpoint] qwen2-7b 2 layers: {len(shards)} shards + index, {nbytes} B written in "
          f"{write_s:.2f}s, loaded onto the card in {load_s:.2f}s; {len(want)} leaves bit-equal; "
          f"greedy tokens equal: {tokens['loaded']}", flush=True)
    del params, loaded
    torch.cuda.empty_cache()
    return {"files": files, "bytes": nbytes, "write_s": write_s, "load_s": load_s, "tokens": tokens["loaded"]}


# A ~1500-byte text: over the launcher's 1024-token dense threshold, so the
# byte tokenizer's tokens prefill in chunks through the chunk kernel.
LAUNCH_TEXT = "The radix cache keeps every prefix that it has served, on every node. " * 22


def launcher_text_phase() -> dict:
    """``python -m radixmesh_tpu_torch.launch serve --model llama3.2-3b
    --weights DIR --tokenizer byte`` in a child process, over a full
    llama3.2-3b checkpoint (tied embeddings, Hq 24 over Hkv 8: GQA group 3)
    that the port wrote under ``chip_out/`` (removed after): a ``text``
    request is answered with ``text``, its repeat hits the prefix, and
    ``/stats`` shows the decode and chunk kernels launched and no plain
    attention call."""
    import socket

    from radixmesh_tpu_torch.server.tokenizer import ByteTokenizer

    cfg = get_config("llama3.2-3b")
    ckpt = tempfile.mkdtemp(prefix="hf-ckpt-3b-", dir=OUT_DIR)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = open(OUT_DIR / "serve_text.log", "w")
    proc = None
    try:
        t = time.monotonic()
        params = init_params(cfg, seed=5, device="cuda")
        save_hf_state_dict(hf_state_dict(cfg, params), ckpt)
        write_s = time.monotonic() - t
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        del params
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "radixmesh_tpu_torch.launch", "serve", "--model", "llama3.2-3b",
               "--http-port", str(port), "--kv-slots", "16384", "--weights", ckpt, "--tokenizer", "byte"]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.monotonic()
        while True:
            check(proc.poll() is None, f"serve text exited with {proc.returncode} (chip_out/serve_text.log)")
            check(time.monotonic() - t0 < 300, "serve text did not answer /healthz in 300 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
        ready_s = time.monotonic() - t0
        first = _post(port, {"text": LAUNCH_TEXT, "max_tokens": 8})
        again = _post(port, {"text": LAUNCH_TEXT, "max_tokens": 8})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        log.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    k = stats["kernels"]
    plain = sum(v for name, v in k.items() if "_plain" in name)
    tok = ByteTokenizer()
    for r in (first, again):
        check(isinstance(r.get("text"), str) and r["text"] == tok.decode(r["output_ids"])
              and 0 < len(r["output_ids"]) <= 8, f"serve text: /generate answered {r}")
    check(again["cached_tokens"] > 0, f"serve text: the repeat hit no prefix ({again['cached_tokens']})")
    check(k["paged_decode_fused_kernel"] > 0 and k["paged_chunk_attention_kernel"] > 0 and plain == 0,
          f"serve text: /stats kernels {k}")
    print(f"[serve-text] launch.py serve --model llama3.2-3b --weights ({nbytes} B written in {write_s:.1f}s) "
          f"--tokenizer byte: /healthz after {ready_s:.1f}s; text of {len(tok.encode(LAUNCH_TEXT))} tokens "
          f"-> {len(first['output_ids'])} tokens, text {first['text']!r}; repeat cached "
          f"{again['cached_tokens']}; /stats kernels {k}", flush=True)
    return {"ready_s": ready_s, "write_s": write_s, "bytes": nbytes, "cached": again["cached_tokens"],
            "kernels": k, "first": first, "again": again}


# ---------------------------------------------------------------------------
# phase 12: seeded replay, resume admission and the observability planes
# ---------------------------------------------------------------------------

REPLAY_SAMPLING = dict(temperature=0.9, top_p=0.95)
# The decode-wall configurations: (engine kwargs, recorder sample rate,
# seeded rows).
WALL_CONFIGS = {
    "unseeded, planes off": (dict(token_timeline_capacity=0), 0.0, False),
    "unseeded, planes default": ({}, 0.0, False),
    "unseeded, planes on": (dict(step_accounting=True), 1.0, False),
    "seeded, planes default": ({}, 0.0, True),
}


def _drain(engine):
    while engine.has_work():
        engine.step()


def _http(port, path, body=None, timeout=120):
    """GET (``body`` None) or POST JSON; returns the decoded body (JSON, or
    text for ``/metrics``)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"{path} returned {r.status}")
        raw = r.read().decode()
    return raw if path == "/metrics" else json.loads(raw)


def _metric(text: str, series: str, default: float | None = None) -> float:
    """The value of one exposition series line (``name{labels}``); a series
    not exposed (a counter never incremented) reads ``default`` if given."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    if default is not None:
        return default
    raise RuntimeError(f"chip_smoke check failed: /metrics has no series {series}")


def replay_f32_phase(dev) -> dict:
    """Phase 5's configuration (2-layer float32 Llama-3-8B widths): a seeded
    stochastic stream on the card, resumed on a new card engine at crash
    points 1 and 5 (the continuation must be token-exact: its first token
    comes from a prefill's last row, not a decode step), and greedy seeded
    rows on the card and on the CPU (the same tokens)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3-8b", n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    kw = dict(num_slots=1024, page_size=16, max_batch=2, long_prefill_threshold=16, prefill_chunk=64)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=150).tolist()
    seeded = SamplingParams(max_new_tokens=16, seed=4242, **REPLAY_SAMPLING)
    greedy_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (40, 90)]
    greedy = SamplingParams(max_new_tokens=12, seed=7)
    pa.reset_counters()
    e1 = Engine(cfg, params, device=dev, name="replay-f32-a", **kw)
    first = e1.add_request(prompt, seeded)
    _drain(e1)
    full = first.generated
    resumed = {}
    for k in (1, 5):
        e2 = Engine(cfg, params, device=dev, name=f"replay-f32-b{k}", **kw)
        r = e2.add_request(prompt, seeded, resume_tokens=full[:k])
        _drain(e2)
        resumed[k] = r.generated
        check(e2.stats.resurrections == 1, f"replay f32: crash point {k} not counted as a resume")
    greedy_out = {}
    eng = Engine(cfg, params, device=dev, name="replay-f32-greedy", **kw)
    reqs = [eng.add_request(p, greedy) for p in greedy_prompts]
    _drain(eng)
    greedy_out["cuda"] = [r.generated for r in reqs]
    counts = _counts(eng)
    torch.cuda.synchronize()
    launches = {"decode": pa.paged_decode_fused_kernel.launches,
                "chunk_cuda_core_body": pa.paged_chunk_attention_kernel.launches_f32_body,
                "plain_calls": pa.plain_calls()}
    cpu = Engine(cfg, params, device="cpu", name="replay-f32-cpu", **kw)
    reqs = [cpu.add_request(p, greedy) for p in greedy_prompts]
    _drain(cpu)
    greedy_out["cpu"] = [r.generated for r in reqs]
    print(f"[replay f32] seeded stream {full}; resumed at 1: {resumed[1]}; at 5: {resumed[5]}; "
          f"greedy seeded cuda={greedy_out['cuda']} cpu={greedy_out['cpu']}; card launches {launches}",
          flush=True)
    check(len(full) == 16, f"replay f32: {len(full)} tokens, expected 16")
    for k, got in resumed.items():
        check(got == full[k:], f"replay f32: the seeded continuation diverged at crash point {k}")
    check(greedy_out["cuda"] == greedy_out["cpu"], "replay f32: greedy seeded rows differ card vs CPU")
    check(launches["decode"] > 0 and launches["chunk_cuda_core_body"] > 0 and launches["plain_calls"] == 0,
          "replay f32: the decode kernel and the CUDA-core chunk body must run, no plain version")
    check(counts["compact_launches"] == counts["multi_step_launches"] == 0,
          "replay f32: a seeded batch took a compact or multi-step launch")
    del e1, e2, eng, cpu
    return {"stream": full, "resumed": resumed, "greedy": greedy_out, "launches": launches}


def decode_wall_phase(dev, model) -> dict:
    """Decode-step wall of 4 rows of 600-token prompts (temperature 0.9):
    unseeded with every plane off, with the planes at their defaults (the
    token timeline), with every plane on (timeline, step accounting, the
    recorder tracing every request) and seeded with the defaults. Per
    configuration, the median of three 8-step windows, one round (the
    serving phases before it warmed the same model's shapes)."""
    from radixmesh_tpu_torch.obs.trace_plane import FlightRecorder, get_recorder, set_recorder

    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=600).tolist() for _ in range(4)]
    out: dict[str, dict] = {name: {"medians_ms": [], "windows_ms": []} for name in WALL_CONFIGS}
    names = list(WALL_CONFIGS)
    old = get_recorder()
    try:
        for name in names:
            kw, sample, seeded = WALL_CONFIGS[name]
            set_recorder(FlightRecorder(capacity=1 << 16, sample=sample))
            eng = Engine(cfg, model, num_slots=8192, page_size=16, max_batch=4, device=dev, name=f"wall-{name}",
                         **kw)
            for i, p in enumerate(prompts):
                eng.add_request(p, SamplingParams(max_new_tokens=48, seed=100 + i if seeded else None,
                                                  **REPLAY_SAMPLING))
            eng.step()  # admission, the group prefill, a first decode step
            eng.step()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(8):
                    eng.step()
                walls.append((time.perf_counter() - t) / 8 * 1e3)
            check(sum(r is not None for r in eng._rows) == 4, f"decode walls {name}: a row finished early")
            mfu = None if eng.step_acct is None else eng.step_acct.report()["decode"]
            _drain(eng)
            out[name]["medians_ms"].append(float(np.median(walls)))
            out[name]["windows_ms"].append(walls)
            if mfu is not None:
                out[name]["step_accounting_decode"] = mfu
            del eng
            torch.cuda.empty_cache()
    finally:
        set_recorder(old)
    base = out["unseeded, planes off"]["medians_ms"]
    for name, r in out.items():
        r["vs_planes_off"] = [m / b for m, b in zip(r["medians_ms"], base)]
        r["median_ms"] = float(np.median(r["medians_ms"]))
        print(f"[decode walls] {name}: {r['median_ms']:.3f} ms/step (median of rounds "
              f"{[round(m, 3) for m in r['medians_ms']]}; x{[round(v, 3) for v in r['vs_planes_off']]} "
              f"of planes off in the same round); windows "
              f"{[[round(w, 2) for w in ws] for ws in r['windows_ms']]}", flush=True)
    acct = out["unseeded, planes on"]["step_accounting_decode"]
    print(f"[decode walls] step accounting (planes on, decode): mfu {acct['mfu']:.6f} over "
          f"{acct['waves']} waves, pad fraction {acct['pad_fraction']}", flush=True)
    out["sampler_ms"] = _sampler_walls(dev, cfg.vocab_size)
    print(f"[decode walls] the draw of 4 rows (host + device wall, median of 30): "
          f"{out['sampler_ms']}", flush=True)
    return out


def _sampler_walls(dev, vocab: int) -> dict:
    """What a step's draw costs for 4 rows at temperature 0.9 / top-p 0.95:
    one batched ``sample_tokens`` call (unseeded rows), the four ``[1, V]``
    seeded draws (``Engine._sample_seeded_rows``), and its parts (the
    top-k/top-p filter alone, four generators built and seeded)."""
    from radixmesh_tpu_torch.ops.sampling import _filtered_logits, sample_tokens

    logits = torch.randn(4, vocab, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    reqs = [Request(prompt=np.ones(600 + i, np.int32), sampling=SamplingParams(seed=100 + i, **REPLAY_SAMPLING))
            for i in range(4)]
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.full((1,), 0.9, device=dev)
    p = torch.full((1,), 0.95, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)

    def wall(fn, n=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ws = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ws.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ws))

    def generators():
        for r in reqs:
            torch.Generator(device=dev).manual_seed(Engine._seed_key(r))

    return {
        "batched_unseeded": wall(lambda: sample_tokens(
            logits, gen, temperature=np.full(4, 0.9, np.float32), top_p=np.full(4, 0.95, np.float32),
            top_k=np.zeros(4, np.int64)).cpu()),
        "seeded_rows": wall(lambda: Engine._sample_seeded_rows(list(zip(reqs, logits)))),
        "filter_x4": wall(lambda: [_filtered_logits(logits[i][None], t, p, k) for i in range(4)]),
        "generators_x4": wall(generators),
    }


def replay_http_phase(dev, model, card) -> dict:
    """Llama-3-8B bf16 over HTTP with the planes on (the recorder tracing
    every request, step accounting, a profile directory): 4 seeded
    requests at once (temperature 0.9, top-p 0.95), each seed alone twice
    (the same tokens, asserted), each resumed at crash points 1 and 5 (the
    share of continuations equal to the alone run's is printed, not
    asserted: bf16 logits of a prefill's last row and of a decode step
    differ). Then one ``/profile`` window over a decode and a chunked
    prefill, ``/metrics`` against ``/stats``, ``/debug/tokens`` and the
    MFU reading of ``/debug/state``."""
    from radixmesh_tpu_torch.obs.step_plane import detect_peak_tflops
    from radixmesh_tpu_torch.obs.trace_plane import FlightRecorder, get_recorder, set_recorder

    cfg = model.cfg
    prof_dir = OUT_DIR / "profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    old = get_recorder()
    set_recorder(FlightRecorder(capacity=1 << 16, sample=1.0, node="chip"))
    engine = Engine(cfg, model, num_slots=65536, page_size=16, max_batch=8, device=dev,
                    name="replay-bf16", step_accounting=True)
    fe = ServingFrontend(engine, port=0, profile_dir=str(prof_dir))
    rng = np.random.default_rng(3)
    prompts = {s: rng.integers(0, cfg.vocab_size, size=600 + 10 * s).tolist() for s in (1, 2, 3, 4)}
    n_tok = 32

    def body(seed, **extra):
        return {"input_ids": prompts[seed], "max_tokens": n_tok, "seed": seed, **REPLAY_SAMPLING, **extra}

    try:
        _post(fe.port, {"input_ids": rng.integers(0, cfg.vocab_size, size=64).tolist()})  # warm-up
        torch.cuda.synchronize()
        pa.reset_counters()
        batch: dict[int, list] = {}
        threads = [threading.Thread(target=lambda s=s: batch.__setitem__(s, _post(fe.port, body(s))))
                   for s in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        alone = {s: [_post(fe.port, body(s))["output_ids"] for _ in range(2)] for s in prompts}
        resumed = {k: {} for k in (1, 5)}
        for k in resumed:
            for s in prompts:
                r = _post(fe.port, body(s, resume_tokens=alone[s][0][:k]))
                check(r["resumed_from"] == k and len(r["output_ids"]) == n_tok - k,
                      f"replay bf16: resume at {k} answered {r.get('resumed_from')}, "
                      f"{len(r['output_ids'])} tokens")
                resumed[k][s] = r["output_ids"]
        share = {k: sum(resumed[k][s] == alone[s][0][k:] for s in prompts) / len(prompts) for k in resumed}
        token_share = {k: float(np.mean([np.mean(np.asarray(resumed[k][s]) == np.asarray(alone[s][0][k:]))
                                         for s in prompts])) for k in resumed}
        batch_vs_alone = {s: batch[s]["output_ids"] == alone[s][0] for s in prompts}

        # One profile window over a decode stream and a chunked prefill.
        prof: dict = {}
        t_prof = threading.Thread(target=lambda: prof.update(_http(fe.port, "/profile", {"seconds": 2.0})))
        t_prof.start()
        time.sleep(0.5)
        load = [threading.Thread(target=_post, args=(fe.port, {"input_ids": p, "max_tokens": 48}))
                for p in (rng.integers(0, cfg.vocab_size, size=3000).tolist(), prompts[1][:500])]
        for t in load:
            t.start()
        for t in load + [t_prof]:
            t.join()
        torch.cuda.synchronize()
        launches = {"paged_decode_fused": pa.paged_decode_fused_kernel.launches,
                    "paged_chunk_attention": pa.paged_chunk_attention_kernel.launches,
                    "cuda_core_chunk_body": pa.paged_chunk_attention_kernel.launches_f32_body,
                    "plain_calls": pa.plain_calls()}
        by_c = _chunk_by_c()
        with open(prof["trace"]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in n for n in kernels) for k in ("paged_decode_kernel", "paged_chunk_tc_kernel")}
        metrics = _http(fe.port, "/metrics")
        stats = _http(fe.port, "/stats")
        state = _http(fe.port, "/debug/state")
        tokens = _http(fe.port, "/debug/tokens?limit=32")
        trace = _http(fe.port, "/debug/trace")
    finally:
        fe.close(drain_s=0.0)
        set_recorder(old)
    lbl = '{engine="replay-bf16"}'
    scraped = {k: _metric(metrics, f"radixmesh_engine_{k}_total{lbl}")
               for k in ("prompt_tokens", "cached_tokens", "generated_tokens", "preemptions")}
    scraped["ttft_count"] = _metric(metrics, f"radixmesh_engine_ttft_seconds_count{lbl}")
    acct = state["step_accounting"]
    peak = acct["peak_tflops"]
    print(f"[replay bf16] batch of 4 seeded vs each alone (information only): {batch_vs_alone}; "
          f"resumed continuations equal to the alone run's at crash points 1 / 5: "
          f"{share[1]:.2f} / {share[5]:.2f} of requests, {token_share[1]:.3f} / {token_share[5]:.3f} "
          f"of tokens", flush=True)
    print(f"[replay bf16] profile {prof.get('logdir')}: {len(kernels)} kernel events, by name {named}, "
          f"device events {prof.get('device_events')}; launches {launches}", flush=True)
    print(f"[replay bf16] /metrics {scraped} vs /stats prompt={stats['prompt_tokens']} "
          f"cached={stats['cached_tokens']} generated={stats['generated_tokens']} "
          f"preemptions={stats['preemptions']} finished={stats['finished']}", flush=True)
    print(f"[replay bf16] /debug/tokens: appends {tokens['timeline']['appends']}, itl "
          f"{tokens['timeline']['itl']}, stalls {tokens['timeline']['stalls']}, goodput "
          f"{tokens['goodput']['tokens_per_second']} tokens/s", flush=True)
    print(f"[replay bf16] MFU (analytic 2*n_params FLOPs/token over {peak} TFLOP/s, {card}): decode "
          f"{acct['decode']['mfu']:.6f} over {acct['decode']['waves']} waves, prefill "
          f"{acct['prefill']['mfu']:.6f} over {acct['prefill']['waves']} waves", flush=True)
    for s in prompts:
        check(alone[s][0] == alone[s][1], f"replay bf16: seed {s} alone twice gave different tokens")
        check(len(batch[s]["output_ids"]) == n_tok, f"replay bf16: seed {s} returned too few tokens")
    check(named["paged_decode_kernel"] > 0 and named["paged_chunk_tc_kernel"] > 0,
          f"replay bf16: the profile's Chrome trace does not name the decode and chunk kernels ({named})")
    check(launches["paged_decode_fused"] > 0 and launches["paged_chunk_attention"] > 0
          and launches["plain_calls"] == 0 and launches["cuda_core_chunk_body"] == 0,
          f"replay bf16: kernel launches {launches}")
    check(scraped["prompt_tokens"] == stats["prompt_tokens"] and scraped["cached_tokens"] == stats["cached_tokens"]
          and scraped["generated_tokens"] == stats["generated_tokens"]
          and scraped["preemptions"] == stats["preemptions"], "replay bf16: /metrics disagrees with /stats")
    check(scraped["ttft_count"] == stats["finished"], "replay bf16: TTFT observations != finished requests")
    check(tokens["timeline"]["appends"] > 0 and tokens["timeline"]["recent"]
          and all(e["itl_s"] > 0 for e in tokens["timeline"]["recent"]), "replay bf16: /debug/tokens has no gaps")
    check(peak == detect_peak_tflops(dev) and (peak > 1.0 or "H100" not in card),
          f"replay bf16: MFU peak {peak} is not the card's")
    check(acct["decode"]["mfu"] > 0 and acct["prefill"]["mfu"] > 0, "replay bf16: no MFU reading")
    span_names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    check({"prefix_match", "prefill_wave", "decode_chunk", "first_token", "http_request"} <= span_names,
          f"replay bf16: /debug/trace spans {sorted(span_names)}")
    shutil.rmtree(prof_dir, ignore_errors=True)
    return {"batch_vs_alone": batch_vs_alone, "resume_match_share": share, "resume_token_share": token_share,
            "profile_kernels": named, "launches": launches, "chunk_by_c": by_c, "metrics": scraped, "mfu": acct,
            "tokens": {k: v for k, v in tokens["timeline"].items() if k != "recent"}}


# ---------------------------------------------------------------------------
# phase 13: the serving edge (SSE, the SLO control plane, the telemetry
# history and the black box)
# ---------------------------------------------------------------------------

# Tenants of the edge's SLO plane: name -> (weight, rate-limited), as
# ``--slo-tenant a=3 --slo-tenant b=1 --slo-tenant c=1:2000``.
EDGE_TENANTS = {"a": (3.0, False), "b": (1.0, False), "c": (1.0, True)}
EDGE_SCHEDULES = {"legacy": {}, "multi-step k=4": dict(decode_steps_per_launch=4),
                  "spec gamma=4": dict(spec_decode_tokens=4)}
# Sizes of phase 13 (``model`` and ``device`` name what the ``serve``
# child process runs; ``rate_c`` is tenant c's prompt tokens/s).
EDGE = dict(model="llama3-8b", device="cuda", kv_slots=65536, vocab=128256,
            sse_prompt=600, sse_tokens=32, sse_prompts=4,
            light_prompt=600, light_tokens=48, light_rounds=2,
            burst_prompt=2000, calibration=8, per_tenant=24, backlog=16, deadline_ms=1500,
            burst_tokens=16, backlog_tokens=128, rate_c=2000.0,
            wall_prompt=600, wall_rounds=1, wall_windows=3, kill_segments=6)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _edge_slo(rate_c: float):
    from radixmesh_tpu_torch.slo import SLOConfig, TenantConfig

    return SLOConfig(tenants={n: TenantConfig(weight=w, rate_tokens_per_s=rate_c if limited else 0.0)
                              for n, (w, limited) in EDGE_TENANTS.items()})


def _edge_frontend(engine, rate_c, blackbox_dir=None, slo=True) -> ServingFrontend:
    """The serving edge as ``serve --slo --slo-tenant ... --blackbox-dir D``
    builds it: the SLO plane, the history at 1.0 s, the black box with its
    watchdog at 10 intervals."""
    return ServingFrontend(engine, port=0, slo=_edge_slo(rate_c) if slo else None,
                           history_interval_s=1.0, blackbox_dir=blackbox_dir,
                           blackbox_watchdog_s=10.0 if blackbox_dir else 0.0)


def _capture_submits(fe) -> list:
    """Every request the frontend's runner builds, in submit order (the
    engine-side stamps the replies do not carry)."""
    reqs = []
    submit = fe.runner.submit

    def wrapped(*a, **k):
        req = submit(*a, **k)
        reqs.append(req)
        return req

    fe.runner.submit = wrapped
    return reqs


def _post_any(port, body, timeout=300, path="/generate") -> tuple[int, dict, dict]:
    """POST JSON (to ``/generate`` by default); ``(status, headers, body)``
    for any status."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _sse_post(port, body, timeout=300) -> tuple[list, list, float]:
    """A streamed /generate: the events, the client's receipt time of each
    (monotonic, the engine's clock: one process) and the send time."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    events, times = [], []
    t_sent = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.headers["Content-Type"].startswith("text/event-stream"),
              f"stream answered {r.headers['Content-Type']}")
        for line in r:
            if line.startswith(b"data: "):
                times.append(time.monotonic())
                events.append(json.loads(line[len(b"data: "):]))
                if events[-1].get("done"):
                    break
    return events, times, t_sent


def _pcts(xs) -> dict:
    xs = np.asarray(xs, dtype=np.float64)
    if xs.size == 0:
        return {"n": 0, "p50": float("nan"), "p99": float("nan"), "mean": float("nan")}
    return {"n": int(xs.size), "p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean()), "max": float(xs.max())}


def _release(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _edge_sse(dev, model, E, rng, bb_root) -> dict:
    """Each schedule in its own engine behind the edge. Four prompts, each
    streamed alone (a prefix-cache miss: the first-event delay, TTFT and
    the inter-event gaps), then sent twice at once, streamed and not, held
    at the SLO queue until both wait there so that one pump dispatches
    them into the same batch: the two must give the same tokens. Whether
    the miss's tokens equal theirs is printed, not asserted (in bf16 the
    hits recompute the prompt's last page through the chunk kernel and
    run in a batch of two, either of which can flip a near-tied greedy
    token)."""
    cfg = model.cfg
    out = {}
    prompts = [rng.integers(0, E["vocab"], size=E["sse_prompt"]).tolist() for _ in range(E["sse_prompts"])]
    for tag, kw in EDGE_SCHEDULES.items():
        slug = tag.split()[0]
        engine = Engine(cfg, model, num_slots=E["kv_slots"], page_size=16, max_batch=8, device=dev,
                        name=f"edge-sse-{slug}", **kw)
        fe = _edge_frontend(engine, E["rate_c"], blackbox_dir=str(bb_root / f"sse-{slug}"))
        reqs = _capture_submits(fe)
        rows = []

        def stream(body):
            # For the pair, reqs[n0] may be the other request of the batch:
            # both take the same first_token_time.
            n0 = len(reqs)
            events, times, t_sent = _sse_post(fe.port, body)
            tokens = [e["token"] for e in events[:-1]]
            check(events[-1] == {"done": True, "output_ids": tokens}
                  and all(set(e) == {"token"} for e in events[:-1]),
                  f"sse {tag}: the done event does not carry the events' tokens")
            check(len(tokens) == E["sse_tokens"], f"sse {tag}: {len(tokens)} events")
            return {"tokens": tokens, "delay_s": times[0] - reqs[n0].first_token_time,
                    "client_ttft_s": times[0] - t_sent, "gaps_s": np.diff(times[:-1]).tolist()}

        try:
            _post(fe.port, {"input_ids": rng.integers(0, E["vocab"], size=64).tolist(), "max_tokens": 4})
            for p in prompts:
                body = {"input_ids": p, "max_tokens": E["sse_tokens"], "tenant": "a",
                        "ttft_deadline_ms": 60000}
                miss = stream(body)
                pair: dict = {}
                with fe.runner._lock:  # no pump until both wait in the SLO queue
                    threads = [threading.Thread(target=lambda: pair.update(stream=stream(body))),
                               threading.Thread(target=lambda: pair.update(plain=_post(fe.port, body)))]
                    for t in threads:
                        t.start()
                    deadline = time.monotonic() + 60
                    while fe.runner.ctl.snapshot()["queued_requests"] < 2 and time.monotonic() < deadline:
                        time.sleep(0.001)
                for t in threads:
                    t.join(timeout=300)
                plain = pair["plain"]["output_ids"]
                rows.append({
                    "equal": pair["stream"]["tokens"] == plain,
                    "miss_equal": miss["tokens"] == plain,
                    "miss_first_differing": next((i for i, (a, b) in enumerate(zip(miss["tokens"], plain))
                                                  if a != b), None),
                    "miss": miss, "paired": pair["stream"],
                })
            counts = _counts(engine)
        finally:
            fe.close(drain_s=0.0)
        misses = [r["miss"] for r in rows]
        res = {"equal": [r["equal"] for r in rows], "miss_equal": [r["miss_equal"] for r in rows],
               "miss_first_differing": [r["miss_first_differing"] for r in rows],
               "first_event_delay_s": _pcts([x["delay_s"] for x in misses]),
               "first_event_delay_paired_s": _pcts([r["paired"]["delay_s"] for r in rows]),
               "delay_share_of_ttft": _pcts([x["delay_s"] / x["client_ttft_s"] for x in misses]),
               "client_ttft_s": _pcts([x["client_ttft_s"] for x in misses]),
               "gaps_s": _pcts([g for x in misses for g in x["gaps_s"]]), "engine_counts": counts}
        print(f"[edge sse {tag}] streamed == non-streamed in one batch: {res['equal']}; alone (a miss) "
              f"equal too: {res['miss_equal']} (first differing {res['miss_first_differing']}); first-event "
              f"delay alone p50 {res['first_event_delay_s']['p50'] * 1e3:.3f} ms p99 "
              f"{res['first_event_delay_s']['p99'] * 1e3:.3f} ms (paired p50 "
              f"{res['first_event_delay_paired_s']['p50'] * 1e3:.3f} ms), share of client TTFT p50 "
              f"{res['delay_share_of_ttft']['p50']:.5f} p99 {res['delay_share_of_ttft']['p99']:.5f}; client "
              f"TTFT p50 {res['client_ttft_s']['p50']:.4f} s; inter-event gaps alone p50 "
              f"{res['gaps_s']['p50'] * 1e3:.3f} ms p99 {res['gaps_s']['p99'] * 1e3:.3f} ms mean "
              f"{res['gaps_s']['mean'] * 1e3:.3f} ms over {res['gaps_s']['n']}; {counts}", flush=True)
        check(all(res["equal"]), f"sse {tag}: streamed tokens differ from the non-streamed reply")
        out[tag] = res
        del engine, fe
        _release(dev)
    return out


def _edge_light(dev, model, E, rng) -> dict:
    """One request at a time through a plain frontend and an SLO frontend,
    interleaved rounds (plain, SLO, then SLO, plain, ...): TTFT and the
    decode step wall, (e2e - TTFT) / (tokens - 1)."""
    cfg = model.cfg
    fes = {}
    for name, slo in (("plain runner", False), ("SLORunner", True)):
        engine = Engine(cfg, model, num_slots=E["kv_slots"], page_size=16, max_batch=8, device=dev,
                        name=f"edge-light-{'slo' if slo else 'plain'}")
        fes[name] = _edge_frontend(engine, E["rate_c"], slo=slo)
    out = {name: {"ttft_s": [], "step_ms": []} for name in fes}
    try:
        for fe in fes.values():
            _post(fe.port, {"input_ids": rng.integers(0, E["vocab"], size=64).tolist(), "max_tokens": 4})
        for rnd in range(E["light_rounds"]):
            for name in (list(fes) if rnd % 2 == 0 else list(fes)[::-1]):
                for _ in range(2):
                    body = {"input_ids": rng.integers(0, E["vocab"], size=E["light_prompt"]).tolist(),
                            "max_tokens": E["light_tokens"], "tenant": "a"}
                    r = _post(fes[name].port, body)
                    check(len(r["output_ids"]) == E["light_tokens"], f"light load {name}: short reply")
                    out[name]["ttft_s"].append(r["ttft_s"])
                    out[name]["step_ms"].append((r["e2e_s"] - r["ttft_s"]) / (E["light_tokens"] - 1) * 1e3)
        snap = fes["SLORunner"].runner.ctl.snapshot()
    finally:
        for fe in fes.values():
            fe.close(drain_s=0.0)
    for name in fes:
        r = out[name]
        r["ttft_median_s"] = float(np.median(r["ttft_s"]))
        r["step_median_ms"] = float(np.median(r["step_ms"]))
        print(f"[edge light] {name}: TTFT median {r['ttft_median_s']:.4f} s {[round(x, 4) for x in r['ttft_s']]}; "
              f"decode step median {r['step_median_ms']:.3f} ms {[round(x, 3) for x in r['step_ms']]}", flush=True)
    ratio = [s / p for s, p in zip(out["SLORunner"]["step_ms"], out["plain runner"]["step_ms"])]
    out["slo_over_plain_step"] = ratio
    out["slo_snapshot"] = {k: snap[k] for k in ("tier", "total_admitted", "total_shed", "prefill_tok_s_ewma")}
    print(f"[edge light] SLORunner / plain decode step, pair by pair {[round(x, 3) for x in ratio]}; "
          f"controller {out['slo_snapshot']}", flush=True)
    check(snap["total_shed"] == 0 and snap["tier"] == 0, f"light load shed or degraded: {snap}")
    del fes
    _release(dev)
    return out


def _edge_overload(dev, model, E, rng, bb_root, calibration="wave") -> dict:
    """Calibrate the controller's prefill-rate EWMA with ``calibration``
    prompts without deadlines, sent as one wave (``"wave"``) or one at a
    time (``"sequential"``), then a burst at once: tenants a and b (3:1)
    with ``per_tenant`` deadline prompts each and ``backlog`` prompts
    without a deadline. After the wave-calibrated burst, a burst of the
    rate-limited tenant c, ``/debug/timeseries`` and ``POST
    /admin/blackbox``. The serving engine runs spec gamma=4."""
    from radixmesh_tpu_torch.obs.blackbox import load_blackbox

    cfg = model.cfg
    main = calibration == "wave"
    engine = Engine(cfg, model, num_slots=E["kv_slots"], page_size=16, max_batch=8, device=dev,
                    name="edge-slo" if main else "edge-slo-seq", spec_decode_tokens=4)
    bb_dir = bb_root / f"overload-{calibration}"
    fe = _edge_frontend(engine, E["rate_c"], blackbox_dir=str(bb_dir))
    ctl = fe.runner.ctl
    folds: list[float] = []
    fold = ctl._fold_rate_locked

    def recording_fold(rate):  # runs with the controller's lock held
        folds.append(rate)
        fold(rate)

    ctl._fold_rate_locked = recording_fold
    reqs = _capture_submits(fe)
    base_spec = engine.spec_decode_tokens

    def fresh(n):
        return rng.integers(0, E["vocab"], size=n).tolist()

    def run_all(bodies) -> list:
        results = [None] * len(bodies)
        gate = threading.Barrier(len(bodies))

        def go(i, body):
            gate.wait()
            results[i] = _post_any(fe.port, body)

        threads = [threading.Thread(target=go, args=(i, b)) for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        return results

    samples = []
    stop = threading.Event()

    def monitor():
        while not stop.is_set():
            samples.append((fe.runner._applied_tier, engine.spec_decode_tokens))
            stop.wait(0.01)

    try:
        t0 = time.monotonic()
        calib_bodies = [{"input_ids": fresh(E["burst_prompt"]), "max_tokens": 8}
                        for _ in range(E["calibration"])]
        calib = run_all(calib_bodies) if main else [_post_any(fe.port, b) for b in calib_bodies]
        check(all(c == 200 for c, _, _ in calib), f"calibration: {[c for c, _, _ in calib]}")
        calib_ewma = ctl.snapshot()["prefill_tok_s_ewma"]
        calib_folds = len(folds)
        bodies = ([{"input_ids": fresh(E["burst_prompt"]), "max_tokens": E["burst_tokens"], "tenant": t,
                    "ttft_deadline_ms": E["deadline_ms"]} for t in ("a", "b") for _ in range(E["per_tenant"])]
                  + [{"input_ids": fresh(E["burst_prompt"]), "max_tokens": E["backlog_tokens"]}
                     for _ in range(E["backlog"])])
        bodies = [bodies[i] for i in rng.permutation(len(bodies))]
        mon = threading.Thread(target=monitor)
        mon.start()
        n_before = len(reqs)
        t_burst = time.monotonic()
        results = run_all(bodies)
        burst_s = time.monotonic() - t_burst
        # Back down the ladder: tier 0 and the base gamma after the hold.
        deadline = time.monotonic() + 30
        while (fe.runner._applied_tier or engine.spec_decode_tokens != base_spec) and time.monotonic() < deadline:
            time.sleep(0.02)
        stop.set()
        mon.join()
        recovered = (fe.runner._applied_tier, engine.spec_decode_tokens)
        steady_ewma = ctl.snapshot()["prefill_tok_s_ewma"]
        by_rid = {r.rid: r for r in reqs[n_before:]}
        if main:
            c_results = run_all([{"input_ids": fresh(E["burst_prompt"]), "max_tokens": 4, "tenant": "c"}
                                 for _ in range(4)])
            series = _http(fe.port, "/debug/timeseries?family=radixmesh_engine&limit=5000")
            slo_series = _http(fe.port, "/debug/timeseries?family=radixmesh_slo&limit=5000")
            waterfall = _http(fe.port, "/debug/waterfall")
            admin = _http(fe.port, "/admin/blackbox", {})
        snap = ctl.snapshot()
        tier_events = [list(e) for e in ctl.tier_events]
        counts = _counts(engine)
    finally:
        stop.set()
        fe.close(drain_s=0.0)
    table: dict[str, dict] = {}
    met, admitted_deadline, capped = 0, 0, []
    for body, (code, headers, reply) in zip(bodies, results):
        tenant = body.get("tenant", "default")
        key = "admitted" if code == 200 and not reply.get("shed") else f"{reply.get('reason')} ({code})"
        cell = table.setdefault(tenant, {}).setdefault(key, {"n": 0, "retry_after": []})
        cell["n"] += 1
        if "Retry-After" in headers:
            cell["retry_after"].append(int(headers["Retry-After"]))
        if code == 200 and "ttft_deadline_ms" in body and not reply.get("shed"):
            admitted_deadline += 1
            met += reply["ttft_s"] is not None and reply["ttft_s"] <= E["deadline_ms"] / 1e3
        r = by_rid.get(reply.get("rid")) if code == 200 else None
        if r is not None and r.degradation_tier >= 2 and body["max_tokens"] > 64:
            capped.append({"rid": r.rid, "tier": r.degradation_tier, "asked": body["max_tokens"],
                           "max_new_tokens": r.sampling.max_new_tokens, "output": len(reply["output_ids"])})
    max_tier = max((t for t, _ in samples), default=0)
    res = {
        "first_fold_tok_s": folds[0] if folds else None, "calibration_folds": calib_folds,
        "ewma_after_calibration": calib_ewma, "steady_ewma": steady_ewma,
        "folds_tok_s": [round(r, 1) for r in folds],
        "outcomes": table, "deadline_admitted": admitted_deadline,
        "deadline_met_share": met / admitted_deadline if admitted_deadline else None,
        "max_tier": max_tier, "tier_events": tier_events,
        "spec_during_tier": sorted({s for t, s in samples if t >= 1}),
        "recovered": recovered, "capped": capped[:3], "n_capped": len(capped),
        "burst_s": burst_s, "calibration_s": t_burst - t0, "snapshot": snap, "engine_counts": counts,
    }
    tag = f"[edge overload, {calibration} calibration]"
    print(f"{tag} EWMA prefill rate: first fold {res['first_fold_tok_s']} tokens/s, after calibration "
          f"{calib_ewma} ({calib_folds} folds), steady {steady_ewma}; folds {res['folds_tok_s'][:24]}", flush=True)
    print(f"{tag} burst of {len(bodies)} in {burst_s:.2f} s (calibration {res['calibration_s']:.2f} s): "
          f"outcomes {json.dumps(table, sort_keys=True)}", flush=True)
    print(f"{tag} deadline requests admitted {admitted_deadline} of {2 * E['per_tenant']}, TTFT <= "
          f"{E['deadline_ms']} ms: {res['deadline_met_share']}; highest tier {max_tier} (events "
          f"{tier_events}); spec_decode_tokens while tier >= 1: {res['spec_during_tier']}; after the hold "
          f"tier/spec {recovered}; capped at tier >= 2: {len(capped)} {capped[:2]}", flush=True)
    check(admitted_deadline > 0, f"{tag} no deadline request admitted")
    check(res["spec_during_tier"] in ([], [0]), f"{tag} spec decode ran at tier >= 1")
    check(recovered == (0, base_spec), f"{tag} tier/spec after the hold {recovered}")
    check(max_tier < 2 or capped, f"{tag} tier 2 reached but no backlog request was capped")
    check(all(c["max_new_tokens"] == 64 and c["output"] <= 64 for c in capped),
          f"{tag} a tier-2 request was not capped at 64: {capped[:3]}")
    if not main:
        # One request at a time, each first token folds over its own
        # window: the rate model the deadline and tier logic assume.
        check(max_tier >= 1, f"{tag} the burst reached no degradation tier")
        return res
    dump = load_blackbox(str(bb_dir))
    c_codes = [(c, h.get("Retry-After"), b.get("reason")) for c, h, b in c_results]
    res["rate_limited_c"] = c_codes
    res["blackbox"] = {"finals": dump["finals"], "causes": dump["causes"], "segments": dump["segments"],
                       "series": len(dump["series"])}
    print(f"{tag} rate-limited tenant c, burst of 4: {c_codes}; /debug/timeseries engine series "
          f"{len(series['series'])}, slo series {len(slo_series['series'])}; waterfall audited "
          f"{waterfall['audited']}; /admin/blackbox {admin['cause']} -> load_blackbox {res['blackbox']}",
          flush=True)
    check(any(c == 429 and ra is not None and int(ra) >= 1 for c, ra, _ in c_codes),
          f"{tag} tenant c's burst was not shed with 429 and Retry-After: {c_codes}")
    check(any('engine="edge-slo"' in n for n in series["series"]),
          f"{tag} /debug/timeseries has no series of the serving engine")
    check("admin" in dump["causes"] and dump["series"], f"{tag} black box {res['blackbox']}")
    del engine, fe
    _release(dev)
    return res


HISTORY_CONFIGS = {"history off": 0.0, "history 1.0 s": 1.0, "history 0.1 s": 0.1}


def _edge_history_walls(dev, model, E, rng) -> dict:
    """Decode step wall of 4 rows (greedy) with the history off, sampling
    every 1.0 s and every 0.1 s over the engine: the median of
    ``wall_windows`` 8-step windows per configuration, interleaved rounds
    (reversed every other one); the sampler's own cost from
    ``radixmesh_history_sample_seconds`` (in a registry of its own for these
    runs)."""
    from radixmesh_tpu_torch.obs.metrics import TRANSFER_SECONDS_BUCKETS, Registry, get_registry, set_registry
    from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory

    cfg = model.cfg
    prompts = [rng.integers(0, E["vocab"], size=E["wall_prompt"]).tolist() for _ in range(4)]
    names = list(HISTORY_CONFIGS)
    out = {n: {"medians_ms": [], "windows_ms": []} for n in names}
    old = set_registry(Registry())
    try:
        for rnd in range(E["wall_rounds"]):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                eng = Engine(cfg, model, num_slots=8192, page_size=16, max_batch=4, device=dev,
                             name=f"hist-{rnd}-{HISTORY_CONFIGS[name]}")
                hist = None
                if HISTORY_CONFIGS[name]:
                    hist = TelemetryHistory(interval_s=HISTORY_CONFIGS[name], engine=eng, node=eng.name).start()
                for p in prompts:
                    eng.add_request(p, SamplingParams(max_new_tokens=48))
                eng.step()
                eng.step()
                walls = []
                for _ in range(E["wall_windows"]):
                    _sync(dev)
                    t = time.perf_counter()
                    for _ in range(8):
                        eng.step()
                    _sync(dev)
                    walls.append((time.perf_counter() - t) / 8 * 1e3)
                check(sum(r is not None for r in eng._rows) == 4, f"history walls {name}: a row finished early")
                _drain(eng)
                if hist is not None:
                    hist.close()
                out[name]["medians_ms"].append(float(np.median(walls)))
                out[name]["windows_ms"].append(walls)
                del eng
        fam = get_registry().histogram("radixmesh_history_sample_seconds", buckets=TRANSFER_SECONDS_BUCKETS)
        n = fam.count
        q = {"count": n, "p50_s": fam.quantile(0.5), "p99_s": fam.quantile(0.99), "mean_s": fam.sum / max(1, n)}
    finally:
        set_registry(old)
    base = out["history off"]["medians_ms"]
    for name in names:
        r = out[name]
        r["median_ms"] = float(np.median(r["medians_ms"]))
        r["vs_off"] = [m / b for m, b in zip(r["medians_ms"], base)]
        print(f"[edge history] decode step {name}: {r['median_ms']:.3f} ms (rounds "
              f"{[round(m, 3) for m in r['medians_ms']]}, x{[round(v, 3) for v in r['vs_off']]} of off in "
              f"the same round)", flush=True)
    print(f"[edge history] radixmesh_history_sample_seconds over {q['count']} samples: p50 "
          f"{q['p50_s'] * 1e3:.3f} ms, p99 {q['p99_s'] * 1e3:.3f} ms, mean {q['mean_s'] * 1e3:.3f} ms", flush=True)
    check(q["count"] > 0, "history walls: the sampler never ran")
    out["sample_seconds"] = q
    return out


def _edge_kill(E) -> dict:
    """``launch.py serve --blackbox-dir D`` with the edge's flags in a child
    process; traffic (streamed and not); ``kill -9``. Every completed
    segment must load, the newest sample must be at most 2 intervals older
    than the kill, and no final may exist (the watchdog never fired)."""
    import signal
    import socket

    from radixmesh_tpu_torch.obs.blackbox import load_blackbox

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    bb_dir = OUT_DIR / "blackbox-kill"
    shutil.rmtree(bb_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "radixmesh_tpu_torch.launch", "serve", "--model", E["model"],
           "--device", E["device"], "--http-port", str(port), "--kv-slots", str(E["kv_slots"]),
           "--blackbox-dir", str(bb_dir), "--slo", "--slo-tenant", "a=3", "--slo-tenant", "b=1",
           "--spec-decode-tokens", "4"]
    log = open(OUT_DIR / "serve_blackbox.log", "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    stop = threading.Event()
    served: list[int] = []
    rng = np.random.default_rng(13)
    th = None
    try:
        while True:
            check(proc.poll() is None,
                  f"serve --blackbox-dir exited with {proc.returncode} (chip_out/serve_blackbox.log)")
            check(time.monotonic() - t0 < 300, "serve --blackbox-dir did not answer /healthz in 300 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
        ready_s = time.monotonic() - t0

        def traffic():
            i = 0
            while not stop.is_set():
                body = {"input_ids": rng.integers(0, E["vocab"], size=E["sse_prompt"]).tolist(),
                        "max_tokens": 16, "tenant": "ab"[i % 2]}
                try:
                    if i % 2:
                        served.append(len(_sse_post(port, body, timeout=120)[0]))
                    else:
                        served.append(len(_post(port, body)["output_ids"]))
                except (OSError, RuntimeError, ValueError):
                    return  # the server is gone
                i += 1

        th = threading.Thread(target=traffic)
        th.start()
        node_dir = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            subs = [d for d in bb_dir.iterdir() if d.is_dir()] if bb_dir.exists() else []
            if subs:
                node_dir = subs[0]
                if len(list(node_dir.glob("segment-*.json"))) >= E["kill_segments"] and len(served) >= 2:
                    break
            time.sleep(0.1)
        check(node_dir is not None, "serve --blackbox-dir wrote no dump directory")
        t_kill = time.time()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if th is not None:
            th.join(timeout=130)
        log.close()
    files = sorted(p.name for p in node_dir.iterdir())
    dump = load_blackbox(str(bb_dir))  # raises on a torn segment
    age = t_kill - (dump["last_t"] + dump["wall_offset"])
    res = {"ready_s": ready_s, "served": len(served), "segments": dump["segments"],
           "segment_files": sum(f.startswith("segment-") for f in files),
           "tmp_files": [f for f in files if ".tmp." in f], "finals": dump["finals"],
           "unclean": dump["unclean"], "newest_sample_age_s": age, "interval_s": dump["interval_s"],
           "series": len(dump["series"])}
    print(f"[edge kill -9] serve --blackbox-dir answered /healthz after {ready_s:.1f} s; {len(served)} "
          f"requests served; after the kill {res['segments']} segments loaded of {res['segment_files']} "
          f"files (temp files {res['tmp_files']}), finals {res['finals']}, unclean {res['unclean']}, newest "
          f"sample {age:.3f} s before the kill (interval {res['interval_s']} s), {res['series']} series",
          flush=True)
    check(res["segments"] == res["segment_files"] >= 1, "kill -9: a segment did not load")
    check(dump["unclean"] and dump["finals"] == 0, "kill -9: a final exists (the watchdog fired)")
    check(age <= 2 * dump["interval_s"], f"kill -9: the newest sample is {age:.3f} s older than the kill")
    shutil.rmtree(bb_dir, ignore_errors=True)
    return res


def serving_edge_phase(dev, model, E=EDGE) -> dict:
    """Phase 13: the serving edge at full width (module docstring)."""
    from radixmesh_tpu_torch.entry import entry

    fn, args = entry(device=dev)  # the port's entry(), on the card by default
    logits = fn(*args)
    check(logits.shape == (2, 16, 512) and bool(torch.isfinite(logits.float()).all()),
          f"entry(): logits {tuple(logits.shape)}")
    print(f"[edge] entry() on {logits.device}: logits {tuple(logits.shape)} {logits.dtype}, finite", flush=True)
    rng = np.random.default_rng(21)
    bb_root = pathlib.Path(tempfile.mkdtemp(prefix="edge-blackbox-", dir=OUT_DIR))
    _sync(dev)
    pa.reset_counters()
    try:
        out = {"sse": _edge_sse(dev, model, E, rng, bb_root)}
        out["light"] = _edge_light(dev, model, E, rng)
        out["overload"] = _edge_overload(dev, model, E, rng, bb_root)
        out["overload sequential"] = _edge_overload(dev, model, E, rng, bb_root, calibration="sequential")
        out["history"] = _edge_history_walls(dev, model, E, rng)
        _sync(dev)
        out["launches"] = {"paged_decode_fused": pa.paged_decode_fused_kernel.launches,
                           "paged_chunk_attention": pa.paged_chunk_attention_kernel.launches,
                           "cuda_core_chunk_body": pa.paged_chunk_attention_kernel.launches_f32_body,
                           "plain_calls": pa.plain_calls()}
        out["chunk_by_c"] = _chunk_by_c()
    finally:
        shutil.rmtree(bb_root, ignore_errors=True)
    print(f"[edge] launches on the edge's path (in process): {out['launches']}", flush=True)
    if torch.device(dev).type == "cuda":
        lc = out["launches"]
        check(lc["paged_decode_fused"] > 0 and lc["paged_chunk_attention"] > 0 and lc["plain_calls"] == 0
              and lc["cuda_core_chunk_body"] == 0, f"edge: kernel launches {lc}")
    _release(dev)
    out["kill"] = _edge_kill(E)
    return out


# ---------------------------------------------------------------------------
# phase 14: disaggregated prefill→decode handoff
# ---------------------------------------------------------------------------

# Sizes of phases 14 and 15 (a CPU rehearsal shrinks them): prompt
# lengths are drawn from ``lengths``; a streamed TCP packet carries at most
# ``tcp_chunk`` tokens (120 x 131072 B at Llama-3-8B bf16 plus the header
# stays under DEFAULT_MAX_MSG_BYTES, 16 MiB); the tail-only handoff shares
# ``tail_base`` tokens; ``f32_model`` names the widths of the 2-layer
# float32 legs.
HANDOFF = dict(n_prompts=8, lengths=(500, 3001), new_tokens=32, tcp_chunk=120, tail_base=2000,
               f32_model="llama3-8b", engine=dict(num_slots=32768, page_size=16, max_batch=8))
W8 = dict(decode_len=600, prefill_len=2000, rounds=2, decode_slots=4096, prefill_slots=20480,
          f32_model="llama3-8b")
TRANSPORTS = ("direct", "inproc", "tcp-py streamed", "device_kv")


def _b1_b2() -> dict:
    """The decode and chunk kernels' launches (both pool dtypes) and the
    plain versions' calls since the last reset."""
    c = pa.launch_counts()
    return {"b1": c["paged_decode_fused_kernel"], "b1_int8": c["paged_decode_fused_kernel[int8]"],
            "b2": c["paged_chunk_attention_kernel"], "b2_int8": c["paged_chunk_attention_kernel[int8]"],
            "plain": pa.plain_calls()}


class _Tapped:
    """A prefill worker whose gathers are copied aside (the reference bytes:
    the prefill pool's ``gather_raw`` of every shipped token) and whose
    prefills and handoffs are timed."""

    def __init__(self, pw):
        self.pw, self.ref, self.prefill_s = pw, {}, 0.0
        gather, admit = pw._gather, pw._admit_one_prompt

        def tap_gather(req, lo, hi):
            kv, sc = gather(req, lo, hi)
            self.ref.setdefault(req.prompt.tobytes(), []).append(
                (lo, kv.clone(), None if sc is None else sc.clone()))
            return kv, sc

        def tap_admit(prompt, sampling):
            t = time.perf_counter()
            req = admit(prompt, sampling)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t
            return req

        pw._gather, pw._admit_one_prompt = tap_gather, tap_admit

    def reference(self, prompt):
        """The gathered KV (and scales) of the shipped tokens of ``prompt``."""
        parts = sorted(self.ref[np.asarray(prompt, np.int32).tobytes()], key=lambda p: p[0])
        kv = torch.cat([p[1] for p in parts], dim=2)
        sc = None if parts[0][2] is None else torch.cat([p[2] for p in parts], dim=2)
        return kv, sc


def _pool_bits(pool, slots):
    kv, sc = pool.gather_raw(slots)
    return kv.contiguous(), None if sc is None else sc.contiguous()


def _same_bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _wait_pending(dw, n, timeout=120.0) -> float:
    """Wait until ``n`` requests are queued on ``dw``; returns the instant."""
    deadline = time.monotonic() + timeout
    while True:
        with dw._lock:
            got = len(dw._pending)
        if got >= n:
            return time.perf_counter()
        check(time.monotonic() < deadline, f"handoff: {got} of {n} requests arrived in {timeout} s")
        time.sleep(0.001)


def _handoff_transport(dev, model, transport, prompts, tag) -> dict:
    """One transport's handoff of ``prompts`` at Llama-3-8B width: a fresh
    prefill worker and a fresh decode worker, each with its own pool.
    Returns tokens, the decode side's TTFTs and decode wall, the prefill and
    decode launches, per-stage walls and the KV bit-equality verdict."""
    from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane
    from radixmesh_tpu_torch.comm.communicator import create_communicator
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, PrefillWorker, pack_handoff

    cfg = model.cfg
    sp = SamplingParams(max_new_tokens=HANDOFF["new_tokens"])
    pw = PrefillWorker(cfg, model, device=dev, long_prefill_threshold=0, name=f"pw-{tag}",
                       **HANDOFF["engine"])
    tap = _Tapped(pw)
    comm = rx = plane = None
    stage_layers = 8 if transport in ("inproc", "tcp-py streamed") else 0
    if transport == "inproc":
        InprocHub.reset_default()
        rx = create_communicator("inproc", "decode", None)
        comm = create_communicator("inproc", None, "decode")
    elif transport == "tcp-py streamed":
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        rx = create_communicator("tcp-py", f"127.0.0.1:{port}", None)
        comm = create_communicator("tcp-py", None, f"127.0.0.1:{port}")
        plane = KVTransferPlane(name=f"handoff-{tag}")
    dw = DecodeWorker(Engine(cfg, model, device=dev, name=f"dw-{tag}", **HANDOFF["engine"]), comm=rx,
                      plane=plane, stage_layers=stage_layers)
    nbytes = sum(len(p) for p in prompts) * kv_token_bytes(pw.pool)
    walls = {}
    try:
        torch.cuda.synchronize()
        pa.reset_counters()
        t0 = time.perf_counter()
        if transport == "tcp-py streamed":
            for p in prompts:
                pw.prefill_handoff_stream(p, sp, send=comm.send, chunk_tokens=HANDOFF["tcp_chunk"],
                                          plane=plane)
            prefill_launches = _b1_b2()
            t_arrived = _wait_pending(dw, len(prompts))
            walls["prefill_s"] = tap.prefill_s
            walls["pack_and_wire_s"] = t_arrived - t0 - tap.prefill_s
        else:
            pkts = [pw.prefill_handoff(p, sp, device_kv=transport == "device_kv") for p in prompts]
            torch.cuda.synchronize()
            prefill_launches = _b1_b2()
            t1 = time.perf_counter()
            walls["prefill_s"] = tap.prefill_s
            walls["pack_s"] = t1 - t0 - tap.prefill_s
            if transport == "inproc":
                for pkt in pkts:
                    comm.send(pack_handoff(pkt))
                walls["wire_s"] = _wait_pending(dw, len(prompts)) - t1
            else:
                for pkt in pkts:
                    dw.submit(pkt)
                walls["wire_s"] = time.perf_counter() - t1
            del pkts
        with dw._lock:
            order = {np.asarray(p, np.int32).tobytes(): i for i, p in enumerate(prompts)}
            reqs = sorted((r for r, _, _ in dw._pending), key=lambda r: order[r.prompt.tobytes()])
        pa.reset_counters()
        t = time.perf_counter()
        dw._admit_pending()
        torch.cuda.synchronize()
        walls["stage_write_s"] = time.perf_counter() - t
        check(all(r.state is RequestState.RUNNING for r in reqs), f"handoff {tag}: a request was not admitted")
        equal = []
        for r in reqs:
            kv, sc = _pool_bits(dw.engine.pool, r.token_slots[: len(r.prompt)])
            ref_kv, ref_sc = tap.reference(r.prompt)
            equal.append(_same_bits(kv, ref_kv) and (sc is None) == (ref_sc is None)
                         and (sc is None or _same_bits(sc, ref_sc)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        dw.run_until_drained()
        torch.cuda.synchronize()
        walls["decode_s"] = time.perf_counter() - t
        decode_launches = _b1_b2()
    finally:
        for c in (comm, rx):
            if c is not None:
                c.close()
        if plane is not None:
            plane.close()
    L = cfg.n_layers
    out = {
        "tokens": [r.generated for r in reqs], "kv_bit_equal": equal, "walls_s": walls,
        "kv_bytes": nbytes, "ttft_s": list(dw.engine.stats.ttft_s),
        "prefill_chunks": pw.stats.prefill_chunks, "decode_forwards": dw.engine.stats.decode_forwards,
        "prefill_launches": prefill_launches, "decode_launches": decode_launches,
        "lane_bytes": None if plane is None else plane.stats()["lane_bytes"]["handoff"],
    }
    moved_s = walls.get("pack_and_wire_s", walls.get("pack_s", 0.0) + walls.get("wire_s", 0.0))
    out["gb_per_s"] = nbytes / moved_s / 1e9 if moved_s > 0 else None
    print(f"[handoff {tag}] {len(prompts)} prompts {sum(len(p) for p in prompts)} tokens "
          f"({nbytes / 1e9:.3f} GB KV): walls {json.dumps({k: round(v, 4) for k, v in walls.items()})}; "
          f"{out['gb_per_s'] and round(out['gb_per_s'], 3)} GB/s over pack+wire; KV bit-equal {equal}; "
          f"prefill launches {prefill_launches} ({out['prefill_chunks']} chunk launches), decode launches "
          f"{decode_launches} ({out['decode_forwards']} decode passes)", flush=True)
    check(all(equal), f"handoff {tag}: the decode pool's KV differs from the prefill pool's gather")
    check(prefill_launches["b2"] == L * out["prefill_chunks"] > 0,
          f"handoff {tag}: prefill chunk launches != layers x chunk passes")
    check(prefill_launches["b1"] == prefill_launches["b1_int8"] == 0,
          f"handoff {tag}: the decode kernel ran on the prefill worker")
    check(decode_launches["b1"] == L * out["decode_forwards"] > 0,
          f"handoff {tag}: decode kernel launches != layers x decode passes")
    check(decode_launches["b2"] == 0, f"handoff {tag}: the chunk kernel ran on the decode worker")
    check(prefill_launches["plain"] == decode_launches["plain"] == 0, f"handoff {tag}: plain attention calls")
    check(all(len(t) == HANDOFF["new_tokens"] for t in out["tokens"]), f"handoff {tag}: short outputs")
    del pw, dw
    torch.cuda.empty_cache()
    return out


def _handoff_tail_only(dev, model, prompts) -> dict:
    """A tail-only handoff: a decode worker caches a prompt, then a second
    prompt sharing its first ``tail_base`` tokens ships only what the
    receiver does not cache (``skip_prefix`` from ``cached_prefix_len``)."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, PrefillWorker

    cfg = model.cfg
    sp = SamplingParams(max_new_tokens=8)
    n_base = HANDOFF["tail_base"]
    pw = PrefillWorker(cfg, model, device=dev, long_prefill_threshold=0, name="pw-tail", **HANDOFF["engine"])
    tap = _Tapped(pw)
    dw = DecodeWorker(Engine(cfg, model, device=dev, name="dw-tail", **HANDOFF["engine"]))
    base = np.random.default_rng(17).integers(0, cfg.vocab_size, size=n_base).tolist()
    first = base + prompts[1][:300]
    second = base + prompts[2][:300]
    dw.submit(pw.prefill_handoff(first, sp))
    dw.run_until_drained()
    skip = dw.cached_prefix_len(second)
    pkt = pw.prefill_handoff(second, sp, skip_prefix=skip)
    r = dw.submit(pkt)
    dw._admit_pending()
    kv, _ = _pool_bits(dw.engine.pool, r.token_slots[skip: len(second)])
    ref, _ = tap.reference(second)
    equal = _same_bits(kv, ref)
    dw.run_until_drained()
    print(f"[handoff tail-only] skip_prefix {skip} of {len(second)}: shipped {pkt.kv.shape[2]} tokens; "
          f"decode reused {dw.engine.stats.cached_tokens} cached tokens; tail KV bit-equal {equal}; "
          f"dropped {dw.dropped}; tokens {r.generated}", flush=True)
    check(skip == n_base and pkt.kv.shape[2] == len(second) - skip,
          "handoff tail-only: the packet did not skip the cached prefix")
    check(equal and dw.dropped == 0 and len(r.generated) == 8, "handoff tail-only: wrong tail or dropped")
    del pw, dw
    torch.cuda.empty_cache()
    return {"skip": skip, "shipped": int(pkt.kv.shape[2]), "tail_bit_equal": equal}


def _handoff_int8_legs(dev, model, prompts) -> dict:
    """An int8 prefill pool handing off to an int8 decode pool (the ints and
    scales bit-equal) and to a bf16 decode pool (the dequantized values,
    rounded to bf16, bit-equal)."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, PrefillWorker

    cfg = model.cfg
    sp = SamplingParams(max_new_tokens=8)
    out = {}
    for receiver in ("int8", None):
        tag = f"int8->{receiver or 'bf16'}"
        pw = PrefillWorker(cfg, model, device=dev, long_prefill_threshold=0, kv_quant="int8",
                           name=f"pw-{tag}", **HANDOFF["engine"])
        tap = _Tapped(pw)
        dw = DecodeWorker(Engine(cfg, model, device=dev, kv_quant=receiver, name=f"dw-{tag}",
                                 **HANDOFF["engine"]), stage_layers=8)
        pa.reset_counters()
        pkts = [pw.prefill_handoff(p, sp) for p in prompts]
        torch.cuda.synchronize()
        prefill_launches = _b1_b2()
        reqs = [dw.submit(pkt) for pkt in pkts]
        pa.reset_counters()
        dw._admit_pending()
        equal = []
        for r in reqs:
            kv, sc = _pool_bits(dw.engine.pool, r.token_slots[: len(r.prompt)])
            ref_kv, ref_sc = tap.reference(r.prompt)
            if receiver == "int8":
                equal.append(_same_bits(kv, ref_kv) and _same_bits(sc, ref_sc))
            else:
                equal.append(_same_bits(kv, dequantize_kv(ref_kv, ref_sc).to(torch.bfloat16)))
        dw.run_until_drained()
        torch.cuda.synchronize()
        decode_launches = _b1_b2()
        L = cfg.n_layers
        print(f"[handoff {tag}] {len(prompts)} prompts: KV bit-equal {equal}; prefill launches "
              f"{prefill_launches}; decode launches {decode_launches}; tokens {[r.generated for r in reqs]}",
              flush=True)
        check(all(equal), f"handoff {tag}: the decode pool's KV differs from the shipped int8 payload")
        check(prefill_launches["b2_int8"] == L * pw.stats.prefill_chunks > 0
              and prefill_launches["b1"] + prefill_launches["b1_int8"] == 0,
              f"handoff {tag}: prefill launches {prefill_launches}")
        b1 = decode_launches["b1_int8" if receiver else "b1"]
        check(b1 == L * dw.engine.stats.decode_forwards > 0 and decode_launches["plain"] == 0,
              f"handoff {tag}: decode launches {decode_launches}")
        out[tag] = {"kv_bit_equal": equal, "prefill_launches": prefill_launches,
                    "decode_launches": decode_launches, "tokens": [r.generated for r in reqs]}
        del pw, dw, pkts
        torch.cuda.empty_cache()
    return out


def _handoff_f32_leg(dev) -> dict:
    """2-layer float32 Llama-3-8B widths: disaggregated (over the wire
    bytes, layer-staged) against collocated on the card, and the card
    against the CPU."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, PrefillWorker, pack_handoff

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(HANDOFF["f32_model"], n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    kw = dict(num_slots=1024, page_size=16, max_batch=2, long_prefill_threshold=16, prefill_chunk=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (150, 40)]
    sp = SamplingParams(max_new_tokens=16)
    out = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        pw = PrefillWorker(cfg, params, device=device, **kw)
        dw = DecodeWorker(Engine(cfg, params, device=device, **kw), stage_layers=1)
        for p in prompts:
            dw._on_packet(pack_handoff(pw.prefill_handoff(p, sp)))
        reqs = [r for r, _, _ in dw._pending]
        dw.run_until_drained()
        out[name] = [r.generated for r in reqs]
    coll = Engine(cfg, params, device=dev, **kw)
    out["collocated cuda"] = [coll.generate([p], sp)[0] for p in prompts]
    print(f"[handoff f32] 2-layer f32 llama3-8b widths: disaggregated card {out['cuda']}, CPU {out['cpu']}; "
          f"collocated card {out['collocated cuda']}", flush=True)
    check(out["cuda"] == out["collocated cuda"], "handoff f32: disaggregated != collocated tokens on the card")
    check(out["cuda"] == out["cpu"], "handoff f32: card != CPU tokens")
    return out


def _warm_pinned(sizes) -> float:
    """Allocate and free pinned host blocks of ``sizes`` bytes, twice over
    (a packet's sender and receiver copies), so PyTorch's pinned host
    allocator has them cached as in a server that has been handing off for
    a while: the transports' walls then time copies, not page locking.
    Returns the seconds it took."""
    t = time.perf_counter()
    blocks = [torch.empty(n, dtype=torch.uint8, pin_memory=True) for n in list(sizes) * 2]
    del blocks
    return time.perf_counter() - t


def handoff_phase(dev, model) -> dict:
    """Phase 14: the disaggregated handoff at Llama-3-8B width (module
    docstring). Every transport ships the same bytes into the same decode
    batch, so every transport gives the same tokens."""
    cfg = model.cfg
    rng = np.random.default_rng(14)
    lengths = [int(n) for n in rng.integers(*HANDOFF["lengths"], size=HANDOFF["n_prompts"])]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]
    out = {"lengths": lengths, "transports": {}}
    if dev.type == "cuda":
        tok = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 KV bytes per token
        chunk = HANDOFF["tcp_chunk"]
        out["pinned_warmup_s"] = _warm_pinned([n * tok for n in lengths] + [chunk * tok] * 2
                                              + [(n % chunk or chunk) * tok for n in lengths])
        print(f"[handoff] pinned host allocator warmed in {out['pinned_warmup_s']:.2f} s", flush=True)
    for transport in TRANSPORTS:
        out["transports"][transport] = _handoff_transport(dev, model, transport, prompts, transport)
    runs = out["transports"]
    tokens = {t: r["tokens"] for t, r in runs.items()}
    check(all(tok == tokens["direct"] for tok in tokens.values()),
          f"handoff: transports gave different tokens: {[t for t in tokens if tokens[t] != tokens['direct']]}")
    # The collocated engine prefills the 8 prompts as one group (other
    # launch shapes, other bf16 rounding): its agreement is printed only.
    n_new = HANDOFF["new_tokens"]
    coll = Engine(cfg, model, device=dev, name="handoff-collocated", **HANDOFF["engine"])
    reqs = [coll.add_request(p, SamplingParams(max_new_tokens=n_new)) for p in prompts]
    coll.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _drain(coll)
    torch.cuda.synchronize()
    coll_decode_s = time.perf_counter() - t
    same = sum(a == b for r, d in zip(reqs, tokens["direct"]) for a, b in zip(r.generated, d))
    out["collocated"] = {"tokens_equal_share": same / (len(prompts) * n_new),
                         "ttft_s": list(coll.stats.ttft_s),
                         "decode_tok_s_per_request": (n_new - 2) / coll_decode_s}
    del coll
    torch.cuda.empty_cache()
    for t, r in runs.items():
        r["decode_tok_s_per_request"] = (n_new - 1) / r["walls_s"]["decode_s"]
    print(f"[handoff] tokens equal across {len(runs)} transports; share equal to a collocated engine's "
          f"{out['collocated']['tokens_equal_share']:.4f}; TTFT p50 decode side (direct) "
          f"{np.median(runs['direct']['ttft_s']):.4f} s vs collocated {np.median(out['collocated']['ttft_s']):.4f} s; "
          f"decode tokens/s per request {json.dumps({t: round(r['decode_tok_s_per_request'], 2) for t, r in runs.items()})} "
          f"vs collocated {out['collocated']['decode_tok_s_per_request']:.2f}", flush=True)
    out["tail_only"] = _handoff_tail_only(dev, model, prompts)
    out["int8"] = _handoff_int8_legs(dev, model, prompts[:2])
    out["f32"] = _handoff_f32_leg(dev)
    for r in runs.values():
        r.pop("tokens")
    return out


# ---------------------------------------------------------------------------
# phase 15: W8A16 weights
# ---------------------------------------------------------------------------

def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _w8_walls(dev, models: dict) -> dict:
    """Decode step wall at 4 x 600 and prefill step wall at 8 x 2000, bf16
    against W8A16, interleaved in one process (order reversed every other
    round). Each wall: decode, the median of five 8-step windows; prefill,
    one admission step of the 8 prompts (one group prefill plus the first
    decode step). The W8A16 runs' launches are counted."""
    cfg = next(iter(models.values())).cfg
    rng = np.random.default_rng(15)
    dec_prompts = [rng.integers(0, cfg.vocab_size, size=W8["decode_len"]).tolist() for _ in range(4)]
    pre_prompts = [rng.integers(0, cfg.vocab_size, size=W8["prefill_len"]).tolist() for _ in range(8)]
    walls = {name: {"decode_ms": [], "prefill_ms": []} for name in models}
    launches = {"b1": 0, "b2": 0, "plain": 0, "decode_forwards": 0, "prefill_chunks": 0}
    names = list(models)
    for rnd in range(W8["rounds"]):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            model = models[name]
            if name == "w8a16":
                pa.reset_counters()
            eng = Engine(cfg, model, num_slots=W8["decode_slots"], page_size=16, max_batch=4, device=dev,
                         name=f"w8-d-{rnd}")
            for p in dec_prompts:
                eng.add_request(p, SamplingParams(max_new_tokens=48))
            eng.step()
            eng.step()
            ws = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(8):
                    eng.step()
                ws.append((time.perf_counter() - t) / 8 * 1e3)
            _drain(eng)
            st = _counts(eng)
            del eng
            eng = Engine(cfg, model, num_slots=W8["prefill_slots"], page_size=16, max_batch=8, device=dev,
                         name=f"w8-p-{rnd}")
            for p in pre_prompts:
                eng.add_request(p, SamplingParams(max_new_tokens=2))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t) * 1e3
            _drain(eng)
            if name == "w8a16":
                torch.cuda.synchronize()
                c = _b1_b2()
                launches["b1"] += c["b1"]
                launches["b2"] += c["b2"]
                launches["plain"] += c["plain"]
                launches["decode_forwards"] += st["decode_forwards"] + eng.stats.decode_forwards
                launches["prefill_chunks"] += st["prefill_chunks"] + eng.stats.prefill_chunks
            del eng
            torch.cuda.empty_cache()
            if rnd > 0:
                walls[name]["decode_ms"].append(float(np.median(ws)))
                walls[name]["prefill_ms"].append(pre_ms)
    return {"walls": walls, "launches": launches}


def _w8_f32_leg(dev) -> dict:
    """2-layer float32 Llama-3-8B widths with W8A16 weights: the card's
    greedy tokens equal the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(W8["f32_model"], n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    kw = dict(num_slots=1024, page_size=16, max_batch=2, long_prefill_threshold=16, prefill_chunk=64,
              weight_quant="int8")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (150, 40)]
    out, logits = {}, {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        eng = Engine(cfg, params, device=device, **kw)
        logits[name] = []
        eng.on_first_logits = lambda req, row, name=name: logits[name].append(row.float().cpu())
        out[name] = eng.generate(prompts, SamplingParams(max_new_tokens=16))
        check(eng.model.layers["wq"].dtype == torch.int8, "w8a16 f32: the weights are not int8")
    diff = max((a - b).abs().max().item() for a, b in zip(logits["cuda"], logits["cpu"]))
    print(f"[w8a16 f32] 2-layer f32 llama3-8b widths, W8A16: first-token logits max|cuda-cpu| {diff:.3e}; "
          f"tokens cuda={out['cuda']} cpu={out['cpu']}", flush=True)
    check(out["cuda"] == out["cpu"], "w8a16 f32: card vs CPU greedy tokens differ")
    return {"tokens": out, "logits_max_abs_diff": diff}


def w8a16_phase(dev, model) -> dict:
    """Phase 15: W8A16 weights at Llama-3-8B width, beside the bf16 model."""
    from radixmesh_tpu_torch.ops.wquant import quantize_params

    cfg = model.cfg
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.inference_mode():
        w8 = Llama(cfg, quantize_params(model.param_tree()))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    resident = {"bf16_bytes": _param_bytes(model), "w8a16_bytes": _param_bytes(w8),
                "w8a16_allocated_delta": torch.cuda.memory_allocated() - before,
                "quantize_peak_over_before": torch.cuda.max_memory_allocated() - before,
                "quantize_s": quant_s}
    print(f"[w8a16] resident weights: bf16 {resident['bf16_bytes'] / 1e9:.3f} GB, W8A16 "
          f"{resident['w8a16_bytes'] / 1e9:.3f} GB (allocated delta {resident['w8a16_allocated_delta'] / 1e9:.3f} GB; "
          f"quantize peak over the bf16 model {resident['quantize_peak_over_before'] / 1e9:.3f} GB, "
          f"{quant_s:.2f} s)", flush=True)
    check(w8.weight_quant == "int8" and resident["w8a16_bytes"] < 0.51 * resident["bf16_bytes"],
          "w8a16: the int8 model is not about half the bf16 bytes")
    # Accuracy (reported): first-token logits and 32 greedy tokens.
    prompt = np.random.default_rng(16).integers(0, cfg.vocab_size, size=W8["decode_len"]).tolist()
    acc = {}
    for name, m in (("bf16", model), ("w8a16", w8)):
        eng = Engine(cfg, m, num_slots=W8["decode_slots"], page_size=16, max_batch=4, device=dev,
                     name=f"w8-acc-{name}")
        rows = []
        eng.on_first_logits = lambda req, row: rows.append(row.float())
        acc[name] = (eng.generate([prompt], SamplingParams(max_new_tokens=32))[0], rows[0])
        del eng
    logit_diff = (acc["bf16"][1] - acc["w8a16"][1]).abs().max().item()
    agree = sum(a == b for a, b in zip(acc["bf16"][0], acc["w8a16"][0])) / 32
    print(f"[w8a16] first-token logits max|bf16 - w8a16| {logit_diff:.4f} (bf16 max|logit| "
          f"{acc['bf16'][1].abs().max().item():.4f}); greedy agreement over 32 tokens {agree:.4f}", flush=True)
    walls = _w8_walls(dev, {"bf16": model, "w8a16": w8})
    L = cfg.n_layers
    lc = walls["launches"]
    med = {n: {k: float(np.median(v)) for k, v in w.items()} for n, w in walls["walls"].items()}
    print(f"[w8a16] walls over {W8['rounds'] - 1} interleaved rounds (median): "
          f"{json.dumps({n: {k: round(v, 3) for k, v in m.items()} for n, m in med.items()})}; per round "
          f"{json.dumps(walls['walls'])}; W8A16 decode x{med['w8a16']['decode_ms'] / med['bf16']['decode_ms']:.3f}, "
          f"prefill x{med['w8a16']['prefill_ms'] / med['bf16']['prefill_ms']:.3f} of bf16; W8A16 launches {lc}",
          flush=True)
    check(lc["b1"] == L * lc["decode_forwards"] > 0 and lc["b2"] == L * lc["prefill_chunks"] > 0
          and lc["plain"] == 0, f"w8a16: launches {lc}")
    del w8
    torch.cuda.empty_cache()
    return {"resident": resident, "logits_max_abs_diff_vs_bf16": logit_diff, "greedy_agreement_32": agree,
            "walls": walls["walls"], "median_ms": med, "launches": lc, "f32": _w8_f32_leg(dev)}


# ---------------------------------------------------------------------------
# phase 16: the LM head's float32 product, and the cache mesh
# ---------------------------------------------------------------------------

# Sizes of phase 16 (a CPU rehearsal shrinks them). (a) ``prompts`` prompts
# of ``prompt_len`` tokens served on p0, routed back with ``extra`` new
# tokens; (b) ``scale_prefixes`` advertised prefixes of ``scale_len``
# tokens, ``match_samples`` router matches; (c) decode walls of
# ``wall_rows`` x ``wall_len`` while d0 advertises ``traffic_per_s``
# prefixes a second; (d) two ``launch.py node`` processes with
# ``node_slots`` KV slots each.
MESH = dict(prompts=8, prompt_len=2000, extra=64, new_tokens=8, f32_prompts=4, f32_layers=2,
            engine=dict(num_slots=65536, page_size=16, max_batch=8),
            scale_prefixes=800, scale_len=2000, match_samples=2000,
            wall_rows=4, wall_len=600, wall_rounds=1, wall_windows=3, wall_slots=8192, traffic_per_s=50,
            node_model="llama3-8b", node_slots=16384, head_rows=(4, 8), head_prompts=4, head_len=600,
            head_tokens=32)
MESH_PAGE = 16
MESH_PROTOCOLS = ("inproc", "tcp", "tcp-py")


def _logits_rounded(self, x):
    """The LM head as the port computed it before its float32-output
    product: the product in the model dtype, widened afterwards."""
    from radixmesh_tpu_torch.ops.norm import rms_norm

    x = rms_norm(x, self.final_norm, self.cfg.rms_eps)
    if self.cfg.tie_embeddings:
        w, s = self.embed.t(), self.embed_s
    else:
        w, s = self.lm_head, self.lm_head_s
    if s is None:
        return torch.matmul(x, w).float()
    return torch.matmul(x, w.to(x.dtype)) * s


def head_phase(dev, model) -> dict:
    """The LM head of a decode step (``Llama._logits`` over ``B`` rows),
    float32-output product against the bf16 product widened afterwards:
    device time, and the greedy tokens of the same bf16 requests served
    with each."""
    from radixmesh_tpu_torch.models.llama import Llama as _Llama

    cfg = model.cfg
    out: dict = {"rows": {}}
    gen = torch.Generator(device=dev).manual_seed(5)
    for rows in MESH["head_rows"]:
        x = torch.randn(rows, 1, cfg.hidden, generator=gen, device=dev, dtype=cfg.dtype)
        with torch.inference_mode():
            new, old = model._logits(x), _logits_rounded(model, x)
            out["rows"][rows] = {
                "f32_output_ms": time_ms(lambda: model._logits(x), 30, dev),
                "bf16_widened_ms": time_ms(lambda: _logits_rounded(model, x), 30, dev),
                "max_abs_diff": float((new - old).abs().max()),
                "argmax_flips": int((new.argmax(-1) != old.argmax(-1)).sum()),
                "on_bf16_grid_after": bool(torch.equal(new, new.to(torch.bfloat16).float())),
            }
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, MESH["head_len"]).tolist() for _ in range(MESH["head_prompts"])]
    sp = SamplingParams(max_new_tokens=MESH["head_tokens"])
    toks = {}
    for tag in ("after", "before"):
        if tag == "before":
            _Llama._logits, saved = _logits_rounded, _Llama._logits
        try:
            eng = Engine(cfg, model, num_slots=8192, page_size=16, max_batch=4, device=dev, name=f"head-{tag}")
            toks[tag] = eng.generate(prompts, sp)
        finally:
            if tag == "before":
                _Llama._logits = saved
        del eng
    same = [a == b for ra, rb in zip(toks["after"], toks["before"]) for a, b in zip(ra, rb)]
    out["greedy_tokens_equal_share"] = sum(same) / len(same)
    out["greedy_rows_equal"] = sum(ra == rb for ra, rb in zip(toks["after"], toks["before"]))
    first = [next((i for i, (a, b) in enumerate(zip(ra, rb)) if a != b), None)
             for ra, rb in zip(toks["after"], toks["before"])]
    out["first_divergent_token"] = first
    for rows, r in out["rows"].items():
        check(not r["on_bf16_grid_after"], f"head: float32-output logits at B={rows} sit on the bf16 grid")
        print(f"[head] B={rows}: LM head {r['f32_output_ms']:.4f} ms with a float32 output vs "
              f"{r['bf16_widened_ms']:.4f} ms bf16 widened; max |diff| {r['max_abs_diff']:.5f}, "
              f"{r['argmax_flips']} argmax flips", flush=True)
    print(f"[head] bf16 greedy tokens after vs before the fix: {out['greedy_rows_equal']}/{len(prompts)} rows "
          f"equal, token share {out['greedy_tokens_equal_share']:.3f}, first divergent {first}", flush=True)
    torch.cuda.empty_cache()
    return out


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _ring_addrs(protocol: str) -> list[str]:
    """Addresses of p0, d0 and r0 on ``protocol``."""
    if protocol == "inproc":
        from radixmesh_tpu_torch.comm.inproc import InprocHub

        InprocHub.reset_default()
        return ["p0", "d0", "r0"]
    return [f"127.0.0.1:{p}" for p in _free_ports(3)]


def _ring_config(addrs: list[str], i: int, protocol: str):
    from radixmesh_tpu_torch.config import MeshConfig

    # A replica bound of 2^21 tokens holds the scale leg's 1.6M unfolded.
    return MeshConfig(prefill_nodes=[addrs[0]], decode_nodes=[addrs[1]], router_nodes=[addrs[2]],
                      local_addr=addrs[i], protocol=protocol, page_size=MESH_PAGE,
                      tick_interval_s=0.05, gc_interval_s=30.0, mesh_max_tokens=1 << 21)


def _mesh_ring(protocol: str):
    """p0, d0 and r0 as three ``MeshCache`` replicas in this process (the
    serving nodes' replicas advertisement-only) and the router."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

    addrs = _ring_addrs(protocol)
    meshes = [MeshCache(_ring_config(addrs, i, protocol), pool=None).start() for i in range(3)]
    for m in meshes:
        check(m.wait_ready(timeout=60), f"mesh {protocol}: rank {m.rank} never passed the startup barrier")
    router = CacheAwareRouter(meshes[2], meshes[2].cfg)
    router.finish_warm_up()
    return addrs, meshes, router


def _close_ring(meshes) -> None:
    for m in meshes:
        m.close()


def _attribution_watch(router_mesh, prompts, t_attr, stop):
    """Poll the router replica until each prompt is attributed whole to
    prefill rank 0; stamp the moment."""
    while not stop.is_set() and len(t_attr) < len(prompts):
        for i, p in enumerate(prompts):
            if i not in t_attr:
                r = router_mesh.match_prefix(p)
                if r.prefill_rank == 0 and r.match_len >= len(p) - len(p) % MESH_PAGE:
                    t_attr[i] = time.monotonic()
        time.sleep(0.0005)


def _mesh_serving_leg(dev, model, protocol: str, n_prompts: int, tag: str) -> dict:
    """Serve → publish → replicate → route back → serve from the cache, on
    one ring: ``n_prompts`` prompts on p0; each prompt attributed to p0 at
    the router (the lag from the end of p0's publish); each routed back with
    ``extra`` new tokens as a p0 hit and served there alone, then served
    alone on d0 as a miss."""
    cfg = model.cfg
    addrs, meshes, router = _mesh_ring(protocol)
    try:
        p0 = Engine(cfg, model, mesh=meshes[0], name=f"{tag}-p0", device=dev, **MESH["engine"])
        d0 = Engine(cfg, model, mesh=meshes[1], name=f"{tag}-d0", device=dev, **MESH["engine"])
        rng = np.random.default_rng(16)
        prompts = [rng.integers(0, cfg.vocab_size, MESH["prompt_len"]).tolist() for _ in range(n_prompts)]
        key16 = {tuple(p[:16]): i for i, p in enumerate(prompts)}
        t_pub: dict[int, float] = {}
        insert = meshes[0].insert

        def timed_insert(key, slots, **kw):
            n = insert(key, slots, **kw)
            i = key16.get(tuple(int(t) for t in key[:16]))
            if i is not None and len(key) >= MESH["prompt_len"] - MESH["prompt_len"] % MESH_PAGE:
                t_pub.setdefault(i, time.monotonic())
            return n

        meshes[0].insert = timed_insert
        t_attr: dict[int, float] = {}
        stop = threading.Event()
        watcher = threading.Thread(target=_attribution_watch, args=(meshes[2], prompts, t_attr, stop),
                                   daemon=True)
        pa.reset_counters()
        watcher.start()
        t = time.monotonic()
        first = p0.generate(prompts, SamplingParams(max_new_tokens=MESH["new_tokens"]))
        serve_s = time.monotonic() - t
        watcher.join(timeout=60)
        stop.set()
        check(len(t_attr) == n_prompts, f"mesh {tag}: the router attributed {len(t_attr)}/{n_prompts} prompts to p0")
        lag_ms = [1e3 * (t_attr[i] - t_pub[i]) for i in range(n_prompts)]
        extra = [rng.integers(0, cfg.vocab_size, MESH["extra"]).tolist() for _ in range(n_prompts)]
        routed = [p + e for p, e in zip(prompts, extra)]
        aligned = MESH["prompt_len"] - MESH["prompt_len"] % MESH_PAGE
        routes = [router.cache_aware_route(r) for r in routed]
        for r in routes:
            check(r.prefill_addr == addrs[0] and r.prefill_cache_hit and r.match_len >= aligned,
                  f"mesh {tag}: a shared-prefix request routed to {r} (want {addrs[0]}, a hit of >= {aligned})")
        hits = [_serve_alone(p0, r, MESH["new_tokens"]) for r in routed]
        p0_counts = {**_b1_b2(), "f32_body": pa.paged_chunk_attention_kernel.launches_f32_body}
        pa.reset_counters()
        misses = [_serve_alone(d0, r, MESH["new_tokens"]) for r in routed]
        d0_counts = {**_b1_b2(), "f32_body": pa.paged_chunk_attention_kernel.launches_f32_body}
        for name, c in (("p0", p0_counts), ("d0", d0_counts)):
            check(c["b1"] > 0 and c["b2"] > 0 and c["plain"] == 0,
                  f"mesh {tag}: {name} launched decode {c['b1']}, chunk {c['b2']}, plain {c['plain']}")
        check(all(h[1] >= aligned for h in hits), f"mesh {tag}: routed hits cached {[h[1] for h in hits]}")
        check(all(m[1] == 0 for m in misses), f"mesh {tag}: d0 misses cached {[m[1] for m in misses]}")
        same = [a == b for h, m in zip(hits, misses) for a, b in zip(h[0], m[0])]
        out = {
            "protocol": protocol, "serve_s": serve_s, "first_tokens": first,
            "lag_ms": lag_ms, "lag_p50_ms": float(np.percentile(lag_ms, 50)),
            "lag_p99_ms": float(np.percentile(lag_ms, 99)),
            "match_len": [r.match_len for r in routes],
            "cached_tokens": [h[1] for h in hits],
            "hit_ttft_s": [h[2] for h in hits], "miss_ttft_s": [m[2] for m in misses],
            "hit_tokens": [h[0] for h in hits], "miss_tokens": [m[0] for m in misses],
            "tokens_equal_share": sum(same) / len(same),
            "launches": {"p0": p0_counts, "d0": d0_counts},
        }
        return out
    finally:
        meshes[0].__dict__.pop("insert", None)
        _close_ring(meshes)


def _scale_replica(i: int, addrs: list, protocol: str, conn) -> None:
    """One replica of the ring in its own process. For the scale leg p0
    inserts the prefixes, d0 and r0 report when every one has landed, r0
    times router matches; for the wall leg d0 advertises a stream of
    prefixes (``traffic``) until told to stop. Commands arrive on
    ``conn``."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache

    def rss_mb() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return float("nan")

    mesh = MeshCache(_ring_config(addrs, i, protocol), pool=None).start()
    try:
        conn.send(("ready", mesh.wait_ready(timeout=60), rss_mb()))
        while True:
            cmd, *arg = conn.recv()
            if cmd == "close":
                break
            if cmd == "traffic":
                sent = _traffic(mesh, arg[0], conn.poll, arg[1])
                conn.recv()  # "stop"
                conn.send(("stopped", sent))
                continue
            n, length, seed = arg[:3]
            keys = np.random.default_rng(seed).integers(0, 128256, (n, length), dtype=np.int32)
            if cmd == "insert":
                rss0 = rss_mb()
                t0 = time.time()
                for j in range(n):
                    mesh.insert(keys[j], np.arange(j * length, (j + 1) * length, dtype=np.int32))
                conn.send(("inserted", t0, time.time(), rss0,
                           float(mesh._g_bytes_per_insert.value)))
            elif cmd == "await":
                rss0 = rss_mb()
                # A fresh lag histogram: only this leg's frames.
                mesh._m_lag = mesh._m_lag._new_child()
                conn.send(("armed",))
                deadline = time.monotonic() + arg[3]
                tree = mesh.tree
                # The tree's token count is read without the mesh lock, so
                # waiting costs the apply path nothing; every key is
                # matched once after.
                while tree.evictable_size_ + tree.protected_size_ < n * length and time.monotonic() < deadline:
                    time.sleep(0.001)
                t_done = time.time()
                if mesh.role.value == "router":
                    pending = [j for j in range(n) if mesh.match_prefix(keys[j]).match_len < length]
                else:
                    pending = [j for j in range(n) if mesh.match_prefix(keys[j]).length < length]
                conn.send(("landed", t_done, len(pending), rss0, rss_mb(),
                           mesh._m_lag.quantile(0.5), mesh._m_lag.quantile(0.99),
                           mesh.tree.evictable_size_ + mesh.tree.protected_size_))
            elif cmd == "match":
                rng = np.random.default_rng(seed + 1)
                us = []
                for j in rng.integers(0, n, arg[3]):
                    cut = int(rng.integers(MESH_PAGE, length + 1))
                    t = time.perf_counter()
                    mesh.match_prefix(keys[j, :cut])
                    us.append(1e6 * (time.perf_counter() - t))
                conn.send(("matched", float(np.percentile(us, 50)), float(np.percentile(us, 99))))
            elif cmd == "rss":
                conn.send(("rss", rss_mb()))
    finally:
        mesh.close()
        conn.close()


def _ring_scale_leg(protocol: str) -> dict:
    """p0, d0 and r0 in three processes: p0 advertises ``scale_prefixes``
    prefixes of ``scale_len`` tokens; the inserts applied per second at
    r0 and d0, bytes per insert at p0, r0's apply lag, r0's
    ``match_prefix`` time and each replica's RSS growth."""
    addrs = _ring_addrs(protocol)
    pipes, procs = _spawn_replicas(addrs, protocol, (0, 1, 2))
    n, length = MESH["scale_prefixes"], MESH["scale_len"]
    try:
        ready = [c.recv() for c in pipes]
        check(all(r[1] for r in ready), f"ring scale {protocol}: a replica never became ready: {ready}")
        for c in pipes[1:]:
            c.send(("await", n, length, 7, 300.0))
        for c in pipes[1:]:
            check(c.recv() == ("armed",), f"ring scale {protocol}: a replica did not arm")
        pipes[0].send(("insert", n, length, 7))
        _, t0, t_inserted, p0_rss0, bytes_per_insert = pipes[0].recv()
        landed = {name: c.recv() for name, c in zip(("d0", "r0"), pipes[1:])}
        for name, r in landed.items():
            check(r[2] == 0, f"ring scale {protocol}: {r[2]} of {n} prefixes never landed at {name}")
        pipes[2].send(("match", n, length, 7, MESH["match_samples"]))
        _, match_p50, match_p99 = pipes[2].recv()
        pipes[0].send(("rss", 0, 0, 0))
        p0_rss1 = pipes[0].recv()[1]
        out = {
            "protocol": protocol, "prefixes": n, "tokens": n * length,
            "insert_s_at_p0": t_inserted - t0, "bytes_per_insert": bytes_per_insert,
            "inserts_per_s": {name: n / (r[1] - t0) for name, r in landed.items()},
            "apply_lag_p50_s": {name: r[5] for name, r in landed.items()},
            "apply_lag_p99_s": {name: r[6] for name, r in landed.items()},
            "replica_tokens": {name: r[7] for name, r in landed.items()},
            "rss_growth_mb": {"p0": p0_rss1 - p0_rss0,
                              **{name: r[4] - r[3] for name, r in landed.items()}},
            "router_match_us": {"p50": match_p50, "p99": match_p99},
        }
        return out
    finally:
        _stop_replicas(pipes, procs)


def _traffic(mesh, rate: float, stopped, seed: int) -> int:
    """Advertise a fresh ``scale_len``-token prefix from ``mesh`` at
    ``rate`` per second until ``stopped(timeout)`` is true (an event's
    ``wait`` or a pipe's ``poll``); returns the prefixes sent."""
    rng = np.random.default_rng(seed)
    length = MESH["scale_len"]
    j = 0
    while not stopped(1.0 / rate):
        mesh.insert(rng.integers(0, 128256, length).astype(np.int32),
                    np.arange(length, dtype=np.int32) + (j % 64) * length)
        j += 1
    return j


def _spawn_replicas(addrs: list, protocol: str, which) -> tuple[list, list]:
    """``_scale_replica`` processes for the ring ranks ``which``; returns
    (pipes, processes) once each replica passed the startup barrier. The
    caller's own replicas must start before this waits."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    pipes, procs = [], []
    for i in which:
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_scale_replica, args=(i, addrs, protocol, child), daemon=True)
        p.start()
        pipes.append(parent)
        procs.append(p)
    return pipes, procs


def _stop_replicas(pipes, procs) -> None:
    for c in pipes:
        try:
            c.send(("close",))
        except (BrokenPipeError, OSError):
            pass
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join()


def _mesh_wall_leg(dev, model, protocol: str, remote: bool) -> dict:
    """Decode step wall of ``wall_rows`` x ``wall_len`` on p0: the engine
    with its mesh replica while d0 advertises ``traffic_per_s`` prefixes a
    second (p0's replica applies and forwards each), against an engine
    without a mesh and a quiet ring, interleaved. ``remote``: d0 and r0 run
    in their own processes, as a deployment runs them; otherwise all three
    replicas share this process. The median of ``wall_windows`` 8-step
    windows per run, ``wall_rounds`` rounds, the order reversed in every
    other one (the serving legs before it warmed the same model)."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache

    cfg = model.cfg
    pipes, procs = [], []
    if remote:
        addrs = _ring_addrs(protocol)
        pipes, procs = _spawn_replicas(addrs, protocol, (1, 2))
        meshes = [MeshCache(_ring_config(addrs, 0, protocol), pool=None).start()]
        check(meshes[0].wait_ready(timeout=60) and all(c.recv()[1] for c in pipes),
              f"mesh walls {protocol}: the ring never formed")
    else:
        addrs, meshes, _ = _mesh_ring(protocol)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, MESH["wall_len"]).tolist() for _ in range(MESH["wall_rows"])]
    out = {"on": [], "off": [], "protocol": protocol, "remote": remote, "traffic_per_s": MESH["traffic_per_s"],
           "advertised": 0}
    try:
        order = [["on", "off"] if r % 2 == 0 else ["off", "on"] for r in range(MESH["wall_rounds"])]
        for rnd, names in enumerate(order, start=1):
            for name in names:
                eng = Engine(cfg, model, num_slots=MESH["wall_slots"], page_size=16, max_batch=4, device=dev,
                             mesh=meshes[0] if name == "on" else None, name=f"wall-{protocol}-{rnd}-{name}")
                for p in prompts:
                    eng.add_request(p, SamplingParams(max_new_tokens=48))
                eng.step()
                eng.step()
                stop = threading.Event()
                th = None
                if name == "on":
                    if remote:
                        pipes[0].send(("traffic", MESH["traffic_per_s"], rnd))
                    else:
                        th = threading.Thread(target=_traffic, daemon=True,
                                              args=(meshes[1], MESH["traffic_per_s"], stop.wait, rnd))
                        th.start()
                walls = []
                try:
                    for _ in range(MESH["wall_windows"]):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        for _ in range(8):
                            eng.step()
                        walls.append((time.perf_counter() - t) / 8 * 1e3)
                finally:
                    stop.set()
                    if th is not None:
                        th.join(timeout=10)
                    if remote and name == "on":
                        pipes[0].send(("stop",))
                        out["advertised"] += pipes[0].recv()[1]
                check(sum(r is not None for r in eng._rows) == MESH["wall_rows"],
                      f"mesh walls {protocol}: a row finished early")
                _drain(eng)
                out[name].append(float(np.median(walls)))
                del eng
        out["on_over_off"] = [a / b for a, b in zip(out["on"], out["off"])]
        return out
    finally:
        _close_ring(meshes)
        _stop_replicas(pipes, procs)


def _port_block(n: int) -> int:
    """A base port with ``base .. base + n - 1`` and the same ports plus
    1000 (the serving ports) free, all below Linux's ephemeral range (from
    32768), so that no outgoing connection takes one while a node that
    owns it restarts."""
    import socket

    rng = np.random.default_rng(os.getpid())
    for _ in range(200):
        base = int(rng.integers(20000, 31000))
        try:
            socks = []
            for p in [base + i for i in range(n)] + [base + 1000 + i for i in range(n)]:
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free block of ports")


def mesh_node_leg(model_preset: str, node_slots: int, device: str = "cuda", out_dir=None) -> dict:
    """Two ``python -m radixmesh_tpu_torch.launch node`` processes, a
    prefill and a decode node, over native ``tcp`` from JSON configs with a
    ``model:`` section and ``--fleet-digest-interval 0.5``: ``POST
    /generate`` to the prefill node; the decode node's
    ``radixmesh_mesh_oplogs_received_total`` rises and its fleet view holds
    the prefill node's digest with the prefill node's own fingerprint. On
    the card the prefill node must have launched the decode and chunk
    kernels and no plain version (``tests/test_torch_launch_node.py`` runs
    this leg on the CPU with ``device="cpu"``)."""
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(exist_ok=True)
    base = _port_block(2)
    addrs = [f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"]
    serve = [base + 1000, base + 1001]
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for i, role in enumerate(("prefill", "decode")):
            cfg = {"prefill_nodes": addrs[:1], "decode_nodes": addrs[1:], "router_nodes": [],
                   "local_addr": addrs[i], "protocol": "tcp", "page_size": MESH_PAGE,
                   "tick_interval_s": 0.5, "serve_port_offset": 1000,
                   "model": {"preset": model_preset, "kv_slots": node_slots, "page_size": 16,
                             "max_batch": 4, "seed": 0}}
            path = out_dir / f"node-{role}.json"
            path.write_text(json.dumps(cfg))
            log = open(out_dir / f"node-{role}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "radixmesh_tpu_torch.launch", "node", "--config-file", str(path),
                 "--fleet-digest-interval", "0.5", "--device", device, "--ready-timeout", "300"],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        for i, port in enumerate(serve):
            while True:
                check(procs[i].poll() is None, f"node {i} exited with {procs[i].returncode} "
                      f"({out_dir}/node-{('prefill', 'decode')[i]}.log)")
                check(time.monotonic() - t0 < 400, f"node {i} did not answer /healthz in 400 s")
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                        if r.status == 200:
                            break
                except OSError:
                    time.sleep(0.5)
        ready_s = time.monotonic() - t0
        series = 'radixmesh_mesh_oplogs_received_total{node="decode@1",type="INSERT"}'
        before = _metric(_http(serve[1], "/metrics"), series)
        mcfg = get_config(model_preset)
        # Longer than the engine's dense-prefill threshold: the chunk kernel.
        ids = np.random.default_rng(18).integers(0, mcfg.vocab_size, min(2000, mcfg.max_seq_len // 2)).tolist()
        t = time.monotonic()
        first = _http(serve[0], "/generate", {"input_ids": ids, "max_tokens": 8})
        generate_s = time.monotonic() - t
        deadline = time.monotonic() + 30
        while True:
            after = _metric(_http(serve[1], "/metrics"), series)
            pre = _http(serve[0], "/cluster/telemetry")["nodes"].get("0")
            seen = _http(serve[1], "/cluster/telemetry")["nodes"].get("0")
            same = (pre is not None and seen is not None and pre["tree_tokens"] > 0
                    and seen["fingerprint"] == pre["fingerprint"])
            if (after > before and same) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(after > before, f"mesh node leg: the decode node received no oplog ({before} -> {after})")
        check(same, f"mesh node leg: the decode node's digest of the prefill node {seen} != the prefill "
              f"node's own {pre}")
        stats = _http(serve[0], "/stats")
        kernels = stats.get("kernels", {})
        if device == "cuda":
            check(kernels.get("paged_decode_fused_kernel", 0) > 0
                  and kernels.get("paged_chunk_attention_kernel", 0) > 0
                  and not any(v for k, v in kernels.items() if "plain" in k),
                  f"mesh node leg: the prefill node's kernels {kernels}")
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return {"ready_s": ready_s, "generate_s": generate_s, "wall_s": time.monotonic() - t0,
            "oplogs_received": [before, after], "prefill_digest": pre, "decode_view_of_prefill": seen,
            "output_ids": first["output_ids"], "kernels": kernels}


# ---------------------------------------------------------------------------
# phase 17: the fleet's failure handling over real processes
# ---------------------------------------------------------------------------

# The fleet leg's shapes: two routers and two Llama-3-8B serving nodes of
# ``slots`` KV slots; (a) ``prompts`` miss prompts of ``prompt_len`` tokens,
# then each with ``extra`` new tokens routed back; (c) ``resume_prompts``
# greedy requests of ``resume_len`` prompt tokens and ``resume_tokens`` new
# ones, p0 killed once each has ``kill_after``; (e) ``drain_rows`` requests
# decoding on d0 and as many arriving during its drain; (f) both routers
# pull the serving nodes' telemetry every ``agg_interval`` seconds.
FLEET = dict(model="llama3-8b", slots=32768, max_batch=4, prompts=8, prompt_len=2000, extra=64,
             new_tokens=8, resume_prompts=4, resume_len=600, resume_tokens=128, kill_after=8,
             drain_rows=4, drain_len=600, drain_tokens=128, wall_tokens=48, drain_timeout=30.0,
             hop_timeout_s=5.0, failure_timeout_s=2.0, start_limit_s=400.0, agg_interval=0.5)
# The fleet aggregator's peer names, derived from the topology (role and
# ring rank), as ``launch.py node`` names them.
FLEET_PEERS = {"p0": "prefill0", "d0": "decode1"}
ENGINE_RULES = ("restore_park_stall", "spec_efficiency", "decode_stall", "spec_misconfigured")
FLEET_NAMES = ("p0", "d0", "r0", "r1")


def _fleet_configs(out_dir, addrs, spec) -> list:
    """One JSON config per node, identical but ``local_addr``."""
    paths = []
    for name, addr in zip(FLEET_NAMES, addrs):
        cfg = {"prefill_nodes": addrs[:1], "decode_nodes": addrs[1:2], "router_nodes": addrs[2:],
               "local_addr": addr, "protocol": "tcp", "page_size": MESH_PAGE, "tick_interval_s": 0.5,
               "failure_timeout_s": spec["failure_timeout_s"], "repair_age_threshold_s": 1.0,
               "repair_backoff_s": 0.5,
               "serve_port_offset": 1000,
               "model": {"preset": spec["model"], "kv_slots": spec["slots"], "page_size": 16,
                         "max_batch": spec["max_batch"], "seed": 0}}
        path = out_dir / f"fleet-{name}.json"
        path.write_text(json.dumps(cfg))
        paths.append(path)
    return paths


class _Fleet:
    """The fleet's processes: ``start`` one node, ``wait_http`` for its
    ``/healthz``, and stop every process on ``close``."""

    def __init__(self, out_dir, paths, http_ports, device, drain_timeout, agg_interval):
        self.out_dir, self.paths, self.http_ports, self.device = out_dir, paths, http_ports, device
        self.drain_timeout, self.agg_interval = drain_timeout, agg_interval
        # r1 keeps a black box: the observer's dump a post-mortem reads.
        self.blackbox_dir = out_dir / "fleet-bb-r1"
        self.procs: dict = {}
        self.logs: list = []

    def start(self, name: str, repair: bool = True, tag: str = ""):
        i = FLEET_NAMES.index(name)
        cmd = [sys.executable, "-m", "radixmesh_tpu_torch.launch", "node", "--config-file", str(self.paths[i]),
               "--fleet-digest-interval", "0.5", "--drain-timeout", str(self.drain_timeout),
               "--ready-timeout", "300"]
        if repair:
            cmd += ["--repair-interval", "1.0"]
        if name.startswith("r"):
            cmd += ["--http-port", str(self.http_ports[i]), "--agg-interval", str(self.agg_interval)]
            if name == "r1":
                cmd += ["--blackbox-dir", str(self.blackbox_dir)]
        else:
            cmd += ["--device", self.device]
        log = open(self.out_dir / f"fleet-{name}{tag}.log", "w")
        self.logs.append(log)
        self.procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        return self.procs[name]

    def wait_http(self, name: str, t0: float, limit: float) -> float:
        port = self.http_ports[FLEET_NAMES.index(name)]
        while True:
            proc = self.procs[name]
            check(proc.poll() is None, f"fleet: {name} exited with {proc.returncode} "
                  f"({self.out_dir}/fleet-{name}*.log)")
            check(time.monotonic() - t0 < limit, f"fleet: {name} did not answer /healthz in {limit:.0f} s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        return time.monotonic() - t0
            except OSError:
                time.sleep(0.2)

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


def _port_of(addr: str) -> int:
    return int(addr.rsplit(":", 1)[1])


def _route_edge(port: int):
    """``POST /route`` on one router as a front-door edge: a shed with
    ``Retry-After`` raises ``RetryAfter``; any other failure propagates, and
    the front door declares the router dead."""
    from radixmesh_tpu_torch.router.front_door import RetryAfter

    def route(ids):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/route",
                                     data=json.dumps({"input_ids": ids}).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code in (429, 503) and e.headers.get("Retry-After"):
                raise RetryAfter(float(e.headers["Retry-After"])) from e
            raise

    return route


def _sse_hop(serve_addr: str, rec, hop_s: float, max_tokens: int) -> dict:
    """One serving hop of a recovery record: a streamed ``/generate`` that
    resumes from the tokens already delivered and calls ``rec.deliver`` per
    token. A broken or silent stream indicts the node."""
    import http.client

    from radixmesh_tpu_torch.server.recovery import HopTimeout, NodeDied

    k = len(rec.delivered)
    body = {"input_ids": rec.prompt.tolist(), "max_tokens": max_tokens, "stream": True}
    if k:
        body["resume_tokens"] = list(rec.delivered)
    req = urllib.request.Request(f"http://{serve_addr}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t_post, t_first = time.monotonic(), None
    try:
        with urllib.request.urlopen(req, timeout=hop_s) as r:
            for line in r:
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[len(b"data: "):])
                if ev.get("done"):
                    return {"addr": serve_addr, "k": k, "resumed_from": ev.get("resumed_from", 0),
                            "output_ids": ev["output_ids"], "t_post": t_post, "t_first": t_first}
                t_first = t_first or time.monotonic()
                rec.deliver(ev["token"])
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{serve_addr} answered {e.code}") from e
    except TimeoutError as e:
        raise HopTimeout(f"no progress from {serve_addr} in {hop_s:.1f} s") from e
    except urllib.error.URLError as e:
        if isinstance(e.reason, TimeoutError):
            raise HopTimeout(f"no progress from {serve_addr} in {hop_s:.1f} s") from e
        raise NodeDied(f"{serve_addr}: {e.reason}") from e
    except (ConnectionError, http.client.HTTPException) as e:
        raise NodeDied(f"{serve_addr}: {e!r}") from e
    raise NodeDied(f"{serve_addr}: the stream ended without a done event")


def _decode_gaps(port: int, prompts, tokens: int) -> dict:
    """``len(prompts)`` concurrent streamed requests on one node: the median
    gap between a request's tokens after its first (ms), a decode step's
    wall as a client sees it."""
    out: list = [None] * len(prompts)

    def one(i):
        out[i] = _sse_post(port, {"input_ids": prompts[i], "max_tokens": tokens})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    gaps = [1e3 * (b - a) for _, times, _ in out for a, b in zip(times[1:-2], times[2:-1])]
    return {"median_ms": float(np.median(gaps)), "p90_ms": float(np.percentile(gaps, 90)), "n": len(gaps)}


def _fleet_stats_kernels(port: int) -> dict:
    k = _http(port, "/stats").get("kernels", {})
    return {"b1": k.get("paged_decode_fused_kernel", 0), "b2": k.get("paged_chunk_attention_kernel", 0),
            "plain": sum(v for n, v in k.items() if "plain" in n)}


def _lifecycle_of(port: int):
    """The node's ``/debug/state`` lifecycle section (None before the plane
    attaches)."""
    return _http(port, "/debug/state").get("lifecycle")


def _fleet_ttft(port: int) -> tuple[tuple, list]:
    """A router's fleet store: the serving nodes' TTFT bucket counts merged
    across nodes (``merge_bucket_counts``: bounds, cumulative counts)."""
    from radixmesh_tpu_torch.obs.aggregator import _parse_labels, merge_bucket_counts

    body = _http(port, "/cluster/timeseries?family=radixmesh_request_ttft_seconds_bucket&limit=1")
    per: dict = {}
    for name, s in body["series"].items():
        labels = _parse_labels(name)
        if "le" in labels and s["last"][1] is not None:
            per.setdefault(labels.get("node"), {})[labels["le"]] = float(s["last"][1])
    return merge_bucket_counts(list(per.values()))


def _fleet_ttft_settled(port: int, want: int, limit_s: float = 20.0) -> tuple[tuple, list]:
    """The router's merged TTFT counts once they hold ``want`` requests (the
    aggregator pulls the nodes' rings, each sampled once a second)."""
    deadline = time.monotonic() + limit_s
    while True:
        bounds, cum = _fleet_ttft(port)
        if cum and cum[-1] >= want:
            check(cum[-1] == want, f"fleet (f): the fleet store counts {cum[-1]} TTFTs, the client {want}")
            return bounds, cum
        check(time.monotonic() < deadline, f"fleet (f): the fleet store counts {cum[-1:]} TTFTs after "
              f"{limit_s:.0f} s, the client {want}")
        time.sleep(0.1)


def _gap_finding(port: int, peer: str):
    """The ``telemetry_gap`` finding naming ``peer`` in a router's
    ``/cluster/doctor``, or None."""
    for f in _http(port, "/cluster/doctor")["findings"]:
        if f["rule"] == "telemetry_gap" and f["evidence"]["peer"] == peer:
            return f
    return None


def _watch_gap(port: int, peer: str, t_kill: float, found: dict, stop) -> None:
    """Poll a router's doctor from a kill until it names the killed peer's
    telemetry gap with the dead-node verdict."""
    while not stop.is_set():
        try:
            f = _gap_finding(port, peer)
        except (OSError, RuntimeError):
            f = None
        if f is not None and f["evidence"]["verdict"] == "node_dead":
            found.update(finding=f, after_kill_s=time.monotonic() - t_kill)
            return
        time.sleep(0.1)


def _fleet_after_a(port: int, replies: list, before: list, n_before: int) -> dict:
    """(f) after (a), on router ``port``: the fleet store holds series of
    both serving nodes under the topology's names; the growth of its merged
    TTFT bucket counts across (a) counts (a)'s requests, and its p50 bucket
    holds the client's own p50 (the order statistic a bucket quantile
    selects); ``/cluster/slo``'s fleet quantiles (every request so far) and
    the aggregator's stats."""
    from radixmesh_tpu_torch.obs.aggregator import merge_quantile

    client = sorted(r["ttft_s"] for r in replies)
    bounds, cum = _fleet_ttft_settled(port, n_before + len(client))
    check(len(cum) == len(before), f"fleet (f): bucket sets differ before and after (a): {before} {cum}")
    delta = [a - b for a, b in zip(cum, before)]
    est, le = merge_quantile(bounds + (float("inf"),), delta, 0.5)
    edges = (0.0,) + bounds + (float("inf"),)
    i = edges.index(float(le)) if le != "+Inf" else len(edges) - 1
    client_p50 = client[math.ceil(0.5 * len(client)) - 1]
    check(edges[i - 1] < client_p50 <= edges[i],
          f"fleet (f): the client's TTFT p50 {client_p50:.6f}s is outside the fleet's p50 bucket "
          f"({edges[i - 1]}, {edges[i]}]")
    names = _http(port, "/cluster/timeseries?limit=1")
    nodes = {n: sum(f'node="{n}"' in k for k in names["series"]) for n in FLEET_PEERS.values()}
    check(all(nodes.values()), f"fleet (f): r1's fleet store holds series per node {nodes}")
    slo = _http(port, "/cluster/slo")
    ttft = slo["tenants"]["default"]["ttft"]
    stats = names["aggregator"]
    return {"client_ttft_s": {"p50": client_p50, "p99": client[math.ceil(0.99 * len(client)) - 1],
                              "n": len(client)},
            "fleet_ttft_a": {"p50": est, "p50_bucket": [edges[i - 1], edges[i]], "n": delta[-1]},
            "slo_ttft": {k: ttft.get(k) for k in ("count", "nodes", "p50", "p99", "p50_bucket", "p99_bucket")},
            "series_per_node": nodes, "aggregator": stats, "peers": slo["peers"],
            "pull_ms_per_peer": 1e3 * stats["pull_seconds_total"] / max(1, stats["sweeps"] * stats["peers"])}


def _fleet_doctor_after_d(r1: int, d0: int, bb_dir) -> dict:
    """(f) after (d): d0's doctor runs the engine rules and none crashed;
    r1's black box, flushed now, holds a ``doctor`` section, and the
    post-mortem reader (``python -m radixmesh_tpu_torch.doctor --blackbox
    --json``, a child process) exits 0 or 1 over it."""
    rep = _http(d0, "/cluster/doctor")
    check(set(ENGINE_RULES) <= set(rep["rules_checked"]),
          f"fleet (f): d0's doctor checked {rep['rules_checked']}")
    crashed = [f for f in rep["findings"] if "rule crashed" in f["summary"]]
    check(not crashed, f"fleet (f): d0's doctor: {crashed}")
    flushed = _http(r1, "/admin/blackbox", {})
    final = json.loads(pathlib.Path(flushed["path"]).read_text())
    check("doctor" in final, f"fleet (f): r1's final dump has sections {sorted(final)}")
    node_dir = pathlib.Path(flushed["path"]).parent
    check(node_dir.parent == pathlib.Path(bb_dir), f"fleet (f): r1's dump at {node_dir}")
    r = subprocess.run([sys.executable, "-m", "radixmesh_tpu_torch.doctor", "--blackbox", str(node_dir), "--json"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    check(r.returncode in (0, 1), f"fleet (f): the post-mortem reader exited {r.returncode}: {r.stderr[-2000:]}")
    report = json.loads(r.stdout)
    crash = [f["evidence"] for f in report["findings"] if f["rule"] == "node_crash"]
    return {"d0_rules_checked": rep["rules_checked"], "d0_findings": [f["rule"] for f in rep["findings"]],
            "r1_final_doctor": {k: final["doctor"].get(k) for k in ("healthy", "rules_checked")}
            | {"findings": [f["rule"] for f in final["doctor"]["findings"]]},
            "postmortem": {"rc": r.returncode, "findings": [(f["rule"], f["evidence"]) for f in report["findings"]],
                           "samples": report["samples"], "series": report["series"],
                           "node_crash_ranks": [c["rank"] for c in crash],
                           "names_p0": any(str(c["rank"]) == "0" for c in crash)}}


def fleet_leg(device: str = "cuda", out_dir=None, sizes=None) -> dict:
    """Phase 17: two routers (r0, r1, model-less) and two serving nodes (p0,
    d0) as ``python -m radixmesh_tpu_torch.launch node`` processes over
    native ``tcp``, with ``--fleet-digest-interval 0.5 --repair-interval
    1.0 --drain-timeout 30``. The client side runs here: a
    ``RouterFrontDoor`` over both routers' ``POST /route`` and a
    ``RecoveryCoordinator`` over streamed ``POST /generate``.

    d0's decode wall with the repair plane armed, on its fresh process; (a)
    route and route back; (b) ``kill -9`` r0 between two requests (it
    restarts during (c)); (c) ``kill -9`` p0 mid-decode and resume its
    requests on d0; (d) restart p0 (a warm join: BOOTSTRAPPING → ACTIVE
    while the routers withhold its hits); (e) drain d0 over ``POST
    /admin/drain`` (decodes finish, arrivals get 503 with the router and,
    from the plain runner, no Retry-After; DRAINING then LEFT, exit 0 on
    SIGTERM); and d0's decode wall unarmed, on a fresh d0 started without
    the repair plane. (f) Both routers host the fleet aggregator
    (``--agg-interval``) and r1 a black box: its fleet store and SLO after
    (a), its doctor's ``telemetry_gap`` for the killed p0 in (c) and its
    clearing in (d), d0's engine rules, and the post-mortem of r1's dump
    after (d). ``tests/test_torch_launch_node.py`` runs it on the CPU with
    the tiny model."""
    from radixmesh_tpu_torch.obs.metrics import get_registry
    from radixmesh_tpu_torch.policy.retry import RetryPolicy
    from radixmesh_tpu_torch.router.front_door import RouterFrontDoor
    from radixmesh_tpu_torch.server.recovery import RecoveryCoordinator

    spec = dict(FLEET, **(sizes or {}))
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(exist_ok=True)
    base = _port_block(4)
    addrs = [f"127.0.0.1:{base + i}" for i in range(4)]
    http_ports = [base + 1000 + i for i in range(4)]
    serve = {n: f"127.0.0.1:{http_ports[i]}" for i, n in enumerate(FLEET_NAMES)}
    port = dict(zip(FLEET_NAMES, http_ports))
    fleet = _Fleet(out_dir, _fleet_configs(out_dir, addrs, spec), http_ports, device, spec["drain_timeout"],
                   spec["agg_interval"])
    shutil.rmtree(fleet.blackbox_dir, ignore_errors=True)
    mcfg = get_config(spec["model"])
    rng = np.random.default_rng(17)
    aligned = spec["prompt_len"] - spec["prompt_len"] % MESH_PAGE
    out: dict = {"addrs": dict(zip(FLEET_NAMES, addrs))}
    t0 = time.monotonic()
    try:
        for name in FLEET_NAMES:
            fleet.start(name)
        out["ready_s"] = {n: fleet.wait_http(n, t0, spec["start_limit_s"]) for n in FLEET_NAMES}
        # Both serving nodes gossip ACTIVE before any traffic.
        deadline = time.monotonic() + 120
        while True:
            nodes = _http(port["r1"], "/cluster/telemetry")["nodes"]
            states = {r: nodes.get(r, {}).get("lifecycle") for r in ("0", "1")}
            if all(s == "active" for s in states.values()):
                break
            check(time.monotonic() < deadline, f"fleet: serving nodes never gossiped active: {states}")
            time.sleep(0.2)
        out["active_s"] = time.monotonic() - t0
        # d0's decode wall with the repair plane armed, taken on its fresh
        # process as the unarmed one is (last): both are the first requests
        # their process serves.
        wall_prompts = [rng.integers(0, mcfg.vocab_size, spec["drain_len"]).tolist()
                        for _ in range(spec["drain_rows"])]
        armed = _decode_gaps(http_ports[1], wall_prompts, spec["wall_tokens"])
        # (f) r1's fleet store holds the armed wall's TTFTs before (a).
        _, ttft_before = _fleet_ttft_settled(port["r1"], len(wall_prompts))

        # (a) route, serve, publish, route back.
        door = RouterFrontDoor([(addrs[2], _route_edge(port["r0"])), (addrs[3], _route_edge(port["r1"]))],
                               hop_timeout_s=2.0, name="fleet")
        route_ms: list = []

        def route(ids):
            t = time.perf_counter()
            res = door.route(ids)
            route_ms.append(1e3 * (time.perf_counter() - t))
            return res

        prompts = [rng.integers(0, mcfg.vocab_size, spec["prompt_len"]).tolist() for _ in range(spec["prompts"])]
        misses = []
        for p in prompts:
            r = route(p)
            check(not r["prefill_cache_hit"] and r["prefill_serve_addr"] == serve["p0"],
                  f"fleet (a): a new prompt routed as {r}")
            misses.append(_http(_port_of(r["prefill_serve_addr"]), "/generate",
                                {"input_ids": p, "max_tokens": spec["new_tokens"]}, timeout=600))
        routed = [p + rng.integers(0, mcfg.vocab_size, spec["extra"]).tolist() for p in prompts]
        deadline = time.monotonic() + 30
        while True:  # replication to the routers' replicas
            back = [route(r) for r in routed]
            if all(b["prefill_cache_hit"] and b["match_len"] >= aligned for b in back):
                break
            check(time.monotonic() < deadline,
                  f"fleet (a): routed back as {[(b['prefill_cache_hit'], b['match_len']) for b in back]}")
            time.sleep(0.2)
        hits = []
        for r, b in zip(routed, back):
            check(b["prefill_serve_addr"] == serve["p0"], f"fleet (a): a shared prefix routed to {b}")
            hits.append(_http(_port_of(b["prefill_serve_addr"]), "/generate",
                              {"input_ids": r, "max_tokens": spec["new_tokens"]}, timeout=600))
        check(all(h["cached_tokens"] >= aligned for h in hits),
              f"fleet (a): routed hits cached {[h['cached_tokens'] for h in hits]} (want >= {aligned})")
        out["a"] = {"route_ms": _pcts(route_ms), "match_len": [b["match_len"] for b in back],
                    "cached_tokens": [h["cached_tokens"] for h in hits],
                    "miss_ttft_s": [m["ttft_s"] for m in misses], "hit_ttft_s": [h["ttft_s"] for h in hits]}
        out["f"] = _fleet_after_a(port["r1"], misses + hits, ttft_before, len(wall_prompts))

        # (b) kill -9 r0 between two requests: the front door fails over.
        answers, t_kill, t_first = [], None, None
        for i, r in enumerate(routed):
            if i == len(routed) // 2:
                fleet.procs["r0"].kill()
                fleet.procs["r0"].wait()
                t_kill = time.monotonic()
            res = route(r)
            if t_kill is not None and t_first is None:
                t_first = time.monotonic()
            answers.append(res)
        check(all(a["prefill_cache_hit"] for a in answers) and len(answers) == len(routed),
              f"fleet (b): routes after the router kill {answers}")
        check(door.dead_addrs() == {addrs[2]} and door.failovers >= 1,
              f"fleet (b): dead {door.dead_addrs()} failovers {door.failovers}")
        text = get_registry().render()
        fd_metrics = {m: _metric(text, f'radixmesh_frontdoor_{m}_total{{node="fleet"}}', 0.0)
                      for m in ("failovers", "hedges", "retry_after_waits")}
        # r0 comes back while (c) warms p0; the front door readmits it
        # before (d), which reads both routers.
        r0_back: dict = {}

        def restart_r0(t):
            try:
                r0_back["s"] = fleet.wait_http("r0", t, 120)
            except RuntimeError as e:
                r0_back["error"] = str(e)

        fleet.start("r0", tag="-restart")
        r0_waiter = threading.Thread(target=restart_r0, args=(time.monotonic(),))
        r0_waiter.start()
        out["b"] = {"failover_s": t_first - t_kill, "routes": len(answers), "frontdoor": fd_metrics}

        # (c) kill -9 p0 mid-decode; the recovery plane finishes on d0. The
        # undisturbed run is a prefix hit on p0, as the interrupted one is:
        # a first pass of one token publishes each prompt.
        rprompts = [rng.integers(0, mcfg.vocab_size, spec["resume_len"]).tolist()
                    for _ in range(spec["resume_prompts"])]
        ref: list = [None] * len(rprompts)
        ref_cached: list = [None] * len(rprompts)

        def reference(i, max_tokens):
            res = _http(http_ports[0], "/generate", {"input_ids": rprompts[i], "max_tokens": max_tokens},
                        timeout=600)
            ref[i], ref_cached[i] = res["output_ids"], res["cached_tokens"]

        for max_tokens in (1, spec["resume_tokens"]):
            threads = [threading.Thread(target=reference, args=(i, max_tokens)) for i in range(len(rprompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        check(all(c > 0 for c in ref_cached), f"fleet (c): the undisturbed runs cached {ref_cached}")
        r0_waiter.join()
        check("s" in r0_back, f"fleet (b): r0's restart: {r0_back}")
        out["b"]["r0_restart_s"] = r0_back["s"]
        door.revive(addrs[2])
        kernels_p0 = _fleet_stats_kernels(http_ports[0])
        coord = RecoveryCoordinator(RetryPolicy(hop_timeout_s=spec["hop_timeout_s"], max_retries=3,
                                                backoff_base_s=0.05), name="fleet")

        def route_fn(key, exclude):
            res = route(key.tolist())
            for a in (res["prefill_serve_addr"], res["decode_serve_addr"]):
                if a is not None and a not in exclude:
                    return a
            return None

        recs = [coord.admit(p) for p in rprompts]
        t_dead: dict = {}  # when the client first declared p0 dead (its stream broke)
        coord.on_node_dead.append(lambda addr, cause: t_dead.setdefault(addr, time.monotonic()))
        hops: dict = {r.rid: [] for r in recs}
        reports: dict = {}
        errors: list = []

        def serve_fn(addr, rec, hop_s):
            hops[rec.rid].append(_sse_hop(addr, rec, hop_s, spec["resume_tokens"]))

        def run(rec):
            try:
                reports[rec.rid] = coord.run_to_completion(rec, route_fn, serve_fn)
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(r,)) for r in recs]
        for th in threads:
            th.start()
        while not all(len(r.delivered) >= spec["kill_after"] for r in recs):
            check(all(th.is_alive() for th in threads), f"fleet (c): a request ended before the kill: {errors}")
            time.sleep(0.001)
        fleet.procs["p0"].kill()
        t_p0_kill = time.monotonic()
        gap: dict = {}
        gap_stop = threading.Event()
        gap_watch = threading.Thread(target=_watch_gap, args=(port["r1"], FLEET_PEERS["p0"], t_p0_kill, gap,
                                                              gap_stop), daemon=True)
        gap_watch.start()
        for th in threads:
            th.join(timeout=600)
        check(not errors, f"fleet (c): recovery failed: {errors}")
        resumed = []
        for r in recs:
            h = hops[r.rid]
            check(len(h) == 1 and r.resurrections == 1,
                  f"fleet (c): request {r.rid} took hops {h} with {r.resurrections} resurrection(s)")
            last = h[-1]
            check(last["addr"] == serve["d0"] and last["k"] >= spec["kill_after"]
                  and last["resumed_from"] == last["k"],
                  f"fleet (c): request {r.rid} resumed as {[(x['addr'], x['k'], x['resumed_from']) for x in h]}")
            check(len(r.delivered) == spec["resume_tokens"] and last["output_ids"] == r.delivered[last["k"]:],
                  f"fleet (c): request {r.rid} delivered {len(r.delivered)} tokens, re-emitted or lost some")
            resumed.append(last["k"])
        same = [r.delivered == ref[i] for i, r in enumerate(recs)]
        same_tok = [a == b for i, r in enumerate(recs) for a, b in zip(r.delivered, ref[i])]
        # Where each continuation first leaves the undisturbed run, counted
        # from its resume point (None: never).
        diverge = [next((j - k for j, (a, b) in enumerate(zip(r.delivered, ref[i])) if a != b), None)
                   for i, (r, k) in enumerate(zip(recs, resumed))]
        rec_s = [reports[r.rid]["recovery_s"] for r in recs]
        out["c"] = {"k": resumed, "recovery_s": rec_s, "recovery_p50_s": float(np.median(rec_s)),
                    "kill_to_first_resumed_token_s": [hops[r.rid][-1]["t_first"] - t_p0_kill for r in recs],
                    "kill_to_declared_dead_s": t_dead[serve["p0"]] - t_p0_kill,
                    "kill_to_resume_post_s": [hops[r.rid][-1]["t_post"] - t_p0_kill for r in recs],
                    "first_divergence_after_k": diverge, "reference_cached_tokens": ref_cached,
                    "recovery_max_s": float(max(rec_s)), "resurrections": [r.resurrections for r in recs],
                    "continuation_equal_share": sum(same) / len(same),
                    "token_equal_share": sum(same_tok) / len(same_tok),
                    "kill_to_done_s": time.monotonic() - t_p0_kill}

        # (d) p0 restarts from the same config: a warm join from d0.
        text = {n: _http(port[n], "/metrics") for n in ("r0", "r1")}
        withheld_series = 'radixmesh_router_requests_total{outcome="withheld",role="prefill"}'
        withheld0 = sum(_metric(text[n], withheld_series, 0.0) for n in text)
        stop = threading.Event()
        serving_p0 = threading.Event()
        # Hits routed to p0 before its HTTP port answers: the window between
        # its ring rejoin and its first (bootstrapping) digest.
        hammer = {"routes": 0, "to_p0_hit": 0, "to_p0_hit_before_serving": 0, "errors": 0}

        def hammer_routes(n):
            # Routes of p0's prefixes on one router from p0's restart until
            # it is active: the hits its bootstrap digest withholds.
            while not stop.is_set():
                for r in routed[:2]:
                    try:
                        res = _http(port[n], "/route", {"input_ids": r}, timeout=10)
                    except (OSError, RuntimeError):
                        hammer["errors"] += 1
                        continue
                    hammer["routes"] += 1
                    hit = res["prefill_cache_hit"] and res["prefill_addr"] == addrs[0]
                    hammer["to_p0_hit"] += hit
                    hammer["to_p0_hit_before_serving"] += hit and not serving_p0.is_set()

        fleet.procs["p0"].wait()
        # (f) r1's doctor names p0's telemetry gap, dead node, before p0 restarts.
        gap_watch.join(timeout=max(0.0, t_p0_kill + 60 - time.monotonic()))
        gap_stop.set()
        check("finding" in gap, f"fleet (f): r1's doctor never named prefill0's telemetry gap as a dead node "
              f"within 60 s of the kill: {_http(port['r1'], '/cluster/doctor')['findings']}")
        out["f"]["gap"] = {"after_kill_s": gap["after_kill_s"], "evidence": gap["finding"]["evidence"]}
        t_restart = time.monotonic()
        fleet.start("p0", tag="-rejoin")
        workers = [threading.Thread(target=hammer_routes, args=(n,), daemon=True) for n in ("r0", "r1")]
        for w in workers:
            w.start()
        fleet.wait_http("p0", t_restart, spec["start_limit_s"])
        serving_p0.set()
        states = []
        deadline = time.monotonic() + 120
        while True:
            lc = _lifecycle_of(http_ports[0])
            if lc is not None and (not states or states[-1] != lc["state"]):
                states.append(lc["state"])
            if lc is not None and lc["state"] == "active":
                break
            check(time.monotonic() < deadline, f"fleet (d): p0 never went active: {states}")
            time.sleep(0.05)
        t_active = time.monotonic()
        # (f) the gap clears within 10 pull intervals of p0's ACTIVE.
        while _gap_finding(port["r1"], FLEET_PEERS["p0"]) is not None:
            check(time.monotonic() - t_active < 10 * spec["agg_interval"],
                  f"fleet (f): prefill0's telemetry gap still open {10 * spec['agg_interval']:.1f} s after ACTIVE")
            time.sleep(0.05)
        out["f"]["gap"]["cleared_after_active_s"] = time.monotonic() - t_active
        time.sleep(max(0.0, t_active + 1.0 - time.monotonic()))  # the routers fold p0's ACTIVE digest
        stop.set()
        for w in workers:
            w.join()
        boot = lc.get("bootstrap", {})
        check(boot.get("donor_rank") == 1 and boot.get("converge_s") is not None,
              f"fleet (d): p0's bootstrap {lc}")
        text = {n: _http(port[n], "/metrics") for n in ("r0", "r1")}
        withheld1 = sum(_metric(text[n], withheld_series, 0.0) for n in text)
        check(withheld1 > withheld0, f"fleet (d): the routers withheld no hit ({withheld0} -> {withheld1}; "
              f"routes {hammer}, p0 states {states})")
        deadline = time.monotonic() + 30
        while True:
            nodes = _http(port["r1"], "/cluster/telemetry")["nodes"]
            fp = {r: nodes.get(r, {}).get("fingerprint") for r in ("0", "1")}
            if fp["0"] is not None and fp["0"] == fp["1"]:
                break
            check(time.monotonic() < deadline, f"fleet (d): fingerprints {fp} never agreed")
            time.sleep(0.2)
        again = route(routed[0])
        check(again["prefill_addr"] == addrs[0] and again["prefill_cache_hit"],
              f"fleet (d): p0's prefix routed as {again} after its join")
        first_hit = _http(http_ports[0], "/generate", {"input_ids": routed[0], "max_tokens": spec["new_tokens"]},
                          timeout=600)
        p0_metrics = _http(http_ports[0], "/metrics")
        d0_metrics = _http(http_ports[1], "/metrics")
        keys = {n: _metric(t, f'radixmesh_repair_keys_pushed_total{{node="{lbl}"}}', 0.0)
                for n, t, lbl in (("p0", p0_metrics, "prefill@0"), ("d0", d0_metrics, "decode@1"))}
        out["f"].update(_fleet_doctor_after_d(port["r1"], http_ports[1], fleet.blackbox_dir))
        out["d"] = {"states": states, "bootstrap_wall_s": t_active - t_restart,
                    "bootstrap_converge_s": boot.get("converge_s"), "rounds": boot.get("rounds"),
                    "keys_pushed": keys, "withheld_hits": [withheld0, withheld1], "hammer": hammer,
                    "fingerprint": fp["0"], "route_after_join": again,
                    "first_routed_cached_tokens": first_hit["cached_tokens"]}

        # (e) d0's drain.
        decoding: list = [None] * spec["drain_rows"]
        dprompts = [rng.integers(0, mcfg.vocab_size, spec["drain_len"]).tolist()
                    for _ in range(spec["drain_rows"])]

        def decode(i):
            decoding[i] = _post_any(http_ports[1], {"input_ids": dprompts[i], "max_tokens": spec["drain_tokens"]},
                                    timeout=600)

        threads = [threading.Thread(target=decode, args=(i,)) for i in range(len(dprompts))]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        while True:
            reqs = _http(http_ports[1], "/debug/requests")
            if reqs["running"] >= spec["drain_rows"] and all(
                    q["output_tokens"] >= 2 for q in reqs["requests"] if q["state"] == "running"):
                break
            check(time.monotonic() < deadline, f"fleet (e): d0 never decoded {spec['drain_rows']} rows: {reqs}")
            time.sleep(0.02)
        t_drain = time.monotonic()
        st, _, drained = _post_any(http_ports[1], {}, path="/admin/drain")
        check(st == 202 and drained["accepted"] and drained["router"] == addrs[2],
              f"fleet (e): POST /admin/drain answered {st} {drained}")
        arrivals = [_post_any(http_ports[1], {"input_ids": p, "max_tokens": spec["drain_tokens"]}, timeout=60)
                    for p in dprompts]
        # The plain runner refuses a submit while draining; the frontend
        # answers 503 with the router to retry through and no Retry-After,
        # as the JAX package's does (ROADMAP.md section C).
        for code, headers, body in arrivals:
            check(code == 503 and "Retry-After" not in headers and body.get("router") == addrs[2],
                  f"fleet (e): an arrival during the drain got {code} {headers} {body}")
        seen_draining = False
        deadline = time.monotonic() + 30
        while not seen_draining:
            nodes = _http(port["r1"], "/cluster/telemetry")["nodes"]
            seen_draining = nodes.get("1", {}).get("lifecycle") == "draining"
            check(seen_draining or time.monotonic() < deadline, "fleet (e): the routers never saw d0 draining")
            time.sleep(0.02)
        # d0 is the only decode node: a departing node is still the
        # fallback when nothing else of its role exists (the router's rule),
        # so it leaves the answers only once it has left.
        r_drain = _http(port["r1"], "/route", {"input_ids": dprompts[0]})
        for th in threads:
            th.join(timeout=spec["drain_timeout"] + 60)
        for code, _, body in decoding:
            check(code == 200 and len(body["output_ids"]) == spec["drain_tokens"] and not body.get("cancelled"),
                  f"fleet (e): a decoding request ended {code} {body.get('output_ids', body)!s:.200}")
        kernels_d0 = _fleet_stats_kernels(http_ports[1])
        deadline = time.monotonic() + spec["drain_timeout"] + 30
        while True:
            lc = _lifecycle_of(http_ports[1])
            if lc["state"] == "left":
                break
            check(time.monotonic() < deadline, f"fleet (e): d0 never left: {lc}")
            time.sleep(0.05)
        t_left = time.monotonic()
        deadline = time.monotonic() + 30
        while True:
            gone = [_http(port[n], "/debug/state")["membership"]["alive"] for n in ("r0", "r1")]
            nodes = _http(port["r1"], "/cluster/telemetry")["nodes"]
            if all(1 not in g for g in gone) and "1" not in nodes:
                break
            check(time.monotonic() < deadline, f"fleet (e): the routers still hold d0: {gone} {sorted(nodes)}")
            time.sleep(0.05)
        r_left = route(dprompts[0])
        check(r_left["decode_addr"] != addrs[1], f"fleet (e): d0 routed after it left: {r_left}")
        t = time.monotonic()
        fleet.procs["d0"].send_signal(signal.SIGTERM)
        rc = fleet.procs["d0"].wait(timeout=spec["drain_timeout"] + 30)
        exit_s = time.monotonic() - t
        check(rc == 0 and exit_s < spec["drain_timeout"], f"fleet (e): d0 exited {rc} after {exit_s:.1f} s")
        out["e"] = {"drain_wall_s": t_left - t_drain, "exit_s": exit_s,
                    "decode_addr_while_draining": r_drain["decode_addr"],
                    "decode_addr_after_left": r_left["decode_addr"], "requeued": lc["drain"].get("requeued"),
                    "arrivals": [c for c, _, _ in arrivals],
                    "retry_after": [h.get("Retry-After") for _, h, _ in arrivals], "drain": lc["drain"]}

        # d0 again without the repair plane: the decode wall unarmed, on a
        # fresh process as the armed one was.
        t = time.monotonic()
        fleet.start("d0", repair=False, tag="-unarmed")
        fleet.wait_http("d0", t, spec["start_limit_s"])
        unarmed = _decode_gaps(http_ports[1], wall_prompts, spec["wall_tokens"])
        kernels_d0b = _fleet_stats_kernels(http_ports[1])
        kernels_p0b = _fleet_stats_kernels(http_ports[0])
        out["decode_wall"] = {"armed": armed, "unarmed": unarmed}
        out["kernels"] = {"p0": {k: kernels_p0[k] + kernels_p0b[k] for k in kernels_p0},
                          "d0": {k: kernels_d0[k] + kernels_d0b[k] for k in kernels_d0}}
        if device == "cuda":
            for name, c in out["kernels"].items():
                check(c["b1"] > 0 and c["b2"] > 0 and c["plain"] == 0, f"fleet: {name}'s kernels {c}")
    finally:
        fleet.close()
    out["wall_s"] = time.monotonic() - t0
    return out


def fleet_phase(card: str) -> dict:
    """Phase 17: :func:`fleet_leg` at Llama-3-8B's full width, and its
    numbers, each beside the card's name and power limit."""
    f = fleet_leg()
    a, b, c, d, e, w = f["a"], f["b"], f["c"], f["d"], f["e"], f["decode_wall"]
    print(f"[fleet] ({card}) 4 launch.py node processes (r0, r1, p0, d0) over native tcp: /healthz after "
          f"{max(f['ready_s'].values()):.1f}s, active after {f['active_s']:.1f}s", flush=True)
    print(f"[fleet a] /route p50 {a['route_ms']['p50']:.3f} ms p99 {a['route_ms']['p99']:.3f} ms; routed back "
          f"as hits of {min(a['match_len'])}-{max(a['match_len'])} tokens, cached {a['cached_tokens']}; TTFT hit "
          f"p50 {np.median(a['hit_ttft_s']):.4f}s vs miss p50 {np.median(a['miss_ttft_s']):.4f}s", flush=True)
    print(f"[fleet b] kill -9 r0: first route through r1 {1e3 * b['failover_s']:.3f} ms after the kill, "
          f"{b['routes']} routes, none lost; front door {b['frontdoor']}; r0 back in {b['r0_restart_s']:.1f}s",
          flush=True)
    print(f"[fleet c] kill -9 p0 at k = {c['k']}: all resumed on d0 (resumed_from == k, nothing re-emitted); "
          f"radixmesh_request_recovery_seconds p50 {c['recovery_p50_s']:.3f}s max {c['recovery_max_s']:.3f}s; "
          f"kill -> declared dead {c['kill_to_declared_dead_s']:.3f}s -> resume POSTed "
          f"{[round(x, 3) for x in c['kill_to_resume_post_s']]}s -> first resumed token "
          f"{[round(x, 3) for x in c['kill_to_first_resumed_token_s']]}s after the kill; "
          f"continuations equal to the undisturbed run (a p0 hit of {c['reference_cached_tokens']} tokens) "
          f"{c['continuation_equal_share']:.3f} (tokens {c['token_equal_share']:.3f}; first divergence after k "
          f"{c['first_divergence_after_k']})", flush=True)
    print(f"[fleet d] p0 restarted: {' -> '.join(d['states'])} in {d['bootstrap_wall_s']:.2f}s from the restart "
          f"(bootstrap {d['bootstrap_converge_s']:.3f}s, {d['rounds']} round(s), keys pushed {d['keys_pushed']}); "
          f"withheld hits {d['withheld_hits']}; routes {d['hammer']}; routed back to p0 "
          f"{d['route_after_join']['prefill_cache_hit']}, its first routed hit cached "
          f"{d['first_routed_cached_tokens']} tokens", flush=True)
    print(f"[fleet e] drain d0: left {e['drain_wall_s']:.3f}s after POST /admin/drain, exit 0 "
          f"{e['exit_s']:.3f}s after SIGTERM; arrivals {e['arrivals']} with the router, Retry-After "
          f"{e['retry_after']} (the plain runner sends none); decode "
          f"addr while draining {e['decode_addr_while_draining']}, after leaving {e['decode_addr_after_left']}; "
          f"drain {e['drain']}", flush=True)
    fa, gp, pm = f["f"], f["f"]["gap"], f["f"]["postmortem"]
    print(f"[fleet f] ({card}) r1's fleet aggregator every {FLEET['agg_interval']}s: series per node "
          f"{fa['series_per_node']}; (a)'s TTFT: client p50 {fa['client_ttft_s']['p50']:.6f}s p99 "
          f"{fa['client_ttft_s']['p99']:.6f}s over {fa['client_ttft_s']['n']}, the fleet's p50 "
          f"{fa['fleet_ttft_a']['p50']:.6f}s in bucket {fa['fleet_ttft_a']['p50_bucket']} over "
          f"{fa['fleet_ttft_a']['n']:.0f}; /cluster/slo TTFT (every request so far) {fa['slo_ttft']}; "
          f"aggregator {fa['aggregator']['sweeps']} sweeps over {fa['aggregator']['peers']} peers, "
          f"{fa['pull_ms_per_peer']:.3f} ms pull wall per peer per sweep, store {fa['aggregator']['store']}; "
          f"peers {fa['peers']}", flush=True)
    print(f"[fleet f] kill -9 p0 -> r1's doctor names telemetry_gap {gp['evidence']} "
          f"{gp['after_kill_s']:.3f}s after the kill; cleared {gp['cleared_after_active_s']:.3f}s after p0's "
          f"ACTIVE; d0's doctor checked {f['f']['d0_rules_checked']} (findings {f['f']['d0_findings']}, none crashed); "
          f"r1's final doctor {f['f']['r1_final_doctor']}; post-mortem of r1's dump: exit {pm['rc']}, "
          f"{pm['samples']} samples / {pm['series']} series, findings {pm['findings']}; node_crash names p0 "
          f"(rank 0): {pm['names_p0']}", flush=True)
    print(f"[fleet walls] d0 decode step (client gap, {FLEET['drain_rows']} rows x {FLEET['drain_len']}, the first "
          f"requests of a fresh d0 process each, one reading each): repair armed median "
          f"{w['armed']['median_ms']:.3f} ms, unarmed {w['unarmed']['median_ms']:.3f} ms; kernels "
          f"{f['kernels']}; leg wall {f['wall_s']:.1f}s", flush=True)
    return f


def build_shadow_phase() -> dict:
    """Host work that needs neither the card nor a kernel, run in a thread
    while ``nvcc`` builds the kernels: phase 16 (b), the ring at scale over
    native ``tcp`` and ``tcp-py`` (replica processes), and the port's
    meshcheck over its tree (``analysis.check_tree``, cached for the
    process), which phase 20 (g)'s TIER report embeds."""
    from radixmesh_tpu_torch.analysis import check_tree

    out = {"scale": {}}
    for protocol in ("tcp", "tcp-py"):
        t = time.monotonic()
        s = out["scale"][protocol] = _ring_scale_leg(protocol)
        print(f"[mesh scale {protocol}] {s['prefixes']} x {MESH['scale_len']} = {s['tokens']} tokens advertised "
              f"from p0 in {s['insert_s_at_p0']:.3f}s; applied/s r0 {s['inserts_per_s']['r0']:.1f} d0 "
              f"{s['inserts_per_s']['d0']:.1f}; bytes/insert {s['bytes_per_insert']:.1f}; apply lag p99 r0 "
              f"{s['apply_lag_p99_s']['r0'] * 1e3:.3f} ms d0 {s['apply_lag_p99_s']['d0'] * 1e3:.3f} ms; "
              f"router match_prefix p50 {s['router_match_us']['p50']:.2f} us p99 "
              f"{s['router_match_us']['p99']:.2f} us; RSS growth MB {s['rss_growth_mb']} "
              f"({time.monotonic() - t:.1f}s, beside the kernel build)", flush=True)
    t = time.monotonic()
    res = check_tree()
    out["meshcheck"] = {"findings": len(res.findings), "suppressed": len(res.suppressed),
                        "wall_s": time.monotonic() - t}
    print(f"[meshcheck] the port's tree: {len(res.findings)} finding(s), {len(res.suppressed)} suppressed "
          f"({out['meshcheck']['wall_s']:.1f}s, beside the kernel build)", flush=True)
    return out


def mesh_phase(dev, model, scale: dict) -> dict:
    """Phase 16: (a) serve → publish → replicate → route back on each
    transport at full width, and a 2-layer float32 leg whose hit and miss
    tokens must be equal; (b) the ring at scale (``scale``: run beside the
    kernel build by :func:`build_shadow_phase`); (c) the decode wall with
    the mesh on and off."""
    out: dict = {"legs": {}, "scale": scale, "walls": {}}
    for protocol in MESH_PROTOCOLS:
        t = time.monotonic()
        leg = out["legs"][protocol] = _mesh_serving_leg(dev, model, protocol, MESH["prompts"], f"mesh-{protocol}")
        hit, miss = leg["hit_ttft_s"], leg["miss_ttft_s"]
        print(f"[mesh {protocol}] {MESH['prompts']} x {MESH['prompt_len']} served on p0 in {leg['serve_s']:.3f}s; "
              f"publish -> router attribution p50 {leg['lag_p50_ms']:.3f} ms p99 {leg['lag_p99_ms']:.3f} ms; "
              f"routed to p0 as hits of {min(leg['match_len'])}-{max(leg['match_len'])} tokens; TTFT hit "
              f"p50 {np.median(hit):.4f}s vs miss on d0 p50 {np.median(miss):.4f}s; cached "
              f"{leg['cached_tokens']}; hit == miss tokens share {leg['tokens_equal_share']:.3f}; "
              f"launches p0 {leg['launches']['p0']} d0 {leg['launches']['d0']} "
              f"({time.monotonic() - t:.1f}s)", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    f32_cfg = get_config(MESH["node_model"], n_layers=MESH["f32_layers"], dtype=torch.float32)
    with torch.inference_mode():
        f32_model = Llama(f32_cfg, init_params(f32_cfg, seed=3, device=dev))
    f32 = out["f32"] = _mesh_serving_leg(dev, f32_model, "inproc", MESH["f32_prompts"], "mesh-f32")
    f32["f32_body_launches"] = sum(c["f32_body"] for c in f32["launches"].values())
    check(f32["f32_body_launches"] > 0, "mesh f32: the CUDA-core chunk body never ran")
    check(f32["hit_tokens"] == f32["miss_tokens"],
          f"mesh f32: routed hit tokens {f32['hit_tokens']} != miss tokens {f32['miss_tokens']}")
    print(f"[mesh f32] 2-layer float32: routed hits cached {f32['cached_tokens']}, hit tokens == miss "
          f"tokens for all {MESH['f32_prompts']}; CUDA-core chunk body launches {f32['f32_body_launches']}",
          flush=True)
    del f32_model
    torch.cuda.empty_cache()
    for protocol in ("tcp", "tcp-py"):
        for remote in (False, True):
            t = time.monotonic()
            tag = f"{protocol} {'d0 and r0 in other processes' if remote else 'one process'}"
            w = out["walls"][tag] = _mesh_wall_leg(dev, model, protocol, remote)
            print(f"[mesh walls {tag}] decode step {MESH['wall_rows']} x {MESH['wall_len']}: mesh on "
                  f"({w['traffic_per_s']} inserts/s from d0) {[round(x, 3) for x in w['on']]} ms vs off "
                  f"{[round(x, 3) for x in w['off']]} ms; on/off {[round(x, 3) for x in w['on_over_off']]} "
                  f"({time.monotonic() - t:.1f}s)", flush=True)
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the whole path, card vs CPU
# ---------------------------------------------------------------------------


def _whole_path_script(eng, cfg, schedules, tiers=False) -> list[list[int]]:
    """The whole path's requests. Legacy: one 150-token prompt. With the
    fast schedules: a random prompt alone (multi-step decode), a 2-token
    request alone (its one decode step a one-row wave: the compact leg), a
    prompt that arrives while another row decodes (mixed waves; its
    repeated 12-token pattern gives n-gram drafts, so speculative verify),
    and a replay of the first (tree drafts). With the tiers: three
    150-token prompts one after another (the third evicts the first to the
    host tier), then the first again (a staged host restore)."""
    rng = np.random.default_rng(1)
    first = rng.integers(0, cfg.vocab_size, size=150).tolist()
    if tiers:
        prompts = [first] + [rng.integers(0, cfg.vocab_size, size=150).tolist() for _ in range(2)]
        out = [eng.generate([p])[0] for p in prompts + [first]]
        return out + [[eng.stats.cached_tokens]]
    if not schedules:
        return eng.generate([first])

    def drain():
        while eng.has_work():
            eng.step()

    sp = SamplingParams(max_new_tokens=16)
    reqs = [eng.add_request(first, sp)]
    drain()
    reqs.append(eng.add_request(rng.integers(0, cfg.vocab_size, size=40).tolist(),
                                SamplingParams(max_new_tokens=2)))
    drain()
    reqs.append(eng.add_request(rng.integers(0, cfg.vocab_size, size=100).tolist(),
                                SamplingParams(max_new_tokens=24)))
    for _ in range(2):
        eng.step()
    reqs.append(eng.add_request((rng.integers(0, cfg.vocab_size, size=12).tolist() * 13)[:150], sp))
    drain()
    reqs.append(eng.add_request(first, sp))
    drain()
    return [r.generated for r in reqs]


@functools.lru_cache(maxsize=1)
def _whole_path_params(model: str) -> dict:
    """The whole-path checks' 2-layer float32 weights on the CPU (several
    GB at full width, built once per model; the engines copy them)."""
    cfg = get_config(model, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    if cfg.qkv_bias:
        plant_biases(params, 1)
    return params


def whole_path_check(dev, kv_quant=None, schedules=None, tiers=False, model="llama3-8b") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(model, n_layers=2, dtype=torch.float32)
    params = _whole_path_params(model)
    kw = dict(num_slots=1024, page_size=16, max_batch=2, long_prefill_threshold=16,
              prefill_chunk=64, kv_quant=kv_quant, **(schedules or {}))
    if tiers:
        # A 23-page pool (the third prompt evicts the first), a host tier
        # and the async plane.
        kw.update(num_slots=384, host_cache_slots=4096, kv_transfer_async=True,
                  kv_transfer_chunk_tokens=64)
    atol = 1e-3 if kv_quant is None else 1e-2
    out, logits, pools, restored = {}, {"cuda": [], "cpu": []}, {}, {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        eng = Engine(cfg, params, device=device, **kw)
        eng.on_first_logits = lambda req, row, name=name: logits[name].append(row.float().cpu())
        if name == "cuda":
            pa.reset_counters()
        out[name] = _whole_path_script(eng, cfg, schedules, tiers)
        if tiers:
            eng.close()
            restored[name] = eng.kv_transfer.stats()["restored_tokens"]
        if name == "cuda":
            torch.cuda.synchronize()
            attr = "launches" if kv_quant is None else "launches_int8"
            launches = {"decode": getattr(pa.paged_decode_fused_kernel, attr),
                        "chunk_cuda_core_body": pa.paged_chunk_attention_kernel.launches_f32_body,
                        "plain_calls": pa.plain_calls()}
            counts = _counts(eng)
        keep = torch.ones(eng.pool.num_slots, dtype=torch.bool)
        keep[eng._scratch_page * eng.page_size : (eng._scratch_page + 1) * eng.page_size] = False
        pools[name] = eng.pool.kv.cpu()[:, :, :, keep]
        del eng
    diff = max((a - b).abs().max().item() for a, b in zip(logits["cuda"], logits["cpu"]))
    # Pool elements that differ card vs CPU, per layer, and by how much
    # (for an int8 pool: how many payload bytes, and by how many steps).
    delta = (pools["cuda"].float() - pools["cpu"].float()).abs()
    per_layer = [int(n) for n in (delta > 0).sum(dim=(0, 2, 3, 4)).tolist()]
    pool_max = delta.max().item()
    tag = ("" if model == "llama3-8b" else model + " ") + (kv_quant or "float32") + (
        " schedules" if schedules else "") + (" tiers" if tiers else "")
    print(f"[whole-path {tag}] 2-layer f32 {model} widths: first-token logits of "
          f"{len(logits['cuda'])} requests max|cuda-cpu|={diff:.3e} (atol {atol}); pool elements that "
          f"differ card vs CPU (scratch page excluded) per layer: {per_layer} of {delta[:, 0].numel()}, "
          f"max |diff| {pool_max:.3g}; tokens cuda={out['cuda']} cpu={out['cpu']}", flush=True)
    print(f"[whole-path {tag}] card launches: {launches}; engine counts: {counts}", flush=True)
    check(len(logits["cuda"]) == len(logits["cpu"]) > 0, f"{tag}: first tokens sampled differ in number")
    check(diff <= atol, f"{tag}: card vs CPU first-token logits differ by {diff}")
    check(out["cuda"] == out["cpu"], f"{tag}: card vs CPU greedy tokens differ")
    check(launches["decode"] > 0 and launches["chunk_cuda_core_body"] > 0,
          f"{tag}: the card run did not launch the split decode and the CUDA-core chunk body")
    check(launches["plain_calls"] == 0, f"{tag}: plain attention calls on the card")
    check(launches["decode"] == cfg.n_layers * counts["decode_forwards"],
          f"{tag}: decode kernel launches != layers x decode passes")
    b2 = cfg.n_layers * (counts["prefill_chunks"] + counts["verify_launches"] + counts["mixed_launches"]
                         + counts["inline_launches"])
    check(launches["chunk_cuda_core_body"] == b2, f"{tag}: chunk launches != layers x chunk launches")
    if schedules:
        for k in ("verify_launches", "mixed_launches", "multi_step_launches", "compact_launches",
                  "spec_accepted"):
            check(counts[k] > 0, f"{tag}: {k} is 0 on the card")
    if tiers:
        print(f"[whole-path {tag}] tokens restored by the plane: {restored}", flush=True)
        check(restored["cuda"] == restored["cpu"] > 0, f"{tag}: no host restore, or card and CPU differ")
    return {"logits_max_abs_diff": diff, "atol": atol, "pool_elements_differing": per_layer,
            "pool_max_abs_diff": pool_max, "tokens": out["cuda"], "launches": launches,
            "engine_counts": counts}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 18: tensor- and sequence-parallel serving, the ranks on the one card

# Sizes of phase 18 (a CPU rehearsal shrinks them). Llama-3-8B at full
# width and ``layers`` deep (a depth cut: one card holds two ranks' whole-
# model sp weights beside this process; and at 32 layers the GEMMs'
# rounding order alone puts tp's bf16 rows 2-3 % from the plain single
# device's, past ``ROW_RTOL``, while they equal a single device with its
# products split as tp splits them, PERF.md). ``witness`` reads the rows
# instead of holding them and adds the rounding witnesses
# (``--parallel-alone``). The tp legs: four prompts (the two long ones share
# a chunk bucket: group prefill through the chunk kernel) and a prefix hit;
# the sp prompt; the float32 leg.
PAR = dict(model="llama3-8b", layers=8, slots=16384, prompts=(300, 280, 100, 150), new_tokens=8,
           hit_extra=64, f32_layers=4, f32_prompts=(300, 280), sp_prompt=8192, sp_warm=4096,
           sp_slots=16384, sp_layers=(0, 4, 7), world=2, nccl_layers=2, nccl_prompt=100, timeout_s=900,
           collective_timeout_s=600, device="cuda", witness=False,
           # (g): 200-token prompts in a pool that holds one of them but not
           # two, so the script a, b, a evicts a to the host tier and restores
           # it. Short prompts, and one token for a and b: under tp every
           # chunk all-gathers the logits of every position and every decode
           # step crosses the ranks twice a layer, which set (g)'s wall.
           g=dict(prompt=200, slots=384, ref_slots=4096, host_slots=1024, new_tokens=3, handoff_prompt=200,
                  mesh_prompt=200))
# Per-rank head counts of B1, B2 and B3 on phase 18's shapes: Llama-3-8B and
# Qwen2-7B at tp = 2.
PAR_HEADS = {"llama3-8b tp=2": (16, 4), "qwen2-7b tp=2": (14, 2)}
# (e)'s legs: tag -> Engine arguments, each on a pp = 2 stage.
PP_LEGS = {"pp bf16": {}, "pp int8": dict(kv_quant="int8"), "pp k=4": dict(decode_steps_per_launch=4),
           "pp spec": dict(spec_decode_tokens=4)}


def sharded_kernel_phase(dev) -> dict:
    """(a) B1, B2 (both bodies) and B3 at the per-rank head counts of a tp = 2
    rank, and B1 and B2 over a pp = 2 stage's microbatch, each against its
    plain version with phase 2's limits (the row check included), timed as
    phase 2 times them."""
    results: dict[str, list] = {}
    run = _runner(results, "kernel tp")
    f32, bf16 = torch.float32, torch.bfloat16
    for tag, heads in PAR_HEADS.items():
        run("paged_decode_fused", decode_case, f"decode B=8 ragged {tag}", RAGGED, bf16, dev, True, 51, heads=heads)
        run("paged_decode_fused[int8]", decode_case, f"decode B=8 ragged {tag} int8", RAGGED, bf16, dev, False, 52,
            quant=True, heads=heads)
        run("paged_attention_pool", pool_case, f"pool B=8 ragged {tag}", RAGGED, bf16, dev, True, 53, heads=heads)
        run("paged_chunk_attention", chunk_case, f"chunk B=8 ragged {tag}", CHUNK_PRIOR, CHUNK_FILL, bf16, dev,
            True, 54, heads=heads)
        run("paged_chunk_attention", chunk_case, f"chunk verify C=5 {tag}", CHUNK_PRIOR, VERIFY_FILL, bf16, dev,
            False, 55, C=5, heads=heads)
        run("paged_chunk_attention[int8]", chunk_case, f"chunk B=8 ragged {tag} int8", CHUNK_PRIOR, CHUNK_FILL,
            bf16, dev, False, 56, quant=True, heads=heads)
        run("paged_chunk_attention[f32]", chunk_case, f"chunk B=8 ragged {tag}", CHUNK_PRIOR, CHUNK_FILL, f32, dev,
            True, 57, heads=heads)
    # A pp = 2 stage runs the kernels at every head of its layers over one
    # microbatch: half the rows (the longer half of phase 2's).
    run("paged_decode_fused", decode_case, "decode B=4 pp=2 microbatch", RAGGED[4:], bf16, dev, True, 58)
    run("paged_chunk_attention", chunk_case, "chunk B=4 pp=2 microbatch", CHUNK_PRIOR[4:], CHUNK_FILL[4:], bf16,
        dev, True, 59)
    return results


def _par_script(cfg, lengths, seed: int = 18):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    hit = prompts[0] + rng.integers(0, cfg.vocab_size, PAR["hit_extra"]).tolist()
    return prompts, hit


def _par_leg(engine, prompts, hit, dev, new_tokens) -> dict:
    """One leg's script on one engine (a rank's, or the single-device
    reference): a warm-up, the prompts submitted together, then the prefix
    hit. Records every first-token logit row, the first decode step's fed
    tokens and logits, each decode step's wall, TTFTs and the launches."""
    greedy = SamplingParams(temperature=0.0, max_new_tokens=new_tokens)
    engine.generate([prompts[2][:64]], SamplingParams(temperature=0.0, max_new_tokens=2))
    firsts, dec = [], {"walls": []}
    engine.on_first_logits = lambda req, row: firsts.append(row.float().cpu())
    # One decode step: the model's, or under pp the pipeline's (the engine's
    # seam; a stage's model runs no whole step).
    owner, attr = (engine, "_decode_step") if engine._pp else (engine.model, "decode_step")
    decode_step = getattr(owner, attr)

    def timed_step(tokens, *a, **kw):
        _sync(dev)
        t = time.perf_counter()
        out = decode_step(tokens, *a, **kw)
        _sync(dev)
        dec["walls"].append(time.perf_counter() - t)
        if "logits" not in dec:
            # A copy: under pp ``tokens`` is the engine's live host buffer.
            dec["tokens"], dec["logits"] = torch.as_tensor(tokens).cpu().clone(), out.float().cpu()
        return out

    setattr(owner, attr, timed_step)
    try:
        _sync(dev)
        pa.reset_counters()
        c0, n0 = _counts(engine), len(engine.stats.ttft_s)
        t = time.monotonic()
        out = engine.generate(prompts, greedy)
        group_wall = time.monotonic() - t
        cached0 = engine.stats.cached_tokens
        out_hit = engine.generate([hit], greedy)[0]
        _sync(dev)
        counts, plain = pa.launch_counts(), pa.plain_calls()
        st = {k: v - c0[k] for k, v in _counts(engine).items()}
    finally:
        delattr(owner, attr)  # back to the class's method
    ttft = list(engine.stats.ttft_s[n0:])
    return {"tokens": out, "hit_tokens": out_hit, "hit_cached": engine.stats.cached_tokens - cached0,
            "ttft_s": ttft[:-1], "hit_ttft_s": ttft[-1], "group_wall_s": group_wall,
            "decode_step_ms": float(np.median(dec["walls"]) * 1e3) if dec["walls"] else None,
            "decode_steps_timed": len(dec["walls"]), "counts": counts, "plain_calls": plain, "stats": st,
            "firsts": firsts, "dec0": (dec.get("tokens"), dec.get("logits"))}


def _par_leg_checks(tag, leg, cfg, quant, dev, pp=1) -> dict:
    """A leg's own checks on one rank; returns its JSON-ready summary. The
    launch checks hold on the card (a CPU rehearsal runs the plain
    versions). A pp stage runs ``L/pp`` layers per microbatch: a decode
    pass is ``pp`` microbatches (``max_batch`` divides), a chunk one or
    ``pp`` (``Engine._pp_n_micro``)."""
    sfx = "[int8]" if quant else ""
    L, st = cfg.n_layers, leg["stats"]
    b1 = leg["counts"]["paged_decode_fused_kernel" + sfx]
    b2 = leg["counts"]["paged_chunk_attention_kernel" + sfx]
    b2_want = sum(_b2_by_schedule(st, L).values())
    if dev.type == "cuda":
        check(b1 == L * st["decode_forwards"] > 0, f"tp {tag}: decode kernel launches {b1} != {L} x "
              f"{st['decode_forwards']} decode passes")
        check(b2_want // pp <= b2 <= b2_want and b2 > 0,
              f"tp {tag}: chunk kernel launches {b2}, not in [{b2_want // pp}, {b2_want}]")
        check(leg["plain_calls"] == 0, f"tp {tag}: {leg['plain_calls']} plain attention calls on the card")
    check(leg["hit_cached"] >= PAR["prompts"][0] // 16 * 16,
          f"tp {tag}: the prefix hit reused {leg['hit_cached']} tokens")
    if "schedules" in tag:
        fused = st["multi_step_launches"] + st["compact_launches"] + st["verify_launches"] + st["mixed_launches"]
        check(fused > 0, f"tp {tag}: no launch of a fast schedule ({st})")
    check(tag != "pp k=4" or st["multi_step_launches"] > 0, f"{tag}: no pp_decode_multi launch ({st})")
    check(tag != "pp spec" or leg["replay_verify_launches"] > 0, f"{tag}: no verify launch ({st})")
    for toks in leg["tokens"] + [leg["hit_tokens"]]:
        check(len(toks) == PAR["new_tokens"] and all(0 <= t < cfg.vocab_size for t in toks),
              f"tp {tag}: bad output {toks}")
    return {k: v for k, v in leg.items() if k not in ("firsts", "dec0")} | {"b1": b1, "b2": b2}


def _par_logit_errs(got, want) -> dict:
    """A leg's first-token logit rows and first decode step's rows against
    another run's (rows of the decode step only where both fed the same
    token: a bf16 near-tie may flip a first token)."""
    check(len(got["firsts"]) == len(want["firsts"]), "first-token rows differ in number")
    first_err = max(_row_rel_err(a, b) for a, b in zip(got["firsts"], want["firsts"]))
    (gt, gl), (wt, wl) = got["dec0"], want["dec0"]
    n = min(len(gt), len(wt))
    same = (gt[:n] == wt[:n]).nonzero().flatten()
    check(len(same) > 0, "no decode row fed the same token")

    def rows(a, b):
        return ((a.float() - b.float()).norm(dim=-1) / (b.float().norm(dim=-1) + 1e-6)).flatten().tolist()

    return {"first_token_row_err": first_err, "decode0_row_err": _row_rel_err(gl[same], wl[same]),
            "decode0_rows": int(len(same)), "decode0_rows_all": int(n),
            "first_token_row_errs": [max(rows(a, b)) for a, b in zip(got["firsts"], want["firsts"])],
            "decode0_row_errs": rows(gl[same], wl[same])}


def _par_logit_checks(tag, got, want, hold=True) -> dict:
    """``_par_logit_errs`` of a tp leg against the single-device engine, each
    held to ``ROW_RTOL`` (with ``hold``; else only read), with the single
    device's walls and tokens beside it."""
    errs = _par_logit_errs(got, want)
    check(not hold or errs["first_token_row_err"] <= ROW_RTOL,
          f"tp {tag}: first-token logits row error {errs['first_token_row_err']} > {ROW_RTOL}")
    check(not hold or errs["decode0_row_err"] <= ROW_RTOL,
          f"tp {tag}: first decode step logits row error {errs['decode0_row_err']} > {ROW_RTOL}")

    def first_diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)

    diffs = [first_diff(a, b) for a, b in zip(got["tokens"] + [got["hit_tokens"]],
                                               want["tokens"] + [want["hit_tokens"]])]
    return {**errs, "first_diff_vs_single": diffs,
            "single_ttft_s": want["ttft_s"], "single_hit_ttft_s": want["hit_ttft_s"],
            "single_decode_step_ms": want["decode_step_ms"], "single_group_wall_s": want["group_wall_s"]}


def _split_tp(model, parts: int) -> dict:
    """Every product of a single-device model as tp = ``parts`` takes it:
    ``_split_reduced`` for ``wo``/``w_down``, the column-parallel ``_proj``
    products and the LM head each as ``parts`` products over contiguous
    column slices, concatenated. What is left of tp is the attention kernels
    at a rank's head counts."""
    from radixmesh_tpu_torch.models.llama import _head_product
    from radixmesh_tpu_torch.ops.norm import rms_norm

    def cols(x, w, product):
        n = w.shape[-1] // parts
        return torch.cat([product(x, w[..., i * n:(i + 1) * n].contiguous()) for i in range(parts)], dim=-1)

    def proj(x, name, l):
        return cols(x, model.layers[name][l], torch.matmul)

    def logits(x):
        x = rms_norm(x, model.final_norm, model.cfg.rms_eps)
        return cols(x, model.embed.t() if model.cfg.tie_embeddings else model.lm_head, _head_product)

    return {"_proj_reduced": _split_reduced(model, parts), "_proj": proj, "_logits": logits}


def _split_reduced(model, parts: int):
    """``model._proj_reduced`` for a single-device model as tp = ``parts``
    takes it: the contraction in ``parts`` slices, each product with a
    float32 result, the partials summed in rank order, the sum cast to the
    activations' dtype."""
    from radixmesh_tpu_torch.models.llama import _head_product

    def proj(x, name, l):
        w = model.layers[name][l]
        k = w.shape[0] // parts
        y = _head_product(x[..., :k].contiguous(), w[:k])
        for i in range(1, parts):
            y = y + _head_product(x[..., i * k:(i + 1) * k].contiguous(), w[i * k:(i + 1) * k])
        return y.to(x.dtype)

    return proj


def _par_witness(full, tp_leg, single, ref_kw, prompts, hit, dev) -> dict:
    """Where a tp leg's logit rows part from the single device's, read on the
    same weights: the single device's own spread (the same engine at
    ``max_batch`` 4, so other GEMM shapes in decode); a single device whose
    row-parallel products (``wo``, ``w_down``) are taken as tp's float32
    partials and summed (``_split_reduced``); and one whose every product is
    split as tp splits it (``_split_tp``). Each against the single device
    and against the tp leg."""
    eng = Engine(full.cfg, full, **{**ref_kw, "max_batch": 4})
    out = {"own_spread": _par_logit_errs(_par_leg(eng, prompts, hit, dev, PAR["new_tokens"]), single)}
    del eng
    _release(dev)
    for tag, patches in (("split", {"_proj_reduced": _split_reduced(full, PAR["world"])}),
                         ("split_all", _split_tp(full, PAR["world"]))):
        leg = _par_patched_leg(full, patches, ref_kw, prompts, hit, dev)
        out[f"{tag}_vs_single"] = _par_logit_errs(leg, single)
        out[f"tp_vs_{tag}"] = _par_logit_errs(tp_leg, leg)
    return out


def _par_patched_leg(full, patches, ref_kw, prompts, hit, dev) -> dict:
    """``_par_leg`` on a single-device engine over ``full`` with some of its
    methods replaced for the leg."""
    for k, f in patches.items():
        setattr(full, k, f)
    try:
        eng = Engine(full.cfg, full, **ref_kw)
        leg = _par_leg(eng, prompts, hit, dev, PAR["new_tokens"])
        del eng
    finally:
        for k in patches:
            delattr(full, k)  # back to the class's methods
    _release(dev)
    return leg


def _par_split_check(tag, full, tp_leg, ref_kw, prompts, hit, dev) -> dict:
    """A tp leg against a single device whose every product is split as tp
    splits it (``_split_tp``): the same arithmetic in the same order, so
    the logit rows and tokens must be equal bit for bit (the all-reduce of
    two float32 partials and the gathers are exact, and the attention
    kernels round a head the same at any head count)."""
    split = _par_patched_leg(full, _split_tp(full, PAR["world"]), ref_kw, prompts, hit, dev)
    errs = _par_logit_errs(tp_leg, split)
    check(errs["first_token_row_err"] == 0 and errs["decode0_row_err"] == 0,
          f"tp {tag}: logit rows differ from the split single device's: {errs}")
    check(tp_leg["tokens"] == split["tokens"] and tp_leg["hit_tokens"] == split["hit_tokens"],
          f"tp {tag}: tokens differ from the split single device's")
    return errs


def _par_pool_path(engine, seq, dev) -> dict:
    """B3 through its sharded wrapper over every layer of the pages a tp
    engine published for ``seq`` (this rank's heads), counted alone and held
    against its plain version."""
    from radixmesh_tpu_torch.ops.attention import paged_attention_pool_kernel_sharded

    m = engine.tree.match_prefix(np.asarray(seq, np.int32))
    check(m.length > 0, "tp pool path: the served sequence is not in the tree")
    table = engine.pool.page_table(m.indices()[: m.length])
    pt = torch.as_tensor(np.asarray(table, np.int32)[None], device=dev)
    ln = torch.as_tensor(np.asarray([m.length], np.int32), device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(1, engine.model.n_heads, engine.cfg.head_dim, generator=g, device=dev).to(engine.cfg.dtype)
    kv = engine.pool.pages()
    _sync(dev)
    pa.reset_counters()
    outs = [paged_attention_pool_kernel_sharded(q, kv, pt, ln, layer) for layer in range(engine.cfg.n_layers)]
    _sync(dev)
    launches = pa.paged_attention_pool_kernel.launches
    err = max((o.float() - pa.paged_attention_pool_plain(q, kv, pt, ln, layer).float()).abs().max().item()
              for layer, o in enumerate(outs))
    if dev.type == "cuda":
        check(launches == engine.cfg.n_layers, f"tp pool path: {launches} launches")
    check(err <= ATOL[engine.cfg.dtype], f"tp pool path: max |kernel - plain| = {err}")
    return {"launches": launches, "max_abs_err": err, "tokens": m.length}


def _kv_layers(engine, slots, layers) -> torch.Tensor:
    """``[2, len(layers), Hkv, n, D]`` of the pool at ``slots``, on the host."""
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=engine.pool.kv.device)
    return engine.pool.kv[:, list(layers)][:, :, :, idx].float().cpu()


def _par_sp_leg(engine, prompt, warm, dev, layers) -> dict:
    """One long prompt served alone (one token past it), after a warm-up
    prompt: its TTFT, first-token logits and the pool's K/V of the checked
    layers."""
    engine.generate([warm], SamplingParams(temperature=0.0, max_new_tokens=2))
    firsts = []
    engine.on_first_logits = lambda req, row: firsts.append(row.float().cpu())
    n0 = len(engine.stats.ttft_s)
    _sync(dev)
    req = engine.add_request(prompt, SamplingParams(temperature=0.0, max_new_tokens=2))
    while engine.has_work():
        engine.step()
    _sync(dev)
    check(req.state is RequestState.FINISHED, "sp leg: the request did not finish")
    kv = _kv_layers(engine, req.token_slots[: len(prompt)], layers)
    return {"ttft_s": engine.stats.ttft_s[n0], "first": firsts[0], "kv": kv, "tokens": req.generated,
            "prefill_chunks": engine.stats.prefill_chunks}


def _bits_digest(t) -> str:
    """sha256 of a tensor's bytes, on the host (bf16 read as its bit
    patterns)."""
    import hashlib

    if t is None:
        return ""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _par_ici_leg(rank, mesh, full, prompt, dev) -> dict:
    """(f) ``IciHandoff`` between rank 0 (a ``PrefillWorker``, ``device_kv``)
    and rank 1 (a ``DecodeWorker``) over the mesh's dp axis, gloo, for a bf16
    and an int8 pool on the whole model: each side's block digest (the
    source's before the move, the destination's after it), the decode
    tokens beside a collocated engine's (rank 1), and the p2p bytes and
    seconds of the move."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, IciHandoff, PrefillWorker
    from radixmesh_tpu_torch.parallel import collective_stats, reset_collective_stats

    greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR["new_tokens"])
    kw = dict(num_slots=4096, page_size=16, max_batch=2, device=dev)
    out = {}
    for tag, quant in (("bf16", None), ("int8", "int8")):
        chan = IciHandoff(mesh, "dp", src_rank=0, dst_rank=1, page_size=16, device=dev)
        pkt = None
        if rank == 0:
            pkt = PrefillWorker(full.cfg, full, kv_quant=quant, **kw).prefill_handoff(prompt, greedy,
                                                                                      device_kv=True)
            check(pkt.kv.is_cuda or dev.type != "cuda", "ici: the packet's KV left the device")
        _sync(dev)
        reset_collective_stats()
        t = time.perf_counter()
        moved = chan.move(pkt)
        _sync(dev)
        wall = time.perf_counter() - t
        p2p = collective_stats().get("p2p", {"calls": 0, "seconds": 0.0, "bytes": 0})
        r = {"move_wall_s": wall, "p2p": p2p}
        if rank == 0:
            check(moved is None, "ici: the source got a packet back")
            r.update(kv_digest=_bits_digest(pkt.kv), scale_digest=_bits_digest(pkt.kv_scale),
                     kv_bytes=pkt.kv.numel() * pkt.kv.element_size())
        else:
            check(moved is not None and moved.kv.device == torch.device(dev), "ici: no packet on the destination")
            r.update(kv_digest=_bits_digest(moved.kv), scale_digest=_bits_digest(moved.kv_scale),
                     kv_bytes=moved.kv.numel() * moved.kv.element_size())
            dw = DecodeWorker(Engine(full.cfg, full, kv_quant=quant, **kw))
            req = dw.submit(moved)
            dw.run_until_drained()
            want = Engine(full.cfg, full, kv_quant=quant, **kw).generate([prompt], greedy)[0]
            check(req.generated == want, f"ici {tag}: decode tokens {req.generated} != collocated {want}")
            r.update(tokens=req.generated, collocated=want)
            del dw
        out[tag] = r
        del pkt, moved
        _release(dev)
    return out


# (g)'s tier setups (its sizes are ``PAR["g"]``); the plane stages 64-token
# chunks, so a restore of a's 192 tokens lands in three.
TIER_G_SETUPS = {"host": {},
                 "host+disk": dict(kv_tier_watermark=0.0, kv_tier_destage_interval_s=0.0,
                                   kv_transfer_chunk_tokens=64),
                 "host+plane": dict(kv_transfer_async=True, kv_transfer_chunk_tokens=64)}


def _first_decode_row(engine) -> dict:
    """Record the first decode step's fed tokens and logits of ``engine``
    (the model's step, or the pipeline's under pp) into the returned dict."""
    owner, attr = (engine, "_decode_step") if engine._pp else (engine.model, "decode_step")
    step = getattr(owner, attr)
    seen = {}

    def first(tokens, *a, **kw):
        out = step(tokens, *a, **kw)
        if "logits" not in seen:
            seen["tokens"], seen["logits"] = torch.as_tensor(tokens).cpu().clone(), out.float().cpu()
        return out

    setattr(owner, attr, first)
    return seen


def _tier_run(model, mesh, dev, quant, setup, prompts, root) -> dict:
    """(g) one engine on ``mesh`` over prompts a, b, a: no tier (a pool that
    holds both, so the second a is a device hit) or a tier setup (a pool
    that holds one: the second a is a restore). The first-token rows, the
    tokens, the tier counters and the lanes' rates."""
    from radixmesh_tpu_torch.parallel import collective_stats, reset_collective_stats

    extra = dict(TIER_G_SETUPS.get(setup, {}))
    if setup != "none":
        extra["host_cache_slots"] = PAR["g"]["host_slots"]
    if "disk" in setup:
        extra["kv_tier_dir"] = root
    slots = PAR["g"]["ref_slots"] if setup == "none" else PAR["g"]["slots"]
    # Every prefill through the chunk kernel (B2), the restored hit's too.
    eng = Engine(model.cfg, model, num_slots=slots, page_size=16, max_batch=2, device=dev, device_mesh=mesh,
                 kv_quant=quant, long_prefill_threshold=0, **extra)
    firsts = []
    eng.on_first_logits = lambda req, row: firsts.append(row.float().cpu())
    # a and b only fill the tiers (their first token); the restored a decodes.
    news = [1] * (len(prompts) - 1) + [PAR["g"]["new_tokens"]]
    reset_collective_stats()
    _sync(dev)
    t = time.perf_counter()
    tokens = [eng.generate([p], SamplingParams(temperature=0.0, max_new_tokens=k))[0]
              for p, k in zip(prompts, news)]
    _sync(dev)
    wall = time.perf_counter() - t
    coll = collective_stats()
    r = {"tokens": tokens, "firsts": firsts, "wall_s": wall, "cached": eng.stats.cached_tokens,
         "evicted": eng.stats.evicted_tokens}
    tree = eng.tree
    if setup != "none":
        hs = tree.stats()
        r["hicache"] = {k: hs[k] for k in ("backup_tokens", "restore_tokens", "writeback_sweeps")}
        per_tok = kv_token_bytes(eng.pool)
        if eng.kv_transfer is None:  # the synchronous restore: its blocking time
            r["restore_gbps"] = hs["restore_tokens"] * per_tok / max(hs["restore_stall_s"], 1e-9) / 1e9
        else:
            st = eng.kv_transfer.stats()
            lb, ls = st["lane_bytes"], st["lane_seconds"]
            r["restore_gbps"] = lb["restore"] / ls["restore"] / 1e9 if ls["restore"] else None
            r["writeback_gbps"] = lb["writeback"] / ls["writeback"] / 1e9 if ls["writeback"] else None
            r["spill_gbps"] = lb["spill"] / ls["spill"] / 1e9 if ls["spill"] else None
            r["plane_restored_tokens"] = st["restored_tokens"]
        if eng._kv_tier is not None:
            ds = eng._kv_tier.stats()
            r["disk"] = {"spilled_tokens": ds["spilled_tokens"], "extents": eng._kv_tier.extents}
        if eng._sync is not None:
            a = coll.get("agree", {"calls": 0, "seconds": 0.0})
            r["agree"] = {"passes": eng._sync.passes, "calls": a["calls"], "seconds": a["seconds"],
                          "broadcasts": coll.get("agree_broadcast", {"calls": 0})["calls"]}
    eng.close()
    del eng
    return r


def _par_tier_leg(rank, meshes: dict, full, dev, out_dir) -> dict:
    """(g) The KV tiers, the async plane, the disaggregated handoff and a
    pool-bound mesh replica on tp = 2 and pp = 2 (every rank runs it):

    - per mesh and pool kind, the script without tiers and with each tier
      setup: the tier runs' first-token rows and tokens bit-equal to the
      run without tiers (restored KV is the KV that was written), their
      counters > 0 (and equal across ranks, held by the parent);
    - a ``PrefillWorker`` per mesh: the leader's packet, whose slices equal
      each rank's own pool shard (digests held by the parent), written for
      the parent's single-device decode; a single-device packet decoded by a
      tp = 2 ``DecodeWorker``, its first decode row against the single
      device's own decode of it;
    - a pool-bound ``MeshCache`` replica on the leader, in a ring over the
      native tcp transport with the parent's replica: the engine serves a
      prompt, the parent's prompt replicates in, a free through the
      replica's proxy lands on every rank, and every rank's slots balance.
    Returns the readings, and each rank's B1/B2 launches over the leg."""
    from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, PrefillWorker, pack_handoff, unpack_handoff
    from radixmesh_tpu_torch.models.llama import param_logical_axes
    from radixmesh_tpu_torch.parallel import shard_params
    import torch.distributed as dist

    cfg = full.cfg
    rng = np.random.default_rng(22)
    a, b = (rng.integers(0, cfg.vocab_size, PAR["g"]["prompt"]).tolist() for _ in range(2))
    script = [a, b, a]
    hp = rng.integers(0, cfg.vocab_size, PAR["g"]["handoff_prompt"]).tolist()
    out = {"runs": {}, "handoff": {}, "digests": {}}
    launches = {}
    tree = full.param_tree()
    for mtag, mesh in meshes.items():
        shards = Llama(cfg, shard_params(tree, param_logical_axes(cfg, tree), mesh), mesh=mesh)
        pa.reset_counters()
        for qtag, quant in (("bf16", None), ("int8", "int8")):
            base = _tier_run(shards, mesh, dev, quant, "none", script, None)
            for setup in TIER_G_SETUPS:
                root = str(out_dir / f"kv-tier-g-{mtag.replace('=', '')}-{qtag}")
                r = _tier_run(shards, mesh, dev, quant, setup, script, root)
                tag = f"{mtag} {qtag} {setup}"
                check(r["tokens"] == base["tokens"], f"(g) {tag}: tokens {r['tokens']} != without tiers "
                      f"{base['tokens']}")
                check(len(r["firsts"]) == len(base["firsts"]) == 3
                      and all(torch.equal(x, y) for x, y in zip(r["firsts"], base["firsts"])),
                      f"(g) {tag}: first-token rows differ from the run without tiers")
                check(r["cached"] == base["cached"] > 0 and r["evicted"] > 0,
                      f"(g) {tag}: cached {r['cached']} vs {base['cached']}, evicted {r['evicted']}: the second "
                      "a did not restore")
                check(r["hicache"]["backup_tokens"] > 0 and r["hicache"]["restore_tokens"] > 0,
                      f"(g) {tag}: hicache counters {r['hicache']}")
                check("disk" not in setup or r["disk"]["spilled_tokens"] > 0, f"(g) {tag}: nothing spilled")
                out["runs"][tag] = {k: v for k, v in r.items() if k != "firsts"} | {"base_wall_s": base["wall_s"]}
                dist.barrier()
                if rank == 0:
                    shutil.rmtree(root, ignore_errors=True)
        c = pa.launch_counts()
        launches[mtag] = {k: c[k] for k in ("paged_decode_fused_kernel", "paged_decode_fused_kernel[int8]",
                                            "paged_chunk_attention_kernel", "paged_chunk_attention_kernel[int8]")}
        # The handoff from this mesh: the leader's packet, and each rank's
        # own shard of the published prefix.
        greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR["g"]["new_tokens"])
        pw = PrefillWorker(cfg, shards, num_slots=PAR["g"]["ref_slots"], page_size=16, max_batch=2, device=dev,
                           device_mesh=mesh, long_prefill_threshold=0)
        _sync(dev)
        t = time.perf_counter()
        pkt = pw.prefill_handoff(hp, greedy)
        _sync(dev)
        h = {"wall_s": time.perf_counter() - t, "gather_s": pw.gather_s, "gather_bytes": pw.gather_bytes}
        m = pw.tree.match_prefix(np.asarray(hp, np.int32))
        n = len(m.indices())
        kv_local, _ = pw.pool.gather_raw(np.asarray(m.indices(), np.int32))
        h["own_digest"] = _bits_digest(kv_local)
        if pkt is not None:
            L, H = pw.model.n_layers, pw.model.n_kv_heads
            h["slice_digests"] = {}
            for r in range(mesh.engine_size):
                pp_i, tp_i = (r // mesh.size("tp")) % mesh.size("pp"), r % mesh.size("tp")
                h["slice_digests"][r] = _bits_digest(pkt.kv[:, pp_i * L:(pp_i + 1) * L, :n, tp_i * H:(tp_i + 1) * H])
            h["kv_bytes"] = pkt.kv.numel() * pkt.kv.element_size()
            (out_dir / f"par-g-packet-{mtag.replace('=', '')}.bin").write_bytes(pack_handoff(pkt))
            h["prompt"] = hp
        out["handoff"][mtag] = h
        del pw, pkt
        if mtag == "tp=2":
            # A single-device packet (rank 0, the whole model) into a tp = 2
            # DecodeWorker; rank 0 also decodes it on the single device.
            data = None
            ref = {}
            if rank == 0:
                spw = PrefillWorker(cfg, full, num_slots=PAR["g"]["ref_slots"], page_size=16, max_batch=2,
                                    device=dev, long_prefill_threshold=0)
                data = pack_handoff(spw.prefill_handoff(hp, greedy))
                del spw
                one = DecodeWorker(Engine(cfg, full, num_slots=PAR["g"]["ref_slots"], page_size=16, max_batch=2,
                                          device=dev))
                ref = _first_decode_row(one.engine)
                ref_req = one.submit(unpack_handoff(data))
                one.run_until_drained()
                ref["generated"] = ref_req.generated
                del one
            eng = Engine(cfg, shards, num_slots=PAR["g"]["ref_slots"], page_size=16, max_batch=2, device=dev,
                         device_mesh=mesh)
            dw = DecodeWorker(eng)
            row = _first_decode_row(eng)
            made = []
            make = dw._make_request
            dw._make_request = lambda p: made.append(make(p)) or made[-1]
            if data is not None:
                dw._on_packet(data)
            _sync(dev)
            t = time.perf_counter()
            dw.run_until_drained()
            _sync(dev)
            d = {"wall_s": time.perf_counter() - t, "tokens": [q.generated for q in made]}
            if rank == 0:
                d["single_tokens"] = ref["generated"]
                same = bool(torch.equal(row["tokens"][:1], ref["tokens"][:1]))
                d["first_row_err"] = _row_rel_err(row["logits"][0], ref["logits"][0]) if same else None
                check(PAR["witness"] or d["first_row_err"] is None or d["first_row_err"] <= ROW_RTOL,
                      f"(g) tp=2 DecodeWorker: first decode row err {d['first_row_err']} > {ROW_RTOL}")
            check(len(made) == 1 and len(made[0].generated) == PAR["g"]["new_tokens"],
                  f"(g) tp=2 DecodeWorker decoded {[q.generated for q in made]}")
            out["handoff"]["single -> tp=2"] = d
            del dw, eng
        # A pool-bound mesh replica on the leader (tp = 2 only: one ring).
        if mtag == "tp=2" and PAR.get("g_addrs"):
            addrs = PAR["g_addrs"]
            L, H = shards.n_layers, shards.n_kv_heads
            pool = PagedKVPool(num_slots=PAR["g"]["slots"], num_layers=L, num_kv_heads=H, head_dim=cfg.head_dim,
                               page_size=16, dtype=cfg.dtype, device=dev)
            replica = None
            if rank == 0:
                mcfg = MeshConfig(prefill_nodes=[addrs[0]], decode_nodes=[addrs[1]], router_nodes=[],
                                  local_addr=addrs[0], protocol="tcp", page_size=16, tick_interval_s=0.05,
                                  gc_interval_s=30.0)
                replica = MeshCache(mcfg, pool=pool).start()
                check(replica.wait_ready(timeout=120), "(g) the leader's replica never joined the ring")
            eng = Engine(cfg, shards, num_slots=PAR["g"]["slots"], page_size=16, max_batch=2, device=dev,
                         device_mesh=mesh, pool=pool, mesh=replica, long_prefill_threshold=0)
            mp = rng.integers(0, cfg.vocab_size, PAR["g"]["mesh_prompt"]).tolist()
            key = mp[: len(mp) // 16 * 16]  # what the replicas hold: whole pages
            got = eng.generate([mp], greedy)[0]
            r = {"tokens": got, "bound": eng._mesh_proxy is not None}
            if rank == 0:
                r["proxy"] = type(replica.pool).__name__
                theirs = np.asarray(PAR["g_parent_key"], np.int32)
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline and replica.tree.match_prefix(theirs).length < len(theirs):
                    time.sleep(0.05)
                r["parent_key_replicated"] = int(replica.tree.match_prefix(theirs).length)
            taken = pool.alloc(32)
            if rank == 0:
                replica.pool.free(taken)
            before = pool.free_slots
            eng.has_work()
            eng.step()
            held = eng.tree.evictable_size_ + eng.tree.protected_size_
            r.update(freed=pool.free_slots - before, free_slots=pool.free_slots,
                     balance=pool.free_slots + held + 16 == PAR["g"]["slots"], key=key)
            check(r["bound"] and r["freed"] == 32 and r["balance"],
                  f"(g) pool-bound mesh: {r}")
            out["mesh"] = r
            dist.barrier()
            if replica is not None:
                # The parent's replica looks for the leader's prefix, then
                # says so; the leader's replica stays up until then.
                (out_dir / "par-g-mesh-ready").write_text(json.dumps(key))
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and not (out_dir / "par-g-mesh-done").exists():
                    time.sleep(0.05)
                replica.close()
            dist.barrier()
            del eng, pool
        del shards
        _release(dev)
    out["launches"] = launches
    return out


# phase 19 and phase 18 (h): training and checkpoints

# Sizes of the training legs (a CPU rehearsal shrinks them): Llama-3-8B at
# full width, ``layers`` deep (a depth cut: phase 19 holds the bf16 weights,
# their gradients and AdamW's two moments, ~12 GB at 2 layers), a batch of
# ``batch`` x ``seq`` tokens; phase 19 takes ``steps`` AdamW steps, each leg
# of (h) ``h_steps`` (pp with ``n_micro`` microbatches). ``prompt``: the
# tree snapshot legs' prompt; ``loss_atol`` and ``norm_rtol``: (h) against
# phase 19's step 1 (the JAX multihost test's pin, and the global gradient
# norm).
# Phase 19 (e): the bf16 LM head's output and gradients against float32
# autograd, relative (Frobenius). Rounding the cotangent and each result to
# bf16 once costs about 2^-9 each; a wrong gradient costs about 1.
HEAD_GRAD_RTOL = 1e-2
TRAIN = dict(model="llama3-8b", layers=2, batch=2, seq=513, steps=3, h_steps=2, n_micro=2, prompt=256,
             slots=4096, tiny_batch=(4, 17), loss_atol=5e-3, norm_rtol=0.02, peak_tflops=989.0)


def _train_tokens(cfg) -> torch.Tensor:
    """The training batch of phase 19 and (h): the same on every rank."""
    rng = np.random.default_rng(24)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"])))


def _fingerprint(t) -> list[int]:
    """Two 64-bit sums of a tensor's bit patterns, the plain one and one
    weighted by a fixed pseudo-random draw, computed on its device in slices
    (a bit-level comparison of gigabytes across ranks without moving them)."""
    bits = t.detach().contiguous().reshape(-1)
    bits = bits.view({2: torch.int16, 4: torch.int32}[bits.element_size()])
    g = torch.Generator(device=bits.device).manual_seed(0)
    s1 = s2 = 0
    for i in range(0, bits.numel(), 1 << 26):
        c = bits[i:i + (1 << 26)].long()
        w = torch.randint(1, 1 << 20, c.shape, generator=g, device=bits.device)
        s1 += int(c.sum())
        s2 += int((c * w).sum())
    return [s1, s2]


def _replicated_fingerprints(model) -> dict:
    """The fingerprint of every leaf that no mesh axis of ``model``'s mesh
    shards (the norms; the embedding and head where tp = 1; everything under
    dp or sp)."""
    from radixmesh_tpu_torch.models.llama import param_logical_axes
    from radixmesh_tpu_torch.parallel.sharding import SERVING_RULES, logical_to_spec

    mesh, tree = model.mesh, model.param_tree()
    axes = param_logical_axes(model.cfg, tree)
    out = {}
    for name, t in _leaves(tree):
        ax = axes["layers"][name.split(".", 1)[1]] if name.startswith("layers.") else axes[name]
        if all(a is None or mesh.size(a) == 1 for a in logical_to_spec(ax, SERVING_RULES)):
            out[name] = _fingerprint(t)
    return out


def _train_steps(state, step, tokens, n: int, dev) -> dict:
    """``n`` steps: each step's loss, wall (to a synchronize) and the global
    gradient norm after it; the serving kernels' launches meanwhile."""
    from radixmesh_tpu_torch.parallel.train import global_grad_norm

    pa.reset_counters()
    losses, walls, norms = [], [], []
    for _ in range(n):
        _sync(state.params.embed.device)
        t = time.monotonic()
        state, loss = step(state, tokens)
        losses.append(float(loss))
        walls.append(time.monotonic() - t)
        norms.append(global_grad_norm(state.params))
    counts = pa.launch_counts()
    check(all(math.isfinite(x) for x in losses), f"training: a loss is not finite: {losses}")
    check(sum(counts.values()) == 0, f"training launched serving kernels: {counts}")
    return {"state": state, "losses": losses, "step_walls_s": walls, "grad_norms": norms,
            "kernel_launches": sum(counts.values())}


def _pp_tree_leg(cfg, mesh, dev, path) -> dict:
    """(h)'s twin of ``test_pp_engine_tree_snapshot_restore`` on both ranks: a
    pp engine serves a prompt, the leader writes the snapshot of its
    gathered pool, a fresh engine over the same stage restores it, the
    prompt grown by two tokens is a hit and the prompt replays its first
    continuation."""
    from radixmesh_tpu_torch.checkpoint import load_tree, save_tree

    with torch.inference_mode():
        model = Llama(cfg, init_params(cfg, 0, dev, mesh=mesh), mesh=mesh)
    kw = dict(num_slots=TRAIN["slots"], page_size=16, max_batch=2, device=dev, device_mesh=mesh)
    prompt = np.random.default_rng(26).integers(0, cfg.vocab_size, TRAIN["prompt"]).tolist()
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)
    eng = Engine(cfg, model, **kw)
    out1 = eng.generate([prompt], greedy)[0]
    t = time.monotonic()
    save_tree(str(path), eng.tree, pool=eng.pool, mesh=mesh)
    save_s = time.monotonic() - t
    del eng
    eng2 = Engine(cfg, model, **kw)
    t = time.monotonic()
    restored = load_tree(str(path), eng2.tree, pool=eng2.pool, mesh=mesh)
    load_s = time.monotonic() - t
    c0 = eng2.stats.cached_tokens
    out2 = eng2.generate([prompt + [7, 8]], greedy)[0]
    cached = eng2.stats.cached_tokens - c0
    out3 = eng2.generate([prompt], greedy)[0]
    check(restored > 0 and cached >= TRAIN["prompt"] - 16,
          f"(h) pp tree snapshot: {restored} nodes restored, the grown prompt hit {cached} tokens")
    check(out3 == out1, f"(h) pp tree snapshot: the restored engine's tokens {out3} != {out1}")
    return {"restored": restored, "cached": cached, "tokens": out1, "grown_tokens": out2, "save_s": save_s,
            "load_s": load_s}


H_GATE = "par-h-go"


def _wait_h_gate(out_dir) -> float:
    """Wait for this process to finish the phases it runs beside phase 18
    and return its cached memory (``parallel_phase_finish`` writes
    ``H_GATE``): (h)'s training legs hold ~12 GiB a rank, which beside the
    whole-path checks would take the card past its budget. Returns the
    seconds waited."""
    t = time.monotonic()
    while not (out_dir / H_GATE).exists():
        check(time.monotonic() - t < PAR["timeout_s"], "(h): this process never opened the gate")
        time.sleep(0.1)
    return time.monotonic() - t


def _par_train_leg(rank, meshes: dict, dev, out_dir, mark) -> dict:
    """(h) on the ranks. First what needs little memory: ``load_params(mesh=)``
    of a checkpoint of the whole tree against ``shard_params`` on the tp and
    pp meshes, bit for bit, and the pp engine's tree snapshot. Then, once
    this process has opened the gate (``_wait_h_gate``), two AdamW steps of
    Llama-3-8B's widths on each of the tp, sp, dp and pp meshes (phase 19's
    batch; the pipeline with ``n_micro`` microbatches): losses, gradient
    norms, walls and the replicated leaves' fingerprints (held across the
    ranks and against phase 19 by ``parallel_phase_finish``)."""
    import torch.distributed as dist

    from radixmesh_tpu_torch.checkpoint import load_params, save_params
    from radixmesh_tpu_torch.models.llama import param_logical_axes
    from radixmesh_tpu_torch.parallel import collective_stats, reset_collective_stats, shard_params
    from radixmesh_tpu_torch.parallel.pipeline import make_pp_train_step
    from radixmesh_tpu_torch.parallel.train import adamw, make_train_state, make_train_step

    cfg = get_config(TRAIN["model"], n_layers=TRAIN["layers"])
    tokens = _train_tokens(cfg)
    out = {"legs": {}}
    mark("(h) load_params")
    whole = init_params(cfg, 0, dev)
    path = out_dir / "h-params"
    if rank == 0:
        save_params(str(path), whole)
    dist.barrier()
    axes = param_logical_axes(cfg)
    out["load_params"] = {}
    for tag in ("tp=2", "pp=2"):
        got = dict(_leaves(load_params(str(path), mesh=meshes[tag], device=dev)))
        want = dict(_leaves(shard_params(whole, axes, meshes[tag])))
        check(got.keys() == want.keys() and all(
            got[k].dtype == v.dtype and torch.equal(got[k].view(torch.int16), v.view(torch.int16))
            for k, v in want.items()), f"(h) load_params(mesh={tag}) on rank {rank} != shard_params")
        out["load_params"][tag] = {k: list(v.shape) for k, v in got.items()}
        del got, want
    dist.barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    del whole
    _release(dev)
    mark("(h) pp tree")
    out["pp_tree"] = _pp_tree_leg(cfg, meshes["pp=2"], dev, out_dir / "h-pp-tree.json")
    dist.barrier()
    if rank == 0:
        for f in ("h-pp-tree.json", "h-pp-tree.json.kv.npz"):
            (out_dir / f).unlink(missing_ok=True)
    _release(dev)
    # torch.optim's first optimizer imports torch._dynamo (seconds of host
    # time): paid here, before the gate.
    importlib.import_module("torch._dynamo")

    mark("(h) gate")
    out["gate_wait_s"] = _wait_h_gate(out_dir)
    for tag, mesh in meshes.items():
        mark(f"(h) {tag}")
        t = time.monotonic()
        state = make_train_state(cfg, 0, mesh, adamw, device=dev)
        init_s = time.monotonic() - t
        if mesh.size("pp") > 1:
            step = make_pp_train_step(cfg, mesh, adamw, TRAIN["n_micro"])
        else:
            step = make_train_step(cfg, mesh, adamw)
        reset_collective_stats()
        run = _train_steps(state, step, tokens, TRAIN["h_steps"], dev)
        leg = {k: v for k, v in run.items() if k != "state"}
        leg.update(init_s=init_s, collectives=collective_stats(),
                   replicated=_replicated_fingerprints(run["state"].params))
        out["legs"][tag] = leg
        print(f"[train rank{rank}] (h) {tag}: losses {leg['losses']}, grad norms {leg['grad_norms']}, step walls "
              f"{[round(w, 3) for w in leg['step_walls_s']]} s, {len(leg['replicated'])} replicated leaves",
              flush=True)
        del state, step, run
        _release(dev)
    _release(dev)
    return out


def _h_finish(ranks) -> dict:
    """(h) across the ranks: each leg's losses and gradient norms equal on
    both ranks (every rank reports the global values), the replicated
    leaves' fingerprints equal."""
    legs = ranks[0]["train"]["legs"]
    for r in ranks[1:]:
        for tag, leg in legs.items():
            other = r["train"]["legs"][tag]
            check(other["losses"] == leg["losses"], f"(h) {tag}: ranks' losses differ: {leg['losses']} "
                                                    f"{other['losses']}")
            check(other["replicated"] == leg["replicated"],
                  f"(h) {tag}: replicated leaves differ across ranks: " + str(
                      [k for k in leg["replicated"] if other["replicated"].get(k) != leg["replicated"][k]]))
        check(r["train"]["pp_tree"]["tokens"] == ranks[0]["train"]["pp_tree"]["tokens"],
              "(h) pp tree snapshot: ranks' tokens differ")
    return legs


def parallel_rank(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 18 (b) and (c): every rank runs this same program,
    gloo between them (they share the card). Writes its readings to
    ``out``."""
    from radixmesh_tpu_torch.parallel import (
        MeshPlan,
        collective_stats,
        init_multihost,
        make_mesh,
        reset_collective_stats,
    )
    import torch.distributed as dist

    dev = torch.device(PAR["device"], 0) if PAR["device"] == "cuda" else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    info = init_multihost(f"file://{store}", world, rank, backend="gloo", timeout_s=PAR["collective_timeout_s"])
    tp_mesh = make_mesh(MeshPlan(tp=world))
    sp_mesh = make_mesh(MeshPlan(sp=world))
    pp_mesh = make_mesh(MeshPlan(pp=world))
    dp_mesh = make_mesh(MeshPlan(dp=world))
    cfg = get_config(PAR["model"], n_layers=PAR["layers"])
    prompts, hit = _par_script(cfg, PAR["prompts"])
    res = {"rank": rank, "world": world, "backend": info.backend, "legs": {}, "collectives": {}, "marks": []}
    kw = dict(num_slots=PAR["slots"], page_size=16, max_batch=8, device=dev, device_mesh=tp_mesh)
    keep = {}  # what the references compare with

    def mark(name):
        """Where this rank is from now on (wall clock), for the card's peak."""
        res["marks"].append([name, time.time()])

    def leg(tag, model, mesh=tp_mesh, **extra):
        mark(tag)
        reset_collective_stats()
        eng = Engine(model.cfg, model, **{**kw, "device_mesh": mesh}, **extra)
        r = _par_leg(eng, prompts, hit, dev, PAR["new_tokens"])
        res["collectives"][tag] = collective_stats()
        if tag == "bf16":
            res["pool_path"] = _par_pool_path(eng, hit, dev)
        if "spec" in tag:
            # A replay: served twice, a prompt of 16k + 9 tokens leaves its 7
            # fed generated tokens in whole 16-token pages of the tree, so the
            # second serve drafts them and verifies (through pp_forward_chunk
            # under pp).
            rp = prompts[2][: (len(prompts[2]) - 9) // 16 * 16 + 9]
            greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR["new_tokens"])
            r["replay_tokens"] = [eng.generate([rp], greedy)[0] for _ in range(2)]
            r["replay_verify_launches"] = eng.stats.verify_launches
        keep[tag] = r
        res["legs"][tag] = _par_leg_checks(tag, r, model.cfg, extra.get("kv_quant"), dev, pp=mesh.size("pp"))
        st = r["stats"]
        print(f"[tp rank{rank}] {tag}: decode step {r['decode_step_ms'] or math.nan:.2f} ms, TTFT "
              f"{[round(x, 4) for x in r['ttft_s']]}, hit cached {r['hit_cached']}, launches B1 "
              f"{res['legs'][tag]['b1']} B2 {res['legs'][tag]['b2']}; multi-step "
              f"{st['multi_step_launches']}, verify {st['verify_launches']}, mixed {st['mixed_launches']}",
              flush=True)
        del eng
        _release(dev)

    def shards(c, **kw2):
        with torch.inference_mode():
            return Llama(c, init_params(c, 0, dev, mesh=tp_mesh, **kw2), mesh=tp_mesh)

    mark("init")
    t = time.monotonic()
    model = shards(cfg)
    res["init_tp_s"] = time.monotonic() - t
    leg("bf16", model)
    leg("int8", model, kv_quant="int8")
    leg("bf16 schedules", model, **SCHEDULES)
    del model
    _release(dev)
    t = time.monotonic()
    w8 = shards(cfg, weight_quant="int8")
    res["init_w8_s"] = time.monotonic() - t
    leg("w8a16 int8", w8, kv_quant="int8")
    del w8
    _release(dev)
    # 4 layers in float32: greedy tokens exact against the single device.
    mark("f32 tp")
    cfg32 = cfg.replace(n_layers=PAR["f32_layers"], dtype=torch.float32)
    f32_prompts, _ = _par_script(cfg32, PAR["f32_prompts"], seed=19)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR["new_tokens"])
    m32 = shards(cfg32)
    pa.reset_counters()
    eng = Engine(cfg32, m32, **kw)
    f32_firsts = []
    eng.on_first_logits = lambda req, row: f32_firsts.append(row.float().cpu())
    res["f32_tokens"] = eng.generate(f32_prompts, greedy)
    res["f32_counts"] = pa.launch_counts()
    del eng, m32
    _release(dev)
    # (e) pp = world: each rank one pipeline stage (L/pp layers of the same
    # draw), behind the unchanged Engine.
    t = time.monotonic()
    with torch.inference_mode():
        ppm = Llama(cfg, init_params(cfg, 0, dev, mesh=pp_mesh), mesh=pp_mesh)
    res["init_pp_s"] = time.monotonic() - t
    t = time.monotonic()
    for tag, extra in PP_LEGS.items():
        leg(tag, ppm, mesh=pp_mesh, **extra)
    del ppm
    _release(dev)
    mark("f32 pp")
    with torch.inference_mode():
        m32 = Llama(cfg32, init_params(cfg32, 0, dev, mesh=pp_mesh), mesh=pp_mesh)
    pa.reset_counters()
    eng = Engine(cfg32, m32, **{**kw, "device_mesh": pp_mesh})
    res["pp_f32_tokens"] = eng.generate(f32_prompts, greedy)
    res["pp_f32_counts"] = pa.launch_counts()
    res["pp_wall_s"] = time.monotonic() - t
    del eng, m32
    _release(dev)
    # (c) sp = 2: the whole model on each rank, ring attention between
    # them; then, on the same weights, the single-device references split
    # between the ranks: rank 0 the sp prompt's chunked prefill and the bf16
    # leg, rank 1 the int8 leg and the float32 leg.
    rng = np.random.default_rng(20)
    sp_prompt = rng.integers(0, cfg.vocab_size, PAR["sp_prompt"]).tolist()
    sp_warm = rng.integers(0, cfg.vocab_size, PAR["sp_warm"]).tolist()
    sp_kw = dict(num_slots=PAR["sp_slots"], page_size=16, max_batch=2, device=dev,
                 max_seq_len=PAR["sp_prompt"] + 128)
    mark("(c) sp")
    t = time.monotonic()
    with torch.inference_mode():
        full = Llama(cfg, init_params(cfg, 0, dev))
    res["init_full_s"] = time.monotonic() - t
    reset_collective_stats()
    eng = Engine(cfg, full, device_mesh=sp_mesh, sp_prefill_threshold=PAR["sp_warm"], **sp_kw)
    sp = _par_sp_leg(eng, sp_prompt, sp_warm, dev, PAR["sp_layers"])
    res["collectives"]["sp"] = collective_stats()
    del eng
    _release(dev)
    check(sp["prefill_chunks"] == 0, "sp leg: the prompt took the chunked path, not the sp one")
    mark("(f) ici")
    res["ici"] = _par_ici_leg(rank, dp_mesh, full, prompts[0], dev)
    mark("(g) tiers")
    t = time.monotonic()
    res["tiers"] = _par_tier_leg(rank, {"tp=2": tp_mesh, "pp=2": pp_mesh}, full, dev, pathlib.Path(out).parent)
    res["tiers"]["wall_s"] = time.monotonic() - t
    print(f"[tp rank{rank}] (g) tiers, handoff and pool-bound mesh: {res['tiers']['wall_s']:.1f} s", flush=True)
    res["sp"] = {"ttft_s": sp["ttft_s"], "tokens": sp["tokens"], "kv_abs_sum": float(sp["kv"].double().abs().sum())}
    mark("references")
    refs = {}
    if rank == 0:
        eng = Engine(cfg, full, long_prefill_threshold=0, **sp_kw)  # always the chunked prefill
        want = _par_sp_leg(eng, sp_prompt, sp_warm, dev, PAR["sp_layers"])
        del eng
        _release(dev)
        check(want["prefill_chunks"] > 0, "sp reference: not the chunked prefill")
        kv_err = [((sp["kv"][:, i] - want["kv"][:, i]).norm() / want["kv"][:, i].norm()).item()
                  for i in range(len(PAR["sp_layers"]))]
        refs["sp"] = {"first_row_err": _row_rel_err(sp["first"], want["first"]), "kv_rel_err": kv_err,
                      "single_ttft_s": want["ttft_s"], "single_tokens": want["tokens"]}
        hold = not PAR["witness"]
        check(not hold or refs["sp"]["first_row_err"] <= ROW_RTOL,
              f"sp: last-position logits row error {refs['sp']['first_row_err']} > {ROW_RTOL}")
        check(not hold or max(kv_err) <= ROW_RTOL, f"sp: pool K/V relative error {kv_err} > {ROW_RTOL}")
        del want
    del sp
    tag, extra = ("bf16", {}) if rank == 0 else ("int8", dict(kv_quant="int8"))
    ref_kw = dict(num_slots=PAR["slots"], page_size=16, max_batch=8, device=dev, **extra)
    eng = Engine(cfg, full, **ref_kw)
    single = _par_leg(eng, prompts, hit, dev, PAR["new_tokens"])
    del eng
    _release(dev)
    refs[tag] = _par_logit_checks(tag, keep[tag], single, hold=not PAR["witness"])
    refs["pp " + tag] = _par_logit_checks("pp " + tag, keep["pp " + tag], single, hold=not PAR["witness"])
    if PAR["witness"]:
        refs[tag]["witness"] = _par_witness(full, keep[tag], single, ref_kw, prompts, hit, dev)
    else:
        refs[tag]["tp_vs_split_all"] = _par_split_check(tag, full, keep[tag], ref_kw, prompts, hit, dev)
    del full, single
    _release(dev)
    if rank != 0:
        with torch.inference_mode():
            m32 = Llama(cfg32, init_params(cfg32, 0, dev))
        eng = Engine(cfg32, m32, num_slots=PAR["slots"], page_size=16, max_batch=8, device=dev)
        want_firsts = []
        eng.on_first_logits = lambda req, row: want_firsts.append(row.float().cpu())
        want32 = eng.generate(f32_prompts, greedy)
        refs["f32"] = {"single_tokens": want32, "first_token_row_err": max(
            _row_rel_err(a, b) for a, b in zip(f32_firsts, want_firsts, strict=True))}
        check(res["f32_tokens"] == want32, f"f32 tp tokens {res['f32_tokens']} != single-device {want32}")
        check(res["pp_f32_tokens"] == want32, f"f32 pp tokens {res['pp_f32_tokens']} != single-device {want32}")
        del eng, m32
    _release(dev)
    # (h) training and checkpoints, with (a)-(g) freed.
    t = time.monotonic()
    res["train"] = _par_train_leg(rank, {"tp=2": tp_mesh, "sp=2": sp_mesh, "dp=2": dp_mesh, "pp=2": pp_mesh}, dev,
                                  pathlib.Path(out).parent, mark)
    mark("done")
    res["train"]["wall_s"] = time.monotonic() - t
    print(f"[train rank{rank}] (h) training and checkpoints: {res['train']['wall_s']:.1f} s", flush=True)
    if dev.type == "cuda":
        res["max_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    res["refs"] = refs
    dist.barrier()
    pathlib.Path(out).write_text(json.dumps(res, default=str))
    dist.destroy_process_group()
    return 0


def parallel_nccl(store: str, out: str) -> int:
    """(d) The nccl backend at world size 1 (the one NCCL group a single card
    allows): ``init_multihost``, one all-reduce, one greedy generate on the
    mesh, equal to the same engine without it."""
    import torch.distributed as dist

    from radixmesh_tpu_torch.parallel import MeshPlan, init_multihost, make_mesh

    info = init_multihost(f"file://{store}", 1, 0, backend="nccl", timeout_s=300)
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    check(torch.equal(x.cpu(), torch.arange(4, dtype=torch.float32)), f"nccl all_reduce gave {x}")
    mesh = make_mesh(MeshPlan())
    check(mesh.backend == "nccl", f"mesh backend {mesh.backend}")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(PAR["model"]).replace(n_layers=PAR["nccl_layers"])
    with torch.inference_mode():
        model = Llama(cfg, init_params(cfg, 0, dev))
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, PAR["nccl_prompt"]).tolist()
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)
    got = Engine(cfg, model, num_slots=4096, device=dev, device_mesh=mesh).generate([prompt], greedy)
    want = Engine(cfg, model, num_slots=4096, device=dev).generate([prompt], greedy)
    check(got == want, f"nccl mesh engine tokens {got} != {want}")
    pathlib.Path(out).write_text(json.dumps({"backend": info.backend, "world": info.process_count,
                                             "tokens": got[0]}))
    dist.destroy_process_group()
    return 0


def _g_parent_replica(out_dir) -> dict:
    """(g)'s second replica, in this process: a model-less ``MeshCache`` on
    the native tcp transport, in a ring with the leader rank's pool-bound
    replica. A thread waits for the ring, inserts this replica's key (which
    the leader must see), then looks for the leader's served prefix and
    writes ``par-g-mesh-done``."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig

    addrs = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    key = np.random.default_rng(23).integers(0, 128000, 160).tolist()
    PAR.update(g_addrs=addrs, g_parent_key=key)
    for name in ("par-g-mesh-ready", "par-g-mesh-done", H_GATE):
        (out_dir / name).unlink(missing_ok=True)
    cfg = MeshConfig(prefill_nodes=[addrs[0]], decode_nodes=[addrs[1]], router_nodes=[], local_addr=addrs[1],
                     protocol="tcp", page_size=16, tick_interval_s=0.05, gc_interval_s=30.0)
    replica = MeshCache(cfg, pool=None).start()
    g = {"replica": replica, "seen": None, "stop": threading.Event()}

    def watch():
        if not replica.wait_ready(timeout=PAR["timeout_s"]):
            return
        replica.insert(np.asarray(key, np.int32), np.arange(len(key), dtype=np.int32))
        ready = out_dir / "par-g-mesh-ready"
        while not g["stop"].is_set() and not ready.exists():
            time.sleep(0.05)
        if g["stop"].is_set():
            return
        theirs = np.asarray(json.loads(ready.read_text()), np.int32)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and replica.tree.match_prefix(theirs).length < len(theirs):
            time.sleep(0.05)
        g["seen"], g["want"] = int(replica.tree.match_prefix(theirs).length), len(theirs)
        (out_dir / "par-g-mesh-done").write_text(str(g["seen"]))

    g["thread"] = threading.Thread(target=watch, name="g-replica", daemon=True)
    g["thread"].start()
    return g


def parallel_phase_start(out_dir=None, fleet=False) -> dict:
    """Start phase 18's processes: the ``PAR["world"]`` ranks of (b) and (c)
    and the nccl process of (d), each this script with its role's flags and
    a log of its own, and (g)'s replica in this process; with ``fleet``,
    also phase 21's two processes, (i) and (j)'s and (k)-(m)'s, joined with
    them."""
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(exist_ok=True)
    g_mesh = _g_parent_replica(out_dir)
    store_dir = tempfile.mkdtemp(prefix="par-store-", dir=out_dir)
    procs, logs = {}, {}
    world = PAR["world"]
    roles = [(f"rank{r}", ["--parallel-rank", str(r), "--parallel-world", str(world)]) for r in range(world)]
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    if PAR["device"] == "cuda":
        roles.append(("nccl", ["--parallel-nccl"]))
    for name, args in roles:
        store = os.path.join(store_dir, "nccl" if name == "nccl" else "tp")
        logs[name] = out_dir / f"par-{name}.log"
        with open(logs[name], "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), *args, "--parallel-store", store,
                 "--parallel-out", str(out_dir / f"par-{name}.json"), "--parallel-sizes", json.dumps(PAR),
                 "--train-sizes", json.dumps(TRAIN)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    if fleet:
        procs["fleet"], logs["fleet"] = _start_fleet_child(out_dir)
        procs["fleet-engines"], logs["fleet-engines"] = _start_phase21_child(
            out_dir, "--fleet-engines", FLEET_ENGINES_JSON.removesuffix(".json"))
    return {"procs": procs, "logs": logs, "out_dir": out_dir, "store_dir": store_dir, "g_mesh": g_mesh,
            "t0": time.monotonic(), "marks": [["start", time.time()]],
            "memory": _card_memory_sampler() if PAR["device"] == "cuda" else None}


def _card_memory_sampler(period_s: float = 0.25) -> dict:
    """The card's memory in use (every process's: ``cudaMemGetInfo``),
    sampled on a thread of its own until ``stop`` is set; ``peak`` in bytes,
    ``peak_t`` its wall-clock time."""
    mem = {"peak": 0, "peak_t": None, "total": 0, "samples": 0, "stop": threading.Event()}

    def run():
        while not mem["stop"].wait(period_s):
            free, total = torch.cuda.mem_get_info()
            if total - free > mem["peak"]:
                mem["peak"], mem["peak_t"] = total - free, time.time()
            mem["total"] = total
            mem["samples"] += 1

    mem["thread"] = threading.Thread(target=run, name="par-memory", daemon=True)
    mem["thread"].start()
    return mem


def parallel_phase_stop(handle) -> None:
    """Kill and join every process of phase 18 still running and stop the
    memory sampler (idempotent: ``parallel_phase_finish`` and a phase that
    raises beside the ranks both end here)."""
    for p in handle["procs"].values():
        if p.poll() is None:
            p.kill()
        p.wait()
    if handle["memory"] is not None:
        handle["memory"]["stop"].set()
        handle["memory"]["thread"].join()
    g = handle["g_mesh"]
    g["stop"].set()
    g["thread"].join(timeout=60)
    if not g.get("closed"):
        g["closed"] = True
        g["replica"].close()
    shutil.rmtree(handle["store_dir"], ignore_errors=True)


def _g_finish(ranks, out_dir, g_mesh) -> dict:
    """(g) across ranks: the tier counters and tokens equal on every rank,
    the leader's packet slices equal to each rank's own shard, each mesh's
    packet decoded here by a single-device engine (its first decode row
    against the single device's own prefill and decode of the prompt), the
    pool-bound replica's allocators equal on every rank and the two
    replicas' prefixes replicated both ways."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker, unpack_handoff

    g0 = ranks[0]["tiers"]
    for r in ranks[1:]:
        g = r["tiers"]
        for tag, run in g0["runs"].items():
            other = g["runs"][tag]
            for k in ("tokens", "hicache", "disk", "cached"):
                check(other.get(k) == run.get(k), f"(g) {tag}: rank {r['rank']}'s {k} {other.get(k)} != rank 0's "
                      f"{run.get(k)}")
        check(g["mesh"]["free_slots"] == g0["mesh"]["free_slots"], "(g) pool-bound mesh: free slots differ")
        check(g["handoff"]["single -> tp=2"]["tokens"] == g0["handoff"]["single -> tp=2"]["tokens"],
              "(g) tp=2 DecodeWorker: ranks' tokens differ")
    for mtag in ("tp=2", "pp=2"):
        lead = g0["handoff"][mtag]["slice_digests"]
        for i, r in enumerate(ranks):
            check(lead[str(i)] == r["tiers"]["handoff"][mtag]["own_digest"],
                  f"(g) {mtag} packet: the leader's slice of engine rank {i} differs from that rank's pool")
        if PAR["device"] == "cuda":
            for qtag in ("", "[int8]"):
                for k in ("paged_decode_fused_kernel", "paged_chunk_attention_kernel"):
                    n = [r["tiers"]["launches"][mtag][k + qtag] for r in ranks]
                    check(all(x > 0 for x in n), f"(g) {mtag}: {k}{qtag} launches per rank {n}")
    check(g0["mesh"]["proxy"] == "MeshPoolProxy", f"(g) the leader's replica sees {g0['mesh']['proxy']}")
    check(g0["mesh"]["parent_key_replicated"] == len(PAR["g_parent_key"]),
          f"(g) the parent's key reached the leader's replica as {g0['mesh']['parent_key_replicated']} tokens")
    check(g_mesh["seen"] is not None and g_mesh["seen"] == g_mesh["want"],
          f"(g) the leader's prefix reached this process's replica as {g_mesh['seen']} tokens")
    # Each mesh's packet, decoded here on one device.
    dev = torch.device("cuda", 0) if PAR["device"] == "cuda" else torch.device("cpu")
    cfg = get_config(PAR["model"], n_layers=PAR["layers"])
    with torch.inference_mode():
        model = Llama(cfg, init_params(cfg, 0, dev))
    greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR["g"]["new_tokens"])
    kw = dict(num_slots=PAR["g"]["ref_slots"], page_size=16, max_batch=2, device=dev)
    prompt = g0["handoff"]["tp=2"]["prompt"]
    ref = Engine(cfg, model, **kw)
    want = _first_decode_row(ref)
    want_tokens = ref.generate([prompt], greedy)[0]
    out = {}
    for mtag in ("tp=2", "pp=2"):
        data = (out_dir / f"par-g-packet-{mtag.replace('=', '')}.bin").read_bytes()
        dw = DecodeWorker(Engine(cfg, model, **kw))
        row = _first_decode_row(dw.engine)
        pkt = unpack_handoff(data, pin_memory=dev.type == "cuda")
        check(pkt.prompt.tolist() == prompt and tuple(pkt.kv.shape)[1] == cfg.n_layers
              and pkt.kv.shape[3] == cfg.n_kv_heads, f"(g) {mtag} packet: shape {tuple(pkt.kv.shape)}")
        req = dw.submit(pkt)
        dw.run_until_drained()
        same = bool(torch.equal(row["tokens"][:1], want["tokens"][:1]))
        err = _row_rel_err(row["logits"][0], want["logits"][0]) if same else None
        check(PAR["witness"] or err is None or err <= ROW_RTOL,
              f"(g) {mtag} packet decoded here: first decode row err {err}")
        out[mtag] = {"tokens": req.generated, "single_tokens": want_tokens, "first_row_err": err,
                     "bytes": len(data)}
        del dw
    del ref, model
    _release(dev)
    return out


def parallel_phase_finish(handle, beside=None) -> dict:
    """Join every process of phase 18, check each exit code and the checks
    across ranks, and print the readings. ``beside`` (a callable), if
    given, runs in this process once (h)'s gate is open, while the ranks
    train; what it returns is the result's ``beside``."""
    procs, logs, out_dir = handle["procs"], handle["logs"], handle["out_dir"]
    (out_dir / H_GATE).touch()  # (h)'s training legs may start
    beside_out = None
    if beside is not None:
        handle["marks"].append(["beside (h)", time.time()])
        beside_out = beside()
        handle["marks"].append(["waiting for the ranks", time.time()])
    deadline = handle["t0"] + PAR["timeout_s"]
    rcs = {}
    try:
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rcs[name] = None
    finally:
        parallel_phase_stop(handle)
    wall = time.monotonic() - handle["t0"]
    for name, rc in rcs.items():
        if rc != 0:
            tail = logs[name].read_text()[-4000:]
            phase = {"fleet": "phase 21 (i), (j)", "fleet-engines": "phase 21 (k)-(m)"}.get(name,
                                                                                           f"phase 18 {name}")
            check(False, f"{phase} {'timed out' if rc is None else f'exited {rc}'}:\n{tail}")
    fleet = ({**_fleet_child_report(out_dir), **_fleet_engine_report(out_dir, logs["fleet-engines"])}
             if "fleet" in procs else None)
    ranks = [json.loads((out_dir / f"par-rank{r}.json").read_text()) for r in range(PAR["world"])]
    nccl = (json.loads((out_dir / "par-nccl.json").read_text()) if "nccl" in procs
            else {"backend": "nccl", "world": 1, "tokens": None})
    r0 = ranks[0]
    for r in ranks[1:]:
        check(list(r["legs"]) == list(r0["legs"]), "the ranks ran different legs")
        for tag in r0["legs"]:
            check(r["legs"][tag]["tokens"] == r0["legs"][tag]["tokens"]
                  and r["legs"][tag]["hit_tokens"] == r0["legs"][tag]["hit_tokens"],
                  f"tp {tag}: rank {r['rank']}'s tokens differ from rank 0's")
            check(r["legs"][tag]["stats"] == r0["legs"][tag]["stats"], f"tp {tag}: ranks' stats differ")
        check(r["f32_tokens"] == r0["f32_tokens"], "f32 tp: ranks' tokens differ")
        check(r["pp_f32_tokens"] == r0["pp_f32_tokens"], "f32 pp: ranks' tokens differ")
        check(r["legs"]["pp spec"]["replay_tokens"] == r0["legs"]["pp spec"]["replay_tokens"],
              "pp spec: ranks' replay tokens differ")
        check(r["sp"]["tokens"] == r0["sp"]["tokens"], "sp: ranks' tokens differ")
    for tag in ("bf16", "int8"):
        src, dst = ranks[0]["ici"][tag], ranks[1]["ici"][tag]
        check(src["kv_digest"] == dst["kv_digest"] and src["scale_digest"] == dst["scale_digest"],
              f"ici {tag}: the moved block differs from the source's")
        check(r["sp"]["kv_abs_sum"] == r0["sp"]["kv_abs_sum"], "sp: the ranks' pools hold different K/V")
    check(nccl["backend"] == "nccl" and nccl["world"] == 1, f"nccl process: {nccl}")
    refs = {**ranks[0]["refs"], **ranks[1]["refs"]}
    h_legs = _h_finish(ranks)
    t_g = time.monotonic()
    g_here = _g_finish(ranks, out_dir, handle["g_mesh"])
    g_here_s = time.monotonic() - t_g
    print(f"[parallel] backend {r0['backend']}, {len(ranks)} ranks on one card; phase wall {wall:.1f}s; "
          f"weights per rank: tp shards {r0['init_tp_s']:.1f}s, W8A16 shards {r0['init_w8_s']:.1f}s, "
          f"whole model {r0['init_full_s']:.1f}s", flush=True)
    for r in ranks:
        print(f"[parallel] rank {r['rank']} kernel launches: "
              + "; ".join(f"{tag} B1 {r['legs'][tag]['b1']} B2 {r['legs'][tag]['b2']}" for tag in r["legs"])
              + f"; pool path B3 {r['pool_path']['launches']}; f32 {PAR['f32_layers']}-layer B1 "
              f"{r['f32_counts']['paged_decode_fused_kernel']} B2 f32 body "
              f"{r['f32_counts']['paged_chunk_attention_kernel[f32 body]']}", flush=True)
    depth = f"{PAR['model']} widths, {PAR['layers']} layers"
    for tag in ("bf16", "int8"):
        leg, ref = r0["legs"][tag], refs[tag]
        print(f"[parallel] tp=2 {tag} vs single device ({depth}): first-token row err "
              f"{ref['first_token_row_err']:.3e}, first decode step row err {ref['decode0_row_err']:.3e} over "
              f"{ref['decode0_rows']} of {ref['decode0_rows_all']} rows; decode step {leg['decode_step_ms']:.2f} ms "
              f"vs {ref['single_decode_step_ms']:.2f} ms; TTFT {[round(x, 4) for x in leg['ttft_s']]} vs "
              f"{[round(x, 4) for x in ref['single_ttft_s']]}; hit TTFT {leg['hit_ttft_s']:.4f} vs "
              f"{ref['single_hit_ttft_s']:.4f} s; first differing token per request (None: equal) "
              f"{ref['first_diff_vs_single']}", flush=True)
    for tag in ("bf16", "int8"):
        leg, ref = r0["legs"]["pp " + tag], refs["pp " + tag]
        print(f"[parallel] pp=2 {tag} vs single device ({depth}, {PAR['layers'] // 2} layers a stage): first-token "
              f"row err {ref['first_token_row_err']:.3e} (per row {[f'{e:.2e}' for e in ref['first_token_row_errs']]})"
              f", first decode step row err {ref['decode0_row_err']:.3e} over {ref['decode0_rows']} of "
              f"{ref['decode0_rows_all']} rows; decode step {leg['decode_step_ms']:.2f} ms vs "
              f"{ref['single_decode_step_ms']:.2f} ms; TTFT {[round(x, 4) for x in leg['ttft_s']]} vs "
              f"{[round(x, 4) for x in ref['single_ttft_s']]}; hit TTFT {leg['hit_ttft_s']:.4f} vs "
              f"{ref['single_hit_ttft_s']:.4f} s; first differing token per request {ref['first_diff_vs_single']}",
              flush=True)
    for tag in PP_LEGS:
        leg = r0["legs"][tag]
        print(f"[parallel] {tag}: decode step {leg['decode_step_ms'] or math.nan:.2f} ms, group wall "
              f"{leg['group_wall_s']:.3f} s, launches per rank B1 {[r['legs'][tag]['b1'] for r in ranks]} B2 "
              f"{[r['legs'][tag]['b2'] for r in ranks]}, stats {leg['stats']}", flush=True)
    print(f"[parallel] pp=2 weights per rank {r0['init_pp_s']:.1f}s; (e) wall {r0['pp_wall_s']:.1f}s; f32 "
          f"{PAR['f32_layers']}-layer pp=2 tokens == single device: {r0['pp_f32_tokens']}", flush=True)
    for tag in ("bf16", "int8"):
        src, dst = ranks[0]["ici"][tag], ranks[1]["ici"][tag]
        gbps = dst["kv_bytes"] / dst["move_wall_s"] / 1e9
        print(f"[parallel] ici {tag}: rank 0 -> 1 over gloo (host bounce, not a device-to-device rate): "
              f"{dst['kv_bytes'] / 2**20:.2f} MiB KV in {dst['move_wall_s'] * 1e3:.2f} ms ({gbps:.3f} GB/s; p2p "
              f"{dst['p2p']['calls']} call(s) {dst['p2p']['seconds'] * 1e3:.2f} ms {dst['p2p']['bytes']} B); block "
              f"bit-equal; decode tokens == collocated {dst['tokens']}", flush=True)
    print(f"[parallel] f32 {PAR['f32_layers']}-layer tp=2 tokens == single device: {r0['f32_tokens']}; "
          f"first-token row err (rank 1) {refs['f32']['first_token_row_err']:.3e}", flush=True)
    for tag in ("bf16", "int8"):
        e = refs[tag].get("tp_vs_split_all")
        if e is not None:
            print(f"[parallel] tp=2 {tag} vs a single device with every product split as tp splits it "
                  f"({depth}): first-token row err {e['first_token_row_err']:.3e}, first decode step row err "
                  f"{e['decode0_row_err']:.3e} over {e['decode0_rows']} rows (held to 0), tokens equal", flush=True)
        w = refs[tag].get("witness")
        if w is not None:
            print(f"[parallel] witness {tag} ({depth}), first-token / first decode step row err: " + "; ".join(
                f"{k} {v['first_token_row_err']:.3e} / {v['decode0_row_err']:.3e} ({v['decode0_rows']} rows)"
                for k, v in w.items()), flush=True)
    mem = handle["memory"]
    if mem is not None:
        print(f"[parallel] card memory in use while phase 18 ran (every process, {mem['samples']} samples "
              f"0.25 s apart): peak {mem['peak'] / 2**30:.2f} of {mem['total'] / 2**30:.2f} GiB; each rank's "
              f"own peak reserved {[round(r.get('max_reserved_gib', 0.0), 2) for r in ranks]} GiB", flush=True)
        if mem["peak_t"] is not None:
            def at(marks):
                return ([n for n, t in marks if t <= mem["peak_t"]] or ["-"])[-1]

            print(f"[parallel] the peak came {mem['peak_t'] - handle['marks'][0][1]:.1f} s into phase 18, with this "
                  f"process in {at(handle['marks'])!r} and the ranks in {[at(r['marks']) for r in ranks]}",
                  flush=True)
    sp = refs["sp"]
    print(f"[parallel] sp=2 prefill of {PAR['sp_prompt']} tokens ({depth}): TTFT {r0['sp']['ttft_s']:.3f} s vs the "
          f"single-device chunked prefill {sp['single_ttft_s']:.3f} s; last-position logits row err "
          f"{sp['first_row_err']:.3e}; pool K/V rel err at layers {list(PAR['sp_layers'])}: "
          f"{[f'{e:.2e}' for e in sp['kv_rel_err']]}", flush=True)
    for tag, c in r0["collectives"].items():
        print(f"[parallel] rank 0 gloo collectives, {tag}: " + ", ".join(
            f"{op} {v['calls']} calls {v['seconds']:.3f}s {v['bytes'] / 2**20:.1f} MiB" for op, v in c.items()),
            flush=True)
    print(f"[parallel] nccl at world size 1: all_reduce ok, greedy generate {nccl['tokens']}", flush=True)
    for r in ranks:
        g = r["tiers"]
        for tag, run in g["runs"].items():
            a = run.get("agree")
            rates = ", ".join(f"{k.split('_')[0]} {run[k]:.2f} GB/s" for k in ("restore_gbps", "writeback_gbps",
                                                                               "spill_gbps") if run.get(k))
            print(f"[parallel] (g) rank {r['rank']} {tag}: wall {run['wall_s']:.3f} s (no tiers "
                  f"{run['base_wall_s']:.3f} s), cached {run['cached']}, hicache {run['hicache']}"
                  + (f", disk {run['disk']}" if run.get("disk") else "") + (f"; {rates}" if rates else "")
                  + (f"; agreement {a['calls']} calls over {a['passes']} passes ({a['calls'] / max(1, a['passes']):.2f}"
                     f" a pass), {a['seconds'] * 1e3:.2f} ms, {a['broadcasts']} broadcasts" if a else ""),
                  flush=True)
        for mtag in ("tp=2", "pp=2"):
            h = g["handoff"][mtag]
            print(f"[parallel] (g) rank {r['rank']} {mtag} PrefillWorker: gather {h['gather_s'] * 1e3:.2f} ms, "
                  f"{h['gather_bytes'] / 2**20:.2f} MiB gathered; handoff wall {h['wall_s'] * 1e3:.1f} ms"
                  + (f"; packet KV {h['kv_bytes'] / 2**20:.2f} MiB" if "kv_bytes" in h else ""), flush=True)
        d = g["handoff"]["single -> tp=2"]
        print(f"[parallel] (g) rank {r['rank']} single-device packet -> tp=2 DecodeWorker: tokens {d['tokens']}"
              + (f" (single device {d['single_tokens']}, first decode row err {d['first_row_err']})"
                 if "single_tokens" in d else "") + f", wall {d['wall_s'] * 1e3:.1f} ms", flush=True)
        m = g["mesh"]
        print(f"[parallel] (g) rank {r['rank']} pool-bound mesh replica (native tcp): tokens {m['tokens']}, "
              f"proxy free applied {m['freed']} slots, free {m['free_slots']}, balance {m['balance']}", flush=True)
        print(f"[parallel] (g) rank {r['rank']} leg wall {g['wall_s']:.1f} s; launches {g['launches']}", flush=True)
    for mtag, d in g_here.items():
        print(f"[parallel] (g) {mtag} packet ({d['bytes'] / 2**20:.2f} MiB) decoded by a single-device engine here: "
              f"{d['tokens']} (its own prefill and decode {d['single_tokens']}), first decode row err "
              f"{d['first_row_err']}", flush=True)
    print(f"[parallel] (g) this process's replica saw the leader's prefix ({handle['g_mesh']['seen']} tokens); "
          f"the single-device decodes here {g_here_s:.1f} s", flush=True)
    for tag, leg in h_legs.items():
        c = ", ".join(f"{op} {v['calls']} calls {v['seconds']:.3f}s {v['bytes'] / 2**20:.1f} MiB"
                      for op, v in leg["collectives"].items())
        print(f"[parallel] (h) {tag} ({TRAIN['h_steps']} AdamW steps, {TRAIN['model']} widths, {TRAIN['layers']} "
              f"layers, {TRAIN['batch']} x {TRAIN['seq']} tokens): losses {leg['losses']}, global grad norms "
              f"{leg['grad_norms']}, step walls {[round(w, 3) for w in leg['step_walls_s']]} s (rank 0), init "
              f"{leg['init_s']:.1f}s; {len(leg['replicated'])} replicated leaves equal on both ranks; rank 0 "
              f"gloo: {c}", flush=True)
    pt = r0["train"]["pp_tree"]
    print(f"[parallel] (h) load_params(mesh=) == shard_params on tp=2 and pp=2, both ranks; pp engine tree snapshot: "
          f"{pt['restored']} nodes restored on both ranks, grown prompt hit {pt['cached']} tokens, tokens equal; "
          f"save {pt['save_s'] * 1e3:.1f} ms, load {pt['load_s'] * 1e3:.1f} ms; (h) wall "
          f"{[round(r['train']['wall_s'], 1) for r in ranks]} s, of which waiting at the gate "
          f"{[round(r['train']['gate_wait_s'], 1) for r in ranks]} s", flush=True)
    return {"ranks": ranks, "refs": refs, "nccl": nccl, "wall_s": wall, "g_here": g_here,
            "card_memory_peak_gib": None if mem is None else mem["peak"] / 2**30, "beside": beside_out,
            "fleet": fleet}


def tree_checkpoint_leg(dev, model) -> dict:
    """Phase 19 (c), on the serving model phase 3 holds: an engine serves a
    prompt, ``save_tree`` writes its tree and pool, a second engine over the
    same weights restores them; the prompt is then a hit of at least
    ``prompt - 16`` tokens and its greedy continuation is the first
    engine's."""
    from radixmesh_tpu_torch.checkpoint import load_tree, save_tree

    cfg = model.cfg
    prompt = np.random.default_rng(27).integers(0, cfg.vocab_size, TRAIN["prompt"]).tolist()
    greedy = SamplingParams(temperature=0.0, max_new_tokens=16)
    kw = dict(num_slots=TRAIN["slots"], page_size=16, max_batch=2, device=dev)
    path = OUT_DIR / "tree-ckpt.json"
    eng = Engine(cfg, model, **kw)
    out1 = eng.generate([prompt], greedy)[0]
    t = time.monotonic()
    save_tree(str(path), eng.tree, pool=eng.pool)
    save_s = time.monotonic() - t
    nbytes = os.path.getsize(path) + os.path.getsize(str(path) + ".kv.npz")
    del eng
    _release(dev)
    eng2 = Engine(cfg, model, **kw)
    try:
        t = time.monotonic()
        restored = load_tree(str(path), eng2.tree, pool=eng2.pool)
        _sync(dev)
        load_s = time.monotonic() - t
    finally:
        for f in (path, pathlib.Path(str(path) + ".kv.npz")):
            f.unlink(missing_ok=True)
    c0 = eng2.stats.cached_tokens
    out2 = eng2.generate([prompt], greedy)[0]
    cached = eng2.stats.cached_tokens - c0
    del eng2
    _release(dev)
    check(cached >= TRAIN["prompt"] - 16, f"tree checkpoint: the restored prefix hit {cached} tokens")
    check(out2 == out1, f"tree checkpoint: restored engine's tokens {out2} != {out1}")
    print(f"[train] (c) save_tree/load_tree, {cfg.n_layers}-layer serving model, a {len(prompt)}-token prompt: "
          f"{restored} nodes, {nbytes} B written in {save_s:.3f}s, restored in {load_s:.3f}s; hit {cached} tokens, "
          f"greedy continuation equal {out2}", flush=True)
    return {"restored": restored, "bytes": nbytes, "save_s": save_s, "load_s": load_s, "cached": cached,
            "tokens": out2}


def _head_grad_check(model, n_tok: int, dev) -> dict:
    """Phase 19 (e): the LM head's bf16 product under autograd
    (``_head_product`` through ``_MmF32``, a float32 output of bf16
    operands) at the training step's head shapes, ``x [n_tok, hidden]``
    against the trained head ``w [hidden, vocab]``, under a seeded float32
    cotangent: the output and both gradients against autograd of the same
    product of the operands widened to float32. The backward rounds the
    cotangent to bf16 once, and each gradient once: each relative error
    (Frobenius) must be at most ``HEAD_GRAD_RTOL``, which a zeroed, scaled
    or misplaced gradient exceeds by far."""
    from radixmesh_tpu_torch.models.llama import _head_product

    gen = torch.Generator(device=dev).manual_seed(26)
    w = model.lm_head.detach().requires_grad_(True)
    x = torch.randn(n_tok, w.shape[0], generator=gen, device=dev, dtype=torch.float32)
    x = x.to(w.dtype).requires_grad_(True)
    g = torch.randn(n_tok, w.shape[1], generator=gen, device=dev, dtype=torch.float32)
    out = _head_product(x, w)
    nodes, seen = [out.grad_fn], []
    for _ in range(3):  # the product's node, under at most two views
        seen += [type(n).__name__ for n in nodes if n is not None]
        nodes = [f for n in nodes if n is not None for f, _ in n.next_functions]
    check(out.dtype == torch.float32 and any("MmF32" in n for n in seen),
          f"(e) the bf16 head product under autograd did not go through _MmF32: {seen}")
    out.backward(g)
    xf = x.detach().float().requires_grad_(True)
    wf = w.detach().float().requires_grad_(True)
    ref = torch.matmul(xf, wf)
    ref.backward(g)

    def rel(a, b):
        return float((a.float() - b).norm() / b.norm())

    errs = {"out": rel(out.detach(), ref.detach()), "gx": rel(x.grad, xf.grad), "gw": rel(w.grad, wf.grad)}
    del out, ref, g, xf, wf, x, w
    _release(dev)
    check(all(e <= HEAD_GRAD_RTOL for e in errs.values()),
          f"(e) the bf16 LM head's product or gradients vs float32 autograd: relative errors {errs} "
          f"(> {HEAD_GRAD_RTOL})")
    print(f"[train] (e) _MmF32 (bf16 LM head under autograd) at x [{n_tok}, {model.cfg.hidden}], w "
          f"[{model.cfg.hidden}, {model.cfg.vocab_size}] vs autograd of the float32 product: relative errors "
          f"(Frobenius) out {errs['out']:.3e}, gx {errs['gx']:.3e}, gw {errs['gw']:.3e} (<= {HEAD_GRAD_RTOL})",
          flush=True)
    return errs


def train_phase(dev, par, tree_leg) -> dict:
    """Phase 19, in this process after phase 18 released its memory: (a)
    ``TRAIN["steps"]`` AdamW steps of Llama-3-8B's widths at ``layers`` deep
    on one device: finite losses, the last below the first, no serving
    kernel launched (training attends with the plain attention); step wall,
    tokens/s, the card's peak memory and an analytic MFU printed; phase 18
    (h)'s first losses within ``loss_atol`` and gradient norms within
    ``norm_rtol`` of this step 1's. (b) ``tiny()`` in float32, one SGD step
    on the card equal to the same step on the CPU within 1e-5 (the loss and
    every updated leaf). (d) ``save_params`` / ``load_params`` of the
    trained tree, bit-equal, write and read GB/s. ``tree_leg``: (c), run
    while phase 3's model was held (``tree_checkpoint_leg``)."""
    from radixmesh_tpu_torch.checkpoint import load_params, save_params
    from radixmesh_tpu_torch.models.llama import ModelConfig
    from radixmesh_tpu_torch.parallel.train import adamw, make_train_state, make_train_step

    cfg = get_config(TRAIN["model"], n_layers=TRAIN["layers"])
    tokens = _train_tokens(cfg)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.monotonic()
    state = make_train_state(cfg, 0, None, adamw, device=dev)
    _sync(dev)
    init_s = time.monotonic() - t
    n_params = sum(p.numel() for p in state.params.parameters())
    run = _train_steps(state, make_train_step(cfg, None, adamw), tokens, TRAIN["steps"], dev)
    state = run.pop("state")
    losses, walls = run["losses"], run["step_walls_s"]
    check(losses[-1] < losses[0], f"training: step {len(losses)}'s loss {losses[-1]} is not below step 1's "
                                  f"{losses[0]}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    wall = float(np.median(walls[1:]))
    n_tok = TRAIN["batch"] * (TRAIN["seq"] - 1)
    # The analytic MFU counts the params that take part in a product: the
    # input embedding is a lookup, the head (a tied head once) a product.
    model = state.params
    n_embed = model.embed.numel() if model.lm_head is not None else 0
    n_mm = n_params - n_embed
    flops = 6 * n_mm * n_tok
    mfu = flops / wall / (TRAIN["peak_tflops"] * 1e12)
    print(f"[train] (a) {TRAIN['model']} widths, {TRAIN['layers']} layers, bf16, {n_params} params, "
          f"{TRAIN['batch']} x {TRAIN['seq']} tokens, AdamW: losses {losses}; step walls "
          f"{[round(w, 4) for w in walls]} s (median of steps 2-{len(walls)} {wall:.4f} s), {n_tok / wall:.0f} "
          f"tokens/s; analytic MFU 6 * (params - input embedding) * tokens / wall / {TRAIN['peak_tflops']:.0f} "
          f"TFLOP/s = 6 * ({n_params} - {n_embed}) * {n_tok} / {wall:.4f} / {TRAIN['peak_tflops']:.0f}e12 = "
          f"{mfu:.4f} (attention's S^2 products not counted); card peak "
          f"{peak / 2**30:.2f} GiB; init {init_s:.1f}s; B1/B2/B3 launches during the steps: "
          f"{run['kernel_launches']}; global grad norm after step 1 {run['grad_norms'][0]:.6g}", flush=True)
    head_grad = _head_grad_check(model, n_tok, dev) if dev.type == "cuda" else None
    del model
    h = {}
    for r in par["ranks"]:
        for tag, leg in r["train"]["legs"].items():
            dl = abs(leg["losses"][0] - losses[0])
            dn = abs(leg["grad_norms"][0] - run["grad_norms"][0]) / run["grad_norms"][0]
            h[tag] = {"loss_diff": dl, "norm_rel_diff": dn}
            check(dl <= TRAIN["loss_atol"], f"(h) {tag} rank {r['rank']}: step 1 loss {leg['losses'][0]} vs one "
                                            f"device {losses[0]} (|diff| {dl} > {TRAIN['loss_atol']})")
            check(dn <= TRAIN["norm_rtol"], f"(h) {tag} rank {r['rank']}: grad norm {leg['grad_norms'][0]} vs one "
                                            f"device {run['grad_norms'][0]} (rel {dn} > {TRAIN['norm_rtol']})")
    print("[train] (h) against this step 1, |loss diff| / grad norm rel diff: "
          + "; ".join(f"{tag} {v['loss_diff']:.3e} / {v['norm_rel_diff']:.3e}" for tag, v in h.items()), flush=True)
    # (d) the trained tree through save_params / load_params.
    tree = state.params.param_tree()
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(tree))
    path = OUT_DIR / "train-params"
    try:
        _sync(dev)
        t = time.monotonic()
        save_params(str(path), tree)
        write_s = time.monotonic() - t
        t = time.monotonic()
        got = load_params(str(path), device=dev)
        _sync(dev)
        read_s = time.monotonic() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = dict(_leaves(got))
    check(got.keys() == dict(_leaves(tree)).keys() and all(
        got[k].dtype == v.dtype and torch.equal(got[k].view(torch.int16), v.detach().view(torch.int16))
        for k, v in _leaves(tree)), "save_params/load_params: the trained tree is not bit-equal after the round trip")
    print(f"[train] (d) save_params / load_params of the trained tree: {nbytes} B, written in {write_s:.2f}s "
          f"({nbytes / write_s / 1e9:.2f} GB/s, to the page cache: no fsync), read onto the card in {read_s:.2f}s "
          f"({nbytes / read_s / 1e9:.2f} GB/s, a warm read: the file was just written); bit-equal", flush=True)
    del state, tree, got
    _release(dev)
    # (b) tiny() float32: one SGD step on the card and on the CPU.
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(tcfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(25).integers(0, tcfg.vocab_size, TRAIN["tiny_batch"]))
    sgd = lambda ps: torch.optim.SGD(ps, lr=1e-2)  # noqa: E731
    f32 = {}
    for where in (dev, torch.device("cpu")):
        st = make_train_state(tcfg, optimizer=sgd, device=where, params=params)
        st, loss = make_train_step(tcfg, None, sgd)(st, toks)
        f32[where.type] = (float(loss), {k: v.detach().cpu() for k, v in _leaves(st.params.param_tree())})
    loss_diff = abs(f32[dev.type][0] - f32["cpu"][0])
    leaf_diff = max(float((f32[dev.type][1][k] - v).abs().max()) for k, v in f32["cpu"][1].items())
    check(loss_diff <= 1e-5 and leaf_diff <= 1e-5,
          f"tiny float32 SGD step, card vs CPU: loss diff {loss_diff}, max leaf diff {leaf_diff} (> 1e-5)")
    print(f"[train] (b) tiny() float32 SGD step, {dev.type} vs CPU: loss {f32[dev.type][0]:.7f} vs "
          f"{f32['cpu'][0]:.7f} (diff {loss_diff:.2e}), max updated-leaf diff {leaf_diff:.2e}", flush=True)
    return {"n_params": n_params, "losses": losses, "step_walls_s": walls, "step_wall_s": wall,
            "tokens_per_s": n_tok / wall, "mfu": mfu, "mfu_params": n_mm,
            "mfu_formula": "6 * (params - input embedding) * tokens / wall / peak", "head_grad": head_grad,
            "peak_gib": peak / 2**30, "init_s": init_s, "grad_norms": run["grad_norms"],
            "kernel_launches": run["kernel_launches"], "h_vs_one_device": h,
            "params_ckpt": {"bytes": nbytes, "write_s": write_s, "read_s": read_s},
            "tiny_f32": {"loss_diff": loss_diff, "leaf_diff": leaf_diff}, "tree_ckpt": tree_leg}


# ---------------------------------------------------------------------------
# phase 20: the engine-driven workloads (``radixmesh_tpu_torch/workload.py``)
# ---------------------------------------------------------------------------

# Sizes of phase 20 (a CPU rehearsal shrinks them). (a) and (b) serve phase
# 3's model (``model``, full depth) on one engine of ``slots`` slots: (a) the
# north-star multi-turn traffic ``mt``; (b) open-loop overload ``ol`` through
# an ``SLORunner``, offered at ``offered_x`` times the prompt-token capacity
# that a deadline-free run of ``calib_s`` measures at the same shape (offered
# there at ``offered_x`` times the closed-loop rate of ``calib_prompts``
# prompts), with a TTFT deadline of ``deadline_x`` times the unloaded TTFT.
# (d)-(h) run the self-contained scenarios through their command lines
# (``radixmesh_tpu_torch/scripts/``, ``doctor --workload``) at
# their default model, ``scenario_model``'s widths ``layers`` deep, with
# the scenarios' default arguments (and the doctor's sizes for that model,
# ``scripts._cli.DOCTOR_KW``); (e) in float32. Then the HTTP soak for
# ``soak_s`` seconds at the same widths.
WL = dict(model="llama3-8b", slots=65536, page=16, max_batch=16,
          mt=dict(n_conversations=16, n_turns=4, system_len=1024, user_len=64, gen_len=32),
          ol=dict(tenants={"free": 1.0, "pro": 2.0}, prompt_len=1024, shared_frac=0.5, gen_len=16,
                  duration_s=4.0, calib_s=2.0, calib_prompts=8, offered_x=2.0, deadline_x=10.0),
          scenario_model=_cli.MODEL, layers=_cli.LAYERS, soak_s=12.0)


def _wl_counts(dev) -> dict:
    """The kernels' launches since the last reset, the plain versions' calls
    (none may run on the card), and the chunk kernel's tensor-core and
    CUDA-core bodies apart."""
    c = pa.launch_counts()
    f32 = c["paged_chunk_attention_kernel[f32 body]"]
    out = {"b1": c["paged_decode_fused_kernel"], "b2": c["paged_chunk_attention_kernel"] - f32, "b2_f32": f32,
           "b3": c["paged_attention_pool_kernel"], "plain": pa.plain_calls()}
    if torch.device(dev).type == "cuda":
        check(out["plain"] == 0, f"[workloads] plain versions ran on the card: {c}")
    return out


def workload_engine_phase(dev, model, card) -> dict:
    """Phase 20 (a) and (b) on phase 3's model. (a) ``MultiTurnWorkload``
    through ``run_engine_workload``: hit rate at least the north star's 0.70
    and at most the ceiling + 0.02, B1 and B2 launched; TTFT p50 and p99
    printed beside the north star's p50 < 200 ms. (b) ``OverloadWorkload``
    through ``run_overload_workload`` on an ``SLORunner`` over the same engine,
    priced as ``bench.py``'s overload sweep prices its points: every arrival
    offered, admitted, shed or timed out, none timed out."""
    from radixmesh_tpu_torch.slo.control import SLOConfig, TenantConfig
    from radixmesh_tpu_torch.slo.runner import SLORunner
    from radixmesh_tpu_torch.workload import (MultiTurnWorkload, OverloadWorkload, run_engine_workload,
                                              run_overload_workload)

    on_card = torch.device(dev).type == "cuda"
    cfg = model.cfg
    engine = Engine(cfg, model, num_slots=WL["slots"], page_size=WL["page"], max_batch=WL["max_batch"],
                    device=dev, name="wl-engine")
    out = {}
    try:
        # Warm-up outside the counted window (cuBLAS handles, allocator): a
        # prompt that shares no page with the workload's.
        warm = np.random.default_rng(20).integers(1, cfg.vocab_size, size=64).tolist()
        engine.generate([warm], SamplingParams(temperature=0.0, max_new_tokens=4))
        _sync(dev)
        wl = MultiTurnWorkload(vocab_size=cfg.vocab_size, seed=0, **WL["mt"])
        pa.reset_counters()
        t = time.monotonic()
        rep = run_engine_workload(engine, wl)
        _sync(dev)
        wall = time.monotonic() - t
        launches = _wl_counts(dev)
        check(rep["hit_rate"] >= 0.70, f"(a) hit rate {rep['hit_rate']:.4f} below the north star's 0.70")
        check(rep["hit_rate"] <= rep["ceiling_hit_rate"] + 0.02,
              f"(a) hit rate {rep['hit_rate']:.4f} past the ceiling {rep['ceiling_hit_rate']:.4f} + 0.02")
        if on_card:
            check(launches["b1"] > 0 and launches["b2"] > 0, f"(a) B1 or B2 not launched: {launches}")
        print(f"[workloads a] ({card}) north-star multi-turn {WL['mt']}: {rep['requests']} requests, "
              f"hit rate {rep['hit_rate']:.4f} (ceiling {rep['ceiling_hit_rate']:.4f}, reuse efficiency "
              f"{rep['reuse_efficiency']:.4f}, not gated: turn 0's siblings share one wave), prompt tokens "
              f"{rep['prompt_tokens']}, cached {rep['cached_tokens']}; TTFT p50 {rep['p50_ttft_s'] * 1e3:.1f} ms "
              f"(north star < 200 ms), p99 {rep['p99_ttft_s'] * 1e3:.1f} ms; wall {wall:.2f}s; launches {launches}",
              flush=True)
        out["a"] = {"report": {k: v for k, v in rep.items() if k != "ttft_s"}, "ttft_s": rep["ttft_s"],
                    "wall_s": wall, "launches": launches}

        ol = WL["ol"]
        samp = SamplingParams(temperature=0.0, max_new_tokens=ol["gen_len"])
        rng = np.random.default_rng(21)
        n = ol["calib_prompts"]
        prompts = [rng.integers(1, cfg.vocab_size, ol["prompt_len"]).tolist() for _ in range(n)]
        t_b = time.monotonic()
        pa.reset_counters()
        # Closed loop (the engine is warm from (a)): the unloaded TTFT and
        # the rate the cap run is offered at.
        n_ttft = len(engine.stats.ttft_s)
        t = time.monotonic()
        engine.generate(prompts, samp)
        _sync(dev)
        closed_tok_s = n * (ol["prompt_len"] + ol["gen_len"]) / (time.monotonic() - t)
        ttft_unloaded = float(np.median(engine.stats.ttft_s[n_ttft:]))
        deadline_s = ol["deadline_x"] * ttft_unloaded

        def slo_runner():
            return SLORunner(engine, SLOConfig(
                tenants={k: TenantConfig(weight=w) for k, w in ol["tenants"].items()})).start()

        def overload(offered, duration_s, seed, ttft_deadline_s):
            wl = OverloadWorkload(tenants=ol["tenants"], duration_s=duration_s, offered_tokens_per_s=offered,
                                  prompt_len=ol["prompt_len"], shared_frac=ol["shared_frac"],
                                  gen_len=ol["gen_len"], vocab_size=cfg.vocab_size, seed=seed)
            runner = slo_runner()
            try:
                rep = run_overload_workload(runner, wl, ttft_deadline_s=ttft_deadline_s)
            finally:
                runner.close()
            check(rep["offered_requests"] == len(wl.arrivals), f"(b) offered {rep['offered_requests']} "
                  f"of {len(wl.arrivals)} arrivals")
            check(rep["admitted_requests"] + rep["shed_requests"] + rep["timed_out_requests"]
                  == rep["offered_requests"], f"(b) the accounting does not close: {rep}")
            check(rep["timed_out_requests"] == 0, f"(b) {rep['timed_out_requests']} request(s) timed out")
            return rep

        # Open loop, no deadline: what the SLO path moves is its capacity.
        cap = overload(ol["offered_x"] * closed_tok_s, ol["calib_s"], 99, None)
        capacity = cap["served_requests"] * ol["prompt_len"] / cap["elapsed_s"]
        offered = ol["offered_x"] * capacity
        rep = overload(offered, ol["duration_s"], 0, deadline_s)
        _sync(dev)
        launches = _wl_counts(dev)
        if on_card:
            check(launches["b1"] > 0 and launches["b2"] > 0, f"(b) B1 or B2 not launched: {launches}")
        adm = rep["admitted_tokens_by_tenant"]
        share = {k: round(v / max(1, sum(adm.values())), 4) for k, v in sorted(adm.items())}
        weights = {k: round(w / sum(ol["tenants"].values()), 4) for k, w in sorted(ol["tenants"].items())}
        print(f"[workloads b] ({card}) open-loop overload, {ol['prompt_len']}-token prompts (shared "
              f"{ol['shared_frac']}), {ol['gen_len']} new: closed loop {closed_tok_s:.0f} tok/s, unloaded TTFT "
              f"{ttft_unloaded * 1e3:.1f} ms; capacity {capacity:.0f} prompt tok/s ({cap['served_requests']} "
              f"served in {cap['elapsed_s']:.2f}s); offered {offered:.0f} prompt tok/s for {ol['duration_s']}s, "
              f"TTFT deadline {deadline_s * 1e3:.0f} ms: offered {rep['offered_requests']}, admitted "
              f"{rep['admitted_requests']}, shed {rep['shed_requests']} {rep['shed_by_reason']}, timed out "
              f"{rep['timed_out_requests']}, deadline met {rep['deadline_met']}; goodput "
              f"{rep['goodput_tok_s']:.0f} tok/s, served {rep['served_tok_s']:.0f} tok/s; admitted share by "
              f"tenant {share} (weights {weights}); TTFT p50 {rep['p50_ttft_s'] * 1e3:.1f} ms, p99 "
              f"{rep['p99_ttft_s'] * 1e3:.1f} ms; wall {time.monotonic() - t_b:.2f}s; launches {launches}",
              flush=True)
        out["b"] = {"calibration": {"closed_loop_tok_s": closed_tok_s, "ttft_unloaded_s": ttft_unloaded,
                                    "capacity_tok_s": capacity, "run": cap},
                    "offered_tok_s": offered, "ttft_deadline_s": deadline_s, "report": rep,
                    "admitted_share": share, "wall_s": time.monotonic() - t_b, "launches": launches}
    finally:
        engine.close()
        del engine
        _release(dev)
    return out


# The DOCTOR report's benchdiff sentinel self-check: an identical pair
# clean, a regressed copy flagged, a cross-kind pair refused.
BENCHDIFF_PROOFS = ("identical_clean", "regression_flagged", "mismatch_detected")


def _model_args(model: str, dev) -> list[str]:
    """The engine-building command lines' device and model flags: on the
    card ``_cli.MODEL`` (Llama-3-8B's widths, ``_cli.LAYERS`` deep); a CPU
    rehearsal passes ``_cli.TOY``."""
    return ["--device", str(dev), "--model", model]


# The validators' verdicts that read the wall clock, by KIND and the start
# of their message; every other verdict is held. BLACKBOX: the history
# sampler's share of the wall and AGG: the pulls' share (the same seconds
# as the JAX runs, over a 2 s scenario instead of 6-24 s); SPEC: the
# adaptive controller's goodput ratio (one A-B pair of a short run).
WALL_CLOCK_VERDICTS = {
    "BLACKBOX": ("history: sampler overhead ",),
    "AGG": ("overhead: aggregation cost ",),
    "SPEC": ("adaptive: goodput ratio ",),
}


def _held_report(kind: str, path, tag: str, rc: int | None = None) -> dict:
    """The report a command line wrote to ``path`` (exiting ``rc``; None:
    written here), read back and held to its schema: the port's validator
    of its KIND (where the kind has a pinned schema) finds nothing but
    ``WALL_CLOCK_VERDICTS``' verdicts of the kind, which are printed; the
    file records as many in ``schema_violation``, and the command line
    exited 1 on them, else 0."""
    report = json.loads(pathlib.Path(path).read_text())
    validate = getattr(reports, f"validate_{kind.lower()}", None)  # SOAK has no pinned schema
    problems = [] if validate is None else validate(report)
    exempt = WALL_CLOCK_VERDICTS.get(kind, ())
    held = [p for p in problems if not p.startswith(exempt)]
    recorded = report.get("schema_violation", [])
    check(not held and len(recorded) == len(problems) and all(p.startswith(exempt) for p in recorded)
          and rc in (None, 1 if problems else 0),
          f"({tag}) the {kind} command line exited {rc}; its validator finds {held} (and the wall-clock "
          f"verdicts {[p for p in problems if p.startswith(exempt)]}); the report records {recorded}")
    if problems:
        print(f"[schema {kind}] ({tag}) wall-clock verdicts of this run, printed: {problems}", flush=True)
    return report


def _cli_leg(out: dict, dev, tag: str, kind: str, main, argv: list[str]):
    """One leg of phases 20 and 21 through its command line: ``main(argv)``
    in this process, writing ``chip_out/<KIND>_torch.json`` (its printed
    line to ``<KIND>_torch.stdout``), with the launch counts zeroed just
    before it and read just after it; the report read back and held to its
    schema (:func:`_held_report`). Its wall, launches and report land in
    ``out[tag]``."""
    path = OUT_DIR / f"{kind}_torch.json"
    _release(dev)
    pa.reset_counters()
    t = time.monotonic()
    with open(OUT_DIR / f"{kind}_torch.stdout", "w") as fh, contextlib.redirect_stdout(fh):
        rc = main([*argv, "--out", str(path)])
    _sync(dev)
    wall = time.monotonic() - t
    launches = _wl_counts(dev)
    rep = _held_report(kind, path, tag, rc)
    out[tag] = {"wall_s": wall, "launches": launches, "report": rep}
    return rep, launches, wall


def workload_scenario_phase(dev, card) -> dict:
    """Phase 20 (d)-(h): the self-contained scenarios of ``workload.py``
    through their command lines at ``WL["scenario_model"]``'s widths,
    ``WL["layers"]`` deep (the command lines' default model; bf16, (e) in
    float32), each leg's launches
    counted from just before it to just after, its report held to its
    schema and its wall printed; then the HTTP soak. The checks read
    nothing that depends on the wall clock."""
    from radixmesh_tpu_torch import doctor
    from radixmesh_tpu_torch import workload as wlm
    from radixmesh_tpu_torch.scripts import convoybench, kvflowbench, soak, specbench, tierbench

    on_card = torch.device(dev).type == "cuda"
    model = _model_args(WL["scenario_model"], dev)
    out = {}
    t0 = time.monotonic()
    leg = functools.partial(_cli_leg, out, dev)

    # (d) speculative decoding: acceptance and conservation, ITL with a
    # seeded stall, the adaptive-gamma A-B, the timeline's overhead.
    rep, n, wall = leg("d spec", "SPEC", specbench.main, model)
    acc, itl, ab, ovh = rep["acceptance"], rep["itl"], rep["adaptive"], rep["overhead"]
    check(acc["conserved"], f"(d) drafts not conserved: {acc}")
    check(itl["seeded_detected"], f"(d) the seeded scheduler_wait stall was not detected: {itl['stalls']}")
    if on_card:
        check(n["b1"] > 0 and n["b2"] > 0, f"(d) B1 or B2 not launched: {n}")
    print(f"[workloads d] ({card}) spec: proposed {acc['proposed']} = accepted {acc['accepted']} + rejected "
          f"{acc['rejected']} over {acc['waves']} waves; by shape "
          f"{ {k: v['acceptance'] for k, v in acc['by_shape'].items()} }, by source "
          f"{ {k: v['acceptance'] for k, v in acc['by_source'].items()} }; ITL p50 {itl['p50_s']} p99 "
          f"{itl['p99_s']} s, stalls {itl['stalls']}; adaptive goodput ratio {ab['goodput_ratio']} (no_worse "
          f"{ab['no_worse']}); timeline overhead fraction {ovh['fraction']} (under budget "
          f"{ovh['under_budget']}); wall {wall:.2f}s; launches {n}", flush=True)

    # (e) the prefill convoy, in float32 (token equality across schedules;
    # the command line runs a preset model in float32).
    rep, n, wall = leg("e convoy", "CONVOY", convoybench.main, model)
    inter, stalls, starv, cross = rep["interleave"], rep["stalls"], rep["starvation"], rep["crossover"]
    check(inter["outputs_match"], "(e) the legacy and mixed-wave arms emitted other tokens (float32)")
    check(starv["bounded"], f"(e) the carrier starved past the bound: {starv}")
    check(cross["small_batch_ok"], f"(e) the small-batch dispatch failed: {cross['sweep']}")
    check(cross["outputs_agree"], f"(e) the sweep's B3 leg (D 64, float32) disagrees with the dense leg past "
          f"{wlm.SWEEP_ATOL}: {[(e['batch'], e['max_abs_err']) for e in cross['sweep']]}")
    if on_card:
        check(n["b3"] > 0, f"(e) the crossover sweep launched no B3: {n}")
        check(n["b2_f32"] > 0 and n["b1"] > 0, f"(e) the float32 chunk body or B1 not launched: {n}")
    sweep = {e["batch"]: (e["dense_t_s"] * 1e3, e["bucketed_t_s"] * 1e3) for e in cross["sweep"]}
    print(f"[workloads e] ({card}) convoy (float32, reps {inter['reps']}): outputs match "
          f"{inter['outputs_match']}; late TTFT p50 base {inter['base_ttft_p50_s'] * 1e3:.2f} ms vs mixed "
          f"{inter['mixed_ttft_p50_s'] * 1e3:.2f} ms (ttft_ratio {inter['ttft_ratio']}); convoy_drop_ratio "
          f"{stalls['convoy_drop_ratio']} (causes base {stalls['base_causes']}, mixed {stalls['mixed_causes']}); "
          f"starvation max step gap {starv['max_step_gap']} <= {starv['max_defer_bound']}, boost waves "
          f"{starv['boost_waves']}; sweep ms (dense leg, B3 bucketed) by batch "
          f"{ {b: (round(d, 4), round(p, 4)) for b, (d, p) in sweep.items()} }, B3 against the dense leg max abs "
          f"{ {e['batch']: e['max_abs_err'] for e in cross['sweep']} } (<= {wlm.SWEEP_ATOL}), paged selected "
          f"{[e['paged_selected'] for e in cross['sweep']]}, large_batch_ok {cross['large_batch_ok']}; "
          f"wall {wall:.2f}s; launches {n}", flush=True)

    # (f) the async KV plane against the synchronous baseline, at the
    # scenario's own sizes (the command line's defaults are the JAX
    # script's 4 x 768 tokens).
    rep, n, wall = leg("f kvflow", "KVFLOW", kvflowbench.main,
                       model + ["--requests", "3", "--prompt-tokens", "1536"])
    rs, wb, pf = rep["restore"], rep["writeback"], rep["prefetch"]
    check(rs["decode_steps_during_restore"] > 0, f"(f) no decode step while a restore was parked: {rs}")
    check(rs["sync_decode_steps_during_restore"] == 0, f"(f) the synchronous path decoded during a restore: {rs}")
    check(wb["gathers_per_sweep"] == 1 and wb["sync_gathers_per_sweep"] == 1,
          f"(f) write-back gathers per sweep: {wb}")
    check(rs["parked_requests"] == rs["requests"], f"(f) parked {rs['parked_requests']} of {rs['requests']}")
    if on_card:
        check(n["b1"] > 0 and n["b2"] > 0, f"(f) B1 or B2 not launched: {n}")
    print(f"[workloads f] ({card}) kvflow: burst mean TTFT sync {rs['sync_ttft_s'] * 1e3:.2f} ms vs plane "
          f"{rs['overlapped_ttft_s'] * 1e3:.2f} ms (overlap_ratio {rs['overlap_ratio']}, restore sub-means "
          f"{rs['sync_restore_ttft_s'] * 1e3:.2f} / {rs['overlapped_restore_ttft_s'] * 1e3:.2f} ms, fresh "
          f"{rs['sync_fresh_ttft_s'] * 1e3:.2f} / {rs['overlapped_fresh_ttft_s'] * 1e3:.2f} ms); decode steps "
          f"during restore {rs['decode_steps_during_restore']} (sync {rs['sync_decode_steps_during_restore']}), "
          f"max decode gap {rs['max_decode_gap_s'] * 1e3:.2f} ms (sync {rs['sync_max_decode_gap_s'] * 1e3:.2f}); "
          f"parked {rs['parked_requests']}/{rs['requests']}; gathers per sweep {wb['gathers_per_sweep']}; "
          f"hit_ahead_rate {pf['hit_ahead_rate']} ({pf['hints_sent']} hints, {pf['hints_joined']} joined); "
          f"wall {wall:.2f}s; launches {n}", flush=True)

    # (g) the disk tier: capacity, restore overlap, the cold cell. Its
    # extents live in the scenario's mkdtemp directory, which it removes.
    tmp = pathlib.Path(tempfile.gettempdir())
    before = set(tmp.glob("tierwl-*"))
    rep, n, wall = leg("g tier", "TIER", tierbench.main, model)
    check(set(tmp.glob("tierwl-*")) <= before, "(g) the tier's extent directory was left behind")
    cap, ro, cs, cor = rep["capacity"], rep["restore_overlap"], rep["cold_start"], rep["corruption"]
    check(cs["byte_identical"], f"(g) the resumed streams are not byte-identical: {cs}")
    check(cs["corrupt_served"] == 0 and cor["served_corrupt"] == 0, f"(g) corrupt KV served: {cor}")
    check(cor["detected"] == cor["extents_attacked"] == 2, f"(g) corrupt extents detected: {cor}")
    check(cs["resumed"] == cs["interrupted"], f"(g) resumed {cs['resumed']} of {cs['interrupted']}")
    check(rep["meshcheck"]["clean"], f"(g) the port's meshcheck over the tier plane: {rep['meshcheck']}")
    if on_card:
        check(n["b1"] > 0 and n["b2"] > 0, f"(g) B1 or B2 not launched: {n}")
    print(f"[workloads g] ({card}) tier: hit rate with the tier {cap['tier_hit_rate']} vs host only "
          f"{cap['baseline_hit_rate']} (gain {cap['hit_rate_gain']}, working set {cap['working_set_ratio']}x the "
          f"arena); restore overlap: parked {ro['parked_requests']}, decode steps during restore "
          f"{ro['decode_steps_during_restore']}, max decode gap {ro['max_decode_gap_s'] * 1e3:.2f} ms; cold cell "
          f"resumed {cs['resumed']}/{cs['interrupted']} byte-identical {cs['byte_identical']}, disk hit tokens "
          f"{cs['disk_hit_tokens']}, corrupt detected {cor['detected']} of {cor['extents_attacked']}, served "
          f"{cor['served_corrupt']}; restart {cs['restart_s']}s; wall {wall:.2f}s; launches {n}", flush=True)

    # (h) the mesh doctor: healthy, then three seeded pathologies, through
    # ``python -m radixmesh_tpu_torch.doctor --workload``.
    rep, n, wall = leg("h doctor", "DOCTOR", doctor.main, ["--workload"] + model)
    hl, path, att = rep["healthy"], rep["pathologies"], rep["attribution"]
    check(hl["findings"] == [], f"(h) the healthy phase has findings: {hl['findings']}")
    for rule in ("hot_shard", "prefill_convoy", "restore_park_stall"):
        check(path[rule]["detected"] and path[rule]["evidence_correct"],
              f"(h) {rule} not named with the seeded evidence: {path[rule]}")
    check(att["sums_ok"], f"(h) the attributor's phase sums are off: {att}")
    if on_card:
        check(n["b1"] > 0 and n["b2"] > 0, f"(h) B1 or B2 not launched: {n}")
    print(f"[workloads h] ({card}) doctor: healthy {len(hl['rules_checked'])} rules, {len(hl['findings'])} "
          f"findings; " + "; ".join(f"{r} score {p['score']} evidence {p['evidence']}" for r, p in path.items())
          + f"; attribution audited {att['audited']}, max sum error {att['max_sum_error_s']}; benchdiff "
          f"self-check { {k: rep['benchdiff'][k] for k in BENCHDIFF_PROOFS} }; wall {wall:.2f}s; launches {n}",
          flush=True)
    check(all(rep["benchdiff"][k] for k in BENCHDIFF_PROOFS), f"(h) the benchdiff self-check: {rep['benchdiff']}")

    # The HTTP soak: multi-turn clients against a ServingFrontend.
    rep, n, wall = leg("soak", "SOAK", soak.main, model + ["--seconds", str(WL["soak_s"])])
    check(rep["errors"] == 0 and rep["value"] > 0, f"(soak) {rep['value']} requests, {rep['errors']} errors")
    if on_card:
        check(n["b1"] > 0 and n["b2"] > 0, f"(soak) B1 or B2 not launched: {n}")
    print(f"[workloads soak] ({card}) {rep['value']} requests in {rep['wall_s']} s ({rep['requests_per_s']}/s), "
          f"errors {rep['errors']}, hit rate {rep['hit_rate']}, server TTFT p50 {rep['server_p50_ttft_ms']} ms, "
          f"client latency {rep['client_latency_ms']}; wall {wall:.2f}s; launches {n}", flush=True)
    _release(dev)
    print(f"[time] phase 20 (d)-(h) and the soak {time.monotonic() - t0:.1f}s", flush=True)
    return out


def workload_phase(dev, card) -> dict:
    """Phase 20 alone: phase 3's model drawn again from its seed (the same
    weights) for (a) and (b), freed, then (d)-(h)."""
    t = time.monotonic()
    cfg = get_config(WL["model"])
    with torch.inference_mode():
        model = Llama(cfg, init_params(cfg, seed=0, device=dev))
    out = workload_engine_phase(dev, model, card)
    del model
    _release(dev)
    print(f"[time] phase 20 (a), (b) {time.monotonic() - t:.1f}s (phase 3's weights drawn again)", flush=True)
    out.update(workload_scenario_phase(dev, card))
    return out


# Phase 21. (i) and (j) are host code over the in-process mesh: the JAX
# acceptance test's reduced chaos arguments, sharded (rf 2) so that the
# rebalance phase runs too. (k)-(m) run each scenario at its defaults.
FLEET_WL = dict(chaos=dict(partition_s=1.2, partition_delay_s=0.3, n_requests=60, quiesce_window_s=0.8,
                           timeout_s=45.0, join_partition_s=1.0, drain_requests=25, crash_streams=8,
                           crash_tokens=16, replication_factor=2),
                model=_cli.MODEL, layers=_cli.LAYERS, timeout_s=300)
FLEET_JSON = "fleet-workloads.json"
FLEET_ENGINES_JSON = "fleet-engines.json"


def fleet_workload_child(out: str) -> int:
    """Phase 21 (i) and (j), in a child process of this script that never
    touches the card (``_start_fleet_child`` hides it): (i) through its
    command line (``scripts.fleetbench``), (j) through ``run_chaos_workload``
    at ``FLEET_WL["chaos"]``'s reduced sizes (which the JAX script's flags
    cannot all express), its CHAOS report built and validated by
    ``reports.py`` beside it; each report is written beside ``out`` and held
    to its schema, and each leg holds its wall-clock-free verdicts here; the
    readings go to ``out``."""
    from radixmesh_tpu_torch import workload as wlm
    from radixmesh_tpu_torch.scripts import fleetbench

    out_dir = pathlib.Path(out).parent
    res = {}
    t = time.monotonic()
    path = out_dir / "FLEET_torch.json"
    with open(out_dir / "FLEET_torch.stdout", "w") as fh, contextlib.redirect_stdout(fh):
        rc = fleetbench.main(["--out", str(path)])
    rep = _held_report("FLEET", path, "i", rc)
    res["i churn"] = {"wall_s": time.monotonic() - t, "report": rep}
    conv, stall = rep["convergence"], rep["stall_reaction"]
    check(conv["converged"] and conv["injected_divergence_detected"] and conv["healed"],
          f"(i) the replicas did not converge, or the injected divergence was missed or not healed: {conv}")
    check(stall["detected"] and rep["health_aware_demotion"], f"(i) the stalled node was not demoted: {stall}")
    print(f"[workloads i] churn: {json.dumps(rep)}", flush=True)

    t = time.monotonic()
    rep = reports.checked(reports.build_chaos_report(wlm.run_chaos_workload(**FLEET_WL["chaos"])),
                          reports.validate_chaos)
    (out_dir / "CHAOS_torch.json").write_text(json.dumps(rep, indent=1, sort_keys=True) + "\n")
    rep = _held_report("CHAOS", out_dir / "CHAOS_torch.json", "j")
    res["j chaos"] = {"wall_s": time.monotonic() - t, "report": rep}
    print(f"[workloads j] chaos: {json.dumps(rep)}", flush=True)
    check(rep["served"]["ok_rate_during_fault"] >= 0.9, f"(j) served through the fault: {rep['served']}")
    check(rep["divergence"]["detected"] and rep["repair"]["converged"],
          f"(j) divergence {rep['divergence']}, repair {rep['repair']}")
    dr, jn, cr, rb, rk = (rep[k] for k in ("drain", "join", "crash", "rebalance", "router_kill"))
    check(dr["performed"] and dr["zero_failed"] and dr["requeued_served"] == dr["requeued"]
          and dr["left_without_failure_detection"] and dr["writeback_flushed"], f"(j) drain: {dr}")
    check(jn["performed"] and jn["converged_with_donor"] and jn["hits_to_bootstrapping"] == 0
          and jn["fleet_converged_after_join"], f"(j) join: {jn}")
    check(cr["performed"] and cr["failed"] == 0 and cr["interrupted"] > 0 and cr["resumed"] == cr["interrupted"]
          and cr["prefix_identical"] and cr["copies_before_kill"] and cr["resurrection_hit_ratio"] >= 0.8
          and cr["hedge"]["first_writer_wins"] and cr["hedge"]["loser_cancelled"], f"(j) crash: {cr}")
    check(rb["performed"] and rb["skew_dropped"] and rb["failed_mid_move"] == 0 and rb["moves_bounded"]
          and rb["overrides_converged"], f"(j) rebalance: {rb}")
    check(rk["performed"] and rk["failed"] == 0 and rk["completed"] == rk["streams"] and rk["survivor_served"],
          f"(j) router kill: {rk}")
    pathlib.Path(out).write_text(json.dumps(res, default=str))
    return 0


def _start_phase21_child(out_dir, flag: str, name: str, env=None) -> tuple:
    """Start a phase 21 child process of this script (``flag`` OUT, with
    ``PAR`` and ``FLEET_WL`` as they stand); its readings go to
    ``<name>.json``, its output to ``<name>.log``."""
    out_dir = pathlib.Path(out_dir)
    log_path = out_dir / f"{name}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag, str(out_dir / f"{name}.json"),
                                 "--parallel-sizes", json.dumps(PAR), "--fleet-sizes", json.dumps(FLEET_WL)],
                                cwd=ROOT, env=env or os.environ, stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def _start_fleet_child(out_dir) -> tuple:
    """Start phase 21 (i) and (j) as a child process of this script, with no
    card visible to it."""
    return _start_phase21_child(out_dir, "--fleet-workloads", FLEET_JSON.removesuffix(".json"),
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def fleet_engine_child(out: str) -> int:
    """Phase 21 (k)-(m) in a child process of this script, started with phase
    18's ranks: it waits for (h)'s gate, then runs ``fleet_engine_phase``
    while this script's main process runs phase 20 (d)-(h) and the ranks
    train. Its launch counts and metric registry are its own. The readings
    go to ``out``."""
    out = pathlib.Path(out)
    _wait_h_gate(out.parent)
    dev = torch.device(PAR["device"], 0) if PAR["device"] == "cuda" else torch.device("cpu")
    out.write_text(json.dumps(fleet_engine_phase(dev, card_line() if dev.type == "cuda" else "cpu"),
                              default=str))
    return 0


def _fleet_engine_report(out_dir, log_path) -> dict:
    """Phase 21 (k)-(m)'s readings, once their process exited 0; their
    lines, printed in that process's log, printed here too."""
    for line in pathlib.Path(log_path).read_text().splitlines():
        if line.startswith(("[workloads k]", "[workloads l]", "[workloads m]", "[schema ", "[time] phase 21")):
            print(line, flush=True)
    return json.loads((pathlib.Path(out_dir) / FLEET_ENGINES_JSON).read_text())


def _fleet_child_report(out_dir) -> dict:
    """Phase 21 (i) and (j)'s readings, once their process exited 0."""
    res = json.loads((pathlib.Path(out_dir) / FLEET_JSON).read_text())
    rep = res["i churn"]["report"]
    conv, stall, fan = rep["convergence"], rep["stall_reaction"], rep["fan_in"]
    print(f"[workloads i] (host CPU, no card) fleet churn, {rep['topology']}: digest fan-in p50 "
          f"{fan['p50_s'] * 1e3:.2f} ms, max {fan['max_s'] * 1e3:.2f} ms ({fan['rounds']} rounds, "
          f"{rep['digest_bytes']} B a digest); {conv['inserts']} inserts by {conv['writers']} writers converged "
          f"{conv['quiesce_to_converged_s']} s after quiescing; an injected divergence detected (age "
          f"{conv['age_while_diverged_s']} s) and healed in {conv['heal_s']} s; a stalled node scored "
          f"{stall['score_after']} < {stall['threshold']} after {stall['reaction_s']} s and demoted; digest frames "
          f"per publish {rep['digest_frames_per_publish']}; wall {res['i churn']['wall_s']:.2f}s", flush=True)
    rep = res["j chaos"]["report"]
    rp, q, dr, jn, cr, rb, rk = (rep[k] for k in ("repair", "quiescence", "drain", "join", "crash", "rebalance",
                                                  "router_kill"))
    print(f"[workloads j] (host CPU, no card) chaos, {rep['topology']}, rf {rep['replication_factor']}: served "
          f"{rep['served']['ok']}/{rep['served']['attempted']} through {rep['fault_plan']['drop_p']} loss and a "
          f"{rep['fault_plan']['partition_s']} s partition ({rep['fault_plan']['frames_dropped']} frames dropped); "
          f"repair converged in {rp['converge_s']} s, {rp['max_episode_rounds']} rounds (budget "
          f"{rep['round_budget']}, within {rp['within_round_budget']}); quiet {q['quiet']}; drain: requeued "
          f"{dr['requeued_served']}/{dr['requeued']}, {dr['ok_during_drain']}/{dr['attempted_during_drain']} served; "
          f"join under a partition: converged with the donor in {jn['bootstrap_converge_s']} s, "
          f"{jn['bootstrap_rounds']} rounds, hits to the joiner while bootstrapping {jn['hits_to_bootstrapping']}; "
          f"crash of {cr['node']}: the survivors held the interrupted streams before the kill "
          f"{cr['copies_before_kill']}, {cr['resumed']}/{cr['interrupted']} streams resumed byte-identical "
          f"{cr['prefix_identical']}, failed {cr['failed']}, resurrection hit ratio {cr['resurrection_hit_ratio']}, "
          f"detection {cr['detection']['detect_s']} s, within one backoff {cr['budget']['within_one_backoff']}; "
          f"rebalance: skew {rb['skew_before']} -> {rb['skew_after']}, {rb['moves']} moves, "
          f"{rb['ok_mid_move']}/{rb['attempted_mid_move']} served mid-move; router kill of {rk['killed']}: "
          f"{rk['completed']}/{rk['streams']} completed through {rk['survivor']}, {rk['failovers']} failovers; "
          f"wall {res['j chaos']['wall_s']:.2f}s", flush=True)
    return res


def _join_fleet_child(proc, log_path, out_dir) -> dict:
    """Wait for phase 21 (i) and (j)'s process (``FLEET_WL["timeout_s"]``),
    fail with its log's tail unless it exited 0, and read its reports."""
    try:
        rc = proc.wait(timeout=FLEET_WL["timeout_s"])
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    check(rc == 0, f"phase 21 (i), (j) {'timed out' if rc is None else f'exited {rc}'}:\n"
          + pathlib.Path(log_path).read_text()[-4000:])
    return _fleet_child_report(out_dir)


def fleet_engine_phase(dev, card) -> dict:
    """Phase 21 (k)-(m): the observability, black-box and fleet-aggregation
    scenarios of ``workload.py`` through their command lines, their engines
    at ``FLEET_WL["model"]``'s widths, ``FLEET_WL["layers"]`` deep (the
    command lines' default model, bf16),
    each with a fresh metric registry (the aggregator's merged TTFT reads
    the process registry, which every earlier phase of this process fed),
    its launches counted from just before it to just after and its report
    held to its schema; the checks read nothing that depends on the wall
    clock. (k)'s engine prefills its three lone short prompts on the dense
    route, as the JAX engine does: the leg launches B1 and no B2, which (l)
    and (m) launch."""
    from radixmesh_tpu_torch.obs.metrics import Registry, get_registry, set_registry
    from radixmesh_tpu_torch.scripts import aggbench, blackboxbench, obsbench

    on_card = torch.device(dev).type == "cuda"
    model = _model_args(FLEET_WL["model"], dev)
    out = {}
    t0 = time.monotonic()
    old_registry = get_registry()
    registries = {}

    def leg(tag, kind, main, argv=()):
        registries[tag] = set_registry(Registry())
        try:
            return _cli_leg(out, dev, tag, kind, main, model + list(argv))
        finally:
            set_registry(old_registry)

    def launched(tag, n, kernels=("b1", "b2")):
        if on_card:
            check(all(n[k] > 0 for k in kernels), f"({tag}) {' or '.join(kernels)} not launched: {n}")

    # (k) the stitched trace, the heat storm, the wire, the step accounting.
    rep, n, wall = leg("k obs steps", "OBS", obsbench.main)
    st, heat, steps, wire = rep["stitch"], rep["heat"], rep["steps"], rep["wire"]
    check(st["failed"] == 0 and st["interrupted"] > 0 and st["resumed"] == st["interrupted"], f"(k) stitch: {st}")
    check(st["copies_before_kill"] and st["node_tracks"] >= 3 and st["replication_edges"] > 0
          and st["publish_edges"] > 0, f"(k) the stitched trace: {st}")
    check(heat["hot_shard"] == heat["expected_hot_shard"] and heat["owner_set_correct"]
          and heat["skew_score"] >= 2.0, f"(k) heat: {heat}")
    check(wire["rf0_traceless_unchanged"] and wire["trace_trailer_roundtrip"] and wire["trailer_bytes"] == 8,
          f"(k) wire: {wire}")
    check(steps["performed"] and steps["prefill"]["waves"] > 0 and steps["decode"]["waves"] > 0,
          f"(k) step accounting: {steps}")
    launched("k", n, ("b1",))
    print(f"[workloads k] ({card}) obs: interrupted {st['interrupted']} (the survivors held them before the kill "
          f"{st['copies_before_kill']}) resumed {st['resumed']}, the stitched "
          f"trace {st['trace_id']} on {st['node_tracks']} node tracks {st['nodes_on_track']}, replication edges "
          f"{st['replication_edges']}, publish edges {st['publish_edges']}; hot shard {heat['hot_shard']} (expected "
          f"{heat['expected_hot_shard']}), owners {heat['hot_owners']}, skew {heat['skew_score']}; wire trailer "
          f"{wire['trailer_bytes']} B; steps (peak {steps['peak_tflops']} TFLOP/s, {steps['n_params']} params): "
          f"prefill {steps['prefill']}, decode {steps['decode']}; wall {wall:.2f}s; launches {n}", flush=True)

    # (l) the black box: healthy, storm, a hard kill, the post-mortem.
    bb_dir = tempfile.mkdtemp(prefix="bb-l-", dir=OUT_DIR)
    try:
        rep, n, wall = leg("l blackbox", "BLACKBOX", blackboxbench.main, ["--keep-dumps", bb_dir])
        victim_dir = pathlib.Path(bb_dir) / "victim"
        names = [p.name for d in victim_dir.iterdir() for p in d.iterdir()]
    finally:
        shutil.rmtree(bb_dir, ignore_errors=True)
    pm, storm, hist = rep["postmortem"], rep["storm"], rep["history"]
    check(rep["healthy"]["findings"] == [], f"(l) the healthy phase has findings: {rep['healthy']['findings']}")
    check(storm["hot_shard"] == storm["expected_hot_shard"] and storm["owner_set_correct"], f"(l) storm: {storm}")
    crash_ev = pm["observer"]["crash_evidence"]
    check(rep["crash"]["digests_fresh_at_kill"] and rep["named"] == 3
          and pm["observer"]["hot_shard_evidence"].get("shard") == pm["expected"]["hot_shard"]
          and crash_ev.get("rank") == str(rep["crash"]["victim_rank"]) and pm["observer"]["crash_window_named"]
          and pm["victim"]["truncation_named"],
          f"(l) the post-mortem: hot shard {pm['observer']['hot_shard_evidence']}, the victim's drop {crash_ev}, "
          f"truncation {pm['victim']['truncation_evidence']}")
    check(pm["victim"]["unclean"] and any(x.startswith("segment-") for x in names)
          and not any(x.startswith("final-") for x in names), f"(l) the victim's directory: {names}")
    launched("l", n)
    print(f"[workloads l] ({card}) blackbox: healthy {len(rep['healthy']['rules_checked'])} rules, 0 findings; "
          f"storm hot shard {storm['hot_shard']}, victim rank {rep['crash']['victim_rank']} killed; post-mortem "
          f"from the dumps: hot shard {pm['observer']['hot_shard_evidence']}, the victim's crash window "
          f"{crash_ev.get('window')} holds t_kill {pm['expected']['t_kill']} (named {rep['named']} of 3), the "
          f"victim's truncation "
          f"{pm['victim']['truncation_evidence']}; {len(names)} victim files, segments only; "
          f"sampler overhead {hist['self_overhead']['fraction']} of the wall (budget 0.01, under "
          f"{hist['self_overhead']['under_budget']}); wall {wall:.2f}s; launches {n}", flush=True)

    # (m) the fleet aggregator: merged p99, straggler, exemplar, gap.
    rep, n, wall = leg("m agg", "AGG", aggbench.main)
    pc, sg, ex, gap, fan, ovh = (rep[k] for k in ("percentiles", "straggler", "exemplar", "gap", "fan_in",
                                                   "overhead"))
    check(sg["detected"] and str(sg["named_rank"]) == str(sg["seeded_rank"]), f"(m) straggler: {sg}")
    check(ex["trace_id"] and ex["stitched"] and ex["has_straggler_span"], f"(m) the p99 exemplar: {ex}")
    check(gap["detected"] and gap["verdict"] in ("node_dead", "sampler_dead"), f"(m) gap: {gap}")
    check(fan["errors"] == 0 and fan["peers"] == 200, f"(m) fan-in: {fan}")
    launched("m", n)
    # Where the p99 tail sits: the leg's TTFTs by bucket (cumulative), the
    # first batch being its first 4 requests.
    family = "radixmesh_request_ttft_seconds"
    snap = registries["m agg"].snapshot(bucket_families=(family,))
    ttft_le = {re.search(r'le="([^"]+)"', k).group(1): int(v) for k, v in snap.items()
               if k.startswith(family + "_bucket") and 'tenant="default"' in k}
    out["m agg"]["ttft_cumulative_by_le"] = ttft_le
    print(f"[workloads m] ({card}) agg: TTFT p99 merged {pc['fleet_p99_s']} s (bucket {pc['bucket_lo_s']}-"
          f"{pc['bucket_hi_s']}) vs the raw records' {pc['truth_p99_s']} s over {pc['raw_requests']} requests, "
          f"within one bucket {pc['within_one_bucket']} (count {pc['count']} over {len(pc['nodes'])} nodes); "
          f"straggler rank {sg['named_rank']} (seeded {sg['seeded_rank']}, ratio {sg['ratio']}); p99 exemplar "
          f"{ex['trace_id']} le {ex['le']} on {ex['node']}, stitched to the straggler's span "
          f"{ex['has_straggler_span']}; gap {gap['killed_peer']} {gap['verdict']} after {gap['stalled_s']} s; "
          f"fan-in sweep of {fan['peers']} peers {fan['sweep_s'] * 1e3:.2f} ms; pull overhead {ovh['fraction']} "
          f"(under budget {ovh['under_budget']}); TTFTs by bucket (cumulative, le: count) {ttft_le}; wall "
          f"{wall:.2f}s; launches {n}", flush=True)
    _release(dev)
    print(f"[time] phase 21 (k)-(m) {time.monotonic() - t0:.1f}s", flush=True)
    return out


# The reports phases 20 and 21 write through the command lines.
WORKLOAD_REPORTS = ("SPEC", "CONVOY", "KVFLOW", "TIER", "DOCTOR", "SOAK", "FLEET", "CHAOS", "OBS", "BLACKBOX",
                    "AGG")


def benchdiff_phase() -> dict:
    """Phase 21's last leg, on the host: the port's benchdiff
    (``scripts.benchdiff``) over each report phases 20 and 21 wrote, against
    itself: each kind is recognised from its metric and compares clean
    (exit 0)."""
    from radixmesh_tpu_torch.scripts import benchdiff

    rcs = {}
    for kind in WORKLOAD_REPORTS:
        path = str(OUT_DIR / f"{kind}_torch.json")
        with open(OUT_DIR / f"benchdiff-{kind}.txt", "w") as fh, contextlib.redirect_stdout(fh):
            rcs[kind] = benchdiff.main([path, path])
    print(f"[benchdiff] each report against itself (exit codes): {rcs}", flush=True)
    check(all(rc == reports.BENCHDIFF_EXIT_CLEAN for rc in rcs.values()), f"benchdiff: {rcs}")
    return rcs


def _parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1, 2 and 7 alone (build, SASS, the kernels against their plain "
                         "versions, timed); the readings go to --json")
    ap.add_argument("--json", metavar="FILE", help="where --kernels writes its readings")
    ap.add_argument("--parallel-alone", metavar="SIZES",
                    help="the build, phase 18 (b)-(h) and phase 19 alone, with these of phase 18's sizes "
                         "changed (a JSON "
                         "object, e.g. '{\"layers\": 32, \"f32_layers\": 32, \"witness\": true}': "
                         "every leg at full depth, the logit rows read, not held, beside the single "
                         "device's own spread and single devices with tp's rounding: its row-parallel "
                         "products, and all its products)")
    ap.add_argument("--workloads-alone", action="store_true",
                    help="the build and phases 20 and 21 alone (phase 3's weights drawn for (a) and (b)); "
                         "the readings go to chip_out/workloads_alone.json")
    # Phase 18's child processes (started by the script itself).
    ap.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-nccl", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-store", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-out", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-sizes", help=argparse.SUPPRESS)
    ap.add_argument("--train-sizes", help=argparse.SUPPRESS)
    # Phase 21 (i) and (j)'s child process.
    ap.add_argument("--fleet-workloads", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--fleet-engines", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--fleet-sizes", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    if args.parallel_sizes:
        PAR.update(json.loads(args.parallel_sizes))
    if args.train_sizes:
        TRAIN.update(json.loads(args.train_sizes))
    if args.fleet_sizes:
        FLEET_WL.update(json.loads(args.fleet_sizes))
    if args.parallel_rank is not None:
        return parallel_rank(args.parallel_rank, args.parallel_world, args.parallel_store, args.parallel_out)
    if args.fleet_workloads:
        return fleet_workload_child(args.fleet_workloads)
    if args.fleet_engines:
        return fleet_engine_child(args.fleet_engines)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU (no result)", file=sys.stderr)
        return 2
    if args.parallel_nccl:
        return parallel_nccl(args.parallel_store, args.parallel_out)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] card: {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    host = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="chip-smoke-host")
    whole_script = not (args.kernels or args.parallel_alone or args.workloads_alone)
    shadow = host.submit(build_shadow_phase) if whole_script else None
    log = _build.build_all()
    print(f"[env] kernel build {time.monotonic() - t0:.1f}s wall: "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in log.items()), flush=True)
    if shadow is not None:
        shadow = shadow.result()
        print(f"[time] kernel build {time.monotonic() - t0:.1f}s, with phase 16 (b) and the port's meshcheck "
              f"beside it", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text("\n".join(f"== {k}\n{v['ptxas']}" for k, v in log.items()))
    lines = [line for v in log.values() for line in v["ptxas"].splitlines()]
    regs = [int(w) for line in lines for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers") and w.isdigit()]
    for line in lines:
        if "warning" in line.lower():
            print(f"[env] ptxas: {line.strip()}", flush=True)
    spills = [line for line in lines
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    print(f"[env] ptxas: max registers/thread {max(regs) if regs else 'n/a'}; "
          f"{len(spills)} kernel(s) spill" + "".join(f"\n  {x.strip()}" for x in spills), flush=True)

    if args.parallel_alone:
        PAR.update(json.loads(args.parallel_alone))
        par = parallel_phase_finish(parallel_phase_start())
        print(f"[time] phase 18 (b)-(h) alone {par['wall_s']:.1f}s", flush=True)
        t = time.monotonic()
        with torch.inference_mode():
            model = Llama(get_config("llama3-8b"), init_params(get_config("llama3-8b"), seed=0, device=dev))
        tree_leg = tree_checkpoint_leg(dev, model)
        del model
        _release(dev)
        train = train_phase(dev, par, tree_leg)
        print(f"[time] phase 19 {time.monotonic() - t:.1f}s (with phase 3's weights drawn for (c))", flush=True)
        (OUT_DIR / "parallel_alone.json").write_text(json.dumps(
            {"card": card, "sizes": PAR, "train_sizes": TRAIN, "parallel": par, "train": train}, indent=1,
            default=str))
        print(card, flush=True)
        return 0
    if args.workloads_alone:
        torch.cuda.reset_peak_memory_stats()
        fleet_proc, fleet_log = _start_fleet_child(OUT_DIR)
        try:
            workloads = workload_phase(dev, card)
            workloads.update(fleet_engine_phase(dev, card))
            workloads.update(_join_fleet_child(fleet_proc, fleet_log, OUT_DIR))
            workloads["benchdiff"] = benchdiff_phase()
        finally:
            if fleet_proc.poll() is None:
                fleet_proc.kill()
            fleet_proc.wait()
        print(f"[workloads] this process's peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        (OUT_DIR / "workloads_alone.json").write_text(json.dumps(
            {"card": card, "sizes": WL, "workloads": workloads}, indent=1, default=str))
        print(card, flush=True)
        return 0
    sass = host.submit(sass_check)  # cuobjdump on the host, beside the kernel phase
    t = time.monotonic()
    kernels = kernel_phase(dev)
    sass = sass.result()
    sass["f32_body_resources"] = f32_body_resources(log["paged_chunk"]["ptxas"])
    print(f"[time] kernel phase {time.monotonic() - t:.1f}s (cuobjdump beside it)", flush=True)
    t = time.monotonic()
    groups = group_kernel_phase(dev)
    print(f"[time] kernel phase at GQA groups 3 and 7 {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    sharded = sharded_kernel_phase(dev)
    print(f"[time] kernel phase at tp=2 head counts {time.monotonic() - t:.1f}s", flush=True)
    if args.kernels:
        if args.json:
            pathlib.Path(args.json).write_text(json.dumps(
                {"card": card, "build": {k: v["seconds"] for k, v in log.items()},
                 "ptxas": {k: v["ptxas"] for k, v in log.items()},
                 "kernels": {"phase 2": kernels, "phase 7": groups, "phase 18 (a)": sharded}},
                indent=1, default=str))
        print(card, flush=True)
        return 0
    t = time.monotonic()
    cfg = get_config("llama3-8b")
    with torch.inference_mode():
        model = Llama(cfg, init_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"[serve] llama3-8b weights built in {time.monotonic() - t:.1f}s", flush=True)
    serving = {tag: serving_phase(dev, model, quant) for tag, quant in (("bf16", None), ("int8", "int8"))}
    serving["bf16 schedules"] = serving_phase(dev, model, None, SCHEDULES, legacy=serving["bf16"])
    print(f"[time] serving phases {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    tiers = {tag: tier_phase(dev, model, quant) for tag, quant in (("bf16", None), ("int8", "int8"))}
    print(f"[time] tier phases {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    replay = {"f32": replay_f32_phase(dev)}
    replay["decode walls"] = decode_wall_phase(dev, model)
    replay["bf16 http"] = replay_http_phase(dev, model, card)
    print(f"[time] replay and observability phases {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    edge = serving_edge_phase(dev, model)
    print(f"[time] serving edge phase {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    handoff = handoff_phase(dev, model)
    print(f"[time] handoff phase {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    w8a16 = w8a16_phase(dev, model)
    print(f"[time] w8a16 phase {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    head = head_phase(dev, model)
    print(f"[time] LM head phase {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    mesh = mesh_phase(dev, model, shadow["scale"])
    print(f"[time] mesh phase (a)-(c) {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    tree_leg = tree_checkpoint_leg(dev, model)
    print(f"[time] phase 19 (c) tree checkpoint {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    workloads = workload_engine_phase(dev, model, card)
    print(f"[time] phase 20 (a), (b) {time.monotonic() - t:.1f}s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    # The child processes start in pairs, each with its own port and log:
    # a pair needs at most ~35 GiB of the card (the W8A16 quantize peak
    # ~23 GiB beside the text launcher's ~12), the node leg's two nodes
    # ~34 GiB alone, and this process may still hold ~20 GiB.
    print(f"[serve-cli] {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated here", flush=True)
    serve_bf16, serve_int8 = _together(lambda: launcher_phase(), lambda: launcher_phase("int8"))
    serve_cli = {"bf16": serve_bf16, "int8": serve_int8}
    print(f"[time] serve launcher phases (bf16 and int8 together) {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    w8a16["serve_cli"], serve_text = _together(lambda: launcher_phase(weight_quant="int8"), launcher_text_phase)
    print(f"[time] w8a16 serve launcher and the text launcher together {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    node = mesh["node"] = mesh_node_leg(MESH["node_model"], MESH["node_slots"])
    print(f"[mesh node] two launch.py node processes (prefill, decode) over native tcp: /healthz after "
          f"{node['ready_s']:.1f}s; /generate {node['generate_s']:.3f}s; decode node oplogs received "
          f"{node['oplogs_received']}; its digest of the prefill node fingerprint "
          f"{node['decode_view_of_prefill']['fingerprint']} == the prefill node's own; prefill node kernels "
          f"{node['kernels']}; leg wall {node['wall_s']:.1f}s", flush=True)
    print(f"[time] mesh node leg (d) {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    fleet = fleet_phase(card)
    print(f"[time] fleet phase {time.monotonic() - t:.1f}s", flush=True)
    t = time.monotonic()
    # Phase 18's ranks run beside the phases below (Qwen2-7B serving, the
    # checkpoint round trip, the whole-path checks: this process holds at
    # most ~20 GiB more meanwhile), which keeps the script inside its limit.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[parallel] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated here as phase 18 starts",
          flush=True)
    par_handle = parallel_phase_start(fleet=True)
    try:
        t_q = time.monotonic()
        par_handle["marks"].append(["qwen2-7b serving", time.time()])
        qwen = qwen2_serving_phase(dev)
        print(f"[time] qwen2-7b serving phase {time.monotonic() - t_q:.1f}s", flush=True)
        t_q = time.monotonic()
        par_handle["marks"].append(["checkpoint", time.time()])
        ckpt = checkpoint_phase(dev)
        print(f"[time] checkpoint phase {time.monotonic() - t_q:.1f}s", flush=True)
        t_q = time.monotonic()
        par_handle["marks"].append(["whole-path checks", time.time()])
        whole = {tag: whole_path_check(dev, quant, sched, tiered, name) for tag, quant, sched, tiered, name in
                 (("float32", None, None, False, "llama3-8b"), ("int8", "int8", None, False, "llama3-8b"),
                  ("float32 schedules", None, SCHEDULES, False, "llama3-8b"),
                  ("float32 tiers", None, None, True, "llama3-8b"),
                  ("qwen2-7b float32", None, None, False, "qwen2-7b"))}
        _whole_path_params.cache_clear()
        _release(dev)  # the cached blocks back to the card: (h)'s ranks train beside this process
        print(f"[time] whole-path checks {time.monotonic() - t_q:.1f}s (phase 18 beside them)", flush=True)
        # Phase 20 (d)-(h) runs while (h)'s ranks train (their gate open),
        # and phase 21 (k)-(m) in a process of its own beside them.
        par = parallel_phase_finish(par_handle, beside=lambda: workload_scenario_phase(dev, card))
        workloads.update(par.pop("beside"))
        workloads.update(par.pop("fleet"))
        workloads["benchdiff"] = benchdiff_phase()
    finally:
        parallel_phase_stop(par_handle)
    print(f"[time] phase 18 (b)-(h) {par['wall_s']:.1f}s from its start; both together "
          f"{time.monotonic() - t:.1f}s", flush=True)
    _release(dev)
    t = time.monotonic()
    train = train_phase(dev, par, tree_leg)
    print(f"[time] phase 19 training and checkpoints {time.monotonic() - t:.1f}s", flush=True)

    # Launches of each kernel entry on each path that ran it (counts zeroed
    # just before each path and read just after); ``launches`` sums them.
    by_path = {
        "paged_decode_fused": {**{f"serving {k}": v["launches"]["paged_decode_fused"]
                                  for k, v in serving.items() if "paged_decode_fused" in v["launches"]},
                               "tiers bf16": tiers["bf16"]["launches"]["paged_decode_fused"],
                               "replay bf16 http": replay["bf16 http"]["launches"]["paged_decode_fused"],
                               "serving edge": edge["launches"]["paged_decode_fused"],
                               "disagg decode bf16": sum(r["decode_launches"]["b1"]
                                                         for r in handoff["transports"].values()),
                               "disagg decode int8->bf16": handoff["int8"]["int8->bf16"]["decode_launches"]["b1"],
                               "w8a16 serving": w8a16["launches"]["b1"],
                               **{f"mesh {proto} {n}": leg["launches"][n]["b1"]
                                  for proto, leg in mesh["legs"].items() for n in ("p0", "d0")},
                               "mesh node prefill": node["kernels"]["paged_decode_fused_kernel"],
                               "fleet p0": fleet["kernels"]["p0"]["b1"], "fleet d0": fleet["kernels"]["d0"]["b1"]},
        "paged_decode_fused[int8]": {"serving int8": serving["int8"]["launches"]["paged_decode_fused[int8]"],
                                     "tiers int8": tiers["int8"]["launches"]["paged_decode_fused[int8]"],
                                     "disagg decode int8":
                                         handoff["int8"]["int8->int8"]["decode_launches"]["b1_int8"]},
        "paged_chunk_attention": {**{f"serving {k}": v["launches"]["paged_chunk_attention"]
                                     for k, v in serving.items() if "paged_chunk_attention" in v["launches"]},
                                  "tiers bf16": tiers["bf16"]["launches"]["paged_chunk_attention"],
                                  "replay bf16 http": replay["bf16 http"]["launches"]["paged_chunk_attention"],
                                  "serving edge": edge["launches"]["paged_chunk_attention"],
                                  "disagg prefill bf16": sum(r["prefill_launches"]["b2"]
                                                             for r in handoff["transports"].values()),
                                  "w8a16 serving": w8a16["launches"]["b2"],
                                  **{f"mesh {proto} {n}": leg["launches"][n]["b2"]
                                     for proto, leg in mesh["legs"].items() for n in ("p0", "d0")},
                                  "mesh node prefill": node["kernels"]["paged_chunk_attention_kernel"],
                                  "fleet p0": fleet["kernels"]["p0"]["b2"], "fleet d0": fleet["kernels"]["d0"]["b2"]},
        "paged_chunk_attention[int8]": {
            "serving int8": serving["int8"]["launches"]["paged_chunk_attention[int8]"],
            "tiers int8": tiers["int8"]["launches"]["paged_chunk_attention[int8]"],
            "disagg prefill int8": sum(leg["prefill_launches"]["b2_int8"] for leg in handoff["int8"].values())},
        "paged_chunk_attention[f32]": {**{f"whole path {k}": w["launches"]["chunk_cuda_core_body"]
                                          for k, w in whole.items() if not k.startswith("qwen2")},
                                       "replay f32": replay["f32"]["launches"]["chunk_cuda_core_body"],
                                       **{f"mesh f32 {n}": c["f32_body"]
                                          for n, c in mesh["f32"]["launches"].items()}},
        "paged_attention_pool": {"pool path bf16": serving["bf16"]["pool_path"]["launches"]},
        "paged_attention_pool[int8]": {"pool path int8": serving["int8"]["pool_path"]["launches"]},
    }
    # Phase 18: each rank's launches on its legs (a rank is a process of
    # its own, its counts zeroed before each leg and read after it); the tp
    # legs' paths are named "tp2 ...", (e)'s pipeline stages' "pp ...".
    def par_paths(int8, key):
        return {f"{tag if tag.startswith('pp') else 'tp2 ' + tag} rank{r['rank']}": leg[key]
                for r in par["ranks"] for tag, leg in r["legs"].items() if ("int8" in tag) == int8}

    by_path["paged_decode_fused"].update(par_paths(False, "b1"))
    by_path["paged_decode_fused[int8]"].update(par_paths(True, "b1"))
    by_path["paged_chunk_attention"].update(par_paths(False, "b2"))
    by_path["paged_chunk_attention[int8]"].update(par_paths(True, "b2"))
    by_path["paged_chunk_attention[f32]"].update(
        {f"{p} f32 rank{r['rank']}": r[k]["paged_chunk_attention_kernel[f32 body]"]
         for r in par["ranks"] for p, k in (("tp2", "f32_counts"), ("pp", "pp_f32_counts"))})
    by_path["paged_attention_pool"].update(
        {f"tp2 pool path rank{r['rank']}": r["pool_path"]["launches"] for r in par["ranks"]})
    # (g): each rank's launches over its tier runs, by mesh and pool kind.
    for r in par["ranks"]:
        for mtag, c in r["tiers"]["launches"].items():
            pfx = "tp2" if mtag == "tp=2" else "pp"
            for sfx, q in (("", "bf16"), ("[int8]", "int8")):
                by_path["paged_decode_fused" + sfx][f"{pfx} tiers {q} rank{r['rank']}"] = \
                    c["paged_decode_fused_kernel" + sfx]
                by_path["paged_chunk_attention" + sfx][f"{pfx} tiers {q} rank{r['rank']}"] = \
                    c["paged_chunk_attention_kernel" + sfx]
    # Phases 20 and 21: each workload leg's launches, the soak's too (B1
    # with float32 queries in (e); B3 in (e)'s crossover sweep alone).
    for key, label in (("a", "(a) north star"), ("b", "(b) overload"), ("d spec", "(d) spec"),
                       ("e convoy", "(e) convoy float32"), ("f kvflow", "(f) kvflow"), ("g tier", "(g) tier"),
                       ("h doctor", "(h) doctor"), ("soak", "soak"), ("k obs steps", "(k) obs steps"),
                       ("l blackbox", "(l) blackbox"), ("m agg", "(m) agg")):
        n = workloads[key]["launches"]
        by_path["paged_decode_fused"][f"workloads {label}"] = n["b1"]
        if key == "e convoy":
            by_path["paged_chunk_attention[f32]"][f"workloads {label}"] = n["b2_f32"]
            by_path["paged_attention_pool"]["workloads (e) crossover sweep"] = n["b3"]
        else:
            by_path["paged_chunk_attention"][f"workloads {label}"] = n["b2"]
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    # The chunk kernel's launches by chunk length C on each in-process path
    # (both pool kinds): launches x (time - bound) by shape.
    chunk_by_c = {**{f"serving {k}": v["chunk_by_c"] for k, v in serving.items()},
                  **{f"tiers {k}": v["chunk_by_c"] for k, v in tiers.items()},
                  "replay bf16 http": replay["bf16 http"]["chunk_by_c"],
                  "serving edge": edge["chunk_by_c"]}
    print("[kernels] chunk kernel launches by C, per path: " + json.dumps(chunk_by_c), flush=True)
    csrc = "radixmesh_tpu_torch/ops/csrc/"
    jax_src = "radixmesh_tpu/ops/paged_attention.py:"
    # name: (source, replaces, the kernel-phase case of the entry, its dtype)
    meta = {
        "paged_decode_fused": (csrc + "paged_decode.cu", jax_src + "1246",
                               "decode B=8 ragged", "bfloat16"),
        "paged_decode_fused[int8]": (csrc + "paged_decode.cu", jax_src + "1246",
                                     "decode B=8 ragged int8", "int8"),
        "paged_chunk_attention": (csrc + "paged_chunk_tc.cu", jax_src + "1550",
                                  "chunk B=8 ragged", "bfloat16"),
        "paged_chunk_attention[int8]": (csrc + "paged_chunk_tc.cu", jax_src + "1550",
                                        "chunk B=8 ragged int8", "int8"),
        "paged_chunk_attention[f32]": (csrc + "paged_chunk.cu", jax_src + "1550",
                                       "chunk B=8 ragged", "float32"),
        "paged_attention_pool": (csrc + "paged_pool.cu", jax_src + "912",
                                 "pool B=8 ragged", "bfloat16"),
        "paged_attention_pool[int8]": (csrc + "paged_pool.cu", jax_src + "912",
                                       "pool B=8 ragged int8", "int8"),
    }
    summary_keys = ("case", "ms", "ms_readings", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                    "row_rel_err", "cblk", "us_per_query_row", "shape")
    # The GQA groups 7 (Qwen2-7B) and 3 (llama3.2-3b): each entry's main
    # row is its G case of the group kernel phase, its launches those of
    # the path that served that group; its other shapes are the group's
    # other timed cases (int8, verify, mixed; for B2 also the G 4 and G 8
    # yardsticks over 4 kv heads, for B3 also G 3).
    group_meta = {
        "paged_decode_fused G=7": ("paged_decode_fused", "decode B=8 ragged G=7", "bfloat16",
                                   {"serving qwen2-7b": qwen["launches"]["paged_decode_fused"]}, ("G=7",)),
        "paged_chunk_attention G=7": ("paged_chunk_attention", "chunk B=8 ragged G=7", "bfloat16",
                                      {"serving qwen2-7b": qwen["launches"]["paged_chunk_attention"]},
                                      ("G=7", "Hkv=4")),
        "paged_attention_pool G=7": ("paged_attention_pool", "pool B=8 ragged G=7", "bfloat16",
                                     {"pool path qwen2-7b": qwen["pool_path"]["launches"]}, ("G=7", "G=3")),
        "paged_chunk_attention[f32] G=7": ("paged_chunk_attention[f32]", "chunk B=8 ragged G=7", "float32",
                                           {"whole path qwen2-7b float32":
                                            whole["qwen2-7b float32"]["launches"]["chunk_cuda_core_body"]},
                                           ("G=7", "G=3")),
        "paged_decode_fused G=3": ("paged_decode_fused", "decode B=8 ragged G=3", "bfloat16",
                                   {"serve text llama3.2-3b": serve_text["kernels"]["paged_decode_fused_kernel"]},
                                   ("G=3",)),
        "paged_chunk_attention G=3": ("paged_chunk_attention", "chunk B=8 ragged G=3", "bfloat16",
                                      {"serve text llama3.2-3b":
                                       serve_text["kernels"]["paged_chunk_attention_kernel"]}, ("G=3",)),
    }
    # The kernels at a tp = 2 rank's head counts and at a pp = 2 stage's
    # microbatch (phase 18 (a)): each entry's main row is its Llama-3-8B
    # case, its launches phase 18's ranks' of that kernel on the tp or the
    # pp legs; a tp entry's other shapes are the Qwen2-7B and int8 cases.
    tp_tag = next(iter(PAR_HEADS))
    for name, kernel, case, dtype, paths in (
            ("paged_decode_fused tp=2", "paged_decode_fused", f"decode B=8 ragged {tp_tag}", "bfloat16", "tp2 "),
            ("paged_chunk_attention tp=2", "paged_chunk_attention", f"chunk B=8 ragged {tp_tag}", "bfloat16",
             "tp2 "),
            ("paged_chunk_attention[f32] tp=2", "paged_chunk_attention[f32]", f"chunk B=8 ragged {tp_tag}",
             "float32", "tp2 "),
            ("paged_attention_pool tp=2", "paged_attention_pool", f"pool B=8 ragged {tp_tag}", "bfloat16", "tp2 "),
            ("paged_decode_fused pp=2", "paged_decode_fused", "decode B=4 pp=2 microbatch", "bfloat16", "pp "),
            ("paged_chunk_attention pp=2", "paged_chunk_attention", "chunk B=4 pp=2 microbatch", "bfloat16",
             "pp ")):
        rows = [r for k in (kernel, kernel + "[int8]") for r in sharded.get(k, [])
                if ("pp=2" in r["case"]) == (paths == "pp ")]
        main_row = [r for r in rows if r["case"] == case and r["dtype"] == dtype][0]
        meta[name] = (meta[kernel][0], meta[kernel][1], case, dtype)
        group_meta[name] = None
        kernels[name] = [main_row] + [r for r in rows if r is not main_row and "ms" in r]
        by_path[name] = {k: v for k2 in (kernel, kernel + "[int8]") for k, v in by_path.get(k2, {}).items()
                         if k.startswith(paths)}
        launches[name] = sum(by_path[name].values())
    for name, spec in group_meta.items():
        if spec is None:
            continue
        kernel, case, dtype, paths, tags = spec
        rows = [r for k in (kernel, kernel + "[int8]") for r in groups.get(k, []) if "ms" in r]
        main_row = [r for r in rows if r["case"] == case and r["dtype"] == dtype][0]
        source, replaces = meta[kernel][:2]
        meta[name] = (source, replaces, case, dtype)
        kernels[name] = [main_row] + [r for r in rows if r is not main_row and any(t in r["case"] for t in tags)]
        by_path[name] = paths
        launches[name] = sum(paths.values())
    entries = []
    for name, (source, replaces, case, dtype) in meta.items():
        main_row = [r for r in kernels[name]
                    if r["case"] == case and r["dtype"] == dtype and "ms" in r][0]
        # The entry's other timed cases: the fast schedules' shapes (verify
        # and mixed-wave chunks, decode over a compact sub-pool), the
        # serving shapes and 4-token pages; a group entry's other cases at
        # its group; every timed case of the CUDA-core chunk body (float32
        # and int8 pools).
        shapes = [{k: r.get(k) for k in summary_keys}
                  for r in kernels[name] if "ms" in r and r is not main_row
                  and (name in group_meta or "[f32]" in name or r["dtype"] == dtype
                       and any(w in r["case"] for w in ("verify", "mixed", "compact", "4x600", "8x2000",
                                                        "page=")))]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": by_path[name],
            **({"launches_by_c": chunk_by_c} if name.startswith("paged_chunk_attention")
               and "[f32]" not in name and " G=" not in name else {}),
            "max_abs_err": main_row["max_abs_err"],
            "max_abs_diff": main_row["max_abs_err"],
            "row_rel_err": main_row.get("row_rel_err"),
            "ms": main_row["ms"],
            "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"],
            "other_shapes": shapes,
        })
    check(all(e["launches"] > 0 for e in entries),
          "a kernel entry was not launched on its main path: "
          + str({e["name"]: e["launches_by_path"] for e in entries if not e["launches"] > 0}))
    for name in group_meta:  # group rows stay under ``groups`` in the report
        del kernels[name]
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build": {k: v["seconds"] for k, v in log.items()}, "sass": sass, "kernels": kernels,
              "groups": groups, "serving": serving, "tiers": tiers, "serve_cli": serve_cli,
              "qwen2_serving": qwen, "checkpoint": ckpt, "serve_text": serve_text, "whole_path": whole,
              "replay": replay, "serving_edge": edge, "handoff": handoff, "w8a16": w8a16,
              "head": head, "mesh": mesh, "fleet": fleet, "sharded_kernels": sharded, "parallel": par,
              "train": train, "workloads": workloads}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
