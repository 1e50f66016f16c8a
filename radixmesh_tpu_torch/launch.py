"""Launcher for the PyTorch/CUDA port.

    python -m radixmesh_tpu_torch.launch serve --model llama3-8b --device cuda
    python -m radixmesh_tpu_torch.launch serve --model llama3-8b --kv-quant int8
    python -m radixmesh_tpu_torch.launch serve --model llama3-8b --weight-quant int8
    python -m radixmesh_tpu_torch.launch serve --spec-decode-tokens 4 \
        --prefill-inline-budget 64 --decode-steps-per-launch 4 --paged-min-batch 2
    python -m radixmesh_tpu_torch.launch serve --host-cache-slots 32768 \
        --kv-transfer-async --kv-tier-dir /var/tmp/kv-tier
    python -m radixmesh_tpu_torch.launch serve --model qwen2-7b \
        --weights /ckpt/Qwen2-7B --tokenizer /ckpt/Qwen2-7B
    python -m radixmesh_tpu_torch.launch serve --model llama3.2-3b \
        --weights /ckpt/llama3.2-3b --tokenizer byte
    python -m radixmesh_tpu_torch.launch serve --stream-publish 16 \
        --step-accounting --profile-dir /var/tmp/prof --trace-sample 0.1
    python -m radixmesh_tpu_torch.launch serve --slo --slo-ttft-ms 1500 \
        --slo-tenant gold=3 --slo-tenant free=1:2000 --blackbox-dir /var/tmp/bb
    python -m radixmesh_tpu_torch.launch node --config-file prefill0.json \
        --fleet-digest-interval 0.5 --replication-factor 2

``serve`` builds one :class:`~radixmesh_tpu_torch.engine.engine.Engine`
behind a :class:`~radixmesh_tpu_torch.server.http_frontend.ServingFrontend`
and serves until SIGINT/SIGTERM. Its weights come from ``--weights``, a
local HF checkpoint directory (safetensors, one file or shards with an
index; ``models/hf_io.py``) whose shapes must match ``--model``, or else
are random from ``--seed``. ``--tokenizer`` (``byte``, or a local HF
tokenizer directory, which needs ``transformers``) lets requests send
``text``. The device defaults to CUDA and the launcher
exits with an error where torch has none; ``--device cpu`` runs the plain
PyTorch path. ``--kv-quant int8`` stores the KV pool as int8 with per-token
scales; ``--weight-quant int8`` serves W8A16 weights (``ops/wquant.py``). The schedule flags (``--decode-steps-per-launch``,
``--prefill-inline-budget``, ``--prefill-inline-max-defer``,
``--paged-min-batch``, ``--spec-decode-tokens``, ``--spec-adaptive``) take
the JAX launcher's defaults, which run the legacy schedule. The tier flags
(``--host-cache-slots``, ``--kv-transfer-async``, ``--kv-transfer-chunk``,
``--kv-transfer-min-restore``, ``--kv-tier-dir``, ``--kv-tier-capacity-gb``)
add a pinned host-RAM tier, the async KV-movement plane and a durable disk
tier, as the JAX launcher does. ``--stream-publish N`` publishes a request's
grown prefix every N tokens (crash recovery). The observability flags are
the JAX launcher's: ``--trace-capacity``, ``--trace-sample`` and
``--trace-dir`` (the flight recorder, dumped under the directory on exit),
``--token-timeline-capacity`` and ``--token-stall-threshold-ms`` (the token
timeline), ``--step-accounting`` and ``--peak-tflops`` (per-wave MFU; the
peak defaults to the card's) and ``--profile-dir`` (``/profile``
captures). ``--slo``, ``--slo-ttft-ms`` and ``--slo-tenant NAME=W[:RATE]``
put the overload control plane in the admission path (``slo/``; any of the
three turns it on). ``--telemetry-history-interval`` (default 1.0 s; 0
disables) samples the telemetry history, ``--blackbox-dir`` arms the black
box (a history segment at every sample, a final dump at shutdown and on
``POST /admin/blackbox``) and ``--blackbox-watchdog`` sets its stall
watchdog (default 10 intervals with a dump directory). Flags of the JAX
launcher whose features are not ported yet are refused by name.

``node`` runs one node of the cache mesh from a config file (YAML, or JSON
where PyYAML is not installed; ``config.load_config``), the JAX launcher's
``node``. A prefill or decode node whose config has a ``model:`` section is
a serving node: an :class:`Engine` with ``mesh=`` an advertisement-only
:class:`~radixmesh_tpu_torch.cache.mesh_cache.MeshCache`, behind a
``ServingFrontend`` on the cache port plus ``serve_port_offset``. Its
``model:`` keys are the JAX launcher's (``preset``, ``overrides``,
``page_size``, ``kv_slots``, ``max_batch``, ``seed``, the schedule, tier
and quantization keys). A prefill or decode node without one is a cache
node whose mesh owns a pool. ``--fleet-digest-interval`` gossips the
node's fleet digest, ``--replication-factor``, ``--router-nodes`` and
``--rebalance-interval`` override the config before it is validated, and
``--chaos-plan`` arms fault injection on every transport the node opens.
A router node (``local_addr`` in ``router_nodes``) runs a
:class:`~radixmesh_tpu_torch.router.cache_aware_router.CacheAwareRouter`
behind a :class:`~radixmesh_tpu_torch.server.http_frontend.RouterFrontend`
(``POST /route``) on ``--http-port``, with ``--warm-up``,
``--health-aware-routing`` and ``--kv-prefetch-hints``; with
``--agg-interval`` (or the config's ``agg_interval_s``) it hosts the fleet
aggregator, pulling every ring node's serving ``/debug/timeseries`` into
the store behind ``/cluster/{timeseries,slo}`` and the doctor's fleet
rules.
``--repair-interval`` (or the config's ``repair_interval_s``) arms the
anti-entropy repair plane on every role (routers probe and pull, never
push). Every non-router node arms the lifecycle plane: with a repair plane
and digests it joins BOOTSTRAPPING (a warm join from a donor) before it
goes ACTIVE, and ``POST /admin/drain`` or SIGTERM/SIGINT drain it
(``--drain-timeout``, default 30 s) and announce LEAVE before it exits.
The KV-transfer, trace and history flags are ``serve``'s; a cache node
without a model honours ``--blackbox-dir`` too (a history of its mesh and a
black box whose doctor judges it). The flags in ``_NOT_PORTED_NODE`` (none
is left) are refused by name with the ROADMAP.md queue item that brings
them.

    python -m radixmesh_tpu_torch.launch node --config-file router0.json --http-port 8100 \
        --fleet-digest-interval 0.5 --repair-interval 1.0 --agg-interval 2

``multihost-dryrun`` joins one ``torch.distributed`` job and runs ONE sharded
train step (``parallel/train.run_dryrun_train_step``) over the global mesh,
printing the JAX launcher's line (``multihost-dryrun: proc i/n devices L
local / G global mesh={...} loss=...``). The port runs one process per
device, so ``--local-devices`` is the number of ranks per host (the JAX
launcher's virtual devices per process), and ``--backend`` is required:
``init_multihost`` never picks one silently (``nccl`` where each rank has a
card of its own, ``gloo`` on the CPU or for ranks that share a card).
``--mesh DP,SP,TP`` pins the plan (default: the host-aligned
``global_mesh`` plan). Every process of the job runs the same command with
its own ``--process-id``:

    python -m radixmesh_tpu_torch.launch multihost-dryrun --coordinator 127.0.0.1:29500 \
        --num-processes 4 --process-id 0 --local-devices 4 --mesh 1,2,2 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

__all__ = ["main", "parse_args"]

# ``serve`` flags of the JAX launcher whose features are not ported yet
# (none since ``--weight-quant``; the check stays for the next one).
_NOT_PORTED_FLAGS: tuple[str, ...] = ()

# ``node`` flags of the JAX launcher whose features are not ported yet,
# with the ROADMAP.md queue item that brings each (none since
# ``--agg-interval``; the check stays for the next one).
_NOT_PORTED_NODE: dict[str, str] = {}


def _configure_tracing(args: argparse.Namespace, node: str = "") -> None:
    """Enable the flight recorder when asked: ``--trace-sample`` gates
    recording; ``--trace-dir`` with the sample unset implies 1.0, but an
    explicit ``--trace-sample 0`` wins."""
    sample = args.trace_sample
    if sample is None:
        sample = 1.0 if args.trace_dir else 0.0
    if sample > 0:
        from radixmesh_tpu_torch.obs.trace_plane import configure

        configure(capacity=args.trace_capacity, sample=sample, node=node)


def _dump_trace(args: argparse.Namespace, log) -> None:
    """Exit-time flight-recorder dump: one Chrome trace-event file under
    ``--trace-dir`` (nothing when tracing is off)."""
    if not args.trace_dir:
        return
    import os
    import time

    from radixmesh_tpu_torch.obs.trace_plane import get_recorder, write_trace

    if not get_recorder().enabled:
        return
    try:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, f"trace-{int(time.time())}.json")
        log.info("wrote %d trace spans to %s", write_trace(path), path)
    except OSError:
        log.exception("trace dump failed")


def _slo_config(args: argparse.Namespace):
    """The :class:`SLOConfig` of ``--slo``/``--slo-ttft-ms``/``--slo-tenant``
    (None when none is given), parsed as the JAX launcher parses them."""
    if not (args.slo or args.slo_ttft_ms is not None or args.slo_tenant):
        return None
    from radixmesh_tpu_torch.slo import SLOConfig, TenantConfig

    tenants = {}
    for spec in args.slo_tenant:
        # NAME=WEIGHT[:RATE_TOKENS_PER_S]
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise SystemExit(f"--slo-tenant {spec!r}: want NAME=W[:RATE]")
        weight, _, rate = rest.partition(":")
        tenants[name] = TenantConfig(
            weight=float(weight), rate_tokens_per_s=float(rate) if rate else 0.0
        )
    return SLOConfig(
        tenants=tenants,
        default_ttft_slo_s=args.slo_ttft_ms / 1e3 if args.slo_ttft_ms is not None else None,
    )


def _history_kwargs(args: argparse.Namespace, log) -> dict:
    """Frontend kwargs of the telemetry history and the black box. The
    watchdog arms at 10x the sample interval whenever a dump directory is
    given, so an unclean death leaves a final without a flag."""
    interval = args.telemetry_history_interval
    watchdog = args.blackbox_watchdog
    if watchdog is None:
        watchdog = 10.0 * interval if args.blackbox_dir else 0.0
    if args.blackbox_dir and interval <= 0:
        log.warning(
            "--blackbox-dir %s is armed but --telemetry-history-interval is 0: no history "
            "is recorded, no segments are written and the watchdog stays off; only "
            "shutdown and POST /admin/blackbox leave a dump", args.blackbox_dir,
        )
    return {
        "history_interval_s": interval,
        "blackbox_dir": args.blackbox_dir,
        "blackbox_watchdog_s": watchdog,
    }


def _run_serve(args: argparse.Namespace) -> int:
    import torch

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models import get_config, init_params
    from radixmesh_tpu_torch.server.http_frontend import ServingFrontend
    from radixmesh_tpu_torch.utils.device import resolve_device
    from radixmesh_tpu_torch.utils.logging import configure_logger, get_logger

    configure_logger("serve")
    log = get_logger("launch")
    device = resolve_device(args.device)
    _configure_tracing(args, node="serve")
    if device.type == "cuda":
        from radixmesh_tpu_torch.ops._build import build_all

        # Build every kernel library now, in parallel, rather than one by
        # one inside the first requests.
        log.info("building the CUDA kernels ...")
        build_all()
    tokenizer = None
    if args.tokenizer:
        from radixmesh_tpu_torch.server.tokenizer import load_tokenizer

        # Before the weights: a tokenizer that cannot load fails at once.
        tokenizer = load_tokenizer(args.tokenizer)
    cfg = get_config(args.model)
    log.info("initializing %s (%d layers) on %s ...", args.model, cfg.n_layers, device)
    with torch.inference_mode():
        if args.weights:
            from radixmesh_tpu_torch.models.hf_io import load_hf_checkpoint

            log.info("loading HF checkpoint from %s", args.weights)
            params = load_hf_checkpoint(args.weights, cfg, device)
        else:
            params = init_params(cfg, seed=args.seed, device=device)
        if args.weight_quant:
            from radixmesh_tpu_torch.ops.wquant import quantize_params

            # Here, so that the full-precision tree is dropped before the
            # engine is built (the engine passes an int8 tree through).
            params = quantize_params(params)
    engine = Engine(
        cfg,
        params,
        num_slots=args.kv_slots,
        page_size=args.page_size,
        max_batch=args.max_batch,
        rng_seed=args.seed,
        decode_steps_per_launch=args.decode_steps_per_launch,
        prefill_inline_budget=args.prefill_inline_budget,
        prefill_inline_max_defer=args.prefill_inline_max_defer,
        paged_min_batch=args.paged_min_batch,
        spec_decode_tokens=args.spec_decode_tokens,
        spec_adaptive=args.spec_adaptive,
        device=device,
        kv_quant=args.kv_quant,
        host_cache_slots=args.host_cache_slots,
        kv_transfer_async=args.kv_transfer_async,
        kv_transfer_chunk_tokens=args.kv_transfer_chunk or 512,
        kv_transfer_min_restore_tokens=args.kv_transfer_min_restore or 0,
        kv_tier_dir=args.kv_tier_dir,
        kv_tier_capacity_bytes=(
            int(args.kv_tier_capacity_gb * (1 << 30))
            if args.kv_tier_capacity_gb is not None
            else 1 << 30
        ),
        name="serve",
        stream_publish_tokens=args.stream_publish or 0,
        token_timeline_capacity=args.token_timeline_capacity,
        token_stall_threshold_s=args.token_stall_threshold_ms / 1e3,
        step_accounting=args.step_accounting,
        peak_tflops=args.peak_tflops,
        weight_quant=args.weight_quant,
    )
    slo = _slo_config(args)
    if slo is not None:
        log.info("SLO control plane enabled (%d tenants)", len(slo.tenants))
    frontend = ServingFrontend(engine, host=args.host, port=args.http_port, tokenizer=tokenizer,
                               profile_dir=args.profile_dir, slo=slo,
                               **_history_kwargs(args, log))
    print(f"serving {args.model} on http://{args.host}:{frontend.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        frontend.close()
        _dump_trace(args, log)
    return 0


def _add_kv_transfer_args(sub: argparse.ArgumentParser) -> None:
    """The async KV-movement plane's and the disk tier's flags (``serve``
    and ``node``)."""
    sub.add_argument("--kv-transfer-async", action="store_true",
                     help="stage host-tier restores and write-backs off the scheduling thread "
                     "(requests with host-tier prefixes park in RESTORING while decode steps)")
    sub.add_argument("--kv-transfer-chunk", type=int, default=None, metavar="TOKENS",
                     help="restore staging chunk in tokens (default 512)")
    sub.add_argument("--kv-transfer-min-restore", type=int, default=None, metavar="TOKENS",
                     help="restores shorter than this stay synchronous (default 0: always staged)")
    sub.add_argument("--kv-tier-dir", default=None, metavar="DIR",
                     help="durable KV spill tier: checksummed fsynced extent files below the "
                     "host tier (needs --host-cache-slots; arms the async plane); scanned and "
                     "resurrected at boot")
    sub.add_argument("--kv-tier-capacity-gb", type=float, default=None, metavar="GB",
                     help="extent-store disk budget (default 1 GiB); oldest extents drop past it")
    sub.add_argument("--stream-publish", type=int, default=None, metavar="TOKENS",
                     help="publish a request's grown prefix to the tree every N generated tokens "
                     "(crash recovery: bounds a resumed request's cache-hit loss to N tokens; "
                     "default 0 = publish only at finish and preemption)")


def _add_trace_args(sub: argparse.ArgumentParser) -> None:
    """The flight recorder's flags (``serve`` and ``node``)."""
    sub.add_argument("--trace-capacity", type=int, default=8192,
                     help="flight-recorder span bound (drop-oldest past it)")
    sub.add_argument("--trace-sample", type=float, default=None,
                     help="fraction of requests to trace (0 disables, the default; spans on "
                     "GET /debug/trace as Perfetto-loadable JSON)")
    sub.add_argument("--trace-dir", default=None,
                     help="also dump the flight recorder to this directory on exit (implies "
                     "--trace-sample 1.0 unless set explicitly)")


def _add_history_args(sub: argparse.ArgumentParser) -> None:
    """The telemetry history's and the black box's flags (``serve`` and
    ``node``)."""
    sub.add_argument("--telemetry-history-interval", type=float, default=1.0, metavar="SECONDS",
                     help="sample every registered metric family plus the step, goodput and "
                     "SLO planes into bounded in-process rings every N seconds (~15 min "
                     "retained, served on GET /debug/timeseries); 0 disables")
    sub.add_argument("--blackbox-dir", default=None, metavar="DIR",
                     help="arm the black box: a history segment lands here at every sample "
                     "(atomic renames: a kill -9 keeps every completed segment), and shutdown, "
                     "the stall watchdog and POST /admin/blackbox write a full final dump "
                     "(history, waterfalls, spans, state)")
    sub.add_argument("--blackbox-watchdog", type=float, default=None, metavar="SECONDS",
                     help="flush the black box once if the history sampler stalls this long "
                     "(default: 10x the sample interval with --blackbox-dir; 0 disables)")


def _aggregator_peers(cfg, interval: float, log) -> list[tuple[str, str, int]]:
    """The fleet aggregator's peers, derived from the topology: every ring
    node with a serving HTTP address, named as its engine labels its series
    (``prefill0``, ``decode1``) and carrying its rank, which the doctor's
    ``telemetry_gap`` rule needs to consult gossip health."""
    if interval <= 0:
        return []
    peers = []
    for r in range(cfg.num_ring):
        serve = cfg.serve_addr(cfg.addr_of_rank(r))
        if serve is not None:  # a portless inproc address has no HTTP tier
            peers.append((f"{cfg.role_of_rank(r).value}{r}", f"http://{serve}", r))
    if not peers:
        log.warning("--agg-interval %.1fs set but no ring node has an HTTP serving address: "
                    "the fleet aggregator stays off", interval)
    return peers


def _node_engine(cfg, args: argparse.Namespace, mesh, name: str, device, log):
    """The serving node's engine, from the config's ``model:`` section (the
    JAX launcher's keys; flags override the config's tier keys)."""
    import torch

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models import get_config, init_params

    model = cfg.model
    mcfg = get_config(model.get("preset", "llama3-tiny"), **model.get("overrides", {}))
    seed = int(model.get("seed", 0))
    log.info("initializing model %s on %s ...", model.get("preset", "llama3-tiny"), device)
    with torch.inference_mode():
        params = init_params(mcfg, seed=seed, device=device)
    return Engine(
        mcfg,
        params,
        num_slots=int(model.get("kv_slots", cfg.num_kv_slots)),
        page_size=int(model.get("page_size", 16)),
        max_batch=int(model.get("max_batch", 8)),
        rng_seed=seed,
        host_cache_slots=int(model.get("host_cache_slots", 0)),
        decode_steps_per_launch=int(model.get("decode_steps_per_launch", 1)),
        prefill_inline_budget=int(model.get("prefill_inline_budget", 0)),
        prefill_inline_max_defer=int(model.get("prefill_inline_max_defer", 2)),
        paged_min_batch=int(model.get("paged_min_batch", 0)),
        spec_decode_tokens=int(model.get("spec_decode_tokens", 0)),
        spec_adaptive=bool(model.get("spec_adaptive", False)),
        token_timeline_capacity=int(model.get("token_timeline_capacity", 4096)),
        token_stall_threshold_s=float(model.get("token_stall_threshold_s", 0.05)),
        kv_quant=model.get("kv_quant"),
        weight_quant=model.get("weight_quant"),
        device=device,
        mesh=mesh,
        name=name,
        kv_transfer_async=args.kv_transfer_async or cfg.kv_transfer_async,
        kv_transfer_chunk_tokens=(
            args.kv_transfer_chunk if args.kv_transfer_chunk is not None
            else cfg.kv_transfer_chunk_tokens
        ),
        kv_transfer_min_restore_tokens=(
            args.kv_transfer_min_restore if args.kv_transfer_min_restore is not None
            else cfg.kv_transfer_min_restore_tokens
        ),
        stream_publish_tokens=(
            args.stream_publish if args.stream_publish is not None else cfg.stream_publish_tokens
        ),
        kv_tier_dir=args.kv_tier_dir or cfg.kv_tier_dir,
        kv_tier_capacity_bytes=(
            int(args.kv_tier_capacity_gb * (1 << 30)) if args.kv_tier_capacity_gb is not None
            else cfg.kv_tier_capacity_bytes
        ),
        step_accounting=bool(model.get("step_accounting", False)),
        peak_tflops=model.get("peak_tflops"),
    )


def _run_node(args: argparse.Namespace) -> int:
    import json

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import NodeRole, load_config, parse_addr
    from radixmesh_tpu_torch.utils.device import resolve_device
    from radixmesh_tpu_torch.utils.logging import configure_logger, get_logger

    router_override = (
        [a.strip() for a in args.router_nodes.split(",") if a.strip()]
        if args.router_nodes is not None else None
    )
    # The overrides apply before validation, so a router added by flag
    # finds its membership and the rebalance check judges the factor the
    # node runs with.
    cfg = load_config(args.config_file, router_nodes=router_override,
                      replication_factor=args.replication_factor,
                      rebalance_interval_s=args.rebalance_interval)
    role, rank, _ = cfg.local_identity()
    is_router = role is NodeRole.ROUTER
    serving = not is_router and bool(cfg.model)
    label = f"{role.value}@{rank}"
    configure_logger(label)
    log = get_logger("launch")
    # A router touches no device.
    device = None if is_router else resolve_device(args.device)
    _configure_tracing(args, node=label)
    if cfg.replication_factor > 0:
        log.info("prefix-ownership sharding ON (replication factor %d)", cfg.replication_factor)
    chaos_spec = cfg.chaos
    if args.chaos_plan:
        with open(args.chaos_plan) as fh:
            chaos_spec = json.load(fh)
    if chaos_spec:
        from radixmesh_tpu_torch.comm.faults import FaultPlan, install

        # Before the node opens any transport, so every channel passes the
        # seam.
        plan = FaultPlan.from_dict(chaos_spec)
        install(plan)
        log.warning("CHAOS PLAN ARMED (seed=%d, drop_p=%.2f, %d partitions)",
                    plan.seed, plan.drop_p, len(plan.partitions))
    if serving and device.type == "cuda":
        from radixmesh_tpu_torch.ops._build import build_all

        log.info("building the CUDA kernels ...")
        build_all()
    if serving or is_router:
        # A serving node's engine owns slot lifetime, so its replica only
        # advertises; a router's replica holds ranks only.
        node = MeshCache(cfg, pool=None).start()
    else:
        from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool

        # A cache node without a model: the mesh owns the pool.
        model = cfg.model or {}
        pool = PagedKVPool(num_slots=cfg.num_kv_slots, num_layers=int(model.get("n_layers", 1)),
                           num_kv_heads=int(model.get("n_kv_heads", 1)),
                           head_dim=int(model.get("head_dim", 128)), page_size=cfg.page_size,
                           device=device)
        node = MeshCache(cfg, pool=pool).start()
    log.info("node started; waiting for ring verification ...")
    if not node.wait_ready(timeout=args.ready_timeout):
        log.error("startup tick barrier timed out")
        node.close()
        return 1
    log.info("ring verified (view epoch=%d)", node.view.epoch)

    # The same tokenizer spec on routers and serving nodes, or routed text
    # prefixes do not line up with cached ones.
    tokenizer = None
    tok_spec = args.tokenizer or (cfg.model or {}).get("tokenizer")
    if tok_spec:
        from radixmesh_tpu_torch.server.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(tok_spec)

    engine = frontend = fleet_plane = repair_plane = rebalance_plane = lifecycle_plane = None
    history_plane = blackbox_plane = None
    if is_router:
        from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter
        from radixmesh_tpu_torch.server.http_frontend import RouterFrontend

        router = CacheAwareRouter(node, cfg, health_aware=args.health_aware_routing,
                                  prefetch_hints=args.kv_prefetch_hints)
        router.watch_topology()
        if not args.warm_up:
            router.finish_warm_up()
        host = parse_addr(cfg.local_addr)[0] or "127.0.0.1"
        agg_interval = args.agg_interval if args.agg_interval is not None else cfg.agg_interval_s
        agg_peers = _aggregator_peers(cfg, agg_interval, log)
        frontend = RouterFrontend(router, host=host, port=args.http_port, tokenizer=tokenizer,
                                  aggregator_peers=agg_peers, aggregator_interval_s=agg_interval or 2.0,
                                  **_history_kwargs(args, log))
        print(f"routing {label} on http://{host}:{frontend.port}", flush=True)
        if frontend.aggregator is not None:
            log.info("fleet aggregator ON: pulling %d peer(s) every %.1fs (GET /cluster/timeseries, "
                     "/cluster/slo)", len(agg_peers), agg_interval)
    elif serving:
        from radixmesh_tpu_torch.server.http_frontend import ServingFrontend

        engine = _node_engine(cfg, args, node, f"{role.value}{rank}", device, log)
        if engine.resurrected.get("grafted_nodes"):
            log.info("resurrected %d prefix(es) / %d tokens; re-announced %d",
                     engine.resurrected["grafted_nodes"], engine.resurrected["grafted_tokens"],
                     engine.announce_resurrected())
        if engine.kv_transfer is not None:
            # PREFETCH hints off the wire land in the plane's hint queue.
            node.on_prefetch = engine.kv_transfer.note_hint
            log.info("async KV-movement plane enabled")
        host, port = parse_addr(cfg.local_addr)
        frontend = ServingFrontend(engine, host=host or "127.0.0.1",
                                   port=port + cfg.serve_port_offset, tokenizer=tokenizer,
                                   **_history_kwargs(args, log))
        print(f"serving {label} on http://{host or '127.0.0.1'}:{frontend.port}", flush=True)
    else:
        # A cache node has no HTTP surface, so its dump is the only reader
        # of a history: the sampler runs only when --blackbox-dir arms it.
        hk = _history_kwargs(args, log)
        if hk["blackbox_dir"]:
            from radixmesh_tpu_torch.obs.blackbox import BlackBox
            from radixmesh_tpu_torch.obs.doctor import MeshDoctor
            from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
            from radixmesh_tpu_torch.obs.trace_plane import get_recorder

            if hk["history_interval_s"] > 0:
                history_plane = TelemetryHistory(interval_s=hk["history_interval_s"], mesh=node,
                                                 node=label)
            blackbox_plane = BlackBox(
                hk["blackbox_dir"], history=history_plane,
                doctor=MeshDoctor(mesh=node, history=history_plane), recorder=get_recorder,
                node=label, watchdog_timeout_s=hk["blackbox_watchdog_s"],
            )
            if history_plane is not None:
                # Started after the black box installed its segment hook.
                history_plane.start()
            log.info("black box armed under %s (history every %.1fs)", hk["blackbox_dir"],
                     hk["history_interval_s"])
    digest_interval = (
        args.fleet_digest_interval if args.fleet_digest_interval is not None
        else cfg.digest_interval_s
    )
    if not is_router and digest_interval > 0:
        from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane

        # Routers never originate digests: the master's fan-out fills
        # their view. Started after the lifecycle plane attaches, so the
        # first digest already carries the node's lifecycle state.
        fleet_plane = FleetPlane(
            node, engine=engine, slo=getattr(getattr(frontend, "runner", None), "ctl", None),
            interval_s=digest_interval,
        )
    repair_interval = (
        args.repair_interval if args.repair_interval is not None else cfg.repair_interval_s
    )
    if repair_interval > 0:
        from radixmesh_tpu_torch.cache.repair_plane import RepairConfig, RepairPlane

        # Every role runs one: routers probe and pull, never push.
        repair_plane = RepairPlane(node, RepairConfig(
            interval_s=repair_interval, age_threshold_s=cfg.repair_age_threshold_s,
            key_budget=cfg.repair_key_budget, backoff_base_s=cfg.repair_backoff_s,
            backoff_max_s=max(cfg.repair_backoff_s * 30.0, cfg.repair_backoff_s),
        )).start()
        log.info("anti-entropy repair armed (scan %.1fs, stale after %.1fs)",
                 repair_interval, cfg.repair_age_threshold_s)
    if not is_router and cfg.replication_factor > 0 and cfg.rebalance_interval_s > 0:
        from radixmesh_tpu_torch.cache.rebalance import RebalanceConfig, RebalancePlane

        rebalance_plane = RebalancePlane(
            node, RebalanceConfig(interval_s=cfg.rebalance_interval_s)
        ).start()
        log.info("heat-driven rebalancer armed (tick %.1fs)", cfg.rebalance_interval_s)
    if not is_router:
        from radixmesh_tpu_torch.policy.lifecycle import LifecycleConfig, LifecyclePlane

        # BOOTSTRAPPING → ACTIVE → DRAINING → LEFT. The warm join (bulk
        # repair from a donor while routers withhold hits) needs a repair
        # plane to pull through and digests to see donors; otherwise the
        # node starts ACTIVE. POST /admin/drain and SIGTERM drain through
        # it, and drain step 5c flushes the node's black box.
        lifecycle_plane = LifecyclePlane(
            node, repair=repair_plane, runner=getattr(frontend, "runner", None),
            fleet_plane=fleet_plane, cfg=LifecycleConfig(drain_timeout_s=args.drain_timeout),
            bootstrap=repair_plane is not None and digest_interval > 0,
            blackbox=getattr(frontend, "blackbox", None) or blackbox_plane,
        )
        if frontend is not None:
            frontend.lifecycle = lifecycle_plane
    if fleet_plane is not None:
        fleet_plane.start()
        log.info("fleet digests every %.1fs", digest_interval)
    if lifecycle_plane is not None:
        lifecycle_plane.start()
        log.info("membership lifecycle plane armed (state=%s, drain timeout %.0fs)",
                 lifecycle_plane.state.value, args.drain_timeout)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        if lifecycle_plane is not None:
            # Drain on the way out while the ring still answers: requeue
            # parked work, flush hot prefixes, announce LEAVE. A node
            # drained by POST /admin/drain falls through at once.
            try:
                lifecycle_plane.drain(deadline_s=args.drain_timeout)
            except Exception:  # noqa: BLE001 — a failed drain must not block the exit
                log.exception("exit drain failed")
            lifecycle_plane.close()
        if rebalance_plane is not None:
            rebalance_plane.close()
        if repair_plane is not None:
            repair_plane.close()
        if fleet_plane is not None:
            fleet_plane.close()
        if frontend is not None:
            frontend.close()
        if blackbox_plane is not None:
            blackbox_plane.close(flush_cause="shutdown")
        if history_plane is not None:
            history_plane.close()
        if engine is not None:
            engine.close()
        node.close(graceful=True)
        _dump_trace(args, log)
    return 0


def _run_multihost_dryrun(args: argparse.Namespace) -> int:
    """One sharded train step with every process of the job in one mesh:
    the same step as the in-process dryrun, the collectives across
    processes."""
    import math

    from radixmesh_tpu_torch.parallel import MeshPlan, global_mesh, init_multihost
    from radixmesh_tpu_torch.parallel.train import run_dryrun_train_step
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and args.backend == "nccl":
        device = None  # init_multihost picks this rank's card
    info = init_multihost(args.coordinator, args.num_processes, args.process_id,
                          local_device_count=args.local_devices, backend=args.backend)
    plan = None
    if args.mesh:
        dp, sp, tp = (int(x) for x in args.mesh.split(","))
        plan = MeshPlan(dp=dp, sp=sp, tp=tp)
    mesh = global_mesh(plan)
    loss = run_dryrun_train_step(mesh, device=device)
    print(
        f"multihost-dryrun: proc {info.process_index}/{info.process_count} "
        f"devices {info.local_devices} local / {info.global_devices} global "
        f"mesh={dict(mesh.shape)} loss={loss:.4f}",
        flush=True,
    )
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0 if math.isfinite(loss) else 1


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse the launcher's command line; exits (status 2) on a flag of a
    feature that is not ported yet (``_NOT_PORTED_FLAGS`` for ``serve``,
    ``_NOT_PORTED_NODE`` for ``node``)."""
    parser = argparse.ArgumentParser(prog="radixmesh-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="run a single-node serving engine")
    serve.add_argument("--model", default="llama3-8b")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--http-port", type=int, default=8000)
    serve.add_argument("--kv-slots", type=int, default=65536)
    serve.add_argument("--page-size", type=int, default=16)
    serve.add_argument("--max-batch", type=int, default=8)
    serve.add_argument("--seed", type=int, default=0)
    serve.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    serve.add_argument("--weights", default=None, metavar="DIR",
                       help="local HF checkpoint directory (safetensors) to serve instead of "
                       "random weights")
    serve.add_argument("--tokenizer", default=None, metavar="SPEC",
                       help="'byte', or a local HF tokenizer directory: enables the text field")
    serve.add_argument("--kv-quant", choices=("int8",), default=None,
                       help="store the KV pool as int8 with per-token scales")
    serve.add_argument("--weight-quant", choices=("int8",), default=None,
                       help="W8A16 weights: int8 storage with per-output-channel scales (halves "
                       "the resident weight bytes)")
    serve.add_argument("--decode-steps-per-launch", type=int, default=1,
                       help="fuse k decode steps per launch (sampling on the device)")
    serve.add_argument("--prefill-inline-budget", type=int, default=0,
                       help="mixed waves: ride up to N prefill tokens of queued prompts on each "
                       "decode launch (0 = legacy alternating schedule)")
    serve.add_argument("--prefill-inline-max-defer", type=int, default=2,
                       help="mixed waves' starvation bound: at most N consecutive prefill-only "
                       "waves before a decode-bearing wave")
    serve.add_argument("--paged-min-batch", type=int, default=0,
                       help="decode waves below N rows take the compact working set "
                       "(0 = always paged where the kernel policy allows)")
    serve.add_argument("--spec-decode-tokens", type=int, default=0,
                       help="speculative decode: draft up to N tokens (radix tree, then n-gram) "
                       "and verify them in one chunk launch")
    serve.add_argument("--spec-adaptive", action="store_true",
                       help="adapt the draft width per request class to its acceptance, "
                       "within [1, --spec-decode-tokens]")
    serve.add_argument("--host-cache-slots", type=int, default=0,
                       help="host-RAM KV tier of N token slots (pinned on the card): evicted "
                       "prefixes are written back and restored on a hit")
    _add_kv_transfer_args(serve)
    _add_trace_args(serve)
    serve.add_argument("--token-timeline-capacity", type=int, default=4096,
                       help="per-token ITL ring entries for /debug/tokens (change-compressed, "
                       "drop-oldest; 0 disables the token timeline and the goodput ledger)")
    serve.add_argument("--token-stall-threshold-ms", type=float, default=50.0,
                       help="inter-token gap above which the timeline attributes a stall to a "
                       "cause")
    serve.add_argument("--step-accounting", action="store_true",
                       help="per-wave token and padding accounting with an analytic-FLOPs MFU "
                       "estimate (radixmesh_step_mfu, radixmesh_wave_pad_fraction, /debug/state)")
    serve.add_argument("--peak-tflops", type=float, default=None,
                       help="nominal peak for the MFU estimate (default: the card's dense bf16 "
                       "peak by name; 1.0 on the CPU)")
    serve.add_argument("--profile-dir", default=None,
                       help="enable POST /profile and GET /debug/profile?seconds=N torch.profiler "
                       "captures into this directory")
    serve.add_argument("--slo", action="store_true",
                       help="enable the overload control plane (SLO-aware admission, per-tenant "
                       "fairness, deadline shedding, degradation tiers; slo/)")
    serve.add_argument("--slo-ttft-ms", type=float, default=None,
                       help="default TTFT deadline for requests that carry none (implies --slo)")
    serve.add_argument("--slo-tenant", action="append", default=[], metavar="NAME=W[:RATE]",
                       help="tenant fair-share weight and optional prompt-token rate limit "
                       "(repeatable; implies --slo)")
    _add_history_args(serve)
    serve.set_defaults(fn=_run_serve)

    node = sub.add_parser("node", help="run one cache-mesh node")
    node.add_argument("--config-file", required=True,
                      help="the node's config (YAML, or JSON without PyYAML); every node of a "
                      "cluster shares one config except local_addr")
    node.add_argument("--http-port", type=int, default=0, help="router API port (router role)")
    node.add_argument("--ready-timeout", type=float, default=120.0,
                      help="seconds to wait for the ring's startup barrier")
    node.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    node.add_argument("--tokenizer", default=None, metavar="SPEC",
                      help="'byte' or a local HF tokenizer dir; enables text on this node's API "
                      "(the same spec on every node; overrides model.tokenizer)")
    node.add_argument("--fleet-digest-interval", type=float, default=None, metavar="SECONDS",
                      help="gossip this node's fleet NodeDigest (tree fingerprint, fill, health "
                      "signals) every N seconds as one oplog frame (obs/fleet_plane.py); "
                      "overrides the config's digest_interval_s; 0 disables origination")
    node.add_argument("--replication-factor", type=int, default=None, metavar="RF",
                      help="prefix-ownership sharding (cache/sharding.py): each subtree shard is "
                      "owned by RF consistent-hash successors; identical on every node; 0 = full "
                      "replication")
    node.add_argument("--router-nodes", default=None, metavar="ADDR,ADDR",
                      help="comma-separated router cache addresses replacing the config's "
                      "router_nodes (identical on every node: the rank space is positional)")
    node.add_argument("--rebalance-interval", type=float, default=None, metavar="SECONDS",
                      help="heat-driven shard rebalancing (cache/rebalance.py) every N seconds; "
                      "needs --replication-factor > 0; 0 disables the decider")
    node.add_argument("--chaos-plan", default=None, metavar="FILE",
                      help="arm fault injection from a FaultPlan JSON file (comm/faults.py) on "
                      "every transport this node opens; drills and soak runs only")
    node.add_argument("--warm-up", action="store_true",
                      help="start the router in warm-up (spread) mode")
    node.add_argument("--health-aware-routing", action="store_true",
                      help="router role: demote nodes whose gossiped health score drops below "
                      "0.5 (stall watchdog, replication lag, eviction storm): cache hits shed "
                      "past them and the hash-ring fallback skips them")
    node.add_argument("--agg-interval", type=float, default=None, metavar="SECONDS",
                      help="router role: host the fleet telemetry aggregator (obs/aggregator.py), "
                      "cursor-pulling every ring node's /debug/timeseries at this cadence into one "
                      "node-labeled store served on GET /cluster/timeseries, with true fleet "
                      "percentiles on GET /cluster/slo and the doctor's fleet rules "
                      "(straggler_node, fleet_burn_slope, telemetry_gap); overrides the config's "
                      "agg_interval_s; 0 disables")
    node.add_argument("--kv-prefetch-hints", action="store_true",
                      help="router role: fire an idempotent PREFETCH oplog at the node a cache "
                      "hit routes to, so a host-tier prefix starts restoring before the request "
                      "arrives (cache/kv_transfer.py)")
    node.add_argument("--repair-interval", type=float, default=None, metavar="SECONDS",
                      help="anti-entropy repair scan cadence (cache/repair_plane.py): compare "
                      "this node's tree fingerprint against gossiped digests and open bounded "
                      "repair sessions with stale diverged peers; overrides the config's "
                      "repair_interval_s; 0 disables. Needs --fleet-digest-interval somewhere in "
                      "the fleet")
    node.add_argument("--drain-timeout", type=float, default=30.0, metavar="SECONDS",
                      help="graceful-drain deadline (policy/lifecycle.py): on POST /admin/drain "
                      "or SIGTERM, in-flight decodes get this long to finish while new work is "
                      "shed retriably, parked restores are requeued, hot prefixes are written "
                      "back to the host tier, and the node announces LEAVE")
    _add_kv_transfer_args(node)
    _add_trace_args(node)
    _add_history_args(node)
    node.set_defaults(fn=_run_node)

    mh = sub.add_parser("multihost-dryrun",
                        help="join a torch.distributed job and run ONE sharded train step over the "
                        "global mesh (the multi-process compute proof)")
    mh.add_argument("--coordinator", required=True,
                    help="host:port (or tcp://host:port, file:///path) of the job's rendezvous")
    mh.add_argument("--num-processes", type=int, required=True)
    mh.add_argument("--process-id", type=int, required=True)
    mh.add_argument("--local-devices", type=int, default=None,
                    help="ranks per host (one process is one device; default: every rank on one host)")
    mh.add_argument("--mesh", default=None, metavar="DP,SP,TP",
                    help="explicit global mesh plan (default: host-aligned auto)")
    mh.add_argument("--backend", choices=("nccl", "gloo"), required=True,
                    help="collective backend: nccl (a card per rank) or gloo (CPU, or ranks sharing a card)")
    mh.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    mh.set_defaults(fn=_run_multihost_dryrun)

    argv = sys.argv[1:] if argv is None else argv
    refused = _NOT_PORTED_NODE if argv[:1] == ["node"] else dict.fromkeys(_NOT_PORTED_FLAGS, "A")
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in refused:
            parser.error(
                f"{flag} is not supported by the PyTorch port yet "
                f"(see ROADMAP.md, queue {refused[flag]})"
            )
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
