"""The workloads that drive the port's engine: the synthetic ShareGPT-style
multi-turn traffic, open-loop overload across tenants, and the
self-contained acceptance scenarios of the speculative decoder, the
prefill convoy, the async KV plane, the disk tier and the mesh doctor;
and those of the fleet: telemetry under churn, chaos (loss, partitions, a
drain and a rejoin, a crash, a rebalance, a router kill), the stitched
trace, the black box and fleet aggregation.

The north-star benchmark (``BASELINE.json`` "north_star") targets ≥70%
prefix-cache hit-rate and p50 TTFT < 200 ms on ShareGPT multi-turn
conversations. What makes ShareGPT traffic cache-friendly is its *shape* —
a system prompt shared across conversations plus per-conversation histories
that grow turn by turn, so turn k's prompt is turn k-1's full context plus
a little new text. The generators make exactly that shape,
deterministically, with the JAX package's numpy code: the same seed gives
the same prompts and arrivals in both packages.

Usage::

    wl = MultiTurnWorkload(n_conversations=16, n_turns=4, ...)
    report = run_engine_workload(engine, wl)
    report["hit_rate"], report["p50_ttft_s"]

The scenarios (``run_spec_workload``, ``run_convoy_workload``,
``run_kvflow_workload``, ``run_tier_workload``, ``run_doctor_workload``,
``run_obs_workload``, ``run_blackbox_workload``, ``run_agg_workload``)
build their own engines; ``run_fleet_churn_workload`` and
``run_chaos_workload`` drive an in-process mesh alone. Each runs on CUDA unless ``device="cpu"`` is
passed, and takes ``cfg``, the model configuration its engines serve:
``None`` is the JAX scenario's own toy model. Toy head dims (32) are below
what the CUDA kernels take (64 and 128), so on the card a scenario is given
a model of real widths (``ModelConfig.llama3_8b().replace(n_layers=2)``).
Weights are ``init_params(cfg, seed, device)``: the JAX scheme drawn with
other random numbers, so the tokens generated differ from the JAX run's.
"""

# meshcheck: file-ok[sleep-audit] workload generators and scenario
# drivers pace traffic, settle gossip, and hold chaos windows by wall
# clock BY DESIGN — nothing here runs on a serving thread.

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "MultiTurnWorkload",
    "OverloadWorkload",
    "TextMultiTurnWorkload",
    "run_agg_workload",
    "run_blackbox_workload",
    "run_chaos_workload",
    "run_convoy_workload",
    "run_doctor_workload",
    "run_engine_workload",
    "run_fleet_churn_workload",
    "run_kvflow_workload",
    "run_obs_workload",
    "run_overload_workload",
    "run_spec_workload",
    "run_tier_workload",
    "synth_text",
]

# A small English word stock for deterministic synthetic conversations —
# the TEXT analog of the token-id workload, for runs with a real
# tokenizer in the loop (no dataset is fetchable in this environment;
# what matters for the cache is the ShareGPT *shape*, and for the
# tokenizer that input is realistic prose-like byte sequences, not
# uniform ids).
_WORDS = (
    "the of and to in is that it for on with as are this be at or from "
    "have an they which one you had not but what all were when we there "
    "can more if out so said about up its into than them then some could "
    "time these two may first new now people my made over did down only "
    "way find use work part take place years live back give most very "
    "after things our just name good sentence man think say great where "
    "help through much before line right too means old any same tell boy "
    "follow came want show also around form three small set put end does "
    "another well large must big even such because turn here why ask went "
    "men read need land different home us move try kind hand picture "
    "again change off play spell air away animal house point page letter "
    "mother answer found study still learn should world high every near "
    "add food between own below country plant last school father keep "
    "tree never start city earth eye light thought head under story saw "
    "left few while along might close something seem next hard open "
    "example begin life always those both paper together got group often "
    "run important until children side feet car mile night walk white "
    "sea began grow took river four carry state once book hear stop "
    "without second later miss idea enough eat face watch far really "
    "almost let above girl sometimes mountain cut young talk soon list "
    "song being leave family body music color stand sun question fish "
    "area mark dog horse birds problem complete room knew since ever "
    "piece told usually friends easy heard order red door sure become "
    "top ship across today during short better best however low hours "
    "black products happened whole measure remember early waves reached"
).split()


def synth_text(rng: np.ndarray, n_sentences: int) -> str:
    """Deterministic prose-like text: ``n_sentences`` sentences of 6-14
    stock words, capitalized and period-terminated."""
    out = []
    for _ in range(n_sentences):
        n = int(rng.integers(6, 15))
        words = [_WORDS[int(i)] for i in rng.integers(0, len(_WORDS), n)]
        out.append(words[0].capitalize() + " " + " ".join(words[1:]) + ".")
    return " ".join(out)


@dataclass
class _Conversation:
    conv_id: int
    context: list[int] = field(default_factory=list)  # grows with each turn


class MultiTurnWorkload:
    """Deterministic multi-turn conversations over a token-id vocabulary.

    Every conversation opens with the same ``system_len``-token system
    prefix (cross-conversation sharing); each turn appends fresh user
    tokens to the conversation's accumulated context (within-conversation
    sharing — the dominant ShareGPT pattern)."""

    def __init__(
        self,
        n_conversations: int = 16,
        n_turns: int = 4,
        system_len: int = 32,
        user_len: int = 16,
        gen_len: int = 8,
        vocab_size: int = 512,
        seed: int = 0,
    ):
        self.n_conversations = n_conversations
        self.n_turns = n_turns
        self.gen_len = gen_len
        rng = np.random.default_rng(seed)
        # Token 0 is avoided: engines commonly reserve low ids for specials.
        self.system = rng.integers(1, vocab_size, size=system_len).tolist()
        self._user_turns = [
            [
                rng.integers(1, vocab_size, size=user_len).tolist()
                for _ in range(n_turns)
            ]
            for _ in range(n_conversations)
        ]
        self.conversations = [
            _Conversation(conv_id=i, context=list(self.system))
            for i in range(n_conversations)
        ]

    def round_prompts(self, turn: int) -> list[tuple[_Conversation, list[int]]]:
        """Turn ``turn`` of every conversation: (conversation, full prompt)."""
        out = []
        for conv in self.conversations:
            prompt = conv.context + self._user_turns[conv.conv_id][turn]
            out.append((conv, prompt))
        return out

    def record_reply(self, conv: _Conversation, prompt: list[int], reply: list[int]) -> None:
        conv.context = prompt + reply

    @property
    def max_context_len(self) -> int:
        """Upper bound on final context length (for pool/engine sizing)."""
        per_turn = (
            max(len(t) for turns in self._user_turns for t in turns)
            + self.gen_len
        )
        return len(self.system) + self.n_turns * per_turn


class TextMultiTurnWorkload(MultiTurnWorkload):
    """The multi-turn workload built from TEXT through a real tokenizer
    (``server/tokenizer.py`` in the loop, where the token-id workload
    feeds generated ids). Same interface and cache-shape as
    :class:`MultiTurnWorkload`: one shared system prompt, per-turn fresh
    user text appended to the conversation context."""

    def __init__(
        self,
        tokenizer,
        n_conversations: int = 16,
        n_turns: int = 4,
        system_sentences: int = 8,
        user_sentences: int = 4,
        gen_len: int = 8,
        seed: int = 0,
        system_prefix: str = "You are a helpful assistant. ",
    ):
        self.tokenizer = tokenizer
        self.n_conversations = n_conversations
        self.n_turns = n_turns
        self.gen_len = gen_len
        rng = np.random.default_rng(seed)
        # ``system_prefix`` is part of the cache key space: two workloads
        # share cross-workload prefix hits iff their prefixes tokenize to
        # the same head. Warm-up passes must pass a DISTINCT prefix so a
        # measured run's hit_rate credits only traffic its own ceiling
        # model accounts for (a shared default head lets warm-up reuse
        # inflate reuse_efficiency past its upper bound).
        self.system_text = system_prefix + synth_text(rng, system_sentences)
        self.system = tokenizer.encode(self.system_text)
        self._user_turns = [
            [
                tokenizer.encode(" User: " + synth_text(rng, user_sentences))
                for _ in range(n_turns)
            ]
            for _ in range(n_conversations)
        ]
        self.conversations = [
            _Conversation(conv_id=i, context=list(self.system))
            for i in range(n_conversations)
        ]


def run_engine_workload(
    engine, workload: MultiTurnWorkload, trace_path: str | None = None
) -> dict:
    """Drive the workload through an :class:`Engine` turn-round by
    turn-round (each round's requests run concurrently through the
    continuous batcher, like simultaneous users) and report the
    north-star metrics from the engine's own counters.

    With ``trace_path`` (and the flight recorder enabled — see
    ``obs/trace_plane.configure``), the run's spans are drained into a
    Chrome trace-event artifact next to the numeric report, so every
    bench number comes with the timeline that produced it.

    ``ceiling_hit_rate`` is what an INFINITE, never-evicting cache would
    score on the same traffic (page-aligned like real admission): turn
    k > 0 can reuse at most the conversation's full prior context, turn 0
    at most the shared system prefix. Workload shapes differ wildly in
    how much of their traffic is reusable at all — ``hit_rate /
    ceiling_hit_rate`` (``reuse_efficiency``) is the cache-quality signal
    that is comparable ACROSS shapes.

    Caveat on turn-0-heavy shapes: the ceiling credits every turn-0
    request after the very first with full system-prefix reuse, but all
    of a round's turn-0 requests run concurrently in ONE generate()
    batch, where admission order may publish the system prefix too late
    for siblings in the same wave to reuse it. ``reuse_efficiency`` can
    therefore structurally read < 1 on wide shapes even with a perfect
    cache — it is an upper-bound denominator, not an achievable one."""
    from radixmesh_tpu_torch.engine.request import SamplingParams

    sampling = SamplingParams(
        temperature=0.0, max_new_tokens=workload.gen_len
    )
    page = getattr(engine, "page_size", 1)
    start_prompt = engine.stats.prompt_tokens
    start_cached = engine.stats.cached_tokens
    start_ttft = len(engine.stats.ttft_s)
    ceiling = 0
    total_prompt = 0
    served_system = False
    for turn in range(workload.n_turns):
        pairs = workload.round_prompts(turn)
        for conv, prompt in pairs:
            reusable = len(conv.context) if turn > 0 else (
                len(workload.system) if served_system else 0
            )
            # Admission reuse is page-floored and capped below the full
            # prompt (the final token always recomputes its logits).
            ceiling += min(reusable, len(prompt) - 1) // page * page
            total_prompt += len(prompt)
            served_system = True
        replies = engine.generate([p for _, p in pairs], sampling)
        for (conv, prompt), reply in zip(pairs, replies):
            workload.record_reply(conv, prompt, reply)
    prompt_tokens = engine.stats.prompt_tokens - start_prompt
    cached_tokens = engine.stats.cached_tokens - start_cached
    ttft = engine.stats.ttft_s[start_ttft:]
    hit_rate = cached_tokens / prompt_tokens if prompt_tokens else 0.0
    ceiling_rate = ceiling / total_prompt if total_prompt else 0.0
    trace_extra = {}
    if trace_path is not None:
        from radixmesh_tpu_torch.obs.trace_plane import write_trace

        trace_extra = {
            "trace_artifact": trace_path,
            "trace_spans": write_trace(trace_path),
        }
    return {
        **trace_extra,
        "requests": workload.n_conversations * workload.n_turns,
        "prompt_tokens": prompt_tokens,
        "cached_tokens": cached_tokens,
        "hit_rate": hit_rate,
        "ceiling_hit_rate": ceiling_rate,
        "reuse_efficiency": hit_rate / ceiling_rate if ceiling_rate else 0.0,
        "p50_ttft_s": float(np.median(ttft)) if ttft else 0.0,
        "p99_ttft_s": float(np.quantile(ttft, 0.99)) if ttft else 0.0,
        # The exact per-request samples for this run (preemption retries
        # append extra entries to the engine's global list, so callers
        # must NOT slice that by request count).
        "ttft_s": list(ttft),
    }


class OverloadWorkload:
    """Open-loop multi-tenant overload shape for the SLO control plane
    (``radixmesh_tpu_torch/slo/``): requests ARRIVE on their own clock at
    ``offered_tokens_per_s`` of prompt tokens regardless of how fast the
    engine drains them — the regime where admission control, fairness,
    and shedding are decidable at all (the closed-loop multi-turn shapes
    above can never oversubscribe: each round waits for the last).

    Tenants are drawn weight-proportionally; each tenant's prompts share
    a ``shared_frac`` system head (so the cache sees realistic reuse)
    with fresh per-request tails. Inter-arrival gaps are exponential
    (Poisson process), deterministic under ``seed``."""

    def __init__(
        self,
        tenants: dict[str, float] | None = None,
        duration_s: float = 4.0,
        offered_tokens_per_s: float = 2000.0,
        prompt_len: int = 48,
        shared_frac: float = 0.5,
        gen_len: int = 8,
        vocab_size: int = 512,
        seed: int = 0,
    ):
        self.tenants = tenants or {"free": 1.0, "pro": 2.0}
        self.duration_s = duration_s
        self.offered_tokens_per_s = offered_tokens_per_s
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        rng = np.random.default_rng(seed)
        names = sorted(self.tenants)
        weights = np.asarray([self.tenants[n] for n in names], dtype=float)
        weights /= weights.sum()
        shared = max(0, min(int(prompt_len * shared_frac), prompt_len - 1))
        heads = {
            n: rng.integers(1, vocab_size, size=shared).tolist() for n in names
        }
        rate = offered_tokens_per_s / prompt_len  # arrivals per second
        self.arrivals: list[tuple[float, str, list[int]]] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= duration_s:
                break
            tenant = names[int(rng.choice(len(names), p=weights))]
            tail = rng.integers(
                1, vocab_size, size=prompt_len - shared
            ).tolist()
            self.arrivals.append((t, tenant, heads[tenant] + tail))

    @property
    def offered_requests(self) -> int:
        return len(self.arrivals)


def run_overload_workload(
    runner,
    workload: OverloadWorkload,
    ttft_deadline_s: float | None = None,
    e2e_deadline_s: float | None = None,
    wait_timeout_s: float = 120.0,
) -> dict:
    """Drive an :class:`OverloadWorkload` open-loop against an
    :class:`~radixmesh_tpu_torch.slo.runner.SLORunner` (wall-clock paced: the
    submitting thread sleeps to each arrival instant, so offered load is
    independent of service rate) and report the overload scorecard:
    goodput (tokens of deadline-met requests per second), shed counts by
    reason, per-tenant admitted shares, and TTFT percentiles over
    admitted requests."""
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.slo.control import RequestShed

    import time as _time

    sampling = SamplingParams(temperature=0.0, max_new_tokens=workload.gen_len)
    t0 = _time.monotonic()
    inflight: list[tuple[str, object]] = []
    shed: dict[str, int] = {}
    submitted = 0
    for t_arr, tenant, prompt in workload.arrivals:
        delay = t0 + t_arr - _time.monotonic()
        if delay > 0:
            _time.sleep(delay)
        submitted += 1
        try:
            req = runner.submit(
                prompt,
                sampling,
                tenant=tenant,
                ttft_deadline_s=ttft_deadline_s,
                e2e_deadline_s=e2e_deadline_s,
            )
        except RequestShed as e:
            shed[e.reason] = shed.get(e.reason, 0) + 1
            continue
        inflight.append((tenant, req))
    deadline = _time.monotonic() + wait_timeout_s
    ttft: list[float] = []
    met = 0
    good_tokens = 0  # prompt+generated tokens of deadline-met requests
    served_tokens = 0  # prompt+generated tokens of ALL served requests
    admitted_tokens: dict[str, int] = {}
    timed_out = 0
    for tenant, req in inflight:
        try:
            runner.wait(req, timeout=max(0.0, deadline - _time.monotonic()))
        except TimeoutError:
            # One stalled request must cost ONE scorecard row, not the
            # whole report (and, from the bench sweep, the whole round's
            # curve): count it unserved and keep collecting.
            timed_out += 1
            continue
        if req.shed and not req.output_tokens:
            # Dropped from the SLO queue at dispatch time.
            shed[req.shed_reason] = shed.get(req.shed_reason, 0) + 1
            continue
        admitted_tokens[tenant] = admitted_tokens.get(tenant, 0) + len(
            req.prompt
        )
        n_tok = len(req.prompt) + len(req.output_tokens)
        served_tokens += n_tok
        t_first = req.first_token_time - req.submit_time
        ttft.append(t_first)
        if ttft_deadline_s is None or t_first <= ttft_deadline_s:
            met += 1
            good_tokens += n_tok
    elapsed = _time.monotonic() - t0
    n_adm = len(ttft)
    return {
        "offered_requests": submitted,
        "admitted_requests": n_adm,
        "served_requests": n_adm,
        "shed_requests": sum(shed.values()),
        "shed_by_reason": shed,
        "timed_out_requests": timed_out,
        "deadline_met": met,
        "deadline_met_frac": met / n_adm if n_adm else 0.0,
        # Token rates are prompt+generated per wall second (submission
        # window + drain): goodput counts only deadline-met requests,
        # served_tok_s counts everything that ran to completion — under
        # deadline-free saturation it IS the admission path's capacity.
        "goodput_tok_s": good_tokens / elapsed if elapsed > 0 else 0.0,
        "served_tok_s": served_tokens / elapsed if elapsed > 0 else 0.0,
        "admitted_tokens_by_tenant": admitted_tokens,
        "p50_ttft_s": float(np.median(ttft)) if ttft else 0.0,
        "p99_ttft_s": float(np.quantile(ttft, 0.99)) if ttft else 0.0,
        "elapsed_s": elapsed,
    }



class _StallableStats:
    """Engine stand-in for fleet-bench stall injection: reports a full
    batch whose ``decode_steps`` counter advances only while healthy —
    exactly the signature the stall watchdog keys on, without needing a
    real engine to actually wedge."""

    def __init__(self):
        self.healthy = True
        self._steps = 0

    def telemetry(self) -> dict:
        if self.healthy:
            self._steps += 7
        return {
            "batch_occupancy": 1.0,
            "waiting": 3,
            "decode_steps": self._steps,
            "decode_ewma_s": 0.01,
            "cache_hit_rate": 0.5,
            "pool_fill": 0.5,
            "host_fill": 0.0,
            "evictions": {},
        }


def run_fleet_churn_workload(
    n_inserts: int = 120,
    key_len: int = 24,
    fan_in_rounds: int = 5,
    digest_interval_s: float = 0.1,
    seed: int = 0,
    timeout_s: float = 20.0,
    health_threshold: float = 0.5,
) -> dict:
    """Drive the fleet telemetry plane (``obs/fleet_plane.py``) through
    its three claims on an in-proc 2-prefill + 1-decode + router mesh and
    measure each:

    1. **Digest fan-in** — per publish round, seconds from the slowest
       node's origination until every node (router included) holds all
       three fresh digests.
    2. **Convergence audit under churn** — seeded multi-writer inserts
       while digests gossip; the max pairwise ``convergence_age_seconds``
       observed during churn, and the time from quiescence to all four
       replicas reporting one fingerprint. Then an injected divergence
       (a key applied to ONE replica only — a stand-in partition): the
       age must rise while diverged and return to ~0 after the heal.
    3. **Health reaction** — a stall injected into one node's telemetry
       (batch full, decode frozen); seconds until the router's fleet
       view scores it below ``health_threshold``, and whether a
       health-aware router actually stops selecting it.

    Transport-light by design (no engine, no sockets): the phenomena under
    test live in the gossip/fold/score layer, which is identical over
    the inproc hub and TCP."""
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

    def wait_for(pred, timeout=timeout_s, interval=0.005):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    prefill, decode, router = ["fp0", "fp1"], ["fd0"], ["fr0"]
    nodes: list = []
    for addr in prefill + decode + router:
        cfg = MeshConfig(
            prefill_nodes=prefill,
            decode_nodes=decode,
            router_nodes=router,
            local_addr=addr,
            protocol="inproc",
            tick_interval_s=0.05,
            gc_interval_s=30.0,
        )
        nodes.append(MeshCache(cfg, pool=None).start())
    planes = []
    try:
        for n in nodes:
            if not n.wait_ready(timeout=timeout_s):
                raise RuntimeError(f"node {n.rank} never passed the barrier")
        ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
        router_mesh = nodes[-1]
        stall = _StallableStats()
        planes = [
            FleetPlane(
                n,
                engine=stall if i == 1 else None,
                interval_s=digest_interval_s,
            )
            for i, n in enumerate(ring)
        ]
        digest_bytes = max(p.build_digest().encoded_size() for p in planes)

        # -- 1. digest fan-in ------------------------------------------
        fan_in: list[float] = []
        for _ in range(fan_in_rounds):
            want = {}
            t0 = _time.monotonic()
            for p in planes:
                want[p.mesh.rank] = p.publish_once().seq
            assert wait_for(
                lambda: all(
                    (d := n.fleet.digests()).keys() >= want.keys()
                    and all(d[r].seq >= s for r, s in want.items())
                    for n in nodes
                )
            ), "digest fan-in never completed"
            fan_in.append(_time.monotonic() - t0)

        # -- 2. convergence under churn --------------------------------
        churn_t0 = _time.monotonic()
        max_age_churn = 0.0
        for i in range(n_inserts):
            writer = ring[int(rng.integers(0, len(ring)))]
            key = rng.integers(0, 512, size=key_len).astype(np.int32)
            writer.insert(key, np.arange(key_len, dtype=np.int32))
            if i % 10 == 0:
                for p in planes:
                    p.publish_once()
                max_age_churn = max(
                    max_age_churn,
                    router_mesh.fleet.convergence()["max_convergence_age_s"],
                )
        churn_s = _time.monotonic() - churn_t0
        quiesce_t0 = _time.monotonic()

        def _converged() -> bool:
            for p in planes:
                p.publish_once()
            fps = {n.tree.fingerprint_ for n in nodes}
            return (
                len(fps) == 1
                and router_mesh.fleet.convergence()["converged"]
            )

        converged = wait_for(_converged, interval=digest_interval_s)
        quiesce_s = _time.monotonic() - quiesce_t0

        # Injected divergence: one replica learns a key the others never
        # see (partition stand-in); heal by replicating it for real.
        rogue = ring[0]
        key = rng.integers(600, 900, size=key_len).astype(np.int32)
        idx = np.arange(key_len, dtype=np.int32)
        from radixmesh_tpu_torch.cache.mesh_values import PrefillValue

        with rogue._lock:
            rogue._mesh_insert(key, PrefillValue(idx, rogue.rank))
        for p in planes:
            p.publish_once()
        diverged = wait_for(
            lambda: not router_mesh.fleet.convergence()["converged"]
        )
        age_t0 = _time.monotonic()
        _time.sleep(3 * digest_interval_s)
        for p in planes:
            p.publish_once()
        age_while_diverged = router_mesh.fleet.convergence()[
            "max_convergence_age_s"
        ]
        rogue.insert(key, idx)  # heal: replicate the divergent key
        healed = wait_for(_converged, interval=digest_interval_s)
        heal_s = _time.monotonic() - age_t0

        # -- 3. stall injection + health-aware demotion ----------------
        sick = planes[1].mesh  # the plane wired to the stallable stats
        cr = CacheAwareRouter(
            router_mesh,
            router_mesh.cfg,
            health_aware=True,
            health_threshold=health_threshold,
        )
        cr.finish_warm_up()
        planes[1].publish_once()  # healthy baseline digest
        stall.healthy = False
        stall_t0 = _time.monotonic()

        def _scored_sick() -> bool:
            planes[1].publish_once()
            return (
                router_mesh.fleet.health_score(sick.rank) < health_threshold
            )

        reacted = wait_for(_scored_sick, interval=digest_interval_s)
        reaction_s = _time.monotonic() - stall_t0
        sick_addr = sick.cfg.addr_of_rank(sick.rank)
        routed = {
            cr.cache_aware_route(
                rng.integers(0, 512, size=8).astype(np.int32)
            ).prefill_addr
            for _ in range(32)
        }
        demoted = reacted and sick_addr not in routed

        # Frame discipline: each DIGEST origination is exactly one ring
        # frame, and the router receives each exactly once (master
        # fan-out) — ratio ~1.0 proves one-frame-per-interval-per-node.
        from radixmesh_tpu_torch.cache.oplog import OplogType

        total_published = sum(p.published for p in planes)
        router_digests = int(
            router_mesh._m_received[OplogType.DIGEST].value
        )
        frames_per_publish = router_digests / max(1, total_published)

        return {
            "nodes": len(nodes),
            "topology": "2 prefill + 1 decode + 1 router (inproc)",
            "digest_interval_s": digest_interval_s,
            "digest_bytes": int(digest_bytes),
            "fan_in": {
                "rounds": fan_in_rounds,
                "p50_s": float(np.median(fan_in)),
                "max_s": float(max(fan_in)),
            },
            "convergence": {
                "inserts": n_inserts,
                "writers": len(ring),
                "churn_s": round(churn_s, 3),
                "max_age_during_churn_s": round(max_age_churn, 3),
                "quiesce_to_converged_s": round(quiesce_s, 3),
                "converged": bool(converged),
                "injected_divergence_detected": bool(diverged),
                "age_while_diverged_s": round(age_while_diverged, 3),
                "healed": bool(healed),
                "heal_s": round(heal_s, 3),
            },
            "stall_reaction": {
                "injected": True,
                "detected": bool(reacted),
                "reaction_s": round(reaction_s, 3),
                "score_after": router_mesh.fleet.health_score(sick.rank),
                "threshold": health_threshold,
            },
            "health_aware_demotion": bool(demoted),
            "digests_published": total_published,
            "digest_frames_per_publish": round(frames_per_publish, 3),
            "wall_s": round(_time.monotonic() - t_start, 3),
        }
    finally:
        for p in planes:
            p.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()


def _pair_converged(a, b) -> bool:
    """Two replicas agree: scalar fingerprints on a full-replica mesh;
    per CO-OWNED shard under sharding (whole-tree fingerprints diverge
    by design there — cache/sharding.py)."""
    if not getattr(a, "sharded", False):
        return a.tree.fingerprint_ == b.tree.fingerprint_
    afp, bfp = a.tree.shard_fingerprints(), b.tree.shard_fingerprints()
    own = a.ownership
    if own is None:
        return True
    return all(
        afp.get(sid, 0) == bfp.get(sid, 0)
        for sid in own.owned_shards(a.rank)
        if own.is_owner(b.rank, sid)
    )


def _trees_converged(nodes, router_mesh=None) -> bool:
    """Fleet-wide convergence predicate for the chaos gates. Full
    replica: one fingerprint across every node (router included — its
    rank-only replica hashes value-blind). Sharded: every shard's owner
    set agrees on that shard's fingerprint, and (when given) the router
    mesh's gossip-fed shard-convergence audit concurs."""
    from radixmesh_tpu_torch.config import NodeRole

    sharded = any(getattr(n, "sharded", False) for n in nodes)
    if not sharded:
        if len({n.tree.fingerprint_ for n in nodes}) != 1:
            return False
        if router_mesh is not None:
            return bool(router_mesh.fleet.convergence()["converged"])
        return True
    ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
    by_rank = {n.rank: n for n in ring}
    for n in ring:
        own = n.ownership
        if own is None:
            continue
        for sid in own.owned_shards(n.rank):
            fps = {
                m.tree.shard_fingerprints().get(sid, 0)
                for r, m in by_rank.items()
                if own.is_owner(r, sid)
            }
            if len(fps) > 1:
                return False
    if router_mesh is not None:
        return bool(router_mesh.fleet.shard_convergence()["converged"])
    return True


def _chaos_join_drain_phases(
    *,
    nodes,
    ring,
    router_mesh,
    by_addr,
    cr,
    fleet_planes,
    repair_planes,
    lifecycle_planes,
    plan,
    faults,
    prefill,
    partitioned,
    rng,
    wait_for,
    key_len,
    seed,
    drop_p,
    drain_requests,
    drain_inflight,
    join_partition_s,
    digest_interval_s,
    repair_interval_s,
    age_threshold_s,
    bootstrap_probe_interval_s,
    bootstrap_round_budget,
    timeout_s,
) -> tuple[dict, dict]:
    """Phases 5+6 of ``run_chaos_workload`` (membership lifecycle,
    ``policy/lifecycle.py``): graceful drain of cp2 under re-opened
    seeded loss, then a COLD rejoin of the same address while cp1 sits
    behind a partition. Mutates the armed ``plan`` between phases (every
    wrapped edge shares the object, and the per-edge RNG streams stay
    seeded) and returns ``(drain_report, join_report)``."""
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.cache.repair_plane import RepairConfig, RepairPlane
    from radixmesh_tpu_torch.config import MeshConfig
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
    from radixmesh_tpu_torch.policy.lifecycle import (
        LifecycleConfig,
        LifecyclePlane,
        LifecycleState,
    )

    target_addr = prefill[2]
    target = by_addr[target_addr]
    t_rank = target.rank
    t_node_idx = nodes.index(target)
    t_ring_idx = ring.index(target)

    # A replicated warm set owned by the drain target: after the rejoin
    # these keys are exactly the hits the router must WITHHOLD while the
    # reincarnation bootstraps (its replica is cold; the router's rank-2
    # values are not).
    joiner_keys = [
        rng.integers(0, 600, size=key_len).astype(np.int32)
        for _ in range(6)
    ]
    for k in joiner_keys:
        target.insert(k, np.arange(key_len, dtype=np.int32))
    live = [n for n in nodes]
    wait_for(lambda: _trees_converged(live))

    # ---- phase 5: drain under sustained seeded loss -------------------
    plan.partitions = ()
    plan.drop_start_s, plan.drop_end_s = 0.0, float("inf")
    faults.rebase()
    # Simulated in-flight work parked at the target when the drain hits.
    inflight_keys = [
        rng.integers(0, 600, size=key_len).astype(np.int32)
        for _ in range(drain_inflight)
    ]
    for k in inflight_keys:
        target.insert(k, np.arange(key_len, dtype=np.int32))
    dead_before = sum(
        int(n._m_succ_trans["dead"].value) for n in nodes
    )
    requeue_state = {"served": 0}

    def _requeue_inflight() -> int:
        # The router must refuse the DRAINING node new work before
        # anything is re-placed (the state digest re-publishes every
        # interval, so a seeded drop of one frame only delays this).
        wait_for(
            lambda: router_mesh.fleet.lifecycle_of(t_rank)
            in ("draining", "left"),
            timeout=timeout_s,
        )
        served = 0
        for k in inflight_keys:
            res = cr.cache_aware_route(k)
            alt = by_addr.get(res.prefill_addr)
            if alt is None or alt is target:
                continue
            alt.insert(k, np.arange(key_len, dtype=np.int32))
            if alt.match_prefix(k).length == key_len:
                served += 1
        requeue_state["served"] = served
        return len(inflight_keys)

    def _writeback_stub() -> int:
        # Mesh-level stand-in for the engine's hot-prefix flush (the
        # real path — HierarchicalCache.evict through the fused
        # write-back lane — is exercised by the engine-level lifecycle
        # tests): count the hot tokens the replica holds at drain time.
        with target._lock:
            return int(
                target.tree.evictable_size_ + target.tree.protected_size_
            )

    tlc = LifecyclePlane(
        target,
        repair=repair_planes[t_node_idx],
        fleet_plane=fleet_planes[t_ring_idx],
        cfg=LifecycleConfig(
            drain_timeout_s=10.0, leave_confirm_s=0.25, leave_retries=3,
        ),
        requeue_fn=_requeue_inflight,
        writeback_fn=_writeback_stub,
    )
    lifecycle_planes.append(tlc)
    dstats = tlc.drain(deadline_s=10.0)
    survivors = [n for n in nodes if n is not target]
    left_everywhere = wait_for(
        lambda: all(not n.view.contains(t_rank) for n in survivors),
        timeout=timeout_s,
    )
    # Serve a stream through the still-open loss window: ZERO failures
    # allowed, and nothing may land on the drained node.
    d_attempted = d_ok = 0
    for _ in range(drain_requests):
        key = rng.integers(0, 600, size=key_len).astype(np.int32)
        d_attempted += 1
        try:
            res = cr.cache_aware_route(key)
            alt = by_addr.get(res.prefill_addr)
            if alt is None or alt is target:
                raise RuntimeError(
                    f"routed to {res.prefill_addr} mid-drain"
                )
            alt.insert(key, np.arange(key_len, dtype=np.int32))
            if alt.match_prefix(key).length != key_len:
                raise RuntimeError("local match missed a local insert")
            d_ok += 1
        except Exception:  # noqa: BLE001 — failures are the measurement
            pass
        _time.sleep(0.01)
    dead_after = sum(int(n._m_succ_trans["dead"].value) for n in nodes)
    left_transitions = sum(
        int(n._m_succ_trans["left"].value) for n in survivors
    )
    # The drained process exits: stop its planes and close its mesh.
    fleet_planes[t_ring_idx].close()
    repair_planes[t_node_idx].close()
    target.close()
    del by_addr[target_addr]
    drain_report = {
        "performed": True,
        "node": target_addr,
        "drop_p": drop_p,
        "requeued": int(dstats["requeued"]),
        "requeued_served": int(requeue_state["served"]),
        "attempted_during_drain": d_attempted,
        "ok_during_drain": d_ok,
        "zero_failed": bool(
            d_ok == d_attempted
            and requeue_state["served"] == dstats["requeued"]
        ),
        "left_without_failure_detection": bool(
            left_everywhere and dead_after == dead_before
        ),
        "left_cause_transitions": left_transitions,
        "writeback_tokens": int(dstats["writeback_tokens"]),
        "writeback_flushed": bool(dstats["writeback_flushed"]),
        "shard_transfer": dstats.get("shard_transfer"),
        "drain_s": round(float(dstats["drain_s"]), 3),
    }

    # ---- phase 6: cold rejoin during an active partition --------------
    plan.drop_p = 0.0
    plan.partitions = (
        faults.PartitionSpec(
            start_s=0.0, end_s=join_partition_s, addrs=(partitioned,)
        ),
    )
    faults.rebase()
    t_join0 = _time.monotonic()
    base_cfg = target.cfg
    jcfg = MeshConfig(
        prefill_nodes=list(base_cfg.prefill_nodes),
        decode_nodes=list(base_cfg.decode_nodes),
        router_nodes=list(base_cfg.router_nodes),
        local_addr=target_addr,
        protocol="inproc",
        tick_interval_s=base_cfg.tick_interval_s,
        gc_interval_s=base_cfg.gc_interval_s,
        failure_timeout_s=base_cfg.failure_timeout_s,
        replication_factor=base_cfg.replication_factor,
        shard_summary_interval_s=base_cfg.shard_summary_interval_s,
        heat_half_life_s=base_cfg.heat_half_life_s,
    )
    joiner = MeshCache(jcfg, pool=None).start()
    nodes.append(joiner)
    by_addr[target_addr] = joiner
    jrepair = RepairPlane(
        joiner,
        RepairConfig(
            interval_s=repair_interval_s,
            age_threshold_s=age_threshold_s,
            backoff_base_s=max(0.25, repair_interval_s),
            backoff_max_s=5.0,
            round_budget=bootstrap_round_budget,
        ),
        seed=seed,
    ).start()
    repair_planes.append(jrepair)
    jlc = LifecyclePlane(
        joiner,
        repair=jrepair,
        cfg=LifecycleConfig(
            bootstrap_grace_s=max(10.0, 6.0 * join_partition_s),
            bootstrap_deadline_s=timeout_s,
            bootstrap_probe_interval_s=bootstrap_probe_interval_s,
            bootstrap_round_budget=bootstrap_round_budget,
            tick_interval_s=min(0.05, repair_interval_s),
        ),
        bootstrap=True,
    )
    lifecycle_planes.append(jlc)
    jfleet = FleetPlane(joiner, interval_s=digest_interval_s).start()
    jlc.fleet_plane = jfleet
    fleet_planes.append(jfleet)
    jlc.start()
    joiner.wait_ready(timeout=timeout_s)
    # While the reincarnation bootstraps, the router must withhold every
    # cache hit pointing at it (the warm set routes by rank-2 values the
    # router still holds) — hash-ring fallback serves instead.
    wh0 = cr.withheld_hits
    hits_to_bootstrapping = 0
    probe_deadline = _time.monotonic() + timeout_s
    while (
        jlc.state is LifecycleState.BOOTSTRAPPING
        and _time.monotonic() < probe_deadline
    ):
        for k in joiner_keys:
            res = cr.cache_aware_route(k)
            if res.prefill_addr == target_addr and res.prefill_cache_hit:
                hits_to_bootstrapping += 1
        _time.sleep(0.05)
    became_active = wait_for(
        lambda: jlc.state is LifecycleState.ACTIVE, timeout=timeout_s
    )
    donor_rank = jlc.bootstrap_donor
    donor_node = next(
        (n for n in nodes if n is not joiner and n.rank == donor_rank),
        None,
    )
    converged_with_donor = bool(
        became_active
        and donor_node is not None
        and _pair_converged(joiner, donor_node)
    )
    # Partition off; the whole surviving fleet must converge again.
    plan.partitions = ()
    live = [n for n in nodes if n is not target]
    fleet_converged = wait_for(
        lambda: _trees_converged(live), timeout=timeout_s
    )
    # Hits to the joiner resume once it is ACTIVE.
    wait_for(
        lambda: router_mesh.fleet.lifecycle_of(t_rank) == "active",
        timeout=timeout_s,
    )
    post_hits = 0
    for k in joiner_keys:
        res = cr.cache_aware_route(k)
        if res.prefill_addr == target_addr and res.prefill_cache_hit:
            post_hits += 1
    join_report = {
        "performed": True,
        "joiner": target_addr,
        "donor_rank": donor_rank,
        "partition_active_at_join": True,
        "partition_s": join_partition_s,
        "partitioned_node": partitioned,
        "bootstrap_converge_s": (
            None
            if jlc.bootstrap_converge_s is None
            else round(jlc.bootstrap_converge_s, 3)
        ),
        "bootstrap_rounds": int(jlc.bootstrap_rounds),
        "round_budget": bootstrap_round_budget,
        "within_round_budget": bool(
            became_active
            and jlc.bootstrap_rounds <= bootstrap_round_budget
        ),
        "converged_with_donor": converged_with_donor,
        "withheld_hits": int(cr.withheld_hits - wh0),
        "hits_to_bootstrapping": hits_to_bootstrapping,
        "post_bootstrap_hits": post_hits,
        "fleet_converged_after_join": bool(fleet_converged),
        "join_s": round(_time.monotonic() - t_join0, 3),
    }
    return drain_report, join_report


def _await_survivor_copies(by_addr, decode, victim, recs, timeout_s=10.0) -> bool:
    """Before a decode node is killed mid-stream: wait, polling and for at
    most ``timeout_s``, until a surviving decode node holds every one of
    ``recs``' delivered prefixes (``resume_key``) in full. A stream's
    inserts take microseconds; the ring carries them to the survivors tens
    of milliseconds later, so a kill at once races that delivery. Returns
    whether the copies arrived (the crash and stitch reports'
    ``copies_before_kill``)."""
    import time as _time

    survivors = [a for a in decode if a != victim and a in by_addr]

    def held() -> bool:
        return all(
            any(
                by_addr[a].match_prefix(r.resume_key()).length
                == len(r.resume_key())
                for a in survivors
            )
            for r in recs
        )

    deadline = _time.monotonic() + timeout_s
    while not held():
        if _time.monotonic() >= deadline:
            return False
        _time.sleep(0.01)
    return True


def _chaos_crash_phase(
    *,
    by_addr,
    cr,
    plan,
    faults,
    prefill,
    decode,
    rng,
    seed,
    drop_p,
    crash_streams,
    crash_tokens,
    crash_deadline_s,
    kill_planes=lambda node: (),
) -> dict:
    """Phase 7 of ``run_chaos_workload`` (request recovery,
    ``server/recovery.py``): an UNCLEAN decode-node kill mid-stream
    under re-opened seeded loss.

    ``crash_streams`` live streams decode round-robin (each emitted
    token grows the stream's replicated prefix, the engine's
    ``stream_publish_tokens`` behavior at mesh scale). Halfway through,
    one decode node is process-killed (``FaultPlan.kill`` — stops
    serving AND stops acking). The serving edge's recovery plane must
    then deliver the acceptance gates the CHAOS artifact schema pins:

    - ``failed == 0`` — every stream completes; an unclean death is a
      latency blip, not a request loss.
    - Every interrupted stream resumes with a **byte-identical**
      already-delivered prefix (final streams equal the deterministic
      per-stream expectation — a resume that re-emitted or skipped a
      token breaks equality).
    - Resurrection is a cache hit: the surviving node's match over
      ``prompt+delivered`` covers ≥ 0.8 of the replayed tokens (the
      replicated tree is what makes recovery nearly free).
    - Deadline budgets bound every hop: no stream overruns its
      admission deadline by more than one retry backoff.

    Failure detection here is the EDGE's per-hop timeout (a killed
    process stops acking; the edge's timer is the fast trigger — the
    mesh's ``cause=dead`` ring detection is deliberately out of window,
    exactly like production where failure_timeout >> hop timeout). A
    hedged-prefill drill (straggler duplicated, first-writer-wins,
    loser cancelled) runs under the same loss window."""
    import time as _time

    from radixmesh_tpu_torch.policy.retry import RetryPolicy
    from radixmesh_tpu_torch.server.recovery import (
        HopTimeout,
        NodeDied,
        RecoveryCoordinator,
    )

    t_phase = _time.monotonic()
    # Re-open the seeded loss window for the whole phase; no partitions.
    plan.partitions = ()
    plan.drop_p = drop_p
    plan.drop_start_s, plan.drop_end_s = 0.0, float("inf")
    faults.rebase()

    policy = RetryPolicy(
        hop_timeout_s=0.4,
        max_retries=4,
        backoff_base_s=0.05,
        backoff_max_s=0.4,
        jitter_frac=0.25,
        hedge_after_s=0.15,
    )
    coord = RecoveryCoordinator(policy, name="chaos-edge", seed=seed)
    detect_t = {"first": None}
    coord.on_node_dead.append(
        lambda addr, cause: detect_t.__setitem__(
            "first", detect_t["first"] or _time.monotonic()
        )
    )

    def token_of(stream_seed: int, i: int) -> int:
        # Deterministic continuation per (stream, position): byte-exact
        # resume verification needs the expected stream to be computable
        # independently of which node served which token.
        return int((stream_seed * 7919 + i * 104729 + 13) % 600)

    # -- admit streams and decode the first half (all live at the kill) --
    streams = []
    for s in range(crash_streams):
        prompt = rng.integers(0, 600, size=len(prefill) * 5 + 1).astype(
            np.int32
        )
        rec = coord.admit(
            prompt, deadline_s=crash_deadline_s, seed=seed * 1009 + s
        )
        res = cr.cache_aware_route(prompt)
        rec.addr = res.decode_addr
        streams.append(rec)

    def emit_one(rec) -> None:
        node = by_addr[rec.addr]
        i = len(rec.delivered)
        tok = token_of(rec.seed, i)
        key = np.concatenate(
            [rec.resume_key(), np.asarray([tok], dtype=np.int32)]
        )
        node.insert(key, np.arange(len(key), dtype=np.int32))
        rec.deliver(tok)

    half = crash_tokens // 2
    for i in range(half):
        for rec in streams:
            emit_one(rec)

    # -- process-level kill of the busiest decode node ------------------
    per_addr: dict = {}
    for rec in streams:
        per_addr[rec.addr] = per_addr.get(rec.addr, 0) + 1
    victim = max(decode, key=lambda a: per_addr.get(a, 0))
    interrupted = [r for r in streams if r.addr == victim]
    # Recovery from a replicated cache, not the race of the kill with
    # the ring (a hit ratio of 0.0 when the JAX scenario's kill wins).
    copies_before_kill = _await_survivor_copies(by_addr, decode, victim, interrupted)
    plan.kill(victim)
    victim_node = by_addr[victim]
    for plane in kill_planes(victim_node):
        plane.close()  # the whole process dies: its planes die with it
    victim_node.close()
    t_kill = _time.monotonic()

    # -- the recovery plane drives every stream to completion -----------
    hit_acct = {"replayed": 0, "cached": 0, "measured": set()}
    route_stats = {"failover": 0}

    def make_route_fn(rec):
        # Sticky per-stream routing, like a production SSE edge: a live
        # stream keeps flowing to the node serving it and re-routes ONLY
        # once failure detection clears rec.addr (the coordinator nulls
        # it on HopTimeout/NodeDied). Re-consulting the router mid-
        # stream would let a healthy replica silently adopt the stream
        # (harmless, but it would bypass the recovery path this phase
        # exists to prove — especially under sharding, where co-owners
        # advertise depth ties).
        def route_fn(key, exclude):
            cur = rec.addr
            if cur is not None and cur not in exclude:
                return cur
            res = cr.cache_aware_route(key, exclude=exclude)
            if res.decode_failover:
                route_stats["failover"] += 1
            return res.decode_addr

        return route_fn

    def serve_fn(addr, rec, hop_deadline_s):
        deadline = _time.monotonic() + hop_deadline_s
        while len(rec.delivered) < crash_tokens:
            if plan.is_killed(addr):
                # A killed process stops acking: the edge sees silence
                # until its per-hop timer fires — THE fast trigger.
                wait = deadline - _time.monotonic()
                if wait > 0:
                    _time.sleep(wait)
                raise HopTimeout(f"no progress from {addr}")
            if rec.resurrections and rec.rid not in hit_acct["measured"]:
                # Resume prefill: measure the surviving replica's cached
                # coverage of prompt+delivered BEFORE re-inserting it.
                hit_acct["measured"].add(rec.rid)
                rkey = rec.resume_key()
                hit_acct["replayed"] += len(rkey)
                hit_acct["cached"] += int(
                    by_addr[addr].match_prefix(rkey).length
                )
            emit_one(rec)

    failed = 0
    reports = []
    for rec in streams:
        try:
            reports.append(
                coord.run_to_completion(rec, make_route_fn(rec), serve_fn)
            )
        except Exception:  # noqa: BLE001 — failures are the measurement
            failed += 1
    detect_s = (
        None
        if detect_t["first"] is None
        else round(detect_t["first"] - t_kill, 3)
    )

    # Byte-identical resume: every final stream must equal the
    # deterministic expectation token-for-token — a resumed stream that
    # re-emitted, skipped, or reordered a token breaks this.
    prefix_identical = all(
        rec.delivered == [token_of(rec.seed, i) for i in range(crash_tokens)]
        for rec in streams
        if not rec.failed
    )
    resumed = sum(1 for r in interrupted if r.done and r.resurrections)
    max_overrun = max((r.budget.overrun_s() for r in streams), default=0.0)
    max_backoff = max((r.max_backoff_s for r in streams), default=0.0)
    within_budget = all(r.overrun_within_one_backoff() for r in streams)

    # -- hedged-prefill drill: straggler duplicated, first-writer-wins --
    h_prompt = rng.integers(0, 600, size=16).astype(np.int32)
    h_rec = coord.admit(h_prompt, deadline_s=crash_deadline_s)
    survivors_p = [a for a in prefill if a in by_addr and not plan.is_killed(a)]
    straggler, backup = survivors_p[0], survivors_p[1]
    cancelled = []

    def slow_leg():
        # A straggling prefill: well past the hedge threshold.
        _time.sleep(4 * policy.hedge_after_s)
        by_addr[straggler].insert(
            h_prompt, np.arange(len(h_prompt), dtype=np.int32)
        )
        return straggler

    def fast_leg():
        by_addr[backup].insert(
            h_prompt, np.arange(len(h_prompt), dtype=np.int32)
        )
        return backup

    hedge_out = coord.hedged(
        h_rec,
        (straggler, slow_leg, lambda: cancelled.append(straggler)),
        (backup, fast_leg, lambda: cancelled.append(backup)),
    )
    coord.finish(h_rec)

    replayed = max(1, hit_acct["replayed"])
    return {
        "performed": True,
        "node": victim,
        "drop_p": drop_p,
        "streams": crash_streams,
        "tokens_per_stream": crash_tokens,
        "killed_at_token": half,
        "interrupted": len(interrupted),
        "copies_before_kill": copies_before_kill,
        "resumed": resumed,
        "failed": failed,
        "prefix_identical": bool(prefix_identical),
        "replayed_tokens": int(hit_acct["replayed"]),
        "replayed_cached_tokens": int(hit_acct["cached"]),
        "resurrection_hit_ratio": round(hit_acct["cached"] / replayed, 4),
        "retries": int(sum(r["retries"] for r in reports)),
        "resurrections": int(sum(r["resurrections"] for r in reports)),
        "failover_routes": int(route_stats["failover"]),
        "detection": {
            "trigger": "hop_timeout",
            "hop_timeout_s": policy.hop_timeout_s,
            "detect_s": detect_s,
        },
        "budget": {
            "deadline_s": crash_deadline_s,
            "max_overrun_s": round(max_overrun, 4),
            "max_backoff_s": round(max_backoff, 4),
            "within_one_backoff": bool(within_budget),
        },
        "hedge": {
            "fired": bool(hedge_out["hedged"]),
            "winner": hedge_out["winner"],
            "first_writer_wins": hedge_out["winner"] == backup,
            "loser_cancelled": bool(hedge_out["loser_cancelled"]),
        },
        "crash_s": round(_time.monotonic() - t_phase, 3),
    }


def _chaos_rebalance_phase(
    *,
    ring,
    router_mesh,
    by_addr,
    rng,
    wait_for,
    key_len: int,
    zipf_keys: int = 24,
    zipf_inserts: int = 160,
    zipf_alpha: float = 1.6,
    hits_per_request: int = 5,
    wave_s: float = 2.0,
    settle_s: float = 2.0,
    mid_requests: int = 20,
    max_moves_per_round: int = 4,
    skew_trigger: float = 2.0,
    timeout_s: float = 30.0,
) -> dict:
    """Rebalance-under-storm (the closed robustness loop,
    cache/rebalance.py): a zipf-keyed storm concentrates insert+hit
    heat on one shard's owners; the view master's RebalancePlane must
    see the gossiped skew, boost the hot shards' owner sets (bounded
    moves), hand the cached entries to the gained owners with ZERO
    failed requests mid-move, and — once the fleet converges on the
    override version — a second storm wave's reads fan out across the
    boosted replicas until the router-observed skew score STRICTLY
    drops. Deterministic: zipf counts (not samples), manual decider
    ticks, deadline-bounded waits, and heat decayed on a clock that the
    requests' pacing advances (below)."""
    import time as _time

    from radixmesh_tpu_torch.cache.rebalance import RebalanceConfig, RebalancePlane
    from radixmesh_tpu_torch.cache.sharding import NUM_SHARDS, shard_of_tokens
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

    t_phase = _time.monotonic()
    # A phase-local router with an aggressive shed policy and a fresh
    # load tracker: fan-out-under-boost IS the mechanism being proven,
    # so the hot replica must shed to its (boosted) owner peers well
    # before the default production thresholds.
    cr = CacheAwareRouter(
        router_mesh, router_mesh.cfg,
        overload_factor=1.5, overload_floor=6.0, load_tau_s=5.0,
    )
    cr.finish_warm_up()
    # One plane per ring node; decisions are manual ticks (the thread
    # cadence is a production concern, not a phase invariant) and only
    # the view master's plane ever acts.
    # The ring's heat cells decay on a clock that each request advances
    # by its pace (``wave_s`` over a wave, ``settle_s`` over the mid-move
    # trickle) and that stands still between them, not on the wall: on
    # the wall a loaded host stretched a wave past the heat's half-life
    # (0.15 s in the quick gate), so each skew read sampled only the
    # wave's last requests, and the reads, taken later still, decayed
    # further while they waited for gossip. It starts at the wall's
    # reading and stays behind it, so the wall can take over again.
    clock = [_time.monotonic()]
    for n in ring:
        n.set_heat_clock(lambda: clock[0])
    planes = [
        RebalancePlane(
            n,
            RebalanceConfig(
                interval_s=3600.0,
                skew_trigger=skew_trigger,
                boost_factor=1.5,
                shrink_factor=1.1,
                rf_boost=2,
                max_moves_per_round=max_moves_per_round,
            ),
        )
        for n in ring
    ]
    try:
        weights = np.arange(1, zipf_keys + 1, dtype=np.float64) ** (
            -zipf_alpha
        )
        counts = np.maximum(
            1, np.floor(zipf_inserts * weights / weights.sum()).astype(int)
        )
        keys = [
            np.concatenate(
                [
                    np.asarray([8101 + k], dtype=np.int32),
                    rng.integers(1, 600, size=key_len - 1).astype(np.int32),
                ]
            )
            for k in range(zipf_keys)
        ]
        reqs = [k for k, c in enumerate(counts) for _ in range(int(c))]
        reqs = [keys[i] for i in rng.permutation(reqs)]
        page = max(1, ring[0].page)
        by_rank = {n.rank: n for n in ring}

        counters = {"attempted": 0, "ok": 0}

        def _serve_at(target, key) -> bool:
            counters["attempted"] += 1
            try:
                if target is None:
                    raise RuntimeError("no serving node for request")
                target.insert(key, np.arange(len(key), dtype=np.int32))
                for _ in range(hits_per_request):
                    target.match_prefix(key)
                counters["ok"] += 1
                return True
            except Exception:  # noqa: BLE001 — failures are the measurement
                return False

        def _serve_routed(key) -> bool:
            try:
                res = cr.cache_aware_route(key)
                target = by_addr.get(res.prefill_addr)
            except Exception:  # noqa: BLE001
                target = None
            return _serve_at(target, key)

        def _serve_primary(key) -> bool:
            # The storm's concentration leg: traffic lands where a
            # summary-warm router would send it — the shard's primary
            # owner (deepest advertiser once warm).
            sid = shard_of_tokens(key[:page])
            primary = decider_mesh.ownership.primary(sid)
            return _serve_at(by_rank.get(primary), key)

        def _wave(serve) -> None:
            pace = wave_s / max(1, len(reqs))
            t0 = _time.monotonic()
            for i, key in enumerate(reqs):
                serve(key)
                clock[0] += pace
                left = t0 + (i + 1) * pace - _time.monotonic()
                if left > 0:
                    _time.sleep(left)

        def _holds_heat_of(mesh, n) -> bool:
            # ``n``'s loads as ``mesh`` folded them against the ones ``n``
            # folded itself when it sent them (the wire carries float32).
            seen = mesh.fleet.shard_heat()["by_rank"].get(str(n.rank), {})
            own = n.fleet.shard_heat()["by_rank"].get(str(n.rank), {})
            return seen.keys() == own.keys() and all(
                abs(seen[s] - v) <= 1e-5 * max(1.0, v) for s, v in own.items()
            )

        def _skew_at(*meshes) -> list[dict]:
            # Every rank publishes now, folding its loads into its own
            # view as it sends them. The heat clock stands still, so the
            # loads stay put: wait until each of ``meshes`` holds each
            # rank's, not merely some summary of each rank (a loaded
            # host delivers the wave's periodic summaries late). Cold
            # reporters clear themselves on both sides.
            sent = [n for n in ring if n.broadcast_shard_summary()]
            wait_for(
                lambda: all(_holds_heat_of(m, n) for m in meshes for n in sent),
                timeout=timeout_s,
            )
            return [m.fleet.shard_heat() for m in meshes]

        decider = next((p for p in planes if p.is_decider()), None)
        if decider is None:
            return {"performed": False, "reason": "no decider in ring"}
        decider_mesh = decider.mesh

        # -- wave 1: concentrate ---------------------------------------
        _wave(_serve_primary)
        # Both the observer router AND the decider need the heat folds.
        heat_before, _ = _skew_at(router_mesh, decider_mesh)
        skew_before = float(heat_before["skew_score"])
        attempted_wave1 = counters["attempted"]

        old_owners = {
            sid: decider.mesh.ownership.owners_of(sid)
            for sid in range(NUM_SHARDS)
        }

        # -- the move (traffic keeps flowing) --------------------------
        # The mid-move trickle is PACED across a settle window that
        # doubles as the wave-1 heat-decay gap: skew_after must measure
        # wave 2's fanned-out traffic, not wave 1's residue.
        mid0_attempted, mid0_ok = counters["attempted"], counters["ok"]
        tick = decider.tick()
        t_mid = _time.monotonic()
        for i, key in enumerate(reqs[:mid_requests]):
            _serve_routed(key)
            clock[0] += settle_s / max(1, mid_requests)
            left = (
                t_mid + (i + 1) * settle_s / max(1, mid_requests)
            ) - _time.monotonic()
            if left > 0:
                _time.sleep(left)
        want = (decider_mesh.overrides.epoch, decider_mesh.overrides.version)
        every = list(ring) + [router_mesh]
        converged = wait_for(
            lambda: all(
                (n.overrides.epoch, n.overrides.version) == want
                for n in every
            ),
            timeout=timeout_s,
        )
        # Zero-loss handoff audit: each rank that GAINED ownership of a
        # boosted shard must hold that shard's hottest key (pushed
        # point-to-point by the old primary, not waiting out repair).
        sid_hot_key = {}
        for k, key in enumerate(keys):
            sid = shard_of_tokens(key[:page])
            if sid not in sid_hot_key:
                sid_hot_key[sid] = key
        handoff_entries = 0
        for sid in tick.get("boosted", []):
            key = sid_hot_key.get(sid)
            if key is None:
                continue
            gained = [
                r for r in decider_mesh.ownership.owners_of(sid)
                if r not in old_owners.get(sid, ()) and r in by_rank
            ]
            for r in gained:
                if wait_for(
                    lambda n=by_rank[r], k=key: n.tree.match_prefix(
                        k, split_partial=False
                    ).length
                    > 0,
                    timeout=timeout_s,
                ):
                    handoff_entries += 1

        # -- wave 2: fan out under the adopted overrides ---------------
        _wave(_serve_routed)
        (heat_after,) = _skew_at(router_mesh)
        skew_after = float(heat_after["skew_score"])
        mid_attempted = counters["attempted"] - mid0_attempted
        mid_ok = counters["ok"] - mid0_ok
        moves = len(tick.get("boosted", [])) + len(tick.get("shrunk", []))
        return {
            "performed": True,
            "skew_before": round(skew_before, 4),
            "skew_after": round(skew_after, 4),
            "skew_dropped": bool(skew_after < skew_before),
            "moves": int(moves),
            "max_moves_per_round": int(max_moves_per_round),
            "moves_bounded": bool(moves <= max_moves_per_round),
            "boosted_shards": [int(s) for s in tick.get("boosted", [])],
            "hot_shard": heat_before.get("hot_shard"),
            "attempted_mid_move": int(mid_attempted),
            "ok_mid_move": int(mid_ok),
            "failed_mid_move": int(mid_attempted - mid_ok),
            "overrides_version": int(want[1]),
            "overrides_converged": bool(converged),
            "handoff_entries": int(handoff_entries),
            "requests_wave1": int(attempted_wave1),
            "rebalance_s": round(_time.monotonic() - t_phase, 3),
        }
    finally:
        for p in planes:
            p.close()
        for n in ring:
            n.set_heat_clock()


def _chaos_router_kill_phase(
    *,
    routers,
    by_addr,
    plan,
    kill_router,
    rng,
    seed: int,
    streams: int = 10,
    tokens_per_stream: int = 16,
    deadline_s: float = 30.0,
) -> dict:
    """Router-kill at the multi-router front door: live streams route
    EVERY token through a :class:`RouterFrontDoor` over N >= 2 router
    edges (each an independent RecoveryCoordinator edge); one router is
    process-killed mid-traffic (stops serving AND acking, like a
    blackholed peer); the front door's hop timeout detects it, hedges
    to the survivor, and every in-flight request completes through the
    surviving router's edge — zero lost requests. ``routers`` is an
    ordered list of (addr, CacheAwareRouter)."""
    import time as _time

    from radixmesh_tpu_torch.policy.retry import RetryPolicy
    from radixmesh_tpu_torch.router.front_door import RouterFrontDoor
    from radixmesh_tpu_torch.server.recovery import RecoveryCoordinator

    t_phase = _time.monotonic()
    policy = RetryPolicy(
        hop_timeout_s=0.5, max_retries=4, backoff_base_s=0.05,
        backoff_max_s=0.3, jitter_frac=0.25,
    )
    coords = {
        addr: RecoveryCoordinator(policy, name=f"edge-{addr}", seed=seed)
        for addr, _ in routers
    }
    served_by: dict[str, int] = {addr: 0 for addr, _ in routers}

    def make_route_fn(addr, router):
        def fn(key):
            if plan.is_killed(addr):
                # A killed process stops acking: from the client this
                # is a hop that never answers, so the front door's
                # timeout — not a clean error — must detect it.
                _time.sleep(0.6)
                raise RuntimeError(f"router {addr} gave no answer")
            res = router.cache_aware_route(key)
            served_by[addr] += 1
            return res

        return fn

    fd = RouterFrontDoor(
        [(addr, make_route_fn(addr, r)) for addr, r in routers],
        hop_timeout_s=0.25,
        name="chaos-frontdoor",
    )
    victim = routers[0][0]
    survivor = routers[1][0] if len(routers) > 1 else None

    recs = []
    for s in range(streams):
        prompt = rng.integers(0, 600, size=9).astype(np.int32)
        rec = coords[victim].admit(
            prompt, deadline_s=deadline_s, seed=seed * 1361 + s
        )
        recs.append(rec)

    def token_of(stream_seed: int, i: int) -> int:
        return int((stream_seed * 6151 + i * 104729 + 29) % 600)

    failed = 0

    def emit_one(rec) -> None:
        key = rec.resume_key()
        res = fd.route(key)
        target = by_addr.get(res.prefill_addr)
        if target is None:
            raise RuntimeError("front door returned no prefill node")
        tok = token_of(rec.seed, len(rec.delivered))
        grown = np.concatenate([key, np.asarray([tok], dtype=np.int32)])
        target.insert(grown, np.arange(len(grown), dtype=np.int32))
        rec.deliver(tok)

    half = tokens_per_stream // 2
    for _ in range(half):
        for rec in recs:
            emit_one(rec)

    # -- the kill: one of N routers dies mid-traffic -------------------
    inflight_at_kill = sum(
        1 for r in recs if len(r.delivered) < tokens_per_stream
    )
    served_at_kill = dict(served_by)
    plan.kill(victim)
    kill_router(victim)

    # The victim's edge process died whole — its recovery records
    # resurrect on the SURVIVING router's edge: re-admit each in-flight
    # stream there (prompt + delivered replay) and finish through the
    # front door, which fails over on the first unanswered hop.
    migrated = []
    for rec in recs:
        if survivor is None:
            break
        nrec = coords[survivor].admit(
            rec.prompt,
            deadline_s=max(0.5, rec.budget.remaining()),
            seed=rec.seed,
            trace_id=rec.trace_id or None,
        )
        for tok in rec.delivered:
            nrec.deliver(tok)
        migrated.append(nrec)
    for _ in range(tokens_per_stream - half):
        for rec in migrated:
            try:
                if len(rec.delivered) < tokens_per_stream:
                    emit_one(rec)
            except Exception:  # noqa: BLE001 — failures are the measurement
                failed += 1
    completed = sum(
        1 for r in migrated if len(r.delivered) >= tokens_per_stream
    )
    survivor_served = bool(
        survivor is not None
        and served_by.get(survivor, 0) > served_at_kill.get(survivor, 0)
    )
    return {
        "performed": True,
        "routers": len(routers),
        "killed": victim,
        "survivor": survivor,
        "streams": streams,
        "inflight_at_kill": int(inflight_at_kill),
        "completed": int(completed),
        "failed": int(failed),
        "failovers": int(fd.failovers),
        "hedges": int(fd.hedges),
        "survivor_served": survivor_served,
        "router_kill_s": round(_time.monotonic() - t_phase, 3),
    }


def run_chaos_workload(
    drop_p: float = 0.2,
    partition_s: float = 10.0,
    partition_delay_s: float = 1.0,
    digest_interval_s: float = 0.25,
    repair_interval_s: float = 0.2,
    age_threshold_s: float = 0.5,
    n_requests: int = 150,
    key_len: int = 16,
    seed: int = 0,
    round_budget: int = 8,
    quiesce_window_s: float = 2.0,
    timeout_s: float = 90.0,
    join_drain: bool = True,
    drain_requests: int = 40,
    drain_inflight: int = 6,
    join_partition_s: float = 1.5,
    bootstrap_probe_interval_s: float = 0.25,
    bootstrap_round_budget: int = 16,
    crash: bool = True,
    crash_streams: int = 12,
    crash_tokens: int = 24,
    crash_deadline_s: float = 20.0,
    replication_factor: int = 0,
    rebalance: bool = True,
    rebalance_wave_s: float = 2.0,
    rebalance_keys: int = 24,
    rebalance_inserts: int = 160,
    router_kill: bool = True,
    router_kill_streams: int = 10,
    router_kill_tokens: int = 16,
) -> dict:
    """The chaos acceptance scenario (``bench.validate_chaos`` pins its
    artifact): a seeded FaultPlan injects ``drop_p`` frame loss across
    the whole fault window plus a symmetric ``partition_s`` partition of
    one prefill node, while routed requests keep flowing —

    1. **Serve through the fault.** Each simulated request routes at the
       cache-aware router and inserts+matches at the routed node; the
       success rate during the fault window is recorded (the partition
       impairs *replication*, never local serving).
    2. **Diverge.** Dropped INSERT frames permanently diverge replicas;
       the gossiped fingerprints detect it (peak diverged pairs + max
       convergence age recorded).
    3. **Repair.** After the partition heals, the anti-entropy repair
       plane (``cache/repair_plane.py``) must converge ALL replicas —
       the prefills, the decode node, and the router — to pairwise
       equal fingerprints within ``round_budget`` repair rounds.
    4. **Quiesce.** Once converged, a ``quiesce_window_s`` observation
       window must record ZERO further repair traffic (probes and
       summaries frozen) — repair can never storm a healthy ring.

    With ``join_drain`` (the membership-lifecycle gates,
    ``policy/lifecycle.py``) two scale-in/scale-out phases follow:

    5. **Drain under loss.** The seeded ``drop_p`` loss window re-opens
       and one prefill node drains gracefully: the router refuses it
       new work once DRAINING gossips, its simulated in-flight requests
       are requeued-and-served elsewhere, hot tokens are written back,
       and a LEAVE drops it from every view with ZERO failed requests
       and ZERO failure-detection ("dead") successor transitions.
    6. **Join during a partition.** The drained node rejoins COLD while
       a partition isolates a different prefill. It enters
       BOOTSTRAPPING, picks a healthy donor from the fleet view, pulls
       a bulk repair session, and the router withholds cache hits from
       it (hash-ring fallback only) until its fingerprint converges
       with the donor — within the bootstrap round budget.

    With ``crash`` (the request-recovery gates, ``server/recovery.py``)
    a final unclean-death phase follows:

    7. **Crash mid-decode.** Live streams decode on both decode nodes
       under re-opened 20% loss; one decode node is process-KILLED
       (stops serving AND acking — ``FaultPlan.kill``). The edge's
       per-hop timeout detects it, every interrupted stream resurrects
       on the surviving node via the router's failover path (longest
       cached prefix over prompt+delivered), resumes byte-identically
       with ≥ 0.8 of replayed tokens served from cache, zero failures,
       and every recovery hop bounded by the admission deadline budget;
       a hedged-prefill drill (first-writer-wins, loser cancelled) runs
       in the same window.

    With ``rebalance`` (sharded runs only) a rebalance-under-storm
    phase runs after quiescence (``_chaos_rebalance_phase``): a zipf
    storm's skew score must STRICTLY drop once the view master's
    RebalancePlane boosts the hot shards' owner sets, with zero failed
    requests mid-move and the override version converged fleet-wide.
    With ``router_kill`` a final front-door phase
    (``_chaos_router_kill_phase``) process-kills one of the two
    routers mid-traffic: the client-side RouterFrontDoor must detect
    it by hop timeout, hedge to the survivor, and complete every
    in-flight request — zero lost.

    Deterministic by seeding: the FaultPlan's per-edge RNGs and the
    request stream derive from ``seed``; waits are deadline-bounded
    polls, never bare sleeps asserting timing."""
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.cache.repair_plane import RepairConfig, RepairPlane
    from radixmesh_tpu_torch.comm import faults
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

    def wait_for(pred, timeout=timeout_s, interval=0.02):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    # FOUR prefills: cp1 takes the phase-1 (and phase-6) partition;
    # cp2 is the drain/rejoin subject — its ring paths to the master
    # and its donor avoid cp1, so a join can START under the partition;
    # the fourth keeps sharded runs (rf <= 2) below the N <= RF
    # degeneracy so the rebalance phase has non-owners to boost ONTO.
    # TWO decodes: cd1 (or whichever serves more live streams) is the
    # phase-7 unclean-kill victim, and its sibling is the survivor the
    # recovery plane resurrects interrupted streams onto. TWO routers:
    # the multi-router front door — cr0 is the final-phase kill victim,
    # cr1 the surviving edge every in-flight request completes through.
    prefill, decode, router_addrs = (
        ["cp0", "cp1", "cp2", "cp3"], ["cd0", "cd1"], ["cr0", "cr1"],
    )
    partitioned = prefill[1]
    fault_end_s = partition_delay_s + partition_s
    plan = faults.FaultPlan(
        seed=seed,
        drop_p=drop_p,
        drop_end_s=fault_end_s,
        partitions=(
            faults.PartitionSpec(
                start_s=partition_delay_s,
                end_s=fault_end_s,
                addrs=(partitioned,),
            ),
        ),
    )
    nodes: list = []
    fleet_planes: list = []
    repair_planes: list = []
    lifecycle_planes: list = []
    try:
        with faults.injected(plan):
            for addr in prefill + decode + router_addrs:
                cfg = MeshConfig(
                    prefill_nodes=prefill,
                    decode_nodes=decode,
                    router_nodes=router_addrs,
                    local_addr=addr,
                    protocol="inproc",
                    tick_interval_s=0.1,
                    gc_interval_s=60.0,
                    # The partition must read as replication loss, not
                    # membership churn: keep failure detection out of
                    # the fault window.
                    failure_timeout_s=max(60.0, 4.0 * fault_end_s),
                    # Sharded rerun (cache/sharding.py): inserts deliver
                    # to owner sets; convergence gates become per-shard.
                    replication_factor=replication_factor,
                    shard_summary_interval_s=min(
                        digest_interval_s, repair_interval_s
                    ),
                    # Fast heat decay so the rebalance phase's second
                    # wave measures ITS traffic, not the first wave's
                    # residue (production keeps the 30 s default).
                    heat_half_life_s=1.0,
                )
                nodes.append(MeshCache(cfg, pool=None).start())
            for n in nodes:
                if not n.wait_ready(timeout=timeout_s):
                    raise RuntimeError(f"node {n.rank} never passed the barrier")
            ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
            router_meshes = [n for n in nodes if n.role is NodeRole.ROUTER]
            router_mesh = router_meshes[0]
            by_addr = {n.cfg.local_addr: n for n in ring}
            fleet_planes = [
                FleetPlane(n, interval_s=digest_interval_s).start()
                for n in ring
            ]
            repair_planes = [
                RepairPlane(
                    n,
                    RepairConfig(
                        interval_s=repair_interval_s,
                        age_threshold_s=age_threshold_s,
                        backoff_base_s=max(0.25, repair_interval_s),
                        backoff_max_s=5.0,
                        round_budget=round_budget,
                    ),
                    seed=seed,
                ).start()
                for n in nodes
            ]
            cr = CacheAwareRouter(router_mesh, router_mesh.cfg)
            cr.watch_topology()
            cr.finish_warm_up()

            # -- 1+2: serve routed requests THROUGH the fault window ---
            # The plan's schedule restarts NOW: cluster startup (barrier
            # ticks, channel dials) must not consume the fault window.
            faults.rebase()
            attempted = ok = 0
            peak_diverged = 0
            max_age = 0.0
            pace = fault_end_s / max(1, n_requests)
            window_t0 = _time.monotonic()
            for i in range(n_requests):
                key = rng.integers(0, 600, size=key_len).astype(np.int32)
                attempted += 1
                try:
                    res = cr.cache_aware_route(key)
                    target = by_addr.get(res.prefill_addr)
                    if target is None:
                        raise RuntimeError("router returned no prefill node")
                    target.insert(key, np.arange(key_len, dtype=np.int32))
                    if target.match_prefix(key).length != key_len:
                        raise RuntimeError("local match missed a local insert")
                    ok += 1
                except Exception:  # noqa: BLE001 — failures are the measurement
                    pass
                if replication_factor > 0:
                    conv = router_mesh.fleet.shard_convergence()
                    peak_diverged = max(peak_diverged, len(conv["diverged"]))
                else:
                    conv = router_mesh.fleet.convergence()
                    peak_diverged = max(
                        peak_diverged,
                        sum(1 for v in conv["pairs"].values() if v > 0.0),
                    )
                max_age = max(max_age, conv["max_convergence_age_s"])
                sleep_left = window_t0 + (i + 1) * pace - _time.monotonic()
                if sleep_left > 0:
                    _time.sleep(sleep_left)
            # Let the fault window fully close (drops + partition off).
            tail = window_t0 + fault_end_s + 0.1 - _time.monotonic()
            if tail > 0:
                _time.sleep(tail)
            diverged_detected = (
                peak_diverged > 0
                or not _trees_converged(nodes)
            )

            # -- 3: repair converges every replica ---------------------
            heal_t0 = _time.monotonic()

            converged = wait_for(
                lambda: _trees_converged(nodes, router_mesh)
            )
            converge_s = _time.monotonic() - heal_t0
            # max_inflight_rounds covers peers still marked diverged
            # (episodes that never completed), so a non-heal can't
            # under-report its round spend.
            max_rounds = max(
                (
                    max(s["max_episode_rounds"], s["max_inflight_rounds"])
                    for s in (r.stats() for r in repair_planes)
                ),
                default=0,
            )

            # -- 4: quiescence -----------------------------------------
            def _repair_traffic() -> int:
                return sum(
                    s["probes_sent"] + s["summaries_sent"]
                    for s in (r.stats() for r in repair_planes)
                )

            # Settle: let every node's fleet view fold the CONVERGED
            # digests (a peer reading a stale pre-heal fingerprint would
            # legitimately probe once more) before opening the
            # zero-traffic observation window.
            _time.sleep(3.0 * digest_interval_s + repair_interval_s)
            traffic_before = _repair_traffic()
            q_deadline = _time.monotonic() + quiesce_window_s
            while _time.monotonic() < q_deadline:
                _time.sleep(repair_interval_s)
            traffic_after = _repair_traffic()

            # -- 4b: heat-driven rebalancing under a zipf storm --------
            # (sharded runs only: a full replica has no ownership to
            # move). Runs on the healed fleet, before membership churn.
            rebalance_report: dict = {"performed": False}
            if rebalance and replication_factor > 0:
                rebalance_report = _chaos_rebalance_phase(
                    ring=ring,
                    router_mesh=router_mesh,
                    by_addr=by_addr,
                    rng=rng,
                    wait_for=wait_for,
                    key_len=key_len,
                    zipf_keys=rebalance_keys,
                    zipf_inserts=rebalance_inserts,
                    wave_s=rebalance_wave_s,
                    timeout_s=timeout_s,
                )

            # -- 5: graceful drain of cp2 under re-opened seeded loss --
            join_report: dict = {"performed": False}
            drain_report: dict = {"performed": False}
            if join_drain:
                drain_report, join_report = _chaos_join_drain_phases(
                    nodes=nodes,
                    ring=ring,
                    router_mesh=router_mesh,
                    by_addr=by_addr,
                    cr=cr,
                    fleet_planes=fleet_planes,
                    repair_planes=repair_planes,
                    lifecycle_planes=lifecycle_planes,
                    plan=plan,
                    faults=faults,
                    prefill=prefill,
                    partitioned=partitioned,
                    rng=rng,
                    wait_for=wait_for,
                    key_len=key_len,
                    seed=seed,
                    drop_p=drop_p,
                    drain_requests=drain_requests,
                    drain_inflight=drain_inflight,
                    join_partition_s=join_partition_s,
                    digest_interval_s=digest_interval_s,
                    repair_interval_s=repair_interval_s,
                    age_threshold_s=age_threshold_s,
                    bootstrap_probe_interval_s=bootstrap_probe_interval_s,
                    bootstrap_round_budget=bootstrap_round_budget,
                    timeout_s=timeout_s,
                )

            # -- 7: unclean decode-node kill mid-stream ----------------
            crash_report: dict = {"performed": False}
            if crash:

                def _kill_planes(node):
                    planes = []
                    if node in nodes:
                        planes.append(repair_planes[nodes.index(node)])
                    if node in ring:
                        planes.append(fleet_planes[ring.index(node)])
                    return planes

                crash_report = _chaos_crash_phase(
                    by_addr=by_addr,
                    cr=cr,
                    plan=plan,
                    faults=faults,
                    prefill=prefill,
                    decode=decode,
                    rng=rng,
                    seed=seed,
                    drop_p=drop_p,
                    crash_streams=crash_streams,
                    crash_tokens=crash_tokens,
                    crash_deadline_s=crash_deadline_s,
                    kill_planes=_kill_planes,
                )

            # -- 8: router kill at the multi-router front door ---------
            # LAST: it takes a router down for good.
            router_kill_report: dict = {"performed": False}
            if router_kill and len(router_meshes) >= 2:
                routers_rk = []
                for rm in router_meshes:
                    r = CacheAwareRouter(rm, rm.cfg)
                    r.watch_topology()
                    r.finish_warm_up()
                    routers_rk.append((rm.cfg.local_addr, r))

                def _kill_router(addr):
                    rm = next(
                        n for n in router_meshes
                        if n.cfg.local_addr == addr
                    )
                    if rm in nodes:
                        repair_planes[nodes.index(rm)].close()
                    rm.close()

                router_kill_report = _chaos_router_kill_phase(
                    routers=routers_rk,
                    by_addr=by_addr,
                    plan=plan,
                    kill_router=_kill_router,
                    rng=rng,
                    seed=seed,
                    streams=router_kill_streams,
                    tokens_per_stream=router_kill_tokens,
                )

            repair_totals = {
                k: sum(r.stats()[k] for r in repair_planes)
                for k in (
                    "probes_sent", "summaries_sent", "keys_pushed",
                    "oplogs_reemitted", "heals",
                )
            }
            return {
                "nodes": len({n.cfg.local_addr for n in nodes}),
                "topology": "4 prefill + 2 decode + 2 routers (inproc)",
                "replication_factor": replication_factor,
                "round_budget": round_budget,
                "fault_plan": {
                    "seed": seed,
                    "drop_p": drop_p,
                    "drop_window_s": fault_end_s,
                    "partition_s": partition_s,
                    "partitioned_node": partitioned,
                    "frames_dropped": int(plan.counters.get("dropped", 0)),
                    "frames_delivered": int(plan.counters.get("delivered", 0)),
                },
                "served": {
                    "attempted": attempted,
                    "ok": ok,
                    "ok_rate_during_fault": round(ok / max(1, attempted), 4),
                },
                "divergence": {
                    "detected": bool(diverged_detected),
                    "peak_diverged_pairs": peak_diverged,
                    "max_age_s": round(max_age, 3),
                },
                "repair": {
                    "converged": bool(converged),
                    "converge_s": round(converge_s, 3),
                    "max_episode_rounds": int(max_rounds),
                    "within_round_budget": bool(
                        converged and max_rounds <= round_budget
                    ),
                    **repair_totals,
                },
                "quiescence": {
                    "window_s": quiesce_window_s,
                    "traffic_before": traffic_before,
                    "traffic_after": traffic_after,
                    "quiet": traffic_after == traffic_before,
                },
                "drain": drain_report,
                "join": join_report,
                "crash": crash_report,
                "rebalance": rebalance_report,
                "router_kill": router_kill_report,
                "wall_s": round(_time.monotonic() - t_start, 3),
            }
    finally:
        for lc in lifecycle_planes:
            lc.close()
        for r in repair_planes:
            r.close()
        for p in fleet_planes:
            p.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()


def _obs_zipf_heat_phase(
    *,
    ring,
    router_mesh,
    by_rank,
    rng,
    wait_for,
    zipf_keys: int,
    zipf_inserts: int,
    zipf_alpha: float,
    key_len: int,
) -> dict:
    """Per-shard heat & skew under a zipf-keyed insert mix (the doctor
    workload's pathology (a)).

    ``zipf_keys`` distinct subtree roots receive deterministic insert
    counts ∝ rank^-alpha (counts, not samples — the ground-truth shard
    load is then computable exactly). Each key's traffic lands at its
    shard's PRIMARY owner (what the router would do) and replicates to
    the co-owners; every node then publishes one SHARD_SUMMARY whose
    heat trailer gossips the decayed loads, and the ROUTER — which holds
    no tree and saw none of the inserts — must detect the hot shard,
    score the skew, and name the hot shard's owner set correctly."""
    import time as _time

    from radixmesh_tpu_torch.cache.sharding import shard_of_tokens

    # Deterministic zipf counts per key (rank-frequency, heaviest first).
    weights = np.arange(1, zipf_keys + 1, dtype=np.float64) ** (-zipf_alpha)
    counts = np.maximum(
        1, np.floor(zipf_inserts * weights / weights.sum()).astype(int)
    )
    keys = [
        np.concatenate(
            [
                np.asarray([7001 + k], dtype=np.int32),
                rng.integers(1, 600, size=key_len - 1).astype(np.int32),
            ]
        )
        for k in range(zipf_keys)
    ]
    any_node = ring[0]
    page = max(1, any_node.page)
    ownership = any_node.ownership
    # Ground truth: tokens generated per shard (insert tokens + the hit
    # walks below) — the shard the workload actually made hottest, which
    # is the hot KEY's shard unless blake2b collided several mid-weight
    # keys into one (the truth is then that shard; the detector must
    # find IT, not our guess).
    truth: dict[int, int] = {}
    t0 = _time.monotonic()
    total = 0
    for k, key in enumerate(keys):
        sid = shard_of_tokens(key[:page])
        primary = ownership.primary(sid)
        node = by_rank[primary]
        slots = np.arange(len(key), dtype=np.int32)
        n = int(counts[k])
        for _ in range(n):
            node.insert(key, slots)
            # Every other insert also exercises the hit-heat path (a
            # served prefix is load too — a read-hot shard must read hot).
            node.match_prefix(key)
        truth[sid] = truth.get(sid, 0) + n * len(key) * 2
        total += n
    expected_sid = max(truth, key=truth.get)
    expected_owners = sorted(ownership.owners_of(expected_sid))
    for n in ring:
        n.broadcast_shard_summary()
    # The router folds heat from the gossiped summaries (master fan-out).
    wait_for(
        lambda: router_mesh.fleet.shard_heat()["reporters"] >= len(ring) - 1
    )

    # Reporters is a set size, which an earlier fold already satisfies, so
    # also wait until the router holds every node's post-storm summary: a
    # node's decayed loads only fall once the storm is over, so the fold of
    # a summary sent after it reads at least the node's current load on
    # each owned shard, and one sent before it lacks the storm's inserts.
    # (The JAX scenario waits on reporters, and on the skew, alone: a fold
    # of only some owners' summaries can name another shard.)
    def folded() -> bool:
        by_rank = router_mesh.fleet.shard_heat()["by_rank"]
        for n in ring:
            seen = by_rank.get(str(n.rank), {})
            owned = n.ownership.owned_shards(n.rank)
            for sid, load in n.heat.loads().items():
                if sid in owned and seen.get(str(sid), 0.0) < load * (1 - 1e-3) - 1e-3:
                    return False
        return True

    wait_for(folded)
    report = router_mesh.shard_heat_report()
    detected = report.get("hot_shard")
    return {
        "performed": True,
        "inserts": int(total),
        "distinct_keys": int(zipf_keys),
        "zipf_alpha": float(zipf_alpha),
        "skew_score": report["skew_score"],
        "hot_shard": detected,
        "expected_hot_shard": int(expected_sid),
        "hot_owners": sorted(report.get("hot_owners", [])),
        "expected_hot_owners": expected_owners,
        "owner_set_correct": bool(
            detected == expected_sid
            and sorted(report.get("hot_owners", [])) == expected_owners
        ),
        "reporters": int(report["reporters"]),
        "reported_shards": len(report["shards"]),
        "heat_s": round(_time.monotonic() - t0, 3),
    }


def _obs_stitch_phase(
    *,
    by_addr,
    cr,
    plan,
    decode,
    rng,
    seed,
    streams: int,
    tokens_per_stream: int,
    deadline_s: float,
    on_kill=lambda addr: None,
) -> tuple[dict, list]:
    """OBS leg (a): crash + resurrection under full tracing — the
    chaos-style run whose spans must stitch into ONE multi-node
    timeline. Live streams decode with every emitted token published to
    the mesh UNDER THE STREAM'S TRACE ID (the oplog trace trailer); the
    busiest decode node is process-killed mid-stream; the recovery edge
    resurrects the interrupted streams on the survivor. Returns the
    phase report plus the interrupted records (the stitch audit reads
    their trace ids)."""
    import time as _time

    from radixmesh_tpu_torch.policy.retry import RetryPolicy
    from radixmesh_tpu_torch.server.recovery import HopTimeout, RecoveryCoordinator

    t_phase = _time.monotonic()
    policy = RetryPolicy(
        hop_timeout_s=0.3,
        max_retries=4,
        backoff_base_s=0.05,
        backoff_max_s=0.3,
        jitter_frac=0.25,
    )
    coord = RecoveryCoordinator(policy, name="obs-edge", seed=seed)

    def token_of(stream_seed: int, i: int) -> int:
        return int((stream_seed * 7919 + i * 104729 + 13) % 600)

    stream_recs = []
    for s in range(streams):
        prompt = rng.integers(0, 600, size=9).astype(np.int32)
        rec = coord.admit(prompt, deadline_s=deadline_s, seed=seed * 977 + s)
        res = cr.cache_aware_route(prompt)
        rec.addr = res.decode_addr
        stream_recs.append(rec)

    def emit_one(rec) -> None:
        node = by_addr[rec.addr]
        i = len(rec.delivered)
        tok = token_of(rec.seed, i)
        key = np.concatenate(
            [rec.resume_key(), np.asarray([tok], dtype=np.int32)]
        )
        # The mesh publish carries the stream's trace id: co-owner
        # replicas open replication_lag spans under it — the stitched
        # view's replication edges.
        node.insert(key, np.arange(len(key), dtype=np.int32),
                    trace_id=rec.trace_id)
        rec.deliver(tok)

    half = tokens_per_stream // 2
    for _ in range(half):
        for rec in stream_recs:
            emit_one(rec)

    per_addr: dict = {}
    for rec in stream_recs:
        per_addr[rec.addr] = per_addr.get(rec.addr, 0) + 1
    victim = max(decode, key=lambda a: per_addr.get(a, 0))
    interrupted = [r for r in stream_recs if r.addr == victim]
    # A kill that wins the race with the ring leaves no replication_lag
    # span under the streams' trace ids (zero replication edges, now and
    # then, in the JAX scenario).
    copies_before_kill = _await_survivor_copies(by_addr, decode, victim, interrupted)
    plan.kill(victim)
    on_kill(victim)  # the process dies whole: its planes die with it
    by_addr[victim].close()

    def make_route_fn(rec):
        def route_fn(key, exclude):
            cur = rec.addr
            if cur is not None and cur not in exclude:
                return cur
            return cr.cache_aware_route(key, exclude=exclude).decode_addr

        return route_fn

    def serve_fn(addr, rec, hop_deadline_s):
        deadline = _time.monotonic() + hop_deadline_s
        while len(rec.delivered) < tokens_per_stream:
            if plan.is_killed(addr):
                wait = deadline - _time.monotonic()
                if wait > 0:
                    _time.sleep(wait)
                raise HopTimeout(f"no progress from {addr}")
            emit_one(rec)

    failed = 0
    for rec in stream_recs:
        try:
            coord.run_to_completion(rec, make_route_fn(rec), serve_fn)
        except Exception:  # noqa: BLE001 — failures are the measurement
            failed += 1
    resumed = sum(1 for r in interrupted if r.done and r.resurrections)
    report = {
        "performed": True,
        "node": victim,
        "streams": streams,
        "tokens_per_stream": tokens_per_stream,
        "interrupted": len(interrupted),
        "copies_before_kill": copies_before_kill,
        "resumed": resumed,
        "failed": failed,
        "stitch_s": round(_time.monotonic() - t_phase, 3),
    }
    return report, interrupted


def run_obs_workload(
    seed: int = 0,
    replication_factor: int = 3,
    streams: int = 8,
    tokens_per_stream: int = 20,
    zipf_keys: int = 64,
    zipf_inserts: int = 400,
    zipf_alpha: float = 1.4,
    key_len: int = 8,
    summary_interval_s: float = 0.2,
    deadline_s: float = 20.0,
    timeout_s: float = 60.0,
    engine_steps: bool = True,
    stitched_trace_path: str | None = None,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The mesh-wide observability acceptance scenario (the JAX package's
    ``bench.validate_obs`` pins its artifact) — three legs over one
    sharded cluster (4 prefill + 2 decode + 1 router, rf defaults 3):

    a. **Cross-node trace stitching.** A chaos-style crash+resurrection
       run under full tracing: every emitted token's mesh publish
       carries the stream's 64-bit trace id (oplog trace trailer), the
       busiest decode node is killed mid-stream, interrupted streams
       resurrect on the survivor — and ONE stitched Perfetto export
       must show the interrupted request's spans on ≥ 3 node tracks
       under a single trace id, with publish/replication edges visible.
    b. **Per-shard heat & skew.** Zipf-keyed inserts provably drive the
       skew score: the router — no tree replica, fed only by SHARD_SUMMARY
       heat trailers — must name the hot shard, its owner set, and a
       skew score above the artifact's floor.
    c. **Step attribution.** An engine with ``step_accounting=True``
       serves a short burst and must report per-wave MFU + pad fraction
       for BOTH prefill and decode.

    Plus the **wire gate**: a traceless INSERT frame is bit-identical
    to the encoding without trace support (no flag, no trailer) and a
    traced frame differs by exactly the 8-byte trailer.

    ``cfg``: the model leg (c)'s engine serves (default: the toy model);
    ``device``: CUDA unless ``"cpu"``. The process-wide inproc hub and
    flight recorder are reset and restored when the scenario ends."""
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.cache.oplog import Oplog, OplogType, serialize
    from radixmesh_tpu_torch.comm import faults
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.obs.trace_plane import (
        FlightRecorder,
        get_recorder,
        set_recorder,
        stitch_traces,
    )

    def wait_for(pred, timeout=timeout_s, interval=0.02):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    prev_recorder = get_recorder()
    set_recorder(
        FlightRecorder(capacity=1 << 16, sample=1.0, node="obs-edge")
    )
    # 4 prefills so rf=3 owner sets are PROPER subsets of the prefill
    # role (an all-nodes-own-everything fleet would make the hot-owner
    # gate vacuous); 2 decodes so the crash leaves a survivor that
    # co-owns every shard (decode owners = min(rf, 2)).
    prefill = ["op0", "op1", "op2", "op3"]
    decode = ["od0", "od1"]
    router_addrs = ["or0"]
    plan = faults.FaultPlan(seed=seed)
    nodes: list = []
    fleet_planes: list = []
    try:
        with faults.injected(plan):
            from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane

            for addr in prefill + decode + router_addrs:
                node_cfg = MeshConfig(
                    prefill_nodes=prefill,
                    decode_nodes=decode,
                    router_nodes=router_addrs,
                    local_addr=addr,
                    protocol="inproc",
                    tick_interval_s=0.1,
                    gc_interval_s=60.0,
                    failure_timeout_s=60.0,
                    replication_factor=replication_factor,
                    shard_summary_interval_s=summary_interval_s,
                )
                nodes.append(MeshCache(node_cfg, pool=None).start())
            for n in nodes:
                if not n.wait_ready(timeout=timeout_s):
                    raise RuntimeError(
                        f"node {n.rank} never passed the barrier"
                    )
            ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
            router_mesh = nodes[-1]
            by_addr = {n.cfg.local_addr: n for n in ring}
            by_rank = {n.rank: n for n in ring}
            # Digest gossip feeds the stitcher's clock-offset estimates
            # (FleetView.clock_offsets) — the "correction from the
            # existing digest timestamps" leg of the stitch contract.
            fleet_planes = [
                FleetPlane(n, interval_s=0.2).start() for n in ring
            ]
            plane_of = dict(zip([n.cfg.local_addr for n in ring], fleet_planes))
            from radixmesh_tpu_torch.router.cache_aware_router import (
                CacheAwareRouter,
            )

            cr = CacheAwareRouter(router_mesh, router_mesh.cfg)
            cr.watch_topology()
            cr.finish_warm_up()
            wait_for(lambda: len(router_mesh.fleet.clock_offsets()) >= 1)

            # -- leg (b) first: heat needs the full fleet alive --------
            heat_report = _obs_zipf_heat_phase(
                ring=ring,
                router_mesh=router_mesh,
                by_rank=by_rank,
                rng=rng,
                wait_for=wait_for,
                zipf_keys=zipf_keys,
                zipf_inserts=zipf_inserts,
                zipf_alpha=zipf_alpha,
                key_len=key_len,
            )

            # -- leg (a): crash + resurrection under full tracing ------
            stitch_report, interrupted = _obs_stitch_phase(
                by_addr=by_addr,
                cr=cr,
                plan=plan,
                decode=decode,
                rng=rng,
                seed=seed,
                streams=streams,
                tokens_per_stream=tokens_per_stream,
                deadline_s=deadline_s,
                on_kill=lambda addr: plane_of[addr].close(),
            )

            # Stitch audit: ONE merged export; the interrupted request's
            # spans must land on >= 3 distinct node tracks under its
            # single trace id, with publish + replication edges visible.
            rec = get_recorder()
            spans = rec.snapshot()
            # Clock-offset correction from the digest timestamps the
            # fleet already gossips (rank-keyed → node-label-keyed).
            offsets = {
                by_rank[r]._node_label: off
                for r, off in router_mesh.fleet.clock_offsets().items()
                if r in by_rank
            }
            stitched = stitch_traces([rec.export_spans()], offsets)
            best = {"trace_id": 0, "nodes": set(), "lag": 0, "publish": 0}
            for irec in interrupted:
                tid = irec.trace_id
                node_set = {
                    s.node for s in spans if s.trace_id == tid and s.node
                }
                lag = sum(
                    1
                    for s in spans
                    if s.trace_id == tid and s.name == "replication_lag"
                )
                pub = sum(
                    1
                    for s in spans
                    if s.trace_id == tid and s.name == "mesh_publish"
                )
                if len(node_set) > len(best["nodes"]):
                    best = {
                        "trace_id": tid, "nodes": node_set,
                        "lag": lag, "publish": pub,
                    }
            stitch_report.update(
                {
                    "trace_id": f"{best['trace_id']:#018x}",
                    "node_tracks": len(best["nodes"]),
                    "nodes_on_track": sorted(best["nodes"]),
                    "replication_edges": int(best["lag"]),
                    "publish_edges": int(best["publish"]),
                    "span_count": len(spans),
                    "stitched_events": len(stitched["traceEvents"]),
                    "clock_offsets_applied": len(offsets),
                }
            )
            if stitched_trace_path:
                import json as _json

                with open(stitched_trace_path, "w") as fh:
                    _json.dump(stitched, fh)
                stitch_report["stitched_artifact"] = stitched_trace_path

            # -- wire gate: traceless frames are the untraced wire, bit for bit --
            base = dict(
                op_type=OplogType.INSERT,
                origin_rank=0,
                logic_id=7,
                ttl=3,
                key=np.arange(1, 9, dtype=np.int32),
                value=np.arange(8, dtype=np.int32),
                value_rank=0,
            )
            import radixmesh_tpu_torch.cache.oplog as oplog_mod

            plain = serialize(Oplog(**base))
            traced = serialize(Oplog(**base, trace_id=0xA5A5_5A5A_DEAD_BEEF))
            # Strip the trailer + clear the flag bit: the result must be
            # BYTE-IDENTICAL to the traceless frame — i.e. tracing-off
            # frames are exactly the untraced wire, and tracing adds
            # exactly (flag bit, 8-byte trailer) and nothing else.
            stripped = bytearray(traced[:-8])
            stripped[oplog_mod._FLAGS_OFFSET] &= ~oplog_mod._FLAG_TRACE
            wire_report = {
                "rf0_traceless_unchanged": bool(
                    bytes(stripped) == plain
                    and oplog_mod.deserialize(plain).trace_id == 0
                ),
                "trace_trailer_roundtrip": bool(
                    oplog_mod.deserialize(traced).trace_id
                    == 0xA5A5_5A5A_DEAD_BEEF
                ),
                "trailer_bytes": len(traced) - len(plain),
            }
    finally:
        set_recorder(prev_recorder)
        for p in fleet_planes:
            p.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()

    # -- leg (c): step attribution on an engine -------------------------
    steps_report: dict = {"performed": False}
    if engine_steps:
        from radixmesh_tpu_torch.engine.engine import Engine
        from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
        from radixmesh_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        mcfg = cfg if cfg is not None else ModelConfig.tiny()
        eng = Engine(
            mcfg,
            init_params(mcfg, seed, device),
            num_slots=512,
            page_size=4,
            max_batch=2,
            name="obs-steps",
            step_accounting=True,
            device=device,
        )
        try:
            sampling = None
            prompts = [list(range(1, 14)), list(range(1, 18)), list(range(1, 14))]
            eng.generate(prompts, sampling)
            acct = eng.step_acct.report()
        finally:
            eng.close()
        steps_report = {
            "performed": True,
            "n_params": acct["n_params"],
            "peak_tflops": acct["peak_tflops"],
            "prefill": {
                k: acct["prefill"][k]
                for k in (
                    "waves", "real_tokens", "padded_tokens", "mfu",
                    "pad_fraction",
                )
            },
            "decode": {
                k: acct["decode"][k]
                for k in (
                    "waves", "real_tokens", "padded_tokens", "mfu",
                    "pad_fraction",
                )
            },
        }

    return {
        "nodes": len(prefill) + len(decode) + len(router_addrs),
        "topology": "4 prefill + 2 decode + 1 router (inproc)",
        "replication_factor": replication_factor,
        "stitch": stitch_report,
        "heat": heat_report,
        "steps": steps_report,
        "wire": wire_report,
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


def run_kvflow_workload(
    n_restore_requests: int = 3,
    prompt_tokens: int = 1536,
    gen_len: int = 2,
    # Three chunks per restore unit at the default prompt length: the
    # artifact must exercise the multi-chunk staging path, not just the
    # degenerate one-chunk case.
    chunk_tokens: int = 512,
    background_tokens: int = 48,
    repeats: int = 3,
    seed: int = 0,
    max_steps: int = 20_000,
    *,
    cfg=None,
    device=None,
) -> dict:
    """Drive the async KV-movement plane (``cache/kv_transfer.py``)
    through its three lanes against the synchronous baseline — the
    KVFLOW artifact's data source.

    **Restore TTFT** (phase A): seed ``n_restore_requests`` distinct
    long prefixes, write them back to the host tier, then re-serve them
    in a MIXED burst — each restore request interleaved with a fresh
    (uncached) request — and compare the burst's mean TTFT between the
    synchronous inline-restore path and the staged plane. The mix is the
    claim's shape: synchronously, every admission in the pass convoys
    behind the serial inline restores (fresh requests pay for KV copies
    they don't need); with the plane, restoring requests park and fresh
    ones admit immediately, so the burst mean drops even though the
    parked requests themselves land at rough parity (both sub-means are
    reported). Runs ``repeats`` interleaved trials per mode (fresh
    engines, shared weights) to decorrelate machine drift.

    **Decode overlap** (phase B): the same burst with a background
    request decoding. The synchronous engine restores inline inside
    ``_admit`` — decode provably makes ZERO progress while any restore
    is in flight; the plane engine parks the requests and keeps
    stepping. ``decode_steps_during_restore`` is the claim's direct
    counter, and the max inter-decode-step gap bounds the stall.

    **Write-back**: the eviction sweeps above pin the fused-gather
    contract — one device gather per sweep regardless of node count
    (``HierarchicalCache.wb_gathers / wb_sweeps``), both modes.

    **Prefetch** (phase C): re-evict, fire idempotent hints (duplicates
    included) for every prefix, let the plane restore with NO request in
    the system, then submit the requests — ``hit_ahead_rate`` is the
    fraction that admitted without parking (their restore ran ahead of
    them).

    CPU-runnable by design: the phenomena under test are scheduling
    overlaps, not FLOPs — but on CPU the restore copies are small next
    to compute, so treat the TTFT comparison as structural (does
    overlapping REGRESS TTFT?) rather than a hardware claim; on the card
    the story is the bytes moved per stall-free decode step.

    ``cfg``: the model the engines serve (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``. Engines are closed as they are
    done with (``Engine.close`` stops the plane's worker).
    """
    import time as _time

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    # Wider-KV small model: restore bytes per token are what the plane
    # moves, FLOPs are what CPU steps cost — keep the former meaningful.
    cfg = cfg if cfg is not None else ModelConfig(
        vocab_size=256, hidden=128, n_layers=4, n_heads=4, n_kv_heads=4,
        head_dim=64, intermediate=256,
        max_seq_len=max(2048, 2 * prompt_tokens),
    )
    params = init_params(cfg, seed, device)
    rng = np.random.default_rng(seed)
    page_size = 4
    prompts = [
        rng.integers(1, cfg.vocab_size - 1, size=prompt_tokens).astype(np.int32)
        for _ in range(n_restore_requests)
    ]

    def fresh_prompts() -> list[np.ndarray]:
        """Distinct uncached companions for one burst (never repeated, so
        no trial ever serves them from the cache)."""
        return [
            rng.integers(
                1, cfg.vocab_size - 1, size=max(64, prompt_tokens // 6)
            ).astype(np.int32)
            for _ in range(n_restore_requests)
        ]

    bg_prompt = rng.integers(
        1, cfg.vocab_size - 1, size=max(16, prompt_tokens // 4)
    ).astype(np.int32)
    sampling = SamplingParams(temperature=0.0, max_new_tokens=gen_len)
    bg_sampling = SamplingParams(temperature=0.0, max_new_tokens=background_tokens)
    t_start = _time.monotonic()

    # Phase A (the TTFT comparison) stages WHOLE restore units: the sync
    # path pays one pool scatter per node. The size is the JAX scenario's,
    # chosen there because on XLA:CPU every scatter copies the entire pool
    # buffer, so per-chunk scatters would tax the async side with copies
    # a device's in-place update never pays — the comparison must differ
    # only in WHERE the copy blocks, not in how many device ops run. Phases B/C run at ``chunk_tokens`` so the
    # multi-chunk staging pipeline is exercised under measurement too.
    ttft_chunk_tokens = max(chunk_tokens, prompt_tokens)

    def make_engine(use_plane: bool, tag: str, chunk: int | None = None) -> Engine:
        return Engine(
            cfg,
            params,
            # Sized to the workload, not generously, as the JAX scenario
            # sizes it: on XLA:CPU every pool scatter copies the whole
            # buffer, so an oversized pool taxes the async path's
            # per-chunk scatters hardest. The port's pool is written in
            # place on either device.
            num_slots=max(
                4096, (n_restore_requests + 1) * prompt_tokens + 4096
            ),
            page_size=page_size,
            max_batch=2 * n_restore_requests + 1,
            host_cache_slots=max(
                8192, (n_restore_requests + 2) * prompt_tokens * 2
            ),
            kv_transfer_async=use_plane,
            kv_transfer_chunk_tokens=chunk if chunk is not None else chunk_tokens,
            name=tag,
            device=device,
        )

    def close(eng: Engine) -> None:
        eng.close()

    def seed_and_evict(eng: Engine) -> dict:
        for p in prompts:
            eng.generate([list(p)], sampling)
        t0 = _time.monotonic()
        eng.tree.evict(10 * prompt_tokens * n_restore_requests)
        stall = _time.monotonic() - t0
        if eng.kv_transfer is not None:
            eng.kv_transfer.wait_host_ready()
        return {
            "evict_stall_s": stall,
            "sweeps": eng.tree.wb_sweeps,
            "gathers": eng.tree.wb_gathers,
        }

    def serve_burst(eng: Engine, background: bool, mixed: bool = False) -> dict:
        bg = None
        if background:
            bg = eng.add_request(list(bg_prompt), bg_sampling)
            eng.step()  # admit + first decode for the background row
        reqs = []
        fresh = fresh_prompts() if mixed else []
        for i, p in enumerate(prompts):
            reqs.append(eng.add_request(list(p), sampling))
            if mixed:
                reqs.append(eng.add_request(list(fresh[i]), sampling))
        restore_rids = {r.rid for r in reqs[:: 2 if mixed else 1]}
        parked: set = set()
        decode_steps_during_restore = 0
        last_decode_t = _time.monotonic()
        max_gap = 0.0
        for _ in range(max_steps):
            before = eng.stats.decode_steps
            eng.step()
            now = _time.monotonic()
            restoring = bool(getattr(eng, "_restoring", ()))
            for r in reqs:
                if r.state is RequestState.RESTORING:
                    parked.add(r.rid)
            stepped = eng.stats.decode_steps - before
            if stepped and background:
                # Max inter-decode-step gap: the synchronous path's
                # inline restores stretch it (admission blocks the whole
                # step); the plane keeps it at ~one step time.
                max_gap = max(max_gap, now - last_decode_t)
                last_decode_t = now
            if restoring:
                decode_steps_during_restore += stepped
            if all(r.state is RequestState.FINISHED for r in reqs):
                break
        if bg is not None and bg.state is not RequestState.FINISHED:
            eng.cancel(bg.rid)
        ttfts = [r.first_token_time - r.submit_time for r in reqs]
        rest_tt = [
            r.first_token_time - r.submit_time
            for r in reqs
            if r.rid in restore_rids
        ]
        fresh_tt = [
            r.first_token_time - r.submit_time
            for r in reqs
            if r.rid not in restore_rids
        ]
        return {
            "mean_ttft_s": float(np.mean(ttfts)),
            "restore_ttft_s": float(np.mean(rest_tt)) if rest_tt else 0.0,
            "fresh_ttft_s": float(np.mean(fresh_tt)) if fresh_tt else 0.0,
            "parked": len(parked),
            "decode_steps_during_restore": decode_steps_during_restore,
            "max_decode_gap_s": max_gap,
        }

    # ---- phase A: restore TTFT, interleaved repeats, no background ----
    # One unmeasured warm-up pair first: both modes share the process's
    # first-use costs (kernel loads, allocator growth, pinned buffers),
    # which would otherwise land entirely on whichever measured trial
    # runs first.
    for warm in (True, False):
        eng = make_engine(warm, f"kvflow-warm-{int(warm)}", chunk=ttft_chunk_tokens)
        seed_and_evict(eng)
        serve_burst(eng, background=False, mixed=True)
        close(eng)
    # Async first within each measured pair: any residual one-time cost
    # still biases AGAINST the overlap claim.
    a_trials: list[dict] = []
    s_trials: list[dict] = []
    wb = {}
    for t in range(max(1, repeats)):
        eng = make_engine(True, f"kvflow-a{t}", chunk=ttft_chunk_tokens)
        wb_a = seed_and_evict(eng)
        a_trials.append(serve_burst(eng, background=False, mixed=True))
        close(eng)
        eng = make_engine(False, f"kvflow-s{t}")
        wb_s = seed_and_evict(eng)
        s_trials.append(serve_burst(eng, background=False, mixed=True))
        close(eng)
        wb = {"async": wb_a, "sync": wb_s}
    a_ttfts = [x["mean_ttft_s"] for x in a_trials]
    s_ttfts = [x["mean_ttft_s"] for x in s_trials]

    # ---- phase B: decode overlap under a live background row ----
    eng_a = make_engine(True, "kvflow-ov-a")
    seed_and_evict(eng_a)
    ov_a = serve_burst(eng_a, background=True)
    eng_s = make_engine(False, "kvflow-ov-s")
    seed_and_evict(eng_s)
    ov_s = serve_burst(eng_s, background=True)
    close(eng_s)

    # ---- phase C: prefetch hit-ahead (reuses the async overlap engine) ----
    plane = eng_a.kv_transfer
    hints_seen0 = plane.hints_seen
    eng_a.tree.evict(10 * prompt_tokens * n_restore_requests)
    plane.wait_host_ready()
    for p in prompts:
        plane.note_hint(p)
        plane.note_hint(p)  # duplicate: must dedupe/join, not double-restore
    hints_sent = plane.hints_seen - hints_seen0
    t0 = _time.monotonic()
    for _ in range(max_steps):
        eng_a.step()
        if plane.idle() or _time.monotonic() - t0 > 30:
            break
    hints_joined = plane.stats()["hints_joined"]
    reqs = [eng_a.add_request(list(p), sampling) for p in prompts]
    parked: set = set()
    for _ in range(max_steps):
        eng_a.step()
        for r in reqs:
            if r.state is RequestState.RESTORING:
                parked.add(r.rid)
        if all(r.state is RequestState.FINISHED for r in reqs):
            break
    hit_ahead = 1.0 - len(parked) / max(1, len(reqs))
    close(eng_a)

    sync_ttft = float(np.mean(s_ttfts))
    over_ttft = float(np.mean(a_ttfts))
    restored_tokens = n_restore_requests * (
        prompt_tokens - prompt_tokens % page_size
    )
    return {
        "restore": {
            "requests": n_restore_requests,
            "repeats": max(1, repeats),
            "sync_ttft_s": round(sync_ttft, 6),
            "overlapped_ttft_s": round(over_ttft, 6),
            "overlap_ratio": (
                round(over_ttft / sync_ttft, 4) if sync_ttft else 0.0
            ),
            "overlap_wins": bool(over_ttft <= sync_ttft),
            "sync_ttft_trials_s": [round(x, 6) for x in s_ttfts],
            "overlapped_ttft_trials_s": [round(x, 6) for x in a_ttfts],
            # Burst composition sub-means: the win comes from fresh
            # admissions no longer convoying behind inline restores;
            # parked requests themselves land at rough parity.
            "sync_restore_ttft_s": round(
                float(np.mean([x["restore_ttft_s"] for x in s_trials])), 6
            ),
            "overlapped_restore_ttft_s": round(
                float(np.mean([x["restore_ttft_s"] for x in a_trials])), 6
            ),
            "sync_fresh_ttft_s": round(
                float(np.mean([x["fresh_ttft_s"] for x in s_trials])), 6
            ),
            "overlapped_fresh_ttft_s": round(
                float(np.mean([x["fresh_ttft_s"] for x in a_trials])), 6
            ),
            "restored_tokens": restored_tokens,
            "parked_requests": ov_a["parked"],
            "decode_steps_during_restore": ov_a["decode_steps_during_restore"],
            "sync_decode_steps_during_restore": ov_s[
                "decode_steps_during_restore"
            ],
            "max_decode_gap_s": round(ov_a["max_decode_gap_s"], 6),
            "sync_max_decode_gap_s": round(ov_s["max_decode_gap_s"], 6),
        },
        "writeback": {
            "tokens_written_back": restored_tokens,
            "sweeps": int(wb["async"]["sweeps"]),
            "gathers": int(wb["async"]["gathers"]),
            "gathers_per_sweep": round(
                wb["async"]["gathers"] / max(1, wb["async"]["sweeps"]), 4
            ),
            "sync_gathers_per_sweep": round(
                wb["sync"]["gathers"] / max(1, wb["sync"]["sweeps"]), 4
            ),
            "evict_stall_s": round(wb["async"]["evict_stall_s"], 6),
            "sync_evict_stall_s": round(wb["sync"]["evict_stall_s"], 6),
        },
        "prefetch": {
            "hints_sent": int(hints_sent),
            "hints_joined": int(hints_joined),
            "hit_ahead_rate": round(hit_ahead, 4),
        },
        "chunk_tokens": chunk_tokens,
        "ttft_chunk_tokens": ttft_chunk_tokens,
        "page_size": page_size,
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


def run_tier_workload(
    n_prefixes: int = 16,
    prefix_tokens: int = 384,
    host_slots: int = 512,
    n_streams: int = 5,
    stream_tail_tokens: int = 48,
    stream_max_new: int = 12,
    interrupt_after: int = 4,
    seed: int = 0,
    max_steps: int = 40_000,
    *,
    cfg=None,
    device=None,
) -> dict:
    """Drive the durable KV spill tier (``cache/kv_tier.py``) through
    the TIER artifact's three claims — the data source for
    ``bench.validate_tier`` / ``scripts/tierbench.py``.

    **Capacity** (phase A): a working set of ``n_prefixes`` distinct
    ``prefix_tokens``-token prefixes — sized >= 10x the host arena —
    served once, churned through eviction (device → host → disk via the
    write-behind destager), then RE-served. With the tier, pass 2 is a
    near-pure cache hit (restores from verified extents); the no-tier
    baseline's host arena can hold only a sliver of the set, so its
    pass-2 hit-rate collapses. The artifact's headline value is the
    hit-rate ratio.

    **Restore overlap** (phase B): every prefix demoted to DISK-only
    residency, then a burst of re-serves against a live background
    decode — requests park in ``RESTORING`` behind staged extent reads
    while decode keeps stepping (``decode_steps_during_restore > 0`` is
    KVFLOW's decode-never-blocks contract extended one tier down).

    **Cold-cell resurrection** (phase C): a fresh cell serves
    ``n_streams`` seeded streams sharing a long warm prefix (already
    spilled to extents), is KILLED HARD mid-decode (every volatile tier
    destroyed with it, no flush), one committed extent is bit-flipped
    and another truncated (the power-loss corruption model), and a new
    cell boots from the extent directory alone: corrupt extents must be
    detected and dropped (never served), every interrupted stream must
    resume byte-identical to its deterministic seeded expectation
    (the seeded-replay contract), and the resumed prefills must actually
    hit disk-restored KV.

    CPU-runnable by design: the phenomena are tier transitions and
    crash recovery, not FLOPs.

    ``cfg``: the model the engines serve (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``. The extents live in a
    ``tempfile.mkdtemp`` directory, removed (and every engine closed)
    when the scenario ends, however it ends.
    """
    import os
    import shutil
    import tempfile
    import time as _time

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig(
            vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
            head_dim=32, intermediate=128, max_seq_len=2048,
        )
    params = init_params(cfg, seed, device)
    rng = np.random.default_rng(seed)
    page_size = 4
    t_start = _time.monotonic()
    root = tempfile.mkdtemp(prefix="tierwl-")
    engines: list = []
    try:
        gen = SamplingParams(temperature=0.0, max_new_tokens=2)

        prefixes = [
            rng.integers(1, cfg.vocab_size - 1, size=prefix_tokens).astype(
                np.int32
            )
            for _ in range(n_prefixes)
        ]
        working_set = n_prefixes * prefix_tokens

        def make_engine(tier_dir: str | None, tag: str) -> Engine:
            eng = Engine(
                cfg,
                params,
                num_slots=max(1024, 2 * prefix_tokens + 512),
                page_size=page_size,
                max_batch=n_streams + 1,
                host_cache_slots=host_slots,
                kv_tier_dir=tier_dir,
                kv_tier_watermark=0.0,  # destage eagerly: durability first
                kv_tier_destage_budget=64,
                kv_tier_destage_interval_s=0.0,  # deterministic per-pump spills
                # Fine-grained staging: each extent restores in several
                # chunks, so the parked window is wide enough to measure
                # decode overlap against.
                kv_transfer_chunk_tokens=64,
                kv_transfer_async=tier_dir is None,  # baseline gets a plane too
                name=tag,
                device=device,
            )
            engines.append(eng)
            return eng

        def settle(eng: Engine, timeout: float = 20.0) -> None:
            """Run the engine's pump until every spill has committed (the
            write-behind destager needs engine pumps to install refs)."""
            plane = eng.kv_transfer
            if plane is None:
                return
            plane.wait_host_ready()
            deadline = _time.monotonic() + timeout
            while _time.monotonic() < deadline:
                eng.step()  # no work -> pure pump/destage service
                if plane.spills_idle():
                    return
                plane.wait_progress(0.01)

        def churn_pass(eng: Engine, reverse: bool = False) -> tuple[int, int]:
            """Serve every prefix once, evicting between requests (the
            pressure that drives device → host → disk). Returns the pass's
            (cached, prompt) token deltas. The measured pass runs in
            REVERSE order — most-recently-evicted first — which is the
            no-tier baseline's BEST case (its arena can only retain the
            tail of the set), so the comparison is biased against the
            claim."""
            c0, p0 = eng.stats.cached_tokens, eng.stats.prompt_tokens
            for p in (reversed(prefixes) if reverse else prefixes):
                eng.generate([list(p)], gen)
                eng.tree.evict(10 * prefix_tokens)
                settle(eng)
            return (
                eng.stats.cached_tokens - c0,
                eng.stats.prompt_tokens - p0,
            )

        # ---- phase A: hit-rate at >= 10x host capacity, tier vs no tier --
        tier_dir = os.path.join(root, "tier-a")
        eng_t = make_engine(tier_dir, "tier-a")
        churn_pass(eng_t)  # pass 1: populate + spill
        t_cached, t_prompt = churn_pass(eng_t, reverse=True)
        tier_hit = t_cached / max(1, t_prompt)

        eng_b = make_engine(None, "tier-base")
        churn_pass(eng_b)
        b_cached, b_prompt = churn_pass(eng_b, reverse=True)
        base_hit = b_cached / max(1, b_prompt)
        eng_b.close()

        tier = eng_t._kv_tier
        moves = list(tier.recent_moves)
        spill_section = {
            "spilled_tokens": int(tier._m_spilled.value),
            "extents": int(tier.extents),
            "demotes": sum(1 for m in moves if m[2] == "demote"),
            "promotes": sum(1 for m in moves if m[2] == "promote"),
            "drops": sum(1 for m in moves if m[2] == "drop"),
            "resident_bytes": int(tier.resident_bytes),
        }

        # ---- phase B: decode never blocks on disk restores ---------------
        # Demote EVERYTHING to disk-only residency: device -> host (free for
        # disk-backed nodes), then shed every host copy.
        eng_t.tree.evict(10 * working_set)
        settle(eng_t)
        eng_t.tree._evict_host(10 * working_set)
        bg_prompt = rng.integers(1, cfg.vocab_size - 1, size=64).astype(np.int32)
        bg = eng_t.add_request(
            list(bg_prompt), SamplingParams(temperature=0.0, max_new_tokens=64)
        )
        eng_t.step()  # admit + first decode for the background row
        burst = [
            eng_t.add_request(list(p), gen) for p in prefixes[: 3]
        ]
        parked: set = set()
        decode_during_restore = 0
        last_t = _time.monotonic()
        max_gap = 0.0
        for _ in range(max_steps):
            before = eng_t.stats.decode_steps
            eng_t.step()
            now = _time.monotonic()
            for r in burst:
                if r.state is RequestState.RESTORING:
                    parked.add(r.rid)
            stepped = eng_t.stats.decode_steps - before
            if stepped:
                max_gap = max(max_gap, now - last_t)
                last_t = now
            if getattr(eng_t, "_restoring", ()):
                decode_during_restore += stepped
            if all(r.state is RequestState.FINISHED for r in burst):
                break
        if bg.state is not RequestState.FINISHED:
            eng_t.cancel(bg.rid)
        restore_section = {
            "parked_requests": len(parked),
            "disk_restored_tokens": int(tier._m_restored.value),
            "decode_steps_during_restore": int(decode_during_restore),
            "max_decode_gap_s": round(max_gap, 6),
            "overlap_ok": bool(parked) and decode_during_restore > 0,
        }
        eng_t.close()

        # ---- phase C: whole-cell kill -> corrupt -> resurrect -> resume --
        cold_dir = os.path.join(root, "tier-cold")
        shared = rng.integers(1, cfg.vocab_size - 1, size=prefix_tokens).astype(
            np.int32
        )
        tails = [
            rng.integers(1, cfg.vocab_size - 1, size=stream_tail_tokens).astype(
                np.int32
            )
            for _ in range(n_streams)
        ]
        stream_prompts = [list(shared) + list(t) for t in tails]
        stream_samps = [
            SamplingParams(
                temperature=0.9, top_p=0.95, seed=7000 + i,
                max_new_tokens=stream_max_new,
            )
            for i in range(n_streams)
        ]

        # Deterministic expectation (the seeded-replay contract: same
        # seed => identical continuation on any engine/row/path): each
        # stream's FULL output, computed on a pristine reference engine.
        eng_ref = make_engine(None, "tier-ref")
        expected: list[list[int]] = []
        for pr, sp in zip(stream_prompts, stream_samps):
            req = eng_ref.add_request(pr, sp)
            while eng_ref.has_work():
                eng_ref.step()
            expected.append(list(req.generated))
        eng_ref.close()

        eng_c = make_engine(cold_dir, "tier-c0")
        # Warm + spill the streams' prompts (the shared prefix and each
        # tail become committed extents).
        for pr in stream_prompts:
            eng_c.generate([pr], gen)
            eng_c.tree.evict(10 * prefix_tokens)
            settle(eng_c)
        # Start every stream and interrupt them mid-decode.
        reqs = [
            eng_c.add_request(pr, sp)
            for pr, sp in zip(stream_prompts, stream_samps)
        ]
        for _ in range(max_steps):
            eng_c.step()
            if all(len(r.generated) >= interrupt_after for r in reqs):
                break
        delivered = [list(r.generated) for r in reqs]
        # KILL the whole cell: no drain, no flush — the plane dies with its
        # queues, HBM and the host arena die with the process. Only
        # committed extents survive.
        eng_c.close()
        engines.remove(eng_c)
        del eng_c

        # Power-loss corruption model: one committed extent bit-flipped,
        # one truncated (attack the two smallest — stream tails — so the
        # shared prefix still proves disk-served hits).
        import glob as _glob

        files = sorted(
            _glob.glob(os.path.join(cold_dir, "ext-*.kv")), key=os.path.getsize
        )
        attacked = 0
        if len(files) >= 2:
            with open(files[0], "r+b") as fh:
                fh.seek(os.path.getsize(files[0]) // 2)
                b = fh.read(1)
                fh.seek(-1, 1)
                fh.write(bytes([b[0] ^ 0xFF]))
            with open(files[1], "r+b") as fh:
                fh.truncate(max(8, os.path.getsize(files[1]) - 64))
            attacked = 2

        t_restart = _time.monotonic()
        eng_r = make_engine(cold_dir, "tier-c1")
        restart_s = _time.monotonic() - t_restart
        corrupt_detected = sum(
            int(m.value) for m in eng_r._kv_tier._m_corrupt_by.values()
        )
        c0 = eng_r.stats.cached_tokens
        failed = 0
        identical = 0
        for i, (pr, sp) in enumerate(zip(stream_prompts, stream_samps)):
            try:
                req = eng_r.add_request(pr, sp, resume_tokens=delivered[i])
                for _ in range(max_steps):
                    eng_r.step()
                    if req.state is RequestState.FINISHED:
                        break
                if req.state is not RequestState.FINISHED:
                    failed += 1
                    continue
                final = delivered[i] + list(req.generated)
                if final == expected[i]:
                    identical += 1
                else:
                    failed += 1
            except Exception:
                failed += 1
        disk_hit_tokens = int(eng_r.stats.cached_tokens - c0)
        resumed = identical
        byte_identical = identical == len(reqs) and failed == 0
        cold_section = {
            "performed": True,
            "interrupted": len(reqs),
            "resumed": resumed,
            "byte_identical": bool(byte_identical),
            "failed": int(failed),
            "disk_hit_tokens": disk_hit_tokens,
            "grafted_nodes": int(eng_r.resurrected["grafted_nodes"]),
            "orphaned": int(eng_r.resurrected["orphaned"]),
            "corrupt_detected": int(corrupt_detected),
            # Byte-identity of EVERY resumed stream is the direct evidence
            # no corrupt KV reached decode (the dropped extents degraded to
            # recomputes instead).
            "corrupt_served": 0 if byte_identical else int(failed),
            "restart_s": round(restart_s, 4),
        }
        eng_r.close()

        return {
            "capacity": {
                "working_set_tokens": int(working_set),
                "host_slots": int(host_slots),
                "working_set_ratio": round(working_set / host_slots, 2),
                "tier_hit_rate": round(tier_hit, 4),
                "baseline_hit_rate": round(base_hit, 4),
                # Baseline floored at 1%: a fully-cold baseline would make
                # the ratio meaningless instead of impressive.
                "hit_rate_gain": round(tier_hit / max(0.01, base_hit), 4),
                "requests": 2 * n_prefixes,
                "distinct_prefixes": n_prefixes,
            },
            "spill": spill_section,
            "restore_overlap": restore_section,
            "cold_start": cold_section,
            "corruption": {
                "extents_attacked": attacked,
                "truncated": 1 if attacked else 0,
                "bitflipped": 1 if attacked else 0,
                "detected": int(min(corrupt_detected, attacked))
                if attacked
                else 0,
                "served_corrupt": cold_section["corrupt_served"],
            },
            "page_size": page_size,
            "wall_s": round(_time.monotonic() - t_start, 3),
        }
    finally:
        for eng in engines:
            eng.close()
        shutil.rmtree(root, ignore_errors=True)


def run_doctor_workload(
    seed: int = 0,
    replication_factor: int = 3,
    balanced_shards: int = 24,
    zipf_keys: int = 64,
    zipf_inserts: int = 400,
    zipf_alpha: float = 1.4,
    key_len: int = 8,
    short_prompt: int = 96,
    long_prompt: int = 1536,
    restore_prompt: int = 512,
    restore_chunk_tokens: int = 64,
    summary_interval_s: float = 0.2,
    timeout_s: float = 60.0,
    max_steps: int = 20_000,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The diagnosis-plane acceptance scenario (the JAX package's
    ``bench.validate_doctor`` pins its artifact): one rf=3 inproc mesh
    (4 prefill + 2 decode + 1 router) plus a traced engine, driven
    through a provably HEALTHY phase and then three deterministically
    seeded pathologies — and ONE :class:`~radixmesh_tpu_torch.obs.doctor.
    MeshDoctor` (the burn windows need continuity) must stay silent on
    the former and NAME each of the latter with evidence matching the
    seeded ground truth:

    0. **Healthy.** One balanced insert per ``balanced_shards`` distinct
       shards (skew ≈ 1) at each shard's primary owner, plus a traced
       two-shape engine burst with decode-dominant requests. Every rule
       runs; zero findings is the gate — a diagnosis plane that cries
       wolf gets muted.
    a. **Zipf heat storm** (``_obs_zipf_heat_phase``): deterministic
       rank^-alpha insert counts drive one shard provably hottest; the
       doctor must name THAT shard and its true owner set (the
       rebalancer's trigger evidence).
    b. **Convoying long-prompt burst**: ``long_prompt``-token requests
       served in small prefill waves spend most of their e2e in
       exclusive prefill time and run well slower than the short-shape
       fleet — a prefill convoy, seeded on purpose; the
       doctor must name the convoying SHAPE bucket from the phase
       attributor's per-shape table.
    c. **Throttled restore lane**: host-tier prefixes re-requested
       through a tiny-chunk KV-transfer plane park in RESTORING behind
       a staged-chunk backlog that is never pumped before the
       diagnosis — the doctor must name the restore lane with the live
       parked count.

    The phase attributor audits every traced request along the way; the
    workload returns its sum-error high-water mark so the artifact can
    gate "exclusive phase times sum to e2e within epsilon" on real
    traffic, not just the property test's synthetic traces.

    ``cfg``: the model the engine serves (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``. The process-wide inproc hub and
    flight recorder are reset and restored when the scenario ends."""
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.cache.sharding import shard_of_tokens
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.obs.aggregator import FleetAggregator, InprocPeer
    from radixmesh_tpu_torch.obs.attribution import ensure_attributor, shape_bucket
    from radixmesh_tpu_torch.obs.doctor import MeshDoctor
    from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
    from radixmesh_tpu_torch.obs.trace_plane import (
        FlightRecorder,
        get_recorder,
        set_recorder,
    )
    from radixmesh_tpu_torch.slo.control import OverloadController, SLOConfig
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def wait_for(pred, timeout=timeout_s, interval=0.02):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    def finding_for(report: dict, rule: str) -> dict | None:
        for f in report["findings"]:
            if f["rule"] == rule:
                return f
        return None

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    prev_recorder = get_recorder()
    # 4 prefills so rf=3 owner sets are PROPER subsets of the prefill
    # role (the hot-owner evidence gate must not be vacuous).
    prefill = ["dp0", "dp1", "dp2", "dp3"]
    decode = ["dd0", "dd1"]
    router_addrs = ["dr0"]
    nodes: list = []
    eng = None
    try:
        for addr in prefill + decode + router_addrs:
            node_cfg = MeshConfig(
                prefill_nodes=prefill,
                decode_nodes=decode,
                router_nodes=router_addrs,
                local_addr=addr,
                protocol="inproc",
                tick_interval_s=0.1,
                gc_interval_s=60.0,
                failure_timeout_s=60.0,
                replication_factor=replication_factor,
                shard_summary_interval_s=summary_interval_s,
            )
            nodes.append(MeshCache(node_cfg, pool=None).start())
        for n in nodes:
            if not n.wait_ready(timeout=timeout_s):
                raise RuntimeError(f"node {n.rank} never passed the barrier")
        ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
        router_mesh = nodes[-1]
        by_rank = {n.rank: n for n in ring}
        any_node = ring[0]
        page = max(1, any_node.page)
        ownership = any_node.ownership

        # -- engine (the convoy + restore substrate) -------------------
        mcfg = cfg if cfg is not None else ModelConfig(
            vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
            head_dim=32, intermediate=128,
            max_seq_len=max(4096, 2 * long_prompt),
        )
        eng = Engine(
            mcfg,
            init_params(mcfg, seed, device),
            num_slots=16384,
            page_size=4,
            max_batch=12,
            host_cache_slots=8192,
            kv_transfer_async=True,
            kv_transfer_chunk_tokens=restore_chunk_tokens,
            name="doctor-eng",
            device=device,
            # The JAX scenario's threshold: its CPU jit compiles take
            # seconds, and a serving-tuned 50ms stall threshold would
            # attribute compile time as decode stalls and trip the
            # healthy-phase zero-findings gate.
            token_stall_threshold_s=5.0,
        )

        def prompts_of(n_tokens: int, count: int) -> list[np.ndarray]:
            return [
                rng.integers(
                    1, mcfg.vocab_size - 1, size=n_tokens
                ).astype(np.int32)
                for _ in range(count)
            ]

        short_sampling = SamplingParams(temperature=0.0, max_new_tokens=12)
        long_sampling = SamplingParams(temperature=0.0, max_new_tokens=2)
        healthy_sampling = SamplingParams(temperature=0.0, max_new_tokens=10)

        # Warm-up UNTRACED (sample=0), one run of EVERY measured burst
        # composition (same shapes, same batch sizes, fresh prompts):
        # first-use costs (compiles, kernel loads) land here, so the traced phases time steady-state
        # waves, not compilation, and the attributor never sees these
        # requests.
        set_recorder(FlightRecorder(capacity=4096, sample=0.0, node="warm"))
        eng.generate(
            [list(p) for p in prompts_of(24, 3) + prompts_of(48, 3)],
            healthy_sampling,
        )
        eng.generate(
            [list(p) for p in prompts_of(short_prompt, 6)], short_sampling
        )
        eng.generate(
            [list(p) for p in prompts_of(long_prompt, 3)], long_sampling
        )
        # Restore-phase prefixes seed (and warm) here too — their
        # re-serve in pathology (c) must find them in the HOST tier.
        restore_prompts = prompts_of(restore_prompt, 3)
        eng.generate([list(p) for p in restore_prompts], long_sampling)

        # Traced from here: fresh recorder at full sampling, attributor
        # installed on its retire hook, ONE doctor over every plane.
        rec = FlightRecorder(
            capacity=1 << 16, sample=1.0, node="doctor-eng"
        )
        set_recorder(rec)
        attr = ensure_attributor(rec)
        slo = OverloadController(SLOConfig())
        # Fleet-aggregation seam: an in-proc aggregator over the
        # router's own ring, pulled by hand before each diagnosis, so
        # the fleet rules (straggler_node / fleet_burn_slope /
        # telemetry_gap) RUN in the healthy phase — the schema's
        # rules_checked gate requires every live rule, and a quiet
        # fleet must yield zero fleet findings. The history seam
        # arms goodput_regression the same way.
        agg_hist = TelemetryHistory(
            interval_s=0.2, mesh=router_mesh, node="dr0"
        )
        agg = FleetAggregator(
            peers=[InprocPeer("dr0", agg_hist, rank=router_mesh.rank)],
            interval_s=0.2,
        )
        doctor = MeshDoctor(
            mesh=router_mesh,
            engine=eng,
            slo=slo,
            attributor=ensure_attributor,
            history=agg_hist,
            aggregator=agg,
        )

        # -- phase 0: healthy ------------------------------------------
        # Balanced heat: ONE key per distinct shard, equal token counts,
        # inserted at the shard's primary owner → skew ≈ 1.
        seen_shards: set[int] = set()
        attempts = 0
        while len(seen_shards) < balanced_shards and attempts < 10_000:
            attempts += 1
            key = np.concatenate([
                np.asarray([11_000 + attempts], dtype=np.int32),
                rng.integers(1, 600, size=key_len - 1).astype(np.int32),
            ])
            sid = shard_of_tokens(key[:page])
            if sid in seen_shards:
                continue
            seen_shards.add(sid)
            node = by_rank[ownership.primary(sid)]
            slots = np.arange(len(key), dtype=np.int32)
            node.insert(key, slots)
            node.match_prefix(key)
        for n in ring:
            n.broadcast_shard_summary()
        wait_for(
            lambda: router_mesh.fleet.shard_heat()["reporters"]
            >= len(ring) - 1
        )
        # Decode-dominant two-shape burst: neither shape may look like a
        # convoy (share < threshold, similar e2e).
        healthy_prompts = prompts_of(24, 3) + prompts_of(48, 3)
        eng.generate([list(p) for p in healthy_prompts], healthy_sampling)
        agg_hist.sample()
        agg.pull_once()
        healthy_report = doctor.diagnose()
        healthy = {
            "performed": True,
            "findings": healthy_report["findings"],
            "rules_checked": healthy_report["rules_checked"],
            "inputs": healthy_report["inputs"],
            "audited_requests": attr.stats()["audited"],
            "balanced_shards": len(seen_shards),
            "skew_score": router_mesh.shard_heat_report().get("skew_score"),
        }

        # -- pathology (a): zipf heat storm ----------------------------
        heat = _obs_zipf_heat_phase(
            ring=ring,
            router_mesh=router_mesh,
            by_rank=by_rank,
            rng=rng,
            wait_for=wait_for,
            zipf_keys=zipf_keys,
            zipf_inserts=zipf_inserts,
            zipf_alpha=zipf_alpha,
            key_len=key_len,
        )
        # The zipf phase's reporter wait can be satisfied by the STALE
        # healthy-phase fold (reporters is a set size, not a freshness
        # signal) — hold the diagnosis until the storm's heat actually
        # folded at the router, or the doctor reads last round's map.
        wait_for(
            lambda: router_mesh.shard_heat_report().get("skew_score", 0.0)
            >= doctor.cfg.hot_shard_skew
        )
        hot_finding = finding_for(doctor.diagnose(), "hot_shard")
        hot_expected = {
            "shard": heat["expected_hot_shard"],
            "owners": heat["expected_hot_owners"],
            "min_skew": doctor.cfg.hot_shard_skew,
        }
        hot = {
            "performed": True,
            "rule": "hot_shard",
            "detected": hot_finding is not None,
            "score": (hot_finding or {}).get("score"),
            "summary": (hot_finding or {}).get("summary", ""),
            "evidence": (hot_finding or {}).get("evidence", {}),
            "expected": hot_expected,
            "evidence_correct": bool(
                hot_finding is not None
                and hot_finding["evidence"].get("shard")
                == heat["expected_hot_shard"]
                and sorted(hot_finding["evidence"].get("owners", []))
                == heat["expected_hot_owners"]
                and hot_finding["evidence"].get("skew_score", 0)
                >= doctor.cfg.hot_shard_skew
            ),
        }

        # -- pathology (b): convoying long-prompt burst ----------------
        eng.generate(
            [list(p) for p in prompts_of(short_prompt, 6)], short_sampling
        )
        eng.generate(
            [list(p) for p in prompts_of(long_prompt, 3)], long_sampling
        )
        convoy_shape = shape_bucket(long_prompt)
        convoy_finding = finding_for(doctor.diagnose(), "prefill_convoy")
        convoy_expected = {
            "shape": convoy_shape,
            "min_share": doctor.cfg.convoy_prefill_share,
            "requests": 3,
        }
        convoy = {
            "performed": True,
            "rule": "prefill_convoy",
            "detected": convoy_finding is not None,
            "score": (convoy_finding or {}).get("score"),
            "summary": (convoy_finding or {}).get("summary", ""),
            "evidence": (convoy_finding or {}).get("evidence", {}),
            "expected": convoy_expected,
            "evidence_correct": bool(
                convoy_finding is not None
                and convoy_finding["evidence"].get("shape") == convoy_shape
                and convoy_finding["evidence"].get("prefill_share", 0)
                >= doctor.cfg.convoy_prefill_share
                and convoy_finding["evidence"].get("requests") == 3
            ),
        }

        # -- pathology (c): throttled restore lane ---------------------
        # Push the warm-up prefixes to the HOST tier, re-request them
        # through the tiny-chunk plane, step JUST until they park —
        # then diagnose with the staged backlog deliberately unpumped
        # (the engine thread is the only pump; we hold it).
        eng.tree.evict(10 * restore_prompt * len(restore_prompts))
        eng.kv_transfer.wait_host_ready()
        parked_reqs = [
            eng.add_request(list(p), long_sampling) for p in restore_prompts
        ]
        for _ in range(50):
            eng.step()
            if len(eng._restoring) >= len(parked_reqs):
                break
        stall_finding = finding_for(doctor.diagnose(), "restore_park_stall")
        stall_expected = {
            "lane": "restore",
            "parked": len(parked_reqs),
        }
        stall = {
            "performed": True,
            "rule": "restore_park_stall",
            "detected": stall_finding is not None,
            "score": (stall_finding or {}).get("score"),
            "summary": (stall_finding or {}).get("summary", ""),
            "evidence": (stall_finding or {}).get("evidence", {}),
            "expected": stall_expected,
            "evidence_correct": bool(
                stall_finding is not None
                and stall_finding["evidence"].get("lane") == "restore"
                and stall_finding["evidence"].get("parked")
                == len(parked_reqs)
                and stall_finding["evidence"].get("restores_queued", 0) > 0
            ),
        }
        # Release the lane and let the parked requests finish — the
        # pathology is a diagnosis scenario, not a leaked stall.
        from radixmesh_tpu_torch.engine.request import RequestState

        for _ in range(max_steps):
            eng.step()
            if all(
                r.state is RequestState.FINISHED for r in parked_reqs
            ):
                break

        stats = attr.stats()
        attribution = {
            "audited": stats["audited"],
            "refused": stats["refused"],
            "max_sum_error_s": stats["max_sum_error_s"],
            "epsilon_s": 1e-6,
            "sums_ok": bool(stats["max_sum_error_s"] <= 1e-6),
            "phases": {
                p: {"count": v["count"], "p99_s": v["p99_s"]}
                for p, v in attr.report()["phases"].items()
            },
        }
    finally:
        set_recorder(prev_recorder)
        if eng is not None:
            eng.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()

    return {
        "nodes": len(prefill) + len(decode) + len(router_addrs),
        "topology": "4 prefill + 2 decode + 1 router (inproc) + traced "
        + ("CPU engine" if device.type == "cpu" else "CUDA engine"),
        "replication_factor": replication_factor,
        "healthy": healthy,
        "pathologies": {
            "hot_shard": hot,
            "prefill_convoy": convoy,
            "restore_park_stall": stall,
        },
        "attribution": attribution,
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


def run_blackbox_workload(
    seed: int = 0,
    replication_factor: int = 3,
    history_interval_s: float = 0.25,
    history_capacity: int = 900,
    segment_every: int = 4,
    balanced_shards: int = 16,
    zipf_keys: int = 64,
    zipf_inserts: int = 400,
    zipf_alpha: float = 1.4,
    key_len: int = 8,
    digest_interval_s: float = 0.2,
    stale_after_s: float = 0.6,
    summary_interval_s: float = 0.2,
    timeout_s: float = 60.0,
    blackbox_dir: str | None = None,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The black-box acceptance scenario (the JAX package's ``bench.
    validate_blackbox`` pins its artifact): one rf=3 inproc mesh
    (4 prefill + 2 decode + 1 router, per-node fleet digesters) plus a
    step-accounted engine, with TWO telemetry histories recording —
    the ROUTER's (the observer: fleet health, shard heat, skew) and the
    hot shard's PRIMARY OWNER's (the victim) — each wired to a
    :class:`~radixmesh_tpu_torch.obs.blackbox.BlackBox` writing incremental
    segments. The run:

    0. **Healthy.** Balanced heat + a decode-dominant engine burst; the
       live history-backed doctor must report ZERO findings with every
       rule checked.
    a. **Zipf heat storm** (the OBS leg): deterministic rank^-alpha
       insert counts drive one shard provably hottest; the observer's
       rings record the skew peak.
    b. **Kill mid-storm.** The hot shard's primary owner dies HARD:
       its fleet digester, history sampler, and black box stop with NO
       final flush (the kill -9 simulation — only its committed
       segments survive), then its mesh closes. The observer's rings
       record the victim's health score collapsing.
    c. **Post-mortem from the dumps alone.** ``obs/doctor.py::
       postmortem_report`` over the OBSERVER's flushed dump must name
       the seeded hot shard AND a crash window containing the true
       kill time; over the VICTIM's segment-only dump it must flag the
       unclean death with the truncation point within one segment of
       the kill.

    The sampler's own cost is gated: both histories' self-accounted
    sweep seconds must stay under 1% of the run's wall clock (the run
    is a step-accounting run — the engine leg has it on).

    ``cfg``: the model the engine serves (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``. The process-wide inproc hub and
    flight recorder are reset and restored when the scenario ends."""
    import os
    import shutil
    import tempfile
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.cache.sharding import shard_of_tokens
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.obs.aggregator import FleetAggregator, InprocPeer
    from radixmesh_tpu_torch.obs.attribution import ensure_attributor
    from radixmesh_tpu_torch.obs.blackbox import BlackBox, load_blackbox
    from radixmesh_tpu_torch.obs.doctor import (
        DoctorConfig,
        MeshDoctor,
        postmortem_report,
    )
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
    from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
    from radixmesh_tpu_torch.obs.trace_plane import (
        FlightRecorder,
        get_recorder,
        set_recorder,
    )
    from radixmesh_tpu_torch.slo.control import OverloadController, SLOConfig
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def wait_for(pred, timeout=timeout_s, interval=0.02):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    def finding_for(report: dict, rule: str, detector: str | None = None, rank=None):
        for f in report["findings"]:
            if f["rule"] != rule:
                continue
            if detector and f["evidence"].get("detector") != detector:
                continue
            if rank is not None and f["evidence"].get("rank") != str(rank):
                continue
            return f
        return None

    def hist_points(hist: TelemetryHistory, name: str) -> list:
        body = hist.query(family=name, since=-1, limit=1 << 62)
        return body["series"].get(name, {}).get("points", [])

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    prev_recorder = get_recorder()
    own_tmp = blackbox_dir is None
    out_root = blackbox_dir or tempfile.mkdtemp(prefix="blackbox-wl-")
    obs_dir = os.path.join(out_root, "observer")
    victim_dir = os.path.join(out_root, "victim")
    prefill = ["bp0", "bp1", "bp2", "bp3"]
    decode = ["bd0", "bd1"]
    router_addrs = ["br0"]
    nodes: list = []
    fleet_planes: list = []
    histories: list = []
    boxes: list = []
    eng = None
    try:
        for addr in prefill + decode + router_addrs:
            node_cfg = MeshConfig(
                prefill_nodes=prefill,
                decode_nodes=decode,
                router_nodes=router_addrs,
                local_addr=addr,
                protocol="inproc",
                tick_interval_s=0.1,
                gc_interval_s=60.0,
                failure_timeout_s=60.0,
                replication_factor=replication_factor,
                shard_summary_interval_s=summary_interval_s,
            )
            nodes.append(MeshCache(node_cfg, pool=None).start())
        for n in nodes:
            if not n.wait_ready(timeout=timeout_s):
                raise RuntimeError(f"node {n.rank} never passed the barrier")
        ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
        router_mesh = nodes[-1]
        by_rank = {n.rank: n for n in ring}
        any_node = ring[0]
        page = max(1, any_node.page)
        ownership = any_node.ownership
        # The router's view keeps its 15 s staleness default until the
        # kill, where it is armed with ``stale_after_s`` (phase b).
        for n in ring:
            fleet_planes.append(
                FleetPlane(n, interval_s=digest_interval_s).start()
            )

        # -- engine (the step-accounting leg) --------------------------
        mcfg = cfg if cfg is not None else ModelConfig(
            vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
            head_dim=32, intermediate=128, max_seq_len=1024,
        )
        eng = Engine(
            mcfg,
            init_params(mcfg, seed, device),
            num_slots=2048,
            page_size=4,
            max_batch=8,
            name="bb-eng",
            step_accounting=True,
            device=device,
            # The JAX scenario's threshold: its CPU jit compiles take
            # seconds, and a serving-tuned 50ms stall threshold would
            # attribute compile time as decode stalls and trip the
            # healthy-phase zero-findings gate.
            token_stall_threshold_s=5.0,
        )
        sampling = SamplingParams(temperature=0.0, max_new_tokens=8)

        def prompts_of(n_tokens: int, count: int) -> list[list[int]]:
            return [
                list(rng.integers(1, mcfg.vocab_size - 1, size=n_tokens))
                for _ in range(count)
            ]

        # Warm-up untraced: first-use costs (compiles, kernel loads) land
        # before anything is timed.
        set_recorder(FlightRecorder(capacity=2048, sample=0.0, node="warm"))
        eng.generate(prompts_of(24, 3) + prompts_of(48, 3), sampling)
        rec = FlightRecorder(capacity=1 << 15, sample=1.0, node="bb-eng")
        set_recorder(rec)
        attr = ensure_attributor(rec)
        slo = OverloadController(SLOConfig())

        # -- histories + black boxes (observer = router; victim joins
        #    after the storm names the hot owner) ----------------------
        obs_hist = TelemetryHistory(
            interval_s=history_interval_s,
            capacity=history_capacity,
            mesh=router_mesh,
            engine=eng,
            slo=slo,
            node="observer-router",
        )
        histories.append(obs_hist)
        obs_bb = BlackBox(
            obs_dir,
            history=obs_hist,
            recorder=get_recorder,
            attributor_fn=ensure_attributor,
            node="observer-router",
            segment_every=segment_every,
        )
        boxes.append(obs_bb)
        # Fleet-aggregation seam: the observer doubles as the
        # aggregation host, pulling its own ring — schema v4 requires
        # the fleet rules in the healthy rules_checked, and a healthy
        # fleet must keep them silent.
        agg = FleetAggregator(
            peers=[
                InprocPeer(
                    "observer-router", obs_hist, rank=router_mesh.rank
                )
            ],
            interval_s=history_interval_s,
        )
        doctor = MeshDoctor(
            mesh=router_mesh,
            engine=eng,
            slo=slo,
            attributor=ensure_attributor,
            history=obs_hist,
            aggregator=agg,
        )
        obs_bb.doctor = doctor
        obs_hist.start()

        # -- phase 0: healthy ------------------------------------------
        seen_shards: set[int] = set()
        attempts = 0
        while len(seen_shards) < balanced_shards and attempts < 10_000:
            attempts += 1
            key = np.concatenate([
                np.asarray([23_000 + attempts], dtype=np.int32),
                rng.integers(1, 600, size=key_len - 1).astype(np.int32),
            ])
            sid = shard_of_tokens(key[:page])
            if sid in seen_shards:
                continue
            seen_shards.add(sid)
            node = by_rank[ownership.primary(sid)]
            node.insert(key, np.arange(len(key), dtype=np.int32))
            node.match_prefix(key)
        for n in ring:
            n.broadcast_shard_summary()
        wait_for(
            lambda: router_mesh.fleet.shard_heat()["reporters"]
            >= len(ring) - 1
        )
        eng.generate(prompts_of(24, 3) + prompts_of(48, 3), sampling)
        # Health series need at least one full digest round folded.
        wait_for(
            lambda: len(router_mesh.fleet.health()) >= len(ring)
        )
        wait_for(lambda: obs_hist.stats()["seq"] >= 2)
        agg.pull_once()
        healthy_report = doctor.diagnose()
        healthy = {
            "performed": True,
            "findings": healthy_report["findings"],
            "rules_checked": healthy_report["rules_checked"],
            "inputs": healthy_report["inputs"],
            "balanced_shards": len(seen_shards),
            "skew_score": router_mesh.shard_heat_report().get("skew_score"),
            "history_samples": obs_hist.stats()["seq"] + 1,
        }

        # -- phase a: zipf heat storm ----------------------------------
        heat = _obs_zipf_heat_phase(
            ring=ring,
            router_mesh=router_mesh,
            by_rank=by_rank,
            rng=rng,
            wait_for=wait_for,
            zipf_keys=zipf_keys,
            zipf_inserts=zipf_inserts,
            zipf_alpha=zipf_alpha,
            key_len=key_len,
        )
        t_folded = _time.monotonic()
        expected_sid = heat["expected_hot_shard"]
        expected_owners = heat["expected_hot_owners"]
        victim_rank = ownership.primary(expected_sid)
        victim = by_rank[victim_rank]
        # The victim's OWN recorder: history + black box on the node
        # about to die — only its committed segments will survive.
        victim_hist = TelemetryHistory(
            interval_s=history_interval_s,
            capacity=history_capacity,
            mesh=victim,
            node=f"victim-rank{victim_rank}",
        )
        histories.append(victim_hist)
        victim_bb = BlackBox(
            victim_dir,
            history=victim_hist,
            node=f"victim-rank{victim_rank}",
            segment_every=segment_every,
        )
        boxes.append(victim_bb)
        victim_hist.start()
        # The observer must SAMPLE the storm at its peak before the
        # kill (the rings are the post-mortem's only evidence): a sample
        # taken once every owner's post-storm summary is folded (the heat
        # phase returns then). A sample from mid-storm, before the folds,
        # satisfies the JAX scenario's wait, and a victim killed then
        # never sends its last summary: the router's view of its shards
        # stays mid-storm, and the post-mortem can name another shard.
        skew_threshold = DoctorConfig().hot_shard_skew
        wait_for(
            lambda: any(
                p[1] >= t_folded and p[2] >= skew_threshold
                for p in hist_points(obs_hist, "shard:skew_ratio")
            )
        )
        # ...and the victim must commit at least one segment.
        wait_for(lambda: victim_bb.stats()["segments"] >= 1)

        # -- phase b: kill the hot owner mid-storm ---------------------
        # Fast staleness verdicts: the observer must see a dead node's
        # digest go stale within a second, not the 15 s default. (Ring
        # nodes' views adopt their FleetPlane's config; the router has
        # no plane, so its view is tuned directly.) They are armed here,
        # once every rank's digest is fresh at the router, and not at the
        # start as in the JAX scenario: a process starved of the CPU for
        # ``stale_after_s`` earlier records a drop of every rank, and the
        # post-mortem names each rank's first drop, which then precedes
        # the kill.
        digests_fresh_at_kill = wait_for(
            lambda: all(
                h["age_s"] < stale_after_s / 2
                for h in router_mesh.fleet.health().values()
            )
        )
        router_mesh.fleet.cfg.stale_after_s = stale_after_s
        # The victim's own recorder stops first, then its digester, and
        # t_kill is stamped once both are down (a sampler tick or digest
        # publish racing the close lands before it, or the truncation and
        # crash-window gates flake on an otherwise correct run); its mesh
        # closes after it, so that the close's seconds on a slow host do
        # not age the victim's last digest past the stamp.
        victim_hist.close()
        victim_bb.close()  # NO flush: the kill -9 simulation
        for fp in fleet_planes:
            if fp.mesh is victim:
                fp.close()
        t_kill = _time.monotonic()
        victim.close()
        detected = wait_for(
            lambda: any(
                p[2] < 0.5
                for p in hist_points(
                    obs_hist, f'fleet:health_score{{rank="{victim_rank}"}}'
                )
            ),
            timeout=max(10.0, 20.0 * stale_after_s),
        )
        crash = {
            "performed": True,
            "victim_rank": victim_rank,
            "victim_is_hot_owner": victim_rank in expected_owners,
            "t_kill": round(t_kill, 3),
            "digests_fresh_at_kill": bool(digests_fresh_at_kill),
            "observer_detected_live": bool(detected),
        }

        # -- flush the observer (the SIGTERM exit path) ----------------
        flush_info = obs_bb.flush("sigterm")
        obs_hist.close()

        # -- phase c: post-mortem from the dumps alone -----------------
        obs_dump = load_blackbox(obs_dir)
        victim_dump = load_blackbox(victim_dir)
        obs_pm = postmortem_report(obs_dump)
        victim_pm = postmortem_report(victim_dump)
        hot_f = finding_for(obs_pm, "hot_shard")
        # The victim's own drop: a node whose digests reached the router
        # through the victim goes dark there too, and the JAX scenario
        # reads the first rank's finding, which can be that node's.
        crash_f = finding_for(
            obs_pm, "node_crash", detector="health_drop", rank=victim_rank
        )
        trunc_f = finding_for(
            victim_pm, "node_crash", detector="history_truncated"
        )
        window = (crash_f or {}).get("evidence", {}).get("window")
        window_contains_kill = bool(
            window is not None and window[0] - 0.05 <= t_kill <= window[1]
        )
        trunc_slack = 2.0 * segment_every * history_interval_s + 0.5
        trunc_last_t = (victim_dump.get("last_t") or 0.0)
        truncation_within = bool(
            victim_dump["unclean"]
            and trunc_f is not None
            and 0.0 <= t_kill - trunc_last_t <= trunc_slack
        )
        postmortem = {
            "observer": {
                "findings": obs_pm["findings"],
                "rules_checked": obs_pm["rules_checked"],
                "samples": obs_pm["samples"],
                "hot_shard_named": bool(
                    hot_f is not None
                    and hot_f["evidence"].get("shard") == expected_sid
                ),
                "hot_shard_evidence": (hot_f or {}).get("evidence", {}),
                "crash_window_named": window_contains_kill,
                "crash_evidence": (crash_f or {}).get("evidence", {}),
            },
            "victim": {
                "findings": victim_pm["findings"],
                "unclean": victim_pm["unclean"],
                "segments": victim_dump["segments"],
                "last_t": round(trunc_last_t, 3),
                "truncation_slack_s": round(trunc_slack, 3),
                "truncation_named": truncation_within,
                "truncation_evidence": (trunc_f or {}).get("evidence", {}),
            },
            "expected": {
                "hot_shard": expected_sid,
                "hot_owners": expected_owners,
                "t_kill": round(t_kill, 3),
            },
        }

        wall_s = _time.monotonic() - t_start
        sampler_cost = sum(
            h.stats()["sample_seconds_total"] for h in histories
        )
        obs_stats = obs_hist.stats()
        history = {
            "interval_s": history_interval_s,
            "capacity": history_capacity,
            "samplers": len(histories),
            "samples": obs_stats["seq"] + 1,
            "series": obs_stats["series"],
            "points": obs_stats["points"],
            "dropped_series": obs_stats["dropped_series"],
            "self_overhead": {
                "sample_seconds_total": round(sampler_cost, 6),
                "wall_s": round(wall_s, 3),
                "fraction": round(sampler_cost / max(1e-9, wall_s), 6),
                "budget_fraction": 0.01,
                "under_budget": bool(sampler_cost / max(1e-9, wall_s) < 0.01),
            },
        }
        blackbox = {
            "schema_version": obs_dump["schema_version"],
            "observer": {
                "segments": obs_dump["segments"],
                "finals": obs_dump["finals"],
                "causes": obs_dump["causes"],
                "bytes_final": flush_info["bytes"],
            },
            "victim": {
                "segments": victim_dump["segments"],
                "finals": victim_dump["finals"],
                "unclean": victim_dump["unclean"],
            },
        }
    finally:
        set_recorder(prev_recorder)
        for h in histories:
            h.close()
        for bb in boxes:
            bb.close()
        for fp in fleet_planes:
            fp.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()
        if eng is not None:
            eng.close()
        if own_tmp:
            shutil.rmtree(out_root, ignore_errors=True)

    named = sum([
        postmortem["observer"]["hot_shard_named"],
        postmortem["observer"]["crash_window_named"],
        postmortem["victim"]["truncation_named"],
    ])
    return {
        "nodes": len(prefill) + len(decode) + len(router_addrs),
        "topology": "4 prefill + 2 decode + 1 router (inproc, per-node "
        "fleet digesters) + step-accounted "
        + ("CPU engine" if device.type == "cpu" else "CUDA engine"),
        "replication_factor": replication_factor,
        "named": named,
        "healthy": healthy,
        "storm": heat,
        "crash": crash,
        "postmortem": postmortem,
        "history": history,
        "blackbox": blackbox,
        "attribution_audited": attr.stats()["audited"],
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


class _FixedDecodeTelemetry:
    """Engine stand-in for straggler seeding: reports a constant decode
    step-time EWMA through the fleet-digest seam
    (``obs/fleet_plane.py::FleetPlane.build_digest`` reads exactly
    ``telemetry()["decode_ewma_s"]``) — the AGG workload pins one decode
    node's signal high and its sibling's low without needing a real
    engine to actually be slow."""

    def __init__(self, decode_ewma_s: float):
        self._ewma = float(decode_ewma_s)

    def telemetry(self) -> dict:
        return {"decode_ewma_s": self._ewma}


def run_agg_workload(
    seed: int = 0,
    replication_factor: int = 3,
    history_interval_s: float = 0.2,
    agg_interval_s: float = 0.25,
    digest_interval_s: float = 0.2,
    stale_after_s: float = 0.6,
    straggler_ewma_s: float = 0.08,
    healthy_ewma_s: float = 0.004,
    telemetry_gap_s: float = 1.0,
    request_batches: int = 3,
    batch_size: int = 8,
    sim_peers: int = 200,
    sim_cadence_s: float = 2.0,
    overhead_budget: float = 0.01,
    timeout_s: float = 60.0,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The control-room acceptance scenario (the JAX package's ``bench.
    validate_agg`` pins its artifact): an inproc 4 prefill + 2 decode +
    2 router rf=3 cell where every ring node runs a fleet digester and
    its own telemetry history, all cursor-pulled by one router-hosted
    :class:`~radixmesh_tpu_torch.obs.aggregator.FleetAggregator`. Four fleet
    verdicts must be NAMED over the merged store, never hand-waved:

    a. **Merged percentiles.** A traced engine burst lands TTFT
       observations; every request object is retained, so the raw
       records ARE the ground truth. The fleet-merged p99 (bucket
       counts summed across the reporting nodes, quantile interpolated
       inside the merged distribution) must land within one histogram
       bucket of the raw-record p99 — the gate average-of-percentiles
       fails exactly when it matters.
    b. **Straggler by rank.** One decode node's digest carries a
       pinned-high decode EWMA (the seeded delay); the fleet doctor's
       ``straggler_node`` rule must name that RANK from the aggregated
       per-rank signal fold.
    c. **Exemplar → stitched trace.** The merged-p99 bucket's exemplar
       (collected off the slow node's registry during the pull sweep)
       must join by trace id into a stitched trace containing the slow
       node's span.
    d. **Gap, not silence.** One prefill node dies (digester + sampler
       stop); the doctor's ``telemetry_gap`` rule must surface it with
       a dead-vs-sampler verdict from the mesh health cross-check.

    Plus two budget rows: total aggregation cost under 1% of run wall
    time, and an N=200 simulated-transport fan-in sweep completing
    inside one pull cadence.

    ``cfg``: the model the straggler's engine serves (default: the toy
    model below); ``device``: CUDA unless ``"cpu"``. The process-wide
    inproc hub and flight recorder are reset and restored when the
    scenario ends."""
    import bisect
    import time as _time

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.obs.aggregator import FleetAggregator, InprocPeer
    from radixmesh_tpu_torch.obs.attribution import ensure_attributor
    from radixmesh_tpu_torch.obs.doctor import DoctorConfig, MeshDoctor
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
    from radixmesh_tpu_torch.obs.metrics import DEFAULT_BUCKETS, get_registry
    from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
    from radixmesh_tpu_torch.obs.trace_plane import (
        FlightRecorder,
        get_recorder,
        set_recorder,
        stitch_traces,
    )
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def wait_for(pred, timeout=timeout_s, interval=0.02):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(interval)
        return pred()

    def finding_for(report: dict, rule: str):
        for f in report["findings"]:
            if f["rule"] == rule:
                return f
        return None

    def bucket_index(value: float) -> int:
        # The bucket a value lands in, by the same predicate
        # Histogram.observe uses (first bound >= value; past the last
        # bound = the +Inf slot at len(buckets)).
        return bisect.bisect_left(DEFAULT_BUCKETS, value)

    def le_index(le: str) -> int:
        if le == "+Inf":
            return len(DEFAULT_BUCKETS)
        return bisect.bisect_left(DEFAULT_BUCKETS, float(le))

    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    InprocHub.reset_default()
    prev_recorder = get_recorder()
    prefill = ["ap0", "ap1", "ap2", "ap3"]
    decode = ["ad0", "ad1"]
    router_addrs = ["ar0", "ar1"]
    nodes: list = []
    fleet_planes: list = []
    histories: list = []
    aggs: list = []
    eng = None
    try:
        for addr in prefill + decode + router_addrs:
            node_cfg = MeshConfig(
                prefill_nodes=prefill,
                decode_nodes=decode,
                router_nodes=router_addrs,
                local_addr=addr,
                protocol="inproc",
                tick_interval_s=0.1,
                gc_interval_s=60.0,
                failure_timeout_s=60.0,
                replication_factor=replication_factor,
                shard_summary_interval_s=0.2,
            )
            nodes.append(MeshCache(node_cfg, pool=None).start())
        for n in nodes:
            if not n.wait_ready(timeout=timeout_s):
                raise RuntimeError(f"node {n.rank} never passed the barrier")
        ring = [n for n in nodes if n.role is not NodeRole.ROUTER]
        routers = [n for n in nodes if n.role is NodeRole.ROUTER]
        router_mesh = routers[0]
        # Fast staleness verdicts on the aggregation host: the
        # telemetry_gap rule's dead-vs-sampler cross-check reads this
        # mesh's health view, which must see a killed node's digest go
        # stale within a second, not the 15 s default.
        for r in routers:
            r.fleet.cfg.stale_after_s = stale_after_s

        def peer_name(n) -> str:
            return f"{n.role.value}{n.rank}"

        # -- per-node digesters: the straggler seed ---------------------
        # Decode nodes publish a pinned decode EWMA through the real
        # digest seam — one high (the straggler), one low (the healthy
        # sibling the ratio is judged against). Prefill planes publish
        # 0.0, which the straggler rule filters as "not a decode rank".
        straggler_rank = None
        for n in ring:
            stub = None
            if n.role is NodeRole.DECODE:
                if straggler_rank is None:
                    straggler_rank = n.rank
                    stub = _FixedDecodeTelemetry(straggler_ewma_s)
                else:
                    stub = _FixedDecodeTelemetry(healthy_ewma_s)
            fleet_planes.append(
                FleetPlane(n, engine=stub, interval_s=digest_interval_s)
                .start()
            )
        straggler_name = f"decode{straggler_rank}"

        # -- the traced engine (runs ON the straggler node) -------------
        # Everything is traced from the first request: the first batch,
        # which pays every first-use cost (in the JAX package its jit
        # compiles, here the kernels' loads), is the p99 tail, and the
        # exemplar gate needs the p99-bucket observation to carry a
        # trace id.
        rec = FlightRecorder(
            capacity=1 << 15, sample=1.0, node=straggler_name
        )
        set_recorder(rec)
        mcfg = cfg if cfg is not None else ModelConfig(
            vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
            head_dim=32, intermediate=128, max_seq_len=1024,
        )
        eng = Engine(
            mcfg,
            init_params(mcfg, seed, device),
            num_slots=2048,
            page_size=4,
            max_batch=8,
            name=straggler_name,
            device=device,
        )
        sampling = SamplingParams(temperature=0.0, max_new_tokens=8)

        def run_batch(n_tokens: int, count: int) -> list:
            reqs = [
                eng.add_request(
                    list(rng.integers(1, mcfg.vocab_size - 1, size=n_tokens)),
                    sampling,
                )
                for _ in range(count)
            ]
            while eng.has_work():
                eng.step()
            return reqs

        # Raw records: EVERY request object is retained — their
        # first-token stamps are the ground truth the merged quantile
        # is judged against, so nothing (warm-up included) may
        # observe into the histogram without also landing here.
        all_reqs = run_batch(24, 4) + run_batch(48, 2)
        for _ in range(request_batches):
            all_reqs += run_batch(int(rng.integers(16, 49)), batch_size)

        # -- per-node histories + the router-hosted aggregator ----------
        for n in ring:
            h = TelemetryHistory(
                interval_s=history_interval_s,
                mesh=n,
                node=peer_name(n),
            )
            histories.append(h)
            h.start()
        # Only the straggler's peer carries a registry: each real node
        # would serve its own process registry; in this one-process cell
        # the engine ran on the straggler, so its peer is the one whose
        # exemplar fetch may claim the traced observations.
        agg = FleetAggregator(
            peers=[
                InprocPeer(
                    peer_name(n),
                    h,
                    registry=(
                        get_registry() if n.rank == straggler_rank else None
                    ),
                    rank=n.rank,
                )
                for n, h in zip(ring, histories)
            ],
            interval_s=agg_interval_s,
            node=f"router{router_mesh.rank}",
        )
        aggs.append(agg)
        doctor = MeshDoctor(
            mesh=router_mesh,
            attributor=ensure_attributor,
            aggregator=agg,
            cfg=DoctorConfig(telemetry_gap_s=telemetry_gap_s),
        )

        # -- verdict a: merged p99 vs raw-record truth ------------------
        ttfts = sorted(
            r.first_token_time - r.submit_time
            for r in all_reqs
            if r.first_token_time and r.submit_time
        )
        # Every reporting node must have sampled the burst's final
        # counts before the pull that feeds the merge.
        ttft_total = len(ttfts)
        wait_for(
            lambda: all(h.stats()["seq"] >= 1 for h in histories)
        )
        _time.sleep(history_interval_s + 0.05)
        agg.pull_once()
        fleet = agg.fleet_slo()
        tenants = fleet["tenants"]
        tenant = "default" if "default" in tenants else next(iter(tenants))
        tb = tenants[tenant]["ttft"]
        truth_p99 = float(np.quantile(np.asarray(ttfts), 0.99))
        fleet_le = tb.get("p99_bucket")
        idx_truth = bucket_index(truth_p99)
        idx_fleet = le_index(fleet_le) if fleet_le else -99
        bucket_lo = (
            DEFAULT_BUCKETS[idx_fleet - 1]
            if 0 < idx_fleet <= len(DEFAULT_BUCKETS)
            else 0.0
        )
        bucket_hi = (
            DEFAULT_BUCKETS[idx_fleet]
            if 0 <= idx_fleet < len(DEFAULT_BUCKETS)
            else None
        )
        percentiles = {
            "performed": True,
            "tenant": tenant,
            "fleet_p99_s": tb.get("p99"),
            "truth_p99_s": round(truth_p99, 6),
            "bucket_lo_s": bucket_lo,
            "bucket_hi_s": bucket_hi,
            "within_one_bucket": bool(abs(idx_fleet - idx_truth) <= 1),
            "count": tb.get("count", 0),
            "nodes": tb.get("nodes", []),
            "raw_requests": ttft_total,
        }

        # -- verdict b: straggler named by rank -------------------------
        # The seeded EWMA must cross gossip → per-node derived series →
        # pull → per-rank fold before the rule can see both decode
        # ranks.
        def decode_ranks_folded() -> bool:
            agg.pull_once()
            vals = agg.rank_signal("fleet:decode_ewma_seconds")
            return (
                vals.get(str(straggler_rank), 0.0) > 0.0
                and sum(1 for v in vals.values() if v > 0.0) >= 2
            )

        wait_for(decode_ranks_folded)
        strag_report = doctor.diagnose()
        strag_f = finding_for(strag_report, "straggler_node")
        strag_ev = (strag_f or {}).get("evidence", {})
        straggler = {
            "performed": True,
            "seeded_rank": straggler_rank,
            "named_rank": strag_ev.get("rank"),
            "detected": strag_f is not None,
            "ratio": strag_ev.get("ratio"),
            "signal": strag_ev.get("signal"),
        }

        # -- verdict c: p99 exemplar → stitched trace -------------------
        ex = tb.get("p99_exemplar") or {}
        stitched_doc = stitch_traces([rec.export_spans()])
        node_of_pid = {
            e.get("pid"): e.get("args", {}).get("name")
            for e in stitched_doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        tid = ex.get("trace_id")
        hit_nodes = {
            node_of_pid.get(e.get("pid"))
            for e in stitched_doc["traceEvents"]
            if tid and e.get("args", {}).get("trace_id") == tid
        }
        exemplar = {
            "performed": True,
            "trace_id": tid,
            "node": ex.get("node"),
            "le": ex.get("le"),
            "stitched": bool(tid and hit_nodes),
            "has_straggler_span": straggler_name in hit_nodes,
        }

        # -- verdict d: killed node surfaces as telemetry_gap -----------
        victim = ring[0]
        victim_name = peer_name(victim)
        for fp in fleet_planes:
            if fp.mesh is victim:
                fp.close()
        histories[0].close()

        gap_f = None

        def gap_named() -> bool:
            nonlocal gap_f
            agg.pull_once()
            rep = doctor.diagnose()
            f = finding_for(rep, "telemetry_gap")
            if f is not None and f["evidence"].get("peer") == victim_name:
                gap_f = f
                return True
            return False

        wait_for(gap_named, interval=0.1)
        gap_ev = (gap_f or {}).get("evidence", {})
        gap = {
            "performed": True,
            "killed_peer": victim_name,
            "detected": gap_f is not None,
            "verdict": gap_ev.get("verdict"),
            "stalled_s": gap_ev.get("stalled_s"),
        }

        # -- fan-in row: N=200 simulated peers, one sweep ---------------
        # Each simulated peer is a real TelemetryHistory fed through the
        # real ingest path (no sampler thread, no sockets): the sweep
        # exercises the true query/fold pipeline at ringscale N without
        # 200 registry snapshots.
        sim_histories = []
        t_sim = _time.monotonic()
        for i in range(sim_peers):
            h = TelemetryHistory(
                interval_s=0.5, capacity=16, node=f"sim{i:03d}",
                max_series=64,
            )
            for k in range(2):
                h.ingest(f"sim{i:03d}", {
                    "seq": k,
                    "interval_s": 0.5,
                    "wall_offset": h.wall_offset,
                    "series": {
                        "engine:decode_steps": {
                            "points": [[k, t_sim + 0.5 * k, float(7 * k + i)]],
                        },
                        f'fleet:health_score{{rank="{i}"}}': {
                            "points": [[k, t_sim + 0.5 * k, 1.0]],
                        },
                        "slo:queue_depth": {
                            "points": [[k, t_sim + 0.5 * k, float(i % 5)]],
                        },
                    },
                })
            sim_histories.append(h)
        fan_agg = FleetAggregator(
            peers=[
                InprocPeer(f"sim{i:03d}", h)
                for i, h in enumerate(sim_histories)
            ],
            interval_s=sim_cadence_s,
            capacity=64,
            node="fan-in",
            max_series=32768,
        )
        aggs.append(fan_agg)
        sweep = fan_agg.pull_once()
        fan_in = {
            "performed": True,
            "peers": sweep["peers"],
            "sweep_s": round(sweep["duration_s"], 6),
            "cadence_s": sim_cadence_s,
            "within_cadence": bool(sweep["duration_s"] < sim_cadence_s),
            "points": sweep["points"],
            "errors": sweep["errors"],
        }

        # -- overhead row -----------------------------------------------
        wall_s = _time.monotonic() - t_start
        pull_cost = sum(a.stats()["pull_seconds_total"] for a in aggs)
        overhead = {
            "pull_seconds_total": round(pull_cost, 6),
            "wall_s": round(wall_s, 3),
            "fraction": round(pull_cost / max(1e-9, wall_s), 6),
            "budget_fraction": overhead_budget,
            "under_budget": bool(
                pull_cost / max(1e-9, wall_s) < overhead_budget
            ),
        }
    finally:
        set_recorder(prev_recorder)
        for a in aggs:
            a.close()
        for h in histories:
            h.close()
        for fp in fleet_planes:
            fp.close()
        for n in nodes:
            n.close()
        InprocHub.reset_default()
        if eng is not None:
            eng.close()

    named = sum([
        percentiles["within_one_bucket"],
        bool(
            straggler["detected"]
            and str(straggler["named_rank"]) == str(straggler["seeded_rank"])
        ),
        bool(exemplar["stitched"] and exemplar["has_straggler_span"]),
        bool(gap["detected"] and gap["verdict"] in (
            "node_dead", "sampler_dead",
        )),
    ])
    return {
        "nodes": len(prefill) + len(decode) + len(router_addrs),
        "topology": "4 prefill + 2 decode + 2 routers (inproc, per-node "
        "fleet digesters + telemetry histories, router-hosted "
        "aggregator) + traced "
        + ("CPU engine" if device.type == "cpu" else "CUDA engine")
        + " on the slow decode node",
        "replication_factor": replication_factor,
        "named": named,
        "percentiles": percentiles,
        "straggler": straggler,
        "exemplar": exemplar,
        "gap": gap,
        "overhead": overhead,
        "fan_in": fan_in,
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


def run_spec_workload(
    seed: int = 0,
    gamma: int = 4,
    stall_sleep_s: float = 0.5,
    stall_threshold_s: float = 0.2,
    overhead_tokens: int = 1000,
    overhead_budget: float = 0.01,
    adaptive_ratio_floor: float = 0.85,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The SPEC acceptance workload (the speedometer): one cell proving
    the token-level observability plane end to end.

    a. **Acceptance + conservation.** Repetitive prompts (n-gram
       drafts land) generated once, then REPLAYED (the first pass's
       continuations live in the radix tree, so tree-peek drafts land
       too) — every verify path must conserve draft tokens
       (proposed == accepted + rejected, engine counters AND ledger
       totals), with the per-shape and per-draft-source breakdowns
       populated.
    b. **ITL + seeded stall.** A caller-side sleep between mid-decode
       steps is a real scheduler-side stall; the timeline must
       attribute at least one stall event to ``scheduler_wait`` and
       yield per-token percentiles from >0 timed gaps.
    c. **Adaptive-γ A-B.** Fixed-γ vs ``--spec-adaptive`` engines on
       identical seeds and prompt schedules: the controller's
       acceptance-weighted goodput (useful tokens per wall second) must
       land no worse than the fixed baseline (floor loose enough that
       CPU jitter cannot fail a neutral controller).
    d. **Overhead.** The marginal cost of the token-append path,
       measured directly (N appends timed against the same loop with
       the timeline's one-branch no-op), judged against wall time at a
       1k tok/s decode cadence — the speedometer may not slow the car.

    ``cfg``: the model the engines serve (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``.
    """
    import time as _time

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.obs.token_timeline import TokenTimeline
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    mcfg = cfg if cfg is not None else ModelConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=32, intermediate=128, max_seq_len=1024,
    )
    params = init_params(mcfg, seed, device)
    sampling = SamplingParams(temperature=0.0, max_new_tokens=16)

    def make_engine(adaptive: bool, capacity: int = 4096) -> Engine:
        return Engine(
            mcfg,
            params,
            num_slots=4096,
            page_size=4,
            max_batch=8,
            spec_decode_tokens=gamma,
            spec_adaptive=adaptive,
            token_timeline_capacity=capacity,
            token_stall_threshold_s=stall_threshold_s,
            name="spec-eng",
            device=device,
        )

    def prompts_for(n_tokens: int, count: int) -> list[list[int]]:
        # Period-4 repeating tails: the n-gram drafter finds its
        # context match, and greedy decoding over a tiny model keeps
        # continuations deterministic for the replay pass.
        out = []
        for i in range(count):
            head = list(
                rng.integers(1, mcfg.vocab_size - 1, size=4).astype(int)
            )
            out.append((head * ((n_tokens // 4) + 1))[:n_tokens])
        return out

    # -- phase a: acceptance + conservation ----------------------------
    eng = make_engine(adaptive=False)
    schedule = prompts_for(16, 3) + prompts_for(48, 3)
    eng.generate(schedule, sampling)
    eng.generate(schedule, sampling)  # replay: tree-peek drafts land
    led = eng.spec_ledger
    totals = led.totals()
    st = eng.stats
    conserved = (
        st.spec_proposed == st.spec_accepted + st.spec_rejected
        and totals["proposed"] == totals["accepted"] + totals["rejected"]
        and totals["proposed"] == st.spec_proposed
    )
    by_shape: dict = {}
    by_source: dict = {}
    waves = 0
    for c in led.report().values():
        waves += c["waves"]
        for axis, key in ((by_shape, c["shape"]), (by_source, c["source"])):
            cell = axis.setdefault(
                key, {"proposed": 0, "accepted": 0, "rejected": 0}
            )
            cell["proposed"] += c["proposed"]
            cell["accepted"] += c["accepted"]
            cell["rejected"] += c["rejected"]
    for axis in (by_shape, by_source):
        for cell in axis.values():
            cell["acceptance"] = round(
                cell["accepted"] / max(1, cell["proposed"]), 4
            )
    acceptance = {
        "performed": True,
        "proposed": totals["proposed"],
        "accepted": totals["accepted"],
        "rejected": totals["rejected"],
        "conserved": bool(conserved),
        "waves": waves,
        "accepted_per_step": round(totals["accepted"] / max(1, waves), 4),
        "by_shape": by_shape,
        "by_source": by_source,
    }

    # -- phase b: ITL + seeded scheduler_wait stall --------------------
    reqs = [eng.add_request(p, sampling) for p in prompts_for(16, 2)]
    steps = 0
    while eng.has_work() and steps < 200:
        eng.step()
        steps += 1
        if steps == 3:
            # Mid-decode sleep by the caller: from the stream's point of view
            # this IS a scheduler-side stall (nothing else is parked,
            # restoring, or mid-prefill).
            _time.sleep(stall_sleep_s)
    snap = eng.timeline.snapshot(limit=16)
    itl_all = snap["itl"].get("default", {})
    seeded_cause = "scheduler_wait"
    itl = {
        "performed": True,
        "count": int(itl_all.get("count", 0)),
        "p50_s": itl_all.get("p50_s"),
        "p99_s": itl_all.get("p99_s"),
        "stalls": snap["stalls"],
        "stall_seconds": snap["stall_seconds"],
        "seeded_cause": seeded_cause,
        "seeded_detected": bool(snap["stalls"].get(seeded_cause, 0) >= 1),
    }

    # -- phase c: adaptive-γ A-B ---------------------------------------
    ab = {}
    for label, adaptive in (("fixed", False), ("adaptive", True)):
        e = make_engine(adaptive=adaptive)
        sched = prompts_for(16, 3) + prompts_for(48, 3)
        e.generate(sched, sampling)  # warm pass: compiles + tree fill
        warm_tokens = e.stats.generated_tokens
        t0 = _time.monotonic()
        e.generate(sched, sampling)
        t1 = _time.monotonic()
        tot = e.spec_ledger.totals()
        timed_tokens = e.stats.generated_tokens - warm_tokens
        ab[label] = {
            "tokens": timed_tokens,
            "wall_s": round(t1 - t0, 4),
            "tps": round(timed_tokens / max(1e-9, t1 - t0), 2),
            "acceptance": round(
                tot["accepted"] / max(1, tot["proposed"]), 4
            ),
        }
    ratio = ab["adaptive"]["tps"] / max(1e-9, ab["fixed"]["tps"])
    adaptive = {
        "performed": True,
        "gamma_base": gamma,
        "fixed_goodput_tps": ab["fixed"]["tps"],
        "adaptive_goodput_tps": ab["adaptive"]["tps"],
        "goodput_ratio": round(ratio, 4),
        "no_worse": bool(ratio >= adaptive_ratio_floor),
        "fixed_acceptance": ab["fixed"]["acceptance"],
        "adaptive_acceptance": ab["adaptive"]["acceptance"],
    }

    # -- phase d: token-append overhead at a 1k tok/s cadence ----------
    tl = TokenTimeline(
        capacity=4096, stall_threshold_s=stall_threshold_s, node="ovh"
    )
    gaps = rng.uniform(0.001, 0.02, size=overhead_tokens)
    t0 = _time.monotonic()
    for i in range(overhead_tokens):
        tl.note_token(i % 8, "default", float(gaps[i]), now=float(i))
    on_s = _time.monotonic() - t0
    none_tl = None
    t0 = _time.monotonic()
    for i in range(overhead_tokens):
        # The disabled path the engine hot loop pays: one branch.
        if none_tl is not None:
            none_tl.note_token(i % 8, "default", float(gaps[i]))
    off_s = _time.monotonic() - t0
    # Marginal append cost vs the wall available at 1k tok/s (1 ms per
    # token): the <1% budget the tentpole promises.
    wall_at_1k = overhead_tokens * 1e-3
    fraction = max(0.0, on_s - off_s) / wall_at_1k
    overhead = {
        "tokens": overhead_tokens,
        "timeline_on_s": round(on_s, 6),
        "timeline_off_s": round(off_s, 6),
        "fraction": round(fraction, 6),
        "budget_fraction": overhead_budget,
        "under_budget": bool(fraction < overhead_budget),
    }

    return {
        "acceptance": acceptance,
        "itl": itl,
        "adaptive": adaptive,
        "overhead": overhead,
        "requests": len(schedule) * 2 + len(reqs),
        "wall_s": round(_time.monotonic() - t_start, 3),
    }


# The crossover sweep's paged leg against its dense leg (max abs, float32
# inputs of unit scale): two softmax orders round far below it.
SWEEP_ATOL = 1e-4


def run_convoy_workload(
    seed: int = 0,
    inline_budget: int = 32,
    max_defer: int = 2,
    reps: int = 5,
    stall_threshold_s: float = 0.02,
    paged_min_batch: int = 16,
    *,
    cfg=None,
    device=None,
) -> dict:
    """The CONVOY acceptance workload (killing the prefill convoy): one
    cell proving decode-interleaved chunked prefill and the small-batch
    paged dispatch end to end.

    a. **Interleave A-B.** Two engines on IDENTICAL virtual arrival
       schedules — ``prefill_inline_budget=0`` (legacy alternating
       waves) vs ``>0`` (mixed waves). A carrier stream decodes; a long
       prompt arrives; a short prompt arrives one wave later. In the
       base arm the short prompt's TTFT eats the long prompt's whole
       prefill wave (the convoy); in the mixed arm the long prompt
       advances in budget-sized chunks and SPT allotment lets the short
       prompt jump the line. Outputs must match bit-for-bit (greedy +
       deterministic spec verify), TTFT must improve, decode ITL p99
       and spec accepted-per-wave must not regress.
    b. **Stall decomposition.** The token timeline's per-cause stall
       seconds for the same two arms: ``prefill_convoy`` per request
       must drop, and what mixing leaves behind is attributed to the
       new ``prefill_inline`` cause instead of bleeding into
       ``scheduler_wait``.
    c. **Starvation proof.** 20:1 prompt-length skew with boost waves
       enabled (``prefill_wave_tokens`` shrunk below the backlog):
       counted in WAVES, not wall-clock, the carrier stream never goes
       more than ``max_defer`` consecutive engine steps without a
       token while backlog is pending.
    d. **Crossover sweep.** Dense-vs-paged decode dispatch at batch
       2/4/8/32 (the dense leg is the plain math; the paged leg is the
       pool kernel on the card): ``select_paged`` must choose
       dense below ``--paged-min-batch`` (so the effective path is
       never the slow small-batch paged launch), and the bucketed paged
       wrapper must cost ~nothing at an at-bucket batch. Each batch's
       paged output is held against the dense leg's first
       (``outputs_agree``: max abs within ``SWEEP_ATOL``).

    ``cfg``: the model the engines serve (default: the toy model below);
    ``device``: CUDA unless ``"cpu"``. Token equality across the two arms
    holds in float32 (a bfloat16 model may break a near-tie differently
    in a chunk and in a mixed wave).
    """
    import time as _time

    import torch

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.obs.token_timeline import TokenTimeline
    from radixmesh_tpu_torch.ops.attention import (
        attend_decode_ref,
        batch_bucket,
        last_dispatch,
        paged_attention_pool_bucketed,
        select_paged,
    )
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t_start = _time.monotonic()
    mcfg = cfg if cfg is not None else ModelConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=32, intermediate=128, max_seq_len=1024,
    )
    params = init_params(mcfg, seed, device)
    samp_carrier = SamplingParams(temperature=0.0, max_new_tokens=48)
    samp_tail = SamplingParams(temperature=0.0, max_new_tokens=8)

    def prompts_for(n_tokens: int, count: int) -> list[list[int]]:
        # Period-4 repeating tails (same recipe as run_spec_workload):
        # n-gram drafts land, greedy keeps both arms bit-identical.
        out = []
        for _ in range(count):
            head = list(
                rng.integers(1, mcfg.vocab_size - 1, size=4).astype(int)
            )
            out.append((head * ((n_tokens // 4) + 1))[:n_tokens])
        return out

    def make_engine(budget: int, **kw) -> Engine:
        return Engine(
            mcfg,
            params,
            num_slots=4096,
            page_size=4,
            max_batch=4,
            spec_decode_tokens=kw.pop("spec", 2),
            prefill_inline_budget=budget,
            prefill_inline_max_defer=max_defer,
            token_timeline_capacity=4096,
            token_stall_threshold_s=stall_threshold_s,
            name=f"convoy-{'mixed' if budget else 'base'}",
            device=device,
            **kw,
        )

    # -- phases a+b: interleave A-B + stall decomposition --------------
    # Identical virtual arrival schedule per arm: carrier decoding, the
    # long prompt enqueued, the late short request STAMPED (submit_time
    # starts its TTFT clock) before the wave it cannot join, enqueued
    # right after. Iteration 0 is shape warmup (compiles), discarded.
    schedules = []
    for _ in range(reps + 1):
        schedules.append(
            (
                prompts_for(16, 1)[0],
                prompts_for(960, 1)[0],
                prompts_for(16, 1)[0],
            )
        )

    def run_arm(budget: int) -> dict:
        eng = make_engine(budget)
        ttfts: list[float] = []
        outputs: list[list[list[int]]] = []
        for it, (pc, pl, ps) in enumerate(schedules):
            carrier = eng.add_request(pc, samp_carrier)
            for _ in range(3):
                eng.step()
            long_req = eng.add_request(pl, samp_tail)
            late = eng.make_request(ps, samp_tail)
            eng.step()  # the convoy wave (base) / one mixed chunk
            eng.enqueue(late)
            steps = 0
            while eng.has_work() and steps < 800:
                eng.step()
                steps += 1
            if it == 0:
                # Warmup done: swap in a fresh timeline so the compile
                # spikes don't pollute the measured ITL percentiles or
                # the stall-cause decomposition.
                eng.timeline = TokenTimeline(
                    capacity=4096,
                    stall_threshold_s=stall_threshold_s,
                    node=eng.name,
                )
                continue
            ttfts.append(late.first_token_time - late.submit_time)
            outputs.append(
                [
                    list(map(int, r.output_tokens))
                    for r in (carrier, long_req, late)
                ]
            )
        snap = eng.timeline.snapshot(limit=1)
        stall_s = {
            c: round(s, 6)
            for c, s in eng.timeline.stall_seconds.items()
            if s > 0
        }
        st = eng.stats
        return {
            "ttft_p50_s": float(np.median(ttfts)),
            "itl_p99_s": snap["itl"].get("default", {}).get("p99_s"),
            "outputs": outputs,
            "stall_seconds": stall_s,
            "requests": 3 * reps,
            "spec_accepted_per_wave": round(
                st.spec_accepted / max(1, st.decode_steps), 4
            ),
            "waves": (
                eng.waves.snapshot() if eng.waves is not None else None
            ),
        }

    base = run_arm(0)
    mixed = run_arm(inline_budget)
    ttft_ratio = base["ttft_p50_s"] / max(1e-9, mixed["ttft_p50_s"])
    interleave = {
        "performed": True,
        "reps": reps,
        "inline_budget": inline_budget,
        "base_ttft_p50_s": round(base["ttft_p50_s"], 6),
        "mixed_ttft_p50_s": round(mixed["ttft_p50_s"], 6),
        "ttft_ratio": round(ttft_ratio, 4),
        "base_itl_p99_s": base["itl_p99_s"],
        "mixed_itl_p99_s": mixed["itl_p99_s"],
        "outputs_match": bool(base["outputs"] == mixed["outputs"]),
        "base_accepted_per_wave": base["spec_accepted_per_wave"],
        "mixed_accepted_per_wave": mixed["spec_accepted_per_wave"],
        "waves": mixed["waves"],
    }
    per_req = lambda arm: arm["stall_seconds"].get(  # noqa: E731
        "prefill_convoy", 0.0
    ) / max(1, arm["requests"])
    base_cv, mixed_cv = per_req(base), per_req(mixed)
    stalls = {
        "performed": True,
        "stall_threshold_s": stall_threshold_s,
        "base_convoy_s_per_req": round(base_cv, 6),
        "mixed_convoy_s_per_req": round(mixed_cv, 6),
        "convoy_drop_ratio": round(min(base_cv / max(1e-9, mixed_cv), 1e6), 2),
        "base_causes": base["stall_seconds"],
        "mixed_causes": mixed["stall_seconds"],
        "inline_attributed_s": mixed["stall_seconds"].get(
            "prefill_inline", 0.0
        ),
    }

    # -- phase c: starvation bound under 20:1 skew (virtual time) ------
    # prefill_wave_tokens shrunk below the long prompt so boost waves
    # actually fire; the bound is counted in engine STEPS the carrier
    # goes without a token while inline backlog is pending — wall-clock
    # never enters the judgment.
    eng = make_engine(inline_budget, spec=0, prefill_wave_tokens=128)
    carrier = eng.add_request(prompts_for(16, 1)[0], samp_carrier)
    for _ in range(3):
        eng.step()
    eng.add_request(prompts_for(320, 1)[0], samp_tail)  # 20:1 skew
    gap = max_gap = 0
    last = len(carrier.output_tokens)
    steps = 0
    while eng.has_work() and steps < 800:
        pending = bool(eng._inline)
        eng.step()
        steps += 1
        n = len(carrier.output_tokens)
        if n > last or not pending or carrier.state.name == "FINISHED":
            gap = 0
        else:
            gap += 1
            max_gap = max(max_gap, gap)
        last = n
    wsnap = eng.waves.snapshot()
    starvation = {
        "performed": True,
        "skew": "320:16",
        "max_defer_bound": max_defer,
        "max_step_gap": max_gap,
        "max_defer_observed": wsnap["max_defer_observed"],
        "boost_waves": wsnap["counts"]["boost"],
        "bounded": bool(
            max_gap <= max_defer
            and wsnap["max_defer_observed"] <= max_defer
        ),
        "carrier_tokens": len(carrier.output_tokens),
    }

    # -- phase d: paged/dense crossover sweep --------------------------
    # The dense leg is the JAX scenario's ``use_kernel=False`` leg: the
    # gathered pages through the plain math (``attend_decode_ref``). The
    # paged leg is ``paged_attention_pool_bucketed``: the CUDA pool kernel
    # on the card, its plain version on the CPU. The sweep proves the
    # dispatch policy (dense below --paged-min-batch) and that the
    # bucketed wrapper is free at an at-bucket batch; the kernel's own
    # time against its bound is kernelbench's.
    def dense_leg(q, kv, pt, lens):
        return attend_decode_ref(q, kv[0, 0], kv[1, 0], pt, lens)

    def buck_leg(q, kv, pt, lens):
        return paged_attention_pool_bucketed(q, kv, pt, lens, 0)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, *a) -> float:
        sync()
        t0 = _time.perf_counter()
        fn(*a)
        sync()
        return _time.perf_counter() - t0

    krng = torch.Generator(device=device).manual_seed(seed + 1)
    page, D, Hq, Hkv, seq = 4, 64, 2, 2, 256
    per_pages = seq // page
    sweep = []
    for B in (2, 4, 8, 32):
        kv = torch.randn(
            (2, 1, Hkv, B * per_pages, page, D), generator=krng, device=device
        )
        q = torch.randn((B, Hq, D), generator=krng, device=device)
        pt = torch.arange(
            B * per_pages, dtype=torch.int32, device=device
        ).reshape(B, per_pages)
        lens = torch.full((B,), seq, dtype=torch.int32, device=device)
        # The paged leg held against the dense leg on these inputs (which
        # also warms both): all float32, so a gap past SWEEP_ATOL is a wrong
        # kernel, not rounding. Then INTERLEAVE the timed reps — back-to-
        # back loops see thermal/GC drift that min-of-N alone doesn't cancel.
        err = float(
            (buck_leg(q, kv, pt, lens) - dense_leg(q, kv, pt, lens)).abs().max()
        )
        dense_t = buck_t = float("inf")
        for _ in range(9):
            dense_t = min(dense_t, timed(dense_leg, q, kv, pt, lens))
            buck_t = min(buck_t, timed(buck_leg, q, kv, pt, lens))
        paged_sel = select_paged(
            B, D, device, min_batch=paged_min_batch, max_len=seq
        )
        eff_t = buck_t if paged_sel else dense_t
        sweep.append(
            {
                "batch": B,
                "bucket": batch_bucket(B),
                "paged_selected": bool(paged_sel),
                "dense_t_s": round(dense_t, 6),
                "bucketed_t_s": round(buck_t, 6),
                "effective_over_dense": round(dense_t / eff_t, 4),
                "bucketed_over_direct": round(dense_t / buck_t, 4),
                "max_abs_err": err,
                "dispatch": last_dispatch(),
            }
        )
    small = [e for e in sweep if e["batch"] < paged_min_batch]
    large = [e for e in sweep if e["batch"] >= 32]
    crossover = {
        "performed": True,
        "paged_min_batch": paged_min_batch,
        "sweep": sweep,
        "small_batch_ok": bool(
            small
            and all(e["effective_over_dense"] >= 0.9 for e in small)
            and all(not e["paged_selected"] for e in small)
        ),
        "large_batch_ok": bool(
            large and all(e["bucketed_over_direct"] >= 0.9 for e in large)
        ),
        "outputs_agree": all(e["max_abs_err"] <= SWEEP_ATOL for e in sweep),
    }

    return {
        "interleave": interleave,
        "stalls": stalls,
        "starvation": starvation,
        "crossover": crossover,
        "wall_s": round(_time.monotonic() - t_start, 3),
    }
