"""The workloads that drive the port's engine: the synthetic ShareGPT-style
multi-turn traffic, open-loop overload across tenants, and the
self-contained acceptance scenarios of the speculative decoder, the
prefill convoy, the async KV plane, the disk tier and the mesh doctor.

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
``run_kvflow_workload``, ``run_tier_workload``, ``run_doctor_workload``)
build their own engines. Each runs on CUDA unless ``device="cpu"`` is
passed, and takes ``cfg``, the model configuration its engines serve:
``None`` is the JAX scenario's own toy model. Toy head dims (32) are below
what the CUDA kernels take (64 and 128), so on the card a scenario is given
a model of real widths (``ModelConfig.llama3_8b().replace(n_layers=2)``).
Weights are ``init_params(cfg, seed, device)``: the JAX scheme drawn with
other random numbers, so the tokens generated differ from the JAX run's.
"""

# The generators and scenario runners pace traffic, settle gossip and hold
# windows by the wall clock by design: nothing here runs on a serving
# thread.

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "MultiTurnWorkload",
    "OverloadWorkload",
    "TextMultiTurnWorkload",
    "run_convoy_workload",
    "run_doctor_workload",
    "run_engine_workload",
    "run_kvflow_workload",
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
