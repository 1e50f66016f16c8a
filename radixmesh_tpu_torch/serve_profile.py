"""Where a serving step's time goes on the card: a ``torch.profiler`` window
over the port's ``Engine`` at full model width.

    python -m radixmesh_tpu_torch.serve_profile [--model llama3-8b]
        [--shapes 4x600,8x2000] [--decode-steps 8] [--kv-quant int8]
        [--decode-steps-per-launch 4] [--spec-decode-tokens 4] [--replay]
        [--out chip_out]

For each ``BxN`` shape, ``B`` distinct random prompts of ``N`` tokens are
queued at once. The first ``step()`` admits them (group prefill through the
chunk kernel) and runs one decode step; it is profiled as the "prefill"
window. Then five windows of ``--decode-steps`` pure decode steps each
are timed without the profiler (per window in
``decode_wall_ms_per_step_unprofiled_windows``, their median in
``decode_wall_ms_per_step_unprofiled``), and the ``--decode-steps`` steps
after them form the profiled "decode" window. Each profiled window reports
its host wall time (ending in a synchronize), the device time of
every operation the profiler saw, grouped as decode attention / chunk
attention / matrix products / other, the device busy share (union of
device intervals over that wall time) and the device operations per step.
The profiler adds host time per operation, so the busy share it gives is a
lower bound. Random bf16 weights from ``--seed``; ``--kv-quant int8``
profiles an int8 KV pool. CUDA only.

The engine's six schedule flags (``--decode-steps-per-launch``,
``--prefill-inline-budget``, ``--prefill-inline-max-defer``,
``--paged-min-batch``, ``--spec-decode-tokens``, ``--spec-adaptive``) are
passed through, so one run profiles one schedule. A step then may emit
more than one token per row: every window also reports the tokens it
emitted, its wall time and device operations per emitted token. With
``--replay`` each shape's prompts first run to completion unprofiled and
are then submitted again, so a speculative run drafts from the radix tree
(the replayed request's own earlier generation); the other schedules see
the same prefix hits.

Prints one JSON line per shape; the profiler's per-kernel table goes to
``<out>/serve_profile.txt`` (``serve_profile_int8.txt`` with an int8 pool).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

__all__ = ["main", "profile_shape"]

# Kernel-name fragments of each group (cuBLAS/CUTLASS GEMM names vary by
# version: gemm, gemv, xmma, cutlass, nvjet).
_GROUPS = (
    ("decode_attention", ("paged_decode_kernel",)),
    ("chunk_attention", ("paged_chunk_tc_kernel", "paged_chunk_kernel")),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _window(prof, wall_s: float, steps: int, emitted: int) -> dict:
    """Device time by group, busy share and operation count of one
    profiled window of ``steps`` engine steps that emitted ``emitted``
    tokens."""
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
    ]
    if not kernels:
        raise RuntimeError("the profiler saw no device kernels: device time not measured")
    by_group: dict[str, float] = {}
    for e in kernels:
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    # Union of kernel intervals: busy time even where streams overlap.
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    wall_ms = wall_s * 1e3
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": {g: v / steps for g, v in sorted(by_group.items())},
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_ops_per_step": len(kernels) / steps,
        "emitted_tokens": emitted,
        "wall_ms_per_emitted_token": wall_ms / max(emitted, 1),
        "device_ops_per_emitted_token": len(kernels) / max(emitted, 1),
    }


# Unprofiled decode windows per shape: a host-clock wall per step varies
# from window to window, so one window alone cannot tell two commits apart.
_DECODE_WINDOWS = 5


def profile_shape(engine, batch: int, prompt_len: int, decode_steps: int, seed: int,
                  replay: bool = False):
    """Profile one prefill window, time ``_DECODE_WINDOWS`` windows of
    ``decode_steps`` steps without the profiler, then profile
    ``decode_steps`` more; returns ``(summary dict, [profiler,
    profiler])``. ``replay`` runs the prompts to completion first."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, engine.cfg.vocab_size, size=prompt_len).tolist() for _ in range(batch)]
    # Enough output budget for every window even when a step emits a whole
    # multi-step launch or an accepted draft per row.
    per_step = max(engine.decode_steps_per_launch, engine.spec_decode_tokens + 1)
    budget = (_DECODE_WINDOWS + 1) * decode_steps * per_step + 4
    if replay:
        engine.generate(prompts, _sampling(budget))
    for p in prompts:
        engine.add_request(p, _sampling(budget))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out, profs = {"batch": batch, "prompt_len": prompt_len}, []
    for name, steps in (("prefill", 1), ("decode", decode_steps)):
        torch.cuda.synchronize()
        if name == "decode":
            walls, per_token = [], []
            for _ in range(_DECODE_WINDOWS):
                n0 = engine.stats.generated_tokens
                t0 = time.perf_counter()
                for _ in range(steps):
                    engine.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                walls.append(wall_ms / steps)
                per_token.append(wall_ms / max(engine.stats.generated_tokens - n0, 1))
            out["decode_wall_ms_per_step_unprofiled"] = statistics.median(walls)
            out["decode_wall_ms_per_step_unprofiled_windows"] = walls
            out["decode_wall_ms_per_emitted_token_unprofiled"] = statistics.median(per_token)
        n0 = engine.stats.generated_tokens
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = _window(prof, wall, steps, engine.stats.generated_tokens - n0)
        profs.append(prof)
    engine.cancel_all()
    return out, profs


def _sampling(max_new: int):
    from radixmesh_tpu_torch.engine.request import SamplingParams

    return SamplingParams(max_new_tokens=max_new)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="serve_profile")
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--shapes", default="4x600,8x2000", help="comma list of BxN")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--kv-slots", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quant", choices=("int8",), default=None)
    ap.add_argument("--decode-steps-per-launch", type=int, default=1)
    ap.add_argument("--prefill-inline-budget", type=int, default=0)
    ap.add_argument("--prefill-inline-max-defer", type=int, default=2)
    ap.add_argument("--paged-min-batch", type=int, default=0)
    ap.add_argument("--spec-decode-tokens", type=int, default=0)
    ap.add_argument("--spec-adaptive", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="run each shape's prompts to completion first, then profile their replay")
    ap.add_argument("--out", default="chip_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device (this measures the card)", file=sys.stderr)
        return 2

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models import get_config, init_params
    from radixmesh_tpu_torch.ops._build import build_all

    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    cfg = get_config(args.model)
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        params = init_params(cfg, seed=args.seed, device=dev)
    max_batch = max(b for b, _ in shapes)
    schedule = dict(
        decode_steps_per_launch=args.decode_steps_per_launch,
        prefill_inline_budget=args.prefill_inline_budget,
        prefill_inline_max_defer=args.prefill_inline_max_defer,
        paged_min_batch=args.paged_min_batch,
        spec_decode_tokens=args.spec_decode_tokens,
        spec_adaptive=args.spec_adaptive,
    )
    engine = Engine(cfg, params, num_slots=args.kv_slots, page_size=16,
                    max_batch=max_batch, device=dev, kv_quant=args.kv_quant, **schedule)
    build_all()
    # Warm-up outside the windows: a concurrent pair (group prefill, both
    # kernels loaded), cuBLAS handles, the caching allocator.
    engine.generate([list(range(1, 65)), list(range(2, 70))])
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tables = []
    for i, (b, n) in enumerate(shapes):
        stats0 = dict(vars(engine.stats))
        summary, profs = profile_shape(engine, b, n, args.decode_steps, args.seed + 1 + i, args.replay)
        counts = ("spec_proposed", "spec_accepted", "multi_step_launches", "compact_launches",
                  "verify_launches", "mixed_launches")
        summary.update(model=args.model, kv_quant=args.kv_quant, schedule=schedule, replay=args.replay,
                       engine_counts={k: getattr(engine.stats, k) - stats0[k] for k in counts},
                       device=torch.cuda.get_device_name(0))
        print(json.dumps(summary), flush=True)
        for name, prof in zip(("prefill", "decode"), profs):
            tables.append(f"== {b}x{n} {name}\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=25))
    tag = "".join(f"_{k}{v}" for k, v in schedule.items() if v and k != "prefill_inline_max_defer")
    name = "serve_profile" + ("" if args.kv_quant is None else f"_{args.kv_quant}") + tag + ".txt"
    (out_dir / name).write_text("\n\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
