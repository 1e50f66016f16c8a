"""Where a serving step's time goes on the card: a ``torch.profiler`` window
over the port's ``Engine`` at full model width.

    python -m radixmesh_tpu_torch.serve_profile [--model llama3-8b]
        [--shapes 4x600,8x2000] [--decode-steps 8] [--kv-quant int8]
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
# version: gemm, gemv, xmma, cutlass, nvjet). ``paged_attend_kernel`` is
# the one-launch decode kernel of earlier commits, so that a copy of this
# script profiles them the same way.
_GROUPS = (
    ("decode_attention", ("paged_split_kernel", "paged_combine_kernel", "paged_attend_kernel")),
    ("chunk_attention", ("paged_chunk_tc_kernel", "paged_chunk_kernel")),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _window(prof, wall_s: float, steps: int) -> dict:
    """Device time by group, busy share and operation count of one
    profiled window."""
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
    }


# Unprofiled decode windows per shape: a host-clock wall per step varies
# from window to window, so one window alone cannot tell two commits apart.
_DECODE_WINDOWS = 5


def profile_shape(engine, batch: int, prompt_len: int, decode_steps: int, seed: int):
    """Profile one prefill window, time ``_DECODE_WINDOWS`` windows of
    ``decode_steps`` steps without the profiler, then profile
    ``decode_steps`` more; returns ``(summary dict, [profiler,
    profiler])``."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    for _ in range(batch):
        engine.add_request(
            rng.integers(0, engine.cfg.vocab_size, size=prompt_len).tolist(),
            _sampling((_DECODE_WINDOWS + 1) * decode_steps + 4),
        )
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out, profs = {"batch": batch, "prompt_len": prompt_len}, []
    for name, steps in (("prefill", 1), ("decode", decode_steps)):
        torch.cuda.synchronize()
        if name == "decode":
            walls = []
            for _ in range(_DECODE_WINDOWS):
                t0 = time.perf_counter()
                for _ in range(steps):
                    engine.step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3 / steps)
            out["decode_wall_ms_per_step_unprofiled"] = statistics.median(walls)
            out["decode_wall_ms_per_step_unprofiled_windows"] = walls
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = _window(prof, wall, steps)
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
    engine = Engine(cfg, params, num_slots=args.kv_slots, page_size=16,
                    max_batch=max_batch, device=dev, kv_quant=args.kv_quant)
    build_all()
    # Warm-up outside the windows: a concurrent pair (group prefill, both
    # kernels loaded), cuBLAS handles, the caching allocator.
    engine.generate([list(range(1, 65)), list(range(2, 70))])
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tables = []
    for i, (b, n) in enumerate(shapes):
        summary, profs = profile_shape(engine, b, n, args.decode_steps, args.seed + 1 + i)
        summary.update(model=args.model, kv_quant=args.kv_quant,
                       device=torch.cuda.get_device_name(0))
        print(json.dumps(summary), flush=True)
        for name, prof in zip(("prefill", "decode"), profs):
            tables.append(f"== {b}x{n} {name}\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=25))
    name = "serve_profile.txt" if args.kv_quant is None else f"serve_profile_{args.kv_quant}.txt"
    (out_dir / name).write_text("\n\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
