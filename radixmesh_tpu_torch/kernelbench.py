"""Kernel-level micro-benchmark of the port's paged-attention kernels on the
card (the twin of ``scripts/kernelbench.py``): the read-only pool kernel,
the fused decode kernel and the chunk-prefill kernel, each over bf16 and
int8 pools, each with two page-table layouts, timed alone with no model
around them.

    python -m radixmesh_tpu_torch.kernelbench [--batch 64] [--ctx 1024]
        [--hq 16] [--iters 10] [--out FILE]

Page tables: ``run`` gives each row one consecutive run of pages (rows in
shuffled order), what the page-granular allocator produces for a freshly
prefilled sequence; ``perm`` permutes every page, the fragmented radix-cache
case. Every case runs at the script's shape (``--batch`` rows of ``--ctx``
tokens, ``--hq``/``--hkv``/``--head-dim``/``--page``; chunks of
``--chunk`` queries over ``--chunk-batch`` rows with ``--ctx`` prior
tokens) and again at Llama-3-8B's attention shape (Hq 32, Hkv 8, D 128,
page 16; B 8, 2048 tokens of context). The chunk kernel also runs at the
fast schedules' shapes at 8B widths, B 8 over 2048 prior tokens: C = 5 (a
γ = 4 speculative verify) and C = 16 (a mixed wave's floor).

Times are CUDA events with the L2 flushed before each launch and the
host's launch time kept out (``utils/cuda_timing.py``); ``host_us`` is the
host's own time per wrapper call, read with the card kept busy. Each case
carries its bound (the larger of its
bytes at the HBM rate and its operations at the dense bf16 peak) and one
``scaled_dot_product_attention`` yardstick over the same K/V gathered dense
(dequantized for int8 pools) — timed here, used nowhere in the port.
Prints one JSON line (also to ``--out``) with the card's name and power
limit. Unlike the JAX script it does not catch a kernel's exception: a
failure fails the run. CUDA only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["main", "run_shape"]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def run_shape(B, ctx, Hq, Hkv, D, page, C, Bc, iters, seed=0, kernels=("pool", "fused", "chunk")) -> dict:
    """Time every (kernel, pool dtype, page-table layout) case of
    ``kernels`` at one shape; returns ``{case: {ms, host_us, bound_ms,
    bound_by, library_ms}}``."""
    from radixmesh_tpu_torch.ops import paged_attention as pa
    from radixmesh_tpu_torch.ops.quant import quantize_kv
    from radixmesh_tpu_torch.utils.cuda_timing import (
        bound, dense_context, host_us, kv_bytes, sdpa_inputs, time_ms)

    if ctx % page:
        raise ValueError(f"ctx ({ctx}) must be a multiple of page ({page})")
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    maxp = ctx // page
    P = B * maxp + 1  # + one page for the decode write of the last token
    g = torch.Generator(device=dev).manual_seed(seed)
    kv32 = torch.randn(2, 1, Hkv, P, page, D, generator=g, device=dev)
    kv8, sc8 = quantize_kv(kv32)
    pools = {"bf16": (kv32.to(bf16), None), "int8": (kv8, sc8)}
    del kv32
    rng = np.random.default_rng(seed)
    rows = rng.permutation(B)
    tables = {
        "run": np.stack([np.arange(r * maxp, (r + 1) * maxp) for r in rows]),
        "perm": rng.permutation(B * maxp).reshape(B, maxp),
    }
    tables = {k: torch.as_tensor(v.astype(np.int32), device=dev) for k, v in tables.items()}
    q = torch.randn(B, Hq, D, generator=g, device=dev).to(bf16)
    kn = torch.randn(B, Hkv, D, generator=g, device=dev).to(bf16)
    lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    # The decode case writes its current token to the spare page's slots
    # and attends ctx - 1 pool tokens plus that token.
    spare = torch.full((B,), (P - 1) * page, dtype=torch.int32, device=dev)
    qc = torch.randn(Bc, C, Hq, D, generator=g, device=dev).to(bf16)
    kc = torch.randn(Bc, C, Hkv, D, generator=g, device=dev)
    prior = torch.full((Bc,), ctx, dtype=torch.int32, device=dev)
    G = Hq // Hkv

    def sdpa(qx, pt, n_rows, kv, sc, chunk_kv=None):
        """SDPA over each row's ``ctx`` pool tokens (dequantized), then
        ``chunk_kv`` ``[n, C, Hkv, D]`` appended, causal among itself."""
        k, v = dense_context(kv, sc, pt[:n_rows], 0, [ctx] * n_rows, ctx, bf16)
        mask = None
        if chunk_kv is not None:
            k = torch.cat([k, chunk_kv.to(bf16)], dim=1)
            v = torch.cat([v, chunk_kv.to(bf16)], dim=1)
            c = torch.arange(C, device=dev)
            mask = torch.cat([torch.ones(C, ctx, dtype=torch.bool, device=dev), c[None, :] <= c[:, None]], 1)
        k, v = sdpa_inputs(k, v, G)
        return lambda: F.scaled_dot_product_attention(qx, k, v, attn_mask=mask)

    out = {}
    for dname, (kv, sc) in pools.items():
        quant = sc is not None
        cur = torch.float32 if quant else bf16
        kcd = kc.to(cur)
        for tname, pt in tables.items():
            cases = {
                "pool": (
                    lambda: pa.paged_attention_pool_kernel(q, kv, pt, lens, 0, sc),
                    kv_bytes(B * ctx, kv, quant) + 2 * q.numel() * 2,
                    4 * Hq * D * B * ctx,
                    sdpa(q[:, :, None], pt, B, kv, sc),
                ),
                "fused": (
                    lambda: pa.paged_decode_fused_kernel(q, kn, kn, kv, spare, pt, lens, 0, sc),
                    kv_bytes(B * (ctx - 1) + B, kv, quant) + 2 * q.numel() * 2 + 2 * kn.numel() * 2,
                    4 * Hq * D * B * ctx,
                    sdpa(q[:, :, None], pt, B, kv, sc),
                ),
                "chunk": (
                    lambda: pa.paged_chunk_attention_kernel(
                        qc, kcd, kcd, kv, pt[:Bc], prior, prior + C, 0, sc),
                    kv_bytes(Bc * ctx, kv, quant) + 2 * qc.numel() * 2 + 2 * kcd.numel() * kcd.element_size(),
                    4 * Hq * D * Bc * (C * ctx + C * (C + 1) // 2),
                    sdpa(qc.permute(0, 2, 1, 3).contiguous(), pt, Bc, kv, sc, chunk_kv=kc),
                ),
            }
            for kname, (fn, nbytes, flops, lib) in ((k, cases[k]) for k in kernels):
                b_ms, b_by = bound(nbytes, flops, bf16)
                out[f"{kname}_{dname}_{tname}"] = {
                    "ms": time_ms(fn, iters, dev),
                    "host_us": host_us(fn, device=dev),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": time_ms(lib, iters, dev),
                }
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kernelbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--hq", type=int, default=16)
    ap.add_argument("--hkv", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--chunk-batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernelbench: no CUDA device (this measures the card)", file=sys.stderr)
        return 2

    from radixmesh_tpu_torch.ops._build import build_all

    build_all()
    shapes = {
        "default": dict(B=args.batch, ctx=args.ctx, Hq=args.hq, Hkv=args.hkv, D=args.head_dim,
                        page=args.page, C=args.chunk, Bc=args.chunk_batch),
        "llama3_8b": dict(B=8, ctx=2048, Hq=32, Hkv=8, D=128, page=16, C=512, Bc=8),
        "llama3_8b_verify": dict(B=8, ctx=2048, Hq=32, Hkv=8, D=128, page=16, C=5, Bc=8,
                                 kernels=("chunk",)),
        "llama3_8b_mixed": dict(B=8, ctx=2048, Hq=32, Hkv=8, D=128, page=16, C=16, Bc=8,
                                kernels=("chunk",)),
    }
    result = {"device": torch.cuda.get_device_name(0), "card": _card(), "shapes": shapes, "ms": {}}
    summary = {}
    for sname, shape in shapes.items():
        cases = run_shape(**shape, iters=args.iters)
        result["ms"][sname] = cases
        ms = {k: v["ms"] for k, v in cases.items()}
        kernels = shape.get("kernels", ("pool", "fused", "chunk"))
        for k in kernels:
            # > 1.0: the second case is faster.
            summary[f"{sname}_int8_vs_bf16_{k}"] = ms[f"{k}_bf16_run"] / ms[f"{k}_int8_run"]
            summary[f"{sname}_run_vs_perm_{k}"] = ms[f"{k}_bf16_perm"] / ms[f"{k}_bf16_run"]
        # bf16 K/V bytes the pool and fused cases read, over their times.
        shape_ctx = shape["B"] * shape["ctx"] * shape["Hkv"] * 2 * shape["D"] * 2
        for k in sorted(set(kernels) & {"pool", "fused"}):
            summary[f"{sname}_{k}_bf16_run_gbps"] = shape_ctx / (ms[f"{k}_bf16_run"] / 1e3) / 1e9
    result["summary"] = summary
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
