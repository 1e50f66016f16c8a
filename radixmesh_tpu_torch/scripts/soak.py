"""HTTP serving soak over the port (``scripts/soak.py`` of the JAX package).

Starts a real :class:`ServingFrontend` (HTTP, the engine's runner thread,
the radix cache) over the port's ``Engine`` and ``--clients`` concurrent
client threads, each cycling its own pool of multi-turn conversations (a
shared system prefix and a growing history: every turn after the first is
a long-prefix hit) against ``POST /generate`` until ``--seconds`` elapse.
Reports requests, errors, the prefix-cache hit rate (server counters),
the server's p50 TTFT and the clients' request-latency percentiles as ONE
JSON line; ``--out FILE`` writes the same line to a file. Exit 0 when no
request failed, else 1 (2 on a refused ``--out``).

Usage::

    python -m radixmesh_tpu_torch.scripts.soak --seconds 600 --clients 3 \\
        [--device cuda|cpu] [--model llama3-8b|toy] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

import numpy as np

from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg


def _post(url: str, obj: dict, timeout=120.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url: str, timeout=10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class _Client(threading.Thread):
    """One soak client: cycles its conversations turn by turn, growing
    each context with the server's replies (so every turn after the first
    is a long-prefix hit: the multi-turn serving shape)."""

    def __init__(self, base: str, client_id: int, n_conv: int, vocab: int, deadline: float, gen_len: int):
        super().__init__(daemon=True, name=f"soak-client-{client_id}")
        self.base = base
        self.deadline = deadline
        self.gen_len = gen_len
        rng = np.random.default_rng(100 + client_id)
        self.rng = rng
        system = rng.integers(1, vocab, size=32).tolist()
        self.contexts = [list(system) for _ in range(n_conv)]
        self.vocab = vocab
        self.requests = 0
        self.errors = 0
        self.latencies: list[float] = []

    def run(self) -> None:
        conv = 0
        while time.monotonic() < self.deadline:
            ctx = self.contexts[conv]
            prompt = ctx + self.rng.integers(1, self.vocab, size=16).tolist()
            t0 = time.monotonic()
            try:
                out = _post(self.base + "/generate", {"input_ids": prompt, "max_tokens": self.gen_len})
                self.latencies.append(time.monotonic() - t0)
                self.requests += 1
                self.contexts[conv] = prompt + out["output_ids"]
                # Conversations can't grow unboundedly in a soak: retire a
                # finished conversation and start a fresh one (keeps pool
                # pressure realistic: admission, eviction and publishes
                # keep churning instead of saturating).
                if len(self.contexts[conv]) > 480:
                    system = self.contexts[conv][:32]
                    self.contexts[conv] = list(system)
            except Exception:  # noqa: BLE001 — a failed request is the measurement
                self.errors += 1
            conv = (conv + 1) % len(self.contexts)


def run_soak(seconds: float, clients: int, n_conv: int, gen_len: int, *, cfg=None, device=None) -> dict:
    """The soak at ``cfg``'s widths (None: ``ModelConfig.tiny()``, the JAX
    soak's model) on ``device`` (the card unless ``"cpu"``)."""
    import torch

    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.server.http_frontend import ServingFrontend
    from radixmesh_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = cfg if cfg is not None else ModelConfig.tiny()
    with torch.inference_mode():
        params = init_params(cfg, 0, device)
    engine = Engine(cfg, params, num_slots=16384, page_size=8, max_batch=8, device=device, name="soak")
    frontend = ServingFrontend(engine, port=0)
    try:
        base = f"http://127.0.0.1:{frontend.port}"
        s0 = _get(base + "/stats")
        deadline = time.monotonic() + seconds
        pool = [_Client(base, i, n_conv, cfg.vocab_size, deadline, gen_len) for i in range(clients)]
        t0 = time.monotonic()
        for c in pool:
            c.start()
        for c in pool:
            c.join(timeout=seconds + 120)
        wall = time.monotonic() - t0
        s1 = _get(base + "/stats")
    finally:
        frontend.close()
    lat = np.asarray(sorted(sum((c.latencies for c in pool), [])))
    prompt = s1["prompt_tokens"] - s0["prompt_tokens"]
    cached = s1["cached_tokens"] - s0["cached_tokens"]
    requests = sum(c.requests for c in pool)
    return {
        "metric": "soak_requests",
        "value": requests,
        "unit": f"requests in {seconds:.0f}s, {clients} clients",
        "wall_s": round(wall, 1),
        "requests_per_s": round(requests / wall, 2) if wall else 0.0,
        "errors": sum(c.errors for c in pool),
        "hit_rate": round(cached / prompt, 4) if prompt else 0.0,
        "generated_tokens": s1["generated_tokens"] - s0["generated_tokens"],
        "preemptions": s1["preemptions"] - s0["preemptions"],
        "server_p50_ttft_ms": round(s1["p50_ttft_s"] * 1e3, 2),
        "client_latency_ms": {
            "p50": round(float(np.percentile(lat, 50)) * 1e3, 1) if len(lat) else None,
            "p99": round(float(np.percentile(lat, 99)) * 1e3, 1) if len(lat) else None,
        },
        "targets": {"hit_rate": 0.70, "errors": 0},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="soak", description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--conversations", type=int, default=8, help="concurrent conversations per client")
    ap.add_argument("--gen-len", type=int, default=8)
    add_engine_args(ap)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if refuse_jax_out("soak", "SOAK", args.out):
        return 2
    report = run_soak(args.seconds, args.clients, args.conversations, args.gen_len,
                      cfg=scenario_cfg(args), device=args.device)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if report["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
