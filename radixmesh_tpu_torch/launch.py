"""Launcher for the PyTorch/CUDA port.

    python -m radixmesh_tpu_torch.launch serve --model llama3-8b --device cuda
    python -m radixmesh_tpu_torch.launch serve --model llama3-8b --kv-quant int8

``serve`` builds one :class:`~radixmesh_tpu_torch.engine.engine.Engine`
(random weights from ``--seed``: no checkpoint loading yet) behind a
:class:`~radixmesh_tpu_torch.server.http_frontend.ServingFrontend` and
serves until SIGINT/SIGTERM. The device defaults to CUDA and the launcher
exits with an error where torch has none; ``--device cpu`` runs the plain
PyTorch path. ``--kv-quant int8`` stores the KV pool as int8 with per-token
scales. Flags of the JAX launcher whose features are not ported yet are
refused by name.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

__all__ = ["main", "parse_args"]

# ``serve`` flags of the JAX launcher whose features are not ported yet.
_NOT_PORTED_FLAGS = (
    "--weights", "--tokenizer", "--host-cache-slots", "--decode-steps-per-launch",
    "--prefill-inline-budget", "--prefill-inline-max-defer", "--paged-min-batch",
    "--spec-decode-tokens", "--spec-adaptive", "--weight-quant",
    "--kv-transfer-async", "--kv-transfer-chunk", "--kv-transfer-min-restore",
    "--kv-tier-dir", "--kv-tier-capacity-gb", "--stream-publish",
    "--step-accounting", "--peak-tflops", "--slo", "--slo-ttft-ms", "--slo-tenant",
    "--profile-dir", "--trace-capacity", "--trace-sample", "--trace-dir",
    "--token-timeline-capacity", "--token-stall-threshold-ms",
    "--telemetry-history-interval", "--blackbox-dir", "--blackbox-watchdog",
)


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
    if device.type == "cuda":
        from radixmesh_tpu_torch.ops._build import build_all

        # Build every kernel library now, in parallel, rather than one by
        # one inside the first requests.
        log.info("building the CUDA kernels ...")
        build_all()
    cfg = get_config(args.model)
    log.info("initializing %s (%d layers) on %s ...", args.model, cfg.n_layers, device)
    with torch.inference_mode():
        params = init_params(cfg, seed=args.seed, device=device)
    engine = Engine(
        cfg,
        params,
        num_slots=args.kv_slots,
        page_size=args.page_size,
        max_batch=args.max_batch,
        rng_seed=args.seed,
        device=device,
        kv_quant=args.kv_quant,
    )
    frontend = ServingFrontend(engine, host=args.host, port=args.http_port)
    print(f"serving {args.model} on http://{args.host}:{frontend.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        frontend.close()
    return 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse the launcher's command line; exits (status 2) on a flag of a
    feature that is not ported yet."""
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
    serve.add_argument("--kv-quant", choices=("int8",), default=None,
                       help="store the KV pool as int8 with per-token scales")
    serve.set_defaults(fn=_run_serve)
    argv = sys.argv[1:] if argv is None else argv
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED_FLAGS:
            parser.error(
                f"{flag} is not supported by the PyTorch port yet "
                "(see ROADMAP.md, queue A)"
            )
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
