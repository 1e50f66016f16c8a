"""What the command lines under ``radixmesh_tpu_torch/scripts/`` share: the
device and model flags of the ones that build engines, and the refusal of
an ``--out`` that names a JAX package artifact."""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch.reports import jax_artifact

# The two models a scenario's engines take: ``MODEL``, Llama-3-8B's widths
# cut to ``LAYERS`` layers (the default: the JAX scenarios' toy model, head
# dim 32, is one that the card's attention kernels refuse), or ``TOY``, the
# scenario's own model.
MODEL = "llama3-8b"
LAYERS = 2
TOY = "toy"

# The doctor scenario's sizes beside ``MODEL``. Its convoy rule
# wants the long shape's e2e 1.5x the fleet's, and at 2 layers a
# 1536-token prefill (the default) is too quick for that on the card. Three
# 4608-token prompts would push the default 512-token restore prefixes out
# of the scenario's 8192-slot host arena before the restore lane is seeded,
# so those are 128 tokens, staged 16 at a time (8 chunks each, as the
# defaults give).
DOCTOR_KW = {"long_prompt": 4608, "restore_prompt": 128, "restore_chunk_tokens": 16}


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: the card (default; raises without one) or 'cpu'")
    ap.add_argument("--model", default=MODEL, choices=(MODEL, TOY),
                    help=f"{MODEL}: its widths, {LAYERS} layers deep (default); {TOY}: the JAX "
                    "scenario's own model")


def scenario_cfg(args, **replace):
    """The ``cfg=`` a scenario takes for ``--model``: None for the toy model
    (the scenario's own), else ``MODEL`` cut to ``LAYERS`` layers with
    ``replace``'s fields (a ``dtype``, say)."""
    if args.model == TOY:
        return None
    from radixmesh_tpu_torch.models import get_config

    return get_config(MODEL).replace(n_layers=LAYERS, **replace)


def refuse_jax_out(prog: str, kind: str, out: str | None) -> bool:
    """True (after saying so) when ``out`` names a JAX package artifact."""
    if out and jax_artifact(out):
        print(f"{prog}: refusing to write {out}: that is the JAX package's {kind} artifact "
              f"name (the port writes {kind}_torch_r{{N}}.json)", file=sys.stderr)
        return True
    return False
