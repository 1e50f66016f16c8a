"""``python -m radixmesh_tpu_torch.launch node``: the JAX launcher's
``node`` subcommand in the port.

Each ``node`` flag whose feature is not ported yet is refused by name with
its ROADMAP.md queue item, and so are the router role and the config keys
of unported planes. Two node processes, a prefill and a decode node of the
tiny model on the CPU over the native transport, from JSON configs with a
``model:`` section and ``--fleet-digest-interval 0.5``, run
``chip_smoke.py``'s launcher leg: ``POST /generate`` to the prefill node,
then the decode node counts the replicated oplogs and its fleet view holds
the prefill node's digest with the prefill node's own fingerprint."""

import json

import pytest

import chip_smoke
from radixmesh_tpu_torch.launch import _NOT_PORTED_NODE, main, parse_args


@pytest.mark.parametrize("flag", sorted(_NOT_PORTED_NODE))
def test_unported_node_flags_are_refused_by_name(flag, capsys):
    assert flag in {"--warm-up", "--health-aware-routing", "--kv-prefetch-hints",
                    "--repair-interval", "--drain-timeout", "--agg-interval"}
    with pytest.raises(SystemExit) as e:
        parse_args(["node", "--config-file", "x.json", flag, "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"queue {_NOT_PORTED_NODE[flag]}" in err


def test_node_parses_the_ported_flags():
    args = parse_args([
        "node", "--config-file", "n.json", "--ready-timeout", "9", "--tokenizer", "byte",
        "--fleet-digest-interval", "0.5", "--replication-factor", "2", "--router-nodes", "a:1,b:2",
        "--rebalance-interval", "1", "--chaos-plan", "plan.json", "--kv-transfer-async",
        "--trace-sample", "0.5", "--telemetry-history-interval", "0", "--device", "cpu",
    ])
    assert (args.cmd, args.config_file, args.ready_timeout, args.tokenizer, args.fleet_digest_interval,
            args.replication_factor, args.router_nodes, args.rebalance_interval, args.chaos_plan,
            args.kv_transfer_async, args.trace_sample, args.telemetry_history_interval, args.device) == (
        "node", "n.json", 9.0, "byte", 0.5, 2, "a:1,b:2", 1.0, "plan.json", True, 0.5, 0.0, "cpu")
    # ``serve`` keeps its flags and refuses none of the node-only ones'
    # features by the node table.
    assert parse_args(["serve", "--device", "cpu", "--kv-transfer-async"]).kv_transfer_async


_BASE = {"prefill_nodes": ["127.0.0.1:51710"], "decode_nodes": ["127.0.0.1:51711"],
         "router_nodes": ["127.0.0.1:51712"], "protocol": "tcp"}


@pytest.mark.parametrize("case,extra,match", [
    ("router role", {"local_addr": "127.0.0.1:51712"}, "router role.*queue A2"),
    ("repair plane", {"local_addr": "127.0.0.1:51710", "repair_interval_s": 1.0}, "repair_interval_s.*queue A3"),
    ("aggregation", {"local_addr": "127.0.0.1:51710", "agg_interval_s": 1.0}, "agg_interval_s.*queue A4"),
])
def test_unported_roles_and_keys_are_refused_by_name(case, extra, match, tmp_path):
    path = tmp_path / "node.json"
    path.write_text(json.dumps({**_BASE, **extra}))
    with pytest.raises(SystemExit, match=match):
        main(["node", "--config-file", str(path), "--device", "cpu"])


def test_two_node_processes_replicate_and_gossip_digests(tmp_path):
    out = chip_smoke.mesh_node_leg("llama3-tiny", 1024, device="cpu", out_dir=tmp_path)
    assert len(out["output_ids"]) == 8
    before, after = out["oplogs_received"]
    assert after > before
    pre, seen = out["prefill_digest"], out["decode_view_of_prefill"]
    assert pre["tree_tokens"] > 0 and seen["fingerprint"] == pre["fingerprint"]
    assert seen["role"] == "prefill" and seen["lifecycle"] == "active"
