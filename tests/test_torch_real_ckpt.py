"""The port serves a real-format checkpoint and tokenizer end to end (a twin
of ``tests/test_real_ckpt.py``): ``scripts/make_real_ckpt.py --tiny``
writes a ``transformers`` checkpoint (bf16 safetensors) and a trained
byte-level BPE tokenizer; the port loads both through its own
``models/hf_io.py`` and ``server/tokenizer.py`` and serves text over HTTP
with prefix reuse. Only this test imports the script."""

import json
import os
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import get_config as j_get_config
from radixmesh_tpu.models.hf_io import load_hf_checkpoint as j_load_checkpoint
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models import get_config
from radixmesh_tpu_torch.models.hf_io import load_hf_checkpoint
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend
from radixmesh_tpu_torch.server.tokenizer import HFTokenizer, load_tokenizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
torch.set_num_threads(1)  # the suite runs in parallel worker processes

TINY = dict(hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32, intermediate=256,
            vocab_size=512)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    from make_real_ckpt import save_hf_model, train_tokenizer

    out = str(tmp_path_factory.mktemp("real_ckpt"))
    assert save_hf_model(out, "llama3.2-1b", tiny=True)["n_params"] > 0
    train_tokenizer(out, vocab_size=384)
    return out


def test_tokenizer_loads_and_round_trips(ckpt_dir):
    tok = load_tokenizer(ckpt_dir)
    assert isinstance(tok, HFTokenizer)
    text = "The cache holds every prefix the router has seen."
    ids = tok.encode(text)
    assert ids and all(isinstance(i, int) for i in ids)
    assert max(ids) < 512
    assert tok.decode(ids) == text
    assert tok.eos_id is not None


def test_checkpoint_matches_the_jax_loader(ckpt_dir):
    cfg = get_config("llama3.2-1b", dtype=torch.float32, **TINY)
    params = load_hf_checkpoint(ckpt_dir, cfg, device="cpu")
    want = j_load_checkpoint(ckpt_dir, j_get_config("llama3.2-1b", dtype=jnp.float32, **TINY))
    assert tuple(params["embed"].shape) == (512, 128)
    assert tuple(params["layers"]["wq"].shape) == (2, 128, 4 * 32)
    assert "lm_head" not in params  # llama3.2 ties its embeddings
    np.testing.assert_array_equal(params["embed"].numpy(), np.asarray(want["embed"]))
    for name, leaf in params["layers"].items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want["layers"][name]))


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_text_conversation_serves_with_prefix_reuse(ckpt_dir):
    cfg = get_config("llama3.2-1b", dtype=torch.float32, max_seq_len=2048, **TINY)
    tok = load_tokenizer(ckpt_dir)
    engine = Engine(cfg, load_hf_checkpoint(ckpt_dir, cfg, device="cpu"), num_slots=2048,
                    page_size=4, max_batch=4, device="cpu")
    fe = ServingFrontend(engine, port=0, tokenizer=tok)
    try:
        system = "You are a helpful assistant. The cache keeps every prefix it has served. "
        context = system + "Which node holds the longest match?"
        first = _post(fe.port, {"text": context, "max_tokens": 4, "stop_token_ids": []})
        assert first["text"] == tok.decode(first["output_ids"])
        # Turn two extends turn one's text: its prefix is in the radix tree.
        context += first["text"] + " And after a restart?"
        second = _post(fe.port, {"text": context, "max_tokens": 4})
        assert second["cached_tokens"] > len(tok.encode(system)) // 2
        other = _post(fe.port, {"text": system + "Something else entirely.", "max_tokens": 4})
        assert other["cached_tokens"] > 0
        assert isinstance(other["text"], str)
    finally:
        fe.close(drain_s=0.0)
