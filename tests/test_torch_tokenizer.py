"""The port's tokenizer seam and text-in/text-out serving (a twin of
``tests/test_tokenizer.py``): ``ByteTokenizer`` round-trips and encodes as
the JAX package's does, ``load_tokenizer`` resolves ``byte`` and refuses
other specs, an HF tokenizer directory without ``transformers`` raises
naming the package, and the port's ``ServingFrontend`` with a tokenizer
answers ``text`` with ``text`` (EOS as the default stop), hits the prefix
cache on a revisit, still takes ``input_ids``, and answers ``text`` 400
without one."""

import json
import sys
import urllib.error
import urllib.request

import pytest
import torch

from radixmesh_tpu.server.tokenizer import ByteTokenizer as JByteTokenizer
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend
from radixmesh_tpu_torch.server.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    Tokenizer,
    load_tokenizer,
)

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _post(port: int, obj: dict, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


class TestByteTokenizer:
    @pytest.mark.parametrize("text", ["hello world", "héllo — ünïcode ✓", "", "\n\t"])
    def test_roundtrip_and_jax_ids(self, text):
        tok = ByteTokenizer()
        ids = tok.encode(text)
        assert all(3 <= i < tok.vocab_size for i in ids)
        assert tok.decode(ids) == text
        assert ids == JByteTokenizer().encode(text)

    def test_specials_never_emitted_and_skipped_on_decode(self):
        tok = ByteTokenizer()
        ids = tok.encode("ab")
        assert tok.eos_id not in ids
        assert tok.decode([tok.BOS, *ids, tok.EOS, 10_000]) == "ab"

    def test_satisfies_protocol(self):
        assert isinstance(ByteTokenizer(), Tokenizer)

    def test_load_tokenizer(self):
        assert isinstance(load_tokenizer("byte"), ByteTokenizer)
        with pytest.raises(ValueError, match="unknown tokenizer"):
            load_tokenizer("nonexistent-spec")

    def test_hf_directory_without_transformers_names_it(self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "transformers", None)
        with pytest.raises(RuntimeError, match="transformers"):
            load_tokenizer(str(tmp_path))
        with pytest.raises(RuntimeError, match="--tokenizer byte"):
            HFTokenizer(str(tmp_path))


def _engine(name, seed=0):
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    return Engine(cfg, init_params(cfg, seed=seed, device="cpu"), num_slots=512, page_size=4,
                  max_batch=2, device="cpu")


@pytest.fixture(scope="module")
def text_frontend():
    f = ServingFrontend(_engine("tok-test"), port=0, tokenizer=ByteTokenizer())
    yield f
    f.close(drain_s=0.0)


class TestTextServing:
    def test_text_in_text_out(self, text_frontend):
        status, out = _post(text_frontend.port, {"text": "The quick brown fox", "max_tokens": 6})
        assert status == 200
        assert isinstance(out["text"], str) and out["output_ids"]
        assert out["text"] == ByteTokenizer().decode(out["output_ids"])
        # EOS is the default stop for text callers: it ends the reply.
        assert ByteTokenizer.EOS not in out["output_ids"][:-1]

    def test_text_revisit_hits_prefix_cache(self, text_frontend):
        prompt = {"text": "shared prefix for the cache hit", "max_tokens": 4}
        _post(text_frontend.port, prompt)
        status, out = _post(text_frontend.port, prompt)
        assert status == 200
        assert out["cached_tokens"] > 0

    def test_text_matches_the_same_ids(self, text_frontend):
        text = "ids and text are one request"
        ids = ByteTokenizer().encode(text)
        _, by_text = _post(text_frontend.port, {"text": text, "max_tokens": 5,
                                                "stop_token_ids": []})
        _, by_ids = _post(text_frontend.port, {"input_ids": ids, "max_tokens": 5})
        assert by_text["output_ids"] == by_ids["output_ids"]
        assert by_ids["text"] == ByteTokenizer().decode(by_ids["output_ids"])

    def test_ids_still_first_class(self, text_frontend):
        status, out = _post(text_frontend.port, {"input_ids": [5, 6, 7, 8], "max_tokens": 4})
        assert status == 200 and out["output_ids"]

    def test_text_must_be_a_string(self, text_frontend):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(text_frontend.port, {"text": [1, 2], "max_tokens": 2})
        assert ei.value.code == 400

    def test_text_without_tokenizer_is_400(self):
        f = ServingFrontend(_engine("tok-none"), port=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f.port, {"text": "hi", "max_tokens": 2})
            assert ei.value.code == 400
            assert "no tokenizer" in json.loads(ei.value.read())["error"]
        finally:
            f.close(drain_s=0.0)
