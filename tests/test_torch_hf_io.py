"""HF checkpoints through the port (a twin of ``tests/test_hf_io.py``):

- real ``transformers`` Llama and Qwen2 tiny models, their QKV biases
  planted non-zero before ``save_pretrained``, load through the port's
  ``load_hf_checkpoint`` and its float32 logits match the transformers
  model's own (rtol/atol 2e-4, as the JAX twin); greedy generation through
  the port's ``Engine`` equals ``generate``;
- the converted params are bit-equal to the JAX ``convert_hf_state_dict``
  in float32 and bf16 (float32 shards rounded to nearest even by both);
- the port's safetensors reader reads what the ``safetensors`` package
  writes (F32, F16, BF16, I8) and that package reads what the port writes;
  the sharded, indexed round trip is bit-exact; a missing tensor raises,
  naming it; tied embeddings take no LM head and an untied checkpoint
  without one takes ``embed.T``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models.hf_io import load_hf_state_dict as j_load_state
from radixmesh_tpu.models.llama import ModelConfig as JConfig
from radixmesh_tpu.models.llama import convert_hf_state_dict as j_convert
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import hf_state_dict
from radixmesh_tpu_torch.models.hf_io import (
    load_hf_checkpoint,
    load_hf_state_dict,
    read_safetensors,
    save_hf_state_dict,
    write_safetensors,
)
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, init_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes

_TINY = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
             intermediate=256, rope_theta=10000.0, rope_scaling=None, max_seq_len=512)


def _cfg(qkv_bias, dtype=torch.float32, **kw):
    return ModelConfig(qkv_bias=qkv_bias, dtype=dtype, **{**_TINY, **kw})


def _hf_model(path, qkv_bias: bool, tie=False):
    """A real transformers model, biases planted non-zero (transformers
    initialises them to zero), saved with ``save_pretrained``."""
    from transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM

    common = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=256, rope_theta=10000.0,
                  rms_norm_eps=1e-5, max_position_embeddings=512, tie_word_embeddings=tie,
                  use_cache=False)
    if qkv_bias:
        model_cls, hf_cfg = Qwen2ForCausalLM, Qwen2Config(**common)
    else:
        model_cls, hf_cfg = LlamaForCausalLM, LlamaConfig(attention_bias=False, **common)
    torch.manual_seed(7)
    model = model_cls(hf_cfg).to(torch.float32).eval()
    if qkv_bias:
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.5)
    model.save_pretrained(path, safe_serialization=True)
    return model, str(path)


@pytest.fixture(scope="module", params=["llama", "qwen2"])
def hf_ckpt(request, tmp_path_factory):
    qkv_bias = request.param == "qwen2"
    model, path = _hf_model(tmp_path_factory.mktemp(request.param), qkv_bias)
    return qkv_bias, model, path


def _logits(cfg, params, ids):
    model = Llama(cfg, params)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    empty = torch.zeros(L, 1, 0, Hkv, D, dtype=cfg.dtype)
    toks = torch.tensor([ids], dtype=torch.int64)
    pos = torch.arange(len(ids))[None]
    return model.prefill_forward(toks, pos, empty, empty, torch.zeros(1, dtype=torch.int64))[0][0]


def test_logits_match_transformers(hf_ckpt):
    qkv_bias, hf_model, path = hf_ckpt
    cfg = _cfg(qkv_bias)
    params = load_hf_checkpoint(path, cfg, device="cpu")
    if qkv_bias:
        assert torch.count_nonzero(params["layers"]["bk"]) > 0
    ids = [3, 141, 59, 26, 250, 8, 99, 400, 77, 12]
    ours = _logits(cfg, params, ids)
    with torch.no_grad():
        theirs = hf_model(torch.tensor([ids])).logits[0].float()
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-4, atol=2e-4)


def test_greedy_generation_matches_transformers(hf_ckpt):
    qkv_bias, hf_model, path = hf_ckpt
    cfg = _cfg(qkv_bias)
    prompt = [3, 141, 59, 26, 250, 8, 99, 400]
    with torch.no_grad():
        want = hf_model.generate(torch.tensor([prompt]), max_new_tokens=8, do_sample=False,
                                 use_cache=True)[0, len(prompt):].tolist()
    engine = Engine(cfg, load_hf_checkpoint(path, cfg, device="cpu"), num_slots=1024, page_size=16,
                    max_batch=2, device="cpu")
    assert engine.generate([prompt], SamplingParams(max_new_tokens=8))[0] == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_bit_equal_to_jax_convert(hf_ckpt, dtype):
    qkv_bias, _, path = hf_ckpt
    tcfg = _cfg(qkv_bias, getattr(torch, dtype))
    jcfg = JConfig(qkv_bias=qkv_bias, dtype=getattr(jnp, dtype), **_TINY)
    got = load_hf_checkpoint(path, tcfg, device="cpu")
    want = j_convert(jcfg, j_load_state(path))

    def bits(t):
        return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16).numpy()

    def jbits(a):
        a = np.asarray(a)
        return a.view(np.int32 if a.dtype == np.float32 else np.int16)

    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(got[name]), jbits(want[name]))
    for name, leaf in got["layers"].items():
        assert leaf.dtype == tcfg.dtype
        np.testing.assert_array_equal(bits(leaf), jbits(want["layers"][name]))


def test_reads_what_safetensors_writes(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    state = {
        "f32": torch.randn(5, 3, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 9, generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (3, 4, 2), generator=g, dtype=torch.int8),
        "scalar": torch.tensor(3.5),
    }
    save_file(state, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    back = read_safetensors(str(tmp_path / "a.safetensors"))
    assert set(back) == set(state)
    for k, t in state.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert torch.equal(back[k], t)


def test_safetensors_reads_what_the_port_writes(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(1)
    state = {
        "b.bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "a.f32": torch.randn(4, generator=g),
        "c.i8": torch.randint(-128, 128, (6,), generator=g, dtype=torch.int8),
        "d.f16": torch.randn(2, 2, generator=g).half(),
        "e.i32": torch.arange(5, dtype=torch.int32),
        "f.i64": torch.arange(3, dtype=torch.int64),
        "g.empty": torch.zeros(0, 4),
        "h.t": torch.randn(4, 6, generator=g).t(),  # non-contiguous
    }
    path = str(tmp_path / "p.safetensors")
    write_safetensors(state, path)
    back = load_file(path)
    assert set(back) == set(state)
    for k, t in state.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0  # the header is padded to 8 bytes


def test_unsupported_dtype_is_refused_by_name(tmp_path):
    from safetensors.torch import save_file

    save_file({"u": torch.zeros(3, dtype=torch.uint8)}, str(tmp_path / "u.safetensors"))
    with pytest.raises(ValueError, match="dtype U8"):
        read_safetensors(str(tmp_path / "u.safetensors"))
    with pytest.raises(ValueError, match="does not support"):
        write_safetensors({"b": torch.zeros(2, dtype=torch.bool)}, str(tmp_path / "b.safetensors"))


def test_sharded_roundtrip_bitexact(tmp_path):
    g = torch.Generator().manual_seed(2)
    state = {f"model.layers.{i}.weight_{j}": torch.randn(64, 48, generator=g)
             for i in range(4) for j in range(3)}
    state["model.embed_tokens.weight"] = torch.randn(40, 16, generator=g).bfloat16()
    save_hf_state_dict(state, str(tmp_path / "ck"), max_shard_bytes=40000)
    files = sorted(f.name for f in (tmp_path / "ck").iterdir())
    assert "model.safetensors.index.json" in files
    assert sum(f.endswith(".safetensors") for f in files) > 1
    index = json.loads((tmp_path / "ck" / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(state)
    back = load_hf_state_dict(str(tmp_path / "ck"))
    assert set(back) == set(state)
    for k, t in state.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t)
    # The JAX package's reader takes the port's shards too.
    jback = j_load_state(str(tmp_path / "ck"))
    np.testing.assert_array_equal(jback["model.layers.0.weight_0"],
                                  state["model.layers.0.weight_0"].numpy())


def test_single_file_and_errors(tmp_path):
    state = {"x": torch.arange(6, dtype=torch.float32)}
    save_hf_state_dict(state, str(tmp_path / "one"))
    assert sorted(p.name for p in (tmp_path / "one").iterdir()) == ["model.safetensors"]
    assert torch.equal(load_hf_state_dict(str(tmp_path / "one"))["x"], state["x"])
    # A stray shard name without an index.
    (tmp_path / "one" / "model.safetensors").rename(tmp_path / "one" / "weights.safetensors")
    assert torch.equal(load_hf_state_dict(str(tmp_path / "one"))["x"], state["x"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        load_hf_state_dict(str(tmp_path / "empty"))
    save_hf_state_dict({"a": torch.zeros(100), "b": torch.zeros(100)}, str(tmp_path / "idx"),
                       max_shard_bytes=400)
    index_path = tmp_path / "idx" / "model.safetensors.index.json"
    index = json.loads(index_path.read_text())
    index["weight_map"]["ghost"] = "model-00001-of-00002.safetensors"
    index_path.write_text(json.dumps(index))
    with pytest.raises(ValueError, match="ghost"):
        load_hf_state_dict(str(tmp_path / "idx"))


def test_missing_tensor_is_named(tmp_path):
    cfg = _cfg(True)
    state = hf_state_dict(cfg, init_params(cfg, seed=0, device="cpu"))
    del state["model.layers.1.self_attn.k_proj.bias"]
    save_hf_state_dict(state, str(tmp_path / "ck"))
    with pytest.raises(KeyError, match="model.layers.1.self_attn.k_proj.bias"):
        load_hf_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")


def test_tied_embeddings_and_missing_lm_head(tmp_path):
    _, path = _hf_model(tmp_path / "tied", qkv_bias=False, tie=True)
    tied = _cfg(False, tie_embeddings=True)
    params = load_hf_checkpoint(path, tied, device="cpu")
    assert "lm_head" not in params
    want = j_convert(JConfig(dtype=jnp.float32, tie_embeddings=True, **_TINY), j_load_state(path))
    np.testing.assert_array_equal(params["embed"].numpy(), np.asarray(want["embed"]))
    # An untied config over a checkpoint with no lm_head: embed.T, as JAX.
    untied = load_hf_checkpoint(path, _cfg(False), device="cpu")
    assert torch.equal(untied["lm_head"], untied["embed"].t())


def test_hf_state_dict_round_trip(tmp_path):
    cfg = _cfg(True, torch.bfloat16)
    params = init_params(cfg, seed=4, device="cpu")
    params["layers"]["bq"].normal_(generator=torch.Generator().manual_seed(4))
    save_hf_state_dict(hf_state_dict(cfg, params), str(tmp_path / "ck"), max_shard_bytes=1 << 18)
    back = load_hf_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(back[name], params[name])
    for name, leaf in params["layers"].items():
        assert torch.equal(back["layers"][name], leaf), name


def test_reads_unaligned_tensors(tmp_path):
    """A writer that neither pads its header nor orders tensors by width:
    the reader copies an unaligned tensor out instead of mapping it."""
    import struct

    a8 = torch.arange(3, dtype=torch.int8)
    f32 = torch.tensor([1.5, -2.25, 3.0])
    header = {"a8": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "f32": {"dtype": "F32", "shape": [3], "data_offsets": [3, 15]}}
    raw = json.dumps(header).encode()
    raw += b" " * ((-len(raw) % 8) + 1)  # 8 + len(raw) is odd
    path = tmp_path / "u.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + a8.numpy().tobytes() + f32.numpy().tobytes())
    back = read_safetensors(str(path))
    assert torch.equal(back["a8"], a8) and torch.equal(back["f32"], f32)
