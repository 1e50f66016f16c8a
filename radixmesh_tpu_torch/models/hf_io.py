"""HuggingFace checkpoint IO (the JAX package's ``models/hf_io.py``): read
and write the directories Llama and Qwen2 checkpoints ship as — one
``model.safetensors``, or shards named by ``model.safetensors.index.json``'s
``weight_map`` — and load one into the port's params
(``models/convert.convert_hf_state_dict``).

The safetensors format is read and written here, without the
``safetensors`` package, so loading needs nothing beyond torch: a file is
an 8-byte little-endian header length ``N``, ``N`` bytes of JSON header
(per tensor ``dtype``, ``shape`` and ``data_offsets`` ``[begin, end)`` into
the data that follows; an optional ``__metadata__`` map of strings), then
the tensors' raw little-endian bytes. Reads map the file (``mmap``, copy-on-write) and wrap
each tensor with ``torch.frombuffer``, so nothing is read until a tensor is
used; the tensors keep their mapping alive. The writer pads the header with
spaces to a multiple of 8 bytes and orders tensors by alignment, as the
reference writer does, so every tensor starts aligned to its element size.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import TYPE_CHECKING

import torch

from radixmesh_tpu_torch.models.convert import convert_hf_state_dict

if TYPE_CHECKING:  # pragma: no cover
    from radixmesh_tpu_torch.models.llama import ModelConfig

__all__ = ["load_hf_checkpoint", "load_hf_state_dict", "save_hf_state_dict", "read_safetensors",
           "write_safetensors"]

_INDEX = "model.safetensors.index.json"
_SINGLE = "model.safetensors"
# safetensors dtype names the port reads and writes.
_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write mapping of the file. Refuses a dtype outside F32, F16,
    BF16, I8, I32 and I64 by name."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the end of the file")
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which is not "
                             f"supported (supported: {', '.join(_DTYPES)})")
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(x) for x in info["data_offsets"])
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} do not fit its "
                             f"{info['dtype']} shape {list(shape)}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # unaligned: copy the bytes out
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=base + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count, offset=base + begin).reshape(shape)
    return out


def write_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` to one ``.safetensors`` file (any device; each is
    brought to the host in turn), with the ``{"format": "pt"}`` metadata
    that ``transformers`` asks of a checkpoint."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which safetensors IO here does "
                             f"not support (supported: {', '.join(map(str, _NAMES))})")
    # Widest elements first, then by name: every offset stays aligned.
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def load_hf_state_dict(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """Read every tensor from an HF-format checkpoint directory.

    Handles both layouts HF emits: one ``model.safetensors`` file, or N
    shards named by ``model.safetensors.index.json``'s ``weight_map`` (an
    index naming tensors its shards lack raises), and falls back to any
    stray ``*.safetensors`` files. Returns CPU tensors (mapped, not read)
    keyed by HF names (``model.layers.3.self_attn.q_proj.weight`` …)."""
    index_path = os.path.join(ckpt_dir, _INDEX)
    single_path = os.path.join(ckpt_dir, _SINGLE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        state: dict[str, torch.Tensor] = {}
        for shard in sorted(set(index["weight_map"].values())):
            state.update(read_safetensors(os.path.join(ckpt_dir, shard)))
        missing = set(index["weight_map"]) - set(state)
        if missing:
            raise ValueError(
                f"checkpoint index names {len(missing)} tensors its shards "
                f"don't contain (e.g. {sorted(missing)[:3]})"
            )
        return state
    if os.path.exists(single_path):
        return read_safetensors(single_path)
    # Some exports skip the index when there is exactly one shard with a
    # non-standard name.
    parts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
    if not parts:
        raise FileNotFoundError(f"no {_SINGLE}, {_INDEX}, or *.safetensors in {ckpt_dir}")
    state = {}
    for part in parts:
        state.update(read_safetensors(os.path.join(ckpt_dir, part)))
    return state


def load_hf_checkpoint(ckpt_dir: str, cfg: "ModelConfig", device=None) -> dict:
    """HF checkpoint directory → the port's param dict in ``cfg.dtype`` on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    return convert_hf_state_dict(cfg, load_hf_state_dict(ckpt_dir), device)


def save_hf_state_dict(state: dict[str, torch.Tensor], ckpt_dir: str,
                       max_shard_bytes: int = 4 << 30) -> None:
    """Write an HF-layout safetensors checkpoint: one ``model.safetensors``,
    or (past ``max_shard_bytes``) shards ``model-0000i-of-0000n.safetensors``
    and ``model.safetensors.index.json``. Shards fill greedily in
    insertion order, as the JAX package's writer does; a tensor larger than
    the limit gets a shard of its own. Tensors may lie on any device."""
    os.makedirs(ckpt_dir, exist_ok=True)
    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] and sizes[-1] + nbytes > max_shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    if len(shards) == 1:
        write_safetensors(shards[0], os.path.join(ckpt_dir, _SINGLE))
        return
    n = len(shards)
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(shard, os.path.join(ckpt_dir, fname))
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(ckpt_dir, _INDEX), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}, f)
