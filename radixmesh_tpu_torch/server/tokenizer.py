"""Pluggable tokenizer seam for the serving frontend (the JAX package's
``server/tokenizer.py``, copied: the port imports nothing of that package).

Two implementations behind one duck-typed interface (``encode(str) ->
list[int]``, ``decode(list[int]) -> str``, ``eos_id``):

- :class:`ByteTokenizer` — dependency-free byte-level tokenizer: UTF-8
  bytes offset past a small special-token block. Any text round-trips
  exactly; vocab 259 fits every model. It needs no package, so it serves
  where ``transformers`` is not installed.
- :class:`HFTokenizer` — wraps a local ``transformers`` tokenizer directory
  (Llama-3 and Qwen2 ship one next to their safetensors shards). Loading is
  strictly offline; ``transformers`` is imported when one is built, and its
  absence raises there, naming the package.

``load_tokenizer("byte")`` or ``load_tokenizer("/path/to/ckpt")``.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence, runtime_checkable

__all__ = ["ByteTokenizer", "HFTokenizer", "Tokenizer", "load_tokenizer"]


@runtime_checkable
class Tokenizer(Protocol):
    # None = the vocabulary declares no EOS; callers must not install a
    # default stop token in that case.
    eos_id: int | None

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """Byte-level tokenizer: token = UTF-8 byte + 3 (ids 0/1/2 reserved
    for pad/bos/eos). Lossless on arbitrary text, no vocabulary file."""

    PAD, BOS, EOS = 0, 1, 2
    _OFFSET = 3

    vocab_size = 256 + _OFFSET
    eos_id = EOS

    def encode(self, text: str) -> list[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(
            i - self._OFFSET
            for i in ids
            if i >= self._OFFSET and i < self.vocab_size
        ).decode("utf-8", errors="replace")


class HFTokenizer:
    """A local HuggingFace tokenizer directory (offline only)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                f"tokenizer directory {path!r} needs the `transformers` package, which is "
                "not installed; use --tokenizer byte"
            ) from e

        self._tok = AutoTokenizer.from_pretrained(
            path, local_files_only=True
        )
        # id 0 is a legitimate EOS for some vocabularies — only a missing
        # eos maps to None (`or`-coercion would silently stop generation
        # at a real token).
        eos = self._tok.eos_token_id
        self.eos_id = None if eos is None else int(eos)
        # len(tokenizer) includes added special tokens; `.vocab_size`
        # does not (Llama-3 reports 128000 vs the 128256 ids it can
        # emit), and callers size embedding checks off this field.
        self.vocab_size = int(len(self._tok))

    def encode(self, text: str) -> list[int]:
        return list(self._tok.encode(text, add_special_tokens=False))

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(spec: str) -> Tokenizer:
    """``"byte"`` → :class:`ByteTokenizer`; a directory path → the HF
    tokenizer stored there."""
    if spec == "byte":
        return ByteTokenizer()
    if os.path.isdir(spec):
        return HFTokenizer(spec)
    raise ValueError(
        f"unknown tokenizer {spec!r}: expected 'byte' or a local "
        f"tokenizer directory"
    )
