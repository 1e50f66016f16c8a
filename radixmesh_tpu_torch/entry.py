"""The port's driver entry point, the counterpart of ``entry()`` in the
repository's ``__graft_entry__.py``:

    from radixmesh_tpu_torch.entry import entry
    fn, args = entry()
    logits = fn(*args)   # [2, 16, vocab] float32, on the card

``fn`` is the radix-cache serving hot path: prefill of new tokens attending
to a right-aligned cached prefix (``Llama.prefill_forward``), on
``ModelConfig.tiny()`` shapes.
"""

from __future__ import annotations

import torch

from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, init_params
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["entry"]


def entry(device=None, params: dict | None = None):
    """Returns ``(fn, example_args)``; ``fn(*example_args)`` gives the
    logits of a 2-row, 16-token prefill over cached prefixes of 32 and 16
    tokens (right-aligned in a 32-token region). ``device`` defaults to
    CUDA and raises where torch has none; ``params`` (a param tree, e.g.
    from ``params_from_jax``, whose dtype the model takes) defaults to
    ``init_params(seed=0)`` in the tiny config's dtype."""
    device = resolve_device(device)
    cfg = ModelConfig.tiny()
    if params is None:
        params = init_params(cfg, seed=0, device=device)
    cfg = cfg.replace(dtype=params["embed"].dtype)
    model = Llama(cfg, params).to(device)

    b, s_new, p_max = 2, 16, 32
    tokens = torch.zeros((b, s_new), dtype=torch.int64, device=device)
    prefix_lengths = torch.tensor([p_max, p_max // 2], dtype=torch.int64, device=device)
    positions = prefix_lengths[:, None] + torch.arange(s_new, device=device)[None]
    kv_shape = (cfg.n_layers, b, p_max, cfg.n_kv_heads, cfg.head_dim)
    cached_k = torch.zeros(kv_shape, dtype=cfg.dtype, device=device)
    cached_v = torch.zeros(kv_shape, dtype=cfg.dtype, device=device)

    def fn(model, tokens, positions, cached_k, cached_v, prefix_lengths):
        with torch.inference_mode():
            logits, _, _ = model.prefill_forward(tokens, positions, cached_k, cached_v, prefix_lengths)
        return logits

    return fn, (model, tokens, positions, cached_k, cached_v, prefix_lengths)
