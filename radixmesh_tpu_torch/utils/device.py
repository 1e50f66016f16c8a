"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``None`` means ``cuda``. Asking for CUDA where torch has none raises — the
port never falls back to the CPU silently (a CPU run would report the CPU's
speed under the card's name).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` on request. Raises if CUDA is asked
    for and ``torch.cuda.is_available()`` is False, or for any other
    device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False "
                f"(torch {torch.__version__}); pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
