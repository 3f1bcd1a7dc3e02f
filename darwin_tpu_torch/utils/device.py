"""Device resolution: every entry point names its device explicitly.

There is no silent CPU fallback: asking for ``cuda`` on a host without a
usable CUDA device raises.  ``cpu`` runs every kernel's plain PyTorch twin
and exists for tests.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``'cuda'``, ``'cuda:N'``, ``'cpu'`` or a ``torch.device`` -> a
    ``torch.device``.  Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false (use device='cpu' only for tests)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
