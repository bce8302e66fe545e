"""Where the port runs: the CUDA card unless the caller names a device."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as given, else the first CUDA card.

    Raises when no card is present and none was named: the port never
    falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
