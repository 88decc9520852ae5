"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA. Asking for CUDA where
    there is none raises: entry points never move to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
