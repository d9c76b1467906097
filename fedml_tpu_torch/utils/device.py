"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA on a machine without a card raises; nothing
    moves to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


def to_device(tree: dict, device) -> dict:
    """numpy arrays (or tensors) of a flat dict -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in tree.items()}
