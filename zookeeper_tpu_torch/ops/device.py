"""The device an entry point runs on, shared by serving and training."""

from typing import Any

import torch


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card
    raises rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA card is "
            "available; pass device='cpu' to run the plain PyTorch path."
        )
    return device
