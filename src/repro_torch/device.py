"""Device selection shared by the port's entry points.

An entry point runs on the CUDA card unless its caller names another
device. It never falls back to the CPU on its own: with no device given and
no card present it raises, so a run that meant to use the card cannot
silently measure the CPU instead.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the CUDA card.

    A CUDA device always carries its index, so it compares equal to the
    ``.device`` of tensors placed on it. Raises ``RuntimeError`` when
    ``device`` is ``None`` and CUDA is absent.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
