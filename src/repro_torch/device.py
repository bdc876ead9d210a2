"""Device selection for the port's entry points: the card is the default."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the first CUDA card; a CUDA device on a machine without
    CUDA raises instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available here; pass device='cpu' to use the plain PyTorch "
            "versions of the kernels")
    return dev
