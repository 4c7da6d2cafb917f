"""Device selection for the port's entry points, and host batches onto it."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device for `name`. Asking for CUDA where there is none raises:
    entry points never drop to the CPU unless the caller asks for it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(pass --device cpu to run on the CPU)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def to_device(images: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, C) numpy images -> (B, C, H, W) float32 on `device`."""
    return torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2).to(device)
