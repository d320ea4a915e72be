"""Device selection: an explicit device, never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):  # meta: shapes and dtypes only (utils/capacity.py)
        raise ValueError(f"unsupported device {dev}")
    return dev
