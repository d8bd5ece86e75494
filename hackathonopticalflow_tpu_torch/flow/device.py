"""Where the flow entry points run: the GPU unless the caller asks for the
CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """torch.device(device); raises if that is a CUDA device and CUDA is
    not available, so nothing silently runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
