"""Device selection and the hardware stamp of result records."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device: ``"cuda"`` unless the caller asks for
    the CPU.  A request for CUDA without a card raises; it never turns
    into a CPU run."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return d


def hardware_tag() -> str:
    """Self-describing hardware stamp, e.g. ``nvidia-h100-80gb-hbm3-1``
    (CUDA device name and count) or ``cpu``."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).strip().lower().replace(" ", "-")
    return f"{name}-{torch.cuda.device_count()}"
