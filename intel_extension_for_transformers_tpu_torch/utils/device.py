"""CUDA device probe.

Replaces the JAX package's `utils/device.py`, which reported the JAX backend
and sized Pallas tiles from a per-TPU VMEM table. The port's kernels are
compiled for `sm_90a` only, so the one question is whether a Hopper card is
present.
"""

from __future__ import annotations

import torch

REQUIRED_CAPABILITY = (9, 0)


def require_cuda() -> torch.device:
    """Return the first CUDA device, or raise unless it is an sm_90 card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(0)} is sm_{cap[0]}{cap[1]}; the kernels "
            f"are built for sm_{REQUIRED_CAPABILITY[0]}{REQUIRED_CAPABILITY[1]}a"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names one.

    `None` means `require_cuda()`, which raises on a host without a Hopper
    card; pass `device="cpu"` to run the plain PyTorch versions there."""
    return require_cuda() if device is None else torch.device(device)
