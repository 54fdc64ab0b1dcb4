"""Device resolution for the port's entry points.

Entry points place their work on ``cuda`` unless the caller asks for
another device; asking for the card where there is none raises, and
nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run the plain versions on the CPU")
    return dev
