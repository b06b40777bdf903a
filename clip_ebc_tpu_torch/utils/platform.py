"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.
Without CUDA they raise: there is no quiet fallback to the CPU, so a
run that was meant for the card never measures the host by mistake.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev
