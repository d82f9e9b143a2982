"""Device selection shared by the port's entry points.

Every entry point runs on the card unless the caller passes ``device="cpu"``
(as the CPU tests do).  Asking for CUDA where there is none is an error, never
a quiet switch to the CPU: a number measured on the host must not pass for a
device number.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
