"""The device the port runs on, named by the caller.

Every entry point takes a `device`; None means "cuda".  Nothing here
picks a device for the caller or falls back to the CPU when CUDA is
missing: a CUDA device without a card raises.  A CPU device is for
tests and runs the plain PyTorch version of every kernel.

Importing this module turns TF32 off for float32 matmuls and cuDNN
convolutions.  The SSIM search compares scores right at a threshold, and
TF32 keeps about three decimal digits, so every float32 product runs in
full float32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fennec: no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' explicitly to run the plain versions")


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device for a caller's `device` argument (None → cuda)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"fennec: unsupported device {dev}")
    return dev
