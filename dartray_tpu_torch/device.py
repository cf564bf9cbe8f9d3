"""Device policy of the port: the card unless the caller asks for the CPU.

Every entry point (``render``, ``render_wave``, ``make_film``,
``perspective``, ``to_device``) resolves its ``device`` argument here. The
default is ``"cuda"``; a request for a CUDA device on a machine without one
raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
