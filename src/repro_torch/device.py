"""Device choice for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the CPU
(``device="cpu"``, ``--device cpu``). With no card and no explicit request
it raises: the port never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device, else ``torch.device(device)``.

    Raises RuntimeError when CUDA is asked for, explicitly or by default,
    and no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available")
    return dev
