"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: return ``cuda``, or raise when there is none.

    The port never falls back to the CPU on its own; a caller that wants the
    CPU (the tests) asks for it with ``device="cpu"``.
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "PyTorch path on the CPU"
        )
    return resolved
