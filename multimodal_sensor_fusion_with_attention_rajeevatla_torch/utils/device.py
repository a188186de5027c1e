"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def pin_float32() -> None:
    """Keep float32 products and convolutions in full float32 on the card (no
    TF32: the port is held to the reference in f32), sum bf16 products in
    f32 (cuBLAS may otherwise reduce partial bf16 sums in bf16; the
    reference rounds a bf16 product once, at its end), and let cuDNN pick
    only deterministic convolution algorithms (no atomics), so a seed
    repeats a run bit for bit. These are process-wide switches of PyTorch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: return ``cuda``, or raise when there is none.

    The port never falls back to the CPU on its own; a caller that wants the
    CPU (the tests) asks for it with ``device="cpu"``. Every entry point
    resolves its device here, so resolving the card also ``pin_float32``\\ s.
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's plain "
                "PyTorch path on the CPU"
            )
        pin_float32()
    return resolved
