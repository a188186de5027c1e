"""Device-resident windows: port of the JAX package's ``data/device.py``.

The whole windowed split (tens to hundreds of MB for PAMAP2) is copied to
the card once; every batch is then an on-device gather, so the host sends a
``[B]`` index vector per request and nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .dataset import WindowedSplit


@dataclass(frozen=True)
class DeviceSplit:
    """A :class:`WindowedSplit` resident on one device."""

    features: Dict[str, torch.Tensor]  # {mod: [N, T, D]} float32
    labels: torch.Tensor  # [N] int32
    lengths: torch.Tensor  # [N] int32
    modalities: tuple

    @classmethod
    def from_windows(cls, windows: WindowedSplit, device=None) -> "DeviceSplit":
        """Copy a windowed split to ``device`` (default ``cuda``; raises
        without it unless ``device="cpu"``)."""
        device = resolve_device(device)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

        return cls(
            features={m: put(windows.features[m], np.float32) for m in windows.modalities},
            labels=put(windows.labels, np.int32),
            lengths=put(windows.lengths, np.int32),
            modalities=tuple(windows.modalities),
        )

    @property
    def num_windows(self) -> int:
        return int(self.labels.shape[0])

    def gather(
        self, idx: torch.Tensor
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """On-device batch gather -> ``(features, labels, lengths)``."""
        idx = idx.to(self.labels.device, non_blocking=True)
        features = {m: self.features[m].index_select(0, idx) for m in self.modalities}
        return features, self.labels.index_select(0, idx), self.lengths.index_select(0, idx)
