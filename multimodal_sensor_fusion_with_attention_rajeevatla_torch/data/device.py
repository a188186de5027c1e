"""Device-resident windows and streamed batches: port of the JAX package's
``data/device.py``.

``DeviceSplit``: the whole windowed split (tens to hundreds of MB for
PAMAP2) is copied to the card once; every batch is then an on-device gather,
so the host sends a ``[B]`` index vector per request and nothing else.

``StreamingDeviceLoader``: for a split that outgrows the card, the batches of
a ``BatchLoader`` are copied one ahead of the consumer instead, from pinned
host memory on a side stream, so the copy of batch ``t + 1`` overlaps the
step on batch ``t`` (``dataset.streaming`` in the trainer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .dataset import WindowedSplit


def _host(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


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
        return cls(
            features={m: _host(windows.features[m], np.float32).to(device)
                      for m in windows.modalities},
            labels=_host(windows.labels, np.int32).to(device),
            lengths=_host(windows.lengths, np.int32).to(device),
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


# the host types of a batch tuple: features, labels, mask, lengths, weight
_BATCH_TYPES = (np.float32, np.int32, np.float32, np.int32, np.float32)


class StreamingDeviceLoader:
    """Batches of ``loader`` (a ``BatchLoader``, or any iterable of its
    ``(features, labels, mask, lengths, weight)`` numpy tuples) as tensors
    on ``device`` (default ``cuda``; raises without it unless
    ``device="cpu"``), features, mask and weight float32, labels and lengths
    int32, one batch ahead of the consumer.

    On the card each host batch is pinned and copied with ``non_blocking`` on
    a side stream, and an event is recorded after the copy; the batch is
    handed over only after the consumer's stream waits on that event, and
    each tensor is marked used on the consumer's stream (``record_stream``),
    so the allocator does not reuse its memory before the consumer is done.
    The copy of batch ``t + 1`` is enqueued before batch ``t`` is yielded,
    so it overlaps the consumer's work on ``t``. On the CPU the batches are
    plain tensors.
    """

    def __init__(self, loader: Iterable, device=None):
        self.loader = loader
        self.device = resolve_device(device)
        self.copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)

    def __len__(self) -> int:
        return len(self.loader)

    def _put(self, batch):
        features, *rest = batch
        host = [{m: _host(v, np.float32) for m, v in features.items()},
                *(_host(x, t) for x, t in zip(rest, _BATCH_TYPES[1:]))]
        if self.copy_stream is None:
            return host, None
        with torch.cuda.stream(self.copy_stream):
            moved = [{m: v.pin_memory().to(self.device, non_blocking=True)
                      for m, v in host[0].items()},
                     *(x.pin_memory().to(self.device, non_blocking=True) for x in host[1:])]
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        return moved, copied

    def _hand_over(self, pending):
        batch, copied = pending
        if copied is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            for t in (*batch[0].values(), *batch[1:]):
                t.record_stream(consumer)
        return tuple(batch)

    def __iter__(self):
        pending = None
        for batch in self.loader:
            ready = pending
            pending = self._put(batch)  # in flight while the consumer works on `ready`
            if ready is not None:
                yield self._hand_over(ready)
        if pending is not None:
            yield self._hand_over(pending)
