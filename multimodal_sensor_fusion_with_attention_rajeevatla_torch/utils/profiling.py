"""Profiling helpers, port of the JAX package's ``utils/profiling.py``.

- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU
  activities, and CUDA ones where the card is there) that writes one Chrome
  trace (``trace_<time>.json``) into ``logdir``.
- ``fence(value)``: wait for the device that holds ``value`` and read one
  number of it to the host, so that a timed interval ends when the work does.
- ``Timer`` and ``throughput``: fenced wall-clock laps, and the items per
  second of a function with the reference's keys (``items_per_sec``,
  ``best_ms``, ``median_ms``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block; its Chrome trace lands in ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json"))


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for item in value:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def fence(value) -> float:
    """Finish the computation of ``value`` (its first tensor) -> a host float."""
    tensor = _first_tensor(value)
    if tensor is None:
        return float(value)
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    return float(tensor.detach().float().sum().item())


class Timer:
    """Wall-clock laps (``with timer.lap(): ...``); fence inside the lap."""

    def __init__(self):
        self.laps: list = []

    @contextlib.contextmanager
    def lap(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.laps.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.laps) if self.laps else float("nan")

    @property
    def median(self) -> float:
        return float(np.median(self.laps)) if self.laps else float("nan")


def throughput(fn: Callable, *args, items_per_call: int = 1, iters: int = 10,
               warmup: int = 2) -> dict:
    """Fenced items a second of ``fn(*args)``: ``items_per_sec`` at the best
    lap, ``best_ms`` and ``median_ms``."""
    for _ in range(warmup):
        fence(fn(*args))
    timer = Timer()
    for _ in range(iters):
        with timer.lap():
            fence(fn(*args))
    return {
        "items_per_sec": items_per_call / timer.best,
        "best_ms": timer.best * 1000,
        "median_ms": timer.median * 1000,
    }
