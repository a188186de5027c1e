"""PyTorch port, ``utils/profiling.py`` on the CPU: ``Timer``'s laps,
``throughput``'s keys (the reference's), ``fence`` on tensors and trees, and a
``trace`` that writes a Chrome trace file."""

import json
import time
from pathlib import Path

import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils import profiling


def test_timer_keeps_laps():
    timer = profiling.Timer()
    assert timer.best != timer.best  # nan before any lap
    for pause in (0.002, 0.001, 0.003):
        with timer.lap():
            time.sleep(pause)
    assert len(timer.laps) == 3
    assert 0.001 <= timer.best <= timer.median <= max(timer.laps)


@pytest.mark.parametrize("value,want", [
    (torch.ones(3), 3.0), ({"a": torch.full((2,), 2.0), "b": torch.ones(1)}, 4.0),
    ([torch.zeros(2), torch.ones(2)], 0.0), ((torch.tensor(1.5),), 1.5), (2.5, 2.5),
])
def test_fence_reads_the_first_tensor(value, want):
    assert profiling.fence(value) == want


def test_throughput_has_the_reference_keys():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    out = profiling.throughput(fn, torch.ones(4), items_per_call=8, iters=3, warmup=2)
    assert sorted(out) == ["best_ms", "items_per_sec", "median_ms"]
    assert len(calls) == 5
    assert out["items_per_sec"] == pytest.approx(8 / (out["best_ms"] / 1000))
    assert 0 < out["best_ms"] <= out["median_ms"]


def test_trace_writes_a_chrome_trace(tmp_path: Path):
    with profiling.trace(tmp_path / "logs") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1 and prof is not None
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
