"""Shard loading (copy of the JAX package's ``data/preprocess.py::load_shard``).

The raw ``.dat`` ETL and its native parser are not needed to serve from the
committed shards and are not copied (ROADMAP queue A12).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def load_shard(path: Path) -> Dict[str, np.ndarray]:
    """Load a shard payload from ``.npz`` (native) or ``.pt`` (reference)."""
    path = Path(path)
    if path.suffix == ".npz" or path.with_suffix(path.suffix + ".npz").exists():
        npz_path = path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")
        with np.load(npz_path, allow_pickle=False) as payload:
            return {
                "columns": [str(c) for c in payload["columns"]],
                "data": np.asarray(payload["data"], dtype=np.float32),
            }
    if path.suffix == ".pt":
        import torch

        payload = torch.load(path, weights_only=False, map_location="cpu")
        return {
            "columns": [str(c) for c in payload["columns"]],
            "data": payload["data"].numpy().astype(np.float32),
        }
    raise FileNotFoundError(f"Unsupported or missing shard: {path}")
