"""Windowed multimodal datasets (copy of the JAX package's ``data/dataset.py``).

The port may not import the JAX package, whose ``data/__init__.py`` pulls in
JAX, so the numpy pieces the serving path needs are copied here:
``resolve_modality_columns``, ``WindowedSplit``, the manifest-backed
``MultimodalDataset`` (numpy window gather only; the native
``libfastload.so`` gather is not loaded), ``apply_instance_normalization``
and ``padded_index_matrix``. A split is materialised once into dense numpy
arrays, ``features {mod: [N, T, D]}``, ``labels [N]``, ``lengths [N]``, with
windows padded to ``chunk_size``; ``data/device.py`` puts them on the card.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .preprocess import load_shard


# ---------------------------------------------------------------------------
# modality resolution (reference ``src/data.py:180-210``)
# ---------------------------------------------------------------------------

def resolve_modality_columns(
    columns: Sequence[str], modalities: Sequence[str]
) -> Dict[str, List[str]]:
    """Map modality names to shard column subsets (reference rules).

    ``heart_rate``/``heart``/``hr`` -> ``heart_rate_bpm``; otherwise the
    modality name is normalised (``imu_hand`` -> ``hand``, ``hand_imu`` ->
    ``hand``) and matched as a column prefix.
    """
    column_set = set(columns)
    mapping: Dict[str, List[str]] = {}
    for modality in modalities:
        normalized = modality.lower()
        candidate: List[str] = []
        if normalized in {"heart_rate", "heart", "hr"}:
            if "heart_rate_bpm" in column_set:
                candidate = ["heart_rate_bpm"]
        else:
            prefix = normalized
            if prefix.startswith("imu_"):
                prefix = prefix.split("imu_", 1)[1]
            if prefix.endswith("_imu"):
                prefix = prefix.rsplit("_imu", 1)[0]
            prefix = prefix.replace(" ", "")
            candidate = [col for col in columns if col.startswith(f"{prefix}_")]
        if not candidate:
            raise ValueError(
                f"Could not resolve modality '{modality}'. "
                f"Available columns: {list(columns)}"
            )
        mapping[modality] = candidate
    return mapping


# ---------------------------------------------------------------------------
# windowed split container
# ---------------------------------------------------------------------------

@dataclass
class WindowedSplit:
    """A fully-materialised split: dense arrays ready for device residency."""

    features: Dict[str, np.ndarray]  # {mod: [N, T, D_mod]} float32
    labels: np.ndarray  # [N] int32
    lengths: np.ndarray  # [N] int32 (valid timesteps per window)
    modalities: List[str] = field(default_factory=list)
    # per-window provenance: which manifest shard each window was cut from
    # (shards are per (subject, activity) segments, so shard ids are the
    # grouping unit for subject-aware calibration folds); None for splits
    # with no shard structure (synthetic / legacy .npy)
    shard_ids: Optional[np.ndarray] = None  # [N] int32 or None

    def __post_init__(self):
        if not self.modalities:
            self.modalities = list(self.features.keys())

    @property
    def num_windows(self) -> int:
        return int(self.labels.shape[0])

    @property
    def window_size(self) -> int:
        first = self.features[self.modalities[0]]
        return int(first.shape[1]) if first.ndim == 3 else 1

    def __len__(self) -> int:
        return self.num_windows


def _scrub(x: np.ndarray) -> np.ndarray:
    """NaN/Inf -> 0, the reference's load-time sanitisation (``src/data.py:299-303``)."""
    return np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0, copy=False)


# ---------------------------------------------------------------------------
# manifest-backed dataset
# ---------------------------------------------------------------------------

class MultimodalDataset:
    """Manifest- or ``.npy``-backed multimodal dataset, windowed eagerly.

    Construction mirrors the reference (``src/data.py:29-178``): if
    ``<data_dir>/splits/<split>.txt`` exists, shards are loaded through it
    (chunked into ``chunk_size`` windows with a disk chunk cache); otherwise
    the legacy ``<data_dir>/<split>/<modality>.npy`` layout is read.

    The result is exposed as :class:`WindowedSplit` dense arrays; sample
    access (``__getitem__``/``__len__``) is kept for API familiarity and
    tests, yielding ``(features, label, mask)`` numpy tuples.
    """

    def __init__(
        self,
        data_dir: str | Path,
        modalities: Sequence[str],
        split: str = "train",
        transform=None,
        modality_dropout: float = 0.0,
        chunk_size: Optional[int] = None,
        chunk_cache_dir: Optional[str | Path] = None,
        window_stride: Optional[int] = None,
        pad_to_chunk: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.data_dir = Path(data_dir)
        self.modalities = list(modalities)
        self.split = split
        self.transform = transform
        self.modality_dropout = modality_dropout if split == "train" else 0.0
        self.chunk_size = chunk_size
        # sliding-window segmentation: stride < chunk_size yields overlapping
        # windows (a data-multiplier the reference's disjoint chunking lacks)
        self.window_stride = window_stride or chunk_size
        self.chunk_cache_dir = Path(chunk_cache_dir) if chunk_cache_dir else None
        self.pad_to_chunk = pad_to_chunk
        self._rng = rng or np.random.default_rng(0)

        self.use_manifest = False
        manifest_path = self.data_dir / "splits" / f"{split}.txt"
        if manifest_path.exists():
            self.use_manifest = True
            self.windows = self._load_from_manifest(manifest_path)
        else:
            self.windows = self._load_numpy_split()

    # -- manifest mode ----------------------------------------------------
    def _resolve_shard_path(self, rel: str, manifest_path: Path) -> Path:
        candidate = Path(rel)
        if candidate.is_absolute():
            return candidate
        roots = [self.data_dir]
        if candidate.parts and candidate.parts[0] == "data":
            # reference manifests are repo-root-relative
            roots = [self.data_dir.parent, self.data_dir]
        if len(manifest_path.parents) >= 3:
            roots.append(manifest_path.parents[2])
        for root in roots:
            resolved = (root / candidate).resolve()
            if resolved.exists() or resolved.with_suffix(
                resolved.suffix + ".npz"
            ).exists():
                return resolved
            # .pt manifest entries may have been converted to .npz
            as_npz = resolved.with_suffix(".npz")
            if as_npz.exists():
                return as_npz
        return (roots[0] / candidate).resolve()

    def _parse_manifest(self, manifest_path: Path) -> List[Tuple[Path, int]]:
        entries: List[Tuple[Path, int]] = []
        for line in manifest_path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            if "," not in line:
                raise ValueError(
                    f"Malformed manifest entry '{line}' in {manifest_path}"
                )
            rel, rows_str = line.split(",", 1)
            rows = int(rows_str)
            if rows <= 0:
                continue
            shard_path = self._resolve_shard_path(rel, manifest_path)
            if not shard_path.exists() and not shard_path.with_suffix(
                shard_path.suffix + ".npz"
            ).exists():
                raise FileNotFoundError(
                    f"Shard referenced in manifest not found: {shard_path}"
                )
            entries.append((shard_path, rows))
        if not entries:
            raise ValueError(f"No shards found in manifest {manifest_path}")
        return entries

    def _chunk_cache_path(self, shard_rows: List[int]) -> Optional[Path]:
        if self.chunk_cache_dir is None:
            return None
        self.chunk_cache_dir.mkdir(parents=True, exist_ok=True)
        key = (
            f"{self.split}_chunks_{self.chunk_size or 'full'}"
            f"_s{self.window_stride or 'full'}_{len(shard_rows)}"
        )
        # the fingerprint must cover per-shard ROW COUNTS, not just the shard
        # count: after re-preprocessing, a stale cached chunk with
        # end > current rows would feed out-of-bounds offsets straight into
        # the native window_gather
        digest = hashlib.md5(
            (str(self.data_dir) + ":" + ",".join(map(str, shard_rows))).encode()
        ).hexdigest()[:8]
        return self.chunk_cache_dir / f"{key}_{digest}.json"

    def _build_chunks(self, shard_rows: List[int]) -> List[Tuple[int, int, int]]:
        chunks: List[Tuple[int, int, int]] = []
        for shard_idx, rows in enumerate(shard_rows):
            if self.chunk_size is None:
                chunks.append((shard_idx, 0, rows))
                continue
            stride = max(1, int(self.window_stride or self.chunk_size))
            start = 0
            while start < rows:
                end = min(start + self.chunk_size, rows)
                chunks.append((shard_idx, start, end))
                if end >= rows:
                    break
                start += stride
        return chunks

    def _load_or_build_chunks(self, shard_rows: List[int]) -> List[Tuple[int, int, int]]:
        cache_path = self._chunk_cache_path(shard_rows)
        if cache_path and cache_path.exists():
            try:
                cached = json.loads(cache_path.read_text())
                chunks = [(int(a), int(b), int(c)) for a, b, c in cached]
                # belt-and-braces: reject any cached window that exceeds the
                # CURRENT shard bounds (the row-count fingerprint in the
                # cache key should already have rotated the file)
                if all(
                    0 <= s < len(shard_rows) and 0 <= b < e <= shard_rows[s]
                    for s, b, e in chunks
                ):
                    return chunks
            except Exception:
                pass
        chunks = self._build_chunks(shard_rows)
        if cache_path is not None:
            cache_path.write_text(json.dumps(chunks))
        return chunks

    def _load_from_manifest(self, manifest_path: Path) -> WindowedSplit:
        entries = self._parse_manifest(manifest_path)
        first_payload = load_shard(entries[0][0])
        columns = first_payload["columns"]
        col_index = {name: i for i, name in enumerate(columns)}
        if "activity_id" not in col_index:
            raise ValueError("activity_id column missing from tensor shards.")
        activity_col = col_index["activity_id"]
        modality_cols = resolve_modality_columns(columns, self.modalities)
        modality_idx = {
            m: np.array([col_index[c] for c in cols], dtype=np.int64)
            for m, cols in modality_cols.items()
        }

        shard_datas: List[np.ndarray] = []
        shard_rows: List[int] = []
        for i, (path, rows) in enumerate(entries):
            payload = first_payload if i == 0 else load_shard(path)
            shard_datas.append(payload["data"])
            shard_rows.append(int(payload["data"].shape[0]))

        chunks = self._load_or_build_chunks(shard_rows)
        window = self.chunk_size or max(end - start for _, start, end in chunks)
        num = len(chunks)

        features = {
            m: np.zeros((num, window, len(idx)), dtype=np.float32)
            for m, idx in modality_idx.items()
        }
        labels = np.zeros(num, dtype=np.int32)
        lengths = np.zeros(num, dtype=np.int32)

        for w, (shard_idx, start, end) in enumerate(chunks):
            label_values = shard_datas[shard_idx][start:end, activity_col]
            if not np.all(label_values == label_values[0]):
                raise ValueError("Activity id varies within shard chunk.")
            labels[w] = int(label_values[0])
            lengths[w] = end - start
            for m, idx in modality_idx.items():
                features[m][w, : end - start] = _scrub(
                    shard_datas[shard_idx][start:end][:, idx]
                )

        shard_ids = np.asarray([c[0] for c in chunks], dtype=np.int32)
        return WindowedSplit(features=features, labels=labels, lengths=lengths,
                             modalities=list(self.modalities),
                             shard_ids=shard_ids)

    # -- legacy npy mode --------------------------------------------------
    def _load_numpy_split(self) -> WindowedSplit:
        split_dir = self.data_dir / self.split
        data: Dict[str, np.ndarray] = {}
        for modality in self.modalities:
            modality_file = split_dir / f"{modality}.npy"
            if not modality_file.exists():
                raise FileNotFoundError(f"Modality file not found: {modality_file}")
            data[modality] = _scrub(np.load(modality_file).astype(np.float32))
        labels_file = split_dir / "labels.npy"
        if not labels_file.exists():
            raise FileNotFoundError(f"Labels file not found: {labels_file}")
        labels = np.load(labels_file).astype(np.int32)
        first = next(iter(data.values()))
        seq_len = first.shape[1] if first.ndim == 3 else 1
        lengths = np.full(labels.shape[0], seq_len, dtype=np.int32)
        return WindowedSplit(features=data, labels=labels, lengths=lengths,
                             modalities=list(self.modalities))

    # -- sample access (API familiarity + tests) --------------------------
    def __len__(self) -> int:
        return self.windows.num_windows

    def __getitem__(self, idx: int):
        features = {
            m: self.windows.features[m][idx] for m in self.modalities
        }
        label = self.windows.labels[idx]
        if self.transform is not None:
            features = self.transform(features)
        mask = np.ones(len(self.modalities), dtype=np.float32)
        if self.modality_dropout > 0:
            keep = (self._rng.random(len(self.modalities)) > self.modality_dropout)
            mask = mask * keep.astype(np.float32)
            if mask.sum() == 0:  # never drop every modality
                mask[self._rng.integers(0, len(self.modalities))] = 1.0
        return features, label, mask




def apply_instance_normalization(windows: WindowedSplit) -> WindowedSplit:
    """Per-window per-channel z-scoring (no cross-split statistics).

    Each window is standardised by its own valid-timestep mean/std — the
    classic cross-subject robustness trick for wearable-sensor HAR (sensor
    offsets and subject-specific baselines cancel out). Needs no train-split
    statistics, so serving-time inputs normalise independently.
    """
    seq_len = windows.window_size
    valid = (
        np.arange(seq_len)[None, :] < windows.lengths[:, None]
    )[..., None].astype(np.float32)
    denom = np.clip(windows.lengths[:, None, None].astype(np.float32), 1.0, None)
    for m in windows.modalities:
        x = windows.features[m] * valid
        mean = x.sum(axis=1, keepdims=True) / denom
        var = (((windows.features[m] - mean) * valid) ** 2).sum(axis=1, keepdims=True) / denom
        std = np.sqrt(var)
        std = np.where(std < 1e-6, 1.0, std)
        windows.features[m] = ((windows.features[m] - mean) / std) * valid
    return windows



def padded_index_matrix(
    n: int, batch_size: int, shuffle: bool = False, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """``[S, B]`` gather-index matrix + validity weights for fixed-batch scans.

    The single source of the pad-and-reshape contract used by the training
    epoch, the jitted evaluators, and the MC-dropout sweep (it used to live
    in three copies). Tail slots of the final partial batch WRAP AROUND the
    epoch order instead of all duplicating window 0: their loss weight is 0
    either way, but batch-statistics consumers (BatchNorm running stats on
    the CNN path) see representative rows rather than ``pad`` copies of one
    window every epoch. Consumers that only want indices slice ``[:n]`` after
    flattening their outputs.
    """
    order = (
        np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    )
    steps = (n + batch_size - 1) // batch_size
    idx = np.resize(order, steps * batch_size)  # cyclic wrap-around pad
    weight = np.concatenate(
        [np.ones(n, np.float32), np.zeros(steps * batch_size - n, np.float32)]
    )
    return (
        idx.reshape(steps, batch_size).astype(np.int32),
        weight.reshape(steps, batch_size),
    )
