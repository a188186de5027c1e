"""Windowed multimodal datasets (copy of the JAX package's ``data/dataset.py``).

The port may not import the JAX package, whose ``data/__init__.py`` pulls in
JAX, so its numpy pieces are copied here: ``resolve_modality_columns``,
``WindowedSplit``, the manifest-backed ``MultimodalDataset`` (numpy window
gather only; the native ``libfastload.so`` gather is not loaded),
``SyntheticMultimodalDataset``, ``BatchLoader``, the normalisations,
``create_datasets`` / ``create_dataloaders``, ``simulate_missing_modalities``
and ``padded_index_matrix``. The same seeds give the same arrays as the
reference. A split is materialised once into dense numpy
arrays, ``features {mod: [N, T, D]}``, ``labels [N]``, ``lengths [N]``, with
windows padded to ``chunk_size``; ``data/device.py`` puts them on the card.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

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



# ---------------------------------------------------------------------------
# synthetic dataset (reference ``src/data.py:346-412``)
# ---------------------------------------------------------------------------

class SyntheticMultimodalDataset:
    """Random multimodal data with split-dependent seeds (seed, seed+1, seed+2)."""

    def __init__(
        self,
        num_samples: int = 10000,
        num_classes: int = 5,
        modality_dims: Optional[Dict[str, int]] = None,
        sequence_length: int = 100,
        split: str = "train",
        seed: int = 42,
    ):
        if modality_dims is None:
            modality_dims = {"sensor1": 32, "sensor2": 32, "sensor3": 32}
        self.num_samples = num_samples
        self.num_classes = num_classes
        self.modality_dims = dict(modality_dims)
        self.modalities = list(self.modality_dims.keys())
        self.sequence_length = sequence_length
        split_seeds = {"train": seed, "val": seed + 1, "test": seed + 2}
        rng = np.random.default_rng(split_seeds.get(split, seed))
        features = {
            m: rng.standard_normal(
                (num_samples, sequence_length, dim), dtype=np.float32
            )
            for m, dim in self.modality_dims.items()
        }
        labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
        lengths = np.full(num_samples, sequence_length, dtype=np.int32)
        self.windows = WindowedSplit(
            features=features, labels=labels, lengths=lengths,
            modalities=list(self.modalities),
        )

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        features = {m: self.windows.features[m][idx] for m in self.modalities}
        label = self.windows.labels[idx]
        mask = np.ones(len(self.modalities), dtype=np.float32)
        return features, label, mask


# ---------------------------------------------------------------------------
# collate + loaders
# ---------------------------------------------------------------------------

def collate_multimodal(batch: List) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Stack a list of ``(features, label, mask)`` samples into dense arrays."""
    features_list, labels_list, masks_list = zip(*batch)
    modality_names = features_list[0].keys()
    batch_features = {
        m: np.stack([f[m] for f in features_list]) for m in modality_names
    }
    return (
        batch_features,
        np.stack([np.asarray(l) for l in labels_list]),
        np.stack([np.asarray(m) for m in masks_list]),
    )


class BatchLoader:
    """Minimal batched iterator over a :class:`WindowedSplit`.

    Yields ``(features, labels, mask, lengths, sample_weight)`` numpy batches
    with a STATIC batch size: the final partial batch is padded (pad rows get
    ``sample_weight 0``), so every step has the same shapes.
    """

    def __init__(
        self,
        windows: WindowedSplit,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        modality_dropout: float = 0.0,
        drop_last: bool = False,
    ):
        self.windows = windows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.modality_dropout = modality_dropout
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = self.windows.num_windows
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_indices(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(indices [B], weight [B])`` per step, padded to batch_size."""
        n = self.windows.num_windows
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
        steps = len(self)
        for s in range(steps):
            idx = order[s * self.batch_size : (s + 1) * self.batch_size]
            weight = np.ones(idx.shape[0], dtype=np.float32)
            if idx.shape[0] < self.batch_size:
                pad = self.batch_size - idx.shape[0]
                idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                weight = np.concatenate([weight, np.zeros(pad, dtype=np.float32)])
            yield idx.astype(np.int32), weight

    def __iter__(self):
        w = self.windows
        num_mod = len(w.modalities)
        rng = np.random.default_rng(self.seed * 1000003 + self._epoch)
        for idx, weight in self.batch_indices():
            features = {m: w.features[m][idx] for m in w.modalities}
            labels = w.labels[idx]
            lengths = w.lengths[idx]
            mask = np.ones((idx.shape[0], num_mod), dtype=np.float32)
            if self.modality_dropout > 0:
                keep = rng.random(mask.shape) > self.modality_dropout
                mask = mask * keep
                dead = mask.sum(axis=1) == 0
                if dead.any():  # never drop every modality (src/data.py:337-341)
                    revive = rng.integers(0, num_mod, int(dead.sum()))
                    mask[np.where(dead)[0], revive] = 1.0
            yield features, labels, mask, lengths, weight


def compute_normalization_stats(
    windows: WindowedSplit,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-modality per-channel mean/std over VALID timesteps of a split."""
    stats: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    seq_len = windows.window_size
    valid = (
        np.arange(seq_len)[None, :] < windows.lengths[:, None]
    )[..., None]  # [N, T, 1]
    denom = max(1, int(valid.sum()))
    for m in windows.modalities:
        x = windows.features[m]
        masked = x * valid
        mean = masked.sum(axis=(0, 1)) / denom
        var = ((x - mean) * valid).astype(np.float64) ** 2
        std = np.sqrt(var.sum(axis=(0, 1)) / denom)
        std = np.where(std < 1e-6, 1.0, std)
        stats[m] = (mean.astype(np.float32), std.astype(np.float32))
    return stats


def apply_normalization(
    windows: WindowedSplit,
    stats: Dict[str, Tuple[np.ndarray, np.ndarray]],
) -> WindowedSplit:
    """Z-score features in place with train-split stats; padding stays zero."""
    seq_len = windows.window_size
    valid = (
        np.arange(seq_len)[None, :] < windows.lengths[:, None]
    )[..., None].astype(np.float32)
    for m in windows.modalities:
        mean, std = stats[m]
        windows.features[m] = ((windows.features[m] - mean) / std) * valid
    return windows


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


def create_datasets(
    dataset_name: str,
    data_dir: str | Path,
    modalities: Sequence[str],
    chunk_size: Optional[int] = None,
    chunk_cache_dir: Optional[str | Path] = None,
    normalize: bool = False,
    window_stride: Optional[int] = None,
    val_window_stride: Optional[int] = None,
    **kwargs,
) -> Tuple[WindowedSplit, WindowedSplit, WindowedSplit]:
    """Materialise train/val/test :class:`WindowedSplit`s.

    ``normalize`` applies per-channel z-scoring with TRAIN-split statistics to
    all three splits. ``window_stride`` (train only) enables overlapping
    sliding windows. ``val_window_stride`` does the same for the VAL split —
    used by temperature-scaling calibration, where the tiny surviving-subset
    val splits (45-89 non-overlapping windows) starve the fit; stride
    ``chunk//4`` pools ~4x more windows from the same underlying rows.
    """
    if dataset_name == "synthetic":
        def make(split, n):
            return SyntheticMultimodalDataset(
                num_samples=n,
                num_classes=kwargs.get("num_classes", 5),
                modality_dims={m: kwargs.get("modality_dim", 32) for m in modalities},
                sequence_length=kwargs.get("sequence_length", 100),
                split=split,
                seed=kwargs.get("seed", 42),
            ).windows

        n_train = kwargs.get("num_samples", 10000)
        n_eval = max(1, n_train // 5)
        return make("train", n_train), make("val", n_eval), make("test", n_eval)

    def make_real(split, stride=None):
        return MultimodalDataset(
            data_dir,
            modalities,
            split,
            chunk_size=chunk_size,
            chunk_cache_dir=chunk_cache_dir,
            window_stride=stride,
        ).windows

    train_w = make_real("train", stride=window_stride)
    val_w = make_real("val", stride=val_window_stride)
    test_w = make_real("test")
    mode = normalize if isinstance(normalize, str) else ("global" if normalize else "none")
    if mode == "instance":
        for w in (train_w, val_w, test_w):
            apply_instance_normalization(w)
    elif mode in ("global", "true", "zscore"):
        stats = compute_normalization_stats(train_w)
        train_w = apply_normalization(train_w, stats)
        val_w = apply_normalization(val_w, stats)
        test_w = apply_normalization(test_w, stats)
    return train_w, val_w, test_w


def create_dataloaders(
    dataset_name: str,
    data_dir: str | Path,
    modalities: Sequence[str],
    batch_size: int = 32,
    modality_dropout: float = 0.0,
    chunk_size: Optional[int] = None,
    chunk_cache_dir: Optional[str | Path] = None,
    seed: int = 0,
    **kwargs,
) -> Tuple[BatchLoader, BatchLoader, BatchLoader]:
    """Train/val/test loaders (reference API, ``src/data.py:446-595``).

    Host-process worker knobs (``num_workers``/``pin_memory``/...) do not
    exist in this design — the data is device-resident; they are accepted and
    ignored for config compatibility.
    """
    kwargs.pop("num_workers", None)
    kwargs.pop("pin_memory", None)
    kwargs.pop("persistent_workers", None)
    kwargs.pop("prefetch_factor", None)
    kwargs.pop("prefetch_shards", None)
    train_w, val_w, test_w = create_datasets(
        dataset_name, data_dir, modalities,
        chunk_size=chunk_size, chunk_cache_dir=chunk_cache_dir, seed=seed, **kwargs
    )
    train = BatchLoader(
        train_w, batch_size, shuffle=True, seed=seed,
        modality_dropout=modality_dropout,
    )
    val = BatchLoader(val_w, batch_size, shuffle=False, seed=seed)
    test = BatchLoader(test_w, batch_size, shuffle=False, seed=seed)
    return train, val, test


def simulate_missing_modalities(
    features: Mapping[str, np.ndarray],
    mask: np.ndarray,
    missing_pattern: Optional[List[int]] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Zero dropped modalities given a keep-pattern (``src/data.py:598-628``)."""
    mask = np.array(mask, copy=True)
    if missing_pattern is not None:
        new_mask = np.zeros_like(mask)
        for idx in missing_pattern:
            new_mask[..., idx] = 1
        mask = new_mask
    out = dict(features)
    for i, modality in enumerate(list(out.keys())):
        if np.all(mask[..., i] == 0):
            out[modality] = np.zeros_like(out[modality])
    return out, mask



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
