"""PAMAP2 offline ETL: raw ``.dat`` -> tensor shards + split manifests (copy
of the JAX package's ``data/preprocess.py``; the port may not import it).

Capability parity with the reference ETL (``data/preprocess.py:41-316``):

- 54-column named schema: ``timestamp_s, activity_id, heart_rate_bpm`` plus
  3 IMUs (hand/chest/ankle) x 17 channels (temp, acc16 xyz, acc6 xyz,
  gyro xyz, mag xyz, orientation wxyz).
- transient-activity rows (``activity_id == 0``) dropped,
- per-subject heart-rate forward/backward fill + rolling-median(25) smoothing,
- per-(subject, activity) shard materialisation,
- greedy row-quota stratified 70/15/15 split by activity with a rebalancing
  pass, and ``path,rows`` manifest files.

Shards are ``.npz`` (numpy archive with ``columns`` + ``data`` float32), as
the JAX package writes them; ``load_shard`` also reads the reference's
``.pt`` shards, and ``import_reference_shards`` converts a reference-layout
data directory into the ``.npz`` store. Host code only: the raw files are
parsed by the native parser of ``data/native.py`` where a C++ compiler is
present, by ``np.loadtxt`` otherwise. The same input gives the same shards
and byte-identical manifests as the JAX package's ETL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_IMU_LOCATIONS = ("hand", "chest", "ankle")
_IMU_CHANNELS = (
    "temp_c",
    "acc16_x_ms2",
    "acc16_y_ms2",
    "acc16_z_ms2",
    "acc6_x_ms2",
    "acc6_y_ms2",
    "acc6_z_ms2",
    "gyro_x_rads",
    "gyro_y_rads",
    "gyro_z_rads",
    "mag_x_ut",
    "mag_y_ut",
    "mag_z_ut",
    "orientation_w",
    "orientation_x",
    "orientation_y",
    "orientation_z",
)

PAMAP2_COLUMNS: Tuple[str, ...] = (
    "timestamp_s",
    "activity_id",
    "heart_rate_bpm",
    *(f"{loc}_{ch}" for loc in _IMU_LOCATIONS for ch in _IMU_CHANNELS),
)

TRAIN_FRACTION, VAL_FRACTION, TEST_FRACTION = 0.70, 0.15, 0.15
_HR_MEDIAN_WINDOW = 25


def load_subject_file(path: Path) -> np.ndarray:
    """Parse one raw PAMAP2 subject ``.dat`` file -> float32 ``[rows, 54]``.

    Uses the native multithreaded parser (``native/fastload.cpp``) when
    available — ~2 orders of magnitude faster than ``np.loadtxt`` on the
    multi-hundred-MB raw subject files — with a numpy fallback.
    """
    from .native import parse_dat

    native = parse_dat(path, len(PAMAP2_COLUMNS))
    if native is not None:
        # align with the numpy fallback's behavior on malformed input:
        # drop all-NaN rows (blank lines — np.loadtxt skips those) and
        # hard-error on rows whose activity_id failed to parse (np.loadtxt
        # raises on ragged/garbage lines; a NaN activity_id would otherwise
        # survive the != 0 filter and crash sharding later)
        blank = np.all(np.isnan(native), axis=1)
        if blank.any():
            native = native[~blank]
        if np.isnan(native[:, 1]).any():
            bad = int(np.isnan(native[:, 1]).sum())
            raise ValueError(
                f"{path}: {bad} row(s) with unparseable activity_id "
                "(malformed line in raw .dat)"
            )
        return native
    rows = np.loadtxt(path, dtype=np.float32, ndmin=2)
    if rows.shape[1] != len(PAMAP2_COLUMNS):
        raise ValueError(
            f"Expected {len(PAMAP2_COLUMNS)} columns in {path}, got {rows.shape[1]}"
        )
    return rows


def interpolate_heart_rate(data: np.ndarray) -> np.ndarray:
    """Forward/backward-fill HR then smooth with a rolling median.

    Vectorised equivalent of the reference's per-subject fill + rolling
    median(25) (``data/preprocess.py:99-110``). Operates on column index 2
    (``heart_rate_bpm``) in place on a copy.
    """
    out = data.copy()
    hr = out[:, 2].astype(np.float64)
    n = hr.shape[0]
    valid = ~np.isnan(hr)
    if not valid.any():
        return out
    # forward fill: index of the most recent valid sample
    idx = np.where(valid, np.arange(n), -1)
    ffill_idx = np.maximum.accumulate(idx)
    filled = np.where(ffill_idx >= 0, hr[np.clip(ffill_idx, 0, None)], np.nan)
    # backward fill the leading NaNs
    first_valid = int(np.argmax(valid))
    filled[:first_valid] = hr[first_valid]
    # centered-ish rolling median over a trailing window (matches a
    # rolling_median with window 25 applied post-fill)
    window = min(_HR_MEDIAN_WINDOW, n)
    if window >= 2:
        from numpy.lib.stride_tricks import sliding_window_view

        padded = np.concatenate([np.full(window - 1, filled[0]), filled])
        filled = np.median(sliding_window_view(padded, window), axis=-1)
    out[:, 2] = filled.astype(np.float32)
    return out


def validate_row_width(row: Sequence[str], path: Path) -> None:
    if len(row) != len(PAMAP2_COLUMNS):
        raise ValueError(
            f"Row width mismatch in {path}: expected {len(PAMAP2_COLUMNS)}, "
            f"got {len(row)}"
        )


def write_shard(
    dest: Path, data: np.ndarray, columns: Sequence[str] = PAMAP2_COLUMNS
) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    np.savez(dest, columns=np.array(list(columns)), data=data.astype(np.float32))


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
        import torch  # optional dependency, only for reference-format shards

        payload = torch.load(path, weights_only=False, map_location="cpu")
        return {
            "columns": [str(c) for c in payload["columns"]],
            "data": payload["data"].numpy().astype(np.float32),
        }
    raise FileNotFoundError(f"Unsupported or missing shard: {path}")


def _materialize_shards(
    merged: np.ndarray,
    subjects: np.ndarray,
    output_root: Path,
    write_csv: bool = True,
) -> List[Tuple[str, int]]:
    """Write per-(subject, activity) CSV + ``.npz`` shards; return (relpath, rows)."""
    shards: List[Tuple[str, int]] = []
    tensor_root = output_root / "processed_tensors"
    csv_root = output_root / "processed"
    for subject in np.unique(subjects):
        subject_rows = merged[subjects == subject]
        for activity in np.unique(subject_rows[:, 1]):
            rows = subject_rows[subject_rows[:, 1] == activity]
            name = f"subject_{int(subject)}/activity_{int(activity)}"
            shard_rel = f"processed_tensors/{name}.npz"
            write_shard(output_root / shard_rel, rows)
            if write_csv:
                csv_path = csv_root / f"{name}.csv"
                csv_path.parent.mkdir(parents=True, exist_ok=True)
                # vectorised write: rows come from a dense [N, 54] array so
                # per-row width validation is vacuous, and a Python loop
                # over millions of rows dominates the whole ETL
                np.savetxt(
                    csv_path, rows, fmt="%.6f", delimiter=",",
                    header=",".join(PAMAP2_COLUMNS), comments="",
                )
            shards.append((shard_rel, int(rows.shape[0])))
    return shards


def stratified_split(
    shards: List[Tuple[str, int, int]],
    fractions: Tuple[float, float, float] = (TRAIN_FRACTION, VAL_FRACTION, TEST_FRACTION),
    max_rebalance_passes: int = 8,
) -> Dict[str, List[Tuple[str, int]]]:
    """Greedy row-quota stratified split by activity, with rebalancing.

    ``shards`` carries ``(relpath, rows, activity_id)``. Within each activity
    the largest shards are dealt to whichever split is furthest below its row
    quota; a rebalancing loop then moves shards from over-full to under-full
    splits while doing so reduces total quota violation (the reference's
    greedy + rebalance design, ``data/preprocess.py:176-234``).
    """
    split_names = ("train", "val", "test")
    assignments: Dict[str, List[Tuple[str, int]]] = {s: [] for s in split_names}
    totals = {s: 0 for s in split_names}
    total_rows = sum(rows for _, rows, _ in shards)
    quotas = {s: f * total_rows for s, f in zip(split_names, fractions)}

    by_activity: Dict[int, List[Tuple[str, int]]] = {}
    for rel, rows, activity in shards:
        by_activity.setdefault(activity, []).append((rel, rows))

    for activity in sorted(by_activity):
        items = sorted(by_activity[activity], key=lambda x: -x[1])
        act_rows = sum(r for _, r in items)
        act_quota = {s: f * act_rows for s, f in zip(split_names, fractions)}
        act_totals = {s: 0 for s in split_names}
        for rel, rows in items:
            # deal within the activity so every split sees every activity
            deficits = {
                s: (act_totals[s] - act_quota[s]) / max(act_quota[s], 1.0)
                for s in split_names
            }
            target = min(split_names, key=lambda s: deficits[s])
            assignments[target].append((rel, rows))
            act_totals[target] += rows
            totals[target] += rows

    activity_of = {rel: act for rel, _rows, act in shards}

    def violation() -> float:
        return sum(abs(totals[s] - quotas[s]) for s in split_names)

    def activity_count(split: str, activity: int) -> int:
        return sum(1 for rel, _ in assignments[split] if activity_of[rel] == activity)

    for _ in range(max_rebalance_passes):
        improved = False
        for src in split_names:
            for dst in split_names:
                if src == dst:
                    continue
                for item in list(assignments[src]):
                    rel, rows = item
                    # never strip the last shard of an activity from a split
                    if activity_count(src, activity_of[rel]) <= 1:
                        continue
                    before = violation()
                    totals[src] -= rows
                    totals[dst] += rows
                    if violation() < before and len(assignments[src]) > 1:
                        assignments[src].remove(item)
                        assignments[dst].append(item)
                        improved = True
                    else:
                        totals[src] += rows
                        totals[dst] -= rows
        if not improved:
            break
    return assignments


def write_split_manifests(
    assignments: Dict[str, List[Tuple[str, int]]], output_root: Path
) -> Dict[str, Path]:
    splits_dir = output_root / "splits"
    splits_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for split, items in assignments.items():
        manifest = splits_dir / f"{split}.txt"
        with manifest.open("w", encoding="utf-8") as handle:
            for rel, rows in sorted(items):
                # entries are OUTPUT-ROOT-relative (the dataset resolver's
                # default root is data_dir): a hard-coded "data/" prefix
                # only resolves when the output root is literally named
                # "data" (reference manifests carry the prefix because they
                # are repo-root-relative; the resolver supports both forms)
                handle.write(f"{rel},{rows}\n")
        paths[split] = manifest
    return paths


def merge_raw_files(
    raw_dir: str | Path,
    output_path: str | Path,
    write_csv: bool = True,
) -> Dict[str, Path]:
    """The whole ETL: discover raw subject files, clean, shard, split.

    Mirrors the reference (``data/preprocess.py:250-282``): rows with
    ``activity_id == 0`` are dropped, rows sorted by (subject, timestamp), HR
    interpolated per subject, then shards + manifests written under
    ``output_path`` (which plays the role of the repo's ``data/`` directory).
    """
    raw_dir = Path(raw_dir)
    output_root = Path(output_path)
    subject_files = sorted(raw_dir.glob("subject*.dat"))
    if not subject_files:
        raise FileNotFoundError(f"No raw PAMAP2 subject files found in {raw_dir}")

    merged_parts = []
    subject_parts = []
    for path in subject_files:
        subject_id = int("".join(ch for ch in path.stem if ch.isdigit()) or 0)
        rows = load_subject_file(path)
        rows = rows[rows[:, 1] != 0]  # drop transient activity 0
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        rows = interpolate_heart_rate(rows)
        merged_parts.append(rows)
        subject_parts.append(np.full(rows.shape[0], subject_id, dtype=np.int64))

    merged = np.concatenate(merged_parts, axis=0)
    subjects = np.concatenate(subject_parts, axis=0)

    shard_list = _materialize_shards(merged, subjects, output_root, write_csv=write_csv)
    with_activity = []
    for rel, rows in shard_list:
        activity = int(rel.rsplit("activity_", 1)[1].split(".")[0])
        with_activity.append((rel, rows, activity))
    assignments = stratified_split(with_activity)
    return write_split_manifests(assignments, output_root)


def import_reference_shards(
    source_root: str | Path,
    output_root: str | Path,
    splits: Sequence[str] = ("train", "val", "test"),
    skip_missing: bool = True,
    restratify: bool = False,
) -> Dict[str, Path]:
    """Convert a reference-layout data dir (torch ``.pt`` shards + manifests)
    into the native ``.npz`` store, keeping only shards that exist.

    The public mirror of the reference strips some large shard blobs; with
    ``skip_missing`` the rebuilt manifests reference only what is present.
    With ``restratify`` the original split assignment is discarded and the
    available shards are re-dealt with :func:`stratified_split`, so every
    split covers the same activity set even when blobs were stripped
    unevenly.
    """
    source_root = Path(source_root)
    output_root = Path(output_root)
    manifests: Dict[str, Path] = {}
    converted: List[Tuple[str, int]] = []
    for split in splits:
        src_manifest = source_root / "splits" / f"{split}.txt"
        if not src_manifest.exists():
            continue
        kept: List[Tuple[str, int]] = []
        for line in src_manifest.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            rel, rows_str = line.split(",", 1)
            rel_path = Path(rel)
            # manifests are repo-root-relative ("data/processed_tensors/...")
            src_shard = (
                source_root / rel_path.relative_to("data")
                if rel_path.parts and rel_path.parts[0] == "data"
                else source_root / rel_path
            )
            if not src_shard.exists():
                if skip_missing:
                    continue
                raise FileNotFoundError(f"Shard referenced in manifest not found: {src_shard}")
            payload = load_shard(src_shard)
            dest_rel = rel_path.with_suffix(".npz")
            dest_rel_str = str(
                dest_rel.relative_to("data") if dest_rel.parts[0] == "data" else dest_rel
            )
            write_shard(output_root / dest_rel_str, payload["data"], payload["columns"])
            kept.append((dest_rel_str, int(rows_str)))
        converted.extend(kept)
        splits_dir = output_root / "splits"
        splits_dir.mkdir(parents=True, exist_ok=True)
        manifest = splits_dir / f"{split}.txt"
        with manifest.open("w", encoding="utf-8") as handle:
            for rel, rows in kept:
                handle.write(f"{rel},{rows}\n")
        manifests[split] = manifest

    if restratify and converted:
        with_activity = []
        for rel, rows in converted:
            activity = int(rel.rsplit("activity_", 1)[1].split(".")[0])
            with_activity.append((rel, rows, activity))
        assignments = stratified_split(with_activity)
        splits_dir = output_root / "splits"
        for split, items in assignments.items():
            manifest = splits_dir / f"{split}.txt"
            with manifest.open("w", encoding="utf-8") as handle:
                for rel, rows in sorted(items):
                    handle.write(f"{rel},{rows}\n")
            manifests[split] = manifest
    return manifests


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: ``python data/preprocess.py --raw-dir <dir> --output <dir>``."""
    import argparse

    parser = argparse.ArgumentParser(description="PAMAP2 preprocessing (raw .dat ETL)")
    parser.add_argument("--raw-dir", type=str, default="data/raw", help="Raw .dat directory")
    parser.add_argument("--output", type=str, default="data", help="Output data root")
    parser.add_argument(
        "--import-reference",
        type=str,
        default=None,
        help="Convert a reference-layout data dir (.pt shards) instead of raw ETL",
    )
    parser.add_argument("--no-csv", action="store_true", help="Skip CSV mirror output")
    args = parser.parse_args(argv)

    if args.import_reference:
        manifests = import_reference_shards(args.import_reference, args.output)
    else:
        manifests = merge_raw_files(args.raw_dir, args.output, write_csv=not args.no_csv)
    for split, path in manifests.items():
        print(f"{split}: {path}")


if __name__ == "__main__":
    main()
