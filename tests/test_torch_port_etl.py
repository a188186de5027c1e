"""PyTorch port, the raw-data ETL (``data/preprocess.py``, ``data/native.py``)
against the JAX package's on synthetic PAMAP2 ``.dat`` files written from a
seed: ``merge_raw_files`` and ``import_reference_shards`` write equal arrays
and byte-equal manifests (and CSV mirrors), the split and the heart-rate
smoothing are the reference's, the native parser and window gather equal
their numpy paths, the manifest dataset cuts the same windows either way,
and ``python -m <port> preprocess`` runs the ETL. No raw PAMAP2 file is read."""

import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.data import preprocess as jpre
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import dataset as tdata
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import native as tnative
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import preprocess as tpre

PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
REPO = Path(__file__).resolve().parent.parent
N_COLS = len(tpre.PAMAP2_COLUMNS)


def _write_subject(path, seed, activities=(1, 2, 3, 0), rows_per=90):
    """A raw subject file: activity 0 (transient) rows included, heart rate
    NaN on most rows (the sensor's low rate), a few NaN IMU readings."""
    rng = np.random.default_rng(seed)
    lines = []
    t = 0.0
    for act in activities:
        for i in range(rows_per):
            row = rng.standard_normal(N_COLS).astype(np.float32)
            row[0], row[1] = t, act
            row[2] = 60 + 40 * rng.random() if i % 9 == 0 else np.nan
            if i % 31 == 5:
                row[3 + i % 17] = np.nan
            t += 0.01
            lines.append(" ".join("NaN" if np.isnan(v) else f"{v:.5f}" for v in row))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def raw_dir(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    for i, subject in enumerate((101, 102, 105)):
        _write_subject(raw / f"subject{subject}.dat", i, rows_per=90 + 30 * i)
    return raw


def _tree(root: Path):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _same_store(got_root: Path, want_root: Path):
    """Equal manifests and CSVs byte for byte, equal shard arrays."""
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    for rel, data in want.items():
        if rel.endswith(".npz"):
            a, b = tpre.load_shard(got_root / rel), jpre.load_shard(want_root / rel)
            assert a["columns"] == b["columns"]
            np.testing.assert_array_equal(a["data"], b["data"], err_msg=rel)
        else:
            assert got[rel] == data, rel


@pytest.mark.parametrize("write_csv", [False, True])
def test_merge_raw_files_equals_the_reference(raw_dir, tmp_path, write_csv):
    got = tpre.merge_raw_files(raw_dir, tmp_path / "port", write_csv=write_csv)
    want = jpre.merge_raw_files(raw_dir, tmp_path / "jax", write_csv=write_csv)
    assert {s: p.relative_to(tmp_path / "port") for s, p in got.items()} == {
        s: p.relative_to(tmp_path / "jax") for s, p in want.items()}
    _same_store(tmp_path / "port", tmp_path / "jax")
    # activity 0 dropped, the heart rate filled and smoothed (finite everywhere)
    for rel in _tree(tmp_path / "port"):
        if rel.endswith(".npz"):
            data = tpre.load_shard(tmp_path / "port" / rel)["data"]
            assert np.all(data[:, 1] != 0) and np.all(np.isfinite(data[:, 2]))


def _reference_layout(root: Path, raw_dir: Path, stripped: str):
    """A reference-layout data dir: torch ``.pt`` shards under
    ``processed_tensors`` and repo-root-relative manifests (``data/...``),
    with one shard's blob missing."""
    store = root.parent / "npz_store"
    manifests = jpre.merge_raw_files(raw_dir, store, write_csv=False)
    for split, path in manifests.items():
        lines = []
        for line in path.read_text().splitlines():
            rel, rows = line.split(",")
            payload = jpre.load_shard(store / rel)
            pt_rel = Path(rel).with_suffix(".pt")
            if str(pt_rel) != stripped:
                (root / pt_rel).parent.mkdir(parents=True, exist_ok=True)
                torch.save({"columns": payload["columns"],
                            "data": torch.from_numpy(payload["data"])}, root / pt_rel)
            lines.append(f"data/{pt_rel},{rows}")
        (root / "splits").mkdir(parents=True, exist_ok=True)
        (root / "splits" / f"{split}.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("restratify", [False, True])
def test_import_reference_shards_equals_the_reference(raw_dir, tmp_path, restratify):
    source = tmp_path / "reference" / "data"
    _reference_layout(source, raw_dir, "processed_tensors/subject_102/activity_2.pt")
    got = tpre.import_reference_shards(source, tmp_path / "port", restratify=restratify)
    want = jpre.import_reference_shards(source, tmp_path / "jax", restratify=restratify)
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    _same_store(tmp_path / "port", tmp_path / "jax")
    manifests = "".join((tmp_path / "port" / "splits" / f"{s}.txt").read_text() for s in got)
    assert "subject_102/activity_2" not in manifests  # the missing blob is skipped


def test_split_and_heart_rate_equal_the_reference():
    rng = np.random.default_rng(3)
    shards = [(f"processed_tensors/subject_{s}/activity_{a}.npz", int(rng.integers(5, 400)), a)
              for s in range(101, 109) for a in (1, 2, 3, 4, 12)]
    assert tpre.stratified_split(shards) == jpre.stratified_split(shards)
    data = rng.standard_normal((200, N_COLS)).astype(np.float32)
    data[rng.random(200) < 0.8, 2] = np.nan
    data[:7, 2] = np.nan  # leading NaNs: back-filled
    np.testing.assert_array_equal(tpre.interpolate_heart_rate(data),
                                  jpre.interpolate_heart_rate(data))
    tpre.validate_row_width(["0"] * N_COLS, Path("x.dat"))
    with pytest.raises(ValueError, match="Row width mismatch"):
        tpre.validate_row_width(["0"] * 3, Path("x.dat"))


def test_native_library_builds_under_build_and_parses_as_numpy(raw_dir, monkeypatch):
    if not tnative.native_available():
        pytest.skip("no C++ compiler: the numpy path is the only one")
    assert tnative._target().parent == REPO / "build" / "native"
    path = raw_dir / "subject101.dat"
    native = tpre.load_subject_file(path)
    monkeypatch.setattr(tnative, "_load_library", lambda: None)
    assert tnative.parse_dat(path, N_COLS) is None
    np.testing.assert_array_equal(native, tpre.load_subject_file(path))  # np.loadtxt


def test_native_window_gather_equals_numpy():
    if not tnative.native_available():
        pytest.skip("no C++ compiler: the numpy path is the only one")
    rng = np.random.default_rng(1)
    data = rng.standard_normal((300, 10)).astype(np.float32)
    data[5, 2], data[60, 4], data[290, 9] = np.nan, np.inf, -np.inf
    starts, ends, cols, window = [0, 50, 280], [40, 114, 300], [2, 4, 9], 64
    out = tnative.window_gather(data, starts, ends, window, cols)
    assert out.shape == (3, window, 3)
    for i, (s, e) in enumerate(zip(starts, ends)):
        np.testing.assert_array_equal(out[i, : e - s], tdata._scrub(data[s:e][:, cols].copy()))
        assert (out[i, e - s:] == 0).all()
    with pytest.raises(ValueError, match="outside"):
        tnative.window_gather(data, [0], [301], window, cols)


def test_manifest_dataset_native_gather_equals_numpy_gather(raw_dir, tmp_path, monkeypatch):
    root = tmp_path / "pamap2"
    tpre.merge_raw_files(raw_dir, root, write_csv=False)
    mods = ["imu_hand", "imu_ankle", "heart_rate"]
    native = tdata.MultimodalDataset(root, mods, "train", chunk_size=32, window_stride=8).windows
    monkeypatch.setattr(tnative, "_load_library", lambda: None)
    plain = tdata.MultimodalDataset(root, mods, "train", chunk_size=32, window_stride=8).windows
    assert native.num_windows == plain.num_windows > 0
    for m in mods:
        np.testing.assert_array_equal(native.features[m], plain.features[m])
    np.testing.assert_array_equal(native.labels, plain.labels)
    np.testing.assert_array_equal(native.lengths, plain.lengths)


def test_preprocess_command_runs_the_etl(raw_dir, tmp_path, monkeypatch, capsys):
    """``python -m <port> preprocess --raw-dir ... --output ...``."""
    monkeypatch.setattr(sys, "argv", [PKG, "preprocess", "--raw-dir", str(raw_dir),
                                      "--output", str(tmp_path / "out"), "--no-csv"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(PKG, run_name="__main__", alter_sys=True)
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()] == ["train", "val", "test"]
    jpre.merge_raw_files(raw_dir, tmp_path / "jax", write_csv=False)
    _same_store(tmp_path / "out", tmp_path / "jax")
    assert not os.path.exists(tmp_path / "out" / "processed")  # --no-csv
