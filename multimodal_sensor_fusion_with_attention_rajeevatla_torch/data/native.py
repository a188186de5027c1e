"""ctypes bindings for the native ETL core (``native/fastload.cpp``).

The port's own binding of the repository's C++ parser and window gather:
at first use the source is compiled with ``g++`` into
``<checkout>/build/native/libfastload_<hash>.so`` (``build/`` is git-ignored;
nothing is written under ``native/``), under a name that carries a hash of
the source and flags, so an edited source is rebuilt. Every entry point
returns None when no compiler is present or the build fails, and the
callers then take their numpy path, which computes the same arrays: the
library is a host-side speed-up of the ETL and of the manifest dataset's
window gather, never a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False
_lock = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastload_{digest}.so"


def _build(target: Path) -> bool:
    """Compile the source into ``target`` (through a temporary file, so that
    processes building at once never load a partial library)."""
    compiler = shutil.which("g++")
    if compiler is None or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([compiler, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, target)
    return True


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        target = _target() if SOURCE.exists() else None
        if target is None:
            return None
        if not target.exists():
            if _build_attempted:
                return None
            _build_attempted = True
            if not _build(target):
                return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        lib.pamap2_count_rows.restype = ctypes.c_long
        lib.pamap2_count_rows.argtypes = [ctypes.c_char_p]
        lib.pamap2_parse.restype = ctypes.c_long
        lib.pamap2_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.window_gather.restype = None
        lib.window_gather.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_library() is not None


def parse_dat(path: str | Path, n_cols: int, strict: bool = False) -> Optional[np.ndarray]:
    """Parse a whitespace-separated .dat file natively -> float32 ``[rows,
    n_cols]`` (missing fields NaN). None if the library is unavailable or the
    file cannot be read; ``ValueError`` on a row of another width with
    ``strict``."""
    lib = _load_library()
    if lib is None:
        return None
    path_b = str(path).encode()
    rows = lib.pamap2_count_rows(path_b)
    if rows < 0:
        return None
    out = np.empty((rows, n_cols), dtype=np.float32)
    got = lib.pamap2_parse(path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows,
                           n_cols, 1 if strict else 0, 0)
    if got < 0:
        if got == -2:
            raise ValueError(f"Row width mismatch in {path}")
        return None
    return out[:got]


def window_gather(
    data: np.ndarray,
    starts: Sequence[int],
    ends: Sequence[int],
    window: int,
    col_idx: Sequence[int],
) -> Optional[np.ndarray]:
    """Native windowing: the rows ``[start, end)`` of the columns ``col_idx``
    of ``data [rows, cols]`` for each window, NaN/Inf scrubbed to 0 and
    zero-padded to ``window`` rows, in one multithreaded pass -> float32
    ``[n_windows, window, len(col_idx)]``. None if the library is
    unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    starts_arr = np.asarray(starts, dtype=np.int64)
    ends_arr = np.asarray(ends, dtype=np.int64)
    cols = np.asarray(col_idx, dtype=np.int64)
    if (starts_arr.shape != ends_arr.shape or np.any(starts_arr < 0)
            or np.any(ends_arr > data.shape[0]) or np.any((cols < 0) | (cols >= data.shape[1]))):
        raise ValueError("window_gather: window bounds or columns outside the data")
    n_windows = starts_arr.shape[0]
    out = np.empty((n_windows, window, cols.shape[0]), dtype=np.float32)
    lib.window_gather(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.shape[1],
        starts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ends_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_windows, window,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), cols.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 0,
    )
    return out
