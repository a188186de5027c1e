"""Build the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``.cu`` source exports a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, then loaded with ``ctypes``.
Sources that include no PyTorch header build in seconds, where one built
through ``torch.utils.cpp_extension.load`` takes minutes; every source gets
its own ``nvcc`` process and all of them run at once.

Libraries land in ``<checkout>/build/torch_ext/`` (listed in ``.gitignore``)
under a name that carries a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here runs
at import time: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = {
    "packed_attention": "packed_attention.cu",
    "packed_attention_bwd": "packed_attention_bwd.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "fusion_head": "fusion_head.cu",
    "proj_ln": "proj_ln.cu",
    "ffw_ln": "ffw_ln.cu",
    "ffw": "ffw.cu",
    "dropout_mask": "dropout_mask.cu",
    "rnn": "rnn.cu",
    "rnn_train": "rnn_train.cu",
}
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the port's CUDA "
        "kernels are compiled from ops/csrc at first use"
    )


def _target(name: str) -> Path:
    source = CSRC_DIR / SOURCES[name]
    # the shared headers are part of every source's content
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing kernel library (all ``nvcc`` runs in parallel)
    and load all of them. Raises ``RuntimeError`` with the compiler's output
    when a source does not build."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        for name in SOURCES:
            if name in _libs:
                continue
            target = _target(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
            pending[name] = (target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failures = []
        for name, (target, tmp, proc) in pending.items():
            output, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{output}")
                continue
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        for name in SOURCES:
            if name not in _libs:
                lib = ctypes.CDLL(str(_target(name)))
                lib.msfa_cuda_error_string.argtypes = [ctypes.c_int]
                lib.msfa_cuda_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for kernel source ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (refused launch,
    bad configuration) — ``torch.cuda.synchronize`` would not report those."""
    if code != 0:
        message = lib.msfa_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({message})")
