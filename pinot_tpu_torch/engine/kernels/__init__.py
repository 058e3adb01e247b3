"""Hand-written CUDA kernels and their build.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first
use and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = REPO_ROOT / "pinot_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas report included) per kernel built here


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Build output for a source, keyed by the hash of source and flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing.  The
    build writes a per-process temporary file and renames it into place,
    so concurrent builders never load a half-written library."""
    lib = _loaded.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            build_logs[name] = proc.stdout
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
            tmp.replace(out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib
