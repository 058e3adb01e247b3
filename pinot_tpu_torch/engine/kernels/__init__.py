"""Hand-written CUDA kernels and their build.

Each kernel is one ``csrc/<source>.cu`` with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first
use and loaded with ``ctypes``.  With ``PINOT_TPU_COMPILE_CACHE_DIR`` set
the libraries build under ``<root>/ext/<fingerprint>`` instead
(``compilecache.library_dir``), keyed also by the torch and CUDA
versions and the card, so a restarted server finds them built.  A source
may build more than one library (``LIBRARIES``: the source and its extra
``nvcc`` flags), so that the halves of a large set of template
instantiations compile in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from pinot_tpu_torch.engine import compilecache

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = REPO_ROOT / "pinot_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every library: (its csrc source, extra nvcc flags).  K1's float and
# double sums, and K2's full-scan and block-table instantiations, are two
# libraries of one source each.
LIBRARIES = {
    "fused_groupby": ("fused_groupby", ("-DSUM_WIDTH=0",)),
    "fused_groupby_x64": ("fused_groupby", ("-DSUM_WIDTH=1",)),
    "value_state_counts": ("value_state_counts", ("-DBLOCK_TABLE=0",)),
    "value_state_counts_blocks": ("value_state_counts", ("-DBLOCK_TABLE=1",)),
}
KERNELS = tuple(LIBRARIES)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas report included) per kernel built here


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build_dir() -> Path:
    """``build/``, or the compile cache's library directory when the cache
    is on."""
    cached = compilecache.library_dir()
    return BUILD_DIR if cached is None else Path(cached)


def library_path(name: str) -> Path:
    """Build output for a library, keyed by the hash of source and flags."""
    source, extra = LIBRARIES[name]
    src = CSRC / f"{source}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS + extra).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{h}.so"


def build(names: Sequence[str]) -> None:
    """Compile every library of ``names`` that is missing: one ``nvcc``
    per source, all started together.  Each build writes a per-process
    temporary file and renames it into place, so concurrent builders
    never load a half-written library."""
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, extra = LIBRARIES[name]
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in procs:
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(name)
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(f"{n}:\n{build_logs[n]}" for n in failed)
        )


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def load_all() -> None:
    """Build every kernel that is missing (all ``nvcc`` at once) and load
    each: a failed build raises here, before any query runs."""
    build(KERNELS)
    for name in KERNELS:
        load(name)
