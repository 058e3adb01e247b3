"""ctypes binding of the native CSV parser (the CSV half of the
reference's ``pinot_tpu.segment.native``; ``csrc/csvread.cpp`` is a copy
of its ``native/csvread.cpp``).

The source is compiled with ``g++ -O3 -fPIC -shared -std=c++17`` into
``build/libcsvread-<hash>.so`` at first use and loaded with ``ctypes``.
Each build writes a per-process temporary file and renames it into
place, as the CUDA kernels' build does (``engine/kernels``), so
concurrent builders never load a half-written library.  A failed build
raises and names the compiler's output: nothing switches quietly to the
row path (the reference degrades to it when its library is missing).
This is a host codec; the reference never ran it on the TPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "pinot_tpu_torch" / "csrc" / "csvread.cpp"
BUILD_DIR = REPO_ROOT / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_log = ""  # the compiler's output of a build made in this process


def library_path() -> Path:
    """Build output, keyed by the hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcsvread-{h}.so"


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("the native CSV parser needs a C++ compiler (g++), and none was found")


def build() -> Path:
    """Compile the parser if its library is missing; raises on failure."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}")
    tmp.replace(out)
    return out


def load() -> ctypes.CDLL:
    """The parser's library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pinot_csv_parse.argtypes = [
                ctypes.c_void_p,  # readonly buffers (mmap) pass by address
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_char,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ]
            lib.pinot_csv_parse.restype = ctypes.c_int64
            _lib = lib
        return _lib


def csv_available() -> bool:
    """True once the parser is built and loaded; a failed build raises."""
    return load() is not None


def csv_parse(data, start: int, delimiter: str, types, i64_defaults, f64_defaults):
    """One-pass columnar CSV parse (``csrc/csvread.cpp``), starting at
    byte offset ``start`` (past the header): the buffer is not copied.

    ``types[c]``: 0 -> int64 column, 1 -> float64 column, 2 -> raw
    (offset,length) slices for string/MV cells (offsets absolute into
    ``data``), 3 -> tokenize but record nothing (non-schema columns).
    Returns ``(nrows, i64_cols, f64_cols, str_offs)``, dicts keyed by
    column index, each value a numpy array trimmed to nrows, or None when
    the data needs the csv module's semantics (unparseable numerics,
    ragged-wide rows, a non-ASCII delimiter): the caller then takes the
    row path, as the reference does.
    """
    lib = load()
    try:
        delim = delimiter.encode("ascii")
    except UnicodeEncodeError:
        return None  # python csv handles exotic delimiters
    if len(delim) != 1:
        return None
    ncols = len(types)
    types_arr = np.asarray(types, dtype=np.int8)
    i64_def = np.asarray(i64_defaults, dtype=np.int64)
    f64_def = np.asarray(f64_defaults, dtype=np.float64)
    if isinstance(data, (bytes, bytearray)):
        max_rows = data.count(b"\n", start) + 1
        buf = data
    else:  # mmap: chunked newline count + pass-by-address (readonly)
        view = np.frombuffer(data, dtype=np.uint8)
        # bounded chunks keep the comparison temporary at O(chunk), not
        # O(file): the point of mmap-ing in the first place
        nl = 0
        for ofs in range(start, view.size, 1 << 24):
            nl += int(np.count_nonzero(view[ofs : ofs + (1 << 24)] == 0x0A))
        max_rows = nl + 1
        buf = ctypes.c_void_p(view.ctypes.data)
    i64_cols = {c: np.empty(max_rows, dtype=np.int64) for c in range(ncols) if types[c] == 0}
    f64_cols = {c: np.empty(max_rows, dtype=np.float64) for c in range(ncols) if types[c] == 1}
    str_offs = {c: np.empty(2 * max_rows, dtype=np.int64) for c in range(ncols) if types[c] == 2}

    PI64 = ctypes.POINTER(ctypes.c_int64)
    PF64 = ctypes.POINTER(ctypes.c_double)
    null_i64 = ctypes.cast(None, PI64)
    null_f64 = ctypes.cast(None, PF64)
    i64_ptrs = (PI64 * ncols)(
        *[i64_cols[c].ctypes.data_as(PI64) if c in i64_cols else null_i64 for c in range(ncols)]
    )
    f64_ptrs = (PF64 * ncols)(
        *[f64_cols[c].ctypes.data_as(PF64) if c in f64_cols else null_f64 for c in range(ncols)]
    )
    off_ptrs = (PI64 * ncols)(
        *[str_offs[c].ctypes.data_as(PI64) if c in str_offs else null_i64 for c in range(ncols)]
    )
    nrows = lib.pinot_csv_parse(
        buf,
        len(data),
        start,
        delim,
        ncols,
        types_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        i64_def.ctypes.data_as(PI64),
        f64_def.ctypes.data_as(PF64),
        max_rows,
        i64_ptrs,
        f64_ptrs,
        off_ptrs,
    )
    if nrows < 0:
        return None  # the csv module's semantics: the row path
    return (
        int(nrows),
        {c: a[:nrows] for c, a in i64_cols.items()},
        {c: a[:nrows] for c, a in f64_cols.items()},
        {c: a[: 2 * nrows] for c, a in str_offs.items()},
    )
