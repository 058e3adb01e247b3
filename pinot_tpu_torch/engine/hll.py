"""HyperLogLog sketch (copy of ``pinot_tpu.engine.hll``, trimmed).

The reference uses clearspring's HyperLogLog with ``log2m = 8``
(pinot-core ``startree/hll/HllConstants.java`` DEFAULT_LOG2M) for
``distinctcounthll`` / ``fasthll``.  Here the sketch is a plain
``uint8[m]`` register array: per-row (bucket, rho) pairs are precomputed
per dictionary entry on the host, the device turns them into register
maxima, and the cross-segment merge is an elementwise ``maximum``.

Hashing is a deterministic 64-bit hash (blake2b over ``repr``), not
Python's salted ``hash()``, so both packages and any oracle agree bit for
bit.
"""
from __future__ import annotations

import hashlib
import math
import struct
from typing import Any, Iterable

import numpy as np

DEFAULT_LOG2M = 8  # HllConstants.java DEFAULT_LOG2M
M = 1 << DEFAULT_LOG2M


def value_hash64(value: Any) -> int:
    """Deterministic 64-bit hash of an ingest value."""
    if isinstance(value, float) and value.is_integer():
        # Hash 5.0 and 5 identically so INT/LONG/FLOAT columns agree.
        value = int(value)
    data = repr(value).encode("utf-8")
    return struct.unpack("<Q", hashlib.blake2b(data, digest_size=8).digest())[0]


def bucket_and_rho(h: int, log2m: int = DEFAULT_LOG2M) -> tuple:
    """Split a 64-bit hash into (register index, rank of first set bit)."""
    m = 1 << log2m
    bucket = h & (m - 1)
    rest = h >> log2m
    # rho = position of least-significant 1 bit in the remaining bits + 1
    width = 64 - log2m
    if rest == 0:
        rho = width + 1
    else:
        rho = (rest & -rest).bit_length()
    return bucket, rho


def registers_from_values(values: Iterable[Any], log2m: int = DEFAULT_LOG2M) -> np.ndarray:
    m = 1 << log2m
    regs = np.zeros(m, dtype=np.uint8)
    for v in values:
        b, r = bucket_and_rho(value_hash64(v), log2m)
        if r > regs[b]:
            regs[b] = r
    return regs


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate_from_registers(regs: np.ndarray) -> int:
    """Standard HLL estimator with small/large-range corrections
    (the clearspring ``HyperLogLog.cardinality()`` algorithm); a stack
    ``[..., m]`` of register arrays gives one estimate each."""
    regs = np.asarray(regs)
    m = regs.shape[-1]
    rsum = np.sum(np.power(2.0, -regs.astype(np.float64)), axis=-1)
    estimate = _alpha(m) * m * m / rsum
    zeros = np.sum(regs == 0, axis=-1)
    if np.ndim(estimate) == 0:
        return int(_correct(float(estimate), int(zeros), m))
    out = np.empty(estimate.shape, dtype=np.int64)
    flat_e, flat_z = estimate.ravel(), np.asarray(zeros).ravel()
    for i in range(flat_e.size):
        out.ravel()[i] = _correct(float(flat_e[i]), int(flat_z[i]), m)
    return out


def _correct(estimate: float, zeros: int, m: int) -> int:
    if estimate <= 2.5 * m and zeros > 0:
        # linear counting
        return int(round(m * math.log(m / float(zeros))))
    two64 = 2.0**64
    if estimate > two64 / 30.0:
        return int(round(-two64 * math.log(1.0 - estimate / two64)))
    return int(round(estimate))


def merge_registers(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def hll_estimate_exact_values(values: Iterable[Any], log2m: int = DEFAULT_LOG2M) -> int:
    """The sketch's estimate of a concrete value set (the host tier's
    row-wise path and any oracle use it, so they agree with the engine)."""
    return int(estimate_from_registers(registers_from_values(values, log2m)))


def dictionary_tables(dictionary):
    """Per-dictId (register index, rank) uint8 tables for a column
    dictionary — the one place the per-entry hashing loop lives (shared
    by the staging stream builder, the planner's table fallback and the
    presence finalize, which must agree bit for bit).  Cached on the
    dictionary: the loop runs at Python speed."""
    cached = getattr(dictionary, "_hll_tables", None)
    if cached is not None:
        return cached
    card = max(dictionary.cardinality, 1)
    bt = np.zeros(card, dtype=np.uint8)
    rt = np.zeros(card, dtype=np.uint8)
    for j in range(dictionary.cardinality):
        b, r = bucket_and_rho(value_hash64(dictionary.get(j)))
        bt[j] = b
        rt[j] = r
    dictionary._hll_tables = (bt, rt)
    return bt, rt
