"""Vectorized numpy group-max primitives (copy of
``pinot_tpu.utils.npgroup``).

``np.maximum.at`` runs an element-wise Python-speed inner loop; these
sort + ``reduceat`` equivalents are far faster over many rows.  The HLL
register finalizers (``engine/executor``) use them.
"""
from __future__ import annotations

import numpy as np


def group_max_rows(inverse: np.ndarray, num_groups: int, values: np.ndarray) -> np.ndarray:
    """Per-group elementwise max of [R, M] ``values`` -> [G, M].

    Contract: every group in [0, num_groups) has >= 1 row (callers pass
    ``inverse`` from ``np.unique(..., return_inverse=True)``, which
    guarantees it) — ``reduceat`` over an empty segment would return
    the boundary element, not an identity.  ``scatter_max_2d`` below
    has no such restriction."""
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(num_groups))
    return np.maximum.reduceat(values[order], bounds, axis=0)


def scatter_max_2d(
    inverse: np.ndarray, num_groups: int, cols: np.ndarray, vals: np.ndarray, m: int
) -> np.ndarray:
    """out[g, cols[i]] = max(vals[i]) over rows with inverse[i] == g
    (one (group, col) cell per input row)."""
    if np.asarray(vals).size == 0:
        return np.zeros((num_groups, m), dtype=np.asarray(vals).dtype)
    keys = np.asarray(inverse, dtype=np.int64) * m + cols
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    vs = np.asarray(vals)[order]
    starts = np.nonzero(np.concatenate(([True], ks[1:] != ks[:-1])))[0]
    maxes = np.maximum.reduceat(vs, starts)
    uk = ks[starts]
    out = np.zeros((num_groups, m), dtype=vs.dtype)
    out[uk // m, uk % m] = maxes
    return out
