"""Per-tier filter cost model: the crossover constants that pick between
the four filter tiers, and the residency manager's reload cost (port of
``pinot_tpu.engine.tiercost``).

The tiers (engine/invindex_path.py, engine/bitsliced.py, the zone-map
blocks of engine/zonemap.py, the full scan of engine/kernel.py) each win a
region of the (selectivity, layout) plane.  The constants are
``engine/config.py``'s (``POSTINGS_MATCH_FRACTION``, ``SCAN_NS_PER_ROW``,
...), read at each call so a caller can move them; their defaults are the
reference's, which came from the reference's own calibration and not from
the card.  The port keeps them so that it routes every query to the tier
the reference picks; the defaults floor the postings bound to exactly
``total_docs // 64`` (a power-of-two reciprocal is exact in floating
point).
"""
from __future__ import annotations

from pinot_tpu_torch.engine import config


def postings_max_matches(total_docs: int) -> int:
    """Postings / scan crossover in rows (invindex_path._max_matches)."""
    return int(total_docs * config.POSTINGS_MATCH_FRACTION)


def scan_cost_ns(total_docs: int) -> float:
    """Full device scan: per-row stream cost + the dispatch floor."""
    return total_docs * config.SCAN_NS_PER_ROW + config.DISPATCH_FLOOR_NS


def postings_cost_ns(matches: int) -> float:
    return matches * config.POSTINGS_NS_PER_ROW


def bitsliced_cost_ns(total_docs: int, planes: int) -> float:
    """Bit-sliced pass over ``planes`` packed bit-planes of the table."""
    return total_docs * planes * config.BSI_NS_PER_ROW_PER_PLANE + config.DISPATCH_FLOOR_NS


def bsi_max_planes() -> int:
    return int(config.BSI_MAX_PLANES)


def h2d_cost_ns(nbytes: int) -> float:
    """Cost of re-promoting ``nbytes`` from the host to the device: the
    reload half of the residency heat score (engine/residency.py)."""
    return nbytes * config.H2D_NS_PER_BYTE + config.DISPATCH_FLOOR_NS


def residency_halflife_s() -> float:
    """Heat-decay halflife for the residency victim choice."""
    return float(config.RESIDENCY_HALFLIFE_S)
