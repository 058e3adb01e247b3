"""Engine-wide precision, device and sizing policy.

The JAX package reads its float and key widths off the process-global
``jax_enable_x64`` flag.  Here the precision is an explicit value that a
caller picks and the staged table carries (``StagedTable.precision``):

  "x64"  float64 aggregation, int64 group keys — the reference's Java
         ``double`` semantics; the CPU tests run this mode
  "x32"  float32 aggregation, int32 group keys — what the TPU served

The mode decides ``key_dtype`` and ``max_key_space``, and those decide
whether a plan runs on the device, so a comparison with the reference
must use the reference's mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

# Padding buckets: shapes are padded up so the set of distinct shapes
# stays small (the reference's analog is its fixed 10k/5k block sizes,
# DocIdSetPlanNode.java:33).
DOC_PAD_MULTIPLE = 1024
# rows per zone-map block (engine/zonemap.py): the reference's
# PINOT_TPU_ZONE_BLOCK default; segment files record the block they hold
ZONE_BLOCK = 1 << 16
# the block path engages while its padded window of candidate blocks is
# at most this share of the table (engine/executor._block_skip_ids)
ZONE_MAX_FRACTION = 0.5
MIN_CARD_PAD = 8

# The per-dispatch row budget: a table of more than this many rows (S x
# n_pad) runs as segment-axis chunks (``kernel.make_chunked_table_kernel``),
# which bounds the torch-op route's per-row temporaries ([S, n_pad] masks
# and int64 keys); 0 turns chunking off.  The reference's
# PINOT_TPU_CHUNK_ROWS default (pinot_tpu/engine/kernel.py:1081-1087).
CHUNK_ROWS = 1 << 28

# The lane's micro-batching tier (engine/dispatch.py): at most this many
# same-plan queries a batched launch (<= 1 turns the tier off), and the
# window that queued same-key demand holds open for more, in ms.  The
# reference's PINOT_TPU_BATCH_MAX / PINOT_TPU_BATCH_WINDOW_MS defaults
# (pinot_tpu/engine/dispatch.py:93-107).
BATCH_MAX = 16
BATCH_WINDOW_MS = 2.0

# Distributed joins (engine/join.py, broker/joinplan.py), the reference's
# environment defaults as constants that read no environment:
# PINOT_TPU_JOIN_DEVICE (False: every join takes the exact host join),
# PINOT_TPU_JOIN_GROUP_CAP (group spaces past it take the host join),
# PINOT_TPU_JOIN_BROADCAST_ROWS / _BYTES (a build side within both is
# broadcast, else shuffled), PINOT_TPU_JOIN_SPLIT and
# PINOT_TPU_JOIN_HEAVY_FACTOR (a shuffle key whose probe rows pass this
# share of the per-owner mean is split across owners and its build rows
# replicated).  pinot_tpu/engine/join.py:551-555, :600;
# pinot_tpu/broker/joinplan.py:146-169.
JOIN_DEVICE = True
JOIN_GROUP_CAP = 1 << 16
JOIN_BROADCAST_ROWS = 100_000
JOIN_BROADCAST_BYTES = 4 << 20
JOIN_SPLIT = True
JOIN_HEAVY_FACTOR = 0.5

# Group-by dense-holder cap (reference caps ARRAY_BASED key space at 1M,
# DefaultGroupKeyGenerator.java): beyond this the host tier's hash path
# runs (engine/host_fallback.py).
MAX_GROUP_CAPACITY = 1 << 20

# distinctcount / percentile dense state cap (global dictionary size).
MAX_VALUE_STATE = 1 << 22

# sort-dedup distinct path (StaticAgg.sort_pairs): most unique (group,
# valueId) pairs the device returns; past it the host tier finishes.
DISTINCT_PAIR_CAP = 1 << 22

HLL_LOG2M = 8  # HllConstants.java DEFAULT_LOG2M
HLL_M = 1 << HLL_LOG2M


@dataclass(frozen=True)
class Precision:
    mode: str  # "x64" | "x32"

    def __post_init__(self) -> None:
        if self.mode not in ("x64", "x32"):
            raise ValueError(f"precision mode must be 'x64' or 'x32', got {self.mode!r}")

    @property
    def x64(self) -> bool:
        return self.mode == "x64"

    @property
    def float_dtype(self) -> torch.dtype:
        return torch.float64 if self.x64 else torch.float32

    @property
    def np_float_dtype(self):
        return np.float64 if self.x64 else np.float32

    @property
    def key_dtype(self) -> torch.dtype:
        return torch.int64 if self.x64 else torch.int32

    @property
    def max_key_space(self) -> int:
        return 2**62 if self.x64 else 2**30


def as_precision(p: Union[str, Precision]) -> Precision:
    return p if isinstance(p, Precision) else Precision(p)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU.  With no CUDA and no explicit CPU request this raises — it never
    carries on quietly on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain torch path on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def pad_docs(n: int) -> int:
    """Round doc count up to the padding bucket (pow2 beyond one block)."""
    if n <= DOC_PAD_MULTIPLE:
        m = 8
        while m < n:
            m *= 2
        return m
    blocks = -(-n // DOC_PAD_MULTIPLE)
    b = 1
    while b < blocks:
        b *= 2
    return b * DOC_PAD_MULTIPLE


def pad_card(c: int) -> int:
    m = MIN_CARD_PAD
    while m < c:
        m *= 2
    return m


def pad_value_card(c: int) -> int:
    """Value-state holder padding: quarter-pow2 buckets (2048, 2560, ...)."""
    base = MIN_CARD_PAD
    while base * 2 <= c:
        base *= 2
    if base >= c:
        return base
    step = max(base // 4, MIN_CARD_PAD)
    return base + -(-(c - base) // step) * step


def raw_card_min(device: torch.device) -> int:
    """Agg-input feed policy: columns with cardinality above this stage a
    dictionary-decoded float ``raw`` array; at or below it the kernel
    reads ``dict[fwd]``.  0 on the card (every agg input streams raw),
    2^15 on the CPU — the same split the reference makes between its
    accelerator and its CPU backend (``pinot_tpu/engine/config.py:122``)."""
    return 0 if device.type == "cuda" else (1 << 15)


def index_dtype(max_exclusive: int):
    """np dtype for dictId arrays indexing tables of ``max_exclusive``
    rows.  torch cannot index with or add uint16, so where the reference
    stages uint16 this stages int16 (tables up to 32767 rows) or int32."""
    if max_exclusive <= 255:
        return np.uint8
    if max_exclusive <= 32767:
        return np.int16
    return np.int32


# per-doc count arrays (values <= bound) share the same width ladder
count_dtype = index_dtype
