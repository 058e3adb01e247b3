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
MIN_CARD_PAD = 8

# Group-by dense-holder cap (reference caps ARRAY_BASED key space at 1M,
# DefaultGroupKeyGenerator.java): beyond this the host hash path runs,
# which is not part of this port yet.
MAX_GROUP_CAPACITY = 1 << 20


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
