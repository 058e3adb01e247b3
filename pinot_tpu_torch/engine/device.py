"""Device staging: immutable segments -> device-resident stacked tensors
(port of ``pinot_tpu.engine.device``, base roles only).

Layout (S = number of segments stacked on the leading axis):

  fwd        uint8/int16/int32 [S, n_pad]   SV dictId forward index
  dict_vals  float             [S, card_pad] numeric dictionary values
  raw        float             [S, n_pad]   dictionary-decoded agg input
  gfwd       uint8/int16/int32 [S, n_pad]   global-dictId forward index
  num_docs   int32             [S]          true doc count per segment

Integer widths are the narrowest that hold the column's dictIds
(``config.index_dtype``): the scans are memory-bound, so a card-3
column costs 1 byte per row.  Validity is never stored: kernels derive
it from ``row < num_docs``.  Each array is built once on the host in
pinned memory and moved with one host-to-device copy.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, MutableMapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.segment.immutable import ImmutableSegment


@dataclass
class StagedColumn:
    name: str
    stored_type: DataType
    single_value: bool
    card_pad: int
    cards: Tuple[int, ...]  # per-segment true cardinality
    fwd: Optional[torch.Tensor] = None
    dict_vals: Optional[torch.Tensor] = None
    raw: Optional[torch.Tensor] = None
    gfwd: Optional[torch.Tensor] = None

    @property
    def is_numeric(self) -> bool:
        return self.stored_type != DataType.STRING

    def tensors(self):
        return [t for t in (self.fwd, self.dict_vals, self.raw, self.gfwd) if t is not None]


_stage_tokens = itertools.count()


@dataclass
class StagedTable:
    """A set of segments staged on one device, stacked on axis 0."""

    segment_names: Tuple[str, ...]
    num_segments: int
    n_pad: int
    num_docs: Tuple[int, ...]
    num_docs_arr: torch.Tensor  # int32 [S]
    device: torch.device
    precision: Precision
    columns: Dict[str, StagedColumn] = field(default_factory=dict)
    token: int = field(default_factory=lambda: next(_stage_tokens))

    def column(self, name: str) -> StagedColumn:
        return self.columns[name]

    @property
    def total_docs(self) -> int:
        return int(sum(self.num_docs))

    def nbytes(self) -> int:
        """Bytes this table holds on its device."""
        n = self.num_docs_arr.numel() * self.num_docs_arr.element_size()
        for c in self.columns.values():
            n += sum(t.numel() * t.element_size() for t in c.tensors())
        return int(n)


def _host_zeros(shape: Tuple[int, ...], np_dtype, device: torch.device) -> torch.Tensor:
    """Zeroed host staging buffer: pinned when the target is a CUDA device
    so the upload is one asynchronous DMA from it."""
    t = torch.from_numpy(np.zeros(0, dtype=np_dtype))
    return torch.zeros(shape, dtype=t.dtype, pin_memory=device.type == "cuda")


def _put(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def stage_segments(
    segments: Sequence[ImmutableSegment],
    column_names: Sequence[str],
    device: torch.device,
    precision: Precision,
    raw_columns: Sequence[str] = (),
    gfwd_columns: Sequence[str] = (),
    ctx=None,
    skip_base_columns: Sequence[str] = (),
) -> StagedTable:
    """Stack + pad + transfer the given single-value columns.

    ``raw_columns`` (numeric) additionally stage dictionary-decoded value
    arrays; ``gfwd_columns`` (requires ``ctx``) stage global-dictId
    forward arrays; ``skip_base_columns`` are read only through such a
    role array, so their ``fwd``/``dict_vals`` are not uploaded."""
    S = len(segments)
    n_pad = config.pad_docs(max(seg.num_docs for seg in segments))
    num_docs = torch.tensor([s.num_docs for s in segments], dtype=torch.int32)
    staged = StagedTable(
        segment_names=tuple(s.segment_name for s in segments),
        num_segments=S,
        n_pad=n_pad,
        num_docs=tuple(s.num_docs for s in segments),
        num_docs_arr=num_docs.to(device),
        device=device,
        precision=precision,
    )
    fdt = precision.np_float_dtype
    for name in column_names:
        cols = [seg.column(name) for seg in segments]
        meta0 = cols[0].metadata
        if not meta0.single_value:
            raise NotImplementedError(
                f"multi-value column {name!r}: MV staging is a later slice of the port"
            )
        cards = tuple(c.dictionary.cardinality for c in cols)
        card_pad = config.pad_card(max(cards))
        sc = StagedColumn(
            name=name,
            stored_type=meta0.data_type.stored_type,
            single_value=True,
            card_pad=card_pad,
            cards=cards,
        )
        skip_base = name in skip_base_columns
        if not skip_base:
            host = _host_zeros((S, n_pad), config.index_dtype(card_pad), device)
            h = host.numpy()
            for i, c in enumerate(cols):
                h[i, : c.fwd.size] = c.fwd
            sc.fwd = _put(host, device)
            if sc.is_numeric:
                host = _host_zeros((S, card_pad), fdt, device)
                h = host.numpy()
                for i, c in enumerate(cols):
                    h[i, : c.dictionary.cardinality] = np.asarray(c.dictionary.values, dtype=fdt)
                sc.dict_vals = _put(host, device)
        if name in raw_columns and sc.is_numeric:
            host = _host_zeros((S, n_pad), fdt, device)
            h = host.numpy()
            for i, c in enumerate(cols):
                vals = np.asarray(c.dictionary.values, dtype=fdt)
                h[i, : c.fwd.size] = vals[c.fwd]
            sc.raw = _put(host, device)
        if name in gfwd_columns and ctx is not None:
            gcol = ctx.column(name)
            host = _host_zeros(
                (S, n_pad), config.index_dtype(config.pad_card(gcol.global_cardinality)), device
            )
            h = host.numpy()
            for i, c in enumerate(cols):
                h[i, : c.fwd.size] = gcol.remaps[i][c.fwd]
            sc.gfwd = _put(host, device)
        staged.columns[name] = sc
    return staged


def get_staged(
    cache: MutableMapping[Tuple, StagedTable],
    segments: Sequence[ImmutableSegment],
    column_names: Sequence[str],
    device: torch.device,
    precision: Precision,
    raw_columns: Sequence[str] = (),
    gfwd_columns: Sequence[str] = (),
    ctx=None,
    skip_base_columns: Sequence[str] = (),
) -> StagedTable:
    """Staging cached in the caller's ``cache`` by segment set, column
    set, role sets, device and precision: segments are immutable, so a
    staged table is reusable for every later query that needs it."""
    key = (
        tuple((s.segment_name, s.metadata.crc, s.staging_token) for s in segments),
        tuple(sorted(column_names)),
        tuple(sorted(raw_columns)),
        tuple(sorted(gfwd_columns)),
        tuple(sorted(skip_base_columns)),
        str(device),
        precision.mode,
    )
    st = cache.get(key)
    if st is None:
        st = stage_segments(
            segments,
            sorted(column_names),
            device,
            precision,
            raw_columns=raw_columns,
            gfwd_columns=gfwd_columns,
            ctx=ctx,
            skip_base_columns=skip_base_columns,
        )
        cache[key] = st
    return st


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def to_device_inputs(tree: Any, device: torch.device) -> Any:
    """Numpy query inputs (nested dicts/lists of arrays) -> tensors on
    ``device``.  Every array rides ONE host-to-device copy: the leaves are
    packed into one pinned byte buffer (8-byte aligned parts) and viewed
    back out of the device copy."""
    leaves = [np.ascontiguousarray(a) for a in _leaves(tree, [])]
    if device.type == "cpu":
        return _rebuild(tree, iter(torch.from_numpy(a.copy()) for a in leaves))
    offs = []
    total = 0
    for a in leaves:
        offs.append(total)
        total += a.nbytes + (-a.nbytes) % 8
    host = torch.empty(max(total, 8), dtype=torch.uint8, pin_memory=True)
    h = host.numpy()
    for a, off in zip(leaves, offs):
        h[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    out = []
    for a, off in zip(leaves, offs):
        dt = torch.from_numpy(np.zeros(0, dtype=a.dtype)).dtype
        out.append(dev[off : off + a.nbytes].view(dt).reshape(a.shape))
    return _rebuild(tree, iter(out))


def segment_arrays(staged: StagedTable, needed) -> Dict[str, torch.Tensor]:
    """The kernel's ``seg`` dict for the given columns: per-role arrays
    keyed ``<column>.<role>`` plus ``num_docs``."""
    arrays: Dict[str, torch.Tensor] = {}
    for name in needed:
        col = staged.columns.get(name)
        if col is None:
            continue
        if col.fwd is not None:
            arrays[f"{name}.fwd"] = col.fwd
        if col.dict_vals is not None:
            arrays[f"{name}.dict"] = col.dict_vals
        if col.raw is not None:
            arrays[f"{name}.raw"] = col.raw
        if col.gfwd is not None:
            arrays[f"{name}.gfwd"] = col.gfwd
    arrays["num_docs"] = staged.num_docs_arr
    return arrays
