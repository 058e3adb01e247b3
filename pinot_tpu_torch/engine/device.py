"""Device staging: immutable segments -> device-resident stacked tensors
(port of ``pinot_tpu.engine.device``: the base roles, the HLL streams and
the multi-value roles).

Layout (S = number of segments stacked on the leading axis):

  fwd        uint8/int16/int32 [S, n_pad]   SV dictId forward index
  mv         uint8/int16/int32 [S, n_pad, mv_pad]  MV dictIds (padded)
  mv_counts  uint8/int16       [S, n_pad]   per-doc MV entry count
  mv_raw     float             [S, n_pad, mv_pad]  decoded MV agg input
  dict_vals  float             [S, card_pad] numeric dictionary values
  raw        float             [S, n_pad]   dictionary-decoded agg input
  gfwd       uint8/int16/int32 [S, n_pad]   global-dictId forward index
  hll_bucket uint8             [S, n_pad]   HLL register index per row
  hll_rho    uint8             [S, n_pad]   HLL rank per row
  bsi        int32             [S, W, nw]   dictId bit-planes (bit-sliced tier)
  bsiv       int32             [S, Wv, nw]  value-offset bit-planes (fused SUM)
  num_docs   int32             [S]          true doc count per segment

Integer widths are the narrowest that hold the column's dictIds
(``config.index_dtype``): the scans are memory-bound, so a card-3
column costs 1 byte per row.  Validity is never stored: kernels derive
it from ``row < num_docs`` and MV entry validity from ``entry <
mv_counts``.  ``mv_pad`` is the pow2 bucket (``config.pad_card``) of the
longest row.  Each array is built once on the host in pinned memory and
moved with one host-to-device copy.

The bit-sliced tier's planes (``engine/bitsliced.py``) pack row r of plane
b at bit r % 32 of word r // 32 (``nw = ceil(n_pad / 32)`` words), encoded
on the host by ``packing.bitslice_encode``.  They are int32 on the card
where the reference stages uint32: torch shifts only signed words (no
``>>`` for uint32), and the bits are the same.  Like every other role they
can be attached to a table already staged (``get_staged``).
"""
from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, MutableMapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.hll import dictionary_tables
from pinot_tpu_torch.engine.packing import bit_width, bitslice_encode, integral_dictionary_values
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
    hll_bucket: Optional[torch.Tensor] = None
    hll_rho: Optional[torch.Tensor] = None
    mv_pad: int = 0
    mv: Optional[torch.Tensor] = None
    mv_counts: Optional[torch.Tensor] = None
    mv_raw: Optional[torch.Tensor] = None
    # bit-sliced tier planes: dictId planes for the bitwise filter and
    # min / max, value-offset planes (value - per-segment vmin) for SUM
    bsi: Optional[torch.Tensor] = None  # int32 [S, W, nw]
    bsiv: Optional[torch.Tensor] = None  # int32 [S, Wv, nw]
    bsi_width: int = 0
    bsiv_width: int = 0
    bsiv_min: Optional[Tuple[int, ...]] = None  # per-segment integer vmin

    @property
    def is_numeric(self) -> bool:
        return self.stored_type != DataType.STRING

    def tensors(self):
        return [
            t
            for t in (self.fwd, self.dict_vals, self.raw, self.gfwd, self.hll_bucket, self.hll_rho,
                      self.mv, self.mv_counts, self.mv_raw, self.bsi, self.bsiv)
            if t is not None
        ]


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
    zones: Dict[Any, Any] = field(default_factory=dict)  # host zone maps by (column, block): engine/zonemap

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


def _csr_scatter(values, offsets, out_row, *extra):
    """Fill one segment's padded [n_pad, mv_pad] block from CSR (values,
    offsets): entry j of doc i lands at [i, j], every entry in one masked
    store (a row-major bool mask lists the slots in CSR order).  ``extra``
    pairs of (values2, out_row2) fill through the same mask (mv ids and
    mv_raw share one offsets array).  Returns the per-doc counts."""
    counts = np.diff(offsets)
    keep = np.arange(out_row.shape[1]) < counts[:, None]
    lo, hi = int(offsets[0]), int(offsets[-1])
    out_row[: counts.size][keep] = values[lo:hi]
    for v2, o2 in zip(extra[::2], extra[1::2]):
        o2[: counts.size][keep] = v2[lo:hi]
    return counts


def stage_segments(
    segments: Sequence[ImmutableSegment],
    column_names: Sequence[str],
    device: torch.device,
    precision: Precision,
    raw_columns: Sequence[str] = (),
    gfwd_columns: Sequence[str] = (),
    ctx=None,
    skip_base_columns: Sequence[str] = (),
    hll_columns: Sequence[str] = (),
    bsi_columns: Sequence[str] = (),
    bsiv_columns: Sequence[str] = (),
) -> StagedTable:
    """Stack + pad + transfer the given columns.

    ``raw_columns`` (numeric) additionally stage dictionary-decoded value
    arrays (``mv_raw`` for an MV column); ``gfwd_columns`` (SV, requires
    ``ctx``) stage global-dictId forward arrays; ``hll_columns`` (SV)
    stage per-row HLL (register, rank) uint8 streams;
    ``skip_base_columns`` (SV) are read only through such a role array,
    so their ``fwd``/``dict_vals`` are not uploaded; ``bsi_columns`` /
    ``bsiv_columns`` (SV) stage the bit-sliced tier's planes
    (``attach_bsi``).  An MV column always stages ``mv`` and
    ``mv_counts``."""
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
        cards = tuple(c.dictionary.cardinality for c in cols)
        card_pad = config.pad_card(max(cards))
        sc = StagedColumn(
            name=name,
            stored_type=meta0.data_type.stored_type,
            single_value=meta0.single_value,
            card_pad=card_pad,
            cards=cards,
        )
        if not meta0.single_value:
            _stage_mv(sc, cols, S, n_pad, device, fdt, name in raw_columns)
            staged.columns[name] = sc
            continue
        skip_base = name in skip_base_columns
        if not skip_base:
            host = _host_zeros((S, n_pad), config.index_dtype(card_pad), device)
            h = host.numpy()
            for i, c in enumerate(cols):
                h[i, : c.fwd.size] = c.fwd
            sc.fwd = _put(host, device)
            if sc.is_numeric:
                sc.dict_vals = _put(_dict_vals(cols, S, card_pad, fdt, device), device)
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
        if name in hll_columns:
            hb, hr = _hll_streams(cols, S, n_pad, device)
            sc.hll_bucket = _put(hb, device)
            sc.hll_rho = _put(hr, device)
        staged.columns[name] = sc
    attach_bsi(staged, segments, bsi_columns, bsiv_columns)
    return staged


def _dict_vals(cols, S: int, card_pad: int, fdt, device: torch.device) -> torch.Tensor:
    host = _host_zeros((S, card_pad), fdt, device)
    h = host.numpy()
    for i, c in enumerate(cols):
        h[i, : c.dictionary.cardinality] = np.asarray(c.dictionary.values, dtype=fdt)
    return host


def _stage_mv(sc: StagedColumn, cols, S: int, n_pad: int, device: torch.device, fdt, want_raw: bool) -> None:
    """An MV column's roles: ``mv`` (local dictIds, zero padded), its
    per-doc ``mv_counts``, ``dict_vals`` (numeric) and, for a numeric
    ``raw_columns`` entry, the decoded ``mv_raw``."""
    mv_pad = config.pad_card(max(1, max(c.metadata.max_num_multi_values for c in cols)))
    mv = _host_zeros((S, n_pad, mv_pad), config.index_dtype(sc.card_pad), device)
    mvc = _host_zeros((S, n_pad), config.count_dtype(mv_pad), device)
    want_raw = want_raw and sc.is_numeric
    mvr = _host_zeros((S, n_pad, mv_pad), fdt, device) if want_raw else None
    m, c_host = mv.numpy(), mvc.numpy()
    r = mvr.numpy() if want_raw else None

    def fill(i: int) -> None:
        c = cols[i]
        if want_raw:
            vals = np.asarray(c.dictionary.values, dtype=fdt)
            counts = _csr_scatter(c.mv_values, c.mv_offsets, m[i], vals[c.mv_values], r[i])
        else:
            counts = _csr_scatter(c.mv_values, c.mv_offsets, m[i])
        c_host[i, : counts.size] = counts

    # numpy's masked stores release the GIL: one thread a segment
    with ThreadPoolExecutor(max(1, min(S, os.cpu_count() or 1))) as pool:
        list(pool.map(fill, range(S)))
    sc.mv_pad = mv_pad
    sc.mv = _put(mv, device)
    sc.mv_counts = _put(mvc, device)
    if want_raw:
        sc.mv_raw = _put(mvr, device)
    if sc.is_numeric:
        sc.dict_vals = _put(_dict_vals(cols, S, sc.card_pad, fdt, device), device)


def _hll_streams(cols, S: int, n_pad: int, device: torch.device):
    """Per-row HLL (register index, rank) uint8 streams, computed on the
    host per dictionary entry and fanned out through the forward index,
    so the kernel streams them instead of gathering per-dictId tables."""
    hb = _host_zeros((S, n_pad), np.uint8, device)
    hr = _host_zeros((S, n_pad), np.uint8, device)
    b, r = hb.numpy(), hr.numpy()
    for i, c in enumerate(cols):
        bt, rt = dictionary_tables(c.dictionary)
        b[i, : c.fwd.size] = bt[c.fwd]
        r[i, : c.fwd.size] = rt[c.fwd]
    return hb, hr


# ---------------------------------------------------------------------------
# Bit-sliced tier staging (engine/bitsliced.py; pinot_tpu/engine/device.py:
# 315-380 and its _augment_staged): the planes are built on the host with
# the packing encoder, stacked [S, W, nw] and attached as role arrays.
# ---------------------------------------------------------------------------


def bsi_filter_width(cols) -> int:
    """Uniform dictId plane count across segments: enough planes for the
    widest per-segment dictionary."""
    return max(bit_width(max(c.dictionary.cardinality - 1, 0)) for c in cols)


def bsiv_value_spec(cols) -> "Optional[Tuple[int, Tuple[int, ...]]]":
    """(plane count, per-segment integer vmin) for value-offset planes, or
    None when any segment's dictionary is not exactly integral: a fused
    SUM is offered only where it is bit-exact against the scan tier."""
    vmins = []
    width = 1
    for c in cols:
        iv = integral_dictionary_values(c.dictionary.values)
        if iv is None:
            return None
        vmin, vmax = int(iv.min()), int(iv.max())
        vmins.append(vmin)
        width = max(width, bit_width(vmax - vmin))
    if width > 32:
        return None
    return width, tuple(vmins)


def _plane_words(n_pad: int) -> int:
    # round up: a segment smaller than one 32-row word still needs a word
    return max(1, (n_pad + 31) // 32)


def _encode_planes(rows, S: int, n_pad: int, width: int, device: torch.device) -> torch.Tensor:
    """int32 [S, width, nw] planes of S per-segment value arrays (a
    callable ``rows(i)`` each), encoded a segment a thread (numpy's bit
    packing releases the GIL) into one pinned host buffer."""
    nw = _plane_words(n_pad)
    host = _host_zeros((S, width, nw), np.int32, device)
    h = host.numpy()

    def fill(i: int) -> None:
        h[i] = bitslice_encode(rows(i), width, nw).view(np.int32)

    with ThreadPoolExecutor(max(1, min(S, os.cpu_count() or 1))) as pool:
        list(pool.map(fill, range(S)))
    return host


def _bsi_planes(cols, S: int, n_pad: int, width: int, device: torch.device) -> torch.Tensor:
    return _encode_planes(lambda i: np.asarray(cols[i].fwd), S, n_pad, width, device)


def _bsiv_planes(cols, S: int, n_pad: int, width: int, vmins: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    def rows(i: int) -> np.ndarray:
        iv = integral_dictionary_values(cols[i].dictionary.values)
        return iv[cols[i].fwd] - vmins[i]

    return _encode_planes(rows, S, n_pad, width, device)


def attach_bsi(
    staged: StagedTable,
    segments: Sequence[ImmutableSegment],
    bsi_columns: Sequence[str] = (),
    bsiv_columns: Sequence[str] = (),
) -> int:
    """Attach the bit-sliced planes a staged table lacks: dictId planes for
    each SV column of ``bsi_columns``, value-offset planes for each
    numeric SV column of ``bsiv_columns`` whose dictionaries are integral.
    Returns the bytes attached (they count in ``StagedTable.nbytes``)."""
    S, n_pad, device = staged.num_segments, staged.n_pad, staged.device
    attached = 0
    for name in bsi_columns:
        sc = staged.columns.get(name)
        if sc is None or sc.bsi is not None or not sc.single_value:
            continue
        cols = [seg.column(name) for seg in segments]
        width = bsi_filter_width(cols)
        planes = _put(_bsi_planes(cols, S, n_pad, width, device), device)
        # the width first: a reader guards on the planes
        sc.bsi_width = width
        sc.bsi = planes
        attached += planes.numel() * 4
    for name in bsiv_columns:
        sc = staged.columns.get(name)
        if sc is None or sc.bsiv is not None or not sc.single_value or not sc.is_numeric:
            continue
        cols = [seg.column(name) for seg in segments]
        spec = bsiv_value_spec(cols)
        if spec is None:
            continue
        width, vmins = spec
        planes = _put(_bsiv_planes(cols, S, n_pad, width, vmins, device), device)
        sc.bsiv_width, sc.bsiv_min = width, vmins
        sc.bsiv = planes
        attached += planes.numel() * 4
    return attached


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
    hll_columns: Sequence[str] = (),
    bsi_columns: Sequence[str] = (),
    bsiv_columns: Sequence[str] = (),
) -> StagedTable:
    """Staging cached in the caller's ``cache`` by segment set, column
    set, role sets, device and precision: segments are immutable, so a
    staged table is reusable for every later query that needs it.  The
    bit-sliced planes (``bsi_columns`` / ``bsiv_columns``) are not part of
    the key: a cached table that lacks them gets them attached."""
    key = (
        tuple((s.segment_name, s.metadata.crc, s.staging_token) for s in segments),
        tuple(sorted(column_names)),
        tuple(sorted(raw_columns)),
        tuple(sorted(gfwd_columns)),
        tuple(sorted(skip_base_columns)),
        tuple(sorted(hll_columns)),
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
            hll_columns=hll_columns,
            bsi_columns=bsi_columns,
            bsiv_columns=bsiv_columns,
        )
        cache[key] = st
    elif bsi_columns or bsiv_columns:
        attach_bsi(st, segments, bsi_columns, bsiv_columns)
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


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict / list / tuple tree, in order."""
    return _leaves(tree, [])


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
        if col.mv is not None:
            arrays[f"{name}.mv"] = col.mv
            arrays[f"{name}.mvc"] = col.mv_counts
        if col.mv_raw is not None:
            arrays[f"{name}.mvraw"] = col.mv_raw
        if col.dict_vals is not None:
            arrays[f"{name}.dict"] = col.dict_vals
        if col.raw is not None:
            arrays[f"{name}.raw"] = col.raw
        if col.gfwd is not None:
            arrays[f"{name}.gfwd"] = col.gfwd
        if col.hll_bucket is not None:
            arrays[f"{name}.hllb"] = col.hll_bucket
            arrays[f"{name}.hllr"] = col.hll_rho
    arrays["num_docs"] = staged.num_docs_arr
    return arrays
