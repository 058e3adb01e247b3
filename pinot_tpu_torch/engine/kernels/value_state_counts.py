"""Value-state holders (occupancy counts, presence bits, HLL registers):
the CUDA kernel's wrapper and its plain torch version.

Replaces the TPU kernel ``_value_state_counts_pallas``
(``pinot_tpu/engine/kernel.py:130``) with
``pinot_tpu_torch/csrc/value_state_counts.cu``; that file's header says
what bounds the kernel on the card (memory) and what its design does
about it.

The TPU kernel counts an int32 index that jnp ops combined beforehand.
``value_state`` combines that index inside the kernel from the streams
the table kernel has staged, over a leading segment axis:

  mask  = filter(s, i) & (i < num_docs[s])
  slot  = mixed radix of the group columns (0 with none), as K1 combines it
  idx   = slot * width + v                      counts, presence
          (slot * HLL_M + bucket) * 64 + rho    registers
  holder, from the occupancy counts of idx over the masked rows
  (indexes outside [0, K) drop):
    counts     int64 [K]                          K = capacity * width
    presence   int32 [K], 1 where the count > 0
    registers  uint8 [capacity * HLL_M], the largest rho counted per
               (slot, bucket); K = capacity * HLL_M * 64

The filter takes K1's forms (``fused_groupby``): ``filter_fwd`` +
``match`` (a match table over dictIds, also the evaluated ``[S, n_pad]``
mask viewed as uint8 with the table [False, True]), ``filter_fwd`` +
``filter_bounds`` (a dictId interval), ``filter_bounds`` alone (docrange),
or none (every valid row).  The group key is K1's ``group_cols`` /
``group_cards`` / ``group_remaps``.  The value is

  counts, presence  ``values``: the global-id stream, or a local fwd
                    stream read through the per-segment remap table
                    ``value_table``
  registers         ``values`` + ``rho``: the per-row uint8 (bucket, rho)
                    streams; or ``values`` = the fwd stream read through
                    the per-dictId ``value_table`` (buckets) and
                    ``rho_table``

A remap- or table-fed row whose id is outside its table drops.  The
matched-doc total (int64) comes back beside the holder.  ``block_ids`` /
``block_rows`` restrict it to the rows of candidate zone blocks, as in
``fused_groupby``.

``value_state_counts(flat_idx, K)`` is the precombined form, the TPU
kernel's own contract: int64 occupancy counts of an int32 stream of any
shape, entries outside ``[0, K)`` dropped.  Counts are int64 where the TPU
kernel returns floats: exact at any count.

How the kernel holds its state is its tier, chosen from the mode and K
(``choose_tier``; ``tier=`` forces one, for measurement):
  byte     presence, registers: a byte per index in shared memory, set by
           plain stores (registers: the largest rho set per register is
           found when the block flushes)
  block    one int32 histogram, bitmap or register file per block in
           shared memory
  global   the holder in device memory

On CUDA tensors the wrappers launch the kernel (or raise); on CPU tensors
they run ``value_state_reference`` / ``value_state_counts_reference``.
``launches`` counts kernel launches only.

``value_state_batched`` serves ``members`` queries of one plan in one
launch (the lane's micro-batching tier): the row streams are shared,
while ``match``, ``filter_bounds``, each of ``group_remaps``,
``value_table`` and ``rho_table`` may lead with a ``[members]`` axis (each
member its own) or not (one shared by all).  It returns the matched-doc
totals [B] and the holders [B, ...]; member m's equal a launch of member m
alone (the same tier and grid partition per member, integer holders).
Its plain version loops over the one-member plain version.
``batched_launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from pinot_tpu_torch.engine.kernels import fused_groupby

MODES = ("counts", "presence", "registers")
TIERS = ("block", "global", "byte")  # the kernel's Tier codes, in order
MODE_TIERS = {
    "counts": ("block", "global"),
    "presence": ("byte", "block", "global"),
    "registers": ("byte", "block", "global"),
}
HLL_M = 256  # registers per slot (engine/config.py HLL_M)
RHO = 64  # rho lanes per register
MAX_GROUP_COLUMNS = fused_groupby.MAX_GROUP_COLUMNS
MAX_TABLE_CARD = fused_groupby.MAX_TABLE_CARD  # match tables, as K1
# H100 opt-in shared memory per block (232448 B) less what the kernel's
# static arrays take (about 1.1 KB); the launch rechecks the device
SHARED_BYTES_LIMIT = 232448 - 2048
# the byte tier (presence, registers) while its map leaves room for four
# resident blocks per SM
BYTE_MAP_BYTES = 49152
TABLE_SHARED_BYTES = 16384  # lookup tables up to this many bytes sit in shared memory
MAX_K = (1 << 31) - 2  # the combined index is an unsigned 32-bit value below K

_INDEX_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_TABLES = MAX_GROUP_COLUMNS + 2  # group remaps, value table, rho table

launches = 0  # kernel launches on CUDA tensors; chip_smoke.py resets and reads it
batched_launches = 0  # launches of the batched wrapper on CUDA tensors
_launches_lock = threading.Lock()  # lanes of two servers launch at once


def index_space(mode: str, capacity: int, width: Optional[int]) -> int:
    """K, the size of the combined index space."""
    return capacity * HLL_M * RHO if mode == "registers" else capacity * int(width)


def state_bytes(mode: str, tier: str, K: int) -> int:
    """Shared memory of one block's holder in ``tier``."""
    if tier == "global":
        return 0
    if tier == "byte":
        return 4 * (-(-K // 4))
    if mode == "counts":
        return 4 * K
    if mode == "presence":
        return 4 * (-(-K // 32))
    return 4 * (K // RHO)


def shared_bytes(mode: str, tier: str, K: int, table_bytes: int = 0, match_card: int = 0) -> int:
    """Dynamic shared memory one block takes, in the kernel's layout:
    the lookup tables (``table_bytes``, 0 when they stay in device
    memory), the holder, the match table."""
    return table_bytes + state_bytes(mode, tier, K) + match_card


def tier_fits(mode: str, tier: str, K: int, table_bytes: int = 0, match_card: int = 0) -> bool:
    return tier in MODE_TIERS[mode] and shared_bytes(mode, tier, K, table_bytes, match_card) <= SHARED_BYTES_LIMIT


def choose_tier(mode: str, K: int, table_bytes: int = 0, match_card: int = 0) -> str:
    """byte while the byte map is small (presence, registers), else block
    while the holder fits one block's shared memory, else global."""
    if mode != "counts" and shared_bytes(mode, "byte", K, table_bytes, match_card) <= BYTE_MAP_BYTES:
        return "byte"
    return "block" if tier_fits(mode, "block", K, table_bytes, match_card) else "global"


def shared_table_bytes(tables: Sequence[Optional[torch.Tensor]]) -> int:
    """Bytes the lookup tables take in shared memory: all of them while
    they fit ``TABLE_SHARED_BYTES``, else none (read from device memory)."""
    total = sum(4 * t.shape[-1] for t in tables if t is not None)
    return total if total <= TABLE_SHARED_BYTES else 0


def holder_from_counts(mode: str, counts: torch.Tensor) -> torch.Tensor:
    """The holder from int64 occupancy counts [K]: the counts, presence
    bits, or per register the largest rho counted."""
    if mode == "counts":
        return counts
    if mode == "presence":
        return (counts > 0).to(torch.int32)
    rho = torch.arange(RHO, device=counts.device)
    return torch.where(counts.view(-1, RHO) > 0, rho, 0).amax(dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------


def _filter_mask(num_docs, n_pad, filter_fwd, match, filter_bounds, rows=None) -> torch.Tensor:
    """``rows``: the doc id of each row (gathered blocks), else 0..n_pad."""
    if rows is None:
        rows = torch.arange(n_pad, device=num_docs.device)[None, :]
    mask = rows < num_docs[:, None]
    if match is not None:
        m = match.to(torch.bool)
        f = filter_fwd.long()
        ok = (f >= 0) & (f < m.shape[-1])
        mask = mask & ok & torch.gather(m, 1, f.clamp(0, m.shape[-1] - 1))
    elif filter_fwd is not None:
        f = filter_fwd.to(torch.int32)
        mask = mask & (f >= filter_bounds[:, 0:1]) & (f < filter_bounds[:, 1:2])
    elif filter_bounds is not None:
        mask = mask & (rows >= filter_bounds[:, 0:1]) & (rows < filter_bounds[:, 1:2])
    return mask


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table[ids], ids inside the table) per row; rows outside read 0."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < table.shape[-1])
    return torch.gather(table, 1, ids.clamp(0, table.shape[-1] - 1)).long(), ok


def combine_index(
    mode: str,
    num_docs: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int = 1,
    width: Optional[int] = None,
    value_table: Optional[torch.Tensor] = None,
    rho: Optional[torch.Tensor] = None,
    rho_table: Optional[torch.Tensor] = None,
    filter_fwd: Optional[torch.Tensor] = None,
    match: Optional[torch.Tensor] = None,
    filter_bounds: Optional[torch.Tensor] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
    block_ids: Optional[torch.Tensor] = None,
    block_rows: int = 0,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """The combine with torch ops: (int32 index [S, n_pad] with the
    sentinel K on dropped rows, K, matched-doc total int64).  Its counts
    are what ``value_state_counts`` / the TPU kernel count.  ``tier`` is
    the kernel's and changes nothing here.  With ``block_ids`` every row
    stream is gathered to the candidate blocks' rows first (the index is
    then [S, nb_pad * block_rows])."""
    K = index_space(mode, capacity, width)
    rows = None
    if block_ids is not None:
        rowid, live = fused_groupby.candidate_rows(block_ids, block_rows)

        def take(t):
            return None if t is None else torch.gather(t, 1, rowid)

        values, rho, filter_fwd = take(values), take(rho), take(filter_fwd)
        group_cols = None if group_cols is None else [take(g) for g in group_cols]
        rows = torch.where(live, rowid, torch.iinfo(torch.int64).max)  # dead rows fail row < num_docs
    S, n_pad = values.shape
    mask = _filter_mask(num_docs, n_pad, filter_fwd, match, filter_bounds, rows)
    docs = mask.sum(dtype=torch.int64)
    slot = torch.zeros((S, n_pad), dtype=torch.int64, device=values.device)
    for c, g in enumerate(group_cols or ()):
        r = group_remaps[c] if group_remaps is not None else None
        if r is not None:
            g, ok = _lookup(r, g)
            mask = mask & ok
        slot = slot * int(group_cards[c]) + g.long()
    if mode == "registers":
        if rho is not None:
            b, r = values.long(), rho.long()
        else:
            b, ok = _lookup(value_table, values)
            r, _ = _lookup(rho_table, values)
            mask = mask & ok
        idx = (slot * HLL_M + b) * RHO + r
    else:
        v = values.long()
        if value_table is not None:
            v, ok = _lookup(value_table, values)
            mask = mask & ok
        idx = slot * int(width) + v
    keep = mask & (idx >= 0) & (idx < K)
    return torch.where(keep, idx, K).to(torch.int32), K, docs


def value_state_counts_reference(flat_idx: torch.Tensor, K: int) -> torch.Tensor:
    """Plain torch version of the precombined form: every in-range index
    adds one to its bin, the rest to a spare bin that is sliced off."""
    idx = flat_idx.reshape(-1).long()
    ok = (idx >= 0) & (idx < K)
    counts = torch.zeros(K + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, torch.where(ok, idx, K), torch.ones_like(idx))
    return counts[:K]


def value_state_reference(mode: str, num_docs: torch.Tensor, values: torch.Tensor, **kw):
    """Plain torch version of ``value_state``: the torch-op combine, the
    occupancy counts, the holder from the counts."""
    idx, K, docs = combine_index(mode, num_docs, values, **kw)
    return docs, holder_from_counts(mode, value_state_counts_reference(idx, K))


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def _validate(mode, num_docs, values, capacity, width, value_table, rho, rho_table, filter_fwd, match,
              filter_bounds, group_cols, group_cards, group_remaps, tier, block_ids=None,
              block_rows=0) -> int:
    """The shape, dtype, device and layout contract; returns K."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    if match is not None and filter_fwd is None:
        raise ValueError("a match table needs filter_fwd")
    if match is not None and filter_bounds is not None:
        raise ValueError("at most one of match / filter_bounds")
    if filter_fwd is not None and match is None and filter_bounds is None:
        raise ValueError("filter_fwd needs a match table or filter_bounds")
    if match is not None and match.shape[-1] > MAX_TABLE_CARD:
        raise ValueError(f"match table card {match.shape[-1]} > {MAX_TABLE_CARD}")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    if mode == "registers":
        if width is not None:
            raise ValueError("registers take no width (HLL_M registers a slot)")
        if (rho is None) == (rho_table is None) or (rho_table is not None) != (value_table is not None):
            raise ValueError("registers need a rho stream, or value_table and rho_table")
    else:
        if width is None or width < 1:
            raise ValueError("counts and presence need width >= 1")
        if rho is not None or rho_table is not None:
            raise ValueError("rho streams and tables are for registers")
    K = index_space(mode, capacity, width)
    if K > MAX_K:
        raise ValueError(f"index space {K} > {MAX_K}")
    if tier is not None and tier not in MODE_TIERS[mode]:
        raise ValueError(f"tier {tier!r} is not a tier of {mode}: {MODE_TIERS[mode]}")
    ng = len(group_cols) if group_cols is not None else 0
    remaps = list(group_remaps) if group_remaps is not None else [None] * ng
    if ng > MAX_GROUP_COLUMNS:
        raise ValueError(f"{ng} group columns: the kernel takes up to {MAX_GROUP_COLUMNS}")
    if ng and (group_cards is None or len(group_cards) != ng or len(remaps) != ng):
        raise ValueError("group_cols, group_cards and group_remaps must have one entry per column")
    if ng and any(int(c) < 1 for c in group_cards):
        raise ValueError("group_cards must be >= 1")
    if values.dim() != 2:
        raise ValueError("values must be [S, n_pad]")
    S, n_pad = values.shape
    if n_pad > fused_groupby.MAX_ROWS:
        raise ValueError(f"{n_pad} rows a segment: the int32 num_docs bounds at most {fused_groupby.MAX_ROWS}")
    dev = values.device

    def check(t, name, dtypes, shape, table=False):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the values on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
        if tuple(t.shape[: len(shape)]) != shape or t.dim() != len(shape) + table:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    check(values, "values", tuple(_INDEX_CODES), (S, n_pad))
    check(num_docs, "num_docs", (torch.int32,), (S,))
    fused_groupby.check_blocks(block_ids, block_rows, S, n_pad, dev)
    if rho is not None:
        check(rho, "rho", (torch.uint8,), (S, n_pad))
    for t, name in ((value_table, "value_table"), (rho_table, "rho_table")):
        if t is not None:
            check(t, name, (torch.int32,), (S,), table=True)
    if rho_table is not None and rho_table.shape != value_table.shape:
        raise ValueError("value_table and rho_table must have one shape")
    for g, r in zip(group_cols or (), remaps):
        check(g, "group column", tuple(_INDEX_CODES), (S, n_pad))
        if r is not None:
            check(r, "group remap", (torch.int32,), (S,), table=True)
    if filter_fwd is not None:
        check(filter_fwd, "filter_fwd", tuple(_INDEX_CODES), (S, n_pad))
    if filter_bounds is not None:
        check(filter_bounds, "filter_bounds", (torch.int32,), (S, 2))
    if match is not None:
        check(match, "match", (torch.bool, torch.uint8), (S,), table=True)
    return K


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------

# resident blocks per SM by device, kernel and shared memory (the grid is
# derived from it at each launch: a cache keyed on the shape would grow
# with every watermark of a consuming segment, whose n_pad moves)
_occupancy: Dict[tuple, int] = {}


def _library(blocks: bool):
    """The full-scan library, or with ``blocks`` the block-table one (two
    builds of ``csrc/value_state_counts.cu``)."""
    from pinot_tpu_torch.engine import kernels

    lib = kernels.load("value_state_counts_blocks" if blocks else "value_state_counts")
    fn = lib.value_state_launch
    if fn.argtypes is None:
        vp, ci, ll, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        fn.argtypes = [
            ci, ci, ci, ci, ci, ll, ll, ctypes.POINTER(ll), ll,
            vp, vp, vp, ci, vp, ci, ll, ci, pv, pi, pi, vp, ci, vp,
            pv, pi, ci, cu, cu, vp, ci, ll, ci, vp, vp, vp, vp, ll, vp, ll, vp,
        ]
        fn.restype = ci
        occ = lib.value_state_blocks_per_sm
        occ.argtypes = [ci, ci, ci, ci, ll]
        occ.restype = ci
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(mode, num_docs, values, K, *, capacity, width, value_table, rho, rho_table, filter_fwd,
            match, filter_bounds, group_cols, group_cards, group_remaps, tier, block_ids=None,
            block_rows=0, members=1):
    """One launch for ``members`` queries (1: the one-member kernel): the
    matched-doc totals [members] and holders [members, ...]."""
    global launches, batched_launches
    S, n_pad = values.shape
    dev = values.device
    ng = len(group_cols) if group_cols is not None else 0
    remaps = list(group_remaps) if group_remaps is not None else [None] * ng
    tables = remaps + [None] * (MAX_GROUP_COLUMNS - ng) + [value_table, rho_table]
    table_bytes = shared_table_bytes(tables)
    mcard = match.shape[-1] if match is not None else 0
    if tier is None:
        tier = choose_tier(mode, K, table_bytes, mcard)
    elif not tier_fits(mode, tier, K, table_bytes, mcard):
        raise ValueError(f"tier {tier!r} does not take this shape")
    smem = shared_bytes(mode, tier, K, table_bytes, mcard)
    kind, fcode = fused_groupby._filter_codes(filter_fwd, match)
    match_u8 = match.view(torch.uint8) if match is not None and match.dtype == torch.bool else match
    mcode, tcode = MODES.index(mode), TIERS.index(tier)
    lib = _library(block_ids is not None)
    with torch.cuda.device(dev):
        # with a block table each entry is a segment of ``block_rows`` rows
        nb_pad = 0 if block_ids is None else block_ids.shape[1]
        segs, rows = (S * nb_pad, block_rows) if nb_pad else (S, n_pad)
        okey = (dev.index, mcode, tcode, kind, fcode, nb_pad > 0, smem)
        per_sm = _occupancy.get(okey)
        if per_sm is None:
            per_sm = lib.value_state_blocks_per_sm(mcode, tcode, kind, fcode, smem)
            if per_sm < 1:
                raise RuntimeError(f"value_state occupancy query failed with code {per_sm}")
            _occupancy[okey] = per_sm
        bps = fused_groupby.blocks_per_segment(segs, rows, dev, per_sm)
        # one buffer, which the launch zeroes: per member the matched-doc
        # total, then the device holder (int64 counts, presence bits or
        # int32 registers)
        if mode == "counts":
            buf = torch.empty((members, K + 1), dtype=torch.int64, device=dev)
            holder = buf[:, 1:]
        else:
            words = -(-K // 32) if mode == "presence" else K // RHO
            buf = torch.empty((members, 1 + -(-words // 2)), dtype=torch.int64, device=dev)
            holder = torch.empty((members, K), dtype=torch.int32, device=dev) if mode == "presence" else \
                torch.empty((members, K // RHO), dtype=torch.uint8, device=dev)
        docs = buf.data_ptr()
        state = docs + 8
        vp = ctypes.c_void_p
        gptrs, gcodes, gcards = (vp * MAX_GROUP_COLUMNS)(), (ctypes.c_int * MAX_GROUP_COLUMNS)(), \
            (ctypes.c_int * MAX_GROUP_COLUMNS)()
        for c in range(ng):
            g = group_cols[c]
            gptrs[c], gcodes[c], gcards[c] = g.data_ptr(), _INDEX_CODES[g.dtype], int(group_cards[c])
        tptrs, tcards = (vp * _TABLES)(), (ctypes.c_int * _TABLES)()
        tstrides = (ctypes.c_longlong * _TABLES)()
        for t, tab in enumerate(tables):
            tptrs[t], tcards[t] = _ptr(tab), 0 if tab is None else tab.shape[-1]
            tstrides[t] = fused_groupby._mstride(tab, 2, members)
        rc = lib.value_state_launch(
            mcode, tcode, kind, fcode, members, fused_groupby._mstride(filter_bounds, 2, members),
            fused_groupby._mstride(match_u8, 2, members), tstrides, buf.shape[1], _ptr(filter_fwd), _ptr(filter_bounds), _ptr(match_u8), mcard,
            _ptr(num_docs), S, n_pad, ng, gptrs, gcodes, gcards,
            values.data_ptr(), _INDEX_CODES[values.dtype], _ptr(rho), tptrs, tcards, int(table_bytes > 0),
            0 if mode == "registers" else int(width), K, _ptr(block_ids), nb_pad, block_rows, bps,
            state if mode == "counts" else None, state if mode == "presence" else None,
            state if mode == "registers" else None, docs, buf.numel() * 8, holder.data_ptr(), smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"value_state launch failed with code {rc}")
    with _launches_lock:
        if members == 1:
            launches += 1
        else:
            batched_launches += 1
    return buf[:, 0], holder


def value_state(
    mode: str,
    num_docs: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int = 1,
    width: Optional[int] = None,
    value_table: Optional[torch.Tensor] = None,
    rho: Optional[torch.Tensor] = None,
    rho_table: Optional[torch.Tensor] = None,
    filter_fwd: Optional[torch.Tensor] = None,
    match: Optional[torch.Tensor] = None,
    filter_bounds: Optional[torch.Tensor] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
    block_ids: Optional[torch.Tensor] = None,
    block_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched-doc total int64 scalar, flat holder) for ``mode``; see
    the module docstring for the arguments."""
    kw = dict(capacity=capacity, width=width, value_table=value_table, rho=rho, rho_table=rho_table,
              filter_fwd=filter_fwd, match=match, filter_bounds=filter_bounds, group_cols=group_cols,
              group_cards=group_cards, group_remaps=group_remaps, tier=tier, block_ids=block_ids,
              block_rows=block_rows)
    K = _validate(mode, num_docs, values, **kw)
    if values.device.type == "cuda":
        if values.numel() == 0:  # nothing to count: no launch
            dtype, n = {"counts": (torch.int64, K), "presence": (torch.int32, K),
                        "registers": (torch.uint8, K // RHO)}[mode]
            return torch.zeros((), dtype=torch.int64, device=values.device), \
                torch.zeros(n, dtype=dtype, device=values.device)
        docs, holder = _launch(mode, num_docs, values, K, **kw)
        return docs[0], holder[0]
    if values.device.type != "cpu":
        raise ValueError(f"unsupported device {values.device}")
    return value_state_reference(mode, num_docs, values, **kw)


def value_state_counts(flat_idx: torch.Tensor, K: int, tier: Optional[str] = None) -> torch.Tensor:
    """int64 ``[K]`` occupancy counts of the precombined int32 ``flat_idx``
    (module docstring): the kernel with no filter, no group-by and the
    index as its value stream."""
    if flat_idx.dtype != torch.int32:
        raise ValueError(f"flat_idx must be int32, got {flat_idx.dtype}")
    if not flat_idx.is_contiguous():
        raise ValueError("flat_idx must be contiguous")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {K}")
    if tier is not None and tier not in MODE_TIERS["counts"]:
        raise ValueError(f"unknown tier {tier!r}: one of {MODE_TIERS['counts']}")
    dev = flat_idx.device
    if dev.type == "cpu":
        return value_state_counts_reference(flat_idx, K)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if flat_idx.numel() == 0:
        return torch.zeros(K, dtype=torch.int64, device=dev)  # nothing to count: no launch
    return _launch("counts", None, flat_idx.view(1, -1), K, capacity=1, width=K, value_table=None,
                   rho=None, rho_table=None, filter_fwd=None, match=None, filter_bounds=None,
                   group_cols=None, group_cards=None, group_remaps=None, tier=tier)[1][0]


_MEMBER_TABLES = ("match", "filter_bounds", "value_table", "rho_table")


def _member_kw(kw: dict, m: int) -> dict:
    """Member ``m``'s one-member arguments: its copy of each per-member
    table ([members, S, ...]), the shared ones as they are."""
    out = dict(kw)
    for name in _MEMBER_TABLES:
        out[name] = fused_groupby._member(kw.get(name), 2, m)
    if kw.get("group_remaps") is not None:
        out["group_remaps"] = [fused_groupby._member(r, 2, m) for r in kw["group_remaps"]]
    return out


def value_state_batched_reference(mode: str, num_docs: torch.Tensor, values: torch.Tensor, *,
                                  members: int, **kw):
    """Plain torch version of ``value_state_batched``: the one-member
    plain version, one member at a time, stacked."""
    kw.pop("tier", None)
    out = [value_state_reference(mode, num_docs, values, **_member_kw(kw, m)) for m in range(members)]
    return torch.stack([d for d, _ in out]), torch.stack([h for _, h in out])


def value_state_batched(
    mode: str,
    num_docs: torch.Tensor,
    values: torch.Tensor,
    *,
    members: int,
    capacity: int = 1,
    width: Optional[int] = None,
    value_table: Optional[torch.Tensor] = None,
    rho: Optional[torch.Tensor] = None,
    rho_table: Optional[torch.Tensor] = None,
    filter_fwd: Optional[torch.Tensor] = None,
    match: Optional[torch.Tensor] = None,
    filter_bounds: Optional[torch.Tensor] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched-doc totals int64 [B], holders [B, ...]) of ``members``
    queries in one launch; see the module docstring.  Each member's
    arguments pass the one-member contract, and the launch takes the tier
    the one-member launch would take."""
    if members < 1:
        raise ValueError("members must be >= 1")
    kw = dict(capacity=capacity, width=width, value_table=value_table, rho=rho, rho_table=rho_table,
              filter_fwd=filter_fwd, match=match, filter_bounds=filter_bounds, group_cols=group_cols,
              group_cards=group_cards, group_remaps=group_remaps, tier=tier)
    for name, t in [(n, kw[n]) for n in _MEMBER_TABLES] + \
            [(f"group_remaps[{c}]", r) for c, r in enumerate(group_remaps or ())]:
        if t is None:
            continue
        if t.dim() not in (2, 3) or (t.dim() == 3 and t.shape[0] != members):
            raise ValueError(f"{name} must be [S, ...] (shared) or [{members}, S, ...], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K = _validate(mode, num_docs, values, **_member_kw(kw, 0))
    if values.device.type == "cuda":
        if values.numel() == 0:  # nothing to count: no launch
            dtype, n = {"counts": (torch.int64, K), "presence": (torch.int32, K),
                        "registers": (torch.uint8, K // RHO)}[mode]
            return torch.zeros(members, dtype=torch.int64, device=values.device), \
                torch.zeros((members, n), dtype=dtype, device=values.device)
        return _launch(mode, num_docs, values, K, members=members, **kw)
    if values.device.type != "cpu":
        raise ValueError(f"unsupported device {values.device}")
    return value_state_batched_reference(mode, num_docs, values, members=members, **kw)
