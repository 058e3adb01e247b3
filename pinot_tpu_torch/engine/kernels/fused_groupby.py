"""Fused filtered group-by sums: the CUDA kernel's wrapper and its plain
torch version.

Replaces the TPU kernel ``fused_filtered_groupby_sums``
(``pinot_tpu/engine/pallas_kernels.py:95``) with
``pinot_tpu_torch/csrc/fused_groupby.cu``; that file's header says what
bounds the kernel on the card (memory) and what its design does about it.

The function takes a leading segment axis, because the port's table
kernel works on ``[S, n_pad]`` stacks:

  mask      = filter(s, i) & (i < num_docs[s])
  num_docs  = sum mask                          int64 scalar
  count[k]  = sum mask * [key == k]             int64 [K]
  sums[j,k] = sum mask * v_j * [key == k]       ``dtype`` [K] per value column

The filter is exactly one of
  * a match table over dictIds: ``filter_fwd`` + ``match`` [S, card];
  * a dictId interval [lo, hi): ``filter_fwd`` + ``filter_bounds`` [S, 2];
  * a doc interval (docrange): ``filter_bounds`` [S, 2] with no
    ``filter_fwd`` — the interval test applied to the row index.
A single-value points leaf is the interval [p, p+1); p = -1 matches
nothing.  Value column j is ``value_dicts[j][s][value_fwds[j][s, i]]`` or
the raw row ``value_raws[j][s, i]``.

The key is exactly one of
  * ``group_keys``: a precombined int32 [S, n_pad] key (the TPU kernel's
    argument; with S = 1 this is the TPU kernel);
  * ``group_cols``: up to ``MAX_GROUP_COLUMNS`` id streams [S, n_pad]
    (uint8 / int16 / int32), each a global-id stream or, where
    ``group_remaps[c]`` is given, a local fwd stream read through that
    per-segment remap table [S, card]; ``group_cards`` are the radices.
    key = ((g0 * c1 + g1) * c2 + g2) ..., the mixed radix of
    ``engine/kernel.py::_group_keys``, combined inside the kernel.
Keys outside [0, capacity) drop.

``block_ids`` (int32 [S, nb_pad], zone-block ids, -1 padded) with
``block_rows`` restricts the function to the rows of those blocks (the
zone-map path, ``engine/zonemap.py``): the kernel scans each table entry
as a segment of its own (its grid's y axis is S x nb_pad), so it covers
only the candidate rows and reads nothing else; row bounds stay the
segment's doc ids (docrange filters compare them); the plain version
gathers the blocks' rows with torch ops and runs the full-scan function
on them.

How the kernel accumulates is its tier, chosen from the shape
(``choose_tier``; ``tier=`` forces one, for measurement):
  private       per-thread counts and sums in shared memory [slot][thread]
                (sums over small K)
  atomic        count-only: shared-memory integer atomics
  warp          sums over larger K: per-warp accumulators fed through
                ``__match_any_sync`` groups

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs ``fused_filtered_groupby_sums_reference``.  ``launches``
counts kernel launches only.

``fused_filtered_groupby_sums_batched`` serves ``members`` queries of one
plan in one launch (the lane's micro-batching tier): the row streams and
dictionaries are shared, while ``match``, ``filter_bounds`` and each of
``group_remaps`` may lead with a ``[members]`` axis (each member its own)
or not (one shared by all).  It returns num_docs [B], count [B, K] and
sums [B, nv, K]; member m's are bit-identical to a launch of member m
alone (the same tier and grid partition per member; the member is the
innermost index of the grid).  Its plain version loops over the one-member
plain version.  ``batched_launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

MAX_TABLE_CARD = 4096  # same contract as the TPU kernel (pallas_kernels.py:61)
MAX_VALUE_COLUMNS = 8
MAX_GROUP_COLUMNS = 4
MAX_ROWS = 2**31 - 1  # rows a segment: num_docs is int32 (K2 shares the bound)
MAX_GRID_Y = 65535  # segments, or block table entries, of one launch
SHARED_BYTES_LIMIT = 232448  # H100 opt-in dynamic shared memory per block; the launch rechecks the device
THREADS = 256
WARPS = THREADS // 32
ROWS_PER_LANE = 16  # kRows: rows a lane takes per chunk, and the warp tier's lane staging
TIERS = ("private", "atomic", "warp")
# the private tier while its [slot][thread] accumulators leave room for
# two or more resident blocks per SM
PRIVATE_SHARED_BYTES = 49152

_INDEX_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_RAW_CODE = 3

launches = 0  # kernel launches on CUDA tensors; chip_smoke.py resets and reads it
batched_launches = 0  # launches of the batched wrapper on CUDA tensors
_launches_lock = threading.Lock()  # lanes of two servers launch at once


def shared_bytes(
    tier: str, float_bytes: int, capacity: int, nv: int, dict_total: int = 0,
    match_card: int = 0, remap_total: int = 0,
) -> int:
    """Dynamic shared memory one block takes in ``tier``, in the layout
    ``carve`` in the kernel makes (the launch is given this count):
    dictionaries, the tier's float accumulators, remap tables, the
    integer counts, docs and flag, and the match table."""
    if tier == "private":
        floats, ints = nv * capacity * THREADS, capacity * THREADS
    elif tier == "warp":
        floats, ints = WARPS * nv * capacity + WARPS * ROWS_PER_LANE * 32, capacity
    elif tier == "atomic":
        floats, ints = 0, capacity
    else:
        raise ValueError(f"unknown tier {tier!r}: one of {TIERS}")
    return float_bytes * (dict_total + floats) + 4 * (remap_total + ints + 2) + match_card


def tier_fits(
    tier: str, float_bytes: int, capacity: int, nv: int, dict_total: int = 0,
    match_card: int = 0, remap_total: int = 0,
) -> bool:
    """Whether ``tier`` can run this shape: the count-only tiers take no
    value columns, and the block's shared memory must fit."""
    if tier == "atomic" and nv:
        return False
    need = shared_bytes(tier, float_bytes, capacity, nv, dict_total, match_card, remap_total)
    return need <= SHARED_BYTES_LIMIT


def choose_tier(
    float_bytes: int, capacity: int, nv: int, dict_total: int = 0,
    match_card: int = 0, remap_total: int = 0,
) -> str:
    """The tier a shape runs in: atomic when count-only, else private
    while its accumulators are small, else warp (the fastest of each on
    the card at the main path's shapes, ``PERF.md``).  Raises when none
    fits."""
    shape = (float_bytes, capacity, nv, dict_total, match_card, remap_total)
    if nv and shared_bytes("private", *shape) <= PRIVATE_SHARED_BYTES:
        return "private"
    tier = "atomic" if nv == 0 else "warp"
    if not tier_fits(tier, *shape):
        raise ValueError(
            f"capacity {capacity} with {nv} value columns does not fit the kernel's "
            f"shared memory (max {max_capacity(float_bytes, nv, dict_total, match_card, remap_total)})"
        )
    return tier


def fits_shared_memory(
    float_bytes: int, capacity: int, nv: int, dict_cards: Sequence[int], match_card: int,
    remap_cards: Sequence[int] = (),
) -> bool:
    """Whether some tier takes this shape."""
    shape = (float_bytes, capacity, nv, sum(dict_cards), match_card, sum(remap_cards))
    return any(tier_fits(t, *shape) for t in TIERS)


def max_capacity(
    float_bytes: int, nv: int, dict_total: int = 0, match_card: int = 0, remap_total: int = 0
) -> int:
    """Largest K that some tier takes: atomic when count-only, else warp
    (the private tier's per-thread accumulators hold fewer groups)."""
    tier = "atomic" if nv == 0 else "warp"
    fixed = shared_bytes(tier, float_bytes, 0, nv, dict_total, match_card, remap_total)
    per_k = shared_bytes(tier, float_bytes, 1, nv) - shared_bytes(tier, float_bytes, 0, nv)
    return max(0, (SHARED_BYTES_LIMIT - fixed) // per_k)


def candidate_rows(block_ids: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the candidate blocks, in block order: (row ids int64
    [S, nb_pad * block], live bool [S, nb_pad * block]; padded blocks
    read row ``offset`` of block 0 and are not live)."""
    S, nb = block_ids.shape
    safe = block_ids.clamp(min=0).long()
    offs = torch.arange(block, device=block_ids.device)
    rowid = (safe[:, :, None] * block + offs).reshape(S, nb * block)
    live = (block_ids >= 0)[:, :, None].expand(S, nb, block).reshape(S, nb * block)
    return rowid, live


def check_blocks(block_ids: Optional[torch.Tensor], block: int, S: int, n_pad: int, dev) -> None:
    """The block-table contract both kernels share."""
    if block_ids is None:
        return
    if block < 1 or n_pad % block:
        raise ValueError(f"block_rows {block} must be >= 1 and divide n_pad {n_pad}")
    if block_ids.device != dev:
        raise ValueError(f"block_ids is on {block_ids.device}, the row streams on {dev}")
    if block_ids.dtype != torch.int32 or block_ids.dim() != 2 or block_ids.shape[0] != S:
        raise ValueError(f"block_ids must be int32 [{S}, nb_pad], got {block_ids.dtype} {tuple(block_ids.shape)}")
    if block_ids.shape[1] < 1 or not block_ids.is_contiguous():
        raise ValueError("block_ids must be contiguous with at least one column")
    if block_ids.numel() > MAX_GRID_Y:
        raise ValueError(f"{block_ids.numel()} block table entries > {MAX_GRID_Y} (the grid's y axis)")


def _validate(
    filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity, dtype,
    filter_bounds, value_raws, group_cols, group_cards, group_remaps, block_ids=None, block=0,
) -> Tuple[list, list]:
    """The TPU kernel's ValueError contract (pallas_kernels.py:114-135),
    plus the group-column contract and the shape, dtype, device and layout
    checks the CUDA kernel needs.  Returns (per value column (fwd, dict,
    raw), per group column (stream, remap))."""
    if (match is None) == (filter_bounds is None):
        raise ValueError("exactly one of match / filter_bounds required")
    if match is not None and filter_fwd is None:
        raise ValueError("a match table needs filter_fwd")
    if match is not None and match.shape[-1] > MAX_TABLE_CARD:
        raise ValueError(
            f"match table card {match.shape[-1]} > {MAX_TABLE_CARD}: rewrite the "
            "predicate as an interval or split it before the fused path"
        )
    nv = len(value_dicts)
    raws = list(value_raws) if value_raws is not None else [None] * nv
    if len(value_fwds) != nv or len(raws) != nv:
        raise ValueError("value_fwds, value_dicts and value_raws must have one entry per column")
    cols = []
    for i in range(nv):
        if (value_dicts[i] is None) == (raws[i] is None):
            raise ValueError(f"value column {i}: exactly one of dict/raw required")
        if value_dicts[i] is not None:
            if value_fwds[i] is None:
                raise ValueError(f"value column {i}: a dictionary needs its fwd")
            if value_dicts[i].shape[-1] > MAX_TABLE_CARD:
                raise ValueError(
                    f"value dict card {value_dicts[i].shape[-1]} > {MAX_TABLE_CARD}; "
                    "stage this column raw for the fused path"
                )
        cols.append((value_fwds[i], value_dicts[i], raws[i]))
    if nv > MAX_VALUE_COLUMNS:
        raise ValueError(f"{nv} value columns > {MAX_VALUE_COLUMNS}")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")

    if (group_keys is None) == (group_cols is None):
        raise ValueError("exactly one of group_keys / group_cols required")
    groups = []
    if group_cols is not None:
        ng = len(group_cols)
        remaps = list(group_remaps) if group_remaps is not None else [None] * ng
        if not 1 <= ng <= MAX_GROUP_COLUMNS:
            raise ValueError(f"{ng} group columns: the kernel takes 1 to {MAX_GROUP_COLUMNS}")
        if group_cards is None or len(group_cards) != ng or len(remaps) != ng:
            raise ValueError("group_cols, group_cards and group_remaps must have one entry per column")
        if any(int(c) < 1 for c in group_cards):
            raise ValueError("group_cards must be >= 1")
        for c, r in enumerate(remaps):
            if r is not None and r.shape[-1] > MAX_TABLE_CARD:
                raise ValueError(
                    f"group column {c}: remap card {r.shape[-1]} > {MAX_TABLE_CARD}; "
                    "stage its global-id stream for the fused path"
                )
        groups = list(zip(group_cols, remaps))
        lead = group_cols[0]
    else:
        if group_keys.dim() != 2 or group_keys.dtype != torch.int32:
            raise ValueError("group_keys must be int32 [S, n_pad]")
        lead = group_keys
    if lead.dim() != 2:
        raise ValueError("group columns must be [S, n_pad]")
    S, n_pad = lead.shape
    if n_pad > MAX_ROWS:
        raise ValueError(f"{n_pad} rows a segment: the int32 num_docs bounds at most {MAX_ROWS}")
    dev = lead.device

    def check(t, name, dtypes, shape, table=False):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the key inputs on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
        if tuple(t.shape[: len(shape)]) != shape or t.dim() != len(shape) + table:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    check(num_docs, "num_docs", (torch.int32,), (S,))
    check_blocks(block_ids, block, S, n_pad, dev)
    if group_keys is not None:
        check(group_keys, "group_keys", (torch.int32,), (S, n_pad))
    for g, r in groups:
        check(g, "group column", tuple(_INDEX_CODES), (S, n_pad))
        if r is not None:
            check(r, "group remap", (torch.int32,), (S,), table=True)
    if filter_fwd is not None:
        check(filter_fwd, "filter_fwd", tuple(_INDEX_CODES), (S, n_pad))
    if filter_bounds is not None:
        check(filter_bounds, "filter_bounds", (torch.int32,), (S, 2))
    if match is not None:
        check(match, "match", (torch.bool, torch.uint8), (S,), table=True)
    for f, d, r in cols:
        if r is not None:
            check(r, "raw", (dtype,), (S, n_pad))
        else:
            check(f, "fwd", tuple(_INDEX_CODES), (S, n_pad))
            check(d, "dict", (dtype,), (S,), table=True)
    fbytes = 8 if dtype == torch.float64 else 4
    dict_cards = [d.shape[-1] for _, d, _ in cols if d is not None]
    remap_cards = [r.shape[-1] for _, r in groups if r is not None]
    mcard = match.shape[-1] if match is not None else 0
    if not fits_shared_memory(fbytes, capacity, nv, dict_cards, mcard, remap_cards):
        raise ValueError(
            f"capacity {capacity} with {nv} value columns does not fit the kernel's "
            f"shared memory (max {max_capacity(fbytes, nv, sum(dict_cards), mcard, sum(remap_cards))})"
        )
    return cols, groups


def combine_group_keys(
    group_cols: Sequence[torch.Tensor], group_cards: Sequence[int],
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """The mixed-radix key [S, n_pad] of the group columns in ``dtype``:
    ((g0 * c1 + g1) * c2 + g2) ..., each g the column's id stream or its
    local fwd through its remap table.  The kernel combines the same key
    in int32 registers; the torch-op route (``engine/kernel.py``) combines
    it here."""
    remaps = list(group_remaps) if group_remaps is not None else [None] * len(group_cols)
    keys = None
    for g, card, r in zip(group_cols, group_cards, remaps):
        g = (torch.gather(r, 1, g.long()) if r is not None else g).to(dtype)
        keys = g if keys is None else keys * int(card) + g
    return keys


def fused_filtered_groupby_sums_reference(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    group_keys: Optional[torch.Tensor],
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
    block_ids: Optional[torch.Tensor] = None,
    block_rows: int = 0,
):
    """Plain torch version of the same function (no validation beyond the
    wrapper's; ``tier`` is the kernel's and changes nothing here).  With
    ``block_ids`` every row stream is gathered to the candidate blocks'
    rows first, which then run in block order.  Counts
    in int64; each sum accumulates in float64 and is returned in
    ``dtype``: ``index_add_`` adds one row at a time into its bucket, and
    in float32 that loses whole percents once a bucket holds millions of
    rows, so the yardstick sums at the higher precision.  The sums add in
    the reference's order: each segment's rows in row order into its own
    partial, then the partials in segment order (``pinot_tpu/engine/
    kernel.py`` scatter-adds per segment and reduces the segment axis),
    so equal inputs give bit-equal float64 sums."""
    if group_keys is None:
        group_keys = combine_group_keys(group_cols, group_cards, group_remaps)
    S, n = group_keys.shape
    dev = group_keys.device
    raws = list(value_raws) if value_raws is not None else [None] * len(value_dicts)
    if block_ids is not None:
        rowid, live = candidate_rows(block_ids, block_rows)

        def take(t):
            return None if t is None else torch.gather(t, 1, rowid)

        filter_fwd, group_keys = take(filter_fwd), take(group_keys)
        value_fwds, raws = [take(f) for f in value_fwds], [take(r) for r in raws]
    else:
        rowid = torch.arange(n, device=dev).expand(S, n)
        live = None
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    docs = torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    accs = [torch.zeros(capacity + 1, dtype=torch.float64, device=dev) for _ in raws]
    for s in range(S):  # one segment at a time: its rows in row order, then the next segment
        rows = rowid[s]
        mask = rows < num_docs[s]
        if live is not None:
            mask = mask & live[s]
        if match is not None:
            mask = mask & match[s].to(torch.bool)[filter_fwd[s].long()]
        else:
            f = filter_fwd[s].to(torch.int32) if filter_fwd is not None else rows
            mask = mask & (f >= filter_bounds[s, 0]) & (f < filter_bounds[s, 1])
        docs += mask.sum(dtype=torch.int64)
        keys = group_keys[s].long()
        ok = mask & (keys >= 0) & (keys < capacity)
        idx = torch.where(ok, keys, capacity)
        count.index_add_(0, idx, torch.ones_like(idx))
        for acc, f, d, r in zip(accs, value_fwds, value_dicts, raws):
            vals = r[s] if r is not None else d[s][f[s].long()]
            part = torch.zeros(capacity + 1, dtype=torch.float64, device=dev)
            part.index_add_(0, idx, torch.where(ok, vals.to(torch.float64), zero))
            acc += part
    sums = [acc[:capacity].to(dtype) for acc in accs]
    return docs, count[:capacity], sums


# per (device, stream): the int64 [members][K + 1] accumulators and the
# uint32 [members] tickets the kernel needs zero at launch and leaves zero
# (launches on one stream run in order, so they share one)
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_occupancy: Dict[tuple, int] = {}


def _zeroed_scratch(dev: torch.device, stream: int, capacity: int,
                    members: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    got = _scratch.get(key)
    need = members * (capacity + 1)
    if got is None or got[0].numel() < need or got[1].numel() < members:
        size = max(need, 1024 if got is None else 2 * got[0].numel())
        tickets = max(members, 1 if got is None else got[1].numel())
        got = (torch.zeros(size, dtype=torch.int64, device=dev),
               torch.zeros(tickets, dtype=torch.int32, device=dev))
        _scratch[key] = got
    return got


def blocks_per_segment(num_segments: int, n_pad: int, device: torch.device, per_sm: int) -> int:
    """Grid width per segment: one wave of the kernel (``per_sm``
    resident blocks on every SM) over all segments, and no more blocks
    than a segment has block-sized row spans.  A pure function of the
    shapes, the tier and the card, so the reduction order — and thus the
    result — is the same on every launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_seg = max(1, -(-max(1, per_sm) * sms // num_segments))
    return max(1, min(per_seg, -(-n_pad // (THREADS * ROWS_PER_LANE))))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _library(float_code: int):
    """The library of the sums' width: float (0) or double (1)."""
    from pinot_tpu_torch.engine import kernels

    lib = kernels.load("fused_groupby_x64" if float_code else "fused_groupby")
    fn = lib.fused_groupby_launch
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        fn.argtypes = [
            ci, ci, ci, ci, ci, ll, ll, ctypes.POINTER(ll),
            vp, vp, vp, ci, vp, ci, ll, vp, ci, pv, pi, pi, pv, pi,
            ci, ci, pv, pi, pv, pi, vp, ci, ll, ci, vp, vp, vp, vp, vp, vp, ll, vp,
        ]
        fn.restype = ci
        occ = lib.fused_groupby_blocks_per_sm
        occ.argtypes = [ci, ci, ci, ci, ll]
        occ.restype = ci
    return lib


def _filter_codes(filter_fwd, match):
    if match is not None:
        return 2, _INDEX_CODES[filter_fwd.dtype]
    if filter_fwd is not None:
        return 0, _INDEX_CODES[filter_fwd.dtype]
    return 1, 0


def _mstride(t: Optional[torch.Tensor], solo_dim: int, members: int) -> int:
    """Elements between two members' copies of a per-member table (0 for
    one shared by every member, or none)."""
    if t is None or members == 1 or t.dim() == solo_dim:
        return 0
    return t[0].numel()


def _launch(filter_fwd, match, num_docs, group_keys, cols, groups, group_cards, capacity,
            dtype, filter_bounds, tier, block_ids=None, block=0, members=1):
    """One launch for ``members`` queries (1: the one-member kernel); the
    outputs lead with the member axis."""
    global launches, batched_launches
    lead = group_keys if group_keys is not None else groups[0][0]
    S, n_pad = lead.shape
    dev = lead.device
    nv = len(cols)
    ng = len(groups)
    fbytes = 8 if dtype == torch.float64 else 4
    kind, fcode = _filter_codes(filter_fwd, match)
    mcard = match.shape[-1] if match is not None else 0
    match_u8 = None
    if match is not None:
        match_u8 = match.view(torch.uint8) if match.dtype == torch.bool else match
    dict_total = sum(d.shape[-1] for _, d, _ in cols if d is not None)
    remap_total = sum(r.shape[-1] for _, r in groups if r is not None)
    shape = (fbytes, capacity, nv, dict_total, mcard, remap_total)
    if tier is None:
        tier = choose_tier(*shape)
    elif tier not in TIERS or not tier_fits(tier, *shape):
        raise ValueError(f"tier {tier!r} does not take this shape")
    smem = shared_bytes(tier, *shape)
    fcode_f = 1 if dtype == torch.float64 else 0
    lib = _library(fcode_f)
    with torch.cuda.device(dev):
        okey = (dev.index, fcode_f, kind, fcode, TIERS.index(tier), smem)  # occupancy of this block
        per_sm = _occupancy.get(okey)
        if per_sm is None:
            per_sm = lib.fused_groupby_blocks_per_sm(fcode_f, kind, fcode, TIERS.index(tier), smem)
            if per_sm < 1:
                raise RuntimeError(f"fused_groupby occupancy query failed with code {per_sm}")
            _occupancy[okey] = per_sm
        # with a block table each entry is a segment of ``block`` rows
        nb_pad = 0 if block_ids is None else block_ids.shape[1]
        segs = S * nb_pad if nb_pad else S
        bps = blocks_per_segment(segs, block if nb_pad else n_pad, dev, per_sm)
        stream = torch.cuda.current_stream(dev).cuda_stream
        acc, ticket = _zeroed_scratch(dev, stream, capacity, members)
        part_sums = torch.empty((members, segs * bps, nv, capacity), dtype=dtype, device=dev)
        out_docs = torch.empty(members, dtype=torch.int64, device=dev)
        out_counts = torch.empty((members, capacity), dtype=torch.int64, device=dev)
        out_sums = torch.empty((members, nv, capacity), dtype=dtype, device=dev)
        rstrides = (ctypes.c_longlong * MAX_GROUP_COLUMNS)()

        vp = ctypes.c_void_p
        n1, g1 = max(nv, 1), max(ng, 1)
        vptrs, vcodes = (vp * n1)(), (ctypes.c_int * n1)()
        dptrs, dcards = (vp * n1)(), (ctypes.c_int * n1)()
        for j, (f, d, r) in enumerate(cols):
            if r is not None:
                vptrs[j], vcodes[j], dptrs[j], dcards[j] = r.data_ptr(), _RAW_CODE, None, 0
            else:
                vptrs[j], vcodes[j] = f.data_ptr(), _INDEX_CODES[f.dtype]
                dptrs[j], dcards[j] = d.data_ptr(), d.shape[-1]
        gptrs, gcodes, gcards = (vp * g1)(), (ctypes.c_int * g1)(), (ctypes.c_int * g1)()
        rptrs, rcards = (vp * g1)(), (ctypes.c_int * g1)()
        for c, (g, r) in enumerate(groups):
            gptrs[c], gcodes[c], gcards[c] = g.data_ptr(), _INDEX_CODES[g.dtype], int(group_cards[c])
            rptrs[c], rcards[c] = _ptr(r), 0 if r is None else r.shape[-1]
            rstrides[c] = _mstride(r, 2, members)
        rc = lib.fused_groupby_launch(
            fcode_f, kind, fcode, TIERS.index(tier), members,
            _mstride(filter_bounds, 2, members), _mstride(match_u8, 2, members), rstrides,
            _ptr(filter_fwd), _ptr(filter_bounds), _ptr(match_u8), mcard,
            num_docs.data_ptr(), S, n_pad, _ptr(group_keys), ng,
            gptrs, gcodes, gcards, rptrs, rcards, capacity, nv,
            vptrs, vcodes, dptrs, dcards, _ptr(block_ids), nb_pad, block, bps,
            part_sums.data_ptr(), acc.data_ptr(), ticket.data_ptr(),
            out_docs.data_ptr(), out_counts.data_ptr(), out_sums.data_ptr(), smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_groupby launch failed with code {rc}")
    with _launches_lock:
        if members == 1:
            launches += 1
        else:
            batched_launches += 1
    return out_docs, out_counts, out_sums


def fused_filtered_groupby_sums(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    group_keys: Optional[torch.Tensor],
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
    block_ids: Optional[torch.Tensor] = None,
    block_rows: int = 0,
):
    """Returns (num_docs int64 scalar, count int64 [K], [sums [K] per
    value column]).  See the module docstring for the arguments."""
    if tier is not None and tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}: one of {TIERS}")
    cols, groups = _validate(
        filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity, dtype,
        filter_bounds, value_raws, group_cols, group_cards, group_remaps, block_ids, block_rows,
    )
    device = num_docs.device
    if device.type == "cuda":
        docs, count, sums = _launch(filter_fwd, match, num_docs, group_keys, cols, groups, group_cards,
                                    capacity, dtype, filter_bounds, tier, block_ids, block_rows)
        return docs[0], count[0], [sums[0, j] for j in range(len(cols))]
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return fused_filtered_groupby_sums_reference(
        filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity,
        dtype=dtype, filter_bounds=filter_bounds, value_raws=value_raws,
        group_cols=group_cols, group_cards=group_cards, group_remaps=group_remaps,
        block_ids=block_ids, block_rows=block_rows,
    )


def _member(t: Optional[torch.Tensor], solo_dim: int, m: int) -> Optional[torch.Tensor]:
    """Member ``m``'s copy of a per-member table, or the shared one."""
    return t if t is None or t.dim() == solo_dim else t[m]


def _member_args(members: int, match, filter_bounds, group_remaps, m: int) -> dict:
    remaps = None if group_remaps is None else [_member(r, 2, m) for r in group_remaps]
    return dict(match=_member(match, 2, m), filter_bounds=_member(filter_bounds, 2, m),
                group_remaps=remaps)


def fused_filtered_groupby_sums_batched_reference(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    members: int,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
):
    """Plain torch version of the batched function: the one-member plain
    version, one member at a time, stacked."""
    docs, counts, sums = [], [], []
    for m in range(members):
        d, c, s = fused_filtered_groupby_sums_reference(
            filter_fwd, num_docs=num_docs, group_keys=None, value_fwds=value_fwds, value_dicts=value_dicts,
            capacity=capacity, dtype=dtype, value_raws=value_raws, group_cols=group_cols,
            group_cards=group_cards, **_member_args(members, match, filter_bounds, group_remaps, m),
        )
        docs.append(d)
        counts.append(c)
        sums.append(torch.stack(s) if s else c.new_zeros((0, capacity), dtype=dtype))
    return torch.stack(docs), torch.stack(counts), torch.stack(sums)


def fused_filtered_groupby_sums_batched(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    members: int,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
    group_cols: Optional[Sequence[torch.Tensor]] = None,
    group_cards: Optional[Sequence[int]] = None,
    group_remaps: Optional[Sequence[Optional[torch.Tensor]]] = None,
    tier: Optional[str] = None,
):
    """(num_docs int64 [B], count int64 [B, K], sums [B, nv, K]) of
    ``members`` queries in one launch; see the module docstring.  Each
    member's arguments pass the one-member contract, and the launch takes
    the tier the one-member launch would take."""
    if members < 1:
        raise ValueError("members must be >= 1")
    if tier is not None and tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}: one of {TIERS}")
    for name, t in (("match", match), ("filter_bounds", filter_bounds),
                    *((f"group_remaps[{c}]", r) for c, r in enumerate(group_remaps or ()))):
        if t is not None and t.dim() == 3 and t.shape[0] != members:
            raise ValueError(f"{name} leads with {t.shape[0]} members, not {members}")
        if t is not None and t.dim() not in (2, 3):
            raise ValueError(f"{name} must be [S, ...] (shared) or [members, S, ...]")
    first = _member_args(members, match, filter_bounds, group_remaps, 0)
    cols, groups = _validate(
        filter_fwd, first["match"], num_docs, None, value_fwds, value_dicts, capacity, dtype,
        first["filter_bounds"], value_raws, group_cols, group_cards, first["group_remaps"],
    )
    for t in (match, filter_bounds, *(group_remaps or ())):
        if t is not None and not t.is_contiguous():
            raise ValueError("the per-member tables must be contiguous")
    device = num_docs.device
    if device.type == "cuda":
        groups = [(g, r) for (g, _), r in zip(groups, group_remaps or [None] * len(groups))]
        return _launch(filter_fwd, match, num_docs, None, cols, groups, group_cards, capacity, dtype,
                       filter_bounds, tier, members=members)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return fused_filtered_groupby_sums_batched_reference(
        filter_fwd, match, num_docs, value_fwds, value_dicts, capacity, members=members, dtype=dtype,
        filter_bounds=filter_bounds, value_raws=value_raws, group_cols=group_cols,
        group_cards=group_cards, group_remaps=group_remaps,
    )
