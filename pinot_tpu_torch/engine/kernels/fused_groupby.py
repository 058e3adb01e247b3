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
the raw row ``value_raws[j][s, i]``.  With S = 1 this is the TPU kernel.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs ``fused_filtered_groupby_sums_reference``.  ``launches``
counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

MAX_TABLE_CARD = 4096  # same contract as the TPU kernel (pallas_kernels.py:61)
MAX_VALUE_COLUMNS = 8
SHARED_BYTES_LIMIT = 232448  # H100 opt-in dynamic shared memory per block; the launch rechecks the device
THREADS = 256
WARPS = THREADS // 32

_INDEX_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_RAW_CODE = 3

launches = 0  # kernel launches on CUDA tensors; chip_smoke.py resets and reads it


def shared_bytes(float_bytes: int, capacity: int, nv: int, dict_total: int, match_card: int) -> int:
    """Dynamic shared memory one block of the partial kernel takes, in the
    layout ``fused_groupby_partial`` carves (the launch is given this
    count): dictionaries, per-warp sum accumulators, per-warp lane staging,
    the integer counts and docs, and the match table."""
    return (
        float_bytes * (dict_total + WARPS * nv * capacity + WARPS * nv * 32)
        + 4 * (capacity + 1)
        + match_card
    )


def fits_shared_memory(
    float_bytes: int, capacity: int, nv: int, dict_cards: Sequence[int], match_card: int
) -> bool:
    return shared_bytes(float_bytes, capacity, nv, sum(dict_cards), match_card) <= SHARED_BYTES_LIMIT


def max_capacity(float_bytes: int, nv: int, dict_total: int = 0, match_card: int = 0) -> int:
    """Largest K whose accumulators fit one block's shared memory."""
    fixed = shared_bytes(float_bytes, 0, nv, dict_total, match_card)
    per_k = float_bytes * WARPS * nv + 4
    return max(0, (SHARED_BYTES_LIMIT - fixed) // per_k)


def _validate(
    filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity, dtype,
    filter_bounds, value_raws,
) -> List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]]:
    """The TPU kernel's ValueError contract (pallas_kernels.py:114-135),
    plus the shape, dtype, device and layout checks the CUDA kernel needs.
    Returns per value column (fwd, dict, raw)."""
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

    if group_keys.dim() != 2 or group_keys.dtype != torch.int32:
        raise ValueError("group_keys must be int32 [S, n_pad]")
    S, n_pad = group_keys.shape
    dev = group_keys.device

    def check(t, name, dtypes, shape):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, group_keys on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
        if tuple(t.shape[: len(shape)]) != shape or t.dim() != len(shape) + (name in ("match", "dict")):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    check(num_docs, "num_docs", (torch.int32,), (S,))
    check(group_keys, "group_keys", (torch.int32,), (S, n_pad))
    if filter_fwd is not None:
        check(filter_fwd, "filter_fwd", tuple(_INDEX_CODES), (S, n_pad))
    if filter_bounds is not None:
        check(filter_bounds, "filter_bounds", (torch.int32,), (S, 2))
    if match is not None:
        check(match, "match", (torch.bool, torch.uint8), (S,))
    for f, d, r in cols:
        if r is not None:
            check(r, "raw", (dtype,), (S, n_pad))
        else:
            check(f, "fwd", tuple(_INDEX_CODES), (S, n_pad))
            check(d, "dict", (dtype,), (S,))
    fbytes = 8 if dtype == torch.float64 else 4
    dict_cards = [d.shape[-1] for _, d, _ in cols if d is not None]
    mcard = match.shape[-1] if match is not None else 0
    if not fits_shared_memory(fbytes, capacity, nv, dict_cards, mcard):
        raise ValueError(
            f"capacity {capacity} with {nv} value columns does not fit the kernel's "
            f"shared-memory accumulators (max {max_capacity(fbytes, nv, sum(dict_cards), mcard)})"
        )
    return cols


def fused_filtered_groupby_sums_reference(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    group_keys: torch.Tensor,
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
):
    """Plain torch version of the same function (no validation beyond the
    wrapper's).  Counts in int64; each sum accumulates in float64 and is
    returned in ``dtype``: ``index_add_`` adds one row at a time into its
    bucket, and in float32 that loses whole percents once a bucket holds
    millions of rows, so the yardstick sums at the higher precision."""
    S, n = group_keys.shape
    dev = group_keys.device
    rows = torch.arange(n, device=dev)
    mask = rows[None, :] < num_docs[:, None]
    if match is not None:
        hit = torch.gather(match.to(torch.bool), 1, filter_fwd.long())
    elif filter_fwd is not None:
        f = filter_fwd.to(torch.int32)
        hit = (f >= filter_bounds[:, 0:1]) & (f < filter_bounds[:, 1:2])
    else:
        hit = (rows[None, :] >= filter_bounds[:, 0:1]) & (rows[None, :] < filter_bounds[:, 1:2])
    mask = mask & hit
    keys = group_keys.long()
    ok = mask & (keys >= 0) & (keys < capacity)
    idx = torch.where(ok, keys, capacity).reshape(-1)
    docs = mask.sum(dtype=torch.int64)
    count = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    count.index_add_(0, idx, torch.ones_like(idx))
    raws = list(value_raws) if value_raws is not None else [None] * len(value_dicts)
    sums = []
    for f, d, r in zip(value_fwds, value_dicts, raws):
        vals = r if r is not None else torch.gather(d, 1, f.long())
        w = torch.where(ok, vals.to(torch.float64), torch.zeros((), dtype=torch.float64, device=dev))
        acc = torch.zeros(capacity + 1, dtype=torch.float64, device=dev)
        acc.index_add_(0, idx, w.reshape(-1))
        sums.append(acc[:capacity].to(dtype))
    return docs, count[:capacity], sums


def blocks_per_segment(num_segments: int, n_pad: int, device: torch.device) -> int:
    """Grid width per segment: about eight blocks per SM in all (64
    resident warps per SM when shared memory allows), and no more blocks
    than a segment has row tiles.  A pure function of the shapes and the
    card, so the reduction order — and thus the result — is the same on
    every launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_seg = max(1, -(-8 * sms // num_segments))
    return max(1, min(per_seg, -(-n_pad // THREADS)))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _library():
    from pinot_tpu_torch.engine import kernels

    lib = kernels.load("fused_groupby")
    fn = lib.fused_groupby_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            ci, ci, ci, vp, vp, vp, ci, vp, ci, ctypes.c_longlong, vp, ci, ci,
            ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(vp), ctypes.POINTER(ci),
            ci, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp,
        ]
        fn.restype = ci
    return fn


def _launch(filter_fwd, match, num_docs, group_keys, cols, capacity, dtype, filter_bounds):
    global launches
    S, n_pad = group_keys.shape
    dev = group_keys.device
    nv = len(cols)
    bps = blocks_per_segment(S, n_pad, dev)
    B = S * bps
    part_docs = torch.empty(B, dtype=torch.int32, device=dev)
    part_counts = torch.empty((B, capacity), dtype=torch.int32, device=dev)
    part_sums = torch.empty((B, nv, capacity), dtype=dtype, device=dev)
    out_docs = torch.empty(1, dtype=torch.int64, device=dev)
    out_counts = torch.empty(capacity, dtype=torch.int64, device=dev)
    out_sums = torch.empty((nv, capacity), dtype=dtype, device=dev)

    if match is not None:
        kind, fcode = 2, _INDEX_CODES[filter_fwd.dtype]
        mcard = match.shape[-1]
        match_u8 = match.view(torch.uint8) if match.dtype == torch.bool else match
    elif filter_fwd is not None:
        kind, fcode, mcard, match_u8 = 0, _INDEX_CODES[filter_fwd.dtype], 0, None
    else:
        kind, fcode, mcard, match_u8 = 1, 0, 0, None
    vptrs = (ctypes.c_void_p * max(nv, 1))()
    vcodes = (ctypes.c_int * max(nv, 1))()
    dptrs = (ctypes.c_void_p * max(nv, 1))()
    dcards = (ctypes.c_int * max(nv, 1))()
    for j, (f, d, r) in enumerate(cols):
        if r is not None:
            vptrs[j], vcodes[j], dptrs[j], dcards[j] = r.data_ptr(), _RAW_CODE, None, 0
        else:
            vptrs[j], vcodes[j] = f.data_ptr(), _INDEX_CODES[f.dtype]
            dptrs[j], dcards[j] = d.data_ptr(), d.shape[-1]
    fbytes = 8 if dtype == torch.float64 else 4
    smem = shared_bytes(fbytes, capacity, nv, sum(dcards[j] for j in range(nv)), mcard)
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            1 if dtype == torch.float64 else 0, kind, fcode,
            _ptr(filter_fwd), _ptr(filter_bounds), _ptr(match_u8), mcard,
            num_docs.data_ptr(), S, n_pad, group_keys.data_ptr(), capacity, nv,
            vptrs, vcodes, dptrs, dcards, bps,
            part_docs.data_ptr(), part_counts.data_ptr(), part_sums.data_ptr(),
            out_docs.data_ptr(), out_counts.data_ptr(), out_sums.data_ptr(), smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_groupby launch failed with code {rc}")
    launches += 1
    return out_docs[0], out_counts, [out_sums[j] for j in range(nv)]


def fused_filtered_groupby_sums(
    filter_fwd: Optional[torch.Tensor],
    match: Optional[torch.Tensor],
    num_docs: torch.Tensor,
    group_keys: torch.Tensor,
    value_fwds: Sequence[Optional[torch.Tensor]],
    value_dicts: Sequence[Optional[torch.Tensor]],
    capacity: int,
    *,
    dtype: torch.dtype,
    filter_bounds: Optional[torch.Tensor] = None,
    value_raws: Optional[Sequence[Optional[torch.Tensor]]] = None,
):
    """Returns (num_docs int64 scalar, count int64 [K], [sums [K] per
    value column]).  See the module docstring for the arguments."""
    cols = _validate(
        filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity, dtype,
        filter_bounds, value_raws,
    )
    device_type = group_keys.device.type
    if device_type == "cuda":
        return _launch(filter_fwd, match, num_docs, group_keys, cols, capacity, dtype, filter_bounds)
    if device_type != "cpu":
        raise ValueError(f"unsupported device {group_keys.device}")
    return fused_filtered_groupby_sums_reference(
        filter_fwd, match, num_docs, group_keys, value_fwds, value_dicts, capacity,
        dtype=dtype, filter_bounds=filter_bounds, value_raws=value_raws,
    )
