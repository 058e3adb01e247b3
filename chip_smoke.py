#!/usr/bin/env python3
"""On-card smoke test and measurement of the PyTorch/CUDA port
(``pinot_tpu_torch``): builds the CUDA kernels from this checkout (one
nvcc per source, started together), holds each against its plain torch
version, and drives the port's paths through parse -> optimize ->
QueryExecutor.execute -> reduce_to_response on one card:

  1. TPC-H Q1, the Q3-shaped query and an unsorted RANGE (K1) over
     134,217,728 lineitem rows, against a float64 numpy oracle;
  2. the value-state queries (distinctcount, percentile, HLL; K2) over the
     same rows, against exact host oracles;
  3. a plan outside K1's fused route (OR filter, sum + min), whose group
     sums go through K1 over the evaluated mask: run twice, bit-identical;
  4. the north-star HLL group-by (NORTHSTAR_HLL.json) over 134,217,728
     ad-events rows, against registers built on the host;

and times the queries, the kernels at each query's shapes, their plain
versions, the torch ops that build their inputs, and the one PyTorch call
that computes K2's function.

    python3 chip_smoke.py [--out results.json] [--profile]

Needs exactly one visible CUDA card (it exits nonzero otherwise).  The last line of
its output is ``{"ok": true, "device": {...}}``; the line before the card
line is the ``{"kernels": [...]}`` summary.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Q1 = (
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) "
    "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus TOP 10"
)
Q3 = (
    "SELECT sum(l_extendedprice), sum(l_quantity) FROM lineitem "
    "WHERE l_returnflag = 'R' GROUP BY l_shipmode TOP 10"
)
RANGE = (
    "SELECT sum(l_extendedprice), count(*) FROM lineitem "
    "WHERE l_quantity > 25 GROUP BY l_returnflag TOP 10"
)
QUERIES = {"q1": Q1, "q3": Q3, "range_unsorted": RANGE}
VALUE_QUERIES = {
    # bench.py:198-201, a BASELINE.md shape: HLL lowered to presence, K = 3 x 2048
    "hll_groupby": "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_returnflag TOP 10",
    # scalar presence over ~259k global values: K = 2^18, K2's global-memory path
    "distinct_price": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
    # grouped histogram: K = 7 x 56
    "pct_quantity": "SELECT percentile90(l_quantity) FROM lineitem GROUP BY l_shipmode TOP 10",
    # HLL registers from the per-row (bucket, rho) streams: K = 256 x 64
    "hll_price": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_shipmode = 'AIR'",
}
# outside K1's fused route (OR tree, min): group sums through K1 over the mask
TORCH_OP_QUERY = (
    "SELECT sum(l_extendedprice), min(l_quantity), count(*) FROM lineitem "
    "WHERE l_quantity > 45 OR l_shipmode = 'AIR' GROUP BY l_returnflag, l_linestatus TOP 10"
)
# NORTHSTAR_HLL.json: 4 distinct ad-events segments of 2^23 rows tiled to 16,
# campaign_card 1024, user_card 2^20 per segment (global ~4.26M users)
NORTH_STAR = "SELECT distinctcounthll(user_id) FROM adevents GROUP BY campaign_id TOP 10"
AD_DISTINCT = 4
AD_CAMPAIGNS = 1024
AD_USERS = 1 << 20
# bench.py:1138-1143, the JAX package's on-chip configuration: 134,217,728 rows
SEGMENTS = 16
ROWS_PER_SEGMENT = 1 << 23
ITERS = 20  # timed runs per median, after warm-up

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside the tensor cores
AUDIT_RTOL, AUDIT_ATOL = 5e-4, 1e-3  # pinot_tpu/utils/audit.py:189-203, float32 reduction order
X64_RTOL, X64_ATOL = 1e-12, 1e-9


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3):
    """Median ms of ``iters`` timed calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


# ---------------------------------------------------------------------------
# K1 against its plain version
# ---------------------------------------------------------------------------


def _close(got, want, rtol, atol) -> float:
    """max |got - want|; raises when any element is outside the band."""
    got = got.double().cpu()
    want = want.double().cpu()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"sums disagree: max err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def k1_shape(fg, args: dict) -> tuple:
    """(float bytes, K, nv, dict entries, match card, remap entries): what
    picks and sizes K1's tier."""
    fb = 8 if args["dtype"] == torch.float64 else 4
    dicts = sum(d.shape[-1] for d in args["value_dicts"] if d is not None)
    match = args["match"].shape[-1] if args["match"] is not None else 0
    remaps = sum(r.shape[-1] for r in (args.get("group_remaps") or []) if r is not None)
    return fb, args["capacity"], len(args["value_dicts"]), dicts, match, remaps


def k1_tiers(fg, args: dict) -> List[str]:
    """Every accumulation tier that takes these inputs."""
    return [t for t in fg.TIERS if fg.tier_fits(t, *k1_shape(fg, args))]


def compare_k1(fg, args: dict, rtol: float, atol: float) -> Tuple[float, List[str]]:
    """Kernel vs plain version on the same card tensors, in every tier
    that takes the inputs: num_docs and counts exact, sums in the band,
    and two kernel launches bit-identical.  Returns the largest absolute
    sum error and the tiers checked."""
    ref = fg.fused_filtered_groupby_sums_reference(**args)
    err = 0.0
    tiers = k1_tiers(fg, args)
    for tier in tiers:
        a = fg.fused_filtered_groupby_sums(**args, tier=tier)
        b = fg.fused_filtered_groupby_sums(**args, tier=tier)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))):
            raise AssertionError(f"two launches of the fused kernel differ (tier {tier})")
        if int(a[0]) != int(ref[0]):
            raise AssertionError(f"tier {tier}: num_docs {int(a[0])} != {int(ref[0])}")
        if not torch.equal(a[1].cpu(), ref[1].cpu()):
            raise AssertionError(f"tier {tier}: group counts differ from the plain version")
        for x, y in zip(a[2], ref[2]):
            err = max(err, _close(x, y, rtol, atol))
    return err, tiers


def k1_cases(fg, dev, dtype):
    """Filters (interval, table, docrange, single point), value columns
    (dict-fed, raw, none), capacities (1, 6, the shared-memory bound),
    S = 1 and 16, ragged num_docs and an empty segment."""
    g = torch.Generator(device="cpu").manual_seed(1234)
    fb = 8 if dtype == torch.float64 else 4

    def ints(S, n, hi, dt):
        return torch.randint(0, hi, (S, n), generator=g, dtype=torch.int64).to(dt).to(dev)

    def floats(S, n, lo=0.0, hi=100.0):
        return (torch.rand((S, n), generator=g, dtype=torch.float64) * (hi - lo) + lo).to(dtype).to(dev)

    def nd(S, n):
        docs = [n - (i * 997) % (n // 3 + 1) for i in range(S)]
        if S > 1:
            docs[S // 2] = 0  # an empty segment
        return torch.tensor(docs, dtype=torch.int32, device=dev)

    cases = {}
    S, n = 1, 1 << 20
    cases["interval_dict_raw_K6_S1"] = dict(
        filter_fwd=ints(S, n, 2000, torch.int16), match=None, num_docs=nd(S, n),
        group_keys=ints(S, n, 6, torch.int32),
        value_fwds=[ints(S, n, 50, torch.uint8), None], value_dicts=[floats(S, 64), None],
        capacity=6, dtype=dtype, filter_bounds=torch.tensor([[100, 1500]], dtype=torch.int32, device=dev),
        value_raws=[None, floats(S, n, 900.0, 105000.0)],
    )
    S, n = 16, 1 << 16
    cases["table_raw_K6_S16_ragged"] = dict(
        filter_fwd=ints(S, n, 7, torch.uint8), match=(torch.rand((S, 8), generator=g) < 0.5).to(dev),
        num_docs=nd(S, n), group_keys=ints(S, n, 6, torch.int32),
        value_fwds=[None, None, None], value_dicts=[None, None, None],
        capacity=6, dtype=dtype, value_raws=[floats(S, n), floats(S, n), floats(S, n, 0.0, 0.1)],
    )
    lo = torch.randint(0, n // 2, (S, 1), generator=g, dtype=torch.int32)
    cases["docrange_count_only_K1_S16"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=ints(S, n, 1, torch.int32),
        value_fwds=[], value_dicts=[], capacity=1, dtype=dtype,
        filter_bounds=torch.cat([lo, lo + n // 3], dim=1).to(dev), value_raws=[],
    )
    S, n = 1, 1 << 20
    cases["single_point_dict_i32_K7_S1"] = dict(
        filter_fwd=ints(S, n, 3, torch.uint8), match=None, num_docs=nd(S, n),
        group_keys=ints(S, n, 7, torch.int32),
        value_fwds=[ints(S, n, 4096, torch.int32)], value_dicts=[floats(S, 4096)],
        capacity=7, dtype=dtype, filter_bounds=torch.tensor([[2, 3]], dtype=torch.int32, device=dev),
        value_raws=[None],
    )
    kmax = fg.max_capacity(fb, 3)
    S, n = 4, 1 << 18
    cases[f"docrange_raw_Kbound{kmax}_S4"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=ints(S, n, kmax, torch.int32),
        value_fwds=[None] * 3, value_dicts=[None] * 3, capacity=kmax, dtype=dtype,
        filter_bounds=torch.tensor([[0, n]] * S, dtype=torch.int32, device=dev),
        value_raws=[floats(S, n) for _ in range(3)],
    )

    def unaligned_docrange(S, n):
        lo = torch.randint(0, n // 4, (S, 1), generator=g, dtype=torch.int32) * 4 + 1
        hi = lo + torch.randint(n // 4, n // 2, (S, 1), generator=g, dtype=torch.int32) * 4 + 2
        return torch.cat([lo, hi], dim=1).to(dev)

    def remap(S, card, gcard):
        return torch.randint(0, gcard, (S, card), generator=g, dtype=torch.int32).to(dev)

    # group columns, combined in the kernel: 1, 2 and 3 columns, uint8 /
    # int16 / int32 global-id streams and remap-fed local fwd streams
    S, n = 16, 1 << 16
    cases["groupcols_u8x2_q1like_docrange_unaligned_S16"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=None,
        group_cols=[ints(S, n, 3, torch.uint8), ints(S, n, 2, torch.uint8)], group_cards=[3, 2],
        group_remaps=[None, None], value_fwds=[None] * 3, value_dicts=[None] * 3, capacity=6,
        dtype=dtype, filter_bounds=unaligned_docrange(S, n),
        value_raws=[floats(S, n), floats(S, n, 900.0, 105000.0), floats(S, n, 0.0, 0.1)],
    )
    cases["groupcols_u8_i16_i32_table_K24_S4"] = dict(
        filter_fwd=ints(4, n, 7, torch.uint8), match=(torch.rand((4, 8), generator=g) < 0.6).to(dev),
        num_docs=nd(4, n), group_keys=None,
        group_cols=[ints(4, n, 3, torch.uint8), ints(4, n, 4, torch.int16), ints(4, n, 2, torch.int32)],
        group_cards=[3, 4, 2], group_remaps=[None, None, None],
        value_fwds=[None], value_dicts=[None], capacity=24, dtype=dtype, value_raws=[floats(4, n)],
    )
    cases["groupcols_remap_u8_i16_count_only_K350_S4"] = dict(
        filter_fwd=ints(4, n, 200, torch.int16), match=None, num_docs=nd(4, n), group_keys=None,
        group_cols=[ints(4, n, 8, torch.uint8), ints(4, n, 300, torch.int16)], group_cards=[7, 50],
        group_remaps=[remap(4, 8, 7), remap(4, 300, 50)], value_fwds=[], value_dicts=[],
        capacity=350, dtype=dtype,
        filter_bounds=torch.tensor([[20, 150]] * 4, dtype=torch.int32, device=dev),
        value_raws=[],
    )
    cases["groupcols_remap_i32_dict_interval_K9_S2"] = dict(
        filter_fwd=ints(2, n, 50, torch.uint8), match=None, num_docs=nd(2, n), group_keys=None,
        group_cols=[ints(2, n, 12, torch.int32)], group_cards=[9], group_remaps=[remap(2, 12, 9)],
        value_fwds=[ints(2, n, 40, torch.uint8)], value_dicts=[floats(2, 40)], capacity=9, dtype=dtype,
        filter_bounds=torch.tensor([[25, 50], [0, 10]], dtype=torch.int32, device=dev), value_raws=[None],
    )
    # the private tier's boundary: the largest K it takes with one value
    # column, and one more (another tier)
    kp = max(k for k in range(1, 4096) if fg.shared_bytes("private", fb, k, 1) <= fg.PRIVATE_SHARED_BYTES)
    for K in (kp, kp + 1):
        cases[f"private_boundary_K{K}_{fg.choose_tier(fb, K, 1)}_S4"] = dict(
            filter_fwd=ints(4, n, 7, torch.uint8), match=None, num_docs=nd(4, n),
            group_keys=ints(4, n, K + 2, torch.int32), value_fwds=[None], value_dicts=[None],
            capacity=K, dtype=dtype, filter_bounds=torch.tensor([[1, 6]] * 4, dtype=torch.int32, device=dev),
            value_raws=[floats(4, n)],
        )
    # count-only at north_star's K over a mask-as-match-table filter
    S, n = 16, 1 << 15
    cases["mask_table_count_only_K1024_S16"] = dict(
        filter_fwd=ints(S, n, 2, torch.uint8), match=torch.tensor([[False, True]] * S, device=dev),
        num_docs=nd(S, n), group_keys=ints(S, n, 1024, torch.int32), value_fwds=[], value_dicts=[],
        capacity=1024, dtype=dtype, value_raws=[],
    )
    # n_pad not a multiple of 16 (vector body with a partial chunk) and
    # not a multiple of 4 (every row through the scalar loop), ragged
    # num_docs with an empty segment; n_pad = 8
    for n in (1000, 1001, 8):
        S = 3
        docs = torch.tensor([n, max(0, n - 5), 0], dtype=torch.int32, device=dev)
        cases[f"npad{n}_groupcols_S3_ragged"] = dict(
            filter_fwd=ints(S, n, 7, torch.int32), match=None, num_docs=docs, group_keys=None,
            group_cols=[ints(S, n, 3, torch.uint8), ints(S, n, 5, torch.int16)], group_cards=[3, 5],
            group_remaps=[None, None], value_fwds=[ints(S, n, 20, torch.int16), None],
            value_dicts=[floats(S, 20), None], capacity=15, dtype=dtype,
            filter_bounds=torch.tensor([[1, 6]] * S, dtype=torch.int32, device=dev),
            value_raws=[None, floats(S, n)],
        )
    return cases


def k1_probe_shapes(dev) -> Dict[str, dict]:
    """K1 inputs at the main path's widths (SEGMENTS x ROWS_PER_SEGMENT,
    x32), made on the card from a seed: q1's (two uint8 group columns,
    docrange, three raw floats), the same with a precombined key, and the
    count-only launches over a {0, 1} mask at K = 3 and 1024."""
    g = torch.Generator(device=dev).manual_seed(99)
    S, n = SEGMENTS, ROWS_PER_SEGMENT
    u8 = lambda hi: torch.randint(0, hi, (S, n), generator=g, device=dev, dtype=torch.uint8)  # noqa: E731
    f32 = lambda: torch.rand((S, n), generator=g, device=dev, dtype=torch.float32)  # noqa: E731
    nd = torch.full((S,), n, dtype=torch.int32, device=dev)
    rf, ls = u8(3), u8(2)
    q1 = dict(filter_fwd=None, match=None, num_docs=nd, group_keys=None, group_cols=[rf, ls],
              group_cards=[3, 2], group_remaps=[None, None], value_fwds=[None] * 3,
              value_dicts=[None] * 3, capacity=6, dtype=torch.float32,
              filter_bounds=torch.tensor([[0, n - 1000]] * S, dtype=torch.int32, device=dev),
              value_raws=[f32(), f32(), f32()])
    keyed = dict(q1, group_keys=(rf.int() * 2 + ls.int()).contiguous(), group_cols=None,
                 group_cards=None, group_remaps=None)
    mask = u8(2)
    match = torch.tensor([[False, True]] * S, device=dev)
    count = lambda K: dict(  # noqa: E731
        filter_fwd=mask, match=match, num_docs=nd,
        group_keys=torch.randint(0, K, (S, n), generator=g, device=dev, dtype=torch.int32),
        value_fwds=[], value_dicts=[], capacity=K, dtype=torch.float32, value_raws=[])
    return {"q1_group_cols": q1, "q1_precombined_key": keyed, "count_only_K3": count(3),
            "count_only_K1024": count(1024)}


# ---------------------------------------------------------------------------
# The float64 host oracle
# ---------------------------------------------------------------------------


def _labels(seg, col):
    """(per-row label index, sorted label list) for a string column."""
    d = seg.column(col).dictionary
    return seg.column(col).fwd, list(d.values)


def oracle(segments, name):
    """{group tuple: {"count": int, <agg display name>: float}} in float64
    from the host segments, independently of the engine."""
    acc = {}

    def add(keys, mask, labels, sums):
        sel = keys[mask]
        cnt = np.bincount(sel, minlength=len(labels))
        tot = {k: np.bincount(sel, weights=v[mask], minlength=len(labels)) for k, v in sums.items()}
        for i, lab in enumerate(labels):
            if cnt[i] == 0:
                continue
            e = acc.setdefault(lab, {"count": 0, **{k: 0.0 for k in sums}})
            e["count"] += int(cnt[i])
            for k in sums:
                e[k] += float(tot[k][i])

    for seg in segments:
        def vals(col):
            c = seg.column(col)
            return np.asarray(c.dictionary.values, dtype=np.float64)[c.fwd]

        if name == "q1":
            c = seg.column("l_shipdate")
            ok = np.array([v <= "1998-09-02" for v in c.dictionary.values])
            mask = ok[c.fwd]
            rf, rfl = _labels(seg, "l_returnflag")
            ls, lsl = _labels(seg, "l_linestatus")
            keys = rf.astype(np.int64) * len(lsl) + ls
            labels = [(a, b) for a in rfl for b in lsl]
            add(keys, mask, labels, {
                "sum_l_quantity": vals("l_quantity"),
                "sum_l_extendedprice": vals("l_extendedprice"),
                "sum_l_discount": vals("l_discount"),
            })
        elif name == "q3":
            c = seg.column("l_returnflag")
            mask = np.array([v == "R" for v in c.dictionary.values])[c.fwd]
            sm, sml = _labels(seg, "l_shipmode")
            add(sm.astype(np.int64), mask, [(x,) for x in sml], {
                "sum_l_extendedprice": vals("l_extendedprice"),
                "sum_l_quantity": vals("l_quantity"),
            })
        elif name == "range_unsorted":
            mask = vals("l_quantity") > 25
            rf, rfl = _labels(seg, "l_returnflag")
            add(rf.astype(np.int64), mask, [(x,) for x in rfl], {
                "sum_l_extendedprice": vals("l_extendedprice"),
            })
        else:  # torch_op
            sm = seg.column("l_shipmode")
            qty = vals("l_quantity")
            mask = (qty > 45) | np.array([v == "AIR" for v in sm.dictionary.values])[sm.fwd]
            rf, rfl = _labels(seg, "l_returnflag")
            ls, lsl = _labels(seg, "l_linestatus")
            keys = rf.astype(np.int64) * len(lsl) + ls
            add(keys, mask, [(a, b) for a in rfl for b in lsl], {
                "sum_l_extendedprice": vals("l_extendedprice"),
            })
            for k, lab in enumerate([(a, b) for a in rfl for b in lsl]):
                sel = qty[mask & (keys == k)]
                if sel.size:
                    e = acc[lab]
                    e["min_l_quantity"] = min(e.get("min_l_quantity", math.inf), float(sel.min()))
    return acc


def check_response(resp, want) -> float:
    """Counts and groups exact, sums within the audit band; returns the
    largest relative sum error."""
    worst = 0.0
    for ar in resp.aggregation_results:
        got = {tuple(g.group): g.value for g in ar.group_by_result}
        if set(got) != set(want):
            raise AssertionError(f"{ar.function}: groups {sorted(got)} != {sorted(want)}")
        for key, v in got.items():
            if ar.function == "count_star":
                if int(v) != want[key]["count"]:
                    raise AssertionError(f"count {key}: {v} != {want[key]['count']}")
                continue
            if ar.function.startswith("min_"):
                if float(v) != want[key][ar.function]:
                    raise AssertionError(f"{ar.function} {key}: {v} != {want[key][ar.function]}")
                continue
            w = want[key][ar.function]
            if not math.isclose(float(v), w, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
                raise AssertionError(f"{ar.function} {key}: {v} vs oracle {w}")
            worst = max(worst, abs(float(v) - w) / max(abs(w), 1e-30))
    return worst


def k1_bytes(args: dict):
    """(rows, bytes, bytes per row) K1 must read and move for these
    inputs: every row it
    has to read (rows below num_docs, inside the doc interval for
    docrange) read once per input, each dictionary / match table once,
    outputs written once.  The key costs its precombined int32 stream, or,
    when the kernel combines it, each group column's own width and each
    remap table once."""
    nd = args["num_docs"].long().cpu()
    lead = args["group_keys"] if args["group_keys"] is not None else args["group_cols"][0]
    n_pad = lead.shape[1]
    if args["filter_fwd"] is None:
        b = args["filter_bounds"].long().cpu()
        lo = b[:, 0].clamp(min=0)
        hi = torch.minimum(b[:, 1], nd)
        rows = int((hi - lo).clamp(min=0).sum())
        per_row = 0
    else:
        rows = int(nd.clamp(max=n_pad).sum())
        per_row = args["filter_fwd"].element_size()
    tables = 0
    if args["group_keys"] is not None:
        per_row += 4  # int32 group key
    else:
        for g, r in zip(args["group_cols"], args.get("group_remaps") or [None] * len(args["group_cols"])):
            per_row += g.element_size()
            if r is not None:
                tables += r.numel() * r.element_size()
    for f, d, r in zip(args["value_fwds"], args["value_dicts"], args["value_raws"]):
        if r is not None:
            per_row += r.element_size()
        else:
            per_row += f.element_size()
            tables += d.numel() * d.element_size()
    if args["match"] is not None:
        tables += args["match"].numel()
    fb = 8 if args["dtype"] == torch.float64 else 4
    K = args["capacity"]
    out = 8 + 8 * K + fb * K * len(args["value_raws"])
    return rows, rows * per_row + tables + out, per_row


def k1_bound(args: dict):
    """(bound ms, "bytes" or "operations", bytes, operations) for these
    inputs: the larger of the bytes over the memory rate and the scalar
    operations over the non-tensor-core rate.  Operations per row read:
    the filter test (two compares; none for docrange, whose rows outside
    the interval are never read), the key combine (a multiply and an add
    per group column past the first), the key range check (two), the count
    add and one add per value column."""
    rows, nbytes, _ = k1_bytes(args)
    combine = 0 if args["group_keys"] is not None else 2 * (len(args["group_cols"]) - 1)
    per_row = (0 if args["filter_fwd"] is None else 2) + combine + 3 + len(args["value_raws"])
    ops = rows * per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


# ---------------------------------------------------------------------------
# K2 against its plain version
# ---------------------------------------------------------------------------


def k2_cases(dev):
    """K = 300, 1024, 6144, 16384 and 2^18 over S = 16 segments with ragged
    num_docs (the tail past each carries the sentinel) and 5 % sentinel
    entries; one hot bin at S = 1; an all-sentinel stream; an empty stream;
    a stream starting 4 bytes past an aligned address, of odd length, with
    indexes below 0 and above K."""
    g = torch.Generator(device="cpu").manual_seed(4321)
    cases = {}
    S, n = 16, 1 << 16
    for K in (300, 1024, 6144, 16384, 1 << 18):
        idx = torch.randint(0, K, (S, n), generator=g, dtype=torch.int32)
        idx[torch.rand((S, n), generator=g) < 0.05] = K
        for s in range(S):
            idx[s, n - (s * 997) % (n // 3 + 1):] = K
        cases[f"K{K}_S16_ragged_5pct_sentinel"] = (idx.to(dev), K)
    hot = torch.randint(0, 300, (1, 1 << 22), generator=g, dtype=torch.int32)
    hot[torch.rand((1, 1 << 22), generator=g) < 0.9] = 7
    cases["K300_S1_hot_bin"] = (hot.to(dev), 300)
    cases["K16384_S1_all_sentinel"] = (torch.full((1, 1 << 20), 16384, dtype=torch.int32, device=dev), 16384)
    cases["K1024_empty"] = (torch.zeros(0, dtype=torch.int32, device=dev), 1024)
    odd = torch.randint(-3, 6147, ((1 << 20) + 7,), generator=g, dtype=torch.int32).to(dev)
    cases["K6144_unaligned_odd_out_of_range"] = (odd[1:], 6144)
    return cases


def compare_k2(vsc, idx, K: int) -> float:
    """Kernel vs torch.bincount over the in-range entries and vs the plain
    version: bit-equal, and two launches bit-identical.  Returns the
    largest absolute difference from the plain version (0)."""
    a = vsc.value_state_counts(idx, K)
    b = vsc.value_state_counts(idx, K)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("two launches of the value-state kernel differ")
    flat = idx.reshape(-1)
    want = torch.bincount(flat[(flat >= 0) & (flat < K)], minlength=K)
    if not torch.equal(a, want):
        raise AssertionError(f"counts differ from torch.bincount (K={K})")
    ref = vsc.value_state_counts_reference(idx, K)
    if not torch.equal(a, ref):
        raise AssertionError(f"counts differ from the plain version (K={K})")
    return float((a - ref).abs().max()) if K else 0.0


def k2_bound(idx, K: int):
    """(bound ms, "bytes" or "operations", bytes, operations): each index
    read once (4 B) and each int64 count written once; about three integer
    operations per index (the range test and the add)."""
    nbytes = 4 * idx.numel() + 8 * K
    ops = 3 * idx.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


# ---------------------------------------------------------------------------
# Exact host oracles of the value-state answers
# ---------------------------------------------------------------------------


def _present(column, rows=None) -> List[Any]:
    """Distinct values of a column over ``rows`` (all rows when None)."""
    fwd = column.fwd if rows is None else column.fwd[rows]
    seen = np.bincount(fwd, minlength=column.dictionary.cardinality) > 0
    return np.asarray(column.dictionary.values)[seen].tolist()


def _group_counts(seg, gcol: str, vcol: str, rows=None) -> Dict[Any, Tuple[np.ndarray, List[Any]]]:
    """{group value: (counts over vcol's dictionary, its values)}."""
    g, v = seg.column(gcol), seg.column(vcol)
    gf, vf = (g.fwd, v.fwd) if rows is None else (g.fwd[rows], v.fwd[rows])
    card = v.dictionary.cardinality
    cnt = np.bincount(gf.astype(np.int64) * card + vf, minlength=g.dictionary.cardinality * card)
    cnt = cnt.reshape(-1, card)
    return {g.dictionary.get(i): (cnt[i], list(v.dictionary.values)) for i in range(cnt.shape[0])}


def _rows_where(seg, col: str, pred) -> np.ndarray:
    c = seg.column(col)
    return np.array([pred(x) for x in c.dictionary.values], dtype=bool)[c.fwd]


def value_oracle(hll_mod, segments, name: str) -> Dict[Tuple[str, ...], Any]:
    """{group tuple (() when ungrouped): exact answer}: distinct counts from
    the set of matched values, percentiles as sorted[int(n p / 100)] over
    the matched values, HLL estimates from registers that the port's own
    hashing builds over the set of matched values."""
    if name in ("distinct_price", "hll_price"):
        seen = set()
        for seg in segments:
            if name == "distinct_price":
                q = seg.column("l_quantity")
                rows = (np.asarray(q.dictionary.values, dtype=np.float64) > 25)[q.fwd]
            else:
                rows = _rows_where(seg, "l_shipmode", lambda v: v == "AIR")
            seen.update(_present(seg.column("l_extendedprice"), rows))
        if name == "distinct_price":
            return {(): len(seen)}
        return {(): int(hll_mod.estimate_from_registers(hll_mod.registers_from_values(seen)))}
    if name == "hll_groupby":
        sets: Dict[Any, set] = {}
        for seg in segments:
            for label, (cnt, values) in _group_counts(seg, "l_returnflag", "l_shipdate").items():
                sets.setdefault(label, set()).update(v for v, c in zip(values, cnt) if c)
        return {
            (label,): int(hll_mod.estimate_from_registers(hll_mod.registers_from_values(vals)))
            for label, vals in sets.items() if vals
        }
    if name == "pct_quantity":
        hists: Dict[Any, Dict[float, int]] = {}
        for seg in segments:
            for label, (cnt, values) in _group_counts(seg, "l_shipmode", "l_quantity").items():
                h = hists.setdefault(label, {})
                for v, c in zip(values, cnt):
                    h[float(v)] = h.get(float(v), 0) + int(c)
        out = {}
        for label, h in hists.items():
            vals = sorted(v for v, c in h.items() if c)
            cum = np.cumsum([h[v] for v in vals])
            if vals:
                idx = min(int(cum[-1] * 90 / 100.0), int(cum[-1]) - 1)
                out[(label,)] = vals[int(np.searchsorted(cum, idx, side="right"))]
        return out
    raise ValueError(name)


def north_star_oracle(hll_mod, segments) -> Dict[Tuple[str, ...], int]:
    """Per campaign, HLL registers over the users of its rows (the port's
    per-dictionary hash tables, max rank per register), then estimates."""
    m = hll_mod.M
    present = None
    for seg in segments:
        camp = seg.column("campaign_id")
        user = seg.column("user_id")
        cvals = np.asarray(camp.dictionary.values, dtype=np.int64)
        bt, rt = hll_mod.dictionary_tables(user.dictionary)
        ncamp = int(cvals.max()) + 1
        key = (cvals[camp.fwd] * m + bt[user.fwd]) * 64 + rt[user.fwd]
        hit = np.bincount(key, minlength=ncamp * m * 64) > 0
        present = hit if present is None else present | hit
    regs = (present.reshape(-1, m, 64) * np.arange(64)).max(axis=2).astype(np.uint8)
    ests = hll_mod.estimate_from_registers(regs)
    rows = present.reshape(-1, m * 64).any(axis=1)
    return {(str(c),): int(ests[c]) for c in np.nonzero(rows)[0]}


def check_value_response(resp, want: Dict[Tuple[str, ...], Any], top_n: int = 10) -> None:
    """The one aggregation's answer equals the oracle exactly: the value
    when ungrouped, else the top_n groups in the broker's order (value
    descending, then group key) with their values."""
    (ar,) = resp.aggregation_results
    if ar.group_by_result is None:
        if ar.value != want[()]:
            raise AssertionError(f"{ar.function}: {ar.value} != oracle {want[()]}")
        return
    got = [(tuple(g.group), g.value) for g in ar.group_by_result]
    exp = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    if got != exp:
        raise AssertionError(f"{ar.function}: {got} != oracle {exp}")


def partials_of(result) -> list:
    """Every group's partials as plain values, for a bit-for-bit compare."""
    return [(k, [sorted(vars(p).items()) for p in ps]) for k, ps in sorted(result.groups.items())]


def profile_query(fn, name: str, runs: int = 5) -> dict:
    """Trace ``runs`` calls with torch.profiler: device time per kernel
    name (summed over the runs), the host wall time of the window, and
    the device's busy share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, memsets): a CPU op's
        # self device time repeats the time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            by_kernel[ev.key] = float(us)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {name}: {runs} runs, wall {wall_us / runs / 1e3:.4f} ms per query, device busy "
        f"{busy_us / runs / 1e3:.4f} ms per query ({busy_us / wall_us:.3f} of wall)")
    for k, us in top:
        log(f"  {us / runs / 1e3:9.4f} ms/query  {k[:100]}")
    return {"runs": runs, "wall_ms_per_query": wall_us / runs / 1e3,
            "device_busy_ms_per_query": busy_us / runs / 1e3, "busy_share": busy_us / wall_us,
            "device_ms_per_query_by_kernel": {k: us / runs / 1e3 for k, us in by_kernel.items()}}


def _capture(module, name: str, into: dict, key: str):
    """Replace module.name by a wrapper that records its arguments in
    ``into[key]``; returns the function to restore."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        into[key] = (a, k)
        return real(*a, **k)

    setattr(module, name, wrapper)
    return real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the measurements as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few runs of each query with torch.profiler: "
                    "device time by kernel and the device's busy share")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building the kernels and checking each against its plain "
                    "version (no queries, no timings, no result line)")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0), opts)


def run(dev: torch.device, opts) -> int:
    """Every phase on ``dev`` (main() passes the one card)."""
    from pinot_tpu_torch.engine import hll as hll_mod
    from pinot_tpu_torch.engine import kernel as kernel_mod
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.kernels import fused_groupby as fg
    from pinot_tpu_torch.engine.kernels import value_state_counts as vsc
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.tools.datagen import (
        synthetic_adevents_segment,
        synthetic_lineitem_segment,
        tile_segments,
    )

    record = {}
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    record["card"] = card

    # 1. build every kernel: one nvcc per source, all started together
    t0 = time.perf_counter()
    kernels.build(kernels.KERNELS)
    for name in kernels.KERNELS:
        kernels.load(name)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s for {', '.join(kernels.KERNELS)}")
    for name, text in kernels.build_logs.items():
        usage = sorted({ln.split("info    :")[-1].strip() for ln in text.splitlines() if "Used" in ln})
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln})
        log(f"  ptxas[{name}]: {usage} {spills}")
    record["build_s"] = build_s

    # 2. each kernel against its plain version on the card
    record["k1_checks"] = {}
    for mode, dtype, rtol, atol in (
        ("x32", torch.float32, AUDIT_RTOL, AUDIT_ATOL),
        ("x64", torch.float64, X64_RTOL, X64_ATOL),
    ):
        for cname, args in k1_cases(fg, dev, dtype).items():
            err, tiers = compare_k1(fg, args, rtol, atol)
            log(f"k1 check {mode} {cname}: ok in tiers {tiers}, deterministic, max_abs_err {err:.6g}")
            record["k1_checks"][f"{mode}/{cname}"] = {"max_abs_err": err, "tiers": tiers}
    record["k2_checks"] = {}
    for cname, (idx, K) in k2_cases(dev).items():
        err = compare_k2(vsc, idx, K)
        log(f"k2 check {cname}: ok, equal to torch.bincount and the plain version, "
            f"deterministic, max_abs_err {err:.6g}")
        record["k2_checks"][cname] = err
    torch.cuda.synchronize()
    if opts.kernels_only:
        # every K1 tier at the main path's widths on data made on the card
        for pname, args in k1_probe_shapes(dev).items():
            bound, bound_by, nbytes, _ = k1_bound(args)
            for tier in k1_tiers(fg, args):
                ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args, tier=tier), ITERS)
                log(f"k1 probe {pname} tier {tier}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}, "
                    f"{nbytes / (ms / 1e3) / 1e12:.3f} TB/s)")
            del args
            torch.cuda.empty_cache()
        log(f"kernels only: build, checks and probes done in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 3. the paths at full size, x32 as the TPU served
    t0 = time.perf_counter()
    segments = [
        synthetic_lineitem_segment(ROWS_PER_SEGMENT, seed=11 + i, name=f"li{i}")
        for i in range(SEGMENTS)
    ]
    total_rows = sum(s.num_docs for s in segments)
    log(f"datagen: {SEGMENTS} x {ROWS_PER_SEGMENT} = {total_rows} rows "
        f"in {time.perf_counter() - t0:.1f} s")
    ex = QueryExecutor(device=dev, precision="x32")
    parse = lambda pql: optimize_request(parse_pql(pql))  # noqa: E731
    requests = {k: parse(v) for k, v in QUERIES.items()}
    value_requests = {k: parse(v) for k, v in VALUE_QUERIES.items()}
    torch_op_request = parse(TORCH_OP_QUERY)

    def drive(path: str, reqs: dict, segs, need: dict) -> dict:
        """One run of a path: every launch count 0 just before, read just
        after; each query must have launched each kernel in ``need``."""
        fg.launches = 0
        vsc.launches = 0
        kernel_mod.fused_dispatches = 0
        per_query = {}
        out = {}
        t = time.perf_counter()
        for name, req in reqs.items():
            k1_before, k2_before = fg.launches, vsc.launches
            out[name] = reduce_to_response(req, [ex.execute(segs, req)])
            per_query[name] = {"k1": fg.launches - k1_before, "k2": vsc.launches - k2_before}
            for kern in need.get(name, ()):
                if per_query[name][kern] < 1:
                    raise AssertionError(f"{path}/{name}: kernel {kern} was not launched")
        torch.cuda.synchronize()
        totals = {"k1": fg.launches, "k2": vsc.launches}
        log(f"path {path} (staging included): {time.perf_counter() - t:.1f} s, "
            f"launches per query {per_query}, total {totals}")
        record.setdefault("paths", {})[path] = {"launches": per_query, "totals": totals}
        return out

    # 3a. slice 1: Q1, Q3, RANGE through K1's fused route, which combines
    # the group key inside the kernel: no torch-op key combine may run
    def no_key_combine(*a, **k):
        raise AssertionError("the fused route combined the group key with torch ops")

    real_group_keys, kernel_mod._group_keys = kernel_mod._group_keys, no_key_combine
    try:
        responses = drive("q1_q3_range", requests, segments, {n: ("k1",) for n in QUERIES})
    finally:
        kernel_mod._group_keys = real_group_keys
    if kernel_mod.fused_dispatches != len(QUERIES):
        raise AssertionError(f"{kernel_mod.fused_dispatches} fused dispatches for {len(QUERIES)} queries")
    record["oracle_max_rel_err"] = {}
    for name in QUERIES:
        worst = check_response(responses[name], oracle(segments, name))
        log(f"oracle {name}: ok (max rel sum err {worst:.3g})")
        record["oracle_max_rel_err"][name] = worst

    # 3b. slice 2: the value-state queries, every one through K2
    value_responses = drive("value_state", value_requests, segments,
                            {n: ("k2",) for n in VALUE_QUERIES})
    for name in VALUE_QUERIES:
        check_value_response(value_responses[name], value_oracle(hll_mod, segments, name))
        log(f"oracle {name}: ok, exact ({value_responses[name].aggregation_results[0].to_json()})"[:400])

    # 3c. the torch-op route: group sums through K1 over the mask, twice
    first = ex.execute(segments, torch_op_request)
    drive("torch_op", {"torch_op": torch_op_request}, segments, {"torch_op": ("k1",)})
    second = ex.execute(segments, torch_op_request)
    if partials_of(first) != partials_of(second):
        raise AssertionError("torch_op: two runs differ")
    worst = check_response(reduce_to_response(torch_op_request, [second]), oracle(segments, "torch_op"))
    log(f"torch_op: two runs bit-identical; oracle ok (max rel sum err {worst:.3g})")
    record["oracle_max_rel_err"]["torch_op"] = worst

    # 3d. the north-star HLL group-by: HLL streams, the sort lowering
    t0 = time.perf_counter()
    ad_distinct = [
        synthetic_adevents_segment(ROWS_PER_SEGMENT, seed=7 + i, name=f"ad{i}",
                                   campaign_card=AD_CAMPAIGNS, user_card=AD_USERS)
        for i in range(AD_DISTINCT)
    ]
    ad_segments = tile_segments(ad_distinct, SEGMENTS)
    for s in ad_distinct:  # the per-dictionary hashing, once, outside the timed path
        hll_mod.dictionary_tables(s.column("user_id").dictionary)
    log(f"datagen + user hashing: {AD_DISTINCT} distinct x {ROWS_PER_SEGMENT} rows tiled to "
        f"{SEGMENTS} segments in {time.perf_counter() - t0:.1f} s")
    ns_request = parse(NORTH_STAR)
    ns = drive("north_star", {"north_star": ns_request}, ad_segments, {"north_star": ("k1",)})
    if record["paths"]["north_star"]["totals"]["k2"]:
        raise AssertionError("north_star: the sort lowering launched the value-state kernel")
    check_value_response(ns["north_star"], north_star_oracle(hll_mod, ad_segments))
    log("oracle north_star: ok, exact")
    log(f"staged on the card: {ex.staged_bytes()} bytes")
    record.update(staged_bytes=ex.staged_bytes(), total_rows=total_rows)

    # 4. timing: whole queries, then each kernel at each query's shapes
    all_requests = {**requests, **value_requests, "torch_op": torch_op_request}
    record["query_ms"] = {}
    for name, req in {**all_requests, "north_star": ns_request}.items():
        segs = ad_segments if name == "north_star" else segments
        ms, _ = cuda_ms(lambda: reduce_to_response(req, [ex.execute(segs, req)]), ITERS)
        log(f"query {name}: {ms:.3f} ms median of {ITERS}, {total_rows / (ms / 1e3):.4g} rows/s")
        record["query_ms"][name] = ms
    if opts.profile:
        record["profile"] = {}
        for name, req in {**all_requests, "north_star": ns_request}.items():
            segs = ad_segments if name == "north_star" else segments
            record["profile"][name] = profile_query(
                lambda: reduce_to_response(req, [ex.execute(segs, req)]), name
            )
            kernel_names = record["profile"][name]["device_ms_per_query_by_kernel"]
            if any("fused_groupby_reduce" in kn for kn in kernel_names):
                raise AssertionError(f"{name}: K1 ran a second reduce kernel")

    # K1 at each of its seven launch shapes on the main path: the fused
    # route's (the key combined in the kernel) and the torch-op route's
    # group counts and sums over the evaluated mask
    captured = {}
    record["k1"] = {}
    k1_queries = {**requests, "hll_groupby": value_requests["hll_groupby"],
                  "pct_quantity": value_requests["pct_quantity"], "torch_op": torch_op_request,
                  "north_star": ns_request}
    names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
    for name, req in k1_queries.items():
        captured.clear()
        restore = (_capture(fg, "fused_filtered_groupby_sums", captured, "k1"),
                   _capture(kernel_mod, "_group_keys", captured, "keys"))
        try:
            ex.execute(ad_segments if name == "north_star" else segments, req)
        finally:
            fg.fused_filtered_groupby_sums, kernel_mod._group_keys = restore
        a, k = captured["k1"]
        args = {**dict(zip(names, a)), **k}
        fused = name in QUERIES
        if fused and (args["group_keys"] is not None or "keys" in captured):
            raise AssertionError(f"{name}: the fused route did not hand K1 the group columns")
        err, tiers = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
        tier = fg.choose_tier(*k1_shape(fg, args))
        k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
        tier_ms = {t: cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args, tier=t), ITERS)[0]
                   for t in tiers}
        p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), 3, warmup=1)
        key_ms = None
        if "keys" in captured:  # the torch-op route still combines its key (min/max need it)
            ka, kk = captured["keys"]
            key_ms, _ = cuda_ms(lambda: restore[1](*ka, **kk), ITERS)
        bound, bound_by, nbytes, ops = k1_bound(args)
        read_ms = None
        if name == "q1":  # the practical ceiling: one plain streaming read of a float32 stream
            raw = args["value_raws"][0]
            read_ms, _ = cuda_ms(lambda: raw.sum(), ITERS)
            raw_bytes = raw.numel() * raw.element_size()
            log(f"k1 q1 yardstick: torch.sum over one {raw_bytes} B float32 stream {read_ms:.4f} ms, "
                f"{raw_bytes / (read_ms / 1e3) / 1e12:.3f} TB/s")
        key_form = ("group_cols " + "+".join(str(g.dtype).replace("torch.", "") for g in args["group_cols"])
                    if fused else "precombined int32 key")
        log(f"k1 {name} ({key_form}, K={args['capacity']}, nv={len(args['value_dicts'])}, tier {tier}): "
            f"{k_ms:.4f} ms (bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; "
            f"{bound / k_ms:.3f} of the bound, {nbytes / (k_ms / 1e3) / 1e12:.3f} TB/s), tiers "
            f"{ {t: round(v, 4) for t, v in tier_ms.items()} }, plain {p_ms:.4f} ms, key combine "
            f"{'none (in the kernel)' if key_ms is None else f'{key_ms:.4f} ms'}, max_abs_err {err:.6g}")
        record["k1"][name] = dict(ms=k_ms, tier=tier, tier_ms=tier_ms, plain_ms=p_ms, bound_ms=bound,
                                  bound_by=bound_by, bytes=nbytes, operations=ops, key_combine_ms=key_ms,
                                  key_form=key_form, max_abs_err=err, stream_read_ms=read_ms)

    record["k2"] = {}
    for name, req in value_requests.items():
        restore = (_capture(vsc, "value_state_counts", captured, "k2"),
                   _capture(kernel_mod, "_value_state_index", captured, "index"))
        try:
            ex.execute(segments, req)
        finally:
            vsc.value_state_counts, kernel_mod._value_state_index = restore
        (idx, K), _ = captured["k2"]
        err = compare_k2(vsc, idx, K)
        k_ms, _ = cuda_ms(lambda: vsc.value_state_counts(idx, K), ITERS)
        p_ms, _ = cuda_ms(lambda: vsc.value_state_counts_reference(idx, K), ITERS)
        lib_ms, _ = cuda_ms(lambda: torch.bincount(idx.reshape(-1), minlength=K + 1)[:K], ITERS)
        ia, ik = captured["index"]
        idx_ms, _ = cuda_ms(lambda: restore[1](*ia, **ik), ITERS)
        bound, bound_by, nbytes, ops = k2_bound(idx, K)
        route = "shared" if vsc.uses_shared_memory(K) else "global"
        log(f"k2 {name}: K={K} ({route}), {idx.numel()} indexes: {k_ms:.4f} ms (bound {bound:.4f} ms "
            f"by {bound_by}: {nbytes} bytes, {ops} operations; {nbytes / (k_ms / 1e3) / 1e12:.3f} TB/s), "
            f"plain {p_ms:.4f} ms, torch.bincount {lib_ms:.4f} ms, index combine {idx_ms:.4f} ms, "
            f"max_abs_err {err:.6g}")
        record["k2"][name] = dict(K=K, route=route, indexes=idx.numel(), ms=k_ms, plain_ms=p_ms,
                                  library_ms=lib_ms, index_combine_ms=idx_ms, bound_ms=bound,
                                  bound_by=bound_by, bytes=nbytes, operations=ops, max_abs_err=err)

    launches = {"k1": 0, "k2": 0}
    for path in record["paths"].values():
        for kern in launches:
            launches[kern] += path["totals"][kern]
    q1, hg = record["k1"]["q1"], record["k2"]["hll_groupby"]
    summary = {"kernels": [
        {
            "name": "fused_filtered_groupby_sums",
            "route": "cuda",
            "source": "pinot_tpu_torch/csrc/fused_groupby.cu",
            "replaces": "pinot_tpu/engine/pallas_kernels.py:95",
            "launches": launches["k1"],
            "max_abs_err": q1["max_abs_err"],
            "ms": q1["ms"],
            "plain_ms": q1["plain_ms"],
            "bound_ms": q1["bound_ms"],
            "bound_by": q1["bound_by"],
            "library_ms": None,
        },
        {
            "name": "value_state_counts",
            "route": "cuda",
            "source": "pinot_tpu_torch/csrc/value_state_counts.cu",
            "replaces": "pinot_tpu/engine/kernel.py:130",
            "launches": launches["k2"],
            "max_abs_err": hg["max_abs_err"],
            "ms": hg["ms"],
            "plain_ms": hg["plain_ms"],
            "bound_ms": hg["bound_ms"],
            "bound_by": hg["bound_by"],
            "library_ms": hg["library_ms"],
        },
    ]}
    record["summary"] = summary
    record["wall_s"] = time.perf_counter() - t_start
    log(f"wall: {record['wall_s']:.1f} s")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(record, f, indent=1)
    log(json.dumps(summary))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
