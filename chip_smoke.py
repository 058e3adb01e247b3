#!/usr/bin/env python3
"""On-card smoke test and measurement of the PyTorch/CUDA port
(``pinot_tpu_torch``): builds the CUDA kernels from this checkout, holds
each against its plain torch version, answers TPC-H Q1, the Q3-shaped
query and an unsorted RANGE over 134,217,728 lineitem rows staged on one
card through parse -> optimize -> QueryExecutor.execute ->
reduce_to_response, checks every answer against a float64 numpy oracle,
and times the queries and the kernel.

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


def compare_k1(fg, args: dict, rtol: float, atol: float) -> float:
    """Kernel vs plain version on the same card tensors: num_docs and
    counts exact, sums in the band, and two kernel launches bit-identical.
    Returns the largest absolute sum error."""
    a = fg.fused_filtered_groupby_sums(**args)
    b = fg.fused_filtered_groupby_sums(**args)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))):
        raise AssertionError("two launches of the fused kernel differ")
    ref = fg.fused_filtered_groupby_sums_reference(**args)
    if int(a[0]) != int(ref[0]):
        raise AssertionError(f"num_docs {int(a[0])} != {int(ref[0])}")
    if not torch.equal(a[1].cpu(), ref[1].cpu()):
        raise AssertionError("group counts differ from the plain version")
    err = 0.0
    for x, y in zip(a[2], ref[2]):
        err = max(err, _close(x, y, rtol, atol))
    return err


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
    return cases


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
        else:
            mask = vals("l_quantity") > 25
            rf, rfl = _labels(seg, "l_returnflag")
            add(rf.astype(np.int64), mask, [(x,) for x in rfl], {
                "sum_l_extendedprice": vals("l_extendedprice"),
            })
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
            w = want[key][ar.function]
            if not math.isclose(float(v), w, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
                raise AssertionError(f"{ar.function} {key}: {v} vs oracle {w}")
            worst = max(worst, abs(float(v) - w) / max(abs(w), 1e-30))
    return worst


def k1_bytes(args: dict):
    """(rows, bytes) K1 must read and move for these inputs: every row it
    has to read (rows below num_docs, inside the doc interval for
    docrange) read once per input, each dictionary / match table once,
    outputs written once."""
    nd = args["num_docs"].long().cpu()
    n_pad = args["group_keys"].shape[1]
    if args["filter_fwd"] is None:
        b = args["filter_bounds"].long().cpu()
        lo = b[:, 0].clamp(min=0)
        hi = torch.minimum(b[:, 1], nd)
        rows = int((hi - lo).clamp(min=0).sum())
        per_row = 0
    else:
        rows = int(nd.clamp(max=n_pad).sum())
        per_row = args["filter_fwd"].element_size()
    per_row += 4  # int32 group key
    tables = 0
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
    return rows, rows * per_row + tables + out


def k1_bound(args: dict):
    """(bound ms, "bytes" or "operations", bytes, operations) for these
    inputs: the larger of the bytes over the memory rate and the scalar
    operations over the non-tensor-core rate.  Operations per row read:
    the filter test (two compares; none for docrange, whose rows outside
    the interval are never read), the key range check (two), the count
    add and one add per value column."""
    rows, nbytes = k1_bytes(args)
    per_row = (0 if args["filter_fwd"] is None else 2) + 3 + len(args["value_raws"])
    ops = rows * per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the measurements as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few runs of each query with torch.profiler: "
                    "device time by kernel and the device's busy share")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2

    from pinot_tpu_torch.engine import kernel as kernel_mod
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.kernels import fused_groupby as fg
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

    record = {}
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    record["card"] = card

    # 1. build the kernel of the path
    t0 = time.perf_counter()
    kernels.load("fused_groupby")
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s for fused_groupby")
    for name, text in kernels.build_logs.items():
        usage = sorted({ln.split("info    :")[-1].strip() for ln in text.splitlines() if "Used" in ln})
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln})
        log(f"  ptxas[{name}]: {usage} {spills}")
    record["build_s"] = build_s

    # 2. K1 against its plain version on the card, both modes
    record["k1_checks"] = {}
    for mode, dtype, rtol, atol in (
        ("x32", torch.float32, AUDIT_RTOL, AUDIT_ATOL),
        ("x64", torch.float64, X64_RTOL, X64_ATOL),
    ):
        for cname, args in k1_cases(fg, dev, dtype).items():
            err = compare_k1(fg, args, rtol, atol)
            log(f"k1 check {mode} {cname}: ok, deterministic, max_abs_err {err:.6g}")
            record["k1_checks"][f"{mode}/{cname}"] = err
    torch.cuda.synchronize()

    # 3. the slice at full size, x32 as the TPU served
    t0 = time.perf_counter()
    segments = [
        synthetic_lineitem_segment(ROWS_PER_SEGMENT, seed=11 + i, name=f"li{i}")
        for i in range(SEGMENTS)
    ]
    total_rows = sum(s.num_docs for s in segments)
    log(f"datagen: {SEGMENTS} x {ROWS_PER_SEGMENT} = {total_rows} rows "
        f"in {time.perf_counter() - t0:.1f} s")
    ex = QueryExecutor(device=dev, precision="x32")
    requests = {k: optimize_request(parse_pql(v)) for k, v in QUERIES.items()}

    # the main path, counted: every count 0 just before, read just after
    fg.launches = 0
    kernel_mod.fused_dispatches = 0
    main_launches = {}
    responses = {}
    t0 = time.perf_counter()
    for name, req in requests.items():
        before = fg.launches
        responses[name] = reduce_to_response(req, [ex.execute(segments, req)])
        main_launches[name] = fg.launches - before
        if main_launches[name] < 1:
            raise AssertionError(f"{name}: the fused kernel was not launched")
    torch.cuda.synchronize()
    total_launches = fg.launches
    log(f"main path (staging included): {time.perf_counter() - t0:.1f} s, "
        f"fused launches per query {main_launches}, total {total_launches}")
    staged = ex.staged_bytes()
    log(f"staged on the card: {staged} bytes")
    record.update(main_launches=main_launches, staged_bytes=staged, total_rows=total_rows)

    # answers against the float64 oracle
    record["oracle_max_rel_err"] = {}
    for name in QUERIES:
        worst = check_response(responses[name], oracle(segments, name))
        log(f"oracle {name}: ok (max rel sum err {worst:.3g})")
        record["oracle_max_rel_err"][name] = worst

    # 4. timing: whole queries, then K1 at each query's shapes
    record["query_ms"] = {}
    for name, req in requests.items():
        ms, _ = cuda_ms(lambda: reduce_to_response(req, [ex.execute(segments, req)]), ITERS)
        log(f"query {name}: {ms:.3f} ms median of {ITERS}, {total_rows / (ms / 1e3):.4g} rows/s")
        record["query_ms"][name] = ms
    if opts.profile:
        record["profile"] = {}
        for name, req in requests.items():
            record["profile"][name] = profile_query(
                lambda: reduce_to_response(req, [ex.execute(segments, req)]), name
            )

    captured = {}
    real_k1 = fg.fused_filtered_groupby_sums
    real_keys = kernel_mod._group_keys

    def capture_k1(*a, **k):
        names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
        captured["k1"] = {**dict(zip(names, a)), **k}
        return real_k1(*a, **k)

    def capture_keys(*a, **k):
        captured["keys"] = (a, k)
        return real_keys(*a, **k)

    record["k1"] = {}
    for name, req in requests.items():
        fg.fused_filtered_groupby_sums = capture_k1
        kernel_mod._group_keys = capture_keys
        try:
            ex.execute(segments, req)
        finally:
            fg.fused_filtered_groupby_sums = real_k1
            kernel_mod._group_keys = real_keys
        args = captured["k1"]
        err = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
        k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
        p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), ITERS)
        ka, kk = captured["keys"]
        key_ms, _ = cuda_ms(lambda: real_keys(*ka, **kk), ITERS)
        bound, bound_by, nbytes, ops = k1_bound(args)
        rows_key = args["group_keys"].numel()
        log(f"k1 {name}: {k_ms:.4f} ms (bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, "
            f"{ops} operations; {nbytes / (k_ms / 1e3) / 1e12:.3f} TB/s), plain {p_ms:.4f} ms, "
            f"key combine {key_ms:.4f} ms ({8 * rows_key} bytes written+read), max_abs_err {err:.6g}")
        record["k1"][name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                                  bytes=nbytes, operations=ops, key_combine_ms=key_ms,
                                  key_bytes=8 * rows_key, max_abs_err=err)

    q1 = record["k1"]["q1"]
    summary = {"kernels": [{
        "name": "fused_filtered_groupby_sums",
        "route": "cuda",
        "source": "pinot_tpu_torch/csrc/fused_groupby.cu",
        "replaces": "pinot_tpu/engine/pallas_kernels.py:95",
        "launches": total_launches,
        "max_abs_err": q1["max_abs_err"],
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": None,
    }]}
    record["summary"] = summary
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
