"""Time the value-state kernel's counts where the histogram lives in device
memory (K = 2^18 bins, the shape of ``percentile90(l_extendedprice)``),
over uniform indexes and over indexes with 90 % of the rows on 8 hot bins.

It goes through ``value_state_counts(flat_idx, K)``, the precombined form
that every version of the port's wrapper has, so the same file times an
older tree of the port too: copy it into that tree's
``pinot_tpu_torch/tools/`` and run it from that tree's root.

    python3 -m pinot_tpu_torch.tools.k2_contention [--rows-log2 27]

Needs one CUDA card.  The index is made on the card from a seed; each
result is checked against ``torch.bincount``.  Prints one JSON line per
shape: per-call ms (median of CUDA events around each call) and device
ms (torch.profiler, every kernel of the call).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from pinot_tpu_torch.engine.kernels import value_state_counts as vsc

K = 1 << 18
HOT_BINS = 8
HOT_SHARE = 0.9


def _per_call_ms(fn, iters: int) -> float:
    for _ in range(3):
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
    return float(sorted(times)[len(times) // 2])


def _device_ms(fn, runs: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            total += float(ev.self_cuda_time_total if us is None else us)
    return total / runs / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-log2", type=int, default=27, help="log2 of the index length (default 2^27)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_contention needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    n = 1 << opts.rows_log2
    g = torch.Generator(device=dev).manual_seed(opts.seed)
    uniform = torch.randint(0, K, (n,), generator=g, device=dev, dtype=torch.int32)
    hot_ids = torch.randint(0, HOT_BINS, (n,), generator=g, device=dev, dtype=torch.int32) * 4099
    hot = torch.where(torch.rand((n,), generator=g, device=dev) < HOT_SHARE, hot_ids, uniform)
    del hot_ids
    for name, idx in (("uniform", uniform), (f"{HOT_BINS}_hot_bins", hot)):
        got = vsc.value_state_counts(idx, K)
        if not torch.equal(got, torch.bincount(idx, minlength=K)):
            raise AssertionError(f"{name}: counts differ from torch.bincount")
        print(json.dumps({
            "shape": name, "K": K, "rows": n,
            "ms": _per_call_ms(lambda: vsc.value_state_counts(idx, K), opts.iters),
            "device_ms": _device_ms(lambda: vsc.value_state_counts(idx, K)),
            "card": torch.cuda.get_device_name(0),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
