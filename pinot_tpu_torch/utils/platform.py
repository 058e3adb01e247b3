"""Declared roofline peaks of the card (port of
``pinot_tpu.utils.platform``, its peaks half).

The utilization plane divides MEASURED achieved bytes/s and FLOP/s by
these DECLARED peaks to get a roofline fraction.  Values are per-card
data-sheet numbers (NVIDIA H100 Tensor Core GPU data sheet, dense rates
without sparsity): the dense bf16 tensor-core rate, the counterpart of
the TPU rows' bf16 figure in the reference, and the HBM rate.  Matching
is by a lowercase substring of ``torch.cuda.get_device_name()`` (the
longest match wins).  Unknown devices (the CPU, cards the table does not
list) report None peaks, so the roofline fraction is "unavailable", not a
made-up number, unless the operator declares peaks through
``PINOT_TPU_PEAK_FLOPS`` / ``PINOT_TPU_PEAK_HBM_BPS``.

Left out, ROADMAP queue 1 item 26: ``force_cpu_mesh`` and
``probe_device``, the multi-device helpers.
"""
from __future__ import annotations

import os

import torch

# lowercase device-name substring -> (peak FLOP/s, peak HBM bytes/s)
_PLATFORM_PEAKS = {
    # H100 SXM5 80 GB ("NVIDIA H100 80GB HBM3"): 989 TFLOP/s dense bf16,
    # 3.35 TB/s HBM3 (the rate chip_smoke.py's byte bounds use)
    "h100 80gb hbm3": (989e12, 3.35e12),
    # H100 PCIe 80 GB: 756 TFLOP/s dense bf16, 2.0 TB/s HBM2e
    "h100 pcie": (756e12, 2.0e12),
    # H100 NVL 94 GB: 835 TFLOP/s dense bf16, 3.9 TB/s HBM3
    "h100 nvl": (835e12, 3.9e12),
}

_peaks_cache = None


def platform_peaks(refresh: bool = False) -> dict:
    """Declared roofline peaks for this process's current device.

    Returns ``{"platform", "deviceKind", "peakFlopsPerSec",
    "peakBytesPerSec", "source"}``.  Peaks are None when the device is
    unknown (source "unknown": the CPU, or a card the table lacks) or
    when CUDA has not been initialized in this process yet (source
    "uninitialized": this function never initializes CUDA, since metric
    scrapes call through here).  Env overrides (``PINOT_TPU_PEAK_FLOPS``
    / ``PINOT_TPU_PEAK_HBM_BPS``, source "env") win over the table."""
    global _peaks_cache
    env_flops = os.environ.get("PINOT_TPU_PEAK_FLOPS")
    env_bps = os.environ.get("PINOT_TPU_PEAK_HBM_BPS")
    if not refresh and _peaks_cache is not None and not (env_flops or env_bps):
        return dict(_peaks_cache)
    out = {
        "platform": None,
        "deviceKind": None,
        "peakFlopsPerSec": None,
        "peakBytesPerSec": None,
        "source": "unknown",
    }
    try:
        if not torch.cuda.is_available():
            out["platform"] = out["deviceKind"] = "cpu"
        elif not torch.cuda.is_initialized():
            out["source"] = "uninitialized"
        else:
            out["platform"] = "cuda"
            kind = torch.cuda.get_device_name(torch.cuda.current_device()).lower()
            out["deviceKind"] = kind
            best = None
            for sub, peaks in _PLATFORM_PEAKS.items():
                if sub in kind and (best is None or len(sub) > len(best[0])):
                    best = (sub, peaks)
            if best is not None:
                out["peakFlopsPerSec"], out["peakBytesPerSec"] = best[1]
                out["source"] = "declared"
    except (RuntimeError, AssertionError):
        out["source"] = "error"
    if env_flops or env_bps:
        try:
            # parse BOTH before applying EITHER: a half-applied pair would
            # report one env peak under a non-"env" source label
            parsed_flops = float(env_flops) if env_flops else None
            parsed_bps = float(env_bps) if env_bps else None
        except ValueError:
            pass  # junk overrides must not break metric scrapes
        else:
            if parsed_flops is not None:
                out["peakFlopsPerSec"] = parsed_flops
            if parsed_bps is not None:
                out["peakBytesPerSec"] = parsed_bps
            out["source"] = "env"
    # never cache transient states: "uninitialized" resolves once CUDA
    # comes up, and "error" may be a one-off
    if out["source"] not in ("uninitialized", "error") and not (env_flops or env_bps):
        _peaks_cache = dict(out)
    return out


def roofline_fractions(
    achieved_bytes_per_sec,
    achieved_flops_per_sec=None,
    peaks: "dict | None" = None,
) -> dict:
    """Per-resource achieved-vs-peak fractions: the one place the roofline
    verdict rule lives (the plan registry's entries and the server-wide
    recent window both call it).

    Returns ``{"bandwidthFraction"?, "flopsFraction"?,
    "rooflineFraction"}``: a per-resource key is present only when its
    peak is declared AND the achieved rate is positive;
    ``rooflineFraction`` is the max of the present fractions, or None
    (never an invented 0) when no peak is declared."""
    if peaks is None:
        peaks = platform_peaks()
    out: dict = {}
    fractions = []
    if peaks.get("peakBytesPerSec") and achieved_bytes_per_sec:
        f = achieved_bytes_per_sec / peaks["peakBytesPerSec"]
        out["bandwidthFraction"] = round(f, 6)
        fractions.append(f)
    if peaks.get("peakFlopsPerSec") and achieved_flops_per_sec:
        f = achieved_flops_per_sec / peaks["peakFlopsPerSec"]
        out["flopsFraction"] = round(f, 6)
        fractions.append(f)
    out["rooflineFraction"] = round(max(fractions), 6) if fractions else None
    return out
