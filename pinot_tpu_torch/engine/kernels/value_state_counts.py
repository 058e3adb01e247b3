"""Occupancy histogram of an index stream: the CUDA kernel's wrapper and
its plain torch version.

Replaces the TPU kernel ``_value_state_counts_pallas``
(``pinot_tpu/engine/kernel.py:130``) with
``pinot_tpu_torch/csrc/value_state_counts.cu``; that file's header says
what bounds the kernel on the card (memory) and what its design does
about it.

  value_state_counts(flat_idx, K)[k] = #{ i : flat_idx[i] == k },  k < K

``flat_idx`` is an int32 stream of any shape (the table kernel hands it
the stacked ``[S, n_pad]`` index, so one call counts every segment);
entries outside ``[0, K)`` are dropped, the sentinel ``K`` included.
Counts come out as int64, where the TPU kernel returns floats: exact at
any count.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs ``value_state_counts_reference``.  ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

SHARED_BYTES_LIMIT = 232448  # H100 opt-in dynamic shared memory per block; the launch rechecks the device
MAX_K = (1 << 31) - 2  # the sentinel K must fit an int32 index

launches = 0  # kernel launches on CUDA tensors; chip_smoke.py resets and reads it


def uses_shared_memory(K: int) -> bool:
    """Whether the launch keeps per-block int32 sub-histograms in shared
    memory (4 K bytes a block) or adds into the int64 output directly."""
    return 4 * K <= SHARED_BYTES_LIMIT


def _validate(flat_idx: torch.Tensor, K: int) -> None:
    if flat_idx.dtype != torch.int32:
        raise ValueError(f"flat_idx must be int32, got {flat_idx.dtype}")
    if not flat_idx.is_contiguous():
        raise ValueError("flat_idx must be contiguous")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {K}")


def value_state_counts_reference(flat_idx: torch.Tensor, K: int) -> torch.Tensor:
    """Plain torch version: every in-range index adds one to its bin,
    the rest to a spare bin that is sliced off."""
    idx = flat_idx.reshape(-1).long()
    ok = (idx >= 0) & (idx < K)
    counts = torch.zeros(K + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, torch.where(ok, idx, K), torch.ones_like(idx))
    return counts[:K]


def _library():
    from pinot_tpu_torch.engine import kernels

    fn = kernels.load("value_state_counts").value_state_counts_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, vp, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(flat_idx: torch.Tensor, K: int) -> torch.Tensor:
    global launches
    dev = flat_idx.device
    out = torch.zeros(K, dtype=torch.int64, device=dev)
    n = flat_idx.numel()
    if n == 0:
        return out  # nothing to count: no launch (the TPU kernel returns zeros too)
    if flat_idx.data_ptr() % 16:
        flat_idx = flat_idx.clone()  # the kernel's 16-byte vector loads need an aligned start
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(flat_idx.data_ptr(), n, K, out.data_ptr(), int(uses_shared_memory(K)), stream)
    if rc != 0:
        raise RuntimeError(f"value_state_counts launch failed with code {rc}")
    launches += 1
    return out


def value_state_counts(flat_idx: torch.Tensor, K: int) -> torch.Tensor:
    """int64 ``[K]`` occupancy counts of ``flat_idx`` (module docstring)."""
    _validate(flat_idx, K)
    device_type = flat_idx.device.type
    if device_type == "cuda":
        return _launch(flat_idx, K)
    if device_type != "cpu":
        raise ValueError(f"unsupported device {flat_idx.device}")
    return value_state_counts_reference(flat_idx, K)
