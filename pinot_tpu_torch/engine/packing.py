"""Single-transfer kernel-output fetch (port of ``make_packed_kernel``,
``pinot_tpu/engine/packing.py:55``).

A Q1-shaped query returns about ten output tensors; reading them back one
at a time pays one synchronizing copy each.  Instead every output is
viewed as bytes on the device, concatenated into ONE contiguous uint8
buffer (8-byte aligned parts), moved with one non-blocking copy into
pinned host memory, and the host waits on one CUDA event before it
slices the buffer back into numpy arrays of the same tree shape.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _flatten(tree, out: List[torch.Tensor]):
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, out)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_flatten(v, out) for v in tree])
    out.append(tree)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, children = spec
    if kind == "dict":
        return {k: _unflatten(v, it) for k, v in children}
    return kind(_unflatten(v, it) for v in children)


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def fetch_packed(outs: Any) -> Any:
    """Tree of device tensors -> same tree of host numpy arrays, through
    one packed device-to-host transfer."""
    leaves: List[torch.Tensor] = []
    spec = _flatten(outs, leaves)
    parts = []
    layout: List[Tuple[Tuple[int, ...], np.dtype, int, int]] = []
    off = 0
    for x in leaves:
        x = x.detach().contiguous()
        b = x.reshape(-1).view(torch.uint8) if x.numel() else x.new_empty(0, dtype=torch.uint8)
        pad = (-b.numel()) % 8
        layout.append((tuple(x.shape), _np_dtype(x.dtype), off, b.numel()))
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
        off += b.numel() + pad
    dev = leaves[0].device if leaves else torch.device("cpu")
    buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
    if dev.type == "cuda":
        host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    else:
        host = buf
    h = host.numpy()
    arrays = []
    for shape, dt, o, n in layout:
        arrays.append(h[o : o + n].copy().view(dt).reshape(shape) if n else np.zeros(shape, dt))
    return _unflatten(spec, iter(arrays))


def make_packed_kernel(fn: Callable) -> Callable:
    """Wrap a kernel-like callable (tree of device tensors out) so a call
    returns the same tree as host numpy arrays via one packed transfer."""

    def call(*args, **kwargs):
        return fetch_packed(fn(*args, **kwargs))

    return call
