"""Single-transfer kernel-output fetch (port of ``make_packed_kernel``,
``pinot_tpu/engine/packing.py:55``).

A Q1-shaped query returns about ten output tensors; reading them back one
at a time pays one synchronizing copy each.  Instead every output is
viewed as bytes on the device, concatenated into ONE contiguous uint8
buffer (8-byte aligned parts), moved with one non-blocking copy into
pinned host memory, and the host waits on one CUDA event before it
slices the buffer back into numpy arrays of the same tree shape.  The
two halves are apart (``dispatch`` / ``fetch``) so the device lane
launches and the worker that submitted waits.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

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


class PackedHandle:
    """One dispatched packed fetch: the layout, the pinned host buffer
    the non-blocking copy lands in, and the CUDA event recorded after it
    (None on the CPU, where the buffer is complete at dispatch)."""

    __slots__ = ("spec", "layout", "host", "event")

    def __init__(self, spec, layout, host: torch.Tensor, event) -> None:
        self.spec = spec
        self.layout = layout
        self.host = host
        self.event = event

    @property
    def nbytes(self) -> int:
        return int(self.host.numel())


def dispatch_packed(outs: Any) -> PackedHandle:
    """Tree of device tensors -> a handle, without waiting: the byte
    packing ``torch.cat`` and the non-blocking copy into pinned memory are
    enqueued on the current stream, and one CUDA event is recorded after
    them."""
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
    event = None
    if dev.type == "cuda":
        host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    else:
        host = buf
    return PackedHandle(spec, layout, host, event)


def fetch_handle(handle: PackedHandle, deadline: Optional[float] = None) -> Any:
    """Wait for a dispatched packed fetch and slice it back into numpy
    arrays of the original tree shape.  With a ``deadline`` (monotonic
    seconds) a query whose budget is already spent raises
    ``TimeoutError`` instead of waiting; otherwise the wait synchronizes
    on the event (the GIL released).  Safe from any thread, and from
    several waiters of one coalesced dispatch (each gets its own
    arrays)."""
    event = handle.event
    if event is not None:
        if deadline is not None and not event.query() and time.monotonic() >= deadline:
            raise TimeoutError("packed fetch exceeded the query deadline")
        event.synchronize()
    h = handle.host.numpy()
    arrays = []
    for shape, dt, o, n in handle.layout:
        arrays.append(h[o : o + n].copy().view(dt).reshape(shape) if n else np.zeros(shape, dt))
    return _unflatten(handle.spec, iter(arrays))


def fetch_packed(outs: Any) -> Any:
    """Tree of device tensors -> same tree of host numpy arrays, through
    one packed device-to-host transfer."""
    return fetch_handle(dispatch_packed(outs))


def make_packed_kernel(fn: Callable) -> Callable:
    """Wrap a kernel-like callable (tree of device tensors out) so a call
    returns the same tree as host numpy arrays via one packed transfer.

    The returned callable also exposes the two pipeline halves:
    ``.dispatch(*args) -> PackedHandle`` runs the kernel and enqueues the
    packed copy on the current stream without waiting (the device lane
    calls it on its own stream), and ``.fetch(handle, deadline=None)``
    waits on the handle's event and unpacks (FINALIZE, on the worker)."""

    def dispatch(*args, **kwargs) -> PackedHandle:
        return dispatch_packed(fn(*args, **kwargs))

    def call(*args, **kwargs):
        return fetch_handle(dispatch(*args, **kwargs))

    call.dispatch = dispatch
    call.fetch = fetch_handle
    return call


# ---------------------------------------------------------------------------
# Cross-query batching helpers (engine/dispatch.py micro-batching tier):
# stack B queries' host input trees along a new leading axis before the
# one batched launch, and slice one member's outputs back out of the
# fetched batch (pinot_tpu/engine/packing.py:214-246).  Trees are nested
# dicts / lists / tuples; leaves are visited with dict keys sorted, the
# order the reference's pytrees use, so signatures compare across the two.
# ---------------------------------------------------------------------------


def _sorted_leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _sorted_leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sorted_leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree in ``rest``), the same tree shape out."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def stack_query_inputs(inputs_list):
    """Stack B structurally identical numpy query-input trees into one
    tree whose array leaves lead with the batch axis.  The batch key
    guarantees the identity (one StaticPlan, one input signature); a
    leaf that is not an array must be equal across members and passes
    through unstacked."""
    return _tree_map(
        lambda leaf, *others: np.stack([leaf, *others]) if isinstance(leaf, np.ndarray) else leaf,
        inputs_list[0], *inputs_list[1:],
    )


def batch_input_signature(inputs) -> tuple:
    """Hashable (shape, dtype) signature of a query-input tree, part of
    the lane's batch key: two dispatches stack only when their leaves
    agree exactly."""
    return tuple(
        (tuple(leaf.shape), str(leaf.dtype)) if isinstance(leaf, np.ndarray) else ("scalar", repr(leaf))
        for leaf in _sorted_leaves(inputs, [])
    )


def slice_batched_outputs(outs, index: int):
    """Member ``index``'s output tree from a batched launch's fetched host
    outputs (every array leaf leads with the batch axis)."""
    return _tree_map(lambda x: x[index], outs)


# ---------------------------------------------------------------------------
# Bit-sliced index (BSI) encoding, the bit-sliced tier's staging layout
# (engine/bitsliced.py, engine/kernel.py; pinot_tpu/engine/packing.py:
# 141-200).  A width-W non-negative integer column becomes W bit-planes of
# packed 32-bit words: row r lands in word r // 32 at bit r % 32 (LSB
# first within a word; plane b holds bit b of every row).  The encoder
# writes uint32 words; staging views them as int32 (the same bits), the
# dtype torch shifts and popcounts on every device.
# ---------------------------------------------------------------------------


def bit_width(max_value: int) -> int:
    """Planes needed for values in [0, max_value], at least 1 so a constant
    column still round-trips through the encoder."""
    return max(1, int(max_value).bit_length())


def bitslice_encode(values: np.ndarray, width: int, n_words: int) -> np.ndarray:
    """uint32 [width, n_words] bit-planes of a non-negative int array.

    Rows beyond ``values.size`` (up to ``n_words * 32``) encode as 0; the
    programs mask padding through the validity words."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    if v.size and (int(v.min()) < 0 or bit_width(int(v.max())) > width):
        raise ValueError(f"values out of range for {width}-plane bit-slice encoding")
    planes = np.zeros((width, n_words), dtype=np.uint32)
    n = min(v.size, n_words * 32)
    for b in range(width):
        bits = np.zeros(n_words * 32, dtype=np.uint8)
        bits[:n] = (v[:n] >> b) & 1
        planes[b] = np.packbits(bits, bitorder="little").view(np.uint32)
    return planes


def bitslice_decode(planes: np.ndarray, num_rows: int) -> np.ndarray:
    """Inverse of bitslice_encode: int64 [num_rows] values (int32 planes
    decode the same as their uint32 view)."""
    width, _ = planes.shape
    out = np.zeros(num_rows, dtype=np.int64)
    for b in range(width):
        bits = np.unpackbits(np.ascontiguousarray(planes[b]).view(np.uint8), bitorder="little")[:num_rows]
        out |= bits.astype(np.int64) << b
    return out


def integral_dictionary_values(values) -> "np.ndarray | None":
    """Dictionary values as exact int64, or None when the dictionary is not
    exactly integral (a fused SUM must be bit-exact against the scan
    tier's float sums, which it is for integral values below 2**53)."""
    vals = np.asarray(values)
    if not np.issubdtype(vals.dtype, np.number) or vals.size == 0:
        return None
    v = np.asarray(vals, dtype=np.float64)
    if not np.all(np.isfinite(v)):
        return None
    if np.any(np.abs(v) >= 2.0**53) or not np.all(v == np.floor(v)):
        return None
    return v.astype(np.int64)
