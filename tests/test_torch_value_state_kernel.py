"""K2's fused form (``value_state``: the index combined inside the kernel
from the staged streams) against the reference's Pallas K2.

Each case makes seeded numpy streams, combines the index with numpy
(filter & row < num_docs; the mixed-radix slot of the group columns;
``slot * width + gid`` or ``(slot * HLL_M + bucket) * 64 + rho``), counts
it with the reference's ``_value_state_counts_pallas`` (interpret mode)
and takes the counts to presence bits, the histogram or HLL registers.
The port's plain version, which the wrapper runs on CPU tensors, must be
bit-equal to that over every filter form, group form, value form and
mode, with ragged ``num_docs``.  The CUDA kernel itself runs only on the
card: ``chip_smoke.py`` holds it against the same plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.pallas_kernels import PALLAS_AVAILABLE

from pinot_tpu_torch.engine.kernels import value_state_counts as vsc

S, N = 3, 200
HLL_M, RHO = 256, 64

FILTERS = ("none", "interval", "docrange", "table", "mask")
GROUPS = ("scalar", "u8", "u8_remapped_i16")
VALUES = (
    ("counts", "gfwd_i16"),
    ("counts", "gfwd_i32"),
    ("counts", "fwd_remap"),
    ("presence", "gfwd_i16"),
    ("presence", "gfwd_i32"),
    ("presence", "fwd_remap"),
    ("registers", "streams"),
    ("registers", "fwd_tables"),
)
WIDTH = 40  # the value holder's width (gcard_pad) for counts and presence


def _case(filt: str, group: str, mode: str, form: str, seed: int):
    """numpy streams for one case: (value_state keyword arguments as numpy
    arrays, capacity)."""
    rng = np.random.default_rng(seed)
    args = {"num_docs": np.array([N, N - 37, 0][:S], np.int32)}
    if filt == "interval":
        args["filter_fwd"] = rng.integers(0, 30, (S, N)).astype(np.int16)
        args["filter_bounds"] = np.array([[5, 22], [0, 9], [3, 30]], np.int32)
    elif filt == "docrange":
        args["filter_bounds"] = np.array([[13, 170], [0, N], [50, 60]], np.int32)
    elif filt == "table":
        args["filter_fwd"] = rng.integers(0, 7, (S, N)).astype(np.uint8)
        args["match"] = rng.random((S, 8)) < 0.5
    elif filt == "mask":
        args["filter_fwd"] = (rng.random((S, N)) < 0.6).astype(np.uint8)
        args["match"] = np.array([[False, True]] * S)
    capacity = 1
    if group == "u8":
        args["group_cols"], args["group_cards"], args["group_remaps"] = [rng.integers(0, 3, (S, N)).astype(np.uint8)], [3], [None]
        capacity = 3
    elif group == "u8_remapped_i16":
        # the int16 column is a local fwd read through a remap table; ids past the table drop
        args["group_cols"] = [rng.integers(0, 2, (S, N)).astype(np.uint8), rng.integers(0, 44, (S, N)).astype(np.int16)]
        args["group_cards"] = [2, 3]
        args["group_remaps"] = [None, rng.integers(0, 3, (S, 40)).astype(np.int32)]
        capacity = 6
    if mode == "registers":
        if form == "streams":
            args["values"] = rng.integers(0, HLL_M, (S, N)).astype(np.uint8)
            args["rho"] = rng.integers(0, 30, (S, N)).astype(np.uint8)
        else:  # fwd through per-dictId bucket / rho tables; ids past the tables drop
            args["values"] = rng.integers(0, 70, (S, N)).astype(np.int16)
            args["value_table"] = rng.integers(0, HLL_M, (S, 64)).astype(np.int32)
            args["rho_table"] = rng.integers(0, 30, (S, 64)).astype(np.int32)
    else:
        args["width"] = WIDTH
        if form == "fwd_remap":
            args["values"] = rng.integers(0, 36, (S, N)).astype(np.int16)
            args["value_table"] = rng.integers(0, WIDTH, (S, 32)).astype(np.int32)
        else:
            args["values"] = rng.integers(0, WIDTH, (S, N)).astype(np.int16 if form == "gfwd_i16" else np.int32)
    return args, capacity


def _lookup(table, ids):
    ids = ids.astype(np.int64)
    ok = (ids >= 0) & (ids < table.shape[1])
    return np.take_along_axis(table, np.clip(ids, 0, table.shape[1] - 1), axis=1).astype(np.int64), ok


def _numpy_index(mode, args, capacity):
    """The combined index with numpy (sentinel K on dropped rows), K and
    the matched-doc total."""
    rows = np.arange(N)[None, :]
    mask = rows < args["num_docs"][:, None]
    f, b = args.get("filter_fwd"), args.get("filter_bounds")
    if args.get("match") is not None:
        mask &= np.take_along_axis(args["match"], f.astype(np.int64), axis=1)
    elif f is not None:
        mask &= (f >= b[:, 0:1]) & (f < b[:, 1:2])
    elif b is not None:
        mask &= (rows >= b[:, 0:1]) & (rows < b[:, 1:2])
    docs = int(mask.sum())
    slot = np.zeros((S, N), np.int64)
    for g, card, remap in zip(args.get("group_cols", ()), args.get("group_cards", ()), args.get("group_remaps", ())):
        if remap is not None:
            g, ok = _lookup(remap, g)
            mask &= ok
        slot = slot * card + g
    if mode == "registers":
        K = capacity * HLL_M * RHO
        if "rho" in args:
            bucket, rho = args["values"].astype(np.int64), args["rho"].astype(np.int64)
        else:
            bucket, ok = _lookup(args["value_table"], args["values"])
            rho, _ = _lookup(args["rho_table"], args["values"])
            mask &= ok
        idx = (slot * HLL_M + bucket) * RHO + rho
    else:
        K = capacity * WIDTH
        v = args["values"].astype(np.int64)
        if "value_table" in args:
            v, ok = _lookup(args["value_table"], v)
            mask &= ok
        idx = slot * WIDTH + v
    return np.where(mask & (idx < K), idx, K).astype(np.int32), K, docs


def _holder(mode, counts):
    if mode == "counts":
        return counts
    if mode == "presence":
        return (counts > 0).astype(np.int32)
    return ((counts.reshape(-1, RHO) > 0) * np.arange(RHO)).max(axis=1).astype(np.uint8)


def _torch_args(args):
    out = {}
    for k, v in args.items():
        if isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
        elif isinstance(v, list) and k != "group_cards":
            out[k] = [None if x is None else torch.from_numpy(x) for x in v]
        else:
            out[k] = v
    return out


@pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")
@pytest.mark.parametrize("mode,form", VALUES)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("filt", FILTERS)
def test_plain_value_state_matches_pallas_over_numpy_index(filt, group, mode, form):
    seed = (FILTERS.index(filt) * 31 + GROUPS.index(group)) * 31 + VALUES.index((mode, form))
    args, capacity = _case(filt, group, mode, form, seed)
    idx, K, docs = _numpy_index(mode, args, capacity)
    counts = np.asarray(ref_kernel._value_state_counts_pallas(jnp.asarray(idx.reshape(-1)), K))
    want = _holder(mode, counts.astype(np.int64))
    got_docs, got = vsc.value_state(mode, **_torch_args(args), capacity=capacity)
    assert got.dtype == torch.from_numpy(want).dtype and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert int(got_docs) == docs
    # the torch-op combine the plain version runs is the numpy index itself
    t_idx, t_K, _ = vsc.combine_index(mode, **_torch_args(args), capacity=capacity)
    assert t_K == K and np.array_equal(t_idx.numpy(), idx)


@pytest.mark.parametrize(
    "mode,K,tier",
    [
        ("counts", 392, "block"),  # pct_quantity: 1568 B
        ("counts", 2560, "block"),  # a scalar histogram of 2560 values
        ("counts", 7 * 2560, "block"),
        ("counts", 16384, "block"),
        ("counts", 57600, "block"),  # the most int32 bins one block holds
        ("counts", 57601, "global"),
        ("counts", 1 << 18, "global"),
        ("presence", 7680, "byte"),  # hll_groupby: a 7.5 KB byte map
        ("presence", 49152, "byte"),
        ("presence", 49153, "block"),
        ("presence", 1 << 18, "block"),  # distinct_price: a 32 KB bitmap
        ("presence", 57600 * 32, "block"),
        ("presence", 57600 * 32 + 32, "global"),
        ("presence", 1 << 24, "global"),
        ("registers", HLL_M * RHO, "byte"),  # hll_price: a 16 KB byte map
        ("registers", 3 * HLL_M * RHO, "byte"),
        ("registers", 4 * HLL_M * RHO, "block"),
        ("registers", 16 * HLL_M * RHO, "block"),  # the largest "matmul" grouped HLL
        ("registers", 225 * HLL_M * RHO, "block"),  # 225 x 256 int32 registers: 225 KB
        ("registers", 226 * HLL_M * RHO, "global"),
    ],
)
def test_choose_tier(mode, K, tier):
    assert vsc.choose_tier(mode, K) == tier
    assert vsc.tier_fits(mode, tier, K)


def test_choose_tier_counts_tables_and_match_in_shared_memory():
    """Tables and the match table share the block's shared memory with
    the holder: they can push a holder out of a tier."""
    assert vsc.choose_tier("counts", 57600, table_bytes=0, match_card=8) == "global"
    assert vsc.choose_tier("presence", 57600 * 32, table_bytes=4) == "global"
    assert vsc.shared_bytes("counts", "block", 392, 4096, 8) == 4096 + 4 * 392 + 8
    small = [torch.zeros((2, 1024), dtype=torch.int32)] * 4
    assert vsc.shared_table_bytes(small + [None]) == 16384
    assert vsc.shared_table_bytes(small + [torch.zeros((2, 1), dtype=torch.int32)]) == 0


def _valid_args():
    args, capacity = _case("interval", "u8", "counts", "gfwd_i16", 5)
    return _torch_args(args), capacity


@pytest.mark.parametrize(
    "change",
    [
        {"mode": "bins"},
        {"width": None},
        {"rho": torch.zeros((S, N), dtype=torch.uint8)},
        {"values": torch.zeros((S, N), dtype=torch.int64)},
        {"values": torch.zeros((N, S), dtype=torch.int16).t()},
        {"num_docs": torch.zeros(S, dtype=torch.int64)},
        {"match": torch.zeros((S, 8), dtype=torch.bool)},  # beside filter_bounds
        {"filter_bounds": None},  # filter_fwd alone
        {"group_cards": [3, 2]},
        {"capacity": 0},
        {"tier": "byte", "mode": "counts"},
        {"width": (1 << 31) // 3 + 1},  # K past the 32-bit index space
    ],
)
def test_value_state_rejects_what_the_kernel_does_not_take(change):
    args, capacity = _valid_args()
    mode = change.pop("mode", "counts")
    kw = {**args, "capacity": capacity, **change}
    with pytest.raises(ValueError):
        vsc.value_state(mode, **kw)


def test_registers_take_a_rho_stream_or_both_tables():
    args, _ = _case("none", "scalar", "registers", "fwd_tables", 3)
    t = _torch_args(args)
    with pytest.raises(ValueError):
        vsc.value_state("registers", **{**t, "rho_table": None})
    with pytest.raises(ValueError):
        vsc.value_state("registers", **{**t, "rho": torch.zeros((S, N), dtype=torch.uint8)})
    with pytest.raises(ValueError):
        vsc.value_state("registers", **{**t, "width": 40})


def test_precombined_form_takes_a_tier():
    idx = torch.tensor([0, 3, 3, 7, -1], dtype=torch.int32)
    assert vsc.value_state_counts(idx, 4, tier="global").tolist() == [1, 0, 0, 2]
    for tier in ("lane", "byte"):  # byte is a presence tier
        with pytest.raises(ValueError):
            vsc.value_state_counts(idx, 4, tier=tier)
