"""The port's fused filtered group-by (plain torch version, which the
wrapper runs for CPU tensors) against the TPU kernel
``pinot_tpu.engine.pallas_kernels.fused_filtered_groupby_sums`` run in
interpret mode, on the same seeded numpy inputs.

Tolerances: counts and num_docs exact (the port counts in int64); sums
rel 1e-9 in x64 (two float64 summation orders over <= 5000 rows differ
by ~1e-13 relative; 1e-9 leaves room without hiding a wrong row).
The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against this plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.engine.pallas_kernels import PALLAS_AVAILABLE
from pinot_tpu.engine.pallas_kernels import fused_filtered_groupby_sums as jax_k1
from pinot_tpu_torch.engine.kernels import fused_groupby as fg

pytestmark = pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")

RTOL = 1e-9


def _case(name):
    """Seeded inputs for one case: a dict of numpy arrays and options."""
    rng = np.random.default_rng(100 + CASES.index(name))
    n = 5000
    c = {"n": n, "num_docs": n - 13}
    c["keys"] = rng.integers(0, 6, n).astype(np.int32)
    c["capacity"] = 6
    c["filter_fwd"] = rng.integers(0, 7, n).astype(np.int32)
    c["match"] = None
    c["bounds"] = None
    c["fwds"], c["dicts"], c["raws"] = [], [], []
    if name == "pallas_table_dict":  # tests/test_pallas.py:12-44
        rng = np.random.default_rng(0)
        c["filter_fwd"] = rng.integers(0, 7, n).astype(np.int32)
        m = np.zeros(7, dtype=bool)
        m[[1, 3, 4]] = True
        c["match"] = m
        c["keys"] = rng.integers(0, 6, n).astype(np.int32)
        c["fwds"] = [rng.integers(0, 50, n).astype(np.int32)]
        c["dicts"] = [np.round(rng.uniform(0, 100, 50), 2)]
        c["raws"] = [None]
    elif name == "pallas_multi_dict":  # tests/test_pallas.py:47-72
        rng = np.random.default_rng(3)
        c["n"] = n = 1000
        c["num_docs"] = n
        c["keys"] = rng.integers(0, 4, n).astype(np.int32)
        c["capacity"] = 4
        c["filter_fwd"] = np.zeros(n, dtype=np.int32)
        c["match"] = np.ones(1, dtype=bool)
        c["fwds"] = [rng.integers(0, 10, n).astype(np.int32) for _ in range(3)]
        c["dicts"] = [np.arange(10, dtype=np.float64) * (i + 1) for i in range(3)]
        c["raws"] = [None] * 3
    elif name == "interval_raw_and_dict":
        c["bounds"] = (2, 5)
        c["fwds"] = [None, rng.integers(0, 40, n).astype(np.int32)]
        c["dicts"] = [None, rng.uniform(-5, 5, 40)]
        c["raws"] = [rng.uniform(0, 1000, n), None]
    elif name == "interval_count_only":
        c["bounds"] = (0, 3)
    elif name == "table_raw":
        m = rng.random(7) < 0.5
        c["match"] = m
        c["raws"] = [rng.uniform(-1, 1, n)]
        c["fwds"], c["dicts"] = [None], [None]
    elif name == "docrange":
        # a doc interval is the interval test on the row index: the TPU
        # kernel sees it as filter_fwd = iota
        c["filter_fwd"] = None
        c["bounds"] = (117, 4321)
        c["raws"] = [rng.uniform(0, 10, n)]
        c["fwds"], c["dicts"] = [None], [None]
    elif name == "single_point":
        c["bounds"] = (4, 5)  # points leaf p=4 -> [p, p+1)
        c["fwds"] = [rng.integers(0, 9, n).astype(np.int32)]
        c["dicts"] = [np.arange(9, dtype=np.float64) * 1.5]
        c["raws"] = [None]
    elif name == "single_point_absent":
        c["bounds"] = (-1, 0)  # p = -1 matches nothing
        c["raws"] = [rng.uniform(0, 10, n)]
        c["fwds"], c["dicts"] = [None], [None]
    elif name == "capacity_one":
        c["capacity"] = 1
        c["keys"] = np.zeros(n, dtype=np.int32)
        c["bounds"] = (1, 6)
        c["raws"] = [rng.uniform(0, 10, n)]
        c["fwds"], c["dicts"] = [None], [None]
    return c


CASES = [
    "pallas_table_dict",
    "pallas_multi_dict",
    "interval_raw_and_dict",
    "interval_count_only",
    "table_raw",
    "docrange",
    "single_point",
    "single_point_absent",
    "capacity_one",
]


def _run_jax(c):
    n = c["n"]
    valid = np.arange(n) < c["num_docs"]
    filter_fwd = c["filter_fwd"] if c["filter_fwd"] is not None else np.arange(n, dtype=np.int32)
    docs, count, sums = jax_k1(
        jnp.asarray(filter_fwd),
        None if c["match"] is None else jnp.asarray(c["match"]),
        jnp.asarray(valid),
        jnp.asarray(c["keys"]),
        [None if f is None else jnp.asarray(f) for f in c["fwds"]],
        [None if d is None else jnp.asarray(d) for d in c["dicts"]],
        capacity=c["capacity"],
        interpret=True,
        filter_bounds=c["bounds"],
        value_raws=[None if r is None else jnp.asarray(r) for r in c["raws"]],
    )
    return float(docs), np.asarray(count), [np.asarray(s) for s in sums]


def _port_args(c, S=1):
    """Port inputs for the same case, stacked [S, n] (segments repeat)."""
    t = lambda a, dt: torch.as_tensor(np.stack([a] * S)).to(dt).contiguous()  # noqa: E731
    return dict(
        filter_fwd=None if c["filter_fwd"] is None else t(c["filter_fwd"], torch.int16),
        match=None if c["match"] is None else t(c["match"], torch.bool),
        num_docs=torch.full((S,), c["num_docs"], dtype=torch.int32),
        group_keys=t(c["keys"], torch.int32),
        value_fwds=[None if f is None else t(f, torch.uint8) for f in c["fwds"]],
        value_dicts=[None if d is None else t(d, torch.float64) for d in c["dicts"]],
        capacity=c["capacity"],
        dtype=torch.float64,
        filter_bounds=None if c["bounds"] is None else torch.tensor([c["bounds"]] * S, dtype=torch.int32),
        value_raws=[None if r is None else t(r, torch.float64) for r in c["raws"]],
    )


@pytest.mark.parametrize("name", CASES)
def test_plain_k1_matches_jax_kernel(name):
    c = _case(name)
    want_docs, want_count, want_sums = _run_jax(c)
    args = _port_args(c)
    docs, count, sums = fg.fused_filtered_groupby_sums_reference(
        args.pop("filter_fwd"), args.pop("match"), args.pop("num_docs"), args.pop("group_keys"),
        args.pop("value_fwds"), args.pop("value_dicts"), args.pop("capacity"), **args,
    )
    assert docs.dtype == torch.int64 and count.dtype == torch.int64
    assert int(docs) == want_docs
    np.testing.assert_array_equal(count.numpy(), want_count.astype(np.int64))
    assert len(sums) == len(c["raws"])
    for got, want in zip(sums, want_sums):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("name", ["interval_raw_and_dict", "docrange", "pallas_table_dict"])
def test_wrapper_on_cpu_is_the_plain_version(name):
    c = _case(name)
    before = fg.launches
    a = fg.fused_filtered_groupby_sums(**_port_args(c, S=2))
    b = fg.fused_filtered_groupby_sums_reference(**_port_args(c, S=2))
    assert fg.launches == before  # CPU tensors never count as launches
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def test_segment_axis_sums_per_segment_kernels():
    """S = 3 with ragged num_docs and an empty segment equals the sum of
    three single-segment TPU-kernel runs."""
    rng = np.random.default_rng(5)
    n, K = 2048, 6
    num_docs = [2048, 700, 0]
    keys = rng.integers(0, K, (3, n)).astype(np.int32)
    ffwd = rng.integers(0, 20, (3, n)).astype(np.int32)
    bounds = np.array([[3, 15], [0, 20], [5, 6]], dtype=np.int32)
    raw = rng.uniform(0, 100, (3, n))
    want_docs, want_count, want_sum = 0.0, np.zeros(K), np.zeros(K)
    for s in range(3):
        d, cnt, (sm,) = jax_k1(
            jnp.asarray(ffwd[s]), None, jnp.asarray(np.arange(n) < num_docs[s]),
            jnp.asarray(keys[s]), [None], [None], capacity=K, interpret=True,
            filter_bounds=tuple(int(x) for x in bounds[s]), value_raws=[jnp.asarray(raw[s])],
        )
        want_docs += float(d)
        want_count += np.asarray(cnt)
        want_sum += np.asarray(sm)
    docs, count, (sums,) = fg.fused_filtered_groupby_sums(
        torch.as_tensor(ffwd), None, torch.tensor(num_docs, dtype=torch.int32),
        torch.as_tensor(keys), [None], [None], K, dtype=torch.float64,
        filter_bounds=torch.as_tensor(bounds), value_raws=[torch.as_tensor(raw)],
    )
    assert int(docs) == want_docs
    np.testing.assert_array_equal(count.numpy(), want_count.astype(np.int64))
    np.testing.assert_allclose(sums.numpy(), want_sum, rtol=RTOL)


def _bad(kind):
    n = 256
    z = np.zeros(n, dtype=np.int32)
    j = dict(
        filter_fwd=z, match=np.ones(4, dtype=bool), valid=np.ones(n, dtype=bool), keys=z,
        fwds=[None], dicts=[None], raws=[np.ones(n)], bounds=None,
    )
    if kind == "match_and_bounds":
        j["bounds"] = (0, 1)
    elif kind == "neither_filter":
        j["match"] = None
    elif kind == "match_card":
        j["match"] = np.ones(fg.MAX_TABLE_CARD + 1, dtype=bool)
    elif kind == "dict_card":
        j["fwds"], j["dicts"], j["raws"] = [z], [np.ones(fg.MAX_TABLE_CARD + 1)], [None]
    elif kind == "dict_and_raw":
        j["fwds"], j["dicts"] = [z], [np.ones(4)]
    elif kind == "no_value_source":
        j["raws"] = [None]
    return j


@pytest.mark.parametrize(
    "kind",
    ["match_and_bounds", "neither_filter", "match_card", "dict_card", "dict_and_raw", "no_value_source"],
)
def test_value_error_contract(kind):
    j = _bad(kind)
    with pytest.raises(ValueError):
        jax_k1(
            jnp.asarray(j["filter_fwd"]), None if j["match"] is None else jnp.asarray(j["match"]),
            jnp.asarray(j["valid"]), jnp.asarray(j["keys"]),
            [None if f is None else jnp.asarray(f) for f in j["fwds"]],
            [None if d is None else jnp.asarray(d) for d in j["dicts"]],
            capacity=4, interpret=True, filter_bounds=j["bounds"],
            value_raws=[None if r is None else jnp.asarray(r) for r in j["raws"]],
        )
    t = lambda a: None if a is None else torch.as_tensor(a)[None].contiguous()  # noqa: E731
    with pytest.raises(ValueError):
        fg.fused_filtered_groupby_sums(
            t(j["filter_fwd"]), t(j["match"]), torch.tensor([256], dtype=torch.int32),
            t(j["keys"]), [t(f) for f in j["fwds"]], [t(d) for d in j["dicts"]], 4,
            dtype=torch.float64,
            filter_bounds=None if j["bounds"] is None else torch.tensor([j["bounds"]], dtype=torch.int32),
            value_raws=[t(r) for r in j["raws"]],
        )


@pytest.mark.parametrize("fbytes,nv", [(4, 3), (8, 3), (4, 0), (8, 8)])
def test_capacity_bound_is_the_shared_memory_bound(fbytes, nv):
    """max_capacity is the largest K some tier takes: the atomic tier's
    int32 counts when count-only (every count-only shape runs there), the
    warp tier's per-warp sums else; with sums the private tier's
    [slot][thread] accumulators take the small shapes, up to
    PRIVATE_SHARED_BYTES."""
    k = fg.max_capacity(fbytes, nv)
    assert k >= 1
    assert fg.fits_shared_memory(fbytes, k, nv, [], 0)
    assert not fg.fits_shared_memory(fbytes, k + 1, nv, [], 0)
    big = "atomic" if nv == 0 else "warp"
    assert fg.tier_fits(big, fbytes, k, nv) and not fg.tier_fits(big, fbytes, k + 1, nv)
    assert fg.choose_tier(fbytes, k, nv) == big
    kp = max(c for c in range(1, k + 1)
             if fg.shared_bytes("private", fbytes, c, nv) <= fg.PRIVATE_SHARED_BYTES)
    assert fg.choose_tier(fbytes, kp, nv) == ("private" if nv else "atomic")
    assert fg.choose_tier(fbytes, kp + 1, nv) == big
    assert fg.choose_tier(fbytes, 1, nv) == ("private" if nv else "atomic")
    # a remap table counts against the same budget
    assert not fg.fits_shared_memory(fbytes, k, nv, [], 0, [fg.MAX_TABLE_CARD])


# ---------------------------------------------------------------------------
# The key combined from group columns (the fused route's form)
# ---------------------------------------------------------------------------

_WIDTHS = {"u8": (np.uint8, torch.uint8), "i16": (np.int16, torch.int16), "i32": (np.int32, torch.int32)}


def _group_case(widths, remapped, seed):
    """Seeded group columns: global-id streams (remapped False) or local
    fwd streams with per-segment remap tables, their radices, the key
    combined with numpy as engine/kernel.py::_group_keys does, and a
    filter, raw values and a dictionary-fed value column."""
    rng = np.random.default_rng(seed)
    S, n = 2, 3000
    cards = [3, 5, 2][: len(widths)]
    cols, remaps, gids = [], [], []
    for w, card in zip(widths, cards):
        if remapped:
            local = card + 2  # local dictionaries larger than the global card
            fwd = rng.integers(0, local, (S, n))
            rm = rng.integers(0, card, (S, local)).astype(np.int32)
            gid = np.take_along_axis(rm, fwd, axis=1)
            remaps.append(rm)
        else:
            fwd = gid = rng.integers(0, card, (S, n))
            remaps.append(None)
        cols.append(fwd.astype(_WIDTHS[w][0]))
        gids.append(gid)
    keys = gids[0].astype(np.int64)
    for gid, card in zip(gids[1:], cards[1:]):
        keys = keys * card + gid
    return dict(
        S=S, n=n, cols=cols, remaps=remaps, cards=cards, keys=keys.astype(np.int32),
        capacity=int(np.prod(cards)), num_docs=[n - 17, 1234],
        filter_fwd=rng.integers(0, 9, (S, n)).astype(np.int32),
        raw=rng.uniform(0, 100, (S, n)), fwd=rng.integers(0, 30, (S, n)).astype(np.int32),
        dict=rng.uniform(-3, 3, 30),
    )


def _group_port_args(c, widths):
    return dict(
        filter_fwd=torch.as_tensor(c["filter_fwd"]).to(torch.int16), match=None,
        num_docs=torch.tensor(c["num_docs"], dtype=torch.int32), group_keys=None,
        value_fwds=[None, torch.as_tensor(c["fwd"]).to(torch.uint8)],
        value_dicts=[None, torch.as_tensor(np.stack([c["dict"]] * c["S"]))],
        capacity=c["capacity"], dtype=torch.float64,
        filter_bounds=torch.tensor([[2, 7]] * c["S"], dtype=torch.int32),
        value_raws=[torch.as_tensor(c["raw"]), None],
        group_cols=[torch.as_tensor(g).to(_WIDTHS[w][1]) for g, w in zip(c["cols"], widths)],
        group_cards=c["cards"],
        group_remaps=[None if r is None else torch.as_tensor(r) for r in c["remaps"]],
    )


GROUP_FORMS = [
    (("u8",), False), (("i16",), False), (("i32",), False),
    (("u8",), True), (("i16",), True), (("i32",), True),
    (("u8", "u8"), False), (("u8", "i16", "i32"), False), (("i32", "u8", "i16"), True),
]


@pytest.mark.parametrize("widths,remapped", GROUP_FORMS)
def test_plain_group_cols_form_matches_jax_kernel(widths, remapped):
    """The plain version's group_cols form (global-id or remap-fed
    streams of each width, 1-3 columns) against the Pallas K1 in
    interpret mode fed the numpy-combined key, per segment summed."""
    c = _group_case(widths, remapped, seed=len(widths) * 10 + remapped)
    S, n, K = c["S"], c["n"], c["capacity"]
    want_docs, want_count, want_sums = 0.0, np.zeros(K), [np.zeros(K), np.zeros(K)]
    for s in range(S):
        d, cnt, sums = jax_k1(
            jnp.asarray(c["filter_fwd"][s]), None, jnp.asarray(np.arange(n) < c["num_docs"][s]),
            jnp.asarray(c["keys"][s]), [None, jnp.asarray(c["fwd"][s])], [None, jnp.asarray(c["dict"])],
            capacity=K, interpret=True, filter_bounds=(2, 7),
            value_raws=[jnp.asarray(c["raw"][s]), None],
        )
        want_docs += float(d)
        want_count += np.asarray(cnt)
        for acc, sm in zip(want_sums, sums):
            acc += np.asarray(sm)
    docs, count, sums = fg.fused_filtered_groupby_sums_reference(**_group_port_args(c, widths))
    assert int(docs) == want_docs
    np.testing.assert_array_equal(count.numpy(), want_count.astype(np.int64))
    for got, want in zip(sums, want_sums):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("widths,remapped", [(("u8", "i16"), False), (("i16", "u8", "i32"), True)])
def test_group_cols_equal_group_keys(widths, remapped):
    """The wrapper's two key forms give equal results, and the key it
    combines is the numpy mixed radix."""
    c = _group_case(widths, remapped, seed=77)
    args = _group_port_args(c, widths)
    a = fg.fused_filtered_groupby_sums(**args)
    keyed = dict(args, group_keys=torch.as_tensor(c["keys"]), group_cols=None, group_cards=None,
                 group_remaps=None)
    b = fg.fused_filtered_groupby_sums(**keyed)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    combined = fg.combine_group_keys(args["group_cols"], args["group_cards"], args["group_remaps"])
    np.testing.assert_array_equal(combined.numpy(), c["keys"])


@pytest.mark.parametrize(
    "kind", ["too_many_group_columns", "remap_card", "keys_and_cols", "neither_key", "cards_mismatch",
             "remap_dtype", "unknown_tier"],
)
def test_group_cols_value_error_contract(kind):
    c = _group_case(("u8", "u8"), True, seed=5)
    args = _group_port_args(c, ("u8", "u8"))
    if kind == "too_many_group_columns":
        g, n = args["group_cols"][0], fg.MAX_GROUP_COLUMNS + 1
        args.update(group_cols=[g] * n, group_cards=[1] * n, group_remaps=[None] * n)
    elif kind == "remap_card":
        args["group_remaps"][0] = torch.zeros((c["S"], fg.MAX_TABLE_CARD + 1), dtype=torch.int32)
    elif kind == "keys_and_cols":
        args["group_keys"] = torch.as_tensor(c["keys"])
    elif kind == "neither_key":
        args["group_cols"] = None
    elif kind == "cards_mismatch":
        args["group_cards"] = c["cards"][:1]
    elif kind == "remap_dtype":
        args["group_remaps"][0] = args["group_remaps"][0].to(torch.int64)
    else:
        args["tier"] = "fast"
    with pytest.raises(ValueError):
        fg.fused_filtered_groupby_sums(**args)
