"""The port's overload scenarios on the CPU, each held to the assertions
the JAX package's own tests hold its reports to (``tests/test_overload.py``),
with the same one-retry timing contract: the functional assertions hold on
both runs, and only a miss of the timing bar alone runs the scenario once
more with the contention-hardened bar.  Beside them, ``FloodLoad``'s shed
classification against the reference's for every set of error codes, and
the harness's command line (``main``)."""
import itertools
import json

import pytest

from pinot_tpu.common.response import ErrorCode as RefErrorCode
from pinot_tpu.tools.cluster_harness import SCENARIOS as REF_SCENARIOS
from pinot_tpu.tools.cluster_harness import FloodLoad as RefFloodLoad

from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.tools.cluster_harness import (
    SCENARIOS,
    FloodLoad,
    main,
    run_ingest_backpressure_scenario,
    run_join_under_flood_scenario,
    run_noisy_neighbor_scenario,
)


def _check_isolation(out):
    assert out["tenantB"]["failedQueries"] == 0, out["tenantB"]
    assert out["offeredMultiple"] >= 10.0, out
    assert out["sheddingTyped"], out["tenantA"]
    assert out["tenantA"]["timeouts"] == 0
    assert out["tenantA"]["shed429"] + out["tenantA"]["shed210"] > 0  # the flood overflowed and was shed
    assert out["failedQueries"] == 0


def _with_one_retry(run, check, tmp_path):
    out = run(num_servers=2, baseline_s=0.7, flood_s=1.5, data_dir=str(tmp_path / "r1"), device="cpu")
    check(out)
    if not out["tenantBP99Within"]:
        # the timing bar alone: one more run with the contention-hardened bar
        out = run(num_servers=2, baseline_s=0.7, flood_s=1.5, data_dir=str(tmp_path / "r2"), device="cpu",
                  p99_floor_ms=50.0, p99_multiple=4.0)
        check(out)
    assert out["tenantBP99Within"], (out["tenantBLoadedP99Ms"], out["tenantBP99LimitMs"])
    return out


@pytest.mark.chaos
def test_noisy_neighbor_tenant_isolation(tmp_path):
    """Tenant A flooding at 10x its quota or more fails no tenant-B query,
    B's p99 stays within its bounded multiple of the baseline, and A's
    overflow is shed typed (429 / 210), never as timeouts."""
    out = _with_one_retry(run_noisy_neighbor_scenario, _check_isolation, tmp_path)
    assert set(out["scheduler"]) == {"server0", "server1"}
    assert out["admission"]


@pytest.mark.chaos
def test_join_under_flood_tenant_isolation(tmp_path):
    """The same contract with tenant A flooding two-table joins; the joins
    really ran through the join plane while flooded."""

    def check(out):
        _check_isolation(out)
        assert out["joinMeters"]["join.queries"] > 0

    _with_one_retry(run_join_under_flood_scenario, check, tmp_path)


@pytest.mark.chaos
def test_ingest_backpressure_pauses_and_drains(tmp_path):
    """The consumer pauses when the server's staging ledger crosses the high
    watermark (offset frozen, lag visible, nothing consumed while held) and
    drains its lag to 0 after the resume."""
    out = run_ingest_backpressure_scenario(data_dir=str(tmp_path), device="cpu")
    assert out["paused"], out
    assert out["offsetFrozen"], out
    assert out["consumedWhilePaused"] == 0
    assert out["lagWhilePaused"] > 0
    assert out["resumed"] and out["finalLag"] == 0, out
    assert out["governor"]["pauses"] == 1 and out["governor"]["resumes"] == 1
    assert out["failedQueries"] == 0
    # the pause came from the server's own ledger: a query staged past the mark
    assert out["stagedBytesAtPause"] >= out["hbmHighBytes"]
    assert out["consumedBeforePressure"] == 100 and out["consumedAfterResume"] == 300


def test_flood_classification_matches_the_reference_for_every_code_set():
    """``FloodLoad._classify`` gives the reference's kind (429, 210,
    timeout, other) for every subset of the error codes."""
    codes = sorted(v for k, v in vars(ErrorCode).items() if k.isupper())
    assert codes == sorted(v for k, v in vars(RefErrorCode).items() if k.isupper())
    port, ref = FloodLoad(None, ""), RefFloodLoad(None, "")
    kinds = set()
    for r in range(len(codes) + 1):
        for subset in itertools.combinations(codes, r):
            got = port._classify(set(subset))
            assert got == ref._classify(set(subset)), subset
            kinds.add(got)
    assert kinds == {"429", "210", "timeout", "other"}


def test_the_command_line_runs_a_scenario_and_offers_the_references(tmp_path, capsys):
    """``--scenario``'s choices are the reference's 15 names, and
    ``--scenario ingest-backpressure --device cpu`` prints the report and
    exits 0."""
    assert sorted(SCENARIOS) == sorted(REF_SCENARIOS) and len(SCENARIOS) == 15
    assert main(["--scenario", "ingest-backpressure", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["scenario"] == "ingest-backpressure" and out["failedQueries"] == 0
    with pytest.raises(SystemExit):
        main(["--scenario", "no-such-scenario"])


@pytest.mark.chaos
def test_the_command_line_runs_join_under_flood(capsys):
    """The reference's ``main`` passes ``--segments`` to the join scenario,
    which does not take it (a TypeError there); the port's runs it."""
    rc = main(["--scenario", "join-under-flood", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["scenario"] == "join-under-flood"
    assert out["tenantB"]["failedQueries"] == 0 and out["sheddingTyped"], out
    assert rc == (0 if out["failedQueries"] == 0 else 1)


def test_scenarios_refuse_the_cpu_unless_asked(monkeypatch):
    """With no card and no ``device``, a scenario raises at its cluster's
    first server: none carries on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (run_noisy_neighbor_scenario, run_ingest_backpressure_scenario):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
