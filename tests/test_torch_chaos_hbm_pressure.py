"""The port's HBM-pressure scenario on the CPU, held to the assertions of
the JAX package's twin (``tests/test_chaos_hbm_pressure.py``): addressable
data far above the server's hot-tier cap under closed-loop mixed load, the
hot set answering, cold tables cycling warm / disk and back, and an
injected allocation failure healed as ``resourceExhausted`` with no host
failover and no poisoned plan.  The hot query's answer under the caps is
held against the JAX package's over the same rows, and the caps the
scenario set are put back on the server's residency manager."""
import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.utils.audit import canonical_payload as ref_canonical_payload

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.engine.residency import ResidencyManager
from pinot_tpu_torch.tools.cluster_harness import run_hbm_pressure_scenario
from pinot_tpu_torch.utils.audit import payloads_equivalent, strip_accounting

HOT_PQL = ("SELECT sum(metInt), sum(metFloat), sum(metDouble), max(dimInt), max(dimLong) FROM tierT0 "
           "GROUP BY dimStr")


def _reference_payload(rows_per_table: int, seed: int):
    schema = ref_make_test_schema(with_mv=False)
    schema.schema_name = "tierT0"
    rows = random_rows(schema, rows_per_table, seed=seed)
    half = rows_per_table // 2
    segs = [ref_build_segment(schema, rows[:half], "tierT0_OFFLINE", "tierT0s0"),
            ref_build_segment(schema, rows[half:], "tierT0_OFFLINE", "tierT0s1")]
    req = ref_optimize(ref_parse(HOT_PQL))
    return ref_canonical_payload(req, RefExecutor().execute(segs, req))


@pytest.mark.chaos
def test_hbm_pressure_scenario_cycles_tiers_with_zero_failures(tmp_path, monkeypatch):
    answers, managers = [], []
    real_handle, real_init = BrokerRequestHandler.handle_pql, ResidencyManager.__init__

    def handle(self, pql, *a, **k):
        resp = real_handle(self, pql, *a, **k)
        if pql == HOT_PQL:
            answers.append(resp)
        return resp

    def init(self, *a, **k):
        real_init(self, *a, **k)
        managers.append((self, self.hbm_cap_bytes, self.host_cap_bytes))

    monkeypatch.setattr(BrokerRequestHandler, "handle_pql", handle)
    monkeypatch.setattr(ResidencyManager, "__init__", init)
    out = run_hbm_pressure_scenario(num_tables=8, rows_per_table=64, clients=2, baseline_s=0.6, load_s=2.0,
                                    data_dir=str(tmp_path), seed=421, device="cpu")

    # the headline: nothing failed while addressable >> the hot-tier cap
    assert out["failedQueries"] == 0, out
    assert out["sweepErrors"] == [], out["sweepErrors"][:3]
    assert out["addressable_over_cap"] >= 4.0
    assert out["addressableBytes"] > out["hbmCapBytes"]

    # the tiers cycled: victims left the card and came back
    assert out["demotions"] > 0
    assert out["promotions"] > 0
    assert out["cold_loads"] > 0
    assert out["coldSweeps"] > 0

    # the hot set stayed bounded (a generous band: a shared CI box)
    assert out["hotLoad"]["okQueries"] > 0
    assert out["hot_p99_ms"] <= 10.0 * max(out["baseline_p99_ms"], 25.0)

    # the OOM healed as its own class: answered on the device, never poisoned
    assert out["oomHealed"] is True
    heal = out["selfHealing"]
    assert heal["resourceExhausted"] >= 1
    assert heal["poisonedPlans"] == 0
    assert out["platform"] == "cpu"

    # the last hot answer (the healed one, under the caps) is the JAX
    # package's over the same rows: sums in the audit band, group order exact
    want = _reference_payload(64, 421)
    for resp in (answers[0], answers[-1]):
        assert not resp.exceptions and resp.num_docs_scanned == 64
        assert payloads_equivalent(strip_accounting(resp.to_json()), want)

    # the scenario put back the caps it set on the server's manager
    (manager, hbm_cap, host_cap), = managers
    assert out["residency"]["hbmCapBytes"] == out["hbmCapBytes"] != hbm_cap
    assert (manager.hbm_cap_bytes, manager.host_cap_bytes) == (hbm_cap, host_cap)
