"""The port's cost-vector keys: each is one of the JAX package's
``COST_KEYS`` (``pinot_tpu/engine/results.py:260-280``), the join keys
among them, the serving-tier subset carries ``segmentsZonemap``, and a port server marks
``cost.tier.segmentsZonemap`` for a query served over zone-map candidate
blocks, as the reference server does (``cost.tier.<key>`` for every key of
``SEGMENT_TIER_KEYS``)."""
import pytest

from pinot_tpu.engine.results import COST_KEYS as REF_COST_KEYS
from pinot_tpu.engine.results import SEGMENT_TIER_KEYS as REF_TIER_KEYS
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.results import COST_KEYS, SEGMENT_TIER_KEYS
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.local import LocalTransport

SEGMENTS = [ref_synthetic(20000, seed=7 + i, name=f"li{i}") for i in range(3)]


def test_every_port_cost_key_is_a_reference_cost_key():
    assert set(COST_KEYS) <= set(REF_COST_KEYS)
    assert set(SEGMENT_TIER_KEYS) <= set(REF_TIER_KEYS)
    assert "segmentsZonemap" in SEGMENT_TIER_KEYS and "batchHits" in COST_KEYS
    # the join plane's additive keys (engine/join.py, broker/joinplan.py)
    assert {"buildRows", "probeRows", "shuffleBytes", "broadcastBytes"} <= set(COST_KEYS)
    # the reference's order, trimmed
    assert list(COST_KEYS) == [k for k in REF_COST_KEYS if k in COST_KEYS]


@pytest.mark.parametrize("pql, meter", [
    ("SELECT sum(l_extendedprice) FROM lineitem WHERE l_shipdate = '1995-06-14'", "segmentsZonemap"),
    ("SELECT sum(l_extendedprice) FROM lineitem WHERE l_quantity > 25", "segmentsFullScan"),
])
def test_a_server_marks_the_tier_meter_of_the_blocks_it_scanned(pql, meter, monkeypatch):
    monkeypatch.setattr(config, "ZONE_BLOCK", 1024)
    server = ServerInstance("s0", device="cpu")
    transport = LocalTransport()
    transport.register(("s0", 0), server.handle_request)
    routing = RoutingTableProvider()
    routing.update("lineitem", {s.segment_name: {"s0": "ONLINE"} for s in SEGMENTS})
    broker = BrokerRequestHandler(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)
    try:
        for seg in SEGMENTS:
            server.add_segment("lineitem", segment_from_arrays(**segment_arrays_of(seg)))
        resp = broker.handle_pql(pql)
        assert not resp.exceptions, resp.exceptions
        assert resp.cost[meter] == len(SEGMENTS)
        counts = {k: server.metrics.meter(f"cost.tier.{k}").count for k in SEGMENT_TIER_KEYS}
        assert counts == {k: (len(SEGMENTS) if k == meter else 0) for k in SEGMENT_TIER_KEYS}
        assert "cost_tier_segmentsZonemap" in server.metrics_text().replace(".", "_")
    finally:
        broker.shutdown()
        server.shutdown()


def test_a_join_extract_payload_is_not_a_merged_result_field():
    """``join_payload`` rides one extract reply to the broker's exchange;
    it is None on a fresh result and not merged."""
    from pinot_tpu_torch.engine.results import IntermediateResult

    a, b = IntermediateResult(), IntermediateResult()
    assert a.join_payload is None
    b.join_payload = {"n": 1}
    b.add_cost(buildRows=3, probeRows=5)
    a.merge(b)
    assert a.join_payload is None and a.cost == {"buildRows": 3, "probeRows": 5}
