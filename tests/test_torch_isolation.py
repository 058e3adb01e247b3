"""The port stands alone: it imports neither JAX nor any module of the JAX
package, and it never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pinot_tpu_torch"

_CHILD = r"""
import importlib.abc
import sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError


class _BlockReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "pinot_tpu" or name.startswith("pinot_tpu."):
            raise ImportError(f"blocked import of the reference package: {name}")
        return None


sys.meta_path.insert(0, _BlockReference())

from pinot_tpu_torch.engine import kernel
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

Q1 = ("SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) "
      "FROM lineitem WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus TOP 10")
segs = [synthetic_lineitem_segment(2000, seed=11 + i, name=f"li{i}") for i in range(2)]
req = optimize_request(parse_pql(Q1))
resp = reduce_to_response(req, [QueryExecutor(device="cpu").execute(segs, req)])
groups = resp.aggregation_results[3].group_by_result
assert sum(int(g.value) for g in groups) == 4000, groups
# the two filter tiers ahead of the scan: host postings, bit-sliced planes
from pinot_tpu_torch.engine import bitsliced, invindex_path, tiercost
from pinot_tpu_torch.segment import invindex

assert callable(bitsliced.bitsliced_decision) and callable(invindex_path.index_path_decision)
assert tiercost.postings_max_matches(6400) == 100
needle = optimize_request(parse_pql("SELECT count(*) FROM lineitem WHERE l_shipdate = '1995-06-14'"))
assert QueryExecutor(device="cpu").execute(segs, needle)._served_tier == "postings"
assert isinstance(segs[0]._inv_cache["l_shipdate"], invindex.InvertedIndex)
fused = optimize_request(parse_pql("SELECT count(*), sum(l_quantity) FROM lineitem "
                                   "WHERE l_quantity IN (5, 10, 15) AND l_shipmode = 'AIR'"))
assert QueryExecutor(device="cpu").execute(segs, fused)._served_tier == "bitsliced"

# the serving path: a port server behind the port broker over TCP
from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.tcp import TcpServer, TcpTransport

server = ServerInstance("iso", device="cpu", device_fault_injector=DeviceFaultInjector())
for s in segs:
    server.add_segment("lineitem", s)
tcp = TcpServer(server.handle_request)
tcp.start()
routing = RoutingTableProvider()
routing.update("lineitem", {s.segment_name: {"iso": "ONLINE"} for s in segs})
broker = BrokerRequestHandler(TcpTransport(), {"iso": tcp.address}, routing=routing)
served = broker.handle_pql(Q1)
assert not served.exceptions, served.exceptions
assert served.aggregation_results[3].group_by_result == groups
assert server.status()["lane"]["dispatches"] == 1
# EXPLAIN over what the server holds, then a demotion and a promotion
from pinot_tpu_torch.tools.explain_dump import render_explain

plan = broker.handle_pql("EXPLAIN " + Q1)
assert not plan.exceptions and plan.explain["servers"][0]["device"]["compile"]["state"] == "warm"
assert render_explain(plan.to_json()).startswith("EXPLAIN ")
tiers = server.executor.residency
tiers.hbm_cap_bytes = 1
assert tiers.enforce() > 0 and tiers.snapshot()["warmTables"] == 1
tiers.hbm_cap_bytes = 0
assert broker.handle_pql(Q1).aggregation_results[3].group_by_result == groups
assert tiers.counter("promotions") == 1
# the utilization and warm-start planes: plan statistics on both roles,
# one torch.profiler capture, the declared peaks, the compile cache's
# ledger, the query quota and one prewarm pass on a second server
import os.path as _osp
import tempfile as _tempfile
import time as _time

from pinot_tpu_torch.broker import quota
from pinot_tpu_torch.engine import compilecache
from pinot_tpu_torch.utils import platform

assert server.plan_stats.digest_count() >= 1 and broker.planstats.digest_count() >= 1
server.profile_start(timeout_s=60)
assert broker.handle_pql(Q1).aggregation_results[3].group_by_result == groups
capture = server.profile_stop()["lastCapture"]
assert _osp.exists(_osp.join(capture["dir"], "trace.json")), capture
assert platform.platform_peaks(refresh=True)["source"] == "unknown"
with _tempfile.TemporaryDirectory() as root:
    assert compilecache.record_plan("abc", root=root) and compilecache.known_plan("abc", root=root)
assert quota.QueryQuotaManager().allow("lineitem")
warm = ServerInstance("iso-warm", device="cpu")
for s in segs:
    warm.add_segment("lineitem", s)
warm.prewarm.workload_source = lambda tables, n: broker.workload_snapshot(top=n)["topByCount"]
warm.prewarm.request_prewarm("lineitem")
_end = _time.monotonic() + 60
while warm.prewarm.warming and _time.monotonic() < _end:
    _time.sleep(0.01)
assert warm.metrics.meter("prewarm.compiled").count >= 1, warm.prewarm.state()
assert warm.metrics.meter("compile.prewarmed").count >= 1 and warm.executor.staged_bytes() == 0
warm.shutdown()
# a join through the same broker: SSB lineorder / date, every strategy
from pinot_tpu_torch.tools.datagen import ssb_date_segment, ssb_lineorder_segment

for p in range(2):
    server.add_segment("lineorder", ssb_lineorder_segment(3000, p, 2, 1000, seed=p))
server.add_segment("date", ssb_date_segment())
routing.update("lineorder", {f"lineorder_p{p}": {"iso": "ONLINE"} for p in range(2)})
routing.update("date", {"date_0": {"iso": "ONLINE"}})
JOIN = ("SELECT count(*), sum(l.lo_revenue) FROM lineorder l JOIN date d "
        "ON l.lo_orderdate = d.d_datekey WHERE d.d_year = 1993")
counts = set()
for strategy in ("broadcast", "shuffle"):
    joined = broker.handle_pql(JOIN, debug_options={"joinStrategy": strategy})
    assert not joined.exceptions, joined.exceptions
    assert "deviceBytes" in joined.cost, joined.cost
    counts.add(joined.aggregation_results[0].value)
assert len(counts) == 1 and int(counts.pop()) > 0
# the serving planes: the result cache, the shadow audit's host oracle,
# admission, the SLO / tail / history / flight-recorder planes, freshness
from pinot_tpu_torch.broker import admission, freshness, querylog
from pinot_tpu_torch.common import conf
from pinot_tpu_torch.engine import rescache
from pinot_tpu_torch.utils import audit, flightrec, slo, tailsample, timeseries

server.result_cache.enabled = True
first = broker.handle_pql(Q1)
hit = broker.handle_pql(Q1)
assert hit.cost == {"rescacheHits": 1} and hit.aggregation_results[3].group_by_result == groups
oracle = server.executor.execute_host_oracle(segs, req)
assert oracle._served_tier == "host"
assert audit.payloads_equivalent(audit.canonical_payload(req, oracle), audit.strip_accounting(first.to_json()))
assert broker.admission.snapshot()["tableInflight"] == {} and broker.tail.armed
assert isinstance(rescache.ResultCache, type) and conf.BrokerConf().hedge_delay_ms == 0.0
assert callable(freshness.batch_max_event_ms) and querylog.SlowQueryLog().threshold_ms == 500.0
assert slo.default_objective()["latencyMs"] == 500.0 and tailsample.TAIL_ALLOCATIONS >= 0
assert callable(timeseries.leaked_recorder_threads) and not flightrec.FlightRecorder("server", "iso").enabled
assert isinstance(admission.AdmissionController().max_inflight_per_table, int)
broker.shutdown()
tcp.stop()
server.shutdown()
# the deployment path: segment files with zone maps, the controller, the
# two network starters and the admin CLI
import os
import tempfile

from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.engine import zonemap
from pinot_tpu_torch.segment.format import read_segment, write_segment
from pinot_tpu_torch.server.network_starter import NetworkedServerStarter
from pinot_tpu_torch.tools import admin

with tempfile.TemporaryDirectory() as td:
    path = write_segment(segs[0], os.path.join(td, "seg"))
    assert read_segment(path).num_docs == 2000
    # star-tree segments: the row builder, the readers, the cube, its file
    # buffers and the executor's star split; the time pruner
    from pinot_tpu_torch.engine import pruner
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.readers import read_jsonl
    from pinot_tpu_torch.startree import StarTreeBuilderConfig
    from pinot_tpu_torch.tools.datagen import baseball_rows, baseball_schema, synthetic_baseball_segment

    bb = build_segment(baseball_schema(), baseball_rows(300, seed=1), "baseballStats", "bb",
                       startree_config=StarTreeBuilderConfig())
    bb = read_segment(write_segment(bb, os.path.join(td, "bb")))
    bb_req = optimize_request(parse_pql("SELECT sum(runs) FROM baseballStats GROUP BY teamID TOP 5"))
    bb_res = QueryExecutor(device="cpu").execute([bb, synthetic_baseball_segment(500, seed=2)], bb_req)
    assert bb_res.cost["segmentsStarTree"] == 1 and bb_res.cost["segmentsFullScan"] == 1, bb_res.cost
    assert pruner.prune_segments(segs, req) == segs and callable(read_jsonl)
    assert zonemap.column_zones(segs[0], "l_shipdate", 1024) is not None
    ctrl_http = ControllerHttpServer(Controller(os.path.join(td, "ctrl")))
    ctrl_http.start()
    ctrl_http.stop()
    # realtime ingestion: a REALTIME table of an in-process cluster over a
    # memory stream, consumed, committed and queried; the stream broker
    from pinot_tpu_torch.realtime import backpressure, llc, mutable, netstream, pool, stream
    from pinot_tpu_torch.tools import cluster_harness, quickstart

    rt = quickstart.run_realtime_quickstart(num_events=600, device="cpu", verbose=False)
    assert rt.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == 600
    rt.stop()
    sb = netstream.StreamBrokerServer()
    sb.start()
    sb.stop()
    assert callable(backpressure.instance_mutable_bytes) and callable(pool.leaked_pool_threads)
    # the offline build path: default columns, the columnar CSV build with
    # its native parser, Avro, the converters and the batch build
    from pinot_tpu_torch.segment import avro, columnar, default_column, native
    from pinot_tpu_torch.tools import batch_build, converters
    from pinot_tpu_torch.tools.datagen import lineitem_schema, random_rows

    li_rows = random_rows(lineitem_schema(), 50, seed=1)
    csv_path = os.path.join(td, "li.csv")
    names = [f.name for f in lineitem_schema().all_fields()]
    with open(csv_path, "w") as f:
        f.write(",".join(names) + "\n" + "".join(",".join(str(r[n]) for n in names) + "\n" for r in li_rows))
    built = columnar.build_segment_from_csv(lineitem_schema(), csv_path, "lineitem", "csv0")
    assert built.metadata.crc == build_segment(lineitem_schema(), li_rows, "lineitem", "csv0").metadata.crc
    avro_path = os.path.join(td, "li.avro")
    avro.write_avro(avro_path, avro.pinot_to_avro_schema(lineitem_schema()), li_rows, codec="deflate")
    assert avro.read_avro(avro_path, lineitem_schema()) == li_rows
    assert converters.segment_to_jsonl(built, os.path.join(td, "li.jsonl")) == 50
    assert default_column.inject_default_columns(built, lineitem_schema()) == 0
    assert callable(batch_build.run_batch_build) and native.csv_available()
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert "libcsvread-" in maps and "libpinotnative" not in maps, "the port loaded native/"

leaked = sorted(m for m in sys.modules if m == "pinot_tpu" or m.startswith("pinot_tpu.")
                or m == "jax" and sys.modules[m] is not None or m.startswith("jax."))
assert not leaked, leaked
print("ISOLATED-OK", len(groups))
"""


def test_q1_runs_with_jax_and_the_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ISOLATED-OK 6" in out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return module in ("jax", "pinot_tpu") or module.startswith(("jax.", "pinot_tpu."))


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(REPO / path) if _forbidden(m)]
    assert not bad, (path, bad)


def test_no_device_and_no_cuda_raises(monkeypatch):
    from pinot_tpu_torch.engine.executor import QueryExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        QueryExecutor()
    with pytest.raises(RuntimeError):
        QueryExecutor(device="cuda")
    assert QueryExecutor(device="cpu").device.type == "cpu"


def test_realtime_config_accepted_and_hlc_or_kafka_refused():
    """A REALTIME LLC config round-trips as the reference writes it, and
    so do a high-level consumer group and a Kafka stream: the port once
    refused those two, and now takes them as the reference does."""
    from pinot_tpu.common.tableconfig import StreamConfig as RefStreamConfig
    from pinot_tpu.common.tableconfig import TableConfig as RefTableConfig
    from pinot_tpu_torch.common import tableconfig
    from pinot_tpu_torch.common.tableconfig import TableConfig

    ref = RefTableConfig("rt", table_type="REALTIME", replication=2, stream=RefStreamConfig(
        stream_type="network", topic="rt", rows_per_segment=5000, properties={"host": "127.0.0.1", "port": 9}))
    port = TableConfig.from_json(ref.to_json())
    assert port.to_json() == ref.to_json() and port.physical_name == "rt_REALTIME"
    assert port.stream.rows_per_segment == 5000 and port.stream.consumer_type == "lowlevel"
    for change in ({"consumerType": "highlevel"}, {"streamType": "kafka"},
                   {"streamType": "kafka", "consumerType": "highlevel"}):
        d = ref.to_json()
        d["streamConfigs"].update(change)
        port = TableConfig.from_json(d)
        assert port.to_json() == RefTableConfig.from_json(d).to_json() == d
    assert not hasattr(tableconfig, "REALTIME_ITEM")


def test_precision_mode_is_explicit():
    from pinot_tpu_torch.engine.config import Precision

    assert Precision("x32").float_dtype == torch.float32
    assert Precision("x32").key_dtype == torch.int32
    assert Precision("x64").max_key_space == 2**62
    with pytest.raises(ValueError):
        Precision("bf16")
