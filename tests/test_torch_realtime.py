"""Realtime ingestion in the port, held against the JAX package on the CPU.

The reference's ``InProcessCluster`` and the port's take the same seeded
rows, the same ``rows_per_segment`` and the same sequence of
``consume_step`` / ``try_commit`` calls; at every watermark the broker
responses (the audit comparison: rel 5e-4 / abs 1e-3 on float leaves,
exact elsewhere, and the scan accounting exactly), the ideal states and
external views, the segment names, the committed start / end offsets and
the committed segments' crcs must be equal.  The cases mirror
``tests/test_realtime.py``: mutable snapshots, consume / commit /
rollover, two replicas catching up (their completion answers equal), the
validation repair, file streams, several partitions, the hybrid time
boundary, batch atomicity, exactly-once ingestion under
``FlakyStreamProvider`` and the columnar latch.  The port's own: the
staged bytes stay at one snapshot of each consuming segment plus the
sealed segments across many watermarks, the ingest governor pauses and
resumes at forced watermarks, the ingest pool drives consumers to their
commits while queries read whole batches, and every pool, consumer and
server a test starts is stopped (``leaked_pool_threads`` stays empty).
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.schema import TimeFieldSpec as RefTimeFieldSpec
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.reduce import reduce_to_response as ref_reduce
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.realtime import llc as ref_llc
from pinot_tpu.realtime.mutable import MutableSegment as RefMutableSegment
from pinot_tpu.realtime.stream import FileBasedStreamProvider as RefFileStream
from pinot_tpu.realtime.stream import FlakyStreamProvider as RefFlaky
from pinot_tpu.realtime.stream import MemoryStreamProvider as RefMemoryStream
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import parse_pql
from pinot_tpu_torch.realtime import llc
from pinot_tpu_torch.realtime.backpressure import IngestBackpressure, instance_mutable_bytes
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.pool import IngestConsumerPool, leaked_pool_threads
from pinot_tpu_torch.realtime.stream import FileBasedStreamProvider, FlakyStreamProvider, MemoryStreamProvider
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.server.scheduler import leaked_scheduler_threads
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

REL, ABS = 5e-4, 1e-3
TABLE = "meetupRsvp"
# the scan accounting a snapshot must report as the reference does
ACCOUNTING = ("numDocsScanned", "numEntriesScannedInFilter", "numEntriesScannedPostFilter", "totalDocs")
TIER_COSTS = ("segmentsZonemap", "segmentsFullScan", "segmentsHost", "segmentsPostings", "segmentsBitsliced")
QUERIES = (
    "SELECT count(*) FROM meetupRsvp",
    "SELECT sum(rsvp_count) FROM meetupRsvp GROUP BY venue_name",
    "SELECT max(mtime), min(rsvp_count), avg(rsvp_count) FROM meetupRsvp",
    "SELECT distinctcount(event_name) FROM meetupRsvp GROUP BY venue_name",
    "SELECT count(*) FROM meetupRsvp WHERE mtime > 1000040 GROUP BY event_name",
    "SELECT sum(rsvp_count) FROM meetupRsvp WHERE venue_name IN ('venue1', 'venue3')",
    "SELECT venue_name, rsvp_count, mtime FROM meetupRsvp ORDER BY mtime DESC LIMIT 5",
)
WAIT_S = 30.0


def rsvp_schema(port: bool = True):
    """meetupRsvp-style schema (the RealtimeQuickStart's), in either package."""
    D, F, T, S, TF = (DataType, FieldSpec, FieldType, Schema, TimeFieldSpec) if port else (
        RefDataType, RefFieldSpec, RefFieldType, RefSchema, RefTimeFieldSpec)
    return S(TABLE, dimensions=[F("venue_name", D.STRING), F("event_name", D.STRING)],
             metrics=[F("rsvp_count", D.INT, T.METRIC)],
             time_field=TF("mtime", D.LONG, time_unit="MILLISECONDS"))


def make_row(i):
    return {"venue_name": f"venue{i % 5}", "event_name": f"event{i % 3}", "rsvp_count": i % 7, "mtime": 1_000_000 + i}


def seeded_rows(n, seed=5):
    """``n`` rows drawn from a seeded numpy generator, in time order."""
    rng = np.random.default_rng(seed)
    venues = rng.integers(0, 12, n)
    events = rng.integers(0, 4, n)
    counts = rng.integers(0, 9, n)
    return [{"venue_name": f"venue{int(v)}", "event_name": f"event{int(e)}", "rsvp_count": int(c),
             "mtime": 1_000_000 + i} for i, (v, e, c) in enumerate(zip(venues, events, counts))]


@pytest.fixture(autouse=True)
def _nothing_leaks():
    yield
    assert not leaked_pool_threads(grace_s=2.0)
    assert not leaked_scheduler_threads(grace_s=4.0)


class Pair:
    """The reference cluster and the port's, driven by the same calls."""

    def __init__(self, tmp_path, num_servers=1):
        self.ref = RefCluster(num_servers=num_servers, data_dir=str(tmp_path / "ref"))
        self.port = InProcessCluster(num_servers=num_servers, data_dir=str(tmp_path / "port"), device="cpu")

    def add_realtime_table(self, make_stream, **kw):
        self.ref_stream, self.port_stream = make_stream(True), make_stream(False)
        ref_phys = self.ref.add_realtime_table(rsvp_schema(False), self.ref_stream, **kw)
        port_phys = self.port.add_realtime_table(rsvp_schema(True), self.port_stream, **kw)
        assert ref_phys == port_phys
        self.physical = port_phys
        return port_phys

    def consumers(self, partition, seq):
        name = llc.make_segment_name(self.physical, partition, seq)
        return (self.ref.controller.realtime_manager.consumers_of(name),
                self.port.controller.realtime_manager.consumers_of(name))

    def assert_same(self, pqls=QUERIES):
        for pql in pqls:
            want = self.ref.query(pql).to_json()
            got = self.port.query(pql).to_json()
            assert not got["exceptions"], (pql, got["exceptions"])
            assert payloads_equivalent(strip_accounting(got), strip_accounting(want), rel_tol=REL, abs_tol=ABS), \
                (pql, got, want)
            for key in ACCOUNTING:
                assert got[key] == want[key], (pql, key, got[key], want[key])
            for key in TIER_COSTS:
                assert got["cost"].get(key, 0) == want["cost"].get(key, 0), (pql, key, got["cost"], want["cost"])
        self.assert_same_state()

    def assert_same_state(self):
        rres, pres = self.ref.controller.resources, self.port.controller.resources
        for phys in pres.tables():
            assert pres.get_ideal_state(phys) == rres.get_ideal_state(phys)
            assert pres.get_external_view(phys) == rres.get_external_view(phys)
            assert sorted(pres.segments_of(phys)) == sorted(rres.segments_of(phys))
            for seg in pres.segments_of(phys):
                pm = pres.get_segment_metadata(phys, seg)["metadata"]
                rm = rres.get_segment_metadata(phys, seg)["metadata"]
                for key in ("startOffset", "endOffset", "partition", "seq", "status"):
                    assert pm.custom.get(key) == rm.custom.get(key), (seg, key)
                assert pm.num_docs == rm.num_docs, seg
                if pm.custom.get("dataCrc"):  # committed or uploaded: the data crc of both
                    assert pm.crc == rm.crc, seg
                    committed = pres.get_segment_metadata(phys, seg).get("segment")
                    assert committed is None or committed.compute_crc() == pm.crc, seg

    def stop(self):
        self.port.stop()
        self.ref.stop()


@pytest.fixture
def pair_factory(tmp_path):
    made = []

    def make(num_servers=1):
        p = Pair(tmp_path, num_servers)
        made.append(p)
        return p

    yield make
    for p in made:
        p.stop()


def memory_stream(partitions=1):
    return lambda ref: (RefMemoryStream if ref else MemoryStreamProvider)(num_partitions=partitions)


# ---------------------------------------------------------------- mutable
@pytest.mark.parametrize("rows_fn", [lambda: [make_row(i) for i in range(100)], lambda: seeded_rows(700)],
                         ids=["modular", "seeded"])
def test_mutable_segment_snapshot_queries(rows_fn):
    rows = rows_fn()
    seg, ref = MutableSegment(rsvp_schema(), "m0", "rt"), RefMutableSegment(rsvp_schema(False), "m0", "rt")
    for r in rows:
        seg.index(r)
        ref.index(r)
    snap = seg.snapshot()
    assert snap.num_docs == len(rows)
    assert seg.snapshot() is snap  # cached until the watermark moves
    extra = make_row(len(rows))
    seg.index(extra)
    ref.index(extra)
    snap2, rsnap = seg.snapshot(), ref.snapshot()
    assert snap2 is not snap and snap2.num_docs == len(rows) + 1
    # the same columns as the reference's snapshot: dictionaries, forward
    # indexes, sortedness (the docrange path), the data crc
    for name, col in snap2.columns.items():
        rcol = rsnap.columns[name]
        assert list(np.asarray(col.dictionary.values)) == list(np.asarray(rcol.dictionary.values)), name
        assert np.array_equal(col.fwd, rcol.fwd), name
        assert col.metadata.to_json() == rcol.metadata.to_json(), name
    assert snap2.metadata.columns["mtime"].is_sorted
    assert (snap2.metadata.start_time, snap2.metadata.end_time) == (rsnap.metadata.start_time, rsnap.metadata.end_time)
    assert snap2.compute_crc() == rsnap.compute_crc()
    for pql in QUERIES:
        got = reduce_to_response(parse_pql(pql), [QueryExecutor(device="cpu").execute([snap2], parse_pql(pql))])
        want = ref_reduce(ref_parse(pql), [RefExecutor().execute([rsnap], ref_parse(pql))])
        assert payloads_equivalent(strip_accounting(got.to_json()), strip_accounting(want.to_json()),
                                   rel_tol=REL, abs_tol=ABS), pql


def test_columnar_index_matches_row_path_and_reference():
    rows = seeded_rows(3000, seed=9)
    cols = {
        "venue_name": np.array([r["venue_name"] for r in rows]),
        "event_name": np.array([r["event_name"] for r in rows], dtype=object),
        "rsvp_count": np.array([r["rsvp_count"] for r in rows], dtype=np.int64),
        "mtime": np.array([r["mtime"] for r in rows], dtype=np.int64),
    }
    col_seg, row_seg = MutableSegment(rsvp_schema(), "c", "rt"), MutableSegment(rsvp_schema(), "c", "rt")
    ref_seg = RefMutableSegment(rsvp_schema(False), "c", "rt")
    for lo in range(0, 3000, 1000):
        assert col_seg.index_columns({k: v[lo:lo + 1000] for k, v in cols.items()}) == 1000
        ref_seg.index_columns({k: v[lo:lo + 1000] for k, v in cols.items()})
    row_seg.index_batch(rows)
    a, b, c = col_seg.to_committed_segment(), row_seg.to_committed_segment(), ref_seg.to_committed_segment()
    assert a.metadata.crc == b.metadata.crc == c.metadata.crc
    assert a.rows()[:50] == b.rows()[:50]


def test_segment_name_roundtrip():
    name = llc.make_segment_name("rt_REALTIME", 3, 7)
    assert name == ref_llc.make_segment_name("rt_REALTIME", 3, 7)
    assert llc.parse_segment_name(name) == ("rt_REALTIME", 3, 7)


# ---------------------------------------------------------------- llc flow
def test_consume_query_commit_rollover(pair_factory):
    pair = pair_factory()
    physical = pair.add_realtime_table(memory_stream(), rows_per_segment=50)
    rows = seeded_rows(120)
    for r in rows:
        pair.ref_stream.produce(r)
        pair.port_stream.produce(r)
    (rdm,), (pdm,) = pair.consumers(0, 0)
    # a partial batch is visible at once
    assert rdm.consume_step(max_rows=30) == pdm.consume_step(max_rows=30) == 30
    assert pair.port.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == 30
    pair.assert_same()
    # the threshold: commit, then the rollover to seq 1
    rdm.consume_step(max_rows=1000)
    pdm.consume_step(max_rows=1000)
    assert pdm.threshold_reached
    assert rdm.try_commit() == pdm.try_commit() == llc.RESP_KEEP
    ideal = pair.port.controller.resources.get_ideal_state(physical)
    seg0, seg1 = (llc.make_segment_name(physical, 0, s) for s in (0, 1))
    assert ideal[seg0] == {"server0": "ONLINE"} and ideal[seg1] == {"server0": "CONSUMING"}
    info = pair.port.controller.resources.get_segment_metadata(physical, seg0)
    assert (info["metadata"].custom["startOffset"], info["metadata"].custom["endOffset"]) == (0, 50)
    pair.assert_same()
    (rdm1,), (pdm1,) = pair.consumers(0, 1)
    assert pdm1.offset == rdm1.offset == 50
    rdm1.consume_step(max_rows=1000)
    pdm1.consume_step(max_rows=1000)
    assert rdm1.try_commit() == pdm1.try_commit() == llc.RESP_KEEP
    (rdm2,), (pdm2,) = pair.consumers(0, 2)
    for step in (7, 13):  # watermarks inside the third segment
        rdm2.consume_step(max_rows=step)
        pdm2.consume_step(max_rows=step)
        pair.assert_same()
    assert pair.port.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == 120


def test_replicated_consumers_catch_up(pair_factory):
    pair = pair_factory(num_servers=2)
    physical = pair.add_realtime_table(memory_stream(), rows_per_segment=40, replication=2)
    for r in seeded_rows(60, seed=2):
        pair.ref_stream.produce(r)
        pair.port_stream.produce(r)
    rdms, pdms = pair.consumers(0, 0)
    assert len(rdms) == len(pdms) == 2
    answers = []
    for (fast, slow) in (rdms, pdms):
        fast.consume_step(max_rows=40)
        slow.consume_step(max_rows=25)  # the laggard
        got = [slow.try_commit(), fast.try_commit()]  # HOLD, then the committer's KEEP
        got.append(slow.try_commit())  # catches up to the committed offset
        got.append(slow.try_commit())
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[1][:2] == [llc.RESP_HOLD, llc.RESP_KEEP]
    seg0 = llc.make_segment_name(physical, 0, 0)
    assert pair.port.controller.resources.get_external_view(physical)[seg0] == {"server0": "ONLINE",
                                                                              "server1": "ONLINE"}
    pair.assert_same()


def test_completion_fsm_answers_equal_the_reference():
    """Both FSMs take the same report sequence: HOLD until every replica
    reported, CATCH_UP below the target, COMMIT to the committer, then
    KEEP / DISCARD by offset, and NOT_LEADER for a non-committer upload."""

    class _Res:
        def get_ideal_state(self, table):
            return {"t_REALTIME__0__0": {"a": "CONSUMING", "b": "CONSUMING", "c": "CONSUMING"}}

    class _Rm:
        resources = _Res()
        epoch = None
        metrics = None

        def physical_table_of(self, seg):
            return "t_REALTIME"

        def on_segment_committed(self, seg, committed):
            pass

    seg = "t_REALTIME__0__0"
    answers = []
    for mod in (ref_llc, llc):
        fsm = mod.SegmentCompletionManager(_Rm())
        got = [fsm.segment_consumed(seg, "a", 90), fsm.segment_consumed(seg, "b", 100),
               fsm.segment_consumed(seg, "c", 95), fsm.segment_consumed(seg, "a", 90),
               fsm.segment_consumed(seg, "b", 100), fsm.segment_commit(seg, "a", None),
               fsm.segment_commit(seg, "b", None), fsm.segment_consumed(seg, "a", 100),
               fsm.segment_consumed(seg, "c", 99)]
        answers.append(got)
    assert answers[0] == answers[1]
    assert [a if isinstance(a, str) else a[0] for a in answers[1]] == [
        "HOLD", "HOLD", "CATCH_UP", "CATCH_UP", "COMMIT", "NOT_LEADER", "KEEP", "KEEP", "DISCARD"]


def test_validation_recreates_consuming(pair_factory):
    pair = pair_factory()
    physical = pair.add_realtime_table(memory_stream(), rows_per_segment=10)
    for i in range(10):
        pair.ref_stream.produce(make_row(i))
        pair.port_stream.produce(make_row(i))
    (rdm,), (pdm,) = pair.consumers(0, 0)
    rdm.consume_step(max_rows=100)
    pdm.consume_step(max_rows=100)
    assert rdm.try_commit() == pdm.try_commit() == llc.RESP_KEEP
    # the seq-1 consuming segment is lost
    seg1 = llc.make_segment_name(physical, 0, 1)
    pair.ref.controller.resources.delete_segment(physical, seg1)
    pair.port.controller.resources.delete_segment(physical, seg1)
    assert seg1 not in pair.port.controller.resources.get_ideal_state(physical)
    assert not pair.port.controller.realtime_manager.consumers_of(seg1)  # released with it
    pair.ref.controller.validation_manager.run_once()
    pair.port.controller.realtime_manager.ensure_consuming_segments()
    ideal = pair.port.controller.resources.get_ideal_state(physical)
    assert ideal[seg1] == {"server0": "CONSUMING"}
    (rdm2,), (pdm2,) = pair.consumers(0, 1)
    assert pdm2.offset == rdm2.offset == 10  # from the committed end offset
    for i in range(10, 14):
        pair.ref_stream.produce(make_row(i))
        pair.port_stream.produce(make_row(i))
    rdm2.consume_step()
    pdm2.consume_step()
    pair.assert_same_state()
    # the port's recreated segment serves its rows.  The reference keeps the
    # deleted segment's consumer, whose mutable no server hosts any more,
    # and answers 10 rows with a 230 (segments unavailable): the port
    # releases a deleted segment's consumers instead
    resp = pair.port.query("SELECT count(*), sum(rsvp_count) FROM meetupRsvp")
    assert not resp.exceptions
    assert [float(a.value) for a in resp.aggregation_results] == [14.0, float(sum(i % 7 for i in range(14)))]


def test_file_stream_provider(tmp_path):
    p = tmp_path / "part0.jsonl"
    p.write_text("\n".join(json.dumps(make_row(i)) for i in range(25)))
    port, ref = FileBasedStreamProvider([str(p)]), RefFileStream([str(p)])
    assert port.partition_count() == ref.partition_count() == 1
    assert port.latest_offset(0) == ref.latest_offset(0) == 25
    for off in (0, 10, 20, 25):
        assert port.fetch(0, off, 10) == ref.fetch(0, off, 10)


@pytest.mark.parametrize("change", ["append", "shorter", "same_length", "longer", "replaced"])
def test_file_stream_provider_after_the_file_changes(tmp_path, change):
    """The port's line index against the reference's reread: an append,
    an in-place rewrite shorter, of the same length and longer, and a
    file replaced by a rename give the reference's fetches."""
    p = tmp_path / "part0.jsonl"

    def text(lo, hi, pad=0):  # lines of three lengths, shifted by ``pad``
        return "".join(json.dumps({**make_row(i), "venue_name": f"venue{i % 5}" + "-" * ((i + pad) % 3)}) + "\n"
                       for i in range(lo, hi))

    p.write_text(text(0, 20))
    port, ref = FileBasedStreamProvider([str(p)]), RefFileStream([str(p)])
    assert port.fetch(0, 0, 50) == ref.fetch(0, 0, 50)
    if change == "append":
        with open(p, "a") as f:
            f.write(text(20, 30))
    elif change == "shorter":
        p.write_text(text(0, 12, pad=1))
    elif change == "same_length":  # the first and the third line swapped (their lengths differ by 2)
        lines = text(0, 20).splitlines(keepends=True)
        lines[0], lines[2] = lines[2], lines[0]
        p.write_text("".join(lines))
    elif change == "longer":
        p.write_text(text(0, 25, pad=1))
    else:
        q = tmp_path / "next.jsonl"
        q.write_text(text(0, 20, pad=2))
        os.replace(q, p)
    assert port.latest_offset(0) == ref.latest_offset(0)
    for off in (0, 1, 5, 19, 20):
        assert port.fetch(0, off, 50) == ref.fetch(0, off, 50)


def test_file_stream_table(pair_factory, tmp_path):
    paths = []
    for part in range(2):
        p = tmp_path / f"p{part}.jsonl"
        p.write_text("\n".join(json.dumps(r) for r in seeded_rows(37, seed=part)))
        paths.append(str(p))
    pair = pair_factory()
    physical = pair.add_realtime_table(lambda ref: (RefFileStream if ref else FileBasedStreamProvider)(paths),
                                       rows_per_segment=20)
    for part in range(2):
        for seq in range(2):
            (rdm,), (pdm,) = pair.consumers(part, seq)
            assert rdm.consume_step(100) == pdm.consume_step(100)
            if pdm.threshold_reached:
                assert rdm.try_commit() == pdm.try_commit() == llc.RESP_KEEP
            pair.assert_same(QUERIES[:3])
    assert pair.port.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == 74
    assert physical in pair.port.controller.resources.tables()


def test_multi_partition(pair_factory):
    pair = pair_factory(num_servers=2)
    physical = pair.add_realtime_table(memory_stream(2), rows_per_segment=1000)
    for i, r in enumerate(seeded_rows(30, seed=4)):
        pair.ref_stream.produce(r, partition=i % 2)
        pair.port_stream.produce(r, partition=i % 2)
    for p in range(2):
        rdms, pdms = pair.consumers(p, 0)
        for dm in [*rdms, *pdms]:
            dm.consume_step(max_rows=100)
    assert pair.port.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == 30
    pair.assert_same()
    assert physical.endswith("_REALTIME")


# ---------------------------------------------------------------- hybrid
def test_hybrid_time_boundary(pair_factory):
    pair = pair_factory()
    for cluster, schema, build in ((pair.ref, rsvp_schema(False), ref_build_segment),
                                   (pair.port, rsvp_schema(True), build_segment)):
        phys = cluster.add_offline_table(schema, table_name=TABLE)
        cluster.upload(phys, build(schema, [make_row(i) for i in range(50)], phys, "off0"))
    pair.add_realtime_table(memory_stream(), rows_per_segment=1000)
    for i in range(30, 80):  # overlaps the offline side's 30..49
        pair.ref_stream.produce(make_row(i))
        pair.port_stream.produce(make_row(i))
    (rdm,), (pdm,) = pair.consumers(0, 0)
    rdm.consume_step(max_rows=100)
    pdm.consume_step(max_rows=100)
    resp = pair.port.query("SELECT count(*) FROM meetupRsvp")
    assert resp.num_docs_scanned == 80 and not resp.exceptions  # each row once
    assert pair.port.query("SELECT max(mtime) FROM meetupRsvp").aggregation_results[0].value == 1_000_079.0
    pair.assert_same(QUERIES[:3])


# ---------------------------------------------------------------- atomicity
def test_index_batch_dirty_row_is_atomic():
    seg = MutableSegment(rsvp_schema(), "atom", "t")
    seg.index_batch([make_row(i) for i in range(10)])
    with pytest.raises(Exception):
        seg.index_batch([make_row(10), {**make_row(11), "rsvp_count": "not-an-int"}])
    assert seg.num_docs == 10
    seg.index_batch([make_row(10), make_row(11)])
    snap = seg.snapshot()
    assert snap.num_docs == 12
    assert snap.row(11) == {k: make_row(11)[k] for k in snap.columns}
    ref = RefMutableSegment(rsvp_schema(False), "atom", "t")
    ref.index_batch([make_row(i) for i in range(12)])
    assert snap.compute_crc() == ref.snapshot().compute_crc()


def test_index_batch_nested_list_sv_value_is_atomic():
    schema = Schema("t", dimensions=[FieldSpec("mv", DataType.INT_ARRAY, single_value=False),
                                     FieldSpec("a", DataType.INT)])
    seg = MutableSegment(schema, "nested", "t")
    with pytest.raises(Exception):
        seg.index_batch([{"mv": [1], "a": [1, 2]}, {"mv": [2], "a": [3, 4]}])
    assert seg.num_docs == 0
    seg.index_batch([{"mv": [9], "a": 7}])
    assert seg.snapshot().row(0) == {"mv": [9], "a": 7}


def test_index_batch_nan_dict_cardinality_stable():
    schema = Schema("t", metrics=[FieldSpec("m", DataType.DOUBLE, FieldType.METRIC)])
    nan = float("nan")
    fast, slow = MutableSegment(schema, "f", "t"), MutableSegment(schema, "s", "t")
    fast.index_batch([{"m": nan}, {"m": nan}])
    slow.index_batch([{"m": nan}, {"m": nan}, {"m": None}])
    assert len(fast._columns["m"].id_to_value) == len(set(slow._columns["m"].ids[:2].tolist()))


def test_flaky_consumer_ingests_exactly_once(pair_factory):
    pair = pair_factory()
    physical = pair.add_realtime_table(
        lambda ref: (RefFlaky if ref else FlakyStreamProvider)(
            (RefMemoryStream if ref else MemoryStreamProvider)(1), fail_rate=0.6, seed=42),
        rows_per_segment=50)
    total = 173
    rows = seeded_rows(total, seed=3)
    for r in rows:
        pair.ref_stream.inner.produce(r)
        pair.port_stream.inner.produce(r)
    # the same call sequence on both, retried as the networked consume loop does
    seq, attempts = 0, 0
    while attempts < 4000:
        attempts += 1
        rdms, pdms = pair.consumers(0, seq)
        if not pdms:
            assert not rdms
            break
        outcome = []
        for dm in (rdms[0], pdms[0]):
            try:
                outcome.append(dm.consume_step(max_rows=64))
            except RuntimeError:
                outcome.append("failed")
        assert outcome[0] == outcome[1], attempts
        if outcome[1] == "failed":
            continue
        if pdms[0].threshold_reached:
            assert rdms[0].try_commit() == pdms[0].try_commit()
            seq += 1
        elif outcome[1] == 0:
            break
    assert pair.port_stream.failures == pair.ref_stream.failures > 5
    assert pair.port.query("SELECT count(*) FROM meetupRsvp").num_docs_scanned == total
    pair.assert_same()
    end = 0
    for s in range(seq):
        info = pair.port.controller.resources.get_segment_metadata(physical, llc.make_segment_name(physical, 0, s))
        assert info["metadata"].custom["startOffset"] == end
        end = info["metadata"].custom["endOffset"]
    assert end == 150


# ---------------------------------------------------------------- columnar latch
def _columnar_dm(stream):
    return llc.RealtimeSegmentDataManager(None, None, "rt_REALTIME", "rt__0__0__t", rsvp_schema(), stream, 0, 0,
                                          1000)


def _ref_columnar_dm(stream):
    return ref_llc.RealtimeSegmentDataManager(None, None, "rt_REALTIME", "rt__0__0__t", rsvp_schema(False), stream,
                                              0, 0, 1000)


def _block(n, start=0):
    return {
        "venue_name": np.array([f"venue{i % 5}" for i in range(start, start + n)]),
        "event_name": np.array([f"event{i % 3}" for i in range(start, start + n)]),
        "rsvp_count": np.arange(start, start + n, dtype=np.int64) % 7,
        "mtime": np.arange(1_000_000 + start, 1_000_000 + start + n, dtype=np.int64),
    }


class _FailOnceStream:
    def __init__(self):
        self.transport_failures = 1
        self.row_fetches = 0

    def fetch_columns(self, partition, offset):
        if self.transport_failures:
            self.transport_failures -= 1
            raise OSError("connection reset by peer")
        return _block(10), 10, offset + 10

    def fetch(self, partition, offset, max_rows):
        self.row_fetches += 1
        return [], offset


class _BadReplyOnceStream:
    def __init__(self):
        self.bad = 1

    def fetch_columns(self, partition, offset):
        if self.bad:
            self.bad -= 1
            raise RuntimeError("stream broker: bad reply")
        return _block(4), 4, offset + 4

    def fetch(self, partition, offset, max_rows):
        raise AssertionError("row path must not engage")


class _RowModeStream:
    def __init__(self):
        self.columnar_attempts = 0

    def fetch_columns(self, partition, offset):
        self.columnar_attempts += 1
        raise RuntimeError("stream broker: row-mode partition")

    def fetch(self, partition, offset, max_rows):
        rows = [make_row(i) for i in range(offset, min(offset + max_rows, 5))]
        return rows, offset + len(rows)


class _FlakyColumnarStream:
    def __init__(self):
        self.calls = 0

    def fetch_columns(self, partition, offset):
        self.calls += 1
        if self.calls == 2:
            raise OSError("tunnel hiccup")
        return _block(3, start=offset), 3, offset + 3

    def fetch(self, partition, offset, max_rows):
        raise AssertionError("row path must not engage")


def _latch_trace(make_dm, stream):
    """(result or exception type, _columnar, offset) after each of four steps."""
    dm = make_dm(stream)
    out = []
    for _ in range(4):
        try:
            got = dm.consume_step()
        except Exception as e:  # noqa: BLE001 - the type is compared
            got = type(e).__name__
        out.append((got, dm._columnar, dm.offset))
    return out, dm


@pytest.mark.parametrize("stream_cls", [_FailOnceStream, _BadReplyOnceStream, _RowModeStream, _FlakyColumnarStream],
                         ids=["transient_unknown", "bad_reply_unknown", "definitive_row_mode",
                              "transport_known_columnar"])
def test_columnar_latch(stream_cls):
    got, dm = _latch_trace(_columnar_dm, stream_cls())
    want, _ = _latch_trace(_ref_columnar_dm, stream_cls())
    assert got == want
    expected = {
        _FailOnceStream: [("OSError", None, 0), (10, True, 10)],
        _BadReplyOnceStream: [("RuntimeError", None, 0), (4, True, 4)],
        _RowModeStream: [(5, False, 5), (0, False, 5)],
        _FlakyColumnarStream: [(3, True, 3), ("OSError", True, 3), (3, True, 6)],
    }[stream_cls]
    assert got[:len(expected)] == expected
    if stream_cls is _RowModeStream:
        assert dm.stream.columnar_attempts == 1  # latched: no more fetchc probes
    if stream_cls is _FailOnceStream:
        assert dm.stream.row_fetches == 0


# ---------------------------------------------------------------- the port's own
def test_staged_bytes_bounded_across_watermarks(tmp_path):
    """Each snapshot is a new segment, staged anew: the tables of its
    superseded snapshots go, so the staged bytes after many watermarks
    are those of one snapshot of each consuming segment plus the sealed
    segments (what a fresh executor stages for the same segments)."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    try:
        stream = MemoryStreamProvider(2)
        physical = cluster.add_realtime_table(rsvp_schema(), stream, rows_per_segment=300)
        for i, r in enumerate(seeded_rows(900, seed=8)):
            stream.produce(r, partition=i % 2)
        server = cluster.servers[0]
        ex = server.executor
        rm = cluster.controller.realtime_manager
        pqls = (QUERIES[1], QUERIES[3])
        seq = [0, 0]
        for step in range(24):
            p = step % 2
            dm = rm.consumers_of(llc.make_segment_name(physical, p, seq[p]))[0]
            dm.consume_step(max_rows=37)
            if dm.threshold_reached:
                assert dm.try_commit() == llc.RESP_KEEP
                seq[p] += 1
            for pql in pqls:
                assert not cluster.query(pql).exceptions
            # what one snapshot of each consuming segment and the sealed ones need
            tdm = server.data_manager.table(physical)
            acquired = tdm.acquire_segments()
            try:
                views = [a.query_view() for a in acquired]
                fresh = QueryExecutor(device="cpu")
                for pql in pqls:
                    fresh.execute(views, parse_pql(pql))
            finally:
                tdm.release_segments(acquired)
            assert ex.staged_bytes() == fresh.staged_bytes(), step
            assert len(ex._staged) == len(fresh._staged) <= len(pqls), step
            assert len(ex._contexts) == len(fresh._contexts) == 1, step
        assert seq == [1, 1]  # both partitions committed and rolled over inside the loop
        # the committed names hold no snapshot identity; dropping the table frees it all
        cluster.controller.delete_table(physical)
        assert ex.staged_bytes() == 0 and not ex._staged and not ex._contexts
    finally:
        cluster.stop()


def test_backpressure_pauses_and_resumes_at_forced_watermarks():
    hbm = {"bytes": 0.0}
    gov = IngestBackpressure(hbm_high_bytes=1000, hbm_low_bytes=500, mutable_high_bytes=0,
                             hbm_bytes_fn=lambda: hbm["bytes"], poll_interval_s=0.0, max_batch_rows=8)
    stream = MemoryStreamProvider(1)
    for i in range(40):
        stream.produce(make_row(i))

    class _Server:
        name = "s0"
        metrics = None
        ingest_backpressure = gov

    dm = llc.RealtimeSegmentDataManager(_Server(), None, "t_REALTIME", "t_REALTIME__0__0", rsvp_schema(), stream,
                                        0, 0, 1000)
    assert dm.consume_step(100) == 8  # clamped to the governor's batch
    hbm["bytes"] = 1200  # above the high watermark: paused, the offset frozen
    assert dm.consume_step(100) == 0 and dm._paused and gov.paused and dm.offset == 8
    hbm["bytes"] = 700  # between the watermarks: still paused (hysteresis)
    assert dm.consume_step(100) == 0 and gov.paused
    hbm["bytes"] = 400  # under the low watermark: resumed
    assert dm.consume_step(100) == 8 and not gov.paused and dm.offset == 16
    snap = gov.snapshot()
    assert (snap["pauses"], snap["resumes"]) == (1, 1)
    assert [e["event"] for e in snap["events"]] == ["pause", "resume"]
    assert dm.lag() == 24


def test_backpressure_on_mutable_bytes_of_a_server(tmp_path):
    """The server's own governor reads its consuming segments' host bytes."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    try:
        stream = MemoryStreamProvider(1)
        physical = cluster.add_realtime_table(rsvp_schema(), stream, rows_per_segment=10_000)
        for r in seeded_rows(3000):
            stream.produce(r)
        server = cluster.servers[0]
        dm = cluster.controller.realtime_manager.consumers_of(llc.make_segment_name(physical, 0, 0))[0]
        dm.consume_step(1000)
        used = instance_mutable_bytes(server)
        assert used > 0
        gov = server.ingest_backpressure
        gov.mutable_high, gov.mutable_low, gov.poll_interval_s = used, used / 2, 0.0
        assert dm.consume_step(1000) == 0 and gov.paused and "mutable" in gov.reason
        assert server.status()["ingest"]["paused"]
        gov.mutable_high = gov.mutable_low = 0.0  # watermarks off: consumption resumes
        assert dm.consume_step(1000) > 0
    finally:
        cluster.stop()


def test_ingest_pool_drives_commits_while_queries_read_whole_batches(tmp_path):
    """Consumers on the pool's workers ingest and commit while a query
    loop reads the table: every answer is a prefix of the stream (whole
    batches at one watermark, never a torn row), and the end state has
    every row once."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    pool = IngestConsumerPool(workers=2, name="test")
    cluster.controller.realtime_manager.ingest_pool = pool
    try:
        stream = MemoryStreamProvider(1)
        physical = cluster.add_realtime_table(rsvp_schema(), stream, rows_per_segment=400)
        rows = seeded_rows(1000, seed=6)
        prefix = np.concatenate([[0], np.cumsum([r["rsvp_count"] for r in rows])])
        for r in rows[:500]:
            stream.produce(r)
        # the consumers that exist when the pool is set register on it
        for dm in cluster.controller.realtime_manager.consumers_of(llc.make_segment_name(physical, 0, 0)):
            dm.step_rows = 64
            pool.add(dm, key=(dm.segment_name, dm.server.name))
        deadline = time.monotonic() + WAIT_S
        seen = []
        produced = False
        while time.monotonic() < deadline:
            resp = cluster.query("SELECT count(*), sum(rsvp_count) FROM meetupRsvp")
            assert not resp.exceptions
            n = int(resp.aggregation_results[0].value)
            assert float(resp.aggregation_results[1].value) == float(prefix[n]), n
            seen.append(n)
            if n >= 450 and not produced:
                for r in rows[500:]:
                    stream.produce(r)
                produced = True
            if n == 1000:
                break
            time.sleep(0.01)
        assert seen[-1] == 1000 and seen == sorted(seen), seen
        ideal = cluster.controller.resources.get_ideal_state(physical)
        assert [ideal[llc.make_segment_name(physical, 0, s)] for s in range(3)] == [
            {"server0": "ONLINE"}, {"server0": "ONLINE"}, {"server0": "CONSUMING"}]
        assert pool.snapshot()["errors"] == 0
    finally:
        pool.stop()
        cluster.stop()
    assert not leaked_pool_threads()
