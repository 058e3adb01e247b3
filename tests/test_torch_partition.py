"""The port's network-partition scenarios on the CPU, each report held to
the invariants the JAX package's own partition tests hold its reports to
(``tests/test_partition.py``): the port's ``NetworkedCluster`` runs a
controller, servers and a broker over HTTP and TCP in one process, every
link through one seeded ``NetworkFaultInjector``, and the scenarios wait
on conditions with deadlines (``cluster.wait``), never on fixed sleeps."""
import pytest

from pinot_tpu_torch.tools.cluster_harness import (
    run_asymmetric_partition_scenario,
    run_partition_controller_scenario,
    run_partition_server_scenario,
)


@pytest.mark.chaos
def test_partition_server_acceptance(tmp_path):
    """A server cut from the controller past its lease: zero failed
    queries, its replicas held through the lease window and moved only
    after it, the victim fenced on its side, re-admitted on heal."""
    out = run_partition_server_scenario(data_dir=str(tmp_path), device="cpu")
    assert out["failedQueries"] == 0, out["failures"]
    assert out["heldThroughLeaseWindow"], out
    assert not out["movedOnFirstMissedHeartbeat"], out
    assert out["leaseDeferrals"] > 0, out
    assert out["victimSelfFenced"], out
    assert out["replicationRestored"], out
    assert out["noDuplicateReplicas"], out
    assert out["victimReadmitted"], out
    assert out["finalComplete"] and out["finalDocs"] == out["expectedDocs"]


@pytest.mark.chaos
def test_partition_controller_acceptance(tmp_path):
    """The controller cut from every role: the broker serves from its
    snapshot, no replica moves, the ideal state is the same after heal."""
    out = run_partition_controller_scenario(data_dir=str(tmp_path), device="cpu")
    assert out["failedQueries"] == 0, out["failures"]
    assert out["idealUnchangedDuringOutage"], out
    assert out["idealUnchangedAfterHeal"], out
    assert out["brokerServedFromSnapshot"], out
    assert out["finalComplete"] and out["finalDocs"] == out["expectedDocs"]


@pytest.mark.chaos
def test_asymmetric_partition_acceptance(tmp_path):
    """Replies to one realtime replica lost: it fences its commits while the
    controller still sees it alive; exactly one committed copy, the same
    bytes on both replicas, nothing lost or doubled."""
    out = run_asymmetric_partition_scenario(data_dir=str(tmp_path), device="cpu")
    assert out["failedQueries"] == 0, out
    assert out["victimSelfFenced"], out
    assert out["controllerSawVictimAlive"], out
    assert out["noReplicaMovement"], out
    assert out["committedByteIdentical"], out
    assert out["finalDocs"] == out["expectedDocs"], out


@pytest.mark.parametrize("chunks", [
    ['{"a": 1}\n{"a": 2}\n', '{"a": 3}\n'],
    ['{"a": 1}\n\n  \n{"a": 2}', '\n{"a": 3}\n\n', '{"a": 4}'],
    ['', '{"a": 1}\n' * 50, '{"a": 2}\n' * 7],
])
def test_file_stream_provider_matches_reference(tmp_path, chunks):
    """The asymmetric scenario's stream: the port's file provider indexes
    each partition's lines once and parses only what a fetch returns, and
    gives the reference's rows, offsets and latest offsets as the file
    grows (blank lines skipped, a last line without its newline read)."""
    from pinot_tpu.realtime.stream import FileBasedStreamProvider as RefProvider
    from pinot_tpu_torch.realtime.stream import FileBasedStreamProvider

    path = str(tmp_path / "p0.jsonl")
    open(path, "w").close()
    port, ref = FileBasedStreamProvider([path]), RefProvider([path])
    offsets = {"port": 0, "ref": 0}
    for chunk in chunks:
        with open(path, "a") as f:
            f.write(chunk)
        assert port.latest_offset(0) == ref.latest_offset(0)
        for max_rows in (1, 3, 100):
            got = port.fetch(0, offsets["port"], max_rows)
            assert got == ref.fetch(0, offsets["ref"], max_rows)
            offsets = {"port": got[1], "ref": got[1]}
        for offset in range(ref.latest_offset(0) + 2):
            assert port.fetch(0, offset, 4) == ref.fetch(0, offset, 4)


def test_mutable_row_path_matches_reference():
    """The file stream's rows reach the mutable segment's row path, which
    transposes complete rows in one pass and encodes a string column once
    a distinct value: the dictionaries and ids are the reference's (first
    appearance order), with rows that lack a field and a string column
    with a null among them taking the per-value path."""
    from pinot_tpu.realtime.mutable import MutableSegment as RefMutable
    from pinot_tpu.tools.datagen import make_test_schema as ref_schema, random_rows
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.realtime.mutable import MutableSegment

    rs = ref_schema(with_mv=False)
    port = MutableSegment(Schema.from_json(rs.to_json()), "t__0__0", "t_REALTIME")
    ref = RefMutable(rs, "t__0__0", "t_REALTIME")
    rows = random_rows(rs, 300, seed=3)
    partial = [{k: v for k, v in r.items() if k != "dimStr"} for r in rows[:20]]
    nulls = [dict(r, dimStr=None) for r in rows[20:25]]
    for batch in (rows[:100], partial, rows[100:200], nulls, rows[200:]):
        port.index_batch(batch)
        ref.index_batch(batch)
    assert port.num_docs == ref.num_docs == 325
    for name, col in ref._columns.items():
        assert port._columns[name].id_to_value == col.id_to_value, name
        assert port._columns[name].ids[:325].tolist() == col.ids[:325].tolist(), name
