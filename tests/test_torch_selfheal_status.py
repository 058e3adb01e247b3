"""The status surface's self-healing and ingest blocks in the port against
the JAX package's, for the same corrupt segment copies.

The port once counted ``crcFailures`` and ``quarantinedSegments`` on its
meters but left both out of ``ServerInstance.status()["selfHealing"]``,
and its ``IngestBackpressure.snapshot()`` had no ``residencyPressure``: the
reference's self-healing tests failed on the port with
``KeyError: 'crcFailures'``.  Here one segment file, written and then
corrupted, is loaded through a port server and a reference server, and
their blocks are compared key for key and value for value.  The port's
block has two keys more, both about the CUDA-only sticky fault class
(``deviceOff``, ``stickyFaults``)."""
import importlib
import os
import shutil

import pytest

TABLE = "healTable"
PORT_ONLY_KEYS = {"deviceOff", "stickyFaults"}


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _corrupt_segment_file(path):
    """Flip bytes in the buffer region (past the JSON header): the file
    still parses, but its column data no longer matches its CRC."""
    with open(path, "r+b") as f:
        data = f.read()
        hlen = int.from_bytes(data[8:16], "little")
        pos = 16 + hlen + max(0, (len(data) - 16 - hlen) // 2)
        f.seek(pos)
        f.write(bytes((~b) & 0xFF for b in data[pos: pos + 8]))


def _server(pkg: str, name: str):
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    return M(pkg, "server.instance").ServerInstance(name, pipeline=False, **kw)


@pytest.fixture
def segment_files(tmp_path):
    """Two copies of one segment file, written by the reference: a clean
    one and one whose column data is corrupted; and the clean copy's
    metadata as each package reads it (the CRC the controller registers)."""
    from pinot_tpu.segment.builder import build_segment
    from pinot_tpu.segment.format import SEGMENT_FILE_NAME, write_segment
    from pinot_tpu.tools.datagen import make_test_schema, random_rows
    from pinot_tpu_torch.segment.format import read_segment

    schema = make_test_schema(with_mv=False)
    seg = build_segment(schema, random_rows(schema, 200, seed=8), TABLE, "s0")
    clean = str(tmp_path / "clean" / "s0")
    write_segment(seg, clean)
    bad = str(tmp_path / "bad" / "s0")
    shutil.copytree(clean, bad)
    _corrupt_segment_file(os.path.join(bad, SEGMENT_FILE_NAME))
    port_meta = read_segment(os.path.join(clean, SEGMENT_FILE_NAME)).metadata
    assert port_meta.crc == seg.metadata.crc
    return clean, bad, {"pinot_tpu": seg.metadata, "pinot_tpu_torch": port_meta}


def _heal_after(pkg: str, tmp_path, metadata: dict, steps) -> dict:
    """The server's selfHealing and ingest blocks after ``steps``: (store
    dir, data dir, rot the local copy first) loads of s0 in turn."""
    fmt = M(pkg, "segment.format")
    server = _server(pkg, f"heal-{pkg}")
    try:
        results = []
        for store, data_dir, rot_local in steps:
            d = str(tmp_path / pkg / data_dir)
            if rot_local:
                _corrupt_segment_file(os.path.join(d, TABLE, "s0", fmt.SEGMENT_FILE_NAME))
            starter = M(pkg, "server.starter").ServerStarter(
                server, M(pkg, "controller.resource_manager").ClusterResourceManager(), data_dir=d)
            results.append(starter._load(TABLE, "s0", {"metadata": metadata[pkg], "downloadUri": "file://" + store}))
        tdm = server.data_manager.table(TABLE)
        served = tdm is not None and "s0" in tdm.segment_names()
        return {"results": results, "served": served, "heal": dict(server.status()["selfHealing"]),
                "ingest": server.status()["ingest"]}
    finally:
        server.shutdown()


def _compare(ref: dict, port: dict) -> None:
    assert port["results"] == ref["results"] and port["served"] == ref["served"]
    assert set(port["heal"]) == set(ref["heal"]) | PORT_ONLY_KEYS
    assert {k: port["heal"][k] for k in ref["heal"]} == ref["heal"]


def test_corrupt_source_copy_same_self_healing_block(tmp_path, segment_files):
    """The controller's copy itself is corrupt: one CRC failure, nothing
    quarantined (the verified fetch never landed a copy), nothing served."""
    clean, bad, metadata = segment_files
    steps = [(bad, "sd", False)]
    ref = _heal_after("pinot_tpu", tmp_path, metadata, steps)
    port = _heal_after("pinot_tpu_torch", tmp_path, metadata, steps)
    _compare(ref, port)
    assert port["results"] == [False] and not port["served"]
    assert port["heal"]["crcFailures"] >= 1 and port["heal"]["quarantinedSegments"] == 0


def test_corrupt_local_copy_same_self_healing_block(tmp_path, segment_files):
    """A local copy that rots on disk: the reload quarantines it and
    fetches the clean copy again; both packages count the same."""
    clean, bad, metadata = segment_files
    steps = [(clean, "sd", False), (clean, "sd", True)]
    ref = _heal_after("pinot_tpu", tmp_path, metadata, steps)
    port = _heal_after("pinot_tpu_torch", tmp_path, metadata, steps)
    _compare(ref, port)
    assert port["results"] == [True, True] and port["served"]
    assert port["heal"]["crcFailures"] >= 1 and port["heal"]["quarantinedSegments"] >= 1


def test_ingest_snapshot_keys_match_reference(tmp_path, segment_files):
    clean, bad, metadata = segment_files
    steps = [(clean, "sd", False)]
    ref = _heal_after("pinot_tpu", tmp_path, metadata, steps)["ingest"]
    port = _heal_after("pinot_tpu_torch", tmp_path, metadata, steps)["ingest"]
    assert set(port) == set(ref)
    assert set(port["watermarks"]) == set(ref["watermarks"])
    assert port["residencyPressure"] == ref["residencyPressure"] == 0.0


def test_residency_pressure_rounded_from_the_manager():
    from pinot_tpu_torch.realtime.backpressure import IngestBackpressure

    class _Residency:
        hbm_cap_bytes = 3

        @staticmethod
        def pressure():
            return 2 / 3

    assert IngestBackpressure().snapshot()["residencyPressure"] == 0.0
    assert IngestBackpressure(residency=_Residency()).snapshot()["residencyPressure"] == 0.6667


def test_dashboard_metrics_page_shows_the_crc_keys():
    """The controller's metrics page renders a server's selfHealing block,
    now with the two CRC keys."""
    from pinot_tpu_torch.controller.dashboard import render_metrics

    server = _server("pinot_tpu_torch", "dash")
    try:
        server.record_crc_failure(TABLE, "s0")
        page = render_metrics(None, {"instances": {"dash": {"role": "server", "metrics": server.status()}}})
    finally:
        server.shutdown()
    assert "<td>crcFailures</td><td>1</td>" in page and "<td>quarantinedSegments</td><td>0</td>" in page
