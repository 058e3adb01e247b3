"""Disaster recovery's tool in the port against the JAX package's: an
archive written by either package restores in the other, record for
record; both refuse a non-empty target and a traversal archive and report
a damaged deep store the same way; and the disaster-recovery scenario's
twin on the port's in-process cluster (backup under load, a corrupt store
copy scrubbed, the property store destroyed and restored)."""
import importlib
import os
import shutil
import tarfile

import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")
RECORDS = (("schemas", "s"), ("tables", "t_OFFLINE"), ("idealstates", "t_OFFLINE"),
           ("segments/t_OFFLINE", "seg0"), ("drain", "server2"))

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _populated_data_dir(pkg: str, root: str):
    """A controller data dir written by ``pkg``: a claimed epoch, a few
    journaled records, and one segment in the deep store."""
    data_dir = os.path.join(root, "cluster")
    ps = M(pkg, "controller.property_store").PropertyStore(os.path.join(data_dir, "property_store"))
    ps.claim_epoch()
    ps.put("schemas", "s", {"dims": ["a"]})
    ps.put("tables", "t_OFFLINE", {"replication": 2})
    ps.put("idealstates", "t_OFFLINE", {"seg0": {"server0": "ONLINE"}})
    ps.put("segments/t_OFFLINE", "seg0", {"crc": 123})
    ps.put("drain", "server2", {"draining": True})
    ps.snapshot_now()
    ps.put("tables", "t2_OFFLINE", {"replication": 1})  # a journaled op past the snapshot
    store = M(pkg, "controller.store").SegmentStore(os.path.join(data_dir, "segments"))
    seg = M(pkg, "tools.datagen").synthetic_lineitem_segment(200, seed=7, name="seg0")
    M(pkg, "segment.format").write_segment(seg, store.segment_dir("t_OFFLINE", "seg0"))
    return data_dir, ps, store


@pytest.mark.parametrize("writer,reader", [("pinot_tpu", "pinot_tpu_torch"), ("pinot_tpu_torch", "pinot_tpu")])
def test_archive_restores_in_the_other_package(tmp_path, writer, reader):
    data_dir, ps, _ = _populated_data_dir(writer, str(tmp_path))
    archive = str(tmp_path / "b.tar.gz")
    info = M(writer, "tools.backup").create_backup(data_dir, archive)
    assert info["segments"] == 1 and info["epoch"] == 1 and info["snapshotSeq"] > 0
    assert info["journalBytes"] > 0 and info["archiveBytes"] == os.path.getsize(archive)
    # restore into a second data dir that holds only the deep store
    data_dir2 = str(tmp_path / "cluster2")
    shutil.copytree(os.path.join(data_dir, "segments"), os.path.join(data_dir2, "segments"))
    out = M(reader, "tools.backup").restore_backup(archive, data_dir2)
    assert out["restored"] and out["segmentsVerified"] == 1
    assert out["segmentsMissing"] == [] and out["segmentsCorrupt"] == []
    assert (out["epoch"], out["snapshotSeq"], out["journalBytes"]) == (
        info["epoch"], info["snapshotSeq"], info["journalBytes"])
    ps2 = M(reader, "controller.property_store").PropertyStore(os.path.join(data_dir2, "property_store"))
    try:
        for ns, key in RECORDS + (("tables", "t2_OFFLINE"),):
            assert ps2.get(ns, key) == ps.get(ns, key) is not None, (ns, key)
        for ns in ("schemas", "tables", "idealstates", "segments/t_OFFLINE", "drain"):
            assert sorted(ps2.list_keys(ns)) == sorted(ps.list_keys(ns)), ns
        assert ps2.stored_epoch() == 1  # the fencing token restored
        # a controller over the restored store claims the next epoch
        assert ps2.claim_epoch() == 2
    finally:
        ps.close()
        ps2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_restore_refuses_nonempty_and_reports_damage(tmp_path, pkg):
    backup = M(pkg, "tools.backup")
    data_dir, ps, store = _populated_data_dir("pinot_tpu_torch", str(tmp_path))
    archive = str(tmp_path / "b.tar.gz")
    backup.create_backup(data_dir, archive)
    ps.close()
    with pytest.raises(FileExistsError):
        backup.restore_backup(archive, data_dir)  # a live store, no overwrite
    # a damaged deep store is reported (the scrubber heals it), never fatal
    seg_path = store.segment_file_path("t_OFFLINE", "seg0")
    with open(seg_path, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\x00" * 8)
    assert backup.restore_backup(archive, data_dir, overwrite=True)["segmentsCorrupt"] == ["t_OFFLINE/seg0"]
    os.unlink(seg_path)
    assert backup.restore_backup(archive, data_dir, overwrite=True)["segmentsMissing"] == ["t_OFFLINE/seg0"]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("member", ["../../escape", "/abs/escape", "link"])
def test_restore_rejects_unsafe_archive(tmp_path, pkg, member):
    evil = str(tmp_path / "evil.tar.gz")
    payload = tmp_path / "x"
    payload.write_text("boom")
    with tarfile.open(evil, "w:gz") as tar:
        if member == "link":
            info = tarfile.TarInfo("metadata/link")
            info.type = tarfile.SYMTYPE
            info.linkname = "/etc/passwd"
            tar.addfile(info)
        else:
            info = tar.gettarinfo(str(payload), arcname="x")
            info.name = member
            with open(payload, "rb") as f:
                tar.addfile(info, f)
    with pytest.raises(ValueError, match="unsafe archive member"):
        M(pkg, "tools.backup").restore_backup(evil, str(tmp_path / "out"))
    assert not (tmp_path / "out" / "property_store").exists()


def test_store_manifest_matches_reference(tmp_path):
    """The backup's segment manifest: the same sizes and byte-level CRCs
    from both packages' SegmentStore over the same deep store."""
    data_dir, ps, _ = _populated_data_dir("pinot_tpu", str(tmp_path))
    ps.close()
    segs = os.path.join(data_dir, "segments")
    ref = M("pinot_tpu", "controller.store").SegmentStore(segs).manifest()
    port = M("pinot_tpu_torch", "controller.store").SegmentStore(segs).manifest()
    assert port == ref and ref["t_OFFLINE"]["seg0"]["crc32"] != 0


def test_backup_cli(tmp_path, capsys):
    import json

    from pinot_tpu_torch.tools.backup import main

    data_dir, ps, _ = _populated_data_dir("pinot_tpu_torch", str(tmp_path))
    ps.close()
    archive = str(tmp_path / "cli.tar.gz")
    assert main(["backup", "--data-dir", data_dir, "--out", archive]) == 0
    assert json.loads(capsys.readouterr().out)["segments"] == 1
    assert main(["restore", "--archive", archive, "--data-dir", data_dir, "--overwrite"]) == 0
    assert json.loads(capsys.readouterr().out)["segmentsVerified"] == 1


@pytest.mark.chaos
def test_disaster_recovery_scenario_twin(tmp_path):
    """The port's twin of the reference's disaster-recovery scenario test:
    zero failed queries throughout, byte-identical answers after the
    restore, the drain flag and the epoch fence preserved, the committed
    realtime rows exactly once and consumption resumed, and the corrupt
    store copy detected and repaired from a live server."""
    from pinot_tpu_torch.tools.cluster_harness import run_disaster_recovery_scenario

    res = run_disaster_recovery_scenario(window_s=0.3, data_dir=str(tmp_path), device="cpu")
    assert res["failedQueries"] == 0, res
    assert res["restore"]["byteIdentical"]
    assert res["restore"]["drainFlagPreserved"]
    assert res["restore"]["fencingPreserved"]
    assert res["restore"]["rtCommittedPreserved"] and res["restore"]["rtResumed"]
    assert res["scrub"]["detected"] and res["scrub"]["repaired"]
    assert res["restore"]["restoreToFirstQuerySeconds"] < 30.0
    assert res["load"]["failedQueries"] == 0 and res["load"]["okQueries"] > 0
