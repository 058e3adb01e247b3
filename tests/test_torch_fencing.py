"""The serving lease in the port against the JAX package, on one injected
clock: the expiry meter, the lease duration the gateway grants under
``PINOT_TPU_LEASE_S``, and the server's ``status()["lease"]`` block with
the lease and controller-reachability meters it registers; and the
networked broker's hold of a cluster-state snapshot that lists no live
server.

Before these were repaired the port's lease ignored ``PINOT_TPU_LEASE_S``
(a fixed 10 s), never counted ``lease.expiries``, and its server instance
had no lease, no ``"lease"`` status block and none of the ``lease.*`` /
``controller.*`` names registered until something marked them; its broker
held an all-dead snapshot without counting it
(``controller.allDeadSnapshotsHeld``).
"""
import contextlib
import importlib
import signal

import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")
LEASE_NAMES = ("lease.held", "lease.renewals", "lease.expiries", "lease.blockedCommits",
               "lease.blockedTransitions", "controller.unreachable", "controller.heartbeatFailures")


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the test with TimeoutError past ``seconds`` (its own limit)."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _expiry_sequence(pkg: str) -> list:
    """The reference's ``test_lease_metrics_and_snapshot`` steps, recorded."""
    clock = [0.0]
    metrics = M(pkg, "utils.metrics").ServerMetrics("srvX")
    lease = M(pkg, "common.fencing").ServingLease(clock=lambda: clock[0], metrics=metrics)
    seen = [metrics.gauge("lease.held").value]
    lease.renew({"epoch": 1, "durationS": 1.0})
    seen.append(metrics.meter("lease.renewals").count)
    clock[0] = 2.0
    for _ in range(3):  # polled three times, expired once
        seen.append((lease.held(), metrics.meter("lease.expiries").count))
    seen.append(lease.snapshot())
    lease.renew({"epoch": 2, "durationS": 1.0})  # renewed, then expired again
    seen.append((lease.held(), metrics.meter("lease.renewals").count))
    clock[0] = 5.0
    seen.append((lease.held(), lease.held(), metrics.meter("lease.expiries").count))
    seen.append(metrics.gauge("lease.held").value)
    return seen


def test_expiry_metered_once_as_in_reference():
    with time_limit(30):
        ref, port = [_expiry_sequence(pkg) for pkg in PKGS]
    assert ref[2:5] == [(False, 1)] * 3  # once, not once per poll
    assert ref[7] == (False, False, 2)
    assert port == ref


def _granted_durations(pkg: str) -> list:
    res = M(pkg, "controller.resource_manager").ClusterResourceManager()
    clock = [50.0]
    gw = M(pkg, "controller.network").ParticipantGateway(res, epoch=7, clock=lambda: clock[0])
    try:
        reg = gw.register({"name": "s1", "role": "server"})
        clock[0] = 51.0
        hb = gw.heartbeat("s1")
        return [M(pkg, "common.fencing").default_lease_s(), reg["lease"], hb["lease"],
                res.instances["s1"].lease_until]
    finally:
        gw.stop()


def test_lease_duration_reads_env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_LEASE_S", "3")
    with time_limit(30):
        ref, port = [_granted_durations(pkg) for pkg in PKGS]
    assert ref[1]["durationS"] == 3.0 and ref[3] == pytest.approx(54.0)
    assert port == ref
    monkeypatch.delenv("PINOT_TPU_LEASE_S")
    assert [M(pkg, "common.fencing").default_lease_s() for pkg in PKGS] == [10.0, 10.0]


def _status_lease(pkg: str) -> dict:
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    server = M(pkg, "server.instance").ServerInstance("s_lease", **kw)
    try:
        snap = server.metrics.snapshot()
        registered = sorted(n for n in LEASE_NAMES if any(n in group for group in snap.values()
                                                           if isinstance(group, dict)))
        before = server.status()["lease"]
        clock = [0.0]
        server.lease._clock = lambda: clock[0]
        server.lease.renew({"epoch": 3, "durationS": 2.0})
        clock[0] = 1.0
        held = server.status()["lease"]
        clock[0] = 4.0
        expired = server.status()["lease"]
        return {"registered": registered, "before": before, "held": held, "expired": expired,
                "expiries": server.metrics.meter("lease.expiries").count,
                "catalog": sorted(n for n in LEASE_NAMES if n in M(pkg, "utils.metrics").SERVER_METRIC_CATALOG)}
    finally:
        server.shutdown()


def test_server_status_lease_block_and_names():
    with time_limit(60):
        ref, port = [_status_lease(pkg) for pkg in PKGS]
    assert ref["registered"] == sorted(LEASE_NAMES)
    assert ref["before"] == {"granted": False, "held": True, "epoch": -1, "remainingS": None}
    assert ref["expired"]["held"] is False and ref["expiries"] == 1
    assert port == ref


def _all_dead_snapshot(pkg: str) -> list:
    """The reference's ``test_broker_holds_routing_on_all_dead_snapshot``
    steps, recorded."""
    starter = M(pkg, "broker.network_starter").NetworkedBrokerStarter("http://127.0.0.1:9")  # never polled
    h = starter.handler
    base = {"epoch": "1", "drainingServers": [], "quotas": {}, "timeBoundaries": {}}
    seen = [h.metrics.meter("controller.allDeadSnapshotsHeld").count]
    for version, servers, dead, replicas in ((5, {"s0": ["127.0.0.1", 1234]}, [], {"s0": "ONLINE"}),
                                             (6, {}, ["s0"], {}), (6, {}, ["s0"], {}),
                                             (7, {"s0": ["127.0.0.1", 1234]}, [], {"s0": "ONLINE"})):
        starter._apply_state(dict(base, version=version, servers=servers, deadServers=dead,
                                  tables={"t_OFFLINE": {"seg0": replicas}}))
        seen.append((starter._version, "t_OFFLINE" in h.routing.tables(),
                     h.metrics.meter("controller.allDeadSnapshotsHeld").count))
    seen.append(sorted(n for n in ("controller.unreachable", "controller.pollFailures",
                                   "controller.allDeadSnapshotsHeld")
                       if n in M(pkg, "utils.metrics").BROKER_METRIC_CATALOG))
    return seen


def test_broker_counts_held_all_dead_snapshots():
    """A snapshot that lists no live server is held, not applied, and the
    broker counts it (``controller.allDeadSnapshotsHeld``, registered at
    zero); before the repair the port held it without counting."""
    with time_limit(30):
        ref, port = [_all_dead_snapshot(pkg) for pkg in PKGS]
    assert ref[0] == 0 and ref[2:4] == [(5, True, 1), (5, True, 2)] and ref[4] == (7, True, 2)
    assert port == ref
