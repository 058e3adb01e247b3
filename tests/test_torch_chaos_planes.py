"""The pieces the in-process chaos scenarios stand on, against the JAX
package's: the seeded ``DeviceFaultInjector`` (its ``error_rate`` and
``alloc_error_rate`` draws), and ``broker/starter.BrokerStarter`` (the view
listener that ``InProcessCluster`` now uses, whose instance listener feeds
the broker's health tracker)."""
import pytest
import torch

from pinot_tpu.common.faults import DeviceFaultInjector as RefInjector

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.starter import BrokerStarter
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.controller.resource_manager import ClusterResourceManager, InstanceState
from pinot_tpu_torch.engine.dispatch import DeviceExecutionError, classify_device_error
from pinot_tpu_torch.tools import cluster_harness
from pinot_tpu_torch.transport.local import LocalTransport


def _outcomes(inj, launches: int):
    for i in range(launches):
        try:
            inj.on_launch(f"d{i % 5}", None)
        except Exception:
            pass
    return [(r.digest, r.outcome) for r in inj.launches]


@pytest.mark.parametrize("seed", [0, 7, 1907])
def test_seeded_injector_draws_the_references_outcomes(seed):
    """At the same rates and seed, both injectors take the same decision at
    every one of 200 launches: the allocation draw first, then the error
    draw; one-shot faults armed on top shift no draw (nor does the port's
    ``sticky_fail_next``, which draws nothing)."""
    port, ref = DeviceFaultInjector(seed=seed), RefInjector(seed=seed)
    for inj in (port, ref):
        inj.error_rate, inj.alloc_error_rate = 0.2, 0.1
        inj.fail_next(3)
        inj.alloc_fail_next(2)
    got = _outcomes(port, 200)
    assert got == _outcomes(ref, 200)
    kinds = {o for _, o in got}
    assert {"alloc_fail", "fail_next", "alloc_rate", "error_rate", "ok"} <= kinds, kinds
    port.sticky_fail_next(1)
    ref_tail = _outcomes(ref, 50)[200:]
    assert [o for _, o in _outcomes(port, 50)[200:]] == ["sticky"] + [o for _, o in ref_tail[:49]]


def test_rate_faults_are_classified_and_healed():
    """A rate-driven allocation failure raises the raw out-of-memory error,
    classified ``resource_exhausted``; a rate-driven launch error is a
    retryable ``DeviceExecutionError``; ``heal()`` zeroes both rates."""
    inj = DeviceFaultInjector(seed=3)
    inj.alloc_error_rate = 1.0
    with pytest.raises(torch.cuda.OutOfMemoryError) as e:
        inj.on_launch("d", None)
    assert classify_device_error(e.value).resource_exhausted
    inj.alloc_error_rate, inj.error_rate = 0.0, 1.0
    with pytest.raises(DeviceExecutionError) as e:
        inj.on_launch("d", None)
    assert e.value.retryable
    inj.alloc_error_rate = 0.5
    inj.heal()
    assert (inj.error_rate, inj.alloc_error_rate) == (0.0, 0.0)
    inj.on_launch("d", None)
    assert [r.outcome for r in inj.launches] == ["alloc_rate", "error_rate", "ok"]


@pytest.mark.chaos
def test_controller_death_event_reaches_health_tracker():
    """A liveness flip (a missed heartbeat, a re-registration) reaches the
    broker's circuit breaker through the event that rebuilds its routing."""
    resources = ClusterResourceManager()
    broker = BrokerRequestHandler(LocalTransport(), {})
    BrokerStarter(broker, resources).start()
    resources.register_instance(InstanceState("sX", role="server"))
    resources.set_instance_alive("sX", False)
    assert broker.health.state_of("sX") == "OPEN"
    resources.set_instance_alive("sX", True)
    assert broker.health.state_of("sX") == "CLOSED"
    broker.shutdown()


def test_the_in_process_cluster_follows_views_through_the_broker_starter(tmp_path):
    """``InProcessCluster`` carries no view listener of its own: its broker
    is registered and routed by a ``BrokerStarter``, also after
    ``attach_controller``, and a quota set through the controller reaches
    the broker."""
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.datagen import make_test_schema, random_rows

    for name in ("_on_view_change", "_on_instance_change"):
        assert not hasattr(cluster_harness.InProcessCluster, name)
    cluster = cluster_harness.InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    try:
        assert isinstance(cluster.broker_starter, BrokerStarter)
        assert cluster.controller.resources.instances["broker0"].role == "broker"
        schema = make_test_schema(with_mv=False)
        physical = cluster.add_offline_table(schema, replication=1)
        cluster.upload(physical, build_segment(schema, random_rows(schema, 50, seed=3), physical, "s0"))
        assert cluster.query("SELECT count(*) FROM testTable").num_docs_scanned == 50
        cluster.controller.resources.update_table_quota(physical, 5.0)
        assert cluster.broker.quota.headroom("testTable") is not None
        old = cluster.broker_starter
        cluster.controller.stop()
        cluster.attach_controller(Controller(cluster.data_dir))
        assert cluster.broker_starter is not old and cluster.broker_starter.resources is cluster.controller.resources
        assert cluster.query("SELECT count(*) FROM testTable").num_docs_scanned == 50
    finally:
        cluster.stop()
