"""The port's link fault plane against the JAX package's, exactly: the same
seed and the same program of ``cut``, ``partition``, ``set_link`` and
``heal`` give the same ``LinkEvent`` sequence, the same raised errors and
the same ``netfaults.*`` counts from both ``NetworkFaultInjector``s; the
same holds for ``FaultInjectingTransport`` over each package's
``LocalTransport``.  Then the injector's unit semantics on both packages
and the controller-edge attribution case of the reference's partition
tests on the port's gateway."""
import importlib
import random

import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")
NODES = ("brk0", "srv0", "srv1", "srv2", "controller")


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def link_program(seed: int, n: int = 400) -> list:
    """A seeded program of link faults and calls over NODES: flaky links
    (so the injector's RNG is drawn), duplicates, tiny delays, one- and
    two-way cuts, and heals of one link, one node or everything."""
    rng = random.Random(seed)
    prog = []
    for _ in range(n):
        a, b = rng.sample(NODES, 2)
        r = rng.random()
        if r < 0.08:
            prog.append(("cut", a, b))
        elif r < 0.12:
            prog.append(("partition", a, b))
        elif r < 0.22:
            prog.append(("set_link", a, b, {"error_rate": rng.choice((0.0, 0.25, 0.5, 0.9)),
                                            "duplicate": rng.random() < 0.3,
                                            "delay_s": rng.choice((0.0, 0.0, 0.0005))}))
        elif r < 0.25:
            prog.append(("heal", a, b))
        elif r < 0.27:
            prog.append(("heal", a))
        elif r < 0.28:
            prog.append(("heal",))
        else:
            prog.append(("call", a, b))
    return prog


def run_link_program(pkg: str, seed: int, prog: list) -> dict:
    faults = M(pkg, "common.faults")
    metrics = M(pkg, "utils.metrics").ServerMetrics("caller")
    inj = faults.NetworkFaultInjector(seed=seed)
    delivered = {"n": 0}

    def fn():
        delivered["n"] += 1
        return delivered["n"]

    outcomes = []
    for op in prog:
        if op[0] == "call":
            try:
                outcomes.append(("reply", inj.call(op[1], op[2], fn, metrics=metrics)))
            except faults.PartitionedLinkError as e:
                outcomes.append(("raised", type(e).__name__, str(e), isinstance(e, M(pkg, "transport.tcp").TransportError)))
        elif op[0] == "set_link":
            inj.set_link(op[1], op[2], **op[3])
        else:
            getattr(inj, op[0])(*op[1:])
    events = [(e.src, e.dst, e.outcome) for e in inj.events]
    meters = {k: v["count"] for k, v in metrics.snapshot()["meters"].items() if k.startswith("netfaults.")}
    return {"outcomes": outcomes, "events": events, "meters": meters, "delivered": delivered["n"],
            "cuts": sorted(inj._cuts)}


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_network_injector_matches_reference(seed):
    prog = link_program(seed)
    ref = run_link_program("pinot_tpu", seed, prog)
    port = run_link_program("pinot_tpu_torch", seed, prog)
    assert port == ref
    # the program exercised every outcome the injector has
    kinds = {e[2] for e in ref["events"]}
    assert kinds == {"ok", "dropped", "replyDropped", "delayed", "duplicated", "flaky"}, kinds
    assert all(o[3] for o in ref["outcomes"] if o[0] == "raised")


def test_network_injector_event_ring_is_4096():
    for pkg in PKGS:
        inj = M(pkg, "common.faults").NetworkFaultInjector()
        for _ in range(5000):
            inj.call("a", "b", lambda: None)
        assert len(inj.events) == 4096, pkg


def transport_program(seed: int, n: int = 300) -> list:
    rng = random.Random(seed)
    addrs = [("s0", 0), ("s1", 0), ("bad", 0)]
    prog = []
    for _ in range(n):
        a = rng.choice(addrs)
        r = rng.random()
        if r < 0.1:
            mode = rng.choice(("down", "fail_next", "error_rate", "delay_s", "blackhole"))
            kw = {"down": {"down": True}, "fail_next": {"fail_next": rng.randint(1, 3)},
                  "error_rate": {"error_rate": rng.choice((0.3, 0.6))}, "delay_s": {"delay_s": 0.0005},
                  "blackhole": {"blackhole": True}}[mode]
            prog.append(("set_fault", a, kw))
        elif r < 0.15:
            prog.append(("clear_fault", a))
        elif r < 0.16:
            prog.append(("clear_all",))
        else:
            prog.append(("request", a))
    return prog


def run_transport_program(pkg: str, seed: int, prog: list) -> dict:
    faults = M(pkg, "common.faults")
    TransportError = M(pkg, "transport.tcp").TransportError
    inner = M(pkg, "transport.local").LocalTransport()
    inner.register(("s0", 0), lambda payload: b"pong:" + payload)
    inner.register(("s1", 0), lambda payload: b"pong1")
    inner.register(("bad", 0), lambda payload: b"ERR:handler failed")
    t = faults.FaultInjectingTransport(inner, seed=seed)
    outcomes = []
    for op in prog:
        if op[0] == "request":
            try:
                outcomes.append(("reply", t.request(op[1], b"ping", timeout=0.001)))
            except TransportError as e:
                outcomes.append(("raised", type(e).__name__, str(e)))
        elif op[0] == "set_fault":
            t.set_fault(op[1], **op[2])
        else:
            getattr(t, op[0])(*op[1:])
    return {"outcomes": outcomes, "calls": [(c.address, c.outcome) for c in t.calls],
            "s0": [(c.address, c.outcome) for c in t.calls_to(("s0", 0))]}


@pytest.mark.parametrize("seed", [0, 13])
def test_fault_injecting_transport_matches_reference(seed):
    prog = transport_program(seed)
    ref = run_transport_program("pinot_tpu", seed, prog)
    port = run_transport_program("pinot_tpu_torch", seed, prog)
    assert port == ref
    kinds = {c[1] for c in ref["calls"]}
    assert kinds == {"ok", "down", "fail_next", "error_rate", "blackhole", "error"}, kinds


@pytest.mark.parametrize("pkg", PKGS)
def test_injector_cut_drops_request_before_delivery(pkg):
    faults = M(pkg, "common.faults")
    inj = faults.NetworkFaultInjector()
    calls = []
    inj.cut("a", "b")
    with pytest.raises(faults.PartitionedLinkError):
        inj.call("a", "b", lambda: calls.append(1))
    assert calls == []  # never delivered
    # the reverse RPC delivers (its request rides b->a, which is open) but
    # its reply rides the cut a->b direction
    delivered = []
    with pytest.raises(faults.PartitionedLinkError):
        inj.call("b", "a", lambda: delivered.append(1))
    assert delivered == [1]
    inj.heal("a", "b")
    assert inj.call("a", "b", lambda: "ok") == "ok"
    assert inj.call("b", "a", lambda: "ok") == "ok"


@pytest.mark.parametrize("pkg", PKGS)
def test_injector_one_way_cut_delivers_then_loses_reply(pkg):
    faults = M(pkg, "common.faults")
    inj = faults.NetworkFaultInjector()
    inj.cut("b", "a")  # replies b->a lost
    delivered = []
    with pytest.raises(faults.PartitionedLinkError):
        inj.call("a", "b", lambda: delivered.append(1))
    assert delivered == [1]  # the side effects happened
    assert [e.outcome for e in inj.events_for("a", "b")] == ["replyDropped"]


@pytest.mark.parametrize("pkg", PKGS)
def test_injector_duplicate_flaky_and_partition(pkg):
    faults = M(pkg, "common.faults")
    inj = faults.NetworkFaultInjector(seed=7)
    inj.set_link("a", "b", duplicate=True)
    n = [0]

    def fn():
        n[0] += 1
        return n[0]

    assert inj.call("a", "b", fn) == 2  # delivered twice, the second reply
    assert n[0] == 2
    inj.heal()
    inj.set_link("a", "b", error_rate=1.0)
    with pytest.raises(faults.PartitionedLinkError):
        inj.call("a", "b", lambda: "ok")
    inj.heal()
    inj.partition("a", "b")
    for src, dst in (("a", "b"), ("b", "a")):
        with pytest.raises(faults.PartitionedLinkError):
            inj.call(src, dst, lambda: "ok")
    inj.heal("a")  # everything touching a
    assert inj.call("a", "b", lambda: "ok") == "ok"
    assert faults.call_on_controller_link(None, "a", lambda: "plain") == "plain"


@pytest.mark.parametrize("pkg", PKGS)
def test_link_fault_transport_over_local_transport(pkg):
    faults = M(pkg, "common.faults")
    transport = M(pkg, "transport.local").LocalTransport()
    transport.register(("s0", 0), lambda payload: b"pong")
    inj = faults.NetworkFaultInjector()
    linked = faults.LinkFaultTransport(transport, inj, src="brk")
    assert linked.request(("s0", 0), b"ping") == b"pong"
    inj.cut("brk", "s0")
    with pytest.raises(M(pkg, "transport.tcp").TransportError):
        linked.request(("s0", 0), b"ping")
    assert [e.outcome for e in inj.events_for("brk", "s0")] == ["ok", "dropped"]


@pytest.mark.parametrize("pkg", PKGS)
def test_gateway_edge_injection_and_netfaults_attribution(pkg):
    """The controller-edge hook (for harnesses that cannot wire the client
    processes): a cut server->controller link drops heartbeats at the
    gateway, and the fault lands on the consulted role's netfaults.*."""
    faults = M(pkg, "common.faults")
    metrics = M(pkg, "utils.metrics").ControllerMetrics("controller")
    gw = M(pkg, "controller.network").ParticipantGateway(
        M(pkg, "controller.resource_manager").ClusterResourceManager(), metrics=metrics, epoch=1,
        fault_injector=(inj := faults.NetworkFaultInjector()))
    assert gw.register({"name": "s1", "role": "server"})["status"] == "ok"
    inj.cut("s1", faults.CONTROLLER_LINK)
    with pytest.raises(faults.PartitionedLinkError):
        gw.heartbeat("s1")
    with pytest.raises(faults.PartitionedLinkError):
        gw.messages("s1")
    assert metrics.meter("netfaults.dropped").count == 2
    inj.heal()
    inj.cut(faults.CONTROLLER_LINK, "s1")  # the reply path: the call runs, its reply is lost
    with pytest.raises(faults.PartitionedLinkError):
        gw.ack("s1", {"msgId": None, "table": "t_OFFLINE", "segment": "x", "state": "ONLINE"})
    assert metrics.meter("netfaults.replyDropped").count == 1
    inj.heal()
    assert gw.heartbeat("s1")["status"] == "ok"
    assert gw.messages("s1") == []


def test_networked_roles_take_the_injector(tmp_path):
    """The port's controller passes its injector to the gateway, and the
    networked broker wraps its scatter transport in a LinkFaultTransport
    that marks netfaults.* on the broker's registry and resolves a
    server's TCP address to its instance name."""
    from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
    from pinot_tpu_torch.common.faults import LinkFaultTransport, NetworkFaultInjector, PartitionedLinkError
    from pinot_tpu_torch.controller.controller import Controller

    inj = NetworkFaultInjector()
    ctrl = Controller(str(tmp_path), fault_injector=inj)
    try:
        assert ctrl.gateway.fault_injector is inj
    finally:
        ctrl.stop()
    starter = NetworkedBrokerStarter("http://127.0.0.1:9", name="brkX", fault_injector=inj)
    try:
        transport = starter.handler.transport
        assert isinstance(transport, LinkFaultTransport) and transport.metrics is starter.handler.metrics
        starter.handler.set_server_address("srv7", ("127.0.0.1", 4242))
        assert starter._server_of_address(("127.0.0.1", 4242)) == "srv7"
        assert starter._server_of_address(("127.0.0.1", 1)) == "127.0.0.1:1"
        inj.cut("brkX", "controller")
        with pytest.raises(PartitionedLinkError):  # before any socket opens
            starter._get("/clusterstate")
        assert starter.handler.metrics.meter("netfaults.dropped").count == 1
    finally:
        starter.handler.shutdown()
