"""The serving fleet in the port, held against the JAX package: the
time-series ring and the alert-rule schema the autoscaler judges with, the
consistent-hash ring and the poll stagger, the autoscaler's decisions, the
router's canary coherence through a rolling swap and its drain around a
dead replica, and a CPU DriverSession fleet that serves, scales up and
down and relaunches a killed replica.

What is compared across the packages (ring owners, stagger offsets,
autoscaler decisions, ring values, rule errors, status keys) is compared
exactly; predictions through the router are the in-process engine's bit
for bit.
"""

import contextlib
import dataclasses
import sys
import time

import cloudpickle
import numpy as np
import pytest

from metisfl_tpu.serving.fleet import FleetAutoscaler as JaxAutoscaler
from metisfl_tpu.serving.fleet import HashRing as JaxHashRing
from metisfl_tpu.serving.fleet import poll_stagger as jax_poll_stagger
from metisfl_tpu.telemetry.alerts import validate_rules as jax_validate
from metisfl_tpu.telemetry.timeseries import TimeSeriesRing as JaxRing
from metisfl_tpu.telemetry.timeseries import sparkline as jax_sparkline
from metisfl_tpu_torch import telemetry
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    PromotionConfig,
    RegistryConfig,
    ServingConfig,
    ServingFleetConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.models import TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP
from metisfl_tpu_torch.serving import (
    FleetAutoscaler,
    HashRing,
    RouterServer,
    ServingClient,
    ServingGateway,
    ServingRouter,
    ServingServer,
    canary_channel,
    poll_stagger,
)
from metisfl_tpu_torch.telemetry.alerts import validate_rules
from metisfl_tpu_torch.telemetry.timeseries import TimeSeriesRing, sparkline
from metisfl_tpu_torch.tensor.pytree import ModelBlob, pack_model, tree_map


@pytest.fixture
def clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


# ---------------------------------------------------------------------- #
# the time-series ring and the alert-rule schema
# ---------------------------------------------------------------------- #

def test_time_series_ring_and_sparkline_equal_the_jax_ones():
    rng = np.random.default_rng(3)
    rings = (TimeSeriesRing(capacity=16, max_series=3),
             JaxRing(capacity=16, max_series=3))
    # the same schedule into both
    schedule = [(100.0 + 0.7 * i, float(v)) for i, v in
                enumerate(np.cumsum(rng.integers(0, 9, 40)))]
    for ring in rings:
        for ts, value in schedule:
            ring.record("requests", value, ts=ts)
            ring.record("depth", value % 5, ts=ts)
        for name in ("a", "b", "c"):  # past max_series: dropped, counted
            ring.record(name, 1.0, ts=1.0)
    now = schedule[-1][0]
    port, jax_ring = rings
    assert port.names() == jax_ring.names()
    assert port.dropped_series == jax_ring.dropped_series == 2
    assert port.latest("requests") == jax_ring.latest("requests")
    for name in ("requests", "depth"):
        for window in (0.5, 3.0, 9.0, 100.0):
            assert (port.window(name, window, now=now)
                    == jax_ring.window(name, window, now=now))
            assert (port.rate(name, window, now=now)
                    == jax_ring.rate(name, window, now=now))
        assert port.points(name, 7) == jax_ring.points(name, 7)
        for width in (8, 24):
            assert (sparkline(port.points(name), width)
                    == jax_sparkline(jax_ring.points(name), width))
    assert port.snapshot(points=5) == jax_ring.snapshot(points=5)
    assert sparkline([]) == jax_sparkline([]) == ""
    assert sparkline([2.0] * 4) == jax_sparkline([2.0] * 4)


_RULES_OK = [
    [{"name": "a", "metric": "m", "threshold": 1}],
    [{"name": "b", "metric": "m", "kind": "rate", "window_s": 5, "op": "<=",
      "threshold": 0.5, "for_s": 2, "labels": {"channel": "stable"},
      "resolve_ratio": 0.8, "severity": "critical"},
     {"name": "c", "metric": "lat", "kind": "quantile", "quantile": 0.5,
      "threshold": "3"}],
]
_RULES_BAD = [
    ["not a mapping"],
    [{"name": "a", "metric": "m", "threshold": 1, "typo": 2}],
    [{"metric": "m", "threshold": 1}],
    [{"name": "a", "threshold": 1}],
    [{"name": "a", "metric": "m"}],
    [{"name": "a", "metric": "m", "threshold": "high"}],
    [{"name": "a", "metric": "m", "threshold": 1, "kind": "delta"}],
    [{"name": "a", "metric": "m", "threshold": 1, "op": "=="}],
    [{"name": "a", "metric": "m", "threshold": 1, "labels": [1]}],
    [{"name": "a", "metric": "m", "threshold": 1, "kind": "rate",
      "window_s": 0}],
    [{"name": "a", "metric": "m", "threshold": 1, "quantile": 1.5}],
    [{"name": "a", "metric": "m", "threshold": 1, "for_s": -1}],
    [{"name": "a", "metric": "m", "threshold": 1, "resolve_ratio": 0}],
    [{"name": "a", "metric": "m", "threshold": 1, "severity": "page"}],
    [{"name": "a", "metric": "m", "threshold": 1},
     {"name": "a", "metric": "n", "threshold": 2}],
]


@pytest.mark.parametrize("specs", _RULES_OK + _RULES_BAD,
                         ids=[f"ok{i}" for i in range(len(_RULES_OK))]
                         + [f"bad{i}" for i in range(len(_RULES_BAD))])
def test_validate_rules_accepts_and_refuses_as_the_jax_schema(specs):
    outcomes = []
    for validate in (validate_rules, jax_validate):
        try:
            rules = validate(specs)
        except ValueError as exc:
            outcomes.append(("error", str(exc)))
        else:
            outcomes.append(("ok", [
                (dataclasses.asdict(r), r.series_key(), r.describe_expr(),
                 [r.breaches(v) for v in (0.0, 0.5, 1.0, 3.0)],
                 [r.resolved(v) for v in (0.0, 0.5, 0.8, 1.0, 3.0)])
                for r in rules]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ok" if specs in _RULES_OK else "error")


# ---------------------------------------------------------------------- #
# the hash ring and the poll stagger
# ---------------------------------------------------------------------- #

def test_hash_ring_owners_equal_the_jax_ring_with_minimal_disruption():
    members = ("serving_0", "serving_1", "serving_2", "serving_3")
    keys = [f"user-{i}" for i in range(1000)]
    rings = (HashRing(vnodes=64), JaxHashRing(vnodes=64))
    for ring in rings:
        for name in members:
            ring.add(name)
    before = {k: rings[0].owners(k) for k in keys}
    assert before == {k: rings[1].owners(k) for k in keys}
    assert all(sorted(chain) == sorted(members) for chain in before.values())
    share = {m: sum(c[0] == m for c in before.values()) for m in members}
    assert min(share.values()) > 150, share
    for ring in rings:
        ring.remove("serving_2")
    after = {k: rings[0].owners(k) for k in keys}
    assert after == {k: rings[1].owners(k) for k in keys}
    for k in keys:
        if before[k][0] != "serving_2":
            assert after[k][0] == before[k][0]
        else:
            # the dead replica's keys fall to its next clockwise owner
            assert after[k][0] == before[k][1]
    assert rings[0].members() == rings[1].members()
    assert HashRing().owners("x") == JaxHashRing().owners("x") == []


def test_poll_stagger_equals_the_jax_schedule():
    for replicas in (0, 1, 2, 3, 8):
        for index in range(10):
            for period in (0.25, 1.0, 1.5):
                assert (poll_stagger(index, replicas, period)
                        == jax_poll_stagger(index, replicas, period))
    assert poll_stagger(1, 3, 1.5) == pytest.approx(0.5)
    assert len({poll_stagger(i, 8, 2.0) for i in range(8)}) == 8


# ---------------------------------------------------------------------- #
# the autoscaler
# ---------------------------------------------------------------------- #

_UP = {"metric": "serving_requests_total", "kind": "rate", "window_s": 5,
       "op": ">", "threshold": 10, "for_s": 2}
_DOWN = {"metric": "serving_requests_total", "kind": "rate", "window_s": 5,
         "op": "<", "threshold": 1, "for_s": 2}
_DEPTH = {"metric": "serving_queue_depth", "kind": "value", "op": ">=",
          "threshold": 4, "for_s": 0}


def _decisions(cls, up, down, schedule):
    clock = {"t": 100.0}
    scaler = cls(up, down, min_replicas=1, max_replicas=3, cooldown_s=10,
                 clock=lambda: clock["t"])
    total, replicas, out = 0.0, 1, []
    for dt, qps, depth in schedule:
        clock["t"] += dt
        total += qps * dt
        decision = scaler.observe({"serving_requests_total": total,
                                   "serving_queue_depth": depth},
                                  replicas=replicas)
        replicas += {"up": 1, "down": -1}.get(decision, 0)
        out.append((decision, replicas, dict(scaler.last_values)))
    return out, scaler.describe()


@pytest.mark.parametrize("rules", ["rate_up_down", "value_up"])
def test_autoscaler_decisions_equal_the_jax_autoscaler(rules):
    """One traffic schedule (surges, holds, the cooldown, the ceiling and
    the floor) under an injected clock: the same decision at every step."""
    up, down = (_UP, _DOWN) if rules == "rate_up_down" else (_DEPTH, None)
    schedule = ([(1.0, 0, 0)] + [(1.0, 50, 6)] * 8 + [(10.0, 50, 6)]
                + [(1.0, 50, 6)] * 8 + [(10.0, 0, 0)] + [(1.0, 0, 0)] * 8
                + [(10.0, 0, 0)] + [(1.0, 0, 0)] * 8 + [(0.5, 30, 5)] * 6)
    port, port_desc = _decisions(FleetAutoscaler, up, down, schedule)
    jax_out, jax_desc = _decisions(JaxAutoscaler, up, down, schedule)
    assert port == jax_out
    assert port_desc == jax_desc
    made = [d for d, _, _ in port if d]
    assert "up" in made
    assert max(r for _, r, _ in port) == 3  # the ceiling held
    if down is not None:
        assert "down" in made and min(r for _, r, _ in port) == 1


def test_autoscaler_refuses_quantile_rules_as_the_jax_one():
    spec = {"metric": "serving_request_latency_seconds", "kind": "quantile",
            "threshold": 1.0}
    errors = []
    for cls in (FleetAutoscaler, JaxAutoscaler):
        with pytest.raises(ValueError, match="quantile") as exc:
            cls(spec, None, 1, 2)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------- #
# the router over in-process gateways behind gRPC servers
# ---------------------------------------------------------------------- #

def _mlp_ops():
    return TorchModelOps(MLP(4, (8,), 3), rng_seed=0, device="cpu")


def _fleet_of(n, canary_percent=0.0, retry_hops=2):
    ops = _mlp_ops()
    cfg = ServingConfig(enabled=True, max_batch=4, max_wait_ms=1.0,
                        canary_percent=canary_percent,
                        fleet=ServingFleetConfig(
                            enabled=True, replicas=n,
                            max_replicas=max(4, n), probe_every_s=0.2,
                            retry_hops=retry_hops))
    blob = pack_model(ops.get_variables())
    gateways, servers = [], []
    for _ in range(n):
        gw = ServingGateway(ops, cfg, device="cpu")
        gw.install("stable", 1, blob)
        srv = ServingServer(gw, host="127.0.0.1", port=0)
        srv.start()
        gateways.append(gw)
        servers.append(srv)
    router = ServingRouter(cfg)
    for i, srv in enumerate(servers):
        router.add_replica(f"serving_{i}", "127.0.0.1", srv.port)
    rserver = RouterServer(router, host="127.0.0.1", port=0)
    rserver.start()
    return ops, cfg, gateways, servers, router, rserver


def _teardown(servers, rserver):
    rserver.stop()
    for srv in servers:
        srv.stop()


def _scaled(ops, factor):
    return pack_model(tree_map(
        lambda a: (np.asarray(a) * np.float32(factor)).astype(np.float32),
        ops.get_variables()))


def test_canary_stays_coherent_across_replicas_through_a_rolling_swap(
        clean_telemetry):
    """A key resolves to one channel whichever replica serves it, while a
    promotion walks the fleet one replica at a time; every reply is the
    in-process engine's bit for bit for the version it names."""
    ops, cfg, gateways, servers, router, rserver = _fleet_of(
        3, canary_percent=30.0)
    blob_c, blob_v2 = _scaled(ops, 3.0), _scaled(ops, 2.0)
    for gw in gateways:
        gw.install("candidate", 2, blob_c)
    x = np.random.default_rng(1).standard_normal((1, 4)).astype(np.float32)
    models = {v: ops.bind(ModelBlob.from_bytes(b).tensors) for v, b in (
        (1, pack_model(ops.get_variables())), (2, blob_c), (3, blob_v2))}
    want = {v: ops.infer(np.repeat(x, cfg.max_batch, 0), cfg.max_batch,
                         model=m)[:1] for v, m in models.items()}
    client = ServingClient("127.0.0.1", rserver.port)
    keys = [f"user{i}" for i in range(40)]
    expected = {k: canary_channel(k, 30.0) for k in keys}
    assert len(set(expected.values())) == 2
    seen = {k: set() for k in keys}
    try:
        def sweep():
            for k in keys:
                reply = client.predict(x, key=k, timeout=30.0)
                seen[k].add(reply.channel)
                np.testing.assert_array_equal(
                    client.predictions(reply), want[reply.model_version])

        sweep()
        for gw in gateways:  # the rolling swap of the stable channel
            gw.install("stable", 3, blob_v2)
            sweep()
    finally:
        client.close()
        _teardown(servers, rserver)
    for k in keys:
        assert seen[k] == {expected[k]}, (k, seen[k])


def test_router_drains_around_a_dead_replica_with_bounded_retry(
        clean_telemetry):
    from metisfl_tpu_torch.telemetry import events as _events

    ops, cfg, gateways, servers, router, rserver = _fleet_of(3)
    client = ServingClient("127.0.0.1", rserver.port)
    x = np.zeros((2, 4), np.float32)
    keys = [f"k{i}" for i in range(30)]
    try:
        for k in keys:
            client.predict(x, key=k, timeout=30.0)
        servers[1].stop()  # the replica's endpoint dies, cold
        for k in keys:  # every key still serves: a retry to the next owner
            client.predict(x, key=k, timeout=30.0)
        desc = router.describe()
        row = next(r for r in desc["replicas"]
                   if r["replica"] == "serving_1")
        assert row["state"] == "dead" and desc["live"] == 2
        dead = [e for e in _events.tail()
                if e["kind"] == "serving_replica_dead"]
        assert dead and dead[-1]["replica"] == "serving_1"
        series = telemetry.parse_exposition(client.get_metrics())
        assert sum(series[telemetry.M_ROUTER_RETRIES_TOTAL].values()) >= 1
        errors = series[telemetry.M_ROUTER_REQUESTS_TOTAL][
            (("outcome", "error"), ("replica", "serving_1"))]
        assert errors >= 1
    finally:
        client.close()
        _teardown(servers, rserver)


def test_retry_is_bounded_at_retry_hops(clean_telemetry):
    """With ``retry_hops`` 1 a request tries its owner and one more: a key
    whose first two owners are both down fails, naming them."""
    ops, cfg, gateways, servers, router, rserver = _fleet_of(
        3, retry_hops=1)
    try:
        for srv in servers[:2]:
            srv.stop()
        dead = {"serving_0", "serving_1"}
        key = next(f"u{i}" for i in range(1000)
                   if set(router.owners(f"u{i}")[:2]) == dead)
        with pytest.raises(RuntimeError, match="no serving replica"):
            router.forward("Predict", b"", key, timeout=5.0)
        survivor_key = next(f"v{i}" for i in range(1000)
                            if router.owners(f"v{i}")[0] == "serving_2")
        client = ServingClient("127.0.0.1", rserver.port)
        try:
            reply = client.predict(np.zeros((1, 4), np.float32),
                                   key=survivor_key, timeout=30.0)
        finally:
            client.close()
        assert reply.model_version == 1
    finally:
        _teardown(servers, rserver)


def test_router_status_keys_equal_the_jax_routers(clean_telemetry):
    """The port's router and the JAX package's, over the same replicas:
    ``GetServingStatus`` has the same keys and per-replica rows, and both
    reflect ``role: router`` with the same methods."""
    from metisfl_tpu.config import ServingConfig as JaxServingConfig
    from metisfl_tpu.config import ServingFleetConfig as JaxFleetConfig
    from metisfl_tpu.serving import RouterServer as JaxRouterServer
    from metisfl_tpu.serving import ServingRouter as JaxRouter

    ops, cfg, gateways, servers, router, rserver = _fleet_of(2)
    jax_router = JaxRouter(JaxServingConfig(
        enabled=True, fleet=JaxFleetConfig(enabled=True, replicas=2,
                                           probe_every_s=0.2)))
    for i, srv in enumerate(servers):
        jax_router.add_replica(f"serving_{i}", "127.0.0.1", srv.port)
    jax_server = JaxRouterServer(jax_router, host="127.0.0.1", port=0)
    jax_port = jax_server.start()
    clients = [ServingClient("127.0.0.1", rserver.port),
               ServingClient("127.0.0.1", jax_port)]
    try:
        router.probe_once()
        jax_router.probe_once()
        for c in clients:
            c.predict(np.zeros((1, 4), np.float32), key="a", timeout=30.0)
        port_desc, jax_desc = (c.status() for c in clients)
        assert sorted(port_desc) == sorted(jax_desc)
        assert ([sorted(r) for r in port_desc["replicas"]]
                == [sorted(r) for r in jax_desc["replicas"]])
        assert port_desc["live"] == jax_desc["live"] == 2
        assert ([r["installed"] for r in port_desc["replicas"]]
                == [r["installed"] for r in jax_desc["replicas"]]
                == [{"stable": 1}] * 2)
        port_ref, jax_ref = (c.list_methods() for c in clients)
        assert port_ref["role"] == jax_ref["role"] == "router"
        names = [sorted(m["name"] for m in ref["methods"])
                 for ref in (port_ref, jax_ref)]
        assert names[0] == names[1]
        assert sorted(clients[0].health()) == sorted(clients[1].health())
    finally:
        for c in clients:
            c.close()
        jax_server.stop()
        _teardown(servers, rserver)


# ---------------------------------------------------------------------- #
# DriverSession: a 2-replica fleet on the CPU
# ---------------------------------------------------------------------- #

@contextlib.contextmanager
def _recipes_by_value():
    """Recipes defined here travel by value: the processes cannot import
    this test module."""
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(module)


def _wait(predicate, timeout_s, what, tick=None):
    deadline = time.time() + timeout_s
    while not predicate():
        assert time.time() < deadline, f"timed out waiting for {what}"
        if tick is not None:
            tick()
        time.sleep(0.2)


def test_driver_session_fleet_serves_scales_and_relaunches(
        tmp_path, clean_telemetry):
    """DriverSession boots 2 replicas and the router beside the learner;
    Predicts through ``serving_client()`` equal the in-process engine on
    the stable version; a request surge fires the rate rule (a third
    replica), its end drains back to 2; a SIGKILLed replica is relaunched
    and pinned back to stable by its first poll; ``run_inference`` answers
    from the learner."""
    from metisfl_tpu_torch.driver import DriverSession
    from metisfl_tpu_torch.models import ArrayDataset
    from metisfl_tpu_torch.telemetry import events as _events

    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.argmax(x @ w, -1).astype(np.int32)

    def recipe():
        from metisfl_tpu_torch.models import ArrayDataset as DS
        from metisfl_tpu_torch.models import TorchModelOps as Ops
        from metisfl_tpu_torch.models.zoo import MLP as Net
        return (Ops(Net(4, (8,), 3), rng_seed=0, device="cpu"),
                DS(x, y, seed=0), None, DS(x, y))

    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=32, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=2),
        registry=RegistryConfig(enabled=True, promotion=PromotionConfig(
            require_eval=False)),
        serving=ServingConfig(
            enabled=True, max_batch=4, max_wait_ms=1.0, poll_every_s=0.25,
            fleet=ServingFleetConfig(
                enabled=True, replicas=2, min_replicas=2, max_replicas=3,
                probe_every_s=0.25, scale_cooldown_s=0.5,
                scale_up={"metric": "serving_requests_total",
                          "kind": "rate", "window_s": 2.0, "op": ">",
                          "threshold": 5.0, "for_s": 0.0},
                scale_down={"metric": "serving_requests_total",
                            "kind": "rate", "window_s": 2.0, "op": "<",
                            "threshold": 0.5, "for_s": 0.5})))
    template = _mlp_ops().get_variables()
    session = DriverSession(config, template, [recipe],
                            workdir=str(tmp_path), device="cpu")
    client = None
    try:
        with _recipes_by_value():
            session.initialize_federation()
        fleet = config.serving.fleet
        assert [g["name"] for g in fleet.gateways] == ["serving_0",
                                                       "serving_1"]
        assert config.serving.port == fleet.router_port
        booted = session.wait_for_serving(timeout_s=120.0)
        assert sorted(booted) == ["router", "serving_0", "serving_1"]
        # launch to the time each READY line states
        assert all(0.0 < s < 120.0 for s in booted.values()), booted
        session.monitor_federation(poll_every_s=0.2,
                                   eval_drain_timeout_s=30.0)
        stable = session._client.describe_registry()["stable"]
        assert stable >= 1
        blob = session._client.get_registered_model(version=stable)
        ops = _mlp_ops()
        want = ops.infer(np.repeat(x[:1], 4, 0), 4, model=ops.bind(
            ModelBlob.from_bytes(blob).tensors))[:1]
        client = session.serving_client()
        assert client.list_methods()["role"] == "router"

        def served_stable():
            try:
                reply = client.predict(x[:1], key="boot", timeout=5.0)
            except Exception:  # noqa: BLE001 - not installed yet
                return False
            return reply.model_version == stable

        _wait(served_stable, 60.0, "the stable version through the router",
              session.poll_serving)
        reply = client.predict(x[:1], key="user-1", timeout=30.0)
        assert (reply.model_version, reply.channel) == (stable, "stable")
        np.testing.assert_array_equal(client.predictions(reply), want)

        # a surge fires the rate rule: a third replica, out of the ring
        # until it probes SERVING
        actions = []

        def surge():
            for i in range(10):
                client.predict(x[:1], key=f"s{i}", timeout=10.0)
            actions.append(session.poll_serving())

        _wait(lambda: "up" in actions, 60.0, "the scale-up", surge)
        assert len(fleet.gateways) == 3
        assert any(p.name == "serving_2" for p in session._procs)
        _wait(lambda: "down" in actions, 60.0, "the drain",
              lambda: actions.append(session.poll_serving()))
        assert [g["name"] for g in fleet.gateways] == ["serving_0",
                                                       "serving_1"]
        assert not any(p.name == "serving_2" for p in session._procs)
        kinds = [e["kind"] for e in _events.tail()]
        assert "serving_scaled_up" in kinds and "serving_scaled_down" in kinds
        reg = telemetry.metrics.registry()
        assert reg.get(telemetry.M_SERVING_FLEET_REPLICAS).value() == 2
        scale = reg.get(telemetry.M_SERVING_SCALE_TOTAL)
        assert scale.value(direction="up") == scale.value(
            direction="down") == 1

        # SIGKILL a replica under traffic: no request fails, the driver
        # relaunches it and its first poll pins it back to stable
        victim = next(p for p in session._procs if p.name == "serving_0")
        victim.process.kill()
        victim.process.wait(timeout=30)
        for i in range(10):
            reply = client.predict(x[:1], key=f"k{i}", timeout=30.0)
            assert reply.model_version == stable

        def repinned():
            session.poll_serving()
            rows = {r["replica"]: r for r in client.status()["replicas"]}
            row = rows["serving_0"]
            return (session._serving_restarts.get("serving_0") == 1
                    and row["state"] == "up"
                    and row["installed"].get("stable") == stable)

        _wait(repinned, 90.0, "the relaunched replica re-pinned")
        assert reg.get(telemetry.M_GATEWAY_RESTARTS_TOTAL).value() == 1

        # the learner's inference task on the community model
        community = ops.bind(ModelBlob.from_bytes(
            session._client.get_community_model()).tensors)
        got = session.run_inference(0, inputs=x[:3], batch_size=2)
        np.testing.assert_allclose(
            got, ops.infer(x[:3], 2, model=community), atol=1e-6)
    finally:
        if client is not None:
            client.close()
        session.shutdown_federation()
    codes = session.process_exit_codes()
    assert all(code == 0 for code in codes.values()), codes
    assert {"router", "serving_0", "serving_1", "learner_0",
            "controller"} <= set(codes)
