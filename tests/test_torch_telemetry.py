"""The port's telemetry core against the JAX package's: the metrics registry
and its Prometheus exposition, trace spans through the JSONL sink and the
trace viewer, the trace context over gRPC metadata, and a 2-round gRPC
federation of the port (the controller's and a learner's ``GetMetrics``,
one stitched trace per round); then mixed fleets: a JAX learner under the
port's controller, and a port learner under the JAX controller, stitch
into one span tree per round. Counterpart of ``tests/test_telemetry.py``.

Exposition texts compare exactly (same registrations, same text); spans
compare by structure (ids are random).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from metisfl_tpu import telemetry as jtel
from metisfl_tpu.telemetry import metrics as jmetrics
from metisfl_tpu.telemetry import trace as jtrace
from metisfl_tpu_torch import telemetry
from metisfl_tpu_torch.telemetry import metrics as tmetrics
from metisfl_tpu_torch.telemetry import trace as ttrace
from metisfl_tpu_torch.telemetry.metrics import parse_exposition


@pytest.fixture()
def telem(tmp_path):
    """Clean port telemetry with a JSONL sink under tmp_path."""
    telemetry.reset()
    ttrace.configure(enabled=True, service="test", dir=str(tmp_path))
    yield tmp_path
    ttrace.flush()
    telemetry.reset()


def _spans(path):
    ttrace.flush()
    jtrace.flush()
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".jsonl"):
            with open(os.path.join(path, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return [s for s in out if s.get("span")]


# --------------------------------------------------------------------- #
# metrics registry + exposition
# --------------------------------------------------------------------- #


def _register(mod):
    """The same families and samples in a fresh registry of ``mod``."""
    reg = mod.Registry()
    c = reg.counter("t_requests_total", "test requests", ("method",))
    g = reg.gauge("t_queue_depth", "queued items")
    h = reg.histogram("t_latency_seconds", "latency",
                      buckets=(0.1, 1.0, 10.0))
    c.inc(method="a")
    c.inc(2, method='we"ird\\label')
    g.set(7)
    h.observe(0.05)
    h.observe(3.0)
    return reg


def test_same_registrations_give_the_same_exposition_text():
    port, jax = _register(tmetrics), _register(jmetrics)
    text = port.render()
    assert text == jax.render()
    parsed = parse_exposition(text)
    assert parsed == jmetrics.parse_exposition(text)
    assert parsed["t_requests_total"][(("method", "a"),)] == 1
    assert parsed["t_requests_total"][(("method", 'we"ird\\label'),)] == 2
    assert parsed["t_queue_depth"][()] == 7
    assert parsed["t_latency_seconds_count"][()] == 2
    assert parsed["t_latency_seconds_sum"][()] == pytest.approx(3.05)
    assert parsed["t_latency_seconds_bucket"][(("le", "0.1"),)] == 1
    assert parsed["t_latency_seconds_bucket"][(("le", "10"),)] == 2


@pytest.mark.parametrize("budget", [0, 2])
def test_the_cardinality_budget_collapses_like_the_jax_package(budget):
    """Past the budget a per-learner family serves sketches; the text and
    the exported budget state are the JAX package's, and the state
    restores into the other package's registry."""
    texts, states = [], []
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        reg.set_cardinality_budget(budget)
        g = reg.gauge("t_score", "per learner", ("learner",),
                      budget_label="learner")
        rng = np.random.default_rng(5)
        for i in range(6):
            g.set(float(rng.standard_normal()), learner=f"L{i}")
        texts.append(reg.render())
        states.append(reg.budget_state())
    assert texts[0] == texts[1]
    assert states[0] == states[1]
    if budget:
        assert states[0], "nothing collapsed past the budget"
        restored = []
        for mod, state in ((tmetrics, states[1]), (jmetrics, states[0])):
            reg = mod.Registry()
            reg.set_cardinality_budget(budget)
            reg.gauge("t_score", "per learner", ("learner",),
                      budget_label="learner")
            reg.restore_budget_state(state)
            restored.append((reg.render(), reg.budget_state()))
        assert restored[0] == restored[1]
        assert restored[0][1] == states[0]


def test_exposition_parse_rejects_garbage():
    with pytest.raises(ValueError):
        parse_exposition("this is not { an exposition")


def test_registry_idempotent_and_type_checked(telem):
    reg = telemetry.registry()
    a = reg.counter("t_twice_total", "x", ("l",))
    assert reg.counter("t_twice_total", "x", ("l",)) is a
    with pytest.raises(ValueError):
        reg.gauge("t_twice_total", "x", ("l",))


def test_disabled_metrics_are_noop(telem):
    reg = telemetry.registry()
    c = reg.counter("t_off_total", "x")
    tmetrics.set_enabled(False)
    try:
        c.inc()
        assert c.value() == 0
    finally:
        tmetrics.set_enabled(True)
    c.inc()
    assert c.value() == 1


def test_the_series_names_are_the_jax_packages():
    ours = {n: getattr(telemetry, n) for n in dir(telemetry)
            if n.startswith("M_")}
    theirs = {n: getattr(jtel, n) for n in dir(jtel) if n.startswith("M_")}
    assert ours == theirs
    assert telemetry.METADATA_KEY == jtel.METADATA_KEY


# --------------------------------------------------------------------- #
# trace spans: sink round trip + CLI renderer
# --------------------------------------------------------------------- #


def test_span_tree_roundtrips_sink_and_cli(telem, capsys):
    root = ttrace.span("round", parent=None, attrs={"round": 3})
    with root.activate():
        with ttrace.span("round.dispatch"):
            time.sleep(0.01)
        child = ttrace.span("learner.train", attrs={"learner": "L0"})
        with child.activate():
            with ttrace.span("learner.train_steps"):
                pass
        child.end()
    root.end()

    spans = _spans(telem)
    by_name = {s["name"]: s for s in spans}
    assert by_name["round"]["parent"] == ""
    assert by_name["round.dispatch"]["parent"] == by_name["round"]["span"]
    assert by_name["learner.train"]["parent"] == by_name["round"]["span"]
    assert (by_name["learner.train_steps"]["parent"]
            == by_name["learner.train"]["span"])
    assert len({s["trace"] for s in spans}) == 1
    assert by_name["round"]["dur_ms"] >= 10.0

    from metisfl_tpu.telemetry.__main__ import render_trace as jax_render
    from metisfl_tpu_torch.telemetry.__main__ import main as tel_main
    from metisfl_tpu_torch.telemetry.__main__ import render_trace
    # the two viewers render the same tree from the same records
    assert render_trace(spans) == jax_render(spans)
    assert tel_main([str(telem)]) == 0
    out = capsys.readouterr().out
    assert "└─ learner.train " in out
    assert "   └─ learner.train_steps " in out
    assert tel_main([str(telem), "--round", "3"]) == 0
    assert tel_main([str(telem), "--round", "99"]) == 1


def test_disabled_tracer_hands_out_null_spans(telem):
    ttrace.configure(enabled=False)
    try:
        sp = ttrace.span("x", parent=None)
        with sp, sp.activate():
            assert ttrace.current_context() is None
            time.sleep(0.01)
        assert sp.trace_id == "" and sp.span_id == ""
        assert sp.end() >= 10.0
        assert sp.duration_ms == sp.end()
    finally:
        ttrace.configure(enabled=True, service="test", dir=str(telem))
    assert not [f for f in os.listdir(telem) if f.endswith(".jsonl")]


def test_the_trace_frame_is_the_jax_packages(telem):
    """The metadata key and frame one package writes, the other reads."""
    with ttrace.span("outer", parent=None) as sp, sp.activate():
        ours = ttrace.outbound_metadata()
    assert ours[0][0] == jtel.METADATA_KEY
    got = jtrace.extract(ours)
    assert (got.trace_id, got.span_id) == (sp.trace_id, sp.span_id)
    with jtrace.span("jax-outer", parent=None) as jsp, jsp.activate():
        theirs = jtrace.outbound_metadata()
    back = ttrace.extract(theirs)
    assert (back.trace_id, back.span_id) == (jsp.trace_id, jsp.span_id)
    assert ttrace.round_trace_id(7) == jtrace.round_trace_id(7)


@pytest.mark.parametrize("server_side", ["torch", "jax"])
def test_trace_context_propagates_over_grpc_metadata(telem, server_side):
    """A port client's context reaches a server of either package, and
    that server's span parents under the caller's."""
    from metisfl_tpu.comm import rpc as jax_rpc
    from metisfl_tpu_torch.comm.rpc import BytesService, RpcClient, RpcServer

    seen = []
    mod_trace = ttrace if server_side == "torch" else jtrace

    def echo(payload: bytes) -> bytes:
        seen.append(mod_trace.current_context())
        return payload

    if server_side == "torch":
        server = RpcServer("127.0.0.1", 0)
        server.add_service(BytesService("test.Trace", {"Echo": echo}))
    else:
        jtrace.configure(enabled=True, service="jax", dir=str(telem))
        server = jax_rpc.RpcServer("127.0.0.1", 0)
        server.add_service(jax_rpc.BytesService("test.Trace",
                                                {"Echo": echo}))
    port = server.start()
    client = RpcClient("127.0.0.1", port, "test.Trace")
    try:
        with ttrace.span("outer", parent=None) as sp:
            with sp.activate():
                client.call("Echo", b"x")
        assert seen and seen[0] is not None
        assert seen[0].trace_id == sp.trace_id
        spans = _spans(telem)
        rpc_span = [s for s in spans if s["name"] == "rpc.server/Echo"][0]
        assert rpc_span["trace"] == sp.trace_id
        assert rpc_span["parent"] == sp.span_id
        parsed = parse_exposition(telemetry.render_metrics())
        assert parsed["rpc_client_calls_total"][(
            ("method", "Echo"), ("retried", "0"),
            ("service", "test.Trace"))] == 1
    finally:
        client.close()
        server.stop()
        if server_side == "jax":
            jtrace.configure(enabled=True, service="test", dir="")


# --------------------------------------------------------------------- #
# federations over gRPC: the port alone, and mixed fleets
# --------------------------------------------------------------------- #


def _shard(i):
    rng = np.random.default_rng(3 + i)
    x = rng.standard_normal((24, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    return x, y


def _port_engine():
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    return TorchModelOps(MLP(4, (8,), 2), rng_seed=0, device="cpu")


def _jax_engine(x):
    from metisfl_tpu.models import FlaxModelOps
    from metisfl_tpu.models.zoo import MLP

    return FlaxModelOps(MLP(features=(8,), num_outputs=2), x[:2],
                        rng_seed=0)


def _controller(kind, rounds=2):
    """(controller, its server, its port) of either package."""
    if kind == "torch":
        from metisfl_tpu_torch.comm import TrainParams
        from metisfl_tpu_torch.config import (AggregationConfig, EvalConfig,
                                              FederationConfig,
                                              TerminationConfig)
        from metisfl_tpu_torch.controller.core import Controller
        from metisfl_tpu_torch.controller.service import (ControllerServer,
                                                          RpcLearnerProxy)
        kw = {"device": "cpu"}
    else:
        from metisfl_tpu.comm.messages import TrainParams
        from metisfl_tpu.config import (AggregationConfig, EvalConfig,
                                        FederationConfig, TerminationConfig)
        from metisfl_tpu.controller.core import Controller
        from metisfl_tpu.controller.service import (ControllerServer,
                                                    RpcLearnerProxy)
        kw = {}
    config = FederationConfig(
        aggregation=AggregationConfig(rule="fedavg", scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=rounds))
    controller = Controller(config, lambda record: RpcLearnerProxy(record),
                            **kw)
    server = ControllerServer(controller, host="127.0.0.1", port=0)
    return controller, server, server.start()


def _learner(kind, port, i):
    """(learner, its server, its controller client) of either package."""
    x, y = _shard(i)
    if kind == "torch":
        from metisfl_tpu_torch.controller.service import ControllerClient
        from metisfl_tpu_torch.learner.learner import Learner
        from metisfl_tpu_torch.learner.service import LearnerServer
        from metisfl_tpu_torch.models import ArrayDataset
        engine = _port_engine()
    else:
        from metisfl_tpu.controller.service import ControllerClient
        from metisfl_tpu.learner.learner import Learner
        from metisfl_tpu.learner.service import LearnerServer
        from metisfl_tpu.models import ArrayDataset
        engine = _jax_engine(x)
    client = ControllerClient("127.0.0.1", port)
    client._client.retries = 2
    client._client.retry_sleep_s = 0.2
    learner = Learner(model_ops=engine, train_dataset=ArrayDataset(
        x, y, seed=i), controller=client, hostname="127.0.0.1")
    server = LearnerServer(learner, host="127.0.0.1", port=0)
    server.start()
    return learner, server, client


def _run(controller_kind, learner_kinds, rounds=2):
    """A gRPC federation of ``controller_kind`` with one learner of each
    of ``learner_kinds``, ``rounds`` rounds; returns (controller metadata,
    the controller's GetMetrics text, learner 0's)."""
    from metisfl_tpu_torch.comm.rpc import RpcClient
    from metisfl_tpu_torch.controller.service import (LEARNER_SERVICE,
                                                      ControllerClient)
    from metisfl_tpu_torch.tensor import pack_model

    controller, ctrl_server, port = _controller(controller_kind, rounds)
    controller.set_community_model(pack_model(
        _port_engine().get_variables()))
    learners = []
    scrape = None
    try:
        for i, kind in enumerate(learner_kinds):
            learners.append(_learner(kind, port, i))
        for learner, _, _ in learners:
            learner.join_federation()
        deadline = time.time() + 120
        while controller.global_iteration < rounds and time.time() < deadline:
            time.sleep(0.05)
        assert controller.global_iteration >= rounds, "federation stalled"
        scrape = ControllerClient("127.0.0.1", port)
        ctrl_text = scrape.get_metrics()
        lclient = RpcClient("127.0.0.1", learners[0][1].port,
                            LEARNER_SERVICE)
        learner_text = lclient.call("GetMetrics", b"",
                                    timeout=10).decode("utf-8")
        lclient.close()
        meta = controller.get_runtime_metadata()
    finally:
        for _, server, _ in learners:
            server.stop(leave=False)
        ctrl_server.stop()
        for _, _, client in learners:
            client.close()
        if scrape is not None:
            scrape.close()
    return meta, ctrl_text, learner_text


def _stitched_rounds(spans, services):
    """Per round, the learner services whose ``learner.train`` span has
    the controller's ``round`` root as its ancestor."""
    by_id = {s["span"]: s for s in spans}
    out = {}
    for ts in spans:
        if ts["name"] != "learner.train":
            continue
        node, hops = ts, 0
        while node.get("parent") and node["parent"] in by_id and hops < 20:
            node = by_id[node["parent"]]
            hops += 1
        if node["name"] == "round" and node["trace"] == ts["trace"]:
            out.setdefault(node["attrs"]["round"], set()).add(
                services[ts["service"]])
    return out


def test_grpc_federation_two_rounds_metrics_and_trace(telem):
    """The controller's and a learner's GetMetrics parse, with the RPC,
    round-phase and uplink series; the sink holds one stitched trace per
    round with the controller's round span an ancestor of each learner's
    train span."""
    ttrace.configure(enabled=True, service="proc", dir=str(telem))
    meta, ctrl_text, learner_text = _run("torch", ["torch", "torch"])
    for text in (ctrl_text, learner_text):
        parsed = parse_exposition(text)
        assert parsed["round_duration_seconds_count"][()] >= 2
        assert any(k.startswith("rpc_server_latency_seconds")
                   for k in parsed)
        assert sum(parsed["uplink_bytes_total"].values()) > 0
        phases = {labels[0][1] for labels in
                  parsed["round_phase_duration_seconds_count"]}
        assert {"dispatch", "wait_uplinks", "aggregate"} <= phases
    assert meta[0]["dispatch_duration_ms"] > 0
    assert meta[0]["wait_duration_ms"] > 0
    assert meta[0]["aggregation_duration_ms"] > 0
    assert len(meta[0]["aggregation_block_duration_ms"]) >= 1
    spans = _spans(telem)
    roots = [s for s in spans if s["name"] == "round" and not s["parent"]]
    assert sorted(s["attrs"]["round"] for s in roots) == [0, 1]
    stitched = _stitched_rounds(spans, {"proc": "port"})
    assert set(stitched) == {0, 1}

    from metisfl_tpu_torch.telemetry.__main__ import main as tel_main
    assert tel_main([str(telem)]) == 0


@pytest.mark.parametrize("controller_kind,learner_kind",
                         [("torch", "jax"), ("jax", "torch")])
def test_trace_context_crosses_a_mixed_fleet(tmp_path, controller_kind,
                                             learner_kind):
    """A learner of the other package trains under each round's root: its
    ``learner.train`` span, in its own package's sink, descends from the
    controller's ``round`` span through the dispatch RPC's metadata."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    telemetry.reset()
    ttrace.configure(enabled=True, service="port", dir=str(port_dir))
    jmetrics.set_enabled(True)
    jtrace.configure(enabled=True, service="jax", dir=str(jax_dir))
    try:
        _run(controller_kind, [learner_kind, controller_kind])
        spans = _spans(port_dir) + _spans(jax_dir)
    finally:
        jtrace.configure(enabled=True, service="test", dir="")
        telemetry.reset()
    kind = {"port": "torch", "jax": "jax"}
    roots = [s for s in spans if s["name"] == "round" and not s["parent"]]
    assert {kind[s["service"]] for s in roots} == {controller_kind}
    stitched = _stitched_rounds(spans, kind)
    # (the JAX controller trains on past its last round; the port's stops)
    assert stitched[0] == stitched[1] == {"torch", "jax"}


def test_telemetry_cli_usage_errors(capsys):
    from metisfl_tpu_torch.telemetry.__main__ import main as tel_main

    assert tel_main([]) == 2
    assert tel_main(["--round"]) == 2


def test_inprocess_federation_honors_optout(tmp_path):
    """telemetry.enabled=false: no sink files, metric instruments no-op;
    a later default-enabled federation in the process re-enables them
    and keeps a host-configured sink."""
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (AggregationConfig, EvalConfig,
                                          FederationConfig, TelemetryConfig,
                                          TerminationConfig)
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset

    config = FederationConfig(
        aggregation=AggregationConfig(rule="fedavg", scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=1, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        telemetry=TelemetryConfig(enabled=False, dir=str(tmp_path / "t")),
        termination=TerminationConfig(federation_rounds=1))
    x, y = _shard(0)
    fed = InProcessFederation(config, device="cpu")
    engine = _port_engine()
    fed.add_learner(engine, ArrayDataset(x, y, seed=0))
    fed.seed_model(engine.get_variables())
    try:
        telemetry.registry().reset()
        fed.start()
        assert fed.wait_for_rounds(1, timeout_s=60)
        assert telemetry.registry().render() == ""
        assert not (tmp_path / "t").exists() or not os.listdir(
            tmp_path / "t")
        meta = fed.controller.get_runtime_metadata()[0]
        assert meta["aggregation_duration_ms"] > 0
        assert meta["dispatch_duration_ms"] > 0
        host_dir = str(tmp_path / "host_sink")
        ttrace.configure(enabled=False, service="test", dir=host_dir)
        fed2 = InProcessFederation(dataclasses.replace(
            config, telemetry=TelemetryConfig()), device="cpu")
        try:
            assert tmetrics.enabled()
            assert ttrace.span("probe", parent=None).trace_id
            assert ttrace.trace_path().startswith(host_dir)
        finally:
            fed2.shutdown()
    finally:
        fed.shutdown()
        telemetry.reset()


def test_a_yaml_telemetry_section_loads_into_the_config(tmp_path):
    """``telemetry:`` loads as the JAX package loads it; the fabric,
    profiler and runtime sections are accepted; SLO alert rules are
    refused (not ported yet)."""
    from metisfl_tpu.config import load_config as jax_load
    from metisfl_tpu_torch.config import load_config

    path = tmp_path / "fed.yaml"
    path.write_text(
        "telemetry:\n"
        "  dir: /tmp/x\n"
        "  cardinality_budget: 64\n"
        "  http_port: 9100\n"
        "  events: {enabled: false, ring_size: 64}\n"
        "  health: {alpha: 0.5, anomaly_threshold: 2.5, advisory: true}\n"
        "  profile: {trace_every_rounds: 3}\n"
        "  prof: {hz: 33.0}\n"
        "  fabric: {poll_every_s: 5.0}\n")
    ours, theirs = load_config(str(path)), jax_load(str(path))
    assert dataclasses.asdict(ours.telemetry) == dataclasses.asdict(
        theirs.telemetry)
    from metisfl_tpu_torch.config import FederationConfig
    assert FederationConfig.from_wire(ours.to_wire()).telemetry == \
        ours.telemetry
    bad = tmp_path / "bad.yaml"
    bad.write_text("telemetry:\n  health: {alpha: 0.0}\n")
    with pytest.raises(ValueError, match="alpha"):
        load_config(str(bad))
    alerts = tmp_path / "alerts.yaml"
    alerts.write_text(
        "telemetry:\n  alerts:\n"
        "    - {name: slow, expr: 'round_duration_seconds_sum > 1'}\n")
    with pytest.raises(NotImplementedError, match="4b"):
        load_config(str(alerts))


# --------------------------------------------------------------------- #
# the learners' device stats and profiler captures
# --------------------------------------------------------------------- #


def test_device_monitor_peaks_and_cpu_degradation():
    from metisfl_tpu.telemetry.profile import DeviceMonitor as JaxMonitor
    from metisfl_tpu_torch.telemetry.profile import (DeviceMonitor,
                                                     device_peak_flops)

    assert device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert device_peak_flops("") == 0.0
    # on the CPU the device fields degrade to 0, as the JAX monitor's do
    # on a backend without memory stats; the EWMA is the JAX one
    ours, theirs = DeviceMonitor(device="cpu"), JaxMonitor()
    for ms in (40.0, 20.0, 30.0):
        got = ours.observe(steps=2, ms_per_step=ms, flops_per_step=1e9)
        want = theirs.observe(steps=2, ms_per_step=ms, flops_per_step=1e9)
        assert got["step_ms_ewma"] == want["step_ms_ewma"]
    assert got["mfu"] == 0.0 and got["hbm_peak_bytes"] == 0
    assert got["device_kind"] == ""


def test_a_profile_dir_leaves_a_torch_profiler_capture(telem, tmp_path):
    """A train task with ``profile_dir`` leaves one capture, in the JAX
    package's layout (a subdirectory per learner, a session directory per
    capture), and reports its device stats."""
    from metisfl_tpu_torch.comm import TrainTask
    from metisfl_tpu_torch.learner.learner import Learner
    from metisfl_tpu_torch.models import ArrayDataset

    class _Ctrl:
        def __init__(self):
            self.results = []

        def task_completed(self, result):
            self.results.append(result)
            return True

    x, y = _shard(0)
    ctrl = _Ctrl()
    learner = Learner(_port_engine(), ArrayDataset(x, y, seed=0), ctrl)
    learner.learner_id = "L0"
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.tensor import pack_model

    params = TrainParams(batch_size=8, local_steps=4, learning_rate=0.1,
                         profile_dir=str(tmp_path / "prof"),
                         profile_steps=2)
    learner.run_task(TrainTask(task_id="t", learner_id="L0", round_id=0,
                               model=pack_model(_port_engine()
                                                .get_variables()),
                               params=params))
    deadline = time.time() + 60
    while not ctrl.results and time.time() < deadline:
        time.sleep(0.05)
    learner.shutdown()
    assert ctrl.results
    sessions = os.listdir(tmp_path / "prof" / "L0")
    assert len(sessions) == 1
    with open(tmp_path / "prof" / "L0" / sessions[0] / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    stats = ctrl.results[0].device_stats
    assert stats["steps"] == 4 and stats["step_ms_ewma"] > 0
    spans = {s["name"] for s in _spans(telem)}
    assert {"learner.train", "learner.load_model", "learner.train_steps",
            "learner.dump_model"} <= spans
