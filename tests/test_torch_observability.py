"""The port's event journal, flight recorder and live snapshot against the
JAX package's: the typed journal (ring bounds, seq monotonicity, sink,
opt-out inertness; the same records as the JAX journal for the same
emits), post-mortem bundles rendered by either package's viewer, a chaos
kill's bundle, ``DescribeFederation`` in process and over gRPC with its
event tail, health and profile, and controller checkpoints carrying the
health plane's state and the collapsed metric families across packages
both ways. Counterpart of ``tests/test_observability.py`` (the status
CLI is not ported yet).
"""

import json
import os
import time

import numpy as np
import pytest

from metisfl_tpu.telemetry import events as jevents
from metisfl_tpu.telemetry import postmortem as jpostmortem
from metisfl_tpu_torch import telemetry
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    EventsConfig,
    FederationConfig,
    TelemetryConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.telemetry import events as tevents
from metisfl_tpu_torch.telemetry import metrics as tmetrics
from metisfl_tpu_torch.telemetry import postmortem as tpostmortem
from metisfl_tpu_torch.telemetry import trace as ttrace
from metisfl_tpu_torch.tensor import pack_model


@pytest.fixture()
def journal():
    """Clean, enabled port telemetry; the same defaults again after."""
    telemetry.reset()
    yield tevents.journal()
    telemetry.reset()


def _jax_reset():
    jevents.configure(enabled=True, service="test", dir="", ring_size=512)
    jevents.journal().reset()


# --------------------------------------------------------------------- #
# event journal units
# --------------------------------------------------------------------- #


def test_ring_bounds_and_seq_monotonicity(journal):
    tevents.configure(enabled=True, ring_size=4)
    for i in range(7):
        tevents.emit(tevents.TaskDispatched, task_id=f"t{i}",
                     learner_id="L0", round=i)
    tail = tevents.tail()
    assert len(tail) == 4
    seqs = [r["seq"] for r in tail]
    assert seqs == sorted(seqs) and seqs[-1] == 7
    assert [r["task_id"] for r in tail] == ["t3", "t4", "t5", "t6"]
    assert tevents.tail(2) == tail[-2:]


def test_the_journal_records_what_the_jax_journal_records(journal):
    """Every event type the JAX package has, with its kind and fields:
    the same emits make the same records (timestamps aside)."""
    ours = {name for name in dir(tevents) if hasattr(
        getattr(tevents, name), "kind")}
    theirs = {name for name in dir(jevents) if hasattr(
        getattr(jevents, name), "kind")}
    assert ours == theirs
    for name in ours:
        assert getattr(tevents, name).kind == getattr(jevents, name).kind
    _jax_reset()
    emits = [("RoundStarted", dict(round=3, cohort=2)),
             ("UpdateAnomalous", dict(learner_id="L1", round=3, score=4.5,
                                      raw=5.0, update_norm=1.25)),
             ("ControllerFailover", dict(role="standby", round=3,
                                         learners=2, promote_s=0.5))]
    try:
        records = []
        for mod in (tevents, jevents):
            for name, fields in emits:
                mod.emit(getattr(mod, name), **fields)
            records.append([{k: v for k, v in r.items() if k != "ts"}
                            for r in mod.tail()])
        assert records[0] == records[1]
    finally:
        _jax_reset()


def test_typed_events_carry_their_fields(journal):
    record = tevents.emit(tevents.EpochChanged, learner_id="L1",
                          old_epoch="aaaa", new_epoch="bbbb",
                          reason="task_envelope")
    assert record["kind"] == "epoch_changed"
    assert record["old_epoch"] == "aaaa"
    with pytest.raises(TypeError):
        tevents.emit(tevents.RoundStarted, roundd=3)


def test_disabled_journal_is_inert(journal):
    tevents.set_enabled(False)
    assert tevents.emit(tevents.RoundStarted, round=1) is None
    assert tevents.tail() == []
    tevents.set_enabled(True)
    assert tevents.emit(tevents.RoundStarted, round=2) is not None


def test_jsonl_sink_roundtrips(journal, tmp_path):
    tevents.configure(enabled=True, service="sinky", dir=str(tmp_path))
    tevents.emit(tevents.FaultInjected, fault="drop", side="client",
                 method="Echo")
    tevents.flush()
    path = tevents.event_path()
    assert os.path.basename(path).startswith("sinky-")
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert lines[-1]["kind"] == "fault_injected"
    assert lines[-1]["fault"] == "drop"


def test_apply_config_wires_events_and_optouts(journal, tmp_path):
    cfg = TelemetryConfig(enabled=True, dir=str(tmp_path),
                          events=EventsConfig(enabled=False, ring_size=8))
    telemetry.apply_config(cfg, service="cfged")
    assert not tevents.enabled()
    cfg.events.enabled = True
    telemetry.apply_config(cfg, service="cfged")
    assert tevents.enabled()
    assert tevents.journal()._ring.maxlen == 8
    telemetry.apply_config(TelemetryConfig(enabled=False), service="cfged")
    assert not tevents.enabled() and not tmetrics.enabled()
    # the planes the port has not ported are named, not silently run
    assert telemetry.unported_planes(TelemetryConfig()) == [
        "fabric", "prof", "runtime"]
    assert telemetry.unported_planes(TelemetryConfig(enabled=False)) == []


# --------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------- #


def test_postmortem_bundle_and_both_viewers(journal, tmp_path, capsys):
    from metisfl_tpu.telemetry.__main__ import render_postmortem as jax_render
    from metisfl_tpu_torch.telemetry.__main__ import main as viewer_main
    from metisfl_tpu_torch.telemetry.__main__ import render_postmortem

    tevents.emit(tevents.RoundStarted, round=5, cohort=3)
    tevents.emit(tevents.TaskDispatched, task_id="tt", learner_id="L2",
                 round=5)
    open_sp = ttrace.span("round", parent=None, attrs={"round": 5})
    tpostmortem.configure(str(tmp_path), service="unit",
                          config_hash="cafe", install_hooks=False)
    path = tpostmortem.dump("unit_test", extra={"note": "x"})
    open_sp.end()
    bundle = json.load(open(path))
    assert bundle["service"] == "unit" and bundle["reason"] == "unit_test"
    assert bundle["config_hash"] == "cafe"
    kinds = [e["kind"] for e in bundle["events"]]
    assert "round_started" in kinds and "task_dispatched" in kinds
    assert any(sp["name"] == "round" for sp in bundle["open_spans"])
    # the JAX viewer reads the port's bundle, and renders it the same
    loaded = tpostmortem.load_bundles([str(tmp_path)])
    assert loaded == jpostmortem.load_bundles([str(tmp_path)])
    assert render_postmortem(loaded[0]) == jax_render(loaded[0])
    assert viewer_main(["--postmortem", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "round_started" in out and "reason=unit_test" in out
    assert viewer_main(["--postmortem", str(tmp_path / "nope")]) == 1


def test_postmortem_unconfigured_is_noop(journal):
    assert tpostmortem._Recorder().dump("whatever") is None


def test_a_chaos_kill_dumps_a_bundle_before_it_exits(journal, tmp_path,
                                                     monkeypatch):
    """The injector's ``kill`` writes the dying process's bundle (its
    event tail names the fault) before ``os._exit``."""
    from metisfl_tpu_torch.chaos import injector

    exits = []
    monkeypatch.setattr(injector.os, "_exit", exits.append)
    monkeypatch.setattr(injector.logging, "shutdown", lambda: None)
    tpostmortem.configure(str(tmp_path), service="controller",
                          install_hooks=False)
    chaos = injector.ChaosInjector.from_spec({"seed": 1, "rules": [
        {"side": "server", "fault": "kill", "method": "MarkTaskCompleted",
         "max_fires": 1}]})
    chaos.intercept("server", "metisfl_tpu.Controller", "MarkTaskCompleted",
                    b"x")
    assert exits == [137]
    bundles = tpostmortem.load_bundles([str(tmp_path)])
    assert [b["reason"] for b in bundles] == ["chaos_kill"]
    assert bundles[0]["events"][-1]["kind"] == "fault_injected"
    faults = telemetry.parse_exposition(telemetry.render_metrics())[
        "chaos_faults_injected_total"]
    assert faults[(("fault", "kill"), ("method", "MarkTaskCompleted"),
                   ("side", "server"))] == 1


# --------------------------------------------------------------------- #
# DescribeFederation
# --------------------------------------------------------------------- #


def _shards(n, seed=11):
    from metisfl_tpu_torch.models import ArrayDataset

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 3)).astype(np.float32)

    def draw(size, i):
        x = rng.standard_normal((size, 6)).astype(np.float32)
        return ArrayDataset(x, np.argmax(x @ w, -1).astype(np.int32),
                            seed=i)

    return [draw(48, i) for i in range(n)], draw(64, 99)


def _federation(rounds=2, events_enabled=True):
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    config = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=16, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=rounds),
        telemetry=TelemetryConfig(
            events=EventsConfig(enabled=events_enabled)))
    fed = InProcessFederation(config, device="cpu")
    shards, test = _shards(2)
    for shard in shards:
        fed.add_learner(TorchModelOps(MLP(6, (8,), 3), rng_seed=0,
                                      device="cpu"), shard,
                        test_dataset=test)
    fed.seed_model(TorchModelOps(MLP(6, (8,), 3), rng_seed=0,
                                 device="cpu").get_variables())
    return fed


def test_describe_federation_live_snapshot(journal):
    """A 2-learner federation: every learner carries a straggler score and
    a divergence score, the gauges are exported, the event ring
    reconstructs the round lifecycle, and the latest round's health and
    cost profile ride along."""
    fed = _federation(rounds=2)
    try:
        fed.start()
        assert fed.wait_for_rounds(2, timeout_s=120)
        snap = fed.controller.describe()
    finally:
        fed.shutdown()
    assert snap["global_iteration"] >= 2
    assert len(snap["learners"]) == 2
    for learner in snap["learners"]:
        assert learner["live"] is True
        assert learner["straggler_score"] > 0
        assert learner["ewma_train_s"] > 0
        assert "divergence_score" in learner
    scores = sorted(l["straggler_score"] for l in snap["learners"])
    assert scores[0] <= 1.0 <= scores[-1] + 1e-9
    kinds = {e["kind"] for e in snap["events"]}
    assert {"learner_joined", "round_started", "task_dispatched",
            "task_completed", "aggregation_done", "round_health"} <= kinds
    assert snap["health"]["round"] >= 1
    assert snap["profile"]["rounds_profiled"] >= 2
    phases = snap["profile"]["phases"]
    assert set(phases) == {"dispatch", "wait_uplinks", "select",
                           "aggregate", "close"}
    text = telemetry.render_metrics()
    assert "learner_straggler_score{" in text
    assert "learner_divergence_score{" in text


def test_events_disabled_keeps_hot_paths_inert(journal):
    fed = _federation(rounds=1, events_enabled=False)
    try:
        fed.start()
        assert fed.wait_for_rounds(1, timeout_s=120)
        snap = fed.controller.describe()
    finally:
        fed.shutdown()
    assert snap["global_iteration"] >= 1
    assert snap["events"] == []
    assert tevents.tail() == []
    assert all(l["straggler_score"] > 0 for l in snap["learners"])


def test_describe_federation_over_grpc(journal):
    """A gRPC-served controller answers DescribeFederation with the event
    tail it is asked for, GetMetrics, ListMethods (with the JAX server's
    ``CollectTelemetry`` stub); the JAX client reads it too."""
    from metisfl_tpu.controller.service import ControllerClient as JaxClient
    from metisfl_tpu_torch.controller.core import Controller
    from metisfl_tpu_torch.controller.service import (ControllerClient,
                                                      ControllerServer)

    config = FederationConfig(
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=1))
    controller = Controller(config, proxy_factory=lambda record: None,
                            device="cpu")
    server = ControllerServer(controller, host="127.0.0.1", port=0)
    port = server.start()
    client, jax_client = (ControllerClient("127.0.0.1", port),
                          JaxClient("127.0.0.1", port))
    try:
        for i in range(3):
            controller.join(JoinRequest(hostname="h", port=7000 + i,
                                        num_train_examples=4))
        snap = client.describe_federation(event_tail=2, timeout=10.0)
        assert [e["kind"] for e in snap["events"]] == ["learner_joined"] * 2
        assert len(client.describe_federation(timeout=10.0)["events"]) == 3
        assert jax_client.describe_federation(
            event_tail=1, timeout=10.0)["events"][0]["kind"] == \
            "learner_joined"
        parsed = telemetry.parse_exposition(client.get_metrics())
        assert parsed["controller_active_learners"][()] == 3
        methods = {m["name"] for m in client.list_methods()["methods"]}
        assert {"GetMetrics", "DescribeFederation",
                "CollectTelemetry"} <= methods
    finally:
        client.close()
        jax_client.close()
        server.stop()
        controller.shutdown()


# --------------------------------------------------------------------- #
# checkpoints with the telemetry planes' state, across packages
# --------------------------------------------------------------------- #


class _NullProxy:
    def __init__(self, record):
        self.learner_id = record.learner_id

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass


def _ckpt_controller(kind, tmp_path, tag):
    common = dict(protocol="synchronous", budget=2)
    if kind == "torch":
        from metisfl_tpu_torch.config import CheckpointConfig
        from metisfl_tpu_torch.controller.core import Controller
        config = FederationConfig(
            protocol=common["protocol"],
            aggregation=AggregationConfig(rule="fedavg",
                                          scaler="participants"),
            train=TrainParams(batch_size=4, local_steps=1),
            eval=EvalConfig(every_n_rounds=0),
            checkpoint=CheckpointConfig(dir=str(tmp_path / tag)),
            telemetry=TelemetryConfig(cardinality_budget=common["budget"]))
        return Controller(config, proxy_factory=_NullProxy, device="cpu")
    from metisfl_tpu.comm.messages import TrainParams as JTrainParams
    from metisfl_tpu.config import (AggregationConfig as JAgg,
                                    CheckpointConfig as JCkpt,
                                    EvalConfig as JEval,
                                    FederationConfig as JFed,
                                    TelemetryConfig as JTel)
    from metisfl_tpu.controller.core import Controller as JController
    config = JFed(
        protocol=common["protocol"],
        aggregation=JAgg(rule="fedavg", scaler="participants"),
        train=JTrainParams(batch_size=4, local_steps=1),
        eval=JEval(every_n_rounds=0),
        checkpoint=JCkpt(dir=str(tmp_path / tag)),
        telemetry=JTel(cardinality_budget=common["budget"]))
    return JController(config, proxy_factory=_NullProxy)


def _round(ctrl, round_no):
    """One synchronous round of three crafted uplinks (learner 2 an
    outlier) through ``ctrl``."""
    if type(ctrl).__module__.startswith("metisfl_tpu_torch"):
        result_cls = TaskResult
    else:
        from metisfl_tpu.comm.messages import TaskResult as result_cls
    lids = sorted(ctrl.active_learners())
    with ctrl._lock:
        tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
    for i, lid in enumerate(lids):
        scale = 8.0 if i == 2 else 0.05
        model = {"enc/w": np.full((6, 4), scale * (1 + 0.01 * i),
                                  np.float32),
                 "head/w": np.full((4,), scale, np.float32)}
        assert ctrl.task_completed(result_cls(
            task_id=f"t{round_no}_{lid}", learner_id=lid,
            auth_token=tokens[lid], model=pack_model(model),
            round_id=round_no, completed_batches=1,
            train_metrics={"loss": 1.0 + i}))
    deadline = time.time() + 30
    while ctrl.global_iteration <= round_no and time.time() < deadline:
        time.sleep(0.02)
    assert ctrl.global_iteration > round_no


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_health_and_metric_budget_cross_packages(
        journal, tmp_path, writer):
    """A checkpoint with the ``health`` and ``metrics_budget`` keys, written
    by either package's controller, restores into the other's: the
    divergence scores and the collapsed families' sketches come back the
    writer's."""
    from metisfl_tpu import telemetry as jtel

    if writer == "jax":
        from metisfl_tpu.comm.messages import JoinRequest as JJoin
    reader = "jax" if writer == "torch" else "torch"
    jtel.registry().reset()
    ctrl = _ckpt_controller(writer, tmp_path, "w")
    try:
        join = JoinRequest if writer == "torch" else JJoin
        ctrl.set_community_model(pack_model({
            "enc/w": np.zeros((6, 4), np.float32),
            "head/w": np.zeros((4,), np.float32)}))
        for i in range(3):
            ctrl.join(join(hostname="h", port=7100 + i,
                           num_train_examples=10))
        _round(ctrl, 0)
        path = ctrl.save_checkpoint()
        scores = ctrl._health.scores()
    finally:
        ctrl.shutdown()
    from metisfl_tpu_torch.comm import loads
    with open(path, "rb") as f:
        state = loads(f.read())
    assert state["health"] and state["metrics_budget"]
    # each package restores the file; the reader of the other package
    # ends with the same scores, health state and metric sketches as the
    # writer's own package does
    restored = {}
    for kind in (reader, writer):
        telemetry.registry().reset()
        jtel.registry().reset()
        other = _ckpt_controller(kind, tmp_path, f"r_{kind}")
        try:
            assert other.restore_checkpoint(path)
            assert other._health.scores() == scores
            assert other._health.export_state() == state["health"]
            registry = (telemetry.registry() if kind == "torch"
                        else jtel.registry())
            restored[kind] = registry.budget_state()
            assert set(state["metrics_budget"]) <= set(restored[kind])
        finally:
            other.shutdown()
    jtel.registry().reset()
    assert restored[reader] == restored[writer]
