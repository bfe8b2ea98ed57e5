"""The controller's hot standby in the port: the durable-write helper, the
round-state WAL (byte for byte the JAX package's files), the standby's
config, the two-endpoint redial, a dead incarnation's completions, the
driver's supervision paths, JAX-package learner processes re-attaching to
the port's promoted standby, and one CPU run of the controller-kill gate
(``python -m metisfl_tpu_torch.driver.crossdevice --controller-smoke``).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

from metisfl_tpu.comm.codec import dumps as jax_dumps
from metisfl_tpu.controller.wal import RoundStateLog as JaxRoundStateLog
from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.config import (
    AggregationConfig,
    CommConfig,
    ControllerConfig,
    ControllerStandbyConfig,
    EvalConfig,
    FederationConfig,
    RegistryConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.controller.wal import (
    JOIN,
    LEAVE,
    SNAPSHOT,
    RoundStateLog,
)
from metisfl_tpu_torch.store import durable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------- #
# the shared atomic-rename-then-ack helper (store/durable.py)
# ---------------------------------------------------------------------- #

def test_sanitize_id_hostile_ids_never_collide():
    from metisfl_tpu.store import durable as jax_durable

    assert durable.sanitize_id("L3_host-9.example_50051") == \
        "L3_host-9.example_50051"
    a = durable.sanitize_id("a/b")
    b = durable.sanitize_id("a\\b")
    assert a != b
    assert a != "a_b" and b != "a_b"
    assert "/" not in a and "\\" not in b
    evil = durable.sanitize_id("../../etc/passwd")
    assert os.path.basename(evil) == evil
    # the JAX package names the same files
    for ident in ("L0_h_1", "a/b", "a\\b", "../../etc/passwd", "ü ö"):
        assert durable.sanitize_id(ident) == jax_durable.sanitize_id(ident)


def test_atomic_write_replaces_whole_file_and_cleans_temp(tmp_path):
    path = str(tmp_path / "rec")
    durable.atomic_write(path, b"one", prefix=".wal_")
    durable.atomic_write(path, b"two", prefix=".wal_")
    with open(path, "rb") as f:
        assert f.read() == b"two"
    assert [n for n in os.listdir(tmp_path) if n != "rec"] == []


def test_read_tolerant_swallows_torn_records(tmp_path):
    path = str(tmp_path / "torn")
    with open(path, "wb") as f:
        f.write(b"\x00garbage-not-codec")
    assert durable.read_tolerant(path, loads) is None
    assert durable.read_tolerant(str(tmp_path / "missing")) is None
    durable.atomic_write(path, dumps({"ok": 1}))
    assert durable.read_tolerant(path, loads) == {"ok": 1}


# ---------------------------------------------------------------------- #
# the WAL: append, snapshot compaction, replay, merge
# ---------------------------------------------------------------------- #

def _join_delta(lid, **extra):
    d = {"learner_id": lid, "hostname": "localhost", "port": 1}
    d.update(extra)
    return d


def test_wal_replay_merges_snapshot_with_later_deltas(tmp_path):
    wal = RoundStateLog(str(tmp_path))
    wal.append(JOIN, _join_delta("L0"))      # before the snapshot: subsumed
    snap_seq = wal.snapshot({"global_iteration": 2, "community_blob": b"m",
                             "learners": [_join_delta("L0")],
                             "round_metadata": [],
                             "community_evaluations": []})
    wal.append(JOIN, _join_delta("L1"))
    wal.append(LEAVE, {"learner_id": "L0"})
    seqs = sorted(int(n.split(".")[0]) for n in os.listdir(tmp_path))
    assert seqs[0] == snap_seq
    state, deltas = wal.replay()
    assert state["global_iteration"] == 2
    assert [d["kind"] for d in deltas] == [JOIN, LEAVE]
    merged = RoundStateLog.merge(state, deltas)
    assert [e["learner_id"] for e in merged["learners"]] == ["L1"]
    assert merged["community_blob"] == b"m"
    assert wal.poll() == snap_seq + 2
    # a new log on the same directory goes on with the sequence
    assert RoundStateLog(str(tmp_path)).append(JOIN, _join_delta("L2")) \
        == snap_seq + 3


def test_wal_replay_skips_torn_records(tmp_path):
    wal = RoundStateLog(str(tmp_path))
    wal.snapshot({"global_iteration": 1, "learners": [],
                  "community_blob": b"x", "round_metadata": [],
                  "community_evaluations": []})
    wal.append(JOIN, _join_delta("L1"))
    with open(tmp_path / f"{wal.poll() + 1:010d}.{JOIN}.rec", "wb") as f:
        f.write(b"\x00torn")
    state, deltas = wal.replay()
    assert state["global_iteration"] == 1
    assert [d["data"]["learner_id"] for d in deltas] == ["L1"]


def test_wal_merge_without_snapshot_builds_registry_only_state(tmp_path):
    wal = RoundStateLog(str(tmp_path))
    assert RoundStateLog.merge(*wal.replay()) is None
    wal.append(JOIN, _join_delta("L0"))
    wal.append(JOIN, _join_delta("L1"))
    wal.append(LEAVE, {"learner_id": "L0"})
    merged = RoundStateLog.merge(*wal.replay())
    assert merged["global_iteration"] == 0
    assert merged["community_blob"] == b""
    assert [e["learner_id"] for e in merged["learners"]] == ["L1"]


def _records():
    rng = np.random.default_rng(5)
    blob = rng.standard_normal(64).astype(np.float32).tobytes()
    return [
        (JOIN, _join_delta("L0", auth_token="t0", party_index=0)),
        (JOIN, _join_delta("L1_h_9", ms_per_step=12.5)),
        (SNAPSHOT, {"global_iteration": 3, "community_blob": blob,
                    "learners": [_join_delta("L0"), _join_delta("L1_h_9")],
                    "round_metadata": [{"global_iteration": 2,
                                        "scales": {"L0": 0.5}}],
                    "community_evaluations": []}),
        (LEAVE, {"learner_id": "L0"}),
        (JOIN, _join_delta("we/ird id")),
    ]


def test_wal_files_are_byte_equal_to_the_jax_package(tmp_path):
    """The same records through both packages' logs: the same file names,
    the same bytes, and each package replays the other's directory."""
    dirs = {}
    for name, cls in (("port", RoundStateLog), ("jax", JaxRoundStateLog)):
        wal = cls(str(tmp_path / name))
        for kind, data in _records():
            if kind == SNAPSHOT:
                wal.snapshot(data)
            else:
                wal.append(kind, data)
        dirs[name] = str(tmp_path / name)
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert len(names) == 3  # the snapshot compacted the two joins
    for name in names:
        with open(os.path.join(dirs["port"], name), "rb") as f:
            port_bytes = f.read()
        with open(os.path.join(dirs["jax"], name), "rb") as f:
            assert f.read() == port_bytes
    # the codec envelope is the JAX package's encoding of the record
    seq, kind = int(names[0].split(".")[0]), names[0].split(".")[1]
    with open(os.path.join(dirs["port"], names[0]), "rb") as f:
        assert f.read() == jax_dumps({"seq": seq, "kind": kind,
                                      "data": _records()[2][1]})
    # each package replays the other's directory to the same state
    port_view = RoundStateLog.merge(*RoundStateLog(dirs["jax"]).replay())
    jax_view = JaxRoundStateLog.merge(*JaxRoundStateLog(dirs["port"])
                                      .replay())
    assert port_view == jax_view
    assert [e["learner_id"] for e in port_view["learners"]] == [
        "L1_h_9", "we/ird id"]


# ---------------------------------------------------------------------- #
# the config: defaults and validation, pinned to the shipped template
# ---------------------------------------------------------------------- #

def test_standby_config_defaults_pinned():
    from metisfl_tpu.config import ControllerStandbyConfig as JaxStandby
    from metisfl_tpu_torch.config import load_config

    sb = ControllerStandbyConfig()
    assert (sb.enabled, sb.host, sb.port, sb.wal_dir) == \
        (False, "localhost", 0, "")
    assert (sb.stale_after_s, sb.probe_interval_s, sb.probe_failures) == \
        (3.0, 0.5, 3)
    assert vars(sb) == vars(JaxStandby())
    template = os.path.join(REPO, "examples", "config", "template.yaml")
    assert load_config(template).controller.standby == sb


def test_standby_config_validation():
    with pytest.raises(ValueError):
        FederationConfig(controller=ControllerConfig(
            standby=ControllerStandbyConfig(enabled=False,
                                            wal_dir="/tmp/x")))
    for bad in (dict(stale_after_s=0.0), dict(probe_interval_s=-1.0),
                dict(probe_failures=0), dict(port=-1)):
        with pytest.raises(ValueError):
            FederationConfig(controller=ControllerConfig(
                standby=ControllerStandbyConfig(enabled=True, **bad)))
    FederationConfig(controller=ControllerConfig(
        standby=ControllerStandbyConfig(enabled=True)))
    from metisfl_tpu_torch.config import FailoverConfig
    with pytest.raises(ValueError, match="max_controller_restarts"):
        FederationConfig(failover=FailoverConfig(max_controller_restarts=-1))


# ---------------------------------------------------------------------- #
# the two-endpoint redial
# ---------------------------------------------------------------------- #

class _FakeControllerService:
    """A real RpcServer with the two controller methods the redial tests
    drive, counting what each server took."""

    def __init__(self, tag):
        from metisfl_tpu_torch.comm.health import SERVING, HealthServicer
        from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
        from metisfl_tpu_torch.controller.service import CONTROLLER_SERVICE

        self.tag = tag
        self.completed = []
        self.registry_polls = 0
        self._health = HealthServicer()
        self._health.set_status(CONTROLLER_SERVICE, SERVING)
        self._server = RpcServer("localhost", 0)
        self._server.add_service(self._health.service())
        self._server.add_service(BytesService(CONTROLLER_SERVICE, {
            "MarkTaskCompleted": self._mark,
            "DescribeRegistry": self._registry,
        }, role="controller"))
        self.port = self._server.start()

    def _mark(self, raw):
        from metisfl_tpu_torch.comm import TaskResult
        self.completed.append(TaskResult.from_wire(raw).task_id)
        return dumps({"ok": True})

    def _registry(self, raw):
        self.registry_polls += 1
        return dumps({"enabled": True, "server": self.tag,
                      "channels": {}, "versions": []})

    def stop(self):
        self._server.stop()


def _fast_comm():
    return CommConfig(default_deadline_s=5.0, retries=3, retry_sleep_s=0.05)


def _result(task_id):
    from metisfl_tpu_torch.comm import TaskResult
    return TaskResult(task_id=task_id, learner_id="L0", auth_token="t",
                      model=b"blob")


def test_learner_client_redials_to_promoted_standby_without_drop():
    """An uplink acked by the primary is never re-sent; the one in flight
    when the primary dies re-resolves to the promoted endpoint and lands
    there exactly once."""
    from metisfl_tpu_torch.controller.service import ControllerClient

    primary = _FakeControllerService("primary")
    standby = _FakeControllerService("standby")
    try:
        client = ControllerClient("localhost", primary.port,
                                  comm=_fast_comm(),
                                  standby=("localhost", standby.port))
        assert client.task_completed(_result("t1"))
        assert primary.completed == ["t1"]
        assert client.endpoint() == ("localhost", primary.port)
        primary.stop()
        t0 = time.monotonic()
        assert client.task_completed(_result("t2"))
        elapsed = time.monotonic() - t0
        assert standby.completed == ["t2"]
        assert primary.completed == ["t1"]
        assert client.endpoint() == ("localhost", standby.port)
        comm = _fast_comm()
        budget = (comm.retries * comm.retry_sleep_s * 4
                  + comm.default_deadline_s * 2 + 10.0)
        assert elapsed < budget, elapsed
        assert client.task_completed(_result("t3"))
        assert standby.completed == ["t2", "t3"]
    finally:
        primary.stop()
        standby.stop()


def test_serving_poller_client_redials_to_promoted_standby():
    """The gateway's registry source holds the same two-endpoint client:
    a poll that dies with the primary lands on the promoted controller."""
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.serving import ControllerRegistrySource

    primary = _FakeControllerService("primary")
    standby = _FakeControllerService("standby")
    try:
        client = ControllerClient("localhost", primary.port,
                                  comm=_fast_comm(),
                                  standby=("localhost", standby.port))
        source = ControllerRegistrySource(client)
        assert source.describe()["server"] == "primary"
        primary.stop()
        assert source.describe()["server"] == "standby"
        assert standby.registry_polls == 1
        assert client.endpoint() == ("localhost", standby.port)
    finally:
        primary.stop()
        standby.stop()


def test_client_without_standby_keeps_failing_fast():
    import grpc

    from metisfl_tpu_torch.controller.service import ControllerClient

    primary = _FakeControllerService("primary")
    client = ControllerClient("localhost", primary.port, comm=_fast_comm())
    assert client.task_completed(_result("t1"))
    primary.stop()
    with pytest.raises(grpc.RpcError):
        client.task_completed(_result("t2"))


def test_concurrent_failed_callers_share_one_redial():
    from metisfl_tpu_torch.controller.service import ControllerClient

    primary = _FakeControllerService("primary")
    standby = _FakeControllerService("standby")
    try:
        client = ControllerClient("localhost", primary.port,
                                  comm=_fast_comm(),
                                  standby=("localhost", standby.port))
        assert client.task_completed(_result("t0"))
        primary.stop()
        errors = []

        def uplink(i):
            try:
                client.task_completed(_result(f"c{i}"))
            except Exception as exc:  # noqa: BLE001 - recorded
                errors.append(exc)

        threads = [threading.Thread(target=uplink, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors, errors
        assert sorted(standby.completed) == ["c0", "c1", "c2", "c3"]
    finally:
        primary.stop()
        standby.stop()


# ---------------------------------------------------------------------- #
# a dead incarnation's completion is kept, never advances a barrier
# ---------------------------------------------------------------------- #

def test_completion_from_dead_incarnation_is_stale():
    from metisfl_tpu_torch.comm import JoinRequest, TaskResult
    from metisfl_tpu_torch.controller import Controller
    from metisfl_tpu_torch.tensor import pack_model

    class _NopProxy:
        def run_task(self, task):
            pass

        def evaluate(self, task, callback):
            pass

    config = FederationConfig(
        aggregation=AggregationConfig(rule="fedavg", scaler="participants"),
        eval=EvalConfig(every_n_rounds=0))
    ctrl = Controller(config, lambda record: _NopProxy(), device="cpu")
    try:
        replies = [ctrl.join(JoinRequest(hostname="h", port=6000 + i,
                                         num_train_examples=10))
                   for i in range(2)]
        ctrl._pool.submit(lambda: None).result(timeout=30)
        model = {"w": np.ones((2, 2), np.float32)}
        ctrl.set_community_model(pack_model(model))

        def submit(i, epoch, tag):
            assert ctrl.task_completed(TaskResult(
                task_id=f"{tag}_{i}", learner_id=replies[i].learner_id,
                auth_token=replies[i].auth_token, model=pack_model(model),
                controller_epoch=epoch, num_train_examples=10,
                completed_batches=1))

        def wait_round(target):
            t0 = time.time()
            while ctrl.global_iteration < target:
                assert time.time() - t0 < 30.0, (target,
                                                 ctrl.global_iteration)
                time.sleep(0.01)

        for i in range(2):
            submit(i, "dead-incarnation-epoch", "old")
        ctrl._pool.submit(lambda: None).result(timeout=30)
        assert ctrl.global_iteration == 0
        for i in range(2):
            submit(i, ctrl.controller_epoch, "cur")
        wait_round(1)
        for i in range(2):
            submit(i, "", "bare")
        wait_round(2)
    finally:
        ctrl.shutdown()


# ---------------------------------------------------------------------- #
# the driver's supervision paths
# ---------------------------------------------------------------------- #

class _DeadProcess:
    def __init__(self, code):
        self._code = code

    def poll(self):
        return self._code


class _FakeProc:
    def __init__(self, name, code, log_path):
        self.name = name
        self.process = _DeadProcess(code)
        self.log_path = log_path


def _session(tmp_path, standby_enabled):
    from metisfl_tpu_torch.driver.session import DriverSession

    config = FederationConfig(controller=ControllerConfig(
        standby=ControllerStandbyConfig(enabled=standby_enabled)))
    return DriverSession(config, {"w": np.zeros((1,), np.float32)},
                         [], workdir=str(tmp_path), device="cpu")


def _dead(tmp_path, name, code=1):
    log = tmp_path / f"{name}.log"
    log.write_text(f"{name} died\n")
    return _FakeProc(name, code, str(log))


def test_check_procs_alive_fails_fast_without_standby(tmp_path):
    session = _session(tmp_path, standby_enabled=False)
    session._procs.append(_dead(tmp_path, "controller"))
    with pytest.raises(RuntimeError, match="controller exited"):
        session._check_procs_alive()


def test_check_procs_alive_defers_to_failover_with_standby(tmp_path):
    """With a standby, a controller or standby death is a failover the
    supervision handles; any other death still fails fast."""
    session = _session(tmp_path, standby_enabled=True)
    session._procs.append(_dead(tmp_path, "controller"))
    session._procs.append(_dead(tmp_path, "standby"))
    session._check_procs_alive()
    session._procs.append(_dead(tmp_path, "learner_0"))
    with pytest.raises(RuntimeError, match="learner_0 exited"):
        session._check_procs_alive()


def test_failover_to_standby_double_fault_fails_fast(tmp_path):
    session = _session(tmp_path, standby_enabled=True)
    ctrl = _dead(tmp_path, "controller")
    session._procs.append(ctrl)
    session._procs.append(_dead(tmp_path, "standby"))
    with pytest.raises(RuntimeError, match="double fault"):
        session._failover_to_standby(ctrl)
    session2 = _session(tmp_path, standby_enabled=True)
    session2._standby_promoted = True
    session2._procs.append(ctrl)
    with pytest.raises(RuntimeError, match="double fault"):
        session2._failover_to_standby(ctrl)


def test_supervision_budget_is_bounded(tmp_path):
    """Without a standby, a controller death past the restart budget fails
    the run with its log; with the supervision off it is left to the
    liveness check."""
    from metisfl_tpu_torch.config import FailoverConfig
    from metisfl_tpu_torch.driver.session import DriverSession

    session = DriverSession(
        FederationConfig(failover=FailoverConfig(max_controller_restarts=0)),
        {"w": np.zeros((1,), np.float32)}, [], workdir=str(tmp_path),
        device="cpu")
    session._procs.append(_dead(tmp_path, "controller"))
    with pytest.raises(RuntimeError, match="restart budget"):
        session._supervise_controller()
    off = DriverSession(
        FederationConfig(failover=FailoverConfig(supervise_controller=False)),
        {"w": np.zeros((1,), np.float32)}, [], workdir=str(tmp_path),
        device="cpu")
    off._procs.append(_dead(tmp_path, "controller"))
    assert not off._supervise_controller()


# ---------------------------------------------------------------------- #
# a mixed fleet: JAX-package learner processes follow the port's standby
# ---------------------------------------------------------------------- #

def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


def _jax_recipe(x, y, seed, gate):
    def recipe():
        import os
        import time

        from metisfl_tpu.models import FlaxModelOps
        from metisfl_tpu.models.dataset import ArrayDataset
        from metisfl_tpu.models.zoo import MLP

        ops = FlaxModelOps(MLP(features=(8,), num_outputs=2), x[:2],
                           rng_seed=0)
        train = ops.train

        def gated(dataset, params, *args, **kwargs):
            deadline = time.time() + 90
            while not os.path.exists(gate) and time.time() < deadline:
                time.sleep(0.05)
            return train(dataset, params, *args, **kwargs)

        ops.train = gated
        return ops, ArrayDataset(x, y, seed=seed)

    return recipe


def _spawn(args, log_path):
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, *args], stdout=log,
                                stderr=subprocess.STDOUT, env=_env(),
                                cwd=REPO)


def _wait_log(proc, log_path, pattern, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with open(log_path) as f:
            found = re.search(pattern, f.read())
        if found:
            return found
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(log_path) as f:
        raise AssertionError(
            f"{pattern!r} never appeared:\n{f.read()[-3000:]}")


def test_jax_learners_reattach_to_the_promoted_port_standby(tmp_path):
    """A port controller process with a warm port standby, two JAX-package
    learner processes holding both endpoints. The chaos injector kills the
    primary at its first uplink; the standby promotes from the WAL, the
    JAX learners re-attach to it as themselves and the rounds complete."""
    from metisfl_tpu_torch.chaos import ENV_VAR
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.driver.session import _free_port
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP
    from metisfl_tpu_torch.tensor import pack_model

    rounds = 2
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    port, standby_port = _free_port(), _free_port()
    config = FederationConfig(
        controller_port=port,
        aggregation=AggregationConfig(scaler="participants"),
        eval=EvalConfig(every_n_rounds=0),
        registry=RegistryConfig(enabled=True, retention=16),
        termination=TerminationConfig(federation_rounds=rounds),
        controller=ControllerConfig(standby=ControllerStandbyConfig(
            enabled=True, port=standby_port,
            wal_dir=str(tmp_path / "wal"), stale_after_s=1.5,
            probe_interval_s=0.25, probe_failures=2)))
    cfg_path = tmp_path / "federation_config.bin"
    cfg_path.write_bytes(config.to_wire())
    gate = str(tmp_path / "gate")
    procs = []
    client = None
    kill = {ENV_VAR: json.dumps({"seed": 7, "rules": [
        {"process": "controller", "side": "server", "fault": "kill",
         "method": "MarkTaskCompleted", "max_fires": 1}]})}
    try:
        with open(tmp_path / "controller.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "metisfl_tpu_torch.controller",
                 "--config", str(cfg_path), "--port", str(port),
                 "--device", "cpu"], stdout=log, stderr=subprocess.STDOUT,
                env={**_env(), **kill}, cwd=REPO))
        procs.append(_spawn(["-m", "metisfl_tpu_torch.controller",
                             "--config", str(cfg_path), "--port",
                             str(standby_port), "--device", "cpu",
                             "--standby"], str(tmp_path / "standby.log")))
        _wait_log(procs[0], str(tmp_path / "controller.log"),
                  r"CONTROLLER_READY")
        _wait_log(procs[1], str(tmp_path / "standby.log"),
                  r"STANDBY_READY")
        client = ControllerClient("localhost", port, comm=_fast_comm(),
                                  standby=("localhost", standby_port))
        template = TorchModelOps(MLP(4, (8,), 2), rng_seed=0,
                                 device="cpu").get_variables()
        assert client.replace_community_model(pack_model(template))
        for i in range(2):
            x = rng.standard_normal((32, 4)).astype(np.float32)
            y = np.argmax(x @ w, -1).astype(np.int32)
            recipe_path = str(tmp_path / f"recipe_{i}.pkl")
            module = sys.modules[__name__]
            cloudpickle.register_pickle_by_value(module)
            try:
                with open(recipe_path, "wb") as f:
                    cloudpickle.dump(_jax_recipe(x, y, i, gate), f)
            finally:
                cloudpickle.unregister_pickle_by_value(module)
            procs.append(_spawn(
                ["-m", "metisfl_tpu.learner", "--controller-host",
                 "localhost", "--controller-port", str(port),
                 "--standby-host", "localhost",
                 "--standby-port", str(standby_port),
                 "--port", "0", "--advertise-host", "localhost",
                 "--recipe", recipe_path],
                str(tmp_path / f"learner_{i}.log")))
        deadline = time.time() + 120
        while time.time() < deadline:
            if len(client.list_learners()) == 2:
                break
            time.sleep(0.1)
        ids = sorted(ep["learner_id"] for ep in client.list_learners())
        assert len(ids) == 2
        open(gate, "w").close()
        # the primary dies at the first uplink; the standby promotes
        assert procs[0].wait(timeout=120) != 0
        _wait_log(procs[1], str(tmp_path / "standby.log"),
                  r"CONTROLLER_PROMOTED port=(\d+)")
        deadline = time.time() + 120
        stats = None
        while time.time() < deadline:
            try:
                stats = client.get_statistics()
                if stats["global_iteration"] >= rounds:
                    break
            except Exception:  # noqa: BLE001 - the handoff window
                pass
            time.sleep(0.2)
        assert stats and stats["global_iteration"] >= rounds, stats
        assert client.endpoint() == ("localhost", standby_port)
        # the JAX learners kept their ids: no ghost registration
        assert sorted(stats["learners"]) == ids
        assert client.describe_registry()["candidate"] >= rounds
        reattached = 0
        for i in range(2):
            with open(tmp_path / f"learner_{i}.log") as f:
                reattached += "re-attached to controller" in f.read()
        assert reattached >= 1
        for ep in client.list_learners():
            from metisfl_tpu_torch.comm.rpc import RpcClient
            from metisfl_tpu_torch.controller.service import LEARNER_SERVICE
            learner = RpcClient(ep["hostname"], ep["port"], LEARNER_SERVICE,
                                retries=0)
            learner.call("ShutDown", b"", timeout=10.0)
            learner.close()
        for proc in procs[2:]:
            assert proc.wait(timeout=60) == 0
        assert client.shutdown_controller()
        assert procs[1].wait(timeout=30) == 0
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)


# ---------------------------------------------------------------------- #
# the controller-kill gate, once on the CPU
# ---------------------------------------------------------------------- #

def test_controller_smoke_runs_on_the_cpu(tmp_path):
    """``--controller-smoke --device cpu``: the standby promotes in the
    kill run and never in the control, and every round-pinned version is
    the control's bits."""
    out = subprocess.run(
        [sys.executable, "-m", "metisfl_tpu_torch.driver.crossdevice",
         "--controller-smoke", "--device", "cpu", "--rounds", "2"],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=REPO)
    lines = [line for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    result = json.loads(lines[-1])
    assert result["ok"] and result["bit_identical"]
    assert result["kill"]["promoted"] and result["kill"]["promoted_logged"]
    assert not result["control"]["promoted"]
    assert len(result["kill"]["model_sha256"]) == 2
    assert all(code == 0 for code in
               result["control"]["exit_codes"].values())
