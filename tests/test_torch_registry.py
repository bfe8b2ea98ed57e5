"""The model registry in the port (registry/), held against the JAX
package's: versions, the eval-gated promotion, rollback, retention GC,
checkpointed lineage, the controller's registry surface over its RPC
handlers, and the serving gateway's registry sources and poller.

Each registry scenario runs on both packages' registries with the same
seeded blobs; after it both describe the same lineage (wall-clock stamps
aside). The JAX registry's gauges and events are the telemetry plane's
(ROADMAP.md Queue 1 item 4) and are not asserted.
"""

import time

import numpy as np
import pytest

from metisfl_tpu.config import PromotionConfig as JaxPromotionConfig
from metisfl_tpu.config import RegistryConfig as JaxRegistryConfig
from metisfl_tpu.registry import ModelRegistry as JaxModelRegistry
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.config import (
    AggregationConfig,
    CheckpointConfig,
    EvalConfig,
    FederationConfig,
    ModelStoreConfig,
    PromotionConfig,
    RegistryConfig,
    SecureAggConfig,
    ServingConfig,
)
from metisfl_tpu_torch.registry import (
    CHANNEL_CANDIDATE,
    CHANNEL_STABLE,
    ModelRegistry,
)
from metisfl_tpu_torch.tensor import pack_model


def _blob(seed=0):
    rng = np.random.default_rng(seed)
    return pack_model({"w": rng.standard_normal((3, 2)).astype(np.float32)})


def _pair(**promotion):
    """The port's and the JAX package's registry, retention 3."""
    port = ModelRegistry(RegistryConfig(
        enabled=True, retention=3, promotion=PromotionConfig(**promotion)),
        config_hash="cfg0")
    jax = JaxModelRegistry(JaxRegistryConfig(
        enabled=True, retention=3,
        promotion=JaxPromotionConfig(**promotion)), config_hash="cfg0")
    return port, jax


def _lineage(reg):
    desc = reg.describe()
    desc["versions"] = [{k: v for k, v in info.items() if k != "created_at"}
                        for info in desc["versions"]]
    return desc


def _both(scenario, **promotion):
    """Run ``scenario(reg)`` on both registries; the lineages and results
    must agree. Returns the port's registry and its result."""
    port, jax = _pair(**promotion)
    out = scenario(port)
    jax_out = scenario(jax)
    assert _lineage(port) == _lineage(jax)
    assert port.export_state()["blobs"] == jax.export_state()["blobs"]
    return port, out, jax_out


# ---------------------------------------------------------------------- #
# registration and the gate
# ---------------------------------------------------------------------- #

def test_register_mints_monotonic_versions_with_lineage():
    def scenario(reg):
        v1 = reg.register(0, _blob(0), {"anomalous": []})
        v2 = reg.register(1, _blob(1), {"anomalous": []})
        return v1.version, v2.version, v2.parent, v1.config_hash

    reg, out, jax_out = _both(scenario)
    assert out == jax_out == (1, 2, 0, "cfg0")
    assert reg.head(CHANNEL_CANDIDATE).version == 2
    assert reg.blob(1) == _blob(0)


def test_gate_accepts_clean_round_and_promotes_on_eval():
    def scenario(reg):
        reg.register(0, _blob(), {"anomalous": [],
                                  "divergence_score": {"L0": 0.2,
                                                       "L1": 0.3}})
        passed, reasons = reg.evaluate_gate(1)
        promoted = reg.note_eval(0, {"test/accuracy": 0.8,
                                     "test/loss": 0.5})
        return passed, reasons, promoted.version

    reg, (passed, reasons, promoted), jax_out = _both(scenario)
    assert not passed and any("eval" in r for r in reasons)
    assert (passed, reasons, promoted) == jax_out
    assert promoted == 1
    assert reg.head(CHANNEL_STABLE).version == 1
    assert reg.head(CHANNEL_CANDIDATE) is None


def test_gate_rejects_anomalous_round():
    def scenario(reg):
        reg.register(0, _blob(), {"anomalous": []})
        reg.note_eval(0, {"test/accuracy": 0.5})
        reg.register(1, _blob(1), {"anomalous": ["L2"]})
        refused = reg.note_eval(1, {"test/accuracy": 0.99})
        return refused, reg.evaluate_gate(2)

    reg, (refused, (passed, reasons)), jax_out = _both(scenario)
    assert refused is None and not passed
    assert any("anomalous" in r for r in reasons)
    assert reg.head(CHANNEL_STABLE).version == 1
    assert reg.info(2).gate["passed"] is False


def test_gate_rejects_eval_regression_past_min_delta():
    def scenario(reg):
        reg.register(0, _blob(), {})
        reg.note_eval(0, {"test/accuracy": 0.9})
        reg.register(1, _blob(1), {})
        refused = reg.note_eval(1, {"test/accuracy": 0.905})
        gate = reg.evaluate_gate(2)
        promoted = reg.note_eval(1, {"test/accuracy": 0.95})
        return refused, gate, promoted.version

    reg, (refused, (passed, reasons), promoted), jax_out = _both(
        scenario, min_delta=0.01)
    assert refused is None and not passed
    assert any("accuracy" in r for r in reasons)
    assert promoted == 2 and reg.head(CHANNEL_STABLE).version == 2
    assert reasons == jax_out[1][1]


def test_gate_loss_metric_improves_downward():
    def scenario(reg):
        reg.register(0, _blob(), {})
        reg.note_eval(0, {"test/loss": 0.4})
        reg.register(1, _blob(1), {})
        worse = reg.note_eval(1, {"test/loss": 0.6})
        better = reg.note_eval(1, {"test/loss": 0.3})
        return worse, better.version

    _, out, jax_out = _both(scenario, metric="test/loss")
    assert out == jax_out == (None, 2)


def test_gate_bounds_divergence_quantile():
    """Nearest-rank quantile: with 10 scores p90 is the 9th smallest, so
    one outlier above it is tolerated and two are not."""
    two_high = {f"L{i}": 0.1 for i in range(8)} | {"L8": 5.0, "L9": 6.0}
    one_high = {f"L{i}": 0.1 for i in range(9)} | {"L9": 5.0}

    def refused(reg):
        reg.register(0, _blob(), {"anomalous": [],
                                  "divergence_score": two_high})
        return reg.evaluate_gate(1)

    _, (passed, reasons), jax_out = _both(refused, max_divergence=1.0,
                                          divergence_quantile=0.9)
    assert not passed and any("divergence" in r for r in reasons)
    assert (passed, reasons) == jax_out

    def tolerated(scores):
        def scenario(reg):
            reg.register(0, _blob(), {"anomalous": [],
                                      "divergence_score": scores})
            reg.note_eval(0, {"test/accuracy": 0.5})
            return reg.head(CHANNEL_STABLE) is not None
        return scenario

    assert _both(tolerated(one_high), max_divergence=1.0,
                 divergence_quantile=0.9)[1]
    assert _both(tolerated(two_high), max_divergence=1.0,
                 divergence_quantile=0.5)[1]


def test_operator_force_promote_bypasses_gate():
    def scenario(reg):
        reg.register(0, _blob(), {"anomalous": ["L0"]})
        with pytest.raises(ValueError):
            reg.promote(1)
        info = reg.promote(1, force=True)
        return info.channel, info.gate["forced"]

    _, out, jax_out = _both(scenario)
    assert out == jax_out == (CHANNEL_STABLE, True)


def test_rollback_restores_prior_stable():
    def scenario(reg):
        reg.register(0, _blob(0), {})
        reg.note_eval(0, {"test/accuracy": 0.5})
        reg.register(1, _blob(1), {})
        reg.note_eval(1, {"test/accuracy": 0.9})
        stable = reg.head(CHANNEL_STABLE).version
        restored = reg.rollback().version
        return stable, restored, reg.rollback()

    reg, out, jax_out = _both(scenario)
    assert out == jax_out == (2, 1, None)
    assert reg.head(CHANNEL_STABLE).version == 1


def test_retention_gc_erases_blobs():
    def scenario(reg):
        for r in range(8):
            reg.register(r, _blob(r), {})
        return [v.version for v in reg.versions()]

    reg, kept, jax_kept = _both(scenario)
    assert kept == jax_kept
    # retention 3 retired versions and the candidate head
    assert len(kept) <= 4, kept
    assert reg.head(CHANNEL_CANDIDATE).version == 8
    assert reg.blob(1) is None
    assert reg.blob(8) == _blob(7)


def test_gc_never_retires_channel_heads_or_rollback_target():
    def scenario(reg):
        reg.register(0, _blob(0), {})
        reg.note_eval(0, {"test/accuracy": 0.1})
        reg.register(1, _blob(1), {})
        reg.note_eval(1, {"test/accuracy": 0.9})   # stable 2, previous 1
        for r in range(2, 12):
            reg.register(r, _blob(r), {})
        return {v.version for v in reg.versions()}

    reg, versions, jax_versions = _both(scenario)
    assert versions == jax_versions and {1, 2} <= versions
    assert reg.blob(2) is not None
    assert reg.rollback().version == 1


@pytest.mark.parametrize("direction", ["port", "jax->port", "port->jax"])
def test_export_restore_roundtrip_preserves_lineage(direction):
    """The lineage round-trips through export_state, also across
    packages."""
    port, jax = _pair()
    source = jax if direction == "jax->port" else port
    source.register(0, _blob(0), {"anomalous": []})
    source.note_eval(0, {"test/accuracy": 0.7})
    source.register(1, _blob(1), {})
    state = source.export_state()
    target = (JaxModelRegistry(JaxRegistryConfig(enabled=True, retention=3))
              if direction == "port->jax" else
              ModelRegistry(RegistryConfig(enabled=True, retention=3)))
    target.restore_state(state)
    assert target.head(CHANNEL_STABLE).version == 1
    assert target.head(CHANNEL_CANDIDATE).version == 2
    assert target.blob(2) == _blob(1)
    assert target.info(1).eval_metrics == {"test/accuracy": 0.7}
    assert _lineage(target) == _lineage(source)
    assert target.register(2, _blob(2), {}).version == 3


# ---------------------------------------------------------------------- #
# the controller's wiring
# ---------------------------------------------------------------------- #

class _NullProxy:
    def __init__(self, record):
        pass

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass


def _controller(tmp_path, tag, registry_enabled=True):
    from metisfl_tpu_torch.controller import Controller

    config = FederationConfig(
        protocol="asynchronous",
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0),
        registry=RegistryConfig(enabled=registry_enabled, retention=3),
        model_store=ModelStoreConfig(store="in_memory"),
        checkpoint=CheckpointConfig(dir=str(tmp_path / f"ckpt_{tag}"),
                                    every_n_rounds=1))
    return Controller(config, _NullProxy, device="cpu")


def _model(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 2)).astype(np.float32)}


def _wait(predicate, timeout_s=20.0, msg="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _run_rounds(ctrl, n, start=0):
    reply = ctrl.join(JoinRequest(hostname="h", port=7100,
                                  num_train_examples=4))
    for i in range(start, start + n):
        assert ctrl.task_completed(TaskResult(
            task_id=f"t{i}", learner_id=reply.learner_id,
            auth_token=reply.auth_token, model=pack_model(_model(i)),
            completed_batches=1))
        _wait(lambda i=i: ctrl.global_iteration > i, msg=f"round {i + 1}")
    return reply


def test_controller_registers_each_round_into_lineage(tmp_path):
    ctrl = _controller(tmp_path, "lin")
    try:
        ctrl.set_community_model(pack_model(_model()))
        _run_rounds(ctrl, 3)
        _wait(lambda: len(ctrl.round_metadata) >= 3, msg="metadata")
        desc = ctrl.describe_registry()
        assert desc["enabled"] and desc["candidate"] == 3
        assert [m.registered_version for m in ctrl.round_metadata] == \
            [1, 2, 3]
        assert ctrl.registered_model(channel="candidate") == \
            ctrl.community_model_bytes()
        assert ctrl.describe()["registry"]["candidate"] == 3
    finally:
        ctrl.shutdown()


def test_registry_lineage_survives_kill_and_resume(tmp_path):
    """The checkpoint carries the channel heads, the version metadata and
    the blobs; the restored incarnation serves the same stable head and
    mints monotone ids."""
    ctrl = _controller(tmp_path, "fo")
    ctrl.set_community_model(pack_model(_model()))
    _run_rounds(ctrl, 2)
    ctrl.promote_version(1, force=True)
    stable_blob = ctrl.registered_model(channel="stable")
    ctrl.shutdown()
    ctrl.save_checkpoint()

    ctrl2 = _controller(tmp_path, "fo")
    try:
        assert ctrl2.restore_checkpoint()
        assert ctrl2.describe_registry()["stable"] == 1
        assert ctrl2.registered_model(channel="stable") == stable_blob
        _run_rounds(ctrl2, 1, start=2)
        _wait(lambda: ctrl2.describe_registry()["candidate"] == 3,
              msg="the registration after the restore")
        metas = [m.registered_version for m in ctrl2.round_metadata]
        assert metas[-1] == 3, metas
        assert ctrl2.round_metadata[-1].stable_version == 1
    finally:
        ctrl2.shutdown()


def test_disabled_registry_is_one_attribute_check(tmp_path, monkeypatch):
    def _boom(*a, **k):
        raise AssertionError("registry code ran on the disabled path")

    monkeypatch.setattr(ModelRegistry, "register", _boom)
    monkeypatch.setattr(ModelRegistry, "note_eval", _boom)
    ctrl = _controller(tmp_path, "off", registry_enabled=False)
    try:
        assert ctrl._registry is None
        ctrl.set_community_model(pack_model(_model()))
        _run_rounds(ctrl, 2)
        assert ctrl.describe_registry() == {"enabled": False}
        assert "registry" not in ctrl.describe()
        assert ctrl.registered_model(channel="stable") is None
        assert all(m.registered_version == 0 for m in ctrl.round_metadata)
        with pytest.raises(ValueError, match="not enabled"):
            ctrl.promote_version(1)
    finally:
        ctrl.shutdown()


def test_eval_digests_gate_promotion_only_once_all_landed(tmp_path):
    """The round's evaluation promotes its version only when every
    learner's digest landed: a fast learner's partial mean never does."""
    from metisfl_tpu_torch.controller import Controller

    pending = []

    class _EvalProxy(_NullProxy):
        def evaluate(self, task, callback):
            pending.append((task, callback))

    from metisfl_tpu_torch.comm import EvalResult
    config = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        eval=EvalConfig(every_n_rounds=1),
        registry=RegistryConfig(enabled=True))
    ctrl = Controller(config, _EvalProxy, device="cpu")
    try:
        ctrl.set_community_model(pack_model(_model()))
        replies = [ctrl.join(JoinRequest(hostname="h", port=7300 + i,
                                         num_train_examples=4))
                   for i in range(2)]
        for i, reply in enumerate(replies):
            assert ctrl.task_completed(TaskResult(
                task_id=f"t{i}", learner_id=reply.learner_id,
                auth_token=reply.auth_token, model=pack_model(_model(i)),
                completed_batches=1))
        _wait(lambda: len(pending) == 2, msg="the eval dispatch")
        task, callback = pending[0]
        callback(EvalResult(task_id=task.task_id, learner_id=task.learner_id,
                            round_id=task.round_id,
                            evaluations={"test": {"accuracy": 0.9}}))
        assert ctrl.describe_registry()["stable"] == 0
        task, callback = pending[1]
        callback(EvalResult(task_id=task.task_id, learner_id=task.learner_id,
                            round_id=task.round_id,
                            evaluations={"test": {"accuracy": 0.7}}))
        desc = ctrl.describe_registry()
        assert desc["stable"] == 1
        assert desc["versions"][0]["eval_metrics"] == {
            "test/accuracy": pytest.approx(0.8)}
    finally:
        ctrl.shutdown()


def test_registry_rpc_handlers(tmp_path):
    """The controller service's registry methods, through their handlers:
    a refused gate and a disabled registry answer ``ok`` false."""
    from metisfl_tpu_torch.controller.service import ControllerServer

    ctrl = _controller(tmp_path, "rpc")
    off = _controller(tmp_path, "rpc_off", registry_enabled=False)
    try:
        server = ControllerServer(ctrl)
        ctrl.set_community_model(pack_model(_model()))
        _run_rounds(ctrl, 2)
        desc = loads(server._describe_registry(b""))
        assert desc["candidate"] == 2 and len(desc["versions"]) == 2
        assert server._get_registered_model(dumps({"version": 1})) == \
            ctrl.registered_model(1)
        assert server._get_registered_model(
            dumps({"channel": "candidate"})) == ctrl.registered_model(2)
        assert server._get_registered_model(dumps({"version": 99})) == b""
        refused = loads(server._promote_version(dumps({"version": 2})))
        assert not refused["ok"] and "eval" in refused["error"]
        forced = loads(server._promote_version(dumps({"version": 1,
                                                      "force": True})))
        assert forced["ok"] and forced["version"]["channel"] == "stable"
        loads(server._promote_version(dumps({"version": 2, "force": True})))
        rolled = loads(server._rollback_version(b""))
        assert rolled["ok"] and rolled["version"]["version"] == 1
        assert not loads(server._rollback_version(b""))["ok"]
        off_server = ControllerServer(off)
        assert loads(off_server._describe_registry(b"")) == {
            "enabled": False}
        assert not loads(off_server._rollback_version(b""))["ok"]
        assert not loads(off_server._promote_version(
            dumps({"version": 1})))["ok"]
    finally:
        ctrl.shutdown()
        off.shutdown()


def test_config_validation():
    from metisfl_tpu.config import FederationConfig as JaxFederationConfig

    with pytest.raises(ValueError, match="retention"):
        FederationConfig(registry=RegistryConfig(enabled=True, retention=0))
    with pytest.raises(ValueError, match="divergence_quantile"):
        FederationConfig(registry=RegistryConfig(
            enabled=True, promotion=PromotionConfig(divergence_quantile=0.0)))
    # masking's settled output is the public plain aggregate; ciphertext
    # schemes are refused
    FederationConfig(
        aggregation=AggregationConfig(rule="secure_agg",
                                      scaler="participants"),
        secure=SecureAggConfig(enabled=True, scheme="masking"),
        registry=RegistryConfig(enabled=True))
    with pytest.raises(ValueError, match="use scheme: masking"):
        FederationConfig(
            aggregation=AggregationConfig(rule="secure_agg",
                                          scaler="participants"),
            secure=SecureAggConfig(enabled=True, scheme="ckks"),
            registry=RegistryConfig(enabled=True))
    # the same defaults as the JAX package's sections
    jax = JaxFederationConfig()
    port = FederationConfig()
    assert vars(port.registry.promotion) == vars(jax.registry.promotion)
    assert port.registry.retention == jax.registry.retention
    assert vars(port.failover) == vars(jax.failover)
    assert vars(port.checkpoint) == vars(jax.checkpoint)


# ---------------------------------------------------------------------- #
# the serving gateway's registry sources and poller
# ---------------------------------------------------------------------- #

def _gateway():
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP
    from metisfl_tpu_torch.serving import ServingGateway

    ops = TorchModelOps(MLP(2, (4,), 2), rng_seed=0, device="cpu")
    return ServingGateway(ops, ServingConfig(max_batch=2, max_wait_ms=1.0),
                          device="cpu"), ops


def _mlp_blob(ops, scale):
    from metisfl_tpu_torch.tensor.pytree import tree_map
    return pack_model(tree_map(
        lambda a: (np.asarray(a) * np.float32(scale)).astype(np.float32),
        ops.get_variables()))


def test_gateway_syncs_promoted_versions_from_a_controller(tmp_path):
    """``sync(DirectRegistrySource(ctrl))`` installs the stable head and
    the candidate, and hot-swaps stable when a new version is promoted;
    its Predict is the installed version's forward."""
    from metisfl_tpu_torch.serving import (
        CHANNEL_CANDIDATE as SERVE_CANDIDATE,
    )
    from metisfl_tpu_torch.serving import (
        CHANNEL_STABLE as SERVE_STABLE,
    )
    from metisfl_tpu_torch.serving import DirectRegistrySource

    gateway, ops = _gateway()
    ctrl = _controller(tmp_path, "serve")
    try:
        ctrl.set_community_model(_mlp_blob(ops, 1.0))
        reply = ctrl.join(JoinRequest(hostname="h", port=7400,
                                      num_train_examples=4))
        for i, scale in enumerate((0.5, 2.0)):
            assert ctrl.task_completed(TaskResult(
                task_id=f"t{i}", learner_id=reply.learner_id,
                auth_token=reply.auth_token, model=_mlp_blob(ops, scale),
                completed_batches=1))
            _wait(lambda i=i: ctrl.global_iteration > i)
        source = DirectRegistrySource(ctrl)
        assert gateway.sync(source) == {SERVE_CANDIDATE: 2}
        ctrl.promote_version(1, force=True)
        assert gateway.sync(source) == {SERVE_STABLE: 1,
                                        SERVE_CANDIDATE: 2}
        ctrl.promote_version(2, force=True)
        assert gateway.sync(source) == {SERVE_STABLE: 2}
        x = np.random.default_rng(0).standard_normal((2, 2)).astype(
            np.float32)
        got, version, channel = gateway.predict(x)
        assert (version, channel) == (2, SERVE_STABLE)
        # the version's own forward, installed by hand in a second gateway
        direct, _ = _gateway()
        try:
            direct.install(SERVE_STABLE, 2, ctrl.registered_model(2))
            want, _, _ = direct.predict(x)
        finally:
            direct.shutdown()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        first, _ = _gateway()
        try:
            first.install(SERVE_STABLE, 1, ctrl.registered_model(1))
            assert not np.array_equal(np.asarray(first.predict(x)[0]),
                                      np.asarray(got))
        finally:
            first.shutdown()
    finally:
        gateway.shutdown()
        ctrl.shutdown()


def test_gateway_start_sync_polls_until_shutdown(tmp_path):
    """``start_sync`` polls a source on a thread, the first poll after its
    delay; a failing poll is retried, and shutdown stops the thread."""
    from metisfl_tpu_torch.serving import ControllerRegistrySource

    gateway, ops = _gateway()
    blob = _mlp_blob(ops, 1.0)
    polls = []

    class _Client:
        def describe_registry(self, timeout=None, wait_ready=True):
            polls.append(time.monotonic())
            if len(polls) == 1:
                raise RuntimeError("controller unreachable")
            return {"enabled": True, "stable": 4, "candidate": 0}

        def get_registered_model(self, version=0, channel="",
                                 timeout=None):
            assert version == 4
            return blob

    t0 = time.monotonic()
    gateway.start_sync(ControllerRegistrySource(_Client()),
                       poll_every_s=0.05, initial_delay_s=0.2)
    try:
        _wait(lambda: gateway.installed() == {"stable": 4}, timeout_s=10)
        assert polls[0] - t0 >= 0.2
        assert len(polls) >= 2
        assert gateway._last_sync_error == ""
    finally:
        gateway.shutdown()
    assert not gateway._sync_thread.is_alive()
    n = len(polls)
    time.sleep(0.2)
    assert len(polls) == n
