"""Controller failover in the port: checkpoints with the learner registry
and tokens, ``--resume``, the learner's re-attach, and a controller killed
mid-round under the driver's supervision, held against the JAX package.

The controller-level tests drive bare ``Controller``s of both packages
over recording proxies (no learner trains) with the same numpy-seeded
uplinks: a resumed community is bit for bit the uninterrupted one (FedRec
within 1e-6, as the JAX test states: its rehydrated sum adds in another
order), and both packages' checkpoints hold the same state and restore
into each other's controllers. The learner-level tests drive the port's
``Learner`` against a controller that forgets it. The process test kills
a controller with the seeded chaos injector and needs the driver's
relaunch with ``--resume`` to finish the run. A ``cuda`` test trains one
LlamaLite step twice from one blob and compares the uplink bytes: the
failover bit compares on the card rest on it.
"""

import os
import time

import numpy as np
import pytest

from metisfl_tpu_torch.comm import JoinReply, JoinRequest, TaskResult
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.comm.codec import loads
from metisfl_tpu_torch.config import (
    AggregationConfig,
    ChaosConfig,
    CheckpointConfig,
    EvalConfig,
    FailoverConfig,
    FederationConfig,
    ModelStoreConfig,
    RegistryConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.controller import Controller
from metisfl_tpu_torch.models import ArrayDataset
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy

RULES = ["fedavg", "fedrec", "fedadam", "scaffold", "fednova"]


@pytest.fixture(autouse=True)
def numpy_fold(request):
    """Both packages' numpy folds: the JAX package's native fold sums in
    another order than its numpy one. The JAX package is imported here
    and in the helpers, not at the top: the ``cuda`` test below runs on
    a GPU host that needs no JAX."""
    if request.node.get_closest_marker("cuda"):
        yield
        return
    from metisfl_tpu.aggregation import base as jax_base
    from metisfl_tpu_torch.aggregation import base as port_base

    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    yield
    jax_base._hostfold_lib, port_base._hostfold_lib = saved


def _wait(predicate, timeout_s=30.0, msg="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class _RecordingProxy:
    def __init__(self, record, sink):
        self._record = record
        self._sink = sink

    def run_task(self, task):
        if self._sink is not None:
            self._sink.append((self._record.learner_id, task))

    def evaluate(self, task, callback):
        pass

    def shutdown(self):
        pass


def _config_kwargs(tmp_path, tag, rule):
    return dict(
        protocol="asynchronous",
        aggregation=dict(rule=rule, scaler="participants"),
        train=dict(batch_size=4, local_steps=1),
        eval=dict(every_n_rounds=0),
        model_store=dict(store="disk", root=str(tmp_path / f"store_{tag}"),
                         lineage_length=2),
        checkpoint=dict(dir=str(tmp_path / f"ckpt_{tag}"), every_n_rounds=1))


def _harness(tmp_path, tag, rule="fedavg", dispatched=None, jax=False,
             registry=False):
    """A bare controller of either package, checkpointing into
    ``ckpt_<tag>`` over a disk store ``store_<tag>``."""
    kw = _config_kwargs(tmp_path, tag, rule)
    if jax:
        from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
        from metisfl_tpu.config import (
            AggregationConfig as JaxAggregationConfig,
            CheckpointConfig as JaxCheckpointConfig,
            EvalConfig as JaxEvalConfig,
            FederationConfig as JaxFederationConfig,
            ModelStoreConfig as JaxModelStoreConfig,
            RegistryConfig as JaxRegistryConfig,
        )
        from metisfl_tpu.controller.core import Controller as JaxController

        config = JaxFederationConfig(
            protocol=kw["protocol"],
            aggregation=JaxAggregationConfig(**kw["aggregation"]),
            train=JaxTrainParams(**kw["train"]),
            eval=JaxEvalConfig(**kw["eval"]),
            model_store=JaxModelStoreConfig(**kw["model_store"]),
            checkpoint=JaxCheckpointConfig(**kw["checkpoint"]),
            registry=JaxRegistryConfig(enabled=registry, retention=3))
        return JaxController(
            config, lambda record: _RecordingProxy(record, dispatched))
    config = FederationConfig(
        protocol=kw["protocol"],
        aggregation=AggregationConfig(**kw["aggregation"]),
        train=TrainParams(**kw["train"]),
        eval=EvalConfig(**kw["eval"]),
        model_store=ModelStoreConfig(**kw["model_store"]),
        checkpoint=CheckpointConfig(**kw["checkpoint"]),
        registry=RegistryConfig(enabled=registry, retention=3))
    return Controller(config, lambda record: _RecordingProxy(record,
                                                             dispatched),
                      device="cpu")


def _fake_model(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


def _msgs(ctrl):
    """The JoinRequest and TaskResult classes of ``ctrl``'s package."""
    if type(ctrl).__module__.startswith("metisfl_tpu."):
        from metisfl_tpu.comm.messages import JoinRequest as JaxJoinRequest
        from metisfl_tpu.comm.messages import TaskResult as JaxTaskResult
        return JaxJoinRequest, JaxTaskResult
    return JoinRequest, TaskResult


def _submit(ctrl, lid, token, model, rounds_before, rule="fedavg"):
    _, result_cls = _msgs(ctrl)
    kwargs = {}
    if rule == "scaffold":
        # a deterministic params-shaped control delta per round
        delta = {name: np.full_like(arr, 0.01 * (rounds_before + 1))
                 for name, arr in model.items()}
        kwargs["control_delta"] = pack_model(delta)
    assert ctrl.task_completed(result_cls(
        task_id=f"t{rounds_before}_{lid}", learner_id=lid, auth_token=token,
        model=pack_model(model), completed_batches=1 + rounds_before % 2,
        **kwargs))
    _wait(lambda: ctrl.global_iteration > rounds_before,
          msg=f"round {rounds_before + 1}")


def _join(ctrl, **kwargs):
    join_cls, _ = _msgs(ctrl)
    return ctrl.join(join_cls(**kwargs))


def _drain(ctrl):
    """Wait for the scheduling worker (queued checkpoint saves included)."""
    ctrl._pool.submit(lambda: None).result(timeout=30)


# ---------------------------------------------------------------------- #
# the checkpointed registry, tokens and epoch
# ---------------------------------------------------------------------- #

def test_checkpoint_restores_registry_tokens_and_party_indices(tmp_path):
    ctrl = _harness(tmp_path, "reg")
    ctrl.set_community_model(pack_model(_fake_model(0)))
    joins = [_join(ctrl, hostname="h", port=7000 + i,
                   num_train_examples=5 + i,
                   capabilities={"party_index": i})
             for i in range(3)]
    ctrl.save_checkpoint()
    epoch1 = ctrl.controller_epoch
    ctrl.shutdown()

    ctrl2 = _harness(tmp_path, "reg")
    try:
        assert ctrl2.restore_checkpoint()
        # a restart is a new incarnation: the learners see a new epoch
        assert ctrl2.controller_epoch != epoch1
        assert sorted(ctrl2.active_learners()) == sorted(
            j.learner_id for j in joins)
        reply = _join(ctrl2, hostname="h", port=7000,
                      previous_id=joins[0].learner_id,
                      auth_token=joins[0].auth_token)
        assert reply.rejoined and reply.learner_id == joins[0].learner_id
        assert reply.controller_epoch == ctrl2.controller_epoch
        with ctrl2._lock:
            assert ctrl2._learners[joins[1].learner_id].party_index == 1
            assert ctrl2._learners[joins[2].learner_id].num_train_examples \
                == 7
        # the checkpointed token is accepted without a re-attach
        assert ctrl2.task_completed(TaskResult(
            task_id="t", learner_id=joins[2].learner_id,
            auth_token=joins[2].auth_token,
            model=pack_model(_fake_model(1)), completed_batches=1))
    finally:
        ctrl2.shutdown()


def test_endpoint_rejoin_without_credentials_keeps_identity(tmp_path):
    """A learner that lost its credentials rejoins from its host:port: it
    keeps its id with a rotated token (the old one stops validating)."""
    ctrl = _harness(tmp_path, "ep")
    ctrl.set_community_model(pack_model(_fake_model(0)))
    first = _join(ctrl, hostname="h", port=7100, num_train_examples=5)
    again = _join(ctrl, hostname="h", port=7100, num_train_examples=9)
    try:
        assert again.rejoined
        assert again.learner_id == first.learner_id
        assert again.auth_token != first.auth_token
        assert len(ctrl.active_learners()) == 1
        assert not ctrl.task_completed(TaskResult(
            task_id="t", learner_id=first.learner_id,
            auth_token=first.auth_token, model=b""))
        assert ctrl.task_completed(TaskResult(
            task_id="t", learner_id=again.learner_id,
            auth_token=again.auth_token,
            model=pack_model(_fake_model(2)), completed_batches=1))
    finally:
        ctrl.shutdown()


def test_resume_round_redispatches_restored_cohort(tmp_path):
    """A restored controller re-dispatches the abandoned round to the
    checkpointed cohort, stamped with the new epoch."""
    ctrl = _harness(tmp_path, "resume")
    ctrl.set_community_model(pack_model(_fake_model(0)))
    joins = [_join(ctrl, hostname="h", port=7200 + i, num_train_examples=5)
             for i in range(2)]
    ckpt = os.path.join(ctrl.config.checkpoint.dir, "controller_ckpt.bin")
    _wait(lambda: os.path.exists(ckpt), msg="the join-time checkpoint")
    ctrl.shutdown()

    dispatched = []
    ctrl2 = _harness(tmp_path, "resume", dispatched=dispatched)
    try:
        assert ctrl2.restore_checkpoint()
        assert ctrl2.resume_round()
        _wait(lambda: len(dispatched) >= 2, msg="the resume dispatch")
        assert {lid for lid, _ in dispatched} == {j.learner_id for j in joins}
        for _, task in dispatched:
            assert task.controller_epoch == ctrl2.controller_epoch
            assert task.round_id == ctrl2.global_iteration
    finally:
        ctrl2.shutdown()


def test_seed_model_is_checkpointed_before_round_one(tmp_path):
    """A crash during round 1 (before any round's checkpoint) still
    restores the seeded model."""
    ctrl = _harness(tmp_path, "seed")
    seed = _fake_model(3)
    ctrl.set_community_model(pack_model(seed))
    ckpt = os.path.join(ctrl.config.checkpoint.dir, "controller_ckpt.bin")
    _wait(lambda: os.path.exists(ckpt), msg="the seed-time checkpoint")
    ctrl.shutdown()
    ctrl2 = _harness(tmp_path, "seed")
    try:
        assert ctrl2.restore_checkpoint()
        blob = ModelBlob.from_bytes(ctrl2.community_model_bytes())
        for name, arr in blob.tensors:
            np.testing.assert_array_equal(to_numpy(arr), seed[name])
    finally:
        ctrl2.shutdown()


def test_no_checkpoint_means_a_fresh_start(tmp_path):
    ctrl = _harness(tmp_path, "fresh")
    try:
        assert not ctrl.restore_checkpoint()
        assert ctrl.global_iteration == 0
        assert ctrl.community_model_bytes() is None
    finally:
        ctrl.shutdown()


# ---------------------------------------------------------------------- #
# a resumed run against the uninterrupted one, by rule, in both packages
# ---------------------------------------------------------------------- #

def _run_federation(tmp_path, rule, tag, crash_after_two, jax=False):
    seed = _fake_model(0)
    m0a, m1a, m0b = _fake_model(1), _fake_model(2), _fake_model(3)
    ctrl = _harness(tmp_path, tag, rule=rule, jax=jax)
    ctrl.set_community_model(pack_model(seed))
    joins = [_join(ctrl, hostname="h", port=5100 + i, num_train_examples=10)
             for i in range(2)]
    ids = [(j.learner_id, j.auth_token) for j in joins]
    _submit(ctrl, ids[0][0], ids[0][1], m0a, 0, rule)
    _submit(ctrl, ids[1][0], ids[1][1], m1a, 1, rule)
    if crash_after_two:
        ctrl.shutdown()  # the crash: only the checkpoint survives it
        ctrl = _harness(tmp_path, tag, rule=rule, jax=jax)
        assert ctrl.restore_checkpoint()
        assert ctrl.global_iteration == 2
        # endpoint rejoins without credentials: the same ids, no ghosts
        joins = [_join(ctrl, hostname="h", port=5100 + i,
                       num_train_examples=10) for i in range(2)]
        assert [j.learner_id for j in joins] == [lid for lid, _ in ids]
        assert all(j.rejoined for j in joins)
        ids = [(j.learner_id, j.auth_token) for j in joins]
    _submit(ctrl, ids[0][0], ids[0][1], m0b, 2, rule)
    blob = ctrl.community_model_bytes()
    with ctrl._lock:
        control = ctrl._pack_scaffold_c() if rule == "scaffold" else b""
    ctrl.shutdown()
    return blob, control


def _tensors(blob):
    return {name: np.asarray(to_numpy(t))
            for name, t in ModelBlob.from_bytes(blob).tensors}


@pytest.mark.parametrize("rule", RULES)
def test_checkpoint_resume_matches_uninterrupted(tmp_path, rule):
    """One round after a kill and a resume, the community model is the
    uninterrupted run's: FedAvg (no state), FedRec (rolling sums rebuilt
    from the store), FedAdam (the server moments), SCAFFOLD (with ``c``),
    FedNova (the model it steps from). The JAX package's resumed run gives
    the same bits."""
    expected_blob, expected_c = _run_federation(
        tmp_path, rule, f"{rule}_nocrash", False)
    resumed_blob, resumed_c = _run_federation(
        tmp_path, rule, f"{rule}_crash", True)
    jax_blob, jax_c = _run_federation(
        tmp_path, rule, f"{rule}_jax_crash", True, jax=True)
    if rule == "fedrec":
        # the rehydrated sum adds in another order than the incremental
        # build: compared numerically, as the JAX test does
        expected, resumed = _tensors(expected_blob), _tensors(resumed_blob)
        assert expected.keys() == resumed.keys()
        for name in expected:
            np.testing.assert_allclose(resumed[name], expected[name],
                                       atol=1e-6)
    else:
        assert resumed_blob == expected_blob
    # the same events through the JAX package's controller: the same bits
    assert jax_blob == resumed_blob
    assert resumed_c == expected_c == jax_c
    if rule == "scaffold":
        assert resumed_c  # c folded, survived the checkpoint


# ---------------------------------------------------------------------- #
# the checkpoint's state, across packages
# ---------------------------------------------------------------------- #

def _events(ctrl, rule):
    """Seed, three joins (one with a party index), two rounds, a leave."""
    ctrl.set_community_model(pack_model(_fake_model(0)))
    joins = [_join(ctrl, hostname="h", port=6100 + i,
                   num_train_examples=10 + i,
                   capabilities={"party_index": i} if i == 1 else {})
             for i in range(3)]
    _submit(ctrl, joins[0].learner_id, joins[0].auth_token,
            _fake_model(1), 0, rule)
    _submit(ctrl, joins[1].learner_id, joins[1].auth_token,
            _fake_model(2), 1, rule)
    assert ctrl.leave(joins[2].learner_id, joins[2].auth_token)
    _drain(ctrl)
    return joins


def _normalized(state):
    """A checkpoint state without what differs by construction: tokens
    (random per join), wall-clock stamps, per-call timings, the config
    hash (each package's config bytes), and the EWMAs (wall-clock)."""
    out = dict(state)
    out["learners"] = sorted(
        ({k: v for k, v in e.items()
          if k not in ("auth_token", "ms_per_step", "ewma_train_s",
                       "ewma_eval_s")} for e in state["learners"]),
        key=lambda e: e["learner_id"])
    out["round_metadata"] = [
        {k: m.get(k) for k in ("global_iteration", "selected_learners",
                               "scales", "staleness", "model_size",
                               "uplink_bytes", "registered_version",
                               "stable_version")}
        for m in state["round_metadata"]]
    if "registry" in out:
        reg = dict(out["registry"])
        reg["versions"] = [
            {k: v for k, v in info.items()
             if k not in ("created_at", "config_hash")}
            for info in reg["versions"]]
        out["registry"] = reg
    return out


@pytest.mark.parametrize("rule", ["fedavg", "fedadam", "scaffold"])
def test_both_controllers_checkpoint_the_same_state(tmp_path, rule):
    """The same events through both packages' controllers: the decoded
    checkpoints hold the same state (community blob, round counter, round
    lineage, learner registry, the rule's state, ``c``, the registry's
    lineage and blobs)."""
    states = []
    for jax in (False, True):
        ctrl = _harness(tmp_path, f"state_{rule}_{jax}", rule=rule, jax=jax,
                        registry=True)
        try:
            _events(ctrl, rule)
            path = ctrl.save_checkpoint()
            with open(path, "rb") as f:
                states.append(loads(f.read()))
        finally:
            ctrl.shutdown()
    port, jax = states
    assert set(port) == set(jax)
    # the health plane's state (scores, last uplink summaries, the latest
    # round snapshot) is the JAX controller's, bit for bit
    assert port["health"] == jax["health"]
    assert _normalized(port) == _normalized(jax)
    assert port["community_blob"] == jax["community_blob"]
    assert port["registry"]["blobs"] == jax["registry"]["blobs"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A controller ``--resume``s from the other package's checkpoint
    file: the same identities, tokens, party indices, round and
    community model, and the next round's bits are the writer's own."""
    rule = "fedadam"
    first = _harness(tmp_path, "x", rule=rule, jax=writer == "jax",
                     registry=True)
    joins = _events(first, rule)
    first.save_checkpoint()
    first.shutdown()
    # the writer's own resumed run, for the next round's bits
    own = _harness(tmp_path, "x", rule=rule, jax=writer == "jax",
                   registry=True)
    other = _harness(tmp_path, "x", rule=rule, jax=writer != "jax",
                     registry=True)
    try:
        for ctrl in (own, other):
            assert ctrl.restore_checkpoint()
            assert ctrl.global_iteration == 2
            with ctrl._lock:
                learners = {lid: (r.auth_token, r.party_index)
                            for lid, r in ctrl._learners.items()}
            assert learners == {
                j.learner_id: (j.auth_token, 1 if i == 1 else -1)
                for i, j in enumerate(joins[:2])}
            assert ctrl.describe_registry()["candidate"] == 2
        assert own.community_model_bytes() == other.community_model_bytes()
        blobs = []
        for ctrl in (own, other):
            reply = _join(ctrl, hostname="h", port=6100,
                          previous_id=joins[0].learner_id,
                          auth_token=joins[0].auth_token)
            assert reply.rejoined and reply.learner_id == joins[0].learner_id
            _submit(ctrl, joins[0].learner_id, joins[0].auth_token,
                    _fake_model(5), 2, rule)
            blobs.append(ctrl.community_model_bytes())
        assert blobs[0] == blobs[1]
    finally:
        own.shutdown()
        other.shutdown()


# ---------------------------------------------------------------------- #
# a rejoin's re-dispatch supersedes the task in flight
# ---------------------------------------------------------------------- #

def test_a_superseded_task_counts_for_no_round(tmp_path):
    """A learner that re-attaches while it trains gets the round again
    (the rejoin's re-dispatch); the result of the task that dispatch
    superseded is kept but advances no barrier. Counted, it would close
    the next round with a model of this one."""
    dispatched = []
    config = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        eval=EvalConfig(every_n_rounds=0))
    ctrl = Controller(config, lambda record: _RecordingProxy(record,
                                                             dispatched),
                      device="cpu")
    try:
        ctrl.set_community_model(pack_model(_fake_model(0)))
        a, b = (_join(ctrl, hostname="h", port=7500 + i,
                      num_train_examples=4) for i in range(2))
        _wait(lambda: len(dispatched) == 2, msg="round 0's tasks")
        first = {lid: task for lid, task in dispatched}
        again = _join(ctrl, hostname="h", port=7500,
                      previous_id=a.learner_id, auth_token=a.auth_token)
        assert again.rejoined
        _wait(lambda: len(dispatched) == 3, msg="the rejoin's re-dispatch")
        second = dispatched[-1][1]
        assert second.learner_id == a.learner_id

        def complete(reply, task, seed):
            assert ctrl.task_completed(TaskResult(
                task_id=task.task_id, learner_id=reply.learner_id,
                auth_token=reply.auth_token, round_id=task.round_id,
                controller_epoch=task.controller_epoch,
                model=pack_model(_fake_model(seed)), completed_batches=1))
            _drain(ctrl)

        complete(a, first[a.learner_id], 1)   # superseded: kept only
        complete(b, first[b.learner_id], 2)
        assert ctrl.global_iteration == 0
        complete(a, second, 3)
        _wait(lambda: ctrl.global_iteration == 1, msg="round 1")
        want = {n: (_fake_model(3)[n] + _fake_model(2)[n]) / 2
                for n in ("w", "b")}
        got = _tensors(ctrl.community_model_bytes())
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
    finally:
        ctrl.shutdown()


# ---------------------------------------------------------------------- #
# the shutdown and the deadline timer
# ---------------------------------------------------------------------- #

def test_no_deadline_timer_survives_shutdown():
    """A round task draining on the scheduling pool during shutdown() must
    not re-arm the straggler timer after shutdown's cancel."""
    cfg = FederationConfig(round_deadline_secs=300.0)
    ctrl = Controller(cfg, lambda record: None, device="cpu")
    ctrl._arm_round_deadline(restart=True)
    ctrl._pool.submit(ctrl._guard,
                      lambda: (time.sleep(0.2),
                               ctrl._arm_round_deadline(True)))
    ctrl.shutdown()
    _wait(lambda: (ctrl._deadline_timer is None
                   or not ctrl._deadline_timer.is_alive()),
          timeout_s=5, msg="the timer's death after shutdown")
    ctrl._arm_round_deadline(restart=True)
    assert (ctrl._deadline_timer is None
            or not ctrl._deadline_timer.is_alive())


# ---------------------------------------------------------------------- #
# the learner's re-attach
# ---------------------------------------------------------------------- #

class _AmnesiacController:
    """A controller proxy that forgets the learner when ``known`` turns
    False (a restart without the registry): completions are rejected
    until the learner joins again."""

    def __init__(self):
        self.joins = 0
        self.known = False
        self.completions = []
        self.epoch = "epoch-one"

    def join(self, request):
        self.joins += 1
        self.known = True
        return JoinReply(learner_id="L0", auth_token=f"tok{self.joins}",
                         rejoined=bool(request.previous_id),
                         controller_epoch=self.epoch)

    def leave(self, learner_id, auth_token):
        self.known = False
        return True

    def task_completed(self, result):
        if not self.known or result.auth_token != f"tok{self.joins}":
            return False
        self.completions.append(result)
        return True


def _bare_learner(ctrl):
    from metisfl_tpu_torch.learner.learner import Learner

    class _Ops:
        def get_variables(self):
            return {"w": np.zeros(2, np.float32)}

    x = np.zeros((4, 2), np.float32)
    learner = Learner(model_ops=_Ops(), controller=ctrl,
                      train_dataset=ArrayDataset(x, np.zeros(4, np.int32)))
    learner.reattach_retries = 3
    learner.reattach_backoff_s = 0.01
    return learner


def test_rejected_completion_reattaches_and_resubmits():
    ctrl = _AmnesiacController()
    learner = _bare_learner(ctrl)
    learner.join_federation()
    assert learner.controller_epoch == "epoch-one"
    joined = []
    learner.on_join = joined.append
    ctrl.known = False
    ctrl.epoch = "epoch-two"
    result = TaskResult(task_id="t1", learner_id=learner.learner_id,
                        auth_token=learner.auth_token, model=b"")
    assert learner._report_completion(result)
    assert ctrl.joins == 2                      # one re-attach join
    assert learner.controller_epoch == "epoch-two"
    assert len(ctrl.completions) == 1
    # the resubmit carries the refreshed credentials, and on_join saw them
    assert ctrl.completions[0].auth_token == learner.auth_token
    assert [r.auth_token for r in joined] == [learner.auth_token]


def test_epoch_mismatch_triggers_reattach():
    ctrl = _AmnesiacController()
    learner = _bare_learner(ctrl)
    learner.join_federation()
    ctrl.epoch = "epoch-two"                    # the controller restarted
    learner._check_controller_epoch("epoch-two")
    assert ctrl.joins == 2
    assert learner.controller_epoch == "epoch-two"
    learner._check_controller_epoch("epoch-two")
    assert ctrl.joins == 2
    # a task without an epoch (a producer of the old shape) changes nothing
    learner._check_controller_epoch("")
    assert ctrl.joins == 2


def test_deliberate_leave_never_reattaches():
    """A completion rejected, or undeliverable, after leave_federation
    never re-registers the learner."""
    ctrl = _AmnesiacController()
    learner = _bare_learner(ctrl)
    learner.join_federation()
    learner.leave_federation()
    result = TaskResult(task_id="t1", learner_id=learner.learner_id,
                        auth_token=learner.auth_token, model=b"")
    assert not learner._report_completion(result)
    assert ctrl.joins == 1

    def _boom(result):
        raise RuntimeError("controller unreachable")

    ctrl.task_completed = _boom
    assert not learner._report_completion(result)
    assert ctrl.joins == 1


def test_reattach_gives_up_after_its_retries():
    class _Gone(_AmnesiacController):
        def join(self, request):
            if self.joins >= 1:
                self.joins += 1
                raise RuntimeError("no controller")
            return super().join(request)

    ctrl = _Gone()
    learner = _bare_learner(ctrl)
    learner.join_federation()
    ctrl.known = False
    result = TaskResult(task_id="t1", learner_id=learner.learner_id,
                        auth_token=learner.auth_token, model=b"")
    assert not learner._report_completion(result)
    assert ctrl.joins == 1 + learner.reattach_retries


# ---------------------------------------------------------------------- #
# the acceptance test: a chaos-killed controller, a supervised relaunch
# ---------------------------------------------------------------------- #

def _mlp_recipe(x, y, seed):
    def recipe():
        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP

        ops = TorchModelOps(MLP(4, (8,), 2), rng_seed=0, device="cpu")
        return ops, ArrayDataset(x, y, seed=seed)

    return recipe


def test_controller_crash_failover_midround(tmp_path):
    """Two learner processes, synchronous rounds; the seeded chaos injector
    kills the controller at its first MarkTaskCompleted (mid-round, the
    uplinks in the air). The driver relaunches it with ``--resume``, the
    learners re-attach and keep their ids, and the run completes its
    rounds with a consistent lineage and monotone registry versions."""
    from metisfl_tpu_torch.driver.session import DriverSession, _free_port
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    recipes = []
    for seed in range(2):
        x = rng.standard_normal((32, 4)).astype(np.float32)
        recipes.append(_mlp_recipe(x, np.argmax(x @ w, -1).astype(np.int32),
                                   seed))
    template = TorchModelOps(MLP(4, (8,), 2), rng_seed=0,
                             device="cpu").get_variables()
    config = FederationConfig(
        controller_port=_free_port(),
        round_deadline_secs=45.0,  # a backstop if the kill strands a round
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        registry=RegistryConfig(enabled=True, retention=3),
        termination=TerminationConfig(federation_rounds=3,
                                      execution_cutoff_mins=6.0),
        failover=FailoverConfig(max_controller_restarts=2,
                                restart_backoff_s=0.5),
        chaos=ChaosConfig(enabled=True, seed=7, rules=[
            {"process": "controller", "side": "server", "fault": "kill",
             "method": "MarkTaskCompleted", "max_fires": 1}]),
    )
    session = DriverSession(config, template, recipes,
                            workdir=str(tmp_path), device="cpu")
    try:
        session.initialize_federation()
        ids_before = None
        session_ids = []

        def _ids():
            try:
                return sorted(ep["learner_id"]
                              for ep in session._client.list_learners(
                                  timeout=5.0))
            except Exception:  # noqa: BLE001 - between incarnations
                return None

        _wait(lambda: _ids() and len(_ids()) == 2, timeout_s=120,
              msg="both learners joined")
        ids_before = _ids()
        stats = session.monitor_federation(poll_every_s=0.5,
                                           eval_drain_timeout_s=0)
        session_ids = sorted(stats["learners"])
        assert stats["global_iteration"] >= 3, stats["global_iteration"]
        # exactly one supervised relaunch, with --resume
        assert session._controller_restarts == 1
        with open(os.path.join(str(tmp_path), "controller.log")) as f:
            log = f.read()
        assert "restored checkpoint" in log
        # no ghost registrations: the learners kept their ids
        assert session_ids == ids_before
        iters = [m["global_iteration"] for m in stats["round_metadata"]]
        assert iters == sorted(set(iters)), iters
        for meta in stats["round_metadata"]:
            selected = meta["selected_learners"]
            assert len(selected) == len(set(selected))
            assert set(meta["train_received_at"]) <= set(stats["learners"])
        # the registry's version ids are monotone across the relaunch
        versions = [m.get("registered_version", 0)
                    for m in stats["round_metadata"]]
        assert all(v > 0 for v in versions), versions
        assert versions == sorted(set(versions)), versions
        reg = session._client.describe_registry()
        assert reg["enabled"] and reg["candidate"] >= max(versions)
        assert session._client.get_registered_model(
            channel="candidate") not in (b"", None)
        # a learner saw the new epoch and re-attached (its log says so)
        logs = ""
        for idx in range(2):
            with open(os.path.join(str(tmp_path),
                                   f"learner_{idx}.log")) as f:
                logs += f.read()
        assert "re-attached to controller" in logs
    finally:
        session.shutdown_federation()
    assert all(code == 0 for code in session.process_exit_codes().values()), \
        session.process_exit_codes()


# ---------------------------------------------------------------------- #
# the card: one LlamaLite step twice from one blob gives the same bytes
# ---------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("model", ["llama", "cnn"])
def test_a_step_is_deterministic_on_the_card(model):
    """Two engines built from one blob, each trained on the same rows (a
    LlamaLite Adam step through K1-K3; CNN SGD steps through cuDNN's
    convolutions), ship the same uplink bytes: the resumed and promoted
    rounds of a failover are compared bit for bit on this."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite

    rng = np.random.default_rng(3)
    if model == "llama":
        def engine(variables=None):
            return TorchModelOps(LlamaLite(
                vocab_size=1024, dim=256, depth=2, heads=4, kv_heads=2,
                use_flash=True, dtype=torch.bfloat16, device="cuda"),
                variables=variables, rng_seed=0, device="cuda")

        tokens = rng.integers(0, 1024, (4, 129)).astype(np.int32)
        data = ArrayDataset(tokens[:, :-1], tokens[:, 1:], seed=0)
        params = TrainParams(batch_size=2, local_steps=1, optimizer="adam",
                             learning_rate=1e-3)
    else:
        def engine(variables=None):
            return TorchModelOps(FashionMnistCNN(dropout_rate=0.0),
                                 variables=variables, rng_seed=0,
                                 device="cuda")

        x = rng.standard_normal((64, 28, 28, 1)).astype(np.float32)
        data = ArrayDataset(x, rng.integers(0, 10, 64).astype(np.int32),
                            seed=0)
        params = TrainParams(batch_size=16, local_steps=4, optimizer="sgd",
                             learning_rate=0.05)
    blob = pack_model(engine().get_variables())
    out = []
    for _ in range(2):
        ops = engine(ModelBlob.from_bytes(blob).tensors)
        out.append(pack_model(ops.train(data, params).variables))
    assert out[0] == out[1]
