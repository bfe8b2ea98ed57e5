"""Churn scoring, the cross-device harness and partial masked cohorts:
the port against the JAX package.

- ``ChurnTracker``: the same event sequence under the same fake clock
  gives the same scores (bit for bit) and the same quarantine windows.
- ``driver/crossdevice.py``: the JAX package's acceptance scenarios
  (tests/test_churn.py ``TestCrossDeviceHarness``) through both
  packages' harnesses: the same number of rounds, the same cohort size
  (reporters) per round, every round at quorum, and each accuracy
  within that test's 0.2 of the other package's and of the no-churn
  control. Arrival order inside a round follows thread timing in both
  packages, so the models are compared through their accuracies, as the
  JAX test compares its churn and control runs.
- Partial masked cohorts (tests/test_churn.py ``TestSecurePartialCohort``
  on the port's controller): a straggler expired by a round deadline, on
  the store path and on the masked streaming tier, and a party that
  leaves mid-round, each settle through ``RecoverMasks`` with the two
  survivors; the community is within 1e-9 of their mean.
"""

import dataclasses
import time

import numpy as np
import pytest

from metisfl_tpu.driver.crossdevice import ChurnScenario as JaxScenario
from metisfl_tpu.driver.crossdevice import run_scenario as jax_run_scenario
from metisfl_tpu.selection import ChurnTracker as JaxChurnTracker
from metisfl_tpu_torch.comm import JoinRequest, TaskResult
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    SecureAggConfig,
)
from metisfl_tpu_torch.controller import Controller
from metisfl_tpu_torch.driver.crossdevice import ChurnScenario, run_scenario
from metisfl_tpu_torch.secure import MaskingBackend
from metisfl_tpu_torch.selection import ChurnTracker
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.spec import DType, TensorKind, TensorSpec

# the JAX acceptance test's accuracy tolerance
ACCURACY_TOL = 0.2


# -- ChurnTracker ---------------------------------------------------------

EVENTS = ("leave", "flap_rejoin", "dispatch_failure", "completion")


@pytest.mark.parametrize("alpha,threshold", [(0.3, 0.0), (0.3, 0.5),
                                             (0.7, 0.6), (1.0, 0.9)])
def test_churn_scores_and_quarantine_windows_match_the_jax_package(
        alpha, threshold):
    rng = np.random.default_rng(int(alpha * 10) + int(threshold * 10))
    port = ChurnTracker(alpha=alpha, quarantine_score=threshold,
                        quarantine_s=2.5, max_entries=16)
    jax = JaxChurnTracker(alpha=alpha, quarantine_score=threshold,
                          quarantine_s=2.5, max_entries=16)
    now = 1000.0
    for step in range(400):
        now += float(rng.uniform(0.0, 0.7))
        lid = f"L{int(rng.integers(0, 24))}"
        event = EVENTS[int(rng.integers(0, len(EVENTS)))]
        assert port.note(lid, event, now=now) == jax.note(lid, event,
                                                          now=now)
        assert port.quarantined(lid, now=now) == jax.quarantined(lid,
                                                                 now=now)
        if step % 17 == 0:
            assert port.quarantined_ids(now) == jax.quarantined_ids(now)
        assert port.scores() == jax.scores()
    assert port._quarantined_until == jax._quarantined_until


def test_churn_score_saturates_and_decays():
    tracker = ChurnTracker(alpha=0.5, quarantine_score=0.7, quarantine_s=1.0)
    assert tracker.note("a", "leave", now=0.0) == 0.5
    assert tracker.note("a", "flap_rejoin", now=0.1) == 0.75
    assert tracker.quarantined("a", now=0.5)
    assert not tracker.quarantined("a", now=1.2)  # the window ran out
    assert tracker.note("a", "completion", now=2.0) == 0.375
    assert tracker.quarantined_ids(now=2.0) == []


# -- the cross-device harness ----------------------------------------------

SCENARIOS = {
    # tests/test_churn.py test_churn_federation_converges_at_quorum
    "quorum_1024": dict(seed=7, clients=1024, rounds=5, quorum=12,
                        overprovision=1.0, dropout=0.3, flappers=1,
                        partitioned=1, timeout_s=120.0),
    # tests/test_churn.py test_buffered_async_harness_mode
    "buffered_256": dict(seed=11, clients=256, rounds=4, buffer_size=8,
                         dropout=0.2, flappers=0, partitioned=0,
                         timeout_s=90.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_crossdevice_harness_matches_the_jax_package(name):
    kwargs = SCENARIOS[name]
    port = run_scenario(ChurnScenario(**kwargs))
    jax = jax_run_scenario(JaxScenario(**kwargs))
    assert port["ok"] and jax["ok"], (port, jax)
    assert port["rounds_completed"] >= kwargs["rounds"]
    assert not port["halted"]
    rounds = kwargs["rounds"]
    assert (port["reporters_per_round"][:rounds]
            == jax["reporters_per_round"][:rounds])
    assert abs(port["accuracy"] - jax["accuracy"]) <= ACCURACY_TOL
    assert port["protocol"] == jax["protocol"]
    if "quorum" in kwargs:
        # every round completed at quorum; the named faults fired
        assert all(r >= kwargs["quorum"]
                   for r in port["reporters_per_round"][:rounds])
        assert port["faults"]["dropped"] > 0
        assert port["faults"]["flapped"] >= 1
        assert port["faults"]["partitioned"] >= 1
        assert port["rss_growth_kb"] < (256 << 10)
        control = run_scenario(dataclasses.replace(
            ChurnScenario(**kwargs), dropout=0.0, flappers=0,
            partitioned=0))
        assert control["ok"]
        assert abs(port["accuracy"] - control["accuracy"]) <= ACCURACY_TOL
        assert port["accuracy"] > 0.6


# -- partial masked cohorts --------------------------------------------------

class _MaskProxy:
    def __init__(self, backend):
        self._backend = backend

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass

    def recover_masks(self, round_id, surviving, dropped, lengths):
        return self._backend.recovery_correction(round_id, surviving,
                                                 dropped, lengths)


def _masked_controller(n=3, streaming=False, **cfg_kwargs):
    backends = [MaskingBackend(federation_secret="fed", party_index=i,
                               num_parties=n) for i in range(n)]
    by_port = {6000 + i: backends[i] for i in range(n)}
    ctrl = Controller(
        FederationConfig(
            aggregation=AggregationConfig(rule="secure_agg",
                                          scaler="participants",
                                          streaming=streaming),
            secure=SecureAggConfig(enabled=True, scheme="masking",
                                   num_parties=n),
            eval=EvalConfig(every_n_rounds=0), **cfg_kwargs),
        lambda record: _MaskProxy(by_port[record.port]), device="cpu",
        secure_backend=MaskingBackend(num_parties=n))
    ids = []
    for i in range(n):
        reply = ctrl.join(JoinRequest(hostname="h", port=6000 + i,
                                      num_train_examples=10,
                                      capabilities={"party_index": i}))
        ids.append((reply.learner_id, reply.auth_token))
    ctrl._pool.submit(lambda: None).result(timeout=30)
    rng = np.random.default_rng(0)
    ctrl.set_community_model(pack_model(
        {"w": rng.standard_normal((2, 2)).astype(np.float32)}))
    return ctrl, ids, backends


def _masked_result(ctrl, backend, lid, token, vec):
    task_id = next(tid for tid, owner in ctrl._tasks_in_flight.items()
                   if owner == lid)
    backend.begin_round(0)
    payload = backend.encrypt(np.asarray(vec, np.float64).ravel())
    spec = TensorSpec(np.asarray(vec).shape, DType.F32,
                      TensorKind.CIPHERTEXT)
    return TaskResult(task_id=task_id, learner_id=lid, auth_token=token,
                      model=ModelBlob(opaque={"w": (payload,
                                                    spec)}).to_bytes(),
                      round_id=0, num_train_examples=10,
                      completed_batches=1)


def _wait(predicate, timeout_s=30.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("trigger,streaming", [
    ("deadline", False), ("deadline", True), ("leave", False),
    ("leave", True)])
def test_partial_masked_cohort_settles_through_recover_masks(trigger,
                                                             streaming):
    kwargs = {"round_deadline_secs": 0.5} if trigger == "deadline" else {}
    ctrl, ids, backends = _masked_controller(streaming=streaming, **kwargs)
    asked = []
    for lid, _ in ids:
        proxy = ctrl._learners[lid].proxy
        recover = proxy.recover_masks

        def spy(*args, _recover=recover, _lid=lid):
            asked.append((_lid, list(args[1]), list(args[2])))
            return _recover(*args)

        proxy.recover_masks = spy
    try:
        assert ctrl.resume_round()
        assert _wait(lambda: len(ctrl._tasks_in_flight) == 3)
        vecs = [np.full(4, float(i + 1)) for i in range(3)]
        for i in (0, 1):
            assert ctrl.task_completed(_masked_result(
                ctrl, backends[i], ids[i][0], ids[i][1], vecs[i]))
        ctrl._pool.submit(lambda: None).result(timeout=30)
        assert ctrl.global_iteration == 0
        if trigger == "leave":
            assert ctrl.leave(*ids[2])
        # party 2 never reports: the deadline (or its leave) releases
        # the round with the two survivors
        assert _wait(lambda: ctrl.global_iteration >= 1)
        meta = ctrl.get_runtime_metadata()[0]
        assert sorted(meta["selected_learners"]) == sorted(
            lid for lid, _ in ids[:2])
        assert not any("aggregation failed" in e for e in meta["errors"])
        assert asked and list(asked[0][1:]) == [[0, 1], [2]]
        payload, _ = ModelBlob.from_bytes(
            ctrl.community_model_bytes()).opaque["w"]
        np.testing.assert_allclose(
            MaskingBackend(num_parties=3).decrypt(payload, 4),
            (vecs[0] + vecs[1]) / 2.0, atol=1e-9)
    finally:
        ctrl.shutdown()
