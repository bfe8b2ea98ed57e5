"""The port's round control against the JAX package's, controller by
controller.

Both packages' ``Controller`` run behind recording proxies (no learner
trains): every learner joins, and the test completes tasks in a fixed
order with the same numpy-seeded uplink blobs. After each step both
controllers hold the same state: the same round count, the same
``selected_learners``, ``scales`` and ``staleness`` per round, the same
community model bit for bit (both folds pinned to numpy), and the same
dispatched tasks (learner, round, local steps). Cohorts and replacements
come from the global ``random``, seeded the same before each package's
run. Covered: the buffered and plain asynchronous protocols under
staleness damping, the semi-synchronous step budgets, the quorum barrier
with over-provisioned dispatch (on the store path and on the streaming
tier, whose late uplink is dropped), a round deadline, the
``max_empty_redispatch`` halt and its resumption, the dispatch-retry
ladder with churn scoring and quarantine, and the defaults (round bits
unchanged by the scheduling plane). Deadlines are sub-second, and every
controller is shut down, which cancels its timers.
"""

import random
import threading
import time

import numpy as np
import pytest

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.comm.messages import JoinRequest as JaxJoinRequest
from metisfl_tpu.comm.messages import TaskResult as JaxTaskResult
from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
from metisfl_tpu.config import EvalConfig as JaxEvalConfig
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import TerminationConfig as JaxTerminationConfig
from metisfl_tpu.config.federation import \
    SchedulingConfig as JaxSchedulingConfig
from metisfl_tpu.controller.core import Controller as JaxController
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    SchedulingConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.controller import Controller
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy

SHAPES = {"dense/kernel": (6, 4), "dense/bias": (4,), "out/kernel": (4, 3)}


@pytest.fixture(autouse=True)
def numpy_fold():
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    yield
    jax_base._hostfold_lib, port_base._hostfold_lib = saved


def _tree(seed):
    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in SHAPES.items():
        scope, leaf = name.split("/")
        tree.setdefault(scope, {})[leaf] = rng.standard_normal(
            shape).astype(np.float32)
    return tree


def _configs(protocol="synchronous", deadline=0.0, sizes=None,
             scaler="train_dataset_size", streaming=False, **sched):
    """The same federation as the port's and the JAX package's config."""
    agg = dict(rule="fedavg", scaler=scaler, streaming=streaming,
               staleness_decay=sched.pop("staleness_decay", 0.0))
    top = dict(protocol=protocol, round_deadline_secs=deadline,
               semi_sync_lambda=sched.pop("semi_sync_lambda", 1.0),
               semi_sync_recompute_every_round=sched.pop(
                   "semi_sync_recompute_every_round", False),
               max_dispatch_failures=sched.pop("max_dispatch_failures", 3))
    train = dict(batch_size=8, local_steps=4, learning_rate=0.1)
    port = FederationConfig(
        aggregation=AggregationConfig(**agg),
        scheduling=SchedulingConfig(**sched),
        train=TrainParams(**train),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=0), **top)
    jax = JaxFederationConfig(
        aggregation=JaxAggregationConfig(**agg),
        scheduling=JaxSchedulingConfig(**sched),
        train=JaxTrainParams(**train),
        eval=JaxEvalConfig(every_n_rounds=0),
        termination=JaxTerminationConfig(federation_rounds=0), **top)
    return port, jax


class _Proxy:
    def __init__(self, harness, learner_id):
        self.harness, self.learner_id = harness, learner_id

    def run_task(self, task):
        self.harness.tasks.append(task)
        if self.learner_id in self.harness.unreachable:
            raise ConnectionError(f"{self.learner_id} is unreachable")

    def evaluate(self, task, callback):
        pass

    def shutdown(self):
        pass


class Harness:
    """One package's controller, its learners joined, driven by hand."""

    def __init__(self, package, config, sizes, seed=0, unreachable=()):
        self.package = package
        self.tasks = []
        self.unreachable = set()
        self._uplinks = 0
        factory = lambda record: _Proxy(self, record.learner_id)  # noqa
        random.seed(seed)
        if package == "port":
            self.ctrl = Controller(config, factory, device="cpu")
            request, self._result = JoinRequest, TaskResult
        else:
            self.ctrl = JaxController(config, factory)
            request, self._result = JaxJoinRequest, JaxTaskResult
        self.ctrl.set_community_model(pack_model(_tree(1)))
        self.ids, self.tokens = [], {}
        for i, n in enumerate(sizes):
            if i in unreachable:
                # learner ids are L<join index>_<host>_<port>
                self.unreachable.add(f"L{i}_h_{5000 + i}")
            reply = self.ctrl.join(request(hostname="h", port=5000 + i,
                                           num_train_examples=n))
            self.ids.append(reply.learner_id)
            self.tokens[reply.learner_id] = reply.auth_token
            self.settle()

    def settle(self):
        """Wait until the scheduling worker ran everything queued."""
        for _ in range(2):
            self.ctrl._pool.submit(lambda: None).result(timeout=30)

    def latest_task(self, i):
        lid = self.ids[i]
        return [t for t in self.tasks if t.learner_id == lid][-1]

    def complete(self, i, ms_per_step=10.0, task=None):
        """Learner ``i`` reports its latest task (or ``task``) with the
        next seeded uplink."""
        task = task or self.latest_task(i)
        self._uplinks += 1
        lid = self.ids[i]
        accepted = self.ctrl.task_completed(self._result(
            task_id=task.task_id, learner_id=lid,
            auth_token=self.tokens[lid],
            controller_epoch=task.controller_epoch,
            round_id=task.round_id,
            model=pack_model(_tree(100 + self._uplinks)),
            num_train_examples=0,
            completed_steps=task.params.local_steps,
            completed_batches=task.params.local_steps,
            processing_ms_per_step=ms_per_step))
        self.settle()
        return accepted

    def wait(self, predicate, timeout_s=10.0):
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if predicate():
                self.settle()
                return True
            time.sleep(0.01)
        return False

    def state(self):
        """What both packages must agree on."""
        stats = self.ctrl.get_statistics()
        rounds = [(list(m["selected_learners"]), dict(m["scales"]),
                   dict(m["staleness"]))
                  for m in stats["round_metadata"]]
        blob = ModelBlob.from_bytes(self.ctrl.community_model_bytes())
        community = [(n, to_numpy(t).dtype.str, to_numpy(t).tobytes())
                     for n, t in blob.tensors]
        tasks = [(t.learner_id, t.round_id, t.params.local_steps)
                 for t in self.tasks]
        return {"global_iteration": stats["global_iteration"],
                "rounds": rounds, "community": community, "tasks": tasks}

    def shutdown(self):
        self.ctrl.shutdown()


def _both(port_cfg, jax_cfg, sizes, script, seed=0, unreachable=()):
    """Run ``script(harness)`` against each package; returns the port's
    and the JAX package's states after every step the script yields."""
    out = {}
    for package, cfg in (("port", port_cfg), ("jax", jax_cfg)):
        h = Harness(package, cfg, sizes, seed=seed, unreachable=unreachable)
        try:
            out[package] = [h.state() for _ in script(h)]
        finally:
            h.shutdown()
    return out["port"], out["jax"]


def _assert_same(port, jax):
    assert len(port) == len(jax)
    for step, (a, b) in enumerate(zip(port, jax)):
        assert a == b, f"step {step}: {a} != {b}"


def test_buffered_async_with_staleness_decay_matches_the_jax_package():
    """buffer_size 2 over 3 learners; learner 2 reports late, so its
    uplink lands with staleness >= 1 and is damped by decay 0.5."""
    port_cfg, jax_cfg = _configs("asynchronous_buffered", buffer_size=2,
                                 staleness_decay=0.5)

    def script(h):
        yield h.complete(0)
        yield h.complete(1)          # fill 1: learners 0 and 1
        yield h.complete(0)
        yield h.complete(1)          # fill 2
        yield h.complete(2)          # round 0's task, two fills late
        yield h.complete(0)          # fill 3: learners 2 and 0
        yield h.complete(1)
        yield h.complete(2)          # fill 4

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    _assert_same(port, jax)
    last = port[-1]
    assert last["global_iteration"] == 4
    # fill 3: learner 2's round-0 uplink two fills late, learner 0's
    # task re-dispatched at its round-1 report, one fill late
    ids = [t[0] for t in port[0]["tasks"]]
    assert last["rounds"][2][2] == {ids[2]: 2.0, ids[0]: 1.0}


def test_async_releases_every_reporter_alone_like_the_jax_package():
    port_cfg, jax_cfg = _configs("asynchronous", staleness_decay=1.0)

    def script(h):
        for i in (0, 1, 0, 2, 1, 2):
            yield h.complete(i)

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    _assert_same(port, jax)
    assert port[-1]["global_iteration"] == 6


def test_semi_sync_budgets_match_the_jax_package():
    """Round 1's step budgets are ``recompute_steps`` on round 0's
    ms_per_step; with recompute_every_round they move again."""
    port_cfg, jax_cfg = _configs("semi_synchronous", semi_sync_lambda=1.0,
                                 semi_sync_recompute_every_round=True)
    speeds = {0: 5.0, 1: 20.0, 2: 40.0}

    def script(h):
        for r in range(3):
            for i in (2, 0, 1):
                yield h.complete(i, ms_per_step=speeds[i] * (1 + r))

    port, jax = _both(port_cfg, jax_cfg, [32, 64, 96], script)
    _assert_same(port, jax)
    steps = {t[0]: t[2] for t in port[-1]["tasks"] if t[1] == 1}
    # the slowest epoch: 96/8 steps x 40 ms; budgets = 480 ms / ms_per_step
    assert sorted(steps.values()) == [12, 24, 96]


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["store", "streaming"])
def test_quorum_with_overprovision_matches_the_jax_package(streaming):
    """quorum 2, overprovision 0.5 over 4 learners (3 dispatched a round):
    the first 2 reporters are the cohort, the straggler's task expires and
    its late uplink advances nothing (dropped on the stream)."""
    port_cfg, jax_cfg = _configs(quorum=2, overprovision=0.5,
                                 scaler="participants", streaming=streaming)

    def script(h):
        yield h.complete(0)
        yield h.complete(1)          # quorum: round 0 = {0, 1}
        late = h.latest_task(2)
        in_round = [h.ids.index(t.learner_id) for t in h.tasks
                    if t.round_id == 1]
        for i in in_round[:2]:
            yield h.complete(i)      # round 1
        yield h.complete(2, task=late)   # expired: kept, not scheduled
        for i in [h.ids.index(t.learner_id) for t in h.tasks
                  if t.round_id == 2][:2]:
            yield h.complete(i)

    port, jax = _both(port_cfg, jax_cfg, [8, 8, 8, 8], script, seed=3)
    _assert_same(port, jax)
    assert port[-1]["global_iteration"] == 3
    assert all(len(r[0]) == 2 for r in port[-1]["rounds"])


def test_round_deadline_matches_the_jax_package():
    """A 0.3 s deadline with learner 2 silent: the round goes on with the
    two reporters, then round 1 runs whole."""
    port_cfg, jax_cfg = _configs(deadline=0.3)

    def script(h):
        yield h.complete(0)
        yield h.complete(1)
        assert h.wait(lambda: h.ctrl.global_iteration == 1)
        yield None
        for i in (0, 1, 2):
            yield h.complete(i)

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    _assert_same(port, jax)
    assert [len(r[0]) for r in port[-1]["rounds"]] == [2, 3]


def test_max_empty_redispatch_halt_and_resume_match_the_jax_package():
    """Nobody reports for 2 deadlines: the round halts with a lineage
    error; a late uplink resumes dispatch with a fresh cohort."""
    port_cfg, jax_cfg = _configs(deadline=0.15, max_empty_redispatch=2)
    errors = {}

    def script(h):
        first = h.latest_task(0)
        assert h.wait(lambda: h.ctrl._halted_no_reporters)
        n_tasks = len(h.tasks)
        time.sleep(0.4)              # halted: nothing more goes out
        assert len(h.tasks) == n_tasks
        errors[h.package] = list(h.ctrl._current_meta.errors)
        yield None
        yield h.complete(0, task=first)  # evidence of life
        for i in (0, 1, 2):
            yield h.complete(i)

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    _assert_same(port, jax)
    assert port[-1]["global_iteration"] == 1
    assert any("round halted" in e for e in errors["port"])
    assert len(errors["port"]) == len(errors["jax"])


def test_dispatch_retry_ladder_matches_the_jax_package():
    """participation 0.4 over 5 learners (2 a round); learner 3's endpoint
    is dead. A failed dispatch counts against it and raises its churn
    score; after the backoff the retry drops it from the barrier and
    dispatches a replacement in its place; after max_dispatch_failures
    (3) it is no longer sampled."""
    port_cfg, jax_cfg = _configs(dispatch_retries=1, retry_backoff_s=0.05)
    for cfg in (port_cfg, jax_cfg):
        cfg.aggregation.participation_ratio = 0.4
    seen = {}

    def script(h):
        for _ in range(5):
            r = h.ctrl.global_iteration
            done = set()
            while h.ctrl.global_iteration == r:
                time.sleep(0.15)     # a retry's backoff fires
                h.settle()
                pending = [h.ids.index(t.learner_id) for t in h.tasks
                           if t.round_id == r
                           and h.ids.index(t.learner_id) not in done | {3}]
                if not pending:
                    break
                done.add(pending[0])
                yield h.complete(pending[0])
        seen[h.package] = (h.ctrl._churn.scores(),
                           h.ctrl._learners[h.ids[3]].dispatch_failures)

    port, jax = _both(port_cfg, jax_cfg, [8] * 5, script, seed=0,
                      unreachable=(3,))
    _assert_same(port, jax)
    assert seen["port"] == seen["jax"]
    churn, failures = seen["port"]
    dead = port[0]["tasks"][3][0]
    assert failures == 3 and churn[dead] > 0.6
    tasks = port[-1]["tasks"]
    # a round after round 0 that dispatched the dead learner also
    # dispatched a replacement: three tasks, two of them live
    retried = [r for r in range(1, port[-1]["global_iteration"])
               if any(t[0] == dead and t[1] == r for t in tasks)]
    assert retried
    for r in retried:
        assert len([t for t in tasks if t[1] == r]) == 3
        assert len(port[-1]["rounds"][r][0]) == 2
    assert max(retried) < port[-1]["global_iteration"] - 1


def test_quarantine_sits_a_flapping_learner_out_like_the_jax_package():
    """A rejoin is a flap: past quarantine_score the learner is left out
    of the next cohort (participation 0.5 over 4)."""
    port_cfg, jax_cfg = _configs(quarantine_score=0.25, quarantine_s=30.0)
    for cfg in (port_cfg, jax_cfg):
        cfg.aggregation.participation_ratio = 0.5
    described = {}

    def script(h):
        lid = h.ids[1]
        request = JoinRequest if h.package == "port" else JaxJoinRequest
        h.ctrl.join(request(hostname="h", port=5001, num_train_examples=8,
                            previous_id=lid, auth_token=h.tokens[lid]))
        h.settle()
        yield None
        for r in range(2):
            for i in dict.fromkeys(h.ids.index(t.learner_id) for t in h.tasks
                                   if t.round_id == r):
                yield h.complete(i)
        described[h.package] = h.ctrl.describe()["scheduling"]

    port, jax = _both(port_cfg, jax_cfg, [8, 8, 8, 8], script, seed=5)
    _assert_same(port, jax)
    assert described["port"] == described["jax"]
    assert described["port"]["quarantined"] == [port[0]["tasks"][1][0]]
    round1 = {t[0] for t in port[-1]["tasks"] if t[1] == 1}
    assert port[0]["tasks"][1][0] not in round1


def test_defaults_leave_the_synchronous_round_unchanged():
    """With the default scheduling settings a synchronous round's bits,
    scales and metadata equal the JAX package's, and no timer runs."""
    port_cfg, jax_cfg = _configs()

    def script(h):
        for r in range(2):
            for i in (1, 2, 0):
                yield h.complete(i)
        assert h.ctrl._deadline_timer is None and not h.ctrl._retry_timers

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    _assert_same(port, jax)
    assert port[-1]["rounds"][0][2] == {}


def test_shutdown_cancels_every_timer():
    port_cfg, _ = _configs(deadline=30.0, dispatch_retries=2,
                           retry_backoff_s=30.0)
    h = Harness("port", port_cfg, [8, 8], unreachable=(1,))
    h.ctrl._dispatch_train(h.ids)
    h.settle()
    timers = [h.ctrl._deadline_timer, *h.ctrl._retry_timers]
    assert timers[0] is not None and len(timers) >= 2
    h.shutdown()
    for timer in timers:
        timer.join(timeout=1.0)
        assert not timer.is_alive()
    assert not [t for t in threading.enumerate()
                if isinstance(t, threading.Timer) and t in timers]


def test_async_run_ends_after_federation_rounds_communities():
    """The port's controller makes no community past
    ``termination.federation_rounds`` (the JAX package's driver stops its
    run there): under the buffered protocol the uplinks of tasks still in
    flight at the last fill are kept, unscheduled. Its communities up to
    the limit are the JAX controller's bits."""
    port_cfg, jax_cfg = _configs("asynchronous_buffered", buffer_size=2)
    port_cfg.termination.federation_rounds = 2

    def script(h):
        for i in (0, 1, 2, 0, 1, 2, 0, 1):
            if h.package == "port" or h.ctrl.global_iteration < 2:
                yield h.complete(i)

    port, jax = _both(port_cfg, jax_cfg, [8, 16, 24], script)
    assert port[-1]["global_iteration"] == 2
    assert port[-1]["community"] == jax[-1]["community"]
    assert port[-1]["rounds"] == jax[-1]["rounds"]
