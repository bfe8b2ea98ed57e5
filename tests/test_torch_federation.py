"""The port's synchronous FedAvg federation against the JAX package's.

The same config and the same numpy-seeded shards (the setup of
tests/test_federation_inprocess.py: 3 MLP learners, participants scaler,
batch 16, 4 SGD steps at lr 0.1) run through both packages'
``InProcessFederation``; the port's learners use
``TorchModelOps(..., device="cpu")``. Every community model is read from
the train tasks that carry it, so nothing races the live federation.
Learner training is held until every learner has joined, on both sides,
so round 0's cohort is the whole federation in both. The port's
controller dispatches nothing after ``termination.federation_rounds``
rounds, so its last community model is read from the controller.

Mixed cohorts (a JAX learner in the port's federation and a port learner
in the JAX package's) complete rounds, and each community model equals
the FedAvg of the blobs its cohort shipped. Most tests pin both
packages' host folds to numpy (``_hostfold_lib = False``); their twins
``..._on_the_native_fold`` run both native folds (``native/hostfold.cc``,
built with g++ at first use). Either way the two folds are bit-identical
(test_torch_aggregation). The cached-disk case runs both federations on
``model_store.store: cached_disk`` with ``ingest_workers: 2``.
"""

import os
import threading

import ml_dtypes
import numpy as np
import pytest

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.config import ModelStoreConfig as JaxModelStoreConfig
from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
from metisfl_tpu.config import EvalConfig as JaxEvalConfig
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import TerminationConfig as JaxTerminationConfig
from metisfl_tpu.driver import InProcessFederation as JaxFederation
from metisfl_tpu.learner.learner import Learner as JaxLearner
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
from metisfl_tpu.models.zoo import MLP as JaxMLP
from metisfl_tpu_torch.aggregation import FedAvg
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.comm import TaskResult, TrainParams, TrainTask
from metisfl_tpu_torch.config import (
    AggregationConfig,
    CheckpointConfig,
    EvalConfig,
    FederationConfig,
    ModelStoreConfig,
    SchedulingConfig,
    TerminationConfig,
    TreeAggregationConfig,
)
from metisfl_tpu_torch.driver import InProcessFederation
from metisfl_tpu_torch.learner import Learner
from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP, FashionMnistCNN
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy

ROUNDS = 3
# community weights of the two federations after every round, max abs:
# both run the same f32 SGD steps and the same numpy fold; measured at
# most 3e-8 (the engines' matmuls differ in summation order)
COMMUNITY_ATOL = 1e-5


def _pin_folds(value):
    """Set both packages' native-fold handles (False: numpy; None: load
    the native library) for one test, and restore them after."""
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = value
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


@pytest.fixture
def numpy_fold():
    yield from _pin_folds(False)


@pytest.fixture
def native_fold():
    for _ in _pin_folds(None):
        if (jax_base._get_hostfold() is None
                or port_base._get_hostfold() is None):
            pytest.skip("g++ cannot build native/hostfold.cc here")
        yield


def _arrays(num_learners, n_per=60, d=6, classes=3, seed=7):
    """tests/test_federation_inprocess.py's shards, as plain arrays."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, classes)).astype(np.float32)
    shards = []
    for _ in range(num_learners):
        x = rng.standard_normal((n_per, d)).astype(np.float32)
        shards.append((x, np.argmax(x @ w, axis=-1).astype(np.int32)))
    x = rng.standard_normal((120, d)).astype(np.float32)
    return shards, (x, np.argmax(x @ w, axis=-1).astype(np.int32))


def _jax_template(x):
    return FlaxModelOps(JaxMLP(features=(16,), num_outputs=3),
                        x[:2]).get_variables()


def _train_kwargs(**extra):
    return dict(batch_size=16, local_steps=4, learning_rate=0.1, **extra)


def _port_config(model_store=None, **train_extra):
    return FederationConfig(
        aggregation=AggregationConfig(rule="fedavg", scaler="participants"),
        train=TrainParams(**_train_kwargs(**train_extra)),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=ROUNDS),
        model_store=model_store or ModelStoreConfig())


def _jax_config(model_store=None):
    return JaxFederationConfig(
        aggregation=JaxAggregationConfig(rule="fedavg",
                                         scaler="participants"),
        train=JaxTrainParams(**_train_kwargs()),
        eval=JaxEvalConfig(batch_size=64, datasets=["test"]),
        termination=JaxTerminationConfig(federation_rounds=ROUNDS),
        model_store=model_store or JaxModelStoreConfig())


class _Recorder:
    """Wraps learners' ``run_task`` (first community blob per round; the
    tasks wait for ``gate``) and a controller's ``task_completed``
    (every uplink, by round and learner)."""

    def __init__(self):
        self.gate = threading.Event()
        self.dispatched = {}   # round_id -> community blob bytes
        # the community model of a controller that stopped dispatching
        self.final = None
        self.uplinks = {}      # round_id -> {learner_id: blob bytes}
        self._lock = threading.Lock()

    def wrap_learner(self, learner):
        run = learner.run_task

        def run_task(task):
            with self._lock:
                self.dispatched.setdefault(task.round_id, task.model)
            self.gate.wait(60)
            return run(task)

        learner.run_task = run_task

    def wrap_controller(self, controller):
        done = controller.task_completed

        def task_completed(result):
            with self._lock:
                self.uplinks.setdefault(result.round_id, {})[
                    result.learner_id] = result.model
            return done(result)

        controller.task_completed = task_completed

    def community(self, round_id):
        """The community model after ``round_id`` (what round_id + 1's
        tasks carried, or the final one after the controller's last
        round), as {name: np.ndarray}."""
        return _parse(self.dispatched.get(round_id + 1, self.final))


def _parse(blob_bytes):
    return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(
        blob_bytes).tensors}


def _run(fed, recorder, rounds=ROUNDS, evals=True):
    for learner in fed.learners:
        recorder.wrap_learner(learner)
    recorder.wrap_controller(fed.controller)
    try:
        fed.start()
        recorder.gate.set()
        assert fed.wait_for_rounds(rounds, timeout_s=240)
        if (isinstance(fed, InProcessFederation)
                and rounds == fed.config.termination.federation_rounds):
            recorder.final = fed.controller.community_model_bytes()
        else:
            assert fed.wait_until(lambda: rounds in recorder.dispatched, 60)
        if evals:
            n = len(fed.learners)

            def evaluated():
                # every learner's evaluation of each of the first rounds
                # (the JAX package's controller runs on: a later round's
                # entry may fill before an earlier one)
                done = {e["global_iteration"]
                        for e in fed.statistics()["community_evaluations"]
                        if len(e["evaluations"]) == n}
                return set(range(rounds)) <= done

            assert fed.wait_until(evaluated, 120)
        stats = fed.statistics()
    finally:
        fed.shutdown()
    return stats


def _port_federation(shards, test, template, config=None):
    # the controller's robust rules combine on the CPU here
    fed = InProcessFederation(config or _port_config(), device="cpu")
    for x, y in shards:
        i = len(fed.learners)
        ops = TorchModelOps(MLP(6, (16,), 3), variables=template,
                            device="cpu")
        fed.add_learner(ops, ArrayDataset(x, y, seed=i),
                        test_dataset=ArrayDataset(*test))
    fed.seed_model(template)
    return fed


def _jax_federation(shards, test, template, config=None):
    fed = JaxFederation(config or _jax_config())
    for x, y in shards:
        i = len(fed.learners)
        engine = FlaxModelOps(JaxMLP(features=(16,), num_outputs=3), x[:2])
        engine.set_variables(template)
        fed.add_learner(engine, JaxDataset(x, y, seed=i),
                        test_dataset=JaxDataset(*test))
    fed.seed_model(template)
    return fed


def _accuracy(stats, round_id):
    entry = next(e for e in stats["community_evaluations"]
                 if e["global_iteration"] == round_id)
    return [v["test"]["accuracy"] for _, v in
            sorted(entry["evaluations"].items())]


def _federations_match(port_config=None, jax_config=None, rounds=ROUNDS):
    """The 3-learner x ``rounds`` federation through both packages: the
    same cohorts and scales, communities within COMMUNITY_ATOL, the same
    accuracies, and the port learns. Returns the largest community
    difference over all rounds and tensors."""
    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    port_rec, jax_rec = _Recorder(), _Recorder()
    port = _run(_port_federation(shards, test, template, port_config),
                port_rec, rounds=rounds)
    ref = _run(_jax_federation(shards, test, template, jax_config), jax_rec,
               rounds=rounds)
    worst = 0.0
    assert port["global_iteration"] >= rounds
    assert ref["global_iteration"] >= rounds
    assert port["learners"] == ref["learners"]
    for r in range(rounds):
        port_meta, ref_meta = port["round_metadata"][r], ref["round_metadata"][r]
        assert port_meta["selected_learners"] == ref_meta["selected_learners"]
        assert len(port_meta["selected_learners"]) == 3
        assert port_meta["scales"] == ref_meta["scales"]
        got, want = port_rec.community(r), jax_rec.community(r)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            diff = float(np.abs(got[name] - want[name]).max())
            assert diff <= COMMUNITY_ATOL, (r, name)
            worst = max(worst, diff)
        # equal accuracy: the same count of correct test predictions (the
        # JAX engine averages each batch in f32, the port in f64)
        n_test = len(test[1])
        assert [round(a * n_test) for a in _accuracy(port, r)] == [
            round(a * n_test) for a in _accuracy(ref, r)]
    # and it learns: the last round's community beats the first
    assert np.mean(_accuracy(port, rounds - 1)) > np.mean(_accuracy(port, 0))
    return worst


def test_sync_federation_matches_the_jax_package(numpy_fold):
    _federations_match()


# the other rules, each with the JAX package's config fields (a server
# learning rate below the default 1.0, whose first Adam step moves every
# weight by about 1, far past what two rounds of this task learn)
RULE_CASES = {
    "fedrec": {},
    "fednova": {},
    "fedadam": {"server_learning_rate": 0.1},
    "median": {},
    "trimmed_mean": {},
    "multikrum": {},
}


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_sync_federation_matches_the_jax_package_under_each_rule(
        numpy_fold, rule):
    """ROUNDS rounds under ``rule`` in both packages'
    InProcessFederation, held as the FedAvg federation is
    (COMMUNITY_ATOL, and the port learns: here as under FedAvg, the
    accuracy needs the third round to rise); the port's controller
    combines the robust rules on the CPU."""
    rounds = ROUNDS
    port_cfg, jax_cfg = _port_config(), _jax_config()
    port_cfg.aggregation = AggregationConfig(
        rule=rule, scaler="participants", **RULE_CASES[rule])
    jax_cfg.aggregation = JaxAggregationConfig(
        rule=rule, scaler="participants", **RULE_CASES[rule])
    port_cfg.termination.federation_rounds = rounds
    jax_cfg.termination.federation_rounds = rounds
    _federations_match(port_cfg, jax_cfg, rounds=rounds)


def test_sync_federation_matches_the_jax_package_on_the_native_fold(
        native_fold):
    _federations_match()


def test_cached_disk_ingest_federation_matches_the_jax_package(
        native_fold, tmp_path):
    """Both federations keep their lineage in a cached disk store (a cache
    budget below one model, so every select reads the mmapped file) and
    ingest through 2 writers; both fold natively. The communities agree
    within COMMUNITY_ATOL; the engines' f32 training differs by ~1e-8, so
    they are not bit-identical (the folds are)."""
    def store(cls, name):
        return cls(store="cached_disk", root=str(tmp_path / name),
                   cache_mb=0, ingest_workers=2)

    worst = _federations_match(
        _port_config(model_store=store(ModelStoreConfig, "port")),
        _jax_config(model_store=store(JaxModelStoreConfig, "jax")))
    assert worst <= COMMUNITY_ATOL
    # both controllers stored their learners' lineage on disk, in files
    # of the same names
    for name in ("port", "jax"):
        assert len(os.listdir(tmp_path / name)) == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def _check_folds(recorder, stats, rounds):
    """Each round's community model equals FedAvg (participants scales)
    of the uplinks its selected cohort shipped, bit for bit."""
    for r in range(rounds):
        selected = stats["round_metadata"][r]["selected_learners"]
        ups = recorder.uplinks[r]
        pairs = [([_parse(ups[lid])], 1.0 / len(selected))
                 for lid in selected]
        want = FedAvg().aggregate(pairs)
        got = recorder.community(r)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            assert got[name].tobytes() == want[name].tobytes(), (r, name)


def test_jax_learner_joins_the_port_controller(numpy_fold):
    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    fed = _port_federation(shards[:2], test, template,
                           config=_port_config())
    x, y = shards[2]
    engine = FlaxModelOps(JaxMLP(features=(16,), num_outputs=3), x[:2])
    engine.set_variables(template)
    port = 50100 + len(fed.learners)
    jax_learner = JaxLearner(engine, JaxDataset(x, y, seed=2),
                             fed.controller, test_dataset=JaxDataset(*test),
                             port=port)
    fed._learners_by_port[port] = jax_learner
    fed.learners.append(jax_learner)
    rec = _Recorder()
    stats = _run(fed, rec, rounds=2)
    assert all(len(m["selected_learners"]) == 3
               for m in stats["round_metadata"][:2])
    _check_folds(rec, stats, 2)
    # the JAX learner evaluated the port's community model too
    entry = stats["community_evaluations"][1]["evaluations"]
    assert len(entry) == 3


def test_port_learner_joins_the_jax_controller(numpy_fold):
    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    fed = _jax_federation(shards[:2], test, template)
    x, y = shards[2]
    ops = TorchModelOps(MLP(6, (16,), 3), variables=template, device="cpu")
    port = 50100 + len(fed.learners)
    learner = Learner(ops, ArrayDataset(x, y, seed=2), fed.controller,
                      test_dataset=ArrayDataset(*test), port=port)
    fed._learners_by_port[port] = learner
    fed.learners.append(learner)
    rec = _Recorder()
    stats = _run(fed, rec, rounds=2)
    assert all(len(m["selected_learners"]) == 3
               for m in stats["round_metadata"][:2])
    _check_folds(rec, stats, 2)
    assert len(stats["community_evaluations"][1]["evaluations"]) == 3


def test_stride_blocks_give_the_same_community(numpy_fold):
    """stride_length 2 folds the 3-learner cohort in blocks of 2 and 1;
    FedAvg is associative up to f32 rounding of the partial sums."""
    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    cfg = _port_config()
    cfg.aggregation.stride_length = 2
    rec = _Recorder()
    stats = _run(_port_federation(shards, test, template, cfg), rec,
                 rounds=1, evals=False)
    assert stats["round_metadata"][0]["aggregation_block_sizes"] == [2, 1]
    selected = stats["round_metadata"][0]["selected_learners"]
    pairs = [([_parse(rec.uplinks[0][lid])], 1.0 / 3) for lid in selected]
    rule = FedAvg()
    rule.accumulate(pairs[:2])
    rule.accumulate(pairs[2:])
    want = rule.result()
    got = rec.community(0)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes()


def test_participation_ratio_samples_the_cohort():
    """participation_ratio 0.5 of 4 learners: round 0 is join-driven (all
    four), later rounds dispatch, barrier on and fold a 2-learner sample."""
    shards, test = _arrays(4)
    template = _jax_template(shards[0][0])
    cfg = _port_config()
    cfg.aggregation.participation_ratio = 0.5
    stats = _run(_port_federation(shards, test, template, cfg), _Recorder(),
                 rounds=3, evals=False)
    sizes = [len(m["selected_learners"]) for m in stats["round_metadata"][:3]]
    assert sizes == [4, 2, 2]
    for meta in stats["round_metadata"][1:3]:
        assert sorted(meta["train_received_at"]) == sorted(
            meta["selected_learners"])


def test_fashion_mnist_cnn_federation_learns():
    """A small FashionMNIST-shaped CNN federation on the port alone."""
    rng = np.random.default_rng(5)
    templates = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)

    def split(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = templates[y] + 0.35 * rng.standard_normal(
            (n, 28, 28, 1)).astype(np.float32)
        return x, y

    cfg = FederationConfig(
        aggregation=AggregationConfig(scaler="train_dataset_size"),
        train=TrainParams(batch_size=16, local_steps=6, optimizer="sgd",
                          learning_rate=0.05),
        eval=EvalConfig(batch_size=64))
    fed = InProcessFederation(cfg)
    test = ArrayDataset(*split(64))
    template = None
    for i in range(2):
        ops = TorchModelOps(FashionMnistCNN(), rng_seed=1, device="cpu",
                            variables=template)
        template = template or ops.get_variables()
        fed.add_learner(ops, ArrayDataset(*split(96), seed=i),
                        test_dataset=test)
    fed.seed_model(template)
    rec = _Recorder()
    stats = _run(fed, rec, rounds=3)
    first, last = np.mean(_accuracy(stats, 0)), np.mean(_accuracy(stats, 2))
    assert last > first and last > 0.1, (first, last)


def test_leave_releases_the_barrier():
    """A dispatched learner that leaves before reporting no longer holds
    the round: the others' uplinks aggregate without it."""
    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    fed = _port_federation(shards, test, template)
    leaver = fed.learners[2]
    run = leaver.run_task
    left = threading.Event()

    def run_task(task):  # never trains: leaves instead
        if not left.is_set():
            left.set()
            threading.Thread(target=leaver.leave_federation).start()
        else:
            run(task)

    leaver.run_task = run_task
    try:
        fed.start()
        assert fed.wait_for_rounds(2, timeout_s=120)
        stats = fed.statistics()
    finally:
        fed.shutdown()
    assert len(stats["learners"]) == 2
    assert leaver.learner_id not in stats["round_metadata"][0][
        "selected_learners"]


def test_federation_stops_after_federation_rounds():
    """termination.federation_rounds: after round 2 the controller sends
    the community model out for evaluation, and no train task."""
    shards, test = _arrays(2)
    template = _jax_template(shards[0][0])
    cfg = _port_config()
    cfg.termination.federation_rounds = 2
    fed = _port_federation(shards, test, template, cfg)
    rec = _Recorder()
    for learner in fed.learners:
        rec.wrap_learner(learner)
    try:
        fed.start()
        rec.gate.set()
        assert fed.wait_for_rounds(2, timeout_s=120)
        # the single scheduling worker runs jobs in order: once this one
        # ran, round 1's close (and any dispatch of round 2) is done
        fed.controller._pool.submit(lambda: None).result(60)
        assert fed.wait_until(lambda: len(
            fed.statistics()["community_evaluations"]) == 2, 60)
        stats = fed.statistics()
    finally:
        fed.shutdown()
    assert stats["global_iteration"] == 2
    assert sorted(rec.dispatched) == [0, 1]
    # a dispatch asked for after the last round (a late join) sends nothing
    fed.controller._dispatch_train(stats["learners"])
    assert sorted(rec.dispatched) == [0, 1]


def test_dropout_federation_uplinks_are_reproducible():
    """Two dropout CNN learners train in parallel threads; each draws its
    masks from its own engine's generator, so a second run of the same
    federation ships the same uplinks, bit for bit."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((72, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, 72).astype(np.int32)
    template = TorchModelOps(FashionMnistCNN(
        input_shape=(8, 8, 1), dropout_rate=0.5), device="cpu"
    ).get_variables()
    cfg = FederationConfig(
        train=TrainParams(batch_size=8, local_steps=3, optimizer="sgd",
                          learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=2))

    def run():
        fed = InProcessFederation(cfg)
        for i in range(2):
            ops = TorchModelOps(FashionMnistCNN(
                input_shape=(8, 8, 1), dropout_rate=0.5), rng_seed=10 + i,
                variables=template, device="cpu")
            part = slice(i * 32, (i + 1) * 32)
            fed.add_learner(ops, ArrayDataset(x[part], y[part], seed=i),
                            test_dataset=ArrayDataset(x[64:], y[64:]))
        fed.seed_model(template)
        rec = _Recorder()
        _run(fed, rec, rounds=2, evals=False)
        return rec.uplinks

    first, second = run(), run()
    assert sorted(first) == sorted(second) == [0, 1]
    for r in (0, 1):
        assert sorted(first[r]) == sorted(second[r])
        assert len(first[r]) == 2
        for lid in first[r]:
            assert first[r][lid] == second[r][lid], (r, lid)


def test_completion_with_a_bad_token_is_rejected():
    shards, test = _arrays(1)
    template = _jax_template(shards[0][0])
    fed = _port_federation(shards, test, template)
    try:
        learner = fed.learners[0]
        reply = learner.join_federation()
        assert not fed.controller.task_completed(TaskResult(
            learner_id=reply.learner_id, auth_token="forged"))
        assert not fed.controller.task_completed(TaskResult(
            learner_id="nobody", auth_token=reply.auth_token))
        # a rejoin with the issued credentials keeps the identity
        again = learner.join_federation(previous_id=reply.learner_id,
                                        auth_token=reply.auth_token)
        assert again.rejoined and again.learner_id == reply.learner_id
    finally:
        fed.shutdown()


# -- unsupported configurations ---------------------------------------------

UNSUPPORTED = {
    # DriverSession watches the cutoffs; the in-process federation cannot
    "cutoff_wall_clock": lambda: InProcessFederation(FederationConfig(
        termination=TerminationConfig(execution_cutoff_mins=5.0))),
    "cutoff_metric": lambda: InProcessFederation(FederationConfig(
        termination=TerminationConfig(metric_cutoff_score=0.9))),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_config_raises(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNSUPPORTED[name]()


# ported since the configurations above were refused
SUPPORTED = {
    # controller checkpoints, beside the disk store too (failover)
    "store_disk": lambda: FederationConfig(
        model_store=ModelStoreConfig(store="disk"),
        checkpoint=CheckpointConfig(dir="ckpt")),
    "checkpoint": lambda: FederationConfig(
        checkpoint=CheckpointConfig(dir="ckpt")),
    # round control: every protocol, quorum barriers and deadlines
    "protocol_semi_synchronous": lambda: FederationConfig(
        protocol="semi_synchronous"),
    "protocol_asynchronous": lambda: FederationConfig(protocol="asynchronous"),
    "protocol_buffered": lambda: FederationConfig(
        protocol="asynchronous_buffered"),
    "quorum": lambda: FederationConfig(
        scheduling=SchedulingConfig(quorum=2)),
    "deadline": lambda: FederationConfig(round_deadline_secs=5.0),
    "rule_fedstride": lambda: FederationConfig(
        aggregation=AggregationConfig(rule="fedstride")),
    "rule_fedadam": lambda: FederationConfig(
        aggregation=AggregationConfig(rule="fedadam")),
    "rule_scaffold": lambda: FederationConfig(
        aggregation=AggregationConfig(rule="scaffold")),
    # the distributed tree tier, with the slices a driver fills in
    "tree_distributed": lambda: FederationConfig(
        aggregation=AggregationConfig(tree=TreeAggregationConfig(
            enabled=True, distributed=True))),
    "ship_int8q": lambda: FederationConfig(
        train=TrainParams(ship_dtype="int8q")),
    "ship_topk": lambda: FederationConfig(
        train=TrainParams(ship_dtype="topk100")),
    "dp_clip": lambda: FederationConfig(
        train=TrainParams(dp_clip_norm=1.0)),
    "dp_noise": lambda: FederationConfig(
        train=TrainParams(dp_clip_norm=1.0, dp_noise_multiplier=0.5)),
    "local_tensors": lambda: FederationConfig(
        train=TrainParams(local_tensor_regex="batch_stats")),
}


@pytest.mark.parametrize("name", sorted(SUPPORTED))
def test_ported_config_is_accepted(name):
    cfg = SUPPORTED[name]()
    assert FederationConfig.from_wire(cfg.to_wire()) == cfg
    if name.startswith("rule_"):
        assert cfg.aggregation.rule == name.split("_", 1)[1]
    fed = InProcessFederation(cfg)
    try:
        assert fed.controller._aggregator.name == cfg.aggregation.rule
    finally:
        fed.shutdown()


def test_the_distributed_tier_beside_parallel_ingest_is_a_value_error():
    """The JAX package's refusal: distributed uplinks bypass the root
    store, so there is nothing to ingest."""
    with pytest.raises(ValueError, match="ingest_workers"):
        FederationConfig(
            model_store=ModelStoreConfig(store="remote", ingest_workers=2),
            aggregation=AggregationConfig(tree=TreeAggregationConfig(
                enabled=True, distributed=True)))


@pytest.mark.parametrize("store", ["in_memory", "disk", "cached_disk",
                                   "remote"])
def test_every_store_is_accepted(store):
    """The JAX package's four stores configure (with parallel ingest);
    a negative writer count is a ValueError, as there."""
    cfg = FederationConfig(model_store=ModelStoreConfig(
        store=store, root="r", cache_mb=8, host="h", port=9,
        ingest_workers=3))
    assert FederationConfig.from_wire(cfg.to_wire()) == cfg
    with pytest.raises(ValueError, match="ingest_workers"):
        FederationConfig(model_store=ModelStoreConfig(store=store,
                                                      ingest_workers=-1))
    with pytest.raises(ValueError, match="unknown store"):
        FederationConfig(model_store=ModelStoreConfig(store="redis"))


class _Reports:
    def __init__(self):
        self.results = []
        self.done = threading.Event()

    def task_completed(self, result):
        self.results.append(result)
        self.done.set()
        return True


@pytest.mark.parametrize("field,task", [
    ("scaffold", TrainTask(scaffold=True)),
    ("dp", TrainTask(params=TrainParams(dp_clip_norm=1.0))),
    ("int8q", TrainTask(params=TrainParams(ship_dtype="int8q"))),
])
def test_unsupported_train_task_raises_before_training(field, task):
    """These tasks were refused before the uplink variants were ported:
    now each trains and reports. What still raises before training, on
    the caller's thread, is a ship dtype that names nothing."""
    shards, _ = _arrays(1)
    ops = TorchModelOps(MLP(6, (16,), 3), device="cpu")
    reports = _Reports()
    learner = Learner(ops, ArrayDataset(*shards[0]), controller=reports)
    try:
        task.model = pack_model(ops.get_variables())
        task.params.local_steps = 1
        task.params.batch_size = 4
        learner.run_task(task)
        assert reports.done.wait(60)
        result = reports.results[0]
        names = ModelBlob.from_bytes(result.model).names
        assert bool(result.control_delta) == (field == "scaffold")
        assert any(n.endswith("#qscale") for n in names) == (
            field == "int8q")
        with pytest.raises(ValueError, match="ship_dtype"):
            learner.run_task(TrainTask(params=TrainParams(
                ship_dtype="int9q")))
    finally:
        learner.shutdown()


# -- the bf16 uplink ---------------------------------------------------------

def test_bf16_uplink_narrows_the_wire_not_training():
    """ship_dtype="bf16": learners ship bf16, the community model is
    stored in bf16, and the learners keep training f32 params."""
    shards, test = _arrays(2)
    template = _jax_template(shards[0][0])
    cfg = _port_config(ship_dtype="bf16")
    cfg.eval.every_n_rounds = 0
    fed = _port_federation(shards, test, template, cfg)
    rec = _Recorder()
    _run(fed, rec, rounds=2, evals=False)
    blob = ModelBlob.from_bytes(fed.controller.community_model_bytes())
    dtypes = {to_numpy(t).dtype for _, t in blob.tensors}
    assert dtypes == {np.dtype(ml_dtypes.bfloat16)}
    for up in rec.uplinks[0].values():
        assert {a.dtype for a in _parse(up).values()} == {
            np.dtype(ml_dtypes.bfloat16)}
    for learner in fed.learners:
        for _, leaf in ModelBlob(tensors=list(
                _leaves(learner.model_ops.get_variables()))).tensors:
            assert leaf.dtype == np.float32


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_bad_ship_dtype_rejected_at_startup():
    with pytest.raises(ValueError, match="ship_dtype"):
        FederationConfig(train=TrainParams(ship_dtype="bfloat16"))


def test_ship_dtype_skips_integer_state():
    """Integer leaves cross the wire untouched under a bf16 uplink."""

    class _Ops:
        def get_variables(self):
            return {"w": np.linspace(0, 1, 8, dtype=np.float32),
                    "steps": np.array([1001, 70000], np.uint32)}

    learner = Learner(_Ops(), ArrayDataset(np.zeros((2, 1)), np.zeros(2)),
                      controller=None)
    try:
        blob = ModelBlob.from_bytes(learner._dump_model(ship_dtype="bf16"))
    finally:
        learner.shutdown()
    by_name = {n: to_numpy(t) for n, t in blob.tensors}
    assert by_name["w"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(by_name["steps"], [1001, 70000])
    assert by_name["steps"].dtype == np.uint32


# the parity tests above, with both packages on their native folds


def test_jax_learner_joins_the_port_controller_on_the_native_fold(
        native_fold):
    test_jax_learner_joins_the_port_controller(native_fold)


def test_port_learner_joins_the_jax_controller_on_the_native_fold(
        native_fold):
    test_port_learner_joins_the_jax_controller(native_fold)


def test_stride_blocks_give_the_same_community_on_the_native_fold(
        native_fold):
    test_stride_blocks_give_the_same_community(native_fold)
