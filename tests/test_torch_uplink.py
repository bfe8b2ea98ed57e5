"""The uplink variants of the port against the JAX package's: SCAFFOLD,
int8q and top-k uplinks, the narrowed downlink, client-level DP, FedBN
local tensors and ship-only subsets.

- SCAFFOLD: the same MLP, seed, control blob and batches through both
  packages' learners: the uplink and the control delta within the
  training tolerance, 2e-6 (SGD steps; the engines' matmuls sum in other
  orders); the controller's ``c`` after each round and the control blob
  it dispatches are the JAX controller's bit for bit.
- ``quantize_named``, ``sparsify_update`` (indices, values and residual,
  ties in ``|u|`` included) and their inverses give the JAX bits; a
  learner's int8q and top-k blobs for the same trained weights are the
  JAX learner's bytes.
- The bf16 downlink blob is the JAX controller's bytes.
- DP: with the same ``np.random.Generator`` state, ``privatize_update``
  gives the JAX bits; with noise 0 a shipped update's norm is at most
  ``clip_norm``.
- FedBN: local tensors never leave the learner and survive the community
  install. Ship-only: the controller holds only the matching tensors from
  the seed on, and the learner's uplink (2e-6) and the controller's model
  (bit for bit, from the same uplinks) are the JAX package's.
- The config checks of SCAFFOLD, DP, the uplink encodings and the regexes
  raise in both packages with one error type.
"""

import threading

import numpy as np
import pytest

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.comm.messages import JoinRequest as JaxJoinRequest
from metisfl_tpu.comm.messages import TaskResult as JaxTaskResult
from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.comm.messages import TrainTask as JaxTrainTask
from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
from metisfl_tpu.config import EvalConfig as JaxEvalConfig
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import SecureAggConfig as JaxSecureAggConfig
from metisfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from metisfl_tpu.controller.core import Controller as JaxController
from metisfl_tpu.learner.learner import Learner as JaxLearner
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
from metisfl_tpu.models.zoo import MLP as JaxMLP
from metisfl_tpu.secure import dp as jax_dp
from metisfl_tpu.tensor import quantize as jax_quantize
from metisfl_tpu.tensor import sparse as jax_sparse
from metisfl_tpu.tensor.pytree import ModelBlob as JaxModelBlob
from metisfl_tpu.tensor.pytree import pack_model as jax_pack_model
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.comm.messages import TrainTask
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.config.federation import SecureAggConfig
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.driver import InProcessFederation
from metisfl_tpu_torch.learner import Learner
from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP
from metisfl_tpu_torch.secure import dp
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor import quantize, sparse
from metisfl_tpu_torch.tensor.pytree import to_numpy

TRAIN_TOL = 2e-6


@pytest.fixture(autouse=True)
def numpy_fold():
    """Both packages' host folds without their native libraries."""
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


def _named(blob):
    return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(blob).tensors}


def _same_bits(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _close(got, want, tol=TRAIN_TOL):
    assert sorted(got) == sorted(want)
    for name in want:
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())


class _Capture:
    def __init__(self):
        self.results = []
        self.arrived = threading.Condition()

    def join(self, request):  # pragma: no cover - never called here
        raise AssertionError

    def leave(self, learner_id, auth_token):
        return True

    def task_completed(self, result):
        with self.arrived:
            self.results.append(result)
            self.arrived.notify_all()
        return True

    def wait(self, n, timeout=60.0):
        with self.arrived:
            assert self.arrived.wait_for(lambda: len(self.results) >= n,
                                         timeout)
        return self.results[n - 1]


def _pair(seed=0, rows=16, features=(16,)):
    """A JAX and a port learner over the same MLP variables and data."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 6)).astype(np.float32)
    y = rng.integers(0, 3, rows).astype(np.int32)
    jax_ops = FlaxModelOps(JaxMLP(features=features, num_outputs=3), x[:2])
    variables = jax_ops.get_variables()
    port_ops = TorchModelOps(MLP(6, features, 3), variables=variables,
                             device="cpu")
    ref = JaxLearner(jax_ops, JaxDataset(x, y, seed=seed),
                     controller=_Capture())
    port = Learner(port_ops, ArrayDataset(x, y, seed=seed),
                   controller=_Capture())
    for learner in (ref, port):
        learner.learner_id, learner.auth_token = "L0", "t"
    return ref, port, variables


def _run(learner, task, n):
    learner.run_task(task)
    return learner.controller.wait(n)


# -- SCAFFOLD -----------------------------------------------------------------

def test_the_scaffold_learner_is_the_jax_learner():
    ref, port, variables = _pair(1)
    rng = np.random.default_rng(3)
    try:
        model = jax_pack_model(variables)
        for n, control in enumerate((b"", "c"), start=1):
            if control:
                # a nonzero server variate (the second task also starts
                # from a nonzero c_i)
                control = jax_pack_model({
                    k: {p: rng.standard_normal(np.shape(a)).astype(
                        np.float32) * 0.01 for p, a in v.items()}
                    for k, v in variables["params"].items()})
            params = dict(batch_size=4, local_steps=3, optimizer="sgd",
                          learning_rate=0.05)
            want = _run(ref, JaxTrainTask(
                task_id=f"t{n}", round_id=n, model=model, scaffold=True,
                control=control, params=JaxTrainParams(**params)), n)
            got = _run(port, TrainTask(
                task_id=f"t{n}", round_id=n, model=model, scaffold=True,
                control=control, params=TrainParams(**params)), n)
            assert got.control_delta and want.control_delta
            _close(_named(got.model), _named(want.model))
            _close(_named(got.control_delta), _named(want.control_delta))
            # the next task starts from this round's uplink
            model = want.model
        # the learner's c_i is the sum of its shipped deltas
        assert port._scaffold_ci is not None
    finally:
        port.shutdown()
        ref.shutdown()


class _Proxy:
    def __init__(self, record, tasks):
        self.learner_id = record.learner_id
        self.tasks = tasks

    def run_task(self, task):
        self.tasks.append(task)

    def evaluate(self, task, callback):
        pass


def _scaffold_controllers(tasks_port, tasks_jax):
    port = Controller(FederationConfig(
        aggregation=AggregationConfig(rule="scaffold", scaler="participants"),
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=0)),
        proxy_factory=lambda r: _Proxy(r, tasks_port), device="cpu")
    ref = JaxController(JaxFederationConfig(
        aggregation=JaxAggregationConfig(rule="scaffold",
                                         scaler="participants"),
        train=JaxTrainParams(batch_size=4, local_steps=1),
        eval=JaxEvalConfig(every_n_rounds=0),
        telemetry=JaxTelemetryConfig(enabled=False)),
        proxy_factory=lambda r: _Proxy(r, tasks_jax))
    return port, ref


def _drive(ctrl, join_cls, result_cls, pack, uplinks, deltas, seed):
    """Join the learners, then complete one round per entry of
    ``uplinks``/``deltas`` (dicts by learner index)."""
    import time

    ctrl.set_community_model(pack(seed))
    for i in range(len(uplinks[0])):
        ctrl.join(join_cls(hostname="h", port=7600 + i,
                           num_train_examples=10))
    lids = sorted(ctrl.active_learners())
    with ctrl._lock:
        tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
    cs = []
    for r, (ups, dcs) in enumerate(zip(uplinks, deltas)):
        for i, lid in enumerate(lids):
            assert ctrl.task_completed(result_cls(
                task_id=f"t{r}_{lid}", learner_id=lid,
                auth_token=tokens[lid], model=pack(ups[i]), round_id=r,
                completed_batches=1, control_delta=pack(dcs[i])))
        deadline = time.time() + 60.0
        while ctrl.global_iteration <= r:
            assert time.time() < deadline, f"round {r} never completed"
            time.sleep(0.01)
        with ctrl._lock:
            cs.append({k: np.asarray(v).copy()
                       for k, v in ctrl._scaffold_c.items()})
    return cs


def _params_tree(rng, scale=1.0):
    return {"Dense_0": {"kernel": rng.standard_normal((6, 5)).astype(
        np.float32) * scale, "bias": rng.standard_normal(5).astype(
        np.float32) * scale}}


def test_the_controllers_scaffold_variate_is_the_jax_one_bit_for_bit():
    rng = np.random.default_rng(11)
    seed = _params_tree(rng)
    uplinks = [[_params_tree(rng) for _ in range(3)] for _ in range(2)]
    deltas = [[_params_tree(rng, 0.01) for _ in range(3)] for _ in range(2)]
    tasks_port, tasks_jax = [], []
    port, ref = _scaffold_controllers(tasks_port, tasks_jax)
    try:
        got = _drive(port, JoinRequest, TaskResult, pack_model, uplinks,
                     deltas, seed)
        want = _drive(ref, JaxJoinRequest, JaxTaskResult, jax_pack_model,
                      uplinks, deltas, seed)
        for g, w in zip(got, want):
            _same_bits(g, w)
        with port._lock, ref._lock:
            assert port._pack_scaffold_c() == ref._pack_scaffold_c()
        # every task after a fold carries c; the first round's none
        last = [t for t in tasks_port if t.round_id == 2]
        assert last and all(t.scaffold and t.control
                            == port._pack_scaffold_c() for t in last)
        assert all(t.control == b"" for t in tasks_port
                   if t.round_id == 0)
        _same_bits(_named(port.community_model_bytes()),
                   _named(ref._community_blob))
    finally:
        port.shutdown()
        ref.shutdown()


# -- int8q and top-k ----------------------------------------------------------

def _tensors(seed, ties=False):
    rng = np.random.default_rng(seed)
    out = [("a/w", rng.standard_normal((33, 7)).astype(np.float32)),
           ("a/steps", np.arange(5, dtype=np.int32)),
           ("b/tiny", rng.standard_normal(9).astype(np.float32)),
           ("c/zero", np.zeros((8, 16), np.float32))]
    if ties:
        # many equal magnitudes: which of them the selection keeps is the
        # numpy argpartition's order
        tied = rng.choice([-0.5, 0.5, 0.25, -0.25, 0.0], (40, 13))
        out.append(("d/tied", tied.astype(np.float32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8q_is_the_jax_quantizer_bit_for_bit(seed):
    named = _tensors(seed, ties=True)
    got = quantize.quantize_named(named)
    want = jax_quantize.quantize_named(named)
    assert [n for n, _ in got] == [n for n, _ in want]
    _same_bits(dict(got), dict(want))
    assert quantize.is_quantized(dict(got)) and not quantize.is_quantized(
        dict(named))
    _same_bits(quantize.dequantize_named(dict(got)),
               jax_quantize.dequantize_named(dict(want)))
    with pytest.raises(ValueError):
        quantize.quantize_named([("x#qscale", np.zeros(2, np.float32))])


@pytest.mark.parametrize("denom", [1, 4, 16, 64])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_is_the_jax_sparsifier_bit_for_bit(denom, ties):
    ref = dict(_tensors(7, ties))
    res_port, res_jax = {}, {}
    for r in range(3):
        trained = [(n, a + np.float32(0.1 * (r + 1)) *
                    np.random.default_rng(r).standard_normal(a.shape)
                    .astype(a.dtype) if a.dtype == np.float32 else a)
                   for n, a in _tensors(7, ties)]
        got = sparse.sparsify_update(trained, ref, denom, res_port)
        want = jax_sparse.sparsify_update(trained, ref, denom, res_jax)
        assert [n for n, _ in got] == [n for n, _ in want]
        _same_bits(dict(got), dict(want))
        _same_bits(res_port, res_jax)
        assert sparse.is_sparse(dict(got))
        _same_bits(sparse.densify_named(dict(got), ref),
                   jax_sparse.densify_named(dict(want), ref))
    assert sparse.parse_topk("topk") == jax_sparse.parse_topk("topk") == 16
    assert sparse.parse_topk("bf16") is None
    with pytest.raises(ValueError):
        sparse.parse_topk("topk0")


def test_a_learners_int8q_and_topk_blobs_are_the_jax_learners_bytes():
    ref, port, variables = _pair(2)
    try:
        trained = {k: {p: {q: np.asarray(a) * np.float32(1.01)
                           for q, a in layer.items()}
                       for p, layer in v.items()}
                   for k, v in variables.items()}
        assert port._dump_model(ship_dtype="int8q", variables=trained) == \
            ref._dump_model(ship_dtype="int8q", variables=trained)
        assert port._dump_model(ship_dtype="bf16", variables=trained) == \
            ref._dump_model(ship_dtype="bf16", variables=trained)
        wire = {n: np.asarray(a) for n, a in JaxModelBlob.from_bytes(
            jax_pack_model(variables)).tensors}
        for _ in range(2):   # the residual carries into the second
            assert port._dump_sparse(wire, trained, 4) == \
                ref._dump_sparse(wire, trained, 4)
        _same_bits(port._ef_residual, ref._ef_residual)
    finally:
        port.shutdown()
        ref.shutdown()


def test_a_topk_round_densifies_against_the_dispatched_model():
    """Learner → controller: the controller rebuilds each dense uplink
    from the sparse update and its community model (error feedback keeps
    what it drops), and the round folds them."""
    ref, port, variables = _pair(4)
    ctrl = Controller(FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(ship_dtype="topk4"),
        eval=EvalConfig(every_n_rounds=0)),
        proxy_factory=lambda r: _Proxy(r, []), device="cpu")
    try:
        ctrl.set_community_model(pack_model(variables))
        result = _run(port, TrainTask(
            task_id="t", model=ctrl.community_model_bytes(),
            params=TrainParams(batch_size=4, local_steps=2,
                               ship_dtype="topk4")), 1)
        shipped = _named(result.model)
        assert sparse.is_sparse(shipped)
        dense = ctrl._parse_result_model(result, ModelBlob.from_bytes(
            result.model))
        community = _named(ctrl.community_model_bytes())
        _same_bits(dense, jax_sparse.densify_named(shipped, community))
    finally:
        ctrl.shutdown()
        port.shutdown()
        ref.shutdown()


# -- the downlink -------------------------------------------------------------

def test_the_bf16_downlink_is_the_jax_controllers_bytes():
    rng = np.random.default_rng(5)
    seed = dict(_params_tree(rng), steps=np.arange(3, dtype=np.int32))
    port = Controller(FederationConfig(
        train=TrainParams(downlink_dtype="bf16"),
        eval=EvalConfig(every_n_rounds=0)),
        proxy_factory=lambda r: _Proxy(r, []), device="cpu")
    ref = JaxController(JaxFederationConfig(
        train=JaxTrainParams(downlink_dtype="bf16"),
        eval=JaxEvalConfig(every_n_rounds=0),
        telemetry=JaxTelemetryConfig(enabled=False)),
        proxy_factory=lambda r: _Proxy(r, []))
    try:
        for ctrl, pack in ((port, pack_model), (ref, jax_pack_model)):
            ctrl.set_community_model(pack(seed))
        got, want = port._dispatch_blob(), ref._dispatch_blob()
        assert got == want
        assert port._dispatch_blob() is got   # encoded once per model
        narrowed = _named(got)
        assert narrowed["steps"].dtype == np.int32
        assert str(narrowed["Dense_0/kernel"].dtype) == "bfloat16"
        # the controller's own model stays full width
        assert _named(port.community_model_bytes())[
            "Dense_0/kernel"].dtype == np.float32
    finally:
        port.shutdown()
        ref.shutdown()


# -- DP -----------------------------------------------------------------------

def _dp_trees(seed, scale):
    rng = np.random.default_rng(seed)
    community = {"params": {"a": rng.standard_normal((5, 4)).astype(
        np.float32), "b": rng.standard_normal(7).astype(np.float32)},
        "steps": np.int32(3)}
    trained = {"params": {k: v + scale * rng.standard_normal(v.shape)
                          .astype(np.float32)
                          for k, v in community["params"].items()},
               "steps": np.int32(9)}
    return trained, community


@pytest.mark.parametrize("noise", [0.0, 0.7])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_dp_is_the_jax_mechanism_bit_for_bit(noise, scale):
    trained, community = _dp_trees(3, scale)
    got = dp.privatize_update(trained, community, 1.0, noise,
                              rng=np.random.default_rng(42))
    want = jax_dp.privatize_update(trained, community, 1.0, noise,
                                   rng=np.random.default_rng(42))
    flat = {f"params/{k}": v for k, v in got["params"].items()}
    flat["steps"] = got["steps"]
    wflat = {f"params/{k}": np.asarray(v) for k, v in want["params"].items()}
    wflat["steps"] = np.asarray(want["steps"])
    _same_bits(flat, wflat)
    assert int(got["steps"]) == 9   # discrete state ships as trained
    if noise == 0.0:
        norm = np.sqrt(sum(float(np.sum(np.square(
            got["params"][k].astype(np.float64)
            - community["params"][k].astype(np.float64))))
            for k in community["params"]))
        assert norm <= 1.0 * (1 + 1e-6)
    for sigma, rounds in ((0.5, 10), (1.1, 100), (0.0, 5)):
        assert dp.rdp_epsilon(sigma, rounds) == jax_dp.rdp_epsilon(sigma,
                                                                   rounds)


def test_a_dp_learner_ships_a_clipped_update():
    _, port, variables = _pair(6)
    try:
        result = _run(port, TrainTask(
            task_id="t", model=pack_model(variables),
            params=TrainParams(batch_size=4, local_steps=3,
                               learning_rate=0.5, dp_clip_norm=1e-3)), 1)
        sent = _named(result.model)
        base = _named(pack_model(variables))
        norm = np.sqrt(sum(float(np.sum(np.square(
            sent[k].astype(np.float64) - base[k].astype(np.float64))))
            for k in base))
        assert 0.0 < norm <= 1e-3 * (1 + 1e-6)
    finally:
        port.shutdown()


# -- FedBN and ship-only subsets ----------------------------------------------

def _shards(n, rows=24, seed=9):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.standard_normal((rows, 6)).astype(np.float32)
        out.append((x, np.argmax(x @ w, -1).astype(np.int32)))
    return out


def _federation(train, rounds=2, n=3):
    shards = _shards(n)
    cfg = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.2,
                          **train),
        eval=EvalConfig(batch_size=8, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=rounds))
    fed = InProcessFederation(cfg, device="cpu")
    template = TorchModelOps(MLP(6, (8,), 3), rng_seed=0,
                             device="cpu").get_variables()
    for x, y in shards:
        fed.add_learner(TorchModelOps(MLP(6, (8,), 3), variables=template,
                                      device="cpu"),
                        ArrayDataset(x, y, seed=1),
                        test_dataset=ArrayDataset(x, y))
    fed.seed_model(template)
    uplinks = []
    done = fed.controller.task_completed

    def recorded(result):
        uplinks.append(result.model)
        return done(result)

    fed.controller.task_completed = recorded
    return fed, uplinks, template


def _run_fed(fed, rounds):
    fed.start()
    try:
        assert fed.wait_for_rounds(rounds, 120)
        assert fed.wait_for_evaluations(rounds, 120)
        return fed.statistics()
    finally:
        fed.shutdown()


def test_fedbn_local_tensors_never_leave_and_survive_the_install():
    fed, uplinks, _ = _federation({"local_tensor_regex": "bias"})
    _run_fed(fed, 2)
    assert len(uplinks) == 6
    for blob in uplinks:
        assert not any("bias" in n for n in ModelBlob.from_bytes(blob).names)
    community = _named(fed.controller.community_model_bytes())
    assert community and not any("bias" in n for n in community)
    biases = []
    for learner in fed.learners:
        # the engine holds its own trained biases, the install merged them
        own = dict(learner._local_values)
        assert own and all("bias" in n for n in own)
        installed = learner._load_model(
            fed.controller.community_model_bytes())
        for name, arr in own.items():
            layer, leaf = name.split("/")[1:]
            assert np.array_equal(
                to_numpy(installed["params"][layer][leaf]), arr)
        biases.append(own["params/Dense_1/bias"])
    # each learner personalised its own (different data)
    assert not np.array_equal(biases[0], biases[1])
    with pytest.raises(ValueError, match="matches every"):
        fed.learners[0]._local_regex = "."
        fed.learners[0]._dump_model()


def test_ship_only_keeps_the_subset_from_the_seed_on():
    fed, uplinks, template = _federation({"ship_tensor_regex": "Dense_1"})
    ctrl = fed.controller
    assert sorted(_named(ctrl.community_model_bytes())) == [
        "params/Dense_1/bias", "params/Dense_1/kernel"]
    _run_fed(fed, 2)
    assert uplinks and all(
        sorted(ModelBlob.from_bytes(b).names) == ["params/Dense_1/bias",
                                                  "params/Dense_1/kernel"]
        for b in uplinks)
    assert sorted(_named(ctrl.community_model_bytes())) == [
        "params/Dense_1/bias", "params/Dense_1/kernel"]
    with pytest.raises(ValueError, match="matches no tensor"):
        ctrl.set_community_model(pack_model({"other": np.zeros(2)}))


def test_ship_only_uplinks_and_the_stored_model_are_the_jax_packages():
    """One learner of each package, the same seed blob: the subset uplink
    within 2e-6; the controllers, fed the same uplinks, hold the same
    subset-resident model bit for bit."""
    ref, port, variables = _pair(8, features=(8,))
    regex = "Dense_1"
    port_ctrl = Controller(FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(ship_tensor_regex=regex),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=0)),
        proxy_factory=lambda r: _Proxy(r, []), device="cpu")
    jax_ctrl = JaxController(JaxFederationConfig(
        aggregation=JaxAggregationConfig(scaler="participants"),
        train=JaxTrainParams(ship_tensor_regex=regex),
        eval=JaxEvalConfig(every_n_rounds=0),
        telemetry=JaxTelemetryConfig(enabled=False)),
        proxy_factory=lambda r: _Proxy(r, []))
    try:
        port_ctrl.set_community_model(pack_model(variables))
        jax_ctrl.set_community_model(jax_pack_model(variables))
        assert port_ctrl.community_model_bytes() == \
            jax_ctrl._community_blob
        params = dict(batch_size=4, local_steps=2, learning_rate=0.1,
                      ship_tensor_regex=regex)
        down = port_ctrl.community_model_bytes()
        got = _run(port, TrainTask(task_id="t", model=down,
                                   params=TrainParams(**params)), 1)
        want = _run(ref, JaxTrainTask(task_id="t", model=down,
                                      params=JaxTrainParams(**params)), 1)
        assert sorted(_named(got.model)) == sorted(
            n for n in _named(pack_model(variables)) if regex in n)
        _close(_named(got.model), _named(want.model))
        # the same two uplinks into each controller: the same model
        ups = [want.model, got.model]
        for ctrl, join_cls, result_cls in (
                (port_ctrl, JoinRequest, TaskResult),
                (jax_ctrl, JaxJoinRequest, JaxTaskResult)):
            lids = [ctrl.join(join_cls(hostname="h", port=7700 + i,
                                       num_train_examples=4)).learner_id
                    for i in range(2)]
            with ctrl._lock:
                tokens = {lid: ctrl._learners[lid].auth_token
                          for lid in lids}
            for lid, blob in zip(lids, ups):
                assert ctrl.task_completed(result_cls(
                    task_id=lid, learner_id=lid, auth_token=tokens[lid],
                    model=blob, round_id=0))
        import time
        deadline = time.time() + 60
        while port_ctrl.global_iteration < 1 or \
                jax_ctrl.global_iteration < 1:
            assert time.time() < deadline
            time.sleep(0.01)
        _same_bits(_named(port_ctrl.community_model_bytes()),
                   {n: np.asarray(a) for n, a in JaxModelBlob.from_bytes(
                       jax_ctrl._community_blob).tensors})
        # the port learner installs the subset over its frozen base
        installed = port._load_model(port_ctrl.community_model_bytes())
        np.testing.assert_array_equal(
            to_numpy(installed["params"]["Dense_0"]["kernel"]),
            variables["params"]["Dense_0"]["kernel"])
    finally:
        port_ctrl.shutdown()
        jax_ctrl.shutdown()
        port.shutdown()
        ref.shutdown()


# -- the config ---------------------------------------------------------------

def _uplink_configs(pkg):
    if pkg == "port":
        fc, ac, tp, sc = (FederationConfig, AggregationConfig, TrainParams,
                          SecureAggConfig)
    else:
        fc, ac, tp, sc = (JaxFederationConfig, JaxAggregationConfig,
                          JaxTrainParams, JaxSecureAggConfig)
    masking = dict(aggregation=ac(rule="secure_agg", scaler="participants"),
                   secure=sc(enabled=True, scheme="masking"))
    scaffold = ac(rule="scaffold")
    return {
        "scaffold": lambda: fc(aggregation=scaffold),
        "scaffold_adam": lambda: fc(aggregation=scaffold,
                                    train=tp(optimizer="adam")),
        "scaffold_secure": lambda: fc(
            aggregation=ac(rule="scaffold"),
            secure=sc(enabled=True, scheme="masking")),
        "scaffold_dp": lambda: fc(aggregation=scaffold,
                                  train=tp(dp_clip_norm=1.0)),
        "scaffold_ship_regex": lambda: fc(
            aggregation=scaffold, train=tp(ship_tensor_regex="head")),
        "dp": lambda: fc(train=tp(dp_clip_norm=1.0,
                                  dp_noise_multiplier=1.0)),
        "dp_noise_only": lambda: fc(train=tp(dp_noise_multiplier=1.0)),
        "dp_negative": lambda: fc(train=tp(dp_clip_norm=-1.0)),
        "int8q": lambda: fc(train=tp(ship_dtype="int8q")),
        "int8q_masking": lambda: fc(train=tp(ship_dtype="int8q"),
                                    **masking),
        "topk16": lambda: fc(train=tp(ship_dtype="topk16")),
        "topk_zero": lambda: fc(train=tp(ship_dtype="topk0")),
        "topk_masking": lambda: fc(train=tp(ship_dtype="topk"), **masking),
        "unknown_dtype": lambda: fc(train=tp(ship_dtype="int9q")),
        "downlink_bf16": lambda: fc(train=tp(downlink_dtype="bf16")),
        "downlink_int": lambda: fc(train=tp(downlink_dtype="i32")),
        "downlink_masking": lambda: fc(train=tp(downlink_dtype="bf16"),
                                       **masking),
        "downlink_topk": lambda: fc(train=tp(downlink_dtype="bf16",
                                             ship_dtype="topk16")),
        "local_regex": lambda: fc(train=tp(local_tensor_regex="bias")),
        "local_regex_broken": lambda: fc(train=tp(local_tensor_regex="[")),
        "local_regex_fedadam": lambda: fc(
            aggregation=ac(rule="fedadam"),
            train=tp(local_tensor_regex="bias")),
        "local_regex_dp": lambda: fc(train=tp(local_tensor_regex="bias",
                                              dp_clip_norm=1.0)),
        "local_regex_masking": lambda: fc(
            train=tp(local_tensor_regex="bias"), **masking),
        "ship_regex": lambda: fc(train=tp(ship_tensor_regex="lora_")),
        "ship_regex_masking": lambda: fc(
            train=tp(ship_tensor_regex="lora_"), **masking),
        "ship_and_local": lambda: fc(train=tp(ship_tensor_regex="lora_",
                                              local_tensor_regex="bias")),
        "ship_regex_dp": lambda: fc(train=tp(ship_tensor_regex="lora_",
                                             dp_clip_norm=1.0)),
    }


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type is the outcome
        return type(exc).__name__
    return None


@pytest.mark.parametrize("name", sorted(_uplink_configs("port")))
def test_the_uplink_config_checks_match_the_jax_package(name):
    assert _outcome(_uplink_configs("port")[name]) == _outcome(
        _uplink_configs("jax")[name])
