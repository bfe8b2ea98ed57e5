"""The distributed slice tier of the port against the JAX package's.

- The spool: for the same submit the port's spool file has the JAX
  package's bytes, and each package reads the other's; torn files are
  skipped, hostile learner ids round-trip, a relaunched aggregator
  reloads its spool.
- The bits: a slice's fold equals a ``TreeReducer`` worker's; the port's
  ``DistributedSliceReducer.reduce`` gives the JAX reducer's bits at
  branch 2 and 3; mixed fleets (the port's reducer against JAX slices
  over loopback gRPC, and the reverse) give the unmixed bits.
- Re-homing: one of three slice aggregator processes SIGKILLed after it
  acked its first uplink; the round completes with the undisturbed
  control's bits. Every aggregator dead degrades to the root; a submit to
  a dead fleet parks at the root; ``forget`` reaches slices outside the
  round's assignment.
- Masking composes with the tier, and with streaming over it: the settled
  sum is within 1e-9 of the float64 mean.
- The controller with ``distributed: true`` is storeless and gives the
  JAX controller's community (1e-5); ``DriverSession`` boots a two-slice
  fleet, runs 2 rounds through it and reaps every process.
- The tier's config rejections raise in both packages with one error
  type.

Folds in this process are pinned to numpy in both packages
(``_hostfold_lib = False``, as in tests/test_torch_aggregation.py), so
bits compare across packages; the tolerance is 0 ulp wherever bits are
said to match.
"""

import contextlib
import os
import signal
import socket
import subprocess
import sys
import time

import cloudpickle
import numpy as np
import pytest

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.aggregation import slice as jax_slice
from metisfl_tpu.aggregation.distributed import (
    DistributedSliceReducer as JaxReducer,
)
from metisfl_tpu.comm.messages import JoinRequest as JaxJoinRequest
from metisfl_tpu.comm.messages import TaskResult as JaxTaskResult
from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
from metisfl_tpu.config import EvalConfig as JaxEvalConfig
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import ModelStoreConfig as JaxModelStoreConfig
from metisfl_tpu.config import SecureAggConfig as JaxSecureAggConfig
from metisfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from metisfl_tpu.config import TreeAggregationConfig as JaxTreeConfig
from metisfl_tpu.controller.core import Controller as JaxController
from metisfl_tpu.tensor.pytree import pack_model as jax_pack_model
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.aggregation.distributed import (
    ROOT,
    DistributedSliceReducer,
)
from metisfl_tpu_torch.aggregation.slice import (
    SLICE_SERVICE,
    SliceAggregator,
    SliceClient,
    SliceServer,
    read_spool,
    read_spool_records,
    spool_path,
)
from metisfl_tpu_torch.aggregation.tree import _DEFAULT_SUBBLOCK, TreeReducer
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.comm.health import probe_health
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    ModelStoreConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.config.federation import (
    SecureAggConfig,
    TreeAggregationConfig,
)
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.secure import MaskingBackend, recovery
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy
from metisfl_tpu_torch.tensor.spec import TensorKind, TensorSpec, wire_dtype_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def numpy_fold():
    """Both packages' host folds without their native libraries."""
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


def _model(i, r=0, integer=False):
    rng = np.random.default_rng(1000 * r + i)
    if integer:
        return {"enc/w": rng.integers(-8, 8, (6, 4)).astype(np.float32),
                "head/b": rng.integers(-8, 8, 4).astype(np.float32)}
    return {"enc/w": rng.standard_normal((6, 4)).astype(np.float32),
            "head/b": rng.standard_normal(4).astype(np.float32)}


def _blob(model):
    return ModelBlob(tensors=sorted(model.items())).to_bytes()


def _same_bits(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _acc(reply):
    return {n: to_numpy(t)
            for n, t in ModelBlob.from_bytes(reply["acc"]).tensors}


def _boot(tmp_path, n, server_cls=SliceServer, tag="p"):
    servers, specs = [], []
    for i in range(n):
        spool = str(tmp_path / f"{tag}_slice_{i}")
        server = server_cls(spool_dir=spool, name=f"slice_{i}",
                            host="127.0.0.1", port=0)
        port = server.start()
        servers.append(server)
        specs.append({"name": f"slice_{i}", "host": "127.0.0.1",
                      "port": port, "spool_dir": spool})
    return servers, specs


def _reducer(specs, cls=DistributedSliceReducer,
             tree_cls=TreeAggregationConfig, retries=2, backoff=0.02,
             **kwargs):
    return cls(tree_cls(enabled=True, branch=len(specs), distributed=True,
                        slices=list(specs), rehome_retries=retries,
                        rehome_backoff_s=backoff), **kwargs)


def _stop(servers, *reducers):
    for red in reducers:
        red.shutdown()
    for server in servers:
        server.stop()


# -- the spool ----------------------------------------------------------------

def test_the_spool_file_is_the_jax_packages_and_each_reads_the_others(
        tmp_path):
    ids = ["L0_localhost_50100", "L1_[::1]:443_7", "a?b"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    port = SliceAggregator(spool_dir=port_dir, name="s0")
    ref = jax_slice.SliceAggregator(spool_dir=jax_dir, name="s0")
    for r, lid in enumerate(ids):
        blob = _blob(_model(r, r))
        port.submit(lid, r, blob)
        ref.submit(lid, r, blob)
        # acked means durable: the file is there when submit returns
        got = spool_path(port_dir, lid)
        want = jax_slice.spool_path(jax_dir, lid)
        assert os.path.basename(got) == os.path.basename(want)
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    for reader, directory in ((read_spool_records, jax_dir),
                              (jax_slice.read_spool_records, port_dir)):
        records = reader(directory)
        assert sorted(records) == sorted(ids)
        for r, lid in enumerate(ids):
            assert records[lid] == (r, _blob(_model(r, r)))


def test_torn_spool_files_are_skipped_and_hostile_ids_round_trip(tmp_path):
    spool = str(tmp_path / "s0")
    agg = SliceAggregator(spool_dir=spool, name="s0")
    agg.submit("LA", 0, _blob(_model(1)))
    with open(os.path.join(spool, "torn.bin"), "wb") as fh:
        fh.write(b"\x00garbage")
    assert sorted(read_spool(spool)) == ["LA"]
    # two distinct hostile ids that sanitize alike keep their own records
    agg.submit("a:b", 0, _blob(_model(4)))
    agg.submit("a?b", 0, _blob(_model(5)))
    recovered = read_spool(spool)
    assert {"LA", "a:b", "a?b"} == set(recovered)
    for lid, i in (("a:b", 4), ("a?b", 5)):
        assert recovered[lid] == _blob(_model(i))


def test_a_relaunched_aggregator_reloads_its_spool(tmp_path):
    spool = str(tmp_path / "s0")
    first = SliceAggregator(spool_dir=spool, name="s0")
    models = {f"L{i}": _model(i) for i in range(3)}
    for lid, m in models.items():
        first.submit(lid, 0, _blob(m))
    relaunched = SliceAggregator(spool_dir=spool, name="s0")
    scales = {lid: 1.0 for lid in models}
    reply = relaunched.fold(sorted(models), scales)
    assert reply["count"] == 3 and relaunched.stats()["held"] == 3
    ref = TreeReducer._fold_slice(
        sorted(models), scales, lambda b: {lid: [models[lid]] for lid in b},
        _DEFAULT_SUBBLOCK)
    _same_bits(_acc(reply), ref.acc)


# -- the tier's bits ----------------------------------------------------------

def test_a_slice_fold_is_a_tree_workers_bit_for_bit():
    agg = SliceAggregator(spool_dir="", name="s0")
    ids = [f"L{i:02d}" for i in range(9)]
    models = {lid: _model(i) for i, lid in enumerate(ids)}
    scales = {lid: 0.25 + 0.125 * i for i, lid in enumerate(ids)}
    for lid in ids:
        agg.submit(lid, 0, _blob(models[lid]))
    for stride in (0, 4):
        reply = agg.fold(ids, scales, stride=stride)
        ref = TreeReducer._fold_slice(
            ids, scales, lambda b: {lid: [models[lid]] for lid in b},
            stride or _DEFAULT_SUBBLOCK)
        assert reply["count"] == ref.count == 9 and reply["z"] == ref.z
        assert tuple(reply["dtypes"]) == ref.dtypes
        assert reply["present"] == ids
        _same_bits(_acc(reply), ref.acc)
    # latest wins: a re-submission replaces the held model
    agg.submit(ids[0], 1, _blob(_model(77)))
    _same_bits(_acc(agg.fold([ids[0]], {ids[0]: 1.0})), _model(77))


def test_the_slice_service_answers_over_grpc(tmp_path):
    servers, specs = _boot(tmp_path, 1)
    client = SliceClient(specs[0]["host"], specs[0]["port"])
    try:
        assert probe_health(specs[0]["host"], specs[0]["port"],
                            SLICE_SERVICE) == "SERVING"
        client.submit("LA", 0, _blob(_model(1)))
        client.submit("LB", 0, _blob(_model(2)))
        reply = client.fold(["LA", "LB"], {"LA": 1.0, "LB": 1.0})
        assert reply["count"] == 2 and reply["present"] == ["LA", "LB"]
        stats = client.describe()
        assert stats["held"] == 2 and stats["uplinks"] == 2
        assert stats["bytes_digest"] and stats["top_bytes"]
        assert client.forget(["LA"])["dropped"] == 1
        assert client.describe()["held"] == 1
        assert not os.path.exists(spool_path(specs[0]["spool_dir"], "LA"))
    finally:
        client.close()
        _stop(servers)


def _reduce(reducer, ids, models, scales, stride=0):
    reducer.assign(ids)
    for lid in ids:
        assert reducer.submit(lid, models[lid], 0)
    return reducer.reduce(ids, scales, stride=stride, round_id=0)


@pytest.mark.parametrize("branch", [2, 3])
def test_the_distributed_reduce_is_the_jax_reducers(tmp_path, branch):
    ids = [f"L{i:02d}" for i in range(8)]
    models = {lid: _model(i) for i, lid in enumerate(ids)}
    scales = {lid: 1.0 + 0.5 * i for i, lid in enumerate(ids)}
    port_servers, port_specs = _boot(tmp_path, branch)
    jax_servers, jax_specs = _boot(tmp_path, branch, jax_slice.SliceServer,
                                   "j")
    port = _reducer(port_specs)
    ref = _reducer(jax_specs, JaxReducer, JaxTreeConfig)
    try:
        for stride in (0, 2):
            got, partials, errors = _reduce(port, ids, models, scales,
                                            stride)
            want, _, _ = _reduce(ref, ids, models, scales, stride)
            assert not errors and len(partials) == branch
            _same_bits(got, want)
        # the in-process tree over the same sorted cohort, on integer
        # payloads (reassociation-proof)
        ints = {lid: _model(i, integer=True) for i, lid in enumerate(ids)}
        got, _, _ = _reduce(port, ids, ints, {lid: 1.0 for lid in ids})
        tree = TreeReducer(branch=branch)
        want, _ = tree.reduce(sorted(ids), {lid: 1.0 for lid in ids},
                              lambda b: {lid: [ints[lid]] for lid in b})
        tree.shutdown()
        _same_bits(got, want)
    finally:
        _stop(port_servers + jax_servers, port, ref)


@pytest.mark.parametrize("reducer_pkg", ["port", "jax"])
def test_mixed_fleets_give_the_unmixed_bits(tmp_path, reducer_pkg):
    """The port's reducer against JAX slice servers, and the JAX reducer
    against the port's, over loopback gRPC."""
    ids = [f"L{i:02d}" for i in range(7)]
    models = {lid: _model(i, 3) for i, lid in enumerate(ids)}
    scales = {lid: 2.0 + i for i, lid in enumerate(ids)}
    same_cls = SliceServer if reducer_pkg == "port" else \
        jax_slice.SliceServer
    other_cls = jax_slice.SliceServer if reducer_pkg == "port" else \
        SliceServer
    red_cls, tree_cls = ((DistributedSliceReducer, TreeAggregationConfig)
                         if reducer_pkg == "port"
                         else (JaxReducer, JaxTreeConfig))
    same, same_specs = _boot(tmp_path, 3, same_cls, "same")
    other, other_specs = _boot(tmp_path, 3, other_cls, "other")
    unmixed = _reducer(same_specs, red_cls, tree_cls)
    mixed = _reducer(other_specs, red_cls, tree_cls)
    try:
        want, _, _ = _reduce(unmixed, ids, models, scales)
        got, partials, errors = _reduce(mixed, ids, models, scales)
        assert not errors and sum(p.count for p in partials) == 7
        _same_bits(got, want)
        assert mixed.describe()["uplinks_total"] == 7
    finally:
        _stop(same + other, unmixed, mixed)


# -- re-homing ----------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


@contextlib.contextmanager
def _slice_processes(tmp_path, n):
    """``n`` slice aggregator processes of the port
    (``python -m metisfl_tpu_torch.aggregation.slice``), healthy."""
    procs, specs = [], []
    tmp_path.mkdir(parents=True, exist_ok=True)
    try:
        for i in range(n):
            port, spool = _free_port(), str(tmp_path / f"slice_{i}")
            log = open(tmp_path / f"slice_{i}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "metisfl_tpu_torch.aggregation.slice",
                 "--host", "127.0.0.1", "--port", str(port), "--spool-dir",
                 spool, "--name", f"slice_{i}"],
                stdout=log, stderr=subprocess.STDOUT, env=_env(), cwd=REPO))
            log.close()
            specs.append({"name": f"slice_{i}", "host": "127.0.0.1",
                          "port": port, "spool_dir": spool})
        deadline = time.time() + 120
        for spec in specs:
            while probe_health(spec["host"], spec["port"],
                               SLICE_SERVICE) != "SERVING":
                assert time.time() < deadline, "a slice never served"
                time.sleep(0.1)
        yield procs, specs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def test_a_slice_process_killed_mid_round_rehomes_to_the_controls_bits(
        tmp_path):
    ids = [f"L{i:02d}" for i in range(12)]
    models = {lid: _model(i, 5) for i, lid in enumerate(ids)}
    scales = {lid: 1.0 / 12 for lid in ids}

    def run(kill):
        with _slice_processes(tmp_path / ("kill" if kill else "control"),
                              3) as (procs, specs):
            red = _reducer(specs)
            try:
                red.assign(ids)
                for n, lid in enumerate(ids):
                    red.submit(lid, models[lid], 0)
                    if kill and n == 0:
                        # slice 0 acked its first uplink (spooled): gone
                        procs[0].send_signal(signal.SIGKILL)
                        procs[0].wait(timeout=10)
                community, partials, _ = red.reduce(ids, scales,
                                                    round_id=0)
                # group boundaries follow the assignment, not liveness
                assert len(partials) == 3
                assert sum(p.count for p in partials) == 12
                return community, red.describe()
            finally:
                red.shutdown()

    killed, killed_desc = run(kill=True)
    control, control_desc = run(kill=False)
    assert killed_desc["rehomed_total"] >= 1
    assert control_desc["rehomed_total"] == 0
    assert [r["dead"] for r in killed_desc["slices"]] == [True, False, False]
    _same_bits(killed, control)


def test_every_aggregator_dead_degrades_to_the_root(tmp_path):
    servers, specs = _boot(tmp_path, 3)
    red = _reducer(specs)
    ids = [f"L{i:02d}" for i in range(6)]
    models = {lid: _model(i, integer=True) for i, lid in enumerate(ids)}
    scales = {lid: 1.0 for lid in ids}
    try:
        red.assign(ids)
        for lid in ids:
            red.submit(lid, models[lid], 0)
        for server in servers:
            server.stop()
        community, partials, errors = red.reduce(ids, scales, round_id=0)
        assert errors  # the degradation is reported
        assert sum(p.count for p in partials) == 6
        tree = TreeReducer(branch=3)
        want, _ = tree.reduce(sorted(ids), scales,
                              lambda b: {lid: [models[lid]] for lid in b})
        tree.shutdown()
        _same_bits(community, want)
    finally:
        _stop(servers, red)


def test_a_submit_to_a_dead_fleet_parks_at_the_root(tmp_path):
    servers, specs = _boot(tmp_path, 2)
    red = _reducer(specs, retries=1, backoff=0.01)
    try:
        for server in servers:
            server.stop()
        red.assign(["LA"])
        assert red.submit("LA", _model(1), 0) is False
        community = red.reduce(["LA"], {"LA": 1.0}, round_id=0)[0]
        _same_bits(community, _model(1))
        assert red.describe()["root_residual"] == 1
        red.round_complete()
        assert red.describe()["root_residual"] == 0
    finally:
        _stop(servers, red)


def test_forget_reaches_slices_outside_the_assignment(tmp_path):
    servers, specs = _boot(tmp_path, 2)
    red = _reducer(specs)
    try:
        red.assign(["LA", "LB"])
        red.submit("LA", _model(1), 0)
        owner = red._base_owner("LA")
        red.assign(["LC", "LD"])   # the next round's cohort leaves LA out
        assert red._base_owner("LA") == ROOT
        red.forget("LA")
        client = SliceClient(specs[owner]["host"], specs[owner]["port"])
        try:
            assert client.describe()["held"] == 0
        finally:
            client.close()
        assert not os.path.exists(spool_path(specs[owner]["spool_dir"],
                                             "LA"))
    finally:
        _stop(servers, red)


# -- masking over the tier ----------------------------------------------------

N_DIM = 257


def _masked(backends, idx, rid, plains):
    spec = TensorSpec((N_DIM,), wire_dtype_of(np.dtype(np.float32)),
                      TensorKind.MASKED)
    backends[idx].begin_round(rid)
    return ModelBlob(opaque={"w": (backends[idx].encrypt(plains[idx]),
                                   spec)}).to_bytes()


@pytest.mark.parametrize("stream", [False, True])
def test_masking_composes_with_the_distributed_tier(tmp_path, stream):
    n = 4
    rng = np.random.default_rng(0)
    plains = [rng.standard_normal(N_DIM) * 0.1 for _ in range(n)]
    backends = [MaskingBackend("s3cret", party_index=i, num_parties=n)
                for i in range(n)]
    servers, specs = _boot(tmp_path, 2)
    red = _reducer(specs, masked=True, stream=stream)
    ids = [f"L{i}" for i in range(n)]
    try:
        for rid, kill in ((3, False), (4, True)):
            red.assign(ids)
            for i in range(n):
                assert red.submit(ids[i], _masked(backends, i, rid, plains),
                                  rid)
            # a byte-identical re-ship is skipped, never counted twice
            red.submit(ids[2], _masked(backends, 2, rid, plains), rid)
            if kill:
                servers[0].stop()   # its spool re-homes the masked sums
            sums, _, present, _ = red.reduce_masked(ids, rid)
            assert sorted(present) == ids
            payloads, report = recovery.settle(
                sums, {lid: i for i, lid in enumerate(ids)}, n, 2, rid,
                lambda *a: None)
            got = np.frombuffer(payloads["w"], np.float64)
            assert not report.dropped
            assert np.abs(got - np.mean(plains, axis=0)).max() <= 1e-9
    finally:
        _stop(servers, red)


# -- the controller -----------------------------------------------------------

class _NullProxy:
    def __init__(self, record):
        self.learner_id = record.learner_id

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass


def _controller_rounds(ctrl, join_cls, result_cls, pack, rounds=2, n=6):
    seed = {"enc/w": np.zeros((6, 4), np.float32),
            "head/b": np.zeros((4,), np.float32)}
    ctrl.set_community_model(pack(seed))
    for i in range(n):
        ctrl.join(join_cls(hostname="h", port=7500 + i,
                           num_train_examples=10 + i))
    lids = sorted(ctrl.active_learners())
    with ctrl._lock:
        tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
    for r in range(rounds):
        for i, lid in enumerate(lids):
            assert ctrl.task_completed(result_cls(
                task_id=f"t{r}_{lid}", learner_id=lid,
                auth_token=tokens[lid], model=pack(_model(i, r)),
                round_id=r, completed_batches=1))
        deadline = time.time() + 60.0
        while ctrl.global_iteration <= r:
            assert time.time() < deadline, f"round {r} never completed"
            time.sleep(0.01)
    return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(
        ctrl.community_model_bytes()).tensors}


def test_the_controller_is_storeless_and_gives_the_jax_community(tmp_path):
    port_servers, port_specs = _boot(tmp_path, 3)
    jax_servers, jax_specs = _boot(tmp_path, 3, jax_slice.SliceServer, "j")
    port = Controller(FederationConfig(
        aggregation=AggregationConfig(tree=TreeAggregationConfig(
            enabled=True, branch=3, distributed=True, slices=port_specs,
            rehome_retries=2, rehome_backoff_s=0.02)),
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=0)),
        proxy_factory=_NullProxy, device="cpu")
    ref = JaxController(JaxFederationConfig(
        aggregation=JaxAggregationConfig(tree=JaxTreeConfig(
            enabled=True, branch=3, distributed=True, slices=jax_specs,
            rehome_retries=2, rehome_backoff_s=0.02)),
        train=JaxTrainParams(batch_size=4, local_steps=1),
        eval=JaxEvalConfig(every_n_rounds=0),
        telemetry=JaxTelemetryConfig(enabled=False)),
        proxy_factory=_NullProxy)
    touched = []
    for name in ("insert", "select"):
        fn = getattr(port._store, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            touched.append(_name)
            return _fn(*args, **kwargs)

        setattr(port._store, name, counted)
    try:
        got = _controller_rounds(port, JoinRequest, TaskResult, pack_model)
        want = {k: np.asarray(v) for k, v in _controller_rounds(
            ref, JaxJoinRequest, JaxTaskResult, jax_pack_model).items()}
        assert touched == [] and port._store.learner_ids() == []
        snap = port.describe()["slices"]
        assert snap["alive"] == 3 and snap["uplinks_total"] >= 6
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 1e-5, k
    finally:
        port.shutdown()
        ref.shutdown()
        _stop(port_servers + jax_servers)


def _mlp_recipe(x, y, seed):
    def recipe():
        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP
        return (TorchModelOps(MLP(6, (16,), 3), rng_seed=0, device="cpu"),
                ArrayDataset(x, y, seed=seed), None, None)

    return recipe


def test_driver_session_boots_runs_and_reaps_a_slice_fleet(tmp_path):
    from metisfl_tpu_torch.driver import DriverSession
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    shards = []
    for _ in range(2):
        x = rng.standard_normal((32, 6)).astype(np.float32)
        shards.append((x, np.argmax(x @ w, -1).astype(np.int32)))
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(
            scaler="participants",
            tree=TreeAggregationConfig(enabled=True, branch=2,
                                       distributed=True)),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=2))
    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    session = DriverSession(config, template,
                            [_mlp_recipe(x, y, i)
                             for i, (x, y) in enumerate(shards)],
                            workdir=str(tmp_path), device="cpu")
    module = sys.modules[__name__]
    try:
        cloudpickle.register_pickle_by_value(module)
        try:
            session.initialize_federation()
        finally:
            cloudpickle.unregister_pickle_by_value(module)
        slices = config.aggregation.tree.slices
        assert [s["name"] for s in slices] == ["slice_0", "slice_1"]
        procs = [p for p in session._procs if p.name.startswith("slice_")]
        assert len(procs) == 2 and all(p.process.poll() is None
                                       for p in procs)
        stats = session.monitor_federation(poll_every_s=0.2,
                                           eval_drain_timeout_s=10.0)
        assert stats["global_iteration"] >= 2
        # round 1's cohort was dispatched together: it went through the
        # slices, whose spools hold the learners' uplinks
        spooled = set()
        for spec in slices:
            spooled |= set(read_spool(spec["spool_dir"]))
        assert spooled == set(stats["learners"])
    finally:
        session.shutdown_federation()
    assert session.process_exit_codes() == {
        "controller": 0, "learner_0": 0, "learner_1": 0, "slice_0": 0,
        "slice_1": 0}


# -- the config ---------------------------------------------------------------

def _tier_configs(pkg):
    if pkg == "port":
        fc, ac, tc, sc, mc = (FederationConfig, AggregationConfig,
                              TreeAggregationConfig, SecureAggConfig,
                              ModelStoreConfig)
    else:
        fc, ac, tc, sc, mc = (JaxFederationConfig, JaxAggregationConfig,
                              JaxTreeConfig, JaxSecureAggConfig,
                              JaxModelStoreConfig)

    def tree(**kw):
        return tc(**{"enabled": True, "distributed": True, **kw})

    masking = dict(rule="secure_agg", scaler="participants")
    return {
        "not_enabled": lambda: fc(aggregation=ac(
            tree=tc(distributed=True))),
        "plain_streaming": lambda: fc(aggregation=ac(
            streaming=True, tree=tree())),
        "masking": lambda: fc(aggregation=ac(tree=tree(), **masking),
                              secure=sc(enabled=True, scheme="masking")),
        "masking_streaming": lambda: fc(
            aggregation=ac(tree=tree(), streaming=True, **masking),
            secure=sc(enabled=True, scheme="masking")),
        "ckks": lambda: fc(aggregation=ac(tree=tree(), **masking),
                           secure=sc(enabled=True, scheme="ckks")),
        "ingest": lambda: fc(aggregation=ac(tree=tree()),
                             model_store=mc(ingest_workers=2)),
        "no_backoff": lambda: fc(aggregation=ac(
            tree=tree(rehome_backoff_s=0.0))),
        "negative_retries": lambda: fc(aggregation=ac(
            tree=tree(rehome_retries=-1))),
        "median": lambda: fc(aggregation=ac(rule="median", tree=tree())),
        "scaffold": lambda: fc(aggregation=ac(rule="scaffold", tree=tree())),
        "fedstride": lambda: fc(aggregation=ac(rule="fedstride",
                                               tree=tree())),
    }


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type is the outcome
        return type(exc).__name__
    return None


@pytest.mark.parametrize("name", sorted(_tier_configs("port")))
def test_the_tiers_config_checks_match_the_jax_package(name):
    got = _outcome(_tier_configs("port")[name])
    want = _outcome(_tier_configs("jax")[name])
    assert got == want
