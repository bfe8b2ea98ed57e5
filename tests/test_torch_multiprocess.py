"""The multi-process federation over localhost gRPC, across packages.

- A port controller process serves JAX learner processes, and a JAX
  controller process serves port learner processes (an MLP, 2 learners x
  2 rounds). Each learner's recipe records every downlink and uplink it
  trains from and ships; each round's community model must be bit for bit
  the FedAvg re-fold, by the controller's own package, of the uplinks of
  that round. Training waits for a gate file that the test writes once
  both learners have joined, so round 0's cohort is the whole federation.
- ``examples/torch_fashionmnist.py --device cpu`` runs 3 learners x 3
  rounds through ``DriverSession`` at a reduced size; accuracy rises and
  every process exits 0.
- The wall-clock and the metric cutoffs stop a ``DriverSession`` run that
  has no round limit.

Every server binds port 0; every wait is bounded; every process started
here is killed in a ``finally``.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import cloudpickle
import numpy as np
import pytest

from metisfl_tpu.aggregation import FedAvg as JaxFedAvg
from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
from metisfl_tpu.config import EvalConfig as JaxEvalConfig
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import TerminationConfig as JaxTerminationConfig
from metisfl_tpu.scaling import make_scaler as jax_make_scaler
from metisfl_tpu_torch.aggregation import FedAvg
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.comm.rpc import RpcClient
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.controller.service import (
    LEARNER_SERVICE,
    ControllerClient,
)
from metisfl_tpu_torch.driver import DriverSession
from metisfl_tpu_torch.models import TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP
from metisfl_tpu_torch.scaling import make_scaler
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 2
WAIT_S = 90.0


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


def _arrays(sizes, d=6, classes=3, seed=7):
    """Shards of a linearly separable 3-class task, and a test split."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, classes)).astype(np.float32)

    def draw(n):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x, np.argmax(x @ w, axis=-1).astype(np.int32)

    return [draw(n) for n in sizes], draw(120)


def _recipe(kind, x, y, test, out_dir, seed, gate):
    """A learner recipe of either package whose engine writes, per train
    call r, ``down_r.npz`` (the weights it starts from: the community
    model it received) and ``up_r.npz`` (the weights it ships). Training
    waits for ``gate`` to exist."""

    def recipe():
        import os
        import time

        import numpy as np

        if kind == "torch":
            from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
            from metisfl_tpu_torch.models.zoo import MLP
            ops = TorchModelOps(MLP(6, (16,), 3), rng_seed=0, device="cpu")
        else:
            from metisfl_tpu.models import FlaxModelOps
            from metisfl_tpu.models.dataset import ArrayDataset
            from metisfl_tpu.models.zoo import MLP
            ops = FlaxModelOps(MLP(features=(16,), num_outputs=3), x[:2],
                               rng_seed=0)

        def flat(tree, prefix=""):
            out = {}
            for key in sorted(tree):
                name = f"{prefix}/{key}" if prefix else key
                if isinstance(tree[key], dict):
                    out.update(flat(tree[key], name))
                else:
                    out[name] = np.asarray(tree[key])
            return out

        train, calls = ops.train, []

        def recorded(dataset, params, *args, **kwargs):
            deadline = time.time() + 60
            while not os.path.exists(gate) and time.time() < deadline:
                time.sleep(0.05)
            r = len(calls)
            calls.append(r)
            np.savez(os.path.join(out_dir, f"down_{r}.npz"),
                     **flat(ops.get_variables()))
            out = train(dataset, params, *args, **kwargs)
            np.savez(os.path.join(out_dir, f"up_{r}.npz"),
                     **flat(out.variables))
            return out

        ops.train = recorded
        return ops, ArrayDataset(x, y, seed=seed), None, ArrayDataset(*test)

    return recipe


@contextlib.contextmanager
def _recipes_by_value():
    """Recipes defined here travel by value: the learner processes cannot
    import this test module."""
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(module)


def _dump_recipe(path, recipe):
    with _recipes_by_value(), open(path, "wb") as f:
        cloudpickle.dump(recipe, f)


def _spawn(args, log_path):
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, *args], stdout=log,
                                stderr=subprocess.STDOUT, env=_env(),
                                cwd=REPO)


def _wait_log(proc, log_path, pattern, timeout=WAIT_S):
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


def _wait_until(predicate, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def _kill_all(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


def _refold(package, uplinks, sizes):
    """FedAvg of ``uplinks`` ({name: array} per learner, in the order the
    controller folded them) weighted by the package's train_dataset_size
    scaler, in that package's fold."""
    scaler = (make_scaler if package == "torch"
              else jax_make_scaler)("train_dataset_size")
    ids = [f"L{i}" for i in range(len(uplinks))]
    scales = scaler({lid: {"num_train_examples": n, "completed_batches": 0}
                     for lid, n in zip(ids, sizes)})
    rule = FedAvg() if package == "torch" else JaxFedAvg()
    out = rule.aggregate([([up], scales[lid])
                          for lid, up in zip(ids, uplinks)])
    return {k: np.asarray(v) for k, v in out.items()}


def _indices_by_id(client, tmp_path, n):
    """learner id → the index of the process that joined under it (each
    learner prints the port it bound, and the controller lists them)."""
    ports = {}
    for i in range(n):
        with open(tmp_path / f"learner_{i}.log") as f:
            ports[int(re.search(r"LEARNER_READY port=(\d+)",
                                f.read()).group(1))] = i
    return {ep["learner_id"]: ports[ep["port"]]
            for ep in client.list_learners()}


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("controller_kind,learner_kind",
                         [("torch", "jax"), ("jax", "torch")])
def test_cross_package_processes(tmp_path, controller_kind, learner_kind):
    sizes = (40, 70)
    shards, test = _arrays(sizes)
    gate = str(tmp_path / "gate")
    train = dict(batch_size=16, local_steps=3, learning_rate=0.1)
    if controller_kind == "torch":
        config = FederationConfig(
            controller_port=0,
            aggregation=AggregationConfig(scaler="train_dataset_size"),
            train=TrainParams(**train),
            eval=EvalConfig(batch_size=64, datasets=["test"]),
            termination=TerminationConfig(federation_rounds=ROUNDS))
        module = "metisfl_tpu_torch"
    else:
        config = JaxFederationConfig(
            controller_port=0,
            aggregation=JaxAggregationConfig(scaler="train_dataset_size"),
            train=JaxTrainParams(**train),
            eval=JaxEvalConfig(batch_size=64, datasets=["test"]),
            termination=JaxTerminationConfig(federation_rounds=ROUNDS))
        module = "metisfl_tpu"
    cfg_path = tmp_path / "federation_config.bin"
    cfg_path.write_bytes(config.to_wire())
    learner_module = ("metisfl_tpu_torch" if learner_kind == "torch"
                      else "metisfl_tpu")
    procs = []
    client = None
    try:
        log = str(tmp_path / "controller.log")
        procs.append(_spawn(["-m", f"{module}.controller", "--config",
                             str(cfg_path), "--port", "0"], log))
        port = int(_wait_log(procs[0], log,
                             r"CONTROLLER_READY port=(\d+)").group(1))
        client = ControllerClient("127.0.0.1", port)
        template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                                 device="cpu").get_variables()
        assert client.replace_community_model(pack_model(template))
        for i, (x, y) in enumerate(shards):
            out_dir = tmp_path / f"learner_{i}"
            out_dir.mkdir()
            recipe_path = str(tmp_path / f"recipe_{i}.pkl")
            _dump_recipe(recipe_path, _recipe(learner_kind, x, y, test,
                                              str(out_dir), i, gate))
            args = ["-m", f"{learner_module}.learner",
                    "--controller-host", "127.0.0.1",
                    "--controller-port", str(port), "--port", "0",
                    "--advertise-host", "127.0.0.1",
                    "--recipe", recipe_path]
            if learner_kind == "torch":
                args += ["--device", "cpu"]
            procs.append(_spawn(args, str(tmp_path / f"learner_{i}.log")))
        assert _wait_until(lambda: len(client.list_learners()) == 2)
        index = _indices_by_id(client, tmp_path, 2)
        open(gate, "w").close()
        assert _wait_until(lambda: client.get_runtime_metadata(tail=1)[
            "global_iteration"] >= ROUNDS)
        stats = client.get_statistics()
        # the JAX controller trains on: round ROUNDS's downlinks carry the
        # last checked community; the port's stops, and serves it
        final = {}
        if controller_kind == "torch":
            final = {name: to_numpy(t) for name, t in ModelBlob.from_bytes(
                client.get_community_model()).tensors}
        else:
            assert _wait_until(lambda: all(
                (tmp_path / f"learner_{i}" / f"down_{ROUNDS}.npz").exists()
                for i in range(2)))
        for r in range(ROUNDS):
            order = [index[lid] for lid in
                     stats["round_metadata"][r]["selected_learners"]]
            assert sorted(order) == [0, 1]
            ups = [_load(tmp_path / f"learner_{i}" / f"up_{r}.npz")
                   for i in order]
            want = _refold(controller_kind, ups, [sizes[i] for i in order])
            if r + 1 < ROUNDS or controller_kind == "jax":
                gots = [_load(tmp_path / f"learner_{i}" / f"down_{r + 1}.npz")
                        for i in range(2)]
            else:
                gots = [final]
            for got in gots:
                assert sorted(got) == sorted(want)
                for name in want:
                    assert got[name].dtype == want[name].dtype
                    assert got[name].tobytes() == want[name].tobytes(), (
                        r, name)
        for ep in client.list_learners():
            learner = RpcClient(ep["hostname"], ep["port"], LEARNER_SERVICE,
                                retries=0)
            learner.call("ShutDown", b"", timeout=10.0)
            learner.close()
        for proc in procs[1:]:
            assert proc.wait(timeout=60) == 0
        assert client.shutdown_controller()
        assert procs[0].wait(timeout=30) == 0
    finally:
        if client is not None:
            client.close()
        _kill_all(procs)


def test_example_runs_three_learners_three_rounds_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "torch_fashionmnist.py"),
         "--device", "cpu", "--learners", "3", "--rounds", "3",
         "--examples-per-learner", "200", "--test-examples", "200",
         "--batch-size", "32", "--noise", "0.8",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["rounds"] == 3
    acc = result["accuracy"]
    assert len(acc) == 3 and acc[-1] > acc[0] and acc[-1] > 0.1, acc
    assert result["exit_codes"] == {
        "controller": 0, "learner_0": 0, "learner_1": 0, "learner_2": 0}
    with open(tmp_path / "experiment.json") as f:
        assert json.load(f)["global_iteration"] == 3


def _mlp_recipe(x, y, test, seed):
    def recipe():
        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP
        return (TorchModelOps(MLP(6, (16,), 3), rng_seed=0, device="cpu"),
                ArrayDataset(x, y, seed=seed), None, ArrayDataset(*test))

    return recipe


@pytest.mark.parametrize("cutoff", ["wall_clock", "metric"])
def test_cutoffs_stop_a_run_without_a_round_limit(tmp_path, cutoff):
    shards, test = _arrays((60, 60))
    term = TerminationConfig(federation_rounds=0)
    if cutoff == "wall_clock":
        term.execution_cutoff_mins = 6.0 / 60
    else:
        # the wall clock is only the backstop here
        term.metric_cutoff_score = 0.6
        term.execution_cutoff_mins = 1.0
    config = FederationConfig(
        controller_port=0,
        train=TrainParams(batch_size=16, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        termination=term)
    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    session = DriverSession(config, template,
                            [_mlp_recipe(x, y, test, i)
                             for i, (x, y) in enumerate(shards)],
                            workdir=str(tmp_path), device="cpu")
    try:
        with _recipes_by_value():
            session.initialize_federation()
        # the wall clock runs from the learners' launch
        t0 = time.time()
        stats = session.monitor_federation(poll_every_s=0.2,
                                           eval_drain_timeout_s=30.0)
        elapsed = time.time() - t0
    finally:
        session.shutdown_federation()
    assert session.process_exit_codes() == {
        "controller": 0, "learner_0": 0, "learner_1": 0}
    if cutoff == "wall_clock":
        # with no round limit only the cutoff ends the run (under load the
        # learners may not have finished a round by then)
        assert 5.5 <= elapsed < 30.0
    else:
        assert elapsed < 55.0  # the metric fired, not the backstop
        score = DriverSession._latest_mean_metric(
            stats["community_evaluations"], "accuracy")
        assert score is not None and score >= 0.6


def test_driver_session_passes_the_store_settings_through(tmp_path):
    """The controller process builds the configured store and ingest
    plane: a cached_disk store under the given root, written by 2 ingest
    writers (the round metadata records each writer's insert)."""
    from metisfl_tpu_torch.config import ModelStoreConfig

    shards, test = _arrays((60, 60))
    root = tmp_path / "store"
    config = FederationConfig(
        controller_port=0,
        train=TrainParams(batch_size=16, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=2),
        model_store=ModelStoreConfig(store="cached_disk", root=str(root),
                                     cache_mb=1, ingest_workers=2))
    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    session = DriverSession(config, template,
                            [_mlp_recipe(x, y, test, i)
                             for i, (x, y) in enumerate(shards)],
                            workdir=str(tmp_path / "run"), device="cpu")
    try:
        with _recipes_by_value():
            session.initialize_federation()
        stats = session.monitor_federation(poll_every_s=0.2,
                                           eval_drain_timeout_s=30.0)
    finally:
        session.shutdown_federation()
    assert session.process_exit_codes() == {
        "controller": 0, "learner_0": 0, "learner_1": 0}
    assert root.is_dir()
    for meta in stats["round_metadata"][:2]:
        assert sorted(meta["ingest_write_duration_ms"]) == sorted(
            meta["selected_learners"])
        assert meta["ingest_drain_duration_ms"] >= 0.0


def test_what_is_not_ported_is_refused_before_any_process_starts(tmp_path):
    from metisfl_tpu_torch.config import LearnerEndpoint
    from metisfl_tpu_torch.controller.__main__ import main as controller_main
    from metisfl_tpu_torch.driver.session import LocalLauncher, SSHLauncher

    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    # the SSH launcher is ported: it is built, and picked for a remote
    # endpoint (tests/test_torch_deploy.py launches through it)
    launcher = SSHLauncher("remote-host", str(tmp_path))
    assert (launcher.host, launcher.workdir) == ("remote-host", str(tmp_path))
    # resume is ported: the session boots its controller with --resume
    assert DriverSession(FederationConfig(), template, [], resume=True,
                         workdir=str(tmp_path / "resumed")).resume
    remote = DriverSession(
        FederationConfig(learners=[LearnerEndpoint(hostname="node-7")]),
        template, [_mlp_recipe(*_arrays((8,))[0][0], None, 0)],
        workdir=str(tmp_path))
    picked = remote._launcher_for(remote._endpoint(0).hostname)
    assert isinstance(picked, SSHLauncher) and picked.host == "node-7"
    assert isinstance(remote._launcher_for("localhost"), LocalLauncher)
    assert remote.process_exit_codes() == {}
    # serving is ported: a session whose config does not enable it has no
    # gateway to dial
    with pytest.raises(RuntimeError, match="serving is not enabled"):
        remote.serving_client()
    # trace collection is ported: before any process wrote a span there is
    # nothing to collect, and no post-mortem bundle
    assert remote.collect_traces() is None
    assert remote.collect_postmortems() == []
    cfg = tmp_path / "federation_config.bin"
    cfg.write_bytes(FederationConfig().to_wire())
    # --standby and --resume are ported: each refuses a config without
    # what it needs (the standby and its WAL; a checkpoint directory)
    # before any server starts
    for flag in ("--standby", "--resume"):
        with pytest.raises(SystemExit) as exc:
            controller_main(["--config", str(cfg), flag, "--device", "cpu"])
        assert exc.value.code == 2


def test_learner_refuses_an_engine_off_the_expected_device(tmp_path):
    """``--device cuda`` (the default) with a recipe that built its engine
    on the CPU: the learner stops before it serves or joins."""
    from metisfl_tpu_torch.learner.__main__ import main as learner_main

    shards, test = _arrays((8,))
    path = str(tmp_path / "recipe.pkl")
    _dump_recipe(path, _mlp_recipe(*shards[0], test, 0))
    import signal

    saved = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(SystemExit) as exit_info:
            learner_main(["--controller-port", "1", "--recipe", path])
    finally:
        signal.signal(signal.SIGTERM, saved)
    assert exit_info.value.code == 2
