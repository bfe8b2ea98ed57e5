"""The SSH launcher of the port's DriverSession, mirroring
tests/test_deploy.py: the ssh command's shape, the launcher picked per
endpoint, the scp commands with ssh's ``-p`` as ``-P``, and launches
through ``ssh``/``scp`` shims on ``PATH`` that run locally (there is no
second host here). Then a 2-learner MLP round on the CPU in which one
learner's endpoint is ``127.0.0.2``, a non-local name for this machine:
its recipe is shipped, it launches through the shims, the round
completes, every process exits 0, and the ShutDown RPC reaches it at
that hostname. Training waits for a gate file that the test writes once
both learners have joined, so round 0's cohort is both. Every
subprocess wait is bounded (60 s, and the federation's own 120 s
wall-clock cutoff).
"""

import os
import stat
import subprocess
import sys
import time

import numpy as np

from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.config import (
    EvalConfig,
    FederationConfig,
    LearnerEndpoint,
    TerminationConfig,
)
from metisfl_tpu_torch.driver.session import (
    DriverSession,
    LocalLauncher,
    SSHLauncher,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMOTE = "127.0.0.2"


def test_ssh_command_shape():
    launcher = SSHLauncher("worker1", "/tmp/w", python="python3",
                           ssh_options=["-o", "BatchMode=yes"])
    cmd = launcher.command(
        ["python3", "-m", "metisfl_tpu_torch.learner", "--port", "0"],
        {"PYTHONPATH": "/srv/repo"})
    assert cmd[:4] == ["ssh", "-o", "BatchMode=yes", "worker1"]
    assert cmd[4].startswith("PYTHONPATH=/srv/repo ")
    assert "python3 -m metisfl_tpu_torch.learner --port 0" in cmd[4]


def test_launcher_selected_per_endpoint(tmp_path):
    cfg = FederationConfig(learners=[
        LearnerEndpoint(hostname="localhost"),
        LearnerEndpoint(hostname="10.0.0.5"),
    ])
    session = DriverSession(
        cfg, {"params": {"w": np.zeros(2, np.float32)}},
        [lambda: None, lambda: None], workdir=str(tmp_path), device="cpu")
    for host in ("localhost", "", "127.0.0.1"):
        assert isinstance(session._launcher_for(host), LocalLauncher)
    remote = session._launcher_for("10.0.0.5")
    assert isinstance(remote, SSHLauncher)
    assert remote.host == "10.0.0.5" and remote.workdir == str(tmp_path)


def test_ssh_ship_commands_same_absolute_paths(tmp_path):
    launcher = SSHLauncher("worker1", "/tmp/w", ssh_options=["-p", "2222"])
    recipe = str(tmp_path / "r.pkl")
    cert = str(tmp_path / "tls" / "cert.pem")
    cmds = launcher.ship_commands([recipe, cert])
    # one mkdir over ssh covering both parent dirs, then one scp per file;
    # the ssh port flag -p must translate to scp's -P
    assert cmds[0][:4] == ["ssh", "-p", "2222", "worker1"]
    assert f"mkdir -p {tmp_path}" in cmds[0][4]
    assert f"mkdir -p {tmp_path / 'tls'}" in cmds[0][4]
    assert cmds[1] == ["scp", "-q", "-P", "2222", recipe, f"worker1:{recipe}"]
    assert cmds[2] == ["scp", "-q", "-P", "2222", cert, f"worker1:{cert}"]


def _install_shims(bindir, remote_root=None):
    """Fake ``ssh`` (drops its options, takes <host> <cmd>, runs the
    command here) and ``scp`` (copies to ``$REMOTE_ROOT<path>``, or to the
    path itself when REMOTE_ROOT is unset); each call is appended to
    ``<bindir>/calls``."""
    bindir.mkdir()
    calls = bindir / "calls"
    (bindir / "ssh").write_text(
        "#!/bin/sh\n"
        f'echo "ssh $*" >> "{calls}"\n'
        'while [ "$1" != "${1#-}" ]; do case "$1" in -p) shift 2;; '
        '*) shift;; esac; done\n'
        'shift\n'
        'exec sh -c "$1"\n')
    (bindir / "scp").write_text(
        "#!/bin/sh\n"
        f'echo "scp $*" >> "{calls}"\n'
        'while [ "$1" != "${1#-}" ]; do case "$1" in -P) shift 2;; '
        '*) shift;; esac; done\n'
        'src="$1"; dst="${2#*:}"\n'
        'mkdir -p "$REMOTE_ROOT$(dirname "$dst")"\n'
        'if [ "$src" -ef "$REMOTE_ROOT$dst" ]; then exit 0; fi\n'
        'exec cp "$src" "$REMOTE_ROOT$dst"\n')
    for shim in ("ssh", "scp"):
        path = bindir / shim
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return calls


def test_ssh_launcher_end_to_end_with_path_shim(tmp_path, monkeypatch):
    """ship and launch through the shims: the files land at their
    absolute paths under the fake remote root, and the remote command
    runs with its environment; stop() signals the process where it runs
    through ssh (its pid file), not the local ssh client."""
    bindir = tmp_path / "bin"
    remote_root = tmp_path / "remote"
    _install_shims(bindir)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("REMOTE_ROOT", str(remote_root))

    launcher = SSHLauncher("testhost", str(tmp_path),
                           ssh_options=["-p", "2222"])
    payload = tmp_path / "cfg" / "federation.bin"
    payload.parent.mkdir()
    payload.write_bytes(b"\x01\x02\x03")
    for cmd in launcher.ship_commands([str(payload)]):
        subprocess.run(cmd, check=True, timeout=60)
    shipped = remote_root / str(payload).lstrip("/")
    assert shipped.read_bytes() == b"\x01\x02\x03"

    proc = launcher.launch(
        "probe", [sys.executable, "-c",
                  "import os; print('ssh-probe', os.environ['FED_MARK'])"],
        env={"FED_MARK": "ok42"})
    assert proc.process.wait(timeout=60) == 0
    assert "ssh-probe ok42" in open(proc.log_path).read()

    sleeper = launcher.launch(
        "sleeper", [sys.executable, "-c",
                    "import time; print('up', flush=True); time.sleep(60)"],
        env={})
    deadline = time.time() + 60
    while "up" not in open(sleeper.log_path).read():
        assert time.time() < deadline and sleeper.process.poll() is None
        time.sleep(0.05)
    launcher.stop(sleeper)
    assert sleeper.process.wait(timeout=60) == -15  # SIGTERM, at its pid


def _recipe(x, y, test, seed, gate):
    """A learner whose training waits (at most 60 s) for ``gate`` to
    exist."""
    def recipe():
        import os
        import time

        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP
        ops = TorchModelOps(MLP(6, (16,), 3), rng_seed=0, device="cpu")
        train = ops.train

        def gated(*args, **kwargs):
            deadline = time.time() + 60
            while not os.path.exists(gate) and time.time() < deadline:
                time.sleep(0.05)
            return train(*args, **kwargs)

        ops.train = gated
        return ops, ArrayDataset(x, y, seed=seed), None, ArrayDataset(*test)

    return recipe


def test_a_learner_on_a_remote_endpoint_runs_through_ssh(tmp_path,
                                                         monkeypatch):
    import cloudpickle

    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    bindir = tmp_path / "bin"
    calls = _install_shims(bindir)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    # one host, one filesystem: the shipped files land on themselves
    monkeypatch.delenv("REMOTE_ROOT", raising=False)

    rng = np.random.default_rng(7)
    w = rng.standard_normal((6, 3)).astype(np.float32)

    def draw(n):
        x = rng.standard_normal((n, 6)).astype(np.float32)
        return x, np.argmax(x @ w, axis=-1).astype(np.int32)

    shards, test = [draw(60), draw(60)], draw(60)
    config = FederationConfig(
        controller_port=0,
        train=TrainParams(batch_size=16, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        # the rounds end the run; the wall clock bounds it
        termination=TerminationConfig(federation_rounds=1,
                                      execution_cutoff_mins=2.0),
        learners=[LearnerEndpoint(hostname="localhost"),
                  LearnerEndpoint(hostname=REMOTE)])
    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    gate = str(tmp_path / "gate")
    session = DriverSession(config, template,
                            [_recipe(x, y, test, i, gate)
                             for i, (x, y) in enumerate(shards)],
                            workdir=str(tmp_path / "run"), device="cpu")
    assert isinstance(session._launcher_for(REMOTE), SSHLauncher)
    dialled = []
    shut_down = session._shut_down_learner

    def record(hostname, port):
        dialled.append((hostname, port))
        shut_down(hostname, port)

    session._shut_down_learner = record
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        session.initialize_federation(health_retries=120)
        # hold training until both learners have joined
        deadline = time.time() + 60
        while len(session._client.list_learners(timeout=10.0)) < 2:
            assert time.time() < deadline, "the learners never both joined"
            time.sleep(0.1)
        open(gate, "w").close()
        stats = session.monitor_federation(poll_every_s=0.2,
                                           eval_drain_timeout_s=30.0)
        endpoints = session._client.list_learners(timeout=10.0)
    finally:
        cloudpickle.unregister_pickle_by_value(module)
        session.shutdown_federation(timeout_s=60.0)
    assert stats["global_iteration"] >= 1
    assert len(stats["round_metadata"][0]["selected_learners"]) == 2
    assert session.process_exit_codes() == {
        "controller": 0, "learner_0": 0, "learner_1": 0}
    # the remote learner registered, and was dialled, at its hostname
    remote = [(ep["hostname"], ep["port"]) for ep in endpoints
              if ep["hostname"] == REMOTE]
    assert len(remote) == 1 and remote[0] in dialled
    assert not any(h == "localhost" and p == remote[0][1]
                   for h, p in dialled)
    log = open(tmp_path / "run" / "learner_1.log").read()
    assert "learner ShutDown RPC received" in log
    # it was launched over ssh after its recipe was shipped, and only it
    recipe = str(tmp_path / "run" / "learner_1_recipe.pkl")
    lines = open(calls).read().splitlines()
    scp = [i for i, line in enumerate(lines)
           if line.startswith("scp") and f"{REMOTE}:{recipe}" in line]
    launch = [i for i, line in enumerate(lines)
              if line.startswith(f"ssh {REMOTE}")
              and "metisfl_tpu_torch.learner" in line]
    assert scp and launch and scp[0] < launch[0]
    assert not any("learner_0" in line for line in lines)


def _slow_recipe(x, y, test, seed, gate):
    """A learner whose training waits for ``gate`` and then takes 0.3 s
    more, so a failed dispatch's retry (0.05 s backoff) lands before any
    uplink of its round."""
    inner = _recipe(x, y, test, seed, gate)

    def recipe():
        import time

        built = inner()
        train = built[0].train

        def slow(*args, **kwargs):
            time.sleep(0.3)
            return train(*args, **kwargs)

        built[0].train = slow
        return built

    return recipe


def test_driver_arms_chaos_by_process_and_the_retry_ladder_replaces(
        tmp_path):
    """Four learner processes, participation 0.5 (two dispatched a round
after round 0, which the joins dispatch to all four). Chaos by
    ``process``: the controller's fifth RunTask (round 1's first
    dispatch; the four before it are the joins') is dropped on its client
    side, and learner 2's tasks run 3x slower. The failed dispatch counts
    against its learner (max_dispatch_failures 1) and quarantines it
    (quarantine_score 0.25); the retry dispatches a replacement in its
    round; it sits out every later round; every process exits 0."""
    import cloudpickle

    from metisfl_tpu_torch.config import AggregationConfig, SchedulingConfig
    from metisfl_tpu_torch.config.federation import ChaosConfig
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 3)).astype(np.float32)

    def draw(n):
        x = rng.standard_normal((n, 6)).astype(np.float32)
        return x, np.argmax(x @ w, axis=-1).astype(np.int32)

    shards, test = [draw(40) for _ in range(4)], draw(40)
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="participants",
                                      participation_ratio=0.5),
        scheduling=SchedulingConfig(dispatch_retries=1,
                                    retry_backoff_s=0.05,
                                    quarantine_score=0.25,
                                    quarantine_s=120.0),
        max_dispatch_failures=1,
        chaos=ChaosConfig(enabled=True, seed=5, rules=[
            {"fault": "drop", "side": "client", "method": "RunTask",
             "process": "controller", "after_calls": 4, "max_fires": 1},
            {"fault": "slow", "factor": 3.0, "process": "learner_2"}]),
        train=TrainParams(batch_size=16, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=64, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=4,
                                      execution_cutoff_mins=2.0),
        learners=[LearnerEndpoint() for _ in shards])
    template = TorchModelOps(MLP(6, (16,), 3), rng_seed=0,
                             device="cpu").get_variables()
    gate = str(tmp_path / "gate")
    session = DriverSession(config, template,
                            [_slow_recipe(x, y, test, i, gate)
                             for i, (x, y) in enumerate(shards)],
                            workdir=str(tmp_path / "run"), device="cpu")
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        session.initialize_federation(health_retries=120)
        deadline = time.time() + 60
        while len(session._client.list_learners(timeout=10.0)) < 4:
            assert time.time() < deadline, "the learners never all joined"
            time.sleep(0.1)
        open(gate, "w").close()
        stats = session.monitor_federation(poll_every_s=0.2,
                                           eval_drain_timeout_s=30.0)
    finally:
        cloudpickle.unregister_pickle_by_value(module)
        session.shutdown_federation(timeout_s=60.0)
    assert session.process_exit_codes() == {
        "controller": 0, "learner_0": 0, "learner_1": 0, "learner_2": 0,
        "learner_3": 0}
    run = tmp_path / "run"
    ctrl_log = open(run / "controller.log").read()
    retries = [line for line in ctrl_log.splitlines()
               if "dispatch retry 1: replacing unreachable" in line]
    assert len(retries) == 1, ctrl_log[-3000:]
    failed, replacement = retries[0].split("unreachable ")[1].split(
        " with ")
    assert "quarantined" in ctrl_log and failed in ctrl_log
    metas = stats["round_metadata"]
    assert stats["global_iteration"] >= 4
    # round 1: two dispatched, one of them failed, one replacement
    assert set(metas[1]["train_submitted_at"]) == {
        failed, replacement, *metas[1]["selected_learners"]}
    assert len(metas[1]["train_submitted_at"]) == 3
    assert failed not in metas[1]["selected_learners"]
    assert replacement in metas[1]["selected_learners"]
    for meta in metas[2:4]:
        assert failed not in meta["train_submitted_at"]
        assert len(meta["selected_learners"]) == 2
    # chaos reached learner 2 only: its log shows the slow fault
    assert "slowing train task by 3.0x" in open(run / "learner_2.log").read()
    for idx in (0, 1, 3):
        assert "chaos" not in open(run / f"learner_{idx}.log").read()
