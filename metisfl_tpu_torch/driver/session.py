"""DriverSession: a multi-process federation run from the user's script.

The port's copy of the JAX package's ``driver/session.py``: it writes the
config, boots the controller (``python -m metisfl_tpu_torch.controller``)
and one learner process per recipe (``python -m
metisfl_tpu_torch.learner``), waits for the controller to answer, ships
the seed model, watches the three termination criteria
(rounds, wall clock, a community metric), collects the statistics and
shuts every process down. Models and data travel as one cloudpickled
recipe per learner and one ModelBlob; the statistics land in
``experiment.json``.

Each process runs where its endpoint says: ``""``, ``localhost`` and
``127.0.0.1`` as a local subprocess (:class:`LocalLauncher`), any other
host over ``ssh`` (:class:`SSHLauncher`, the reference's fabric bootstrap),
after ``scp`` has copied its files (the config, the learner's recipe and
secure-aggregation material, the TLS pair) to the same absolute paths
there. Where the controller runs on this host, the learners boot beside
it (``--wait-for-model``: each joins once the controller holds the seed
model, so round 0's tasks go out as they join); under a remote
controller they are launched after the seed model is shipped. The remote
host is
assumed to hold the repo at the same path (``PYTHONPATH`` names the local
package root) and an interpreter named by the launcher's ``python``. A
process's output comes back through the local ``ssh`` client into
``<workdir>/<name>.log``, which is where the controller's ephemeral port
is read. At shutdown every learner is dialled at the endpoint it
registered with the controller (or its configured host and logged port),
and one that does not serve yet is stopped where it runs (over ssh for a
remote one), never by signalling the local ``ssh`` client alone.

Secure aggregation: before the controller boots, the driver makes each
learner's material (CKKS keys in ``<workdir>/he_keys`` unless
``secure.key_dir`` names a directory that holds them, or one masking
federation secret with a party index per learner, and ``secure.
num_parties``) and writes it to ``<workdir>/learner_<i>_secure.bin``,
which the learner reads through ``--secure-config``. The controller's
config carries no decryption capability.

The distributed slice tier (``aggregation.tree.distributed``): before the
config is written DriverSession gives each of ``branch`` slice aggregators a
localhost port and a spool directory under ``<workdir>/slices`` (unless
``tree.slices`` lists the fleet), boots them (``python -m
metisfl_tpu_torch.aggregation.slice --config <file> --index <i>``) and
waits until each answers its health check, all before the controller, so
round 1's first uplink never meets a half-up slice. While the federation
runs, a slice process that died is relaunched with a doubling backoff
(its spool reloads; the controller re-adopts it at a later round's
assignment); at shutdown each gets the ShutDown RPC and is reaped.

Chaos (``chaos.enabled``): each original controller, standby, learner and
slice process gets the rules whose ``process`` selector names it
(``controller``, ``standby``, ``learner``, ``learner_<i>``, ``slice``,
``slice_<i>``, or none for every process) through the ``METISFL_TPU_CHAOS``
env var; a relaunch runs clean, so a kill rule cannot re-fire on every
restart and a failover can be shown to converge.

Controller failover. Under ``failover.supervise_controller`` (the
default) the checkpoint directory defaults to ``<workdir>/checkpoint``,
and a controller that dies while the federation runs is relaunched with
``--resume`` on its port after a doubling backoff, at most
``max_controller_restarts`` times (the learners re-attach on the new
epoch). Under ``controller.standby`` the standby's port and WAL directory
(``<workdir>/wal``) are pinned before the config is written, the warm
standby boots right behind the primary, and every learner and the
driver's own client hold both endpoints; a dead primary is never
relaunched: the driver waits for the standby to promote itself (probe
driven) and hands the controller endpoint over to it. A warm standby that
dies is relaunched within the same budget; a second controller death
after the handoff fails the run. ``resume=True`` boots the controller
with ``--resume`` and ships the seed model only when the checkpoint held
no round.

The port's controller dispatches no train task after
``termination.federation_rounds`` rounds, so the rounds criterion ends an
idle federation; the two cutoffs end one mid-round.

Telemetry: the span sinks and the post-mortem directory default into the
workdir (``<workdir>/telemetry``, ``<workdir>/postmortem``) and reach the
learners as ``--telemetry-dir``/``--postmortem-dir``; the driver arms its
own flight recorder, so a supervised relaunch or a standby handoff leaves a
driver-side bundle beside its ``FailoverBegan`` event, and the handoff
counts ``controller_failover_total{role="driver"}`` and emits
``ControllerFailover``. :meth:`DriverSession.collect_traces` merges every
local process's span file into ``<workdir>/traces.jsonl`` (render it with
``python -m metisfl_tpu_torch.telemetry``), and
:meth:`DriverSession.collect_postmortems` gathers the bundles.

Serving (``serving.enabled``, with the registry): every serving port is
pinned before the config is written (the gateway's, or under
``serving.fleet`` one per replica and the router's, which ``serving.port``
then names). The gateway (``python -m metisfl_tpu_torch.serving``), or
the fleet's replicas and its router (``--router``), boot beside the
learners and run the learners' recipe ``serving.recipe_index`` on the
driver's ``device``. :meth:`DriverSession.serving_client` dials the
gateway or the router. A serving process that dies is relaunched with a
doubling backoff capped at 30 s; a relaunched replica needs no state of
its own (its first registry poll pins it back to the promoted versions)
and a relaunched router is re-told the fleet's replicas. Serving never
fails the run. With ``serving.fleet.scale_up``/``scale_down`` rules the
driver scrapes the fleet's ``serving_*`` families each poll and boots a
replica (``AddReplica`` out of the ring until it probes SERVING) or drains
the newest one (``DrainReplica``, an idle wait, ``ShutDown``,
``RemoveReplica``) within ``min_replicas``/``max_replicas``.
:meth:`DriverSession.monitor_federation` supervises and autoscales the
serving plane; once it returned, :meth:`DriverSession.poll_serving` does
one such tick. :meth:`DriverSession.run_inference` runs the community
model's inference (or greedy generation) on one learner
(``RunInference``).

The fleet fabric's live span stream is not ported (ROADMAP.md Queue 1
item 4b).
"""

from __future__ import annotations

import json
import logging
import os
import re
import secrets
import shlex
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import cloudpickle
import numpy as np

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.aggregation.slice import SLICE_SERVICE
from metisfl_tpu_torch.chaos import ENV_VAR as CHAOS_ENV_VAR
from metisfl_tpu_torch.comm.codec import dumps as codec_dumps
from metisfl_tpu_torch.comm.codec import loads as codec_loads
from metisfl_tpu_torch.comm.health import probe_health
from metisfl_tpu_torch.comm.rpc import RpcClient
from metisfl_tpu_torch.config import FederationConfig, LearnerEndpoint
from metisfl_tpu_torch.controller.service import (
    CONTROLLER_SERVICE,
    LEARNER_SERVICE,
    ControllerClient,
)
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import postmortem as _tpostmortem
from metisfl_tpu_torch.tensor.pytree import pack_model

logger = logging.getLogger("metisfl_tpu_torch.driver")

_M_CTRL_RESTARTS = _tmetrics.registry().counter(
    _tel.M_CONTROLLER_RESTARTS_TOTAL,
    "Supervised controller relaunches with --resume (driver side)")
_M_CTRL_FAILOVER = _tmetrics.registry().counter(
    _tel.M_CONTROLLER_FAILOVER_TOTAL,
    "Standby promotions to controller, by role of the emitting process",
    ("role",))

_M_GATEWAY_RESTARTS = _tmetrics.registry().counter(
    _tel.M_GATEWAY_RESTARTS_TOTAL,
    "Supervised serving-gateway relaunches after a crash")
_M_FLEET_REPLICAS = _tmetrics.registry().gauge(
    _tel.M_SERVING_FLEET_REPLICAS,
    "Serving-fleet replica count as the autoscaler maintains it")
_M_SCALE_TOTAL = _tmetrics.registry().counter(
    _tel.M_SERVING_SCALE_TOTAL,
    "Autoscaler actions on the serving fleet", ("direction",))

_CONTROLLER_READY = re.compile(r"METISFL_TPU_CONTROLLER_READY port=(\d+)")
_SERVING_READY = re.compile(
    r"METISFL_TPU_(?:SERVING|ROUTER)_READY port=(\d+)(?: at=([0-9.]+))?")
_PROMOTED = "METISFL_TPU_CONTROLLER_PROMOTED"
_LEARNER_READY = re.compile(r"METISFL_TPU_LEARNER_READY port=(\d+)")


@dataclass
class _Proc:
    name: str
    process: subprocess.Popen
    log_path: str
    # what launched it (stops it where it runs)
    launcher: Any = None
    started_at: float = field(default_factory=time.time)
    # seconds from the launch to the process's READY line, once seen
    ready_s: Optional[float] = None


def _free_port() -> int:
    """A port that is free on this host now (the controller binds it a
    moment later)."""
    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def _terminate_process(process: subprocess.Popen,
                       grace_s: float = 5.0) -> None:
    """terminate → wait → kill → reap, never raising: a process stuck in
    the kernel must not abort the caller's loop, and the last wait records
    its exit code instead of leaving a zombie."""
    if process.poll() is not None:
        return
    process.terminate()
    try:
        process.wait(timeout=grace_s)
        return
    except subprocess.TimeoutExpired:
        pass
    process.kill()
    try:
        process.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:  # pragma: no cover - unkillable
        pass


class LocalLauncher:
    """Launch federation processes as localhost subprocesses, each logging
    to ``<workdir>/<name>.log``."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.python = sys.executable

    def launch(self, name: str, argv: Sequence[str],
               env: Dict[str, str]) -> _Proc:
        log_path = os.path.join(self.workdir, f"{name}.log")
        with open(log_path, "w") as log:
            process = subprocess.Popen(
                list(argv), stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, **env})
        return _Proc(name, process, log_path, self)

    def stop(self, proc: _Proc) -> None:
        """Ask the process to exit (SIGTERM)."""
        if proc.process.poll() is None:
            proc.process.terminate()


class SSHLauncher:
    """Launch federation processes on a remote host over ``ssh`` (the
    reference's fabric path, driver_session.py:506-582). The repo and the
    interpreter ``python`` must exist at the same paths on the host;
    :meth:`ship` copies files to it. ``ssh_options`` go to every ``ssh``
    (and, translated, ``scp``) call."""

    def __init__(self, host: str, workdir: str, python: str = "python3",
                 ssh_options: Sequence[str] = ()):
        self.host = host
        self.workdir = workdir
        self.python = python
        self.ssh_options = list(ssh_options)

    def command(self, argv: Sequence[str], env: Dict[str, str]) -> List[str]:
        """``ssh [options] host 'K=V ... argv'``."""
        env_prefix = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        remote_cmd = (f"{env_prefix} "
                      f"{' '.join(shlex.quote(a) for a in argv)}").strip()
        return ["ssh", *self.ssh_options, self.host, remote_cmd]

    def _scp_options(self) -> List[str]:
        """``ssh_options`` translated for scp: the same flags but the port
        (``ssh -p`` is ``scp -P``; to scp, ``-p`` preserves times and the
        port number would parse as a stray source operand)."""
        out: List[str] = []
        it = iter(self.ssh_options)
        for opt in it:
            if opt == "-p":
                out += ["-P", next(it, "")]
            else:
                out.append(opt)
        return out

    def ship_commands(self, paths: Sequence[str]) -> List[List[str]]:
        """Commands that copy local files to the same absolute paths on
        the host: one ``mkdir -p`` over ssh for their directories, then one
        ``scp`` per file."""
        dirs = sorted({os.path.dirname(os.path.abspath(p)) for p in paths})
        mkdir = " && ".join(f"mkdir -p {shlex.quote(d)}" for d in dirs)
        cmds: List[List[str]] = [["ssh", *self.ssh_options, self.host, mkdir]]
        scp_opts = self._scp_options()
        for p in paths:
            p = os.path.abspath(p)
            cmds.append(["scp", "-q", *scp_opts, p, f"{self.host}:{p}"])
        return cmds

    def ship(self, paths: Sequence[str]) -> None:
        for cmd in self.ship_commands(paths):
            subprocess.run(cmd, check=True)

    def _pid_path(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.pid")

    def launch(self, name: str, argv: Sequence[str],
               env: Dict[str, str]) -> _Proc:
        """Run ``argv`` on the host; its output streams back through the
        local ssh client into ``<workdir>/<name>.log``. The remote shell
        records its pid in ``<workdir>/<name>.pid`` there and execs the
        process, so :meth:`stop` can signal it where it runs."""
        log_path = os.path.join(self.workdir, f"{name}.log")
        words = [f"{k}={shlex.quote(v)}" for k, v in env.items()]
        words += [shlex.quote(a) for a in argv]
        remote = (f"echo $$ > {shlex.quote(self._pid_path(name))} && "
                  f"exec env {' '.join(words)}")
        with open(log_path, "w") as log:
            process = subprocess.Popen(
                ["ssh", *self.ssh_options, self.host, remote], stdout=log,
                stderr=subprocess.STDOUT)
        return _Proc(name, process, log_path, self)

    def stop(self, proc: _Proc) -> None:
        """SIGTERM the process on the host (signalling the local ssh client
        would leave it running there)."""
        pid = shlex.quote(self._pid_path(proc.name))
        subprocess.run(
            ["ssh", *self.ssh_options, self.host,
             f"test -f {pid} && kill -TERM \"$(cat {pid})\""],
            check=False, timeout=30, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)


class DriverSession:
    """Run a multi-process federation on its endpoints' hosts.

    ``learner_recipes``: one zero-argument callable per learner returning
    ``(model_ops, train_ds, val_ds, test_ds)``, run inside the learner's
    process. ``device`` is where every learner's engine must run
    (``cuda`` unless the caller says otherwise; a learner whose recipe
    built its engine elsewhere refuses to start) and where the controller
    runs the robust rules. ``resume``: the controller restores
    ``checkpoint.dir`` before it serves (module docstring)."""

    _LOCAL_HOSTS = ("", "localhost", "127.0.0.1")

    def __init__(
        self,
        config: FederationConfig,
        initial_model_variables: Any,
        learner_recipes: Sequence[Callable[[], tuple]],
        workdir: Optional[str] = None,
        learner_env: Optional[Dict[str, str]] = None,
        resume: bool = False,
        device: str = "cuda",
    ):
        self.config = config
        self.resume = resume
        self.initial_blob = pack_model(initial_model_variables)
        self.learner_recipes = list(learner_recipes)
        self.workdir = workdir or tempfile.mkdtemp(prefix="metisfl_torch_")
        os.makedirs(self.workdir, exist_ok=True)
        self.learner_env = learner_env or {}
        self.device = device
        self._local_launcher = LocalLauncher(self.workdir)
        self._procs: List[_Proc] = []
        self._client: Optional[ControllerClient] = None
        self._config_path = ""
        self._started_at = 0.0
        # slice aggregator supervision: relaunches so far and the earliest
        # time of the next, per slice index
        self._slice_restarts: Dict[int, int] = {}
        self._slice_restart_after: Dict[int, float] = {}
        self._shutting_down = False
        # chaos arms original incarnations only (_chaos_env)
        self._chaos_armed: set = set()
        # the controller's supervision: relaunches so far; the standby's
        # relaunches while warm and the earliest time of the next; whether
        # the controller endpoint was handed over to a promoted standby
        # (there is no third incarnation after that)
        self._controller_restarts = 0
        self._standby_restarts = 0
        self._standby_restart_after = 0.0
        self._standby_promoted = False
        # serving-plane supervision, per process name: relaunches so far
        # and the earliest time of the next; the fleet autoscaler
        self._serving_restarts: Dict[str, int] = {}
        self._serving_restart_after: Dict[str, float] = {}
        self._autoscaler = None

    # ------------------------------------------------------------------ #
    # bootstrap
    # ------------------------------------------------------------------ #

    def _launcher_for(self, hostname: str):
        """The local launcher for ``""``, ``localhost`` and ``127.0.0.1``,
        ssh for any other host."""
        if hostname in self._LOCAL_HOSTS:
            return self._local_launcher
        return SSHLauncher(hostname, self.workdir)

    def _ssl_files(self) -> List[str]:
        if not self.config.ssl.enabled:
            return []
        return [p for p in (self.config.ssl.cert_path,
                            self.config.ssl.key_path) if p]

    def _secure_path(self, idx: int) -> str:
        return os.path.join(self.workdir, f"learner_{idx}_secure.bin")

    def _prepare_secure(self) -> None:
        """Make and write each learner's secure-aggregation material (the
        reference's driver-side keygen and key shipping): CKKS keys, or the
        masking federation secret with each learner's party index. The
        controller's config learns only the scheme and the party count."""
        cfg = self.config.secure
        if not cfg.enabled:
            return
        n = len(self.learner_recipes)
        if cfg.scheme == "ckks":
            key_dir = cfg.key_dir or os.path.join(self.workdir, "he_keys")
            if not os.path.exists(os.path.join(key_dir, "sk.bin")):
                from metisfl_tpu_torch.secure.ckks import generate_keys
                generate_keys(key_dir)
            cfg.key_dir = key_dir
            files = [{"scheme": "ckks", "key_dir": key_dir, "kwargs": {}}] * n
        elif cfg.scheme == "masking":
            cfg.num_parties = n
            secret = secrets.token_hex(32)
            files = [{"scheme": "masking", "kwargs": {
                "federation_secret": secret, "party_index": idx,
                "num_parties": n, "min_parties": cfg.min_recovery_parties,
                "neighbors": cfg.mask_neighbors}} for idx in range(n)]
        else:  # identity
            files = [{"scheme": cfg.scheme, "kwargs": {}}] * n
        for idx, payload in enumerate(files):
            path = self._secure_path(idx)
            with open(path, "wb") as f:
                f.write(codec_dumps(payload))
            os.chmod(path, 0o600)

    def _secure_files(self, idx: int) -> List[str]:
        """The files learner ``idx`` needs for secure aggregation (shipped
        with its recipe to a remote host)."""
        if not self.config.secure.enabled:
            return []
        files = [self._secure_path(idx)]
        if self.config.secure.scheme == "ckks":
            key_dir = self.config.secure.key_dir
            files += [os.path.join(key_dir, "pk.bin"),
                      os.path.join(key_dir, "sk.bin")]
        return files

    def _endpoint(self, idx: int) -> LearnerEndpoint:
        if idx < len(self.config.learners):
            return self.config.learners[idx]
        return LearnerEndpoint()

    def _chaos_env(self, process: str,
                   idx: Optional[int] = None) -> Dict[str, str]:
        """The ``METISFL_TPU_CHAOS`` env of one subprocess: the configured
        chaos rules whose ``process`` selector matches (empty = every
        process; ``learner`` = any learner; ``learner_<idx>`` = one; the
        same for ``slice``). Only the original incarnation of a process is
        armed: a relaunch runs clean, so a kill rule cannot re-fire on
        every restart."""
        cfg = self.config.chaos
        name = process if idx is None else f"{process}_{idx}"
        if not cfg.enabled or not cfg.rules or name in self._chaos_armed:
            return {}
        self._chaos_armed.add(name)
        wanted = {"", process, name}
        rules = [r for r in cfg.rules if r.get("process", "") in wanted]
        if not rules:
            return {}
        return {CHAOS_ENV_VAR: json.dumps({"seed": cfg.seed,
                                           "rules": rules})}

    def _base_env(self) -> Dict[str, str]:
        # the package importable in the children whatever their cwd
        import metisfl_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(metisfl_tpu_torch.__file__)))
        pythonpath = os.pathsep.join(
            p for p in (pkg_root, os.environ.get("PYTHONPATH", "")) if p)
        return {"PYTHONPATH": pythonpath}

    def _prepare_telemetry(self) -> None:
        """The span sinks and the post-mortem directory default into the
        workdir, so the controller's and the learners' spans stitch into
        one tree on disk; the driver arms its own flight recorder."""
        tel = self.config.telemetry
        if not tel.enabled:
            return
        if not tel.dir:
            tel.dir = os.path.join(self.workdir, "telemetry")
        os.makedirs(tel.dir, exist_ok=True)
        if not tel.postmortem_dir:
            tel.postmortem_dir = os.path.join(self.workdir, "postmortem")
        os.makedirs(tel.postmortem_dir, exist_ok=True)
        _tpostmortem.configure(tel.postmortem_dir, service="driver",
                               install_hooks=False)

    def initialize_federation(self, health_retries: int = 60,
                              health_sleep_s: float = 0.5) -> None:
        """Make the secure material, boot the controller (and its standby)
        and (under a local controller, at once) the learners, wait until
        the controller answers, ship the seed model; the learners join
        once it holds the model."""
        self._prepare_secure()
        self._prepare_telemetry()
        ctrl_host = self.config.controller_host or "localhost"
        # a local controller's port is known before it boots, so the
        # learners' interpreters, recipes and devices start beside it; a
        # supervised relaunch binds the same port
        early = ctrl_host in self._LOCAL_HOSTS
        if early and not self.config.controller_port:
            self.config.controller_port = _free_port()
        # supervision restores from a checkpoint: default its directory
        # into the workdir
        if (self.config.failover.supervise_controller
                and not self.config.checkpoint.dir):
            self.config.checkpoint.dir = os.path.join(self.workdir,
                                                      "checkpoint")
        if self.config.checkpoint.dir:
            os.makedirs(self.config.checkpoint.dir, exist_ok=True)
        # the standby's endpoint and WAL directory, pinned before the config
        # is written: the controller appends to the WAL, the standby tails
        # it, and every peer holds both endpoints from the start
        standby = self.config.controller.standby
        if standby.enabled:
            if not standby.wal_dir:
                standby.wal_dir = os.path.join(self.workdir, "wal")
            os.makedirs(standby.wal_dir, exist_ok=True)
            if not standby.port:
                if (standby.host or "localhost") not in self._LOCAL_HOSTS:
                    raise ValueError(
                        "controller.standby on remote host "
                        f"{standby.host!r} requires an explicit "
                        "controller.standby.port")
                standby.port = _free_port()
        if self.config.ssl.enabled and not self.config.ssl.cert_path:
            # the federation's self-signed pair, made on first boot
            from metisfl_tpu_torch.comm.ssl import generate_self_signed
            cert, key = generate_self_signed(
                os.path.join(self.workdir, "tls"),
                hosts=[h for h in self.config.ssl.hosts
                       if h not in self._LOCAL_HOSTS])
            self.config.ssl.cert_path, self.config.ssl.key_path = cert, key
        self._plan_serving()
        if self._slices_distributed():
            self.start_slices()
        else:
            self._write_config()

        proc = self._launch_controller(resume=self.resume)
        if standby.enabled:
            # right behind the primary, so it tails the WAL from record one
            self._launch_standby()
        if early:
            for idx in range(len(self.learner_recipes)):
                self.launch_learner(idx, wait_for_model=True)
            self._launch_serving()
        deadline = time.time() + health_retries * health_sleep_s
        if not self.config.controller_port:
            # an ephemeral port: the controller prints the one it bound
            self.config.controller_port = self._wait_ready_port(proc,
                                                                deadline)
        self._client = ControllerClient(
            ctrl_host, self.config.controller_port, ssl=self.config.ssl,
            comm=self.config.comm, standby=self._standby_endpoint())
        self._wait_healthy(deadline, health_sleep_s)
        # the seed model, unless the controller resumed a checkpointed
        # round (it reports its restored round counter)
        if not (self.resume
                and self._client.get_statistics()["global_iteration"] > 0):
            self._client.replace_community_model(self.initial_blob)
        if not early:
            for idx in range(len(self.learner_recipes)):
                self.launch_learner(idx)
            self._launch_serving()
        self._started_at = time.time()

    def _standby_endpoint(self) -> Optional[tuple]:
        """The warm standby's ``(host, port)`` for the peers' two-endpoint
        clients; None without one, or once it took over."""
        standby = self.config.controller.standby
        if not standby.enabled or self._standby_promoted:
            return None
        return (standby.host or "localhost", standby.port)

    def _launch_controller(self, resume: bool = False) -> _Proc:
        """(Re)launch the controller on its port; ``resume`` restores the
        checkpoint and re-dispatches the abandoned round."""
        args = ["-m", "metisfl_tpu_torch.controller",
                "--config", self._config_path,
                "--port", str(self.config.controller_port),
                "--device", self.device]
        if resume:
            args.append("--resume")
        return self._launch("controller",
                            self.config.controller_host or "localhost", args,
                            env=self._chaos_env("controller"),
                            ship=[self._config_path])

    def _launch_standby(self) -> _Proc:
        """(Re)launch the warm standby (``--standby``): it tails the WAL and
        promotes itself when the primary dies; the driver only observes
        the promotion."""
        standby = self.config.controller.standby
        return self._launch("standby", standby.host or "localhost", [
            "-m", "metisfl_tpu_torch.controller",
            "--config", self._config_path,
            "--port", str(standby.port),
            "--device", self.device,
            "--standby"], env=self._chaos_env("standby"),
            ship=[self._config_path])

    def _supervise_controller(self) -> bool:
        """A controller process that died while the federation runs: hand
        over to the hot standby (under ``controller.standby``), or relaunch
        it with ``--resume`` within the restart budget, after a doubling
        backoff. True when a relaunch or a handoff happened; raises once the
        budget is spent or no standby is left (a controller that crashes
        every time must fail the run, not loop)."""
        ctrl = next((p for p in self._procs if p.name == "controller"), None)
        if (ctrl is None or self._shutting_down
                or ctrl.process.poll() is None):
            return False
        if self.config.controller.standby.enabled:
            # the primary is never relaunched: the standby takes over
            return self._failover_to_standby(ctrl)
        fo = self.config.failover
        if not fo.supervise_controller:
            return False  # _check_procs_alive reports the death
        code = ctrl.process.poll()
        if self._controller_restarts >= fo.max_controller_restarts:
            raise RuntimeError(
                f"controller died (exit {code}) with the restart budget "
                f"({fo.max_controller_restarts}) spent; log tail:\n"
                f"{self._log_tail(ctrl)}")
        self._controller_restarts += 1
        backoff = fo.restart_backoff_s * (2 ** (self._controller_restarts
                                                - 1))
        logger.warning(
            "controller died (exit %s); supervised restart %d/%d with "
            "--resume in %.1fs", code, self._controller_restarts,
            fo.max_controller_restarts, backoff)
        # the supervisor's own record of when it saw the death and what it
        # did about it
        _tevents.emit(_tevents.FailoverBegan,
                      restart=self._controller_restarts, exit_code=code)
        _tpostmortem.dump("failover_relaunch",
                          extra={"exit_code": code,
                                 "restart": self._controller_restarts})
        time.sleep(backoff)
        self._launch_controller(resume=True)
        _M_CTRL_RESTARTS.inc()
        try:
            self._wait_healthy(time.time() + 30.0, 0.5)
        except RuntimeError as exc:
            # the relaunch died too: spend the budget across supervision
            # cycles rather than abort with restarts left
            if self._controller_restarts >= fo.max_controller_restarts:
                raise
            logger.warning("relaunched controller not healthy (%s); "
                           "supervision will retry", exc)
            return True
        logger.info("controller restarted and healthy (restart %d)",
                    self._controller_restarts)
        return True

    def _failover_to_standby(self, ctrl: _Proc) -> bool:
        """A controller death under a hot standby: wait (bounded) until the
        standby's self-promotion answers SERVING for the controller
        service, then move ``controller_host``/``_port`` to it, so the
        shutdown and any learner relaunch follow; live peers redial on
        their own. A dead standby, or a second controller death after the
        handoff, is a double fault and fails the run."""
        code = ctrl.process.poll()
        standby = self.config.controller.standby
        host = standby.host or "localhost"
        sb = next((p for p in self._procs if p.name == "standby"), None)
        if self._standby_promoted or sb is None or (
                sb.process.poll() is not None):
            raise RuntimeError(
                f"controller died (exit {code}) with no live standby left "
                f"(double fault); log tail:\n{self._log_tail(ctrl)}")
        logger.warning("controller died (exit %s); waiting for standby "
                       "%s:%d to promote", code, host, standby.port)
        _tevents.emit(_tevents.FailoverBegan, restart=1, exit_code=code)
        _tpostmortem.dump("failover_handoff", extra={"exit_code": code})
        # one staleness window, the probe escalation, and room for the
        # WAL restore
        budget = (standby.stale_after_s
                  + standby.probe_interval_s * (standby.probe_failures + 2)
                  + 30.0)
        t0 = time.monotonic()
        while time.monotonic() - t0 < budget:
            if sb.process.poll() is not None:
                break  # died while promoting: the double fault below
            if probe_health(host, standby.port, CONTROLLER_SERVICE,
                            ssl=self.config.ssl,
                            comm=self.config.comm) == "SERVING":
                waited = time.monotonic() - t0
                self.config.controller_host = host
                self.config.controller_port = standby.port
                self._standby_promoted = True
                # the promoted standby is the controller now: the shutdown
                # waits on it and its death is the double fault above
                self._procs = [p for p in self._procs
                               if p.name != "controller"]
                sb.name = "controller"
                _M_CTRL_FAILOVER.inc(role="driver")
                _tevents.emit(_tevents.ControllerFailover, role="driver",
                              host=host, port=standby.port,
                              promote_s=round(waited, 4),
                              reason=f"controller_exit_{code}")
                logger.warning(
                    "standby promoted at %s:%d after %.1fs; controller "
                    "endpoint handed over", host, standby.port, waited)
                return True
            time.sleep(min(1.0, standby.probe_interval_s))
        raise RuntimeError(
            f"controller died (exit {code}) and the standby at "
            f"{host}:{standby.port} never promoted within {budget:.0f}s; "
            f"standby log tail:\n{self._log_tail(sb)}")

    def _supervise_standby(self) -> bool:
        """A warm standby that died is relaunched (it re-tails the WAL),
        within ``max_controller_restarts`` and a capped doubling backoff;
        past the budget the federation runs on without a standby (the next
        controller death is fatal). It never fails the run: the standby is
        redundancy, not the service."""
        standby = self.config.controller.standby
        if (not standby.enabled or self._standby_promoted
                or self._shutting_down):
            return False
        sb = next((p for p in self._procs if p.name == "standby"), None)
        if sb is None or sb.process.poll() is None:
            return False
        if time.time() < self._standby_restart_after:
            return False
        code = sb.process.poll()
        fo = self.config.failover
        if self._standby_restarts >= fo.max_controller_restarts:
            logger.error(
                "standby died (exit %s) with its relaunch budget (%d) spent;"
                " going on WITHOUT a standby: the next controller death is "
                "fatal", code, fo.max_controller_restarts)
            self._procs = [p for p in self._procs if p.name != "standby"]
            return False
        self._standby_restarts += 1
        backoff = fo.restart_backoff_s * (2 ** (self._standby_restarts - 1))
        self._standby_restart_after = time.time() + min(backoff, 60.0)
        logger.warning("standby died (exit %s); relaunch %d/%d", code,
                       self._standby_restarts, fo.max_controller_restarts)
        self._launch_standby()
        return True

    @staticmethod
    def _log_tail(proc: _Proc, chars: int = 2000) -> str:
        with open(proc.log_path) as f:
            return f.read()[-chars:]

    def standby_promoted_in_log(self) -> bool:
        """Whether the promoted controller's own log says it promoted (the
        standby prints ``METISFL_TPU_CONTROLLER_PROMOTED`` when it serves)."""
        proc = next((p for p in self._procs if p.name == "controller"),
                    None)
        return (self._standby_promoted and proc is not None
                and _PROMOTED in self._log_tail(proc, 1 << 20))

    def _write_config(self) -> None:
        self._config_path = os.path.join(self.workdir,
                                         "federation_config.bin")
        with open(self._config_path, "wb") as f:
            f.write(self.config.to_wire())

    def start_slices(self) -> List[dict]:
        """Boot the distributed tree's slice aggregator fleet and wait until
        every slice answers its health check; returns ``tree.slices``. The
        fleet's endpoints and spools are fixed before the config is
        written: the file tells the slices where to serve and the
        controller where to dial. :meth:`initialize_federation` calls this
        before the controller boots; a caller that runs the controller
        itself may call it alone, and :meth:`stop_slices` after."""
        self._plan_slices()
        self._write_config()
        for idx in range(len(self.config.aggregation.tree.slices)):
            self._launch_slice(idx)
        self._wait_slices_healthy()
        return self.config.aggregation.tree.slices

    def stop_slices(self, timeout_s: float = 30.0) -> None:
        """Send each slice aggregator the ShutDown RPC and wait for its
        process; one still running after ``timeout_s`` is terminated."""
        deadline = time.time() + timeout_s
        slices = [p for p in self._procs if p.name.startswith("slice_")]
        for spec in (self.config.aggregation.tree.slices
                     if slices else []):
            # the same fail-fast ShutDown as the learners'
            client = RpcClient(spec.get("host", "localhost"), spec["port"],
                               SLICE_SERVICE, retries=0, ssl=self.config.ssl)
            try:
                client.call("ShutDown", b"", timeout=5.0, wait_ready=False)
            except Exception:  # noqa: BLE001 - already gone
                pass
            finally:
                client.close()
        self._wait(slices, deadline)

    def _slices_distributed(self) -> bool:
        tree = self.config.aggregation.tree
        return tree.enabled and tree.distributed

    def _plan_slices(self) -> None:
        """One localhost endpoint and spool directory per branch, unless
        ``tree.slices`` lists the fleet (a remote controller needs that: a
        port probed here says nothing about another host)."""
        tree = self.config.aggregation.tree
        if not tree.slices:
            if (self.config.controller_host
                    or "localhost") not in self._LOCAL_HOSTS:
                raise ValueError(
                    "aggregation.tree.distributed on remote host "
                    f"{self.config.controller_host!r} requires explicit "
                    "aggregation.tree.slices endpoints")
            tree.spool_dir = tree.spool_dir or os.path.join(self.workdir,
                                                            "slices")
            for idx in range(tree.branch):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                tree.slices.append({
                    "name": f"slice_{idx}", "host": "localhost",
                    "port": port,
                    "spool_dir": os.path.join(tree.spool_dir,
                                              f"slice_{idx}")})
        for spec in tree.slices:
            if spec.get("spool_dir"):
                os.makedirs(spec["spool_dir"], exist_ok=True)

    def _launch_slice(self, idx: int) -> _Proc:
        """(Re)launch slice aggregator ``idx`` where the controller runs. A
        relaunch needs no handoff: its spool persists and the controller
        re-adopts it at a later round's assignment."""
        return self._launch(
            f"slice_{idx}", self.config.controller_host or "localhost",
            ["-m", "metisfl_tpu_torch.aggregation.slice",
             "--config", self._config_path, "--index", str(idx)],
            env=self._chaos_env("slice", idx), ship=[self._config_path])

    def _wait_slices_healthy(self, retries: int = 60,
                             sleep_s: float = 0.5) -> None:
        pending = list(self.config.aggregation.tree.slices)
        for _ in range(retries):
            pending = [
                spec for spec in pending
                if probe_health(spec["host"], spec["port"], SLICE_SERVICE,
                                ssl=self.config.ssl) != "SERVING"]
            if not pending:
                return
            self._check_procs_alive()
            time.sleep(sleep_s)
        raise RuntimeError(
            f"slice aggregator(s) never became healthy: "
            f"{[s.get('name') for s in pending]}")

    def _supervise_slices(self) -> bool:
        """Relaunch a slice aggregator process that died (backoff doubling
        from 0.5 s up to 30 s per slice). The federation does not wait for
        it: the controller has re-homed its slice. Returns True when a
        relaunch happened."""
        if not self._slices_distributed() or self._shutting_down:
            return False
        restarted = False
        for idx in range(len(self.config.aggregation.tree.slices)):
            proc = next((p for p in self._procs
                         if p.name == f"slice_{idx}"), None)
            if proc is None or proc.process.poll() is None:
                continue
            if time.time() < self._slice_restart_after.get(idx, 0.0):
                continue
            restarts = self._slice_restarts.get(idx, 0) + 1
            self._slice_restarts[idx] = restarts
            self._slice_restart_after[idx] = time.time() + min(
                30.0, 0.5 * (2 ** (restarts - 1)))
            logger.warning("slice aggregator %d died (exit %s); supervised "
                           "relaunch %d", idx, proc.process.poll(), restarts)
            self._launch_slice(idx)
            restarted = True
        return restarted

    # ------------------------------------------------------------------ #
    # serving: the gateway, or the fleet's replicas and router
    # ------------------------------------------------------------------ #

    def _serving_host(self) -> str:
        """Where the serving processes run: beside the controller."""
        return self.config.controller_host or "localhost"

    def _plan_serving(self) -> None:
        """Pin every serving port before the config is written (the file
        tells the gateways and the router where to serve, and the driver
        and its clients where to dial): one per fleet replica and the
        router's, which ``serving.port`` then names, or the gateway's."""
        serving = self.config.serving
        if not serving.enabled:
            return
        fleet = serving.fleet
        needs_ports = (not serving.port
                       or (fleet.enabled
                           and (not fleet.router_port or not fleet.gateways)))
        if needs_ports and self._serving_host() not in self._LOCAL_HOSTS:
            # a port probed here says nothing about the remote host
            raise ValueError(
                f"serving on remote host {self._serving_host()!r} requires "
                "explicit serving ports (serving.port / "
                "serving.fleet.router_port + gateways)")
        if fleet.enabled:
            if not fleet.gateways:
                fleet.gateways = [
                    {"name": f"serving_{idx}", "host": "localhost",
                     "port": _free_port()}
                    for idx in range(fleet.replicas)]
            if not fleet.router_port:
                fleet.router_port = _free_port()
            # what serving_client() dials is the router
            serving.port = fleet.router_port
        elif not serving.port:
            serving.port = _free_port()

    def _launch_serving(self) -> None:
        """Boot the gateway, or the fleet's replicas and its router."""
        if not self.config.serving.enabled:
            return
        fleet = self.config.serving.fleet
        if fleet.enabled:
            for idx in range(len(fleet.gateways)):
                self._launch_gateway(idx)
            self._launch_router()
            self._setup_autoscaler()
        else:
            self._launch_gateway()

    def _launch_gateway(self, replica: Optional[int] = None) -> _Proc:
        """(Re)launch the gateway (``replica`` None) or fleet replica
        ``replica`` on the driver's device, from the learners' recipe
        ``serving.recipe_index``. It needs no state handoff: its first
        registry poll pins it to the promoted versions."""
        cfg = self.config.serving
        if cfg.recipe_index >= len(self.learner_recipes):
            # a clamped index would boot the gateway on the wrong
            # architecture and every registry sync would fail to decode
            raise ValueError(
                f"serving.recipe_index={cfg.recipe_index} but only "
                f"{len(self.learner_recipes)} learner recipe(s) exist")
        recipe_path = self._recipe_path(cfg.recipe_index)
        args = ["-m", "metisfl_tpu_torch.serving",
                "--config", self._config_path, "--recipe", recipe_path,
                "--device", self.device]
        name = "serving"
        if replica is not None:
            spec = cfg.fleet.gateways[replica]
            name = spec.get("name") or f"serving_{replica}"
            # each replica binds its pinned port and phases its registry
            # polls by its fleet index: a promotion rolls through the fleet
            args += ["--port", str(spec["port"]),
                     "--replica-index", str(replica),
                     "--replicas", str(len(cfg.fleet.gateways))]
        return self._launch(name, self._serving_host(), args,
                            env=self._chaos_env("serving", replica),
                            ship=[self._config_path, recipe_path])

    def _launch_router(self) -> _Proc:
        """(Re)launch the fleet's router (``--router``). Stateless: it reads
        the initial fleet from the config; :meth:`_sync_router_fleet`
        re-adds autoscaled replicas after a relaunch."""
        return self._launch("router", self._serving_host(), [
            "-m", "metisfl_tpu_torch.serving", "--router",
            "--config", self._config_path, "--device", self.device],
            env=self._chaos_env("router"), ship=[self._config_path])

    def _serving_proc_names(self) -> List[str]:
        """The names of every serving process the driver supervises."""
        serving = self.config.serving
        if not serving.enabled:
            return []
        if not serving.fleet.enabled:
            return ["serving"]
        return [spec.get("name") or f"serving_{i}"
                for i, spec in enumerate(serving.fleet.gateways)] + ["router"]

    def _serving_rpc(self, host: str, port: int) -> RpcClient:
        """A fail-fast client of a gateway's or the router's service."""
        from metisfl_tpu_torch.serving.service import SERVING_SERVICE
        return RpcClient(host, port, SERVING_SERVICE, retries=0,
                         ssl=self.config.ssl)

    def _router_call(self, method: str, payload: dict) -> None:
        """One admin call to the router; a failure is logged (the router's
        probes re-adopt the fleet eventually)."""
        client = self._serving_rpc(self._serving_host(),
                                   self.config.serving.fleet.router_port)
        try:
            client.call(method, codec_dumps(payload), timeout=5.0,
                        wait_ready=False)
        except Exception:  # noqa: BLE001 - best effort
            logger.warning("router %s(%s) failed", method,
                           payload.get("name"))
        finally:
            client.close()

    def _sync_router_fleet(self) -> None:
        """AddReplica every current replica (idempotent): how a relaunched
        router learns of replicas its config file predates."""
        for idx, spec in enumerate(self.config.serving.fleet.gateways):
            self._router_call("AddReplica", {
                "name": spec.get("name") or f"serving_{idx}",
                "host": spec.get("host", "localhost"),
                "port": spec["port"]})

    def _supervise_gateway(self) -> bool:
        """Relaunch a serving process that died (the gateway, a fleet
        replica or the router), each after its own doubling backoff capped
        at 30 s, without a budget: all are stateless, a relaunched replica
        re-pins through its first registry poll and the router's probes
        re-admit it. Serving never fails the run. True when a relaunch
        happened."""
        if not self.config.serving.enabled or self._shutting_down:
            return False
        fleet = self.config.serving.fleet
        restarted = False
        for name in self._serving_proc_names():
            proc = next((p for p in self._procs if p.name == name), None)
            if proc is None or proc.process.poll() is None:
                continue
            if time.time() < self._serving_restart_after.get(name, 0.0):
                continue
            code = proc.process.poll()
            restarts = self._serving_restarts.get(name, 0) + 1
            self._serving_restarts[name] = restarts
            self._serving_restart_after[name] = time.time() + min(
                30.0, 0.5 * (2 ** (restarts - 1)))
            logger.warning("%s died (exit %s); supervised relaunch %d",
                           name, code, restarts)
            _tpostmortem.dump("gateway_relaunch",
                              extra={"process": name, "exit_code": code,
                                     "restart": restarts})
            if name == "router":
                self._launch_router()
                self._sync_router_fleet()
            elif fleet.enabled:
                idx = next((i for i, spec in enumerate(fleet.gateways)
                            if (spec.get("name") or f"serving_{i}") == name),
                           None)
                if idx is None:
                    continue  # scaled away meanwhile
                self._launch_gateway(idx)
            else:
                self._launch_gateway()
            _M_GATEWAY_RESTARTS.inc()
            restarted = True
        return restarted

    def poll_serving(self) -> Optional[str]:
        """One tick of the serving plane's supervision and autoscaling (each
        :meth:`monitor_federation` poll runs one; a caller that keeps the
        federation up after it returned runs them itself). Returns the
        autoscaler's action (``"up"``/``"down"``) or None."""
        self._supervise_gateway()
        return self._autoscale_serving()

    def serving_ready(self) -> Dict[str, float]:
        """The serving processes that printed their READY line, each with
        its seconds from launch to the time the line states (a relaunch is
        timed afresh)."""
        names = set(self._serving_proc_names())
        ready: Dict[str, float] = {}
        for proc in self._procs:
            if proc.name not in names:
                continue
            if proc.ready_s is None:
                with open(proc.log_path) as f:
                    found = _SERVING_READY.search(f.read())
                if found:
                    at = (float(found.group(2)) if found.group(2)
                          else time.time())
                    proc.ready_s = at - proc.started_at
            if proc.ready_s is not None:
                ready[proc.name] = proc.ready_s
        return ready

    def wait_for_serving(self, timeout_s: float = 120.0) -> Dict[str, float]:
        """Wait until every serving process printed its READY line (a
        replica's first ``import torch`` and model build take seconds),
        supervising them meanwhile; returns :meth:`serving_ready`."""
        deadline = time.time() + timeout_s
        names = self._serving_proc_names()
        while True:
            ready = self.serving_ready()
            if len(ready) == len(names):
                return ready
            if time.time() > deadline:
                missing = sorted(set(names) - set(ready))
                raise RuntimeError(f"serving process(es) {missing} never "
                                   "reported ready")
            self.poll_serving()
            time.sleep(0.1)

    def _stop_serving(self, deadline: float) -> None:
        """ShutDown every replica and then the router (or the gateway), and
        wait for their processes."""
        serving = self.config.serving
        if not serving.enabled:
            return
        targets = []
        if serving.fleet.enabled:
            targets = [(spec.get("host", "localhost"), spec["port"])
                       for spec in serving.fleet.gateways]
        if serving.port:
            targets.append((self._serving_host(), serving.port))
        for host, port in targets:
            client = self._serving_rpc(host, port)
            try:
                client.call("ShutDown", b"", timeout=5.0, wait_ready=False)
            except Exception:  # noqa: BLE001 - already gone
                pass
            finally:
                client.close()
        names = set(self._serving_proc_names())
        procs = [p for p in self._procs if p.name in names]
        for proc in procs:
            if self._logged_port(proc, _SERVING_READY) is None:
                # still booting: nothing to drain
                self._stop(proc)
        self._wait(procs, deadline)

    # -- the fleet autoscaler ------------------------------------------- #

    def _setup_autoscaler(self) -> None:
        fleet = self.config.serving.fleet
        if not (fleet.scale_up or fleet.scale_down):
            return
        from metisfl_tpu_torch.serving.fleet import FleetAutoscaler
        self._autoscaler = FleetAutoscaler(
            fleet.scale_up or None, fleet.scale_down or None,
            fleet.min_replicas, fleet.max_replicas,
            cooldown_s=fleet.scale_cooldown_s)
        _M_FLEET_REPLICAS.set(len(fleet.gateways))

    def _scrape_serving_families(self) -> Dict[str, float]:
        """The fleet's ``serving_*`` family values summed over series and
        over the replicas and the router (the router's
        ``serving_router_*`` families live in its process): the sample the
        scale rules judge. A dead process scrapes as nothing."""
        fleet = self.config.serving.fleet
        targets = ([(spec.get("host", "localhost"), spec["port"])
                    for spec in fleet.gateways]
                   + [(self._serving_host(), fleet.router_port)])
        totals: Dict[str, float] = {}
        for host, port in targets:
            client = self._serving_rpc(host, port)
            try:
                text = client.call("GetMetrics", b"", timeout=5.0,
                                   wait_ready=False,
                                   idempotent=True).decode("utf-8")
                series = _tmetrics.parse_exposition(text)
            except Exception:  # noqa: BLE001 - dead or garbled: skip it
                continue
            finally:
                client.close()
            for name, cells in series.items():
                if not name.startswith("serving_") or name.endswith(
                        ("_bucket", "_sum", "_count")):
                    continue  # histogram internals are not family sums
                totals[name] = totals.get(name, 0.0) + sum(cells.values())
        return totals

    def _autoscale_serving(self) -> Optional[str]:
        """One autoscaler evaluation and its action: "up", "down" or None."""
        if self._autoscaler is None or self._shutting_down:
            return None
        values = self._scrape_serving_families()
        decision = self._autoscaler.observe(
            values, replicas=len(self.config.serving.fleet.gateways))
        if decision == "up":
            return self._scale_up_serving(values)
        if decision == "down":
            return self._scale_down_serving(values)
        return None

    def _scale_up_serving(self, values: Dict[str, float]) -> str:
        """Boot one more replica and hand it to the router out of the ring
        (``wait_serving``): the router's probes admit it once it answers,
        so no key routes to a replica that is still booting."""
        fleet = self.config.serving.fleet
        names = {spec.get("name") or "" for spec in fleet.gateways}
        idx = len(fleet.gateways)
        while f"serving_{idx}" in names:
            idx += 1
        name = f"serving_{idx}"
        port = _free_port()
        fleet.gateways.append({"name": name, "host": "localhost",
                               "port": port})
        self._launch_gateway(len(fleet.gateways) - 1)
        self._router_call("AddReplica", {"name": name, "host": "localhost",
                                         "port": port, "wait_serving": True})
        rule = self._autoscaler.up_rule
        _tevents.emit(_tevents.ServingScaledUp, replica=name,
                      replicas=len(fleet.gateways),
                      rule=rule.describe_expr() if rule else "",
                      value=self._autoscaler.last_values.get("up", 0.0))
        _M_FLEET_REPLICAS.set(len(fleet.gateways))
        _M_SCALE_TOTAL.inc(direction="up")
        logger.warning("serving fleet scaled UP to %d replicas (+%s): %s",
                       len(fleet.gateways), name, values)
        return "up"

    def _scale_down_serving(self, values: Dict[str, float]) -> str:
        """Drain the newest replica: out of the ring first, then a bounded
        wait until its decode slots are idle, its ShutDown, and the router's
        RemoveReplica last (closing the router's channel must not cancel a
        forward the wait let finish)."""
        fleet = self.config.serving.fleet
        if len(fleet.gateways) <= fleet.min_replicas:
            return "down"  # raced the floor; the autoscaler re-checks
        spec = fleet.gateways[-1]
        name = spec.get("name") or f"serving_{len(fleet.gateways) - 1}"
        self._router_call("DrainReplica", {"name": name})
        client = self._serving_rpc(spec.get("host", "localhost"),
                                   spec["port"])
        try:
            deadline = time.time() + 15.0
            while time.time() < deadline:
                try:
                    desc = codec_loads(client.call(
                        "GetServingStatus", b"", timeout=5.0,
                        wait_ready=False, idempotent=True))
                except Exception:  # noqa: BLE001 - already gone
                    break
                # decode sequences are the multi-second in-flight work;
                # the gateway's own ShutDown drains its micro-batches
                decode = desc.get("decode") or {}
                if not any(d.get("queued", 0) or d.get("active", 0)
                           for d in decode.values()):
                    break
                time.sleep(0.25)
            client.call("ShutDown", b"", timeout=5.0, wait_ready=False)
        except Exception:  # noqa: BLE001 - already gone
            pass
        finally:
            client.close()
        self._router_call("RemoveReplica", {"name": name})
        fleet.gateways.remove(spec)
        proc = next((p for p in self._procs if p.name == name), None)
        if proc is not None:
            try:
                proc.process.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                _terminate_process(proc.process)
            self._procs = [p for p in self._procs if p.name != name]
        # a later scale-up may reuse the name with fresh supervision
        self._serving_restarts.pop(name, None)
        self._serving_restart_after.pop(name, None)
        rule = self._autoscaler.down_rule
        _tevents.emit(_tevents.ServingScaledDown, replica=name,
                      replicas=len(fleet.gateways),
                      rule=rule.describe_expr() if rule else "",
                      value=self._autoscaler.last_values.get("down", 0.0))
        _M_FLEET_REPLICAS.set(len(fleet.gateways))
        _M_SCALE_TOTAL.inc(direction="down")
        logger.warning("serving fleet scaled DOWN to %d replicas (-%s)",
                       len(fleet.gateways), name)
        return "down"

    def _launch(self, name: str, host: str, args: Sequence[str],
                env: Optional[Dict[str, str]] = None,
                ship: Sequence[str] = ()) -> _Proc:
        """Start ``python args`` on ``host`` with the launcher's own
        interpreter; over ssh, ``ship`` and the TLS files are copied there
        first."""
        launcher = self._launcher_for(host)
        if isinstance(launcher, SSHLauncher):
            launcher.ship([*ship, *self._ssl_files()])
        env = {**self._base_env(), **(env or {})}
        # a relaunch replaces the tracked process of the same name
        self._procs = [p for p in self._procs if p.name != name]
        proc = launcher.launch(name, [launcher.python, *args], env)
        self._procs.append(proc)
        return proc

    @staticmethod
    def _logged_port(proc: _Proc, pattern: re.Pattern) -> Optional[int]:
        """The port a process printed it serves on, once it has."""
        with open(proc.log_path) as f:
            found = pattern.search(f.read())
        return int(found.group(1)) if found else None

    def _wait_ready_port(self, proc: _Proc, deadline: float) -> int:
        while time.time() < deadline:
            port = self._logged_port(proc, _CONTROLLER_READY)
            if port is not None:
                return port
            self._check_procs_alive()
            time.sleep(0.1)
        raise RuntimeError("the controller never reported its port")

    def _recipe_path(self, idx: int) -> str:
        """Learner ``idx``'s recipe, cloudpickled into the workdir once."""
        path = os.path.join(self.workdir, f"learner_{idx}_recipe.pkl")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                cloudpickle.dump(self.learner_recipes[idx], f)
        return path

    def launch_learner(self, idx: int, wait_for_model: bool = False) -> _Proc:
        """(Re)launch learner ``idx``. Its port comes from its endpoint or
        is ephemeral (the learner reports it on join); its credentials
        persist in the workdir, so a relaunched learner rejoins as
        itself. ``wait_for_model``: it joins only once the controller
        holds a community model."""
        ep = self._endpoint(idx)
        name = f"learner_{idx}"
        recipe_path = self._recipe_path(idx)
        args = ["-m", "metisfl_tpu_torch.learner",
                "--controller-host",
                self.config.controller_host or "localhost",
                "--controller-port", str(self.config.controller_port),
                "--advertise-host", ep.hostname or "localhost",
                "--port", str(ep.port),
                "--recipe", recipe_path,
                "--device", self.device,
                "--rpc-deadline-s", str(self.config.comm.default_deadline_s),
                "--rpc-retries", str(self.config.comm.retries),
                "--rpc-retry-sleep-s", str(self.config.comm.retry_sleep_s),
                "--credentials-dir",
                os.path.join(self.workdir, f"{name}_creds")]
        if self.config.ssl.enabled:
            args += ["--ssl-cert", self.config.ssl.cert_path,
                     "--ssl-key", self.config.ssl.key_path]
        if self.config.secure.enabled:
            args += ["--secure-config", self._secure_path(idx)]
        tel = self.config.telemetry
        if not tel.enabled:
            args.append("--telemetry-off")
        else:
            if tel.dir:
                args += ["--telemetry-dir", tel.dir]
            if not tel.events.enabled:
                args.append("--events-off")
            if tel.postmortem_dir:
                args += ["--postmortem-dir", tel.postmortem_dir]
        if wait_for_model:
            args.append("--wait-for-model")
        standby = self._standby_endpoint()
        if standby is not None:
            args += ["--standby-host", standby[0],
                     "--standby-port", str(standby[1])]
        return self._launch(name, ep.hostname or "localhost", args,
                            {**self.learner_env,
                             **self._chaos_env("learner", idx)},
                            ship=[recipe_path, *self._secure_files(idx)])

    def _wait_healthy(self, deadline: float, sleep_s: float) -> None:
        last_exc: Optional[Exception] = None
        while time.time() < deadline:
            try:
                if self._client.health(timeout=5.0).get("status") == \
                        "SERVING":
                    return
            except Exception as exc:  # noqa: BLE001 - retried until deadline
                last_exc = exc
            self._check_procs_alive()
            time.sleep(sleep_s)
        raise RuntimeError(f"controller never became healthy: {last_exc}")

    def _check_procs_alive(self, skip: Sequence[str] = ()) -> None:
        """Raise with the log's tail if any process not in ``skip`` exited
        non-zero. A slice aggregator is supervised instead once the
        federation runs, a serving process always is, and under a hot
        standby a controller or standby death is a failover, which the
        supervision handles."""
        skip = tuple(skip)
        if self.config.controller.standby.enabled:
            skip += ("controller", "standby")
        # serving processes are supervised (relaunched), never fatal
        skip += tuple(self._serving_proc_names())
        for proc in self._procs:
            if proc.name in skip or (proc.name.startswith("slice_")
                                     and self._started_at):
                continue
            code = proc.process.poll()
            if code is not None and code != 0:
                raise RuntimeError(
                    f"{proc.name} exited with code {code}; log tail:\n"
                    f"{self._log_tail(proc)}")

    # ------------------------------------------------------------------ #
    # monitoring
    # ------------------------------------------------------------------ #

    def monitor_federation(self, poll_every_s: float = 1.0,
                           eval_drain_timeout_s: float = 90.0) -> dict:
        """Poll until a termination criterion holds: ``federation_rounds``
        rounds completed, ``execution_cutoff_mins`` passed since the
        learners launched, or the mean test ``metric_name`` of the latest
        evaluated community model reached ``metric_cutoff_score``; each
        poll also supervises the processes and autoscales the serving
        fleet. Then give in-flight evaluations a bounded grace and return
        the statistics."""
        term = self.config.termination
        poll_failures = 0
        while True:
            time.sleep(poll_every_s)
            # a dead controller first: relaunched, handed over, or (with
            # the supervision off) reported by the liveness check below
            self._supervise_controller()
            self._supervise_standby()
            self._supervise_slices()
            self.poll_serving()
            skip = (("controller",)
                    if self.config.failover.supervise_controller else ())
            if self.config.chaos.enabled:
                # a kill rule names its victim up front: its death is the
                # fault under test, which the failover must absorb
                skip += tuple(
                    str(r["process"]) for r in self.config.chaos.rules
                    if r.get("fault") == "kill" and r.get("process"))
            self._check_procs_alive(skip=skip)
            try:
                # fail fast on a dead controller (short deadline, no wait
                # for ready); the lineage RPCs are tail-bounded
                progress = self._client.get_runtime_metadata(
                    tail=1, timeout=15.0, wait_ready=False)
                poll_failures = 0
            except Exception as exc:  # noqa: BLE001 - bounded retry
                poll_failures += 1
                if poll_failures > 5:
                    raise
                logger.warning("monitor poll failed (%s); retrying", exc)
                continue
            if progress["global_iteration"] >= term.federation_rounds > 0:
                logger.info("termination: reached %d rounds",
                            term.federation_rounds)
                break
            if term.execution_cutoff_mins > 0 and (
                    time.time() - self._started_at
                    > term.execution_cutoff_mins * 60):
                logger.info("termination: wall-clock cutoff")
                break
            if term.metric_cutoff_score > 0:
                score = self._latest_mean_metric(
                    self._client.get_evaluation_lineage(tail=5),
                    term.metric_name)
                if score is not None and score >= term.metric_cutoff_score:
                    logger.info("termination: %s=%.4f >= cutoff",
                                term.metric_name, score)
                    break
        self._drain_evaluations(eval_drain_timeout_s)
        return self.get_statistics()

    def _drain_evaluations(self, timeout_s: float) -> None:
        """Wait (bounded) until every registered learner has reported its
        evaluation of the latest community model: a round completes on
        training, and its evaluations lag behind."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                evals = self._client.get_evaluation_lineage(tail=1)
                learners = self._client.list_learners(timeout=5.0)
            except Exception:  # noqa: BLE001 - the controller is gone
                return
            if not evals or len(evals[-1]["evaluations"]) >= len(learners):
                return
            time.sleep(0.2)
        logger.warning("evaluations still pending after %.0f s", timeout_s)

    @staticmethod
    def _latest_mean_metric(evaluations: List[dict],
                            metric: str) -> Optional[float]:
        for entry in reversed(evaluations):
            values = [ds_metrics[metric]
                      for learner_evals in entry["evaluations"].values()
                      for ds_name, ds_metrics in learner_evals.items()
                      if ds_name == "test" and metric in ds_metrics]
            if values:
                return float(np.mean(values))
        return None

    # ------------------------------------------------------------------ #
    # statistics and shutdown
    # ------------------------------------------------------------------ #

    def get_statistics(self) -> dict:
        return self._client.get_statistics()

    def process_exit_codes(self) -> Dict[str, Optional[int]]:
        """name → exit code (None while running) of every process."""
        return {p.name: p.process.poll() for p in self._procs}

    def save_experiment(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.workdir, "experiment.json")
        with open(path, "w") as f:
            json.dump(self.get_statistics(), f, indent=2, default=str)
        return path

    def serving_client(self):
        """A :class:`metisfl_tpu_torch.serving.ServingClient` dialing this
        session's gateway, or the router in a fleet (``serving.port``)."""
        from metisfl_tpu_torch.serving.service import ServingClient
        if not self.config.serving.enabled:
            raise RuntimeError("serving is not enabled in this federation")
        return ServingClient(self.config.controller_host or "localhost",
                             self.config.serving.port, ssl=self.config.ssl,
                             comm=self.config.comm)

    def run_inference(self, learner_index: int = 0, inputs=None,
                      dataset: str = "test", batch_size: int = 256,
                      max_examples: int = 0, timeout_s: float = 120.0,
                      generate_tokens: int = 0, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 0.0,
                      eos_id: Optional[int] = None) -> np.ndarray:
        """The community model's inference on one registered learner (in
        registration order), as a numpy array: over ``inputs`` where given,
        else the learner's ``dataset`` split. ``generate_tokens > 0``: the
        inputs are (B, L) token prompts and the result their greedy
        continuations (``temperature > 0`` raises on the learner)."""
        import uuid

        from metisfl_tpu_torch.comm.messages import InferResult, InferTask
        from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy

        endpoints = self._client.list_learners()
        if not endpoints:
            raise RuntimeError("no learners registered")
        ep = endpoints[learner_index % len(endpoints)]
        task = InferTask(
            task_id=uuid.uuid4().hex,
            learner_id=ep.get("learner_id", ""),
            model=self._client.get_community_model(),
            batch_size=batch_size,
            dataset=dataset,
            inputs=(ModelBlob(tensors=[("x", np.asarray(inputs))]).to_bytes()
                    if inputs is not None else b""),
            max_examples=max_examples,
            generate_tokens=generate_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_id=-1 if eos_id is None else int(eos_id),
            local_tensor_regex=self.config.train.local_tensor_regex,
            ship_tensor_regex=self.config.train.ship_tensor_regex)
        client = RpcClient(ep["hostname"], ep["port"], LEARNER_SERVICE,
                           ssl=self.config.ssl)
        try:
            result = InferResult.from_wire(client.call(
                "RunInference", task.to_wire(), timeout=timeout_s))
        finally:
            client.close()
        return to_numpy(dict(ModelBlob.from_bytes(
            result.predictions).tensors)["predictions"])

    def collect_traces(self, dest: Optional[str] = None) -> Optional[str]:
        """Merge every local process's sink file under ``telemetry.dir``
        (spans, and the event journals beside them, which the trace viewer
        skips) into ``traces.jsonl`` (default in the workdir); None when
        there is nothing to collect. Remote learners keep their files on their host
        (the fleet fabric that streams them is item 4b)."""
        if not self.config.telemetry.enabled:
            return None
        import glob as _glob
        tel_dir = self.config.telemetry.dir
        files = (sorted(_glob.glob(os.path.join(tel_dir, "*.jsonl")))
                 if tel_dir and os.path.isdir(tel_dir) else [])
        if not files:
            return None
        dest = dest or os.path.join(self.workdir, "traces.jsonl")
        with open(dest, "w") as out:
            for name in files:
                try:
                    with open(name) as f:
                        out.write(f.read())
                except OSError:
                    logger.warning("could not collect trace file %s", name)
        return dest

    def collect_postmortems(self) -> List[str]:
        """The post-mortem bundles, collected into ``<workdir>/postmortem``
        (where the processes write them unless ``telemetry.postmortem_dir``
        points elsewhere, in which case they are copied in)."""
        src = self.config.telemetry.postmortem_dir
        if not (self.config.telemetry.enabled and src
                and os.path.isdir(src)):
            return []
        import glob as _glob
        import shutil as _shutil
        dest = os.path.join(self.workdir, "postmortem")
        paths = sorted(_glob.glob(os.path.join(src, "*.json")))
        if os.path.abspath(src) != os.path.abspath(dest) and paths:
            os.makedirs(dest, exist_ok=True)
            collected = []
            for p in paths:
                target = os.path.join(dest, os.path.basename(p))
                try:
                    _shutil.copyfile(p, target)
                    collected.append(target)
                except OSError:
                    logger.warning("could not collect bundle %s", p)
            paths = collected
        if paths:
            logger.warning(
                "%d post-mortem bundle(s) in %s: render with python -m "
                "metisfl_tpu_torch.telemetry --postmortem %s",
                len(paths), dest, dest)
        return paths

    @staticmethod
    def _stop(proc: _Proc) -> None:
        """Ask a process to exit where it runs (never raising)."""
        try:
            proc.launcher.stop(proc)
        except Exception:  # noqa: BLE001 - the local process is killed next
            logger.warning("stopping %s where it runs failed", proc.name)

    def _wait(self, procs: Sequence[_Proc], deadline: float) -> None:
        for proc in procs:
            try:
                proc.process.wait(timeout=max(0.5, deadline - time.time()))
            except subprocess.TimeoutExpired:
                logger.warning("%s did not exit; terminating it", proc.name)
                self._stop(proc)
                _terminate_process(proc.process)

    def _shut_down_learner(self, hostname: str, port: int) -> None:
        client = RpcClient(hostname, port, LEARNER_SERVICE, retries=0,
                           ssl=self.config.ssl)
        try:
            client.call("ShutDown", b"", timeout=5.0, wait_ready=False)
        except Exception:  # noqa: BLE001 - the learner may be gone
            pass
        finally:
            client.close()

    def shutdown_federation(self, timeout_s: float = 30.0) -> None:
        """Stop every learner, and once they have exited (each leaves the
        federation on the way out), the serving processes (the replicas,
        then the router), the slice aggregators, then the controller; a
        process still
        running after ``timeout_s`` is stopped where it runs and its local
        process terminated. Learners get the ShutDown RPC at the endpoints
        they registered with the controller and at their configured host
        and logged port (a learner that serves but has not joined); one
        still starting is stopped by its launcher (SIGTERM, over ssh for a
        remote one), which it answers by exiting."""
        deadline = time.time() + timeout_s
        self._shutting_down = True
        learners = [p for p in self._procs if p.name.startswith("learner_")]
        dialled = set()
        if self._client is not None:
            try:
                dialled = {(ep["hostname"], int(ep["port"]))
                           for ep in self._client.list_learners(timeout=5.0)}
            except Exception:  # noqa: BLE001 - the controller is gone
                pass
        for hostname, port in sorted(dialled):
            self._shut_down_learner(hostname, port)
        for proc in learners:
            if proc.process.poll() is not None:
                continue
            idx = int(proc.name.rsplit("_", 1)[1])
            host = self._endpoint(idx).hostname or "localhost"
            port = self._logged_port(proc, _LEARNER_READY)
            if port is None:
                self._stop(proc)
            elif (host, port) not in dialled:
                self._shut_down_learner(host, port)
        self._wait(learners, deadline)
        self._stop_serving(deadline)
        self.stop_slices(max(0.0, deadline - time.time()))
        for proc in self._procs:
            if proc.name == "standby" and proc.process.poll() is None:
                # the warm standby has no ShutDown RPC: SIGTERM is its clean
                # exit, sent before the primary stops, or the primary's
                # stop would read as a WAL stall and the standby promote
                # into the shutdown
                self._stop(proc)
                self._wait([proc], deadline)
        if self._client is not None:
            try:
                self._client.shutdown_controller()
            except Exception:  # noqa: BLE001 - terminated below
                logger.warning("controller shutdown RPC failed")
            self._client.close()
        self._wait([p for p in self._procs if p.name == "controller"],
                   deadline)

    def run(self) -> dict:
        """initialize → monitor → save the statistics → shut down."""
        try:
            self.initialize_federation()
            stats = self.monitor_federation()
            self.save_experiment()
            return stats
        finally:
            self.shutdown_federation()
