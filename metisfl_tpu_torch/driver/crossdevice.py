"""Seeded in-process cross-device churn harness.

The port's copy of the JAX package's ``driver/crossdevice.py``. The
cross-device regime is thousands of unreliable virtual clients, per-round
sampling and heavy per-round dropout, and what it stresses is the
controller's round control (quorum barriers, deadlines, churn admission,
dispatch retries), not the training math. So the harness keeps the port's
controller whole (registry, scheduler, store, aggregation) and replaces
each learner with a virtual client: a seeded softmax-regression shard
trained with plain numpy on a small worker pool. A 1024-client federation
under 30% per-round dropout runs in seconds.

Fault model per dispatched task (every draw from the scenario seed):

- **dropout**: with probability ``dropout`` the client never reports (the
  quorum or the deadline releases the round without it);
- **flap**: ``flappers`` clients ignore their first task of every round
  they are sampled into and re-attach at once with their previous
  identity (the controller notes a ``flap_rejoin`` and re-dispatches; the
  re-dispatched task trains normally);
- **partition**: ``partitioned`` clients are unreachable (the dispatch
  raises) for rounds ``[1, 1 + partition_rounds)``: liveness counting,
  churn scoring and the retry to a replacement.

Client shards, fault draws and cohort sizes are seed-derived, so a
scenario replays the same fault schedule; the arrival order inside a round
follows thread timing, which under the ``participants`` scaler moves the
aggregate only by fp reassociation, so runs compare accuracies within a
tolerance. :func:`run_slice_smoke` boots real slice aggregator processes
(``python -m metisfl_tpu_torch.aggregation.slice``), kills one mid-round
and holds the community model to the undisturbed control's bits.

CLI::

    python -m metisfl_tpu_torch.driver.crossdevice --clients 512 --rounds 5
    # the churn scenario and its no-churn same-seed control: one JSON
    # line, non-zero exit on a failed round or an accuracy gap beyond
    # --tolerance
    python -m metisfl_tpu_torch.driver.crossdevice --slice-smoke
    # the controller-kill gate (driver/ha_smoke.py): a hot standby
    # promotes, the versions equal the control's bits
    python -m metisfl_tpu_torch.driver.crossdevice --controller-smoke \
        [--device cpu]

Not ported: the telemetry planes the JAX harness can arm (the cardinality
budget and the alert smoke, ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import random
import resource
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from metisfl_tpu_torch.comm.messages import JoinRequest, TaskResult
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    SchedulingConfig,
)
from metisfl_tpu_torch.config.federation import TreeAggregationConfig
from metisfl_tpu_torch.controller.core import Controller, LearnerRecord
from metisfl_tpu_torch.tensor.pytree import ModelBlob, pack_model, to_numpy

logger = logging.getLogger("metisfl_tpu_torch.crossdevice")


@dataclass
class ChurnScenario:
    """One reproducible cross-device run; the defaults are the JAX
    package's (its tests pin the 1024-client scenario)."""

    seed: int = 7
    clients: int = 1024
    rounds: int = 5
    # rounds release at `quorum` reporters out of a dispatch of
    # ceil(quorum * (1 + overprovision))
    quorum: int = 12
    overprovision: float = 1.0
    # per-task silent-dropout probability, and the named fault clients
    dropout: float = 0.3
    flappers: int = 1
    partitioned: int = 1
    partition_rounds: int = 2
    # the virtual task: seeded softmax regression on per-client shards
    dim: int = 8
    classes: int = 4
    samples_per_client: int = 32
    local_steps: int = 8
    lr: float = 0.25
    # the controller settings under test
    round_deadline_secs: float = 5.0
    quarantine_score: float = 0.55
    quarantine_s: float = 2.0
    dispatch_retries: int = 4
    # > 0: protocol asynchronous_buffered with this buffer instead of the
    # quorum barrier (quorum is then ignored)
    buffer_size: int = 0
    # > 0: this many slice aggregator processes over gRPC, under
    # aggregation.tree.distributed
    slices: int = 0
    # kill aggregator 0 while round `slice_kill_round` waits on uplinks
    slice_kill: bool = False
    slice_kill_round: int = 1
    # simulation plumbing
    workers: int = 8
    timeout_s: float = 120.0


def _local_train(weights: Dict[str, np.ndarray], x: np.ndarray,
                 y: np.ndarray, steps: int,
                 lr: float) -> Dict[str, np.ndarray]:
    """Full-batch softmax-regression SGD: deterministic, sub-millisecond
    at the harness's scale, and it converges when federated."""
    w = np.asarray(weights["w"], np.float32).copy()
    b = np.asarray(weights["b"], np.float32).copy()
    n = len(x)
    rows = np.arange(n)
    for _ in range(max(1, steps)):
        logits = x @ w + b
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=1, keepdims=True)
        p[rows, y] -= 1.0
        p /= n
        w -= lr * (x.T @ p)
        b -= lr * p.sum(axis=0)
    return {"w": w, "b": b}


class _VirtualClientProxy:
    """Controller → virtual client: the scenario's fault model, then
    training on the harness's worker pool."""

    def __init__(self, harness: "CrossDeviceHarness", record: LearnerRecord):
        self._h = harness
        self._learner_id = record.learner_id

    def run_task(self, task) -> None:
        self._h._on_dispatch(self._learner_id, task)

    def evaluate(self, task, callback) -> None:
        pass  # the harness evaluates the community model itself


class CrossDeviceHarness:
    """See the module docstring. Construct, then :meth:`run` (which owns
    the controller's start and shutdown) returns a result dict."""

    def __init__(self, scenario: ChurnScenario):
        self.scenario = s = scenario
        sched = dict(quarantine_score=s.quarantine_score,
                     quarantine_s=s.quarantine_s,
                     dispatch_retries=s.dispatch_retries,
                     retry_backoff_s=0.5)
        if s.buffer_size > 0:
            protocol = "asynchronous_buffered"
            sched["buffer_size"] = s.buffer_size
        else:
            protocol = "synchronous"
            sched.update(quorum=s.quorum, overprovision=s.overprovision)
        self._slice_procs: List[subprocess.Popen] = []
        self._slice_tmp = ""
        self._slice_killed = False
        agg_kwargs = {}
        if s.slices > 0:
            agg_kwargs["tree"] = self._boot_slices()
        self.config = FederationConfig(
            protocol=protocol,
            scheduling=SchedulingConfig(**sched),
            round_deadline_secs=s.round_deadline_secs,
            aggregation=AggregationConfig(
                rule="fedavg", scaler="participants",
                staleness_decay=0.5 if s.buffer_size > 0 else 0.0,
                **agg_kwargs),
            eval=EvalConfig(every_n_rounds=0),
        )
        self.controller = Controller(self.config, self._make_proxy,
                                     device="cpu")
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, s.workers),
            thread_name_prefix="virtual-client")
        self._lock = threading.Lock()
        # learner_id -> client index, and its live auth token
        self._clients: Dict[str, int] = {}
        self._tokens: Dict[str, str] = {}
        # the fault roles go to the first clients dispatched in round 1
        # (sampling a large population would almost never pick a
        # designated index: the faults must fire, not probably fire)
        self._flap_idx: set = set()
        self._part_idx: set = set()
        self._last_flap_round: Dict[int, int] = {}
        self._data_cache: Dict[int, Any] = {}
        self._truth = np.random.default_rng(s.seed).standard_normal(
            (s.dim, s.classes)).astype(np.float32)
        self.faults = {"dropped": 0, "flapped": 0, "partitioned": 0}

    # -- slice aggregator processes ----------------------------------------

    def _boot_slices(self) -> TreeAggregationConfig:
        """Boot ``scenario.slices`` aggregator processes (their own
        interpreters, real gRPC, killable) and return the
        ``aggregation.tree`` config that points the controller at them."""
        from metisfl_tpu_torch.aggregation.slice import SLICE_SERVICE
        from metisfl_tpu_torch.comm.health import probe_health

        s = self.scenario
        self._slice_tmp = tempfile.mkdtemp(prefix="metisfl_torch_slices_")
        # the package importable in the children whatever their cwd
        import metisfl_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(metisfl_tpu_torch.__file__)))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (pkg_root, os.environ.get("PYTHONPATH", "")) if p)}
        specs = []
        try:
            for i in range(s.slices):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                spool = os.path.join(self._slice_tmp, f"slice_{i}")
                specs.append({"name": f"slice_{i}", "host": "127.0.0.1",
                              "port": port, "spool_dir": spool})
                self._slice_procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "metisfl_tpu_torch.aggregation.slice",
                     "--host", "127.0.0.1", "--port", str(port),
                     "--spool-dir", spool, "--name", f"slice_{i}"],
                    env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL))
            deadline = time.time() + 60.0
            pending = list(specs)
            while pending and time.time() < deadline:
                pending = [spec for spec in pending
                           if probe_health(spec["host"], spec["port"],
                                           SLICE_SERVICE) != "SERVING"]
                if pending:
                    time.sleep(0.2)
            if pending:
                raise RuntimeError(f"slice aggregators never came up: "
                                   f"{[p['name'] for p in pending]}")
        except BaseException:
            # a failed boot must not orphan the processes that started
            self._stop_slices()
            raise
        return TreeAggregationConfig(
            enabled=True, branch=s.slices, distributed=True, slices=specs,
            rehome_retries=2, rehome_backoff_s=0.05)

    def _maybe_kill_slice(self) -> None:
        """The chaos trigger: kill aggregator 0 while the target round is
        in flight (uplinks in the air, the barrier open)."""
        s = self.scenario
        if (not s.slice_kill or self._slice_killed or not self._slice_procs
                or self.controller.global_iteration < s.slice_kill_round
                or not self.controller._tasks_in_flight):
            return
        self._slice_killed = True
        self._slice_procs[0].kill()
        logger.warning("chaos: killed slice aggregator 0 mid-round %d",
                       self.controller.global_iteration)

    def _stop_slices(self) -> None:
        for proc in self._slice_procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self._slice_procs:
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)

    # -- data ---------------------------------------------------------------

    def _client_data(self, idx: int):
        with self._lock:
            cached = self._data_cache.get(idx)
        if cached is not None:
            return cached
        s = self.scenario
        rng = np.random.default_rng((s.seed, idx))
        x = rng.standard_normal((s.samples_per_client, s.dim)).astype(
            np.float32)
        noise = 0.1 * rng.standard_normal((s.samples_per_client, s.classes))
        y = np.argmax(x @ self._truth + noise, axis=-1).astype(np.int32)
        with self._lock:
            self._data_cache[idx] = (x, y)
        return x, y

    def _test_data(self):
        s = self.scenario
        rng = np.random.default_rng((s.seed, 99991))
        x = rng.standard_normal((1024, s.dim)).astype(np.float32)
        y = np.argmax(x @ self._truth, axis=-1).astype(np.int32)
        return x, y

    # -- controller plumbing ------------------------------------------------

    def _make_proxy(self, record: LearnerRecord):
        return _VirtualClientProxy(self, record)

    def _join_all(self) -> None:
        for idx in range(self.scenario.clients):
            reply = self.controller.join(JoinRequest(
                hostname="vclient", port=20000 + idx,
                num_train_examples=self.scenario.samples_per_client))
            with self._lock:
                self._clients[reply.learner_id] = idx
                self._tokens[reply.learner_id] = reply.auth_token

    def _on_dispatch(self, learner_id: str, task) -> None:
        """The scenario's fault model, then a training job on the pool."""
        s = self.scenario
        with self._lock:
            idx = self._clients.get(learner_id)
            token = self._tokens.get(learner_id, "")
        if idx is None:
            return
        if task.round_id == 1:
            with self._lock:
                if (len(self._part_idx) < s.partitioned
                        and idx not in self._flap_idx):
                    self._part_idx.add(idx)
                elif (len(self._flap_idx) < s.flappers
                        and idx not in self._part_idx):
                    self._flap_idx.add(idx)
        if idx in self._part_idx and (
                1 <= task.round_id < 1 + s.partition_rounds):
            # a partition: the dispatch itself fails
            self.faults["partitioned"] += 1
            raise RuntimeError(f"chaos: client {idx} partitioned")
        if idx in self._flap_idx:
            if self._last_flap_round.get(idx) != task.round_id:
                # crash-flap: ignore the task and re-attach as itself
                self._last_flap_round[idx] = task.round_id
                self.faults["flapped"] += 1
                self._pool.submit(self._rejoin, learner_id, idx, token)
                return
        if idx not in self._flap_idx and idx not in self._part_idx:
            # one seed per (scenario, round, client), as the JAX harness
            draw = random.Random(
                (s.seed << 40) ^ (task.round_id << 24) ^ idx).random()
            if draw < s.dropout:
                self.faults["dropped"] += 1
                return  # a silent dropout: it never reports
        self._pool.submit(self._train_and_complete, learner_id, idx,
                          token, task)

    def _rejoin(self, learner_id: str, idx: int, token: str) -> None:
        try:
            reply = self.controller.join(JoinRequest(
                hostname="vclient", port=20000 + idx,
                num_train_examples=self.scenario.samples_per_client,
                previous_id=learner_id, auth_token=token))
            with self._lock:
                self._clients[reply.learner_id] = idx
                self._tokens[reply.learner_id] = reply.auth_token
        except Exception:  # noqa: BLE001 - a fault path, never fatal
            logger.exception("virtual client %d rejoin failed", idx)

    def _train_and_complete(self, learner_id: str, idx: int, token: str,
                            task) -> None:
        try:
            blob = ModelBlob.from_bytes(task.model)
            weights = {name: to_numpy(t) for name, t in blob.tensors}
            x, y = self._client_data(idx)
            s = self.scenario
            trained = _local_train(weights, x, y, s.local_steps, s.lr)
            if s.slices > 0 and task.round_id == s.slice_kill_round:
                # hold the target round open long enough that the kill
                # lands mid-round (in the kill run and the control alike;
                # timing cannot move the sorted-id fold's bits)
                time.sleep(0.02)
            self.controller.task_completed(TaskResult(
                task_id=task.task_id, learner_id=learner_id,
                auth_token=token, round_id=task.round_id,
                controller_epoch=task.controller_epoch,
                model=pack_model(trained),
                num_train_examples=len(x),
                completed_steps=s.local_steps,
                completed_batches=s.local_steps,
                processing_ms_per_step=1.0))
        except Exception:  # noqa: BLE001 - a fault path, never fatal
            logger.exception("virtual client %d train failed", idx)

    # -- run ----------------------------------------------------------------

    def accuracy(self) -> float:
        """The community model's accuracy on the seeded test set."""
        raw = self.controller.community_model_bytes()
        if raw is None:
            return 0.0
        weights = {name: to_numpy(t)
                   for name, t in ModelBlob.from_bytes(raw).tensors}
        x, y = self._test_data()
        pred = np.argmax(x @ weights["w"] + weights["b"], axis=-1)
        return float(np.mean(pred == y))

    def run(self) -> Dict[str, Any]:
        s = self.scenario
        # the controller samples cohorts and replacements from the global
        # `random`: seeded, the dispatch schedule replays
        random.seed(s.seed)
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.time()
        # join before seeding: a controller without a model skips each
        # join's dispatch, so round 1 is a sampled cohort, not every
        # client (the expected no-model warnings are silenced)
        ctrl_logger = logging.getLogger("metisfl_tpu_torch.controller")
        level = ctrl_logger.level
        ctrl_logger.setLevel(logging.ERROR)
        try:
            self._join_all()
            # the joins' dispatch no-ops run before the seed lands
            self.controller._pool.submit(lambda: None).result(timeout=60)
        finally:
            ctrl_logger.setLevel(level)
        joined_s = time.time() - t0
        rng = np.random.default_rng((s.seed, 77777))
        seed_model = {
            "w": (0.01 * rng.standard_normal((s.dim, s.classes))).astype(
                np.float32),
            "b": np.zeros((s.classes,), np.float32)}
        self.controller.set_community_model(pack_model(seed_model))
        round_walls: List[float] = []
        halted = False
        try:
            if not self.controller.resume_round():
                raise RuntimeError("nothing to dispatch")
            deadline = time.time() + s.timeout_s
            for target in range(1, s.rounds + 1):
                r0 = time.time()
                while self.controller.global_iteration < target:
                    if time.time() > deadline:
                        break
                    if self.controller._halted_no_reporters:
                        halted = True
                        break
                    self._maybe_kill_slice()
                    time.sleep(0.01)
                if halted or self.controller.global_iteration < target:
                    break
                round_walls.append(round(time.time() - r0, 3))
        finally:
            completed = self.controller.global_iteration
            metas = self.controller.get_runtime_metadata()
            acc = self.accuracy()
            slices_out = None
            if s.slices > 0:
                raw = self.controller.community_model_bytes() or b""
                tier = self.controller._slices
                slices_out = {
                    "slices": s.slices,
                    "killed": self._slice_killed,
                    "rehomed_total": tier.rehomed_total if tier else 0,
                    "describe": tier.describe() if tier else {},
                    "model_sha256": hashlib.sha256(raw).hexdigest(),
                }
            self.controller.shutdown()
            self._stop_slices()
            self._pool.shutdown(wait=True)
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        reporters = [len(m.get("train_received_at", {})) for m in metas]
        return {
            **({"slices": slices_out} if slices_out is not None else {}),
            "clients": s.clients,
            "protocol": self.config.protocol,
            "quorum": 0 if s.buffer_size else s.quorum,
            "buffer_size": s.buffer_size,
            "dropout": s.dropout,
            "seed": s.seed,
            "rounds_target": s.rounds,
            "rounds_completed": completed,
            "halted": halted,
            "ok": completed >= s.rounds and not halted,
            "accuracy": round(acc, 4),
            "join_s": round(joined_s, 3),
            "wall_s": round(time.time() - t0, 3),
            "round_walls_s": round_walls,
            "reporters_per_round": reporters[:s.rounds],
            "faults": dict(self.faults),
            "errors": [e for m in metas for e in m.get("errors", [])],
            "peak_rss_kb": rss1,
            "rss_growth_kb": rss1 - rss0,
        }


def run_scenario(scenario: ChurnScenario) -> Dict[str, Any]:
    return CrossDeviceHarness(scenario).run()


def run_slice_smoke(clients: int = 24, rounds: int = 3, slices: int = 3,
                    seed: int = 7, timeout_s: float = 120.0
                    ) -> Dict[str, Any]:
    """The slice-kill chaos gate: ``slices`` aggregator processes over
    gRPC, full-barrier rounds with no churn fault, one aggregator killed
    mid-round, against the same-seed undisturbed control. It passes when
    the kill run completes every round, re-homing happened (>= 1 in the
    kill run, 0 in the control), and the two community models are the
    same bits (the distributed tier folds in sorted-id order)."""
    base = ChurnScenario(
        seed=seed, clients=clients, rounds=rounds, slices=slices,
        quorum=0, overprovision=0.0, dropout=0.0, flappers=0,
        partitioned=0, dispatch_retries=0, quarantine_score=0.0,
        round_deadline_secs=30.0, timeout_s=timeout_s)
    kill = run_scenario(dataclasses.replace(base, slice_kill=True))
    control = run_scenario(base)
    ks, cs = kill.get("slices") or {}, control.get("slices") or {}
    bit_identical = (bool(ks.get("model_sha256"))
                     and ks.get("model_sha256") == cs.get("model_sha256"))
    ok = (kill["ok"] and control["ok"]
          and bool(ks.get("killed"))
          and int(ks.get("rehomed_total", 0)) >= 1
          and int(cs.get("rehomed_total", 0)) == 0
          and bit_identical)
    return {"kill": kill, "control": control,
            "bit_identical": bit_identical, "ok": ok}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "metisfl_tpu_torch.driver.crossdevice",
        description="seeded cross-device churn harness")
    parser.add_argument("--clients", type=int, default=1024)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--quorum", type=int, default=12)
    parser.add_argument("--overprovision", type=float, default=1.0)
    parser.add_argument("--dropout", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--buffer", type=int, default=0,
                        help=">0: asynchronous_buffered with this buffer "
                             "size")
    parser.add_argument("--deadline", type=float, default=5.0)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--tolerance", type=float, default=0.2,
                        help="max |accuracy(churn) - accuracy(no churn)|")
    parser.add_argument("--skip-control", action="store_true",
                        help="skip the no-churn same-seed control run")
    parser.add_argument("--slice-smoke", action="store_true",
                        help="run the slice-kill gate instead: slice "
                             "aggregator processes, one killed mid-round; "
                             "fails unless the round completes by "
                             "re-homing and the community model equals "
                             "the undisturbed control's bits")
    parser.add_argument("--slices", type=int, default=3,
                        help="aggregator processes for --slice-smoke")
    parser.add_argument("--secure-smoke", action="store_true",
                        help="run driver/secure_smoke.py's masked "
                             "federation against its plain control")
    parser.add_argument("--controller-smoke", action="store_true",
                        help="run the controller-kill gate instead: a gRPC "
                             "federation with a warm --standby, the "
                             "controller killed mid-round; fails unless the "
                             "standby promotes, every round completes and "
                             "the versions equal the same-seed control's "
                             "bits")
    parser.add_argument("--device", default="cuda",
                        help="the learners' device for --controller-smoke "
                             "(cuda or cpu)")
    args = parser.parse_args(argv)

    if args.controller_smoke:
        from metisfl_tpu_torch.driver.ha_smoke import run_ha_smoke
        out = run_ha_smoke(rounds=min(args.rounds, 3), seed=args.seed,
                           timeout_s=args.timeout, device=args.device)
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    if args.secure_smoke:
        from metisfl_tpu_torch.driver.secure_smoke import run_secure_smoke
        out = run_secure_smoke(seed=args.seed)
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    if args.slice_smoke:
        out = run_slice_smoke(clients=min(args.clients, 24),
                              rounds=min(args.rounds, 3),
                              slices=args.slices, seed=args.seed,
                              timeout_s=args.timeout)
        print(json.dumps(out))
        return 0 if out["ok"] else 1

    scenario = ChurnScenario(
        seed=args.seed, clients=args.clients, rounds=args.rounds,
        quorum=args.quorum, overprovision=args.overprovision,
        dropout=args.dropout, buffer_size=args.buffer,
        round_deadline_secs=args.deadline, timeout_s=args.timeout)
    churn = run_scenario(scenario)
    out: Dict[str, Any] = {"churn": churn}
    ok = churn["ok"]
    if not args.skip_control:
        control = run_scenario(dataclasses.replace(
            scenario, dropout=0.0, flappers=0, partitioned=0))
        out["control"] = control
        gap = abs(churn["accuracy"] - control["accuracy"])
        out["accuracy_gap"] = round(gap, 4)
        out["tolerance"] = args.tolerance
        ok = ok and control["ok"] and gap <= args.tolerance
    out["ok"] = ok
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
