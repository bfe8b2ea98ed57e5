"""Controller gRPC service, the controller's proxy of a remote learner, and
the client learners and DriverSession use to reach the controller.

The port's copy of the JAX package's ``controller/service.py``, with its
service and method names, so that processes of either package talk to
each other: join and leave, mark a task completed, replace or fetch the
community model, the statistics and lineage getters, the learner list,
health, a status snapshot and shutdown. Each server builds its
:class:`~metisfl_tpu_torch.comm.rpc.BytesService`\\ s when it is
constructed and the gRPC server only in :meth:`ControllerServer.start`, so
the handlers can be driven by direct calls where grpc is not installed.

The controller's proxy of a learner also asks it for a masking dropout
residual (``RecoverMasks``). The model registry's surface: its snapshot
(``DescribeRegistry``), a version's blob by id or channel
(``GetRegisteredModel``), and the operator's ``PromoteVersion`` and
``RollbackVersion``, which answer ``{"ok": false, "error"}`` rather than
fail when the gate refuses or the registry is off. Not ported:
``GetMetrics`` (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, List, Optional

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.health import (
    NOT_SERVING,
    SERVING,
    HealthServicer,
)
from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainTask,
)
from metisfl_tpu_torch.comm.rpc import BytesService, RpcClient, RpcServer
from metisfl_tpu_torch.controller.core import Controller, LearnerRecord

logger = logging.getLogger("metisfl_tpu_torch.controller.service")

CONTROLLER_SERVICE = "metisfl_tpu.Controller"
LEARNER_SERVICE = "metisfl_tpu.Learner"


def comm_kwargs(comm) -> dict:
    """``RpcClient`` keyword arguments from a config's ``comm`` section
    (None → the transport's defaults)."""
    if comm is None:
        return {}
    return {"default_deadline_s": comm.default_deadline_s,
            "retries": comm.retries,
            "retry_sleep_s": comm.retry_sleep_s}


class RpcLearnerProxy:
    """Controller → remote learner over gRPC; dispatch never blocks."""

    def __init__(self, record: LearnerRecord, ssl=None, comm=None):
        self._learner_id = record.learner_id
        self._client = RpcClient(record.hostname, record.port,
                                 LEARNER_SERVICE, ssl=ssl,
                                 **comm_kwargs(comm))

    def run_task(self, task: TrainTask) -> None:
        # RunTask acks at once (the learner trains on its own thread)
        self._client.call_async(
            "RunTask", task.to_wire(),
            error_callback=lambda exc: logger.warning(
                "RunTask to %s failed: %s", self._learner_id, exc))

    def run_task_with_callback(self, task: TrainTask, on_error) -> None:
        """Dispatch with failure notification, for the controller's
        liveness accounting: ``wait_ready=False`` surfaces UNAVAILABLE
        from a dead endpoint at once, and the timeout bounds a connected
        peer that does not answer."""
        self._client.call_async("RunTask", task.to_wire(),
                                error_callback=on_error, timeout=60.0,
                                wait_ready=False)

    def evaluate(self, task: EvalTask,
                 callback: Callable[[EvalResult], None]) -> None:
        self._client.call_async(
            "EvaluateModel", task.to_wire(),
            callback=lambda raw: callback(EvalResult.from_wire(raw)),
            error_callback=lambda exc: logger.warning(
                "EvaluateModel on %s failed: %s", self._learner_id, exc))

    def recover_masks(self, round_id: int, surviving, dropped,
                      lengths) -> list:
        """Blocking masking-dropout recovery: the learner computes the
        dropped parties' residual masks."""
        raw = self._client.call("RecoverMasks", dumps(
            {"round_id": int(round_id), "surviving": list(surviving),
             "dropped": list(dropped), "lengths": list(lengths)}),
            timeout=60.0, wait_ready=False)
        return loads(raw)["corrections"]


class ControllerServer:
    """A :class:`Controller` behind gRPC."""

    def __init__(self, controller: Controller, host: str = "0.0.0.0",
                 port: int = 50051, ssl=None):
        self.controller = controller
        self.host, self.requested_port, self.ssl = host, port, ssl
        # grpc.health.v1 beside the custom status method
        self._health_servicer = HealthServicer()
        self._health_servicer.set_status(CONTROLLER_SERVICE, SERVING)
        self.services: List[BytesService] = [
            self._health_servicer.service(),
            BytesService(CONTROLLER_SERVICE, {
                "JoinFederation": self._join,
                "LeaveFederation": self._leave,
                "MarkTaskCompleted": self._mark_completed,
                "ReplaceCommunityModel": self._replace_model,
                "GetCommunityModel": self._get_model,
                "GetStatistics": self._get_statistics,
                "GetRuntimeMetadata": self._get_runtime_metadata,
                "GetEvaluationLineage": self._get_evaluation_lineage,
                "ListLearners": self._list_learners,
                "GetHealthStatus": self._health,
                "DescribeFederation": self._describe,
                "DescribeRegistry": self._describe_registry,
                "GetRegisteredModel": self._get_registered_model,
                "PromoteVersion": self._promote_version,
                "RollbackVersion": self._rollback_version,
                "ShutDown": self._shutdown_rpc,
            }, role="controller"),
        ]
        self._server: Optional[RpcServer] = None
        self._stop_lock = threading.Lock()
        self._stopping = False
        self._shutdown_event = threading.Event()
        self.port: Optional[int] = None

    # -- handlers (RPC threads) -------------------------------------------
    def _join(self, raw: bytes) -> bytes:
        return self.controller.join(JoinRequest.from_wire(raw)).to_wire()

    def _leave(self, raw: bytes) -> bytes:
        req = loads(raw)
        return dumps({"ok": self.controller.leave(req["learner_id"],
                                                  req["auth_token"])})

    def _mark_completed(self, raw: bytes) -> bytes:
        ok = self.controller.task_completed(TaskResult.from_wire(raw))
        return dumps({"ok": ok})

    def _replace_model(self, raw: bytes) -> bytes:
        self.controller.set_community_model(raw)
        return dumps({"ok": True})

    def _get_model(self, raw: bytes) -> bytes:
        return self.controller.community_model_bytes() or b""

    def _get_statistics(self, raw: bytes) -> bytes:
        return dumps(self.controller.get_statistics())

    def _get_runtime_metadata(self, raw: bytes) -> bytes:
        tail = int(loads(raw).get("tail", 0)) if raw else 0
        return dumps({"global_iteration": self.controller.global_iteration,
                      "round_metadata":
                      self.controller.get_runtime_metadata(tail)})

    def _get_evaluation_lineage(self, raw: bytes) -> bytes:
        tail = int(loads(raw).get("tail", 0)) if raw else 0
        return dumps({"community_evaluations":
                      self.controller.get_evaluation_lineage(tail)})

    def _list_learners(self, raw: bytes) -> bytes:
        return dumps({"learners": self.controller.learner_endpoints()})

    def _health(self, raw: bytes) -> bytes:
        return dumps({"status": "SERVING",
                      "learners": self.controller.active_learners()})

    def _describe(self, raw: bytes) -> bytes:
        return dumps(self.controller.describe())

    def _describe_registry(self, raw: bytes) -> bytes:
        return dumps(self.controller.describe_registry())

    def _get_registered_model(self, raw: bytes) -> bytes:
        req = loads(raw) if raw else {}
        blob = self.controller.registered_model(
            version=int(req.get("version", 0) or 0),
            channel=str(req.get("channel", "") or ""))
        return blob or b""

    def _promote_version(self, raw: bytes) -> bytes:
        req = loads(raw)
        try:
            info = self.controller.promote_version(
                int(req["version"]), force=bool(req.get("force", False)))
        except ValueError as exc:
            # a refused gate is an answer, not a transport error
            return dumps({"ok": False, "error": str(exc)})
        return dumps({"ok": True, "version": info.to_dict()})

    def _rollback_version(self, raw: bytes) -> bytes:
        try:
            info = self.controller.rollback_version()
        except ValueError as exc:
            return dumps({"ok": False, "error": str(exc)})
        if info is None:
            return dumps({"ok": False, "error": "nothing to roll back to"})
        return dumps({"ok": True, "version": info.to_dict()})

    def _shutdown_rpc(self, raw: bytes) -> bytes:
        # ack first, then tear down off the RPC thread
        threading.Thread(target=self.stop, daemon=True).start()
        return dumps({"ok": True})

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self._server = RpcServer(self.host, self.requested_port,
                                 ssl=self.ssl)
        for service in self.services:
            self._server.add_service(service)
        self.port = self._server.start()
        return self.port

    def stop(self) -> None:
        """Stop the controller and the server; the waiters of
        :meth:`wait_for_shutdown` wake once both are down."""
        with self._stop_lock:
            if self._stopping:
                return
            self._stopping = True
        try:
            self._health_servicer.set_all(NOT_SERVING)
            self.controller.shutdown()
            if self._server is not None:
                self._server.stop()
        finally:
            self._shutdown_event.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)


class ControllerClient:
    """Learner or DriverSession → controller.

    ``standby`` is a second ``(host, port)`` of the controller: a call that
    has spent the transport's own UNAVAILABLE retries probes both
    endpoints (grpc.health.v1, the primary first) and is re-issued once
    against whichever answers SERVING: the promoted hot standby after the
    primary died. Without it a call is exactly one ``RpcClient.call``."""

    def __init__(self, host: str, port: int, ssl=None, comm=None,
                 standby: Optional[tuple] = None):
        self._ssl, self._comm = ssl, comm
        self._endpoints = [(host, int(port))]
        if standby and int(standby[1]) > 0:
            self._endpoints.append((standby[0], int(standby[1])))
        self._redial_lock = threading.Lock()
        self._generation = 0
        self._retries = comm.retries if comm is not None else 10
        self._retry_sleep_s = (comm.retry_sleep_s if comm is not None
                               else 1.0)
        self._active = (host, int(port))
        self._client = RpcClient(host, port, CONTROLLER_SERVICE, ssl=ssl,
                                 **comm_kwargs(comm))

    def endpoint(self) -> tuple:
        """The (host, port) currently dialed."""
        return self._active

    def _call(self, method: str, payload: bytes, **kwargs) -> bytes:
        import grpc

        if len(self._endpoints) > 1:
            # fail fast on a dead endpoint: the bounded retries and the
            # redial probe are the failure detector
            kwargs.setdefault("wait_ready", False)
        gen = self._generation
        try:
            return self._client.call(method, payload, **kwargs)
        except (grpc.RpcError, ValueError):
            # ValueError: another thread's redial closed this channel
            if not self._redial(gen):
                raise
        return self._client.call(method, payload, **kwargs)

    def _redial(self, gen: int) -> bool:
        """Swap to whichever known endpoint answers SERVING, probing up to
        ``comm.retries`` rounds; concurrent callers redial once."""
        if len(self._endpoints) < 2:
            return False
        from metisfl_tpu_torch.comm.health import probe_health

        with self._redial_lock:
            if self._generation != gen:
                return True  # another caller already redialed
            for _ in range(max(1, self._retries)):
                for host, port in self._endpoints:
                    if probe_health(host, port, CONTROLLER_SERVICE,
                                    ssl=self._ssl,
                                    comm=self._comm) != "SERVING":
                        continue
                    old = self._client
                    self._client = RpcClient(host, port, CONTROLLER_SERVICE,
                                             ssl=self._ssl,
                                             **comm_kwargs(self._comm))
                    self._active = (host, port)
                    self._generation += 1
                    old.close()
                    logger.warning("controller redialed to %s:%d", host,
                                   port)
                    return True
                time.sleep(self._retry_sleep_s)
            return False

    def join(self, request: JoinRequest) -> JoinReply:
        # idempotent: a join sent twice lands on the rejoin path
        return JoinReply.from_wire(self._call(
            "JoinFederation", request.to_wire(), idempotent=True))

    def leave(self, learner_id: str, auth_token: str) -> bool:
        raw = self._call("LeaveFederation", dumps(
            {"learner_id": learner_id, "auth_token": auth_token}))
        return bool(loads(raw)["ok"])

    def task_completed(self, result: TaskResult) -> bool:
        raw = self._call("MarkTaskCompleted", result.to_wire())
        return bool(loads(raw)["ok"])

    def replace_community_model(self, blob: bytes) -> bool:
        return bool(loads(self._call("ReplaceCommunityModel", blob))["ok"])

    def get_community_model(self) -> bytes:
        return self._call("GetCommunityModel", b"", idempotent=True)

    def get_statistics(self) -> dict:
        return loads(self._call("GetStatistics", b"", idempotent=True))

    def get_runtime_metadata(self, tail: int = 0,
                             timeout: Optional[float] = None,
                             wait_ready: bool = True) -> dict:
        """``{"global_iteration", "round_metadata"}`` with the last
        ``tail`` rounds (0 = all). A short ``timeout`` and
        ``wait_ready=False`` make a poll of a dead controller fail fast."""
        return loads(self._call("GetRuntimeMetadata", dumps({"tail": tail}),
                                timeout=timeout, wait_ready=wait_ready,
                                idempotent=True))

    def get_evaluation_lineage(self, tail: int = 0) -> list:
        """The last ``tail`` evaluation entries (0 = all)."""
        raw = self._call("GetEvaluationLineage", dumps({"tail": tail}),
                         idempotent=True)
        return loads(raw)["community_evaluations"]

    def list_learners(self, timeout: Optional[float] = None,
                      wait_ready: bool = True) -> list:
        """Registered learners ``[{learner_id, hostname, port}]``, with the
        ports they bound and reported on join."""
        return loads(self._call("ListLearners", b"", timeout=timeout,
                                wait_ready=wait_ready,
                                idempotent=True))["learners"]

    def health(self, timeout: float = 5.0) -> dict:
        return loads(self._call("GetHealthStatus", b"", timeout=timeout,
                                idempotent=True))

    def describe_federation(self, timeout: Optional[float] = None,
                            wait_ready: bool = True) -> dict:
        """A live snapshot: round, protocol, learners, in-flight tasks."""
        return loads(self._call("DescribeFederation", b"", timeout=timeout,
                                wait_ready=wait_ready, idempotent=True))

    def describe_registry(self, timeout: Optional[float] = None,
                          wait_ready: bool = True) -> dict:
        """The registry's snapshot (channel heads and retained lineage);
        ``{"enabled": False}`` when off. The gateway polls it fail-fast."""
        return loads(self._call("DescribeRegistry", b"", timeout=timeout,
                                wait_ready=wait_ready, idempotent=True))

    def get_registered_model(self, version: int = 0, channel: str = "",
                             timeout: Optional[float] = None) -> bytes:
        """A registered version's blob by id or channel (b'' when absent)."""
        return self._call(
            "GetRegisteredModel",
            dumps({"version": int(version), "channel": channel}),
            timeout=timeout, idempotent=True)

    def promote_version(self, version: int, force: bool = False,
                        timeout: Optional[float] = None) -> dict:
        """``{"ok": bool, ...}``: a refused gate comes back as ``ok`` false
        with its reasons."""
        return loads(self._call(
            "PromoteVersion", dumps({"version": int(version),
                                     "force": bool(force)}),
            timeout=timeout))

    def rollback_version(self, timeout: Optional[float] = None) -> dict:
        return loads(self._call("RollbackVersion", dumps({}),
                                timeout=timeout))

    def list_methods(self, timeout: float = 5.0) -> dict:
        """The service's methods and transport capabilities (JSON)."""
        raw = self._call("ListMethods", b"", timeout=timeout,
                         idempotent=True)
        return json.loads(raw.decode("utf-8"))

    def shutdown_controller(self) -> bool:
        return bool(loads(self._call("ShutDown", b""))["ok"])

    def close(self) -> None:
        self._client.close()
