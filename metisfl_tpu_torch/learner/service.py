"""Learner gRPC service.

The port's copy of the JAX package's ``learner/service.py``, with its
service and method names: RunTask (acks at once; training runs on the
learner's own thread), EvaluateModel and RunInference (blocking),
RecoverMasks (masking dropout recovery: the dropped parties' residual),
health, ``GetMetrics`` (the process registry's Prometheus exposition) and
shutdown. The services are built when the server is constructed and the
gRPC server only in :meth:`LearnerServer.start`, so the handlers can be
driven by direct calls where grpc is not installed.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.health import (
    NOT_SERVING,
    SERVING,
    HealthServicer,
)
from metisfl_tpu_torch.comm.messages import EvalTask, InferTask, TrainTask
from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
from metisfl_tpu_torch.controller.service import LEARNER_SERVICE
from metisfl_tpu_torch.learner.learner import Learner
from metisfl_tpu_torch.telemetry import render_metrics

logger = logging.getLogger("metisfl_tpu_torch.learner.service")


class LearnerServer:
    def __init__(self, learner: Learner, host: str = "0.0.0.0",
                 port: int = 0, ssl=None):
        self.learner = learner
        self.host, self.requested_port, self.ssl = host, port, ssl
        self._health_servicer = HealthServicer()
        self._health_servicer.set_status(LEARNER_SERVICE, SERVING)
        self.services: List[BytesService] = [
            self._health_servicer.service(),
            BytesService(LEARNER_SERVICE, {
                "RunTask": self._run_task,
                "EvaluateModel": self._evaluate,
                "RunInference": self._infer,
                "RecoverMasks": self._recover_masks,
                "GetHealthStatus": self._health,
                "GetMetrics": self._get_metrics,
                "ShutDown": self._shutdown_rpc,
            }, role="learner"),
        ]
        self._server: Optional[RpcServer] = None
        self._stop_lock = threading.Lock()
        self._stopping = False
        self._shutdown_event = threading.Event()
        self._tasks_received = 0
        self.port: Optional[int] = None

    def _run_task(self, raw: bytes) -> bytes:
        self._tasks_received += 1
        self.learner.run_task(TrainTask.from_wire(raw))
        return dumps({"ok": True})

    def _evaluate(self, raw: bytes) -> bytes:
        return self.learner.evaluate(EvalTask.from_wire(raw)).to_wire()

    def _infer(self, raw: bytes) -> bytes:
        return self.learner.infer(InferTask.from_wire(raw)).to_wire()

    def _recover_masks(self, raw: bytes) -> bytes:
        req = loads(raw)
        corrections = self.learner.recover_masks(
            req["round_id"], req["surviving"], req["dropped"],
            req["lengths"])
        return dumps({"corrections": corrections})

    def _get_metrics(self, raw: bytes) -> bytes:
        return render_metrics().encode("utf-8")

    def _health(self, raw: bytes) -> bytes:
        return dumps({"status": "SERVING",
                      "tasks_received": self._tasks_received})

    def _shutdown_rpc(self, raw: bytes) -> bytes:
        logger.info("learner ShutDown RPC received")
        threading.Thread(target=self.stop, daemon=True).start()
        return dumps({"ok": True})

    def start(self) -> int:
        self._server = RpcServer(self.host, self.requested_port,
                                 ssl=self.ssl)
        for service in self.services:
            self._server.add_service(service)
        self.port = self._server.start()
        self.learner.port = self.port
        return self.port

    def stop(self, leave: bool = True) -> None:
        """Leave the federation, stop training and the server; the waiters
        of :meth:`wait_for_shutdown` wake once all of it is done."""
        with self._stop_lock:
            if self._stopping:
                return
            self._stopping = True
        try:
            self._health_servicer.set_all(NOT_SERVING)
            logger.info("learner server stopping (leave=%s)", leave)
            try:
                if leave:
                    self.learner.leave_federation()
            except Exception:  # noqa: BLE001 - the controller may be gone
                logger.warning("leave_federation during shutdown failed")
            self.learner.shutdown()
            if self._server is not None:
                self._server.stop()
        finally:
            self._shutdown_event.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)
