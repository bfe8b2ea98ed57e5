"""The serving gateway's gRPC surface and its client.

The port's copy of the JAX package's ``serving/service.py``, over the
same BytesService transport as the controller and the learner (chunked
fallback, ``ListMethods`` reflection; the gateway's methods carry
``role: "serving"`` so a probe tells gateway endpoints apart from learner
and controller ones). The service name, the method names and the message
bytes are the JAX package's: a client of either package dials a server of
either."""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Optional

import numpy as np

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.messages import (GenerateReply,
                                             GenerateRequest, ServeReply,
                                             ServeRequest)
from metisfl_tpu_torch.comm.rpc import BytesService, RpcClient, RpcServer
from metisfl_tpu_torch.serving.gateway import ServingGateway
from metisfl_tpu_torch.telemetry import trace as _ttrace
from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy

logger = logging.getLogger("metisfl_tpu_torch.serving.service")

SERVING_SERVICE = "metisfl_tpu.Serving"


class ServingServer:
    """Host a :class:`ServingGateway` behind gRPC."""

    def __init__(self, gateway: ServingGateway, host: str = "0.0.0.0",
                 port: int = 0, ssl=None):
        from metisfl_tpu_torch.comm.health import SERVING, HealthServicer

        self.gateway = gateway
        self._server = RpcServer(host, port, ssl=ssl)
        self._health_servicer = HealthServicer()
        self._health_servicer.set_status(SERVING_SERVICE, SERVING)
        self._server.add_service(self._health_servicer.service())
        self._server.add_service(BytesService(SERVING_SERVICE, {
            "Predict": self._predict,
            "Generate": self._generate,
            "GetServingStatus": self._status,
            "GetHealthStatus": self._health,
            "GetMetrics": self._get_metrics,
            "ShutDown": self._shutdown_rpc,
        }, role="serving"))
        self._shutdown_event = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopping = False
        self.port: Optional[int] = None

    # -- handlers (RPC threads) ---------------------------------------- #

    def _predict(self, raw: bytes) -> bytes:
        req = ServeRequest.from_wire(raw)
        tensors = dict(ModelBlob.from_bytes(req.inputs).tensors)
        if "x" not in tensors:
            raise ValueError("ServeRequest.inputs must pack an 'x' tensor")
        t0 = time.time()
        outs, version, channel = self.gateway.predict(
            to_numpy(tensors["x"]), key=req.key or req.request_id)
        return ServeReply(
            request_id=req.request_id,
            predictions=ModelBlob(
                tensors=[("predictions", np.asarray(outs))]).to_bytes(),
            model_version=version,
            channel=channel,
            duration_ms=(time.time() - t0) * 1e3,
        ).to_wire()

    def _generate(self, raw: bytes) -> bytes:
        req = GenerateRequest.from_wire(raw)
        tensors = dict(ModelBlob.from_bytes(req.prompt).tensors)
        if "tokens" not in tensors:
            raise ValueError(
                "GenerateRequest.prompt must pack a 'tokens' tensor")
        t0 = time.time()
        tokens, version, channel = self.gateway.generate(
            to_numpy(tensors["tokens"]),
            max_new_tokens=int(req.max_new_tokens),
            key=req.key or req.request_id,
            eos_id=None if req.eos_id < 0 else int(req.eos_id))
        return GenerateReply(
            request_id=req.request_id,
            tokens=ModelBlob(
                tensors=[("tokens",
                          np.asarray(tokens, np.int32))]).to_bytes(),
            model_version=version,
            channel=channel,
            duration_ms=(time.time() - t0) * 1e3,
        ).to_wire()

    def _status(self, raw: bytes) -> bytes:
        return dumps(self.gateway.describe())

    def _health(self, raw: bytes) -> bytes:
        return dumps({"status": "SERVING",
                      "installed": self.gateway.installed()})

    def _get_metrics(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.telemetry import render_metrics
        return render_metrics().encode("utf-8")

    def _shutdown_rpc(self, raw: bytes) -> bytes:
        threading.Thread(target=self.stop, daemon=True).start()
        return dumps({"ok": True})

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> int:
        self.port = self._server.start()
        return self.port

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopping:
                return
            self._stopping = True
        from metisfl_tpu_torch.comm.health import NOT_SERVING

        try:
            self._health_servicer.set_all(NOT_SERVING)
            # RPC server first: no new Predicts can race the gateway
            # teardown (a racing request would otherwise respawn a batcher
            # worker on a torn-down gateway)
            self._server.stop()
            self.gateway.shutdown()
        finally:
            # only once the server's threads are gone: the process's main
            # thread exits when this is set, and an interpreter torn down
            # under a live gRPC thread aborts
            self._shutdown_event.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)


class ServingClient:
    """Application → gateway client."""

    def __init__(self, host: str, port: int, ssl=None, comm=None):
        kwargs = {}
        if comm is not None:
            kwargs = {"default_deadline_s": comm.default_deadline_s,
                      "retries": comm.retries,
                      "retry_sleep_s": comm.retry_sleep_s}
        self._client = RpcClient(host, port, SERVING_SERVICE, ssl=ssl,
                                 **kwargs)

    def predict(self, x, key: str = "",
                timeout: Optional[float] = None) -> ServeReply:
        req = ServeRequest(
            request_id=uuid.uuid4().hex,
            key=key,
            inputs=ModelBlob(
                tensors=[("x", np.asarray(x))]).to_bytes())
        # deterministic serving trace root: the trace id is a pure
        # function of the request id, so any party holding the id can
        # look the trace up without a side channel
        sp = _ttrace.span(
            "serving.request", parent=None,
            trace_id=_ttrace.request_trace_id(req.request_id),
            attrs={"request_id": req.request_id, "method": "Predict"})
        with sp, sp.activate():
            return ServeReply.from_wire(
                self._client.call("Predict", req.to_wire(),
                                  timeout=timeout))

    def predictions(self, reply: ServeReply) -> np.ndarray:
        return to_numpy(dict(ModelBlob.from_bytes(
            reply.predictions).tensors)["predictions"])

    def generate(self, prompt, max_new_tokens: int = 16, key: str = "",
                 eos_id: int = -1,
                 timeout: Optional[float] = 180.0) -> GenerateReply:
        """One continuous-batching generation: ``prompt`` is a (L,) or
        (1, L) int token array; the reply's tokens come back via
        :meth:`tokens`."""
        req = GenerateRequest(
            request_id=uuid.uuid4().hex,
            key=key,
            prompt=ModelBlob(tensors=[
                ("tokens",
                 np.asarray(prompt, np.int32).reshape(-1))]).to_bytes(),
            max_new_tokens=int(max_new_tokens),
            eos_id=int(eos_id))
        sp = _ttrace.span(
            "serving.request", parent=None,
            trace_id=_ttrace.request_trace_id(req.request_id),
            attrs={"request_id": req.request_id, "method": "Generate"})
        with sp, sp.activate():
            return GenerateReply.from_wire(
                self._client.call("Generate", req.to_wire(),
                                  timeout=timeout))

    def tokens(self, reply: GenerateReply) -> np.ndarray:
        return to_numpy(
            dict(ModelBlob.from_bytes(reply.tokens).tensors)["tokens"])

    def status(self, timeout: float = 10.0,
               wait_ready: bool = True) -> dict:
        return loads(self._client.call("GetServingStatus", b"",
                                       timeout=timeout,
                                       wait_ready=wait_ready,
                                       idempotent=True))

    def health(self, timeout: float = 5.0) -> dict:
        return loads(self._client.call("GetHealthStatus", b"",
                                       timeout=timeout, idempotent=True))

    def get_metrics(self, timeout: float = 10.0) -> str:
        return self._client.call("GetMetrics", b"", timeout=timeout,
                                 idempotent=True).decode("utf-8")

    def list_methods(self, timeout: float = 5.0) -> dict:
        import json as _json
        raw = self._client.call("ListMethods", b"", timeout=timeout,
                                idempotent=True)
        return _json.loads(raw.decode("utf-8"))

    def shutdown_gateway(self) -> bool:
        return bool(loads(self._client.call("ShutDown", b""))["ok"])

    def close(self) -> None:
        self._client.close()
