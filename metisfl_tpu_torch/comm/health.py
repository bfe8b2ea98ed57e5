"""Standard gRPC health checking (``grpc.health.v1.Health``).

The port's copy of the JAX package's ``comm/health.py``. Off-the-shelf
probes (grpc_health_probe, Kubernetes) work against the controller and the
learners. The two protobuf messages are encoded by hand, since each is one
field: HealthCheckRequest.service (field 1, a string) and
HealthCheckResponse.status (field 1, an enum). ``Check`` is served; the
streaming ``Watch`` is not.
"""

from __future__ import annotations

import threading
from typing import Dict

from metisfl_tpu_torch.comm.rpc import BytesService

HEALTH_SERVICE = "grpc.health.v1.Health"

UNKNOWN = 0
SERVING = 1
NOT_SERVING = 2
SERVICE_UNKNOWN = 3

STATUS_NAMES = {UNKNOWN: "UNKNOWN", SERVING: "SERVING",
                NOT_SERVING: "NOT_SERVING",
                SERVICE_UNKNOWN: "SERVICE_UNKNOWN"}


def _read_varint(raw: bytes, pos: int):
    value, shift = 0, 0
    while pos < len(raw):
        byte = raw[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
    raise ValueError("truncated varint")


def decode_request(raw: bytes) -> str:
    """HealthCheckRequest → service name ('' = the whole server)."""
    pos = 0
    while pos < len(raw):
        tag, pos = _read_varint(raw, pos)
        if tag == 0x0A:  # field 1, length-delimited
            length, pos = _read_varint(raw, pos)
            return raw[pos: pos + length].decode("utf-8", "replace")
        wire_type = tag & 0x07  # skip an unknown field
        if wire_type == 0:
            _, pos = _read_varint(raw, pos)
        elif wire_type == 2:
            length, pos = _read_varint(raw, pos)
            pos += length
        else:  # pragma: no cover - health clients send no such field
            break
    return ""


def encode_response(status: int) -> bytes:
    """HealthCheckResponse{status}: field 1, a varint below 128."""
    return bytes([0x08, status])


def encode_request(service: str = "") -> bytes:
    if not service:
        return b""
    payload = service.encode()
    if len(payload) > 127:  # pragma: no cover - service names are short
        raise ValueError("service name too long")
    return bytes([0x0A, len(payload)]) + payload


def decode_response(raw: bytes) -> int:
    pos = 0
    while pos < len(raw):
        tag, pos = _read_varint(raw, pos)
        if tag == 0x08:
            value, pos = _read_varint(raw, pos)
            return value
        break
    return UNKNOWN


class _NotFound(Exception):
    """An unknown service: the spec's NOT_FOUND status."""

    def __init__(self, service: str):
        super().__init__(f"unknown health service {service!r}")

    def code(self):
        import grpc

        return grpc.StatusCode.NOT_FOUND


class HealthServicer:
    """``Check`` with a status per service name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._status: Dict[str, int] = {"": SERVING}

    def set_status(self, service: str, status: int) -> None:
        with self._lock:
            self._status[service] = status

    def set_all(self, status: int) -> None:
        with self._lock:
            for service in self._status:
                self._status[service] = status

    def service(self) -> BytesService:
        return BytesService(HEALTH_SERVICE, {"Check": self._check})

    def _check(self, raw: bytes) -> bytes:
        service = decode_request(raw)
        with self._lock:
            status = self._status.get(service)
        if status is None:
            raise _NotFound(service)
        return encode_response(status)


def probe_health(host: str, port: int, service: str = "", ssl=None,
                 comm=None, timeout: float = 2.0) -> str:
    """One ``Check`` against an endpoint, as a status name ("SERVING",
    "NOT_SERVING", ..., or "UNREACHABLE"). Fails fast (no wait for ready,
    no retries) and never raises: a dead endpoint is an answer here."""
    from metisfl_tpu_torch.comm.rpc import RpcClient

    kwargs = {}
    if comm is not None:
        kwargs = {"default_deadline_s": comm.default_deadline_s}
    client = RpcClient(host, port, HEALTH_SERVICE, retries=0, ssl=ssl,
                       **kwargs)
    try:
        raw = client.call("Check", encode_request(service), timeout=timeout,
                          wait_ready=False, idempotent=True)
        return STATUS_NAMES.get(decode_response(raw), "UNKNOWN")
    except Exception:  # noqa: BLE001 - unreachable is the probe's answer
        return "UNREACHABLE"
    finally:
        client.close()
