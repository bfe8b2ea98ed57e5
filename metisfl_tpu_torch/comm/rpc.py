"""gRPC bytes transport.

The port's copy of the JAX package's ``comm/rpc.py``. Services are generic
byte methods with no codegen: each endpoint is a named unary handler that
takes and returns codec or blob bytes. Clients retry UNAVAILABLE with a
pause between attempts, and every call has a deadline unless the caller
opts out. Method and service names are the JAX package's, so processes of
either package talk to each other.

Chunked transfer: gRPC frames one message in at most ~2 GiB. Every unary
method therefore doubles as a stream-stream method (``<Method>Chunked``):
a payload above :data:`STREAM_THRESHOLD` travels in :data:`CHUNK_BYTES`
segments, reassembled on the other side, and so does its response. A
unary response above :data:`UNARY_RESPONSE_LIMIT` is refused by the server
with RESOURCE_EXHAUSTED, and the client re-issues the call over the
chunked method and remembers to use it for that method from then on.

``grpc`` is imported where the transport is built (:class:`RpcServer`,
:class:`RpcClient`, :meth:`BytesService._generic_handler`), so that
:class:`BytesService` and the services built on it import, and their
handlers can be called directly, on a machine without grpc.

Not ported: the per-method metrics, ``CollectTelemetry`` and per-peer byte
attribution (ROADMAP.md Queue 1 item 4), and the fault-injection hooks
(item 3f).
"""

from __future__ import annotations

import json
import logging
import time
from concurrent import futures
from typing import Callable, Dict, Optional

logger = logging.getLogger("metisfl_tpu_torch.rpc")

# deadline of a call whose caller passes timeout=None: one hung peer must
# not park a dispatch thread forever. Sized for multi-GB chunked model
# transfers, not for acks. CommConfig.default_deadline_s <= 0 opts out.
DEFAULT_DEADLINE_S = 120.0

_UNLIMITED = [
    ("grpc.max_send_message_length", -1),
    ("grpc.max_receive_message_length", -1),
    # gRPC servers default to SO_REUSEPORT on Linux: two federations on
    # one port would silently share RPCs. Fail loudly instead.
    ("grpc.so_reuseport", 0),
]


def _identity(b: bytes) -> bytes:
    return b


# chunked-transfer framing; module attributes so that tests can shrink them
CHUNK_BYTES = 32 * 1024 * 1024
STREAM_THRESHOLD = 128 * 1024 * 1024
# a unary response above this cannot be framed: the server refuses it and
# the client retries chunked (a margin under the 2 GiB limit)
UNARY_RESPONSE_LIMIT = (2 << 30) - (64 << 20)
_CHUNK_SUFFIX = "Chunked"
_OVERSIZE_MARK = "response exceeds unary framing; retry chunked"


def _iter_chunks(payload: bytes):
    if not payload:
        yield b""
        return
    view = memoryview(payload)
    for i in range(0, len(payload), CHUNK_BYTES):
        yield bytes(view[i: i + CHUNK_BYTES])


class BytesService:
    """A named set of unary bytes → bytes methods served over gRPC.

    Every service also answers ``ListMethods``: its method names and the
    transport's capabilities (each method doubles as a chunked stream, and
    an oversize unary response falls back to it), in JSON so that tooling
    without this package can read it.

    A handler whose response can exceed :data:`UNARY_RESPONSE_LIMIT` must
    be idempotent: the server refuses the unary response after the handler
    ran, and the client calls it again over the chunked method.
    """

    def __init__(self, service_name: str,
                 handlers: Dict[str, Callable[[bytes], bytes]],
                 role: str = ""):
        self.service_name = service_name
        # the endpoint's role ("controller", "learner"), for ListMethods
        self.role = role
        self.handlers = dict(handlers)
        self.handlers.setdefault("ListMethods", self._list_methods)

    def _list_methods(self, raw: bytes) -> bytes:
        methods = [
            {"name": name, "transports": ["unary", "chunked"],
             "oversize_unary_fallback": True}
            for name in sorted(self.handlers)
        ]
        reply = {"service": self.service_name, "methods": methods}
        if self.role:
            reply["role"] = self.role
        return json.dumps(reply).encode("utf-8")

    def _generic_handler(self):
        import grpc

        method_handlers = {}
        for name, fn in self.handlers.items():
            method_handlers[name] = grpc.unary_unary_rpc_method_handler(
                self._wrap(fn), request_deserializer=_identity,
                response_serializer=_identity)
            method_handlers[name + _CHUNK_SUFFIX] = (
                grpc.stream_stream_rpc_method_handler(
                    self._wrap_chunked(fn), request_deserializer=_identity,
                    response_serializer=_identity))
        return grpc.method_handlers_generic_handler(self.service_name,
                                                    method_handlers)

    @staticmethod
    def _abort(context, exc: Exception):
        import grpc

        code = getattr(exc, "code", None)
        if callable(code):  # RpcError-shaped
            try:
                code = code()
            except Exception:  # noqa: BLE001 - fall through to INTERNAL
                code = None
        if isinstance(code, grpc.StatusCode):
            context.abort(code, str(exc))
        if isinstance(exc, ValueError):
            # a malformed payload (codec framing, blob integrity) is the
            # caller's defect: INVALID_ARGUMENT is never retried as if it
            # were a transient server failure
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"{type(exc).__name__}: {exc}")
        logger.exception("RPC handler failed")
        context.abort(grpc.StatusCode.INTERNAL,
                      f"{type(exc).__name__}: {exc}")

    @staticmethod
    def _wrap(fn: Callable[[bytes], bytes]):
        def handler(request: bytes, context) -> bytes:
            import grpc

            try:
                result = fn(request)
            except Exception as exc:  # noqa: BLE001 - becomes a status
                BytesService._abort(context, exc)
            if len(result) > UNARY_RESPONSE_LIMIT:
                # the handler has run; the client runs it again chunked
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              _OVERSIZE_MARK)
            return result

        return handler

    @staticmethod
    def _wrap_chunked(fn: Callable[[bytes], bytes]):
        def handler(request_iter, context):
            try:
                # draining the stream can itself fail (the client cancelled
                # mid-upload): it is reported like a handler error
                result = fn(b"".join(request_iter))
            except Exception as exc:  # noqa: BLE001 - becomes a status
                BytesService._abort(context, exc)
            yield from _iter_chunks(result)

        return handler


class RpcServer:
    """gRPC server hosting one or more :class:`BytesService`\\ s; an enabled
    :class:`~metisfl_tpu_torch.comm.ssl.SSLConfig` serves TLS."""

    def __init__(self, host: str, port: int, max_workers: int = 16,
                 ssl=None):
        import grpc

        self.host = host
        self.port = port
        self.ssl = ssl if (ssl is not None and ssl.enabled) else None
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_UNLIMITED)
        self._bound_port: Optional[int] = None

    def add_service(self, service: BytesService) -> None:
        self._server.add_generic_rpc_handlers((service._generic_handler(),))

    def start(self) -> int:
        addr = f"{self.host}:{self.port}"
        if self.ssl is not None:
            from metisfl_tpu_torch.comm.ssl import server_credentials
            self._bound_port = self._server.add_secure_port(
                addr, server_credentials(self.ssl))
        else:
            self._bound_port = self._server.add_insecure_port(addr)
        if self._bound_port == 0:
            raise RuntimeError(f"could not bind gRPC server on {addr}")
        self._server.start()
        logger.info("gRPC server listening on %s:%d%s", self.host,
                    self._bound_port, " (TLS)" if self.ssl else "")
        return self._bound_port

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()

    def wait(self) -> None:
        """Block until the server stops."""
        self._server.wait_for_termination()


class RpcClient:
    """Channel to a :class:`BytesService`, retrying UNAVAILABLE.

    ``default_deadline_s`` applies to calls that pass ``timeout=None``:
    ``None`` → :data:`DEFAULT_DEADLINE_S`, ``<= 0`` → unbounded.
    """

    def __init__(self, host: str, port: int, service_name: str,
                 retries: int = 10, retry_sleep_s: float = 1.0, ssl=None,
                 default_deadline_s: Optional[float] = None):
        import grpc

        self.target = f"{host}:{port}"
        self.service_name = service_name
        self.retries = retries
        self.retry_sleep_s = retry_sleep_s
        if default_deadline_s is None:
            default_deadline_s = DEFAULT_DEADLINE_S
        self.default_deadline_s = (default_deadline_s
                                   if default_deadline_s > 0 else None)
        if ssl is not None and ssl.enabled:
            from metisfl_tpu_torch.comm.ssl import channel_credentials
            self._channel = grpc.secure_channel(
                self.target, channel_credentials(ssl), options=_UNLIMITED)
        else:
            self._channel = grpc.insecure_channel(self.target,
                                                  options=_UNLIMITED)
        # created now: a lazy pool would race between the caller's thread
        # and grpc's callback threads
        self._stream_pool = futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="rpc-chunked")
        # methods seen to need chunked responses: later calls go straight
        # to the stream instead of running the handler twice
        self._chunked_methods: set = set()

    @staticmethod
    def _oversize(exc) -> bool:
        import grpc

        return (isinstance(exc, grpc.RpcError)
                and exc.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                and _OVERSIZE_MARK in (exc.details() or ""))

    def call(self, method: str, payload: bytes,
             timeout: Optional[float] = None, wait_ready: bool = True,
             idempotent: bool = False) -> bytes:
        """Blocking call. ``idempotent=True`` also retries
        DEADLINE_EXCEEDED, which is safe only for methods whose second run
        cannot apply twice (getters, join, health)."""
        import grpc

        if timeout is None:
            timeout = self.default_deadline_s
        chunked = (len(payload) > STREAM_THRESHOLD
                   or method in self._chunked_methods)
        attempt = 0
        while True:
            try:
                if chunked:
                    return self._call_chunked(method, payload, timeout,
                                              wait_ready)
                fn = self._channel.unary_unary(
                    f"/{self.service_name}/{method}",
                    request_serializer=_identity,
                    response_deserializer=_identity)
                return fn(payload, timeout=timeout,
                          wait_for_ready=wait_ready)
            except grpc.RpcError as exc:
                if not chunked and self._oversize(exc):
                    chunked = True
                    self._chunked_methods.add(method)
                    continue
                code = exc.code()
                retryable = (code == grpc.StatusCode.UNAVAILABLE
                             or (idempotent and code
                                 == grpc.StatusCode.DEADLINE_EXCEEDED))
                if retryable and attempt < self.retries:
                    attempt += 1
                    logger.warning("%s/%s %s (attempt %d/%d)", self.target,
                                   method, code.name.lower(), attempt,
                                   self.retries)
                    time.sleep(self.retry_sleep_s)
                    continue
                raise

    def _call_chunked(self, method: str, payload: bytes,
                      timeout: Optional[float], wait_ready: bool) -> bytes:
        fn = self._channel.stream_stream(
            f"/{self.service_name}/{method}{_CHUNK_SUFFIX}",
            request_serializer=_identity, response_deserializer=_identity)
        return b"".join(fn(_iter_chunks(payload), timeout=timeout,
                           wait_for_ready=wait_ready))

    @staticmethod
    def _settle(outer: "futures.Future", callback, error_callback, method,
                result=None, exc: Optional[BaseException] = None) -> None:
        """Resolve the caller's future (it may have been cancelled) and
        fire exactly one of the callbacks."""
        try:
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(result)
        except futures.InvalidStateError:  # pragma: no cover - cancelled
            pass
        if exc is None:
            if callback is not None:
                callback(result)
        elif error_callback is not None:
            error_callback(exc)
        else:
            logger.warning("async RPC %s failed with no error_callback: %s",
                           method, exc)

    def call_async(self, method: str, payload: bytes,
                   callback: Optional[Callable[[bytes], None]] = None,
                   error_callback: Optional[Callable[[Exception], None]]
                   = None,
                   timeout: Optional[float] = None,
                   wait_ready: bool = True) -> "futures.Future":
        """Non-blocking call. ``wait_ready=False`` fails fast with
        UNAVAILABLE on a dead endpoint instead of queueing. Chunked calls
        (a payload above the threshold, or a method whose unary response
        was refused as oversize) run on a worker thread.

        The returned future resolves only with the final outcome: a unary
        attempt refused as oversize is re-issued chunked, and the future
        and the callbacks see that retry's result, once."""
        if timeout is None:
            timeout = self.default_deadline_s
        outer: "futures.Future" = futures.Future()
        if (len(payload) > STREAM_THRESHOLD
                or method in self._chunked_methods):
            self._async_chunked(method, payload, callback, error_callback,
                                timeout, wait_ready, outer)
            return outer
        fn = self._channel.unary_unary(
            f"/{self.service_name}/{method}",
            request_serializer=_identity, response_deserializer=_identity)
        future = fn.future(payload, timeout=timeout,
                           wait_for_ready=wait_ready)

        def _done(f):
            try:
                result = f.result()
            except Exception as exc:  # noqa: BLE001 - goes to the callback
                if self._oversize(exc):
                    self._chunked_methods.add(method)
                    self._async_chunked(method, payload, callback,
                                        error_callback, timeout, wait_ready,
                                        outer)
                    return
                self._settle(outer, callback, error_callback, method,
                             exc=exc)
                return
            self._settle(outer, callback, error_callback, method,
                         result=result)

        future.add_done_callback(_done)
        return outer

    def _async_chunked(self, method, payload, callback, error_callback,
                       timeout, wait_ready, outer) -> None:
        def _run():
            try:
                result = self._call_chunked(method, payload, timeout,
                                            wait_ready)
            except Exception as exc:  # noqa: BLE001 - goes to the callback
                self._settle(outer, callback, error_callback, method,
                             exc=exc)
                return
            self._settle(outer, callback, error_callback, method,
                         result=result)

        try:
            self._stream_pool.submit(_run)
        except RuntimeError as exc:
            # the pool is shut down (close() raced an oversize retry from a
            # grpc thread): the caller's future must still settle
            self._settle(outer, callback, error_callback, method, exc=exc)

    def close(self) -> None:
        self._stream_pool.shutdown(wait=False)
        self._channel.close()
