"""The port's gRPC transport, health service and controller service, alone
and against the JAX package's.

Echo services over localhost (every server binds port 0): unary and async
calls, handler errors as statuses, the chunked path with the thresholds
shrunk (as tests/test_rpc.py does for the JAX package), the oversize-unary
fallback, a port client against a JAX server and the reverse (chunked
included), grpc.health.v1 probes both ways, and each package's
``ControllerClient`` against the other's ``ControllerServer``.
"""

import os
import threading

import grpc
import numpy as np
import pytest

from metisfl_tpu.comm import health as jax_health
from metisfl_tpu.comm import rpc as jax_rpc
from metisfl_tpu.comm.messages import JoinRequest as JaxJoinRequest
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.controller.core import Controller as JaxController
from metisfl_tpu.controller.service import ControllerClient as JaxClient
from metisfl_tpu.controller.service import ControllerServer as JaxServer
from metisfl_tpu_torch.comm import JoinRequest, dumps, loads
from metisfl_tpu_torch.comm import health, rpc
from metisfl_tpu_torch.comm.rpc import BytesService, RpcClient, RpcServer
from metisfl_tpu_torch.config import FederationConfig
from metisfl_tpu_torch.controller import Controller
from metisfl_tpu_torch.controller.service import (
    CONTROLLER_SERVICE,
    ControllerClient,
    ControllerServer,
)
from metisfl_tpu_torch.tensor import pack_model


def _handlers(state):
    def echo(payload: bytes) -> bytes:
        state["count"] += 1
        return payload

    def boom(payload: bytes) -> bytes:
        raise RuntimeError("kaboom")

    def bad(payload: bytes) -> bytes:
        raise ValueError("malformed")

    return {"Echo": echo, "Boom": boom, "Bad": bad}


@pytest.fixture(params=["torch", "jax"])
def echo_server(request):
    """An echo service on a server of either package."""
    state = {"count": 0}
    if request.param == "torch":
        server = RpcServer("127.0.0.1", 0)
        server.add_service(BytesService("test.Echo", _handlers(state)))
    else:
        server = jax_rpc.RpcServer("127.0.0.1", 0)
        server.add_service(jax_rpc.BytesService("test.Echo",
                                                _handlers(state)))
    port = server.start()
    yield port, state
    server.stop()


@pytest.fixture
def port_server():
    state = {"count": 0}
    server = RpcServer("127.0.0.1", 0)
    server.add_service(BytesService("test.Echo", _handlers(state),
                                    role="test"))
    port = server.start()
    yield port, state
    server.stop()


def test_unary_roundtrip(echo_server):
    port, state = echo_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    payload = dumps({"x": 1, "blob": b"\x00" * 1000})
    assert loads(client.call("Echo", payload)) == loads(payload)
    assert state["count"] == 1
    client.close()


def test_jax_client_against_the_port_server(port_server):
    port, state = port_server
    client = jax_rpc.RpcClient("127.0.0.1", port, "test.Echo")
    assert client.call("Echo", b"from jax") == b"from jax"
    assert state["count"] == 1
    client.close()


def test_async_call(echo_server):
    port, _ = echo_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    done = threading.Event()
    result = {}

    def cb(raw):
        result["raw"] = raw
        done.set()

    future = client.call_async("Echo", b"hello", callback=cb)
    assert done.wait(10)
    assert result["raw"] == b"hello" == future.result(timeout=10)
    client.close()


@pytest.mark.parametrize("method,code", [
    ("Boom", grpc.StatusCode.INTERNAL),
    ("Bad", grpc.StatusCode.INVALID_ARGUMENT),
    ("Missing", grpc.StatusCode.UNIMPLEMENTED),
])
def test_errors_come_back_as_statuses(port_server, method, code):
    port, _ = port_server
    client = RpcClient("127.0.0.1", port, "test.Echo", retries=0)
    with pytest.raises(grpc.RpcError) as err:
        client.call(method, b"")
    assert err.value.code() == code
    failed = client.call_async(method, b"", error_callback=lambda e: None)
    with pytest.raises(grpc.RpcError):
        failed.result(timeout=10)
    client.close()


def test_unavailable_is_retried_then_raised():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    client = RpcClient("127.0.0.1", dead, "test.Echo", retries=2,
                       retry_sleep_s=0.01)
    with pytest.raises(grpc.RpcError) as err:
        client.call("Echo", b"", wait_ready=False, timeout=2.0)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    client.close()


@pytest.mark.parametrize("client_side", ["torch", "jax"])
def test_chunked_roundtrip_multi_frame(echo_server, monkeypatch,
                                       client_side):
    """Payloads above the threshold travel in chunks and come back whole,
    both directions, between any client and any server."""
    module = rpc if client_side == "torch" else jax_rpc
    monkeypatch.setattr(module, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(module, "CHUNK_BYTES", 4096)
    port, state = echo_server
    client = module.RpcClient("127.0.0.1", port, "test.Echo")
    payload = os.urandom(64 * 1024 + 7)  # 17 frames, a ragged tail
    assert client.call("Echo", payload) == payload
    assert state["count"] == 1
    client.close()


def test_oversize_unary_response_retries_chunked(port_server, monkeypatch):
    """A small request whose response exceeds the unary limit is refused
    by the server and re-issued over the chunked stream; the client then
    goes to the stream at once."""
    monkeypatch.setattr(rpc, "UNARY_RESPONSE_LIMIT", 100)
    monkeypatch.setattr(rpc, "CHUNK_BYTES", 64)
    port, state = port_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    payload = b"\xab" * 1000
    assert client.call("Echo", payload) == payload
    assert state["count"] == 2  # the unary attempt and the chunked retry
    assert client.call("Echo", payload) == payload
    assert state["count"] == 3
    client.close()


def test_async_oversize_resolves_with_the_final_outcome(port_server,
                                                        monkeypatch):
    monkeypatch.setattr(rpc, "UNARY_RESPONSE_LIMIT", 100)
    monkeypatch.setattr(rpc, "CHUNK_BYTES", 64)
    port, state = port_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    seen = []
    future = client.call_async("Echo", b"\xcd" * 1000, callback=seen.append,
                               error_callback=seen.append)
    assert future.result(timeout=30) == b"\xcd" * 1000
    assert seen == [b"\xcd" * 1000]  # one callback, the success
    assert state["count"] == 2
    client.close()


def test_async_chunked(echo_server, monkeypatch):
    monkeypatch.setattr(rpc, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(rpc, "CHUNK_BYTES", 2048)
    port, _ = echo_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    payload = b"\xcd" * 10_000
    assert client.call_async("Echo", payload).result(timeout=30) == payload
    client.close()


def test_list_methods(port_server):
    import json

    port, _ = port_server
    client = RpcClient("127.0.0.1", port, "test.Echo")
    reply = json.loads(client.call("ListMethods", b""))
    assert reply["service"] == "test.Echo" and reply["role"] == "test"
    assert {m["name"] for m in reply["methods"]} == {
        "Echo", "Boom", "Bad", "ListMethods"}
    client.close()


@pytest.mark.parametrize("server_side,prober", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_health_probes_both_ways(server_side, prober):
    mod = health if server_side == "torch" else jax_health
    servicer = mod.HealthServicer()
    servicer.set_status("svc.A", mod.SERVING)
    servicer.set_status("svc.B", mod.NOT_SERVING)
    server = (RpcServer if server_side == "torch"
              else jax_rpc.RpcServer)("127.0.0.1", 0)
    server.add_service(servicer.service())
    port = server.start()
    probe = (health if prober == "torch" else jax_health).probe_health
    try:
        assert probe("127.0.0.1", port) == "SERVING"
        assert probe("127.0.0.1", port, "svc.A") == "SERVING"
        assert probe("127.0.0.1", port, "svc.B") == "NOT_SERVING"
        # an unknown service is NOT_FOUND, which the probe reports as such
        assert probe("127.0.0.1", port, "svc.C") == "UNREACHABLE"
        servicer.set_all(mod.NOT_SERVING)
        assert probe("127.0.0.1", port) == "NOT_SERVING"
    finally:
        server.stop()
    assert probe("127.0.0.1", port, timeout=0.5) == "UNREACHABLE"


def test_health_messages_encode_like_the_jax_package():
    for service in ("", "metisfl_tpu.Controller"):
        assert (health.encode_request(service)
                == jax_health.encode_request(service))
        assert health.decode_request(
            jax_health.encode_request(service)) == service
    for status in (0, 1, 2, 3):
        assert (health.encode_response(status)
                == jax_health.encode_response(status))


def _seed_blob():
    rng = np.random.default_rng(0)
    return pack_model({"params": {"dense": {
        "kernel": rng.standard_normal((4, 3)).astype(np.float32),
        "bias": np.zeros(3, np.float32)}}})


class _NoLearner:
    """A proxy that accepts tasks and runs nothing (no learner behind)."""

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass


@pytest.mark.parametrize("server_side", ["torch", "jax"])
def test_controller_clients_against_either_controller(server_side):
    """Each package's ControllerClient joins, seeds and reads either
    package's controller over gRPC."""
    if server_side == "torch":
        server = ControllerServer(
            Controller(FederationConfig(), lambda r: _NoLearner()),
            host="127.0.0.1", port=0)
    else:
        server = JaxServer(JaxController(JaxFederationConfig(),
                                         lambda r: _NoLearner()),
                           host="127.0.0.1", port=0)
    port = server.start()
    mine = ControllerClient("127.0.0.1", port)
    theirs = JaxClient("127.0.0.1", port)
    try:
        assert mine.replace_community_model(_seed_blob())
        assert theirs.get_community_model() == _seed_blob()
        a = mine.join(JoinRequest(hostname="h", port=1,
                                  num_train_examples=10))
        b = theirs.join(JaxJoinRequest(hostname="h", port=2,
                                       num_train_examples=20))
        assert a.learner_id and b.learner_id and a.controller_epoch
        for client in (mine, theirs):
            learners = client.list_learners()
            assert sorted(ep["port"] for ep in learners) == [1, 2]
            assert client.health()["status"] == "SERVING"
            assert client.get_statistics()["global_iteration"] == 0
            assert client.get_runtime_metadata(tail=1)[
                "global_iteration"] == 0
            assert client.get_evaluation_lineage(tail=2) == []
            assert "JoinFederation" in {
                m["name"] for m in client.list_methods()["methods"]}
        snapshot = mine.describe_federation()
        if server_side == "torch":
            assert snapshot["global_iteration"] == 0
            assert len(snapshot["learners"]) == 2
        assert mine.leave(a.learner_id, a.auth_token)
        assert not theirs.leave(b.learner_id, "a wrong token")
        assert health.probe_health("127.0.0.1", port,
                                   CONTROLLER_SERVICE) == "SERVING"
        assert mine.shutdown_controller()
        assert server.wait_for_shutdown(10)
    finally:
        mine.close()
        theirs.close()
        server.stop()


def test_controller_handlers_run_without_a_grpc_server():
    """The services exist before start(): a direct call of a handler
    reaches the controller (what a machine without grpc can drive)."""
    controller = Controller(FederationConfig(), lambda r: _NoLearner())
    server = ControllerServer(controller)
    by_name = {s.service_name: s for s in server.services}
    handlers = by_name[CONTROLLER_SERVICE].handlers
    assert loads(handlers["ReplaceCommunityModel"](_seed_blob()))["ok"]
    reply = handlers["JoinFederation"](JoinRequest(port=3).to_wire())
    assert loads(reply)["learner_id"]
    assert handlers["GetCommunityModel"](b"") == _seed_blob()
    assert health.decode_response(by_name[health.HEALTH_SERVICE].handlers[
        "Check"](health.encode_request(CONTROLLER_SERVICE))) == \
        health.SERVING
    server.stop()


def test_tls_roundtrip(tmp_path, port_server):
    """An enabled SSLConfig serves TLS with the federation's self-signed
    pair; a client trusting its certificate talks to it, of either
    package."""
    from metisfl_tpu.comm.ssl import SSLConfig as JaxSSLConfig
    from metisfl_tpu_torch.comm.ssl import SSLConfig, generate_self_signed

    cert, key = generate_self_signed(str(tmp_path))
    ssl = SSLConfig(enabled=True, cert_path=cert, key_path=key)
    server = RpcServer("127.0.0.1", 0, ssl=ssl)
    server.add_service(BytesService("test.Echo", _handlers({"count": 0})))
    port = server.start()
    try:
        client = RpcClient("localhost", port, "test.Echo", ssl=ssl)
        assert client.call("Echo", b"sealed") == b"sealed"
        client.close()
        theirs = jax_rpc.RpcClient(
            "localhost", port, "test.Echo",
            ssl=JaxSSLConfig(enabled=True, cert_path=cert, key_path=key))
        assert theirs.call("Echo", b"sealed too") == b"sealed too"
        theirs.close()
    finally:
        server.stop()


def test_controller_client_redials_a_live_standby_endpoint():
    """With a second endpoint, a call that spends its UNAVAILABLE retries
    on a dead primary probes both endpoints and re-issues once on the one
    that answers SERVING."""
    import socket

    from metisfl_tpu_torch.config import CommConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    server = ControllerServer(
        Controller(FederationConfig(), lambda r: _NoLearner()),
        host="127.0.0.1", port=0)
    port = server.start()
    client = ControllerClient(
        "127.0.0.1", dead, comm=CommConfig(default_deadline_s=5.0,
                                           retries=1, retry_sleep_s=0.01),
        standby=("127.0.0.1", port))
    try:
        assert client.endpoint() == ("127.0.0.1", dead)
        assert client.health()["status"] == "SERVING"
        assert client.endpoint() == ("127.0.0.1", port)
    finally:
        client.close()
        server.stop()
    alone = ControllerClient("127.0.0.1", dead, comm=CommConfig(
        default_deadline_s=2.0, retries=0, retry_sleep_s=0.01))
    with pytest.raises(grpc.RpcError):
        alone.health()
    alone.close()
