"""The port's network model store (``store/remote.py``, ``store/server.py``)
against the JAX package's: tests/test_remote_store.py's cases on the
port's client and server, and both crossings (a port client on a JAX
server, a JAX client on a port server), each round-tripping a lineage and
ciphertext bytes verbatim. Also the standalone
``python -m metisfl_tpu_torch.store.server`` process and a blob large
enough for the chunked transport.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from metisfl_tpu.store import make_store as jax_make_store
from metisfl_tpu.store.remote import ModelStoreServer as JaxModelStoreServer
from metisfl_tpu.store.remote import RemoteModelStore as JaxRemoteModelStore
from metisfl_tpu_torch.store import make_store
from metisfl_tpu_torch.store.remote import ModelStoreServer, RemoteModelStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SIDES = {
    "port": (ModelStoreServer, RemoteModelStore, make_store),
    "jax": (JaxModelStoreServer, JaxRemoteModelStore, jax_make_store),
}


def _m(v, n=64):
    return {"layer/w": np.full((n,), float(v), np.float32),
            "layer/b": np.full((4,), float(v) + 0.5, np.float32)}


@pytest.fixture(params=[("port", "port"), ("port", "jax"), ("jax", "port")],
                ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def served(request, tmp_path):
    """A cached_disk store server of one package and a client of the
    other (or the same)."""
    client_side, server_side = request.param
    server_cls, _, factory = _SIDES[server_side]
    server = server_cls(factory("cached_disk", root=str(tmp_path / "blobs"),
                                lineage_length=2))
    port = server.start()
    client = _SIDES[client_side][1]("localhost", port)
    yield server, client, port
    client.shutdown()
    server.stop()


def test_roundtrip_lineage_and_eviction(served):
    _, client, _ = served
    assert client.ping()
    for v in (1, 2, 3):
        client.insert("L0", _m(v))
    client.insert("L1", _m(9))
    out = client.select(["L0", "L1", "ghost"], k=5)
    assert set(out) == {"L0", "L1"}
    # server-side lineage_length=2 evicted seq 0; most recent first
    assert [float(m["layer/w"][0]) for m in out["L0"]] == [3.0, 2.0]
    np.testing.assert_array_equal(out["L1"][0]["layer/b"], 9.5)
    assert out["L1"][0]["layer/b"].dtype == np.float32
    assert client.size("L0") == 2
    assert sorted(client.learner_ids()) == ["L0", "L1"]
    client.erase(["L0"])
    assert client.select(["L0"]) == {}


def test_raw_ciphertext_bytes_pass_verbatim(served):
    _, client, _ = served
    payload = b"\x00opaque-ciphertext\xff" * 100
    client.insert("enc", payload)
    out = client.select(["enc"])["enc"][0]
    assert isinstance(out, bytes) and out == payload


def test_failover_client_sees_prior_lineage(tmp_path):
    """A new client (a restarted controller) of the same server finds
    everything the old one stored."""
    server = ModelStoreServer(make_store("cached_disk",
                                         root=str(tmp_path / "blobs"),
                                         lineage_length=2))
    port = server.start()
    try:
        first = RemoteModelStore("localhost", port)
        first.insert("L0", _m(7))
        first.shutdown()
        second = RemoteModelStore("localhost", port)
        try:
            np.testing.assert_allclose(
                second.select(["L0"])["L0"][0]["layer/w"], 7.0)
        finally:
            second.shutdown()
    finally:
        server.stop()


def test_store_survives_server_restart(tmp_path):
    """A disk-backed server restarted on the same root keeps the lineage
    (the sequence numbers are the bookkeeping)."""
    root = str(tmp_path / "blobs")
    server = ModelStoreServer(make_store("cached_disk", root=root,
                                         lineage_length=2))
    port = server.start()
    client = RemoteModelStore("localhost", port)
    client.insert("L0", _m(1))
    client.insert("L0", _m(2))
    client.shutdown()
    server.stop()

    reborn = ModelStoreServer(make_store("cached_disk", root=root,
                                         lineage_length=2))
    port2 = reborn.start()
    client2 = RemoteModelStore("localhost", port2)
    try:
        out = client2.select(["L0"], k=2)
        assert [float(m["layer/w"][0]) for m in out["L0"]] == [2.0, 1.0]
    finally:
        client2.shutdown()
        reborn.stop()


def test_standalone_server_process(tmp_path):
    """``python -m metisfl_tpu_torch.store.server`` boots, prints its
    port, serves a JAX client and a port client, and exits 0 on
    SIGTERM."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "metisfl_tpu_torch.store.server", "--port",
         "0", "--store", "disk", "--root", str(tmp_path / "blobs")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    try:
        port = None
        for _ in range(100):
            line = proc.stdout.readline()
            if "METISFL_TPU_STORE_READY" in line:
                port = int(line.strip().rsplit("=", 1)[1])
                break
        assert port, "server did not report readiness"
        for cls, v in ((RemoteModelStore, 5), (JaxRemoteModelStore, 6)):
            client = cls("localhost", port)
            client.insert(f"L{v}", _m(v))
            np.testing.assert_allclose(
                client.select([f"L{v}"])[f"L{v}"][0]["layer/w"], float(v))
            client.shutdown()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
    assert sorted(os.listdir(tmp_path / "blobs")) == ["L5", "L6"]


def test_federation_runs_on_remote_store(tmp_path):
    """A port federation whose controller keeps all model state in the
    store service completes rounds, and its lineage lands there."""
    from metisfl_tpu_torch.config import (AggregationConfig, EvalConfig,
                                          FederationConfig, ModelStoreConfig,
                                          TerminationConfig)
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    server = ModelStoreServer(make_store("cached_disk",
                                         root=str(tmp_path / "blobs"),
                                         lineage_length=2))
    port = server.start()
    try:
        fed = InProcessFederation(FederationConfig(
            aggregation=AggregationConfig(rule="fedavg",
                                          scaler="participants"),
            train=TrainParams(batch_size=8, local_steps=2,
                              learning_rate=0.1),
            eval=EvalConfig(every_n_rounds=0),
            termination=TerminationConfig(federation_rounds=2),
            model_store=ModelStoreConfig(store="remote", host="localhost",
                                         port=port, ingest_workers=2)))
        rng = np.random.default_rng(3)
        template = None
        try:
            for i in range(2):
                x = rng.standard_normal((32, 6)).astype(np.float32)
                y = rng.integers(0, 3, 32).astype(np.int32)
                ops = TorchModelOps(MLP(6, (8,), 3), device="cpu")
                template = template or ops.get_variables()
                fed.add_learner(ops, ArrayDataset(x, y, seed=i))
            fed.seed_model(template)
            fed.start()
            assert fed.wait_for_rounds(2, timeout_s=120)
            assert len(server.store.learner_ids()) == 2
        finally:
            fed.shutdown()
    finally:
        server.stop()


def test_large_blob_streams_through_store_service(tmp_path, monkeypatch):
    """The store rides the chunked transport: a blob past the (tuned
    down) stream threshold round-trips through insert and select with
    exact bytes, and the client really streamed it."""
    from metisfl_tpu_torch.comm import rpc

    monkeypatch.setattr(rpc, "STREAM_THRESHOLD", 64 * 1024)
    monkeypatch.setattr(rpc, "CHUNK_BYTES", 128 * 1024)
    streamed = []
    orig = rpc.RpcClient._call_chunked

    def spy(self, *args, **kwargs):
        streamed.append(args[0])
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(rpc.RpcClient, "_call_chunked", spy)
    server = ModelStoreServer(make_store("cached_disk",
                                         root=str(tmp_path / "blobs")))
    port = server.start()
    client = RemoteModelStore("localhost", port)
    try:
        big = {"emb/table": np.random.default_rng(0).standard_normal(
            (512, 1024)).astype(np.float32)}  # ~2 MB >> threshold
        client.insert("whale", big)
        got = client.select(["whale"], k=1)["whale"][0]
        np.testing.assert_array_equal(got["emb/table"], big["emb/table"])
        assert "Insert" in streamed, streamed
    finally:
        client.shutdown()
        server.stop()
