"""Network model store (the port's copy of the JAX package's
``store/remote.py``): model lineage held by a separate process.

:class:`ModelStoreServer` (``python -m metisfl_tpu_torch.store.server``)
hosts any local store backend over gRPC, and :class:`RemoteModelStore` is
a drop-in ``ModelStore`` client that the controller selects with
``ModelStoreConfig(store="remote", host=..., port=...)``. A restarted
controller reconnects and finds the full lineage. The service name,
methods and payloads are the JAX package's, so a port client talks to a
JAX server and the reverse.

Wire format: the session codec (``comm/codec.py``) for structure, models
as v2 blob bytes (``pack_store_value``), raw byte payloads (ciphertexts)
verbatim. Models read back as ``{name: numpy array}``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.rpc import BytesService, RpcClient, RpcServer
from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore
from metisfl_tpu_torch.store.disk import decode_store_value, pack_store_value

logger = logging.getLogger("metisfl_tpu_torch.store.remote")

SERVICE_NAME = "metisfl.ModelStore"


def _encode_value(model: Any) -> Dict[str, Any]:
    if isinstance(model, (bytes, bytearray)):
        return {"kind": "bytes", "data": bytes(model)}
    return {"kind": "tree", "data": pack_store_value(model)}


def _decode_value(wire: Dict[str, Any]) -> Any:
    data = wire["data"]
    if wire["kind"] == "bytes":
        return data
    # the wire carries v2 blobs only
    return decode_store_value(data, allow_nocrc=False)


class ModelStoreServer:
    """Serves any local :class:`ModelStore` backend over gRPC."""

    def __init__(self, store: ModelStore, host: str = "0.0.0.0",
                 port: int = 0, ssl=None):
        self.store = store
        self._server = RpcServer(host, port, ssl=ssl)
        self._server.add_service(BytesService(SERVICE_NAME, {
            "Insert": self._insert,
            "Select": self._select,
            "Erase": self._erase,
            "LearnerIds": self._learner_ids,
            "Size": self._size,
            "Ping": lambda _: b"ok",
        }))
        self.port: int = 0

    # -- handlers ----------------------------------------------------------
    def _insert(self, payload: bytes) -> bytes:
        req = loads(payload)
        self.store.insert(req["lid"], _decode_value(req["value"]))
        return dumps(True)

    def _select(self, payload: bytes) -> bytes:
        req = loads(payload)
        picked = self.store.select(req["lids"], k=int(req["k"]))
        return dumps({
            lid: [_encode_value(m) for m in lineage]
            for lid, lineage in picked.items()
        })

    def _erase(self, payload: bytes) -> bytes:
        self.store.erase(loads(payload)["lids"])
        return dumps(True)

    def _learner_ids(self, _: bytes) -> bytes:
        return dumps(self.store.learner_ids())

    def _size(self, payload: bytes) -> bytes:
        return dumps(self.store.size(loads(payload)["lid"]))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self.port = self._server.start()
        return self.port

    def stop(self) -> None:
        self._server.stop()
        self.store.shutdown()

    def wait(self) -> None:
        self._server.wait()


class RemoteModelStore(ModelStore):
    """Drop-in ``ModelStore`` backed by a :class:`ModelStoreServer`.

    Eviction lives server-side (the server's backend was built with its
    own lineage length); this client only transports."""

    def __init__(self, host: str, port: int, lineage_length: int = 1,
                 ssl=None, timeout_s: float = 60.0):
        super().__init__(EvictionPolicy.LINEAGE_LENGTH, lineage_length)
        self._client = RpcClient(host, port, SERVICE_NAME, ssl=ssl)
        self.timeout_s = timeout_s

    def ping(self) -> bool:
        try:
            return self._client.call("Ping", b"", timeout=5.0) == b"ok"
        except Exception:  # noqa: BLE001 - any failure means "not up"
            return False

    # public API overrides (the lock/evict machinery is server-side)
    def insert(self, learner_id: str, model: Any) -> None:
        self._client.call("Insert", dumps(
            {"lid": learner_id, "value": _encode_value(model)}),
            timeout=self.timeout_s)

    def select(self, learner_ids: Sequence[str],
               k: int = 1) -> Dict[str, List[Any]]:
        wire = loads(self._client.call("Select", dumps(
            {"lids": list(learner_ids), "k": int(k)}),
            timeout=self.timeout_s))
        return {lid: [_decode_value(m) for m in lineage]
                for lid, lineage in wire.items()}

    def erase(self, learner_ids: Sequence[str]) -> None:
        self._client.call("Erase", dumps({"lids": list(learner_ids)}),
                          timeout=self.timeout_s)

    def learner_ids(self) -> List[str]:
        return loads(self._client.call("LearnerIds", b"",
                                       timeout=self.timeout_s))

    def size(self, learner_id: str) -> int:
        return int(loads(self._client.call(
            "Size", dumps({"lid": learner_id}), timeout=self.timeout_s)))

    def shutdown(self) -> None:
        self._client.close()
