"""Slice aggregator: one contiguous slice of the cohort, folded in its own
process (the port's copy of the JAX package's ``aggregation/slice.py``).

A slice aggregator receives its learners' uplinks over gRPC, folds them
with the in-process tree tier's kernel (:meth:`TreeReducer._fold_slice`
over ``np_stacked_scaled_add``) and answers one ``FoldPartial`` per round,
so the controller fans in O(branch) partials and never holds the slice's
models (``aggregation/distributed.py`` is the controller side). The
service name, its methods and every payload are the JAX package's byte for
byte: a slice of either package answers a controller of the other.

Durability: every accepted uplink is spooled to
``<spool_dir>/<learner_id>.bin`` by an atomic rename BEFORE the submit is
acked, so an acked uplink survives the process. When the aggregator dies
mid-round the controller re-reads the spool directory and re-homes the
slice; a relaunched aggregator reloads its spool.

Memory: one fold-ready model tree per owned learner, latest wins (the
``required_lineage == 1`` of the weighted-sum rules the tier serves:
fedavg, scaffold, fedstride). Masked uplinks (secure aggregation under
masking) are held as uint64 payloads, or folded on arrival into the
round's modular accumulator. ``Forget`` prunes departed learners.

Host numpy only. Entry point::

    python -m metisfl_tpu_torch.aggregation.slice --port 50070 \\
        --spool-dir /tmp/slices/slice_0 --name slice_0
    # or as DriverSession boots it: --config federation_config.bin --index 0

Telemetry, the JAX package's: the uplink, held-model and masked-fold
metrics, a ``slice.fold`` span under the ``FoldPartial`` server span, and
``GetMetrics``; with ``--config`` the process applies the config's
``telemetry`` section.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.aggregation.tree import _DEFAULT_SUBBLOCK, TreeReducer
from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.secure.distributed import MaskedAccumulator
from metisfl_tpu_torch.store import durable as _durable
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import trace as _ttrace
from metisfl_tpu_torch.telemetry.sketch import QuantileDigest, SpaceSaving
from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy

logger = logging.getLogger("metisfl_tpu_torch.aggregation.slice")

# the wire name both packages serve and dial
SLICE_SERVICE = "metisfl_tpu.SliceAggregator"

# stream-mode accumulators kept per round id (mask streams are
# round-keyed: older rounds' sums can never settle)
_STREAM_ROUNDS_KEPT = 4

_REG = _tmetrics.registry()
_M_UPLINKS = _REG.counter(
    _tel.M_SLICE_UPLINKS_TOTAL,
    "Uplinks accepted (spooled + held) by this slice aggregator")
_M_HELD = _REG.gauge(
    _tel.M_SLICE_HELD_MODELS,
    "Learner models currently held fold-ready by this slice aggregator")
_M_MASKED_UPLINKS = _REG.counter(
    _tel.M_SECURE_MASKED_UPLINKS_TOTAL,
    "Masked (secure-agg) uplinks accepted by this process")
_M_MASKED_FOLDS = _REG.counter(
    _tel.M_SECURE_MASKED_FOLDS_TOTAL,
    "Masked partial folds performed, by tier",
    labelnames=("tier",))


def spool_path(spool_dir: str, learner_id: str) -> str:
    """The learner's spool file; the id is sanitized into a file name with
    a digest suffix (``store/durable.py``), and the exact id rides inside
    the record."""
    return os.path.join(spool_dir, f"{_durable.sanitize_id(learner_id)}.bin")


def _decode_record(raw: bytes):
    record = loads(raw)
    blob = record["model"]
    ModelBlob.from_bytes(blob)  # integrity check before recovery
    return str(record["learner_id"]), int(record.get("round", 0)), blob


def read_spool_records(spool_dir: str) -> Dict[str, tuple]:
    """A (possibly dead) aggregator's spooled uplinks: ``{learner_id:
    (round, model blob bytes)}``. Torn or unreadable files are skipped
    with a warning: re-homing recovers what it can. The round matters for
    masked uplinks, which fold only into their own round."""
    out: Dict[str, tuple] = {}
    if not os.path.isdir(spool_dir):
        return out
    for name in sorted(os.listdir(spool_dir)):
        if not name.endswith(".bin"):
            continue
        decoded = _durable.read_tolerant(os.path.join(spool_dir, name),
                                         _decode_record)
        if decoded is not None:
            out[decoded[0]] = (decoded[1], decoded[2])
    return out


def read_spool(spool_dir: str) -> Dict[str, bytes]:
    """``{learner_id: model blob bytes}`` (see :func:`read_spool_records`)."""
    return {lid: blob
            for lid, (_, blob) in read_spool_records(spool_dir).items()}


def _plain_tensors(blob: ModelBlob) -> Dict[str, np.ndarray]:
    return {name: to_numpy(t) for name, t in blob.tensors}


class SliceAggregator:
    """The slice aggregator's state, without a transport (the server below
    mounts it behind a ``BytesService``; tests drive it directly).
    Thread-safe: uplinks arrive on RPC threads while the controller's fold
    request runs on another."""

    def __init__(self, spool_dir: str = "", name: str = "slice"):
        self.name = name
        self.spool_dir = spool_dir
        if spool_dir:
            os.makedirs(spool_dir, exist_ok=True)
        self._lock = threading.Lock()
        # learner_id -> (round, fold-ready model tree), latest wins
        self._models: Dict[str, tuple] = {}
        # masked uplinks held (learner_id -> (round, opaque dict)) and the
        # fold-on-arrival accumulators, one per round id
        self._masked: Dict[str, tuple] = {}
        self._stream_accs: Dict[int, MaskedAccumulator] = {}
        if spool_dir:
            # a relaunched aggregator reloads its spool: an acked uplink
            # survives the process for the supervised relaunch too
            for lid, (rid, blob) in read_spool_records(spool_dir).items():
                decoded = ModelBlob.from_bytes(blob)
                if decoded.opaque:
                    # held even where the live path streams: the fold's
                    # held scan picks up the round-matched survivors
                    self._masked[lid] = (rid, dict(decoded.opaque))
                else:
                    self._models[lid] = (rid, _plain_tensors(decoded))
            if self._models or self._masked:
                logger.info("slice %s reloaded %d spooled model(s)",
                            name, len(self._models) + len(self._masked))
                _M_HELD.set(len(self._models) + len(self._masked))
        # the slice's per-client uplink rollup, shipped as mergeable
        # sketches in every fold reply
        self._bytes_digest = QuantileDigest()
        self._top_bytes = SpaceSaving(capacity=32)
        self._uplinks = 0

    # -- uplink path (RPC threads) ----------------------------------------
    def submit(self, learner_id: str, round_id: int, blob: bytes,
               stream: bool = False) -> int:
        """Accept one uplink: spool it first (atomic: an acked uplink
        survives this process), then hold the decoded tree fold-ready.
        Masked payloads are held as uint64 blobs, or with ``stream`` fold
        straight into the round's modular accumulator (a duplicate id is
        skipped: a re-shipped masked payload is byte-identical). Returns
        the number of models held."""
        decoded = ModelBlob.from_bytes(blob)
        masked = bool(decoded.opaque)
        model = dict(decoded.opaque) if masked else _plain_tensors(decoded)
        if not model:
            raise ValueError("uplink carries no tensors")
        if self.spool_dir:
            record = dumps({"learner_id": learner_id,
                            "round": int(round_id), "model": blob})
            _durable.atomic_write(spool_path(self.spool_dir, learner_id),
                                  record, prefix=".up_")
        rid = int(round_id)
        with self._lock:
            if masked and stream:
                acc = self._stream_accs.get(rid)
                if acc is None:
                    acc = self._stream_accs[rid] = MaskedAccumulator()
                    while len(self._stream_accs) > _STREAM_ROUNDS_KEPT:
                        self._stream_accs.pop(min(self._stream_accs))
                acc.fold(learner_id, model)
            elif masked:
                self._masked[learner_id] = (rid, model)
            else:
                self._models[learner_id] = (rid, model)
            held = len(self._models) + len(self._masked)
            self._uplinks += 1
            self._bytes_digest.add(float(len(blob)))
            self._top_bytes.update(learner_id, float(len(blob)))
        _M_UPLINKS.inc()
        if masked:
            _M_MASKED_UPLINKS.inc()
        _M_HELD.set(held)
        return held

    def forget(self, learner_ids) -> int:
        """Prune departed learners: drop the held model and the spool
        file. Returns how many were held. A stream-folded contribution
        stays in its round's sum (a modular fold cannot be undone without
        the payload; the settlement counts the contributor)."""
        dropped = 0
        with self._lock:
            for lid in learner_ids:
                if self._models.pop(lid, None) is not None:
                    dropped += 1
                if self._masked.pop(lid, None) is not None:
                    dropped += 1
                self._top_bytes.drop(lid)
            held = len(self._models) + len(self._masked)
        _M_HELD.set(held)
        if self.spool_dir:
            for lid in learner_ids:
                try:
                    os.unlink(spool_path(self.spool_dir, lid))
                except OSError:
                    pass
        return dropped

    # -- fold path (the controller's FoldPartial) --------------------------
    def fold(self, ids, scales: Dict[str, float],
             stride: int = 0) -> Dict[str, Any]:
        """Fold the held models of ``ids``, in the given order, with the
        tree tier's sub-block blocking: the same kernel and accumulator
        dtypes, so the partial equals a :class:`TreeReducer` worker's bit
        for bit. Returns the wire-ready partial."""
        with self._lock:
            snapshot = {lid: self._models[lid][1] for lid in ids
                        if lid in self._models}

        def fetch(block):
            return {lid: [snapshot[lid]] for lid in block
                    if lid in snapshot}

        # the named fold span under the FoldPartial server span
        with _ttrace.span("slice.fold",
                          attrs={"slice": self.name, "ids": len(ids)}):
            partial = TreeReducer._fold_slice(list(ids), scales, fetch,
                                              int(stride) or _DEFAULT_SUBBLOCK)
        reply: Dict[str, Any] = {
            "ok": True,
            "count": partial.count,
            "z": float(partial.z),
            "duration_ms": round(partial.duration_ms, 3),
            "dtypes": list(partial.dtypes or ()),
            "present": [lid for lid in ids if lid in snapshot],
            "acc": b"",
            "stats": self.stats(),
        }
        if partial.acc is not None:
            reply["acc"] = ModelBlob(
                tensors=[(name, np.asarray(arr))
                         for name, arr in sorted(partial.acc.items())]
            ).to_bytes()
        return reply

    def fold_masked(self, ids, round_id: int,
                    stream: bool = False) -> Dict[str, Any]:
        """The masked partial fold: per-tensor uint64 sums mod 2^64 over
        this slice's contributors (no scales, no keys; the masks cancel at
        the root). Starts from the round's stream accumulator and adds the
        held round-matched payloads of ``ids`` the stream has not seen.
        The reply's ``present`` list is what the root's settlement
        reconciles against the cohort."""
        rid = int(round_id)
        t0 = time.perf_counter()
        out = MaskedAccumulator()
        with self._lock:
            if stream:
                acc = self._stream_accs.get(rid)
                if acc is not None:
                    sums, specs, contributors = acc.snapshot()
                    out.merge_sums(sums, contributors, specs)
            for lid in ids:
                held = self._masked.get(lid)
                if held is None or held[0] != rid:
                    continue
                out.fold(lid, held[1])
        sums, specs, present = out.snapshot()
        _M_MASKED_FOLDS.inc(tier="slice")
        reply: Dict[str, Any] = {
            "ok": True,
            "masked": True,
            "count": out.count,
            "duration_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "present": present,
            "acc": b"",
            "stats": self.stats(),
        }
        if sums:
            reply["acc"] = ModelBlob(opaque={
                name: (sums[name].tobytes(), specs[name])
                for name in sorted(sums)}).to_bytes()
        return reply

    def stats(self) -> Dict[str, Any]:
        """The slice's per-client rollup as mergeable sketches: the
        uplink-bytes digest and the top learners by bytes."""
        with self._lock:
            return {
                "name": self.name,
                "held": len(self._models) + len(self._masked),
                "uplinks": self._uplinks,
                "bytes_digest": self._bytes_digest.to_dict(),
                "top_bytes": self._top_bytes.to_dict(),
            }


class SliceServer:
    """A :class:`SliceAggregator` behind gRPC, with ``grpc.health.v1``
    (the controller probes it with ``comm.health.probe_health``)."""

    def __init__(self, spool_dir: str = "", name: str = "slice",
                 host: str = "0.0.0.0", port: int = 0, ssl=None):
        from metisfl_tpu_torch.comm.health import SERVING, HealthServicer
        from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer

        self.aggregator = SliceAggregator(spool_dir=spool_dir, name=name)
        self._server = RpcServer(host, port, ssl=ssl)
        self._health = HealthServicer()
        self._health.set_status(SLICE_SERVICE, SERVING)
        self._server.add_service(self._health.service())
        self._server.add_service(BytesService(SLICE_SERVICE, {
            "SubmitUplink": self._submit,
            "FoldPartial": self._fold,
            "Forget": self._forget,
            "DescribeSlice": self._describe,
            "GetHealthStatus": self._health_rpc,
            "GetMetrics": self._get_metrics,
            "ShutDown": self._shutdown_rpc,
        }, role="slice"))
        self._shutdown_event = threading.Event()
        self.port: Optional[int] = None

    # -- handlers (RPC threads) -------------------------------------------
    def _submit(self, raw: bytes) -> bytes:
        req = loads(raw)
        held = self.aggregator.submit(str(req["learner_id"]),
                                      int(req.get("round", 0)),
                                      req["model"],
                                      stream=bool(req.get("stream", False)))
        return dumps({"ok": True, "held": held})

    def _fold(self, raw: bytes) -> bytes:
        req = loads(raw)
        ids = [str(lid) for lid in req.get("ids", [])]
        if bool(req.get("masked", False)):
            return dumps(self.aggregator.fold_masked(
                ids, int(req.get("round", 0)),
                stream=bool(req.get("stream", False))))
        return dumps(self.aggregator.fold(
            ids,
            {str(k): float(v) for k, v in (req.get("scales") or {}).items()},
            stride=int(req.get("stride", 0))))

    def _forget(self, raw: bytes) -> bytes:
        req = loads(raw)
        dropped = self.aggregator.forget(
            [str(lid) for lid in req.get("learner_ids", [])])
        return dumps({"ok": True, "dropped": dropped})

    def _describe(self, raw: bytes) -> bytes:
        return dumps(self.aggregator.stats())

    def _get_metrics(self, raw: bytes) -> bytes:
        return _tel.render_metrics().encode("utf-8")

    def _health_rpc(self, raw: bytes) -> bytes:
        return dumps({"status": "SERVING", "name": self.aggregator.name})

    def _shutdown_rpc(self, raw: bytes) -> bytes:
        threading.Thread(target=self.stop, daemon=True).start()
        return dumps({"ok": True})

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self.port = self._server.start()
        return self.port

    def stop(self) -> None:
        if self._shutdown_event.is_set():
            return
        from metisfl_tpu_torch.comm.health import NOT_SERVING

        self._health.set_all(NOT_SERVING)
        self._shutdown_event.set()
        self._server.stop()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)


class SliceClient:
    """Controller → slice aggregator. No transparent retries: the
    distributed tier owns the retry, backoff and re-home policy, so a dead
    endpoint surfaces at once (``retries=0``, no wait for ready)."""

    def __init__(self, host: str, port: int, ssl=None, comm=None,
                 timeout_s: float = 30.0):
        from metisfl_tpu_torch.comm.rpc import RpcClient

        kwargs = {}
        if comm is not None:
            kwargs["default_deadline_s"] = comm.default_deadline_s
        self.target = f"{host}:{port}"
        self.timeout_s = timeout_s
        self._client = RpcClient(host, port, SLICE_SERVICE, retries=0,
                                 ssl=ssl, **kwargs)

    def submit(self, learner_id: str, round_id: int, blob: bytes,
               stream: bool = False) -> dict:
        return loads(self._client.call(
            "SubmitUplink",
            dumps({"learner_id": learner_id, "round": int(round_id),
                   "model": blob, "stream": bool(stream)}),
            timeout=self.timeout_s, wait_ready=False))

    def fold(self, ids, scales, stride: int = 0,
             timeout: Optional[float] = None) -> dict:
        return loads(self._client.call(
            "FoldPartial",
            dumps({"ids": list(ids), "scales": dict(scales),
                   "stride": int(stride)}),
            timeout=timeout or max(self.timeout_s, 120.0),
            wait_ready=False))

    def fold_masked(self, ids, round_id: int, stream: bool = False,
                    timeout: Optional[float] = None) -> dict:
        return loads(self._client.call(
            "FoldPartial",
            dumps({"ids": list(ids), "masked": True,
                   "round": int(round_id), "stream": bool(stream)}),
            timeout=timeout or max(self.timeout_s, 120.0),
            wait_ready=False))

    def forget(self, learner_ids) -> dict:
        return loads(self._client.call(
            "Forget", dumps({"learner_ids": list(learner_ids)}),
            timeout=self.timeout_s, wait_ready=False))

    def describe(self) -> dict:
        return loads(self._client.call("DescribeSlice", b"",
                                       timeout=self.timeout_s,
                                       wait_ready=False, idempotent=True))

    def shutdown_remote(self) -> None:
        self._client.call("ShutDown", b"", timeout=5.0, wait_ready=False)

    def close(self) -> None:
        self._client.close()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "metisfl_tpu_torch.aggregation.slice",
        description="slice aggregator process (BytesService role 'slice')")
    parser.add_argument("--config", default="",
                        help="federation config file (wire or YAML); the "
                             "endpoint comes from aggregation.tree."
                             "slices[--index]")
    parser.add_argument("--index", type=int, default=0,
                        help="this aggregator's entry in aggregation."
                             "tree.slices (with --config)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--spool-dir", default="")
    parser.add_argument("--name", default="")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    host, port = args.host, args.port
    spool_dir, name = args.spool_dir, args.name
    ssl = None
    if args.config:
        from metisfl_tpu_torch.config import FederationConfig, load_config
        if args.config.endswith((".yaml", ".yml")):
            config = load_config(args.config)
        else:
            with open(args.config, "rb") as fh:
                config = FederationConfig.from_wire(fh.read())
        slices = config.aggregation.tree.slices
        if not 0 <= args.index < len(slices):
            parser.error(f"--index {args.index} out of range for "
                         f"{len(slices)} configured slice(s)")
        spec = slices[args.index]
        port = port or int(spec.get("port", 0))
        spool_dir = spool_dir or str(spec.get("spool_dir", ""))
        name = name or str(spec.get("name", ""))
        ssl = config.ssl
        _tel.apply_config(config.telemetry,
                          service=name or f"slice_{args.index}")
    name = name or f"slice_{os.getpid()}"
    server = SliceServer(spool_dir=spool_dir, name=name, host=host,
                         port=port, ssl=ssl)
    bound = server.start()
    # SIGTERM (a launcher's stop) ends the process as ShutDown does
    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    logger.info("slice aggregator %s listening on %s:%d (spool %s)",
                name, host, bound, spool_dir or "<off>")
    try:
        server.wait_for_shutdown()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
