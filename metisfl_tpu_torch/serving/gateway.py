"""Serving gateway core: micro-batching, hot-swap, canary routing.

The torch side of the JAX package's ``serving/gateway.py``:

- **Micro-batching.** Concurrent requests coalesce into one forward pass:
  the batcher waits ``max_wait_ms`` from the first queued row (or until
  ``max_batch`` rows accumulate) and executes one padded forward. Every
  forward pads to exactly ``max_batch`` rows (repeating the last row), so
  each row's computation is the same whether it arrived alone or
  coalesced, and batched results are bit-identical to unbatched ones.
- **Hot-swap.** A channel's ``(version, model)`` pair is replaced
  atomically under the gateway lock; a batch in flight already captured
  the old pair and completes on it, so no request is dropped or served a
  half-installed model. ``model`` is a device copy of the module made once
  at install (``TorchModelOps.bind``).
- **Canary.** Requests carry a routing key; ``crc32(key) % 10000`` below
  ``canary_percent * 100`` routes to the ``candidate`` channel when one is
  installed. Deterministic: a key always lands on the same side.
- **Registry sync.** :meth:`ServingGateway.sync` compares the channel heads
  of a registry source with what is installed and hot-swaps the changed
  ones; :meth:`ServingGateway.start_sync` polls on a background thread
  every ``poll_every_s``, its first poll phased by ``initial_delay_s``
  (replicas stagger so that a promotion rolls through a fleet one at a
  time). The sources: :class:`DirectRegistrySource` (a controller in this
  process) and :class:`ControllerRegistrySource` (a ``ControllerClient``,
  which redials a promoted standby).

Telemetry, the JAX package's: requests by served channel, request
latency, batch rows, queue depth, the installed version and swaps per
channel, ``ServingSwapped`` events, and ``serving.predict``/
``serving.generate`` spans. The locks are plain ``threading`` locks, what
the JAX package hands out with ``telemetry.prof.enabled=false``.
"""

from __future__ import annotations

import logging
import re
import threading
import time
import zlib
from concurrent import futures
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.models.ops import resolve_device
from metisfl_tpu_torch.serving.decode import ContinuousBatcher
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import trace as _ttrace
from metisfl_tpu_torch.tensor.pytree import ModelBlob, pytree_to_named_tensors

logger = logging.getLogger("metisfl_tpu_torch.serving")

_REG = _tmetrics.registry()
_M_REQUESTS = _REG.counter(
    _tel.M_SERVING_REQUESTS_TOTAL, "Inference requests by routed channel",
    ("channel",))
_M_LATENCY = _REG.histogram(
    _tel.M_SERVING_REQUEST_LATENCY_SECONDS,
    "End-to-end request latency (enqueue -> reply)")
_M_BATCH_ROWS = _REG.histogram(
    _tel.M_SERVING_BATCH_ROWS,
    "Rows per executed micro-batch (occupancy of the max_batch bucket)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_M_VERSION = _REG.gauge(
    _tel.M_SERVING_MODEL_VERSION,
    "Registry version currently installed per channel", ("channel",))
_M_SWAPS = _REG.counter(
    _tel.M_SERVING_SWAPS_TOTAL, "Hot-swaps by channel", ("channel",))
_M_QUEUE_DEPTH = _REG.gauge(
    _tel.M_SERVING_QUEUE_DEPTH,
    "Requests currently queued per micro-batcher channel — the occupancy "
    "signal the round cost profile and fleet scale-out key on (series "
    "removed when the channel's batcher closes)", ("channel",))

# registry channel names (the JAX package's registry/registry.py)
CHANNEL_CANDIDATE = "candidate"
CHANNEL_STABLE = "stable"


def canary_channel(key: str, canary_percent: float) -> str:
    """Deterministic traffic split: the candidate channel owns the lowest
    ``canary_percent`` of the crc32 keyspace (basis-point resolution).
    Keyless requests serve stable: ``crc32(b"") == 0`` sits inside EVERY
    canary slice, so defaulting them in would send all unkeyed traffic to
    the candidate the moment a canary arms."""
    if canary_percent <= 0.0 or not key:
        return CHANNEL_STABLE
    slot = zlib.crc32(key.encode("utf-8")) % 10000
    return (CHANNEL_CANDIDATE if slot < canary_percent * 100.0
            else CHANNEL_STABLE)


class _Pending:
    """One queued request: input rows + the future its caller blocks on."""

    __slots__ = ("rows", "future", "enqueued_at")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.future: "futures.Future" = futures.Future()
        self.enqueued_at = time.perf_counter()


class MicroBatcher:
    """Coalesce concurrent requests into padded fixed-size forwards.

    ``run_batch(rows)`` is the model-executing callback: it receives the
    concatenated request rows (<= max_batch of them, unless one request is
    larger) and returns per-row outputs, optionally as ``(outputs, extra)``
    where ``extra`` rides to every request of the batch. One worker thread
    per batcher drains the queue."""

    def __init__(self, run_batch: Callable[[np.ndarray], Any],
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 name: str = "batcher"):
        self._run_batch = run_batch
        self.name = name
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._queue: List[_Pending] = []
        self._cv = threading.Condition(threading.Lock())
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"serving-{name}")
        self._worker.start()

    def submit(self, rows: np.ndarray) -> "futures.Future":
        rows = np.asarray(rows)
        if rows.ndim == 0:
            # reject on the caller's thread: a 0-d array has no len()
            raise ValueError("batcher input must be at least 1-d "
                             "(a batch of rows)")
        pending = _Pending(rows)
        with self._cv:
            if self._closed:
                pending.future.set_exception(
                    RuntimeError("batcher closed"))
                return pending.future
            self._queue.append(pending)
            _M_QUEUE_DEPTH.set(len(self._queue), channel=self.name)
            self._cv.notify()
        return pending.future

    def depth(self) -> int:
        """Requests currently queued."""
        with self._cv:
            return len(self._queue)

    def _gather(self) -> List[_Pending]:
        """Wait for work, then coalesce until the bucket is full or the
        wait window (from the FIRST request) expires."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(0.1)
            if self._closed and not self._queue:
                return []
            deadline = self._queue[0].enqueued_at + self.max_wait_s
            while (sum(len(p.rows) for p in self._queue) < self.max_batch
                   and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch: List[_Pending] = []
            rows = 0
            while self._queue and (not batch
                                   or rows + len(self._queue[0].rows)
                                   <= self.max_batch):
                item = self._queue.pop(0)
                rows += len(item.rows)
                batch.append(item)
            _M_QUEUE_DEPTH.set(len(self._queue), channel=self.name)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if not batch:
                with self._cv:
                    if self._closed and not self._queue:
                        return
                continue
            try:
                self._execute(batch)
            except Exception as exc:  # noqa: BLE001 - worker must survive
                # one poisoned batch fails ITS requests only: a dead worker
                # would hang every later request on this channel
                logger.exception("micro-batch execution failed")
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _execute(self, batch: List[_Pending]) -> None:
        try:
            rows = np.concatenate([p.rows for p in batch], axis=0)
            _M_BATCH_ROWS.observe(len(rows))
            outs = self._run_batch(rows)
        except Exception as exc:  # noqa: BLE001 - surfaced per request
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        # (outs, extra): extra (the version the forward captured) rides to
        # every request, so replies report the TRUE served version even when
        # a hot-swap lands between enqueue and execution
        extra = None
        if isinstance(outs, tuple):
            outs, extra = outs
        offset = 0
        for p in batch:
            n = len(p.rows)
            sliced = np.asarray(outs[offset:offset + n])
            p.future.set_result(sliced if extra is None
                                else (sliced, extra))
            offset += n

    def close(self) -> None:
        """Drain: queued requests still execute, then the worker exits."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=30.0)
        # a closed channel's depth series must not linger at its last value
        _M_QUEUE_DEPTH.remove(channel=self.name)


# --------------------------------------------------------------------- #
# registry sources (where the gateway learns of promoted versions)
# --------------------------------------------------------------------- #

class DirectRegistrySource:
    """In-process source: reads a live controller."""

    def __init__(self, controller):
        self._controller = controller

    def describe(self) -> Dict[str, Any]:
        return self._controller.describe_registry()

    def blob(self, version: int) -> Optional[bytes]:
        return self._controller.registered_model(version)


class ControllerRegistrySource:
    """RPC source: polls the controller's ``DescribeRegistry`` and
    ``GetRegisteredModel`` (fail-fast, as the driver's polls are)."""

    def __init__(self, client):
        self._client = client

    def describe(self) -> Dict[str, Any]:
        return self._client.describe_registry(timeout=15.0,
                                              wait_ready=False)

    def blob(self, version: int) -> Optional[bytes]:
        return self._client.get_registered_model(version=version,
                                                 timeout=60.0)


class ServingGateway:
    """Serve inference over registry channels. ``model_ops`` (a
    ``TorchModelOps``) supplies the architecture and the forward;
    ``config`` is a :class:`metisfl_tpu_torch.config.ServingConfig`.
    ``device`` (default ``"cuda"``, which raises without a GPU) must be the
    engine's device."""

    def __init__(self, model_ops, config, ship_tensor_regex: str = "",
                 device="cuda"):
        self.device = resolve_device(device)
        if model_ops.device != self.device:
            raise ValueError(f"model_ops runs on {model_ops.device}, the "
                             f"gateway on {self.device}")
        self.model_ops = model_ops
        self.config = config
        self._ship_regex = ship_tensor_regex
        self._lock = threading.Lock()
        # channel -> (version id, bound model)
        self._models: Dict[str, Tuple[int, Any]] = {}
        self._base_named = pytree_to_named_tensors(model_ops.get_variables())
        self._batchers: Dict[str, MicroBatcher] = {}
        # continuous-batching decode engines, one per channel, created on
        # the first Generate for that channel
        self._decoders: Dict[str, ContinuousBatcher] = {}
        self._requests = 0
        self._shut_down = False
        self._started_at = time.time()
        # the registry poller (start_sync)
        self._sync_stop = threading.Event()
        self._sync_thread: Optional[threading.Thread] = None
        self._last_sync_error = ""

    # -- model install / hot-swap ------------------------------------- #

    def _load_model(self, blob_bytes: bytes):
        """Community blob → a device copy of the module holding it. Under
        ship_tensor_regex the blob carries only the federated subset:
        backfill the frozen base from the engine's construction-time
        weights."""
        named = list(ModelBlob.from_bytes(blob_bytes).tensors)
        if self._ship_regex:
            have = {n for n, _ in named}
            named.extend((n, t) for n, t in self._base_named
                         if n not in have
                         and not re.search(self._ship_regex, n))
        return self.model_ops.bind(named)

    def install(self, channel: str, version: int, blob: bytes) -> None:
        """Atomically hot-swap ``channel`` to ``version``. Decoding and the
        device upload happen OUTSIDE the lock; in-flight batches keep the
        pair they already captured, so zero requests drop across the
        swap."""
        model = self._load_model(blob)
        with self._lock:
            previous = self._models.get(channel, (0, None))[0]
            self._models[channel] = (int(version), model)
            decoder = self._decoders.get(channel)
        if decoder is not None:
            # in-flight generations finish on the pair they captured,
            # queued ones drain onto this one (serving/decode.py)
            decoder.swap(int(version), model)
        _M_VERSION.set(int(version), channel=channel)
        if previous != version:
            _M_SWAPS.inc(channel=channel)
            _tevents.emit(_tevents.ServingSwapped, channel=channel,
                          version=int(version), previous=previous)
            logger.info("serving %s hot-swapped to v%d (was v%d)",
                        channel, version, previous)

    def uninstall(self, channel: str) -> None:
        with self._lock:
            gone = self._models.pop(channel, None)
            decoder = self._decoders.pop(channel, None)
        if decoder is not None:
            # drain: queued/in-flight generations on the departing
            # channel still finish on their captured pair
            decoder.close()
        if gone is not None:
            _M_VERSION.remove(channel=channel)
            logger.info("serving %s uninstalled (was v%d)", channel,
                        gone[0])

    def installed(self) -> Dict[str, int]:
        with self._lock:
            return {ch: v for ch, (v, _) in self._models.items()}

    # -- registry sync ------------------------------------------------- #

    def sync(self, source) -> Dict[str, int]:
        """One poll: compare channel heads against the registry source
        (anything with ``describe()`` and ``blob(version)``) and hot-swap
        any channel whose head changed. Returns the installed map."""
        desc = source.describe()
        if not desc.get("enabled", False):
            return self.installed()
        current = self.installed()
        for channel in (CHANNEL_STABLE, CHANNEL_CANDIDATE):
            head = int(desc.get(channel, 0) or 0)
            if not head:
                if channel == CHANNEL_CANDIDATE and channel in current:
                    # promoted or superseded away: stop canarying it
                    self.uninstall(channel)
                continue
            if current.get(channel) == head:
                continue
            blob = source.blob(head)
            if blob:
                self.install(channel, head, blob)
        return self.installed()

    def start_sync(self, source, poll_every_s: Optional[float] = None,
                   initial_delay_s: float = 0.0) -> None:
        """Poll ``source`` on a background thread (a gateway process's main
        loop) every ``poll_every_s`` (default the config's), the first poll
        after ``initial_delay_s``. A failed poll is logged and retried at
        the next tick; :meth:`shutdown` stops the thread."""
        period = (self.config.poll_every_s if poll_every_s is None
                  else poll_every_s)

        def _loop():
            if initial_delay_s > 0.0:
                self._sync_stop.wait(initial_delay_s)
            while not self._sync_stop.is_set():
                try:
                    self.sync(source)
                    self._last_sync_error = ""
                except Exception as exc:  # noqa: BLE001 - keep polling
                    self._last_sync_error = str(exc)
                    logger.warning("registry sync failed: %s", exc)
                self._sync_stop.wait(max(0.05, period))

        self._sync_thread = threading.Thread(target=_loop, daemon=True,
                                             name="serving-sync")
        self._sync_thread.start()

    # -- request path --------------------------------------------------- #

    def _batcher_for(self, channel: str) -> MicroBatcher:
        with self._lock:
            if self._shut_down:
                # a Predict racing shutdown must not resurrect a worker
                raise RuntimeError("serving gateway is shut down")
            batcher = self._batchers.get(channel)
            if batcher is None:
                batcher = MicroBatcher(
                    lambda rows, ch=channel: self._forward(ch, rows),
                    max_batch=self.config.max_batch,
                    max_wait_ms=self.config.max_wait_ms,
                    name=channel)
                self._batchers[channel] = batcher
            return batcher

    def _forward(self, channel: str,
                 rows: np.ndarray) -> Tuple[np.ndarray, Tuple[int, str]]:
        """One padded fixed-shape forward per ``max_batch`` chunk. The
        (version, model) pair is captured once per call, and the captured
        (version, channel) rides back so replies report what ACTUALLY
        served them, fallback included."""
        with self._lock:
            entry = self._models.get(channel)
            if entry is None and channel == CHANNEL_CANDIDATE:
                # the candidate was uninstalled between routing and
                # execution: degrade the queued canary batch to stable
                channel = CHANNEL_STABLE
                entry = self._models.get(channel)
        if entry is None:
            raise RuntimeError(f"no model installed on channel {channel!r}")
        version, model = entry
        bucket = self.config.max_batch
        outs = []
        for start in range(0, len(rows), bucket):
            chunk = rows[start:start + bucket]
            pad = bucket - len(chunk)
            if pad > 0:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
            full = self.model_ops.infer(chunk, batch_size=bucket,
                                        model=model)
            outs.append(full[:bucket - pad])
        return np.concatenate(outs, axis=0), (version, channel)

    def _route(self, key: str) -> str:
        channel = canary_channel(key or "", self.config.canary_percent)
        with self._lock:
            if channel not in self._models:
                # canary slice with no candidate installed: serve stable
                channel = CHANNEL_STABLE
            if channel not in self._models:
                raise RuntimeError("no model installed (registry has no "
                                   "stable version yet)")
        return channel

    def predict(self, x: np.ndarray, key: str = "",
                timeout_s: float = 60.0) -> Tuple[np.ndarray, int, str]:
        """Route, micro-batch, and run one request. Returns
        ``(outputs, served version, channel)``."""
        t0 = time.perf_counter()
        channel = self._route(key)
        # the batcher runs on its own thread: the span brackets submit to
        # result on this one, the request's true wait
        with _ttrace.span("serving.predict", attrs={"channel": channel}):
            outs, (version, served_channel) = self._batcher_for(
                channel).submit(np.asarray(x)).result(timeout=timeout_s)
        with self._lock:
            self._requests += 1
        # labelled by what served it (a canary degraded to stable)
        _M_REQUESTS.inc(channel=served_channel)
        _M_LATENCY.observe(time.perf_counter() - t0)
        return outs, version, served_channel

    def _decoder_for(self, channel: str) -> ContinuousBatcher:
        """The channel's continuous-batching decode engine, created on
        first use from the channel's installed (version, model) pair."""
        with self._lock:
            if self._shut_down:
                raise RuntimeError("serving gateway is shut down")
            decoder = self._decoders.get(channel)
            if decoder is None:
                entry = self._models.get(channel)
                if entry is None:
                    raise RuntimeError(
                        f"no model installed on channel {channel!r}")
                version, model = entry
                decode_cfg = self.config.decode
                decoder = ContinuousBatcher(
                    self.model_ops, version, model,
                    slots=decode_cfg.slots, max_len=decode_cfg.max_len,
                    channel=channel)
                self._decoders[channel] = decoder
            return decoder

    def generate(self, prompt, max_new_tokens: int, key: str = "",
                 eos_id: Optional[int] = None,
                 timeout_s: float = 120.0) -> Tuple[np.ndarray, int, str]:
        """Route one generation request through the continuous-batching
        decode loop. Returns ``(tokens, served version, channel)``: tokens
        are the (max_new_tokens,) greedy continuation, pad after eos."""
        t0 = time.perf_counter()
        channel = self._route(key)
        # activated: the decode loop retires slots on its own thread, so
        # the decoder's submit captures this context for its slot span
        gen_sp = _ttrace.span("serving.generate", attrs={"channel": channel})
        with gen_sp, gen_sp.activate():
            try:
                tokens, version = self._decoder_for(channel).submit(
                    prompt, max_new_tokens, eos_id=eos_id).result(
                        timeout=timeout_s)
            except RuntimeError:
                # the candidate was uninstalled between routing and
                # decode: degrade the canary request to stable,
                # predict()'s rule
                if channel != CHANNEL_CANDIDATE:
                    raise
                channel = self._route("")
                tokens, version = self._decoder_for(channel).submit(
                    prompt, max_new_tokens, eos_id=eos_id).result(
                        timeout=timeout_s)
        with self._lock:
            self._requests += 1
        _M_REQUESTS.inc(channel=channel)
        _M_LATENCY.observe(time.perf_counter() - t0)
        return tokens, version, channel

    # -- status --------------------------------------------------------- #

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            installed = {ch: v for ch, (v, _) in self._models.items()}
            requests = self._requests
            decoders = dict(self._decoders)
        out = {
            "installed": installed,
            "canary_percent": float(self.config.canary_percent),
            "max_batch": int(self.config.max_batch),
            "max_wait_ms": float(self.config.max_wait_ms),
            "requests": requests,
            "uptime_s": round(time.time() - self._started_at, 3),
            "device": str(self.device),
        }
        if decoders:
            out["decode"] = {ch: d.describe() for ch, d in decoders.items()}
        return out

    def queue_snapshot(self) -> Dict[str, Any]:
        """Micro-batch queue occupancy (per channel + total)."""
        with self._lock:
            batchers = dict(self._batchers)
            decoders = dict(self._decoders)
        depths = {ch: b.depth() for ch, b in batchers.items()}
        out = {"queue_depth": sum(depths.values()),
               "queue_depth_by_channel": depths,
               "max_batch": int(self.config.max_batch)}
        if decoders:
            out["decode_queue_depth"] = sum(d.depth()
                                            for d in decoders.values())
            out["decode_active_slots"] = sum(d.active()
                                             for d in decoders.values())
        return out

    def shutdown(self) -> None:
        self._sync_stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=10.0)
        with self._lock:
            self._shut_down = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
            decoders = list(self._decoders.values())
            self._decoders.clear()
        for batcher in batchers:
            batcher.close()
        for decoder in decoders:
            decoder.close()
