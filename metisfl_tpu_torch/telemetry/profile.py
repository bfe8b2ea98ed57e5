"""Performance observatory: per-round cost profiles + device utilization
(the port's copy of the JAX package's ``telemetry/profile.py``: the same
``RoundProfile`` schema and metric families; the device side reads
``torch.cuda`` and captures with ``torch.profiler``; the per-round
folded-stack delta and the critical path are not ported yet, ROADMAP.md
Queue 1 item 4b, and stay empty).

The other planes explain the federation's *behavior* (spans, metrics,
events, learning health, lifecycle); this plane explains its *cost* —
where each round's time and bytes go, attributed per phase and per
learner, so every remaining ROADMAP item (ingest parallelization, MFU
tuning, fleet autoscaling) is measured through one instrument panel:

- :class:`ProfileCollector` — controller-side assembler: folds the
  round's span-sourced phase durations, per-learner uplink/downlink wire
  bytes, codec encode/decode attribution (:mod:`metisfl_tpu_torch.comm.codec`),
  store insert/select time, and the learner-shipped device stats into a
  typed :class:`RoundProfile`, persisted into ``RoundMetadata.profile``
  (→ ``experiment.json``) and a JSONL sink next to the trace files
  (``<dir>/profiles-<pid>.jsonl``). A bounded tail rides in post-mortem
  bundles and ``DescribeFederation`` snapshots.
- :class:`DeviceMonitor` — learner-side utilization capture per train
  task: step-time EWMA, achieved-MFU estimate (model-ops FLOPs estimate
  over the card's dense bf16 peak), and the device-memory high-water mark
  from ``torch.cuda.max_memory_allocated`` — shipped back in
  ``TaskResult.device_stats`` so the controller profile is
  federation-wide.
- :func:`device_tracer` — the one reusable ``torch.profiler`` capture
  handle (CUDA activity, exception-safe stop, unique per-session
  capture dirs holding a Chrome trace ``trace.json``) that
  ``models/ops.py`` drives; ``telemetry.profile.trace_every_rounds`` arms
  it periodically via the dispatched ``TrainParams.profile_dir``.

Opt-out: ``telemetry.profile.enabled=false`` leaves every hot path at
one attribute check (no collector constructed, no device stats shipped).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger("metisfl_tpu_torch.telemetry")

SCHEMA_VERSION = 1

# Round phases whose durations compose the waterfall. store_insert
# overlaps wait_uplinks (inserts happen while the barrier is open), so it
# rides in the store section instead of the coverage sum. When the
# controller recorded all four phase-boundary timestamps (note_mark),
# the waterfall is computed as CONTIGUOUS segments between them — it
# tiles the round wall-clock exactly, instead of summing independent
# span durations whose inter-span gaps leak coverage on short rounds.
PHASES = ("dispatch", "wait_uplinks", "select", "aggregate", "close")

# boundary marks, in waterfall order (each ends the named phase)
_MARKS = ("dispatch_end", "wait_end", "select_end", "aggregate_end")

_REG = _tmetrics.registry()
_M_DOWNLINK = _REG.counter(
    _tel.M_DOWNLINK_BYTES_TOTAL,
    "Community-model bytes dispatched to each learner (train + eval "
    "downlink payloads)", ("learner",), budget_label="learner")
_M_MFU = _REG.gauge(
    _tel.M_LEARNER_ACHIEVED_MFU,
    "Achieved model FLOPs utilization per learner (estimated step FLOPs "
    "over the chip's bf16 peak; 0 where the peak is unknown, e.g. CPU)",
    ("learner",), budget_label="learner")
_M_STEP_EWMA = _REG.gauge(
    _tel.M_LEARNER_STEP_MS_EWMA,
    "EWMA steady-state optimizer-step time per learner (ms, from "
    "TaskResult.device_stats)", ("learner",), budget_label="learner")
_M_HBM = _REG.gauge(
    _tel.M_LEARNER_HBM_PEAK_BYTES,
    "Device-memory high-water mark per learner "
    "(device.memory_stats peak_bytes_in_use; 0 where unsupported)",
    ("learner",), budget_label="learner")

# dense bf16 peak FLOP/s per card by device-name substring (first match
# wins) — the MFU denominator. The H100 SXM's 989 TFLOP/s (the JAX
# package's table lists TPUs only, which would read 0 on the card).
CHIP_PEAKS = [
    ("h100", 989e12),
]


def device_peak_flops(device_kind: str) -> float:
    """Dense bf16 peak FLOP/s for a ``torch.cuda.get_device_name`` string
    (0.0 = unknown)."""
    kind = (device_kind or "").lower()
    for key, peak in CHIP_PEAKS:
        if key in kind:
            return peak
    return 0.0


# --------------------------------------------------------------------- #
# reusable torch.profiler capture handle (models/ops.py drives this)
# --------------------------------------------------------------------- #

_TRACE_SEQ_LOCK = threading.Lock()
_TRACE_SEQ = 0


def _unique_session_dir(base_dir: str) -> str:
    """A capture dir no concurrent learner/process/call can collide with:
    session dirs are timestamped at second granularity, so same-host
    learners starting traces within the same second would
    otherwise clobber each other (learner/learner.py namespaces per
    learner id on top of this)."""
    global _TRACE_SEQ
    with _TRACE_SEQ_LOCK:
        _TRACE_SEQ += 1
        seq = _TRACE_SEQ
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(base_dir, f"{stamp}-{os.getpid()}-{seq:03d}")


class DeviceTracer:
    """One ``torch.profiler`` capture lifecycle: ``start()`` opens a
    capture of the card's (CUDA) activity, or of the host's where there is
    no card, into a unique session dir under ``base_dir`` (at most one
    capture per handle), ``stop()`` is idempotent and exception-safe and writes the
    session's Chrome trace, ``<session>/trace.json`` — a train loop can
    call it from a ``finally`` without tracking which of its start sites
    fired. A handle with no ``base_dir`` is inert."""

    def __init__(self, base_dir: str = ""):
        self.base_dir = base_dir
        self.active = False
        self.captured = False
        self.session_dir = ""
        self._prof = None

    def start(self) -> bool:
        """Open the capture (False when inert, already active, or already
        captured once — one trace per handle, matching the one-capture
        contract of TrainParams.profile_dir)."""
        if not self.base_dir or self.active or self.captured:
            return False
        session = _unique_session_dir(self.base_dir)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            # the card's activity where there is one (its kernels, copies
            # and runtime calls; recording every host op too costs the
            # step more), the host's otherwise
            activities = ([ProfilerActivity.CUDA]
                          if torch.cuda.is_available()
                          else [ProfilerActivity.CPU])
            os.makedirs(session, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception:  # noqa: BLE001 - profiling must never fail a task
            logger.exception("torch.profiler capture start failed")
            return False
        self._prof = prof
        self.session_dir = session
        self.active = True
        self.captured = True
        return True

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        prof, self._prof = self._prof, None
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(self.session_dir, "trace.json"))
        except Exception:  # noqa: BLE001 - stop is best-effort by contract
            logger.exception("torch.profiler capture stop failed")


def device_tracer(base_dir: str = "") -> DeviceTracer:
    """A trace handle for one train task ('' → inert handle)."""
    return DeviceTracer(base_dir)


# --------------------------------------------------------------------- #
# learner-side device utilization
# --------------------------------------------------------------------- #

class DeviceMonitor:
    """Per-learner device-utilization capture across train tasks:
    step-time EWMA (same alpha posture as the straggler analytics),
    achieved-MFU estimate, and the HBM high-water mark. ``observe``
    returns the stats dict that ships in ``TaskResult.device_stats``;
    everything device-specific is guarded — on CPU (or a backend without
    memory_stats) the fields degrade to 0 instead of raising."""

    def __init__(self, alpha: float = 0.3, device: Any = None):
        self.alpha = alpha
        self.step_ms_ewma = 0.0
        self._peak_flops: Optional[float] = None
        self._device_kind = ""
        # the engine's device: a CUDA device reads the card, anything
        # else (the CPU) degrades to ""/0
        self.device = device

    def _cuda_device(self):
        try:
            import torch

            dev = torch.device(self.device if self.device is not None
                               else "cpu")
            if dev.type != "cuda" or not torch.cuda.is_available():
                return None
            return dev
        except Exception:  # noqa: BLE001 - no backend is a valid state
            return None

    def _resolve_device(self) -> None:
        if self._peak_flops is not None:
            return
        dev = self._cuda_device()
        if dev is not None:
            try:
                import torch

                self._device_kind = torch.cuda.get_device_name(dev) or ""
            except Exception:  # noqa: BLE001 - no backend is a valid state
                self._device_kind = ""
        self._peak_flops = device_peak_flops(self._device_kind)

    def _hbm_peak_bytes(self) -> int:
        dev = self._cuda_device()
        if dev is None:
            return 0
        try:
            import torch

            return int(torch.cuda.max_memory_allocated(dev))
        except Exception:  # noqa: BLE001 - unsupported backends return 0
            return 0

    def observe(self, steps: int, ms_per_step: float,
                flops_per_step: float = 0.0) -> Dict[str, Any]:
        self._resolve_device()
        if ms_per_step > 0.0:
            if self.step_ms_ewma <= 0.0:
                self.step_ms_ewma = ms_per_step
            else:
                self.step_ms_ewma = (self.alpha * ms_per_step
                                     + (1.0 - self.alpha) * self.step_ms_ewma)
        mfu = 0.0
        if (self._peak_flops and flops_per_step > 0.0 and ms_per_step > 0.0):
            mfu = flops_per_step / (ms_per_step / 1e3) / self._peak_flops
        return {
            "steps": int(steps),
            "ms_per_step": round(float(ms_per_step), 4),
            "step_ms_ewma": round(self.step_ms_ewma, 4),
            "flops_per_step": float(flops_per_step),
            "mfu": round(float(mfu), 5),
            "hbm_peak_bytes": self._hbm_peak_bytes(),
            "device_kind": self._device_kind,
        }


# --------------------------------------------------------------------- #
# controller-side round profiles
# --------------------------------------------------------------------- #

@dataclass
class RoundProfile:
    """Typed per-round cost profile — the driver-collects-statistics role
    (PAPER.md §driver) extended from aggregate metadata to an
    attribution: where this round's wall-clock and wire bytes went."""

    round: int = 0
    wall_ms: float = 0.0
    # phase → milliseconds (PHASES above); coverage = sum/wall
    phases: Dict[str, float] = field(default_factory=dict)
    coverage: float = 0.0
    aggregation_ms: float = 0.0
    # store-layer time: per-model insert (overlaps wait_uplinks) and the
    # aggregation path's lineage selects
    store: Dict[str, float] = field(default_factory=dict)
    # overlay timings recorded via note_phase that OVERLAP the tiled
    # waterfall rather than extending it (stream_fold inside
    # wait_uplinks, ingest_drain/select inside aggregate) — kept out of
    # ``phases`` so its coverage invariant holds
    extras: Dict[str, float] = field(default_factory=dict)
    # learner → {uplink_bytes, downlink_bytes, codec_encode_s,
    #            codec_decode_s, insert_ms, device{...}}
    learners: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    totals: Dict[str, float] = field(default_factory=dict)
    serving: Dict[str, Any] = field(default_factory=dict)
    # per-round folded-stack delta from the continuous profiler (the
    # JAX package's telemetry/prof.py; not ported yet, always empty)
    prof: Dict[str, Any] = field(default_factory=dict)
    # controller-local causal critical path (the JAX package's
    # telemetry/causal.py; not ported yet, always empty)
    critical_path: Dict[str, Any] = field(default_factory=dict)
    # torch.profiler capture armed for this round (trace_every_rounds)
    trace_armed: bool = False
    schema: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self)


class ProfileCollector:
    """Controller-side cost accounting for the in-flight round. All note
    hooks are one call deep and cheap; the collector is only constructed
    when ``telemetry.profile.enabled`` — the disabled hot path in the
    controller is one attribute check (the health-monitor posture)."""

    def __init__(self, config: Any = None, telemetry_dir: str = "",
                 service: str = "controller"):
        self.trace_every_rounds = int(
            getattr(config, "trace_every_rounds", 0) or 0)
        self.dir = (getattr(config, "dir", "") or telemetry_dir or "")
        self.service = service
        self._lock = threading.Lock()
        # sink writes serialize on their own lock: persist() runs at
        # round close concurrently with note_* hooks called under the
        # controller lock, and disk I/O must not stall those
        self._sink_lock = threading.Lock()
        self._path = ""
        self._fh = None
        if self.dir:
            try:
                os.makedirs(self.dir, exist_ok=True)
                self._path = os.path.join(
                    self.dir, f"profiles-{os.getpid()}.jsonl")
            except OSError as exc:
                logger.warning("profile sink dir %r not creatable (%s); "
                               "round profiles will not be persisted",
                               self.dir, exc)
        # per-round accumulators (reset by assemble_round)
        self._downlink: Dict[str, int] = {}
        self._select_ms = 0.0
        self._insert_ms: Dict[str, float] = {}
        self._phase_extra: Dict[str, float] = {}
        # phase-boundary timestamps (epoch seconds, _MARKS order) — the
        # tiled-waterfall inputs; reset with the other accumulators
        self._marks: Dict[str, float] = {}
        # latest device stats per learner (persists across rounds — a
        # learner not sampled this round keeps its last observation)
        self._device: Dict[str, Dict[str, Any]] = {}
        # cumulative codec-attribution snapshot at the last round close
        # (comm/codec.py keeps the process totals; per-round = delta)
        self._codec_snapshot: Dict[Any, float] = {}
        # bounded recent-profile tail (post-mortem bundles, describe())
        self._tail: List[dict] = []
        self._tail_limit = 16
        # optional serving-occupancy probe (in-process gateway / tests):
        # a zero-arg callable returning a small dict snapshot
        self.serving_probe: Optional[Callable[[], Dict[str, Any]]] = None

    # -- trace arming ------------------------------------------------------
    def trace_target(self, round_no: int) -> str:
        """The torch.profiler capture dir to dispatch for this round (''
        when not due). Periodic: every ``trace_every_rounds`` rounds,
        rooted under the profile sink dir."""
        if (self.trace_every_rounds <= 0 or not self.dir
                or round_no % self.trace_every_rounds != 0):
            return ""
        return os.path.join(self.dir, "jaxprof", f"round{round_no}")

    # -- note hooks (scheduling executor / RPC threads) --------------------
    def note_downlink(self, learner_id: str, nbytes: int) -> None:
        with self._lock:
            self._downlink[learner_id] = (
                self._downlink.get(learner_id, 0) + int(nbytes))
        _M_DOWNLINK.inc(nbytes, learner=learner_id)

    def note_device(self, learner_id: str, stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict) or not stats:
            return
        with self._lock:
            self._device[learner_id] = dict(stats)
        try:
            _M_STEP_EWMA.set(float(stats.get("step_ms_ewma", 0.0) or 0.0),
                             learner=learner_id)
            _M_MFU.set(float(stats.get("mfu", 0.0) or 0.0),
                       learner=learner_id)
            _M_HBM.set(float(stats.get("hbm_peak_bytes", 0) or 0),
                       learner=learner_id)
        except (TypeError, ValueError):
            # learner-shipped dicts are never validated on the wire — a
            # garbage value must not take the completion path down
            logger.warning("unusable device stats from %s: %r",
                           learner_id, stats)

    def note_store_select(self, ms: float) -> None:
        with self._lock:
            self._select_ms += float(ms)

    def note_store_insert(self, learner_id: str, ms: float) -> None:
        with self._lock:
            self._insert_ms[learner_id] = (
                self._insert_ms.get(learner_id, 0.0) + float(ms))

    def note_phase(self, phase: str, ms: float) -> None:
        with self._lock:
            self._phase_extra[phase] = (
                self._phase_extra.get(phase, 0.0) + float(ms))

    def note_mark(self, name: str, first: bool = False) -> None:
        """Record a phase-boundary timestamp for the in-flight round.
        ``first=True`` keeps the earliest recording (a mid-round rejoin
        re-dispatch must not move ``dispatch_end`` into the wait window);
        otherwise the latest wins (an aggregation-failure retry moves the
        later boundaries forward with it, so the waterfall keeps
        tiling)."""
        now = time.time()
        with self._lock:
            if first and name in self._marks:
                return
            self._marks[name] = now

    def drop(self, learner_id: str) -> None:
        """Prune the collector's per-learner state for a learner that
        left. The downlink/MFU/step/HBM *series* themselves are pruned
        by the central ``telemetry.prune_learner`` registry helper
        (they carry the "learner" cardinality label) — this drops only
        the collector-internal attribution behind them."""
        with self._lock:
            self._downlink.pop(learner_id, None)
            self._insert_ms.pop(learner_id, None)
            self._device.pop(learner_id, None)
            # the codec process totals are pruned by
            # prune_attribution_series; without dropping the matching
            # snapshot keys too, a leave→rejoin between round closes
            # would diff a fresh (small) total against the stale (large)
            # snapshot and record a negative per-round cost
            for key in [k for k in self._codec_snapshot
                        if k[0] == learner_id]:
                del self._codec_snapshot[key]
        # NOT calling prune_attribution_series here: the central
        # telemetry.prune_learner already does, strictly before the
        # controller calls this (one prune per departure, not two)

    # -- round assembly ----------------------------------------------------
    def assemble_round(self, meta: Any, close_ms: float = 0.0) -> dict:
        """Fold the finished round's metadata + accumulators into a
        RoundProfile dict and reset the per-round state. Cheap (dict
        building only) — the controller calls it under its lock, then
        :meth:`persist` outside it."""
        try:
            codec_totals = self._codec_totals()
        except Exception:  # noqa: BLE001 - attribution is best-effort
            codec_totals = {}
        with self._lock:
            downlink, self._downlink = self._downlink, {}
            insert_ms, self._insert_ms = self._insert_ms, {}
            select_ms, self._select_ms = self._select_ms, 0.0
            extra, self._phase_extra = self._phase_extra, {}
            marks, self._marks = self._marks, {}
            device = {lid: dict(s) for lid, s in self._device.items()}
            codec_round = {
                key: total - self._codec_snapshot.get(key, 0.0)
                for key, total in codec_totals.items()}
            self._codec_snapshot = codec_totals

        started = float(getattr(meta, "started_at", 0.0))
        completed = float(getattr(meta, "completed_at", 0.0))
        wall_ms = 1e3 * max(0.0, completed - started)
        if wall_ms > 0 and all(m in marks for m in _MARKS):
            # tiled waterfall: contiguous segments between the recorded
            # boundaries (clamped into [started, completed] and kept
            # monotonic) — sums to the wall-clock by construction
            seq = [started]
            for name in _MARKS:
                seq.append(min(completed, max(seq[-1], marks[name])))
            seq.append(completed)
            phases = {phase: (seq[i + 1] - seq[i]) * 1e3
                      for i, phase in enumerate(PHASES)}
        else:
            # fallback (resumed/partial rounds): the independent span
            # durations — honest, but inter-span gaps leak coverage
            phases = {
                "dispatch": float(getattr(meta, "dispatch_duration_ms",
                                          0.0)),
                "wait_uplinks": float(getattr(meta, "wait_duration_ms",
                                              0.0)),
                "select": float(extra.get("select", 0.0)),
                "aggregate": float(getattr(meta, "aggregation_duration_ms",
                                           0.0)),
                "close": float(close_ms),
            }
        phases = {k: round(v, 3) for k, v in phases.items()}
        attributed = sum(phases.values())
        uplink = dict(getattr(meta, "uplink_bytes", {}) or {})
        learners: Dict[str, Dict[str, Any]] = {}
        for lid in sorted(set(uplink) | set(downlink)):
            entry: Dict[str, Any] = {
                "uplink_bytes": int(uplink.get(lid, 0)),
                "downlink_bytes": int(downlink.get(lid, 0)),
            }
            if lid in insert_ms:
                entry["insert_ms"] = round(insert_ms[lid], 3)
            enc = codec_round.get((lid, "encode"), 0.0)
            dec = codec_round.get((lid, "decode"), 0.0)
            if enc or dec:
                entry["codec_encode_s"] = round(enc, 6)
                entry["codec_decode_s"] = round(dec, 6)
            if lid in device:
                entry["device"] = device[lid]
            learners[lid] = entry
        profile = RoundProfile(
            round=int(getattr(meta, "global_iteration", 0)),
            wall_ms=round(wall_ms, 3),
            phases=phases,
            coverage=round(min(1.0, attributed / wall_ms), 4)
            if wall_ms > 0 else 0.0,
            # span-measured aggregation compute time (the tiled phase
            # segment additionally carries the select→aggregate glue)
            aggregation_ms=round(float(getattr(
                meta, "aggregation_duration_ms", 0.0))
                or phases["aggregate"], 3),
            store={"insert_ms": round(sum(insert_ms.values()), 3),
                   "select_ms": round(select_ms, 3)},
            extras={k: round(v, 3) for k, v in sorted(extra.items())},
            learners=learners,
            totals={"uplink_bytes": float(sum(uplink.values())),
                    "downlink_bytes": float(sum(downlink.values()))},
            trace_armed=bool(self.trace_target(
                int(getattr(meta, "global_iteration", 0)))),
        )
        if self.serving_probe is not None:
            try:
                profile.serving = dict(self.serving_probe() or {})
            except Exception:  # noqa: BLE001 - a probe never fails a round
                logger.exception("serving occupancy probe failed")
        record = profile.to_dict()
        with self._lock:
            self._tail.append(record)
            del self._tail[:-self._tail_limit]
        return record

    @staticmethod
    def _codec_totals() -> Dict[Any, float]:
        from metisfl_tpu_torch.comm import codec as _codec

        return _codec.attributed_totals()

    def persist(self, record: dict) -> None:
        """Append one profile line to the JSONL sink (best-effort, same
        degradation contract as the trace sink)."""
        if not self._path:
            return
        line = json.dumps(record, default=str) + "\n"
        with self._sink_lock:
            if not self._path:
                return
            try:
                if self._fh is None:
                    self._fh = open(self._path, "a", buffering=1)
                self._fh.write(line)
            except OSError:
                self._path = ""
                self._fh = None

    def close(self) -> None:
        """Release the sink file handle (controller shutdown). Idempotent;
        a persist() after close simply reopens — correctness never depends
        on close being called."""
        with self._sink_lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def profiles_path(self) -> str:
        return self._path

    def tail(self, n: int = 3) -> List[dict]:
        with self._lock:
            return list(self._tail[-n:]) if n > 0 else []

    def summary(self) -> Dict[str, Any]:
        """Compact latest-round view for DescribeFederation / status."""
        with self._lock:
            last = dict(self._tail[-1]) if self._tail else {}
            rounds = len(self._tail)
        out: Dict[str, Any] = {
            "enabled": True,
            "trace_every_rounds": self.trace_every_rounds,
            "rounds_profiled": rounds,
        }
        if last:
            out.update({
                "last_round": last.get("round", 0),
                "wall_ms": last.get("wall_ms", 0.0),
                "coverage": last.get("coverage", 0.0),
                "phases": dict(last.get("phases", {})),
                "uplink_bytes": last.get("totals", {}).get(
                    "uplink_bytes", 0.0),
                "downlink_bytes": last.get("totals", {}).get(
                    "downlink_bytes", 0.0),
            })
        return out


def prune_attribution_series(learner_id: str) -> None:
    """Prune the codec-attribution and RPC peer-byte series for a
    departed learner. Module-level (not a collector method) so the
    controller can call it UNCONDITIONALLY on leave — attribution may
    have been minted while a collector was active (or by a direct
    caller) even if the profile plane is off now, and those series must
    not outlive the learner."""
    # lazy imports: codec/rpc import this package at module level
    try:
        from metisfl_tpu_torch.comm import codec as _codec

        _codec.prune_attribution(learner_id)
    except ImportError:  # pragma: no cover - comm always present
        pass
    try:
        from metisfl_tpu_torch.comm import rpc as _rpc

        _rpc.prune_peer_series(learner_id)
    except ImportError:  # pragma: no cover - optional grpc dependency
        pass


# --------------------------------------------------------------------- #
# process-level hooks (post-mortem bundles read the active collector)
# --------------------------------------------------------------------- #

_COLLECTOR: Optional[ProfileCollector] = None


def set_collector(collector: Optional[ProfileCollector]) -> None:
    """Register the process's active collector (the controller's); the
    flight recorder snapshots its tail into crash bundles."""
    global _COLLECTOR
    _COLLECTOR = collector


def collector() -> Optional[ProfileCollector]:
    return _COLLECTOR


def tail(n: int = 3) -> List[dict]:
    """The latest round profiles ([] when no collector is active)."""
    if _COLLECTOR is None:
        return []
    return _COLLECTOR.tail(n)
