"""Structured event journal: the federation's flight-data recorder.

Third telemetry layer next to spans (how long did it take) and metrics
(how much / how often): a typed, ordered record of *what the process was
doing* — learners joining, rounds starting, tasks dispatching, retries
scheduling, faults firing. Spans and metrics answer performance
questions after the fact; the journal answers "what was in flight when
it died" and feeds the live `DescribeFederation` snapshot.

Events are frozen dataclasses (one class per kind, typed fields), stamped
at emit time with a process-monotonic ``seq`` and a wall-clock ``ts``,
and kept in a bounded in-memory ring buffer. With a sink directory
configured, each event additionally appends one JSON line to
``<dir>/<service>-<pid>-events.jsonl`` (same per-process-file +
torn-sink-tolerant posture as :mod:`metisfl_tpu_torch.telemetry.trace`). The
ring tail is exported over ``DescribeFederation`` and into post-mortem
bundles (:mod:`metisfl_tpu_torch.telemetry.postmortem`).

Overhead contract: a disabled journal costs one attribute read per call
site — :func:`emit` returns before the event dataclass is even
constructed (federation config ``telemetry.events.enabled=false``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, ClassVar, Dict, List, Optional, Type

DEFAULT_RING_SIZE = 512


# --------------------------------------------------------------------- #
# event catalog (docs/OBSERVABILITY.md "Events, status, and post-mortems")
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class LearnerJoined:
    kind: ClassVar[str] = "learner_joined"
    learner_id: str
    hostname: str = ""
    port: int = 0
    rejoined: bool = False


@dataclass(frozen=True)
class LearnerLost:
    kind: ClassVar[str] = "learner_lost"
    learner_id: str
    reason: str = "leave"


@dataclass(frozen=True)
class RoundStarted:
    kind: ClassVar[str] = "round_started"
    round: int
    cohort: int = 0


@dataclass(frozen=True)
class TaskDispatched:
    kind: ClassVar[str] = "task_dispatched"
    task_id: str
    learner_id: str
    round: int = 0


@dataclass(frozen=True)
class TaskCompleted:
    kind: ClassVar[str] = "task_completed"
    task_id: str
    learner_id: str
    round: int = 0
    stale: bool = False
    uplink_bytes: int = 0


@dataclass(frozen=True)
class RetryScheduled:
    """A transparent RPC-client retry (UNAVAILABLE backoff, idempotent
    DEADLINE_EXCEEDED, or the unary-oversize → chunked fallback)."""

    kind: ClassVar[str] = "retry_scheduled"
    service: str
    method: str
    code: str = ""
    attempt: int = 0


@dataclass(frozen=True)
class FaultInjected:
    kind: ClassVar[str] = "fault_injected"
    fault: str
    side: str = ""
    method: str = ""


@dataclass(frozen=True)
class EpochChanged:
    """A learner observed a controller-incarnation change (crash+restart)."""

    kind: ClassVar[str] = "epoch_changed"
    learner_id: str
    old_epoch: str = ""
    new_epoch: str = ""
    reason: str = ""


@dataclass(frozen=True)
class AggregationDone:
    kind: ClassVar[str] = "aggregation_done"
    round: int
    selected: int = 0
    duration_ms: float = 0.0


@dataclass(frozen=True)
class FailoverBegan:
    """The driver began a supervised controller relaunch."""

    kind: ClassVar[str] = "failover_began"
    restart: int
    exit_code: Optional[int] = None


@dataclass(frozen=True)
class UpdateAnomalous:
    """A learner's update diverged from its cohort past the configured
    robust-z threshold (telemetry/health.py; ``raw`` is this round's
    z-score, ``score`` the EWMA divergence score after folding it)."""

    kind: ClassVar[str] = "update_anomalous"
    learner_id: str
    round: int = 0
    score: float = 0.0
    raw: float = 0.0
    update_norm: float = 0.0


@dataclass(frozen=True)
class RoundHealth:
    """Per-round learning-health snapshot (telemetry/health.py):
    community update norm, effective step size, participation entropy,
    and how many cohort updates scored anomalous."""

    kind: ClassVar[str] = "round_health"
    round: int
    update_norm: float = 0.0
    effective_step: float = 0.0
    participation_entropy: float = 0.0
    anomalous: int = 0


@dataclass(frozen=True)
class LearnerQuarantined:
    """A flapping learner's churn score crossed the quarantine threshold
    (selection.py ChurnTracker): excluded from cohort sampling until
    ``until_s`` seconds of quarantine elapse."""

    kind: ClassVar[str] = "learner_quarantined"
    learner_id: str
    score: float = 0.0
    until_s: float = 0.0


@dataclass(frozen=True)
class DispatchRetried:
    """A failed train dispatch was retried to a replacement learner
    (scheduling.dispatch_retries): the dead endpoint left the round
    barrier and ``replacement`` was dispatched in its place."""

    kind: ClassVar[str] = "dispatch_retried"
    learner_id: str
    replacement: str = ""
    attempt: int = 0


@dataclass(frozen=True)
class RoundHalted:
    """The controller stopped re-dispatching a round that can never
    complete (consecutive zero-reporter deadlines past
    scheduling.max_empty_redispatch, or the aggregation-failure limit)."""

    kind: ClassVar[str] = "round_halted"
    round: int
    reason: str = ""


@dataclass(frozen=True)
class VersionRegistered:
    """The model registry minted a candidate version from an aggregated
    round (registry/registry.py)."""

    kind: ClassVar[str] = "version_registered"
    version: int
    round: int = 0
    parent: int = 0
    channel: str = "candidate"


@dataclass(frozen=True)
class VersionPromoted:
    """A registry version moved channels (candidate → stable), through
    the promotion gate or an operator's PromoteVersion."""

    kind: ClassVar[str] = "version_promoted"
    version: int
    round: int = 0
    previous_stable: int = 0
    forced: bool = False


@dataclass(frozen=True)
class VersionRolledBack:
    """The stable channel was rolled back to the prior stable version."""

    kind: ClassVar[str] = "version_rolled_back"
    version: int
    rolled_back_from: int = 0


@dataclass(frozen=True)
class ServingSwapped:
    """The serving gateway hot-swapped a channel to a new version
    (serving/gateway.py) without dropping in-flight requests."""

    kind: ClassVar[str] = "serving_swapped"
    channel: str
    version: int
    previous: int = 0


@dataclass(frozen=True)
class AlertFiring:
    """An alert rule's expression breached its threshold and held past
    its ``for:`` duration (telemetry/alerts.py AlertEngine)."""

    kind: ClassVar[str] = "alert_firing"
    name: str
    expr: str = ""
    value: float = 0.0
    threshold: float = 0.0
    severity: str = "warning"


@dataclass(frozen=True)
class AlertResolved:
    """A firing alert's value crossed back past its resolve-hysteresis
    bound after ``active_s`` seconds."""

    kind: ClassVar[str] = "alert_resolved"
    name: str
    value: float = 0.0
    active_s: float = 0.0


@dataclass(frozen=True)
class FabricPeerStale:
    """The fleet collector's consecutive pulls from a telemetry peer
    failed past the staleness threshold (telemetry/fabric.py
    FleetCollector) — the peer stays in the fleet view, marked stale,
    and collection continues for everyone else."""

    kind: ClassVar[str] = "fabric_peer_stale"
    peer: str
    failures: int = 0


@dataclass(frozen=True)
class FabricPeerRecovered:
    """A stale telemetry peer answered a fleet pull again; its cursors
    resumed (or reset, when the peer restarted with a new epoch)."""

    kind: ClassVar[str] = "fabric_peer_recovered"
    peer: str
    stale_s: float = 0.0
    epoch_changed: bool = False


@dataclass(frozen=True)
class ServingReplicaDead:
    """The serving router declared a gateway replica dead (consecutive
    forward failures confirmed by a grpc.health.v1 probe, or the probe
    loop itself); its keyspace arcs fell to the next consistent-hash
    owners (serving/fleet.py)."""

    kind: ClassVar[str] = "serving_replica_dead"
    replica: str
    reason: str = ""
    failures: int = 0


@dataclass(frozen=True)
class ServingReplicaRecovered:
    """A dead or draining serving replica probed SERVING again and
    rejoined the router's hash ring."""

    kind: ClassVar[str] = "serving_replica_recovered"
    replica: str


@dataclass(frozen=True)
class ServingScaledUp:
    """The serving autoscaler booted a gateway replica (a ``serving_*``
    scale-up rule fired past its hold; driver/session.py). ``value`` is
    the rule's sampled value at the decision — the evidence trail next
    to the queue-occupancy profile."""

    kind: ClassVar[str] = "serving_scaled_up"
    replica: str
    replicas: int = 0
    rule: str = ""
    value: float = 0.0


@dataclass(frozen=True)
class ServingScaledDown:
    """The serving autoscaler drained a gateway replica back out of the
    fleet (scale-down rule fired, floor ``serving.fleet.min_replicas``
    respected)."""

    kind: ClassVar[str] = "serving_scaled_down"
    replica: str
    replicas: int = 0
    rule: str = ""
    value: float = 0.0


@dataclass(frozen=True)
class ControllerFailover:
    """The warm standby promoted itself to controller: the primary's WAL
    tail went stale, ``probe_failures`` consecutive grpc.health.v1
    probes confirmed it down, and the standby restored the replicated
    round state and started serving on its own pinned port
    (controller/__main__.py ``--standby``). Also emitted by the driver
    when it hands the federation's controller endpoint over to the
    promoted standby."""

    kind: ClassVar[str] = "controller_failover"
    role: str            # "standby" (promotion) | "driver" (handoff)
    host: str = ""
    port: int = 0
    round: int = 0
    learners: int = 0
    wal_records: int = 0
    promote_s: float = 0.0
    reason: str = ""


@dataclass(frozen=True)
class RecompileStorm:
    """One jitted function recompiled ``count`` times inside
    ``window_s`` seconds (telemetry/runtime.py): its abstract input
    signature keeps changing — unpadded shapes, an LRU bound too small
    for the live working set, or a Python-side cache miss — and every
    recompile stalls the caller for the full XLA compile. Muted per
    function for one window after firing."""

    kind: ClassVar[str] = "jax_recompile_storm"
    fn: str
    count: int = 0
    window_s: float = 0.0
    last_sig: str = ""


@dataclass(frozen=True)
class SliceAggregatorLost:
    """A slice aggregator process stopped answering (consecutive RPC
    failures confirmed by a grpc.health.v1 probe); its cohort slice is
    about to re-home (aggregation/distributed.py)."""

    kind: ClassVar[str] = "slice_aggregator_lost"
    slice: str
    failures: int = 0


@dataclass(frozen=True)
class SliceRehomed:
    """A dead slice aggregator's cohort slice re-homed mid-round: its
    spooled uplinks were recovered and its learners re-pointed at a
    surviving aggregator (``target=<slice>``) or folded directly at the
    root (``target="root"``) — the round completes without it."""

    kind: ClassVar[str] = "slice_rehomed"
    slice: str
    target: str
    round: int = 0
    recovered: int = 0
    lost: int = 0
    reason: str = ""


@dataclass(frozen=True)
class SecureSettlement:
    """The root settled a masked round (secure/recovery.py): the
    contributor set was reconciled against the dispatched mask-party
    cohort, dropout residuals (if any) were subtracted, and the sum
    decoded to the plain community payload. ``tier`` names which masked
    plane fed the root: ``stream`` (fold-on-arrival), ``slice``
    (distributed partial folds) or ``store`` (the in-process path)."""

    kind: ClassVar[str] = "secure_settlement"
    round: int
    contributors: int = 0
    dropped: int = 0
    recovered: bool = False
    tier: str = ""
    duration_ms: float = 0.0


@dataclass(frozen=True)
class SecureMasksRecovered:
    """A surviving learner disclosed the dropped parties' residual masks
    (seed-share disclosure through the quorum/deadline expiry path):
    ``survivor`` recomputed Σ±stream(i, d) for every dropped d so the
    partial sum unmasks to exactly the survivors' sum — the dropped
    payloads are settled OUT, never silently folded in."""

    kind: ClassVar[str] = "secure_masks_recovered"
    round: int
    survivor: str = ""
    surviving: int = 0
    dropped: int = 0


EVENT_TYPES: Dict[str, type] = {
    cls.kind: cls
    for cls in (LearnerJoined, LearnerLost, RoundStarted, TaskDispatched,
                TaskCompleted, RetryScheduled, FaultInjected, EpochChanged,
                AggregationDone, FailoverBegan, UpdateAnomalous,
                RoundHealth, LearnerQuarantined, DispatchRetried,
                RoundHalted, VersionRegistered, VersionPromoted,
                VersionRolledBack, ServingSwapped, AlertFiring,
                AlertResolved, FabricPeerStale, FabricPeerRecovered,
                SliceAggregatorLost, SliceRehomed, ServingReplicaDead,
                ServingReplicaRecovered, ServingScaledUp,
                ServingScaledDown, ControllerFailover, RecompileStorm,
                SecureSettlement, SecureMasksRecovered)
}


# --------------------------------------------------------------------- #
# journal
# --------------------------------------------------------------------- #

class Journal:
    """Bounded ring of event records + optional JSONL sink. A *record* is
    the emitted event's fields plus ``{seq, ts, kind}`` — plain dicts so
    the ring tail serializes straight into RPC snapshots and bundles."""

    def __init__(self):
        self.enabled = True
        self.service = ""
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=DEFAULT_RING_SIZE)
        self._seq = 0
        self._lock = threading.Lock()
        self._path = ""
        self._fh = None

    def configure(self, enabled: bool = True, service: str = "",
                  dir: str = "", ring_size: int = 0) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:  # pragma: no cover - close never critical
                    pass
                self._fh = None
            self.enabled = bool(enabled)
            self.service = service or self.service or "proc"
            if ring_size and ring_size != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=int(ring_size))
            self._path = ""
            if enabled and dir:
                try:
                    os.makedirs(dir, exist_ok=True)
                except OSError as exc:
                    import logging
                    logging.getLogger("metisfl_tpu_torch.telemetry").warning(
                        "event sink dir %r not creatable (%s); events stay "
                        "ring-only", dir, exc)
                    return
                self._path = os.path.join(
                    dir, f"{self.service}-{os.getpid()}-events.jsonl")

    def emit(self, event_cls: Type, **fields) -> Optional[dict]:
        """Construct + journal one event; returns the record, or None
        when the journal is disabled (the hot-path no-op)."""
        if not self.enabled:
            return None
        event = event_cls(**fields)  # typed validation at the call site
        record = {"kind": event.kind, "ts": round(time.time(), 6)}
        record.update(asdict(event))
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            self._ring.append(record)
            path = self._path
        if path:
            self._sink(record)
        return record

    def _sink(self, record: dict) -> None:
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    if not self._path:
                        return
                    self._fh = open(self._path, "a", buffering=1)
                self._fh.write(line)
            except OSError:
                # a torn sink (deleted dir, full disk) must never take an
                # instrumented code path down with it — stop persisting
                self._path = ""
                self._fh = None

    def set_ring_size(self, ring_size: int) -> None:
        """Resize the ring without touching the sink configuration (the
        in-process federation honors ``events.ring_size`` while leaving
        any host-configured sink alone)."""
        with self._lock:
            if ring_size and ring_size != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=int(ring_size))

    def tail(self, n: int = 0) -> List[dict]:
        """The last ``n`` records (0 = the whole ring), oldest first."""
        with self._lock:
            records = list(self._ring)
        return records[-n:] if n > 0 else records

    def tail_since(self, seq: int, limit: int = 0) -> List[dict]:
        """Records with ``seq > cursor`` (oldest first) — the fleet
        fabric's cursor pull (telemetry/fabric.py). A cursor older than
        the ring tail silently skips the evicted records; the JSONL sink
        keeps the full history."""
        with self._lock:
            records = [r for r in self._ring if r.get("seq", 0) > seq]
        return records[:limit] if limit > 0 else records

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def reset(self) -> None:
        """Drop the ring + seq counter (tests)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0


_JOURNAL = Journal()


def journal() -> Journal:
    return _JOURNAL


def configure(enabled: bool = True, service: str = "", dir: str = "",
              ring_size: int = 0) -> None:
    _JOURNAL.configure(enabled=enabled, service=service, dir=dir,
                       ring_size=ring_size)


def set_enabled(value: bool) -> None:
    _JOURNAL.enabled = bool(value)


def enabled() -> bool:
    return _JOURNAL.enabled


def emit(event_cls: Type, **fields) -> Optional[dict]:
    """Module-level emit: ``events.emit(events.RoundStarted, round=3)``.
    One attribute check when the journal is off."""
    if not _JOURNAL.enabled:
        return None
    return _JOURNAL.emit(event_cls, **fields)


def tail(n: int = 0) -> List[dict]:
    return _JOURNAL.tail(n)


def tail_since(seq: int, limit: int = 0) -> List[dict]:
    return _JOURNAL.tail_since(seq, limit=limit)


def flush() -> None:
    _JOURNAL.flush()


def event_path() -> str:
    """The JSONL file this process appends events to ('' = ring-only)."""
    return _JOURNAL._path


def format_record(record: Dict[str, Any], t0: Optional[float] = None) -> str:
    """One human line per record (status CLI + post-mortem viewer):
    ``+12.345s #17 task_dispatched learner_id=L0 task_id=ab12``."""
    ts = float(record.get("ts", 0.0))
    rel = f"+{ts - t0:8.3f}s" if t0 is not None else (
        time.strftime("%H:%M:%S", time.localtime(ts)))
    seq = record.get("seq", "?")
    kind = record.get("kind", "?")
    skip = {"ts", "seq", "kind"}
    fields = " ".join(f"{k}={v}" for k, v in record.items()
                      if k not in skip and v not in ("", None))
    return f"{rel}  #{seq:<5} {kind:<18} {fields}".rstrip()
