"""Federation and serving configuration: copies of the JAX package's
dataclasses (``config/federation.py``) with the fields the port reads.

``FederationConfig`` covers every protocol of the JAX package
(synchronous with quorum barriers and over-provisioned dispatch,
semi-synchronous, asynchronous and buffered asynchronous, with round
deadlines, dispatch retries, churn scoring with quarantine and staleness
damping), the chaos injector's rules, FedAvg and the JAX package's other
plaintext rules (SCAFFOLD, FedStride, FedRec, FedNova,
the server optimizers and the robust rules), secure aggregation (masking,
CKKS, identity), the streaming tier and the tree tier in process or over
slice aggregator processes, the uplink variants (int8q and top-k uplinks,
a narrowed downlink, client-level DP, FedBN local tensors and ship-only
subsets), over the in-memory, disk, cached-disk and remote stores (with
parallel ingest), with the controller's endpoint, the learners' endpoints,
the transport's settings and TLS for the multi-process federation, and the
failover and lifecycle planes: controller checkpoints, the driver's
supervision of the controller, the hot standby with its round-state WAL,
and the model registry with its promotion gate, and the serving plane
(the gateway, its replicated fleet behind the router, the autoscaler's
rules). It
travels to the controller process as codec bytes (``to_wire``) or YAML
(:func:`load_config`). It refuses at construction what the port does not
do yet: a request for a protocol, rule, tier, uplink encoding or
plane that is not ported raises ``NotImplementedError`` naming the ROADMAP
item that queues it, so no configuration is accepted and then silently
ignored. Values the JAX package rejects raise ``ValueError`` here too.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
import re
from typing import Any, Dict, List

import numpy as np

from metisfl_tpu_torch.aggregation import AGGREGATION_RULES
from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.messages import TrainParams
from metisfl_tpu_torch.comm.ssl import SSLConfig
from metisfl_tpu_torch.tensor.quantize import SHIP_INT8Q
from metisfl_tpu_torch.tensor.sparse import parse_topk
from metisfl_tpu_torch.tensor.spec import resolve_ship_dtype


@dataclass
class ServingFleetConfig:
    """Replicated serving fleet (serving/fleet.py): N driver-booted gateway
    replicas behind a consistent-hash router process (``python -m
    metisfl_tpu_torch.serving --router``). Key-stable routing keeps the
    crc32 canary split coherent across replicas; replicas stagger their
    registry polls so a promotion rolls through the fleet one replica at a
    time; the router drains around dead or draining replicas with bounded
    retry to the next hash owner. ``enabled=false`` keeps the single
    supervised gateway."""

    enabled: bool = False
    # replicas booted at launch (the autoscaler moves the live count
    # within [min_replicas, max_replicas] afterwards)
    replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 4
    # router gRPC port (0: the driver picks a free one and points
    # serving.port, what serving_client() dials, at it)
    router_port: int = 0
    # consistent-hash virtual nodes per replica (keyspace smoothing)
    vnodes: int = 64
    # bounded retry past the hash owner when it fails at call time
    retry_hops: int = 2
    # router health-probe cadence over the replica fleet
    probe_every_s: float = 1.0
    # autoscaler rules (telemetry/alerts.py AlertRule schema, kinds
    # value|rate, evaluated over fleet-summed serving_* families by the
    # driver): scale_up boots a replica, scale_down drains one; empty = no
    # autoscaler. Example:
    #   scale_up: {metric: serving_requests_total, kind: rate,
    #              window_s: 10, op: ">", threshold: 50, for_s: 2}
    scale_up: Dict[str, Any] = field(default_factory=dict)
    scale_down: Dict[str, Any] = field(default_factory=dict)
    # minimum seconds between scale actions (flap damping)
    scale_cooldown_s: float = 30.0
    # replica endpoints [{name, host, port}]; the driver fills one per
    # replica when left empty
    gateways: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class ServingDecodeConfig:
    """Continuous-batching decode (serving/decode.py)."""

    # concurrent sequences per channel's in-flight batch
    slots: int = 4
    # KV-cache length: every request's prompt + max_new_tokens must fit
    max_len: int = 512


@dataclass
class ServingConfig:
    """Serving gateway (serving/gateway.py): a driver-bootable process
    (``python -m metisfl_tpu_torch.serving``) serving inference over the
    federation's BytesService RPC with a micro-batching queue, atomic
    hot-swap to newly promoted versions and a canary split toward the
    ``candidate`` channel. Requires the registry."""

    enabled: bool = False
    host: str = "0.0.0.0"
    # gateway gRPC port (0: the driver picks a free one at launch)
    port: int = 0
    # micro-batching: coalesce concurrent requests until the batch holds
    # max_batch rows or max_wait_ms elapsed since the first queued row.
    # Every forward pass pads to exactly max_batch rows, so per-row results
    # stay bit-identical to unbatched ones.
    max_batch: int = 8
    max_wait_ms: float = 5.0
    # deterministic canary: requests whose key hashes into the lowest
    # canary_percent slots route to the candidate channel (0 = all stable)
    canary_percent: float = 0.0
    # registry poll period: how often ``start_sync`` compares the channel
    # heads against the registry
    poll_every_s: float = 1.0
    # which learner recipe builds the gateway's model engine
    recipe_index: int = 0
    # replicated fleet behind a consistent-hash router (serving/fleet.py)
    fleet: ServingFleetConfig = field(default_factory=ServingFleetConfig)
    decode: ServingDecodeConfig = field(default_factory=ServingDecodeConfig)


@dataclass
class TerminationConfig:
    """When the federation stops. The port's controller dispatches no train
    task after ``federation_rounds`` rounds (0 = no limit). The wall-clock
    and metric cutoffs are watched by the multi-process ``DriverSession``
    (``driver/session.py``), which then shuts the federation down; the
    in-process federation cannot watch them and refuses them."""

    federation_rounds: int = 10
    execution_cutoff_mins: float = 0.0       # 0 → no wall-clock cutoff
    metric_cutoff_score: float = 0.0         # 0 → no metric cutoff
    metric_name: str = "accuracy"            # the metric cutoff's metric


@dataclass
class SchedulingConfig:
    """Churn-tolerant round scheduling: quorum barriers, the buffered
    protocol's buffer size, churn-aware admission and bounded dispatch
    retries. The defaults reduce each controller path to one attribute
    check and keep rounds bit-identical to the plain barriers."""

    # K-of-N quorum for sync/semi-sync rounds: the round releases the
    # moment `quorum` dispatched learners reported (the reporters are the
    # cohort; the stragglers' tasks expire as at a deadline). 0 = the
    # full-cohort barrier, and so is any quorum >= the dispatched size.
    quorum: int = 0
    # with a quorum, each round dispatches ceil(quorum * (1 +
    # overprovision)) learners
    overprovision: float = 0.0
    # protocol=asynchronous_buffered: aggregation triggers per fill of a
    # buffer of this many reporters
    buffer_size: int = 10
    # churn/flap scores (selection.py ChurnTracker), an EWMA of leave,
    # flap-rejoin and failed-dispatch events per learner
    churn_tracking: bool = True
    churn_alpha: float = 0.3
    # a churn event lifting a learner's score past this excludes it from
    # cohort sampling for quarantine_s seconds (0 = never quarantine)
    quarantine_score: float = 0.0
    quarantine_s: float = 30.0
    # a provably failed train dispatch drops the learner from the round
    # barrier and dispatches a replacement after retry_backoff_s (doubling
    # per retry), up to this many retries a round (0 = off)
    dispatch_retries: int = 0
    retry_backoff_s: float = 0.5
    # consecutive round deadlines with no reporter before the round halts
    # with a lineage error (0 = re-dispatch forever)
    max_empty_redispatch: int = 8


@dataclass
class TreeAggregationConfig:
    """The tree-aggregation tier (aggregation/tree.py): the cohort split
    into ``branch`` slices folded in worker threads, then the partials
    folded at the root, for the weighted-sum rules on the store path.
    ``distributed`` turns the branches into slice aggregator processes
    (aggregation/slice.py, the controller side aggregation/
    distributed.py): each owns a contiguous slice of the cohort, receives
    its learners' uplinks over gRPC, spools them before the ack and ships
    one partial fold; a dead aggregator's slice re-homes mid-round."""

    enabled: bool = False
    branch: int = 8
    workers: int = 0                         # 0 → min(branch, cpu_count)
    distributed: bool = False
    # slice endpoints [{name, host, port, spool_dir}]; DriverSession fills
    # one per branch when left empty
    slices: List[Dict[str, Any]] = field(default_factory=list)
    # DriverSession's aggregators' spool root ("" → <workdir>/slices)
    spool_dir: str = ""
    # submit retries (doubling backoff) before an unreachable aggregator
    # is probed and its slice re-homed
    rehome_retries: int = 3
    rehome_backoff_s: float = 0.2


@dataclass
class AggregationConfig:
    rule: str = "fedavg"                     # fedavg | scaffold |
                                             # fedstride | fedrec |
                                             # fednova | fedavgm | fedadam |
                                             # fedyogi | median |
                                             # trimmed_mean | krum |
                                             # multikrum
    # server-optimizer hyperparameters (fedavgm / fedadam / fedyogi only)
    server_learning_rate: float = 1.0
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_tau: float = 1e-3
    scaler: str = "train_dataset_size"       # participants | train_dataset_size | batches
    stride_length: int = 0                   # 0 → all models in one block
    # how many learners train per round (1.0 = all)
    participation_ratio: float = 1.0
    # staleness damping: each contribution's weight times (1 +
    # staleness)^-decay, renormalized (0 = off; staleness is 0 under a
    # synchronous barrier)
    staleness_decay: float = 0.0
    # byzantine-robust rules (aggregation/robust.py): tail fraction each
    # side for trimmed_mean; assumed byzantine count for krum/multikrum
    # (0 derives the largest tolerable (n-3)//2 from the cohort)
    trim_ratio: float = 0.1
    byzantine_f: int = 0
    # streaming aggregation (aggregation/streaming.py): fold each accepted
    # uplink on arrival, no store round trip, for fedavg / fedstride /
    # fedrec where the lineage permits (other rules fall back to the
    # store path); under masking, masked uplinks fold on arrival
    streaming: bool = False
    tree: TreeAggregationConfig = field(default_factory=TreeAggregationConfig)


@dataclass
class ModelStoreConfig:
    store: str = "in_memory"                 # in_memory | disk | cached_disk
                                             # | remote
    lineage_length: int = 0                  # 0 → derive from the rule
    root: str = ""                           # disk stores' directory ("":
                                             # metisfl_tpu_store in the
                                             # temp directory)
    cache_mb: int = 256                      # cached_disk memory budget
    # store="remote": where python -m metisfl_tpu_torch.store.server (or
    # the JAX package's) serves
    host: str = "localhost"
    port: int = 0
    # > 0: a bounded pool of this many writers persists uplinks off the
    # completion path and aggregation fences on its drain before select
    # (store/ingest.py); 0 inserts on the completion path
    ingest_workers: int = 0


@dataclass
class SecureAggConfig:
    """Secure aggregation (aggregation/secure.py, secure/)."""

    enabled: bool = False
    scheme: str = "masking"                  # masking | ckks | identity
    key_dir: str = ""
    # masking: the party count the controller settles against; the driver
    # fills it in (secrets travel only in per-learner secure files)
    num_parties: int = 0
    # the Bonawitz threshold t: never unmask a partial sum of fewer
    # surviving parties than this
    min_recovery_parties: int = 2
    # 0: every pair masks (the complete graph); k > 0: the deterministic
    # ring k-regular mask graph (secure/distributed.py mask_partners)
    mask_neighbors: int = 0


@dataclass
class CheckpointConfig:
    """Controller checkpoints (``Controller.save_checkpoint``): the
    community model, the round counter and lineage, the learner registry
    with its tokens, the rules' state across rounds and the model
    registry, written every ``every_n_rounds`` rounds and at the seed and
    membership changes."""

    dir: str = ""                            # "" → checkpointing disabled
    every_n_rounds: int = 1


@dataclass
class FailoverConfig:
    """The driver's supervision of the controller process: a controller
    that dies mid-run is relaunched with ``--resume`` (the checkpoint
    restores the community model, the round counter and the learner
    registry with its tokens, so rejoining learners are recognized as
    themselves), at most ``max_controller_restarts`` times, the backoff
    doubling per restart."""

    supervise_controller: bool = True
    max_controller_restarts: int = 3
    restart_backoff_s: float = 1.0


@dataclass
class ControllerStandbyConfig:
    """The controller's hot standby (controller/wal.py and ``python -m
    metisfl_tpu_torch.controller --standby``). When enabled, the primary
    appends registry deltas and round-state snapshots to a write-ahead log
    under ``wal_dir`` (atomic rename before the ack) and the driver boots
    a warm standby that tails it: WAL tail stale past ``stale_after_s`` →
    grpc.health.v1 probe of the primary → ``probe_failures`` consecutive
    non-SERVING verdicts → promote (restore the WAL state, serve on its
    own pinned port, re-dispatch the abandoned round)."""

    enabled: bool = False
    host: str = "localhost"
    # the standby's gRPC port (0: the driver picks a free one and ships it
    # to every peer, so the two-endpoint redial is pinned up front)
    port: int = 0
    # the WAL directory the primary and the standby share (empty: the
    # driver puts it under its workdir)
    wal_dir: str = ""
    # seconds without WAL progress before the standby probes the primary
    stale_after_s: float = 3.0
    # the standby's tail-loop poll period
    probe_interval_s: float = 0.5
    # consecutive non-SERVING health probes that trigger promotion
    probe_failures: int = 3


@dataclass
class ControllerConfig:
    """Controller-process settings beyond ``controller_host``/``_port``."""

    standby: ControllerStandbyConfig = field(
        default_factory=ControllerStandbyConfig)


@dataclass
class PromotionConfig:
    """The model registry's promotion gate (registry/registry.py): a
    candidate moves to the ``stable`` channel only when every enabled rule
    passes; ``auto=false`` leaves promotion to the operator
    (``PromoteVersion``)."""

    auto: bool = True
    # the "<dataset>/<metric>" key of the folded community evaluation
    # compared against the stable version; loss/error-like metrics improve
    # downward, the others upward, and the candidate must not regress past
    # min_delta
    metric: str = "test/accuracy"
    min_delta: float = 0.0
    # refuse a version whose evaluation has not reported back
    require_eval: bool = True
    # refuse a version whose source round scored an update anomalous
    forbid_anomalies: bool = True
    # the source round's divergence scores at ``divergence_quantile`` must
    # stay <= max_divergence (0 = rule off)
    max_divergence: float = 0.0
    divergence_quantile: float = 0.9


@dataclass
class RegistryConfig:
    """The versioned community-model registry (registry/registry.py): each
    aggregated round registers a candidate version, the gate above
    promotes it to ``stable``, with rollback and retention GC; its lineage
    rides in the controller checkpoint."""

    enabled: bool = False
    # retired and candidate versions kept beyond the channel heads
    retention: int = 5
    promotion: PromotionConfig = field(default_factory=PromotionConfig)


@dataclass
class ChaosConfig:
    """Deterministic fault injection (metisfl_tpu_torch/chaos). ``rules``
    are ``FaultRule`` dicts; each may carry ``process`` (``controller``,
    ``learner``, ``learner_<idx>``, ``slice``, ``slice_<idx>``): the driver
    filters the rules per subprocess and arms them through the
    ``METISFL_TPU_CHAOS`` env var."""

    enabled: bool = False
    seed: int = 0
    rules: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class EvalConfig:
    batch_size: int = 256
    datasets: List[str] = field(default_factory=lambda: ["test"])
    metrics: List[str] = field(default_factory=lambda: ["loss", "accuracy"])
    every_n_rounds: int = 1


@dataclass
class EventsConfig:
    """Structured event journal (telemetry/events.py): typed federation
    events (joins, rounds, dispatches, retries, faults) in a bounded
    in-memory ring + JSONL sink (under ``telemetry.dir``). The ring tail
    rides in ``DescribeFederation`` snapshots and post-mortem bundles.
    ``enabled=false`` makes every emit call site a one-attribute-check
    no-op (telemetry.enabled=false implies it)."""

    enabled: bool = True
    ring_size: int = 512


@dataclass
class HealthConfig:
    """Learning-health plane (telemetry/health.py): per-uplink update
    statistics (norms, cohort alignment), per-learner EWMA divergence
    scores (cohort-median/MAD robust z, the convergence analogue of the
    straggler score), and per-round convergence snapshots. Controller-
    side and host-numpy only; ``enabled=false`` leaves the uplink hot
    path at one attribute check (secure aggregation implies off — the
    payloads are opaque ciphertext)."""

    enabled: bool = True
    # EWMA blend for per-learner divergence scores (~last 3-4 rounds
    # dominate, matching the straggler analytics)
    alpha: float = 0.3
    # robust-z threshold past which an uplink emits UpdateAnomalous
    anomaly_threshold: float = 3.0
    # advisory hook: pass the scores to selection + robust aggregation
    # (informational — results are bit-identical either way; the rules
    # record/log which flagged learners entered the cohort)
    advisory: bool = False


@dataclass
class ProfileConfig:
    """Performance observatory (telemetry/profile.py): typed per-round
    cost profiles on the controller (phase waterfall, per-learner
    uplink/downlink wire bytes + codec attribution, store/aggregation
    time), device-utilization capture in the learner train loop
    (step-time EWMA, achieved MFU, HBM watermark, shipped back in
    ``TaskResult.device_stats``), and flag-gated periodic ``jax.profiler``
    trace capture (``torch.profiler`` in the port). ``enabled=false``
    leaves every hot path at one attribute check (no collector
    constructed, no device stats shipped)."""

    enabled: bool = True
    # arm a torch.profiler capture on the dispatched tasks every N rounds
    # (0 = never); sessions land under <dir>/jaxprof/round<N>/ in
    # collision-free per-capture subdirs
    trace_every_rounds: int = 0
    # RoundProfile JSONL sink dir ("" → telemetry.dir, next to traces)
    dir: str = ""


@dataclass
class ProfConfig:
    """Continuous profiling plane (telemetry/prof.py; accepted and not
    ported yet, ROADMAP.md Queue 1 item 4b): an always-on
    stack sampler per process (daemon thread over
    ``sys._current_frames()``) folding into a bounded mergeable
    folded-stack table, plus instrumented wrappers on the hot locks
    (controller registry, store lineage/LRU, ingest, slice reducer,
    serving queue, fleet collector) recording wait-time histograms and
    per-site contention counters. Profiles ride ``CollectTelemetry``
    and each RoundProfile carries the per-round folded-stack delta.
    ``enabled=false``: no sampler thread, and the lock factories
    hand back raw ``threading`` locks — zero wrapper cost."""

    enabled: bool = True
    # sampling frequency; 67 Hz is deliberately off-harmonic with the
    # 1/10/100 ms periods federation work is built from (GWP posture)
    hz: float = 67.0
    # folded-stack table budget: top-`budget` stacks keep exact labels,
    # the crowd collapses into the SpaceSaving eviction floor — fleet
    # profiles stay O(budget) however long the process runs
    budget: int = 512


@dataclass
class RuntimeConfig:
    """Accelerator runtime observability (telemetry/runtime.py; accepted
    and not ported yet, 4b): XLA
    compile tracking (``jax.monitoring`` duration listener + the
    ``monitored_jit`` attribution wrappers on the jit entrypoints we
    own), cold-vs-recompile classification with storm events, and
    device/host memory accounting sampled on the prof cadence.
    ``enabled=false`` installs no listener, wrapped jits pass straight
    through at one attribute check, and the ``CollectTelemetry``
    section is an ``{"enabled": false}`` stub."""

    enabled: bool = True
    # per-fn compile-row budget: this many names stay exact, the crowd
    # folds into the "_other" row
    budget: int = 256
    # memory-sample gate on the prof sampler cadence (seconds): a 67 Hz
    # sampler costs one memory walk per this interval, not 67/s
    mem_every_s: float = 1.0
    # a recompile storm = storm_threshold recompiles of ONE function
    # inside storm_window_s (emits a jax_recompile_storm event, muted
    # per function for one window)
    storm_window_s: float = 10.0
    storm_threshold: int = 4


@dataclass
class FabricConfig:
    """Fleet telemetry fabric (telemetry/fabric.py; accepted and not
    ported yet, 4b — every server answers ``CollectTelemetry`` with the
    ``{"enabled": false}`` stub): the
    ``CollectTelemetry`` cursor-pull RPC every role-carrying endpoint
    answers, and the driver-side :class:`FleetCollector` that polls the
    fleet with jitter, corrects per-peer clock skew NTP-style, and
    streams the merged span timeline into ``traces.jsonl`` live.
    ``enabled=false`` leaves every server at one attribute check (the
    handler answers a stub and the finished-span ring is disabled)."""

    enabled: bool = True
    # collector poll period (seconds) and its relative jitter in [0, 1)
    # — jitter de-correlates N collectors against one fleet
    poll_every_s: float = 2.0
    jitter: float = 0.3
    # clock-offset EWMA blend and the RTT gate: an offset sample is
    # accepted only when its round trip stays within rtt_gate × the
    # best RTT seen for that peer (a congested exchange can be off by
    # rtt/2)
    offset_alpha: float = 0.2
    rtt_gate: float = 3.0
    # per-process finished-span ring the cursor pulls read from
    # (0 → the trace module's default, 4096)
    span_ring: int = 0
    # causal critical-path attribution (telemetry/causal.py) over the
    # merged span buffer: refresh per sweep, export the heaviest edges
    # as round_critical_path_seconds{edge} and the snapshot's crit row.
    # False skips the walk (span collection itself is unaffected).
    critical_path: bool = True
    # how many heaviest edges each summary/gauge keeps
    critical_path_edges: int = 5


@dataclass
class TelemetryConfig:
    """Federation-wide observability (metisfl_tpu_torch/telemetry): trace spans
    + metrics registry + event journal. ``enabled=false`` opts the whole
    subsystem out (instrument call sites become attribute-check no-ops)."""

    enabled: bool = True
    # JSONL trace-sink directory. "" → spans are not persisted (ids and
    # durations still flow into RoundMetadata); the driver fills this in
    # with <workdir>/telemetry so controller + learner files stitch.
    dir: str = ""
    # Cardinality budget for the per-learner metric families
    # (docs/OBSERVABILITY.md "Telemetry at scale"): past this many
    # series a family collapses to quantile series + top-K offender
    # series + a distinct count (mergeable sketches, telemetry/
    # sketch.py), bounding exposition / describe() / checkpoint at
    # O(budget) however large the fleet. 0 (default) = exact series,
    # today's behavior bit-identically.
    cardinality_budget: int = 0
    # SLO alert rules (the JAX package's telemetry/alerts.py; not ported
    # yet, 4b: a non-empty list is refused). Empty (default) constructs
    # no engine.
    alerts: List[Dict[str, Any]] = field(default_factory=list)
    # alert-engine evaluation cadence (also the sampling period of the
    # bounded time-series ring behind status --watch sparklines)
    alerts_interval_s: float = 1.0
    # optional plain-HTTP /metrics listener on the controller (0 = off);
    # learners take --metrics-port on their CLI instead (N learners on
    # one host cannot share a configured port)
    http_port: int = 0
    # event journal (telemetry/events.py)
    events: EventsConfig = field(default_factory=EventsConfig)
    # learning-health plane (telemetry/health.py)
    health: HealthConfig = field(default_factory=HealthConfig)
    # performance observatory (telemetry/profile.py)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    # fleet telemetry fabric (telemetry/fabric.py)
    fabric: FabricConfig = field(default_factory=FabricConfig)
    # continuous profiling plane (telemetry/prof.py)
    prof: ProfConfig = field(default_factory=ProfConfig)
    # accelerator runtime observability (telemetry/runtime.py)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    # flight-recorder bundle directory (telemetry/postmortem.py): crash /
    # chaos-kill / failover post-mortems land here. "" → recorder off;
    # the driver fills this in with <workdir>/postmortem.
    postmortem_dir: str = ""


@dataclass
class CommConfig:
    """Transport settings (``comm/rpc.py`` ``RpcClient``): the deadline of
    a call that passes ``timeout=None`` (``<= 0`` = unbounded), and how
    often and how far apart UNAVAILABLE is retried. DEADLINE_EXCEEDED is
    retried only for idempotent methods (getters, join, health)."""

    default_deadline_s: float = 120.0
    retries: int = 10
    retry_sleep_s: float = 1.0


@dataclass
class LearnerEndpoint:
    """Where DriverSession launches one learner; port 0 binds an ephemeral
    port, which the learner reports when it joins."""

    hostname: str = "localhost"
    port: int = 0
    # processes for this one learner (multi-host learners: not ported)
    world_size: int = 1


# the protocols of the JAX package
_PROTOCOLS = ("synchronous", "semi_synchronous", "asynchronous",
              "asynchronous_buffered")
_STORES = ("in_memory", "disk", "cached_disk", "remote")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to metisfl_tpu_torch yet (ROADMAP.md "
        f"Queue 1 item {item})")


@dataclass
class FederationConfig:
    protocol: str = "synchronous"            # synchronous |
                                             # semi_synchronous |
                                             # asynchronous |
                                             # asynchronous_buffered
    semi_sync_lambda: float = 1.0
    semi_sync_recompute_every_round: bool = False
    # straggler deadline for sync/semi-sync rounds: a dispatched learner
    # that has not reported within this many seconds is dropped from the
    # barrier and the round goes on with whoever reported (0 = none)
    round_deadline_secs: float = 0.0
    # after this many consecutive failed train dispatches a learner is
    # left out of cohort sampling until it completes a task or rejoins
    # (0 = off)
    max_dispatch_failures: int = 3
    scheduling: SchedulingConfig = field(default_factory=SchedulingConfig)
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
    model_store: ModelStoreConfig = field(default_factory=ModelStoreConfig)
    secure: SecureAggConfig = field(default_factory=SecureAggConfig)
    termination: TerminationConfig = field(default_factory=TerminationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    registry: RegistryConfig = field(default_factory=RegistryConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    train: TrainParams = field(default_factory=TrainParams)
    eval: EvalConfig = field(default_factory=EvalConfig)
    comm: CommConfig = field(default_factory=CommConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    ssl: SSLConfig = field(default_factory=SSLConfig)
    failover: FailoverConfig = field(default_factory=FailoverConfig)
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    # the controller's endpoint; DriverSession binds an ephemeral port and
    # reads it back when controller_port is 0
    controller_host: str = "localhost"
    controller_port: int = 50051
    learners: List[LearnerEndpoint] = field(default_factory=list)

    def __post_init__(self):
        agg, sched, train = self.aggregation, self.scheduling, self.train
        secure = self.secure
        masking = secure.enabled and secure.scheme == "masking"
        rule = agg.rule.lower()
        if masking and self.protocol.startswith("asynchronous"):
            # pairwise masks cancel only across one round barrier
            raise ValueError(
                "masking secure aggregation requires protocol: synchronous "
                "or semi_synchronous (pairwise masks only cancel across "
                "one round barrier). For an asynchronous secure federation "
                "use scheme: ckks")
        if self.protocol not in _PROTOCOLS:
            raise ValueError(f"unknown protocol {self.protocol!r}")
        if secure.enabled and agg.rule != "secure_agg":
            raise ValueError("secure aggregation requires aggregation.rule "
                             "== 'secure_agg'")
        if agg.rule == "secure_agg" and not secure.enabled:
            raise ValueError("aggregation.rule 'secure_agg' requires "
                             "secure.enabled")
        if secure.enabled and secure.scheme not in ("masking", "ckks",
                                                    "identity"):
            raise ValueError(f"unknown secure scheme {secure.scheme!r}")
        if masking and agg.scaler != "participants":
            # MaskingBackend refuses non-uniform scales at aggregation
            raise ValueError(
                "masking secure aggregation requires uniform scales: set "
                f"aggregation.scaler: participants (got {agg.scaler!r})")
        if secure.mask_neighbors < 0:
            raise ValueError("secure.mask_neighbors must be >= 0 (0 = "
                             "complete pairwise mask graph)")
        if agg.streaming and secure.enabled and not masking:
            # ciphertexts need the full-cohort combine; masked sums fold
            # on arrival
            raise ValueError(
                "aggregation.streaming with secure aggregation requires "
                f"secure.scheme: masking (scheme={secure.scheme!r} "
                "ciphertexts cannot fold on arrival)")
        if rule not in AGGREGATION_RULES:
            raise ValueError(f"unknown aggregation rule {agg.rule!r}; have "
                             f"{sorted(AGGREGATION_RULES)}")
        if rule == "trimmed_mean" and not 0.0 <= agg.trim_ratio < 0.5:
            # the JAX package's TrimmedMean refuses it when the controller
            # builds the rule; here before any process starts
            raise ValueError("trim_ratio must be in [0, 0.5)")
        if agg.tree.enabled and agg.tree.branch < 2:
            raise ValueError("aggregation.tree.branch must be >= 2")
        if agg.tree.workers < 0:
            raise ValueError("aggregation.tree.workers must be >= 0")
        if agg.tree.distributed:
            self._check_distributed(masking)
        if not 0.0 < agg.participation_ratio <= 1.0:
            raise ValueError("participation_ratio must be in (0, 1]")
        if self.model_store.store not in _STORES:
            raise ValueError(f"unknown store {self.model_store.store!r}")
        if self.model_store.ingest_workers < 0:
            raise ValueError("model_store.ingest_workers must be >= 0")
        self._check_scheduling()
        if agg.staleness_decay < 0.0:
            raise ValueError("staleness_decay must be >= 0")
        if masking and agg.staleness_decay > 0.0:
            # damping makes the scales non-uniform, and masks cancel only
            # under uniform scales
            raise ValueError(
                "staleness_decay is incompatible with masking secure "
                "aggregation (masks only cancel under uniform scales)")
        term = self.termination
        if term.federation_rounds < 0:
            raise ValueError("termination.federation_rounds must be >= 0")
        if term.execution_cutoff_mins < 0 or term.metric_cutoff_score < 0:
            raise ValueError("termination cutoffs must be >= 0")
        self._check_uplink(rule)
        self._check_failover()
        self._check_serving()
        self._check_telemetry()
        # what the port does not do yet, once the values are known valid
        if any(ep.world_size > 1 for ep in self.learners):
            raise not_ported("multi-host learners (world_size > 1)", "9")
        if self.telemetry.alerts:
            raise not_ported("SLO alert rules (telemetry.alerts)", "4b")

    def _check_scheduling(self) -> None:
        """The JAX package's scheduling checks, with its error types."""
        sched = self.scheduling
        if sched.quorum < 0:
            raise ValueError("scheduling.quorum must be >= 0")
        if sched.quorum > 0 and self.protocol.startswith("asynchronous"):
            # the asynchronous protocols have no barrier a quorum could
            # shorten
            raise ValueError(
                "scheduling.quorum requires a synchronous or "
                "semi-synchronous protocol (asynchronous rounds have no "
                "barrier; use scheduling.buffer_size for "
                "asynchronous_buffered)")
        if sched.overprovision < 0.0:
            raise ValueError("scheduling.overprovision must be >= 0")
        if sched.overprovision > 0.0 and sched.quorum <= 0:
            raise ValueError(
                "scheduling.overprovision requires scheduling.quorum > 0 "
                "(over-provisioning sizes the quorum dispatch)")
        if sched.buffer_size < 1:
            raise ValueError("scheduling.buffer_size must be >= 1")
        if not 0.0 < sched.churn_alpha <= 1.0:
            raise ValueError("scheduling.churn_alpha must be in (0, 1]")
        if sched.quarantine_score < 0.0:
            raise ValueError("scheduling.quarantine_score must be >= 0")
        if sched.quarantine_score > 0.0 and sched.quarantine_s <= 0.0:
            raise ValueError(
                "scheduling.quarantine_s must be > 0 when quarantine is "
                "armed (a zero-length quarantine never excludes anyone)")
        if sched.quarantine_score > 0.0 and not sched.churn_tracking:
            raise ValueError(
                "scheduling.quarantine_score requires churn_tracking "
                "(quarantine is driven by the churn scores)")
        if sched.dispatch_retries < 0:
            raise ValueError("scheduling.dispatch_retries must be >= 0")
        if sched.dispatch_retries > 0 and sched.retry_backoff_s <= 0.0:
            raise ValueError(
                "scheduling.retry_backoff_s must be > 0 when "
                "dispatch_retries is armed")
        if sched.max_empty_redispatch < 0:
            raise ValueError("scheduling.max_empty_redispatch must be >= 0")
        if self.chaos.enabled:
            # a misspelt fault fails here, not when it would fire
            from metisfl_tpu_torch.chaos.injector import ChaosInjector
            try:
                ChaosInjector.from_spec({"seed": self.chaos.seed,
                                         "rules": self.chaos.rules})
            except (TypeError, ValueError) as exc:
                raise ValueError(f"invalid chaos rule: {exc}") from None

    def _check_telemetry(self) -> None:
        """The JAX package's telemetry checks, with its error types (the
        fabric, profiler and runtime sections are checked though the port
        does not run them yet, so a YAML valid for one package is valid for
        the other)."""
        if not 0.0 < self.telemetry.health.alpha <= 1.0:
            # a typo'd blend weight would silently freeze (0) or unsmooth
            # (>1 oscillates) every divergence score
            raise ValueError("telemetry.health.alpha must be in (0, 1]")
        if self.telemetry.health.anomaly_threshold <= 0.0:
            # threshold 0 would flag EVERY above-median update anomalous
            raise ValueError(
                "telemetry.health.anomaly_threshold must be > 0")
        if self.telemetry.profile.trace_every_rounds < 0:
            # a negative period would silently never fire via the modulo
            raise ValueError(
                "telemetry.profile.trace_every_rounds must be >= 0")
        if self.telemetry.cardinality_budget < 0:
            raise ValueError("telemetry.cardinality_budget must be >= 0")
        fab = self.telemetry.fabric
        if fab.poll_every_s <= 0.0:
            raise ValueError("telemetry.fabric.poll_every_s must be > 0")
        if not 0.0 <= fab.jitter < 1.0:
            raise ValueError("telemetry.fabric.jitter must be in [0, 1)")
        if not 0.0 < fab.offset_alpha <= 1.0:
            # same posture as the other EWMA blends: a typo'd weight
            # would silently freeze or unsmooth every offset estimate
            raise ValueError(
                "telemetry.fabric.offset_alpha must be in (0, 1]")
        if fab.rtt_gate < 1.0:
            # a gate under 1 rejects even the best-RTT sample — the
            # estimator would never converge
            raise ValueError("telemetry.fabric.rtt_gate must be >= 1")
        if fab.span_ring < 0:
            raise ValueError("telemetry.fabric.span_ring must be >= 0")
        if fab.critical_path_edges < 1:
            # 0 edges is an attribution that attributes nothing — turn
            # the walk off with critical_path=false instead
            raise ValueError(
                "telemetry.fabric.critical_path_edges must be >= 1")
        pr = self.telemetry.prof
        if pr.enabled:
            if not 0.0 < pr.hz <= 1000.0:
                # 0 would park the sampler thread in a busy loop's
                # degenerate cousin (wait(inf)); past 1 kHz the sampler
                # IS the workload it claims to measure
                raise ValueError(
                    "telemetry.prof.hz must be in (0, 1000]")
            if pr.budget < 16:
                # a tiny table thrashes the SpaceSaving floor and every
                # profile becomes eviction noise
                raise ValueError("telemetry.prof.budget must be >= 16")
        rt = self.telemetry.runtime
        if rt.enabled:
            # the silently-armed-nothing posture: a knob that would make
            # the plane record nothing (or storm-mute everything) must
            # fail at config time, not "run" blind
            if rt.budget < 8:
                raise ValueError("telemetry.runtime.budget must be >= 8")
            if rt.mem_every_s <= 0.0:
                raise ValueError(
                    "telemetry.runtime.mem_every_s must be > 0")
            if rt.storm_window_s <= 0.0:
                raise ValueError(
                    "telemetry.runtime.storm_window_s must be > 0")
            if rt.storm_threshold < 2:
                # 1 would flag every single recompile as a "storm"
                raise ValueError(
                    "telemetry.runtime.storm_threshold must be >= 2")
        if self.telemetry.alerts_interval_s <= 0.0:
            raise ValueError("telemetry.alerts_interval_s must be > 0")

    def _check_failover(self) -> None:
        """The JAX package's failover, standby and registry checks, with
        its error types."""
        if self.failover.max_controller_restarts < 0:
            raise ValueError("failover.max_controller_restarts must be >= 0")
        standby = self.controller.standby
        if standby.enabled:
            if standby.stale_after_s <= 0.0:
                raise ValueError(
                    "controller.standby.stale_after_s must be > 0 (a zero "
                    "staleness window probes a healthy primary every tick)")
            if standby.probe_interval_s <= 0.0:
                raise ValueError(
                    "controller.standby.probe_interval_s must be > 0")
            if standby.probe_failures < 1:
                raise ValueError(
                    "controller.standby.probe_failures must be >= 1 "
                    "(promotion must require at least one probe verdict)")
            if standby.port < 0:
                raise ValueError("controller.standby.port must be >= 0")
        elif standby.wal_dir:
            # a WAL on a disabled standby replicates to nobody
            raise ValueError(
                "controller.standby.wal_dir requires "
                "controller.standby.enabled (the WAL exists to keep a "
                "standby promote-ready)")
        registry = self.registry
        if registry.enabled and self.secure.enabled and (
                self.secure.scheme != "masking"):
            # ciphertext could never be served; masking's settled output
            # is the public plain aggregate
            raise ValueError(
                "registry requires a decodable community model: secure "
                f"scheme {self.secure.scheme!r} registers opaque "
                "ciphertext — use scheme: masking, whose settled output "
                "is the public plain aggregate and composes with the "
                "registry")
        if registry.enabled and registry.retention < 1:
            raise ValueError("registry.retention must be >= 1")
        if registry.enabled:
            q = registry.promotion.divergence_quantile
            if not 0.0 < q <= 1.0:
                raise ValueError(
                    "registry.promotion.divergence_quantile must be in "
                    "(0, 1]")

    def _check_serving(self) -> None:
        """The JAX package's serving and serving-fleet checks, with its
        error types and messages."""
        serving = self.serving
        fleet = serving.fleet
        if serving.enabled:
            if not self.registry.enabled:
                # the gateway serves registry channels; without versions
                # there is nothing to install or swap
                raise ValueError(
                    "serving.enabled requires registry.enabled (the "
                    "gateway serves promoted registry versions)")
            if serving.max_batch < 1:
                raise ValueError("serving.max_batch must be >= 1")
            if serving.max_wait_ms < 0:
                raise ValueError("serving.max_wait_ms must be >= 0")
            if not 0.0 <= serving.canary_percent <= 100.0:
                raise ValueError(
                    "serving.canary_percent must be in [0, 100]")
            if serving.recipe_index < 0:
                # a negative index would pick a recipe from the END of the
                # driver's list
                raise ValueError("serving.recipe_index must be >= 0")
            if serving.decode.slots < 1:
                raise ValueError("serving.decode.slots must be >= 1")
            if serving.decode.max_len < 2:
                # one prompt token + one generated token is the minimum
                # generation the cache must hold
                raise ValueError("serving.decode.max_len must be >= 2")
            if fleet.enabled:
                if fleet.min_replicas < 1:
                    raise ValueError(
                        "serving.fleet.min_replicas must be >= 1")
                if fleet.max_replicas < fleet.min_replicas:
                    raise ValueError(
                        "serving.fleet.max_replicas must be >= "
                        "min_replicas")
                if not (fleet.min_replicas <= fleet.replicas
                        <= fleet.max_replicas):
                    raise ValueError(
                        "serving.fleet.replicas must lie within "
                        "[min_replicas, max_replicas]")
                if fleet.vnodes < 1:
                    raise ValueError("serving.fleet.vnodes must be >= 1")
                if fleet.retry_hops < 0:
                    raise ValueError(
                        "serving.fleet.retry_hops must be >= 0")
                if fleet.probe_every_s <= 0.0:
                    raise ValueError(
                        "serving.fleet.probe_every_s must be > 0")
                if fleet.scale_cooldown_s < 0.0:
                    raise ValueError(
                        "serving.fleet.scale_cooldown_s must be >= 0")
                if fleet.scale_up or fleet.scale_down:
                    # a typo'd scale rule fails at config time, not at the
                    # first traffic surge; quantile kinds are refused
                    # inside (a scraped family sum has no digest)
                    from metisfl_tpu_torch.serving.fleet import (
                        FleetAutoscaler)
                    try:
                        FleetAutoscaler(
                            fleet.scale_up or None,
                            fleet.scale_down or None,
                            fleet.min_replicas, fleet.max_replicas,
                            cooldown_s=fleet.scale_cooldown_s)
                    except (TypeError, ValueError) as exc:
                        raise ValueError(
                            f"invalid serving.fleet scale rule: "
                            f"{exc}") from None
        if fleet.enabled and not serving.enabled:
            # a fleet block on a disabled serving plane boots nothing
            raise ValueError(
                "serving.fleet.enabled requires serving.enabled")
        if (fleet.scale_up or fleet.scale_down) and not fleet.enabled:
            # scale rules only drive the fleet autoscaler
            raise ValueError(
                "serving.fleet.scale_up/scale_down require "
                "serving.fleet.enabled (the autoscaler boots and drains "
                "fleet replicas)")

    def _check_distributed(self, masking: bool) -> None:
        """The distributed tier's capability matrix (the JAX package's):
        it is the tree tier's topology; masked sums fold key-free at the
        slices, ciphertexts do not; plaintext uplinks fold at their slice,
        not in a controller stream; there is no root store to ingest into;
        only the weighted-sum rules slice-fold."""
        agg = self.aggregation
        tree = agg.tree
        if not tree.enabled:
            raise ValueError("aggregation.tree.distributed requires "
                             "aggregation.tree.enabled")
        if self.secure.enabled and not masking:
            raise ValueError(
                "aggregation.tree.distributed with secure aggregation "
                "requires secure.scheme: masking (masked partial sums fold "
                f"key-free at the slices; scheme={self.secure.scheme!r} "
                "payloads need the one-combine path)")
        if agg.streaming and not masking:
            raise ValueError(
                "aggregation.tree.distributed with aggregation.streaming "
                "requires masking secure aggregation (plaintext uplinks fold "
                "at their slice aggregator, not in the controller's stream)")
        if self.model_store.ingest_workers > 0:
            raise ValueError(
                "aggregation.tree.distributed is incompatible with "
                "model_store.ingest_workers (uplinks bypass the root store)")
        if agg.rule.lower() not in ("fedavg", "scaffold", "fedstride",
                                    "secure_agg"):
            raise ValueError(
                "aggregation.tree.distributed requires a weighted-sum rule "
                "(fedavg/scaffold/fedstride) or masked secure_agg, not "
                f"{agg.rule!r}")
        if tree.rehome_retries < 0:
            raise ValueError("aggregation.tree.rehome_retries must be >= 0")
        if tree.rehome_retries > 0 and tree.rehome_backoff_s <= 0.0:
            raise ValueError("aggregation.tree.rehome_backoff_s must be > 0 "
                             "when rehome_retries is armed")

    def _check_uplink(self, rule: str) -> None:
        """SCAFFOLD, client-level DP and the uplink and downlink encodings:
        the JAX package's checks, with its error types."""
        train, secure = self.train, self.secure
        if train.dp_noise_multiplier < 0.0 or train.dp_clip_norm < 0.0:
            raise ValueError("dp_clip_norm and dp_noise_multiplier must be "
                             ">= 0")
        if rule == "scaffold":
            if secure.enabled:
                raise ValueError(
                    "scaffold is incompatible with secure aggregation: "
                    "control deltas are not encrypted/masked")
            if train.dp_clip_norm > 0.0:
                raise ValueError(
                    "scaffold is incompatible with dp_clip_norm: control "
                    "deltas are not privatized, so the DP guarantee would "
                    "not cover them")
            if train.optimizer.lower() != "sgd":
                # the variate update divides by K*lr, the inverse of a
                # plain SGD step
                raise ValueError(
                    "scaffold requires optimizer='sgd' (the control-variate "
                    "update c_i+ = c_i - c + (x - y)/(K*lr) assumes plain "
                    "SGD local steps)")
        if train.dp_noise_multiplier > 0.0 and train.dp_clip_norm <= 0.0:
            raise ValueError(
                "dp_noise_multiplier > 0 requires dp_clip_norm > 0 "
                "(noise scales with the clip bound)")
        topk = None
        if train.ship_dtype:
            topk = parse_topk(train.ship_dtype)
            int8q = train.ship_dtype.lower() == SHIP_INT8Q
            if not int8q and topk is None:
                # an unknown name is a ValueError before any training
                resolve_ship_dtype(train.ship_dtype)
            if (int8q or topk is not None) and secure.enabled:
                raise ValueError(
                    f"ship_dtype={train.ship_dtype!r} is incompatible with "
                    "secure aggregation (HE/masking payloads have their own "
                    "fixed-point encoding)")
            if topk is not None and self.protocol.startswith("asynchronous"):
                # the controller densifies against the dispatched model
                raise ValueError(
                    "ship_dtype='topk...' requires a synchronous or "
                    "semi_synchronous protocol (async advances the "
                    "community model mid-task, breaking sparse-update "
                    "reconstruction)")
        if train.local_tensor_regex:
            _compiles("local_tensor_regex", train.local_tensor_regex)
            if secure.enabled:
                raise ValueError(
                    "local_tensor_regex is incompatible with secure "
                    "aggregation (partial trees break the uniform-shape "
                    "masking/HE payload contract)")
            if rule in ("fedavgm", "fedadam", "fedyogi", "fednova",
                        "scaffold"):
                raise ValueError(
                    f"local_tensor_regex is incompatible with rule="
                    f"{rule!r}: stateful server rules track a full model "
                    "tree, but local tensors drop out of the aggregate "
                    "after round 1")
            if train.dp_clip_norm > 0.0:
                raise ValueError(
                    "local_tensor_regex is incompatible with client-level "
                    "DP: the clip norm covers the full update, so local "
                    "tensors would consume the sensitivity budget")
        if train.ship_tensor_regex:
            _compiles("ship_tensor_regex", train.ship_tensor_regex)
            if train.local_tensor_regex:
                raise ValueError(
                    "ship_tensor_regex and local_tensor_regex cannot "
                    "combine: one selects the federated subset, the other "
                    "retains a local subset — pick one partition")
            if rule == "scaffold":
                raise ValueError(
                    "ship_tensor_regex is incompatible with rule='scaffold' "
                    "(control variates span the full model tree)")
            if train.dp_clip_norm > 0.0:
                raise ValueError(
                    "ship_tensor_regex is incompatible with client-level "
                    "DP: the clip norm covers the full update while only "
                    "the subset ships")
        if train.downlink_dtype:
            target = np.dtype(resolve_ship_dtype(train.downlink_dtype))
            if np.issubdtype(target, np.integer) or target == np.bool_:
                raise ValueError(
                    f"downlink_dtype {train.downlink_dtype!r} must be a "
                    "float dtype (integer state never narrows)")
            if secure.enabled:
                raise ValueError(
                    "downlink_dtype is incompatible with secure aggregation "
                    "(the broadcast is an opaque ciphertext payload)")
            if topk is not None:
                raise ValueError(
                    "downlink_dtype cannot combine with ship_dtype='topk...'"
                    ": sparse updates reconstruct against the controller's "
                    "exact f32 community model")

    def to_wire(self) -> bytes:
        return dumps(_to_plain(self))

    @classmethod
    def from_wire(cls, buf) -> "FederationConfig":
        return _from_plain(cls, loads(buf))


def _compiles(field_name: str, pattern: str) -> None:
    try:
        re.compile(pattern)
    except re.error as exc:
        raise ValueError(f"{field_name} does not compile: {exc}") from None


def _to_plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_to_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


def _from_plain(cls, data):
    """A dataclass from plain dicts and lists; fields it does not know are
    ignored, as the JAX package ignores them."""
    if not dataclasses.is_dataclass(cls):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        hint = hints.get(f.name)
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _from_plain(hint, value)
        elif isinstance(value, list):
            args = typing.get_args(hint)
            if args and dataclasses.is_dataclass(args[0]):
                value = [_from_plain(args[0], v) for v in value]
        kwargs[f.name] = value
    return cls(**kwargs)


def load_config(path: str) -> FederationConfig:
    """A federation environment from YAML."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _from_plain(FederationConfig, data)
