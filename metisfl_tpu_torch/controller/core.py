"""Federation controller: rounds under every protocol and ported rule.

The port's copy of the JAX package's ``controller/core.py``: the learner
registry (join, rejoin, leave), the train-task lifecycle, the model store
(in memory, on disk, cached, or remote) with its parallel-ingest plane,
aggregation, round metadata, community-model evaluation and re-dispatch.

Round control, as in the JAX package. The protocols (scheduling.py): the
synchronous barrier, with a ``scheduling.quorum`` releasing at K
reporters out of an over-provisioned dispatch (the stragglers' tasks
expire, so their late uplinks never advance the next round's barrier);
the semi-synchronous one, whose per-learner step budgets are recomputed
from the learners' ``ms_per_step`` after a round; the asynchronous one,
which releases each reporter alone; and the buffered one, which folds per
``buffer_size`` reporters and re-dispatches each reporter at once. A
contribution's staleness (the rounds the community model advanced since
its task's dispatch) damps its weight under ``aggregation.
staleness_decay``. ``round_deadline_secs`` arms a timer per round: at its
end the unreported tasks expire and the round goes on with the reporters
(under masking, settled through ``RecoverMasks``), or re-dispatches, and
after ``scheduling.max_empty_redispatch`` empty deadlines in a row halts
until an uplink arrives. A provably failed dispatch counts against the
learner (``max_dispatch_failures`` leaves it out of the sampling) and,
under ``scheduling.dispatch_retries``, drops it from the barrier and
dispatches a replacement after a doubling backoff. ``ChurnTracker``
(selection.py) scores leaves, flap rejoins and failed dispatches, and
quarantines a learner past ``scheduling.quarantine_score``. Cohorts and
replacements are drawn from the global ``random``, as the JAX package
draws them. ``shutdown()`` cancels every deadline and retry timer.

Aggregation dispatches as the JAX controller does, by the rule's kind:
the fold rules (FedAvg, FedNova with each learner's ``completed_batches``
as its local steps, and the server optimizers over the FedAvg fold) fold
stride block by stride block on the host; the rolling rules (FedStride,
reset every round, and FedRec, whose state lives across rounds) fold
each block into their rolling state; the robust rules (median, trimmed
mean, Krum, MultiKrum) take the whole cohort in one call. Wire blobs are
parsed into numpy and every fold runs on the host (aggregation/base.py);
the robust rules stack the cohort on the controller's ``device``
(``cuda`` unless the caller asks for the CPU), combine it there and
bring the community model back (aggregation/robust.py). Rules with state
across rounds (FedNova, the server optimizers) start from the seeded
community model and commit a round's step only once its community model
is installed, so an aggregation-failure retry does not step twice.

Parallel ingest (``model_store.ingest_workers > 0``, store/ingest.py):
a completion enqueues its model and returns; the writer pool persists it
and applies the result's metadata only once the write lands; aggregation
drains the pipeline before any select, and a departing learner's queued
writes are drained before its lineage is erased.

The other ingest tiers of the JAX controller: streaming
(``aggregation.streaming``, aggregation/streaming.py) folds each accepted
uplink on arrival and finalizes at barrier release with no store read,
for fedavg, fedstride and fedrec (anything else falls back to the store
path, logged); the tree tier (``aggregation.tree.enabled``,
aggregation/tree.py) folds the store path's cohort in ``branch`` slices
on worker threads, for fedavg, scaffold and fedstride; the distributed
tier (``aggregation.tree.distributed``, aggregation/distributed.py)
forwards each accepted uplink to its slice aggregator process instead of
the store and fans in one partial per slice at barrier release (the root
store sees no insert and no select). Its slices are assigned when a
round's cohort is dispatched together; a learner's first task, dispatched
when it joins, has no slice yet, so round 0 folds at the root's residual
buffer, as in the JAX package.

SCAFFOLD (rule ``scaffold``): each task carries the server control variate
``c``, each result a control delta; after the weights' FedAvg fold the
controller adds the cohort's deltas over the active learner count to
``c``. The uplink variants: an ``int8q`` uplink is dequantized and a
``topk`` one densified against the dispatched community model as it
lands; ``downlink_dtype`` narrows the dispatched blob (encoded once per
community model); under ``ship_tensor_regex`` the community model holds
only the federated subset from the seed on. The tasks carry both tensor
regexes.

Secure aggregation (``secure.enabled``, rule ``secure_agg``): uplinks are
opaque (CKKS ciphertexts, masked fixed-point words, or identity float64
bytes) and the community model stays opaque; :class:`SecureAgg` combines
them over the backend the caller passes (``secure_backend``), which holds
no decryption capability. Under ``scheme: masking`` a round whose cohort
misses registered mask parties asks one survivor for the dropped
parties' residual (``recover_masks``) and subtracts it; with
``aggregation.streaming`` masked uplinks fold on arrival as modular
uint64 sums (secure/distributed.py) and the barrier settles them
(secure/recovery.py).

Concurrency as in the JAX package: RPC threads only validate and enqueue;
one scheduling worker owns all round logic, so a completion ack never
waits on aggregation, and state needs one lock.

After ``termination.federation_rounds`` rounds (0 = no limit) the
controller dispatches no more train tasks and schedules no completion (a
task still in flight under the asynchronous protocols reports, and its
model is kept), so a run ends after that many community models under
every protocol; the last round's evaluations still go out.

Failover, as in the JAX package. ``checkpoint.dir`` turns on checkpoints
(:meth:`Controller.save_checkpoint`): the community model, the round
counter and lineage, the learner registry with its tokens and party
indices, FedRec's contribution scales, the server optimizers' and
FedNova's state, SCAFFOLD's ``c`` and the model registry, written at the
seed, at membership changes (coalesced on the scheduling worker) and
every ``every_n_rounds`` rounds. :meth:`restore_checkpoint` builds the
state back into a fresh controller, whose new ``controller_epoch`` tells
the learners to re-attach, and :meth:`resume_round` re-dispatches the
abandoned round. Under ``controller.standby`` the same state goes to the
round-state WAL (controller/wal.py) as snapshots, with each join and
leave appended before its ack, for the hot standby's
:meth:`restore_from_wal`. A completion of another incarnation's task is
kept but never advances a barrier, so a re-run round is the undisturbed
run's bits. A learner has one train task in flight: a dispatch to a
learner that has one (the re-dispatch of a rejoin while it trains)
supersedes it, and the superseded task's result is kept but counts for no
round (a deliberate divergence: the JAX controller folds it into the next
round). Checkpoints cross packages both ways.

The model registry (``registry.enabled``, registry/): each aggregated
round registers a candidate version; the round's community evaluation,
once every learner's digest landed, runs the promotion gate; the
controller serves the lineage (:meth:`describe_registry`,
:meth:`registered_model`) and the operator's :meth:`promote_version` and
:meth:`rollback_version`.

Not ported yet (ROADMAP.md Queue 1 item 4): the health plane (its
advisory scores, the round's ``health`` snapshot, which the registry's
gate reads as ``{}``, and the checkpoint's ``health`` and
``metrics_budget`` keys) and every telemetry plane (the secure plane's
fold, settlement and recovery metrics, the slice tier's, the WAL's and
the failover's among them).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
import random
import re
import resource
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple)

import numpy as np
import torch

from metisfl_tpu_torch.aggregation import DEVICE_RULES, make_aggregation_rule
from metisfl_tpu_torch.aggregation.distributed import DistributedSliceReducer
from metisfl_tpu_torch.aggregation.secure import SecureAgg
from metisfl_tpu_torch.aggregation.streaming import (
    StreamingAggregator,
    streaming_supported,
)
from metisfl_tpu_torch.aggregation.tree import TreeReducer
from metisfl_tpu_torch.comm.codec import dumps as codec_dumps
from metisfl_tpu_torch.comm.codec import loads as codec_loads
from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainTask,
)
from metisfl_tpu_torch.config import FederationConfig
from metisfl_tpu_torch.controller.wal import JOIN, LEAVE, RoundStateLog
from metisfl_tpu_torch.registry import CHANNEL_STABLE, ModelRegistry
from metisfl_tpu_torch.scaling import (
    apply_staleness_decay,
    make_scaler,
    raw_weight,
    staleness_factor,
)
from metisfl_tpu_torch.scheduling import (
    SemiSynchronousScheduler,
    make_scheduler,
)
from metisfl_tpu_torch.secure import recovery
from metisfl_tpu_torch.secure.distributed import MaskedStreamingAggregator
from metisfl_tpu_torch.selection import ChurnTracker, make_selector
from metisfl_tpu_torch.store import IngestPipeline, make_store
from metisfl_tpu_torch.store import durable as _durable
from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy
from metisfl_tpu_torch.tensor.quantize import SHIP_INT8Q, dequantize_named
from metisfl_tpu_torch.tensor.sparse import densify_named, parse_topk
from metisfl_tpu_torch.tensor.spec import (
    TensorKind,
    TensorSpec,
    narrow_named,
    quantify,
    resolve_ship_dtype,
)

# the rules whose community is a plain weighted sum (the tree tiers fold
# them slice by slice)
_WEIGHTED_SUM_RULES = ("fedavg", "scaffold", "fedstride")

logger = logging.getLogger("metisfl_tpu_torch.controller")

# the learners' dispatch-to-completion EWMAs (straggler analytics, carried
# through checkpoints)
_EWMA_ALPHA = 0.3

# RoundMetadata fields of the port alone: the JAX controller rebuilds its
# records with ``RoundMetadata(**m)``, so a checkpoint it can restore
# leaves them out
_PORT_ONLY_META = ("aggregation_device_ms", "community_pack_duration_ms",
                   "ingest_write_duration_ms", "ingest_drain_duration_ms",
                   "store_select_duration_ms")


def _ewma(prev: float, observation: float) -> float:
    """The first observation seeds the average; later ones blend in."""
    if prev <= 0.0:
        return observation
    return _EWMA_ALPHA * observation + (1.0 - _EWMA_ALPHA) * prev


def finite_metrics(metrics: Any) -> Dict[str, float]:
    """A learner-shipped metric mapping filtered down to finite floats
    (a zero-step task ships loss=NaN; nothing here may raise)."""
    if not isinstance(metrics, dict):
        return {}
    out: Dict[str, float] = {}
    for key, value in metrics.items():
        try:
            f = float(value)
        except (TypeError, ValueError):
            continue
        if math.isfinite(f):
            out[str(key)] = f
    return out


class LearnerProxy(Protocol):
    """Controller → learner transport for one registered learner."""

    def run_task(self, task: TrainTask) -> None:
        """Fire-and-forget local-training dispatch."""
        ...

    def evaluate(self, task: EvalTask,
                 callback: Callable[[EvalResult], None]) -> None:
        """Non-blocking evaluation; ``callback`` runs on completion."""
        ...


@dataclass
class LearnerRecord:
    learner_id: str
    auth_token: str
    hostname: str = "localhost"
    port: int = 0
    num_train_examples: int = 0
    num_val_examples: int = 0
    num_test_examples: int = 0
    # completed batches of the stored model's task (the batches scaler)
    # and the latest task's ms per step (the semi-synchronous budgets)
    completed_batches: int = 0
    ms_per_step: float = 0.0
    # consecutive failed train dispatches (reset on completion and rejoin)
    dispatch_failures: int = 0
    # the round the latest accepted contribution was dispatched from (its
    # staleness under the asynchronous protocols)
    last_result_round: int = -1
    # the semi-synchronous step budget (0: the config's local_steps)
    local_steps_override: int = 0
    # the masking party index it joined with (-1: not a masking party),
    # which maps its id to its mask streams in a settlement
    party_index: int = -1
    # EWMA dispatch-to-completion seconds of its train and eval tasks
    ewma_train_s: float = 0.0
    ewma_eval_s: float = 0.0
    proxy: Optional[LearnerProxy] = None


@dataclass
class RoundMetadata:
    """Per-round runtime record (the lineage ``get_statistics`` returns)."""

    global_iteration: int = 0
    started_at: float = 0.0
    completed_at: float = 0.0
    train_submitted_at: Dict[str, float] = field(default_factory=dict)
    train_received_at: Dict[str, float] = field(default_factory=dict)
    eval_submitted_at: Dict[str, float] = field(default_factory=dict)
    eval_received_at: Dict[str, float] = field(default_factory=dict)
    selected_learners: List[str] = field(default_factory=list)
    aggregation_block_sizes: List[int] = field(default_factory=list)
    aggregation_block_duration_ms: List[float] = field(default_factory=list)
    # select + fold + community blob encode
    aggregation_duration_ms: float = 0.0
    # the robust rules: where they combined, and their H2D, combine and
    # D2H times (aggregation/robust.py ``last_timing``)
    aggregation_device_ms: Dict[str, Any] = field(default_factory=dict)
    # of which the community blob encode
    community_pack_duration_ms: float = 0.0
    dispatch_duration_ms: float = 0.0
    # the contribution weights applied this round (after staleness damping)
    scales: Dict[str, float] = field(default_factory=dict)
    # per uplink, the rounds the community model advanced between its
    # task's dispatch and this aggregate (nonzero entries only)
    staleness: Dict[str, float] = field(default_factory=dict)
    # per uplink: blob parse + store insert (with parallel ingest: blob
    # parse + enqueue)
    model_insertion_duration_ms: Dict[str, float] = field(default_factory=dict)
    # parallel ingest: per uplink, the writer's store insert; the drain
    # fence before the select
    ingest_write_duration_ms: Dict[str, float] = field(default_factory=dict)
    ingest_drain_duration_ms: float = 0.0
    # the store selects of the round's blocks
    store_select_duration_ms: float = 0.0
    model_size: Dict[str, int] = field(default_factory=dict)
    uplink_bytes: Dict[str, int] = field(default_factory=dict)
    peak_rss_kb: int = 0
    train_metrics: Dict[str, Dict[str, float]] = field(default_factory=dict)
    epoch_metrics: Dict[str, List[Dict[str, float]]] = field(
        default_factory=dict)
    # the model registry: the version this round's aggregate registered
    # as, and the stable head at round close (0 with the registry off)
    registered_version: int = 0
    stable_version: int = 0
    errors: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Controller:
    """See module docstring. Lifecycle: learners ``join()`` → rounds run
    event-driven off ``task_completed()`` → ``shutdown()``."""

    # consecutive aggregation failures tolerated before halting re-dispatch
    _MAX_AGG_FAILURES = 10

    def __init__(self, config: FederationConfig,
                 proxy_factory: Callable[[LearnerRecord], LearnerProxy],
                 device: str = "cuda", secure_backend=None):
        self.config = config
        self._proxy_factory = proxy_factory
        self._lock = threading.RLock()
        self._learners: Dict[str, LearnerRecord] = {}
        self._tokens: Dict[str, str] = {}
        # incarnation id: rides in JoinReply and every task envelope
        self.controller_epoch = uuid.uuid4().hex

        agg = config.aggregation
        self.device = torch.device(device)
        if config.secure.enabled:
            if secure_backend is None:
                raise ValueError("secure aggregation enabled but no "
                                 "backend given")
            self._aggregator = SecureAgg(secure_backend)
        else:
            self._aggregator = self._make_rule(config)
        self._scaler = make_scaler(agg.scaler)
        self._selector = make_selector("scheduled_cardinality")
        sched_cfg = config.scheduling
        if config.protocol == "semi_synchronous":
            self._scheduler = make_scheduler(
                "semi_synchronous", lambda_=config.semi_sync_lambda,
                recompute_every_round=config.semi_sync_recompute_every_round,
                quorum=sched_cfg.quorum)
        elif config.protocol == "asynchronous_buffered":
            self._scheduler = make_scheduler(
                "asynchronous_buffered", buffer_size=sched_cfg.buffer_size)
        elif config.protocol == "synchronous":
            self._scheduler = make_scheduler("synchronous",
                                             quorum=sched_cfg.quorum)
        else:
            self._scheduler = make_scheduler(config.protocol)
        # the quorum barrier: 0 = the full-cohort barrier, and every quorum
        # path below is one attribute check
        self._quorum = (sched_cfg.quorum
                        if config.protocol in ("synchronous",
                                               "semi_synchronous") else 0)
        # churn-aware admission: None when opted out
        self._churn: Optional[ChurnTracker] = None
        if sched_cfg.churn_tracking:
            self._churn = ChurnTracker(
                alpha=sched_cfg.churn_alpha,
                quarantine_score=sched_cfg.quarantine_score,
                quarantine_s=sched_cfg.quarantine_s)
        required = self._aggregator.required_lineage
        store_cfg = config.model_store
        lineage = max(store_cfg.lineage_length or required, required)
        store_kwargs: Dict[str, Any] = {"lineage_length": lineage}
        if store_cfg.store in ("disk", "cached_disk"):
            store_kwargs["root"] = store_cfg.root or os.path.join(
                tempfile.gettempdir(), "metisfl_tpu_store")
        if store_cfg.store == "cached_disk":
            store_kwargs["cache_bytes"] = store_cfg.cache_mb << 20
        if store_cfg.store == "remote":
            store_kwargs["host"] = store_cfg.host
            store_kwargs["port"] = store_cfg.port
        self._store = make_store(store_cfg.store, **store_kwargs)
        # parallel ingest: completions enqueue, a bounded writer pool
        # persists, aggregation fences on drain; the worker re-checks
        # membership right before the write, so a queued write racing
        # leave() cannot land after the erase
        self._ingest: Optional[IngestPipeline] = None
        if store_cfg.ingest_workers > 0:
            self._ingest = IngestPipeline(
                self._store, store_cfg.ingest_workers,
                on_insert=self._note_ingest_insert, accept=self.is_member)
        # streaming: fold accepted uplinks on arrival for the weighted-sum
        # rules; what cannot stream falls back to the store path (secure
        # payloads stream through the masked stream below)
        self._streaming: Optional[StreamingAggregator] = None
        if agg.streaming and not config.secure.enabled:
            if streaming_supported(self._aggregator.name, config.protocol,
                                   config.secure.enabled, lineage,
                                   required,
                                   checkpointed=bool(config.checkpoint.dir),
                                   buffer_size=sched_cfg.buffer_size):
                self._streaming = StreamingAggregator(
                    self._aggregator, stride=agg.stride_length)
            else:
                logger.info(
                    "aggregation.streaming requested but rule=%s/"
                    "protocol=%s/lineage=%d does not support it; using the "
                    "store path", self._aggregator.name, config.protocol,
                    lineage)
        # the tree tier: O(branch) fan-in for the store path
        self._tree: Optional[TreeReducer] = None
        if agg.tree.enabled:
            self._tree = TreeReducer(branch=agg.tree.branch,
                                     workers=agg.tree.workers)
        # the distributed tier: the tree's branches as slice aggregator
        # processes; uplinks go to their slice over gRPC, the root folds
        # O(branch) partials. The in-process tree above stays built as the
        # fallback where the rule cannot slice-fold.
        self._slices: Optional[DistributedSliceReducer] = None
        masked_tier = (config.secure.enabled
                       and config.secure.scheme == "masking")
        if agg.tree.distributed and agg.tree.slices:
            if (self._aggregator.name in _WEIGHTED_SUM_RULES
                    and not config.secure.enabled) or masked_tier:
                # masked mode: slices fold the raw masked blobs as modular
                # uint64 sums (key-free; the masks cancel at the root's
                # settlement), on arrival under streaming
                self._slices = DistributedSliceReducer(
                    agg.tree, ssl=config.ssl, comm=config.comm,
                    masked=masked_tier,
                    stream=masked_tier and agg.streaming)
            else:
                logger.info(
                    "aggregation.tree.distributed requested but rule=%s "
                    "cannot slice-fold; using the in-process path",
                    self._aggregator.name)
        # masked streaming: under scheme: masking with streaming and no
        # slice tier the controller folds masked uplinks on arrival as
        # modular sums (with slices, they fold at the slices)
        self._masked_stream: Optional[MaskedStreamingAggregator] = None
        if masked_tier and agg.streaming and self._slices is None:
            self._masked_stream = MaskedStreamingAggregator()
        # SCAFFOLD: the server control variate c (name -> f32 array), its
        # wire bytes (encoded once per c) and the cohort's latest
        # unconsumed control deltas (learner_id -> blob)
        self._scaffold_c: Optional[Dict[str, np.ndarray]] = None
        self._scaffold_c_blob: Optional[bytes] = None
        self._scaffold_deltas: Dict[str, bytes] = {}
        # the community model as host arrays (top-k uplinks densify
        # against it) and the narrowed downlink of one community blob,
        # (full-width blob, narrowed bytes)
        self._community_flat: Optional[Dict[str, np.ndarray]] = None
        self._downlink_cache: Optional[Tuple[bytes, bytes]] = None

        # the community model's wire bytes
        self._community_blob: Optional[bytes] = None
        self.global_iteration = 0
        self.round_metadata: List[RoundMetadata] = []
        self.community_evaluations: List[Dict[str, Any]] = []
        self._current_meta = RoundMetadata(global_iteration=0)

        # single-worker pool serializes all scheduling/aggregation work
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ctrl-sched")
        self._shutdown = threading.Event()
        self._agg_failures = 0
        # train tasks dispatched and not yet reported (task_id ->
        # learner_id), and the expired ones whose late uplinks are stored
        # but never advance a barrier (a bounded ordered set)
        self._tasks_in_flight: Dict[str, str] = {}
        self._expired_tasks: Dict[str, None] = {}
        # task_id -> dispatch time, in step with the two maps above (the
        # train EWMAs)
        self._task_dispatched_at: Dict[str, float] = {}
        # each fresh round's dispatch bumps the serial, so a deadline or
        # retry timer of a closed round never acts on the next one
        self._round_serial = 0
        self._deadline_timer: Optional[threading.Timer] = None
        # consecutive round deadlines with no reporter; the halt they
        # trigger lifts when an uplink arrives
        self._empty_deadlines = 0
        self._halted_no_reporters = False
        # dispatch retries used this round, and their live backoff timers
        self._dispatch_retries_used = 0
        self._retry_timers: Dict[threading.Timer, None] = {}
        # no checkpoint while a restore replays the community model through
        # set_community_model; one queued save covers a burst of requests
        self._in_restore = False
        self._ckpt_queued = False
        # the hot standby's round-state WAL: registry deltas land on the
        # join/leave path before the ack, snapshots ride the coalesced save
        # with the checkpoint; None without a standby
        self._wal = None
        standby = config.controller.standby
        if standby.enabled and standby.wal_dir:
            self._wal = RoundStateLog(standby.wal_dir)
        # the model registry; None when off (the round close is then one
        # attribute check)
        self._registry = None
        if config.registry.enabled:
            self._registry = ModelRegistry(
                config.registry, config_hash=hashlib.sha256(
                    config.to_wire()).hexdigest()[:16])

    def _make_rule(self, config: FederationConfig):
        """The configured rule with its hyperparameters; the robust rules
        run on the controller's device, which must exist."""
        agg = config.aggregation
        rule = agg.rule.lower()
        kwargs: Dict[str, Any] = {}
        if rule in ("fedavgm", "fedadam", "fedyogi"):
            kwargs = dict(learning_rate=agg.server_learning_rate,
                          beta1=agg.server_beta1, beta2=agg.server_beta2,
                          tau=agg.server_tau)
        elif rule == "trimmed_mean":
            kwargs = dict(trim_ratio=agg.trim_ratio)
        elif rule in ("krum", "multikrum"):
            kwargs = dict(byzantine_f=agg.byzantine_f)
        if rule in DEVICE_RULES:
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"the {rule} rule combines on the controller's device "
                    f"{self.device}, and no CUDA device is available; pass "
                    "device='cpu' (--device cpu) to combine on the CPU")
            kwargs["device"] = self.device
        return make_aggregation_rule(rule, **kwargs)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            if self._deadline_timer is not None:
                self._deadline_timer.cancel()
            for timer in list(self._retry_timers):
                timer.cancel()
            self._retry_timers.clear()
        self._pool.shutdown(wait=True)
        # a round task that was draining on the pool may have armed a timer
        # between the cancel above and the flag reaching it: no timer
        # outlives shutdown
        with self._lock:
            if self._deadline_timer is not None:
                self._deadline_timer.cancel()
            for timer in list(self._retry_timers):
                timer.cancel()
            self._retry_timers.clear()
        # ingest workers write INTO the store: stop them (bounded drain)
        # before the store's own shutdown
        if self._ingest is not None:
            self._ingest.shutdown()
        if self._tree is not None:
            self._tree.shutdown()
        if self._slices is not None:
            # the clients close; DriverSession owns the processes
            self._slices.shutdown()
        if self._registry is not None:
            self._registry.shutdown()
        self._store.shutdown()

    # ------------------------------------------------------------------ #
    # membership (RPC thread)
    # ------------------------------------------------------------------ #

    def join(self, request: JoinRequest) -> JoinReply:
        """Register (or re-register) a learner; schedules its first task
        off the join path. A rejoin presents its previous id and token; a
        credential-less join from an endpoint already registered is the
        same learner reincarnated, and keeps its id with a new token."""
        with self._lock:
            record = None
            token = ""
            if (request.previous_id and request.previous_id in self._learners
                    and self._tokens.get(request.previous_id)
                    == request.auth_token):
                record = self._learners[request.previous_id]
                record.hostname, record.port = request.hostname, request.port
                token = record.auth_token
            elif request.port:
                record = next(
                    (r for r in self._learners.values()
                     if r.hostname == request.hostname
                     and r.port == request.port), None)
                if record is not None:
                    token = uuid.uuid4().hex
                    record.auth_token = token
                    self._tokens[record.learner_id] = token
                    record.num_train_examples = request.num_train_examples
                    record.num_val_examples = request.num_val_examples
                    record.num_test_examples = request.num_test_examples
            if record is not None:
                record.party_index = int(request.capabilities.get(
                    "party_index", record.party_index))
                # a fresh endpoint: assume it is live
                record.dispatch_failures = 0
            rejoined = record is not None
            if record is None:
                learner_id = (f"L{len(self._tokens)}_{request.hostname}_"
                              f"{request.port}")
                token = uuid.uuid4().hex
                record = LearnerRecord(
                    learner_id=learner_id, auth_token=token,
                    hostname=request.hostname, port=request.port,
                    num_train_examples=request.num_train_examples,
                    num_val_examples=request.num_val_examples,
                    num_test_examples=request.num_test_examples,
                    party_index=int(request.capabilities.get(
                        "party_index", -1)))
                self._learners[learner_id] = record
                self._tokens[learner_id] = token
            record.proxy = self._proxy_factory(record)
        logger.info("learner %s %s (%d train examples)", record.learner_id,
                    "rejoined" if rejoined else "joined",
                    record.num_train_examples)
        if rejoined:
            self._note_churn(record.learner_id, "flap_rejoin")
        if not self._shutdown.is_set():
            self._pool.submit(self._guard, self._schedule_initial,
                              record.learner_id)
        # a controller crash before the next checkpoint must not forget
        # this learner's identity and token
        self._wal_join(record)
        self._checkpoint_async()
        return JoinReply(learner_id=record.learner_id, auth_token=token,
                         rejoined=rejoined,
                         controller_epoch=self.controller_epoch)

    def leave(self, learner_id: str, auth_token: str) -> bool:
        """Drop a learner's registry entry and its stored models."""
        with self._lock:
            record = self._learners.get(learner_id)
            if record is None or record.auth_token != auth_token:
                return False
            del self._learners[learner_id]
            # its tasks can never complete
            for tid in [t for t, lid in self._tasks_in_flight.items()
                        if lid == learner_id]:
                del self._tasks_in_flight[tid]
                self._task_dispatched_at.pop(tid, None)
        # the standby forgets it too, before the ack: a promoted registry
        # resurrecting a departed learner would ghost the barrier
        self._wal_leave(learner_id)
        # drain the departing learner's queued writes BEFORE the erase: a
        # write landing after it would resurrect the lineage
        if (self._ingest is not None
                and not self._ingest.drain(learner_id, timeout=30.0)):
            # a wedged writer: erase anyway; the worker's membership gate
            # drops the queued write
            logger.error("ingest drain for departing %s timed out; its "
                         "queued writes will be gate-dropped", learner_id)
        self._store.erase([learner_id])
        if self._slices is not None:
            # prune its held model from every live slice and the root's
            # residual buffer
            self._slices.forget(learner_id)
        if self._streaming is not None and not self._shutdown.is_set():
            # subtract its streamed contribution on the scheduling worker
            # (the fold state is single-threaded)
            self._pool.submit(self._guard, self._streaming.forget,
                              learner_id)
        logger.info("learner %s left", learner_id)
        # churn memory survives the leave: a flapper's history is the signal
        self._note_churn(learner_id, "leave")
        # the departed learner may have been the last one the barrier
        # waited on: no later completion would re-check it
        if not self._shutdown.is_set():
            self._pool.submit(self._guard, self._handle_membership_change)
        return True

    def _note_churn(self, learner_id: str, event: str) -> None:
        """Fold one membership event into the learner's churn score; logs
        a quarantine when the score newly crosses the threshold. One
        attribute check when churn tracking is off."""
        if self._churn is None:
            return
        was_quarantined = self._churn.quarantined(learner_id)
        score = self._churn.note(learner_id, event)
        if not was_quarantined and self._churn.quarantined(learner_id):
            logger.warning(
                "learner %s quarantined for %.1fs (churn score %.2f >= "
                "%.2f after %s)", learner_id, self._churn.quarantine_s,
                score, self._churn.quarantine_score, event)

    def active_learners(self) -> List[str]:
        with self._lock:
            return list(self._learners.keys())

    def is_member(self, learner_id: str) -> bool:
        with self._lock:
            return learner_id in self._learners

    def learner_endpoints(self) -> List[Dict[str, Any]]:
        """Registered endpoints with the ports learners reported on join."""
        with self._lock:
            return [{"learner_id": r.learner_id, "hostname": r.hostname,
                     "port": r.port} for r in self._learners.values()]

    # ------------------------------------------------------------------ #
    # community model
    # ------------------------------------------------------------------ #

    def set_community_model(self, blob_bytes: bytes) -> None:
        """Seed (or overwrite) the community model from wire bytes (a secure
        federation's may be opaque). Under ``ship_tensor_regex`` the
        controller keeps only the federated subset from the seed on, so
        round 1's dispatch is already subset-sized."""
        blob = ModelBlob.from_bytes(blob_bytes)
        ship_regex = self.config.train.ship_tensor_regex
        if ship_regex and blob.tensors:
            subset = [(n, t) for n, t in blob.tensors
                      if re.search(ship_regex, n)]
            if not subset:
                raise ValueError(
                    f"ship_tensor_regex {ship_regex!r} matches no tensor "
                    "in the seeded model: nothing would ever federate")
            if len(subset) != len(blob.tensors):
                blob = ModelBlob(tensors=subset)
                blob_bytes = blob.to_bytes()
        with self._lock:
            self._community_blob = bytes(blob_bytes)
            if blob.tensors:
                self._community_flat = {name: to_numpy(t)
                                        for name, t in blob.tensors}
                if hasattr(self._aggregator, "seed_community"):
                    # FedNova and the server optimizers step from the
                    # seeded model (a replacement mid-run re-anchors them)
                    self._aggregator.seed_community(self._community_flat)
        # the per-round checkpoint starts after round 1: a crash during it
        # must still restore a model to train from
        self._checkpoint_async()

    def _wal_join(self, record: LearnerRecord) -> None:
        """Append the learner's registry entry to the WAL on the join path,
        before the JoinReply: a learner the primary acked exists in a
        promoted standby as itself (same id, token, party index). A failed
        append is logged, not raised: a disk hiccup must not refuse the
        join."""
        if self._wal is None:
            return
        try:
            self._wal.append(JOIN, self._learner_entry(record))
        except Exception:  # noqa: BLE001 - best-effort durability
            logger.exception("WAL join append for %s failed",
                             record.learner_id)

    def _wal_leave(self, learner_id: str) -> None:
        """Append a leave delta before the leave ack (see _wal_join)."""
        if self._wal is None:
            return
        try:
            self._wal.append(LEAVE, {"learner_id": learner_id})
        except Exception:  # noqa: BLE001 - best-effort durability
            logger.exception("WAL leave append for %s failed", learner_id)

    def _checkpoint_async(self) -> None:
        """Queue a round-state save on the scheduling worker (off the RPC
        path, ordered with the round logic): the checkpoint file under
        ``checkpoint.dir`` and a WAL snapshot under a standby, from one
        state capture. While a save is queued further requests are no-ops:
        the queued save captures the state when it runs. Nothing happens
        with neither sink armed, during a restore or after shutdown."""
        if ((not self.config.checkpoint.dir and self._wal is None)
                or self._in_restore or self._shutdown.is_set()):
            return
        with self._lock:
            if self._ckpt_queued:
                return
            self._ckpt_queued = True

        def _save():
            with self._lock:
                self._ckpt_queued = False
            try:
                state = self._checkpoint_state()
                if self.config.checkpoint.dir:
                    self.save_checkpoint(state=state)
                if self._wal is not None:
                    self._wal.snapshot(state)
            except Exception:  # noqa: BLE001 - best-effort durability
                logger.exception("round-state save failed")

        try:
            self._pool.submit(self._guard, _save)
        except RuntimeError:  # the pool is shut down
            with self._lock:
                self._ckpt_queued = False

    def community_model_bytes(self) -> Optional[bytes]:
        with self._lock:
            return self._community_blob

    def resume_round(self) -> bool:
        """Dispatch a fresh round to a sampled cohort: the restored cohort
        after a checkpoint or WAL restore (the crash abandoned the round
        in flight; its tasks carry the dead epoch, and their completions,
        if any arrive, are kept but fold into no barrier), or a controller
        seeded after its learners joined (the cross-device harness starts
        its first sampled round so). False when there is no community
        model or no learner; rejoining learners then start rounds through
        their own first dispatch."""
        with self._lock:
            ready = (self._community_blob is not None
                     and bool(self._learners))
        if not ready or self._shutdown.is_set():
            return False
        self._pool.submit(self._guard, self._resume_dispatch)
        return True

    def _resume_dispatch(self) -> None:
        if self._shutdown.is_set():
            return
        self._scheduler.reset()
        cohort = self._sample_cohort()
        if cohort:
            logger.info("resuming round %d: dispatching to %s",
                        self.global_iteration, cohort)
            self._dispatch_train(cohort)

    # ------------------------------------------------------------------ #
    # task completion (RPC thread → scheduling worker)
    # ------------------------------------------------------------------ #

    def task_completed(self, result: TaskResult) -> bool:
        """Validate the (learner_id, auth_token) pair and enqueue; returns
        the ack. The heavy work runs on the scheduling worker."""
        if self._shutdown.is_set():
            return False
        with self._lock:
            record = self._learners.get(result.learner_id)
            if record is None:
                logger.warning("completion from unknown learner %s",
                               result.learner_id)
                return False
            if record.auth_token != result.auth_token:
                logger.warning("completion from %s with bad auth token",
                               result.learner_id)
                return False
        self._pool.submit(self._guard, self._handle_completed, result)
        return True

    def _guard(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:  # logged, never kills the pool
            logger.exception("controller executor task failed")

    def _schedule_initial(self, learner_id: str) -> None:
        if self._shutdown.is_set():
            return
        with self._lock:
            if learner_id not in self._learners:
                return
        self._dispatch_train([learner_id], fresh_round=False)

    def _handle_completed(self, result: TaskResult) -> None:
        start = time.time()
        with self._lock:
            record = self._learners.get(result.learner_id)
            if record is None:
                return
            record.dispatch_failures = 0  # provably reachable
            if result.processing_ms_per_step > 0:
                record.ms_per_step = result.processing_ms_per_step
            self._tasks_in_flight.pop(result.task_id, None)
            dispatched_at = self._task_dispatched_at.pop(result.task_id, 0.0)
            if dispatched_at:
                # an expired task's late arrival counts too: a straggler's
                # is the observation the score needs
                record.ewma_train_s = _ewma(record.ewma_train_s,
                                            max(0.0, start - dispatched_at))
            # a completion of a task that a deadline or a quorum expired,
            # or that another controller incarnation dispatched: its model
            # is kept (fresh lineage for later rounds) but it advances no
            # barrier and stays out of this round's metadata
            stale = (result.task_id in self._expired_tasks
                     or bool(result.controller_epoch
                             and result.controller_epoch
                             != self.controller_epoch))
            self._expired_tasks.pop(result.task_id, None)
            if not stale:
                self._current_meta.train_received_at[result.learner_id] = \
                    start
                self._current_meta.uplink_bytes[result.learner_id] = len(
                    result.model)
            if result.control_delta:
                self._scaffold_deltas[result.learner_id] = \
                    result.control_delta
        # a delivered uplink is the churn score's decay tick
        self._note_churn(result.learner_id, "completion")
        if stale and parse_topk(self.config.train.ship_dtype) is not None:
            # a top-k payload is a delta against the community model at its
            # dispatch, which has since moved: it cannot be rebuilt
            logger.info("late topk completion from %s for expired task %s "
                        "dropped (its reference model advanced)",
                        result.learner_id, result.task_id)
            return
        blob = None
        try:
            blob = ModelBlob.from_bytes(result.model)
            model = self._parse_result_model(result, blob)
        except ValueError as exc:
            # a malformed payload costs its own contribution, not the round
            logger.warning("dropping malformed result from %s for task %s: "
                           "%s", result.learner_id, result.task_id, exc)
            with self._lock:
                self._current_meta.errors.append(
                    f"malformed result from {result.learner_id}: {exc}")
            model = None
        deferred_meta = False
        if model is not None and self._masked_stream is not None:
            # masked streaming: the raw masked blob folds on arrival as a
            # modular uint64 sum; a stale uplink or one of another round
            # carries dead masks (streams are round-keyed) and never enters
            # the sum
            folded = False
            if blob.opaque and not stale:
                try:
                    folded = self._masked_stream.fold(
                        result.learner_id, dict(blob.opaque),
                        result.round_id)
                except ValueError as exc:
                    logger.warning("unfoldable masked uplink from %s: %s",
                                   result.learner_id, exc)
            if not folded:
                logger.info("masked uplink from %s dropped (stale, another "
                            "round's or malformed)", result.learner_id)
                model = None
        elif model is not None and self._streaming is not None:
            # streaming: the accepted uplink folds straight into the
            # community accumulator, no store round trip
            if not self._stream_fold(result, model, stale):
                model = None
        elif model is not None and self._slices is not None:
            # the distributed tier: the uplink goes to its slice aggregator
            # (the root never stores it); submit never drops an accepted
            # uplink: a dead owner re-homes, the last resort is the root's
            # residual buffer
            self._slices.submit(result.learner_id, model, result.round_id)
        elif model is not None and self._ingest is not None:
            # enqueue and go on: the writer records the write's own time
            # (_note_ingest_insert) and applies the result's metadata only
            # when the write lands (_ingest_landed); aggregation fences on
            # the drain before its select
            self._ingest.submit(result.learner_id, model,
                                on_success=partial(self._ingest_landed,
                                                   result))
            deferred_meta = True
        elif model is not None:
            self._store.insert(result.learner_id, model)
        if model is not None and not deferred_meta:
            # the step count and the round pair with the stored (or
            # streamed) model
            with self._lock:
                record.completed_batches = result.completed_batches
                record.last_result_round = result.round_id
        if not stale:
            with self._lock:
                meta = self._current_meta
                meta.model_insertion_duration_ms[result.learner_id] = (
                    (time.time() - start) * 1e3)
                finite = finite_metrics(result.train_metrics)
                if finite:
                    meta.train_metrics[result.learner_id] = finite
                if isinstance(result.epoch_metrics, (list, tuple)):
                    meta.epoch_metrics[result.learner_id] = [
                        finite_metrics(epoch)
                        for epoch in result.epoch_metrics]
        if self._halted_no_reporters:
            # the no-reporter halt lifts on evidence of life: a delivered
            # uplink (stale or not: the halt expired every task)
            self._halted_no_reporters = False
            self._empty_deadlines = 0
            logger.warning("completion from %s after the no-reporter halt; "
                           "resuming dispatch", result.learner_id)
            self._scheduler.reset()
            self._abandon_streams()
            self._dispatch_train(self._sample_cohort())
            return
        if stale:
            logger.info("late completion from %s for expired task %s kept "
                        "but not scheduled", result.learner_id,
                        result.task_id)
            return
        limit = self.config.termination.federation_rounds
        if 0 < limit <= self.global_iteration:
            # the run is over: under the asynchronous protocols a task in
            # flight at the last community still reports; it is kept, and
            # no community past the limit is made
            logger.info("completion from %s after the last round kept but "
                        "not scheduled", result.learner_id)
            return
        to_schedule = self._scheduler.schedule_next(
            result.learner_id, self.active_learners())
        if not to_schedule:
            if getattr(self._scheduler, "redispatch_on_completion", False):
                # buffered async: the reporter trains on against the
                # current community model while the buffer fills
                self._dispatch_train([result.learner_id], fresh_round=False)
            return
        if self._quorum > 0:
            # quorum release: the tasks still in flight belong to the round
            # that just closed
            self._expire_unreported(to_schedule)
        self._complete_round(to_schedule)

    def _ingest_landed(self, result: TaskResult, ms: float) -> None:
        """Ingest-write success hook (on the writer, strictly before the
        drain fence covering the write returns): pair the result's step
        count with the NOW-stored model. A failed write never gets here,
        so the older stored model keeps its older metadata."""
        with self._lock:
            record = self._learners.get(result.learner_id)
            if record is not None:
                record.completed_batches = result.completed_batches
                record.last_result_round = result.round_id

    def _note_ingest_insert(self, learner_id: str, ms: float) -> None:
        """The writer's own insert time, recorded against the round the
        write lands in."""
        with self._lock:
            if learner_id in self._learners:
                self._current_meta.ingest_write_duration_ms[learner_id] = ms

    def _handle_membership_change(self) -> None:
        active = self.active_learners()
        if not active or self._shutdown.is_set():
            return
        cohort = self._scheduler.handle_leave(active)
        if cohort:
            if self._quorum > 0:
                self._expire_unreported(cohort)
            self._complete_round(cohort)
        elif self._scheduler.round_stalled(active):
            # every dispatched learner departed: abandon the round and
            # dispatch a fresh sample to the survivors
            logger.info("round abandoned (dispatched cohort left); "
                        "re-dispatching")
            self._scheduler.reset()
            self._abandon_streams()
            self._dispatch_train(self._sample_cohort())

    def _expire_tasks_locked(self, pending: Dict[str, str]) -> None:
        """Move ``pending`` (task_id -> learner_id) to the bounded expired
        set: one definition for the quorum and deadline triggers. Call with
        ``self._lock`` held."""
        for tid in pending:
            self._tasks_in_flight.pop(tid, None)
        self._expired_tasks.update(dict.fromkeys(pending))
        while len(self._expired_tasks) > 512:
            self._expired_tasks.pop(next(iter(self._expired_tasks)))
        keep = set(self._tasks_in_flight) | set(self._expired_tasks)
        self._task_dispatched_at = {
            tid: t for tid, t in self._task_dispatched_at.items()
            if tid in keep}

    def _expire_unreported(self, cohort: Sequence[str]) -> None:
        """Quorum release: every task still in flight to a learner outside
        the releasing cohort belongs to the round that just closed; expire
        it, so the straggler's late uplink is kept but never advances the
        next round's barrier."""
        cohort_set = set(cohort)
        with self._lock:
            pending = {tid: lid for tid, lid in self._tasks_in_flight.items()
                       if lid not in cohort_set}
            if not pending:
                return
            self._expire_tasks_locked(pending)
        logger.info("quorum reached: expiring %d straggler task(s) from %s",
                    len(pending), sorted(set(pending.values())))

    # -- round deadline ---------------------------------------------------

    def _arm_round_deadline(self, restart: bool = True) -> None:
        """Start (or restart) the round's straggler timer after a dispatch
        (the synchronous, semi-synchronous and buffered protocols).
        ``restart=False`` (a single learner's dispatch) arms only where no
        timer is live, so a learner rejoining inside the window cannot
        postpone the deadline."""
        deadline = self.config.round_deadline_secs
        if deadline <= 0 or self._scheduler.name == "asynchronous":
            return
        with self._lock:
            # shutdown() cancels the live timer under this lock: no timer
            # is armed after it
            if self._shutdown.is_set():
                return
            if (not restart and self._deadline_timer is not None
                    and self._deadline_timer.is_alive()):
                return
            serial = self._round_serial
            if self._deadline_timer is not None:
                self._deadline_timer.cancel()

            def _fire():
                if self._shutdown.is_set():
                    return
                try:
                    self._pool.submit(self._guard, self._handle_deadline,
                                      serial)
                except RuntimeError:  # the pool is shut down
                    pass

            timer = threading.Timer(deadline, _fire)
            timer.daemon = True
            self._deadline_timer = timer
            timer.start()

    def _handle_deadline(self, serial: int) -> None:
        """The round's deadline passed: expire the unreported tasks and go
        on with whoever reported, or re-dispatch if nobody did (halting
        after ``scheduling.max_empty_redispatch`` such deadlines)."""
        if self._shutdown.is_set():
            return
        with self._lock:
            if serial != self._round_serial:
                return  # the round already completed
            pending = dict(self._tasks_in_flight)
            self._expire_tasks_locked(pending)
        cohort = self._scheduler.expire_pending(self.active_learners())
        dropped = sorted(set(pending.values()))
        if cohort:
            logger.warning(
                "round deadline (%.1fs) expired; aggregating %d reporter(s), "
                "dropping stragglers %s", self.config.round_deadline_secs,
                len(cohort), dropped)
            # under masking the partial cohort settles through the dropout
            # recovery; where it cannot, aggregation fails and the round is
            # re-dispatched
            self._complete_round(cohort)
            if (getattr(self._scheduler, "redispatch_on_completion", False)
                    and dropped and not self._shutdown.is_set()):
                # buffered async: the expired learners would idle for the
                # rest of the run
                revive = self._idle_reporters(dropped)
                if revive:
                    self._dispatch_train(revive, fresh_round=False)
            return
        self._empty_deadlines += 1
        limit = self.config.scheduling.max_empty_redispatch
        if limit > 0 and self._empty_deadlines >= limit:
            # nobody reported for `limit` deadline windows in a row: halt
            # instead of re-dispatching forever; a delivered uplink resumes
            # dispatch (_handle_completed)
            reason = (f"{self._empty_deadlines} consecutive round "
                      f"deadlines expired with no reporters "
                      f"(last dropped: {dropped})")
            logger.error("halting re-dispatch: %s", reason)
            self._halted_no_reporters = True
            with self._lock:
                self._current_meta.errors.append(f"round halted: {reason}")
            return
        logger.warning(
            "round deadline (%.1fs) expired with no reporters (%s); "
            "re-dispatching (%d/%s)", self.config.round_deadline_secs,
            dropped, self._empty_deadlines, limit or "unbounded")
        self._abandon_streams()
        self._dispatch_train(self._sample_cohort())

    def _abandon_streams(self) -> None:
        """Drop the round's streamed fold state (an abandoned or failed
        round re-dispatches clean; FedRec's rolling state stays)."""
        if self._streaming is not None:
            self._streaming.abandon()
        if self._masked_stream is not None:
            self._masked_stream.abandon()

    def _parse_result_model(self, result: TaskResult, blob: ModelBlob):
        """An uplink (``blob`` parsed from its wire bytes) → flat ``{name:
        np.ndarray}`` (host numpy: the store and the fold stay on the
        host); under secure aggregation an opaque uplink stays its wire
        bytes."""
        if self.config.secure.enabled and blob.opaque:
            return result.model
        tensors = {name: to_numpy(t) for name, t in blob.tensors}
        # the uplink encodings, gated on the config (never sniffed from the
        # payload, so a tensor that happens to carry a companion suffix is
        # never mangled)
        ship = self.config.train.ship_dtype
        if ship.lower() == SHIP_INT8Q:
            tensors = dequantize_named(tensors)
        elif parse_topk(ship) is not None:
            # dense = the dispatched community model + the scattered
            # update: under the synchronous protocol the community model
            # has not moved since the task's dispatch
            with self._lock:
                community = dict(self._community_flat or {})
            tensors = densify_named(tensors, community)
        return tensors

    def _stream_fold(self, result: TaskResult, model, stale: bool) -> bool:
        """Fold one accepted uplink into the streaming accumulator with
        its raw weight (the cohort's normalizer is unknown until barrier
        release; ``finish`` divides by Σw), damped by its staleness under
        ``staleness_decay``. Returns False when nothing was accepted (a
        stale uplink on a round-scoped rule: the stream keeps no store to
        park it in; a payload that is not a tensor tree)."""
        if stale and self._streaming.rule_name != "fedrec":
            # fedavg and fedstride sums are round-scoped, and the round
            # this model belongs to was closed (FedRec wants the newest)
            logger.info("late completion from %s dropped (the streaming "
                        "path keeps no store lineage)", result.learner_id)
            return False
        if not isinstance(model, dict) or not model:
            return False
        with self._lock:
            record = self._learners.get(result.learner_id)
            if record is None:
                return False
            entry = {"num_train_examples": record.num_train_examples,
                     "completed_batches": result.completed_batches}
        weight = raw_weight(self.config.aggregation.scaler, entry)
        if weight <= 0.0:
            # the batch scalers would give it scale 0: accept, fold nothing
            return True
        decay = self.config.aggregation.staleness_decay
        if decay > 0.0:
            # the dispatch-version lag, damped as the store path damps it
            staleness = max(0, self.global_iteration - result.round_id)
            weight *= staleness_factor(staleness, decay)
        self._streaming.fold(result.learner_id, model, weight)
        return True

    # ------------------------------------------------------------------ #
    # round close
    # ------------------------------------------------------------------ #

    def _complete_round(self, cohort: Sequence[str]) -> None:
        """Select, aggregate, record metadata, evaluate, re-dispatch. An
        aggregation failure is recorded and the round re-dispatched (after
        ``_MAX_AGG_FAILURES`` in a row, dispatch halts)."""
        selected = self._selector.select(cohort, self.active_learners())
        try:
            self._compute_community_model(selected)
        except Exception as exc:
            self._agg_failures += 1
            # the retry starts from a clean round
            self._abandon_streams()
            with self._lock:
                self._current_meta.errors.append(
                    f"aggregation failed: {exc!r}")
            if self._agg_failures >= self._MAX_AGG_FAILURES:
                logger.error("aggregation failed %d consecutive times (%r); "
                             "halting re-dispatch", self._agg_failures, exc)
                return
            logger.warning("aggregation failed (%r); re-dispatching", exc)
            if self._shutdown.is_set():
                return
            if self._scheduler.name.startswith("asynchronous"):
                # the reporters would wait forever for a round that aborted
                self._dispatch_train(self._idle_reporters(cohort))
            else:
                self._scheduler.reset()
                self._dispatch_train(self._sample_cohort())
            return
        self._agg_failures = 0
        self._empty_deadlines = 0
        if self._slices is not None:
            # the root's residual buffer is folded; the slices keep their
            # latest model per learner, as the store keeps lineage
            self._slices.round_complete()
        self._register_round_version()
        self._send_eval_tasks()
        with self._lock:
            self.global_iteration += 1
            self._current_meta.completed_at = time.time()
            self._current_meta.peak_rss_kb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
            self.round_metadata.append(self._current_meta)
            self._current_meta = RoundMetadata(
                global_iteration=self.global_iteration)
        ckpt = self.config.checkpoint
        if ckpt.dir and self.global_iteration % max(
                1, ckpt.every_n_rounds) == 0:
            try:
                self.save_checkpoint()
            except Exception:  # noqa: BLE001 - the round goes on
                logger.exception("checkpoint save failed")
        self._maybe_recompute_semisync()
        if self._shutdown.is_set():
            return
        if self._scheduler.name.startswith("asynchronous"):
            # async: re-dispatch the reporters that are idle (the buffered
            # protocol re-dispatched most of them as they uplinked)
            next_ids = self._idle_reporters(cohort)
        else:
            next_ids = self._sample_cohort()
        self._dispatch_train(next_ids)

    def _idle_reporters(self, cohort: Sequence[str]) -> List[str]:
        """The cohort's active members without a task in flight: the only
        ones an asynchronous re-dispatch may target."""
        active = set(self.active_learners())
        with self._lock:
            busy = set(self._tasks_in_flight.values())
        return [lid for lid in cohort if lid in active and lid not in busy]

    def _admission_pool(self) -> List[str]:
        """Dispatchable learners: active, under ``max_dispatch_failures``
        consecutive failed dispatches, and not quarantined. It never
        empties: where every learner looks dead, it keeps them all; where
        every one is quarantined, it keeps the pool."""
        limit = self.config.max_dispatch_failures
        with self._lock:
            pool = [lid for lid, r in self._learners.items()
                    if limit <= 0 or r.dispatch_failures < limit]
            if not pool:
                pool = list(self._learners.keys())
        if self._churn is not None:
            quarantined = set(self._churn.quarantined_ids())
            if quarantined:
                healthy = [lid for lid in pool if lid not in quarantined]
                if healthy:
                    pool = healthy
        return pool

    def _sample_cohort(self) -> List[str]:
        """Next round's participants from the admission pool: with a quorum
        ``ceil(quorum * (1 + overprovision))`` of them (the expected
        dropout still leaves a quorum), else ``participation_ratio`` of
        them. The barrier is the dispatched sample."""
        pool = self._admission_pool()
        if self._quorum > 0:
            k = math.ceil(self._quorum
                          * (1.0 + self.config.scheduling.overprovision))
            k = max(1, min(len(pool), k))
            if k >= len(pool):
                return pool
            return random.sample(pool, k)
        ratio = self.config.aggregation.participation_ratio
        if ratio >= 1.0 or not pool:
            return pool
        k = max(1, int(round(ratio * len(pool))))
        return random.sample(pool, k)

    def _maybe_recompute_semisync(self) -> None:
        """Semi-synchronous: the next rounds' per-learner step budgets from
        the learners' recorded ms per step."""
        if not isinstance(self._scheduler, SemiSynchronousScheduler):
            return
        batch = self.config.train.batch_size
        with self._lock:
            timings = {
                lid: {
                    "ms_per_step": r.ms_per_step,
                    "steps_per_epoch": max(
                        1.0, r.num_train_examples / max(1, batch)),
                }
                for lid, r in self._learners.items()
            }
        overrides = self._scheduler.recompute_steps(timings)
        if not overrides:
            return
        with self._lock:
            for lid, steps in overrides.items():
                if lid in self._learners:
                    self._learners[lid].local_steps_override = steps
        logger.info("semi-sync step budgets: %s", overrides)

    # -- aggregation ------------------------------------------------------

    def _scaling_metadata(self, selected: Sequence[str]
                          ) -> Dict[str, Dict[str, float]]:
        # a learner may leave between selection and aggregation
        with self._lock:
            return {
                lid: {"num_train_examples": r.num_train_examples,
                      "completed_batches": r.completed_batches,
                      "staleness": float(max(
                          0, self.global_iteration - r.last_result_round))
                      if r.last_result_round >= 0 else 0.0}
                for lid, r in ((lid, self._learners.get(lid))
                               for lid in selected)
                if r is not None
            }

    def _compute_community_model(self, selected: Sequence[str]) -> None:
        """Aggregate the selected cohort by the path and the rule's kind
        (module docstring): the masked stream's settlement, the secure
        combine, the plain stream's finish, or the store, read one block
        of ``stride_length`` models at a time (the fold rules keep only
        that block and their accumulator resident; the tree tier one
        sub-block per slice worker)."""
        t0 = time.perf_counter()
        drain_ms = 0.0
        if self._ingest is not None:
            # lineage fence: every queued write lands (and the store
            # flushes its batched fsyncs) before any select; a timeout
            # means a wedged writer, and raising routes into the
            # aggregation-failure retry instead of a partial cohort
            if not self._ingest.drain(timeout=300.0):
                raise RuntimeError("ingest drain fence timed out; store "
                                   "lineage would be torn")
            drain_ms = (time.perf_counter() - t0) * 1e3
        agg = self._aggregator
        lineage_k = agg.required_lineage
        stride = self.config.aggregation.stride_length or len(selected) or 1
        metadata = self._scaling_metadata(selected)
        scales = self._scaler(metadata)
        decay = self.config.aggregation.staleness_decay
        if decay > 0.0:
            scales = apply_staleness_decay(scales, metadata, decay)
        ids = [lid for lid in selected if lid in scales]
        block_sizes: List[int] = []
        block_ms: List[float] = []
        select_ms = 0.0

        def blocks():
            """(block ids, present ids, their (lineage, scale) pairs) per
            stride block, each block's select and handling timed."""
            nonlocal select_ms
            for i in range(0, len(ids), stride):
                b0 = time.perf_counter()
                block = ids[i: i + stride]
                picked = self._store.select(block, k=lineage_k)
                select_ms += (time.perf_counter() - b0) * 1e3
                present = [lid for lid in block if lid in picked]
                yield block, present, [(picked[lid], scales[lid])
                                       for lid in present]
                block_sizes.append(len(block))
                block_ms.append((time.perf_counter() - b0) * 1e3)

        def collect_all():
            """(pairs, present ids) of the whole cohort, for the rules
            that combine it in one call."""
            pairs, present_ids = [], []
            for _, present, block_pairs in blocks():
                pairs += block_pairs
                present_ids += present
            return pairs, present_ids

        def finish_stream(stream, *args):
            """A stream's finish, recorded as one block of its folds."""
            b0 = time.perf_counter()
            folded = stream.stats()["folded"]
            out = stream.finish(*args)
            block_sizes.append(folded)
            block_ms.append((time.perf_counter() - b0) * 1e3)
            return out

        # FedStride's state is one round's (under streaming it holds the
        # round's folds, and finish() resets it); FedRec's lives across
        # rounds
        if agg.name == "fedstride" and self._streaming is None:
            agg.reset()
        secure = self.config.secure
        community = None
        device_ms: Dict[str, Any] = {}
        if self._masked_stream is not None:
            # the round's masked sums accumulated on arrival: reconcile
            # the contributors against the mask parties and settle
            snap = finish_stream(self._masked_stream, selected)
            if snap is not None:
                community = self._settle_masked(*snap)
        elif self._slices is not None and self._slices.masked:
            # the masked sums accumulated at the slices: one masked
            # partial per slice, combined and settled at the root
            b0 = time.perf_counter()
            reduced = self._slices.reduce_masked(ids, self.global_iteration)
            if reduced is not None:
                m_sums, m_specs, m_present, slice_errors = reduced
                block_sizes.append(len(m_present))
                block_ms.append((time.perf_counter() - b0) * 1e3)
                if slice_errors:
                    with self._lock:
                        self._current_meta.errors.extend(slice_errors)
                community = self._settle_masked(m_sums, m_specs, m_present)
        elif secure.enabled:
            # opaque payloads: one combine over the whole cohort (masks
            # cancel only across every party, or with a recovered residual)
            pairs, present_ids = collect_all()
            if pairs:
                parsed = self._parse_secure(pairs)
                correction = None
                if secure.scheme == "masking":
                    correction = self._masking_dropout_correction(
                        present_ids, parsed)
                community = agg.aggregate(parsed, correction=correction)
        elif self._streaming is not None:
            # the community model is already accumulated: finalize it,
            # zero store reads
            community = finish_stream(self._streaming, selected)
        elif getattr(agg, "requires_full_cohort", False):
            # robust rules: a median cannot fold stride-wise; every
            # selected model enters one combine
            pairs, present_ids = collect_all()
            if pairs:
                community = agg.aggregate(pairs, learner_ids=present_ids)
                device_ms = dict(agg.last_timing)
        elif self._slices is not None:
            # the distributed tier: one FoldPartial per slice (a slice that
            # died since its uplinks re-homes inside reduce); the rule gate
            # ran at construction
            if agg.name == "fedstride":
                agg.reset()  # its rolling state is unused here
            reduced = self._slices.reduce(
                ids, scales, stride=self.config.aggregation.stride_length,
                round_id=self.global_iteration)
            if reduced is not None:
                community, partials, slice_errors = reduced
                for part in partials:
                    block_sizes.append(part.count)
                    block_ms.append(round(part.duration_ms, 3))
                if slice_errors:
                    with self._lock:
                        self._current_meta.errors.extend(slice_errors)
        elif self._tree is not None and agg.name in _WEIGHTED_SUM_RULES:
            # the tree tier: slice folds on worker threads, O(branch) root
            # fan-in; stride_length 0 passes through, so the tier bounds
            # each worker by its own sub-block
            select_times: List[float] = []

            def fetch(block):
                b0 = time.perf_counter()
                picked = self._store.select(block, k=lineage_k)
                select_times.append((time.perf_counter() - b0) * 1e3)
                return picked

            reduced = self._tree.reduce(
                ids, scales, fetch,
                stride=self.config.aggregation.stride_length)
            select_ms = sum(select_times)
            if reduced is not None:
                community, partials = reduced
                for part in partials:
                    block_sizes.append(part.count)
                    block_ms.append(round(part.duration_ms, 3))
        elif hasattr(agg, "accumulate"):
            # fold rules: FedAvg, FedNova, and the server optimizers over
            # the FedAvg fold (their step runs once, inside result())
            agg.reset()
            accumulated = 0
            needs_steps = getattr(agg, "needs_local_steps", False)
            for _, present, pairs in blocks():
                if not pairs:
                    continue
                if needs_steps:
                    # fednova: each learner's completed local steps (one
                    # optimizer step per batch)
                    steps = [max(1.0, float(metadata.get(lid, {}).get(
                        "completed_batches", 0.0)) or 1.0)
                        for lid in present]
                    agg.accumulate(pairs, steps=steps)
                else:
                    agg.accumulate(pairs)
                accumulated += len(pairs)
            if accumulated:
                community = agg.result()
            agg.reset()
        else:
            # rolling rules (fedstride / fedrec): each block updates the
            # rolling state, whose community model the last block returns
            for _, present, pairs in blocks():
                if pairs:
                    community = agg.aggregate(pairs, learner_ids=present)
        if community is None:
            logger.warning("no stored models for cohort %s", list(selected))
            return
        if agg.name == "scaffold":
            self._fold_scaffold_controls(ids)
        p0 = time.perf_counter()
        blob = self._community_to_blob(community)
        pack_ms = (time.perf_counter() - p0) * 1e3
        agg_ms = (time.perf_counter() - t0) * 1e3
        sizes = {"values": 0, "non_zeros": 0, "zeros": 0, "bytes": 0}
        if not secure.enabled:
            for arr in community.values():
                q = quantify(arr)
                for key in sizes:
                    sizes[key] += q[key]
        with self._lock:
            self._community_blob = blob
            if not secure.enabled:
                self._community_flat = community
            # the stateful rules' step of this round counts from here on
            if hasattr(agg, "commit"):
                agg.commit()
            meta = self._current_meta
            meta.selected_learners = list(selected)
            meta.scales = {lid: round(float(w), 6)
                           for lid, w in scales.items()}
            meta.staleness = {lid: float(m["staleness"])
                              for lid, m in metadata.items()
                              if m.get("staleness")}
            meta.aggregation_block_sizes = block_sizes
            meta.aggregation_block_duration_ms = block_ms
            meta.aggregation_duration_ms = agg_ms
            meta.aggregation_device_ms = device_ms
            meta.community_pack_duration_ms = pack_ms
            meta.ingest_drain_duration_ms = drain_ms
            meta.store_select_duration_ms = select_ms
            meta.model_size = sizes

    def _community_to_blob(self, community: Dict[str, Any]) -> bytes:
        if self.config.secure.enabled:
            return ModelBlob(opaque=dict(community)).to_bytes()
        return ModelBlob(tensors=list(community.items())).to_bytes()

    # -- SCAFFOLD ---------------------------------------------------------

    def _pack_scaffold_c(self) -> bytes:
        """The server control variate's wire bytes (empty until the first
        cohort's deltas fold in: learners read empty as zeros), encoded
        once per ``c``. Call with ``self._lock`` held."""
        if self._scaffold_c is None:
            return b""
        if self._scaffold_c_blob is None:
            self._scaffold_c_blob = ModelBlob(
                tensors=sorted(self._scaffold_c.items())).to_bytes()
        return self._scaffold_c_blob

    def _fold_scaffold_controls(self, cohort: Sequence[str]) -> None:
        """c += (1/N) Σ the cohort's control deltas (SCAFFOLD's server
        update, |S|/N times the mean over S; N = the active learners). Host
        numpy float32, in the JAX package's order: bit for bit."""
        with self._lock:
            blobs = [self._scaffold_deltas.pop(lid)
                     for lid in cohort if lid in self._scaffold_deltas]
            n_active = max(1, len(self._learners))
        if not blobs:
            return
        total: Dict[str, np.ndarray] = {}
        for raw in blobs:
            for name, t in ModelBlob.from_bytes(raw).tensors:
                arr = np.asarray(to_numpy(t), np.float32)
                total[name] = total.get(name, 0.0) + arr
        with self._lock:
            if self._scaffold_c is None:
                self._scaffold_c = {n: np.zeros_like(a)
                                    for n, a in total.items()}
            for name, summed in total.items():
                if name in self._scaffold_c:
                    self._scaffold_c[name] = (
                        self._scaffold_c[name] + summed / n_active)
            self._scaffold_c_blob = None

    # -- secure aggregation ----------------------------------------------

    def _parse_secure(self, pairs):
        """Stored secure uplinks (wire bytes) → their opaque entries."""
        parsed = []
        for lineage, scale in pairs:
            models = []
            for item in lineage:
                if isinstance(item, (bytes, bytearray)):
                    models.append(dict(ModelBlob.from_bytes(item).opaque))
                else:
                    models.append(item)
            parsed.append((models, scale))
        return parsed

    def _mask_parties(self, ids: Sequence[str]):
        """(party index of each registered id of ``ids``, the party count
        to settle against: ``secure.num_parties``, which the driver fills
        in, else one more than the largest registered index)."""
        with self._lock:
            idx_of = {lid: self._learners[lid].party_index
                      for lid in ids if lid in self._learners}
            registered = {r.party_index for r in self._learners.values()
                          if r.party_index >= 0}
        n = self.config.secure.num_parties or (
            max(registered) + 1 if registered else 0)
        return idx_of, n

    def _settle_masked(self, sums, specs, contributors):
        """Settle a round's masked streamed sums (secure/recovery.py) into
        the opaque community payload: reconcile the contributors against
        the mask parties, recover dropouts from one survivor, unmask, and
        wrap the float64 payloads as SecureAgg's output. Raises when the
        cohort cannot settle, so the aggregation-failure retry re-runs the
        round clean."""
        cfg = self.config.secure
        idx_of, n = self._mask_parties(contributors)
        missing = [lid for lid in contributors if lid not in idx_of]
        if missing:
            raise RuntimeError(
                f"masked contributors {missing} have no registration "
                "record; their party indices are unknown and the sum "
                "cannot settle")
        if n <= 0:
            raise RuntimeError(
                "mask settlement needs the party count (secure.num_parties"
                " or the joined capabilities['party_index'] values)")

        def recover_fn(rid, surviving, dropped, lengths):
            return self._request_mask_recovery(
                rid, surviving, dropped, lengths, list(contributors))

        payloads, report = recovery.settle(
            sums, idx_of, n, max(2, cfg.min_recovery_parties),
            self.global_iteration, recover_fn)
        if report.recovered:
            logger.info("round %d settled with %d dropped parties "
                        "recovered in %.3f ms", report.round_id,
                        len(report.dropped), report.duration_ms)
        return {name: (payload, TensorSpec(tuple(specs[name].shape),
                                           specs[name].dtype,
                                           TensorKind.CIPHERTEXT))
                for name, payload in payloads.items()}

    def _request_mask_recovery(self, round_id, surviving, dropped, lengths,
                               candidates):
        """Ask the surviving learners, one at a time, for the dropped
        parties' residual (``recover_masks``; the learner enforces the
        privacy thresholds). Returns the per-tensor correction, None when
        the transport cannot recover, and raises when every survivor
        refused or failed."""
        last_error = None
        for lid in candidates:
            with self._lock:
                record = self._learners.get(lid)
            if record is None or record.proxy is None:
                continue
            if not hasattr(record.proxy, "recover_masks"):
                return None
            try:
                corrections = record.proxy.recover_masks(
                    int(round_id), list(surviving), list(dropped),
                    list(lengths))
            except Exception as exc:  # noqa: BLE001 - try the next one
                last_error = exc
                continue
            logger.warning("masking dropout recovery: %s computed residuals "
                           "for dropped parties %s (surviving %d)", lid,
                           list(dropped), len(surviving))
            return corrections
        raise RuntimeError(f"masking dropout recovery failed on every "
                           f"survivor: {last_error!r}")

    def _masking_dropout_correction(self, present_ids, parsed):
        """The store path's dropout recovery: where the cohort misses
        registered mask parties, one survivor's residual for them, as
        ``{tensor name: bytes}``; None when nobody dropped or the party
        indices are unknown (the combine then needs every party). Raises
        below the survivor threshold."""
        idx_of, n = self._mask_parties(present_ids)
        surviving = sorted(idx_of.values())
        if n <= 0 or not surviving or -1 in surviving:
            return None
        if len(surviving) == n:
            return None
        min_parties = max(2, self.config.secure.min_recovery_parties)
        if len(surviving) < min_parties:
            raise RuntimeError(
                f"masking dropout recovery needs >= {min_parties} surviving "
                f"parties, have {len(surviving)}")
        dropped = sorted(set(range(n)) - set(surviving))
        first = parsed[0][0][0]
        names = list(first)
        lengths = [int(first[name][1].size) for name in names]
        corrections = self._request_mask_recovery(
            self.global_iteration, surviving, dropped, lengths,
            list(present_ids))
        if corrections is None:
            return None
        return dict(zip(names, corrections))

    # -- dispatch ---------------------------------------------------------

    def _dispatch_blob(self) -> Optional[bytes]:
        """The community blob as dispatched: ``downlink_dtype`` narrows its
        floating tensors (bf16 halves the broadcast), encoded once per
        community model; the controller's own state stays full width."""
        with self._lock:
            blob = self._community_blob
            target = self.config.train.downlink_dtype
            if blob is None or not target or self.config.secure.enabled:
                return blob
            cached = self._downlink_cache
            if cached is not None and cached[0] is blob:
                return cached[1]
        named = [(n, to_numpy(t))
                 for n, t in ModelBlob.from_bytes(blob).tensors]
        narrowed = ModelBlob(tensors=narrow_named(
            named, resolve_ship_dtype(target))).to_bytes()
        with self._lock:
            self._downlink_cache = (blob, narrowed)
        return narrowed

    def _dispatch_train(self, learner_ids: Sequence[str],
                        fresh_round: bool = True) -> None:
        """Send the community model to ``learner_ids`` as train tasks; the
        dispatched set is the round barrier. Nothing is sent once
        ``termination.federation_rounds`` rounds have completed.
        ``fresh_round``: a round's cohort dispatched together (not a
        joining learner's first task, a replacement or an asynchronous
        reporter's next task): it renews the round's retry budget, bumps
        the round serial that fences the deadline and retry timers,
        (re)starts the deadline, and the distributed tier splits it into
        its slices."""
        limit = self.config.termination.federation_rounds
        with self._lock:
            if 0 < limit <= self.global_iteration:
                return
        blob = self._dispatch_blob()
        if blob is None:
            logger.warning("no community model yet; cannot dispatch train "
                           "tasks")
            return
        t0 = time.perf_counter()
        if fresh_round:
            with self._lock:
                self._dispatch_retries_used = 0
                self._round_serial += 1
            if self._slices is not None:
                # contiguous slices of the sorted cohort over every
                # configured aggregator (a relaunched one revives here)
                self._slices.assign(list(learner_ids))
        if self._masked_stream is not None:
            # mask streams are round-keyed: a fold of another round's
            # uplink into this round's sum would never cancel
            self._masked_stream.begin_round(self.global_iteration)
        self._scheduler.notify_dispatched(list(learner_ids))
        with self._lock:
            if not self._current_meta.started_at:
                self._current_meta.started_at = time.time()
        for lid in learner_ids:
            with self._lock:
                record = self._learners.get(lid)
                if record is None:
                    continue
                params = dataclasses.replace(self.config.train)
                if record.local_steps_override:
                    params.local_steps = record.local_steps_override
                # no device-utilization plane in the port
                params.device_stats = False
                # one task in flight per learner: a learner drops its running
                # task for a new one, so the result of a task this dispatch
                # replaces (a rejoin's re-dispatch while it trains) is kept
                # but advances no barrier, or it would count in the next
                # round
                superseded = {tid: owner for tid, owner
                              in self._tasks_in_flight.items()
                              if owner == lid}
                if superseded:
                    self._expire_tasks_locked(superseded)
                task = TrainTask(
                    task_id=uuid.uuid4().hex,
                    learner_id=lid,
                    round_id=self.global_iteration,
                    global_iteration=self.global_iteration,
                    model=blob,
                    params=params,
                    scaffold=self._aggregator.name == "scaffold",
                    control=self._pack_scaffold_c(),
                    controller_epoch=self.controller_epoch,
                )
                self._tasks_in_flight[task.task_id] = lid
                self._task_dispatched_at[task.task_id] = time.time()
                self._current_meta.train_submitted_at[lid] = time.time()
                proxy = record.proxy
            try:
                if hasattr(proxy, "run_task_with_callback"):
                    # an asynchronous transport reports a failed dispatch
                    # through the callback
                    proxy.run_task_with_callback(
                        task, lambda exc, lid=lid, tid=task.task_id:
                        self._note_dispatch_failure(lid, exc, tid))
                else:
                    proxy.run_task(task)
            except Exception as exc:
                # counted against the learner; the round relies on the
                # deadline, membership changes and the retries
                logger.exception("train dispatch to %s failed", lid)
                self._note_dispatch_failure(lid, exc, task.task_id)
        with self._lock:
            self._current_meta.dispatch_duration_ms += (
                (time.perf_counter() - t0) * 1e3)
        self._arm_round_deadline(restart=fresh_round)

    def _note_dispatch_failure(self, learner_id: str, exc: Exception,
                               task_id: str = "") -> None:
        with self._lock:
            if task_id:
                # the task never reached the learner: no completion pops it
                self._tasks_in_flight.pop(task_id, None)
                self._task_dispatched_at.pop(task_id, None)
            record = self._learners.get(learner_id)
            if record is None:
                return
            record.dispatch_failures += 1
            count = record.dispatch_failures
        limit = self.config.max_dispatch_failures
        if limit > 0 and count == limit:
            logger.warning(
                "learner %s unreachable after %d failed dispatches (%r); "
                "left out of cohort sampling until it reports or rejoins",
                learner_id, count, exc)
        self._note_churn(learner_id, "dispatch_failure")
        self._maybe_retry_dispatch(learner_id)

    def _maybe_retry_dispatch(self, failed_id: str) -> None:
        """Bounded dispatch retry (``scheduling.dispatch_retries``): a
        provably failed dispatch schedules a replacement after a doubling
        backoff, up to the round's budget. Off, a failed dispatch stalls
        the round until its deadline."""
        cfg = self.config.scheduling
        if cfg.dispatch_retries <= 0 or self._shutdown.is_set():
            return
        with self._lock:
            if self._dispatch_retries_used >= cfg.dispatch_retries:
                return
            self._dispatch_retries_used += 1
            attempt = self._dispatch_retries_used
            # a timer armed for round N never acts on round N+1
            serial = self._round_serial
        delay = cfg.retry_backoff_s * (2 ** (attempt - 1))

        def _fire():
            with self._lock:
                self._retry_timers.pop(timer, None)
            if self._shutdown.is_set():
                return
            try:
                self._pool.submit(self._guard, self._retry_dispatch,
                                  failed_id, attempt, serial)
            except RuntimeError:  # the pool is shut down
                pass

        timer = threading.Timer(delay, _fire)
        timer.daemon = True
        with self._lock:
            if self._shutdown.is_set():
                return
            self._retry_timers[timer] = None
        timer.start()

    def _retry_dispatch(self, failed_id: str, attempt: int,
                        serial: int = 0) -> None:
        """After the backoff, on the scheduling worker: drop the dead
        endpoint from the round barrier and dispatch a replacement learner
        in its place, so the reporters stay at strength."""
        if self._shutdown.is_set():
            return
        with self._lock:
            if serial != self._round_serial:
                return  # the round that armed this retry closed
            busy = set(self._tasks_in_flight.values())
            record = self._learners.get(failed_id)
            healed = record is not None and record.dispatch_failures == 0
        if failed_id in busy or healed:
            # the endpoint healed since (a completion or a rejoin): its
            # contribution is deliverable, or delivered
            return
        drop = getattr(self._scheduler, "drop_dispatched", None)
        released: List[str] = []
        if drop is not None:
            released = drop(failed_id, self.active_learners())
        dispatched: set = set()
        getter = getattr(self._scheduler, "dispatched_ids", None)
        if getter is not None:
            dispatched = getter()
        pool = [lid for lid in self._admission_pool()
                if lid != failed_id and lid not in dispatched
                and lid not in busy]
        replacement = random.choice(pool) if pool else ""
        if released:
            # dropping the dead endpoint met the barrier: finish the round
            # instead of growing it by a replacement
            if self._quorum > 0:
                self._expire_unreported(released)
            self._complete_round(released)
            return
        if not replacement:
            logger.warning("dispatch retry %d for %s: no replacement "
                           "learner available", attempt, failed_id)
            return
        logger.info("dispatch retry %d: replacing unreachable %s with %s",
                    attempt, failed_id, replacement)
        self._dispatch_train([replacement], fresh_round=False)

    def _send_eval_tasks(self) -> None:
        """Evaluate the new community model on every learner; results land
        in ``community_evaluations`` as they arrive."""
        cfg = self.config.eval
        if cfg.every_n_rounds <= 0:
            return
        if (self.global_iteration + 1) % cfg.every_n_rounds != 0:
            return
        with self._lock:
            blob = self._community_blob
            learners = list(self._learners.values())
            iteration = self.global_iteration
            # eval timestamps bind to the submitting round's record
            meta = self._current_meta
        if blob is None:
            return
        entry: Dict[str, Any] = {"global_iteration": iteration,
                                 "evaluations": {}}
        with self._lock:
            self.community_evaluations.append(entry)
        for record in learners:
            task = EvalTask(
                task_id=uuid.uuid4().hex,
                learner_id=record.learner_id,
                round_id=iteration,
                model=blob,
                batch_size=cfg.batch_size,
                datasets=list(cfg.datasets),
                metrics=list(cfg.metrics),
                local_tensor_regex=self.config.train.local_tensor_regex,
                ship_tensor_regex=self.config.train.ship_tensor_regex,
                controller_epoch=self.controller_epoch,
            )
            with self._lock:
                meta.eval_submitted_at[record.learner_id] = time.time()

            def _digest(result: EvalResult, lid=record.learner_id,
                        entry=entry, meta=meta):
                with self._lock:
                    entry["evaluations"][lid] = result.evaluations
                    now = time.time()
                    meta.eval_received_at[lid] = now
                    rec = self._learners.get(lid)
                    sent = meta.eval_submitted_at.get(lid, 0.0)
                    if rec is not None and sent:
                        rec.ewma_eval_s = _ewma(rec.ewma_eval_s,
                                                max(0.0, now - sent))
                # outside the controller lock: the fold takes the
                # registry's
                if self._registry is not None:
                    self._note_registry_eval(entry, expected=len(learners))

            try:
                record.proxy.evaluate(task, _digest)
            except Exception:
                logger.exception("eval dispatch to %s failed",
                                 record.learner_id)

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #

    _CKPT_NAME = "controller_ckpt.bin"

    def _checkpoint_state(self) -> Dict[str, Any]:
        """One capture of everything a round's bits depend on: the
        community model, the round counter and lineage, the learner
        registry with its tokens (a restarted controller recognizes
        rejoining learners as themselves, with their party indices), the
        rules' state, SCAFFOLD's ``c`` and the model registry. The
        checkpoint file and the WAL snapshot share it, so a promoted
        standby restores what ``--resume`` restores. The JAX package's
        keys and encodings: its controller restores this state too."""
        with self._lock:
            state = {
                "global_iteration": self.global_iteration,
                "community_blob": self._community_blob or b"",
                "round_metadata": [
                    {k: v for k, v in m.to_dict().items()
                     if k not in _PORT_ONLY_META}
                    for m in self.round_metadata],
                "community_evaluations": self._snapshot_evaluations(),
                "learners": [self._learner_entry(r)
                             for r in self._learners.values()],
            }
            # FedRec's scales rebuild its rolling sums from the store's
            # lineage (aggregation/rolling.py rehydrate)
            if hasattr(self._aggregator, "export_scales"):
                state["agg_scales"] = self._aggregator.export_scales()
            # the server optimizers' moments and FedNova's previous model
            if hasattr(self._aggregator, "export_state"):
                state["agg_state"] = self._aggregator.export_state()
            if self._scaffold_c is not None:
                state["scaffold_c"] = self._pack_scaffold_c()
        if self._registry is not None:
            # the channel heads and rollback target survive a failover, or
            # serving would lose its promoted model; outside the controller
            # lock (the export takes the registry's own)
            state["registry"] = self._registry.export_state()
        return state

    @staticmethod
    def _learner_entry(r: LearnerRecord) -> Dict[str, Any]:
        """A learner's serialized registry entry: one shape for the
        checkpoint, the WAL snapshot and the WAL's join delta, so the
        replay merge and the restore agree field for field."""
        return {"learner_id": r.learner_id,
                "auth_token": r.auth_token,
                "hostname": r.hostname,
                "port": r.port,
                "num_train_examples": r.num_train_examples,
                "num_val_examples": r.num_val_examples,
                "num_test_examples": r.num_test_examples,
                "completed_batches": r.completed_batches,
                "ms_per_step": float(r.ms_per_step),
                "last_result_round": r.last_result_round,
                "party_index": r.party_index,
                "local_steps_override": r.local_steps_override,
                "ewma_train_s": float(r.ewma_train_s),
                "ewma_eval_s": float(r.ewma_eval_s)}

    def save_checkpoint(self, path: Optional[str] = None,
                        state: Optional[Dict[str, Any]] = None) -> str:
        """Write the checkpoint (``state``, or a fresh capture) to ``path``
        (default ``<checkpoint.dir>/controller_ckpt.bin``) as one codec
        envelope, atomically (store/durable.py)."""
        if path is None:
            path = os.path.join(self.config.checkpoint.dir, self._CKPT_NAME)
        if state is None:
            state = self._checkpoint_state()
        buf = codec_dumps(state)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _durable.atomic_write(path, buf, prefix=".ckpt_")
        return path

    def restore_checkpoint(self, path: Optional[str] = None) -> bool:
        """Restore from :meth:`save_checkpoint`'s file (``path`` or the
        config's directory); False when there is none (a fresh start)."""
        if path is None:
            path = self.config.checkpoint.dir
        if os.path.isdir(path):
            path = os.path.join(path, self._CKPT_NAME)
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            state = codec_loads(f.read())
        self._restore_state(state)
        with self._lock:
            n_learners = len(self._learners)
        logger.info("restored checkpoint %s at round %d (%d learner(s) in "
                    "the registry, epoch %s)", path, self.global_iteration,
                    n_learners, self.controller_epoch[:8])
        return True

    def restore_from_wal(self) -> bool:
        """The hot standby's restore at promotion: the WAL's latest
        snapshot merged with every registry delta after it, restored as
        ``--resume`` restores a checkpoint. False when the log is empty
        (the primary died before anything durable happened: the standby
        serves a fresh federation and the learners re-attach by joining)."""
        if self._wal is None:
            return False
        snapshot, deltas = self._wal.replay()
        state = RoundStateLog.merge(snapshot, deltas)
        if state is None:
            return False
        self._restore_state(state)
        with self._lock:
            n_learners = len(self._learners)
        logger.info("restored WAL round state at round %d (%d learner(s), "
                    "%d registry delta(s) past the snapshot, epoch %s)",
                    self.global_iteration, n_learners, len(deltas),
                    self.controller_epoch[:8])
        return True

    def _restore_state(self, state: Dict[str, Any]) -> None:
        """Apply one ``_checkpoint_state``-shaped dict (of either package)
        to this fresh controller; fields this package does not know are
        dropped."""
        blob = state.get("community_blob") or None
        meta_fields = {f.name for f in dataclasses.fields(RoundMetadata)}
        with self._lock:
            self.global_iteration = int(state["global_iteration"])
            self.round_metadata = [
                RoundMetadata(**{k: v for k, v in m.items()
                                 if k in meta_fields})
                for m in state.get("round_metadata", [])]
            self.community_evaluations = list(
                state.get("community_evaluations", []))
            self._current_meta = RoundMetadata(
                global_iteration=self.global_iteration)
        known_fields = {f.name for f in dataclasses.fields(LearnerRecord)}
        for entry in state.get("learners", []):
            record = LearnerRecord(**{k: v for k, v in entry.items()
                                      if k in known_fields})
            try:
                # the learners may have outlived the controller: a working
                # proxy re-dispatches the abandoned round at once; a dead
                # endpoint fails its dispatch and heals on re-attach
                record.proxy = self._proxy_factory(record)
            except Exception:  # noqa: BLE001 - rebuilt on rejoin
                logger.warning("could not rebuild the proxy of %s; waiting "
                               "for its re-attach", record.learner_id)
            with self._lock:
                self._learners[record.learner_id] = record
                self._tokens[record.learner_id] = record.auth_token
        if blob:
            self._in_restore = True
            try:
                self.set_community_model(blob)
            finally:
                self._in_restore = False
        agg_scales = state.get("agg_scales")
        if agg_scales and hasattr(self._aggregator, "rehydrate"):
            # without this FedRec's rolling sum would restart from nothing
            # and a straggler's earlier contribution count twice
            restored = self._aggregator.rehydrate(self._store, agg_scales)
            logger.info("rehydrated %d/%d rolling contributions from the "
                        "store", restored, len(agg_scales))
        scaffold_c = state.get("scaffold_c")
        if scaffold_c:
            with self._lock:
                self._scaffold_c = {
                    name: np.asarray(to_numpy(arr), np.float32)
                    for name, arr in ModelBlob.from_bytes(scaffold_c).tensors}
                self._scaffold_c_blob = None
        agg_state = state.get("agg_state")
        if agg_state and hasattr(self._aggregator, "restore_state"):
            # the server optimizers resume the uninterrupted run's steps
            self._aggregator.restore_state(agg_state)
        registry_state = state.get("registry")
        if registry_state and self._registry is not None:
            # version ids stay monotonic across incarnations, and the
            # gateway's next poll sees the stable head it served before
            self._registry.restore_state(registry_state)

    # ------------------------------------------------------------------ #
    # model lifecycle (registry/)
    # ------------------------------------------------------------------ #

    def _register_round_version(self) -> None:
        """Register the round that just aggregated as a candidate version
        and record it in ``RoundMetadata``; on the scheduling worker, with
        ``global_iteration`` still naming the round. Never raises (the
        lifecycle must not trip the aggregation-failure retry)."""
        if self._registry is None:
            return
        try:
            with self._lock:
                blob = self._community_blob
            if blob is None:
                return
            # the round's health snapshot: {} until the health plane is
            # ported (ROADMAP.md Queue 1 item 4)
            info = self._registry.register(self.global_iteration, blob, {})
            stable = self._registry.head(CHANNEL_STABLE)
            with self._lock:
                self._current_meta.registered_version = info.version
                self._current_meta.stable_version = (
                    stable.version if stable is not None else 0)
        except Exception:  # noqa: BLE001 - the lifecycle never fails a round
            logger.exception("model version registration failed")

    def _note_registry_eval(self, entry: Dict[str, Any],
                            expected: int = 0) -> None:
        """Fold a round's community evaluation into its registered version
        (``{"<dataset>/<metric>": mean over learners}``); under
        ``promotion.auto`` the gate runs only once all ``expected``
        digests landed, so one fast learner's partial mean never promotes
        a model the whole cohort would reject. Never raises."""
        if self._registry is None:
            return
        try:
            with self._lock:
                evals = {lid: dict(v)
                         for lid, v in entry["evaluations"].items()}
                round_id = int(entry["global_iteration"])
            per: Dict[str, List[float]] = {}
            for learner_evals in evals.values():
                for ds, metrics in learner_evals.items():
                    for name, value in metrics.items():
                        try:
                            per.setdefault(f"{ds}/{name}", []).append(
                                float(value))
                        except (TypeError, ValueError):
                            continue
            if not per:
                return
            folded = {k: sum(v) / len(v) for k, v in per.items()}
            promoted = self._registry.note_eval(
                round_id, folded, gate=len(evals) >= expected)
            if promoted is not None:
                logger.info("round %d eval promoted model version v%d to "
                            "stable", round_id, promoted.version)
        except Exception:  # noqa: BLE001 - an eval digest never breaks
            logger.exception("registry eval fold failed")

    def describe_registry(self) -> Dict[str, Any]:
        """The registry's snapshot (DescribeRegistry, the gateway's polls);
        ``{"enabled": False}`` when off."""
        if self._registry is None:
            return {"enabled": False}
        return self._registry.describe()

    def registered_model(self, version: int = 0,
                         channel: str = "") -> Optional[bytes]:
        """A registered version's blob, by id or by channel head."""
        if self._registry is None:
            return None
        if not version and channel:
            head = self._registry.head(channel)
            if head is None:
                return None
            version = head.version
        return self._registry.blob(version) if version else None

    def promote_version(self, version: int, force: bool = False):
        if self._registry is None:
            raise ValueError("model registry is not enabled")
        info = self._registry.promote(version, force=force)
        # the new stable head must survive a crash before the next round's
        # checkpoint (the queued save captures the promoted state)
        self._checkpoint_async()
        return info

    def rollback_version(self):
        if self._registry is None:
            raise ValueError("model registry is not enabled")
        info = self._registry.rollback()
        if info is not None:
            self._checkpoint_async()
        return info

    # ------------------------------------------------------------------ #
    # lineage
    # ------------------------------------------------------------------ #

    def _snapshot_evaluations(self, tail: int = 0) -> List[dict]:
        """The last ``tail`` entries (0 = all), copied deep enough to detach
        the ``evaluations`` dict that eval callbacks keep inserting into.
        Call with the lock held."""
        entries = (self.community_evaluations[-tail:] if tail > 0
                   else self.community_evaluations)
        return [{**e, "evaluations": dict(e["evaluations"])}
                for e in entries]

    def get_runtime_metadata(self, tail: int = 0) -> List[dict]:
        """Round metadata, only the last ``tail`` rounds when ``tail > 0``
        (DriverSession polls this; it must not ship the whole history)."""
        with self._lock:
            metas = (self.round_metadata[-tail:] if tail > 0
                     else self.round_metadata)
            return [m.to_dict() for m in metas]

    def get_evaluation_lineage(self, tail: int = 0) -> List[dict]:
        """Community-model evaluations, only the last ``tail`` when
        ``tail > 0``."""
        with self._lock:
            return self._snapshot_evaluations(tail)

    def describe(self) -> dict:
        """A live snapshot: the round, the protocol, the learners (with
        their liveness, and churn scores where tracked), the tasks in
        flight and the community model's size; a ``scheduling`` section
        where a quorum, dispatch retries, the buffered protocol or a
        quarantine is armed."""
        slices = self._slices.describe() if self._slices is not None else None
        churn_scores: Dict[str, float] = {}
        quarantined: set = set()
        if self._churn is not None:
            churn_scores = self._churn.scores()
            quarantined = set(self._churn.quarantined_ids())
        sched_cfg = self.config.scheduling
        limit = self.config.max_dispatch_failures
        with self._lock:
            blob = self._community_blob
            snapshot = {
                "global_iteration": self.global_iteration,
                "protocol": self.config.protocol,
                "controller_epoch": self.controller_epoch,
                "learners": [
                    {"learner_id": r.learner_id, "hostname": r.hostname,
                     "port": r.port,
                     "num_train_examples": r.num_train_examples,
                     # liveness mirrors the admission pool's rule
                     "live": limit <= 0 or r.dispatch_failures < limit,
                     "dispatch_failures": r.dispatch_failures,
                     "last_result_round": r.last_result_round,
                     **({"churn_score": round(
                         churn_scores.get(r.learner_id, 0.0), 4),
                         "quarantined": r.learner_id in quarantined}
                        if self._churn is not None else {})}
                    for r in self._learners.values()],
                # dispatched this round and not yet reported back
                "in_flight": sorted(
                    set(self._current_meta.train_submitted_at)
                    - set(self._current_meta.train_received_at)),
                "community_model_bytes": len(blob) if blob else 0,
                **({"streaming": self._streaming.stats()}
                   if self._streaming is not None else {}),
                **({"secure_stream": self._masked_stream.stats()}
                   if self._masked_stream is not None else {}),
                **({"slices": slices} if slices is not None else {}),
            }
            if self._registry is not None:
                # channel heads and the version lineage
                snapshot["registry"] = self._registry.describe()
            if (self._quorum > 0 or sched_cfg.dispatch_retries > 0
                    or self._scheduler.name == "asynchronous_buffered"
                    or quarantined):
                section: Dict[str, Any] = {}
                if self._quorum > 0:
                    section["quorum"] = self._quorum
                    section["overprovision"] = sched_cfg.overprovision
                if self._scheduler.name == "asynchronous_buffered":
                    section["buffer_size"] = self._scheduler.buffer_size
                    section["buffer_pending"] = self._scheduler.pending()
                if sched_cfg.dispatch_retries > 0:
                    section["dispatch_retries_used"] = \
                        self._dispatch_retries_used
                    section["dispatch_retries"] = sched_cfg.dispatch_retries
                if quarantined:
                    section["quarantined"] = sorted(quarantined)
                snapshot["scheduling"] = section
            return snapshot

    def get_statistics(self) -> dict:
        with self._lock:
            return {
                "global_iteration": self.global_iteration,
                "learners": sorted(self._learners.keys()),
                "round_metadata": [m.to_dict() for m in self.round_metadata],
                "community_evaluations": self._snapshot_evaluations(),
            }
