"""Federation controller: the synchronous FedAvg round.

The port's copy of the JAX package's ``controller/core.py``, trimmed to
the synchronous FedAvg path: the learner registry (join, rejoin, leave),
the train-task lifecycle, the model store (in memory, on disk, cached, or
remote) with its parallel-ingest plane, stride-blocked FedAvg aggregation
on the host, round metadata, community-model evaluation and re-dispatch.
The controller does no device work: wire blobs are parsed into numpy and
folded on the host (aggregation/base.py); a round's device work is its
learners' training.

Parallel ingest (``model_store.ingest_workers > 0``, store/ingest.py):
a completion enqueues its model and returns; the writer pool persists it
and applies the result's metadata only once the write lands; aggregation
drains the pipeline before any select, and a departing learner's queued
writes are drained before its lineage is erased.

Concurrency as in the JAX package: RPC threads only validate and enqueue;
one scheduling worker owns all round logic, so a completion ack never
waits on aggregation, and state needs one lock.

After ``termination.federation_rounds`` rounds (0 = no limit) the
controller dispatches no more train tasks; the last round's evaluations
still go out.

Not ported yet (ROADMAP.md Queue 1 items 3c-3g and 4): the round-state WAL,
checkpoints and the hot standby, deadlines, quorum and dispatch retries,
churn scoring and quarantine, the registry, the streaming and tree tiers,
secure aggregation, SCAFFOLD, int8q/top-k uplinks, ``describe`` and every
telemetry plane. The config (config/federation.py) refuses them.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import random
import resource
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence)

import numpy as np

from metisfl_tpu_torch.aggregation import make_aggregation_rule
from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainTask,
)
from metisfl_tpu_torch.config import FederationConfig
from metisfl_tpu_torch.scaling import make_scaler
from metisfl_tpu_torch.scheduling import make_scheduler
from metisfl_tpu_torch.selection import make_selector
from metisfl_tpu_torch.store import IngestPipeline, make_store
from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy
from metisfl_tpu_torch.tensor.spec import quantify

logger = logging.getLogger("metisfl_tpu_torch.controller")


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
    completed_batches: int = 0
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
    # of which the community blob encode
    community_pack_duration_ms: float = 0.0
    dispatch_duration_ms: float = 0.0
    # the contribution weights applied this round
    scales: Dict[str, float] = field(default_factory=dict)
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
    errors: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Controller:
    """See module docstring. Lifecycle: learners ``join()`` → rounds run
    event-driven off ``task_completed()`` → ``shutdown()``."""

    # consecutive aggregation failures tolerated before halting re-dispatch
    _MAX_AGG_FAILURES = 10

    def __init__(self, config: FederationConfig,
                 proxy_factory: Callable[[LearnerRecord], LearnerProxy]):
        self.config = config
        self._proxy_factory = proxy_factory
        self._lock = threading.RLock()
        self._learners: Dict[str, LearnerRecord] = {}
        self._tokens: Dict[str, str] = {}
        # incarnation id: rides in JoinReply and every task envelope
        self.controller_epoch = uuid.uuid4().hex

        agg = config.aggregation
        self._aggregator = make_aggregation_rule(agg.rule)
        self._scaler = make_scaler(agg.scaler)
        self._selector = make_selector("scheduled_cardinality")
        self._scheduler = make_scheduler(config.protocol)
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

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def shutdown(self) -> None:
        self._shutdown.set()
        self._pool.shutdown(wait=True)
        # ingest workers write INTO the store: stop them (bounded drain)
        # before the store's own shutdown
        if self._ingest is not None:
            self._ingest.shutdown()
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
                    num_test_examples=request.num_test_examples)
                self._learners[learner_id] = record
                self._tokens[learner_id] = token
            record.proxy = self._proxy_factory(record)
        logger.info("learner %s %s (%d train examples)", record.learner_id,
                    "rejoined" if rejoined else "joined",
                    record.num_train_examples)
        if not self._shutdown.is_set():
            self._pool.submit(self._guard, self._schedule_initial,
                              record.learner_id)
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
        # drain the departing learner's queued writes BEFORE the erase: a
        # write landing after it would resurrect the lineage
        if (self._ingest is not None
                and not self._ingest.drain(learner_id, timeout=30.0)):
            # a wedged writer: erase anyway; the worker's membership gate
            # drops the queued write
            logger.error("ingest drain for departing %s timed out; its "
                         "queued writes will be gate-dropped", learner_id)
        self._store.erase([learner_id])
        logger.info("learner %s left", learner_id)
        # the departed learner may have been the last one the barrier
        # waited on: no later completion would re-check it
        if not self._shutdown.is_set():
            self._pool.submit(self._guard, self._handle_membership_change)
        return True

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
        """Seed (or overwrite) the community model from wire bytes."""
        blob = ModelBlob.from_bytes(blob_bytes)
        if blob.opaque:
            raise NotImplementedError(
                "encrypted community models are not ported to "
                "metisfl_tpu_torch yet (ROADMAP.md Queue 1 item 3c)")
        with self._lock:
            self._community_blob = bytes(blob_bytes)

    def community_model_bytes(self) -> Optional[bytes]:
        with self._lock:
            return self._community_blob

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
        self._dispatch_train([learner_id])

    def _handle_completed(self, result: TaskResult) -> None:
        start = time.time()
        with self._lock:
            record = self._learners.get(result.learner_id)
            if record is None:
                return
            self._current_meta.train_received_at[result.learner_id] = start
            self._current_meta.uplink_bytes[result.learner_id] = len(
                result.model)
        try:
            model = self._parse_result_model(result)
        except ValueError as exc:
            # a malformed payload costs its own contribution, not the round
            logger.warning("dropping malformed result from %s for task %s: "
                           "%s", result.learner_id, result.task_id, exc)
            with self._lock:
                self._current_meta.errors.append(
                    f"malformed result from {result.learner_id}: {exc}")
            model = None
        if model is not None and self._ingest is not None:
            # enqueue and go on: the writer records the write's own time
            # (_note_ingest_insert) and applies the result's metadata only
            # when the write lands (_ingest_landed); aggregation fences on
            # the drain before its select
            self._ingest.submit(result.learner_id, model,
                                on_success=partial(self._ingest_landed,
                                                   result))
        elif model is not None:
            self._store.insert(result.learner_id, model)
            with self._lock:
                record.completed_batches = result.completed_batches
        with self._lock:
            meta = self._current_meta
            meta.model_insertion_duration_ms[result.learner_id] = (
                (time.time() - start) * 1e3)
            finite = finite_metrics(result.train_metrics)
            if finite:
                meta.train_metrics[result.learner_id] = finite
            if isinstance(result.epoch_metrics, (list, tuple)):
                meta.epoch_metrics[result.learner_id] = [
                    finite_metrics(epoch) for epoch in result.epoch_metrics]
        to_schedule = self._scheduler.schedule_next(
            result.learner_id, self.active_learners())
        if to_schedule:
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
            self._complete_round(cohort)
        elif self._scheduler.round_stalled(active):
            # every dispatched learner departed: abandon the round and
            # dispatch a fresh sample to the survivors
            logger.info("round abandoned (dispatched cohort left); "
                        "re-dispatching")
            self._scheduler.reset()
            self._dispatch_train(self._sample_cohort())

    def _parse_result_model(self, result: TaskResult) -> Dict[str, np.ndarray]:
        """Uplink wire bytes → flat ``{name: np.ndarray}`` (host numpy: the
        store and the fold stay on the host)."""
        blob = ModelBlob.from_bytes(result.model)
        if blob.opaque:
            raise ValueError("opaque (encrypted/masked) payloads are not "
                             "ported")
        return {name: to_numpy(t) for name, t in blob.tensors}

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
            with self._lock:
                self._current_meta.errors.append(
                    f"aggregation failed: {exc!r}")
            if self._agg_failures >= self._MAX_AGG_FAILURES:
                logger.error("aggregation failed %d consecutive times (%r); "
                             "halting re-dispatch", self._agg_failures, exc)
                return
            logger.warning("aggregation failed (%r); re-dispatching", exc)
            if not self._shutdown.is_set():
                self._scheduler.reset()
                self._dispatch_train(self._sample_cohort())
            return
        self._agg_failures = 0
        self._send_eval_tasks()
        with self._lock:
            self.global_iteration += 1
            self._current_meta.completed_at = time.time()
            self._current_meta.peak_rss_kb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
            self.round_metadata.append(self._current_meta)
            self._current_meta = RoundMetadata(
                global_iteration=self.global_iteration)
        if self._shutdown.is_set():
            return
        self._dispatch_train(self._sample_cohort())

    def _sample_cohort(self) -> List[str]:
        """Next round's participants (``participation_ratio`` of the
        active learners; the barrier is the dispatched sample)."""
        pool = self.active_learners()
        ratio = self.config.aggregation.participation_ratio
        if ratio >= 1.0 or not pool:
            return pool
        k = max(1, int(round(ratio * len(pool))))
        return random.sample(pool, k)

    # -- aggregation ------------------------------------------------------

    def _scaling_metadata(self, selected: Sequence[str]
                          ) -> Dict[str, Dict[str, float]]:
        # a learner may leave between selection and aggregation
        with self._lock:
            return {
                lid: {"num_train_examples": r.num_train_examples,
                      "completed_batches": r.completed_batches}
                for lid, r in ((lid, self._learners.get(lid))
                               for lid in selected)
                if r is not None
            }

    def _compute_community_model(self, selected: Sequence[str]) -> None:
        """Stride-blocked FedAvg over the store: only one block of
        ``stride_length`` models (plus the accumulator) is resident at a
        time."""
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
        lineage_k = self._aggregator.required_lineage
        stride = self.config.aggregation.stride_length or len(selected) or 1
        metadata = self._scaling_metadata(selected)
        scales = self._scaler(metadata)
        ids = [lid for lid in selected if lid in scales]
        block_sizes: List[int] = []
        block_ms: List[float] = []
        self._aggregator.reset()
        accumulated = 0
        select_ms = 0.0
        for i in range(0, len(ids), stride):
            b0 = time.perf_counter()
            block = ids[i: i + stride]
            picked = self._store.select(block, k=lineage_k)
            select_ms += (time.perf_counter() - b0) * 1e3
            pairs = [(picked[lid], scales[lid]) for lid in block
                     if lid in picked]
            if pairs:
                self._aggregator.accumulate(pairs)
                accumulated += len(pairs)
            block_sizes.append(len(block))
            block_ms.append((time.perf_counter() - b0) * 1e3)
        if not accumulated:
            logger.warning("no stored models for cohort %s", list(selected))
            return
        community = self._aggregator.result()
        self._aggregator.reset()
        p0 = time.perf_counter()
        blob = self._community_to_blob(community)
        pack_ms = (time.perf_counter() - p0) * 1e3
        agg_ms = (time.perf_counter() - t0) * 1e3
        sizes = {"values": 0, "non_zeros": 0, "zeros": 0, "bytes": 0}
        for arr in community.values():
            q = quantify(arr)
            for key in sizes:
                sizes[key] += q[key]
        with self._lock:
            self._community_blob = blob
            meta = self._current_meta
            meta.selected_learners = list(selected)
            meta.scales = {lid: round(float(w), 6)
                           for lid, w in scales.items()}
            meta.aggregation_block_sizes = block_sizes
            meta.aggregation_block_duration_ms = block_ms
            meta.aggregation_duration_ms = agg_ms
            meta.community_pack_duration_ms = pack_ms
            meta.ingest_drain_duration_ms = drain_ms
            meta.store_select_duration_ms = select_ms
            meta.model_size = sizes

    def _community_to_blob(self, community: Dict[str, np.ndarray]) -> bytes:
        return ModelBlob(tensors=list(community.items())).to_bytes()

    # -- dispatch ---------------------------------------------------------

    def _dispatch_train(self, learner_ids: Sequence[str]) -> None:
        """Send the community model to ``learner_ids`` as train tasks; the
        dispatched set is the round barrier. Nothing is sent once
        ``termination.federation_rounds`` rounds have completed."""
        limit = self.config.termination.federation_rounds
        with self._lock:
            if 0 < limit <= self.global_iteration:
                return
            blob = self._community_blob
        if blob is None:
            logger.warning("no community model yet; cannot dispatch train "
                           "tasks")
            return
        t0 = time.perf_counter()
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
                # no device-utilization plane in the port
                params.device_stats = False
                task = TrainTask(
                    task_id=uuid.uuid4().hex,
                    learner_id=lid,
                    round_id=self.global_iteration,
                    global_iteration=self.global_iteration,
                    model=blob,
                    params=params,
                    controller_epoch=self.controller_epoch,
                )
                self._current_meta.train_submitted_at[lid] = time.time()
                proxy = record.proxy
            try:
                proxy.run_task(task)
            except Exception:
                logger.exception("train dispatch to %s failed", lid)
        with self._lock:
            self._current_meta.dispatch_duration_ms += (
                (time.perf_counter() - t0) * 1e3)

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
                controller_epoch=self.controller_epoch,
            )
            with self._lock:
                meta.eval_submitted_at[record.learner_id] = time.time()

            def _digest(result: EvalResult, lid=record.learner_id,
                        entry=entry, meta=meta):
                with self._lock:
                    entry["evaluations"][lid] = result.evaluations
                    meta.eval_received_at[lid] = time.time()

            try:
                record.proxy.evaluate(task, _digest)
            except Exception:
                logger.exception("eval dispatch to %s failed",
                                 record.learner_id)

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
        """A live snapshot: the round, the protocol, the learners and the
        community model's size."""
        with self._lock:
            blob = self._community_blob
            return {
                "global_iteration": self.global_iteration,
                "protocol": self.config.protocol,
                "controller_epoch": self.controller_epoch,
                "learners": [{"learner_id": r.learner_id,
                              "hostname": r.hostname, "port": r.port,
                              "num_train_examples": r.num_train_examples}
                             for r in self._learners.values()],
                # dispatched this round and not yet reported back
                "in_flight": sorted(
                    set(self._current_meta.train_submitted_at)
                    - set(self._current_meta.train_received_at)),
                "community_model_bytes": len(blob) if blob else 0,
            }

    def get_statistics(self) -> dict:
        with self._lock:
            return {
                "global_iteration": self.global_iteration,
                "learners": sorted(self._learners.keys()),
                "round_metadata": [m.to_dict() for m in self.round_metadata],
                "community_evaluations": self._snapshot_evaluations(),
            }
