"""Learner runtime: runs train and eval tasks against local data.

The port's copy of the JAX package's ``learner/learner.py`` for the
synchronous round: join the federation, run a train task on one worker
thread (a new task cancels the running one between steps), ship the
trained weights back as a ModelBlob, evaluate community models, and run
inference tasks (logits, or greedy generation) on a shipped model. The
engine is a :class:`~metisfl_tpu_torch.models.ops.TorchModelOps` on the
device its caller chose; weights move by value through the wire blob.

The uplink variants, host numpy as in the JAX package:

- SCAFFOLD (``task.scaffold``): the server variate ``c`` rides on the
  task; the learner trains with ``c - c_i`` added to every gradient and
  ships the control delta of its Option-II update
  ``c_i+ = c_i - c + (x - y) / (K lr)`` (SGD local steps assumed).
- Client-level DP (``dp_clip_norm``, ``dp_noise_multiplier``): the update
  is clipped and noised (secure/dp.py) before anything else touches it.
- ``ship_dtype``: a float dtype narrows the uplink; ``int8q`` quantizes it
  (tensor/quantize.py); ``topk<D>`` ships the update's top entries with
  an error-feedback residual kept across rounds (tensor/sparse.py),
  against the exact wire tensors of the dispatched model.
- ``local_tensor_regex`` (FedBN): matching tensors never ship and keep
  this learner's values across community installs.
- ``ship_tensor_regex``: only matching tensors ship; the community blob
  carries that subset, and the rest is filled from the engine's base
  (every learner holds the same frozen base).

Secure aggregation: with a ``secure_backend`` (secure/) the learner
encrypts or masks every uplink tensor from its float64 values, in the
tensor order of the wire, and decrypts an opaque community model into
the engine's dtypes; a masking backend starts each train task's round
(``begin_round``), joins with its party index, and computes a dropped
party's residual on request (:meth:`Learner.recover_masks`). The backend
is host numpy: no secure work runs on the card.

Controller failover: the learner remembers the ``controller_epoch`` it
joined under. A task stamped with another epoch (a restarted or promoted
controller) makes it re-attach first (:meth:`Learner.reattach`: join
again with its id and token, which a restored registry recognizes); a
completion the controller rejects or cannot take makes it re-attach and
resubmit once under the refreshed credentials. ``on_join`` sees every
re-attach's reply (the learner process saves its credentials there). A
learner that left on purpose never re-attaches.

Telemetry, the JAX package's: the train, step, compile, task, eval,
re-attach and mask-generation metrics; a ``learner.train`` span per task
parented under the dispatch's trace context (the controller's round span,
carried over gRPC or in process) with its load, train-steps and dump
spans, and a ``learner.eval`` span; ``EpochChanged`` events; the device
stats (``DeviceMonitor``: step-time EWMA, MFU over the card's peak, the
device-memory high-water mark) in ``TaskResult.device_stats``; and a
``torch.profiler`` capture under ``TrainParams.profile_dir``, per learner.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Protocol

import numpy as np
import torch

from metisfl_tpu_torch import chaos as _chaos
from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    InferResult,
    InferTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainTask,
)
from metisfl_tpu_torch.models.dataset import ArrayDataset
from metisfl_tpu_torch.secure.dp import privatize_update
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    as_tensor,
    named_tensors_to_pytree,
    narrow_tensors,
    pytree_to_named_tensors,
    tensor_from_float64,
    to_numpy,
    tree_map,
    wire_dtype_of,
)
from metisfl_tpu_torch.tensor.quantize import SHIP_INT8Q, quantize_named
from metisfl_tpu_torch.tensor.sparse import parse_topk, sparsify_update
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import profile as _tprofile
from metisfl_tpu_torch.telemetry import trace as _ttrace
from metisfl_tpu_torch.tensor.spec import (
    TensorKind,
    TensorSpec,
    resolve_ship_dtype,
)

logger = logging.getLogger("metisfl_tpu_torch.learner")

_REG = _tmetrics.registry()
_M_TRAIN_DURATION = _REG.histogram(
    _tel.M_LEARNER_TRAIN_DURATION_SECONDS, "End-to-end train-task time")
_M_TRAIN_STEP_MS = _REG.histogram(
    _tel.M_LEARNER_STEP_MILLISECONDS, "Median per-optimizer-step time",
    buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
             5000))
_M_JIT_COMPILE = _REG.histogram(
    _tel.M_LEARNER_JIT_COMPILE_SECONDS,
    "Estimated jit-compile overhead per train task (task wall-clock "
    "minus steps x steady-state step time)")
_M_TASKS = _REG.counter(
    _tel.M_LEARNER_TASKS_TOTAL, "Train tasks by outcome",
    ("outcome",))
_M_EVALS = _REG.histogram(
    _tel.M_LEARNER_EVAL_DURATION_SECONDS, "Community-model evaluation time")
_M_REATTACH = _REG.counter(
    _tel.M_LEARNER_REATTACH_TOTAL,
    "Re-attach joins after a controller crash/restart was detected",
    ("reason",))
_M_MASK_GEN = _REG.histogram(
    _tel.M_SECURE_MASK_GEN_SECONDS,
    "Secure-uplink encode time per train task: fixed-point encoding + "
    "pairwise mask stream generation (secure/distributed.py)")


class ControllerProxy(Protocol):
    """Learner → controller transport."""

    def join(self, request: JoinRequest) -> JoinReply: ...
    def leave(self, learner_id: str, auth_token: str) -> bool: ...
    def task_completed(self, result: TaskResult) -> bool: ...


def check_train_task(task: TrainTask) -> None:
    """Refuse, before any training is paid for, a task whose ship dtype
    or tensor regex cannot work (``ValueError``): an unknown dtype name, a
    malformed top-k denominator, a regex that does not compile."""
    params = task.params
    if params.ship_dtype:
        if (params.ship_dtype.lower() != SHIP_INT8Q
                and parse_topk(params.ship_dtype) is None):
            resolve_ship_dtype(params.ship_dtype)
    for field_name in ("local_tensor_regex", "ship_tensor_regex"):
        pattern = getattr(params, field_name)
        if pattern:
            try:
                re.compile(pattern)
            except re.error as exc:
                raise ValueError(
                    f"{field_name} does not compile: {exc}") from None


def _host(tree):
    """A tree of tensors (or arrays) as host numpy arrays."""
    return tree_map(lambda a: to_numpy(a) if isinstance(a, torch.Tensor)
                    else np.asarray(a), tree)


def _named_copies(tree):
    """``[(name, numpy copy)]`` of a variables tree (the engine's arrays on
    the CPU share its parameters' memory, which training updates in
    place)."""
    return [(n, np.array(to_numpy(t)))
            for n, t in pytree_to_named_tensors(tree)]


class Learner:
    def __init__(
        self,
        model_ops,
        train_dataset: ArrayDataset,
        controller: ControllerProxy,
        val_dataset: Optional[ArrayDataset] = None,
        test_dataset: Optional[ArrayDataset] = None,
        hostname: str = "localhost",
        port: int = 0,
        secure_backend=None,
    ):
        self.model_ops = model_ops
        self.secure_backend = secure_backend
        self.datasets: Dict[str, Optional[ArrayDataset]] = {
            "train": train_dataset,
            "valid": val_dataset,
            "test": test_dataset,
        }
        self.controller = controller
        self.hostname = hostname
        self.port = port
        self.learner_id: str = ""
        self.auth_token: str = ""
        # the controller incarnation joined under: a task of another epoch
        # means the controller restarted, and the learner re-attaches
        self.controller_epoch: str = ""
        # called with the JoinReply after every re-attach (the learner
        # process saves its credentials there)
        self.on_join: Optional[Callable[[JoinReply], None]] = None
        # the bounded re-attach loop
        self.reattach_retries = 10
        self.reattach_backoff_s = 1.0
        # a deliberate leave: a straggling completion rejected after it
        # must not re-register the learner (reset by the next join)
        self._left = False
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="learner-train")
        self._cancel = threading.Event()
        self._task_lock = threading.Lock()
        self._current_future = None
        self._shutdown = threading.Event()
        # the engine's variables tree with each leaf's torch dtype: the
        # structure wire tensors are rebuilt into, and the training dtypes
        # a narrower community blob is widened back to
        initial = model_ops.get_variables()
        self._dtypes_like = tree_map(lambda a: as_tensor(a).dtype, initial)
        # the same tree as f32 meta tensors (shapes, no memory)
        self._shapes_like = tree_map(
            lambda a: torch.empty(np.shape(a), device="meta"), initial)
        self._names = [n for n, _ in pytree_to_named_tensors(
            self._shapes_like)]
        # SCAFFOLD's client variate c_i (params-shaped f32, zeros until the
        # first scaffold task; in memory only, as in the JAX package)
        self._scaffold_ci = None
        # top-k uplinks' error-feedback residuals {tensor name: flat f32}
        self._ef_residual: Dict[str, np.ndarray] = {}
        # FedBN (local_tensor_regex): the learner's own copies of its local
        # tensors, refreshed on the train thread after each task (evals run
        # concurrently with training and read only this dict), and the
        # regex they were taken under
        self._local_regex: str = ""
        self._local_values: Dict[str, np.ndarray] = {}
        self._snapshot_regex: str = ""
        # ship-only subsets (ship_tensor_regex): the tensors that never
        # federate, taken from the engine once (its frozen base), which
        # fill every community blob's missing names
        self._ship_regex: str = ""
        self._frozen_base: Optional[tuple] = None   # (regex, {name: array})
        self._warned_unfrozen = False
        # the device stats' monitor, built on the first task that asks
        self._device_monitor = None

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #

    def join_federation(self, previous_id: str = "",
                        auth_token: str = "") -> JoinReply:
        capabilities = {}
        party_index = getattr(self.secure_backend, "party_index", None)
        if party_index is not None and hasattr(self.secure_backend,
                                               "recovery_correction"):
            # masking: the controller maps learner ids to mask parties to
            # ask for a dropped party's residual
            capabilities["party_index"] = int(party_index)
        reply = self.controller.join(JoinRequest(
            hostname=self.hostname,
            port=self.port,
            num_train_examples=len(self.datasets["train"]),
            num_val_examples=len(self.datasets["valid"] or []),
            num_test_examples=len(self.datasets["test"] or []),
            previous_id=previous_id,
            auth_token=auth_token,
            capabilities=capabilities,
        ))
        self.learner_id = reply.learner_id
        self.auth_token = reply.auth_token
        if reply.controller_epoch:
            if (self.controller_epoch
                    and reply.controller_epoch != self.controller_epoch):
                # which controller each of this learner's tasks belonged to
                _tevents.emit(_tevents.EpochChanged,
                              learner_id=reply.learner_id,
                              old_epoch=self.controller_epoch[:8],
                              new_epoch=reply.controller_epoch[:8],
                              reason="join_reply")
            self.controller_epoch = reply.controller_epoch
        self._left = False
        return reply

    def leave_federation(self) -> bool:
        if not self.learner_id:
            return False
        self._left = True
        return self.controller.leave(self.learner_id, self.auth_token)

    # ------------------------------------------------------------------ #
    # controller-failover re-attach
    # ------------------------------------------------------------------ #

    def reattach(self, reason: str) -> bool:
        """Join again as ourselves after losing the controller (a
        completion rejected or undeliverable, or a task of another epoch).
        A controller that restored its registry keeps our identity, party
        index included; one that lost it gives a new identity, which we
        adopt and hand to ``on_join``."""
        previous_id, token = self.learner_id, self.auth_token
        for attempt in range(1, max(1, self.reattach_retries) + 1):
            if self._shutdown.is_set():
                return False
            try:
                reply = self.join_federation(previous_id=previous_id,
                                             auth_token=token)
            except Exception as exc:  # noqa: BLE001 - retried
                logger.warning("%s: re-attach attempt %d/%d failed: %s",
                               previous_id, attempt, self.reattach_retries,
                               exc)
                self._shutdown.wait(self.reattach_backoff_s)
                continue
            _M_REATTACH.inc(reason=reason)
            logger.info(
                "%s: re-attached to controller (epoch %s, rejoined=%s, "
                "reason=%s)", self.learner_id,
                (reply.controller_epoch or "?")[:8], reply.rejoined, reason)
            if self.on_join is not None:
                try:
                    self.on_join(reply)
                except Exception:  # noqa: BLE001 - persistence best-effort
                    logger.exception("on_join callback failed")
            return True
        logger.error("%s: re-attach gave up after %d attempts (reason=%s)",
                     previous_id, self.reattach_retries, reason)
        return False

    def _check_controller_epoch(self, task_epoch: str) -> None:
        """A task stamped with another controller incarnation than the one
        we joined: the controller restarted, so refresh the registration
        instead of trusting the stale one."""
        if (task_epoch and self.controller_epoch
                and task_epoch != self.controller_epoch):
            logger.warning(
                "%s: task from controller epoch %s but joined under %s; "
                "re-attaching", self.learner_id, task_epoch[:8],
                self.controller_epoch[:8])
            _tevents.emit(_tevents.EpochChanged,
                          learner_id=self.learner_id,
                          old_epoch=self.controller_epoch[:8],
                          new_epoch=task_epoch[:8],
                          reason="task_envelope")
            self.reattach("epoch_mismatch")

    def _report_completion(self, result: TaskResult) -> bool:
        """Deliver a TaskResult through a controller crash between the
        dispatch and the completion: on a transport failure or a rejection,
        re-attach and resubmit once under the refreshed credentials (the
        new incarnation keeps the model as a late contribution)."""
        try:
            if self.controller.task_completed(result):
                return True
            if self._left or self._shutdown.is_set():
                # rejected because we left or stop: not a controller fault
                return False
            reason = "completion_rejected"
            logger.warning("%s: completion for task %s rejected; "
                           "re-attaching", self.learner_id, result.task_id)
        except Exception as exc:  # noqa: BLE001 - a transport failure
            if self._left or self._shutdown.is_set():
                return False
            reason = "completion_unavailable"
            logger.warning("%s: completion for task %s undeliverable (%s); "
                           "re-attaching", self.learner_id, result.task_id,
                           exc)
        if not self.reattach(reason):
            logger.error("%s: dropping the result of task %s (re-attach "
                         "failed)", self.learner_id, result.task_id)
            return False
        result = dataclasses.replace(result, learner_id=self.learner_id,
                                     auth_token=self.auth_token)
        try:
            return bool(self.controller.task_completed(result))
        except Exception:  # noqa: BLE001 - the round deadline recovers
            logger.exception("%s: completion resubmit failed for task %s",
                             self.learner_id, result.task_id)
            return False

    # ------------------------------------------------------------------ #
    # model wire I/O
    # ------------------------------------------------------------------ #

    def _load_model(self, blob_bytes: bytes, with_wire: bool = False):
        """Wire blob → variables tree of (CPU) tensors in the engine's
        training dtypes (a community model may arrive narrower, or opaque
        under secure aggregation: decrypted into its plaintext dtypes),
        with this learner's local tensors and the frozen base merged in.
        With ``with_wire`` also the wire-dtype tensors by name as numpy,
        which a top-k update differences against (the controller densifies
        against those exact values)."""
        blob = ModelBlob.from_bytes(blob_bytes)
        named = blob.tensors
        if blob.opaque:
            if self.secure_backend is None:
                raise RuntimeError("received an encrypted model without a "
                                   "secure backend")
            named = [(name, tensor_from_float64(
                spec, self.secure_backend.decrypt(payload, spec.size)))
                for name, (payload, spec) in blob.opaque.items()]
        named = self._merge_frozen(self._merge_local(named))
        tree = named_tensors_to_pytree(
            [(n, as_tensor(t)) for n, t in named], self._dtypes_like)
        tree = tree_map(lambda a, dt: a if a.dtype == dt else a.to(dt),
                        tree, self._dtypes_like)
        if with_wire:
            return tree, {n: to_numpy(as_tensor(t)) for n, t in named}
        return tree

    def _merge_local(self, named):
        """FedBN: the local tensors a community blob leaves out, from this
        learner's own copies."""
        if not self._local_regex:
            return named
        have = {n for n, _ in named}
        return list(named) + [(n, a) for n, a in self._local_values.items()
                              if n not in have]

    def _merge_frozen(self, named):
        """Ship-only subsets: the names a community blob leaves out that
        never federate, from the frozen base. Only non-matching names fill
        in, so a blob missing a federated tensor still fails."""
        if not self._ship_regex:
            return named
        have = {n for n, _ in named}
        return list(named) + [(n, a) for n, a in self._base().items()
                              if n not in have]

    def _base(self) -> Dict[str, np.ndarray]:
        """The engine's tensors outside ``ship_tensor_regex``, copied once
        per regex, before the first install that needs them: under the
        engine's ``trainable_regex`` freeze they never change."""
        if self._frozen_base is None or self._frozen_base[0] != \
                self._ship_regex:
            self._frozen_base = (self._ship_regex, {
                name: arr for name, arr in _named_copies(
                    self.model_ops.get_variables())
                if not re.search(self._ship_regex, name)})
        return self._frozen_base[1]

    def _snapshot_local(self) -> None:
        """Refresh the local tensors' copies from the engine (on the train
        thread, with no step in flight)."""
        if not self._local_regex:
            self._local_values, self._snapshot_regex = {}, ""
            return
        self._local_values = {
            name: arr for name, arr in _named_copies(
                self.model_ops.get_variables())
            if re.search(self._local_regex, name)}
        self._snapshot_regex = self._local_regex

    def _adopt_local_regex(self, regex: str) -> None:
        """Take the FedBN regex from an eval task (a learner that has not
        trained yet still receives round-2+ blobs without its local
        tensors) and snapshot its local tensors from the engine if none
        were taken under it (a train task's own snapshot, taken after its
        steps, supersedes this one)."""
        if regex:
            self._local_regex = regex
        if not self._local_regex or self._snapshot_regex == self._local_regex:
            return
        with self._task_lock:
            self._snapshot_local()

    def _keep_ship(self, named):
        """Uplink filter: only ``ship_tensor_regex`` matches federate."""
        if not self._ship_regex:
            return named
        kept = [(n, a) for n, a in named if re.search(self._ship_regex, n)]
        if not kept:
            raise ValueError(
                f"ship_tensor_regex {self._ship_regex!r} matches no "
                "tensor: nothing would ever be aggregated")
        return kept

    def _drop_local(self, named):
        """Uplink filter: local tensors never ship."""
        if not self._local_regex:
            return named
        kept = [(n, a) for n, a in named
                if not re.search(self._local_regex, n)]
        if not kept:
            raise ValueError(
                f"local_tensor_regex {self._local_regex!r} matches every "
                "tensor: nothing would ever be aggregated")
        return kept

    def _shipped(self, variables):
        """The named tensors of ``variables`` that ship."""
        return self._keep_ship(self._drop_local(
            pytree_to_named_tensors(variables)))

    def _dump_model(self, ship_dtype: str = "", variables=None) -> bytes:
        """The engine's weights (or ``variables``) as wire bytes: the
        shipped tensors, floating ones narrowed to ``ship_dtype`` or
        quantized under ``int8q``."""
        if variables is None:
            variables = self.model_ops.get_variables()
        named = self._shipped(variables)
        if self.secure_backend is not None:
            # one payload per tensor, in the wire's tensor order (a masking
            # backend derives each tensor's mask from its position)
            t0 = time.perf_counter()
            opaque = {}
            for name, t in named:
                t = as_tensor(t).detach().cpu()
                values = t.to(torch.float64).reshape(-1).numpy()
                opaque[name] = (self.secure_backend.encrypt(values),
                                TensorSpec(tuple(t.shape), wire_dtype_of(t),
                                           TensorKind.CIPHERTEXT))
            _M_MASK_GEN.observe(time.perf_counter() - t0)
            return ModelBlob(opaque=opaque).to_bytes()
        if ship_dtype and ship_dtype.lower() == SHIP_INT8Q:
            # int8 absmax: 4x less uplink than f32; the controller
            # dequantizes before it folds
            named = quantize_named([(n, to_numpy(t)) for n, t in named])
        elif ship_dtype:
            named = narrow_tensors(named, ship_dtype)
        return ModelBlob(tensors=named).to_bytes()

    def _dump_sparse(self, wire_ref, variables, denom: int) -> bytes:
        """The top-k update against the dispatched model's wire tensors,
        with the error-feedback residual carried across rounds."""
        named = [(n, to_numpy(t)) for n, t in self._shipped(variables)]
        return ModelBlob(tensors=sparsify_update(
            named, wire_ref, denom, self._ef_residual)).to_bytes()

    # -- SCAFFOLD ---------------------------------------------------------

    def _scaffold_offset(self, control_bytes: bytes):
        """(c, c - c_i) for this task, params-shaped f32 numpy trees. An
        empty control blob means c is still zero; c_i starts at zero."""
        shapes = self._shapes_like["params"]

        def zeros():
            return tree_map(lambda m: np.zeros(tuple(m.shape), np.float32),
                            shapes)

        if control_bytes:
            blob = ModelBlob.from_bytes(control_bytes)
            c = named_tensors_to_pytree(blob.tensors, shapes)
            c = tree_map(lambda a: np.asarray(to_numpy(a), np.float32), c)
        else:
            c = zeros()
        if self._scaffold_ci is None:
            self._scaffold_ci = zeros()
        offset = tree_map(lambda a, b: a - b, c, self._scaffold_ci)
        return c, offset

    def _scaffold_update(self, incoming, trained, params_cfg,
                         completed_steps: int, c) -> bytes:
        """Option-II variate update (Karimireddy et al., eq. 4):
        c_i+ = c_i - c + (x - y_i) / (K lr); ships dc = c_i+ - c_i. Host
        numpy float32 in the JAX package's order (the division stays off
        the card)."""
        k_lr = max(1, completed_steps) * float(params_cfg.learning_rate)
        x, y = incoming["params"], trained["params"]
        ci = self._scaffold_ci
        ci_new = tree_map(
            lambda ci_l, c_l, x_l, y_l: ci_l - c_l
            + (np.asarray(x_l, np.float32) - np.asarray(y_l, np.float32))
            / k_lr,
            ci, c, x, y)
        dc = tree_map(lambda a, b: a - b, ci_new, ci)
        self._scaffold_ci = ci_new
        return ModelBlob(tensors=pytree_to_named_tensors(dc)).to_bytes()

    # ------------------------------------------------------------------ #
    # task execution
    # ------------------------------------------------------------------ #

    def run_task(self, task: TrainTask) -> None:
        """Non-blocking: cancels any running training, schedules this one.
        A task that cannot work (``check_train_task``) raises here, on the
        caller's thread, before anything is scheduled."""
        if self._shutdown.is_set():
            return
        check_train_task(task)
        # the dispatch's span context (the controller's round, over gRPC
        # metadata or in process) travels to the train thread explicitly
        trace_ctx = _ttrace.current_context()
        with self._task_lock:
            if (self._current_future is not None
                    and not self._current_future.done()):
                self._cancel.set()
            self._current_future = self._executor.submit(
                self._train_and_report, task, trace_ctx)

    def _train_and_report(self, task: TrainTask, trace_ctx=None) -> None:
        self._cancel.clear()
        task_sp = _ttrace.span(
            "learner.train", parent=trace_ctx,
            attrs={"task_id": task.task_id, "round": task.round_id,
                   "learner": self.learner_id})
        with task_sp, task_sp.activate():
            self._run_train_task(task, task_sp)
        # the whole task: load, train, dump and report
        _M_TRAIN_DURATION.observe(task_sp.duration_ms / 1e3)

    def _run_train_task(self, task: TrainTask, task_sp) -> None:
        try:
            # before paying for training: a task of a restarted controller
            # refreshes the registration first
            self._check_controller_epoch(task.controller_epoch)
            params = task.params
            # the regexes before the load: round-2+ community blobs leave
            # out the local tensors and the frozen base, which the load
            # merges back
            self._local_regex = params.local_tensor_regex
            if self._local_regex != self._snapshot_regex:
                with self._task_lock:
                    self._snapshot_local()
            self._ship_regex = params.ship_tensor_regex
            # fail before paying for training: a regex that keeps nothing
            # to aggregate
            self._keep_ship(self._drop_local([(n, None)
                                              for n in self._names]))
            if self._ship_regex and not self._warned_unfrozen and not \
                    getattr(self.model_ops, "_trainable_regex", ""):
                self._warned_unfrozen = True
                logger.warning(
                    "%s: ship_tensor_regex=%r but the engine freezes "
                    "nothing (trainable_regex): tensors that never ship "
                    "train and are reset on every install", self.learner_id,
                    self._ship_regex)
            if params.profile_dir:
                # a subdirectory per learner keeps the captures
                # attributable (each capture has its own session dir)
                params = dataclasses.replace(
                    params, profile_dir=os.path.join(
                        params.profile_dir,
                        self.learner_id or f"port_{self.port}"))
            topk = parse_topk(params.ship_dtype) if params.ship_dtype \
                else None
            wire_ref = None
            load_sp = _ttrace.span("learner.load_model",
                                   attrs={"bytes": len(task.model)})
            with load_sp:
                if topk is not None and self.secure_backend is None:
                    incoming, wire_ref = self._load_model(task.model,
                                                          with_wire=True)
                else:
                    incoming = self._load_model(task.model)
                self.model_ops.set_variables(incoming)
            grad_offset = scaffold_c = None
            if task.scaffold or task.control:
                scaffold_c, grad_offset = self._scaffold_offset(task.control)
            elif self._scaffold_ci is not None:
                # the federation stopped running scaffold: a stale variate
                # must not keep correcting gradients
                self._scaffold_ci = None
            train_sp = _ttrace.span("learner.train_steps")
            with train_sp:
                out = self.model_ops.train(self.datasets["train"], params,
                                           cancel_event=self._cancel,
                                           grad_offset=grad_offset)
                train_sp.set_attr("steps", out.completed_steps)
                train_sp.set_attr("ms_per_step", round(out.ms_per_step, 3))
                # the task's wall-clock past its steady-state steps: the
                # warm-up (allocator, kernel builds), the JAX package's
                # compile estimate
                compile_s = max(0.0, train_sp.duration_ms / 1e3
                                - out.completed_steps * out.ms_per_step / 1e3)
                train_sp.set_attr("jit_compile_s_est", round(compile_s, 3))
            if out.completed_steps > 0 and out.ms_per_step > 0:
                _M_TRAIN_STEP_MS.observe(out.ms_per_step)
                _M_JIT_COMPILE.observe(compile_s)
            # the chaos ``slow`` fault: stretch this task's wall-clock by
            # the armed factor (a slow survivor, which only deadlines and
            # quorum barriers defend against); one attribute read when off
            injector = _chaos.get()
            if injector is not None:
                slow = injector.train_slowdown()
                if slow > 1.0:
                    time.sleep(min(300.0, (train_sp.duration_ms / 1e3)
                                   * (slow - 1.0)))
            device_stats = {}
            if (params.device_stats and out.completed_steps > 0
                    and out.ms_per_step > 0):
                device_stats = self._capture_device_stats(params, out)
            # training moved the local tensors (e.g. normalization
            # statistics): refresh the copies evals and later merges read
            with self._task_lock:
                self._snapshot_local()
            # masking: the round keys the task's mask streams
            if self.secure_backend is not None and hasattr(
                    self.secure_backend, "begin_round"):
                self.secure_backend.begin_round(task.round_id)
            if self._cancel.is_set():
                logger.info("%s: task %s cancelled", self.learner_id,
                            task.task_id)
                _M_TASKS.inc(outcome="cancelled")
                task_sp.set_attr("outcome", "cancelled")
                return
            # TrainOutput.variables already holds the trained weights on
            # the host: ship those rather than copying them out again
            trained = out.variables
            control_delta = b""
            if scaffold_c is not None:
                control_delta = self._scaffold_update(
                    _host(incoming), trained, params, out.completed_steps,
                    scaffold_c)
            if params.dp_clip_norm > 0.0:
                # client-level DP: clip and noise the update before any
                # encryption, masking or narrowing
                trained = privatize_update(
                    trained, _host(incoming), params.dp_clip_norm,
                    params.dp_noise_multiplier)
            dump_sp = _ttrace.span("learner.dump_model")
            with dump_sp:
                if wire_ref is not None:
                    model_bytes = self._dump_sparse(wire_ref, trained, topk)
                else:
                    model_bytes = self._dump_model(
                        ship_dtype=params.ship_dtype, variables=trained)
                dump_sp.set_attr("bytes", len(model_bytes))
            task_sp.set_attr("uplink_bytes", len(model_bytes))
            result = TaskResult(
                task_id=task.task_id,
                learner_id=self.learner_id,
                auth_token=self.auth_token,
                controller_epoch=task.controller_epoch,
                round_id=task.round_id,
                model=model_bytes,
                num_train_examples=len(self.datasets["train"]),
                completed_steps=out.completed_steps,
                completed_epochs=out.completed_epochs,
                completed_batches=out.completed_batches,
                processing_ms_per_step=out.ms_per_step,
                train_metrics=out.train_metrics,
                epoch_metrics=out.epoch_metrics,
                control_delta=control_delta,
                device_stats=device_stats,
            )
            self._report_completion(result)
            _M_TASKS.inc(outcome="completed")
            task_sp.set_attr("outcome", "completed")
        except Exception:
            _M_TASKS.inc(outcome="failed")
            task_sp.set_attr("outcome", "failed")
            logger.exception("%s: training task %s failed",
                             self.learner_id, task.task_id)

    def _capture_device_stats(self, params, out) -> Dict[str, float]:
        """One train task's device stats: the step-time EWMA, the MFU
        from the engine's FLOPs estimate, the device-memory high-water
        mark. Never raises."""
        try:
            if self._device_monitor is None:
                self._device_monitor = _tprofile.DeviceMonitor(
                    device=getattr(self.model_ops, "device", None))
            flops = 0.0
            step_flops = getattr(self.model_ops, "step_flops", None)
            if callable(step_flops):
                flops = float(step_flops(params.batch_size))
            return self._device_monitor.observe(
                steps=out.completed_steps, ms_per_step=out.ms_per_step,
                flops_per_step=flops)
        except Exception:  # noqa: BLE001 - telemetry never fails a task
            logger.exception("%s: device-stats capture failed",
                             self.learner_id)
            return {}

    def evaluate(self, task: EvalTask) -> EvalResult:
        """Blocking community-model evaluation over the requested
        datasets, on an explicit variables tree so a training task running
        meanwhile keeps the engine's own weights. The task's regexes say
        which tensors the community blob leaves out (a task without them
        clears them)."""
        t0 = time.time()
        eval_sp = _ttrace.span(
            "learner.eval", attrs={"task_id": task.task_id,
                                   "round": task.round_id,
                                   "learner": self.learner_id})
        with eval_sp, eval_sp.activate():
            self._check_controller_epoch(task.controller_epoch)
            self._adopt_local_regex(task.local_tensor_regex)
            self._ship_regex = task.ship_tensor_regex
            variables = self._load_model(task.model)
            evaluations: Dict[str, Dict[str, float]] = {}
            for name in task.datasets:
                ds = self.datasets.get(name)
                if ds is None or len(ds) == 0:
                    continue
                evaluations[name] = self.model_ops.evaluate(
                    ds, task.batch_size, task.metrics, variables=variables)
        _M_EVALS.observe(eval_sp.duration_ms / 1e3)
        return EvalResult(
            task_id=task.task_id,
            learner_id=self.learner_id,
            round_id=task.round_id,
            evaluations=evaluations,
            duration_ms=(time.time() - t0) * 1e3,
        )

    def infer(self, task: InferTask) -> InferResult:
        """Blocking inference on a shipped model: predictions over explicit
        inputs or a named local split, on a bound copy of the module so a
        training task running meanwhile keeps the engine's own weights.
        ``generate_tokens > 0`` makes it a greedy generation task on a
        causal-LM engine, in ``batch_size`` chunks (``temperature > 0``
        raises: sampled decoding is not ported)."""
        t0 = time.time()
        self._adopt_local_regex(task.local_tensor_regex)
        # unconditional, like evaluate: a regex-less task clears it
        self._ship_regex = task.ship_tensor_regex
        model = (self.model_ops.bind(self._load_model(task.model))
                 if task.model else None)
        if task.inputs:
            tensors = dict(ModelBlob.from_bytes(task.inputs).tensors)
            if "x" not in tensors:
                raise ValueError("InferTask.inputs must pack an 'x' tensor")
            x = to_numpy(tensors["x"])
        else:
            name = task.dataset or "test"
            ds = self.datasets.get(name)
            if ds is None or len(ds) == 0:
                raise ValueError(
                    f"inference requested on dataset {name!r} but this "
                    "learner has no such split (available: "
                    f"{[k for k, v in self.datasets.items() if v]})")
            x = ds.x
        if task.max_examples > 0:
            x = x[: task.max_examples]
        if task.generate_tokens > 0:
            # x is a (B, L) prompt batch; one KV cache per chunk, not one
            # unbounded (B, L + new) cache over a whole split
            prompts = np.asarray(x, np.int32)
            bs = max(1, int(task.batch_size))
            preds = np.concatenate([
                self.model_ops.generate(
                    prompts[i:i + bs], task.generate_tokens, model=model,
                    temperature=task.temperature,
                    eos_id=None if task.eos_id < 0 else task.eos_id)
                for i in range(0, len(prompts), bs)], axis=0)
        else:
            preds = self.model_ops.infer(x, task.batch_size, model=model)
        return InferResult(
            task_id=task.task_id,
            learner_id=self.learner_id,
            round_id=task.round_id,
            predictions=ModelBlob(
                tensors=[("predictions", np.asarray(preds))]).to_bytes(),
            num_examples=int(len(x)),
            duration_ms=(time.time() - t0) * 1e3,
        )

    def recover_masks(self, round_id: int, surviving, dropped,
                      lengths) -> list:
        """Masking dropout recovery: the dropped parties' residual mask of
        round ``round_id``, which any survivor can compute from the
        federation secret; the controller subtracts it from the partial
        sum. The backend refuses what would disclose a payload."""
        backend = self.secure_backend
        if backend is None or not hasattr(backend, "recovery_correction"):
            raise RuntimeError("this learner has no masking backend")
        return backend.recovery_correction(round_id, list(surviving),
                                           list(dropped), list(lengths))

    def shutdown(self) -> None:
        self._shutdown.set()
        self._cancel.set()
        self._executor.shutdown(wait=True)
