"""Learner runtime: runs train and eval tasks against local data.

The port's copy of the JAX package's ``learner/learner.py`` for the
synchronous round: join the federation, run a train task on one worker
thread (a new task cancels the running one between steps), ship the
trained weights back as a ModelBlob, and evaluate community models. The
engine is a :class:`~metisfl_tpu_torch.models.ops.TorchModelOps` on the
device its caller chose; weights move by value through the wire blob.

Secure aggregation: with a ``secure_backend`` (secure/) the learner
encrypts or masks every uplink tensor from its float64 values, in the
tensor order of the wire, and decrypts an opaque community model into
the engine's dtypes; a masking backend starts each train task's round
(``begin_round``), joins with its party index, and computes a dropped
party's residual on request (:meth:`Learner.recover_masks`). The backend
is host numpy: no secure work runs on the card.

Not ported yet, and refused when a task asks for them
(``NotImplementedError`` from :meth:`Learner.run_task` or
:meth:`Learner.evaluate`): SCAFFOLD control variates, client-level DP,
int8q/top-k uplinks, FedBN local tensors and ship-only-trainable subsets
(ROADMAP.md Queue 1 item 3e); controller-failover re-attach and telemetry
(items 3f and 4).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Protocol

import torch

from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainTask,
)
from metisfl_tpu_torch.models.dataset import ArrayDataset
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    as_tensor,
    named_tensors_to_pytree,
    narrow_tensors,
    pytree_to_named_tensors,
    tensor_from_float64,
    tree_map,
    wire_dtype_of,
)
from metisfl_tpu_torch.tensor.spec import (
    TensorKind,
    TensorSpec,
    resolve_ship_dtype,
)

logger = logging.getLogger("metisfl_tpu_torch.learner")


class ControllerProxy(Protocol):
    """Learner → controller transport."""

    def join(self, request: JoinRequest) -> JoinReply: ...
    def leave(self, learner_id: str, auth_token: str) -> bool: ...
    def task_completed(self, result: TaskResult) -> bool: ...


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to metisfl_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item})")


def check_train_task(task: TrainTask) -> None:
    """Refuse a train task that asks for a branch the port lacks, and a
    ship dtype whose name is unknown (``ValueError``), before any
    training is paid for."""
    params = task.params
    if task.scaffold or task.control:
        raise _not_ported("SCAFFOLD", "3e")
    if params.dp_clip_norm > 0.0 or params.dp_noise_multiplier > 0.0:
        raise _not_ported("client-level differential privacy", "3e")
    if params.local_tensor_regex or params.ship_tensor_regex:
        raise _not_ported("local_tensor_regex / ship_tensor_regex", "3e")
    if params.ship_dtype:
        name = params.ship_dtype.lower()
        if name == "int8q" or name.startswith("topk"):
            raise _not_ported(f"ship_dtype {params.ship_dtype!r}", "3e")
        resolve_ship_dtype(params.ship_dtype)


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
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="learner-train")
        self._cancel = threading.Event()
        self._task_lock = threading.Lock()
        self._current_future = None
        self._shutdown = threading.Event()
        # the engine's variables tree with each leaf's torch dtype: the
        # structure wire tensors are rebuilt into, and the training dtypes
        # a narrower community blob is widened back to
        self._dtypes_like = tree_map(lambda a: as_tensor(a).dtype,
                                     model_ops.get_variables())

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
        return reply

    def leave_federation(self) -> bool:
        if not self.learner_id:
            return False
        return self.controller.leave(self.learner_id, self.auth_token)

    # ------------------------------------------------------------------ #
    # model wire I/O
    # ------------------------------------------------------------------ #

    def _load_model(self, blob_bytes: bytes):
        """Wire blob → variables tree of (CPU) tensors in the engine's
        training dtypes (a community model may arrive narrower, or opaque
        under secure aggregation: decrypted into its plaintext dtypes)."""
        blob = ModelBlob.from_bytes(blob_bytes)
        named = blob.tensors
        if blob.opaque:
            if self.secure_backend is None:
                raise RuntimeError("received an encrypted model without a "
                                   "secure backend")
            named = [(name, tensor_from_float64(
                spec, self.secure_backend.decrypt(payload, spec.size)))
                for name, (payload, spec) in blob.opaque.items()]
        tree = named_tensors_to_pytree(named, self._dtypes_like)
        return tree_map(lambda a, dt: a if a.dtype == dt else a.to(dt),
                        tree, self._dtypes_like)

    def _dump_model(self, ship_dtype: str = "", variables=None) -> bytes:
        """The engine's weights (or ``variables``) as wire bytes, floating
        tensors narrowed to ``ship_dtype`` when one is set."""
        if variables is None:
            variables = self.model_ops.get_variables()
        named = pytree_to_named_tensors(variables)
        if self.secure_backend is not None:
            # one payload per tensor, in the wire's tensor order (a masking
            # backend derives each tensor's mask from its position)
            opaque = {}
            for name, t in named:
                t = as_tensor(t).detach().cpu()
                values = t.to(torch.float64).reshape(-1).numpy()
                opaque[name] = (self.secure_backend.encrypt(values),
                                TensorSpec(tuple(t.shape), wire_dtype_of(t),
                                           TensorKind.CIPHERTEXT))
            return ModelBlob(opaque=opaque).to_bytes()
        if ship_dtype:
            named = narrow_tensors(named, ship_dtype)
        return ModelBlob(tensors=named).to_bytes()

    # ------------------------------------------------------------------ #
    # task execution
    # ------------------------------------------------------------------ #

    def run_task(self, task: TrainTask) -> None:
        """Non-blocking: cancels any running training, schedules this one.
        A task asking for an unported branch raises here, on the caller's
        thread, before anything is scheduled."""
        if self._shutdown.is_set():
            return
        check_train_task(task)
        with self._task_lock:
            if (self._current_future is not None
                    and not self._current_future.done()):
                self._cancel.set()
            self._current_future = self._executor.submit(
                self._run_train_task, task)

    def _run_train_task(self, task: TrainTask) -> None:
        self._cancel.clear()
        try:
            params = task.params
            self.model_ops.set_variables(self._load_model(task.model))
            out = self.model_ops.train(self.datasets["train"], params,
                                       cancel_event=self._cancel)
            # masking: the round keys the task's mask streams
            if self.secure_backend is not None and hasattr(
                    self.secure_backend, "begin_round"):
                self.secure_backend.begin_round(task.round_id)
            if self._cancel.is_set():
                logger.info("%s: task %s cancelled", self.learner_id,
                            task.task_id)
                return
            # TrainOutput.variables already holds the trained weights on
            # the host: ship those rather than copying them out again
            model_bytes = self._dump_model(ship_dtype=params.ship_dtype,
                                           variables=out.variables)
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
            )
            if not self.controller.task_completed(result):
                logger.warning("%s: completion for task %s rejected",
                               self.learner_id, task.task_id)
        except Exception:
            logger.exception("%s: training task %s failed",
                             self.learner_id, task.task_id)

    def evaluate(self, task: EvalTask) -> EvalResult:
        """Blocking community-model evaluation over the requested
        datasets, on an explicit variables tree so a training task running
        meanwhile keeps the engine's own weights."""
        if task.local_tensor_regex or task.ship_tensor_regex:
            raise _not_ported("local_tensor_regex / ship_tensor_regex", "3e")
        t0 = time.time()
        variables = self._load_model(task.model)
        evaluations: Dict[str, Dict[str, float]] = {}
        for name in task.datasets:
            ds = self.datasets.get(name)
            if ds is None or len(ds) == 0:
                continue
            evaluations[name] = self.model_ops.evaluate(
                ds, task.batch_size, task.metrics, variables=variables)
        return EvalResult(
            task_id=task.task_id,
            learner_id=self.learner_id,
            round_id=task.round_id,
            evaluations=evaluations,
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
