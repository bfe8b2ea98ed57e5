"""In-process federation: a controller and N learners in one process.

The port's copy of the JAX package's ``driver/inprocess.py``: real
training and real aggregation over direct-call proxies, with every model
round-tripped through the ModelBlob wire bytes as a remote federation
would. Each learner's engine runs on the device its caller chose
(``TorchModelOps(..., device="cuda")`` by default); ``device`` (``cuda``
by default) is the controller's, where the robust rules combine. Under
secure aggregation the controller takes a keyless ``secure_backend`` and
each learner its own (``add_learner(..., secure_backend=)``). Under
``aggregation.tree.distributed`` the controller dials the slice
aggregators that ``tree.slices`` names, as the config gives them (the
caller boots them, e.g. ``python -m metisfl_tpu_torch.aggregation.slice``).

One process, one telemetry context: the controller's round spans and the
learners' train spans share the registry and the sink, as in the JAX
package. The metrics and the journal follow this config's switches; the
tracer is reconfigured only when the config says something (a sink
directory, or an opt-out), so a default config keeps a sink the host
process set up.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

from metisfl_tpu_torch.comm.messages import EvalTask, TrainTask
from metisfl_tpu_torch.config import FederationConfig
from metisfl_tpu_torch.controller.core import (
    Controller,
    LearnerProxy,
    LearnerRecord,
)
from metisfl_tpu_torch.learner.learner import Learner
from metisfl_tpu_torch.tensor.pytree import pack_model


class _DirectLearnerProxy:
    """Controller → learner over direct calls; evaluation runs on a worker
    thread so dispatch stays non-blocking. Eval threads are tracked so
    shutdown can join them."""

    def __init__(self, get_learner: Callable[[], Learner]):
        self._get_learner = get_learner
        self._threads: List[threading.Thread] = []

    def run_task(self, task: TrainTask) -> None:
        self._get_learner().run_task(task)

    def recover_masks(self, round_id: int, surviving, dropped,
                      lengths) -> list:
        return self._get_learner().recover_masks(round_id, surviving,
                                                 dropped, lengths)

    def evaluate(self, task: EvalTask, callback) -> None:
        learner = self._get_learner()

        def _run():
            callback(learner.evaluate(task))

        thread = threading.Thread(target=_run, daemon=True)
        self._threads = [t for t in self._threads if t.is_alive()]
        self._threads.append(thread)
        thread.start()

    def join_evals(self, timeout_s: float = 30.0) -> None:
        deadline = time.time() + timeout_s
        for thread in self._threads:
            thread.join(timeout=max(0.1, deadline - time.time()))
        self._threads = [t for t in self._threads if t.is_alive()]


class InProcessFederation:
    """Wire a controller and learners with direct proxies and run rounds."""

    def __init__(self, config: FederationConfig, device: str = "cuda",
                 secure_backend=None):
        term = config.termination
        if term.execution_cutoff_mins > 0 or term.metric_cutoff_score > 0:
            raise NotImplementedError(
                "termination cutoffs are watched by DriverSession "
                "(driver/session.py, ROADMAP.md Queue 1 item 3a); the "
                "in-process federation cannot watch them")
        self.config = config
        from metisfl_tpu_torch import telemetry
        from metisfl_tpu_torch.telemetry import events as _tevents
        from metisfl_tpu_torch.telemetry import metrics as _tmetrics
        from metisfl_tpu_torch.telemetry import trace as _ttrace
        tel = config.telemetry
        _tmetrics.set_enabled(tel.enabled)
        _tevents.set_enabled(tel.enabled and tel.events.enabled)
        if tel.events.ring_size:
            _tevents.journal().set_ring_size(tel.events.ring_size)
        if not tel.enabled or tel.dir:
            telemetry.apply_config(tel, service="inprocess")
        else:
            # a prior opt-out run in this process must not stick
            _ttrace.set_enabled(True)
        self._learners_by_port: Dict[int, Learner] = {}
        self._proxies: List[_DirectLearnerProxy] = []
        self.controller = Controller(config, self._make_proxy,
                                     device=device,
                                     secure_backend=secure_backend)
        self.learners: List[Learner] = []

    def _make_proxy(self, record: LearnerRecord) -> LearnerProxy:
        port = record.port
        proxy = _DirectLearnerProxy(lambda: self._learners_by_port[port])
        self._proxies.append(proxy)
        return proxy

    def add_learner(self, model_ops, train_dataset, val_dataset=None,
                    test_dataset=None, secure_backend=None) -> Learner:
        port = 50100 + len(self.learners)
        learner = Learner(
            model_ops=model_ops,
            train_dataset=train_dataset,
            val_dataset=val_dataset,
            test_dataset=test_dataset,
            port=port,
            controller=self.controller,
            secure_backend=secure_backend,
        )
        self._learners_by_port[port] = learner
        self.learners.append(learner)
        return learner

    def seed_model(self, variables) -> None:
        """Ship the initial community model to the controller."""
        self.controller.set_community_model(pack_model(variables))

    def start(self) -> None:
        for learner in self.learners:
            learner.join_federation()

    def wait_for_rounds(self, rounds: int, timeout_s: float = 300.0) -> bool:
        """Block until ``rounds`` federation rounds completed."""
        return self.wait_until(
            lambda: self.controller.global_iteration >= rounds, timeout_s)

    def wait_for_evaluations(self, count: int = 1,
                             timeout_s: float = 120.0) -> bool:
        """Block until ``count`` rounds have learner evaluations back."""
        def _done():
            evals = [e for e in
                     self.controller.get_statistics()["community_evaluations"]
                     if e["evaluations"]]
            return len(evals) >= count
        return self.wait_until(_done, timeout_s)

    def wait_until(self, predicate: Callable[[], bool],
                   timeout_s: float = 300.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if predicate():
                return True
            time.sleep(0.02)
        return False

    def shutdown(self) -> None:
        for learner in self.learners:
            learner.shutdown()
        self.controller.shutdown()
        for proxy in self._proxies:
            proxy.join_evals()

    def statistics(self) -> dict:
        return self.controller.get_statistics()
