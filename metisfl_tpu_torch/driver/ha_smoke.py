"""Controller-kill gate: a hot-standby federation against its control.

The port's copy of the JAX package's ``driver/ha_smoke.py``. A gRPC
federation (a controller process, a warm ``--standby``, two learner
processes, through ``DriverSession``) where the seeded chaos injector
kills the controller on its first ``MarkTaskCompleted``: mid-round, after
the dispatch, with uplinks in the air. The gate passes iff:

- the standby promotes itself (probe driven: WAL stall, then
  grpc.health.v1 escalation) and the driver hands the controller endpoint
  over (``session._standby_promoted``, and the promoted process's log
  says ``METISFL_TPU_CONTROLLER_PROMOTED``);
- every round completes without an operator;
- each round's registered community model is bit for bit the same-seed
  undisturbed control run's, which also has the standby armed and never
  promotes.

Bit identity is compared on round-pinned registry versions, not the live
community head: the federation keeps aggregating until shutdown, while
version ``k`` is exactly round ``k``'s aggregate in both runs. Two
learners keep the root fold order-free at the bit level (IEEE addition
commutes), so arrival order cannot move the bits; what the gate pins is
that promotion rebuilt the round state the bits depend on.

Not ported: the JAX gate's ``controller_failover`` event and metric
counts per role (ROADMAP.md Queue 1 item 4).

Run it::

    python -m metisfl_tpu_torch.driver.crossdevice --controller-smoke \\
        [--device cpu]
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np


def _recipe(idx: int, x, y, device: str):
    def recipe():
        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP

        ops = TorchModelOps(MLP(4, (8,), 2), rng_seed=0, device=device)
        return ops, ArrayDataset(x, y, seed=idx)

    return recipe


def _run_one(workdir: str, seed: int, rounds: int, kill: bool,
             timeout_s: float, device: str) -> Dict[str, Any]:
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        ChaosConfig,
        ControllerConfig,
        ControllerStandbyConfig,
        EvalConfig,
        FederationConfig,
        RegistryConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.driver.session import DriverSession, _free_port
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    recipes = []
    for idx in range(2):
        x = rng.standard_normal((32, 4)).astype(np.float32)
        y = np.argmax(x @ w, -1).astype(np.int32)
        recipes.append(_recipe(idx, x, y, device))
    template = TorchModelOps(MLP(4, (8,), 2), rng_seed=0,
                             device="cpu").get_variables()
    config = FederationConfig(
        controller_port=_free_port(),
        round_deadline_secs=60.0,
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        # round-pinned evidence: version k is round k-1's aggregate in both
        # runs; retention outlasts the rounds raced through between the
        # termination and the shutdown
        registry=RegistryConfig(enabled=True, retention=64),
        termination=TerminationConfig(
            federation_rounds=rounds,
            execution_cutoff_mins=max(1.0, timeout_s / 60.0)),
        controller=ControllerConfig(standby=ControllerStandbyConfig(
            enabled=True, stale_after_s=1.5, probe_interval_s=0.25,
            probe_failures=2)),
        chaos=ChaosConfig(enabled=kill, seed=seed, rules=([
            {"process": "controller", "side": "server", "fault": "kill",
             "method": "MarkTaskCompleted", "max_fires": 1}]
            if kill else [])),
    )
    session = DriverSession(config, template, recipes, workdir=workdir,
                            device=device)
    t0 = time.time()
    blobs: Dict[int, str] = {}
    missing = []
    completed = learners = 0
    promoted = promoted_logged = False
    try:
        session.initialize_federation()
        stats = session.monitor_federation(poll_every_s=0.5,
                                           eval_drain_timeout_s=0)
        for version in range(1, rounds + 1):
            raw = session._client.get_registered_model(version=version,
                                                       timeout=30.0)
            if not raw:
                missing.append(version)
            blobs[version] = hashlib.sha256(raw or b"").hexdigest()
        promoted = session._standby_promoted
        promoted_logged = session.standby_promoted_in_log()
        completed = int(stats.get("global_iteration", 0))
        learners = len(stats.get("learners", []))
    finally:
        session.shutdown_federation()
    return {
        "kill": kill,
        "seed": seed,
        "rounds_target": rounds,
        "rounds_completed": completed,
        "learners": learners,
        "promoted": promoted,
        "promoted_logged": promoted_logged,
        "exit_codes": session.process_exit_codes(),
        "model_sha256": blobs,
        "missing_versions": missing,
        "wall_s": round(time.time() - t0, 3),
        "ok": completed >= rounds and learners == 2 and not missing,
    }


def run_ha_smoke(rounds: int = 3, seed: int = 7, timeout_s: float = 240.0,
                 workdir: Optional[str] = None,
                 device: str = "cuda") -> Dict[str, Any]:
    """The kill run (the controller killed at its first uplink) against
    the same-seed undisturbed control, both with the standby armed.
    Passes iff the kill run promoted (and its promoted process logged it)
    and completed, the control never promoted, and every round-pinned
    community model matches bit for bit."""
    root = workdir or tempfile.mkdtemp(prefix="metisfl_torch_ha_")
    kill = _run_one(os.path.join(root, "kill"), seed, rounds, kill=True,
                    timeout_s=timeout_s, device=device)
    control = _run_one(os.path.join(root, "control"), seed, rounds,
                       kill=False, timeout_s=timeout_s, device=device)
    bit_identical = (bool(kill["model_sha256"])
                     and kill["model_sha256"] == control["model_sha256"])
    ok = (kill["ok"] and control["ok"]
          and kill["promoted"] and kill["promoted_logged"]
          and not control["promoted"]
          and bit_identical)
    return {"kill": kill, "control": control,
            "bit_identical": bit_identical, "workdir": root, "ok": ok}
