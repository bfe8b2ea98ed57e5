"""Secure-aggregation smoke: a masked federation with a mid-round dropout
against the same-seed plain control.

The port's copy of the JAX package's ``driver/secure_smoke.py``. The JAX
smoke reaches its partial cohort through a seeded chaos kill, a round
deadline and the distributed slice tier, none of which the port has yet
(ROADMAP.md Queue 1 items 3c, 3f and 4); the port's synchronous round
reaches one through a leave. So here three learner processes and a
controller process run two rounds through ``DriverSession`` over gRPC
under ``scheme: masking`` with ``aggregation.streaming`` (masked uplinks
fold on arrival at the controller), and learner 0 leaves the federation
while it trains round 1. The smoke passes iff:

- both runs complete every round;
- the masked run settled round 1 by recovering the departed party's
  masks from a survivor (``RecoverMasks``; the controller logs it);
- masks cancel: the masked run's final community model (the float64
  payloads SecureAgg outputs) matches the same-seed plain FedAvg run's
  within :data:`MASK_CANCEL_TOLERANCE`, where fixed-point encoding moves
  a value by ~1e-12 a round and a residual mask by ~1e7.

Run it::

    python -m metisfl_tpu_torch.driver.secure_smoke [--device cpu]

It prints one JSON object and exits 0 when the smoke passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

# fixed-point quantization is 2^-40 a value a round; a residual mask is
# O(2^24) after decoding. 1e-3 lies between the two regimes.
MASK_CANCEL_TOLERANCE = 1e-3
ROUNDS = 2
LEARNERS = 3
WAIT_S = 300.0


def _decode_community(raw: bytes) -> Dict[str, np.ndarray]:
    """A community blob as ``name -> float64 vector``, plaintext (the
    control) or the masking plane's opaque float64 payloads."""
    from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy

    blob = ModelBlob.from_bytes(raw)
    out: Dict[str, np.ndarray] = {}
    for name, t in blob.tensors:
        out[name] = np.asarray(to_numpy(t), np.float64).ravel()
    for name, (payload, _spec) in blob.opaque.items():
        out[name] = np.frombuffer(bytes(payload), np.float64).copy()
    return out


def _recipe(idx: int, x, y, device: str, gate: str, release: str):
    """Learner ``idx``: an MLP on ``device``. Training waits for ``gate``;
    learner 0's round-1 task also waits for ``release``, which the smoke
    writes once that learner has left the federation."""

    def recipe():
        import os
        import time

        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import MLP

        ops = TorchModelOps(MLP(4, (8,), 2), rng_seed=0, device=device)
        train, calls = ops.train, []

        def gated(dataset, params, *args, **kwargs):
            files = [gate] + ([release] if idx == 0 and calls else [])
            deadline = time.time() + WAIT_S
            while (not all(os.path.exists(f) for f in files)
                   and time.time() < deadline):
                time.sleep(0.05)
            calls.append(len(calls))
            return train(dataset, params, *args, **kwargs)

        ops.train = gated
        return ops, ArrayDataset(x, y, seed=idx)

    return recipe


def _run_one(workdir: str, seed: int, secure: bool,
             device: str) -> Dict[str, Any]:
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        SecureAggConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.driver.session import DriverSession
    from metisfl_tpu_torch.learner.__main__ import load_credentials
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    os.makedirs(workdir, exist_ok=True)
    gate = os.path.join(workdir, "gate")
    release = os.path.join(workdir, "release")
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    recipes = []
    for i in range(LEARNERS):
        x = rng.standard_normal((32, 4)).astype(np.float32)
        y = np.argmax(x @ w, -1).astype(np.int32)
        recipes.append(_recipe(i, x, y, device, gate, release))
    template = TorchModelOps(MLP(4, (8,), 2), rng_seed=0,
                             device="cpu").get_variables()
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(
            rule="secure_agg" if secure else "fedavg",
            scaler="participants", streaming=True),
        secure=SecureAggConfig(enabled=secure, scheme="masking",
                               min_recovery_parties=2),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=ROUNDS))
    session = DriverSession(config, template, recipes, workdir=workdir,
                            device=device)
    t0 = time.time()
    client = None
    final = b""
    completed = 0
    try:
        session.initialize_federation()
        client = ControllerClient("localhost", config.controller_port)
        deadline = time.time() + WAIT_S
        while len(client.list_learners()) < LEARNERS:
            session._check_procs_alive()
            if time.time() > deadline:
                raise RuntimeError("the learners never all joined")
            time.sleep(0.1)
        open(gate, "w").close()
        while client.get_runtime_metadata(tail=1)["global_iteration"] < 1:
            session._check_procs_alive()
            if time.time() > deadline:
                raise RuntimeError("round 0 never completed")
            time.sleep(0.1)
        # learner 0 leaves while its round-1 task waits: round 1's cohort
        # is the two survivors
        learner_id, token = load_credentials(
            os.path.join(workdir, "learner_0_creds"))
        left = client.leave(learner_id, token)
        open(release, "w").close()
        stats = session.monitor_federation(poll_every_s=0.25,
                                           eval_drain_timeout_s=0)
        completed = int(stats.get("global_iteration", 0))
        final = client.get_community_model()
        cohorts = [len(m["selected_learners"])
                   for m in stats["round_metadata"]]
    finally:
        if client is not None:
            client.close()
        session.shutdown_federation()
    with open(os.path.join(workdir, "controller.log")) as f:
        log = f.read()
    return {
        "secure": secure,
        "rounds_completed": completed,
        "cohorts": cohorts,
        "left": left,
        "masks_recovered": log.count("masking dropout recovery"),
        "exit_codes": session.process_exit_codes(),
        "model": _decode_community(final) if final else {},
        "wall_s": round(time.time() - t0, 3),
    }


def run_secure_smoke(seed: int = 7, device: str = "cuda",
                     workdir: Optional[str] = None) -> Dict[str, Any]:
    """The masked run against the same-seed plain control (see the module
    docstring for what passes)."""
    root = workdir or tempfile.mkdtemp(prefix="metisfl_torch_secure_")
    masked = _run_one(os.path.join(root, "masked"), seed, True, device)
    control = _run_one(os.path.join(root, "control"), seed, False, device)
    a, b = masked.pop("model"), control.pop("model")
    diff = float("inf")
    if a and sorted(a) == sorted(b):
        diff = max(float(np.max(np.abs(a[k] - b[k]))) if a[k].size else 0.0
                   for k in a)
    masks_cancel = diff <= MASK_CANCEL_TOLERANCE
    ok = all(run["rounds_completed"] >= ROUNDS and run["left"]
             and run["cohorts"][:ROUNDS] == [LEARNERS, LEARNERS - 1]
             for run in (masked, control))
    ok = (ok and masked["masks_recovered"] >= 1
          and control["masks_recovered"] == 0 and masks_cancel)
    return {"masked": masked, "control": control, "max_abs_diff": diff,
            "tolerance": MASK_CANCEL_TOLERANCE, "masks_cancel": masks_cancel,
            "workdir": root, "ok": ok}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch.driver.secure_smoke")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--device", default="cuda",
                        help="where the learners train (cuda or cpu)")
    parser.add_argument("--workdir", default="")
    args = parser.parse_args(argv)
    out = run_secure_smoke(seed=args.seed, device=args.device,
                           workdir=args.workdir or None)
    print(json.dumps(out, default=str))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
