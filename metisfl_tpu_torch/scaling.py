"""Scaling functions: per-learner contribution weights.

The port's copy of the JAX package's ``scaling.py``. Each scaler maps
per-learner metadata to normalized weights that the aggregation rules
consume; weights always sum to 1 over the participating set.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

# learner_id -> metadata dict with keys: num_train_examples, completed_batches
Metadata = Mapping[str, Mapping[str, float]]


def participants_scaler(metadata: Metadata) -> Dict[str, float]:
    """Uniform 1/N weights."""
    n = len(metadata)
    if n == 0:
        return {}
    return {lid: 1.0 / n for lid in metadata}


def train_dataset_size_scaler(metadata: Metadata) -> Dict[str, float]:
    """Weights proportional to each learner's training-set size."""
    sizes = {lid: float(m.get("num_train_examples", 0)) for lid, m in metadata.items()}
    total = sum(sizes.values())
    if total <= 0:
        return participants_scaler(metadata)
    return {lid: s / total for lid, s in sizes.items()}


def staleness_factor(staleness: float, decay: float) -> float:
    """The polynomial staleness damping kernel: ``(1 + s)^-decay``
    (FedAsync / FedBuff staleness-aware scaling). ``staleness`` is the
    dispatch-version lag: how many rounds the community model advanced
    between the task's dispatch and its uplink landing (0 under a
    synchronous barrier). One definition shared by the batch path
    (:func:`apply_staleness_decay`) and the streaming fold."""
    if decay <= 0.0 or staleness <= 0.0:
        return 1.0
    return (1.0 + float(staleness)) ** -float(decay)


def apply_staleness_decay(scales: Dict[str, float], metadata: Metadata,
                          decay: float) -> Dict[str, float]:
    """Down-weight stale contributions: scale *= (1 + staleness)^-decay,
    renormalized. ``metadata[lid]["staleness"]`` is how many rounds behind
    the current community model a learner's latest contribution was
    computed (0 for everyone under a synchronous barrier: a no-op)."""
    damped = {
        lid: w * staleness_factor(
            float(metadata[lid].get("staleness", 0.0)), decay)
        for lid, w in scales.items()
    }
    total = sum(damped.values())
    if total <= 0.0:
        return scales
    return {lid: w / total for lid, w in damped.items()}


def batches_scaler(metadata: Metadata) -> Dict[str, float]:
    """Weights proportional to completed batches in the last task."""
    batches = {lid: float(m.get("completed_batches", 0)) for lid, m in metadata.items()}
    total = sum(batches.values())
    if total <= 0:
        return participants_scaler(metadata)
    return {lid: b / total for lid, b in batches.items()}


SCALERS: Dict[str, Callable[[Metadata], Dict[str, float]]] = {
    "participants": participants_scaler,
    "train_dataset_size": train_dataset_size_scaler,
    "batches": batches_scaler,
}


def raw_weight(scaler_name: str, entry: Mapping[str, float]) -> float:
    """Unnormalized contribution weight for ONE learner — a fold of
    uplinks as they arrive (the streaming tier, aggregation/streaming.py)
    happens before the cohort (and therefore the normalizer Σw) is
    known, so it uses raw weights and divides by z = Σw at finalize.
    Proportional to the batch scalers above within any one round (the
    community model is identical up to fp reassociation).

    A missing/zero quantity returns 0.0 — the batch scalers give that
    learner weight 0 whenever anyone in the cohort reported a positive
    quantity, so the streaming fold skips the contribution (scale-0
    parity). The scalers' cohort-WIDE degrade-to-uniform (every quantity
    zero) has no streaming analogue: all folds skip and the round
    completes without a model, which the caller logs."""
    name = scaler_name.lower()
    if name == "train_dataset_size":
        return float(entry.get("num_train_examples", 0.0))
    if name == "batches":
        return float(entry.get("completed_batches", 0.0))
    if name == "participants":
        return 1.0
    raise ValueError(f"unknown scaler {scaler_name!r}; have {sorted(SCALERS)}")


def make_scaler(name: str) -> Callable[[Metadata], Dict[str, float]]:
    try:
        return SCALERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown scaler {name!r}; have {sorted(SCALERS)}") from None
