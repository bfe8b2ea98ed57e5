"""Learning-health plane: per-update model statistics + divergence scores.

Fourth telemetry layer next to spans (how long), metrics (how much), and
events (what happened): *is the federation actually learning, and is any
learner pulling against it*. The systems planes can say a round took 4 s
and which learner straggled; nothing before this module watched the
content of the uplinks themselves. Robust aggregation rules
(:mod:`metisfl_tpu_torch.aggregation.robust`) silently *mask* diverging or
poisoned updates — this plane *measures and exposes* them, the
observability analogue of Krum: per-update norms, cohort alignment, and
a per-learner divergence score, normalized the same round-relative way
as the straggler score (controller/core.py ``_straggler_scores``).

Statistics (host numpy, read-only — the dtype-preserving aggregation
contract in :mod:`metisfl_tpu_torch.aggregation.base` is untouched), computed
per uplink against the community model the task trained from:

- ``update_norm`` — L2 norm of the flattened update ``u_i = w_i − w``;
- ``layer_norms`` — the same norm broken down per top-level layer
  (first two ``/``-separated name components), so a single exploding
  head/adapter is attributable;
- ``cos_prev_delta`` — cosine of ``u_i`` against the previous round's
  community delta (is this learner still pushing the direction the
  federation just moved, or against it).

At round completion the cohort folds: cosine of each update against the
cohort mean update, a deviation ``d_i = ‖u_i − ū‖``, and the **robust
z-score** ``z_i = (d_i − median d) / (1.4826·MAD + 0.05·median + ε)``
(median/MAD instead of mean/std so the outlier being scored cannot
inflate its own yardstick). Per-learner scores are the EWMA of
``max(z_i, 0)`` across rounds — like the straggler score, a recovered
learner decays back within a few rounds. A round whose raw ``z_i``
crosses ``anomaly_threshold`` emits an ``UpdateAnomalous`` event; every
round emits ``RoundHealth`` with the convergence snapshot (community
update norm, effective step size ``‖Δw‖/‖w‖``, participation entropy of
the applied scales, cohort train-loss quantiles from the
``TaskResult.train_metrics`` learners already ship).

Overhead contract: ``telemetry.health.enabled=false`` (or secure
aggregation, whose payloads are opaque ciphertext) leaves the
controller's monitor unset — the uplink hot path costs ONE attribute
check and performs no statistics work. Enabled, the per-uplink pass is
O(params) host work (``chip_smoke.py`` times it on every in-process
federation).
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("metisfl_tpu_torch.telemetry.health")

# EWMA blend weight and anomaly threshold defaults live in
# config/federation.py HealthConfig; these mirror them for direct use.
DEFAULT_ALPHA = 0.3
DEFAULT_ANOMALY_THRESHOLD = 3.0
# robust-z denominator: sigma ≈ 1.4826·MAD for a normal cohort, plus a
# floor fraction of the median so jitter around a tiny median cannot
# mint huge scores, plus an absolute epsilon for the all-identical case
_MAD_SIGMA = 1.4826
_MEDIAN_FLOOR = 0.05
_EPS = 1e-12
# per-snapshot layer-breakdown cap (bounds DescribeFederation payloads
# for thousand-tensor models; the largest norms are the interesting ones)
_MAX_LAYER_ROWS = 32
# Pending per-round update vectors are dropped at each cohort fold; this
# caps the buffer against an async federation whose folds lag uplinks.
# Sized to the largest supported cohort scale (the JAX package's bench
# drives 4096) so a legitimate sync round is never silently truncated;
# evictions are counted and surfaced as ``pending_evicted`` in the next
# round snapshot (evicted learners get no score that round).
_MAX_PENDING = 4096
# Buffered-vector width cap: updates larger than this are buffered as a
# fixed seeded coordinate subsample scaled by sqrt(d/k) (norms and
# cosines preserved in expectation — a JL-style sketch), so the cohort
# buffer is O(cohort x SKETCH_DIM), never O(cohort x params): the
# stride-aggregation memory-bounding story survives the health plane
# (worst case 4096 x 16384 f32 = 256 MiB, vs gigabytes of raw vectors).
# Per-uplink norms stay EXACT — only the cohort mean/deviation/cosine
# statistics use the sketch. Models at or under the cap are exact too.
_SKETCH_DIM = 16384
_SKETCH_SEED = 0xC0FFEE
# raw divergence assigned to a non-finite (NaN/Inf-weight) update — a
# finite sentinel well past any default threshold, so the anomaly fires
# and every downstream JSON surface stays strict-parseable
_NON_FINITE_Z_FACTOR = 10.0


def flatten_model(model: Dict[str, np.ndarray]) -> np.ndarray:
    names = sorted(model)
    if not names:
        return np.zeros(0, np.float32)
    return np.concatenate([np.asarray(model[n], np.float32).ravel()
                           for n in names])


def layer_key(name: str) -> str:
    """Per-top-level-layer attribution key: the first two ``/``-separated
    components of a flattened tensor name (``params/Dense_0/kernel`` →
    ``params/Dense_0``; a bare ``w`` stays ``w``)."""
    return "/".join(name.split("/")[:2])


def finite_metrics(metrics: Any) -> Dict[str, float]:
    """Learner-shipped metric mapping filtered down to finite floats.
    The wire validates neither the container nor the values — a non-dict
    payload (version skew, malice), None/str values, and NaN/Inf must
    all be dropped, never raised on: in the controller's completion
    handler an escaping exception would skip ``schedule_next`` and stall
    the sync round barrier, and NaN breaks strict-JSON surfaces. Shared
    by the controller's round-lineage recording and the per-uplink
    summaries here — one filter, no drift."""
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


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity; 0.0 for zero/empty/mismatched vectors (an
    undefined angle must not look like perfect alignment)."""
    if a.size == 0 or a.shape != b.shape:
        return 0.0
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na <= 0.0 or nb <= 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def robust_z(values: Dict[str, float]) -> Dict[str, float]:
    """Cohort median/MAD z-scores (see module docstring for the exact
    denominator). Cohorts smaller than 3 score 0 everywhere: with one
    member there is no cohort to diverge from, and with two the
    deviations from the cohort mean are equal by symmetry (‖u_i − ū‖ =
    ‖u_1 − u_2‖/2 for both), so divergence is unattributable — scoring
    needs at least 3 participants."""
    if len(values) < 3:
        return {k: 0.0 for k in values}
    arr = np.asarray(list(values.values()), np.float64)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    denom = _MAD_SIGMA * mad + _MEDIAN_FLOOR * abs(med) + _EPS
    return {k: float((v - med) / denom) for k, v in values.items()}


def participation_entropy(scales: Dict[str, float]) -> float:
    """Normalized Shannon entropy of the applied contribution weights
    (1.0 = perfectly uniform cohort, → 0 as one learner dominates)."""
    weights = [max(0.0, float(w)) for w in scales.values()]
    total = sum(weights)
    if total <= 0.0 or len(weights) < 2:
        return 1.0 if weights else 0.0
    h = -sum((w / total) * math.log(w / total)
             for w in weights if w > 0.0)
    return float(h / math.log(len(weights)))


def _quantiles(values: List[float]) -> Dict[str, float]:
    arr = np.asarray(values, np.float64)
    return {"min": round(float(arr.min()), 6),
            "p50": round(float(np.median(arr)), 6),
            "max": round(float(arr.max()), 6)}


class HealthMonitor:
    """Controller-side learning-health state machine.

    ``observe_update`` runs per accepted uplink (scheduling-executor
    thread), ``complete_round`` at each successful aggregation (same
    thread — the controller serializes both); ``scores``/``last_stats``/
    ``round_health`` are read from RPC threads (DescribeFederation), so
    shared state sits behind one small lock. Update vectors are buffered
    only until their cohort folds."""

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 anomaly_threshold: float = DEFAULT_ANOMALY_THRESHOLD):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("health alpha must be in (0, 1]")
        if anomaly_threshold <= 0.0:
            raise ValueError("health anomaly_threshold must be > 0")
        self.alpha = float(alpha)
        self.anomaly_threshold = float(anomaly_threshold)
        self._lock = threading.Lock()
        # learner_id -> (update vector — sketched when wide, its
        # PRE-sketch width, summary dict) for the round in flight;
        # cleared (and memory released) at each cohort fold
        self._pending: Dict[str, Tuple[np.ndarray, int,
                                       Dict[str, Any]]] = {}
        self._evicted = 0  # buffered vectors dropped since the last fold
        # per-dimension cached subsample indices (same indices for every
        # learner, or cross-update cosines would be meaningless)
        self._sketch_idx: Dict[int, np.ndarray] = {}
        self._ewma: Dict[str, float] = {}
        self._last: Dict[str, Dict[str, Any]] = {}  # last uplink summary
        self._prev_community: Optional[np.ndarray] = None
        # previous community delta, sketched, plus its PRE-sketch width:
        # sketches of different-width vectors share a shape but live in
        # incomparable subspaces, so comparability is keyed on the width
        self._prev_delta: Optional[np.ndarray] = None
        self._prev_delta_dim: Optional[int] = None
        self.round_health: Dict[str, Any] = {}

    # -- per-uplink (scheduling executor) ------------------------------ #

    def _sketch(self, vec: np.ndarray) -> np.ndarray:
        """Fixed seeded coordinate subsample scaled by sqrt(d/k) for
        vectors wider than ``_SKETCH_DIM`` (norms/cosines preserved in
        expectation); identity for small vectors. The SAME indices apply
        to every vector of a given width — update vectors and the
        community delta must land in one comparable subspace."""
        if vec.size <= _SKETCH_DIM:
            return vec
        idx = self._sketch_idx.get(vec.size)
        if idx is None:
            rng = np.random.default_rng(_SKETCH_SEED)
            idx = np.sort(rng.choice(vec.size, _SKETCH_DIM, replace=False))
            self._sketch_idx[vec.size] = idx
        return vec[idx] * np.float32(math.sqrt(vec.size / _SKETCH_DIM))

    def note_community(self, community: Dict[str, np.ndarray]) -> None:
        """Anchor the reference for round/effective-step deltas (called at
        seed/replace; aggregation re-anchors inside complete_round)."""
        flat = flatten_model(community)
        with self._lock:
            self._prev_community = flat
            self._prev_delta = None
            self._prev_delta_dim = None

    def observe_update(self, learner_id: str, model: Dict[str, np.ndarray],
                       reference: Dict[str, np.ndarray],
                       train_metrics: Optional[Dict[str, float]] = None,
                       ) -> Dict[str, Any]:
        """One uplink's statistics; buffers the update vector for the
        cohort fold and returns the per-uplink summary. Single pass over
        the tensors: the per-tensor diff feeds both the flat vector and
        the per-layer norm breakdown (this is the health plane's hot
        path)."""
        names = sorted(set(model) & set(reference))
        parts: List[np.ndarray] = []
        layer_sq: Dict[str, float] = {}
        for name in names:
            diff = (np.asarray(model[name], np.float32).ravel()
                    - np.asarray(reference[name], np.float32).ravel())
            parts.append(diff)
            key = layer_key(name)
            layer_sq[key] = layer_sq.get(key, 0.0) + float(diff @ diff)
        flat = (np.concatenate(parts) if parts else np.zeros(0, np.float32))
        dim = flat.size  # pre-sketch width: the comparability key
        norm = float(np.linalg.norm(flat)) if flat.size else 0.0
        finite = math.isfinite(norm)
        if not finite:
            # NaN/Inf weights (exploding gradients — the most diverged
            # update possible) are definitionally anomalous: never let
            # the vector enter the cohort mean (NaN would propagate into
            # EVERY learner's score and no anomaly would fire) or the
            # norm leak into JSON surfaces — buffer a sentinel instead;
            # the fold assigns it a finite off-scale divergence
            flat = np.zeros(0, np.float32)
        else:
            # bound buffer memory at O(SKETCH_DIM) per learner
            # (update_norm above stays exact; no-op for small models)
            flat = self._sketch(flat)
        with self._lock:
            prev_delta = self._prev_delta
            prev_dim = self._prev_delta_dim
        summary: Dict[str, Any] = {
            "update_norm": round(norm, 6) if finite else 0.0,
            "layer_norms": {k: round(math.sqrt(v), 6)
                            for k, v in sorted(layer_sq.items(),
                                               key=lambda kv: -kv[1])
                            [:_MAX_LAYER_ROWS]
                            if math.isfinite(v)},
            # comparable only when the pre-sketch widths match — two
            # different-width vectors sketch to the same shape but
            # sample different coordinates (a noise cosine, not 0.0)
            "cos_prev_delta": round(
                cosine(flat, prev_delta)
                if finite and prev_delta is not None and dim == prev_dim
                else 0.0, 6),
        }
        if not finite:
            summary["non_finite"] = True
        clean = finite_metrics(train_metrics) if train_metrics else {}
        if clean:
            summary["train_metrics"] = clean
        with self._lock:
            self._pending[learner_id] = (flat, dim, summary)
            while len(self._pending) > _MAX_PENDING:
                self._pending.pop(next(iter(self._pending)))
                self._evicted += 1
            self._last[learner_id] = dict(summary)
        return summary

    # -- per-round cohort fold (scheduling executor) ------------------- #

    def complete_round(self, round_no: int,
                       community: Dict[str, np.ndarray],
                       scales: Dict[str, float],
                       ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """Fold the buffered cohort: cohort-mean cosines, robust-z
        deviation scores, EWMA divergence update, and the round's
        convergence snapshot. Returns ``(round_health, anomalies)``."""
        with self._lock:
            pending = dict(self._pending)
            self._pending.clear()
            evicted, self._evicted = self._evicted, 0
            prev_community = self._prev_community
        if evicted:
            # never silently truncate: evicted learners get no score
            # this round, and the snapshot says so
            logger.warning(
                "health pending buffer overflowed: %d update vector(s) "
                "evicted before the round %d fold (cohort larger than "
                "the %d-entry buffer); evicted learners are unscored "
                "this round", evicted, round_no, _MAX_PENDING)
        new_flat = flatten_model(community)
        update_norm = 0.0
        effective_step = 0.0
        delta: Optional[np.ndarray] = None
        if (prev_community is not None
                and prev_community.shape == new_flat.shape
                and new_flat.size):
            delta = new_flat - prev_community
            update_norm = float(np.linalg.norm(delta))
            if not math.isfinite(update_norm):
                # a NaN community (a non-finite stored model survived a
                # non-robust aggregation) must not leak into the JSON
                # surfaces or next round's cosine reference
                update_norm, delta = 0.0, None
            else:
                prev_norm = float(np.linalg.norm(prev_community))
                # like cosine(): a ~zero-norm reference (zero-seeded
                # model) makes the ratio undefined — report 0.0, not a
                # ~1e12 blowup
                effective_step = (update_norm / prev_norm
                                  if prev_norm > 1e-9 else 0.0)

        # Cohort alignment + deviation. Comparability is keyed on the
        # PRE-sketch width: a partial/malformed/version-skewed update
        # (different tensor set) must not enter the mean — sketched, it
        # would share the dominant SHAPE while sampling different
        # coordinates, polluting every learner's statistics with
        # subspace noise. Off-width updates go unscored this round.
        entries = {lid: (v, d) for lid, (v, d, _s) in pending.items()
                   if v.size}
        dims = [d for _v, d in entries.values()]
        dominant = max(set(dims), key=dims.count) if dims else None
        vecs = {lid: v for lid, (v, d) in entries.items() if d == dominant}
        deviations: Dict[str, float] = {}
        cos_cohort: Dict[str, float] = {}
        if vecs:
            mean_u = np.mean(list(vecs.values()), axis=0)
            for lid, v in vecs.items():
                cos_cohort[lid] = round(cosine(v, mean_u), 6)
                deviations[lid] = float(np.linalg.norm(v - mean_u))
        raw_z = robust_z(deviations)
        for lid, (_v, _d, summary) in pending.items():
            if summary.get("non_finite"):
                # excluded from the cohort mean above; scored with a
                # finite off-scale sentinel so the anomaly always fires
                raw_z[lid] = self.anomaly_threshold * _NON_FINITE_Z_FACTOR

        anomalies: List[Dict[str, Any]] = []
        with self._lock:
            for lid, z in raw_z.items():
                prev = self._ewma.get(lid, 0.0)
                clamped = max(0.0, z)
                score = (clamped if prev <= 0.0
                         else self.alpha * clamped + (1 - self.alpha) * prev)
                self._ewma[lid] = score
                last = self._last.get(lid)
                if last is not None:
                    last["cos_cohort"] = cos_cohort.get(lid, 0.0)
                    last["divergence_raw"] = round(z, 4)
                    last["divergence_score"] = round(score, 4)
                if z >= self.anomaly_threshold:
                    anomalies.append({
                        "learner_id": lid, "round": round_no,
                        "score": round(score, 4), "raw": round(z, 4),
                        "update_norm": (pending[lid][2]["update_norm"]
                                        if lid in pending else 0.0)})
            self._prev_community = new_flat
            # sketched like every buffered update vector, so next
            # round's cos_prev_delta compares in the same subspace;
            # the pre-sketch width is the comparability key
            self._prev_delta = (self._sketch(delta)
                                if delta is not None else None)
            self._prev_delta_dim = (delta.size if delta is not None
                                    else None)
            scores_snapshot = {lid: round(s, 4)
                               for lid, s in self._ewma.items()}

        # non-finite losses (a zero-step task ships loss=NaN) must not
        # poison the cohort quantiles — one bad learner would otherwise
        # turn the whole round's cohort_loss into NaN
        losses = [s["train_metrics"]["loss"]
                  for _v, _d, s in pending.values()
                  if math.isfinite(s.get("train_metrics", {}).get(
                      "loss", math.nan))]
        health: Dict[str, Any] = {
            "round": int(round_no),
            "round_update_norm": round(update_norm, 6),
            "effective_step": round(effective_step, 6),
            "participation_entropy": round(
                participation_entropy(scales), 4),
            "update_norms": {lid: s["update_norm"]
                             for lid, (_v, _d, s) in pending.items()},
            "cos_cohort": cos_cohort,
            "cos_prev_delta": {lid: s["cos_prev_delta"]
                               for lid, (_v, _d, s) in pending.items()},
            "divergence_raw": {lid: round(z, 4)
                               for lid, z in raw_z.items()},
            "divergence_score": scores_snapshot,
            "anomalous": sorted(a["learner_id"] for a in anomalies),
        }
        if evicted:
            health["pending_evicted"] = int(evicted)
        if losses:
            health["cohort_loss"] = _quantiles(losses)
        with self._lock:
            self.round_health = health
        return health, anomalies

    # -- reads (RPC threads) + lifecycle ------------------------------- #

    def scores(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ewma)

    def last_stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {lid: dict(s) for lid, s in self._last.items()}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.round_health)

    def drop(self, learner_id: str) -> None:
        """Forget a departed learner (bounded state + gauge cardinality
        under churn, same posture as the straggler series prune)."""
        with self._lock:
            self._pending.pop(learner_id, None)
            self._ewma.pop(learner_id, None)
            self._last.pop(learner_id, None)

    # -- checkpoint persistence (controller save/restore) -------------- #

    def export_state(self) -> Dict[str, Any]:
        """Scores + last summaries + the latest round snapshot — small,
        codec-serializable. Update VECTORS are deliberately not
        persisted (O(params) each); after a failover the first fold has
        no previous delta and ``cos_prev_delta`` restarts at 0."""
        with self._lock:
            return {"ewma": {k: float(v) for k, v in self._ewma.items()},
                    "last": {k: dict(v) for k, v in self._last.items()},
                    "round_health": dict(self.round_health)}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self._ewma = {k: float(v)
                          for k, v in (state.get("ewma") or {}).items()}
            self._last = {k: dict(v)
                          for k, v in (state.get("last") or {}).items()}
            self.round_health = dict(state.get("round_health") or {})
