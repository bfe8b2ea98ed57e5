"""Versioned community-model registry with eval-gated channel promotion.

The port's copy of the JAX package's ``registry/registry.py``. It turns
every aggregated round into a versioned, promotable, servable artifact:

- :meth:`ModelRegistry.register` mints a monotonic version id for a
  round's community blob, recording the round, the parent version (the
  stable head it will be judged against), the config hash and the round's
  learning-health snapshot; the blob persists through the store layer
  (``store.make_store``, one lineage slot per version id).
- Channels are named heads: a fresh version enters ``candidate``;
  :meth:`promote` moves it to ``stable``. Promotion is gated
  (:meth:`evaluate_gate`): the eval metric against the current stable
  version, no anomalous update in the source round, and a bounded
  divergence-score quantile. With ``promotion.auto`` the gate runs when a
  candidate's evaluation arrives (:meth:`note_eval`).
- :meth:`rollback` restores the previous stable head; :meth:`gc` retires
  and erases versions beyond ``retention``.

The health rules read the source round's ``health`` snapshot, which the
controller's learning-health plane takes at round close (on by default,
as in the JAX package; with it off, or under secure aggregation, the
snapshot is ``{}`` and the anomaly and divergence rules pass).

One lock guards the metadata; the blob bytes live in the store, which has
its own. The whole state round-trips through :meth:`export_state` and
:meth:`restore_state`, so the lineage survives a controller ``--resume``
inside the controller checkpoint. Telemetry, the JAX package's: the
version, promotion and rollback counters, a per-version state gauge, and
the ``VersionRegistered``/``VersionPromoted``/``VersionRolledBack``
events.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.store import make_store
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger("metisfl_tpu_torch.registry")

_REG = _tmetrics.registry()
_M_VERSIONS = _REG.counter(
    _tel.M_REGISTRY_VERSIONS_TOTAL, "Model versions registered")
_M_STATE = _REG.gauge(
    _tel.M_REGISTRY_VERSION_STATE,
    "Per-version lifecycle state (2 = stable head, 1 = candidate head, "
    "0 = retained, series removed at GC)", ("version",))
_M_PROMOTIONS = _REG.counter(
    _tel.M_REGISTRY_PROMOTIONS_TOTAL, "Versions promoted to stable")
_M_ROLLBACKS = _REG.counter(
    _tel.M_REGISTRY_ROLLBACKS_TOTAL, "Stable-channel rollbacks")

CHANNEL_CANDIDATE = "candidate"
CHANNEL_STABLE = "stable"

# metric keys whose value improves downward (the JAX package's stats.py
# uses the same rule)
_LOWER_BETTER_TAGS = ("loss", "error", "mse", "mae")


def _lower_better(metric_key: str) -> bool:
    return any(tag in metric_key.lower() for tag in _LOWER_BETTER_TAGS)


@dataclass
class VersionInfo:
    """One registered community-model version (metadata only: the blob
    lives in the store under ``v<version>``)."""

    version: int
    round: int = 0
    parent: int = 0                  # 0 = no parent (first version)
    config_hash: str = ""
    created_at: float = 0.0
    channel: str = ""                # candidate | stable | "" (retained)
    # the source round's RoundMetadata.health snapshot at registration
    health: Dict[str, Any] = field(default_factory=dict)
    # folded community evaluation, {"<dataset>/<metric>": mean-across-
    # learners}; empty until the round's eval tasks report back
    eval_metrics: Dict[str, float] = field(default_factory=dict)
    # last gate decision for operators: {"passed": bool, "reasons": [...]}
    gate: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)


class ModelRegistry:
    """See module docstring. ``config`` is a
    :class:`metisfl_tpu_torch.config.RegistryConfig`."""

    def __init__(self, config, config_hash: str = "", store=None):
        self.config = config
        self.config_hash = config_hash
        self._lock = threading.RLock()
        self._versions: Dict[int, VersionInfo] = {}
        self._next_version = 1
        self._heads: Dict[str, int] = {}     # channel -> version id
        self._previous_stable = 0            # rollback target
        # blob bytes ride the existing store layer: one "learner" id per
        # version, lineage length 1 (a version's bytes never change)
        self._store = store if store is not None else make_store(
            "in_memory", lineage_length=1)

    # ------------------------------------------------------------------ #
    # registration
    # ------------------------------------------------------------------ #

    def register(self, round_id: int, blob: bytes,
                 health: Optional[Dict[str, Any]] = None) -> VersionInfo:
        """Mint a candidate version for an aggregated round's community
        blob. The parent is whatever the stable head was when the version
        was created (the model it will be judged against)."""
        with self._lock:
            version = self._next_version
            self._next_version += 1
            info = VersionInfo(
                version=version,
                round=int(round_id),
                parent=self._heads.get(CHANNEL_STABLE, 0),
                config_hash=self.config_hash,
                created_at=round(time.time(), 6),
                channel=CHANNEL_CANDIDATE,
                health=dict(health or {}),
            )
            self._versions[version] = info
            previous_candidate = self._heads.get(CHANNEL_CANDIDATE, 0)
            self._heads[CHANNEL_CANDIDATE] = version
            if previous_candidate and previous_candidate in self._versions:
                # superseded, never promoted: plain retained version now
                self._versions[previous_candidate].channel = ""
        self._store.insert(self._blob_key(version), bytes(blob))
        _M_VERSIONS.inc()
        self._refresh_state_gauges()
        _tevents.emit(_tevents.VersionRegistered, version=version,
                      round=int(round_id), parent=info.parent)
        logger.info("registered model version v%d (round %d, parent v%d)",
                    version, round_id, info.parent)
        self.gc()
        return info

    def note_eval(self, round_id: int, metrics: Dict[str, float],
                  gate: bool = True) -> Optional[VersionInfo]:
        """Fold a round's community evaluation into the version registered
        from that round (metrics keys: ``"<dataset>/<metric>"``). Under
        ``promotion.auto`` (and ``gate=True`` — the controller passes
        False while the cohort's digests are still partial, so a single
        fast learner's mean never tips a promotion) the gate re-runs —
        returns the promoted VersionInfo when this fold tipped a
        candidate to stable, else None. Idempotent per arriving digest:
        later results refresh the fold and re-evaluate."""
        with self._lock:
            # the latest version of the round: a --resume re-runs the
            # abandoned round number, so two versions may share it
            matches = [v for v in self._versions.values()
                       if v.round == int(round_id)]
            info = max(matches, key=lambda v: v.version, default=None)
            if info is None:
                return None
            info.eval_metrics = {k: float(v) for k, v in metrics.items()}
            is_candidate = self._heads.get(CHANNEL_CANDIDATE) == info.version
        if not (gate and self.config.promotion.auto and is_candidate):
            return None
        passed, reasons = self.evaluate_gate(info.version)
        if passed:
            return self.promote(info.version)
        with self._lock:
            info.gate = {"passed": False, "reasons": reasons}
        return None

    # ------------------------------------------------------------------ #
    # promotion gate
    # ------------------------------------------------------------------ #

    def evaluate_gate(self, version: int) -> Tuple[bool, List[str]]:
        """Run the configured promotion rules for ``version`` against the
        current stable head. Returns (passed, failure reasons)."""
        p = self.config.promotion
        with self._lock:
            info = self._versions.get(version)
            stable = self._versions.get(self._heads.get(CHANNEL_STABLE, 0))
        if info is None:
            return False, [f"unknown version v{version}"]
        reasons: List[str] = []
        if p.require_eval and not info.eval_metrics:
            reasons.append("no eval metrics reported yet")
        if p.forbid_anomalies and info.health.get("anomalous"):
            reasons.append(
                "source round flagged anomalous updates: "
                f"{sorted(info.health['anomalous'])}")
        if p.max_divergence > 0.0:
            scores = sorted(
                float(s) for s in
                (info.health.get("divergence_score") or {}).values())
            if scores:
                # nearest-rank quantile: ceil(q*n)-1, not int(q*n) (the
                # latter evaluates p100 for q=0.9 at n=10)
                idx = min(len(scores) - 1,
                          max(0, math.ceil(
                              p.divergence_quantile * len(scores)) - 1))
                q = scores[idx]
                if q > p.max_divergence:
                    reasons.append(
                        f"divergence p{int(p.divergence_quantile * 100)}"
                        f"={q:.3f} > {p.max_divergence:.3f}")
        if p.metric and stable is not None:
            mine = info.eval_metrics.get(p.metric)
            theirs = stable.eval_metrics.get(p.metric)
            if mine is None and info.eval_metrics:
                reasons.append(f"candidate lacks gate metric {p.metric!r}")
            elif mine is not None and theirs is None:
                # the stable head never reported the gate metric (e.g. a
                # force-promote before its eval landed): refusing beats a
                # vacuous pass that would let a regressing candidate
                # auto-promote unchecked — operators can still force
                reasons.append(
                    f"stable v{stable.version} lacks gate metric "
                    f"{p.metric!r}; comparison impossible (force to "
                    "override)")
            elif mine is not None and theirs is not None:
                improvement = (theirs - mine if _lower_better(p.metric)
                               else mine - theirs)
                if improvement < p.min_delta:
                    reasons.append(
                        f"{p.metric} {mine:.4f} vs stable {theirs:.4f} "
                        f"(needs delta >= {p.min_delta})")
        return not reasons, reasons

    def promote(self, version: int, force: bool = False) -> VersionInfo:
        """Move ``version`` to the stable channel. ``force`` bypasses the
        gate (operator override); otherwise a failing gate raises so the
        RPC surface reports the reasons instead of silently promoting."""
        if not force:
            passed, reasons = self.evaluate_gate(version)
            if not passed:
                with self._lock:
                    info = self._versions.get(version)
                    if info is not None:
                        info.gate = {"passed": False, "reasons": reasons}
                raise ValueError(
                    f"promotion gate rejected v{version}: "
                    + "; ".join(reasons))
        with self._lock:
            info = self._versions.get(version)
            if info is None:
                raise ValueError(f"unknown version v{version}")
            previous = self._heads.get(CHANNEL_STABLE, 0)
            if previous == version:
                return info
            self._previous_stable = previous
            if previous and previous in self._versions:
                self._versions[previous].channel = ""
            self._heads[CHANNEL_STABLE] = version
            if self._heads.get(CHANNEL_CANDIDATE) == version:
                del self._heads[CHANNEL_CANDIDATE]
            info.channel = CHANNEL_STABLE
            info.gate = {"passed": True, "reasons": [],
                         "forced": bool(force)}
            round_id = info.round
        _M_PROMOTIONS.inc()
        self._refresh_state_gauges()
        _tevents.emit(_tevents.VersionPromoted, version=version,
                      round=round_id, previous_stable=previous,
                      forced=bool(force))
        logger.info("promoted model version v%d to stable (was v%d)",
                    version, previous)
        self.gc()
        return info

    def rollback(self) -> Optional[VersionInfo]:
        """Restore the previous stable head (one level). Returns the
        restored VersionInfo, or None when there is nothing to roll back
        to."""
        with self._lock:
            target = self._previous_stable
            current = self._heads.get(CHANNEL_STABLE, 0)
            info = self._versions.get(target)
            if not target or info is None or target == current:
                return None
            if current and current in self._versions:
                self._versions[current].channel = ""
            self._heads[CHANNEL_STABLE] = target
            self._previous_stable = 0  # one level: no rollback ping-pong
            info.channel = CHANNEL_STABLE
        _M_ROLLBACKS.inc()
        self._refresh_state_gauges()
        _tevents.emit(_tevents.VersionRolledBack, version=target,
                      rolled_back_from=current)
        logger.warning("rolled stable back to v%d (was v%d)", target,
                       current)
        return info

    # ------------------------------------------------------------------ #
    # retention GC
    # ------------------------------------------------------------------ #

    def gc(self) -> List[int]:
        """Erase versions beyond ``retention``, never a channel head or
        the rollback target; their blobs leave the store."""
        with self._lock:
            protected = set(self._heads.values()) | {self._previous_stable}
            retire = [
                v for v in sorted(self._versions)
                if v not in protected
            ][:-self.config.retention or None]
            if len(self._versions) - len(retire) < 1:
                retire = []
            for v in retire:
                del self._versions[v]
        for v in retire:
            self._store.erase([self._blob_key(v)])
            _M_STATE.remove(version=f"v{v}")
            logger.info("registry GC retired model version v%d", v)
        return retire

    # ------------------------------------------------------------------ #
    # lookup
    # ------------------------------------------------------------------ #

    def _blob_key(self, version: int) -> str:
        return f"v{version}"

    def head(self, channel: str) -> Optional[VersionInfo]:
        with self._lock:
            return self._versions.get(self._heads.get(channel, 0))

    def info(self, version: int) -> Optional[VersionInfo]:
        with self._lock:
            return self._versions.get(version)

    def blob(self, version: int) -> Optional[bytes]:
        picked = self._store.select([self._blob_key(version)], k=1)
        lineage = picked.get(self._blob_key(version))
        return lineage[0] if lineage else None

    def versions(self) -> List[VersionInfo]:
        with self._lock:
            return [self._versions[v] for v in sorted(self._versions)]

    def describe(self) -> Dict[str, Any]:
        """The registry's snapshot for DescribeFederation and
        DescribeRegistry: the channel heads and the retained lineage."""
        with self._lock:
            return {
                "enabled": True,
                "stable": self._heads.get(CHANNEL_STABLE, 0),
                "candidate": self._heads.get(CHANNEL_CANDIDATE, 0),
                "previous_stable": self._previous_stable,
                "next_version": self._next_version,
                "versions": [self._versions[v].to_dict()
                             for v in sorted(self._versions)],
            }

    # ------------------------------------------------------------------ #
    # checkpoint persistence
    # ------------------------------------------------------------------ #

    def export_state(self) -> Dict[str, Any]:
        """The whole metadata lineage, but blobs only of the servable set
        (the channel heads and the rollback target): the checkpoint runs
        every round and at every join, and the other retained versions
        cannot be served. A restored version without a head keeps its
        metadata; promoting it again needs a new registration."""
        with self._lock:
            versions = [self._versions[v].to_dict()
                        for v in sorted(self._versions)]
            heads = dict(self._heads)
            protected = sorted(
                {v for v in list(heads.values()) + [self._previous_stable]
                 if v})
            state = {
                "next_version": self._next_version,
                "previous_stable": self._previous_stable,
                "heads": heads,
                "versions": versions,
            }
        state["blobs"] = {str(v): self.blob(v) or b"" for v in protected}
        return state

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self._next_version = int(state.get("next_version", 1))
            self._previous_stable = int(state.get("previous_stable", 0))
            self._heads = {str(k): int(v)
                           for k, v in (state.get("heads") or {}).items()}
            self._versions = {}
            for entry in state.get("versions", []):
                info = VersionInfo(**entry)
                self._versions[info.version] = info
        for key, blob in (state.get("blobs") or {}).items():
            if blob:
                self._store.insert(self._blob_key(int(key)), bytes(blob))
        self._refresh_state_gauges()
        logger.info("restored registry: %d version(s), stable=v%d, "
                    "candidate=v%d", len(self._versions),
                    self._heads.get(CHANNEL_STABLE, 0),
                    self._heads.get(CHANNEL_CANDIDATE, 0))

    def _refresh_state_gauges(self) -> None:
        with self._lock:
            stable = self._heads.get(CHANNEL_STABLE, 0)
            candidate = self._heads.get(CHANNEL_CANDIDATE, 0)
            versions = list(self._versions)
        for v in versions:
            _M_STATE.set(2 if v == stable else 1 if v == candidate else 0,
                         version=f"v{v}")

    def shutdown(self) -> None:
        self._store.shutdown()
