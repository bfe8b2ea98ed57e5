"""Model store interface and eviction semantics.

The port's copy of the JAX package's ``store/base.py``. Lock granularity
is per learner lineage: a registry lock guards only the table of
per-learner locks, and one lock per learner serializes that learner's
lineage mutations and snapshots, so different learners insert in
parallel. Subclass storage hooks (``_append``/``_lineage``/``_erase``/
``_evict``) run with the owning learner's lock held; ``_learner_ids`` runs
with no lock and must be a GIL-atomic snapshot.
"""

from __future__ import annotations

import contextlib
import enum
import threading

from typing import Any, Dict, List, Optional, Sequence


class EvictionPolicy(enum.Enum):
    """Lineage retention.

    ``NO_EVICTION`` keeps full history; ``LINEAGE_LENGTH`` keeps the k most
    recent models per learner (k=1 is classic FedAvg; FedRec needs k≥2).
    """

    NO_EVICTION = "no_eviction"
    LINEAGE_LENGTH = "lineage_length"


class ModelStore:
    """Per-learner lineage cache. Thread-safe per the module docstring;
    values are opaque to the store (pytrees of host numpy arrays, or
    encrypted OpaqueModels)."""

    def __init__(self, policy: EvictionPolicy = EvictionPolicy.LINEAGE_LENGTH,
                 lineage_length: int = 1):
        if policy is EvictionPolicy.LINEAGE_LENGTH and lineage_length < 1:
            raise ValueError("lineage_length must be >= 1")
        self.policy = policy
        self.lineage_length = lineage_length
        # registry lock: guards ONLY the per-learner lock table (and
        # subclass-global bookkeeping) — never held across I/O
        self._lock = threading.Lock()
        # learner_id -> [lock, refcount]; the refcount makes pruning safe:
        # erase may drop an entry only when no other thread has fetched
        # it, otherwise two lock objects could coexist for one learner
        # and "serialized per learner" would silently stop being true
        self._learner_locks: Dict[str, List] = {}

    @contextlib.contextmanager
    def _locked(self, learner_id: str):
        """Hold ``learner_id``'s lineage lock. All same-learner mutations
        and snapshots run under exactly one lock object at a time."""
        with self._lock:
            entry = self._learner_locks.get(learner_id)
            if entry is None:
                entry = self._learner_locks[learner_id] = [
                    threading.Lock(), 0]
            entry[1] += 1
        try:
            with entry[0]:
                yield
        finally:
            with self._lock:
                entry[1] -= 1

    # -- subclass storage hooks (called with the learner's lock held) ------
    def _append(self, learner_id: str, model: Any) -> None:
        raise NotImplementedError

    def _lineage(self, learner_id: str) -> List[Any]:
        """Most-recent-FIRST list of stored models."""
        raise NotImplementedError

    def _erase(self, learner_id: str) -> None:
        raise NotImplementedError

    def _evict(self, learner_id: str) -> None:
        raise NotImplementedError

    def _learner_ids(self) -> List[str]:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def insert(self, learner_id: str, model: Any) -> None:
        with self._locked(learner_id):
            self._append(learner_id, model)
            if self.policy is EvictionPolicy.LINEAGE_LENGTH:
                self._evict(learner_id)

    def select(self, learner_ids: Sequence[str], k: int = 1) -> Dict[str, List[Any]]:
        """Latest ≤k models per learner, most recent first. Learners with no
        stored model are omitted."""
        out: Dict[str, List[Any]] = {}
        for lid in learner_ids:
            with self._locked(lid):
                lineage = self._lineage(lid)
            if lineage:
                out[lid] = lineage[:k]
        return out

    def erase(self, learner_ids: Sequence[str]) -> None:
        for lid in learner_ids:
            with self._locked(lid):
                self._erase(lid)
            # lock-table hygiene for long-churn federations: drop the
            # entry, but ONLY when uncontended (refcount 0) — a thread
            # that already fetched it keeps the one true lock object; a
            # contended entry survives until a later erase prunes it
            with self._lock:
                entry = self._learner_locks.get(lid)
                if entry is not None and entry[1] == 0:
                    del self._learner_locks[lid]

    def learner_ids(self) -> List[str]:
        return self._learner_ids()

    def size(self, learner_id: str) -> int:
        with self._locked(learner_id):
            return len(self._lineage(learner_id))

    def shutdown(self) -> None:
        pass
