"""Disk-persistent store with a byte-bounded in-memory LRU cache (the
port's copy of the JAX package's ``store/cached.py``).

Every model persists to disk (:class:`DiskModelStore`), and a
byte-budgeted LRU cache serves hot lineage heads from memory, so the
resident set stays under ``cache_bytes`` instead of growing with the
federation. A model larger than the whole budget is never cached: its
select reads the mmapped file.

Concurrency: lineage mutations are serialized per learner by the base
class (store/base.py); the LRU spans learners, so it takes its OWN lock
(``_cache_lock``, always acquired AFTER a learner lock, never before —
no ordering cycle). The cache publishes the JAX package's gauges and
counters (resident bytes and entries, hits and misses); ``cache_hits``
and ``cache_misses`` count on the instance too.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Tuple

import numpy as np
import torch

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.store.base import EvictionPolicy
from metisfl_tpu_torch.store.disk import _MISS, DiskModelStore
from metisfl_tpu_torch.telemetry import metrics as _tmetrics

_REG = _tmetrics.registry()
_M_CACHE_HITS = _REG.counter(
    _tel.M_STORE_CACHE_HITS_TOTAL, "Model-store cache hits")
_M_CACHE_MISSES = _REG.counter(
    _tel.M_STORE_CACHE_MISSES_TOTAL, "Model-store cache misses (disk reads)")
_M_CACHE_BYTES = _REG.gauge(
    _tel.M_STORE_CACHE_RESIDENT_BYTES, "Decoded models resident in the cache")
_M_CACHE_ENTRIES = _REG.gauge(
    _tel.M_STORE_CACHE_ENTRIES, "Models resident in the cache")


def _value_nbytes(value: Any) -> int:
    """Resident bytes of one store value; 64 for what it cannot size."""
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, dict):
        total = 0
        for item in value.values():
            if isinstance(item, np.ndarray):
                total += item.nbytes
            elif isinstance(item, torch.Tensor):
                total += item.numel() * item.element_size()
            elif isinstance(item, tuple):  # opaque: (payload, spec)
                total += len(item[0])
            else:
                total += 64
        return total
    return 64


class CachedDiskStore(DiskModelStore):
    """See module docstring. API-identical to :class:`DiskModelStore`;
    ``cache_bytes`` bounds resident decoded models (0 disables caching)."""

    def __init__(self, root: str,
                 policy: EvictionPolicy = EvictionPolicy.LINEAGE_LENGTH,
                 lineage_length: int = 1,
                 cache_bytes: int = 256 * 1024 * 1024):
        super().__init__(root, policy, lineage_length)
        self.cache_bytes = int(cache_bytes)
        # (learner_id, seq) -> (nbytes, decoded value); newest at the end
        self._cache: "OrderedDict[Tuple[str, int], Tuple[int, Any]]" = (
            OrderedDict())
        self._cache_lock = threading.Lock()
        self._cached_total = 0
        self.cache_hits = 0
        self.cache_misses = 0

    # -- cache plumbing (thread-safe via _cache_lock) ----------------------
    def _cache_put(self, key: Tuple[str, int], value: Any) -> None:
        if self.cache_bytes <= 0:
            return
        nbytes = _value_nbytes(value)
        if nbytes > self.cache_bytes:
            return  # one oversized model must not evict the whole cache
        with self._cache_lock:
            old = self._cache.pop(key, None)
            if old is not None:
                self._cached_total -= old[0]
            self._cache[key] = (nbytes, value)
            self._cached_total += nbytes
            while self._cached_total > self.cache_bytes and self._cache:
                _, (evicted_bytes, _) = self._cache.popitem(last=False)
                self._cached_total -= evicted_bytes
            self._publish_gauges()

    def _publish_gauges(self) -> None:
        """Call with ``_cache_lock`` held."""
        _M_CACHE_BYTES.set(self._cached_total)
        _M_CACHE_ENTRIES.set(len(self._cache))

    def _cache_drop_learner(self, learner_id: str) -> None:
        with self._cache_lock:
            for key in [k for k in self._cache if k[0] == learner_id]:
                nbytes, _ = self._cache.pop(key)
                self._cached_total -= nbytes
            self._publish_gauges()

    # -- DiskModelStore overrides -----------------------------------------
    def _append(self, learner_id: str, model: Any) -> int:
        seq = super()._append(learner_id, model)
        # the decoded value is in hand at insert time: cache it so the next
        # select round hits memory, not disk
        self._cache_put((learner_id, seq), model)
        return seq

    def _cache_fetch(self, learner_id: str, seq: int) -> Any:
        with self._cache_lock:
            cached = self._cache.get((learner_id, seq))
            if cached is not None:
                self._cache.move_to_end((learner_id, seq))
                self.cache_hits += 1
                _M_CACHE_HITS.inc()
                return cached[1]
            self.cache_misses += 1
            _M_CACHE_MISSES.inc()
            return _MISS

    def _cache_store(self, learner_id: str, seq: int, value: Any) -> None:
        self._cache_put((learner_id, seq), value)

    def _lineage(self, learner_id: str) -> List[Any]:
        out = []
        for seq, name in reversed(self._entries(learner_id)):
            hit = self._cache_fetch(learner_id, seq)
            if hit is not _MISS:
                out.append(hit)
                continue
            value = self._read_entry(learner_id, name)
            self._cache_put((learner_id, seq), value)
            out.append(value)
        return out

    def _erase(self, learner_id: str) -> None:
        super()._erase(learner_id)
        self._cache_drop_learner(learner_id)

    def _evict(self, learner_id: str) -> None:
        entries = self._entries(learner_id)
        excess = len(entries) - self.lineage_length
        super()._evict(learner_id)
        with self._cache_lock:
            for seq, _ in entries[:max(0, excess)]:
                dropped = self._cache.pop((learner_id, seq), None)
                if dropped is not None:
                    self._cached_total -= dropped[0]
            self._publish_gauges()
