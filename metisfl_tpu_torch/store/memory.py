"""In-memory model store (the port's copy of the JAX package's
``store/memory.py``).

Concurrency: per-learner list mutations are serialized by the base
class's per-learner locks (store/base.py thread-safety contract); the
outer dict is touched only through GIL-atomic single operations
(defaultdict item access, ``pop``, ``list(keys())``), so the store-global
registry lock is never needed on the hot path."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List

from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore


class InMemoryModelStore(ModelStore):
    def __init__(self, policy: EvictionPolicy = EvictionPolicy.LINEAGE_LENGTH,
                 lineage_length: int = 1):
        super().__init__(policy, lineage_length)
        self._models: Dict[str, List[Any]] = defaultdict(list)  # oldest first

    def _append(self, learner_id: str, model: Any) -> None:
        self._models[learner_id].append(model)

    def _lineage(self, learner_id: str) -> List[Any]:
        return list(reversed(self._models.get(learner_id, ())))

    def _erase(self, learner_id: str) -> None:
        self._models.pop(learner_id, None)

    def _evict(self, learner_id: str) -> None:
        models = self._models[learner_id]
        excess = len(models) - self.lineage_length
        if excess > 0:
            del models[:excess]

    def _learner_ids(self) -> List[str]:
        return list(self._models.keys())
