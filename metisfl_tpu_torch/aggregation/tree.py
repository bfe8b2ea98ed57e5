"""Tree-aggregation tier: a two-level reduction inside the controller.

The port's copy of the JAX package's ``aggregation/tree.py``. The tier
splits the cohort into ``branch`` contiguous slices, folds each slice in
its own worker thread (parallel store selects and host folds), then folds
the ``branch`` partial accumulators into the root in slice order: the
controller's fan-in is O(branch), and peak residency is about ``branch``
x (one sub-block of models + one accumulator) instead of the cohort.

Math: the tier applies only to weighted-sum rules (community =
Σ wᵢ·mᵢ / Σ wᵢ), where addition is associative, so any slicing gives the
same sum up to fp reassociation; on integer-valued payloads (every
partial sum exact) it equals the flat fold bit for bit.

Host numpy only: models come out of the store as host arrays, and the
slice folds use the same ``np_stacked_scaled_add`` (or native hostfold)
kernels as :class:`~metisfl_tpu_torch.aggregation.fedavg.FedAvg`.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.aggregation.base import (
    np_finalize,
    np_stacked_scaled_add,
)
from metisfl_tpu_torch.tensor.pytree import tree_leaves, tree_map

logger = logging.getLogger("metisfl_tpu_torch.aggregation.tree")

# sub-block size inside a slice when the federation runs with
# stride_length=0: the tier still bounds each worker's residency
_DEFAULT_SUBBLOCK = 32

Fetch = Callable[[Sequence[str]], Dict[str, List[Any]]]


class SlicePartial:
    """One slice's fold result."""

    __slots__ = ("acc", "z", "count", "dtypes", "duration_ms")

    def __init__(self, acc, z, count, dtypes, duration_ms):
        self.acc, self.z, self.count = acc, z, count
        self.dtypes, self.duration_ms = dtypes, duration_ms


class TreeReducer:
    """B-way two-level reducer over store-resident lineages."""

    def __init__(self, branch: int = 8, workers: int = 0):
        if branch < 2:
            raise ValueError("tree branch must be >= 2")
        self.branch = int(branch)
        self._workers = int(workers) or min(self.branch,
                                            max(2, os.cpu_count() or 2))
        self._pool: Optional[ThreadPoolExecutor] = None

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers, thread_name_prefix="tree-agg")
        return self._pool

    def shutdown(self) -> None:
        """Idempotent; a reducer can be reused after it (the pool is made
        again on demand)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    close = shutdown

    # -- slice fold (worker thread) ----------------------------------------
    @staticmethod
    def _fold_slice(slice_ids: Sequence[str], scales: Dict[str, float],
                    fetch: Fetch, subblock: int) -> SlicePartial:
        t0 = time.perf_counter()
        acc = None
        z = 0.0
        count = 0
        dtypes: Optional[Tuple[str, ...]] = None
        for i in range(0, len(slice_ids), subblock):
            block = list(slice_ids[i:i + subblock])
            picked = fetch(block)
            models = [picked[lid][0] for lid in block if lid in picked]
            weights = np.asarray([scales[lid] for lid in block
                                  if lid in picked], np.float64)
            if not models:
                continue
            if dtypes is None:
                dtypes = tuple(str(np.asarray(x).dtype)
                               for x in tree_leaves(models[0]))
            acc = np_stacked_scaled_add(acc, models, weights)
            z += float(weights.sum())
            count += len(models)
        return SlicePartial(acc, z, count, dtypes,
                            (time.perf_counter() - t0) * 1e3)

    # -- public API --------------------------------------------------------
    def reduce(self, ids: Sequence[str], scales: Dict[str, float],
               fetch: Fetch, stride: int = 0
               ) -> Optional[Tuple[Dict[str, Any], List[SlicePartial]]]:
        """Fold ``ids``' latest stored models into a community model.

        ``fetch(block) -> {lid: lineage}`` is the (thread-safe) store
        select; ``stride`` bounds each worker's resident sub-block (0: a
        default bound, not the whole slice). Returns ``(community,
        partials)``, or None when no learner had a stored model."""
        ids = list(ids)
        if not ids:
            return None
        subblock = int(stride) or _DEFAULT_SUBBLOCK
        # contiguous slices (the last may be short) in the flat path's id
        # order, so each slice's blocking matches the flat fold's
        per = max(1, -(-len(ids) // self.branch))
        slices = [ids[i:i + per] for i in range(0, len(ids), per)]
        if len(slices) == 1:
            partials = [self._fold_slice(slices[0], scales, fetch, subblock)]
        else:
            futures = [self._executor().submit(
                self._fold_slice, s, scales, fetch, subblock)
                for s in slices]
            # settle every future before raising: a sibling left running
            # would race the aggregation-failure retry through the pool
            partials, first_error = [], None
            for f in futures:
                try:
                    partials.append(f.result())
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    if first_error is None:
                        first_error = exc
            if first_error is not None:
                raise first_error
        live = [p for p in partials if p.acc is not None]
        if not live:
            return None
        # root fold: O(branch) partial-accumulator adds, in slice order
        acc, z = live[0].acc, live[0].z
        for p in live[1:]:
            acc = tree_map(lambda a, b: a + b, acc, p.acc)
            z += p.z
        community = np_finalize(acc, z, dtypes=live[0].dtypes)
        return community, partials
