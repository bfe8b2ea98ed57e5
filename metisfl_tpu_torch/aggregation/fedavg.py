"""FedAvg: the weighted average of learner models.

The port's copy of the JAX package's ``aggregation/fedavg.py``:
community = Σ scaleᵢ · modelᵢ / Σ scaleᵢ, folded block by block
(``accumulate``) so only one stride block of models and the accumulator are
resident at a time. Host numpy trees fold on the host, tensor trees on
their device (aggregation/base.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.aggregation.base import (
    Pytree,
    finalize,
    is_host_tree,
    np_finalize,
    np_stacked_scaled_add,
    stacked_scaled_add,
)
from metisfl_tpu_torch.tensor.pytree import tree_leaves


class FedAvg:
    name = "fedavg"
    required_lineage = 1

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._acc: Optional[Pytree] = None
        self._total: float = 0.0
        self._dtypes: Optional[Tuple] = None
        self._np: bool = False

    def accumulate(
        self, models: Sequence[Tuple[Sequence[Pytree], float]]
    ) -> None:
        """Fold one block of ``(lineage, scale)`` pairs into the running
        sum; the locale and storage dtypes come from the first model."""
        if not models:
            return
        first = models[0][0][0]
        if self._dtypes is None:
            self._np = is_host_tree(first)
            self._dtypes = tuple(
                str(np.asarray(x).dtype) if self._np else x.dtype
                for x in tree_leaves(first))
        block = [lineage[0] for lineage, _ in models]
        # f64 scales: each fold casts them to its accumulator dtype, so
        # 64-bit trees keep double-precision weights
        scales = np.asarray([scale for _, scale in models], np.float64)
        fold = np_stacked_scaled_add if self._np else stacked_scaled_add
        self._acc = fold(self._acc, block, scales)
        self._total += float(scales.sum())

    def result(self) -> Pytree:
        """The running sum over the total weight, in the storage dtypes
        (normalised here, so unnormalised scales are right too)."""
        if self._acc is None:
            raise ValueError("FedAvg.result called before any accumulate")
        fin = np_finalize if self._np else finalize
        return fin(self._acc, self._total, self._dtypes)

    def aggregate(
        self,
        models: Sequence[Tuple[Sequence[Pytree], float]],
        state=None,
    ) -> Pytree:
        """One-shot aggregation (accumulate everything, then result)."""
        if not models:
            raise ValueError("FedAvg.aggregate called with no models")
        self.reset()
        self.accumulate(models)
        out = self.result()
        self.reset()
        return out


class Scaffold(FedAvg):
    """SCAFFOLD (Karimireddy et al.): the weights fold exactly as FedAvg's;
    the control variates live around the fold. Learners correct their
    local gradients by ``c - c_i`` and ship control deltas
    (learner/learner.py); the controller folds the cohort's deltas into
    the server variate ``c`` and ships ``c`` with every task
    (controller/core.py ``_fold_scaffold_controls``). The rule name
    selects that protocol over the stride-blocked weight fold."""

    name = "scaffold"
