"""Rolling (incremental) aggregation: FedStride and FedRec.

The port's copy of the JAX package's ``aggregation/rolling.py``, itself the
reference's ``FederatedRollingAverageBase`` family (federated_stride.cc,
federated_recency.cc):

- the community model is kept as ``wc_scaled / z``, with
  ``wc_scaled = Σ scaleᵢ·modelᵢ`` and ``z = Σ scaleᵢ``;
- **FedStride**: each stride block of a round is added to the running sum,
  so only ``stride`` models are resident; the controller resets the state
  every round;
- **FedRec** (recency): a learner that reports again has its previous
  contribution subtracted and its newest added, so nobody counts twice;
  the state lives across rounds, and the store keeps a lineage of 2.

Host numpy trees (every wire-arrived model) fold on the host with the JAX
package's numpy kernels; trees of torch tensors fold where they live
(aggregation/base.py). Across a controller restart the rolling state
rebuilds from the checkpointed contribution scales and the store's
lineage heads (:meth:`export_scales`, :meth:`rehydrate`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from metisfl_tpu_torch.aggregation.base import (
    Pytree,
    finalize,
    is_host_tree,
    np_finalize,
    np_scaled_add,
    np_scaled_init,
    np_scaled_sub,
    scaled_add,
    scaled_init,
    scaled_sub,
)


class AggState:
    """The rolling state kept across calls: the scaled community sum, the
    running normalisation, the fold locale, and each learner's latest
    counted ``(scale, model)`` (what a re-submission subtracts)."""

    def __init__(self):
        self.wc_scaled: Optional[Pytree] = None
        self.z: float = 0.0
        self.use_numpy: bool = False
        self.contributions: Dict[str, Tuple[float, Pytree]] = {}

    def reset(self) -> None:
        self.wc_scaled = None
        self.z = 0.0
        self.use_numpy = False
        self.contributions.clear()


class _RollingBase:
    required_lineage = 1

    def __init__(self):
        self._state = AggState()

    def reset(self) -> None:
        self._state.reset()

    def _community(self, template: Pytree) -> Pytree:
        fin = np_finalize if self._state.use_numpy else finalize
        return fin(self._state.wc_scaled, self._state.z, like=template)

    def _add(self, learner_id: str, model: Pytree, scale: float) -> None:
        state = self._state
        if state.wc_scaled is None:
            state.use_numpy = is_host_tree(model)
            init = np_scaled_init if state.use_numpy else scaled_init
            state.wc_scaled = init(model, scale)
        else:
            add = np_scaled_add if state.use_numpy else scaled_add
            state.wc_scaled = add(state.wc_scaled, model, scale)
        state.z += float(scale)
        state.contributions[learner_id] = (float(scale), model)

    def _remove(self, learner_id: str) -> None:
        state = self._state
        prev = state.contributions.pop(learner_id, None)
        if prev is not None and state.wc_scaled is not None:
            old_scale, old_model = prev
            sub = np_scaled_sub if state.use_numpy else scaled_sub
            state.wc_scaled = sub(state.wc_scaled, old_model, old_scale)
            state.z -= old_scale

    # -- one contribution at a time ----------------------------------------

    def fold(self, learner_id: str, model: Pytree, scale: float) -> None:
        """Fold one contribution; a re-submission replaces the learner's
        previous one."""
        self._remove(learner_id)
        self._add(learner_id, model, scale)

    def forget(self, learner_id: str) -> None:
        """Subtract a learner's contribution (it left, or was dropped)."""
        self._remove(learner_id)

    def contributors(self):
        return set(self._state.contributions)

    def fold_result(self) -> Pytree:
        """The community model of the current rolling state."""
        if self._state.wc_scaled is None or self._state.z <= 0.0:
            raise ValueError("fold_result called with no contributions")
        template = next(iter(self._state.contributions.values()))[1]
        return self._community(template)

    # -- checkpoint / resume ----------------------------------------------

    def export_scales(self) -> Dict[str, float]:
        """``learner_id -> scale`` of every counted contribution: the part
        of the rolling state the model store cannot give back (the models
        are its lineage heads)."""
        return {lid: scale
                for lid, (scale, _) in self._state.contributions.items()}

    def rehydrate(self, store, scales: Dict[str, float]) -> int:
        """Rebuild ``wc_scaled`` and ``z`` after a controller restart from
        the store's lineage and the checkpointed scales: each learner's
        newest stored model (lineage[0]) re-enters the sum, so a model
        inserted between the checkpoint and the crash is adopted, as the
        uninterrupted run's recency rule would. Returns the contributions
        restored (a learner whose models the store did not keep, as an
        in-memory store after a restart, is skipped)."""
        self.reset()
        picked = store.select(list(scales), k=1)  # only the head re-enters
        restored = 0
        for lid, scale in scales.items():
            lineage = picked.get(lid)
            if not lineage:
                continue
            self._add(lid, lineage[0], float(scale))
            restored += 1
        return restored

    def aggregate(
        self,
        models: Sequence[Tuple[Sequence[Pytree], float]],
        state=None,
        learner_ids: Optional[Sequence[str]] = None,
    ) -> Pytree:
        """Fold ``models`` = [(lineage, scale), ...] (``learner_ids`` in the
        same order) into the rolling state and return its community
        model. A learner already counted has its previous contribution
        replaced."""
        if not models:
            raise ValueError(f"{type(self).__name__}.aggregate called with "
                             "no models")
        ids = learner_ids or [f"_anon{i}" for i in range(len(models))]
        template = None
        for lid, (lineage, scale) in zip(ids, models):
            model = lineage[0]
            if template is None:
                template = model
            self.fold(lid, model, scale)
        return self._community(template)


class FedStride(_RollingBase):
    """Stride-blocked synchronous rolling FedAvg (bounded memory)."""

    name = "fedstride"


class FedRec(_RollingBase):
    """Recency aggregation: each learner's newest contribution counts."""

    name = "fedrec"
    required_lineage = 2
