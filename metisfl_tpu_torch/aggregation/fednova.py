"""FedNova: normalized averaging for heterogeneous local work.

The port's copy of the JAX package's ``aggregation/fednova.py`` (Wang et
al., NeurIPS 2020). Learners that complete different numbers of local
steps τᵢ bias plain FedAvg toward whoever stepped most; FedNova averages
per-step normalized updates and rescales by the effective step count:

    x⁺ = x + τ_eff · Σᵢ pᵢ (wᵢ - x)/τᵢ,     τ_eff = Σᵢ pᵢ τᵢ

which is a q-weighted FedAvg fold plus one affine correction:

    qᵢ = pᵢ/τᵢ,  Q = Σ qᵢ,  avg_q = Σ qᵢ wᵢ / Q
    x⁺ = x + (τ_eff · Q) · (avg_q - x)

The fold is the port's :class:`FedAvg` (one stride block resident at a
time); the correction runs once a round on the host in fp32 numpy, the
JAX package's code line for line. With uniform τ it is FedAvg. The
controller passes each learner's ``completed_batches`` as ``steps``
(``needs_local_steps``). Like :class:`ServerOpt`, :meth:`result` stages
the new previous model and :meth:`commit` installs it, and
:meth:`export_state`/:meth:`restore_state` carry the model it steps from
through a controller checkpoint.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.aggregation.base import Pytree, host_array
from metisfl_tpu_torch.aggregation.fedavg import FedAvg
from metisfl_tpu_torch.aggregation.serveropt import (
    check_structure,
    to_f32,
    unpack_f32,
)
from metisfl_tpu_torch.tensor.pytree import (
    pack_model,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


class FedNova:
    name = "fednova"
    required_lineage = 1
    # the controller passes per-learner local step counts to accumulate()
    needs_local_steps = True

    def __init__(self):
        self._fold = FedAvg()
        self._state_lock = threading.Lock()
        self._prev: Optional[Pytree] = None   # fp32 host community model
        self._staged: Optional[Pytree] = None
        self.reset()

    # -- fold interface ----------------------------------------------------

    def reset(self) -> None:
        self._fold.reset()
        self._sum_q = 0.0      # Σ pᵢ/τᵢ
        self._tau_eff = 0.0    # Σ pᵢτᵢ
        self._sum_p = 0.0      # Σ pᵢ over the models accumulated

    def accumulate(
        self,
        models: Sequence[Tuple[Sequence[Pytree], float]],
        steps: Optional[Sequence[float]] = None,
    ) -> None:
        if steps is None or len(steps) != len(models):
            raise ValueError(
                "fednova requires one local-step count per model "
                f"(got {None if steps is None else len(steps)} for "
                f"{len(models)} models)")
        adjusted = []
        for (lineage, p), tau in zip(models, steps):
            tau = max(1.0, float(tau))
            adjusted.append((lineage, float(p) / tau))
            self._sum_q += float(p) / tau
            self._tau_eff += float(p) * tau
            self._sum_p += float(p)
        self._fold.accumulate(adjusted)

    def result(self) -> Pytree:
        avg_q = tree_map(host_array, self._fold.result())
        with self._state_lock:
            return self._apply_correction(avg_q)

    def aggregate(self, models, steps=None, state=None) -> Pytree:
        """One-shot: accumulate everything, result, commit."""
        self.reset()
        self.accumulate(models, steps=steps)
        out = self.result()
        self.commit()
        self.reset()
        return out

    def commit(self) -> None:
        with self._state_lock:
            if self._staged is not None:
                self._prev = self._staged
                self._staged = None

    # -- persistence (controller checkpoint) --------------------------------

    def export_state(self) -> Dict[str, Any]:
        with self._state_lock:
            out: Dict[str, Any] = {"rule": self.name}
            if self._prev is not None:
                out["prev"] = pack_model(self._prev)
            return out

    def restore_state(self, state: Dict[str, Any]) -> None:
        if state.get("rule") not in (None, self.name):
            raise ValueError(
                f"checkpoint aggregation state is for {state.get('rule')!r},"
                f" this rule is {self.name!r}")
        with self._state_lock:
            if state.get("prev"):
                self._prev = unpack_f32(state["prev"])
            self._staged = None

    # -- the normalized step -----------------------------------------------

    def seed_community(self, community: Pytree) -> None:
        with self._state_lock:
            self._prev = tree_map(to_f32, community)

    def _apply_correction(self, avg_q: Pytree) -> Pytree:
        if self._prev is None:
            # no seeded model: adopt the q-average (the next round steps
            # from it)
            self._staged = tree_map(to_f32, avg_q)
            return avg_q
        check_structure(self._prev, avg_q, "fednova")
        # scales are normalized over the selected cohort; learners dropped
        # before accumulate leave Σpᵢ = s < 1, and τ_eff and Q are both
        # linear in p, so each is renormalized by s
        s = self._sum_p
        eff = (self._tau_eff * self._sum_q) / (s * s) if s > 0.0 else 0.0

        def leaf(prev, a):
            if np.issubdtype(a.dtype, np.integer):
                return a  # discrete state: adopt the average
            return (prev + eff * (np.asarray(a, np.float32) - prev)) \
                .astype(np.float32)

        new_prev = tree_unflatten(avg_q, [leaf(p, a) for p, a in zip(
            tree_leaves(self._prev), tree_leaves(avg_q))])
        self._staged = new_prev
        # the community keeps each tensor's storage dtype (wire contract)
        return tree_map(lambda n, a: np.asarray(n).astype(a.dtype),
                        new_prev, avg_q)
