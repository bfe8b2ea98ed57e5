"""Streaming aggregation: fold uplinks into the community accumulator as
they arrive off the wire, with no store round trip.

The port's copy of the JAX package's ``aggregation/streaming.py``. For the
rules whose community model is a weighted sum (plain ``fedavg`` and the
rolling rules ``fedstride``/``fedrec``) each accepted uplink can enter the
accumulator the moment the completion handler has it, and the community
model materializes at barrier release with zero store reads.

Fold order (the bit-identity contract):

- **Rolling rules** fold per arrival with the kernels their store-based
  ``aggregate`` uses (``np_scaled_add``, same accumulator dtype). The
  community model is bit-identical to the store path whenever the arrival
  order matches the selection order the store path would have folded in;
  under another arrival order it is equal up to fp reassociation.
- **fedavg** buffers arrivals into blocks of the store path's
  ``stride_length`` and folds each full block with the same stacked
  kernel (``FedAvg.accumulate``): identical blocking and kernels, so
  bit-identity again holds under matching order. Peak residency is one
  stride block of models, as on the store path.

Weights are raw (:func:`metisfl_tpu_torch.scaling.raw_weight`) because the
cohort's normalizer is unknown at arrival time; ``finish`` divides by
z = Σw. Within a round that is the normalized store path up to fp
rounding, and bit-identical when the weights are uniform powers of two.

The controller builds a :class:`StreamingAggregator` only when
``aggregation.streaming`` is on and the rule, protocol and lineage allow
it (:func:`streaming_supported`); anything else falls back to the store
path (logged), and the opt-out hot path is one attribute check. Folds are
host numpy, as on the store path.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from metisfl_tpu_torch.aggregation.rolling import _RollingBase

logger = logging.getLogger("metisfl_tpu_torch.aggregation.streaming")

# rules whose round community model is a weighted sum the stream can fold
STREAMING_RULES = ("fedavg", "fedstride", "fedrec")


def streaming_supported(rule_name: str, protocol: str,
                        secure_enabled: bool,
                        store_lineage_length: int,
                        required_lineage: int,
                        checkpointed: bool = False,
                        buffer_size: int = 0) -> bool:
    """Can the controller fold uplinks on arrival for this federation?

    - only the weighted-sum rules (robust, fednova and the server
      optimizers need whole cohorts or state of their own: store path);
    - never under secure aggregation (opaque payloads; masked payloads
      fold through ``secure/distributed.py`` instead);
    - only where ``lineage_length`` permits: an operator keeping more
      store history than the rule needs wants the store written;
    - ``fedavg``/``fedstride`` are round-scoped sums over the barrier's
      cohort: not under the plain asynchronous protocol, and under
      ``asynchronous_buffered`` only with ``buffer_size >= 2``;
    - ``fedrec`` with checkpoints needs the store: a restore rebuilds the
      cross-round rolling sum from store lineage.
    """
    rule = rule_name.lower()
    if rule not in STREAMING_RULES or secure_enabled:
        return False
    if store_lineage_length > required_lineage:
        return False
    if rule in ("fedavg", "fedstride"):
        if protocol == "asynchronous":
            return False
        if protocol == "asynchronous_buffered" and buffer_size < 2:
            return False
    if rule == "fedrec" and checkpointed:
        return False
    return True


class StreamingAggregator:
    """Wraps the controller's aggregation rule with an arrival-order fold.

    ``fold``/``finish``/``abandon`` run on the controller's single
    scheduling worker, and ``forget`` is routed there too; the lock guards
    only the counters :meth:`stats` reads from other threads."""

    def __init__(self, rule, stride: int = 0):
        self._rule = rule
        self._stride = int(stride)
        self._rolling = isinstance(rule, _RollingBase)
        # fedavg: the block buffer and the round's fold bookkeeping
        self._block: List[Tuple[Any, float]] = []
        self._folded: Set[str] = set()
        self._fold_count = 0
        self._lock = threading.Lock()

    @property
    def rule_name(self) -> str:
        return self._rule.name

    # -- uplink path (scheduling worker) -----------------------------------
    def fold(self, learner_id: str, model: Any, weight: float) -> None:
        """Fold one accepted uplink. Rolling rules fold at once (a
        re-submission replaces the previous contribution); fedavg buffers
        until a stride block is full, then folds it with the store path's
        stacked kernel."""
        if self._rolling:
            self._rule.fold(learner_id, model, weight)
        else:
            if learner_id in self._folded:
                # a stacked fold cannot replace a folded contribution: a
                # duplicate within one round keeps the first
                logger.warning("duplicate streaming fold from %s ignored",
                               learner_id)
                return
            self._block.append((model, float(weight)))
            if self._stride > 0 and len(self._block) >= self._stride:
                self._flush_block()
        with self._lock:
            self._folded.add(learner_id)
            self._fold_count += 1

    def _flush_block(self) -> None:
        if not self._block:
            return
        self._rule.accumulate([([m], w) for m, w in self._block])
        self._block.clear()

    def forget(self, learner_id: str) -> None:
        """A learner left: subtract its contribution where the rule can
        (rolling state). fedavg's folded blocks cannot un-fold; its round
        sum keeps the contribution and ``finish`` logs it."""
        if self._rolling:
            self._rule.forget(learner_id)
            with self._lock:
                self._folded.discard(learner_id)

    # -- barrier release ---------------------------------------------------
    def finish(self, selected: Sequence[str]) -> Optional[Dict[str, Any]]:
        """The community model from the streamed folds for the released
        cohort; None when nothing folded (the caller logs and goes on, as
        the store path does on an empty select)."""
        selected_set = set(selected)
        if self._rolling:
            if self._rule.name == "fedstride":
                # round-scoped: contributions outside the released cohort
                # are subtracted (exact: the models are in the state)
                for lid in list(self._rule.contributors() - selected_set):
                    self._rule.forget(lid)
            # fedrec keeps every contributor: its sum spans rounds
            try:
                community = self._rule.fold_result()
            except ValueError:
                community = None
            self._reset_round()
            return community
        # fedavg: a fold outside the cohort comes from a learner that
        # uplinked and then left mid-round; a stacked fold cannot be
        # subtracted, so the round keeps it and completes
        extra = self._folded - selected_set
        if extra:
            logger.warning(
                "streamed folds from departed learners %s stay in the "
                "round sum (stacked folds cannot be subtracted)",
                sorted(extra)[:5])
        self._flush_block()
        try:
            community = self._rule.result()
        except ValueError:
            community = None
        self._reset_round()
        return community

    def abandon(self) -> None:
        """The round was abandoned: drop the round's fold state so the
        re-dispatched round starts clean (FedRec's rolling state stays)."""
        self._reset_round()

    def _reset_round(self) -> None:
        if self._rolling:
            if self._rule.name == "fedstride":
                self._rule.reset()
        else:
            self._rule.reset()
        self._block.clear()
        with self._lock:
            self._folded.clear()

    # -- status ------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"rule": self._rule.name,
                    "folded": len(self._folded),
                    "fold_count": self._fold_count}
