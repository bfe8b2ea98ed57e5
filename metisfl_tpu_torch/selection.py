"""Model selection and churn-aware admission: which stored learner models
join an aggregation, and which learners are healthy enough to dispatch to.

The port's copy of the JAX package's ``selection.py``. With fewer than two
scheduled learners the aggregation uses ALL active learners' latest models;
otherwise exactly the scheduled set. :class:`ChurnTracker` scores each
learner's churn (an EWMA of leave, flap-rejoin and failed-dispatch events)
and optionally quarantines flapping learners, which cohort sampling
consults. The selector records the health plane's advisory divergence
scores (``telemetry.health.advisory``) without letting them change its
choice.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence


class ScheduledCardinalitySelector:
    name = "scheduled_cardinality"

    def __init__(self):
        # the latest advisory divergence scores the controller handed over
        # (telemetry.health.advisory): recorded for operators and tests;
        # the choice is deliberately unaffected by them
        self.last_advisory_scores: Optional[Dict[str, float]] = None

    def select(self, scheduled: Sequence[str], active: Sequence[str],
               advisory_scores: Optional[Dict[str, float]] = None,
               ) -> List[str]:
        if advisory_scores is not None:
            self.last_advisory_scores = dict(advisory_scores)
        if len(scheduled) < 2:
            return list(active)
        return [lid for lid in scheduled if lid in set(active)]


class ChurnTracker:
    """Per-learner churn/flap scores with optional quarantine.

    Each churn event (``leave``, ``flap_rejoin``, ``dispatch_failure``)
    blends a 1.0 observation in (``score = alpha + (1-alpha)*score``), each
    completion a 0.0, so a learner that leaves and rejoins every few rounds
    saturates toward 1.0 while one that delivers steadily decays toward 0.

    Quarantine (``quarantine_score > 0`` arms it): a churn event that lifts
    a learner's score past the threshold excludes it from cohort sampling
    for ``quarantine_s`` seconds. The tracker survives leave (a flapper's
    history is the signal); its state is bounded by ``max_entries`` with
    oldest-touched eviction. Thread-safe: the controller notes events from
    RPC threads and samples cohorts on its scheduling worker.
    """

    def __init__(self, alpha: float = 0.3, quarantine_score: float = 0.0,
                 quarantine_s: float = 30.0, max_entries: int = 8192):
        self.alpha = float(alpha)
        self.quarantine_score = float(quarantine_score)
        self.quarantine_s = float(quarantine_s)
        self.max_entries = max(16, int(max_entries))
        self._lock = threading.Lock()
        # learner_id -> score, in touch order for the bounded eviction
        self._scores: Dict[str, float] = {}
        self._quarantined_until: Dict[str, float] = {}

    # events worth a full 1.0 observation
    CHURN_EVENTS = ("leave", "flap_rejoin", "dispatch_failure")

    def note(self, learner_id: str, event: str,
             now: Optional[float] = None) -> float:
        """Fold one membership event into the learner's score and return
        the score after the blend (``event='completion'`` is the decay
        tick); quarantine arms when a churn event pushes it past the
        threshold."""
        observation = 1.0 if event in self.CHURN_EVENTS else 0.0
        now = time.time() if now is None else now
        with self._lock:
            prev = self._scores.pop(learner_id, 0.0)  # pop+set: touch order
            score = self.alpha * observation + (1.0 - self.alpha) * prev
            self._scores[learner_id] = score
            while len(self._scores) > self.max_entries:
                evicted, _ = next(iter(self._scores.items()))
                del self._scores[evicted]
                self._quarantined_until.pop(evicted, None)
            if (observation > 0.0 and self.quarantine_score > 0.0
                    and score >= self.quarantine_score):
                self._quarantined_until[learner_id] = now + self.quarantine_s
            return score

    def score(self, learner_id: str) -> float:
        with self._lock:
            return self._scores.get(learner_id, 0.0)

    def scores(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._scores)

    def quarantined(self, learner_id: str,
                    now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        with self._lock:
            until = self._quarantined_until.get(learner_id, 0.0)
            if until and until <= now:
                del self._quarantined_until[learner_id]  # expired
                return False
            return until > now

    def quarantined_ids(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        with self._lock:
            expired = [lid for lid, until in self._quarantined_until.items()
                       if until <= now]
            for lid in expired:
                del self._quarantined_until[lid]
            return sorted(self._quarantined_until)


SELECTORS = {"scheduled_cardinality": ScheduledCardinalitySelector}


def make_selector(name: str):
    try:
        return SELECTORS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown selector {name!r}; have "
                         f"{sorted(SELECTORS)}") from None
