"""Model selection: which stored learner models join an aggregation.

The port's copy of the JAX package's ``selection.py``. With fewer than two
scheduled learners the aggregation uses ALL active learners' latest models;
otherwise exactly the scheduled set. The churn tracker and flap quarantine
are not ported yet (ROADMAP.md Queue 1 item 3f).
"""

from __future__ import annotations

from typing import List, Sequence


class ScheduledCardinalitySelector:
    name = "scheduled_cardinality"

    def select(self, scheduled: Sequence[str],
               active: Sequence[str]) -> List[str]:
        if len(scheduled) < 2:
            return list(active)
        return [lid for lid in scheduled if lid in set(active)]


SELECTORS = {"scheduled_cardinality": ScheduledCardinalitySelector}


def make_selector(name: str):
    try:
        return SELECTORS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown selector {name!r}; have {sorted(SELECTORS)}") from None
