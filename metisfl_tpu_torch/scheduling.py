"""Round scheduling: the synchronous barrier.

The port's copy of the JAX package's ``scheduling.py`` for the synchronous
protocol with the full-cohort barrier: the round releases when every
dispatched learner still active has reported. Quorum barriers, deadline
expiry, dispatch retries and the semi-synchronous, asynchronous and
buffered-asynchronous schedulers are not ported yet (ROADMAP.md Queue 1
item 3f). A pure in-memory policy object, no I/O.
"""

from __future__ import annotations

from typing import List, Sequence, Set


class SynchronousScheduler:
    """Release the round cohort only when every dispatched learner reports.

    The barrier is the set of learners the controller actually dispatched
    train tasks to this round (``notify_dispatched``), not all active
    learners, so participation_ratio < 1 cannot deadlock a round on
    learners that were never asked to train. When no dispatch was recorded
    the barrier falls back to all active learners.
    """

    name = "synchronous"

    def __init__(self):
        self._completed: Set[str] = set()
        self._dispatched: Set[str] = set()

    def notify_dispatched(self, learner_ids: Sequence[str]) -> None:
        self._dispatched.update(learner_ids)

    def _barrier(self, active: Sequence[str]) -> List[str]:
        # only learners still active count: one leaving mid-round must not
        # stall the federation forever
        if self._dispatched:
            return [lid for lid in active if lid in self._dispatched]
        return list(active)

    def _release(self, active: Sequence[str]) -> List[str]:
        cohort = [lid for lid in self._barrier(active)
                  if lid in self._completed]
        self._completed.clear()
        self._dispatched.clear()
        return cohort

    def schedule_next(self, learner_id: str,
                      active: Sequence[str]) -> List[str]:
        self._completed.add(learner_id)
        barrier = self._barrier(active)
        if not barrier or not all(lid in self._completed for lid in barrier):
            return []
        return self._release(active)

    def handle_leave(self, active: Sequence[str]) -> List[str]:
        """Re-evaluate the barrier after membership shrinks: if the departed
        learner was the last pending one, release the round now (no later
        completion event would re-check)."""
        if not self._completed:
            return []
        barrier = self._barrier(active)
        # an empty barrier means every dispatched learner left: nothing to
        # aggregate; keep state so round_stalled() reports it
        if not barrier or not all(lid in self._completed for lid in barrier):
            return []
        return self._release(active)

    def round_stalled(self, active: Sequence[str]) -> bool:
        """True when a dispatched round can never complete because no
        dispatched learner is still active: the caller resets and
        dispatches a fresh round to the surviving learners."""
        return bool(self._dispatched) and not any(
            lid in active for lid in self._dispatched)

    def reset(self) -> None:
        self._completed.clear()
        self._dispatched.clear()


SCHEDULERS = {"synchronous": SynchronousScheduler}


def make_scheduler(name: str):
    try:
        return SCHEDULERS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have "
                         f"{sorted(SCHEDULERS)}") from None
