"""Round scheduling policies: synchronous (with quorum barriers),
semi-synchronous, asynchronous and FedBuff-style buffered asynchronous.

The port's copy of the JAX package's ``scheduling.py``: the synchronous
barrier releases when every dispatched learner still active has reported,
or, with a ``quorum``, when that many have (the reporters are the cohort);
the semi-synchronous scheduler adds per-learner step budgets matched to
the slowest learner's epoch; the asynchronous scheduler releases every
reporter alone; the buffered one releases per ``buffer_size`` reporters
(Nguyen et al., AISTATS 2022). Pure in-memory policy objects, no I/O.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set


class SynchronousScheduler:
    """Release the round cohort only when every dispatched learner reports.

    The barrier is the set of learners the controller actually dispatched
    train tasks to this round (``notify_dispatched``), not all active
    learners, so participation_ratio < 1 cannot deadlock a round on
    learners that were never asked to train. When no dispatch was recorded
    the barrier falls back to all active learners.

    ``quorum`` turns the full barrier into a K-of-N one: the round
    releases the moment K dispatched learners reported, with the
    reporters as the cohort. ``quorum=0`` and any quorum >= the dispatched
    cohort's size are the full barrier: the target clamps to the
    barrier's size.
    """

    name = "synchronous"

    def __init__(self, quorum: int = 0):
        self.quorum = int(quorum)
        self._completed: Set[str] = set()
        self._dispatched: Set[str] = set()

    def notify_dispatched(self, learner_ids: Sequence[str]) -> None:
        self._dispatched.update(learner_ids)

    def dispatched_ids(self) -> Set[str]:
        """The current round's dispatched barrier set (a copy): the
        dispatch-retry path samples replacements outside it."""
        return set(self._dispatched)

    def _barrier(self, active: Sequence[str]) -> List[str]:
        # only learners still active count: one leaving mid-round must not
        # stall the federation forever
        if self._dispatched:
            return [lid for lid in active if lid in self._dispatched]
        return list(active)

    def _target(self, barrier: Sequence[str]) -> int:
        """How many reporters release the round: the full barrier, or the
        quorum when one is set and the barrier is larger."""
        if self.quorum <= 0:
            return len(barrier)
        return min(self.quorum, len(barrier))

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
        done = sum(1 for lid in barrier if lid in self._completed)
        if not barrier or done < self._target(barrier):
            return []
        return self._release(active)

    def handle_leave(self, active: Sequence[str]) -> List[str]:
        """Re-evaluate the barrier after membership shrinks: if the departed
        learner was the last pending one (or the shrunk barrier now meets
        the quorum), release the round now (no later completion event
        would re-check)."""
        if not self._completed:
            return []
        barrier = self._barrier(active)
        # an empty barrier means every dispatched learner left: nothing to
        # aggregate; keep state so round_stalled() reports it
        if not barrier:
            return []
        done = sum(1 for lid in barrier if lid in self._completed)
        if done < self._target(barrier):
            return []
        return self._release(active)

    def drop_dispatched(self, learner_id: str,
                        active: Sequence[str]) -> List[str]:
        """A dispatch to this learner provably failed: remove it from the
        round barrier so the round never waits on a task that was never
        delivered, and release the round if the shrunk barrier is now
        met. Only the dispatch-retry path calls this."""
        if learner_id not in self._dispatched:
            return []
        if self._dispatched == {learner_id}:
            # never empty the barrier: round_stalled() and the deadline own
            # the no-survivors case, and an empty dispatched set would
            # fall back to the all-active barrier
            return []
        self._dispatched.discard(learner_id)
        return self.handle_leave(active)

    def round_stalled(self, active: Sequence[str]) -> bool:
        """True when a dispatched round can never complete because no
        dispatched learner is still active: the caller resets and
        dispatches a fresh round to the surviving learners."""
        return bool(self._dispatched) and not any(
            lid in active for lid in self._dispatched)

    def expire_pending(self, active: Sequence[str]) -> List[str]:
        """Round deadline: drop dispatched-but-unreported learners from
        the barrier and release whoever did report (possibly nobody: the
        caller then re-dispatches)."""
        return self._release(active)

    def reset(self) -> None:
        self._completed.clear()
        self._dispatched.clear()


class AsynchronousScheduler:
    """Immediately reschedule the reporting learner (no round barrier)."""

    name = "asynchronous"

    def notify_dispatched(self, learner_ids: Sequence[str]) -> None:
        pass

    def schedule_next(self, learner_id: str,
                      active: Sequence[str]) -> List[str]:
        return [learner_id]

    def handle_leave(self, active: Sequence[str]) -> List[str]:
        return []

    def round_stalled(self, active: Sequence[str]) -> bool:
        return False

    def expire_pending(self, active: Sequence[str]) -> List[str]:
        return []  # no barrier: a hung learner stalls nobody else

    def reset(self) -> None:
        pass


class BufferedAsynchronousScheduler:
    """FedBuff-style buffered asynchronous aggregation: uplinks fill a
    buffer of ``buffer_size`` reporters and aggregation triggers per fill.
    A reporter is re-dispatched at once (``redispatch_on_completion``,
    read by the controller), so slow learners keep training while fast
    ones fill buffers; their late uplinks carry the staleness that
    ``aggregation.staleness_decay`` damps.

    The fill target is ``min(buffer_size, active)``, so a federation
    smaller than the buffer still aggregates. The buffer holds reporter
    ids in arrival order, one slot per learner (a duplicate arrival before
    the fill keeps the learner's newest contribution).
    """

    name = "asynchronous_buffered"
    redispatch_on_completion = True

    def __init__(self, buffer_size: int = 10):
        self.buffer_size = max(1, int(buffer_size))
        self._buffer: Dict[str, None] = {}  # ordered set: arrival order

    def notify_dispatched(self, learner_ids: Sequence[str]) -> None:
        pass

    def _target(self, active: Sequence[str]) -> int:
        return min(self.buffer_size, max(1, len(active)))

    def _flush(self, active: Sequence[str]) -> List[str]:
        act = set(active)
        cohort = [lid for lid in self._buffer if lid in act]
        self._buffer.clear()
        return cohort

    def schedule_next(self, learner_id: str,
                      active: Sequence[str]) -> List[str]:
        self._buffer[learner_id] = None
        act = set(active)
        live = sum(1 for lid in self._buffer if lid in act)
        if live < self._target(active):
            return []
        return self._flush(active)

    def handle_leave(self, active: Sequence[str]) -> List[str]:
        """Membership shrank: drop departed reporters from the buffer and
        release it if the shrunk fill target is now met."""
        act = set(active)
        for lid in [lid for lid in self._buffer if lid not in act]:
            del self._buffer[lid]
        if self._buffer and len(self._buffer) >= self._target(active):
            return self._flush(active)
        return []

    def round_stalled(self, active: Sequence[str]) -> bool:
        return False  # a partial buffer is progress, not a stall

    def expire_pending(self, active: Sequence[str]) -> List[str]:
        """Deadline: flush whatever the buffer holds (possibly nothing:
        the caller then re-dispatches)."""
        return self._flush(active)

    def pending(self) -> int:
        return len(self._buffer)

    def reset(self) -> None:
        self._buffer.clear()


class SemiSynchronousScheduler(SynchronousScheduler):
    """Synchronous release + per-learner step budget matched to the slowest.

    After a round every learner's local-step count is recomputed so all
    train for ``lambda_`` x the slowest learner's epoch wall-clock:
    ``steps_i = lambda_ * t_slowest_epoch / t_step_i``.
    """

    name = "semi_synchronous"

    def __init__(self, lambda_: float = 1.0,
                 recompute_every_round: bool = False, quorum: int = 0):
        super().__init__(quorum=quorum)
        self.lambda_ = float(lambda_)
        self.recompute_every_round = recompute_every_round
        self._recomputed_once = False

    def recompute_steps(
        self,
        timings: Dict[str, Dict[str, float]],
    ) -> Dict[str, int]:
        """``timings[lid] = {"ms_per_step": float, "steps_per_epoch":
        float}`` → per-learner local-step budgets for the next round."""
        if self.recompute_every_round is False and self._recomputed_once:
            return {}
        usable = {
            lid: t
            for lid, t in timings.items()
            if t.get("ms_per_step", 0) > 0 and t.get("steps_per_epoch", 0) > 0
        }
        if not usable:
            return {}
        slowest_epoch_ms = max(
            t["ms_per_step"] * t["steps_per_epoch"] for t in usable.values()
        )
        budget_ms = self.lambda_ * slowest_epoch_ms
        self._recomputed_once = True
        return {
            lid: max(1, int(budget_ms / t["ms_per_step"]))
            for lid, t in usable.items()
        }


SCHEDULERS = {
    "synchronous": SynchronousScheduler,
    "semi_synchronous": SemiSynchronousScheduler,
    "asynchronous": AsynchronousScheduler,
    "asynchronous_buffered": BufferedAsynchronousScheduler,
}


def make_scheduler(name: str, **kwargs):
    try:
        cls = SCHEDULERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have "
                         f"{sorted(SCHEDULERS)}") from None
    return cls(**kwargs)
