"""The port's schedulers and staleness scaling against the JAX package's.

Both packages' schedulers are fed the same seeded event sequence
(dispatch, complete, leave, expire at a deadline, drop a failed dispatch,
reset) over a changing active set; after every event they must return
the same release (the same learners, in the same order) and agree on
``round_stalled`` and the buffered protocol's ``pending``. The
semi-synchronous ``recompute_steps`` budgets match on random timings,
and ``staleness_factor`` and ``apply_staleness_decay`` agree bit for bit.
"""

import numpy as np
import pytest

from metisfl_tpu import scaling as jax_scaling
from metisfl_tpu import scheduling as jax_scheduling
from metisfl_tpu_torch import scaling, scheduling

CASES = {
    "synchronous": {},
    "synchronous_quorum2": {"quorum": 2},
    "synchronous_quorum5": {"quorum": 5},
    "semi_synchronous": {"lambda_": 0.7},
    "semi_synchronous_quorum3": {"quorum": 3},
    "asynchronous": {},
    "asynchronous_buffered": {"buffer_size": 3},
    "asynchronous_buffered_1": {"buffer_size": 1},
}


def _make(module, case):
    name = case.rsplit("_quorum", 1)[0]
    if name.endswith("_1"):
        name = name[:-2]
    return module.make_scheduler(name, **CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedulers_release_as_the_jax_package_does(case, seed):
    port, jax = _make(scheduling, case), _make(jax_scheduling, case)
    assert port.name == jax.name
    rng = np.random.default_rng(seed)
    everyone = [f"L{i}" for i in range(8)]
    active = list(everyone[:6])
    releases = 0
    for step in range(600):
        kind = rng.choice(["dispatch", "complete", "complete", "complete",
                           "leave", "join", "expire", "drop", "reset"],
                          p=[0.15, 0.2, 0.2, 0.15, 0.07, 0.08, 0.05, 0.07,
                             0.03])
        if kind == "dispatch":
            k = int(rng.integers(1, len(active) + 1)) if active else 0
            ids = sorted(rng.choice(active, size=k, replace=False)) \
                if k else []
            got = (port.notify_dispatched(ids), jax.notify_dispatched(ids))
        elif kind == "complete" and active:
            lid = str(rng.choice(active))
            got = (port.schedule_next(lid, active),
                   jax.schedule_next(lid, active))
        elif kind == "leave" and len(active) > 1:
            active.remove(str(rng.choice(active)))
            got = (port.handle_leave(active), jax.handle_leave(active))
        elif kind == "join":
            missing = [lid for lid in everyone if lid not in active]
            if missing:
                active.append(str(rng.choice(missing)))
            got = (None, None)
        elif kind == "expire":
            got = (port.expire_pending(active), jax.expire_pending(active))
        elif kind == "drop" and hasattr(jax, "drop_dispatched"):
            lid = str(rng.choice(everyone))
            got = (port.drop_dispatched(lid, active),
                   jax.drop_dispatched(lid, active))
        elif kind == "reset":
            got = (port.reset(), jax.reset())
        else:
            continue
        assert got[0] == got[1], (step, kind)
        releases += bool(got[0])
        assert port.round_stalled(active) == jax.round_stalled(active)
        if hasattr(jax, "dispatched_ids"):
            assert port.dispatched_ids() == jax.dispatched_ids()
        if hasattr(jax, "pending"):
            assert port.pending() == jax.pending()
    assert releases > 10
    assert (getattr(port, "redispatch_on_completion", False)
            == getattr(jax, "redispatch_on_completion", False))


@pytest.mark.parametrize("every_round", [False, True])
def test_semi_sync_budgets_match_the_jax_package(every_round):
    rng = np.random.default_rng(int(every_round))
    port = scheduling.make_scheduler(
        "semi_synchronous", lambda_=1.3, recompute_every_round=every_round)
    jax = jax_scheduling.make_scheduler(
        "semi_synchronous", lambda_=1.3, recompute_every_round=every_round)
    for _ in range(20):
        timings = {
            f"L{i}": {"ms_per_step": float(rng.choice(
                [0.0, rng.uniform(0.5, 90.0)], p=[0.1, 0.9])),
                "steps_per_epoch": float(rng.integers(0, 40))}
            for i in range(int(rng.integers(1, 9)))}
        assert port.recompute_steps(timings) == jax.recompute_steps(timings)


def test_recompute_steps_matches_the_slowest_epoch():
    sched = scheduling.make_scheduler("semi_synchronous", lambda_=1.0)
    budgets = sched.recompute_steps({
        "a": {"ms_per_step": 10.0, "steps_per_epoch": 4.0},
        "b": {"ms_per_step": 40.0, "steps_per_epoch": 4.0}})
    # slowest epoch: 160 ms; a runs 16 steps of 10 ms, b 4 of 40 ms
    assert budgets == {"a": 16, "b": 4}
    assert sched.recompute_steps({"a": {"ms_per_step": 1.0,
                                        "steps_per_epoch": 1.0}}) == {}


def test_unknown_scheduler_is_refused():
    with pytest.raises(ValueError, match="unknown scheduler"):
        scheduling.make_scheduler("gossip")


def test_staleness_factor_is_the_jax_package_bits():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        s = float(rng.choice([0.0, rng.integers(0, 50),
                              rng.uniform(-1, 100)]))
        d = float(rng.choice([0.0, rng.uniform(-1, 3), 0.5, 1.0]))
        got = scaling.staleness_factor(s, d)
        want = jax_scaling.staleness_factor(s, d)
        assert np.float64(got).tobytes() == np.float64(want).tobytes()


@pytest.mark.parametrize("decay", [0.0, 0.3, 0.5, 1.0, 2.5])
def test_apply_staleness_decay_is_the_jax_package_bits(decay):
    rng = np.random.default_rng(int(decay * 10))
    for _ in range(200):
        n = int(rng.integers(1, 10))
        metadata = {f"L{i}": {"num_train_examples": float(
            rng.integers(0, 50)), "staleness": float(rng.integers(0, 6))}
            for i in range(n)}
        for name in ("participants", "train_dataset_size"):
            scales = scaling.make_scaler(name)(metadata)
            got = scaling.apply_staleness_decay(scales, metadata, decay)
            want = jax_scaling.apply_staleness_decay(
                jax_scaling.make_scaler(name)(metadata), metadata, decay)
            assert list(got) == list(want)
            assert all(np.float64(got[k]).tobytes()
                       == np.float64(want[k]).tobytes() for k in got)
