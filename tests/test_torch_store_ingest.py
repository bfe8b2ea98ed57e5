"""The port's parallel store-ingest plane (``store/ingest.py``) and the
per-learner store thread-safety contract (``store/base.py``): every case
of the JAX package's tests/test_store_ingest.py, run against the port's
pipeline, stores and controller. Backpressure, per-learner drain,
fail-soft writes, the membership gate, ``on_success``, shutdown, the
insert/select/erase hammer, batched fsyncs and the sequence cache under
concurrency. The soak case keeps its JAX sizes and its ``slow`` mark.
"""

import os
import threading
import time

import numpy as np
import pytest

from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore
from metisfl_tpu_torch.store.cached import CachedDiskStore
from metisfl_tpu_torch.store.disk import DiskModelStore
from metisfl_tpu_torch.store.ingest import IngestPipeline
from metisfl_tpu_torch.store.memory import InMemoryModelStore


def _model(tag: int, n: int = 64):
    """Two arrays derived from one tag: a select that ever returns
    mismatched halves has observed a torn lineage."""
    return {"a/w": np.full((n,), np.float32(tag)),
            "b/w": np.full((n // 2,), np.float32(tag))}


def _tag_of(model):
    a = float(np.asarray(model["a/w"])[0])
    b = float(np.asarray(model["b/w"])[0])
    assert a == b, f"torn model: halves tagged {a} vs {b}"
    assert np.all(np.asarray(model["a/w"]) == a)
    assert np.all(np.asarray(model["b/w"]) == b)
    return int(a)


def test_disk_fast_path_roundtrips_flat_dicts(tmp_path):
    """A flat tensor dict inserted through DiskModelStore takes the
    streamed v3 fast path; the shared read path decodes it to the same
    tensors a staged v2 write would have produced."""
    store = DiskModelStore(str(tmp_path / "s"),
                           EvictionPolicy.LINEAGE_LENGTH, lineage_length=2)
    model = _model(11)
    store.insert("L0", model)
    blob_file = next(f for f in os.listdir(store._dir("L0"))
                     if f.endswith(".blob"))
    with open(os.path.join(store._dir("L0"), blob_file), "rb") as fh:
        data = fh.read()
    assert data[4] == 3  # store-local files are the no-crc variant
    picked = store.select(["L0"], k=1)
    assert _tag_of(picked["L0"][0]) == 11
    for key, arr in model.items():
        np.testing.assert_array_equal(picked["L0"][0][key], arr)
    store.shutdown()


# --------------------------------------------------------------------- #
# ingest pipeline
# --------------------------------------------------------------------- #

def test_ingest_lands_models_and_attributes_worker_time(tmp_path):
    """Every submitted model is selectable after drain, and the
    attribution callback fires once per successful write with the
    WORKER's measured duration (satellite: no double count — the
    enqueueing thread records nothing; the callback is the only sample)."""
    store = DiskModelStore(str(tmp_path / "s"),
                           EvictionPolicy.LINEAGE_LENGTH, lineage_length=1)
    samples = []
    pipe = IngestPipeline(store, workers=4,
                          on_insert=lambda lid, ms: samples.append((lid, ms)))
    ids = [f"L{i}" for i in range(16)]
    for i, lid in enumerate(ids):
        pipe.submit(lid, _model(i))
    assert pipe.drain(timeout=30.0)
    assert pipe.queue_depth() == 0
    picked = store.select(ids, k=1)
    assert sorted(picked) == sorted(ids)
    for i, lid in enumerate(ids):
        assert _tag_of(picked[lid][0]) == i
    assert sorted(lid for lid, _ in samples) == sorted(ids)
    assert all(ms >= 0.0 for _, ms in samples)
    pipe.shutdown()
    store.shutdown()


def test_ingest_backpressure_bounds_queue():
    """The queue is bounded: submit blocks once max_pending writes are
    queued or in flight, so a flood of uplinks throttles at the
    transport instead of buffering the cohort in controller RAM."""
    gate = threading.Event()

    class SlowStore(InMemoryModelStore):
        def _append(self, learner_id, model):
            gate.wait(10.0)
            super()._append(learner_id, model)

    store = SlowStore()
    pipe = IngestPipeline(store, workers=1, max_pending=3)
    for i in range(3):
        pipe.submit(f"L{i}", _model(i))
    assert pipe.queue_depth() == 3
    blocked = threading.Event()

    def overflow():
        pipe.submit("L3", _model(3))
        blocked.set()

    t = threading.Thread(target=overflow, daemon=True)
    t.start()
    assert not blocked.wait(0.3), "submit past max_pending did not block"
    gate.set()
    assert blocked.wait(10.0), "blocked submit never unblocked"
    assert pipe.drain(timeout=10.0)
    assert len(store.learner_ids()) == 4
    pipe.shutdown()


def test_ingest_per_learner_drain():
    """drain(learner_id) waits only for THAT learner's queued writes —
    the leave() path must not stall behind the whole queue."""
    slow_gate = threading.Event()

    class GatedStore(InMemoryModelStore):
        def _append(self, learner_id, model):
            if learner_id == "slow":
                slow_gate.wait(10.0)
            super()._append(learner_id, model)

    store = GatedStore()
    pipe = IngestPipeline(store, workers=2)
    pipe.submit("slow", _model(0))
    time.sleep(0.05)  # let the slow write occupy its worker
    pipe.submit("fast", _model(1))
    assert pipe.drain("fast", timeout=10.0)
    assert "fast" in store.learner_ids()
    assert "slow" not in store.learner_ids()  # still gated
    slow_gate.set()
    assert pipe.drain(timeout=10.0)
    assert "slow" in store.learner_ids()
    pipe.shutdown()


def test_ingest_write_failure_is_failsoft():
    """A raising insert is counted, logged, and does NOT wedge the drain
    fence or feed the attribution callback; other learners land."""

    class FlakyStore(InMemoryModelStore):
        def _append(self, learner_id, model):
            if learner_id == "bad":
                raise RuntimeError("disk on fire")
            super()._append(learner_id, model)

    store = FlakyStore()
    samples = []
    pipe = IngestPipeline(store, workers=2,
                          on_insert=lambda lid, ms: samples.append(lid))
    pipe.submit("good", _model(1))
    pipe.submit("bad", _model(2))
    assert pipe.drain(timeout=10.0)
    count, tail = pipe.errors()
    assert count == 1 and "bad" in tail[0]
    assert store.learner_ids() == ["good"]
    assert samples == ["good"]
    pipe.shutdown()


def test_ingest_membership_gate_drops_departed_writes():
    """The worker re-checks ``accept`` right before the write: a queued
    write whose learner was erased between enqueue and execution (a
    completion racing leave()) must not land and resurrect the lineage."""
    gate = threading.Event()
    started = threading.Event()
    members = {"blocker", "alive", "leaving"}

    class GatedStore(InMemoryModelStore):
        def _append(self, learner_id, model):
            if learner_id == "blocker":
                started.set()
                gate.wait(10.0)
            super()._append(learner_id, model)

    store = GatedStore()
    pipe = IngestPipeline(store, workers=1,
                          accept=lambda lid: lid in members)
    pipe.submit("blocker", _model(9))   # occupies the single worker
    assert started.wait(10.0)
    pipe.submit("leaving", _model(0))   # queued behind the blocker
    pipe.submit("alive", _model(1))
    members.discard("leaving")          # leave() erased it while queued
    gate.set()
    assert pipe.drain(timeout=10.0)
    assert sorted(store.learner_ids()) == ["alive", "blocker"]
    count, _ = pipe.errors()
    assert count == 0  # a gate drop is not an error
    pipe.shutdown()


def test_ingest_on_success_fires_only_when_write_lands():
    """Per-submit on_success runs before the drain fence returns, and
    ONLY for writes that landed — the controller pairs result metadata
    with the stored model through it, so a fail-soft write failure must
    not trigger it."""

    class FlakyStore(InMemoryModelStore):
        def _append(self, learner_id, model):
            if learner_id == "bad":
                raise RuntimeError("disk on fire")
            super()._append(learner_id, model)

    store = FlakyStore()
    pipe = IngestPipeline(store, workers=2)
    landed = []
    pipe.submit("good", _model(1), on_success=lambda ms: landed.append(ms))
    pipe.submit("bad", _model(2), on_success=lambda ms: landed.append(-1.0))
    assert pipe.drain(timeout=10.0)
    assert len(landed) == 1 and landed[0] >= 0.0
    pipe.shutdown()


def test_controller_failed_ingest_write_keeps_old_metadata():
    """Controller-level pin for the metadata-pairing invariant: when the
    worker's write fails (fail-soft), the learner's completed_batches
    must keep pairing with the older stored model."""
    from metisfl_tpu_torch.comm.messages import (JoinRequest, TaskResult,
                                                 TrainParams)
    from metisfl_tpu_torch.config import (AggregationConfig, EvalConfig,
                                          FederationConfig)
    from metisfl_tpu_torch.controller.core import Controller
    from metisfl_tpu_torch.tensor.pytree import pack_model

    class _NullProxy:
        def __init__(self, record):
            self.learner_id = record.learner_id

        def run_task(self, task):
            pass

        def evaluate(self, task, callback):
            pass

    cfg = FederationConfig(
        protocol="synchronous",
        aggregation=AggregationConfig(rule="fedavg", scaler="participants"),
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0),
    )
    cfg.model_store.ingest_workers = 2
    ctrl = Controller(cfg, proxy_factory=_NullProxy)
    real_insert = ctrl._store.insert
    try:
        ctrl.set_community_model(pack_model(
            {"w": np.zeros(4, np.float32)}))
        for i in range(2):
            ctrl.join(JoinRequest(hostname="h", port=7600 + i,
                                  num_train_examples=10))
        lids = sorted(ctrl.active_learners())
        with ctrl._lock:
            tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
        victim = lids[0]

        def flaky_insert(lid, model):
            if lid == victim:
                raise RuntimeError("disk on fire")
            real_insert(lid, model)

        ctrl._store.insert = flaky_insert
        for i, lid in enumerate(lids):
            assert ctrl.task_completed(TaskResult(
                task_id=f"t0_{lid}", learner_id=lid,
                auth_token=tokens[lid],
                model=pack_model({"w": np.full(4, float(i + 1),
                                               np.float32)}),
                round_id=0, completed_batches=7))
        # completions process on the scheduling executor: the round
        # advancing proves both handlers (and the drain fence before the
        # aggregate) ran
        deadline = time.monotonic() + 30.0
        while ctrl.global_iteration < 1:
            assert time.monotonic() < deadline, "round never completed"
            time.sleep(0.02)
        assert ctrl._ingest.drain(timeout=30.0)
        with ctrl._lock:
            assert ctrl._learners[victim].completed_batches == 0
            assert ctrl._learners[lids[1]].completed_batches == 7
        count, tail = ctrl._ingest.errors()
        assert count == 1 and victim in tail[0]
        meta = ctrl.round_metadata[0]
        assert set(meta.ingest_write_duration_ms) == {lids[1]}
        assert meta.ingest_drain_duration_ms >= 0.0
    finally:
        ctrl._store.insert = real_insert
        ctrl.shutdown()


def test_ingest_shutdown_rejects_submits():
    store = InMemoryModelStore()
    pipe = IngestPipeline(store, workers=1)
    pipe.submit("L0", _model(0))
    pipe.shutdown()
    assert "L0" in store.learner_ids()  # shutdown drained first
    with pytest.raises(RuntimeError):
        pipe.submit("L1", _model(1))


def test_ingest_rejects_zero_workers():
    with pytest.raises(ValueError):
        IngestPipeline(InMemoryModelStore(), workers=0)


# --------------------------------------------------------------------- #
# store thread-safety contract (store/base.py)
# --------------------------------------------------------------------- #

def _make_backend(kind: str, root) -> ModelStore:
    if kind == "disk":
        return DiskModelStore(str(root), EvictionPolicy.LINEAGE_LENGTH,
                              lineage_length=1)
    if kind == "cached":
        return CachedDiskStore(str(root), EvictionPolicy.LINEAGE_LENGTH,
                               lineage_length=1, cache_bytes=16 * 1024)
    return InMemoryModelStore()


@pytest.mark.parametrize("kind", ["disk", "cached", "memory"])
def test_concurrent_insert_select_erase_hammer(tmp_path, kind):
    """The contract regression test: 8 threads hammer insert/select/erase
    over a shared learner set. No exception may escape, and every value a
    select returns must be internally consistent (both halves carry the
    same tag — a mismatch means a torn lineage was observed)."""
    store = _make_backend(kind, tmp_path / kind)
    ids = [f"L{i}" for i in range(12)]
    stop = time.monotonic() + 2.0
    failures = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        while time.monotonic() < stop:
            lid = ids[int(rng.integers(len(ids)))]
            op = int(rng.integers(10))
            try:
                if op < 5:
                    store.insert(lid, _model(int(rng.integers(1000))))
                elif op < 9:
                    picked = store.select(
                        list(rng.choice(ids, size=3, replace=False)), k=1)
                    for lineage in picked.values():
                        _tag_of(lineage[0])
                else:
                    store.erase([lid])
            except Exception as exc:  # noqa: BLE001 - the assertion
                failures.append(repr(exc))
                return

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, failures
    # post-hammer: the store still works, lineage-length eviction held
    store.insert("L0", _model(42))
    picked = store.select(["L0"], k=4)
    assert _tag_of(picked["L0"][0]) == 42
    assert store.size("L0") == 1
    store.shutdown()


def test_erase_prunes_learner_lock_table(tmp_path):
    """Long-churn federations must not accumulate one lock per learner
    that ever existed (the contract's lock-table hygiene clause)."""
    store = DiskModelStore(str(tmp_path / "s"),
                           EvictionPolicy.LINEAGE_LENGTH, lineage_length=1)
    for i in range(5):
        store.insert(f"L{i}", _model(i))
    assert len(store._learner_locks) == 5
    store.erase([f"L{i}" for i in range(5)])
    assert not store._learner_locks
    assert not store.learner_ids()
    store.shutdown()


def test_disk_flush_batches_directory_fsyncs(tmp_path):
    """Inserts mark their directory dirty instead of fsyncing inline;
    flush() drains the dirty set in one pass (and tolerates a directory
    erased between the write and the flush)."""
    store = DiskModelStore(str(tmp_path / "s"),
                           EvictionPolicy.LINEAGE_LENGTH, lineage_length=1)
    store.insert("L0", _model(0))
    store.insert("L1", _model(1))
    assert len(store._dirty_dirs) == 2
    store.erase(["L1"])  # flush must survive the vanished directory
    store.flush()
    assert not store._dirty_dirs
    store.flush()  # idempotent on a clean store
    assert InMemoryModelStore().flush() is None  # base no-op contract
    store.shutdown()


def test_disk_insert_seq_cache_survives_concurrency(tmp_path):
    """The per-learner sequence cache (no listdir per insert) stays
    monotonic under concurrent same-learner inserts and reseeds from the
    directory after an erase."""
    store = DiskModelStore(str(tmp_path / "s"),
                           EvictionPolicy.LINEAGE_LENGTH, lineage_length=4)
    threads = [threading.Thread(
        target=lambda k=i: [store.insert("L0", _model(k * 10 + j))
                            for j in range(5)]) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert store.size("L0") == 4  # eviction to lineage_length held
    store.erase(["L0"])
    store.insert("L0", _model(99))
    assert _tag_of(store.select(["L0"], k=1)["L0"][0]) == 99
    store.shutdown()


@pytest.mark.slow
def test_ingest_soak_throughput_and_consistency(tmp_path):
    """Soak-scale: 512 learners x 2 generations through a 8-worker
    pipeline with interleaved selects; every final lineage holds the
    second-generation tag (per-learner linearization: generation 2 was
    submitted after generation 1 for each learner)."""
    store = CachedDiskStore(str(tmp_path / "s"),
                            EvictionPolicy.LINEAGE_LENGTH, lineage_length=1,
                            cache_bytes=1 << 20)
    pipe = IngestPipeline(store, workers=8)
    ids = [f"L{i}" for i in range(512)]
    for gen in range(2):
        for i, lid in enumerate(ids):
            pipe.submit(lid, _model(gen * 1000 + i, n=256))
        if gen == 0:
            store.select(ids[:64], k=1)  # selects race the writers
    assert pipe.drain(timeout=120.0)
    picked = store.select(ids, k=1)
    assert sorted(picked) == sorted(ids)
    for i, lid in enumerate(ids):
        assert _tag_of(picked[lid][0]) == 1000 + i
    pipe.shutdown()
    store.shutdown()
