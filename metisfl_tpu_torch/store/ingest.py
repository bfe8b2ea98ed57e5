"""Parallel store-ingest pipeline: payload persistence off the uplink
path (the port's copy of the JAX package's ``store/ingest.py``).

The controller's completion handler ENQUEUES an uplink and returns; a
bounded writer pool drains the queue into the store, and aggregation
fences on :meth:`drain` before any ``select`` so it never reads a torn
lineage.

Semantics:

- **Bounded**: at most ``max_pending`` models wait (default
  ``max(8 x workers, 16)``); past that, ``submit`` blocks the caller, so
  uplink handlers throttle instead of buffering a whole cohort in RAM.
- **Fenced**: ``drain()`` blocks until every queued write has landed
  (optionally for one learner only: the controller drains a departing
  learner's writes before ``erase``, so a write in flight cannot
  resurrect an erased lineage), then calls the store's ``flush()``, the
  batched-directory-fsync durability point.
- **Attributed**: the worker measures the ACTUAL write and reports it
  through ``on_insert(learner_id, ms)``; the enqueueing thread records
  nothing.
- **Fail-soft**: a write that raises is logged and counted
  (``errors()``); the learner's contribution is simply absent from the
  next select.
- **Gated**: ``accept(learner_id)`` is re-checked by the worker right
  before the write, so a queued write whose learner left in between is
  dropped.

Each landed write records a ``round.store_insert`` span parented on the
uplink that queued it (the span context travels with the queue entry).
The JAX package's lock profiling around the queue is not ported (ROADMAP.md
Queue 1 item 4b).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from metisfl_tpu_torch.telemetry import trace as _trace

from metisfl_tpu_torch.store.base import ModelStore

logger = logging.getLogger("metisfl_tpu_torch.store.ingest")


class IngestPipeline:
    """Bounded writer pool draining (learner_id, model) into a store."""

    def __init__(self, store: ModelStore, workers: int,
                 max_pending: int = 0,
                 on_insert: Optional[Callable[[str, float], None]] = None,
                 accept: Optional[Callable[[str], bool]] = None):
        if workers < 1:
            raise ValueError("ingest pipeline needs >= 1 worker")
        self._store = store
        self._on_insert = on_insert
        self._accept = accept
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="store-ingest")
        self.workers = workers
        self.max_pending = int(max_pending) or max(8 * workers, 16)
        self._cond = threading.Condition(threading.Lock())
        # learner_id -> queued-or-writing count (under _cond)
        self._pending: Dict[str, int] = {}
        self._pending_total = 0
        self._error_count = 0
        self._last_errors: List[str] = []
        self._closed = False

    # -- enqueue (RPC / completion-handler threads) ------------------------
    def submit(self, learner_id: str, model: Any,
               on_success: Optional[Callable[[float], None]] = None) -> None:
        """Queue one write; blocks only while the bounded queue is full.

        ``on_success(ms)`` runs in the worker after the write LANDS and
        strictly before any ``drain()`` fence covering it can return: the
        controller applies the result's metadata there, so a failed
        (fail-soft) write never pairs fresh metadata with the learner's
        older stored model."""
        # the uplink's span context, captured on the enqueueing thread:
        # the worker's contextvars are empty
        trace_ctx = _trace.current_context()
        with self._cond:
            if self._closed:
                raise RuntimeError("ingest pipeline is shut down")
            while self._pending_total >= self.max_pending:
                self._cond.wait()
                if self._closed:
                    raise RuntimeError("ingest pipeline is shut down")
            self._pending[learner_id] = self._pending.get(learner_id, 0) + 1
            self._pending_total += 1
        try:
            self._pool.submit(self._write, learner_id, model, on_success,
                              trace_ctx)
        except BaseException:
            # a shutdown racing this submit: roll the counters back so
            # drain() fences don't wait on a write that will never run
            self._settle(learner_id)
            raise

    def _settle(self, learner_id: str) -> None:
        with self._cond:
            count = self._pending.get(learner_id, 1) - 1
            if count <= 0:
                self._pending.pop(learner_id, None)
            else:
                self._pending[learner_id] = count
            self._pending_total -= 1
            self._cond.notify_all()

    # -- worker ------------------------------------------------------------
    def _write(self, learner_id: str, model: Any,
               on_success: Optional[Callable[[float], None]],
               trace_ctx=None) -> None:
        t0 = time.perf_counter()
        ok = True
        try:
            if self._accept is not None and not self._accept(learner_id):
                # erased between enqueue and execution: the leave() path's
                # last line of defense against a resurrected lineage
                logger.info("ingest write for departed %s dropped",
                            learner_id)
                ok = False
            else:
                self._store.insert(learner_id, model)
        except Exception as exc:  # noqa: BLE001 - fail-soft, see docstring
            ok = False
            logger.exception("ingest write for %s failed", learner_id)
            with self._cond:
                self._error_count += 1
                self._last_errors.append(f"{learner_id}: {exc!r}")
                del self._last_errors[:-8]
        ms = (time.perf_counter() - t0) * 1e3
        if ok and trace_ctx is not None:
            # the write's span, parented on the uplink that queued it
            _trace.event("round.store_insert", ms / 1e3, parent=trace_ctx,
                         attrs={"learner": learner_id, "ingest": True})
        if ok:
            # success callbacks run BEFORE the pending decrement so a
            # drain() fence returning implies their effects are visible
            if self._on_insert is not None:
                try:
                    self._on_insert(learner_id, ms)
                except Exception:  # noqa: BLE001 - best-effort hook
                    logger.exception("ingest attribution callback failed")
            if on_success is not None:
                try:
                    on_success(ms)
                except Exception:  # noqa: BLE001 - best-effort hook
                    logger.exception("ingest success callback failed")
        self._settle(learner_id)

    # -- fences ------------------------------------------------------------
    def drain(self, learner_id: Optional[str] = None,
              timeout: Optional[float] = None) -> bool:
        """Block until queued writes land (all, or one learner's), then
        flush the store (batched directory fsyncs). Returns False on
        timeout; the caller decides whether a torn fence is fatal."""
        if learner_id is None:
            def pred():
                return self._pending_total == 0
        else:
            def pred():
                return learner_id not in self._pending
        with self._cond:
            done = self._cond.wait_for(pred, timeout)
        if done:
            self._store.flush()
        return done

    def queue_depth(self) -> int:
        with self._cond:
            return self._pending_total

    def errors(self) -> Tuple[int, List[str]]:
        with self._cond:
            return self._error_count, list(self._last_errors)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain (bounded) and stop the workers; further submits raise."""
        self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._pool.shutdown(wait=True)
