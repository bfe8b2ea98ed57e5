"""Write-ahead round-state log for the controller's hot standby.

The port's copy of the JAX package's ``controller/wal.py``. It replicates
the round state a warm standby (``python -m metisfl_tpu_torch.controller
--standby``) needs to take over mid-run, with the acked-means-durable
atomic rename of the slice aggregator's spool (store/durable.py):

- **Registry deltas** (``join`` / ``leave``) are appended on the RPC
  path BEFORE the join or leave ack returns: a learner the primary acked
  is a learner the promoted standby recognizes (same id, token, party
  index).
- **Snapshots** carry the whole checkpoint state
  (``Controller._checkpoint_state()``: the community blob, the round
  counter, the rules' and SCAFFOLD's state, the learner registry, the
  model registry's lineage) and are appended by the controller's
  coalesced save on its scheduling worker, which also writes the on-disk
  checkpoint: at the seed model, at membership changes and at a
  promotion or rollback. A snapshot makes every older record dead
  weight, so the log compacts itself on append.

Replay (:meth:`RoundStateLog.replay`) merges the latest snapshot with
every registry delta after it. The round in flight is not replicated
uplink by uplink: promotion re-dispatches it from the snapshot's
community model (``resume_round``), and since training and aggregation
are deterministic functions of (model, cohort), the re-run round gives
the bits of an undisturbed run, the argument behind ``--resume`` too.

File format: one record per file, ``<seq:010d>.<kind>.rec`` holding a
codec envelope ``{"seq", "kind", "data"}``, byte for byte the JAX
package's for the same records. One file per record keeps every append
atomic (rename), keeps a torn tail record from corrupting the log, and
lets the standby tail the directory with ``listdir`` alone.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from metisfl_tpu_torch.comm.codec import dumps as codec_dumps
from metisfl_tpu_torch.comm.codec import loads as codec_loads
from metisfl_tpu_torch.store import durable as _durable

logger = logging.getLogger("metisfl_tpu_torch.controller.wal")

SNAPSHOT = "snapshot"
# registry deltas, appended before the membership ack
JOIN = "join"
LEAVE = "leave"

_RECORD_SUFFIX = ".rec"


def _record_name(seq: int, kind: str) -> str:
    return f"{seq:010d}.{_durable.sanitize_id(kind)}{_RECORD_SUFFIX}"


def _parse_name(name: str) -> Optional[Tuple[int, str]]:
    if not name.endswith(_RECORD_SUFFIX):
        return None
    stem = name[: -len(_RECORD_SUFFIX)]
    seq_part, dot, kind = stem.partition(".")
    if not dot or not seq_part.isdigit():
        return None
    return int(seq_part), kind


class RoundStateLog:
    """A durable, self-compacting record log in one directory.

    The writer (the primary): :meth:`append` and :meth:`snapshot`, each
    durable (atomic rename) before it returns. The reader (the standby):
    :meth:`poll` for the tail's progress, :meth:`replay` for the state at
    promotion. The two share nothing but the directory: the standby never
    dials the primary for state."""

    def __init__(self, wal_dir: str):
        if not wal_dir:
            raise ValueError("RoundStateLog requires a wal_dir")
        self.wal_dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = self._scan_last_seq()

    # -- writer (primary) --------------------------------------------------

    def append(self, kind: str, data: Any) -> int:
        """Durably append one record; returns its sequence number. The
        record is on disk (atomic rename) before this returns: callers on
        the RPC path ack only after."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        payload = codec_dumps({"seq": seq, "kind": kind, "data": data})
        _durable.atomic_write(os.path.join(self.wal_dir,
                                           _record_name(seq, kind)),
                              payload, prefix=".wal_")
        return seq

    def snapshot(self, state: Dict[str, Any]) -> int:
        """Append a full-state snapshot, then prune every older record:
        the snapshot subsumes them, and an unbounded log would make
        promote-time replay (and disk) grow with the run."""
        seq = self.append(SNAPSHOT, state)
        self._compact(before=seq)
        return seq

    def _compact(self, before: int) -> None:
        for name in self._list_records():
            parsed = _parse_name(name)
            if parsed is not None and parsed[0] < before:
                try:
                    os.unlink(os.path.join(self.wal_dir, name))
                except OSError:  # a racing reader removed it first
                    pass

    # -- reader (standby) --------------------------------------------------

    def poll(self) -> int:
        """The highest sequence number on disk (0 = empty): the standby's
        cheap liveness signal (a stale tail escalates to health probes)."""
        return self._scan_last_seq()

    def replay(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """``(snapshot_state, deltas_after_it)``: the latest readable
        snapshot's state (None when none landed yet) and every join/leave
        delta with a higher sequence number, in order. Torn or unreadable
        records are skipped: promotion recovers what landed."""
        records: List[Dict[str, Any]] = []
        for name in self._list_records():
            if _parse_name(name) is None:
                continue
            record = _durable.read_tolerant(
                os.path.join(self.wal_dir, name), codec_loads)
            if isinstance(record, dict) and "seq" in record:
                records.append(record)
        records.sort(key=lambda r: int(r["seq"]))
        state: Optional[Dict[str, Any]] = None
        snap_seq = -1
        for record in records:
            if record.get("kind") == SNAPSHOT:
                state, snap_seq = record.get("data"), int(record["seq"])
        deltas = [r for r in records
                  if r.get("kind") != SNAPSHOT and int(r["seq"]) > snap_seq]
        return state, deltas

    @staticmethod
    def merge(state: Optional[Dict[str, Any]],
              deltas: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """Fold registry deltas into a snapshot's ``learners`` list: the
        state the standby restores from. A join delta carries the whole
        learner record (insert or replace by id); a leave delta removes
        it. With no snapshot yet, the deltas alone build a model-less
        state (the round restarts once a model is seeded, as a
        ``--resume`` from an empty checkpoint does)."""
        if state is None and not deltas:
            return None
        merged = dict(state or {"global_iteration": 0,
                                "community_blob": b"",
                                "round_metadata": [],
                                "community_evaluations": []})
        learners = {entry["learner_id"]: dict(entry)
                    for entry in merged.get("learners", [])}
        for delta in deltas:
            data = delta.get("data") or {}
            if delta.get("kind") == JOIN and data.get("learner_id"):
                learners[data["learner_id"]] = dict(data)
            elif delta.get("kind") == LEAVE:
                learners.pop(data.get("learner_id"), None)
        merged["learners"] = list(learners.values())
        return merged

    # -- internals ---------------------------------------------------------

    def _list_records(self) -> List[str]:
        try:
            return sorted(os.listdir(self.wal_dir))
        except OSError:
            return []

    def _scan_last_seq(self) -> int:
        last = 0
        for name in self._list_records():
            parsed = _parse_name(name)
            if parsed is not None:
                last = max(last, parsed[0])
        return last
