"""The distributed slice tier, the controller side (the port's copy of
the JAX package's ``aggregation/distributed.py``).

``aggregation.tree.distributed: true`` turns the in-process tree's
branches into slice aggregator processes (``aggregation/slice.py``, booted
by ``DriverSession``): each owns a contiguous slice of the dispatched cohort,
accepted uplinks go to their owner over gRPC (the root never holds the
slice's models), and at barrier release the controller fans in O(branch)
``FoldPartial`` replies, folded with :class:`TreeReducer`'s kernel,
blocking and accumulator dtypes.

- **Supervision**: every slice RPC failure counts; at ``STALE_FAILURES``
  consecutive failures a ``grpc.health.v1`` probe decides whether the
  aggregator is dead.
- **Mid-round re-homing**: a dead aggregator's spooled uplinks (acked
  means durable, ``aggregation/slice.py``) are re-read from its spool
  directory and re-submitted to a surviving aggregator, or decoded into
  the root's residual buffer when none survives, and its learners point
  there for the rest of the run. Submits retry with doubling backoff
  before they give up on an endpoint; an accepted uplink is never
  dropped (the root's residual buffer is the last resort).
- **Degradation**: with every aggregator dead the tier folds everything
  at the root with the same kernel.

Determinism: each slice folds its ids in SORTED order, so the fold order,
and with it the community's bits, is a pure function of the contributor
set whatever the uplinks' arrival order; group boundaries follow the
round's assignment, never liveness, so a re-homed group folds as it
would have where it was.

The slices ship their learners' uplink accounting as mergeable sketches
(``telemetry/sketch.py``) in every fold reply; :meth:`describe` merges
O(branch) of them.

Not ported yet: the tier's failure and re-homing metrics, its events and
spans (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.aggregation.base import np_finalize
from metisfl_tpu_torch.aggregation.slice import (
    SLICE_SERVICE,
    SliceClient,
    read_spool_records,
)
from metisfl_tpu_torch.aggregation.tree import (
    _DEFAULT_SUBBLOCK,
    SlicePartial,
    TreeReducer,
)
from metisfl_tpu_torch.secure.distributed import MaskedAccumulator
from metisfl_tpu_torch.telemetry.sketch import QuantileDigest, SpaceSaving
from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy, tree_map

logger = logging.getLogger("metisfl_tpu_torch.aggregation.distributed")

# consecutive RPC failures before a grpc.health.v1 probe decides the
# aggregator is dead
STALE_FAILURES = 2

ROOT = -1  # owner index for "folded at the root"


class _SliceState:
    __slots__ = ("index", "name", "host", "port", "spool_dir", "client",
                 "failures", "dead", "redirect", "last_stats", "last_probe")

    def __init__(self, index: int, spec: Dict[str, Any]):
        self.index = index
        self.name = str(spec.get("name") or f"slice_{index}")
        self.host = str(spec.get("host") or "localhost")
        self.port = int(spec.get("port") or 0)
        self.spool_dir = str(spec.get("spool_dir") or "")
        self.client: Optional[SliceClient] = None
        self.failures = 0          # consecutive; reset on any success
        self.dead = False
        self.redirect: Optional[int] = None   # index or ROOT after re-home
        self.last_stats: Optional[Dict[str, Any]] = None
        self.last_probe = 0.0      # revival-probe rate limit (assign)


class DistributedSliceReducer:
    """See module docstring. Built by the controller iff
    ``aggregation.tree.distributed`` with endpoints configured; every
    public method is safe to call from the scheduling executor, and
    :meth:`describe` additionally from RPC threads."""

    def __init__(self, tree_cfg, ssl=None, comm=None, masked: bool = False,
                 stream: bool = False):
        self._ssl, self._comm = ssl, comm
        # masked partial-fold plane (secure/distributed.py): uplinks are
        # opaque uint64 blobs forwarded VERBATIM (re-encoding a masked
        # payload is meaningless and decode is impossible here), slices
        # fold them as modular sums via FoldPartial{masked}, and reduce
        # happens through :meth:`reduce_masked`. ``stream`` additionally
        # turns on slice-side fold-on-arrival (masking × streaming ×
        # distributed — safe because masked payloads are round-idempotent
        # byte-identical, so the slice's duplicate-contributor skip holds)
        self.masked = bool(masked)
        self.stream = bool(stream) and self.masked
        self.rehome_retries = int(getattr(tree_cfg, "rehome_retries", 3))
        self.rehome_backoff_s = float(
            getattr(tree_cfg, "rehome_backoff_s", 0.2))
        self._slices = [
            _SliceState(i, spec)
            for i, spec in enumerate(getattr(tree_cfg, "slices", []) or [])]
        if not self._slices:
            raise ValueError(
                "aggregation.tree.distributed requires configured slice "
                "endpoints (DriverSession fills aggregation.tree.slices)")
        # uplink forwarding and re-home bookkeeping serialize here
        self._lock = threading.Lock()
        # learner_id -> owner index (ROOT = fold at the root)
        self._owner: Dict[str, int] = {}
        # root residual buffer: {learner_id: (round, model tree)} — the
        # fold-of-last-resort for re-homed/undeliverable uplinks
        self._residual: Dict[str, Tuple[int, Dict[str, Any]]] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        # serializes re-homes AND lets a submit that lost its retry race
        # wait for an in-flight re-home before parking at the root (the
        # redirect usually lands while the spool recovery runs)
        self._rehome_lock = threading.Lock()
        self._shutdown = False
        self.rehomed_total = 0

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #

    def _client(self, st: _SliceState) -> SliceClient:
        # under the lock: concurrent first uses (submit on RPC threads,
        # fold on the pool) must not each open a channel and leak the
        # loser — shutdown() only closes the stored client
        with self._lock:
            if st.client is None:
                st.client = SliceClient(st.host, st.port, ssl=self._ssl,
                                        comm=self._comm)
            return st.client

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(2, len(self._slices)),
                thread_name_prefix="slice-reduce")
        return self._pool

    def _probe(self, st: _SliceState) -> str:
        from metisfl_tpu_torch.comm.health import probe_health
        return probe_health(st.host, st.port, SLICE_SERVICE, ssl=self._ssl,
                            timeout=2.0)

    def _alive_indices(self) -> List[int]:
        with self._lock:
            return [st.index for st in self._slices
                    if not st.dead and st.redirect is None]

    # ------------------------------------------------------------------ #
    # slice assignment (fresh round dispatch)
    # ------------------------------------------------------------------ #

    def assign(self, cohort: Sequence[str]) -> None:
        """Partition the dispatched cohort into contiguous slices over
        ALL configured aggregators (sorted ids, ceil division — the
        in-process tier's slicing over its configured branch). The
        partition deliberately ignores liveness: group boundaries are a
        pure function of (cohort, branch), so a death changes only WHO
        executes a group (the re-home redirect), never the fold blocking
        — which is what keeps the community bits identical to the
        undisturbed run. Dead aggregators whose
        process DriverSession has since relaunched are revived here (one
        health probe each, only while any is dead), so a supervised
        relaunch rejoins the tier at the next round."""
        now = time.monotonic()
        with self._lock:
            # revival probes are rate-limited (one per slice per window)
            # and run in parallel on the reducer pool: a blackholed host
            # times out at the probe deadline, and N of them must cost
            # the dispatch path one probe window, not N serial ones
            dead = [st for st in self._slices
                    if st.dead and now - st.last_probe > 5.0]
            for st in dead:
                st.last_probe = now
        if dead:
            probes = {st: self._executor().submit(self._probe, st)
                      for st in dead}
            for st, fut in probes.items():
                try:
                    revived = fut.result() == "SERVING"
                except Exception:  # noqa: BLE001 - a probe never raises,
                    revived = False  # but the pool submit could
                if revived:
                    with self._lock:
                        st.dead = False
                        st.redirect = None
                        st.failures = 0
                    logger.info("slice aggregator %s answered its health "
                                "probe again; rejoining the tier", st.name)
        ids = sorted(set(cohort))
        with self._lock:
            branch = len(self._slices)
            per = max(1, -(-len(ids) // branch))  # ceil division
            owner: Dict[str, int] = {}
            for n, i in enumerate(range(0, len(ids), per)):
                for lid in ids[i:i + per]:
                    owner[lid] = min(n, branch - 1)
            self._owner = owner

    def _resolve_executor(self, idx: int) -> int:
        """Follow re-home redirects from a base owner index to whoever
        executes for it now (ROOT when the chain dead-ends)."""
        with self._lock:
            seen = set()
            while idx != ROOT:
                st = self._slices[idx]
                if st.redirect is None:
                    break
                if idx in seen:  # defensive: no redirect cycles
                    return ROOT
                seen.add(idx)
                idx = st.redirect
            return idx

    def _base_owner(self, learner_id: str) -> int:
        """The round assignment's owner index, WITHOUT redirect
        resolution — partial grouping keys on this so re-homing changes
        which process folds a group, never the group boundaries (the
        fold blocking, and therefore the community bits, stay a pure
        function of the assignment + contributor set)."""
        with self._lock:
            return self._owner.get(learner_id, ROOT)

    def _owner_of(self, learner_id: str) -> int:
        """The learner's current executor (base owner through any
        re-home redirects). Unknown learners go to the root."""
        return self._resolve_executor(self._base_owner(learner_id))

    # ------------------------------------------------------------------ #
    # uplink path (scheduling executor)
    # ------------------------------------------------------------------ #

    def submit(self, learner_id: str, model: Dict[str, Any],
               round_id: int) -> bool:
        """Forward one accepted uplink to its slice owner, with bounded
        retry/backoff and re-homing on a confirmed-dead owner. Returns
        True when a slice holds it, False when it fell back to the
        root's residual buffer — either way the uplink is kept."""
        blob: Optional[bytes] = None
        if self.masked:
            # masked mode: ``model`` IS the learner's raw uplink bytes —
            # forwarded verbatim (one-time-pad discipline: the slice must
            # hold exactly the bytes the learner shipped)
            blob = model
        attempt = 0
        last_idx = ROOT
        while not self._shutdown:
            idx = self._owner_of(learner_id)
            if idx == ROOT:
                break
            if blob is None:
                # lazily: a root-owned uplink (degraded mode, pre-assign
                # arrivals) parks the raw tree and never needs the encode
                blob = ModelBlob(
                    tensors=[(name, np.asarray(arr))
                             for name, arr in sorted(model.items())]
                ).to_bytes()
            st = self._slices[idx]
            last_idx = idx
            try:
                self._client(st).submit(learner_id, round_id, blob,
                                        stream=self.stream)
                with self._lock:
                    st.failures = 0
                return True
            except Exception as exc:  # noqa: BLE001 - the retry ladder
                self._note_failure(st, exc, round_id)
                if attempt >= self.rehome_retries:
                    break
                time.sleep(self.rehome_backoff_s * (2 ** attempt))
                attempt += 1
        if not self._shutdown and last_idx != ROOT:
            # a submit that burned its ladder against a dying slice may
            # have raced that slice's re-home (spool recovery takes a
            # while at scale): wait for any in-flight re-home to land,
            # then try the redirect target once before parking at the
            # root — parking moves this learner's group boundary, which
            # costs the round its control-run bit-identity
            with self._rehome_lock:
                pass
            idx = self._owner_of(learner_id)
            if idx not in (ROOT, last_idx):
                try:
                    self._client(self._slices[idx]).submit(
                        learner_id, round_id, blob, stream=self.stream)
                    with self._lock:
                        self._slices[idx].failures = 0
                    return True
                except Exception:  # noqa: BLE001 - park below
                    pass
        # fold-of-last-resort: the uplink was accepted upstream and must
        # survive whatever the slice fleet is doing. Re-pointing the
        # owner to ROOT is what keeps it IN the round's fold (the fold
        # path only consults the residual buffer for root-owned ids).
        parked: Any = model
        if self.masked:
            try:
                parked = dict(ModelBlob.from_bytes(model).opaque)
            except ValueError:
                logger.warning("masked uplink from %s undecodable; "
                               "dropping from the root residual",
                               learner_id)
                return False
        with self._lock:
            self._residual[learner_id] = (int(round_id), parked)
            self._owner[learner_id] = ROOT
        return False

    def _note_failure(self, st: _SliceState, exc: Exception,
                      round_id: int) -> None:
        with self._lock:
            if st.dead or st.redirect is not None:
                return
            st.failures += 1
            failures = st.failures
        logger.warning("slice aggregator %s RPC failed (%d consecutive): "
                       "%s", st.name, failures, exc)
        if failures < STALE_FAILURES:
            return
        # consecutive-failure staleness confirmed by the standard health
        # probe (a congested-but-alive aggregator must not be re-homed)
        if self._probe(st) == "SERVING":
            with self._lock:
                st.failures = 0
            return
        self._rehome(st, round_id, reason=f"{type(exc).__name__}: {exc}")

    # ------------------------------------------------------------------ #
    # re-homing
    # ------------------------------------------------------------------ #

    def _rehome(self, st: _SliceState, round_id: int,
                reason: str = "") -> None:
        """The slice aggregator is dead: recover its spooled uplinks and
        re-point its learners at a survivor (or the root). Idempotent —
        concurrent failure paths collapse onto the first re-home — and
        serialized on ``_rehome_lock`` so a racing submit can wait for
        the redirect instead of parking its uplink at the root."""
        t0 = time.perf_counter()
        with self._lock:
            if st.dead or st.redirect is not None:
                return
            st.dead = True
        with self._rehome_lock:
            self._rehome_locked(st, round_id, reason, t0)

    def _rehome_locked(self, st: _SliceState, round_id: int,
                       reason: str, t0: float) -> None:
        logger.warning("slice aggregator %s lost after %d failures",
                       st.name, st.failures)
        alive = [i for i in self._alive_indices() if i != st.index]
        target = alive[0] if alive else ROOT
        target_name = self._slices[target].name if target != ROOT else "root"
        spooled = read_spool_records(st.spool_dir) if st.spool_dir else {}
        recovered, lost = 0, 0
        for lid, (rid, raw) in spooled.items():
            if target != ROOT:
                try:
                    # re-submit under the RECORDED round: masked folds are
                    # round-matched (mask streams are round-keyed), and
                    # the plain path's latest-wins hold is unaffected
                    self._client(self._slices[target]).submit(
                        lid, rid, raw, stream=self.stream)
                    recovered += 1
                    continue
                except Exception:  # noqa: BLE001 - survivor died too
                    logger.warning("re-home target %s refused %s; keeping "
                                   "it at the root", target_name, lid)
            try:
                decoded = ModelBlob.from_bytes(raw)
                tree = (dict(decoded.opaque) if decoded.opaque
                        else {n: to_numpy(t) for n, t in decoded.tensors})
            except ValueError:
                lost += 1
                continue
            with self._lock:
                self._residual[lid] = (int(rid), tree)
                # re-point THIS learner at the root: the fold path only
                # consults the residual buffer for root-owned ids, so
                # without the re-point a target-refused uplink would be
                # silently excluded from the round (its group executes
                # at a target that never received it)
                self._owner[lid] = ROOT
            recovered += 1
        with self._lock:
            st.redirect = target
        duration = time.perf_counter() - t0
        self.rehomed_total += 1
        logger.warning(
            "slice %s re-homed to %s in %.3fs: %d spooled uplink(s) "
            "recovered, %d lost (%s)", st.name, target_name, duration,
            recovered, lost, reason or "confirmed dead")

    # ------------------------------------------------------------------ #
    # fan-in (scheduling executor)
    # ------------------------------------------------------------------ #

    def _fold_root(self, ids: Sequence[str], scales: Dict[str, float],
                   subblock: int) -> SlicePartial:
        """Residual-buffer fold with the in-process tier's exact kernel —
        the degraded-to-root path shares the slice processes' math."""
        with self._lock:
            snapshot = {lid: self._residual[lid][1] for lid in ids
                        if lid in self._residual}
        return TreeReducer._fold_slice(
            list(ids), scales,
            lambda block: {lid: [snapshot[lid]] for lid in block
                           if lid in snapshot},
            subblock)

    def _fold_remote(self, st: _SliceState, group: List[str],
                     scales: Dict[str, float],
                     subblock: int) -> SlicePartial:
        reply = self._client(st).fold(
            group, {lid: scales[lid] for lid in group}, stride=subblock)
        with self._lock:
            st.failures = 0
            st.last_stats = reply.get("stats")
        acc = None
        if reply.get("acc"):
            acc = {n: to_numpy(t) for n, t in
                   ModelBlob.from_bytes(reply["acc"]).tensors}
        return SlicePartial(
            acc, float(reply.get("z", 0.0)), int(reply.get("count", 0)),
            tuple(reply.get("dtypes") or ()) or None,
            float(reply.get("duration_ms", 0.0)))

    def _fold_group(self, base_idx: int, group: List[str],
                    scales: Dict[str, float], subblock: int,
                    round_id: int) -> Tuple[SlicePartial, Optional[str]]:
        """One BASE group's partial, executed by whoever owns it now: the
        live aggregator's FoldPartial, its re-home target's after a
        mid-round death (the spool recovery hands the target the models),
        or the root's residual fold when the chain dead-ends. The group
        boundary never changes — only the executor — so the partial's
        blocking (and bits) match the undisturbed run."""
        error: Optional[str] = None
        attempts = 0
        budget = len(self._slices) + max(1, self.rehome_retries) + 1
        while attempts < budget:
            idx = self._resolve_executor(base_idx)
            if idx == ROOT:
                break
            st = self._slices[idx]
            try:
                return self._fold_remote(st, group, scales, subblock), error
            except Exception as exc:  # noqa: BLE001 - retry / re-home
                # _note_failure owns the death decision: it probes at the
                # staleness threshold and re-homes ONLY a probe-dead
                # aggregator — a congested-but-alive one keeps its models
                # and gets its bounded backoff retry here instead
                self._note_failure(st, exc, round_id)
                attempts += 1
                with self._lock:
                    alive = not st.dead and st.redirect is None
                if alive:
                    if attempts >= budget:
                        # probe keeps answering SERVING while FoldPartial
                        # keeps failing: fold at the root rather than
                        # stall the round (models the slice still holds
                        # are missing and reduce() reports the shortfall)
                        error = (f"slice {st.name} probe-alive but "
                                 "unresponsive to FoldPartial; its group "
                                 "folded at the root")
                        break
                    time.sleep(self.rehome_backoff_s
                               * (2 ** max(0, attempts - 1)))
                else:
                    error = (f"slice {st.name} died mid-round; its group "
                             "re-folded from the recovered spool")
                # loop: the executor re-resolves through any new redirect
        return self._fold_root(group, scales, subblock), error

    # ------------------------------------------------------------------ #
    # masked fan-in (secure/distributed.py partial-fold plane)
    # ------------------------------------------------------------------ #

    def _fold_masked_root(self, ids: Sequence[str], round_id: int
                          ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                     List[str]]:
        """Residual-buffer masked fold: round-matched opaque blobs only
        (a stale masked payload must never enter the sum — its masks
        would not cancel)."""
        acc = MaskedAccumulator()
        with self._lock:
            held = {lid: self._residual[lid] for lid in ids
                    if lid in self._residual}
        for lid in sorted(held):
            rid, tree = held[lid]
            if int(rid) != int(round_id):
                continue
            acc.fold(lid, tree)
        return acc.snapshot()

    def _fold_masked_remote(self, st: _SliceState, group: List[str],
                            round_id: int
                            ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                       List[str]]:
        reply = self._client(st).fold_masked(group, round_id,
                                             stream=self.stream)
        with self._lock:
            st.failures = 0
            st.last_stats = reply.get("stats")
        sums: Dict[str, Any] = {}
        specs: Dict[str, Any] = {}
        if reply.get("acc"):
            blob = ModelBlob.from_bytes(reply["acc"])
            for name, (payload, spec) in blob.opaque.items():
                sums[name] = np.frombuffer(payload, np.uint64).copy()
                specs[name] = spec
        return sums, specs, [str(lid) for lid in reply.get("present") or ()]

    def _fold_masked_group(self, base_idx: int, group: List[str],
                           round_id: int
                           ) -> Tuple[Tuple[Dict[str, Any], Dict[str, Any],
                                            List[str]], Optional[str]]:
        """The masked twin of :meth:`_fold_group`: same retry ladder,
        same probe-owned death decision, same root fallback — but the
        partial is per-tensor uint64 sums + the contributor list the
        root's mask settlement reconciles."""
        error: Optional[str] = None
        attempts = 0
        budget = len(self._slices) + max(1, self.rehome_retries) + 1
        while attempts < budget:
            idx = self._resolve_executor(base_idx)
            if idx == ROOT:
                break
            st = self._slices[idx]
            try:
                return self._fold_masked_remote(st, group, round_id), error
            except Exception as exc:  # noqa: BLE001 - retry / re-home
                self._note_failure(st, exc, round_id)
                attempts += 1
                with self._lock:
                    alive = not st.dead and st.redirect is None
                if alive:
                    if attempts >= budget:
                        error = (f"slice {st.name} probe-alive but "
                                 "unresponsive to FoldPartial; its group "
                                 "folded at the root")
                        break
                    time.sleep(self.rehome_backoff_s
                               * (2 ** max(0, attempts - 1)))
                else:
                    error = (f"slice {st.name} died mid-round; its group "
                             "re-folded from the recovered spool")
        return self._fold_masked_root(group, round_id), error

    def reduce_masked(self, ids: Sequence[str], round_id: int
                      ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any],
                                          List[str], List[str]]]:
        """Fan in the round's MASKED partials: one FoldPartial{masked}
        per base owner group (parallel), root residual folded locally,
        modular uint64 sums combined at the root. Returns ``(sums,
        specs, contributors, errors)`` — the contributor list is ground
        truth for the mask settlement — or None when nothing folded.
        Contributor sets across groups must be disjoint; an overlap
        means a payload entered two sums and the combined sum would
        double-count it, so the round fails loudly into the caller's
        aggregation retry instead of publishing a corrupt model."""
        ids = sorted(set(ids))
        if not ids:
            return None
        groups: Dict[int, List[str]] = {}
        for lid in ids:
            groups.setdefault(self._base_owner(lid), []).append(lid)
        order = sorted(groups, key=lambda i: (i == ROOT, i))

        def _fold(idx):
            if idx == ROOT:
                return self._fold_masked_root(groups[idx], round_id), None
            return self._fold_masked_group(idx, groups[idx], round_id)

        futures = {idx: self._executor().submit(_fold, idx)
                   for idx in order}
        root = MaskedAccumulator()
        errors: List[str] = []
        first_error: Optional[BaseException] = None
        for idx in order:
            try:
                (sums, specs, present), err = futures[idx].result()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = exc
                continue
            if err:
                errors.append(err)
            if not present:
                continue
            fresh = [lid for lid in present
                     if lid not in set(root.contributors)]
            if not fresh:
                # a fully-duplicate partial: after a re-home, two base
                # groups resolve to the same executor and (in stream
                # mode) each fold reply is that slice's WHOLE round
                # accumulator — every contributor already merged, so the
                # partial carries nothing new. Skip it.
                continue
            if len(fresh) != len(present):
                overlap = sorted(set(present) - set(fresh))
                raise RuntimeError(
                    f"masked partials overlap on {overlap}: a payload "
                    "was folded in two places and the modular sum would "
                    "double-count it")
            root.merge_sums(sums, present, specs)
        if first_error is not None:
            raise first_error
        if root.count == 0:
            return None
        sums, specs, present = root.snapshot()
        if len([lid for lid in ids if lid in present]) < len(ids):
            missing = len(ids) - len([l for l in ids if l in present])
            errors.append(f"{missing} of {len(ids)} selected learners "
                          "had no held masked payload in any slice")
        return sums, specs, present, errors

    def reduce(self, ids: Sequence[str], scales: Dict[str, float],
               stride: int = 0, round_id: int = 0
               ) -> Optional[Tuple[Dict[str, Any], List[SlicePartial],
                                   List[str]]]:
        """Fan in the round's partials: one FoldPartial per BASE owner
        group (parallel), root residual folded locally, partials
        combined in base-slice order. Returns ``(community, partials,
        errors)`` or None when no learner had a held model anywhere."""
        ids = sorted(set(ids))
        if not ids:
            return None
        subblock = int(stride) or _DEFAULT_SUBBLOCK
        groups: Dict[int, List[str]] = {}
        for lid in ids:
            groups.setdefault(self._base_owner(lid), []).append(lid)
        order = sorted(groups, key=lambda i: (i == ROOT, i))

        def _fold(idx):
            return self._fold_group(idx, groups[idx], scales, subblock,
                                    round_id)

        futures = {idx: self._executor().submit(_fold, idx)
                   for idx in order}
        partials: List[SlicePartial] = []
        errors: List[str] = []
        # settle EVERY future before raising (the TreeReducer.reduce
        # posture): an abandoned in-flight fold would race the caller's
        # aggregation-failure retry through this same reused pool
        first_error: Optional[BaseException] = None
        for idx in order:
            try:
                partial, err = futures[idx].result()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = exc
                continue
            partials.append(partial)
            if err:
                errors.append(err)
        if first_error is not None:
            raise first_error
        live = [p for p in partials if p.acc is not None]
        if not live:
            return None
        acc, z = live[0].acc, live[0].z
        for p in live[1:]:
            acc = tree_map(lambda a, b: a + b, acc, p.acc)
            z += p.z
        community = np_finalize(acc, z, dtypes=live[0].dtypes)
        folded = sum(p.count for p in live)
        if folded < len(ids):
            errors.append(f"{len(ids) - folded} of {len(ids)} selected "
                          "learners had no held model in any slice")
        return community, partials, errors

    def round_complete(self) -> None:
        """Round closed: drop the root residual buffer (its uplinks were
        folded or superseded; the slices keep their latest-per-learner
        models exactly like the store keeps lineage)."""
        with self._lock:
            self._residual.clear()

    # ------------------------------------------------------------------ #
    # membership / status / lifecycle
    # ------------------------------------------------------------------ #

    def forget(self, learner_id: str) -> None:
        """Learner left: prune its model + spool record from EVERY live
        aggregator (best-effort) and from the residual buffer. The
        broadcast — O(branch) tiny RPCs on the rare leave path — is
        deliberate: the current round's assignment only covers this
        round's dispatched cohort, so a learner that last reported in an
        EARLIER round is held by a slice the owner map no longer names,
        and routing by owner alone would leak its model and spool file
        for the process lifetime (then reload them on a relaunch)."""
        with self._lock:
            self._residual.pop(learner_id, None)
            self._owner.pop(learner_id, None)
            live = [st for st in self._slices
                    if not st.dead and st.redirect is None]
        for st in live:
            try:
                self._client(st).forget([learner_id])
            except Exception:  # noqa: BLE001 - pruning is best-effort
                logger.info("could not prune %s from slice %s",
                            learner_id, st.name)

    def describe(self) -> Dict[str, Any]:
        """Status-plane snapshot: per-slice liveness/re-home state plus
        the fleet-wide uplink-byte rollup merged from the slices' O(1)
        sketches (never an O(fleet) scan at the root)."""
        merged = QuantileDigest()
        top = SpaceSaving(capacity=32)
        uplinks = 0
        rows = []
        with self._lock:
            states = list(self._slices)
            residual = len(self._residual)
        for st in states:
            stats = st.last_stats or {}
            if stats.get("bytes_digest"):
                try:
                    merged.merge(
                        QuantileDigest.from_dict(stats["bytes_digest"]))
                    top.merge(SpaceSaving.from_dict(stats["top_bytes"]))
                except (KeyError, TypeError, ValueError):
                    pass
            uplinks += int(stats.get("uplinks", 0) or 0)
            rows.append({
                "name": st.name,
                "target": f"{st.host}:{st.port}",
                "dead": st.dead,
                "rehomed_to": (
                    "" if st.redirect is None else
                    ("root" if st.redirect == ROOT
                     else self._slices[st.redirect].name)),
                "failures": st.failures,
                "held": int(stats.get("held", 0) or 0),
            })
        out: Dict[str, Any] = {
            "enabled": True,
            "slices": rows,
            "alive": sum(1 for r in rows if not r["dead"]),
            "rehomed_total": self.rehomed_total,
            "root_residual": residual,
            "uplinks_total": uplinks,
        }
        if merged.count > 0:
            out["uplink_bytes"] = {
                "p50": round(merged.quantile(0.5), 1),
                "p99": round(merged.quantile(0.99), 1),
                "top": [{"learner": k, "bytes": v}
                        for k, v, _, _ in top.top(5)],
            }
        return out

    def shutdown(self, stop_remote: bool = False) -> None:
        self._shutdown = True
        for st in self._slices:
            if st.client is not None:
                if stop_remote:
                    try:
                        st.client.shutdown_remote()
                    except Exception:  # noqa: BLE001 - already gone
                        pass
                st.client.close()
                st.client = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
