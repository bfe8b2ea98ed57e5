"""Mask settlement: reconcile contributors against the dispatched cohort.

The root of the masked partial-fold plane (secure/distributed.py) ends a
round holding per-tensor uint64 sums and the list of learners that
actually contributed. Masks cancel only across the full mask graph — a
party that was dispatched but dropped (quorum release, deadline expiry,
crash) leaves its un-cancelled pairwise residual in the sum. Settlement
is the step that makes the sum decodable anyway:

1. **Reconcile** — map contributor learner ids to mask party indices and
   diff against the registered party set: ``surviving`` vs ``dropped``.
2. **Disclose** — ask ONE surviving learner for the dropped parties'
   residual (``recover_masks`` → ``MaskingBackend.recovery_correction``):
   seed-share disclosure collapsed to a single RPC in this trust model,
   because every learner derives pair streams from the federation
   secret. The learner side enforces the privacy thresholds (Bonawitz
   ``t``, the round allowlist, one recovery split per round, and the
   neighbor-isolation guard for bounded mask graphs) — the controller is
   the party those checks defend against, so they cannot live here.
3. **Unmask** — subtract the residual mod 2^64 and decode fixed point to
   the plain float64 community payload, scaled uniformly by
   1/len(contributors) (the ``participants`` scaler, the only one the
   masking scheme admits).

A settlement that cannot complete (below the survivor threshold, every
survivor refused or unreachable) raises — the controller's aggregation-
failure retry re-runs the round clean rather than publishing a sum with
live masks in it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.secure.distributed import unmask

# recover_fn(round_id, surviving, dropped, lengths) -> per-tensor residual
# bytes, or None when no transport can recover (full-cohort semantics
# apply: the caller's combine will fail loudly instead of mis-decoding).
RecoverFn = Callable[[int, Sequence[int], Sequence[int], Sequence[int]],
                     Optional[Sequence[bytes]]]


@dataclass
class SettlementReport:
    """What the settlement did, for telemetry + round metadata."""

    round_id: int
    contributors: List[str] = field(default_factory=list)
    surviving: List[int] = field(default_factory=list)
    dropped: List[int] = field(default_factory=list)
    recovered: bool = False
    duration_ms: float = 0.0


def reconcile(present_parties: Mapping[str, int],
              num_parties: int) -> Tuple[List[int], List[int]]:
    """Split the registered party index space into (surviving, dropped)
    given the learners that actually contributed this round."""
    surviving = sorted(set(int(p) for p in present_parties.values()))
    dropped = sorted(set(range(int(num_parties))) - set(surviving))
    return surviving, dropped


def settle(sums: Mapping[str, np.ndarray],
           present_parties: Mapping[str, int],
           num_parties: int,
           min_parties: int,
           round_id: int,
           recover_fn: RecoverFn) -> Tuple[Dict[str, bytes], SettlementReport]:
    """Settle one round's masked sums into plain float64 payloads.

    ``present_parties`` maps contributor learner id -> mask party index.
    Returns ``(payloads, report)``; raises when the cohort cannot be
    settled (unknown party indices, below-threshold survivors, recovery
    refused everywhere) so the caller's round retry takes over."""
    t0 = time.perf_counter()
    report = SettlementReport(round_id=int(round_id),
                              contributors=sorted(present_parties))
    if not present_parties:
        raise RuntimeError("mask settlement with no contributors")
    if any(int(p) < 0 for p in present_parties.values()):
        raise RuntimeError(
            "mask settlement needs a party index for every contributor "
            f"(got {dict(present_parties)}); learners join with "
            "capabilities['party_index'] under scheme=masking")
    n = int(num_parties)
    surviving, dropped = reconcile(present_parties, n)
    if len(surviving) != len(present_parties):
        raise RuntimeError(
            f"contributors {sorted(present_parties)} map to "
            f"{len(surviving)} distinct parties — duplicate party "
            "indices cannot settle (masks would double)")
    report.surviving, report.dropped = surviving, dropped
    correction: Optional[Dict[str, bytes]] = None
    if dropped:
        threshold = max(2, int(min_parties))
        if len(surviving) < threshold:
            raise RuntimeError(
                f"mask settlement needs >= {threshold} surviving parties "
                f"to recover {len(dropped)} dropouts, have "
                f"{len(surviving)}")
        # wire order: the masks were keyed on each tensor's position in
        # the uplink, and the accumulator keeps the first uplink's order
        names = list(sums)
        lengths = [int(np.asarray(sums[name]).size) for name in names]
        residuals = recover_fn(int(round_id), surviving, dropped, lengths)
        if residuals is None:
            raise RuntimeError(
                f"mask settlement could not recover dropped parties "
                f"{dropped}: no survivor disclosed the residual")
        correction = dict(zip(names, residuals))
        report.recovered = True
    # the participants scaler: the ONLY scaling masking admits (uniform),
    # applied exactly once, after the masks cancelled
    payloads = unmask(sums, correction, 1.0 / len(present_parties))
    report.duration_ms = (time.perf_counter() - t0) * 1e3
    return payloads, report
