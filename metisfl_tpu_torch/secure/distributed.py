"""The masked partial-fold plane: secure aggregation at distributed scale
(the port's copy of the JAX package's ``secure/distributed.py``; the
derivations, the fixed point and the words on the wire are the same, so
masks made by either package cancel in the other's sums).

Pairwise additive masking (secure/masking.py) has one property the CKKS
path lacks: a masked payload is a fixed-point **uint64 vector** and the
protocol's combine is plain modular addition, which is exact, associative
and commutative. That makes masked sums *partial-foldable anywhere* —
a slice aggregator (the distributed tier, not ported yet), a
streaming accumulator, or
the controller root can add masked blobs in any order, in any grouping,
without keys, and the pairwise masks still cancel at the root by
construction. This module is that plane:

- **Streaming-compatible mask generation** — pair streams derive chunk
  by chunk from SHAKE-256 (one XOF call per ``MASK_CHUNK`` values keyed
  on ``secret | pair | round | tensor | chunk``), so a learner masks a
  tensor with O(chunk) transient memory and never materializes an
  O(model)-per-pair mask table. :func:`pair_stream` is the canonical
  derivation — encrypt-time masking and dropout recovery both call it,
  so the residuals a survivor discloses are bit-exact.
- **Bounded mask graphs** — :func:`mask_partners` optionally restricts
  each party's mask edges to its ``neighbors`` nearest parties on the
  deterministic ring (the Bell et al. CCS'20 k-regular-graph idea,
  specialized to a deterministic topology this trust model admits), so
  mask generation is O(neighbors · model) instead of O(parties · model)
  and 10k-party cohorts stay tractable.
- **Masked partial folds** — :class:`MaskedAccumulator` folds opaque
  masked payloads into per-tensor uint64 sums (mod 2^64) with
  round-scoped idempotence: a re-shipped payload is byte-identical (the
  backend's one-time-pad cache), so duplicates are skipped by id and
  arrival order cannot change a single bit of the sum.
- **Root finalization** — :func:`combine_partials` adds slice partials,
  :func:`unmask` subtracts the dropout-recovery residual and decodes
  fixed point back to the plain float64 community payload (the same
  public output ``MaskingBackend.weighted_sum`` produces).

The controller-side settlement that reconciles contributors against the
dispatched cohort and drives seed-share disclosure for dropouts lives in
:mod:`metisfl_tpu_torch.secure.recovery`.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# fixed-point contract (shared with secure/masking.py): values scale by
# 2^FP_BITS into int64, viewed as uint64 for modular arithmetic
FP_BITS = 40
FP_SCALE = float(1 << FP_BITS)

# values per SHAKE-256 XOF invocation: the transient working set of
# streaming mask generation (512 KiB of stream bytes per call)
MASK_CHUNK = 1 << 16


# --------------------------------------------------------------------- #
# pair streams (the canonical derivation)
# --------------------------------------------------------------------- #

def _chunk_digest(secret: str, lo: int, hi: int, round_id: int,
                  tensor_idx: int, chunk_idx: int, nbytes: int) -> bytes:
    material = (f"metisfl-mask|{secret}|{lo}|{hi}|{round_id}|"
                f"{tensor_idx}|{chunk_idx}").encode()
    return hashlib.shake_256(material).digest(nbytes)


def iter_pair_stream(secret: str, i: int, j: int, round_id: int,
                     tensor_idx: int, n: int,
                     chunk: int = MASK_CHUNK) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield ``(offset, values)`` chunks of the (i, j) pair stream.

    Chunks are independently seeded (the chunk index is part of the XOF
    key), so any range of the stream regenerates without hashing its
    prefix — the property that keeps both streaming mask application and
    partial-range recovery O(chunk) in memory."""
    lo, hi = (i, j) if i < j else (j, i)
    for chunk_idx, start in enumerate(range(0, int(n), int(chunk))):
        take = min(int(chunk), int(n) - start)
        raw = _chunk_digest(secret, lo, hi, int(round_id), int(tensor_idx),
                            chunk_idx, 8 * take)
        yield start, np.frombuffer(raw, "<u8")


def pair_stream(secret: str, i: int, j: int, round_id: int,
                tensor_idx: int, n: int,
                chunk: int = MASK_CHUNK) -> np.ndarray:
    """The full n-value (i, j) pair stream (chunked derivation)."""
    out = np.empty(int(n), np.uint64)
    for start, values in iter_pair_stream(secret, i, j, round_id,
                                          tensor_idx, n, chunk=chunk):
        out[start:start + len(values)] = values
    return out


def pair_sign(i: int, j: int) -> int:
    """The sign party ``i`` applies to stream (i, j): +1 iff j > i (j
    applies the opposite, so the pair cancels in the sum)."""
    return 1 if j > i else -1


# --------------------------------------------------------------------- #
# mask graph
# --------------------------------------------------------------------- #

def mask_partners(index: int, num_parties: int,
                  neighbors: int = 0) -> List[int]:
    """The parties ``index`` shares mask streams with.

    ``neighbors <= 0`` (default) is the complete graph — every other
    party, the classic Bonawitz construction. Otherwise each party pairs
    with its ``neighbors`` nearest parties on the ring (radius
    ``ceil(neighbors / 2)`` each way), a deterministic symmetric
    k-regular graph: ``j in partners(i)  <=>  i in partners(j)``, which
    is what makes the pairwise cancellation hold."""
    n = int(num_parties)
    i = int(index)
    if n <= 1:
        return []
    k = int(neighbors)
    if k <= 0 or k >= n - 1:
        return [j for j in range(n) if j != i]
    radius = (k + 1) // 2
    out = set()
    for step in range(1, radius + 1):
        out.add((i + step) % n)
        out.add((i - step) % n)
    out.discard(i)
    return sorted(out)


# --------------------------------------------------------------------- #
# fixed point
# --------------------------------------------------------------------- #

def encode_fixed(values: np.ndarray) -> np.ndarray:
    """Flat float -> fixed-point uint64 (the masking wire encoding)."""
    flat = np.asarray(values, np.float64).ravel()
    return np.round(flat * FP_SCALE).astype(np.int64).view(np.uint64)


def decode_fixed(acc: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Fixed-point uint64 sum -> float64 (applied once, at the root,
    after masks cancelled — scales must be uniform under masking)."""
    signed = np.asarray(acc, np.uint64).view(np.int64).astype(np.float64)
    return signed / FP_SCALE * float(scale)


# --------------------------------------------------------------------- #
# masked partial folds
# --------------------------------------------------------------------- #

class MaskedAccumulator:
    """Order-independent modular accumulator for masked opaque models.

    ``fold`` adds one contributor's payloads (uint64, mod 2^64) into the
    per-tensor running sums; a duplicate contributor id is skipped, which
    is sound because the masking backend re-ships a round's ciphertext
    verbatim (one-time-pad discipline) — the duplicate is byte-identical.
    The accumulator is round-scoped by construction: its owner keys one
    instance per round id (mask streams differ per round, so payloads
    from different rounds must never meet in one sum)."""

    def __init__(self):
        self._sums: Dict[str, np.ndarray] = {}
        self._specs: Dict[str, object] = {}
        self._contributors: List[str] = []

    @property
    def count(self) -> int:
        return len(self._contributors)

    @property
    def contributors(self) -> List[str]:
        return list(self._contributors)

    def fold(self, contributor_id: str,
             opaque: Mapping[str, Tuple[bytes, object]]) -> bool:
        """Add one masked model. Returns False for a duplicate id (byte-
        identical payload — nothing to add). Raises on a tensor-set or
        length mismatch: a malformed payload must cost its own
        contribution at the submitter, never corrupt the shared sum."""
        cid = str(contributor_id)
        if cid in self._contributors:
            return False
        if not opaque:
            raise ValueError("masked fold needs a non-empty opaque model")
        if self._sums and set(opaque) != set(self._sums):
            raise ValueError(
                f"masked payload tensor set {sorted(opaque)} does not "
                f"match the accumulated set {sorted(self._sums)}")
        staged: Dict[str, np.ndarray] = {}
        for name, (payload, spec) in opaque.items():
            values = np.frombuffer(payload, np.uint64)
            have = self._sums.get(name)
            if have is not None and len(values) != len(have):
                raise ValueError(
                    f"masked payload {name!r} has {len(values)} values, "
                    f"accumulated sum has {len(have)}")
            staged[name] = values
            if name not in self._specs:
                self._specs[name] = spec
        # stage fully, then commit: a mid-loop mismatch must not leave a
        # half-added contributor in the sum
        for name, values in staged.items():
            have = self._sums.get(name)
            self._sums[name] = values.copy() if have is None else have + values
        self._contributors.append(cid)
        return True

    def merge_sums(self, sums: Mapping[str, np.ndarray],
                   contributors: Iterable[str],
                   specs: Optional[Mapping[str, object]] = None) -> None:
        """Add another accumulator's partial sums (slice fan-in)."""
        fresh = [c for c in contributors if c not in self._contributors]
        if not fresh and self._sums:
            return
        for name, values in sums.items():
            arr = np.asarray(values, np.uint64)
            have = self._sums.get(name)
            self._sums[name] = arr.copy() if have is None else have + arr
            if specs and name not in self._specs:
                self._specs[name] = specs[name]
        self._contributors.extend(fresh)

    def snapshot(self) -> Tuple[Dict[str, np.ndarray], Dict[str, object],
                                List[str]]:
        return (dict(self._sums), dict(self._specs),
                list(self._contributors))


def combine_partials(parts: Sequence[Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Root fan-in: add per-slice partial sums (mod 2^64)."""
    out: Dict[str, np.ndarray] = {}
    for part in parts:
        for name, values in part.items():
            arr = np.asarray(values, np.uint64)
            have = out.get(name)
            out[name] = arr.copy() if have is None else have + arr
    return out


def unmask(sums: Mapping[str, np.ndarray],
           correction: Optional[Mapping[str, bytes]],
           scale: float) -> Dict[str, bytes]:
    """Finalize at the root: subtract the dropout-recovery residual (mod
    2^64) and decode fixed point to plain float64 payload bytes — the
    protocol's public output, byte-compatible with
    ``MaskingBackend.weighted_sum``."""
    out: Dict[str, bytes] = {}
    for name, acc in sums.items():
        acc = np.asarray(acc, np.uint64)
        if correction is not None:
            acc = acc - np.frombuffer(correction[name], np.uint64)
        out[name] = decode_fixed(acc, scale).tobytes()
    return out


# --------------------------------------------------------------------- #
# controller-side masked streaming
# --------------------------------------------------------------------- #

class MaskedStreamingAggregator:
    """Fold masked uplinks on arrival (aggregation.streaming under
    ``scheme: masking``, no store round-trip).

    The plain :class:`~metisfl_tpu_torch.aggregation.streaming.StreamingAggregator`
    cannot take opaque payloads; this one exists *because* masked sums
    can fold on arrival — modular addition is exact and order-free, so
    the stream accumulates the same bits any batch fold would. Round-
    scoped: ``begin_round`` rotates the accumulator (stale uplinks carry
    dead masks and are dropped by the caller). ``finish`` hands the
    sums + contributor list to the root settlement; it deliberately does
    NOT unmask — that needs the dropout reconciliation only the
    controller's round barrier knows."""

    def __init__(self):
        self._lock = threading.Lock()
        self._round_id: Optional[int] = None
        self._acc = MaskedAccumulator()

    def begin_round(self, round_id: int) -> None:
        with self._lock:
            rid = int(round_id)
            if rid != self._round_id:
                self._round_id = rid
                self._acc = MaskedAccumulator()

    def fold(self, learner_id: str,
             opaque: Mapping[str, Tuple[bytes, object]],
             round_id: int) -> bool:
        with self._lock:
            if self._round_id is None:
                self._round_id = int(round_id)
            elif int(round_id) != self._round_id:
                return False
            return self._acc.fold(learner_id, opaque)

    def finish(self, selected: Iterable[str]):
        """Sums + specs + the contributors actually folded (⊆ selected:
        the barrier expires stragglers before release and stale uplinks
        never fold). Resets for the next round."""
        with self._lock:
            sums, specs, contributors = self._acc.snapshot()
            self._acc = MaskedAccumulator()
            self._round_id = None
        if not contributors:
            return None
        wanted = set(str(s) for s in selected)
        extra = [c for c in contributors if c not in wanted]
        if extra:
            # contributors the barrier did not select cannot be folded
            # OUT of a masked sum (their payloads were not retained);
            # surface loudly — the caller falls back to a clean retry
            raise RuntimeError(
                f"masked stream folded non-selected contributors {extra}")
        return sums, specs, contributors

    def abandon(self) -> None:
        with self._lock:
            self._acc = MaskedAccumulator()
            self._round_id = None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"folded": self._acc.count,
                    "round": -1 if self._round_id is None else self._round_id}
