"""Pairwise additive-masking secure aggregation (the port's copy of the JAX
package's ``secure/masking.py``: the same payload words for the same
secret, party, round and values).

The lightweight alternative to HE (Bonawitz-style secure aggregation):
every learner pair (i, j) derives a shared mask stream; learner i adds the
stream, learner j subtracts it, so the *sum* over all learners is exactly
the plaintext sum while every individual payload the controller sees is
uniformly masked. No ciphertext blow-up (the reference's CKKS inflates a
CIFAR model to ~100 MB, controller.cc:594-604) and no homomorphic compute
on the controller — the hot path stays a plain fused sum.

Construction: values are fixed-point encoded into uint64 (scale 2^40) and
masked with uniform uint64 streams from SHAKE-256 in XOF mode over
``secret | pair | round | tensor`` — a CSPRNG stream, modular arithmetic, so
masks cancel EXACTLY (no float-noise leakage) and each masked payload is
uniform to anyone without the federation secret.

Constraints (enforced):
- scales must be uniform (1/N) — weighted masking requires learner-side
  pre-scaling; use the ``participants`` scaler.

**Dropout robustness** (the Bonawitz unmasking round, specialized to this
trust model): when parties drop mid-round, the partial sum carries the
un-cancelled residual Σᵢ∈S ±stream(i, d) for each dropped d. Because every
learner holds the federation secret, ONE surviving learner can recompute
exactly that residual (:meth:`recovery_correction` — the protocol's "share
recovery" collapses to a single RPC); the controller subtracts it and
recovers Σᵢ∈S xᵢ, precisely what full Bonawitz reveals after recovery.
Individual payloads stay uniformly masked throughout; a minimum-survivor
threshold (``weighted_sum(..., min_parties=…)``, the Bonawitz ``t``)
refuses recoveries that would reduce the sum to fewer than 2 parties.

Pair streams derive from a driver-distributed federation secret that the
controller never receives (the reference likewise withholds the CKKS private
key from the controller, driver_session.py:129-140).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from metisfl_tpu_torch.secure.distributed import (
    FP_BITS,
    FP_SCALE,
    mask_partners,
    pair_stream,
)

_FP_BITS = FP_BITS
_FP_SCALE = FP_SCALE


class MaskingBackend:
    name = "masking"

    def __init__(self, federation_secret: str = "", party_index: int = 0,
                 num_parties: int = 1, min_parties: int = 2,
                 neighbors: int = 0):
        self.secret = federation_secret
        self.party_index = int(party_index)
        self.num_parties = int(num_parties)
        # the Bonawitz threshold t, enforced LEARNER-side: this party
        # refuses to help unmask a sum of fewer than min_parties payloads
        self.min_parties = max(2, int(min_parties))
        # bounded mask graph (secure/distributed.py mask_partners): 0 =
        # every pair (the classic construction); > 0 = the deterministic
        # ring k-regular graph, O(neighbors · model) mask generation
        self.neighbors = max(0, int(neighbors))
        self._round_id = 0
        self._tensor_counter = 0
        # rounds this party actually trained for (begin_round), newest
        # last, bounded by TRAINING progression — the recovery allowlist.
        # Recovery requests for any other round id are refused, so the
        # controller cannot flood dummy ids to evict served-split records.
        self._rounds_seen: "OrderedDict[int, Optional[tuple]]" = OrderedDict()
        # per-round ciphertext cache: ONE ciphertext per (round, tensor)
        # ever leaves this party. A re-dispatched round re-ships the
        # first attempt's payload verbatim — encrypting fresh values under
        # the same (deterministic per-round) mask stream would hand the
        # controller a two-time pad (difference of the two payloads).
        self._sent: dict = {}

    # -- round context (learner calls this per task) ----------------------
    def begin_round(self, round_id: int) -> None:
        rid = int(round_id)
        if self.secret and rid != self._round_id:
            # only the CURRENT round can legitimately re-dispatch (masking
            # is sync/semi-sync only; the round counter never rewinds), so
            # previous rounds' ciphertext caches are dead weight — at
            # 110M-param scale each is ~0.9 GB, so this purge is what
            # bounds learner memory to one round's payloads
            self._sent = {k: v for k, v in self._sent.items()
                          if k[0] == rid}
        self._round_id = rid
        self._tensor_counter = 0
        if self.secret:
            if self._round_id not in self._rounds_seen:
                self._rounds_seen[self._round_id] = None
            while len(self._rounds_seen) > 64:
                self._rounds_seen.popitem(last=False)

    def _pair_stream(self, i: int, j: int, tensor_idx: int, n: int,
                     round_id: int = None) -> np.ndarray:
        rid = self._round_id if round_id is None else int(round_id)
        # the canonical chunked XOF derivation (secure/distributed.py):
        # encrypt-time masking and dropout recovery share it bit-exactly
        return pair_stream(self.secret, i, j, rid, tensor_idx, n)

    def _partners(self) -> Sequence[int]:
        return mask_partners(self.party_index, self.num_parties,
                             self.neighbors)

    def _mask(self, n: int, tensor_idx: int) -> np.ndarray:
        mask = np.zeros(n, np.uint64)
        i = self.party_index
        for j in self._partners():
            stream = self._pair_stream(i, j, tensor_idx, n)
            # modular uint64 arithmetic: adds and subtracts cancel exactly
            mask = mask + stream if j > i else mask - stream
        return mask

    # -- HEBackend contract ------------------------------------------------
    def _max_abs_value(self) -> float:
        # the unmasked k-party fixed-point sum must stay inside int64
        return 2.0 ** (62 - _FP_BITS) / max(1, self.num_parties)

    def encrypt(self, values: np.ndarray) -> bytes:
        # one-time-pad discipline: the mask stream is deterministic per
        # (round, tensor), so only ONE ciphertext per (round, tensor) may
        # ever leave this party — a re-dispatched round (same round id,
        # possibly retrained values) re-ships the first attempt verbatim
        # instead of leaking the difference of two payloads. (The retry's
        # local training is then wasted compute — an accepted cost on a
        # rare failure path; see docs/SECURITY.md for the restart caveat.)
        idx = self._tensor_counter
        self._tensor_counter += 1
        key = (self._round_id, idx)
        cached = self._sent.get(key)
        if cached is not None:
            return cached
        values = np.asarray(values, np.float64).ravel()
        bound = self._max_abs_value()
        if values.size and np.abs(values).max() > bound:
            raise ValueError(
                f"masking fixed-point encoding supports |v| <= {bound:g} "
                f"for {self.num_parties} parties")
        fixed = np.round(values * _FP_SCALE).astype(np.int64).view(np.uint64)
        payload = (fixed + self._mask(len(values), idx)).tobytes()
        if self.secret:
            self._sent[key] = payload
        return payload

    def decrypt(self, payload: bytes, num_values: int) -> np.ndarray:
        # aggregated payloads (weighted_sum output) are plain float64 — the
        # controller-computed community model is the protocol's public output
        out = np.frombuffer(payload, np.float64)
        if len(out) < num_values:
            raise ValueError(f"payload has {len(out)} values, need {num_values}")
        return out[:num_values].copy()

    def recovery_correction(self, round_id: int, surviving: Sequence[int],
                            dropped: Sequence[int],
                            lengths: Sequence[int]) -> list:
        """The dropped parties' un-cancelled mask residual, per tensor.

        For the partial sum over surviving set S with dropped set D, the
        residual is Σ_{d∈D} Σ_{i∈S} sign(i,d)·stream(i,d) with
        sign(i,d) = +1 iff d > i (the sign party i used when masking).
        Any learner can compute it (the secret is federation-wide); the
        controller cannot. Returns one uint64-array ``bytes`` per tensor,
        to be SUBTRACTED from the masked partial sum."""
        if not self.secret:
            raise RuntimeError("recovery requires the federation secret "
                               "(learner role)")
        if set(surviving) & set(dropped):
            raise ValueError("surviving and dropped sets overlap")
        # Learner-side privacy enforcement (the controller-side checks
        # constrain the party they are meant to protect against):
        # (a) never help unmask a sum of < min_parties payloads;
        if len(set(surviving)) < self.min_parties:
            raise ValueError(
                f"refusing recovery for {len(set(surviving))} survivors "
                f"(< threshold {self.min_parties}: the unmasked sum would "
                "approach a single party's plaintext)")
        # (b) only rounds this party actually trained for are recoverable —
        # the served-split record below lives as long as the round itself,
        # so the controller cannot flood dummy round ids to evict it;
        rid = int(round_id)
        if rid not in self._rounds_seen:
            raise ValueError(
                f"refusing recovery for round {rid}: this party has no "
                "record of training for it")
        # (c) one split per round: corrections for two different survivor
        # sets of the same round intersect to individual payloads.
        key = (frozenset(surviving), frozenset(dropped))
        prev = self._rounds_seen[rid]
        if prev is not None and prev != key:
            raise ValueError(
                f"already served a different recovery split for round "
                f"{rid}; refusing (partial-sum intersection attack)")
        # (d) neighbor isolation (bounded mask graphs only): a survivor
        # whose every mask partner is in the dropped set would have ALL
        # its masks disclosed by this residual — its payload would sit in
        # the sum effectively unmasked. Refuse the whole recovery.
        survivors = set(surviving)
        if self.neighbors > 0:
            for s in survivors:
                partners = set(mask_partners(int(s), self.num_parties,
                                             self.neighbors))
                if partners and not (partners & survivors):
                    raise ValueError(
                        f"refusing recovery: survivor {s} would keep no "
                        "live mask partner (every neighbor dropped; its "
                        "payload would be disclosed)")
        self._rounds_seen[rid] = key
        corrections = []
        for tensor_idx, n in enumerate(lengths):
            acc = np.zeros(int(n), np.uint64)
            for d in dropped:
                # bounded graphs: party d only ever masked against its
                # partners — the residual spans exactly those edges
                partners = set(mask_partners(int(d), self.num_parties,
                                             self.neighbors))
                for i in surviving:
                    if i not in partners:
                        continue
                    stream = self._pair_stream(i, d, tensor_idx, int(n),
                                               round_id=round_id)
                    acc = acc + stream if d > i else acc - stream
            corrections.append(acc.tobytes())
        return corrections

    def weighted_sum(self, payloads: Sequence[bytes],
                     scales: Sequence[float],
                     correction: bytes = None,
                     min_parties: int = 2) -> bytes:
        if correction is None and len(payloads) != self.num_parties:
            raise ValueError(
                f"masking secure-agg needs all {self.num_parties} parties; "
                f"got {len(payloads)} (partial cohorts need a dropout "
                "recovery correction)")
        if correction is not None and len(payloads) < max(2, min_parties):
            # the Bonawitz threshold: never unmask a sum of < min_parties
            # payloads (at 1 it would be a single learner's plaintext)
            raise ValueError(
                f"dropout recovery needs >= {max(2, min_parties)} surviving "
                f"parties; got {len(payloads)}")
        if len(set(np.round(scales, 9))) != 1:
            raise ValueError(
                "masking secure-agg requires uniform scales — configure the "
                "'participants' scaler")
        acc = np.zeros(len(payloads[0]) // 8, np.uint64)
        for payload in payloads:
            acc = acc + np.frombuffer(payload, np.uint64)  # wraps mod 2^64
        if correction is not None:
            acc = acc - np.frombuffer(correction, np.uint64)
        signed = acc.view(np.int64).astype(np.float64) / _FP_SCALE
        return (signed * float(scales[0])).tobytes()
