"""Mergeable streaming sketches: the port's copy of the JAX package's
``telemetry/sketch.py``, pure Python and line for line.

- :class:`QuantileDigest`: a t-digest-style quantile sketch with a
  bounded centroid count: ``add()`` streams observations, ``merge()``
  combines digests from independent streams, ``quantile(q)``
  interpolates. The per-centroid capacity ``4·n·q·(1-q)/compression``
  keeps resolution at the tails.
- :class:`SpaceSaving`: the Metwally et al. space-saving top-K heavy
  hitter tracker: bounded key table, minimum-count eviction, per-key
  overestimation bound (``error <= count``), ``merge()`` for fan-in.

Both serialize to plain dicts (``to_dict``/``from_dict``). A slice
aggregator ships its per-client uplink rollup as these dicts in every
fold reply (aggregation/slice.py), and the controller merges them
(aggregation/distributed.py ``describe``), in the JAX package's format,
so a slice of either package answers a controller of the other.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple


class QuantileDigest:
    """Streaming quantile sketch with a bounded centroid count.

    Centroids are (mean, weight) pairs kept sorted by mean; an insert
    buffers, and a compression pass greedily merges sorted neighbors
    while the merged weight stays under the k1-style capacity
    ``4·n·q·(1-q)/compression`` at the centroid's quantile position.
    Exact min/max are tracked separately so ``quantile(0)``/``(1)``
    never interpolate past an observed value.
    """

    def __init__(self, compression: int = 128):
        if compression < 8:
            raise ValueError("compression must be >= 8")
        self.compression = int(compression)
        self._means: List[float] = []
        self._weights: List[float] = []
        self._buffer: List[Tuple[float, float]] = []
        self._count = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- ingest ----------------------------------------------------------

    def add(self, value: float, weight: float = 1.0) -> None:
        if weight <= 0.0:
            return
        value = float(value)
        if math.isnan(value):
            return
        self._buffer.append((value, float(weight)))
        self._count += weight
        if value < self._min:
            self._min = value
        if value > self._max:
            self._max = value
        if len(self._buffer) >= 4 * self.compression:
            self._compress()

    def merge(self, other: "QuantileDigest") -> None:
        """Fold another digest in (both streams' observations count)."""
        other._compress()  # drains other's buffer into its centroids
        for mean, weight in zip(other._means, other._weights):
            self._buffer.append((mean, weight))
            self._count += weight
        if other._min < self._min:
            self._min = other._min
        if other._max > self._max:
            self._max = other._max
        self._compress()

    def _capacity(self, q: float) -> float:
        """Per-centroid weight cap at quantile position q (k1 scale)."""
        q = min(max(q, 1e-9), 1.0 - 1e-9)
        return max(1.0, 4.0 * self._count * q * (1.0 - q) / self.compression)

    def _compress(self) -> None:
        if not self._buffer:
            return  # centroids are already a compression-pass output
        pairs = sorted(list(zip(self._means, self._weights)) + self._buffer)
        self._buffer = []
        if not pairs:
            return
        means: List[float] = []
        weights: List[float] = []
        cum = 0.0
        cur_mean, cur_weight = pairs[0]
        for mean, weight in pairs[1:]:
            midpoint_q = (cum + (cur_weight + weight) / 2.0) / max(
                self._count, 1.0)
            if cur_weight + weight <= self._capacity(midpoint_q):
                total = cur_weight + weight
                cur_mean += (mean - cur_mean) * (weight / total)
                cur_weight = total
            else:
                means.append(cur_mean)
                weights.append(cur_weight)
                cum += cur_weight
                cur_mean, cur_weight = mean, weight
        means.append(cur_mean)
        weights.append(cur_weight)
        self._means = means
        self._weights = weights

    # -- queries ---------------------------------------------------------

    @property
    def count(self) -> float:
        return self._count

    @property
    def centroids(self) -> int:
        self._compress()
        return len(self._means)

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1] (0.0 when empty)."""
        self._compress()
        if not self._means or self._count <= 0:
            return 0.0
        q = min(max(float(q), 0.0), 1.0)
        if q <= 0.0:
            return self._min
        if q >= 1.0:
            return self._max
        target = q * self._count
        # centroid i spans [cum_i - w_i/2, cum_i + w_i/2] in rank space
        cum = 0.0
        prev_mean, prev_cum = self._min, 0.0
        for mean, weight in zip(self._means, self._weights):
            center = cum + weight / 2.0
            if target <= center:
                span = center - prev_cum
                frac = (target - prev_cum) / span if span > 0 else 1.0
                value = prev_mean + (mean - prev_mean) * frac
                return min(max(value, self._min), self._max)
            prev_mean, prev_cum = mean, center
            cum += weight
        span = self._count - prev_cum
        frac = (target - prev_cum) / span if span > 0 else 1.0
        value = prev_mean + (self._max - prev_mean) * frac
        return min(max(value, self._min), self._max)

    def quantiles(self, qs: Iterable[float]) -> Dict[str, float]:
        """``{str(q): value}`` for several quantiles in one pass."""
        return {f"{q:g}": self.quantile(q) for q in qs}

    # -- serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        self._compress()
        return {
            "compression": self.compression,
            "means": list(self._means),
            "weights": list(self._weights),
            "count": self._count,
            "min": None if math.isinf(self._min) else self._min,
            "max": None if math.isinf(self._max) else self._max,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuantileDigest":
        digest = cls(compression=int(data.get("compression", 128)))
        digest._means = [float(v) for v in data.get("means", [])]
        digest._weights = [float(v) for v in data.get("weights", [])]
        digest._count = float(data.get("count", sum(digest._weights)))
        digest._min = (math.inf if data.get("min") is None
                       else float(data["min"]))
        digest._max = (-math.inf if data.get("max") is None
                       else float(data["max"]))
        return digest


class SpaceSaving:
    """Space-saving top-K heavy hitters (Metwally et al. 2005).

    Bounded table of ``capacity`` keys. ``offer(key, amount)`` adds to a
    tracked key's count; an untracked key past capacity evicts the
    current minimum and inherits its count as ``error`` (the classic
    overestimation bound: ``true_count >= count - error``). ``last``
    keeps the most recent raw observation per key so gauge-shaped
    families can expose the offender's current value, not its running
    sum.
    """

    def __init__(self, capacity: int = 48):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._counts: Dict[str, float] = {}
        self._errors: Dict[str, float] = {}
        self._last: Dict[str, float] = {}

    def offer(self, key: str, amount: float = 1.0,
              value: Optional[float] = None) -> None:
        if amount < 0.0:
            amount = 0.0
        if key in self._counts:
            self._counts[key] += amount
        elif len(self._counts) < self.capacity:
            self._counts[key] = amount
            self._errors[key] = 0.0
        else:
            victim = min(self._counts, key=self._counts.get)
            floor = self._counts.pop(victim)
            self._errors.pop(victim, None)
            self._last.pop(victim, None)
            self._counts[key] = floor + amount
            self._errors[key] = floor
        self._last[key] = float(value if value is not None
                                else self._counts[key])

    def update(self, key: str, value: float) -> None:
        """Gauge-shaped tracking: rank by CURRENT value, not cumulative
        sum — ``offer()`` would let a frequent low-value reporter
        accumulate past a rarely-reporting true offender (slow learners
        report rarely by definition). Tracked keys follow their latest
        value down as well as up; an untracked key enters only by
        beating the current minimum (no error inheritance — there is no
        count semantics to bound)."""
        value = float(value)
        if key in self._counts:
            self._counts[key] = value
        elif len(self._counts) < self.capacity:
            self._counts[key] = value
            self._errors[key] = 0.0
        else:
            victim = min(self._counts, key=self._counts.get)
            if value <= self._counts[victim]:
                return
            self.drop(victim)
            self._counts[key] = value
            self._errors[key] = 0.0
        self._last[key] = value

    def drop(self, key: str) -> None:
        """Forget one key (a departed learner's offender slot)."""
        self._counts.pop(key, None)
        self._errors.pop(key, None)
        self._last.pop(key, None)

    def merge(self, other: "SpaceSaving") -> None:
        """Fold another tracker in: counts and errors add for shared
        keys; the union is then trimmed back to capacity by evicting the
        smallest counts (their mass is dropped — the usual space-saving
        merge approximation, still within the summed error bounds for
        the survivors)."""
        for key, count in other._counts.items():
            if key in self._counts:
                self._counts[key] += count
                self._errors[key] = (self._errors.get(key, 0.0)
                                     + other._errors.get(key, 0.0))
            else:
                self._counts[key] = count
                self._errors[key] = other._errors.get(key, 0.0)
            self._last[key] = other._last.get(key, self._last.get(key, 0.0))
        while len(self._counts) > self.capacity:
            victim = min(self._counts, key=self._counts.get)
            self.drop(victim)

    def top(self, k: int = 0) -> List[Tuple[str, float, float, float]]:
        """``(key, count, error, last_value)`` rows, largest count first
        (``k=0`` returns the whole table)."""
        rows = sorted(((key, count, self._errors.get(key, 0.0),
                        self._last.get(key, 0.0))
                       for key, count in self._counts.items()),
                      key=lambda r: (-r[1], r[0]))
        return rows[:k] if k > 0 else rows

    def __len__(self) -> int:
        return len(self._counts)

    def __contains__(self, key: str) -> bool:
        return key in self._counts

    # -- serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "rows": [[key, count, self._errors.get(key, 0.0),
                      self._last.get(key, 0.0)]
                     for key, count in self._counts.items()],
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SpaceSaving":
        tracker = cls(capacity=int(data.get("capacity", 48)))
        for row in data.get("rows", []):
            key, count, error, last = (list(row) + [0.0, 0.0, 0.0])[:4]
            tracker._counts[str(key)] = float(count)
            tracker._errors[str(key)] = float(error)
            tracker._last[str(key)] = float(last)
        return tracker
