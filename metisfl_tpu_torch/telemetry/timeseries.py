"""Bounded in-process time series: the serving autoscaler's working memory.

The port's copy of the JAX package's ``telemetry/timeseries.py``. The
metrics registry answers "what is the value *now*"; a scale rule needs
"how has it moved": a rate over a window, a threshold held for a
duration. :class:`TimeSeriesRing` keeps a small ring of (ts, value)
samples per named series, bounded on both axes (``capacity`` points per
series, ``max_series`` series in all), so a process that runs for a month
holds as much history as one that ran for an hour. ``snapshot()`` gives
the recent points of every series and :func:`sparkline` renders a series
as one line of block characters.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


class TimeSeriesRing:
    """``record()`` appends, ``window()``/``rate()`` read back. Thread-
    safe; series past ``max_series`` are dropped (counted, never raised
    — telemetry must not fail the caller)."""

    def __init__(self, capacity: int = 240, max_series: int = 64):
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        self._series: "Dict[str, collections.deque]" = {}
        self.dropped_series = 0

    def record(self, name: str, value: float,
               ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else float(ts)
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                ring = self._series[name] = collections.deque(
                    maxlen=self.capacity)
            ring.append((ts, float(value)))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1] if ring else None

    def window(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples within the trailing ``seconds`` (oldest first)."""
        now = time.time() if now is None else float(now)
        cutoff = now - max(0.0, float(seconds))
        with self._lock:
            ring = self._series.get(name)
            if not ring:
                return []
            return [(ts, v) for ts, v in ring if ts >= cutoff]

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> float:
        """Per-second increase over the trailing window — counter
        semantics: (last - first) / elapsed, clamped at 0 so a registry
        reset never reports a negative rate. 0.0 with fewer than two
        samples in the window (no rate is attributable yet)."""
        points = self.window(name, seconds, now=now)
        if len(points) < 2:
            return 0.0
        (t0, v0), (t1, v1) = points[0], points[-1]
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))

    def points(self, name: str, n: int = 0) -> List[float]:
        """The last ``n`` sample values (0 = everything retained)."""
        with self._lock:
            ring = self._series.get(name)
            values = [v for _, v in ring] if ring else []
        return values[-n:] if n > 0 else values

    def snapshot(self, points: int = 30) -> Dict[str, Any]:
        """Bounded wire shape for DescribeFederation: the last
        ``points`` values per series plus the newest timestamp."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, ring in self._series.items():
                if not ring:
                    continue
                values = [round(v, 6) for _, v in ring]
                out[name] = {"points": values[-points:],
                             "last_ts": round(ring[-1][0], 3)}
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self.dropped_series = 0


def sparkline(values: List[float], width: int = 24) -> str:
    """One unicode block-character line for a value series (the status
    CLI's live time-series cell). Scales min→max; a flat series renders
    as the lowest block so movement is what draws the eye."""
    if not values:
        return ""
    values = [float(v) for v in values[-width:]]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return SPARK_BLOCKS[0] * len(values)
    span = hi - lo
    return "".join(
        SPARK_BLOCKS[min(len(SPARK_BLOCKS) - 1,
                         int((v - lo) / span * len(SPARK_BLOCKS)))]
        for v in values)
