"""Thread-safe metrics registry with Prometheus text exposition.

Zero-dependency counterpart of ``prometheus_client``: counters, gauges and
histograms keyed by label values, rendered in the text exposition format
(version 0.0.4) that Prometheus, victoriametrics and ``promtool`` ingest:

    https://prometheus.io/docs/instrumenting/exposition_formats/

One process-wide registry (``registry()``) backs every instrumented
subsystem — RPC transport, controller rounds, learner training, stores —
and is served over the ``GetMetrics`` RPC and the optional plain-HTTP
``/metrics`` listener (:mod:`metisfl_tpu_torch.telemetry.httpd`). The whole
registry can be disabled (federation config ``telemetry.enabled=false``);
disabled instruments return before taking the lock, so the opt-out path
costs one attribute read per call site.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# latency-shaped default buckets (seconds): sub-ms RPC acks up through
# multi-second cold-jit training rounds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# --------------------------------------------------------------------- #
# cardinality budgets (docs/OBSERVABILITY.md "Telemetry at scale")
# --------------------------------------------------------------------- #

# Companion families minted when a budgeted family collapses. Name
# strings live HERE (telemetry/__init__.py re-exports them as M_*
# constants — this module cannot import the package back).
SERIES_OVERFLOW_TOTAL = "metrics_series_overflow_total"
FAMILY_SERIES = "metrics_family_series"

# quantile series a collapsed gauge family exposes, and how many top-K
# offender series keep their original labels
SKETCH_QUANTILES = (0.5, 0.9, 0.99)
SKETCH_OFFENDERS = 10


def exact_quantile(ordered: Sequence[float], q: float) -> float:
    """Interpolated quantile of an already-sorted value list (0.0 when
    empty) — the ONE implementation behind exact-mode family quantiles
    and the controller's describe() digest columns."""
    if not ordered:
        return 0.0
    q = min(max(float(q), 0.0), 1.0)
    pos = q * (len(ordered) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


class _FamilySketch:
    """Collapsed-family state: a quantile digest over observations
    (gauge families), a top-K offender tracker (gauges rank by current
    value, counters by accumulated space-saving count), per-rest-label
    totals (counter families — one remainder per non-budget label
    combination, so ``sum by (op)`` stays exact), and distinct-series
    accounting. O(compression + capacity + label-combos) memory and
    checkpoint bytes regardless of fleet size — manipulated only under
    the owning family's lock."""

    def __init__(self, kind: str, budget: int):
        from metisfl_tpu_torch.telemetry.sketch import QuantileDigest, SpaceSaving

        self.kind = kind
        self.digest = QuantileDigest()
        self.topk = SpaceSaving(capacity=max(16, min(int(budget), 64)))
        self.seen: set = set()
        # restored distinct-series count: the checkpoint persists sketches
        # and the count, never the key list (that would be O(fleet) again)
        self.seen_floor = 0
        # counter families: sum across series, keyed by the non-budget
        # label values (bounded by the family's label-value combos)
        self.totals: Dict[Tuple[str, ...], float] = {}

    def total(self) -> float:
        return sum(self.totals.values())

    def distinct(self) -> int:
        return max(len(self.seen), self.seen_floor)

    def to_dict(self) -> Dict[str, object]:
        return {"kind": self.kind, "digest": self.digest.to_dict(),
                "topk": self.topk.to_dict(), "distinct": self.distinct(),
                "totals": [[list(rest), value]
                           for rest, value in self.totals.items()]}

    @classmethod
    def from_dict(cls, data: Dict[str, object]) -> "_FamilySketch":
        from metisfl_tpu_torch.telemetry.sketch import QuantileDigest, SpaceSaving

        sketch = cls(str(data.get("kind", "gauge")), 48)
        sketch.digest = QuantileDigest.from_dict(data.get("digest") or {})
        sketch.topk = SpaceSaving.from_dict(data.get("topk") or {})
        sketch.seen_floor = int(data.get("distinct", 0) or 0)
        for rest, value in data.get("totals", []) or []:
            sketch.totals[tuple(str(v) for v in rest)] = float(value)
        if "total" in data:  # pre-rest-label state shape
            sketch.totals[()] = float(data.get("total") or 0.0)
        return sketch


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class _Metric:
    """One named family; concrete series are keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str,
                 labelnames: Sequence[str]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        # cardinality budget (docs/OBSERVABILITY.md "Telemetry at
        # scale"): families registered with ``budget_label`` (the label
        # whose distinct values scale with the fleet — "learner",
        # "peer") collapse to sketches once the registry's budget is
        # armed and exceeded. 0 = exact behavior, one attribute check.
        self.budget_label = ""
        self._budget = 0
        self._sketch: Optional["_FamilySketch"] = None
        # companion-family handles, resolved once at first overflow (a
        # registry _get_or_create per hot-path observation would
        # serialize every budgeted family on the registry lock)
        self._overflow_handle: Optional["Counter"] = None
        self._series_handle: Optional["Gauge"] = None

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _series(self, key: Tuple[str, ...]) -> str:
        if not key:
            return self.name
        pairs = ",".join(f'{k}="{_escape(v)}"'
                         for k, v in zip(self.labelnames, key))
        return f"{self.name}{{{pairs}}}"

    # -- cardinality budget (Counter/Gauge only; call sites hold _lock) --

    @staticmethod
    def _topk_key(key: Tuple[str, ...]) -> str:
        return "\x00".join(key)

    @staticmethod
    def _from_topk_key(tkey: str) -> Tuple[str, ...]:
        return tuple(tkey.split("\x00"))

    def _budget_index(self) -> int:
        return self.labelnames.index(self.budget_label)

    def _rest_key(self, key: Tuple[str, ...]) -> Tuple[str, ...]:
        """The non-budget label values of a series key (counter
        remainders are kept per combination of these, so per-label
        Prometheus sums stay exact past the budget)."""
        idx = self._budget_index()
        return tuple(v for i, v in enumerate(key) if i != idx)

    def _other_key(self, rest: Tuple[str, ...]) -> Tuple[str, ...]:
        """Full series key for a remainder: the budget label reads
        ``_other``, every other label keeps its real value — the family
        exposes one consistent label set across all its series."""
        values = list(rest)
        values.insert(self._budget_index(), "_other")
        return tuple(values)

    def _collapse_locked(self) -> None:
        """Exact → sketch transition: fold every existing series into
        the digest/top-K, drop the per-series map. Called under _lock
        the moment the budget is first exceeded."""
        sketch = _FamilySketch(self.kind, self._budget)
        for key, value in self._values.items():
            v = float(value)
            sketch.digest.add(v)
            if self.kind == "gauge":
                sketch.topk.update(self._topk_key(key), v)
            else:
                sketch.topk.offer(self._topk_key(key), v, value=v)
                rest = self._rest_key(key)
                sketch.totals[rest] = sketch.totals.get(rest, 0.0) + v
            sketch.seen.add(key)
        self._values.clear()
        self._sketch = sketch
        self._note_overflow(1)  # the series that tipped the budget
        self._note_family_series(sketch.distinct())

    def _observe_collapsed(self, key: Tuple[str, ...], value: float,
                           cumulative: bool) -> None:
        """One observation into the collapsed state. ``cumulative`` is
        the counter shape (value = increment, totals accumulate, top-K
        ranks by accumulated count); gauges feed the digest with the
        set value itself and rank offenders by CURRENT value."""
        sketch = self._sketch
        if key not in sketch.seen:
            sketch.seen.add(key)
            self._note_overflow(1)
            self._note_family_series(sketch.distinct())
        tkey = self._topk_key(key)
        if cumulative:
            rest = self._rest_key(key)
            sketch.totals[rest] = sketch.totals.get(rest, 0.0) + value
            sketch.topk.offer(tkey, value)
        else:
            sketch.digest.add(value)
            sketch.topk.update(tkey, value)

    def _note_overflow(self, n: int) -> None:
        handle = self._overflow_handle
        if handle is None:
            handle = self._overflow_handle = self._registry.counter(
                SERIES_OVERFLOW_TOTAL,
                "Series observed past a family's "
                "telemetry.cardinality_budget (the family is serving "
                "sketches, not exact series)", ("family",))
        handle.inc(n, family=self.name)

    def _note_family_series(self, distinct: int) -> None:
        handle = self._series_handle
        if handle is None:
            handle = self._series_handle = self._registry.gauge(
                FAMILY_SERIES,
                "Distinct series tracked by a budget-collapsed family "
                "(exact families expose their series instead)",
                ("family",))
        handle.set(distinct, family=self.name)

    def _render_collapsed(self, out: List[str]) -> None:
        """Collapsed exposition: O(budget) lines however large the
        fleet. Gauge families expose quantile series + top-K offenders
        (current value); counter families expose top-K offenders
        (accumulated count) + one ``<budget_label>="_other"`` remainder
        per non-budget label combination, so ``sum()`` — including
        ``sum by (<other label>)`` — over the family stays exact."""
        sketch = self._sketch
        if sketch.kind == "gauge":
            for q in SKETCH_QUANTILES:
                out.append(f'{self.name}{{quantile="{q:g}"}} '
                           f"{_format_value(sketch.digest.quantile(q))}")
        top = sketch.topk.top(SKETCH_OFFENDERS)
        shown: Dict[Tuple[str, ...], float] = {}
        for tkey, count, _err, last in top:
            key = self._from_topk_key(tkey)
            value = last if sketch.kind == "gauge" else count
            if sketch.kind != "gauge":
                rest = self._rest_key(key)
                shown[rest] = shown.get(rest, 0.0) + count
            out.append(f"{self._series(key)} {_format_value(value)}")
        if sketch.kind != "gauge":
            for rest in sorted(sketch.totals):
                remainder = max(0.0, sketch.totals[rest]
                                - shown.get(rest, 0.0))
                out.append(f"{self._series(self._other_key(rest))} "
                           f"{_format_value(remainder)}")

    # -- budget-aware queries (safe in exact mode too) -------------------

    def collapsed(self) -> bool:
        with self._lock:
            return self._sketch is not None

    def series_count(self) -> int:
        with self._lock:
            if self._sketch is not None:
                return self._sketch.distinct()
            return len(getattr(self, "_values", {}))

    def quantile(self, q: float) -> float:
        """Quantile across the family's series: exact (sorted values)
        below budget, digest estimate once a GAUGE family collapsed.
        Alert rules and the describe() digest columns read through
        this. A collapsed COUNTER family returns 0.0 — its running
        per-series totals cannot be digested (only the top-K offenders
        survive, whose counts are biased by eviction error), and a
        garbage quantile would false-fire alerts; use value/rate rules
        for counter families past the budget. Histogram families (list
        cells) report 0.0 — an alert rule over one is inert, never a
        poll-crashing TypeError."""
        with self._lock:
            if self._sketch is not None:
                if self._sketch.kind == "gauge":
                    return self._sketch.digest.quantile(q)
                return 0.0
            values = sorted(float(v) for v in self._values.values()
                            if isinstance(v, (int, float)))
        return exact_quantile(values, q)

    def total(self) -> float:
        """Sum across all series (counter semantics survive collapse
        exactly; a collapsed gauge sums its tracked offenders only).
        Histogram families (list cells) report 0.0 — see quantile()."""
        with self._lock:
            if self._sketch is not None:
                if self._sketch.kind != "gauge":
                    return self._sketch.total()
                return sum(last for _, _c, _e, last in
                           self._sketch.topk.top(0))
            return sum(v for v in self._values.values()
                       if isinstance(v, (int, float)))

    def sketch_summary(self, offenders: int = 5):
        """Compact collapsed-state view for RoundMetadata / status:
        distinct-series count, quantiles (gauge families), total
        (counter families), top offenders. None while exact."""
        with self._lock:
            if self._sketch is None:
                return None
            sketch = self._sketch
            out: Dict[str, object] = {"series": sketch.distinct()}
            if sketch.kind == "gauge":
                out["quantiles"] = {
                    f"{q:g}": round(sketch.digest.quantile(q), 6)
                    for q in SKETCH_QUANTILES}
            else:
                out["total"] = sketch.total()
            out["top"] = [
                [list(self._from_topk_key(tkey)),
                 round(last if sketch.kind == "gauge" else count, 6)]
                for tkey, count, _e, last in sketch.topk.top(offenders)]
            return out

    def prune_label_value(self, value: str) -> None:
        """Drop every series whose budget label equals ``value`` (the
        central leave()-time prune). The digest keeps its history —
        observations cannot be unobserved — but the key leaves the
        distinct set and the offender table."""
        if not self.budget_label:
            return
        idx = self._budget_index()
        with self._lock:
            if self._sketch is not None:
                sketch = self._sketch
                for key in [k for k in sketch.seen if k[idx] == value]:
                    sketch.seen.discard(key)
                for tkey, count, _e, _l in sketch.topk.top(0):
                    key = self._from_topk_key(tkey)
                    if len(key) > idx and key[idx] == value:
                        if sketch.kind != "gauge":
                            rest = self._rest_key(key)
                            sketch.totals[rest] = max(
                                0.0, sketch.totals.get(rest, 0.0) - count)
                        sketch.topk.drop(tkey)
                self._note_family_series(sketch.distinct())
                return
            for key in [k for k in self._values if k[idx] == value]:
                self._values.pop(key, None)

    def budget_state(self):
        with self._lock:
            return (self._sketch.to_dict()
                    if self._sketch is not None else None)

    def restore_budget_state(self, state: Dict[str, object]) -> None:
        """Rehydrate collapsed state from a checkpoint: the family is
        collapsed from here on (pre-crash observations live only in the
        digest — exact series cannot be reconstructed from it)."""
        sketch = _FamilySketch.from_dict(state)
        with self._lock:
            for key, value in getattr(self, "_values", {}).items():
                v = float(value)
                sketch.digest.add(v)
                if sketch.kind == "gauge":
                    sketch.topk.update(self._topk_key(key), v)
                else:
                    sketch.topk.offer(self._topk_key(key), v, value=v)
                    rest = self._rest_key(key)
                    sketch.totals[rest] = sketch.totals.get(rest, 0.0) + v
                sketch.seen.add(key)
            self._values.clear()
            self._sketch = sketch
            self._note_family_series(sketch.distinct())


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help, labelnames):
        super().__init__(registry, name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            if self._sketch is not None:
                self._observe_collapsed(key, amount, cumulative=True)
                return
            self._values[key] = self._values.get(key, 0.0) + amount
            if self._budget and len(self._values) > self._budget:
                self._collapse_locked()

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            if self._sketch is not None:
                # best effort past the budget: an offender's tracked
                # count (gauges: last observed value), 0 for the crowd
                for tkey, count, _e, last in self._sketch.topk.top(0):
                    if self._from_topk_key(tkey) == key:
                        return last if self.kind == "gauge" else count
                return 0.0
            return self._values.get(key, 0.0)

    def remove(self, **labels) -> None:
        """Drop one series (bounded cardinality under churn: e.g. a
        departed learner's per-learner series must not live forever)."""
        key = self._key(labels)
        with self._lock:
            if self._sketch is not None:
                sketch = self._sketch
                sketch.seen.discard(key)
                tkey = self._topk_key(key)
                if tkey in sketch.topk:
                    if sketch.kind != "gauge":
                        count = dict((k, c) for k, c, _e, _l in
                                     sketch.topk.top(0)).get(tkey, 0.0)
                        rest = self._rest_key(key)
                        sketch.totals[rest] = max(
                            0.0, sketch.totals.get(rest, 0.0) - count)
                    sketch.topk.drop(tkey)
                self._note_family_series(sketch.distinct())
                return
            self._values.pop(key, None)

    def _render(self, out: List[str]) -> None:
        with self._lock:
            if self._sketch is not None:
                self._render_collapsed(out)
                return
            items = sorted(self._values.items())
        for key, value in items:
            out.append(f"{self._series(key)} {_format_value(value)}")

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._sketch = None


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        key = self._key(labels)
        with self._lock:
            if self._sketch is not None:
                self._observe_collapsed(key, float(value), cumulative=False)
                return
            self._values[key] = float(value)
            if self._budget and len(self._values) > self._budget:
                self._collapse_locked()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._registry.enabled:
            return
        key = self._key(labels)
        with self._lock:
            if self._sketch is not None:
                # no exact current value to read back past the budget:
                # treat the delta as the observation (no budgeted family
                # in this repo uses gauge inc/dec)
                self._observe_collapsed(key, float(amount),
                                        cumulative=False)
                return
            self._values[key] = self._values.get(key, 0.0) + amount
            if self._budget and len(self._values) > self._budget:
                self._collapse_locked()

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # key -> [per-bucket counts..., +Inf count, sum]
        self._values: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        key = self._key(labels)
        value = float(value)
        with self._lock:
            cells = self._values.get(key)
            if cells is None:
                cells = self._values[key] = [0.0] * (len(self.buckets) + 2)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    cells[i] += 1
            cells[-2] += 1  # +Inf
            cells[-1] += value

    def count(self, **labels) -> float:
        with self._lock:
            cells = self._values.get(self._key(labels))
            return cells[-2] if cells else 0.0

    def sum(self, **labels) -> float:
        with self._lock:
            cells = self._values.get(self._key(labels))
            return cells[-1] if cells else 0.0

    def _render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._values.items())
        for key, cells in items:
            for bound, count in zip(self.buckets, cells):
                series = self._series_with(key, ("le", _format_value(bound)))
                out.append(f"{self.name}_bucket{series} "
                           f"{_format_value(count)}")
            series = self._series_with(key, ("le", "+Inf"))
            out.append(f"{self.name}_bucket{series} "
                       f"{_format_value(cells[-2])}")
            base = self._series(key)[len(self.name):]
            out.append(f"{self.name}_sum{base} {_format_value(cells[-1])}")
            out.append(f"{self.name}_count{base} {_format_value(cells[-2])}")

    def _series_with(self, key: Tuple[str, ...],
                     extra: Tuple[str, str]) -> str:
        pairs = [f'{k}="{_escape(v)}"' for k, v in zip(self.labelnames, key)]
        pairs.append(f'{extra[0]}="{_escape(extra[1])}"')
        return "{" + ",".join(pairs) + "}"

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()


class Registry:
    """Named metric families; idempotent registration (a second
    ``counter()`` call with the same name returns the first family, so
    module-level instrumentation never double-registers)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, _Metric]" = {}
        self.enabled = True
        self._budget = 0

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], budget_label: str = "",
                       **kwargs) -> _Metric:
        if budget_label and budget_label not in labelnames:
            raise ValueError(
                f"{name}: budget_label {budget_label!r} is not one of the "
                f"labels {tuple(labelnames)}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                        existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}")
                if budget_label and not existing.budget_label:
                    existing.budget_label = budget_label
                    existing._budget = self._budget
                return existing
            metric = cls(self, name, help, labelnames, **kwargs)
            if budget_label:
                metric.budget_label = budget_label
                metric._budget = self._budget
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                budget_label: str = "") -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   budget_label=budget_label)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              budget_label: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames,
                                   budget_label=budget_label)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        """An already-registered family by name (alert rules and the
        describe() digest columns read through this), or None."""
        with self._lock:
            return self._metrics.get(name)

    # -- cardinality budget (docs/OBSERVABILITY.md "Telemetry at scale") --

    def set_cardinality_budget(self, budget: int) -> None:
        """Arm (or re-arm) the per-family series budget on every family
        registered with a ``budget_label``. 0 disarms — but an already-
        collapsed family stays collapsed (exact series cannot be
        reconstructed from a sketch; ``reset()`` clears it)."""
        budget = max(0, int(budget))
        with self._lock:
            self._budget = budget
            families = [m for m in self._metrics.values() if m.budget_label]
        for family in families:
            with family._lock:
                family._budget = budget
                over = (budget and family._sketch is None
                        and len(family._values) > budget)
                if over:
                    family._collapse_locked()

    def cardinality_budget(self) -> int:
        return self._budget

    def budget_families(self) -> List[_Metric]:
        """Every family registered with a budget label (the per-learner
        set the central ``telemetry.prune_learner`` helper prunes)."""
        with self._lock:
            return [m for m in self._metrics.values() if m.budget_label]

    def prune_label_value(self, value: str) -> None:
        """Drop every series carrying ``value`` in its budget label
        across all budgeted families — the one call leave() needs."""
        for family in self.budget_families():
            family.prune_label_value(value)

    def budget_state(self) -> Dict[str, Dict]:
        """Serialized sketches of every collapsed family (checkpoint
        payload: O(budget) bytes however large the fleet; empty dict
        when nothing has collapsed)."""
        state: Dict[str, Dict] = {}
        for family in self.budget_families():
            data = family.budget_state()
            if data is not None:
                state[family.name] = data
        return state

    def restore_budget_state(self, state: Dict[str, Dict]) -> None:
        """Rehydrate collapsed families from a checkpoint (``--resume``:
        digests survive a controller crash). Families not registered in
        this process are skipped."""
        for name, data in (state or {}).items():
            family = self.get(name)
            if family is not None and family.budget_label:
                family.restore_budget_state(data)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        out: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for metric in metrics:
            body: List[str] = []
            metric._render(body)
            if not body:
                continue
            if metric.help:
                out.append(f"# HELP {metric.name} "
                           f"{metric.help.replace(chr(10), ' ')}")
            out.append(f"# TYPE {metric.name} {metric.kind}")
            out.extend(body)
        return "\n".join(out) + ("\n" if out else "")

    def reset(self) -> None:
        """Zero every series and disarm the cardinality budget (tests);
        families stay registered so module-level instrument handles
        keep working."""
        with self._lock:
            self._budget = 0
            metrics = list(self._metrics.values())
        for metric in metrics:
            metric._reset()
            if metric.budget_label:
                with metric._lock:
                    metric._budget = 0


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def set_enabled(value: bool) -> None:
    _REGISTRY.enabled = bool(value)


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse a text exposition into ``{series_name: {labels: value}}``
    (labels as a sorted tuple of (key, value) pairs). Raises ValueError
    on malformed lines — the scrape-compatibility check tests lean on.
    """
    series: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, rest = _parse_series(line, lineno)
        parts = rest.split()
        if not parts:
            raise ValueError(f"line {lineno}: missing value: {line!r}")
        raw = parts[0]
        if raw == "+Inf":
            value = math.inf
        elif raw == "-Inf":
            value = -math.inf
        else:
            try:
                value = float(raw)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: bad value {raw!r}") from None
        series.setdefault(name, {})[labels] = value
    return series


def _parse_series(line: str, lineno: int):
    brace = line.find("{")
    if brace < 0:
        name, _, rest = line.partition(" ")
        if not name or not rest:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        return name, (), rest
    name = line[:brace]
    end = line.find("}", brace)
    if end < 0 or not name:
        raise ValueError(f"line {lineno}: malformed labels: {line!r}")
    labels: List[Tuple[str, str]] = []
    body = line[brace + 1:end]
    pos = 0
    while pos < len(body):
        eq = body.find("=", pos)
        if eq < 0 or body[eq + 1:eq + 2] != '"':
            raise ValueError(f"line {lineno}: malformed labels: {line!r}")
        key = body[pos:eq].strip().lstrip(",").strip()
        pos = eq + 2
        value = []
        while pos < len(body):
            ch = body[pos]
            if ch == "\\":
                esc = body[pos + 1:pos + 2]
                value.append({"n": "\n", '"': '"', "\\": "\\"}.get(esc, esc))
                pos += 2
                continue
            if ch == '"':
                pos += 1
                break
            value.append(ch)
            pos += 1
        else:
            raise ValueError(f"line {lineno}: unterminated label: {line!r}")
        labels.append((key, "".join(value)))
    return name, tuple(sorted(labels)), line[end + 1:].strip()
