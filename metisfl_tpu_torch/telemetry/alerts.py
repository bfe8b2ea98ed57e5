"""The alert-rule schema: :class:`AlertRule` and :func:`validate_rules`.

The port's copy of the schema half of the JAX package's
``telemetry/alerts.py``; the serving fleet's autoscaler
(serving/fleet.py) judges its ``scale_up``/``scale_down`` rules with it.
The alert engine that evaluates ``telemetry.alerts`` on a cadence is not
ported (ROADMAP.md Queue 1 item 4b), and the config refuses those rules.

Rule schema (one dict per rule, validated at config load: a typo'd rule
fails startup, not fire-time)::

    name: drop_burst              # unique; the rule's identity
    metric: learner_dropped_total # registry family name
    kind: rate                    # value | rate | quantile
    labels: {reason: quarantine}  # optional: one series; omitted = the
                                  #   sum across the family
    window_s: 30                  # rate: trailing window
    quantile: 0.99                # quantile: which one
    op: ">"                       # > >= < <=
    threshold: 0.5
    for_s: 5                      # the breach must HOLD this long
    resolve_ratio: 0.8            # hysteresis: a ">" alert resolves only
                                  #   below 0.8*threshold
    severity: warning             # info | warning | critical
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

_KINDS = ("value", "rate", "quantile")
_OPS = (">", ">=", "<", "<=")
_SEVERITIES = ("info", "warning", "critical")

@dataclass(frozen=True)
class AlertRule:
    """One validated alert rule (see module docstring for the schema)."""

    name: str
    metric: str
    threshold: float
    kind: str = "value"
    labels: Dict[str, str] = field(default_factory=dict)
    window_s: float = 60.0
    quantile: float = 0.99
    op: str = ">"
    for_s: float = 0.0
    resolve_ratio: float = 1.0
    severity: str = "warning"

    _FIELDS = ("name", "metric", "threshold", "kind", "labels", "window_s",
               "quantile", "op", "for_s", "resolve_ratio", "severity")

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "AlertRule":
        if not isinstance(spec, dict):
            raise ValueError(f"alert rule must be a mapping, got {spec!r}")
        unknown = set(spec) - set(cls._FIELDS)
        if unknown:
            raise ValueError(
                f"alert rule {spec.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)}")
        name = str(spec.get("name", "") or "")
        if not name:
            raise ValueError("alert rule needs a non-empty 'name'")
        metric = str(spec.get("metric", "") or "")
        if not metric:
            raise ValueError(f"alert rule {name!r} needs a 'metric'")
        if "threshold" not in spec:
            raise ValueError(f"alert rule {name!r} needs a 'threshold'")
        try:
            threshold = float(spec["threshold"])
        except (TypeError, ValueError):
            raise ValueError(
                f"alert rule {name!r}: threshold {spec['threshold']!r} "
                "is not a number") from None
        kind = str(spec.get("kind", "value"))
        if kind not in _KINDS:
            raise ValueError(
                f"alert rule {name!r}: kind {kind!r} not in {_KINDS}")
        op = str(spec.get("op", ">"))
        if op not in _OPS:
            raise ValueError(f"alert rule {name!r}: op {op!r} not in {_OPS}")
        labels = spec.get("labels") or {}
        if (not isinstance(labels, dict)
                or not all(isinstance(k, str) for k in labels)):
            raise ValueError(
                f"alert rule {name!r}: labels must be a string mapping")
        window_s = float(spec.get("window_s", 60.0))
        if kind == "rate" and window_s <= 0.0:
            raise ValueError(
                f"alert rule {name!r}: rate rules need window_s > 0")
        quantile = float(spec.get("quantile", 0.99))
        if not 0.0 < quantile <= 1.0:
            raise ValueError(
                f"alert rule {name!r}: quantile must be in (0, 1]")
        for_s = float(spec.get("for_s", 0.0))
        if for_s < 0.0:
            raise ValueError(f"alert rule {name!r}: for_s must be >= 0")
        resolve_ratio = float(spec.get("resolve_ratio", 1.0))
        if not 0.0 < resolve_ratio <= 1.0:
            raise ValueError(
                f"alert rule {name!r}: resolve_ratio must be in (0, 1] "
                "(1 = no hysteresis)")
        severity = str(spec.get("severity", "warning"))
        if severity not in _SEVERITIES:
            raise ValueError(
                f"alert rule {name!r}: severity {severity!r} not in "
                f"{_SEVERITIES}")
        return cls(name=name, metric=metric, threshold=threshold, kind=kind,
                   labels={str(k): str(v) for k, v in labels.items()},
                   window_s=window_s, quantile=quantile, op=op, for_s=for_s,
                   resolve_ratio=resolve_ratio, severity=severity)

    def series_key(self) -> str:
        if not self.labels:
            return self.metric
        pairs = ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
        return f"{self.metric}{{{pairs}}}"

    def breaches(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == ">=":
            return value >= self.threshold
        if self.op == "<":
            return value < self.threshold
        return value <= self.threshold

    def resolved(self, value: float) -> bool:
        """Hysteresis bound, margin-form so it stays monotone for zero
        and negative thresholds (a multiplicative bound would invert
        there and flap the alert every poll): the margin is
        ``(1 - resolve_ratio) * |threshold|``; a ">"-family alert
        resolves only below ``threshold - margin``, a "<"-family one
        only above ``threshold + margin``. For positive thresholds the
        ">" bound is exactly the familiar ``threshold * resolve_ratio``;
        ratio 1 (or threshold 0) = plain de-breach."""
        margin = abs(self.threshold) * (1.0 - self.resolve_ratio)
        if self.op in (">", ">="):
            return value < self.threshold - margin
        return value > self.threshold + margin

    def describe_expr(self) -> str:
        head = {"value": self.series_key(),
                "rate": f"rate({self.series_key()}[{self.window_s:g}s])",
                "quantile": f"q{self.quantile:g}({self.metric})"}[self.kind]
        return f"{head} {self.op} {self.threshold:g}"


def validate_rules(specs: List[Dict[str, Any]]) -> List[AlertRule]:
    """Parse + validate a config's rule list (duplicate names rejected —
    two rules sharing an identity would fight over one state machine)."""
    rules: List[AlertRule] = []
    seen = set()
    for spec in specs or []:
        rule = AlertRule.from_spec(spec)
        if rule.name in seen:
            raise ValueError(f"duplicate alert rule name {rule.name!r}")
        seen.add(rule.name)
        rules.append(rule)
    return rules
