"""Seeded fault injector wired into the RPC transport.

The port's copy of the JAX package's ``chaos/injector.py``: the same spec,
the same env var and the same seeded decisions, so one spec and seed fire
the same faults in either package's processes. One
:class:`ChaosInjector` per process, installed through :func:`configure`
or the ``METISFL_TPU_CHAOS`` env var. ``comm/rpc.py`` calls :func:`get`
on every client call and server handler; with no injector that is one
attribute read and an ``is None`` check.

A spec is plain JSON::

    {"seed": 7, "rules": [
        {"fault": "kill", "side": "server", "method": "MarkTaskCompleted",
         "max_fires": 1},
        {"fault": "drop", "side": "client", "prob": 0.2},
        {"fault": "corrupt", "side": "client", "method": "MarkTaskCompleted",
         "after_calls": 2, "max_fires": 1}
    ]}

Faults:

- ``drop``: raise UNAVAILABLE without touching the wire.
- ``delay``: sleep ``delay_s``, then proceed.
- ``hang``: sleep ``delay_s`` (default 3600 s), then proceed; with the
  transport's deadline this surfaces as DEADLINE_EXCEEDED.
- ``corrupt``: flip 8 payload bytes from the middle on (the blob's
  integrity check must reject the result).
- ``kill``: ``os._exit(137)``, the crash-at-phase primitive.
- ``flap``: calls in the down window of each ``period_s`` cycle (its
  first ``down_s`` seconds, default half the period) raise UNAVAILABLE.
  The cycle anchors at the rule's first eligible call.
- ``slow``: the learner's train loop asks :meth:`ChaosInjector.
  train_slowdown` after each task and stretches its wall-clock by
  ``factor`` (default 2.0); inert on the RPC path.
- ``partition``: calls between ``after_s`` and ``after_s + window_s``
  (from the rule's first eligible call) raise UNAVAILABLE.

Every fire is logged, counted (``chaos_faults_injected_total``) and
journaled (``FaultInjected``); a ``kill`` first dumps the process's
post-mortem bundle (telemetry/postmortem.py, where the flight recorder is
armed).
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger("metisfl_tpu_torch.chaos")

_M_FAULTS = _tmetrics.registry().counter(
    _tel.M_CHAOS_FAULTS_INJECTED_TOTAL, "Faults fired by the chaos injector",
    ("fault", "side", "method"))

ENV_VAR = "METISFL_TPU_CHAOS"

_KILL_EXIT_CODE = 137  # looks like SIGKILL to the supervising driver


class FaultInjected(Exception):
    """An injected transport fault, shaped like a ``grpc.RpcError``
    (``code()``, ``details()``) so the client's retry loop and the
    server's abort path handle it as a real wire error."""

    def __init__(self, status: str, rule: "FaultRule"):
        super().__init__(f"chaos: injected {rule.fault} ({status})")
        self.status = status
        self.rule = rule

    def code(self):
        import grpc

        return grpc.StatusCode[self.status]

    def details(self) -> str:
        return str(self)


@dataclass
class FaultRule:
    """One fault site. Empty ``side``/``service``/``method`` match any;
    ``process`` routes the rule to a subprocess (``controller``,
    ``learner``, ``learner_<idx>``, ``slice``, ``slice_<idx>``) in the
    driver and is ignored by the injector itself."""

    fault: str                    # drop | delay | hang | corrupt | kill |
                                  # flap | slow | partition
    side: str = ""                # client | server | "" (both)
    service: str = ""
    method: str = ""
    process: str = ""
    prob: float = 1.0             # firing probability per eligible call
    after_calls: int = 0          # skip the first N matching calls
    max_fires: int = 0            # 0 = unlimited
    delay_s: float = 0.0          # delay/hang duration (hang: 0 → 3600)
    # flap: the cycle's length and its down window
    period_s: float = 0.0         # 0 → 10 s
    down_s: float = 0.0           # 0 → period_s / 2
    # partition: the window's offset and length from the first match
    after_s: float = 0.0
    window_s: float = 0.0         # 0 → 10 s
    # slow: the train wall-clock multiplier
    factor: float = 0.0           # 0 → 2.0
    # runtime counters (not part of the spec)
    matched: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)
    anchor: float = field(default=0.0, compare=False)  # first-match clock

    _FAULTS = ("drop", "delay", "hang", "corrupt", "kill",
               "flap", "slow", "partition")

    def __post_init__(self):
        if self.fault not in self._FAULTS:
            raise ValueError(
                f"unknown chaos fault {self.fault!r}; have {self._FAULTS}")

    def matches(self, side: str, service: str, method: str) -> bool:
        return ((not self.side or self.side == side)
                and (not self.service or self.service == service)
                and (not self.method or self.method == method))


class ChaosInjector:
    def __init__(self, seed: int = 0,
                 rules: Optional[List[FaultRule]] = None):
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules or [])
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: Dict) -> "ChaosInjector":
        known = {f for f in FaultRule.__dataclass_fields__
                 if f not in ("matched", "fired", "anchor")}
        rules = []
        for raw in spec.get("rules", []):
            unknown = set(raw) - known
            if unknown:
                raise ValueError(
                    f"chaos rule has unknown keys {sorted(unknown)}")
            rules.append(FaultRule(**raw))
        return cls(seed=spec.get("seed", 0), rules=rules)

    def intercept(self, side: str, service: str, method: str,
                  payload: bytes) -> bytes:
        """Run every matching rule against this call; returns the
        (possibly corrupted) payload, raises :class:`FaultInjected` on
        drop, flap and partition, sleeps on delay and hang, exits the
        process on kill."""
        for rule in self.rules:
            with self._lock:
                if rule.fault == "slow":
                    # inert here: the learner's train loop reads it
                    continue
                if not rule.matches(side, service, method):
                    continue
                rule.matched += 1
                if rule.matched <= rule.after_calls:
                    continue
                if rule.max_fires and rule.fired >= rule.max_fires:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                if rule.fault in ("flap", "partition"):
                    # windowed faults anchor at the rule's first eligible
                    # call; calls outside the down window pass and do not
                    # count as fires
                    now = time.monotonic()
                    if rule.anchor == 0.0:
                        rule.anchor = now
                    elapsed = now - rule.anchor
                    if rule.fault == "flap":
                        period = rule.period_s or 10.0
                        down = rule.down_s or period / 2.0
                        if (elapsed % period) >= down:
                            continue  # up phase
                    else:
                        start = rule.after_s
                        window = rule.window_s or 10.0
                        if not (start <= elapsed < start + window):
                            continue  # outside the partition window
                rule.fired += 1
            _M_FAULTS.inc(fault=rule.fault, side=side, method=method)
            _tevents.emit(_tevents.FaultInjected, fault=rule.fault,
                          side=side, method=method)
            logger.warning("chaos: firing %s on %s %s/%s (fire %d)",
                           rule.fault, side, service, method, rule.fired)
            if rule.fault == "kill":
                # the flight recorder first: the dying process's event ring
                # and open spans are the post-mortem this kill exists for
                from metisfl_tpu_torch.telemetry import postmortem
                postmortem.dump("chaos_kill",
                                extra={"method": method, "side": side})
                # flush the warning before dying: a diagnosable crash
                logging.shutdown()
                os._exit(_KILL_EXIT_CODE)
            if rule.fault in ("drop", "flap", "partition"):
                raise FaultInjected("UNAVAILABLE", rule)
            if rule.fault == "delay":
                time.sleep(rule.delay_s)
            elif rule.fault == "hang":
                time.sleep(rule.delay_s or 3600.0)
            elif rule.fault == "corrupt":
                payload = self._corrupt(payload)
        return payload

    def train_slowdown(self) -> float:
        """The train wall-clock multiplier of the armed ``slow`` rules (the
        learner's train loop calls this once per task and sleeps the extra
        time: a slow survivor, which only deadlines and quorum barriers
        defend against). 1.0 with no eligible rule; each application
        counts one fire toward the rule's ``max_fires``."""
        factor = 1.0
        for rule in self.rules:
            if rule.fault != "slow":
                continue
            with self._lock:
                rule.matched += 1
                if rule.matched <= rule.after_calls:
                    continue
                if rule.max_fires and rule.fired >= rule.max_fires:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.fired += 1
            _M_FAULTS.inc(fault="slow", side="learner", method="Train")
            _tevents.emit(_tevents.FaultInjected, fault="slow",
                          side="learner", method="Train")
            factor = max(factor, rule.factor or 2.0)
        if factor > 1.0:
            logger.warning("chaos: slowing train task by %.1fx", factor)
        return factor

    @staticmethod
    def _corrupt(payload: bytes) -> bytes:
        if not payload:
            return payload
        # byte flips past any header, so only a checksum (not a structural
        # parse error) can catch them
        start = len(payload) // 2
        buf = bytearray(payload)
        for i in range(start, min(start + 8, len(buf))):
            buf[i] ^= 0xFF
        return bytes(buf)

    def fired_total(self, fault: str = "") -> int:
        with self._lock:
            return sum(r.fired for r in self.rules
                       if not fault or r.fault == fault)


_INJECTOR: Optional[ChaosInjector] = None


def get() -> Optional[ChaosInjector]:
    return _INJECTOR


def configure(spec: Optional[Dict]) -> Optional[ChaosInjector]:
    """Install an injector from a spec dict (None uninstalls)."""
    global _INJECTOR
    _INJECTOR = None if spec is None else ChaosInjector.from_spec(spec)
    if _INJECTOR is not None:
        logger.warning("chaos injector ARMED (seed=%d, %d rule(s))",
                       _INJECTOR.seed, len(_INJECTOR.rules))
    return _INJECTOR


def reset() -> None:
    configure(None)


def install_from_env() -> Optional[ChaosInjector]:
    """Arm from ``METISFL_TPU_CHAOS`` (JSON, or ``@/path`` to a JSON
    file). Runs once when the module is imported, and the processes' entry
    points call it again at start."""
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    return configure(json.loads(raw))


install_from_env()
