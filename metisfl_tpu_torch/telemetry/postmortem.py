"""Flight recorder: post-mortem bundles for crashed federation processes
(the port's copy of the JAX package's ``telemetry/postmortem.py``, with
the same bundle schema; the profiler, runtime and alert sections of the
JAX bundle are not ported yet, ROADMAP.md Queue 1 item 4b).

Failover recovers from a controller crash but leaves no record of
what the process was *doing* when it died — the round that was in
flight, the tasks that were dispatched, the spans that never closed.
This module dumps exactly that, as one JSON bundle per incident, into a
directory the driver defaults to ``<workdir>/postmortem/``:

- the event-journal ring tail (:mod:`metisfl_tpu_torch.telemetry.events`) —
  the pre-crash timeline;
- the metrics registry's text exposition — a last scrape nobody got;
- the still-open trace spans (a round span with no end IS the smoking
  gun for "died mid-round");
- process identity (service, pid, reason, wall-clock) and the federation
  config hash, so bundles from different incarnations are tellable apart.

Bundles are written on: an unhandled exception (``sys.excepthook`` +
``threading.excepthook``, installed by :func:`configure`), a chaos
``kill`` (the injector dumps before ``os._exit``), and a driver-side
failover relaunch (the driver dumps its own bundle as it restarts the
controller). Render them with
``python -m metisfl_tpu_torch.telemetry --postmortem <dir>``.

Everything here is best-effort by construction: a flight recorder that
can crash the plane is worse than none, so :func:`dump` never raises.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("metisfl_tpu_torch.telemetry")

SCHEMA_VERSION = 1


class _Recorder:
    def __init__(self):
        self.dir = ""
        self.service = ""
        self.config_hash = ""
        self._lock = threading.Lock()
        self._seq = 0
        self._hooks_installed = False
        self._dumping = False

    def configure(self, dir: str, service: str = "",
                  config_hash: str = "", install_hooks: bool = True) -> None:
        self.dir = dir or ""
        self.service = service or self.service or "proc"
        self.config_hash = config_hash or self.config_hash
        if self.dir:
            try:
                os.makedirs(self.dir, exist_ok=True)
            except OSError as exc:
                logger.warning("postmortem dir %r not creatable (%s); "
                               "flight recorder disabled", dir, exc)
                self.dir = ""
                return
            if install_hooks:
                self._install_hooks()

    def _install_hooks(self) -> None:
        """Wrap the unhandled-exception hooks (idempotent): dump a bundle,
        then delegate to whatever hook was installed before us."""
        with self._lock:
            if self._hooks_installed:
                return
            self._hooks_installed = True
        prev_sys = sys.excepthook
        prev_thread = threading.excepthook

        def _sys_hook(exc_type, exc, tb):
            self.dump(f"crash_{exc_type.__name__}",
                      extra={"error": f"{exc_type.__name__}: {exc}"})
            prev_sys(exc_type, exc, tb)

        def _thread_hook(args):
            if args.exc_type is not SystemExit:
                self.dump(f"crash_{args.exc_type.__name__}",
                          extra={"error": f"{args.exc_type.__name__}: "
                                          f"{args.exc_value}",
                                 "thread": getattr(args.thread, "name", "?")})
            prev_thread(args)

        sys.excepthook = _sys_hook
        threading.excepthook = _thread_hook

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Write one bundle; returns its path, or None when unconfigured
        or the write failed. Never raises; re-entrancy-guarded (a dump
        that crashes must not recurse through the excepthook)."""
        if not self.dir:
            return None
        with self._lock:
            if self._dumping:
                return None
            self._dumping = True
            self._seq += 1
            seq = self._seq
        try:
            return self._write(reason, seq, extra)
        except Exception:  # noqa: BLE001 - best-effort by contract
            logger.exception("postmortem dump failed")
            return None
        finally:
            with self._lock:
                self._dumping = False

    def _write(self, reason: str, seq: int,
               extra: Optional[Dict[str, Any]]) -> str:
        from metisfl_tpu_torch.telemetry import events as _events
        from metisfl_tpu_torch.telemetry import metrics as _metrics
        from metisfl_tpu_torch.telemetry import trace as _trace

        bundle: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "service": self.service,
            "pid": os.getpid(),
            "reason": reason,
            "time": round(time.time(), 6),
            "config_hash": self.config_hash,
            "events": _events.tail(),
            "open_spans": _trace.open_spans(),
            "metrics": _metrics.registry().render(),
        }
        try:
            # latest RoundProfile tail (performance observatory): where
            # the last rounds' time and bytes went, readable post-crash
            from metisfl_tpu_torch.telemetry import profile as _profile

            profiles = _profile.tail(3)
            if profiles:
                bundle["profiles"] = profiles
        except Exception:  # noqa: BLE001 - best-effort by contract
            pass
        if extra:
            bundle["extra"] = extra
        safe_reason = "".join(c if (c.isalnum() or c in "_-") else "_"
                              for c in reason)[:64]
        name = f"{self.service}-{os.getpid()}-{seq}-{safe_reason}.json"
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)  # atomic: never a torn bundle
        # the bundle snapshots the ring; flush the sinks too so the JSONL
        # files agree with the last thing the recorder saw
        _events.flush()
        _trace.flush()
        logger.warning("post-mortem bundle written: %s (reason=%s)",
                       path, reason)
        return path


_RECORDER = _Recorder()


def configure(dir: str, service: str = "", config_hash: str = "",
              install_hooks: bool = True) -> None:
    """Arm the flight recorder for this process. ``install_hooks`` wraps
    ``sys.excepthook``/``threading.excepthook`` so unhandled crashes dump
    automatically; chaos-kill and failover call :func:`dump` directly."""
    _RECORDER.configure(dir, service=service, config_hash=config_hash,
                        install_hooks=install_hooks)


def dump(reason: str, extra: Optional[Dict[str, Any]] = None
         ) -> Optional[str]:
    return _RECORDER.dump(reason, extra=extra)


def armed() -> bool:
    return bool(_RECORDER.dir)


def recorder_dir() -> str:
    return _RECORDER.dir


def load_bundles(paths: List[str]) -> List[dict]:
    """Bundle dicts from explicit .json files and/or directories of them
    (unreadable/foreign files are skipped — a postmortem dir may hold a
    half-written .tmp from the crash itself)."""
    import glob as _glob

    bundles: List[dict] = []
    for path in paths:
        files = (sorted(_glob.glob(os.path.join(path, "*.json")))
                 if os.path.isdir(path) else [path])
        for name in files:
            try:
                with open(name) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(data, dict) and data.get("schema"):
                data["_path"] = name
                bundles.append(data)
    bundles.sort(key=lambda b: b.get("time", 0.0))
    return bundles
