"""Federation-wide trace spans with a process-local JSONL sink.

A span is a named, timed interval with a trace id shared by every span in
one logical operation (a federation round), a span id of its own, and its
parent's span id — enough to stitch controller → learner → aggregation
into one tree after the fact (rooted at the controller's round span; the
driver collects the sink files rather than opening spans). Spans are:

- cheap: ids are ``os.urandom`` hex, timestamps are ``time.time()``/
  ``perf_counter``; a disabled tracer hands out one shared no-op span;
- cross-thread: the active span context lives in a ``contextvars``
  variable for same-thread nesting, and is passed EXPLICITLY wherever work
  hops threads (the controller's scheduling executor, the learner's train
  thread) — never inferred across a pool boundary;
- cross-process: :func:`outbound_metadata` / :func:`extract` carry the
  context over gRPC metadata (key ``metisfl-trace-ctx``) in a
  W3C-traceparent-style frame (``00-<trace_id>-<span_id>-01``), so a
  learner's train span parents under the controller round span that
  dispatched it;
- deterministic at the root: the controller derives the round trace id
  from its round serial (:func:`round_trace_id`) and serving clients
  derive theirs from the request id (:func:`request_trace_id`), so the
  causal analyzer (telemetry/causal.py) can name a round's or request's
  trace without a join table.

Finished spans append one JSON line to ``<dir>/<service>-<pid>.jsonl``
(per-process file: concurrent federation processes on one host must not
interleave writes). ``python -m metisfl_tpu_torch.telemetry`` renders the tree.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

METADATA_KEY = "metisfl-trace-ctx"

_CURRENT: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("metisfl_tpu_trace_ctx", default=None)

# sentinel: "parent not given — use the calling context's active span"
_USE_CURRENT = object()


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: enough to parent children
    anywhere — another thread, another process, another host."""

    trace_id: str
    span_id: str

    def to_wire(self) -> str:
        # W3C-traceparent framing: version 00, sampled flag 01. Trace and
        # span ids are hex (never contain "-"), so the frame splits
        # unambiguously.
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_wire(cls, value: str) -> Optional["SpanContext"]:
        parts = value.split("-")
        if len(parts) == 4:
            _version, trace_id, span_id, _flags = parts
            if trace_id and span_id:
                return cls(trace_id=trace_id, span_id=span_id)
            return None
        # pre-traceparent peers framed the context as "trace/span" —
        # tolerated so a mixed-version fleet keeps stitching
        trace_id, sep, span_id = value.partition("/")
        if not sep or not trace_id or not span_id:
            return None
        return cls(trace_id=trace_id, span_id=span_id)


def round_trace_id(serial: int) -> str:
    """Deterministic 32-hex trace id for one federation round dispatch:
    the controller's round serial, zero-extended. Every hop the round
    causes — dispatch, train, uplink, ingest, slice fold, finalize —
    shares it, so ``perf --critical-path --round N`` selects the round's
    causal tree by id, not by timestamp heuristics."""
    return f"{int(serial) & ((1 << 128) - 1):032x}"


def request_trace_id(request_id: str) -> str:
    """Deterministic 32-hex trace id for one serving request (router →
    replica → decode-slot chain), derived from the request id. The raw
    request id travels as a span attribute; the hash keeps the trace id
    fixed-width for arbitrary caller-chosen ids."""
    digest = hashlib.sha256(b"metisfl-req:"
                            + str(request_id).encode("utf-8", "replace"))
    return digest.hexdigest()[:32]


class Span:
    """A timed interval. Use as a context manager, or call :meth:`end`
    explicitly for spans that outlive one scope (the controller's round
    span stays open across many scheduling-executor invocations)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "start", "_t0", "_duration_ms", "_tracer", "__weakref__")

    def __init__(self, tracer: "_Tracer", name: str,
                 parent: Optional[SpanContext],
                 attrs: Optional[Dict[str, Any]] = None,
                 trace_id: Optional[str] = None):
        self.name = name
        # a parent's trace wins; an explicit trace_id names a NEW root
        # trace deterministically (round serial / serving request id)
        self.trace_id = (parent.trace_id if parent
                         else (trace_id or os.urandom(16).hex()))
        self.span_id = os.urandom(8).hex()
        self.parent_id = parent.span_id if parent else ""
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.start = time.time()
        self._t0 = time.perf_counter()
        self._duration_ms: Optional[float] = None
        self._tracer = tracer

    # -- identity ---------------------------------------------------------
    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    @property
    def duration_ms(self) -> float:
        """Elapsed so far, or the final duration once ended."""
        if self._duration_ms is not None:
            return self._duration_ms
        return (time.perf_counter() - self._t0) * 1e3

    # -- mutation ---------------------------------------------------------
    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self) -> float:
        """Finish the span (idempotent) and write it to the sink."""
        if self._duration_ms is None:
            self._duration_ms = (time.perf_counter() - self._t0) * 1e3
            self._tracer._closed(self)
            self._tracer._record(self)
        return self._duration_ms

    # -- scoping ----------------------------------------------------------
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = f"{type(exc).__name__}: {exc}"
        self.end()

    @contextlib.contextmanager
    def activate(self):
        """Make this span the calling context's active span, so nested
        ``span()`` calls and outbound RPCs parent under it."""
        token = _CURRENT.set(self.context())
        try:
            yield self
        finally:
            _CURRENT.reset(token)


class _NullSpan:
    """Disabled-tracer span: no ids, no sink, no context propagation —
    but it still MEASURES, because span durations are authoritative for
    lineage fields (RoundMetadata aggregation/phase timings) that the
    pre-telemetry code always recorded. Opting telemetry out must not
    zero ``experiment.json`` timings."""

    __slots__ = ("_t0", "_duration_ms")
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = ""
    attrs: Dict[str, Any] = {}

    def __init__(self):
        self._t0 = time.perf_counter()
        self._duration_ms: Optional[float] = None

    @property
    def duration_ms(self) -> float:
        if self._duration_ms is not None:
            return self._duration_ms
        return (time.perf_counter() - self._t0) * 1e3

    def context(self) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def end(self) -> float:
        if self._duration_ms is None:
            self._duration_ms = (time.perf_counter() - self._t0) * 1e3
        return self._duration_ms

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end()

    @contextlib.contextmanager
    def activate(self):
        yield self


class _Tracer:
    def __init__(self):
        self.enabled = True
        self.service = ""
        self.dir = ""
        self._path = ""
        self._fh = None
        self._lock = threading.Lock()
        # live (un-ended) spans, weakly held so an abandoned span can
        # still be collected: the flight recorder's "what was open when
        # the process died" snapshot (telemetry/postmortem.py)
        self._open: "Dict[int, Any]" = {}

    def _opened(self, span: "Span") -> None:
        import weakref
        with self._lock:
            # Bound dead-ref growth from spans abandoned without end():
            # no weakref GC callback (it could re-enter this non-reentrant
            # lock from a collection triggered while holding it), so prune
            # lazily once the map grows past a generous live-span count.
            if len(self._open) > 512:
                self._open = {k: r for k, r in self._open.items()
                              if r() is not None}
            self._open[id(span)] = weakref.ref(span)

    def _closed(self, span: "Span") -> None:
        with self._lock:
            self._open.pop(id(span), None)

    def open_spans(self) -> list:
        """Snapshot of live spans as records (ages keep ticking — the
        caller sees elapsed-so-far durations). Also prunes entries whose
        span was garbage-collected without ``end()``."""
        out = []
        with self._lock:
            dead = [k for k, r in self._open.items() if r() is None]
            for k in dead:
                del self._open[k]
            refs = list(self._open.values())
        for ref in refs:
            span = ref()
            if span is None or span._duration_ms is not None:
                continue
            record = {
                "trace": span.trace_id,
                "span": span.span_id,
                "parent": span.parent_id,
                "name": span.name,
                "service": self.service,
                "start": round(span.start, 6),
                "open_ms": round(span.duration_ms, 3),
            }
            if span.attrs:
                record["attrs"] = dict(span.attrs)
            out.append(record)
        out.sort(key=lambda r: r["start"])
        return out

    def configure(self, enabled: bool = True, service: str = "",
                  dir: str = "") -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:  # pragma: no cover - close never critical
                    pass
                self._fh = None
            self.enabled = bool(enabled)
            self.service = service or self.service or "proc"
            self.dir = dir
            self._path = ""
            self._open.clear()  # a reconfigure starts a fresh lifetime
            if enabled and dir:
                try:
                    os.makedirs(dir, exist_ok=True)
                except OSError as exc:
                    # an uncreatable sink dir (remote learner with the
                    # driver's local path, read-only mount) must degrade
                    # to unpersisted spans, not kill the process
                    import logging
                    logging.getLogger("metisfl_tpu_torch.telemetry").warning(
                        "trace sink dir %r not creatable (%s); spans "
                        "will not be persisted", dir, exc)
                    return
                self._path = os.path.join(
                    dir, f"{self.service}-{os.getpid()}.jsonl")

    def _record(self, span: Span) -> None:
        if not self._path:
            return
        record = {
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "name": span.name,
            "service": self.service,
            "pid": os.getpid(),
            "start": round(span.start, 6),
            "dur_ms": round(span._duration_ms or 0.0, 3),
        }
        if span.attrs:
            record["attrs"] = dict(span.attrs)
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    if not self._path:
                        return
                    self._fh = open(self._path, "a", buffering=1)
                self._fh.write(line)
            except OSError:
                # a torn sink (deleted dir, full disk) must never take a
                # traced code path down with it — stop persisting
                self._path = ""
                self._fh = None

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()


_TRACER = _Tracer()


def configure(enabled: bool = True, service: str = "", dir: str = "") -> None:
    """(Re)configure the process tracer. ``dir=""`` keeps spans in-memory
    only (ids and durations still work — instrumentation that feeds
    RoundMetadata does not need a sink)."""
    _TRACER.configure(enabled=enabled, service=service, dir=dir)


def set_enabled(value: bool) -> None:
    """Flip tracing on/off while keeping the configured service + sink
    dir (a disabled tracer remembers where it was writing)."""
    _TRACER.configure(enabled=value, service=_TRACER.service,
                      dir=_TRACER.dir)


def flush() -> None:
    _TRACER.flush()


def trace_path() -> str:
    """The JSONL file this process appends spans to ('' = no sink)."""
    return _TRACER._path


def open_spans() -> list:
    """Live (un-ended) spans as records — the flight recorder's
    "what was in flight" snapshot (telemetry/postmortem.py)."""
    return _TRACER.open_spans()


def span(name: str, parent: Any = _USE_CURRENT,
         attrs: Optional[Dict[str, Any]] = None,
         trace_id: Optional[str] = None):
    """Open a span. ``parent``: omitted → the calling context's active
    span; ``None`` → a new root trace; a :class:`Span` or
    :class:`SpanContext` → explicit parent (the cross-thread form).
    ``trace_id`` names a root trace deterministically (ignored when a
    parent supplies one)."""
    if not _TRACER.enabled:
        return _NullSpan()
    if parent is _USE_CURRENT:
        parent = _CURRENT.get()
    elif isinstance(parent, (Span, _NullSpan)):
        parent = parent.context()
    sp = Span(_TRACER, name, parent, attrs, trace_id=trace_id)
    # only factory-made spans are tracked as open: event() spans below are
    # born already-finished and must never show up in open_spans()
    _TRACER._opened(sp)
    return sp


def event(name: str, duration_s: float, parent: Any = _USE_CURRENT,
          attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-measured interval as a completed span (for call
    sites that timed themselves, e.g. the codec hot path)."""
    if not _TRACER.enabled:
        return
    if parent is _USE_CURRENT:
        parent = _CURRENT.get()
    elif isinstance(parent, (Span, _NullSpan)):
        parent = parent.context()
    sp = Span(_TRACER, name, parent, attrs)
    sp.start = time.time() - duration_s
    sp._duration_ms = duration_s * 1e3
    _TRACER._record(sp)


def current_context() -> Optional[SpanContext]:
    if not _TRACER.enabled:
        return None
    return _CURRENT.get()


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]):
    """Activate an explicit (e.g. wire-extracted) context."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def outbound_metadata() -> Optional[Tuple[Tuple[str, str], ...]]:
    """gRPC metadata carrying the active span context (None when there is
    nothing to propagate — grpc treats ``metadata=None`` as absent)."""
    ctx = current_context()
    if ctx is None:
        return None
    return ((METADATA_KEY, ctx.to_wire()),)


def extract(metadata: Optional[Iterable]) -> Optional[SpanContext]:
    """Span context from gRPC invocation metadata (None when absent)."""
    if not metadata:
        return None
    for item in metadata:
        key = getattr(item, "key", None) or (item[0] if item else None)
        if key == METADATA_KEY:
            value = getattr(item, "value", None) or item[1]
            return SpanContext.from_wire(str(value))
    return None
