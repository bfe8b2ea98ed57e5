"""Self-describing binary codec for federation messages.

The port's copy of the JAX package's ``comm/codec.py``. A small tagged
format: values are ``None``, bools, signed 64-bit ints (zigzag varint),
float64, utf-8 strings, bytes, lists and string-keyed dicts; numpy scalars
encode as the Python value they hold. Bulk tensors never pass through it:
they travel as ModelBlob bytes (``tensor/pytree.py``) in ``bytes`` fields.
The bytes equal the JAX codec's for every value, so processes of either
package read each other's messages.

Telemetry (the JAX package's): encode/decode duration and byte metrics, a
trace event for payloads of 256 KiB and more, and per-learner attribution
(``attributed``/``attribute``) that the controller's cost profiles diff
per round.
"""

from __future__ import annotations

import contextlib
import contextvars
import struct
import threading
import time
from typing import Any, Dict, Tuple

import numpy as np

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import trace as _ttrace

# codec hot-path telemetry: histograms always (cheap), spans only for
# payloads big enough to matter in a round trace — every tiny ack would
# otherwise flood the JSONL sink
_M_CODEC = _tmetrics.registry().histogram(
    _tel.M_CODEC_DURATION_SECONDS, "Message codec encode/decode time", ("op",))
_M_CODEC_BYTES = _tmetrics.registry().counter(
    _tel.M_CODEC_BYTES_TOTAL, "Message codec bytes by operation", ("op",))
_SPAN_MIN_BYTES = 1 << 18

# Per-learner codec attribution (performance observatory): call sites
# that know which learner a message belongs to wrap the encode in
# ``attributed(learner_id)`` (or report a self-timed decode via
# ``attribute``), and the time lands in a labeled counter + the process
# totals the profile collector diffs per round. Series are pruned on
# learner leave (``prune_attribution``) — bounded cardinality under
# churn, the same posture as the controller's per-learner gauges.
_M_CODEC_LEARNER = _tmetrics.registry().counter(
    _tel.M_CODEC_LEARNER_SECONDS,
    "Codec encode/decode seconds attributed to one learner's messages",
    ("learner", "op"), budget_label="learner")
_ATTR: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "metisfl_tpu_torch_codec_attr", default="")
_ATTR_LOCK = threading.Lock()
_ATTR_TOTALS: Dict[Tuple[str, str], float] = {}


@contextlib.contextmanager
def attributed(learner_id: str):
    """Attribute every dumps/loads inside the block to ``learner_id``."""
    token = _ATTR.set(learner_id or "")
    try:
        yield
    finally:
        _ATTR.reset(token)


def attribute(learner_id: str, op: str, seconds: float) -> None:
    """Record codec time for a learner's message (post-hoc form, for
    decode sites that only learn the learner id FROM the decode)."""
    if not learner_id or not _tmetrics.enabled():
        return
    _M_CODEC_LEARNER.inc(seconds, learner=learner_id, op=op)
    with _ATTR_LOCK:
        key = (learner_id, op)
        _ATTR_TOTALS[key] = _ATTR_TOTALS.get(key, 0.0) + seconds


def attributed_totals() -> Dict[Tuple[str, str], float]:
    """Cumulative attributed seconds ``{(learner_id, op): s}`` — the
    profile collector snapshots this per round and diffs."""
    with _ATTR_LOCK:
        return dict(_ATTR_TOTALS)


def prune_attribution(learner_id: str) -> None:
    for op in ("encode", "decode"):
        _M_CODEC_LEARNER.remove(learner=learner_id, op=op)
    with _ATTR_LOCK:
        for key in [k for k in _ATTR_TOTALS if k[0] == learner_id]:
            del _ATTR_TOTALS[key]


_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_DICT = 0x08

_INT64_MIN = -(2**63)
_INT64_MAX = 2**63 - 1

# nesting bound for the recursive decoder: crafted deep nesting must raise
# a ValueError at the wire boundary, not a RecursionError; real messages
# nest fewer than 10 levels
_MAX_DEPTH = 100


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _zigzag(value: int) -> int:
    if not _INT64_MIN <= value <= _INT64_MAX:
        raise OverflowError(f"codec ints are 64-bit; {value} out of range")
    return (value << 1) ^ (value >> 63) if value < 0 else value << 1


def _unzigzag(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _encode(out: bytearray, value: Any) -> None:
    if isinstance(value, np.generic):
        value = value.item()
    if value is None:
        out.append(_T_NONE)
    elif value is True:
        out.append(_T_TRUE)
    elif value is False:
        out.append(_T_FALSE)
    elif isinstance(value, int):
        out.append(_T_INT)
        _write_varint(out, _zigzag(value))
    elif isinstance(value, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack("<d", value))
    elif isinstance(value, str):
        encoded = value.encode("utf-8")
        out.append(_T_STR)
        _write_varint(out, len(encoded))
        out.extend(encoded)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        if isinstance(value, memoryview) and (value.itemsize != 1
                                              or value.ndim != 1):
            value = bytes(value)  # measure and copy bytes, not elements
        out.append(_T_BYTES)
        _write_varint(out, len(value))
        out.extend(value)
    elif isinstance(value, (list, tuple)):
        out.append(_T_LIST)
        _write_varint(out, len(value))
        for item in value:
            _encode(out, item)
    elif isinstance(value, dict):
        out.append(_T_DICT)
        _write_varint(out, len(value))
        for key, item in value.items():
            if not isinstance(key, str):
                raise TypeError(f"dict keys must be str, got {type(key)!r}")
            encoded = key.encode("utf-8")
            _write_varint(out, len(encoded))
            out.extend(encoded)
            _encode(out, item)
    else:
        raise TypeError(f"codec cannot encode {type(value)!r}")


def dumps(value: Any) -> bytes:
    out = bytearray()
    if not _tmetrics.enabled():
        _encode(out, value)
        return bytes(out)
    t0 = time.perf_counter()
    _encode(out, value)
    buf = bytes(out)
    elapsed = time.perf_counter() - t0
    _M_CODEC.observe(elapsed, op="encode")
    _M_CODEC_BYTES.inc(len(buf), op="encode")
    lid = _ATTR.get()
    if lid:
        attribute(lid, "encode", elapsed)
    if len(buf) >= _SPAN_MIN_BYTES:
        _ttrace.event("codec.encode", elapsed, attrs={"bytes": len(buf)})
    return buf


def _read_varint(view: memoryview, offset: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if offset >= len(view):
            raise ValueError("codec: truncated varint")
        if shift > 63:
            raise ValueError("codec: varint exceeds 64 bits")
        byte = view[offset]
        offset += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            if result > 0xFFFFFFFFFFFFFFFF:
                raise ValueError("codec: varint exceeds 64 bits")
            return result, offset
        shift += 7


def _take(view: memoryview, offset: int, length: int
          ) -> tuple[memoryview, int]:
    end = offset + length
    if end > len(view):
        raise ValueError(
            f"codec: truncated buffer (need {end} bytes, have {len(view)})")
    return view[offset:end], end


def _decode(view: memoryview, offset: int, depth: int = 0
            ) -> tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise ValueError(f"codec: nesting exceeds {_MAX_DEPTH} levels")
    if offset >= len(view):
        raise ValueError("codec: truncated buffer (empty value)")
    tag = view[offset]
    offset += 1
    if tag == _T_NONE:
        return None, offset
    if tag == _T_TRUE:
        return True, offset
    if tag == _T_FALSE:
        return False, offset
    if tag == _T_INT:
        raw, offset = _read_varint(view, offset)
        return _unzigzag(raw), offset
    if tag == _T_FLOAT:
        raw, offset = _take(view, offset, 8)
        return struct.unpack("<d", raw)[0], offset
    if tag in (_T_STR, _T_BYTES):
        length, offset = _read_varint(view, offset)
        raw, offset = _take(view, offset, length)
        return (bytes(raw).decode("utf-8") if tag == _T_STR
                else bytes(raw)), offset
    if tag == _T_LIST:
        length, offset = _read_varint(view, offset)
        items = []
        for _ in range(length):
            item, offset = _decode(view, offset, depth + 1)
            items.append(item)
        return items, offset
    if tag == _T_DICT:
        length, offset = _read_varint(view, offset)
        result = {}
        for _ in range(length):
            klen, offset = _read_varint(view, offset)
            raw, offset = _take(view, offset, klen)
            key = bytes(raw).decode("utf-8")
            result[key], offset = _decode(view, offset, depth + 1)
        return result, offset
    raise ValueError(f"codec: unknown tag 0x{tag:02x} at offset {offset - 1}")


def loads(buf) -> Any:
    """Decode one value; trailing bytes are a framing error and raise."""
    if not _tmetrics.enabled():
        return _loads(buf)
    t0 = time.perf_counter()
    value = _loads(buf)
    elapsed = time.perf_counter() - t0
    nbytes = memoryview(buf).nbytes
    _M_CODEC.observe(elapsed, op="decode")
    _M_CODEC_BYTES.inc(nbytes, op="decode")
    lid = _ATTR.get()
    if lid:
        attribute(lid, "decode", elapsed)
    if nbytes >= _SPAN_MIN_BYTES:
        _ttrace.event("codec.decode", elapsed, attrs={"bytes": nbytes})
    return value


def _loads(buf) -> Any:
    view = memoryview(buf)
    value, offset = _decode(view, 0)
    if offset != len(view):
        raise ValueError(
            f"codec: {len(view) - offset} trailing byte(s) after value")
    return value
