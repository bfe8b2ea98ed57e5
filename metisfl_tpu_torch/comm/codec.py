"""Self-describing binary codec for federation messages.

The port's copy of the JAX package's ``comm/codec.py``. A small tagged
format: values are ``None``, bools, signed 64-bit ints (zigzag varint),
float64, utf-8 strings, bytes, lists and string-keyed dicts; numpy scalars
encode as the Python value they hold. Bulk tensors never pass through it:
they travel as ModelBlob bytes (``tensor/pytree.py``) in ``bytes`` fields.
The bytes equal the JAX codec's for every value, so processes of either
package read each other's messages.

Not ported: the codec's metrics, trace events and per-learner attribution
(ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

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
    _encode(out, value)
    return bytes(out)


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
    view = memoryview(buf)
    value, offset = _decode(view, 0)
    if offset != len(view):
        raise ValueError(
            f"codec: {len(view) - offset} trailing byte(s) after value")
    return value
