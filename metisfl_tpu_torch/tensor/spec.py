"""Tensor wire format (the port's own copy of the JAX package's
``tensor/spec.py``, which cannot be imported without jax; the format is
byte for byte the same, so either package reads the other's blobs).

A tensor travels as ``(TensorSpec, bytes)``: a small header describing dtype,
shape and kind, plus the flattened little-endian row-major payload. This is
the capability equivalent of the reference's ``TensorSpec`` proto
(reference metisfl/proto/model.proto:14-60) and its C++/numpy serde
(proto_tensor_serde.h:13-32, proto_messages_factory.py:419-507), with two
deliberate TPU-first changes:

- ``bfloat16`` is a first-class dtype (the reference had no TPU dtypes).
- payloads are always little-endian C-order; Fortran-order inputs are
  normalized at the boundary instead of carrying a layout flag through the
  whole stack.

Ciphertext / masked tensors reuse the same container with an opaque payload
(``TensorKind.CIPHERTEXT`` / ``MASKED``), mirroring the reference's
``CiphertextTensor`` wrapping (model.proto:69-72).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

try:  # optional here: the torch path (tensor/pytree.py) needs no numpy bf16
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
    _FLOAT8_E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
    _FLOAT8_E5M2 = np.dtype(ml_dtypes.float8_e5m2)
except ImportError:  # pragma: no cover - depends on the installation
    _BFLOAT16 = None
    _FLOAT8_E4M3 = None
    _FLOAT8_E5M2 = None


class DType(enum.IntEnum):
    """Wire dtype tags. Values are stable — they are part of the wire format."""

    F32 = 1
    F64 = 2
    F16 = 3
    BF16 = 4
    I8 = 5
    I16 = 6
    I32 = 7
    I64 = 8
    U8 = 9
    U16 = 10
    U32 = 11
    U64 = 12
    BOOL = 13
    F8_E4M3 = 14
    F8_E5M2 = 15


class TensorKind(enum.IntEnum):
    """What the payload holds."""

    PLAINTEXT = 0
    CIPHERTEXT = 1  # opaque HE ciphertext bytes; dtype/shape describe plaintext
    MASKED = 2      # additively masked plaintext (secure aggregation)


_DTYPE_TO_NP = {
    DType.F32: np.dtype(np.float32),
    DType.F64: np.dtype(np.float64),
    DType.F16: np.dtype(np.float16),
    DType.I8: np.dtype(np.int8),
    DType.I16: np.dtype(np.int16),
    DType.I32: np.dtype(np.int32),
    DType.I64: np.dtype(np.int64),
    DType.U8: np.dtype(np.uint8),
    DType.U16: np.dtype(np.uint16),
    DType.U32: np.dtype(np.uint32),
    DType.U64: np.dtype(np.uint64),
    DType.BOOL: np.dtype(np.bool_),
}
if _BFLOAT16 is not None:
    _DTYPE_TO_NP[DType.BF16] = _BFLOAT16
    _DTYPE_TO_NP[DType.F8_E4M3] = _FLOAT8_E4M3
    _DTYPE_TO_NP[DType.F8_E5M2] = _FLOAT8_E5M2

_NP_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NP.items()}
_NATIVE_LITTLE = struct.pack("=H", 1) == b"\x01\x00"
# The wire format and the serde below assume a little-endian host (true for
# every TPU host platform: x86-64 and aarch64). Fail loudly otherwise.
assert _NATIVE_LITTLE, "metisfl_tpu_torch requires a little-endian host"


def np_dtype_of(dtype: DType) -> np.dtype:
    try:
        return _DTYPE_TO_NP[dtype]
    except KeyError:
        raise ValueError(f"unsupported wire dtype {dtype!r}") from None


def wire_dtype_of(dtype) -> DType:
    dtype = np.dtype(dtype)
    try:
        return _NP_TO_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"numpy dtype {dtype} has no wire representation") from None


@dataclass(frozen=True)
class TensorSpec:
    """Header for one tensor on the wire."""

    shape: Tuple[int, ...]
    dtype: DType
    kind: TensorKind = TensorKind.PLAINTEXT

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * np_dtype_of(self.dtype).itemsize


# Header layout (little-endian):
#   u8 version | u8 dtype | u8 kind | u8 ndim | u32 dims[ndim] | u64 payload_len
_HEADER_VERSION = 1


def tensor_to_bytes(array: np.ndarray, kind: TensorKind = TensorKind.PLAINTEXT,
                    payload: bytes | None = None) -> bytes:
    """Serialize an array (or an opaque payload with array-shaped metadata)."""
    array = np.asarray(array)
    # Normalize byte order at the boundary: the wire is always little-endian.
    # (Little-endian hosts only — asserted at import; '<x' dtypes hash equal
    # to native ones there, so only explicit big-endian inputs need a swap.)
    if array.dtype.byteorder == ">":
        array = array.astype(array.dtype.newbyteorder("="))
    dtype = wire_dtype_of(array.dtype)
    if payload is None:
        payload = np.ascontiguousarray(array).tobytes()
    return _header_bytes(TensorSpec(array.shape, dtype, kind), len(payload)) + payload


def opaque_tensor_to_bytes(spec: TensorSpec, payload: bytes) -> bytes:
    """Serialize an opaque (ciphertext/masked) payload under plaintext metadata."""
    return _header_bytes(spec, len(payload)) + payload


def _header_bytes(spec: TensorSpec, payload_len: int) -> bytes:
    return struct.pack(
        f"<BBBB{len(spec.shape)}IQ",
        _HEADER_VERSION,
        int(spec.dtype),
        int(spec.kind),
        len(spec.shape),
        *spec.shape,
        payload_len,
    )


def read_tensor(view: memoryview, offset: int = 0):
    """Parse one tensor's header; returns ``(spec, payload view,
    next_offset)`` without interpreting the payload (the torch decoder in
    tensor/pytree.py and :func:`tensor_from_bytes` share it)."""
    try:
        version, dtype_tag, kind_tag, ndim = struct.unpack_from("<BBBB", view, offset)
        if version != _HEADER_VERSION:
            raise ValueError(f"unsupported tensor wire version {version}")
        offset += 4
        shape = struct.unpack_from(f"<{ndim}I", view, offset)
        offset += 4 * ndim
        (payload_len,) = struct.unpack_from("<Q", view, offset)
        offset += 8
    except struct.error as exc:
        raise ValueError(f"truncated tensor header: {exc}") from None
    if offset + payload_len > len(view):
        raise ValueError(
            f"truncated tensor payload (need {offset + payload_len} bytes, "
            f"have {len(view)})"
        )
    payload = view[offset : offset + payload_len]
    spec = TensorSpec(tuple(shape), DType(dtype_tag), TensorKind(kind_tag))
    return spec, payload, offset + payload_len


def tensor_from_bytes(buf, offset: int = 0, copy: bool = True):
    """Deserialize one tensor; returns ``(array_or_payload, spec, next_offset)``.

    For PLAINTEXT tensors returns a numpy array — a writable copy by default;
    pass ``copy=False`` for a zero-copy **read-only** view that aliases (and
    keeps alive) ``buf``. For CIPHERTEXT / MASKED returns the raw payload
    bytes (the caller owns decryption).
    """
    view = memoryview(buf)
    spec, payload, offset = read_tensor(view, offset)
    if spec.kind is TensorKind.PLAINTEXT:
        arr = np.frombuffer(payload, dtype=np_dtype_of(spec.dtype)).reshape(spec.shape)
        if copy:
            arr = arr.copy()
        return arr, spec, offset
    return bytes(payload), spec, offset


def quantify(array: np.ndarray) -> dict:
    """Zero/non-zero/byte counts for round metadata.

    Capability parity with the reference's ``QuantifyTensor``
    (proto_tensor_serde.h:34-50) used for community-model size records.
    """
    array = np.asarray(array)
    nonzero = int(np.count_nonzero(array))
    return {
        "values": int(array.size),
        "non_zeros": nonzero,
        "zeros": int(array.size) - nonzero,
        "bytes": int(array.nbytes),
    }


def resolve_ship_dtype(name: str) -> np.dtype:
    """A DType name ("bf16", "f16", ...) → numpy dtype, with a clear
    error listing the valid names (used by TrainParams.ship_dtype; the
    quantized "int8q" mode is handled by callers before this resolver,
    but belongs in the guidance a typo gets back)."""
    try:
        return np_dtype_of(DType[name.upper()])
    except KeyError:
        raise ValueError(
            f"unknown ship_dtype {name!r}; valid names: "
            f"{[d.name.lower() for d in DType] + ['int8q']}") from None


def narrow_named(named, target: np.dtype):
    """[(name, arr)] with float tensors cast to ``target``; integer/bool
    state (step counters, token ids) passes through — casting it through a
    float mantissa would corrupt it. Shared by the uplink (ship_dtype) and
    downlink (downlink_dtype) wire-narrowing paths."""
    return [(n, np.asarray(a, target)
             if np.issubdtype(np.asarray(a).dtype, np.floating)
             and np.asarray(a).dtype != target else a)
            for n, a in named]
