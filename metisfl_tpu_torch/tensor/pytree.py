"""Nested tensor trees ⇄ named-tensor model blobs (the torch side of the
wire contract).

The federation moves *models* as ordered, named, flat tensors. The names
come from the tree's key path exactly as the JAX package derives them
(``params/block_0/attn/wq/base/kernel``), and ModelBlob v2 is the same
bytes: a blob packed by either package unpacks in the other to the same
names, dtypes and bytes. Trees here are nested ``dict``/``list``/``tuple``
containers whose leaves are ``torch.Tensor`` (numpy arrays are accepted
and converted). Dict keys flatten in sorted order, as JAX flattens dicts,
so the tensor order on the wire matches too.

bf16 and fp8 travel as themselves: the payload is the tensor's raw bytes,
so no numpy bf16 type is needed on either side.
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from metisfl_tpu_torch.tensor.spec import (
    DType,
    TensorKind,
    TensorSpec,
    _header_bytes,
    np_dtype_of,
    opaque_tensor_to_bytes,
    read_tensor,
    resolve_ship_dtype,
)
from metisfl_tpu_torch.tensor.spec import wire_dtype_of as np_wire_dtype_of

NamedTensors = List[Tuple[str, torch.Tensor]]

_MAGIC = b"MTFB"  # metisfl-tpu federated blob
# v2: integrity framing (<u64 body_len, u32 crc32> over the tensor body);
# v1 blobs parse unverified; v3 is the store-local variant whose crc field
# is zero and never verified (accepted only with allow_nocrc=True)
_BLOB_VERSION = 2
_BLOB_VERSION_NOCRC = 3

_TORCH_TO_WIRE = {
    torch.float32: DType.F32,
    torch.float64: DType.F64,
    torch.float16: DType.F16,
    torch.bfloat16: DType.BF16,
    torch.int8: DType.I8,
    torch.int16: DType.I16,
    torch.int32: DType.I32,
    torch.int64: DType.I64,
    torch.uint8: DType.U8,
    torch.bool: DType.BOOL,
}
for _name, _tag in (("uint16", DType.U16), ("uint32", DType.U32),
                    ("uint64", DType.U64), ("float8_e4m3fn", DType.F8_E4M3),
                    ("float8_e5m2", DType.F8_E5M2)):
    if hasattr(torch, _name):  # newer torch releases only
        _TORCH_TO_WIRE[getattr(torch, _name)] = _tag
_WIRE_TO_TORCH = {v: k for k, v in _TORCH_TO_WIRE.items()}

# numpy dtype names of the types numpy lacks natively (ml_dtypes' names),
# reinterpreted bit for bit through an integer view
_NP_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, getattr(torch, "float8_e4m3fn",
                                                   None)),
               "float8_e5m2": (np.uint8, getattr(torch, "float8_e5m2", None))}


def as_tensor(x, read_only: bool = False) -> torch.Tensor:
    """A leaf as a torch tensor: tensors pass through; numpy arrays (and
    anything ``np.asarray`` takes) convert without changing their bits,
    bf16/fp8 from ml_dtypes included. A read-only array is copied, since
    torch tensors are writable, unless ``read_only`` is set: then the
    tensor views it, and the caller must only read it (a copy to the
    device, for one)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.byteorder == ">":  # the wire is little-endian (spec.py)
        arr = arr.astype(arr.dtype.newbyteorder("="))
    if not arr.flags.writeable and not read_only:
        arr = arr.copy()
    # reshape: ascontiguousarray promotes a 0-d array to 1-d
    contig = np.ascontiguousarray(arr).reshape(arr.shape)
    bitcast = _NP_BITCAST.get(arr.dtype.name)
    if bitcast is not None:
        int_dtype, torch_dtype = bitcast
        if torch_dtype is None:
            raise TypeError(f"this torch has no {arr.dtype.name} dtype")
        contig = contig.view(int_dtype)
    with warnings.catch_warnings():
        # a read_only view: torch warns that its memory is not writable
        warnings.simplefilter("ignore", UserWarning)
        tensor = torch.from_numpy(contig)
    return tensor if bitcast is None else tensor.view(torch_dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 needs ml_dtypes installed."""
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        import ml_dtypes  # raises where numpy has no bf16 type at all

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def wire_dtype_of(t: torch.Tensor) -> DType:
    try:
        return _TORCH_TO_WIRE[t.dtype]
    except KeyError:
        raise ValueError(f"torch dtype {t.dtype} has no wire "
                         "representation") from None


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    """One plaintext tensor: header + little-endian C-order payload."""
    t = as_tensor(t).detach().cpu().contiguous()
    payload = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return _header_bytes(TensorSpec(tuple(t.shape), wire_dtype_of(t),
                                    TensorKind.PLAINTEXT),
                         len(payload)) + payload


def tensor_from_payload(spec: TensorSpec, payload) -> torch.Tensor:
    """A plaintext payload as a (writable, CPU) tensor of ``spec``."""
    dtype = _WIRE_TO_TORCH.get(spec.dtype)
    if dtype is None:
        raise ValueError(f"wire dtype {spec.dtype!r} has no torch dtype here")
    if len(payload) == 0:
        return torch.empty(spec.shape, dtype=dtype)
    return torch.frombuffer(bytearray(payload), dtype=dtype).reshape(
        spec.shape)


def tensor_from_float64(spec: TensorSpec, values) -> torch.Tensor:
    """Decoded float64 values (a secure payload's plaintext) as a CPU
    tensor of ``spec``'s dtype and shape, rounded as numpy rounds them:
    straight from float64 where numpy has the dtype, through float32 for
    bf16 and fp8 (as ml_dtypes casts)."""
    dtype = _WIRE_TO_TORCH.get(spec.dtype)
    if dtype is None:
        raise ValueError(f"wire dtype {spec.dtype!r} has no torch dtype here")
    values = np.asarray(values, np.float64)
    try:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return torch.from_numpy(values.astype(np.float32)).to(dtype).reshape(
            spec.shape)
    return torch.from_numpy(values.astype(np_dtype)).reshape(spec.shape)


def _escape(part: str) -> str:
    # '/' joins path components; escape literal '/' (and the escape char) so
    # {'a': {'b': x}} and {'a/b': y} can never collide.
    return part.replace("%", "%25").replace("/", "%2F")


def _key_to_name(path) -> str:
    """Key path → wire name: dict keys escaped, sequence indices as
    decimal (the JAX package's ``DictKey``/``SequenceKey`` rule)."""
    return "/".join(str(p) if isinstance(p, int) else _escape(str(p))
                    for p in path)


def _flatten(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, path + (i,))
    else:
        yield path, tree


def _check_unique(names) -> None:
    if len(set(names)) != len(names):
        seen, dupes = set(), set()
        for n in names:
            (dupes if n in seen else seen).add(n)
        raise ValueError(f"duplicate tensor names in model: {sorted(dupes)[:5]}")


def pytree_to_named_tensors(tree) -> NamedTensors:
    """Flatten a nested tree to ``[(name, torch.Tensor), ...]`` (ordered)."""
    named = [(_key_to_name(path), as_tensor(leaf))
             for path, leaf in _flatten(tree)]
    _check_unique([n for n, _ in named])
    return named


def named_tensors_to_pytree(named: NamedTensors, treedef_like):
    """Rebuild a tree structured like ``treedef_like`` from named tensors."""
    _check_unique([n for n, _ in named])
    by_name = dict(named)
    missing = [_key_to_name(p) for p, _ in _flatten(treedef_like)
               if _key_to_name(p) not in by_name]
    if missing:
        raise KeyError(f"model blob is missing tensors: {missing[:5]}")

    def build(sub, path):
        if sub is None:
            return None
        if isinstance(sub, dict):
            return {k: build(v, path + (k,)) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(build(v, path + (i,)) for i, v in enumerate(sub))
        return by_name[_key_to_name(path)]

    return build(treedef_like, ())


@dataclass
class ModelBlob:
    """A serializable model: ordered named tensors plus opaque entries
    (``name -> (payload bytes, TensorSpec)``, ciphertext or masked)."""

    tensors: NamedTensors = field(default_factory=list)
    opaque: Dict[str, tuple] = field(default_factory=dict)

    @property
    def names(self) -> List[str]:
        seen = [n for n, _ in self.tensors]
        seen.extend(self.opaque.keys())
        return seen

    @property
    def num_parameters(self) -> int:
        return sum(int(t.numel()) for _, t in self.tensors) + sum(
            spec.size for _, spec in self.opaque.values())

    def to_bytes(self) -> bytes:
        chunks = []
        for name, t in self.tensors:
            nb = name.encode("utf-8")
            chunks.append(struct.pack("<H", len(nb)))
            chunks.append(nb)
            chunks.append(tensor_to_bytes(t))
        for name, (payload, spec) in self.opaque.items():
            nb = name.encode("utf-8")
            chunks.append(struct.pack("<H", len(nb)))
            chunks.append(nb)
            chunks.append(opaque_tensor_to_bytes(spec, payload))
        body = b"".join(chunks)
        return b"".join([
            _MAGIC,
            struct.pack("<BI", _BLOB_VERSION, len(self.names)),
            struct.pack("<QI", len(body), zlib.crc32(body)),
            body,
        ])

    @classmethod
    def from_bytes(cls, buf, allow_nocrc: bool = False) -> "ModelBlob":
        """Parse and verify a blob. ``allow_nocrc=True`` accepts the v3
        store-local variant; by default it is rejected, so a wire payload
        cannot sidestep the v2 integrity framing."""
        blob = cls()
        for name, spec, payload in blob_entries(buf, allow_nocrc):
            if spec.kind is TensorKind.PLAINTEXT:
                blob.tensors.append((name, tensor_from_payload(spec,
                                                               payload)))
            else:
                blob.opaque[name] = (bytes(payload), spec)
        return blob


def blob_entries(buf, allow_nocrc: bool = False
                 ) -> Iterator[Tuple[str, TensorSpec, memoryview]]:
    """Verify a blob's framing (magic, version, length, the v2 crc), then
    yield ``(name, spec, payload view)`` per entry without copying a
    payload. ``allow_nocrc`` as in :meth:`ModelBlob.from_bytes`."""
    view = memoryview(buf)
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("not a metisfl-tpu model blob")
    version, count = struct.unpack_from("<BI", view, 4)
    offset = 9
    if version == _BLOB_VERSION_NOCRC and not allow_nocrc:
        raise ValueError(
            "unchecksummed v3 model blob rejected outside the store "
            "read path (wire payloads must carry the v2 crc framing)")
    if version in (_BLOB_VERSION, _BLOB_VERSION_NOCRC):
        try:
            body_len, crc = struct.unpack_from("<QI", view, offset)
        except struct.error:
            raise ValueError("truncated model blob header") from None
        offset += 12
        body = view[offset:]
        if len(body) != body_len:
            raise ValueError(
                f"model blob length mismatch (framed {body_len} body "
                f"bytes, have {len(body)}) — truncated or spliced "
                "payload")
        if version == _BLOB_VERSION and zlib.crc32(body) != crc:
            raise ValueError(
                "model blob checksum mismatch — corrupt payload "
                "rejected before deserialization")
    elif version != 1:  # v1: legacy pre-integrity blobs parse unverified
        raise ValueError(f"unsupported blob version {version}")
    for _ in range(count):
        (nlen,) = struct.unpack_from("<H", view, offset)
        offset += 2
        name = bytes(view[offset: offset + nlen]).decode("utf-8")
        offset += nlen
        spec, payload, offset = read_tensor(view, offset)
        yield name, spec, payload


def read_named_arrays(buf, allow_nocrc: bool = False
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, tuple]]:
    """A blob as ``({name: numpy array}, {name: (payload bytes, spec)})``:
    the plaintext tensors as read-only numpy views over ``buf`` (no copy;
    they keep ``buf`` alive), the opaque entries as in
    :class:`ModelBlob`. The host side of the store and the fold read
    models this way; bf16/fp8 tensors need ml_dtypes."""
    tensors: Dict[str, np.ndarray] = {}
    opaque: Dict[str, tuple] = {}
    for name, spec, payload in blob_entries(buf, allow_nocrc):
        if spec.kind is TensorKind.PLAINTEXT:
            tensors[name] = np.frombuffer(
                payload, dtype=np_dtype_of(spec.dtype)).reshape(spec.shape)
        else:
            opaque[name] = (bytes(payload), spec)
    return tensors, opaque


def _payload_view(value) -> Tuple[TensorSpec, memoryview]:
    """One plaintext tensor (numpy or torch) as its header spec and a flat
    byte view over its buffer (a contiguous copy only where it is not
    contiguous already)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        spec = TensorSpec(tuple(t.shape), wire_dtype_of(t),
                          TensorKind.PLAINTEXT)
        flat = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return spec, flat.data
    arr = np.asarray(value)
    if arr.dtype.byteorder == ">":  # the wire is little-endian (spec.py)
        arr = arr.astype(arr.dtype.newbyteorder("="))
    # the header's shape before the reshape: a 0-d array stays 0-d there
    spec = TensorSpec(tuple(arr.shape), np_wire_dtype_of(arr.dtype),
                      TensorKind.PLAINTEXT)
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return spec, flat.data


def write_named_tensors(fd: int, named, checksum: bool = True) -> int:
    """Stream a tensors-only blob to the open file descriptor ``fd`` with
    no staging copy of the model; returns the bytes written.

    ``named`` is ``[(name, numpy array or torch tensor)]``. Each tensor
    contributes a ``memoryview`` over its own buffer: the crc folds across
    the views and ``os.writev`` gathers them into the file. With
    ``checksum=True`` the file holds exactly ``ModelBlob(tensors=named)
    .to_bytes()`` (v2); ``checksum=False`` writes the store-local v3
    variant, the same layout with a zero crc that is never verified
    (the uplink was checked at the wire decode, and the length frame
    still rejects truncation). The JAX package's
    ``tensor/pytree.py:write_named_tensors`` writes the same bytes."""
    chunks: List = []
    for name, value in named:
        spec, payload = _payload_view(value)
        nb = name.encode("utf-8")
        chunks.append(struct.pack("<H", len(nb)) + nb
                      + _header_bytes(spec, len(payload)))
        chunks.append(payload)
    body_len = sum(len(c) for c in chunks)
    crc = 0
    if checksum:
        for c in chunks:
            crc = zlib.crc32(c, crc)
    header = b"".join([
        _MAGIC,
        struct.pack("<BI", _BLOB_VERSION if checksum else _BLOB_VERSION_NOCRC,
                    len(named)),
        struct.pack("<QI", body_len, crc),
    ])
    buffers: List = [header] + chunks
    total = len(header) + body_len
    while buffers:
        written = os.writev(fd, buffers[:64])
        while buffers and written >= len(buffers[0]):
            written -= len(buffers[0])
            buffers.pop(0)
        if written:
            buffers[0] = memoryview(buffers[0])[written:]
    return total


def pack_model(params_tree) -> bytes:
    """One-call tree → wire bytes."""
    return ModelBlob(tensors=pytree_to_named_tensors(params_tree)).to_bytes()


def unpack_model(buf, treedef_like):
    """One-call wire bytes → tree shaped like ``treedef_like``."""
    blob = ModelBlob.from_bytes(buf)
    return named_tensors_to_pytree(blob.tensors, treedef_like)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple tree in JAX's flattening
    order (dict keys sorted); leaves stay as they are (numpy or torch)."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_paths(tree) -> list:
    """The key paths of a tree's leaves in flattening order: two trees
    with equal paths have the same structure."""
    return [path for path, _ in _flatten(tree)]


def tree_unflatten(like, leaves):
    """``leaves`` (in flattening order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), rebuilt in ``tree``'s structure; dicts come back
    with their keys sorted, as ``jax.tree.map`` returns them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def narrow_tensors(named: NamedTensors, ship_dtype: str) -> NamedTensors:
    """[(name, tensor)] with floating tensors cast to the wire dtype named
    ``ship_dtype`` ("bf16", "f16", "f32", ...); integer and bool state
    (step counters, token ids) passes through untouched, since a float
    mantissa would corrupt it. The torch form of ``spec.narrow_named``;
    an unknown name raises ``ValueError`` (``spec.resolve_ship_dtype``)."""
    resolve_ship_dtype(ship_dtype)
    target = _WIRE_TO_TORCH[DType[ship_dtype.upper()]]
    return [(n, t.to(target) if t.is_floating_point() and t.dtype != target
             else t) for n, t in named]
