"""Top-k sparsified federation uplink with error feedback: the port's
copy of the JAX package's ``tensor/sparse.py``, numpy, bit for bit.

``TrainParams.ship_dtype="topk<D>"`` (e.g. ``"topk16"``) ships each float
tensor of the learner's update (trained weights minus the round's
dispatched community model) as its ``ceil(size/D)`` largest-magnitude
entries, value and flat index, instead of the dense tensor: about ``D/2``
times less uplink than f32. The learner keeps the dropped remainder as a
per-tensor error-feedback residual and adds it to the next round's update
before it sparsifies again.

Wire shape: each sparsified tensor ``name`` becomes three companion
entries of the ordinary named-tensor blob, ``name#tkidx`` (flat indices),
``name#tkval`` (f32 values) and ``name#tkshape`` (the dense shape). The
controller rebuilds dense weights at parse time (``densify_named``: the
community model plus the scattered update), which is valid only while the
community model has not moved since dispatch: a synchronous protocol
(config-validated).

The selection stays in numpy: among equal ``|u|`` ``np.argpartition``
picks by its own selection order, which ``torch.topk`` would not repeat,
and the indices must equal the JAX learner's. Integer and bool tensors,
and floats smaller than ``MIN_SPARSE_SIZE``, pass through dense.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

IDX_SUFFIX = "#tkidx"
VAL_SUFFIX = "#tkval"
SHAPE_SUFFIX = "#tkshape"
_SUFFIXES = (IDX_SUFFIX, VAL_SUFFIX, SHAPE_SUFFIX)

SHIP_TOPK_PREFIX = "topk"
_TOPK_RE = re.compile(r"^topk(\d*)$")
DEFAULT_DENOM = 16
# below this many elements the idx+val+shape companions cost more wire
# than the dense tensor they replace
MIN_SPARSE_SIZE = 64


def parse_topk(ship_dtype: str) -> Optional[int]:
    """``"topk<D>"`` → D (bare ``"topk"`` → DEFAULT_DENOM); None when the
    string is not a topk spec. Raises on a malformed denominator."""
    m = _TOPK_RE.match(str(ship_dtype).strip().lower())
    if m is None:
        return None
    denom = int(m.group(1)) if m.group(1) else DEFAULT_DENOM
    if not 1 <= denom <= 100_000:
        raise ValueError(
            f"ship_dtype {ship_dtype!r}: denominator must be in "
            f"[1, 100000], got {denom}")
    return denom


def sparsify_update(
    new_named: List[Tuple[str, np.ndarray]],
    ref: Dict[str, np.ndarray],
    denom: int,
    residual: Dict[str, np.ndarray],
) -> List[Tuple[str, np.ndarray]]:
    """[(name, trained)] + {name: dispatched} → sparse wire entries.

    For each float tensor: ``u = (trained - dispatched) + residual``; the
    top ``ceil(size/denom)`` entries of ``|u|`` ship as (idx, val, shape);
    the rest becomes the new residual (mutated in place in ``residual``).
    Tensors absent from ``ref`` (shape/name drift after a model swap) and
    non-float/tiny tensors ship dense, and their residual resets; residuals
    for names no longer in the model are pruned (they could never ship
    again and would otherwise leak dense f32 copies for the learner's
    lifetime).
    """
    current = {name for name, _ in new_named}
    for gone in [k for k in residual if k not in current]:
        residual.pop(gone)
    out: List[Tuple[str, np.ndarray]] = []
    for name, arr in new_named:
        arr = np.asarray(arr)
        if any(name.endswith(s) for s in _SUFFIXES):
            raise ValueError(f"tensor name {name!r} collides with a "
                             "topk companion suffix")
        ref_arr = ref.get(name)
        if (not np.issubdtype(arr.dtype, np.floating)
                or arr.size < MIN_SPARSE_SIZE
                or ref_arr is None
                or np.asarray(ref_arr).shape != arr.shape):
            residual.pop(name, None)
            out.append((name, arr))
            continue
        u = (np.asarray(arr, np.float32)
             - np.asarray(ref_arr, np.float32)).ravel()
        res = residual.get(name)
        if res is not None and res.shape == u.shape:
            u = u + res
        k = max(1, -(-arr.size // denom))  # ceil
        # argpartition: O(n) selection of the k largest |u|
        idx = np.argpartition(np.abs(u), arr.size - k)[arr.size - k:]
        idx = np.sort(idx)
        vals = u[idx]
        new_res = u.copy()
        new_res[idx] = 0.0
        residual[name] = new_res
        idx_dtype = np.int32 if arr.size <= np.iinfo(np.int32).max \
            else np.int64
        out.append((name + IDX_SUFFIX, idx.astype(idx_dtype)))
        out.append((name + VAL_SUFFIX, vals.astype(np.float32)))
        out.append((name + SHAPE_SUFFIX,
                    np.asarray(arr.shape, np.int64)))
    return out


def is_sparse(names) -> bool:
    return any(str(n).endswith(VAL_SUFFIX) for n in names)


def densify_named(
    tensors: Dict[str, np.ndarray],
    community: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """{wire name: arr} + {name: community tensor} → dense f32 weights:
    ``community + scatter(update)`` per sparsified tensor; companion
    entries consumed; dense passthrough entries kept as-is."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if any(name.endswith(s) for s in _SUFFIXES):
            continue
        out[name] = arr
    for name, vals in tensors.items():
        if not name.endswith(VAL_SUFFIX):
            continue
        base = name[: -len(VAL_SUFFIX)]
        idx = tensors.get(base + IDX_SUFFIX)
        shape = tensors.get(base + SHAPE_SUFFIX)
        if idx is None or shape is None:
            raise ValueError(f"sparse tensor {base!r}: missing "
                             "companion idx/shape entries")
        ref = community.get(base)
        shape = tuple(int(d) for d in np.asarray(shape).ravel())
        if ref is None or tuple(np.asarray(ref).shape) != shape:
            raise ValueError(
                f"sparse tensor {base!r}: no community tensor of shape "
                f"{shape} to densify against (topk shipping requires the "
                "controller to hold the dispatched community model)")
        dense = np.asarray(ref, np.float32).ravel().copy()
        flat_idx = np.asarray(idx).ravel()
        if flat_idx.size and (flat_idx.min() < 0
                              or flat_idx.max() >= dense.size):
            raise ValueError(f"sparse tensor {base!r}: index out of range")
        if np.unique(flat_idx).size != flat_idx.size:
            # a well-formed sparsify_update payload has unique indices;
            # duplicates would silently drop contributions under numpy's
            # unbuffered fancy-index add
            raise ValueError(f"sparse tensor {base!r}: duplicate indices")
        dense[flat_idx] += np.asarray(vals, np.float32).ravel()
        out[base] = dense.reshape(shape)
    return out
