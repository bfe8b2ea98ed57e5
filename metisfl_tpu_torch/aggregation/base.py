"""The weighted-sum fold kernels of the aggregation rules.

The port's copy of the JAX package's ``aggregation/base.py``. Every rule
consumes ``(model_tree, scale)`` pairs and produces a community model
tree. Arithmetic runs in an accumulator dtype (f32, or f64 for 64-bit
tensors) and is cast back to each tensor's storage dtype at the end;
integer tensors round half to even.

Fold locale (``is_host_tree``): models that arrived over the wire are host
numpy trees and fold on the host as the JAX package folds them. Its fast
path is the native streaming fold (``native/hostfold.cc``, built with g++
at first use): one pass over each model, no staging copy, bit-identical to
the JAX package's native fold on the same host. Where g++ cannot build the
library, the fold is the JAX package's numpy fold (one stacked
``(k,)·(k, n)`` GEMV per leaf), the same bits as its numpy fold; a leaf
the native fold does not take (another dtype) folds that way too. The
first attempt logs which fold serves, and :func:`fold_backend` reports
which one the last host fold ran. Trees of torch tensors fold where they
live, with torch ops. A weighted sum is a memory-bound streaming op with
no TPU kernel behind it, so no device kernel serves here.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from metisfl_tpu_torch.tensor.pytree import tree_leaves, tree_map

logger = logging.getLogger("metisfl_tpu_torch.aggregation")

Pytree = Any

_WIDE = tuple(np.dtype(d) for d in (np.float64, np.int64, np.uint64))
_TORCH_WIDE = (torch.float64, torch.int64)


def is_host_tree(tree) -> bool:
    """True when every leaf is a host numpy array (no torch tensor)."""
    leaves = tree_leaves(tree)
    return bool(leaves) and all(isinstance(leaf, np.ndarray)
                                for leaf in leaves)


# -- host numpy fold ---------------------------------------------------------

def _np_acc_dtype(dtype) -> np.dtype:
    return np.dtype(np.float64 if np.dtype(dtype) in _WIDE else np.float32)


# the native fold library: None until first tried, False where it could
# not be built (the numpy fold then serves); tests set it to pin a fold
_hostfold_lib = None
# the folds the last np_stacked_scaled_add ran ("native" and/or "numpy")
_last_backends: Tuple[str, ...] = ()


def _get_hostfold():
    """The native fold library (native/hostfold.cc), or None where g++
    cannot build it; the first attempt logs which fold serves."""
    global _hostfold_lib
    if _hostfold_lib is None:
        try:
            from metisfl_tpu_torch.native import library_path, load_hostfold

            _hostfold_lib = load_hostfold()
            logger.info("host fold: native (%s)", library_path("hostfold"))
        except (RuntimeError, OSError) as exc:
            _hostfold_lib = False
            logger.warning("host fold: numpy (native hostfold.cc "
                           "unavailable: %s)", exc)
    return _hostfold_lib or None


def fold_backend() -> Optional[str]:
    """Which fold the last host fold ran: ``"native"``, ``"numpy"``,
    ``"native+numpy"`` (leaves of both kinds) or None before any."""
    return "+".join(_last_backends) or None


def _native_fold(a, arrs, scales):
    """acc (+)= Σ scalesᵢ·arrsᵢ through hostfold.cc, or None where it does
    not apply (no library, mixed or other dtypes, an accumulator it cannot
    write in place). Streams each model once with no staging copy."""
    lib = _get_hostfold()
    if lib is None:
        return None
    dt = arrs[0].dtype
    if any(x.dtype != dt for x in arrs):
        return None
    if dt == np.float32:
        fold, cptr = lib.hostfold_f32, ctypes.c_float
    elif dt == np.float64:
        fold, cptr = lib.hostfold_f64, ctypes.c_double
    else:
        return None
    if a is None:
        out, init = np.empty(arrs[0].shape, dt), 1
    elif a.dtype == dt and a.flags["C_CONTIGUOUS"]:
        out, init = a, 0
    else:
        return None
    ptr_t = ctypes.POINTER(cptr)
    contig = [np.ascontiguousarray(x) for x in arrs]
    ptrs = (ptr_t * len(contig))(*[x.ctypes.data_as(ptr_t) for x in contig])
    sc = np.ascontiguousarray(scales, np.float64)
    fold(out.ctypes.data_as(ptr_t), ptrs,
         sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
         len(contig), out.size, init)
    return out


def np_stacked_scaled_add(acc: Optional[Pytree], block: Sequence[Pytree],
                          scales: np.ndarray) -> Pytree:
    """Host block fold: acc += Σᵢ scalesᵢ · blockᵢ (``acc`` None starts
    it). Per leaf the native streaming fold where it applies, else one
    stacked (k, n) matvec in the accumulator dtype."""
    global _last_backends
    used = set()

    def fold(a, *xs):
        arrs = [np.asarray(x) for x in xs]
        native = _native_fold(a, arrs, scales)
        if native is not None:
            used.add("native")
            return native
        used.add("numpy")
        stack = np.stack(arrs)
        acc_dt = _np_acc_dtype(stack.dtype)
        flat = stack.reshape(len(xs), -1)
        v = (scales.astype(acc_dt) @ flat).reshape(stack.shape[1:])
        v = np.asarray(v, acc_dt)
        return v if a is None else a + v

    if acc is None:
        out = tree_map(lambda *xs: fold(None, *xs), *block)
    else:
        out = tree_map(fold, acc, *block)
    _last_backends = tuple(b for b in ("native", "numpy") if b in used)
    return out


def np_finalize(acc: Pytree, z, dtypes: Tuple[str, ...]) -> Pytree:
    """community = acc / z cast to the storage ``dtypes`` (leaf order);
    integer leaves round half to even (``np.rint``)."""
    it = iter(dtypes)

    def fin(a):
        dtype = np.dtype(next(it))
        value = a / z
        if np.issubdtype(dtype, np.integer):
            value = np.rint(value)
        return np.asarray(value).astype(dtype)

    return tree_map(fin, acc)


# -- torch fold (trees of tensors, on their device) --------------------------

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in _TORCH_WIDE else torch.float32


def stacked_scaled_add(acc: Optional[Pytree], block: Sequence[Pytree],
                       scales: np.ndarray) -> Pytree:
    """acc += Σᵢ scalesᵢ · blockᵢ over tensor trees: per leaf one stacked
    ``tensordot`` in the accumulator dtype, on the leaves' device."""
    def fold(a, *xs):
        xs = [torch.as_tensor(x) for x in xs]
        acc_dt = a.dtype if a is not None else _acc_dtype(xs[0].dtype)
        stack = torch.stack([x.to(acc_dt) for x in xs])
        w = torch.as_tensor(scales, dtype=acc_dt, device=stack.device)
        v = torch.tensordot(w, stack, dims=1)
        return v if a is None else a + v

    if acc is None:
        return tree_map(lambda *xs: fold(None, *xs), *block)
    return tree_map(fold, acc, *block)


def finalize(acc: Pytree, z, dtypes: Tuple[torch.dtype, ...]) -> Pytree:
    """community = acc / z cast to the storage ``dtypes``; integer leaves
    round half to even (``torch.round``, like ``np.rint``)."""
    it = iter(dtypes)

    def fin(a):
        dtype = next(it)
        value = a / z
        if not (dtype.is_floating_point or dtype.is_complex):
            value = torch.round(value)
        return value.to(dtype)

    return tree_map(fin, acc)

