"""The weighted-sum fold kernels of the aggregation rules.

The port's copy of the JAX package's ``aggregation/base.py``. Every rule
consumes ``(model_tree, scale)`` pairs and produces a community model
tree. Arithmetic runs in an accumulator dtype (f32, or f64 for 64-bit
tensors) and is cast back to each tensor's storage dtype at the end;
integer tensors round half to even.

Fold locale (``is_host_tree``): models that arrived over the wire are host
numpy trees and fold on the host, exactly as the JAX package's numpy fold
does (one stacked ``(k,)·(k, n)`` GEMV per leaf), so the two packages give
the same bits. Trees of torch tensors fold where they live, with torch ops.
A weighted sum is a memory-bound streaming op with no TPU kernel behind
it, so no hand-written kernel serves here. The JAX package's native host
fold (``native/hostfold.cc``) is not ported yet (ROADMAP.md Queue 1
item 3d).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from metisfl_tpu_torch.tensor.pytree import tree_leaves, tree_map

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


def np_stacked_scaled_add(acc: Optional[Pytree], block: Sequence[Pytree],
                          scales: np.ndarray) -> Pytree:
    """Host block fold: acc += Σᵢ scalesᵢ · blockᵢ, one stacked (k, n)
    matvec per leaf in the accumulator dtype (``acc`` None starts it)."""
    def fold(a, *xs):
        stack = np.stack([np.asarray(x) for x in xs])
        acc_dt = _np_acc_dtype(stack.dtype)
        flat = stack.reshape(len(xs), -1)
        v = (scales.astype(acc_dt) @ flat).reshape(stack.shape[1:])
        v = np.asarray(v, acc_dt)
        return v if a is None else a + v

    if acc is None:
        return tree_map(lambda *xs: fold(None, *xs), *block)
    return tree_map(fold, acc, *block)


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

