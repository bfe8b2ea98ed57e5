"""Weights carried across between the JAX package and the port.

The port's modules name their parameters after the Flax variables and keep
the Flax layouts (dense kernels ``(in, out)``), so a variables tree maps
onto a module by renaming alone: ``params/block_0/attn/wq/base/kernel`` is
the parameter ``block_0.attn.wq.base.kernel``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from metisfl_tpu_torch.tensor.pytree import (
    as_tensor,
    pytree_to_named_tensors,
    to_numpy,
)

_COLLECTION = "params"


def flax_name(param_name: str) -> str:
    """``block_0.attn.wo.kernel`` → ``params/block_0/attn/wo/kernel``."""
    return f"{_COLLECTION}/" + param_name.replace(".", "/")


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill ``module`` from a Flax variables tree (nested dicts of numpy
    arrays or tensors, ``{"params": {...}}``) or from named tensors
    (``[(name, tensor)]``, e.g. a ModelBlob's). Every parameter must be
    present with its exact shape, and no extra name may be left over;
    values are cast to the parameter's dtype and copied to its device.
    Returns ``module``."""
    if isinstance(variables, (list, tuple)):
        named = [(n, as_tensor(t)) for n, t in variables]
    else:
        named = pytree_to_named_tensors(variables)
    given = dict(named)
    params = {flax_name(n): p for n, p in module.named_parameters()}
    missing = sorted(set(params) - set(given))
    extra = sorted(set(given) - set(params))
    if missing or extra:
        raise KeyError(f"variables do not match {type(module).__name__}: "
                       f"missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        src = given[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the module's {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return module


def export_flax_variables(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a Flax variables tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        node = tree
        *parents, leaf = flax_name(name).split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = to_numpy(p)
    return tree
