"""MLPs: the port's copies of the JAX package's ``models/zoo/mlp.py``.

Parameters keep the Flax names (``Dense_0/kernel``) and layouts (kernels
``(in, out)``), so Flax variables load by renaming (models/convert.py).
Flax infers a dense layer's input width at its first call; a torch module
allocates its parameters up front, so ``in_features`` (the flattened
width of one example) is a constructor argument.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from metisfl_tpu_torch.models.zoo.transformer import Dense


def _dense_stack(module: nn.Module, in_features: int,
                 widths: Sequence[int], device=None) -> int:
    """Add ``Dense_0..Dense_{n-1}`` of ``widths`` to ``module``; returns
    the last width (the next layer's input)."""
    width = in_features
    for i, out in enumerate(widths):
        module.add_module(f"Dense_{i}", Dense(width, out, device=device))
        width = out
    return width


class MLP(nn.Module):
    """Plain classifier/regressor MLP with configurable hidden widths."""

    def __init__(self, in_features: int, features: Sequence[int] = (64, 64),
                 num_outputs: int = 10, device=None):
        super().__init__()
        self.depth = len(features)
        _dense_stack(self, in_features, tuple(features) + (num_outputs,),
                     device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth}")(x)


class HousingMLP(nn.Module):
    """Regression MLP with a scalar output per example (shape ``(B,)``)."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 32),
                 device=None):
        super().__init__()
        self.depth = len(features)
        _dense_stack(self, in_features, tuple(features) + (1,),
                     device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth}")(x)[..., 0]
