"""Small CNNs: the port's copies of the JAX package's
``models/zoo/cnn.py``.

Inputs are channels-last, as in Flax (``(B, H, W, C)``, ``(B, D, H, W,
C)``). Parameters keep the Flax names (``Conv_0/kernel``, ``Dense_0``) and
layouts: conv kernels are stored HWIO (DHWIO in 3-D) and permuted to
torch's OIHW inside ``forward``, so Flax variables load by renaming. The
numerics follow Flax: ``nn.Conv`` pads SAME at stride 1, ``nn.max_pool``
is VALID, and the flatten before the dense head runs in channels-last
order (H, then W, then C), so ``Dense_0``'s kernel rows mean what they
mean in Flax. Dropout draws its masks from the generator that
``TorchModelOps.train`` gives it (transformer.py ``Dropout``); they are
not JAX's. A torch module allocates its parameters up front, so the input
shape of one example (``input_shape``, channels last) is a constructor
argument.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from metisfl_tpu_torch.models.zoo.transformer import Dense, Dropout, _param


class Conv(nn.Module):
    """Flax ``nn.Conv`` at stride 1, SAME padding: ``kernel``
    ``(*window, in, out)``, ``bias`` ``(out,)``; runs on channels-first
    tensors."""

    def __init__(self, in_features: int, features: int,
                 window: Sequence[int], device=None):
        super().__init__()
        self.kernel = _param(*window, in_features, features, device=device)
        self.bias = _param(features, device=device)
        self._conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[len(window)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = self.kernel.dim() - 2
        # (*window, I, O) → (O, I, *window)
        weight = self.kernel.permute(nd + 1, nd, *range(nd))
        return self._conv(x, weight, self.bias, padding="same")


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _flatten_channels_last(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``x.reshape((B, -1))`` of a channels-last feature map."""
    return x.movedim(1, -1).reshape(x.shape[0], -1)


def _pooled(size: int, blocks: int) -> int:
    for _ in range(blocks):
        size //= 2  # VALID 2-window, stride-2 pooling
    return size


class FashionMnistCNN(nn.Module):
    """2-conv CNN for 28×28×1 inputs."""

    def __init__(self, num_classes: int = 10,
                 input_shape: Sequence[int] = (28, 28, 1),
                 dropout_rate: float = 0.25, device=None):
        super().__init__()
        h, w, c = input_shape
        self.dropout = Dropout(dropout_rate)
        self.Conv_0 = Conv(c, 32, (3, 3), device=device)
        self.Conv_1 = Conv(32, 64, (3, 3), device=device)
        flat = _pooled(h, 2) * _pooled(w, 2) * 64
        self.Dense_0 = Dense(flat, 128, device=device)
        self.Dense_1 = Dense(128, num_classes, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = _channels_first(x)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        x = F.relu(self.Dense_0(_flatten_channels_last(x)))
        x = self.dropout(x, train)
        return self.Dense_1(x)


class Cifar10CNN(nn.Module):
    """3-block VGG-style CNN for 32×32×3 inputs."""

    widths = (32, 64, 128)

    def __init__(self, num_classes: int = 10,
                 input_shape: Sequence[int] = (32, 32, 3),
                 dropout_rate: float = 0.5, device=None):
        super().__init__()
        h, w, c = input_shape
        self.dropout = Dropout(dropout_rate)
        width_in = c
        for i, width in enumerate(self.widths):
            self.add_module(f"Conv_{2 * i}",
                            Conv(width_in, width, (3, 3), device=device))
            self.add_module(f"Conv_{2 * i + 1}",
                            Conv(width, width, (3, 3), device=device))
            width_in = width
        blocks = len(self.widths)
        flat = _pooled(h, blocks) * _pooled(w, blocks) * width_in
        self.Dense_0 = Dense(flat, 128, device=device)
        self.Dense_1 = Dense(128, num_classes, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _channels_first(x)
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"Conv_{2 * i}")(x))
            x = F.relu(getattr(self, f"Conv_{2 * i + 1}")(x))
            x = F.max_pool2d(x, 2)
        x = F.relu(self.Dense_0(_flatten_channels_last(x)))
        x = self.dropout(x, train)
        return self.Dense_1(x)


class BrainAge3DCNN(nn.Module):
    """Volumetric 3D-CNN: Conv3D/MaxPool3D blocks scaled by ``widths``.

    Input ``(B, D, H, W)`` or ``(B, D, H, W, 1)``. With ``num_outputs=0``
    the output is ``(B,)`` regression values (train with ``loss="mse"``;
    the squeezed shape matches ``(B,)`` labels); with ``num_outputs > 0``
    it is ``(B, num_outputs)`` class logits."""

    def __init__(self, widths: Sequence[int] = (8, 16, 32),
                 num_outputs: int = 0,
                 input_shape: Sequence[int] = (16, 16, 16, 1), device=None):
        super().__init__()
        *spatial, c = input_shape
        self.widths = tuple(widths)
        self.num_outputs = num_outputs
        width_in = c
        for i, width in enumerate(self.widths):
            self.add_module(f"Conv_{i}",
                            Conv(width_in, width, (3, 3, 3), device=device))
            width_in = width
        flat = math.prod(_pooled(s, len(self.widths))
                         for s in spatial) * width_in
        self.Dense_0 = Dense(flat, 64, device=device)
        self.Dense_1 = Dense(64, num_outputs if num_outputs > 0 else 1,
                             device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() == 4:
            x = x[..., None]
        x = _channels_first(x)
        for i in range(len(self.widths)):
            x = F.max_pool3d(F.relu(getattr(self, f"Conv_{i}")(x)), 2)
        x = F.relu(self.Dense_0(_flatten_channels_last(x)))
        out = self.Dense_1(x)
        return out if self.num_outputs > 0 else out[..., 0]
