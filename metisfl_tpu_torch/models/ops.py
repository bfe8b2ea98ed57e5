"""TorchModelOps — the inference subset of the JAX package's
``FlaxModelOps``, around one torch module.

The engine owns a module and its weights on one device. Weights go in and
out as Flax variables trees of numpy arrays (the names and layouts the
wire carries); :meth:`TorchModelOps.bind` makes the per-version copies a
server keeps. Training, evaluation and metrics come with the training
slice.
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from metisfl_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from metisfl_tpu_torch.models.generate import generate as _generate
from metisfl_tpu_torch.models.zoo.transformer import init_params


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (no quiet
    move to the CPU: pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


class TorchModelOps:
    """Inference engine around one module. ``variables`` (a Flax variables
    tree or named tensors) fills the weights; without it they are drawn
    from a ``torch.Generator`` seeded with ``rng_seed``. Runs on
    ``device`` (default ``"cuda"``, which raises without a GPU)."""

    def __init__(self, module: nn.Module, rng_seed: int = 0,
                 variables=None, device="cuda"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        if variables is not None:
            load_flax_variables(self.module, variables)
        else:
            init_params(self.module, torch.Generator().manual_seed(rng_seed))
        self._count_lock = threading.Lock()
        # module forwards run by infer (each is one padded batch)
        self.forward_calls = 0

    # -- weights I/O -------------------------------------------------------
    def get_variables(self):
        """The engine's weights as a Flax variables tree of numpy arrays."""
        return export_flax_variables(self.module)

    def set_variables(self, variables) -> None:
        load_flax_variables(self.module, variables)

    def bind(self, variables) -> nn.Module:
        """A copy of the engine's module holding ``variables`` on the
        engine's device (the install-time conversion a server does once per
        version, so no request re-uploads the model)."""
        return load_flax_variables(copy.deepcopy(self.module), variables)

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def infer(self, x: np.ndarray, batch_size: int = 256,
              model: Optional[nn.Module] = None) -> np.ndarray:
        """Batched forward pass → stacked outputs (logits) as numpy.
        ``model`` (from :meth:`bind`) runs an explicit version without
        touching the engine's own weights."""
        model = self.module if model is None else model
        outs = []
        for start in range(0, len(x), batch_size):
            batch = torch.as_tensor(np.asarray(x[start:start + batch_size]),
                                    device=self.device)
            out = model(batch)
            with self._count_lock:
                self.forward_calls += 1
            outs.append(out.cpu().numpy())
        if not outs:
            return np.zeros((0,), np.float32)
        return np.concatenate(outs, axis=0)

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 model: Optional[nn.Module] = None,
                 **sampling) -> np.ndarray:
        """Greedy KV-cache decoding (models/generate.py). Keyword arguments:
        ``eos_id``, ``pad_id``, ``max_len``; ``temperature > 0`` raises."""
        model = self.module if model is None else model
        return _generate(model, np.asarray(prompt, np.int32),
                         max_new_tokens, **sampling).cpu().numpy()
