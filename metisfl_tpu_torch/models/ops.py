"""TorchModelOps — the JAX package's ``FlaxModelOps`` around one torch
module: local training, evaluation and inference.

The engine owns a module and its weights on one device. Weights go in and
out as Flax variables trees of numpy arrays (the names and layouts the
wire carries); :meth:`TorchModelOps.bind` makes the per-version copies a
server keeps.

Training (:meth:`TorchModelOps.train`) runs **exactly N optimizer steps**
with optax's update rules (models/optimizers.py): FedProx as a proximal
loss term, ``trainable_regex`` freezing by Flax tensor name, and the
SCAFFOLD ``grad_offset`` added to the gradients, as the JAX engine does.
PyTorch runs eagerly, so the JAX engine's compiled step and its fused
``lax.scan`` chunks have no counterpart: ``scan_chunk`` only sets how many
steps run between host syncs.

A step is deterministic on the card, as the JAX engine's is: the same
weights and batches give the same bits in any process, which a failover's
re-run round relies on. The flash kernels, ``F.embedding``'s backward and
cuBLAS are; cuDNN's convolutions are once ``torch.backends.cudnn.
deterministic`` is set (its default backward algorithms add with atomics),
which an engine on a CUDA device sets.
"""

from __future__ import annotations

import copy
import inspect
import logging
import math
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metisfl_tpu_torch.comm.messages import TrainParams
from metisfl_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from metisfl_tpu_torch.models.dataset import ArrayDataset
from metisfl_tpu_torch.models.generate import generate as _generate
from metisfl_tpu_torch.models.optimizers import apply_updates, make_optimizer
from metisfl_tpu_torch.models.zoo.transformer import Dropout, init_params
from metisfl_tpu_torch.tensor.pytree import as_tensor, pytree_to_named_tensors

logger = logging.getLogger("metisfl_tpu_torch.models")


@dataclass
class TrainOutput:
    variables: Any
    completed_steps: int
    completed_batches: int
    completed_epochs: float
    ms_per_step: float
    train_metrics: Dict[str, float]
    epoch_metrics: List[Dict[str, float]] = field(default_factory=list)


def softmax_cross_entropy_loss(logits: torch.Tensor,
                               y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (any leading
    shape), optax's ``softmax_cross_entropy_with_integer_labels``."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1).long())


def mse_loss(preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(preds - y))


_LOSSES = {
    "softmax_cross_entropy": softmax_cross_entropy_loss,
    "mse": mse_loss,
}


def _accuracy(logits, y):
    return (logits.argmax(dim=-1) == y).float().mean()


def _top5_accuracy(logits, y):
    k = min(5, logits.shape[-1])
    top = logits.topk(k, dim=-1).indices
    return (top == y[..., None]).any(dim=-1).float().mean()


def _mse_metric(preds, y):
    return torch.mean(torch.square(preds.squeeze() - y))


def _mae_metric(preds, y):
    return torch.mean(torch.abs(preds.squeeze() - y))


# Evaluation metric registry, the JAX package's: each metric maps (model
# outputs, labels) → a scalar tensor.
METRICS: Dict[str, Callable] = {
    "accuracy": _accuracy,
    "top5_accuracy": _top5_accuracy,
    "mse": _mse_metric,
    "mae": _mae_metric,
}


def register_metric(name: str, fn: Callable) -> None:
    """Register a custom eval metric ``fn(outputs, labels) -> scalar``."""
    METRICS[name] = fn


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
    """Train/eval/inference engine around one module. ``variables`` (a
    Flax variables tree or named tensors) fills the weights; without it
    they are drawn from a ``torch.Generator`` seeded with ``rng_seed``,
    which also seeds the masks of the zoo's ``Dropout`` layers in training
    (a module's own ``nn.Dropout`` draws from torch's default generator,
    which the engine leaves alone). ``loss`` names a loss (or is a
    callable ``loss(outputs, labels)``); ``trainable_regex`` freezes every
    parameter whose Flax name does not match it (LoRA: ``"lora_"``). Runs
    on ``device`` (default ``"cuda"``, which raises without a GPU)."""

    def __init__(self, module: nn.Module, rng_seed: int = 0,
                 variables=None, device="cuda",
                 loss: Union[str, Callable] = "softmax_cross_entropy",
                 trainable_regex: str = ""):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # deterministic convolution algorithms (module docstring)
            torch.backends.cudnn.deterministic = True
        self.module = module.to(self.device).eval()
        if variables is not None:
            load_flax_variables(self.module, variables)
        else:
            init_params(self.module, torch.Generator().manual_seed(rng_seed))
        self._generator = torch.Generator().manual_seed(rng_seed)
        self.loss_fn = _LOSSES[loss] if isinstance(loss, str) else loss
        self._trainable_regex = trainable_regex
        self._takes_train = "train" in inspect.signature(
            self.module.forward).parameters
        self._count_lock = threading.Lock()
        # module forwards run by infer (each is one padded batch)
        self.forward_calls = 0

    # -- cost accounting ---------------------------------------------------
    def param_count(self) -> int:
        """Parameter count (the ``params`` collection's leaves)."""
        return int(sum(p.numel() for p in self.module.parameters()))

    def step_flops(self, batch_size: int) -> float:
        """Estimated FLOPs of one optimizer step at ``batch_size``: the
        dense-layer approximation 6·params·batch (2 forward + 4 backward
        matmul FLOPs per parameter per example), the JAX engine's."""
        return 6.0 * self.param_count() * max(1, int(batch_size))

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

    def _apply(self, model: nn.Module, x, train: bool) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x), device=self.device)
        return model(x, train=train) if self._takes_train else model(x)

    def _labels(self, y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(y), device=self.device)

    # -- training ----------------------------------------------------------
    def _trainable(self):
        """``(names, params)`` of the parameters training updates, named as
        in the Flax ``params`` tree (``block_0/attn/wq/lora_a``)."""
        named = [(n.replace(".", "/"), p)
                 for n, p in self.module.named_parameters()]
        regex = self._trainable_regex
        if regex:
            named = [(n, p) for n, p in named if re.search(regex, n)]
            if not named:
                raise ValueError(
                    f"trainable_regex {regex!r} matches no params — "
                    "training would silently be a no-op (did you forget "
                    "lora_rank > 0?)")
        return [n for n, _ in named], [p for _, p in named]

    def _offsets(self, grad_offset, names) -> Optional[List[torch.Tensor]]:
        """The SCAFFOLD offsets of the trainable parameters, from a
        params-shaped tree (or a ``{"params": ...}`` variables tree);
        None or an empty tree means no correction."""
        if grad_offset is None:
            return None
        tree = grad_offset
        if isinstance(tree, dict) and set(tree) == {"params"}:
            tree = tree["params"]
        given = dict(pytree_to_named_tensors(tree))
        if not given:
            return None
        missing = [n for n in names if n not in given]
        if missing:
            raise KeyError(f"grad_offset is missing tensors: {missing[:5]}")
        return [as_tensor(given[n]).to(self.device, torch.float32)
                for n in names]

    def train(self, dataset: ArrayDataset, params_cfg: TrainParams,
              cancel_event=None, grad_offset=None) -> TrainOutput:
        """Exactly ``local_steps`` optimizer steps (or ``ceil(local_epochs
        · steps_per_epoch)`` of them) over ``dataset.infinite_batches``.
        ``grad_offset``: optional params-shaped tree ADDED to every step's
        gradients (SCAFFOLD c − c_i). The module is left in eval mode."""
        steps_per_epoch = max(1, len(dataset) // max(1, params_cfg.batch_size))
        if params_cfg.local_steps > 0:
            total_steps = params_cfg.local_steps
        else:
            total_steps = max(1, int(math.ceil(
                params_cfg.local_epochs * steps_per_epoch)))
        names, params = self._trainable()
        offsets = self._offsets(grad_offset, names)
        mu = float(params_cfg.proximal_mu)
        # FedProx anchors to a copy of the round-start weights
        anchors = [p.detach().clone() for p in params] if mu > 0 else None
        tx = make_optimizer(params_cfg.optimizer, params_cfg.learning_rate,
                            params_cfg.optimizer_kwargs)
        with torch.no_grad():
            opt_state = tx.init(params)

        def step(x, y):
            nonlocal opt_state
            outputs = self._apply(self.module, x, train=True)
            labels = self._labels(y)
            loss = self.loss_fn(outputs, labels)
            if anchors is not None:
                prox = sum(torch.sum(torch.square(p - p0))
                           for p, p0 in zip(params, anchors))
                loss = loss + 0.5 * mu * prox
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                if offsets is not None:
                    grads = [g + o.to(g.dtype)
                             for g, o in zip(grads, offsets)]
                updates, opt_state = tx.update(list(grads), opt_state,
                                               params)
                apply_updates(params, updates)
                return loss.detach(), _accuracy(outputs.detach(), labels)

        losses: List[float] = []
        accs: List[float] = []
        epoch_metrics: List[Dict[str, float]] = []
        epoch_losses: List[tuple] = []
        step_times: List[float] = []
        first_time: Optional[float] = None
        completed = 0
        stream = dataset.infinite_batches(params_cfg.batch_size)
        chunk = max(1, int(params_cfg.scan_chunk))
        # dropout masks: a generator of this call on the engine's device,
        # seeded from the engine's own (no global state, so engines that
        # train in parallel threads keep their own streams)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._generator))
        dropouts = [m for m in self.module.modules()
                    if isinstance(m, Dropout)]
        masks = torch.Generator(device=self.device).manual_seed(seed)
        for m in dropouts:
            m.generator = masks
        self.module.train()
        try:
            while completed < total_steps:
                if cancel_event is not None and cancel_event.is_set():
                    break
                n = min(chunk, total_steps - completed)
                t0 = time.perf_counter()
                pending = [step(*next(stream)) for _ in range(n)]
                # one host sync per chunk: read the chunk's metrics
                stats = torch.stack([torch.stack(p) for p in pending]
                                    ).float().cpu().tolist()
                dt = (time.perf_counter() - t0) / n
                if completed == 0:
                    # the first chunk pays the warm-up (allocator, kernel
                    # builds); steady-state timing skips it
                    first_time = dt
                else:
                    step_times.extend([dt] * n)
                for loss, acc in stats:
                    completed += 1
                    epoch_losses.append((loss, acc))
                    if (completed % steps_per_epoch == 0
                            or completed == total_steps):
                        self._flush(epoch_losses, epoch_metrics, losses,
                                    accs)
        finally:
            for m in dropouts:
                m.generator = None
            self.module.eval()
        self._flush(epoch_losses, epoch_metrics, losses, accs)
        if not step_times and first_time is not None:
            step_times = [first_time]
        ms_per_step = float(np.median(step_times) * 1e3) if step_times else 0.0
        return TrainOutput(
            variables=self.get_variables(),
            completed_steps=completed,
            completed_batches=completed,
            completed_epochs=completed / steps_per_epoch,
            ms_per_step=ms_per_step,
            train_metrics={
                "loss": float(np.mean(losses)) if losses else float("nan"),
                "accuracy": float(np.mean(accs)) if accs else float("nan"),
            },
            epoch_metrics=epoch_metrics,
        )

    @staticmethod
    def _flush(epoch_losses, epoch_metrics, losses, accs) -> None:
        """Close an epoch: its mean loss and accuracy, and the run's."""
        if not epoch_losses:
            return
        ls = [l for l, _ in epoch_losses]
        as_ = [a for _, a in epoch_losses]
        epoch_metrics.append({"loss": float(np.mean(ls)),
                              "accuracy": float(np.mean(as_))})
        losses.extend(ls)
        accs.extend(as_)
        epoch_losses.clear()

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, dataset: ArrayDataset, batch_size: int = 256,
                 metrics: Optional[List[str]] = None,
                 variables=None) -> Dict[str, float]:
        """Evaluate ``variables`` (default: the engine's current model).

        ``metrics`` selects from :data:`METRICS` (loss is always reported;
        unregistered names are skipped with a warning, as the JAX engine
        does). Passing variables evaluates them on a bound copy, leaving
        the engine's own weights alone."""
        requested = [m for m in (metrics or ["accuracy"]) if m != "loss"]
        unknown = [m for m in requested if m not in METRICS]
        if unknown:
            logger.warning("skipping unregistered eval metrics %s "
                           "(registered: %s)", unknown, sorted(METRICS))
        names = tuple(m for m in requested if m in METRICS)
        model = self.module if variables is None else self.bind(variables)
        totals = {name: 0.0 for name in ("loss",) + names}
        count = 0
        for x, y in dataset.batches(batch_size, shuffle=False):
            n = x.shape[0]
            outputs = self._apply(model, x, train=False)
            labels = self._labels(y)
            vals = {"loss": self.loss_fn(outputs, labels)}
            for name in names:
                vals[name] = METRICS[name](outputs, labels)
            for name, v in vals.items():
                totals[name] += float(v) * n
            count += n
        if count == 0:
            return {}
        return {name: total / count for name, total in totals.items()}

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
