"""The port's copy of the JAX package's ``TrainParams``
(metisfl_tpu/comm/messages.py): the same fields with the same defaults, as
a plain dataclass. The ``Message`` base class and its wire codec are not
needed yet: training takes the dataclass in process.

Fields that matter only to the JAX engine are kept so that one task's
parameters fit both engines: ``profile_dir`` and ``profile_steps`` are
ignored (``torch.profiler`` is driven from outside), ``device_stats`` is
read by the learner, and ``scan_chunk`` changes only how often the host
waits for the device, never the result. The transport fields (``ship_*``,
``downlink_dtype``, ``local_tensor_regex``, ``dp_*``) are read by the
learner and the aggregation slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class TrainParams:
    """Local-training hyperparameters shipped with every task."""

    batch_size: int = 32
    local_steps: int = 0        # exact optimizer steps; 0 → derive from epochs
    local_epochs: float = 1.0   # used when local_steps == 0
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    optimizer_kwargs: Dict[str, Any] = field(default_factory=dict)
    # FedProx proximal term weight; 0 disables
    proximal_mu: float = 0.0
    # weight on sown auxiliary losses (MoE router load balancing); the
    # port's LlamaLite has no MoE yet, so nothing reads it
    moe_aux_weight: float = 0.01
    # the JAX engine's jax.profiler capture; ignored here
    profile_dir: str = ""
    profile_steps: int = 3
    # per-task device utilization report (learner)
    device_stats: bool = True
    # steps between host syncs (loss read-back, cancellation check); the
    # JAX engine fuses them into one lax.scan program. Same results.
    scan_chunk: int = 1
    # wire dtype for shipped weights ("bf16", "f16", "f32", "int8q"; ""
    # ships the training dtype)
    ship_dtype: str = ""
    # wire dtype for the community-model downlink ("" = stored dtype)
    downlink_dtype: str = ""
    # tensors matching this regex stay local to each learner (FedBN)
    local_tensor_regex: str = ""
    # only tensors matching this regex are federated (LoRA adapters)
    ship_tensor_regex: str = ""
    # client-level differential privacy on the shipped update
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
