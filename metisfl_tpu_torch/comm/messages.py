"""The port's copies of the JAX package's federation messages
(``comm/messages.py``): ``TrainParams``, ``JoinRequest``/``JoinReply``,
``TrainTask``/``TaskResult`` and ``EvalTask``/``EvalResult``, with the same
field names and defaults. Each is a :class:`Message`: ``to_wire`` encodes
its fields, nested messages as dicts, with the codec (``comm/codec.py``)
and ``from_wire`` reads them back, ignoring fields it does not know. Since
every field keeps its name, the bytes equal the JAX package's for the same
values, and a learner or controller of either package reads the other's
messages, over the wire or by attribute in one process.

Fields keep their meaning in both engines: ``profile_dir`` and
``profile_steps`` arm a ``torch.profiler`` capture of that many training
steps here, ``device_stats`` asks the learner for its device stats, and
``scan_chunk`` changes only how often the host waits for the device, never
the result. The transport fields (``ship_*``,
``downlink_dtype``, ``local_tensor_regex``, ``dp_*``) are read by the
learner and the aggregation slices.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, get_type_hints

from metisfl_tpu_torch.comm.codec import dumps, loads


@functools.lru_cache(maxsize=None)
def _hints_for(cls):
    return get_type_hints(cls)


class Message:
    """Base of the messages: dataclass ⇄ codec bytes, nested messages
    included."""

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, Message):
                value = value.to_dict()
            elif (isinstance(value, list) and value
                  and isinstance(value[0], Message)):
                value = [v.to_dict() for v in value]
            out[f.name] = value
        return out

    @classmethod
    def from_dict(cls, data: dict):
        hints = _hints_for(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            value = data[f.name]
            hint = hints.get(f.name)
            if (isinstance(hint, type) and issubclass(hint, Message)
                    and isinstance(value, dict)):
                value = hint.from_dict(value)
            elif isinstance(value, list):
                args = getattr(hint, "__args__", ())
                if (args and isinstance(args[0], type)
                        and issubclass(args[0], Message)):
                    value = [args[0].from_dict(v) for v in value]
            kwargs[f.name] = value
        return cls(**kwargs)

    def to_wire(self) -> bytes:
        return dumps(self.to_dict())

    @classmethod
    def from_wire(cls, buf):
        return cls.from_dict(loads(buf))


@dataclass
class TrainParams(Message):
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
    # a profiler capture of profile_steps steady-state steps into this
    # directory ("" = none; the learner namespaces it by its id)
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


@dataclass
class JoinRequest(Message):
    hostname: str = "localhost"
    port: int = 0
    num_train_examples: int = 0
    num_val_examples: int = 0
    num_test_examples: int = 0
    # rejoin: a restarted learner presents its previous identity
    previous_id: str = ""
    auth_token: str = ""
    capabilities: Dict[str, Any] = field(default_factory=dict)


@dataclass
class JoinReply(Message):
    learner_id: str = ""
    auth_token: str = ""
    rejoined: bool = False
    # controller incarnation id, fresh per controller object
    controller_epoch: str = ""


@dataclass
class TrainTask(Message):
    task_id: str = ""
    learner_id: str = ""
    round_id: int = 0
    global_iteration: int = 0
    model: bytes = b""          # ModelBlob wire bytes (community model)
    params: TrainParams = field(default_factory=TrainParams)
    # SCAFFOLD: the rule is on, and the server control variate's blob
    # (empty until the first cohort's deltas fold in)
    scaffold: bool = False
    control: bytes = b""
    controller_epoch: str = ""


@dataclass
class TaskResult(Message):
    task_id: str = ""
    learner_id: str = ""
    # the controller accepts a model only with the learner's token
    auth_token: str = ""
    # the dispatching incarnation (the TrainTask's controller_epoch)
    controller_epoch: str = ""
    round_id: int = 0
    model: bytes = b""          # locally trained ModelBlob
    num_train_examples: int = 0
    completed_steps: int = 0
    completed_epochs: float = 0.0
    completed_batches: int = 0
    processing_ms_per_step: float = 0.0
    train_metrics: Dict[str, float] = field(default_factory=dict)
    epoch_metrics: List[Dict[str, float]] = field(default_factory=list)
    control_delta: bytes = b""
    device_stats: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvalTask(Message):
    task_id: str = ""
    learner_id: str = ""
    round_id: int = 0
    model: bytes = b""
    batch_size: int = 256
    datasets: List[str] = field(default_factory=lambda: ["test"])
    metrics: List[str] = field(default_factory=lambda: ["loss", "accuracy"])
    local_tensor_regex: str = ""
    ship_tensor_regex: str = ""
    controller_epoch: str = ""


@dataclass
class EvalResult(Message):
    task_id: str = ""
    learner_id: str = ""
    round_id: int = 0
    # dataset name -> {metric -> value}
    evaluations: Dict[str, Dict[str, float]] = field(default_factory=dict)
    duration_ms: float = 0.0
