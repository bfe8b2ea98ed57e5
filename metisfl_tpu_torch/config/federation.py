"""Federation and serving configuration: copies of the JAX package's
dataclasses (``config/federation.py``) with the fields the port reads.

``FederationConfig`` covers the synchronous FedAvg round over the
in-memory, disk, cached-disk and remote stores (with parallel ingest),
with the controller's endpoint, the learners' endpoints,
the transport's settings and TLS for the multi-process federation. It
travels to the controller process as codec bytes (``to_wire``) or YAML
(:func:`load_config`). It refuses at construction what the port does not
do yet: a request for a protocol, rule, tier, uplink encoding or
plane that is not ported raises ``NotImplementedError`` naming the ROADMAP
item that queues it, so no configuration is accepted and then silently
ignored. Values the JAX package rejects raise ``ValueError`` here too.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import List

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.messages import TrainParams
from metisfl_tpu_torch.comm.ssl import SSLConfig
from metisfl_tpu_torch.tensor.spec import resolve_ship_dtype


@dataclass
class ServingDecodeConfig:
    """Continuous-batching decode (serving/decode.py)."""

    # concurrent sequences per channel's in-flight batch
    slots: int = 4
    # KV-cache length: every request's prompt + max_new_tokens must fit
    max_len: int = 512


@dataclass
class ServingConfig:
    """Serving gateway (serving/gateway.py)."""

    # micro-batching: coalesce concurrent requests until the batch holds
    # max_batch rows or max_wait_ms elapsed since the first queued row.
    # Every forward pass pads to exactly max_batch rows, so per-row results
    # stay bit-identical to unbatched ones.
    max_batch: int = 8
    max_wait_ms: float = 5.0
    # deterministic canary: requests whose key hashes into the lowest
    # canary_percent slots route to the candidate channel (0 = all stable)
    canary_percent: float = 0.0
    decode: ServingDecodeConfig = field(default_factory=ServingDecodeConfig)


@dataclass
class TerminationConfig:
    """When the federation stops. The port's controller dispatches no train
    task after ``federation_rounds`` rounds (0 = no limit). The wall-clock
    and metric cutoffs are watched by the multi-process ``DriverSession``
    (``driver/session.py``), which then shuts the federation down; the
    in-process federation cannot watch them and refuses them."""

    federation_rounds: int = 10
    execution_cutoff_mins: float = 0.0       # 0 → no wall-clock cutoff
    metric_cutoff_score: float = 0.0         # 0 → no metric cutoff
    metric_name: str = "accuracy"            # the metric cutoff's metric


@dataclass
class SchedulingConfig:
    """Round scheduling. The port runs the full-cohort barrier
    (``quorum`` 0)."""

    quorum: int = 0


@dataclass
class TreeAggregationConfig:
    """The tree-aggregation tier (not ported: ``enabled`` raises)."""

    enabled: bool = False
    distributed: bool = False


@dataclass
class AggregationConfig:
    rule: str = "fedavg"
    scaler: str = "train_dataset_size"       # participants | train_dataset_size | batches
    stride_length: int = 0                   # 0 → all models in one block
    # how many learners train per round (1.0 = all)
    participation_ratio: float = 1.0
    streaming: bool = False
    tree: TreeAggregationConfig = field(default_factory=TreeAggregationConfig)


@dataclass
class ModelStoreConfig:
    store: str = "in_memory"                 # in_memory | disk | cached_disk
                                             # | remote
    lineage_length: int = 0                  # 0 → derive from the rule
    root: str = ""                           # disk stores' directory ("":
                                             # metisfl_tpu_store in the
                                             # temp directory)
    cache_mb: int = 256                      # cached_disk memory budget
    # store="remote": where python -m metisfl_tpu_torch.store.server (or
    # the JAX package's) serves
    host: str = "localhost"
    port: int = 0
    # > 0: a bounded pool of this many writers persists uplinks off the
    # completion path and aggregation fences on its drain before select
    # (store/ingest.py); 0 inserts on the completion path
    ingest_workers: int = 0


@dataclass
class SecureAggConfig:
    """Secure aggregation (not ported: ``enabled`` raises)."""

    enabled: bool = False


@dataclass
class CheckpointConfig:
    """Controller checkpoints (not ported: a ``dir`` raises)."""

    dir: str = ""


@dataclass
class EvalConfig:
    batch_size: int = 256
    datasets: List[str] = field(default_factory=lambda: ["test"])
    metrics: List[str] = field(default_factory=lambda: ["loss", "accuracy"])
    every_n_rounds: int = 1


@dataclass
class CommConfig:
    """Transport settings (``comm/rpc.py`` ``RpcClient``): the deadline of
    a call that passes ``timeout=None`` (``<= 0`` = unbounded), and how
    often and how far apart UNAVAILABLE is retried. DEADLINE_EXCEEDED is
    retried only for idempotent methods (getters, join, health)."""

    default_deadline_s: float = 120.0
    retries: int = 10
    retry_sleep_s: float = 1.0


@dataclass
class LearnerEndpoint:
    """Where DriverSession launches one learner; port 0 binds an ephemeral
    port, which the learner reports when it joins."""

    hostname: str = "localhost"
    port: int = 0
    # processes for this one learner (multi-host learners: not ported)
    world_size: int = 1


# names the JAX package accepts (the protocols beyond synchronous are not
# ported yet)
_PROTOCOLS = ("synchronous", "semi_synchronous", "asynchronous",
              "asynchronous_buffered")
_STORES = ("in_memory", "disk", "cached_disk", "remote")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to metisfl_tpu_torch yet (ROADMAP.md "
        f"Queue 1 item {item})")


@dataclass
class FederationConfig:
    protocol: str = "synchronous"
    # straggler deadline for a round (0 = none; deadlines not ported)
    round_deadline_secs: float = 0.0
    scheduling: SchedulingConfig = field(default_factory=SchedulingConfig)
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
    model_store: ModelStoreConfig = field(default_factory=ModelStoreConfig)
    secure: SecureAggConfig = field(default_factory=SecureAggConfig)
    termination: TerminationConfig = field(default_factory=TerminationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    train: TrainParams = field(default_factory=TrainParams)
    eval: EvalConfig = field(default_factory=EvalConfig)
    comm: CommConfig = field(default_factory=CommConfig)
    ssl: SSLConfig = field(default_factory=SSLConfig)
    # the controller's endpoint; DriverSession binds an ephemeral port and
    # reads it back when controller_port is 0
    controller_host: str = "localhost"
    controller_port: int = 50051
    learners: List[LearnerEndpoint] = field(default_factory=list)

    def __post_init__(self):
        if self.protocol not in _PROTOCOLS:
            raise ValueError(f"unknown protocol {self.protocol!r}")
        if self.protocol != "synchronous":
            raise not_ported(f"protocol {self.protocol!r}", "3f")
        agg, sched, train = self.aggregation, self.scheduling, self.train
        if self.secure.enabled or agg.rule.lower() == "secure_agg":
            raise not_ported("secure aggregation", "3c")
        if agg.rule.lower() == "scaffold":
            raise not_ported("SCAFFOLD", "3e")
        if agg.rule.lower() != "fedavg":
            raise not_ported(f"aggregation rule {agg.rule!r}", "3c")
        if agg.streaming:
            raise not_ported("aggregation.streaming", "3c")
        if agg.tree.enabled or agg.tree.distributed:
            raise not_ported("the tree-aggregation tier", "3c")
        if not 0.0 < agg.participation_ratio <= 1.0:
            raise ValueError("participation_ratio must be in (0, 1]")
        if self.model_store.store not in _STORES:
            raise ValueError(f"unknown store {self.model_store.store!r}")
        if self.model_store.ingest_workers < 0:
            raise ValueError("model_store.ingest_workers must be >= 0")
        if self.checkpoint.dir:
            raise not_ported("controller checkpoints", "3f")
        if self.round_deadline_secs > 0:
            raise not_ported("round deadlines", "3f")
        if sched.quorum < 0:
            raise ValueError("scheduling.quorum must be >= 0")
        if sched.quorum > 0:
            raise not_ported("quorum barriers", "3f")
        term = self.termination
        if term.federation_rounds < 0:
            raise ValueError("termination.federation_rounds must be >= 0")
        if term.execution_cutoff_mins < 0 or term.metric_cutoff_score < 0:
            raise ValueError("termination cutoffs must be >= 0")
        if any(ep.world_size > 1 for ep in self.learners):
            raise not_ported("multi-host learners (world_size > 1)", "9")
        if train.dp_noise_multiplier < 0.0 or train.dp_clip_norm < 0.0:
            raise ValueError("dp_clip_norm and dp_noise_multiplier must be "
                             ">= 0")
        if train.dp_clip_norm > 0.0 or train.dp_noise_multiplier > 0.0:
            raise not_ported("client-level differential privacy", "3e")
        if train.ship_dtype:
            name = train.ship_dtype.lower()
            if name == "int8q" or name.startswith("topk"):
                raise not_ported(f"ship_dtype {train.ship_dtype!r}", "3e")
            # an unknown name is a ValueError, as in the JAX package
            resolve_ship_dtype(train.ship_dtype)
        if train.downlink_dtype:
            raise not_ported("downlink_dtype", "3e")
        if train.local_tensor_regex or train.ship_tensor_regex:
            raise not_ported("local_tensor_regex / ship_tensor_regex", "3e")

    def to_wire(self) -> bytes:
        return dumps(_to_plain(self))

    @classmethod
    def from_wire(cls, buf) -> "FederationConfig":
        return _from_plain(cls, loads(buf))


def _to_plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_to_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


def _from_plain(cls, data):
    """A dataclass from plain dicts and lists; fields it does not know are
    ignored, as the JAX package ignores them."""
    if not dataclasses.is_dataclass(cls):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        hint = hints.get(f.name)
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _from_plain(hint, value)
        elif isinstance(value, list):
            args = typing.get_args(hint)
            if args and dataclasses.is_dataclass(args[0]):
                value = [_from_plain(args[0], v) for v in value]
        kwargs[f.name] = value
    return cls(**kwargs)


def load_config(path: str) -> FederationConfig:
    """A federation environment from YAML."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _from_plain(FederationConfig, data)
