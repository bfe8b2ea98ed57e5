"""Federation and serving configuration: the port's copies of the JAX
package's ``config`` dataclasses, with the fields the port reads."""

from metisfl_tpu_torch.config.federation import (
    AggregationConfig,
    CheckpointConfig,
    EvalConfig,
    FederationConfig,
    ModelStoreConfig,
    SchedulingConfig,
    SecureAggConfig,
    ServingConfig,
    ServingDecodeConfig,
    TerminationConfig,
    TreeAggregationConfig,
)

__all__ = [
    "FederationConfig", "AggregationConfig", "TreeAggregationConfig",
    "SchedulingConfig", "ModelStoreConfig", "SecureAggConfig",
    "TerminationConfig", "CheckpointConfig", "EvalConfig", "ServingConfig",
    "ServingDecodeConfig",
]
