"""Federation and serving configuration: the port's copies of the JAX
package's ``config`` dataclasses, with the fields the port reads."""

from metisfl_tpu_torch.config.federation import (
    AggregationConfig,
    ChaosConfig,
    CheckpointConfig,
    CommConfig,
    ControllerConfig,
    ControllerStandbyConfig,
    EvalConfig,
    EventsConfig,
    FabricConfig,
    FailoverConfig,
    FederationConfig,
    HealthConfig,
    LearnerEndpoint,
    ModelStoreConfig,
    ProfConfig,
    ProfileConfig,
    PromotionConfig,
    RegistryConfig,
    RuntimeConfig,
    SchedulingConfig,
    SecureAggConfig,
    ServingConfig,
    ServingDecodeConfig,
    TelemetryConfig,
    TerminationConfig,
    TreeAggregationConfig,
    load_config,
)
from metisfl_tpu_torch.comm.ssl import SSLConfig

__all__ = [
    "FederationConfig", "AggregationConfig", "TreeAggregationConfig",
    "SchedulingConfig", "ModelStoreConfig", "SecureAggConfig",
    "TerminationConfig", "CheckpointConfig", "ChaosConfig", "EvalConfig",
    "ServingConfig",
    "ServingDecodeConfig", "CommConfig", "LearnerEndpoint", "SSLConfig",
    "FailoverConfig", "ControllerConfig", "ControllerStandbyConfig",
    "PromotionConfig", "RegistryConfig", "TelemetryConfig", "EventsConfig",
    "HealthConfig", "ProfileConfig", "ProfConfig", "RuntimeConfig",
    "FabricConfig", "load_config",
]
