"""The versioned community-model registry (the model lifecycle plane):
every aggregated round mints a candidate version, eval-gated promotion
moves it to ``stable``, and the serving gateway installs promoted
versions (serving/gateway.py ``start_sync``)."""

from metisfl_tpu_torch.registry.registry import (
    CHANNEL_CANDIDATE,
    CHANNEL_STABLE,
    ModelRegistry,
    VersionInfo,
)

__all__ = [
    "ModelRegistry",
    "VersionInfo",
    "CHANNEL_CANDIDATE",
    "CHANNEL_STABLE",
]
