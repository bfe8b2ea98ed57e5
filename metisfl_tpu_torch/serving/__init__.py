"""Serving gateway: micro-batched Predict and continuous-batching Generate
over registry channels, in process (the gRPC server and the fleet router
come with a later slice)."""

from metisfl_tpu_torch.serving.decode import ContinuousBatcher
from metisfl_tpu_torch.serving.gateway import (
    CHANNEL_CANDIDATE,
    CHANNEL_STABLE,
    ControllerRegistrySource,
    DirectRegistrySource,
    MicroBatcher,
    ServingGateway,
    canary_channel,
)

__all__ = ["ServingGateway", "MicroBatcher", "ContinuousBatcher",
           "canary_channel", "CHANNEL_STABLE", "CHANNEL_CANDIDATE",
           "DirectRegistrySource", "ControllerRegistrySource"]
