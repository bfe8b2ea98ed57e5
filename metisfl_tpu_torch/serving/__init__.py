"""Serving: micro-batched Predict and continuous-batching Generate over
registry channels, in process or behind gRPC, one gateway or a fleet.

The port's copy of the JAX package's ``serving/``: a driver-bootable
process (``python -m metisfl_tpu_torch.serving``) serves the promoted
community model over the federation's BytesService RPC with a
micro-batching queue, atomic hot-swap on promotion and a deterministic
canary split toward the candidate channel; a fleet of such replicas sits
behind a consistent-hash router (``--router``) that the driver supervises
and autoscales.
"""

from metisfl_tpu_torch.serving.decode import ContinuousBatcher
from metisfl_tpu_torch.serving.fleet import (
    FleetAutoscaler,
    HashRing,
    RouterServer,
    ServingRouter,
    poll_stagger,
)
from metisfl_tpu_torch.serving.gateway import (
    CHANNEL_CANDIDATE,
    CHANNEL_STABLE,
    ControllerRegistrySource,
    DirectRegistrySource,
    MicroBatcher,
    ServingGateway,
    canary_channel,
)
from metisfl_tpu_torch.serving.service import (
    SERVING_SERVICE,
    ServingClient,
    ServingServer,
)

__all__ = [
    "ServingGateway",
    "MicroBatcher",
    "ContinuousBatcher",
    "ControllerRegistrySource",
    "DirectRegistrySource",
    "canary_channel",
    "CHANNEL_STABLE",
    "CHANNEL_CANDIDATE",
    "ServingServer",
    "ServingClient",
    "ServingRouter",
    "RouterServer",
    "FleetAutoscaler",
    "HashRing",
    "poll_stagger",
    "SERVING_SERVICE",
]
