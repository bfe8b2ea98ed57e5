"""Drivers: the in-process federation, and ``DriverSession``, which runs a
controller and its learners as processes over gRPC."""

from metisfl_tpu_torch.driver.inprocess import InProcessFederation
from metisfl_tpu_torch.driver.session import DriverSession, LocalLauncher

__all__ = ["InProcessFederation", "DriverSession", "LocalLauncher"]
