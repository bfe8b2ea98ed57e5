"""Drivers. The port has the in-process federation; the multi-process
``DriverSession`` waits for the wire codec and gRPC (ROADMAP.md Queue 1
item 3a)."""

from metisfl_tpu_torch.driver.inprocess import InProcessFederation

__all__ = ["InProcessFederation"]
