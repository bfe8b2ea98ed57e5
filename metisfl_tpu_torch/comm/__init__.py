"""Messages the port exchanges; the wire codec comes with the gRPC slice."""

from metisfl_tpu_torch.comm.messages import TrainParams

__all__ = ["TrainParams"]
