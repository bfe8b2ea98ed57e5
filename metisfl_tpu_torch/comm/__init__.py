"""Messages the port exchanges; the wire codec comes with the gRPC slice."""

from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    TaskResult,
    TrainParams,
    TrainTask,
)

__all__ = ["TrainParams", "JoinRequest", "JoinReply", "TrainTask",
           "TaskResult", "EvalTask", "EvalResult"]
