"""The wire: the codec, the federation messages and the gRPC transport
(``comm/rpc.py``, ``comm/health.py``, ``comm/ssl.py``; those import grpc
where the transport is built)."""

from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.comm.messages import (
    EvalResult,
    EvalTask,
    JoinReply,
    JoinRequest,
    Message,
    TaskResult,
    TrainParams,
    TrainTask,
)

__all__ = ["dumps", "loads", "Message", "TrainParams", "JoinRequest",
           "JoinReply", "TrainTask", "TaskResult", "EvalTask", "EvalResult"]
