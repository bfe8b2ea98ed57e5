"""Federation controller (the synchronous FedAvg round)."""

from metisfl_tpu_torch.controller.core import (
    Controller,
    LearnerProxy,
    LearnerRecord,
    RoundMetadata,
)

__all__ = ["Controller", "LearnerProxy", "LearnerRecord", "RoundMetadata"]
