"""Models: the LlamaLite zoo slice, weight conversion, decoding and the
inference engine."""

from metisfl_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from metisfl_tpu_torch.models.generate import SlotDecoder, generate, init_cache
from metisfl_tpu_torch.models.ops import TorchModelOps, resolve_device

__all__ = ["TorchModelOps", "resolve_device", "generate", "init_cache",
           "SlotDecoder", "load_flax_variables", "export_flax_variables"]
