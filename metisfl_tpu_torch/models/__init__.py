"""Models: the LlamaLite zoo slice, weight conversion, decoding, datasets,
optimizers and the train/eval/inference engine."""

from metisfl_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from metisfl_tpu_torch.models.dataset import ArrayDataset
from metisfl_tpu_torch.models.generate import SlotDecoder, generate, init_cache
from metisfl_tpu_torch.models.ops import (
    METRICS,
    TorchModelOps,
    TrainOutput,
    register_metric,
    resolve_device,
)
from metisfl_tpu_torch.models.optimizers import make_optimizer

__all__ = ["TorchModelOps", "TrainOutput", "METRICS", "register_metric",
           "resolve_device", "ArrayDataset", "make_optimizer", "generate",
           "init_cache", "SlotDecoder", "load_flax_variables",
           "export_flax_variables"]
