"""Torch model zoo: the JAX package's MLPs, small CNNs and the LlamaLite
part of its transformers."""

from metisfl_tpu_torch.models.zoo.cnn import (
    BrainAge3DCNN,
    Cifar10CNN,
    Conv,
    FashionMnistCNN,
)
from metisfl_tpu_torch.models.zoo.mlp import MLP, HousingMLP
from metisfl_tpu_torch.models.zoo.transformer import (
    Attention,
    DecoderBlock,
    Dense,
    Embed,
    LlamaLite,
    LoRADense,
    RMSNorm,
    SwiGLU,
    init_params,
)

__all__ = ["MLP", "HousingMLP", "FashionMnistCNN", "Cifar10CNN",
           "BrainAge3DCNN", "Conv", "LlamaLite", "DecoderBlock", "Attention",
           "SwiGLU", "LoRADense", "Dense", "Embed", "RMSNorm", "init_params"]
