"""Torch model zoo: the serving slice of the JAX package's zoo."""

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

__all__ = ["LlamaLite", "DecoderBlock", "Attention", "SwiGLU", "LoRADense",
           "Dense", "Embed", "RMSNorm", "init_params"]
