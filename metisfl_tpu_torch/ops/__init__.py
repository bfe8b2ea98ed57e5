"""Hand-written CUDA kernels for the hot ops, with their plain twins."""

from metisfl_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "attention", "FLASH_MIN_SEQ"]
