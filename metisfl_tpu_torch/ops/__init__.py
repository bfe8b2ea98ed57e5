"""Hand-written CUDA kernels for the hot ops, with their plain twins."""

from metisfl_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "attention", "FLASH_MIN_SEQ"]
