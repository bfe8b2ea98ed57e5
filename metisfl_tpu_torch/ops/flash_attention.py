"""Flash attention forward: a CUDA kernel for Hopper and its plain twin.

The JAX package's TPU kernel ``_fwd_kernel`` (metisfl_tpu/ops/
flash_attention.py) becomes ``csrc/flash_fwd.cu``, written for sm_90a and
loaded through ``ctypes`` (ops/build.py). :func:`flash_attention_fwd` is its
wrapper: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
:func:`flash_attention_fwd_reference`, the plain PyTorch version of the same
function. There is no fallback from one to the other.

Layout is the JAX package's (B, H, L, D) with scale 1/sqrt(D). GQA is
native: ``k``/``v`` may carry fewer heads than ``q`` (Hq a multiple of Hkv)
and query head h reads kv head h // (Hq // Hkv). The forward returns
``(o, lse)`` with lse in logical layout (B, Hq, L) fp32, the shape ring
attention consumes.

This slice serves inference only: the backward kernels (``_dq_kernel``,
``_dkv_kernel``) and the autograd wrapper come with the training slice, so
:func:`flash_attention` refuses inputs that require a gradient.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)

_launch_lock = threading.Lock()


def _gqa_shapes(q: torch.Tensor, k: torch.Tensor):
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of KV heads ({Hkv})")
    return B, Hq, Hkv, L, D


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """Each KV head repeated ``group`` times contiguously (``jnp.repeat``
    on axis 1): query head h then lines up with kv head h // group."""
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: a dense fp32 softmax with GQA
    grouping. Returns ``(o in q.dtype, lse (B, Hq, L) fp32)``."""
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    group = Hq // Hkv
    qf = q.float()
    kf = _repeat_kv(k.float(), group)
    vf = _repeat_kv(v.float(), group)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * float(1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return o.to(q.dtype), lse


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32/float16/bfloat16, "
                         f"got {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    if k.shape[0] != B or k.shape[2] != L or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    if L < 1 or B * Hq > 65535:  # gridDim.y carries b * Hq + h
        raise ValueError(f"shape {tuple(q.shape)} is outside the kernel's "
                         "grid")


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built on
    first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from metisfl_tpu_torch.ops.build import load

            lib = load("flash_fwd")
            fn = lib.metisfl_flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.metisfl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.metisfl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(o, lse)`` for (B, Hq, L, D) q and (B, Hkv, L, D) k/v.

    CPU tensors run :func:`flash_attention_fwd_reference`. CUDA tensors
    launch ``csrc/flash_fwd.cu`` on the current stream (D in {64, 128};
    fp32, fp16 or bf16; contiguous) and raise on anything else.
    ``flash_attention_fwd.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on cuda tensors, got "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v)
    lib = _library()
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.metisfl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, L, D, _DTYPE_CODES[q.dtype],
            int(bool(causal)), float(1.0 / math.sqrt(D)), stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.metisfl_cuda_error_string(err).decode())
    with _launch_lock:
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention output over (B, H, L, D), GQA-native. Forward only
    in this slice: inputs that require a gradient are refused."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward (K2/K3) is not ported yet; run under "
            "torch.no_grad() or use the dense path")
    return flash_attention_fwd(q, k, v, causal)[0]


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    """The routed dense path: scores in the compute dtype, softmax in
    fp32, probabilities cast back before the PV product."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * float(
        1.0 / math.sqrt(D))
    if causal:
        L = q.shape[2]
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# Flash-vs-dense crossover (sequence length). 4096 is the JAX package's
# value, kept for parity; it was not measured on a GPU, and measuring the
# crossover on the H100 is queued in ROADMAP.md.
FLASH_MIN_SEQ = 4096


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, *,
              min_flash_seq: Optional[int] = None) -> torch.Tensor:
    """Sequence-length-routed attention: the flash kernel at
    ``L >= min_flash_seq`` (default :data:`FLASH_MIN_SEQ`), dense below.
    GQA inputs work on both paths (dense repeats the KV groups)."""
    threshold = FLASH_MIN_SEQ if min_flash_seq is None else int(min_flash_seq)
    if q.shape[2] >= threshold:
        return flash_attention(q, k, v, causal)
    group = q.shape[1] // k.shape[1]
    return _dense_attention(q, _repeat_kv(k, group), _repeat_kv(v, group),
                            causal)
