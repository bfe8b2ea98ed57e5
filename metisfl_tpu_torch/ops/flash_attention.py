"""Flash attention, forward and backward: CUDA kernels for Hopper and their
plain twins.

The JAX package's TPU kernels (metisfl_tpu/ops/flash_attention.py) become
hand-written sm_90a kernels, loaded through ``ctypes`` (ops/build.py):

- ``_fwd_kernel`` (K1) → ``csrc/flash_fwd.cu``, wrapped by
  :func:`flash_attention_fwd`;
- ``_dq_kernel`` (K2) and ``_dkv_kernel`` (K3) → ``csrc/flash_bwd.cu``,
  wrapped by :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`, which
  :func:`flash_attention_bwd` launches in turn.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
PyTorch twin of the same function (:func:`flash_attention_fwd_reference`,
:func:`flash_bwd_dq_reference` and :func:`flash_bwd_dkv_reference`, which
:func:`flash_attention_bwd_reference` runs in turn). There is no
fallback from one to the other. Each wrapper counts its kernel launches in
``.launches``.

Layout is the JAX package's (B, H, L, D) with scale 1/sqrt(D). GQA is
native: ``k``/``v`` may carry fewer heads than ``q`` (Hq a multiple of Hkv)
and query head h reads kv head h // (Hq // Hkv). lse and delta travel in
logical layout (B, Hq, L) fp32, the shape ring attention consumes.

The Pallas kernels take any D, since their blocks span the whole head; the
CUDA kernels are built for a few: K1 for 64, 128 and 256, K2 and K3 for
64 and 128. The wrappers zero-pad q, k, v (and dO) along D to the next
head dim the kernel is built for, launch with the true D's scale, and
slice O, dQ, dK and dV back to D. That is exact: padded columns add 0 to
Q·Kᵀ and to dO·Vᵀ, and padded V, dO, Q and K columns only give output
columns that are sliced off. A built head dim makes no copy. So the
forward takes D <= 256 and the backward D <= 128; D > 128 in the backward
raises: K3 keeps dK and dV of its 64-row tile in registers, 256 fp32 a
thread at D = 256 against the 255 a thread may hold, and the fp32 K2/K3
tiles would need more than the 227 KB of shared memory a block may use
(K2's tensor-core tiles would fit, but a backward needs K3). The SIMT
kernels carry b * H in gridDim.y, which stops at 65535, so the wrappers
launch in batch chunks of at most 65535 // H batches.
:func:`flash_attention` is differentiable: its autograd Function runs K1
forward and K2/K3 backward, as the JAX package's custom VJP does.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the head dims each kernel is instantiated for; a smaller D is padded
_FWD_HEAD_DIMS = (64, 128, 256)
_BWD_HEAD_DIMS = (64, 128)
# gridDim.y of the SIMT kernels carries b * H
_MAX_GRID_Y = 65535

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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The twins' accumulation type: fp32 as in the kernels, fp64 for fp64
    inputs (so ``gradcheck`` can hold the twins to finite differences)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _softmax_scale(D: int, scale: Optional[float]) -> float:
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: Optional[float] = None):
    """scale·QKᵀ in the accumulation type, masked to -1e30, and the causal
    mask (None when not causal). ``scale`` defaults to 1/sqrt(D)."""
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    acc = _acc_dtype(q.dtype)
    kf = _repeat_kv(k.to(acc), Hq // Hkv)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kf) * _softmax_scale(
        D, scale)
    mask = None
    if causal:
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    return s, mask


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K1: a dense softmax with GQA grouping that
    rounds where the kernel rounds. P = exp(S − m) against the row max m is
    rounded to the input dtype before P·V, summed in fp32 and divided by
    l = ΣP afterwards, as ``_fwd_kernel`` casts ``p.astype(v.dtype)`` before
    its PV product and divides at the store. Returns ``(o in q.dtype,
    lse = m + log l (B, Hq, L) fp32)``. ``scale`` defaults to 1/sqrt(D)."""
    group = q.shape[1] // k.shape[1]
    acc = _acc_dtype(q.dtype)
    s, _ = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)  # masked scores give exp(-1e30 - m) = 0
    l = p.sum(dim=-1, keepdim=True)
    vf = _repeat_kv(v.to(acc), group)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), vf) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_probs(q, k, v, do, lse, delta, causal, scale=None):
    """P recomputed from lse (masked to 0) and dS = P∘(dP − δ)·scale, dense
    (B, Hq, L, L) in the accumulation type, as both backward kernels
    recompute them tile by tile."""
    group = q.shape[1] // k.shape[1]
    acc = _acc_dtype(q.dtype)
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.to(acc)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc),
                      _repeat_kv(v.to(acc), group))
    ds = p * (dp - delta.to(acc)[..., None]) * _softmax_scale(q.shape[-1],
                                                               scale)
    return p, ds


def flash_bwd_dq_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain PyTorch twin of K2: dQ = (dS→``k.dtype``)·K summed in fp32,
    returned in q.dtype."""
    acc = _acc_dtype(q.dtype)
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(acc),
                      _repeat_kv(k.to(acc), q.shape[1] // k.shape[1]))
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool, scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K3: dV = (P→``do.dtype``)ᵀ·dO and dK =
    (dS→``q.dtype``)ᵀ·Q summed in fp32 over each KV group (a reshape to
    (B, Hkv, G, L, D)), returned in k's and v's dtypes."""
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    acc = _acc_dtype(q.dtype)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(acc),
                      do.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(acc), q.to(acc))
    dk = dk.reshape(B, Hkv, Hq // Hkv, L, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, Hq // Hkv, L, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool,
                                  delta: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch twin of the backward, dense, with the kernels' casts:
    P is recomputed from lse, dS = P∘(dP − δ)·scale is rounded to
    ``k.dtype`` before dS·K and to ``q.dtype`` before dSᵀ·Q, and P to
    ``do.dtype`` before Pᵀ·dO. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    if delta is None:
        delta = _delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO∘O) in fp32 (fp64 for fp64 inputs), (B, Hq, L); the
    JAX package computes it outside any kernel too."""
    acc = _acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(dim=-1)


def _check_cuda_inputs(q, k, v, head_dims, **same_as_q):
    named = (("q", q), ("k", k), ("v", v)) + tuple(same_as_q.items())
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32/float16/bfloat16, "
                         f"got {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    if k.shape[0] != B or k.shape[2] != L or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if not 1 <= D <= head_dims[-1]:
        raise ValueError(f"flash kernel takes head_dim 1..{head_dims[-1]}, "
                         f"got {D}")
    if L < 1 or B < 1 or Hq > _MAX_GRID_Y:
        raise ValueError(f"shape {tuple(q.shape)} is outside the kernel's "
                         "grid")


def pad_head_dim(*tensors: torch.Tensor, head_dims=_BWD_HEAD_DIMS):
    """``(Dk, padded)``: each (B, H, L, D) tensor zero-padded along D to
    Dk, the next of ``head_dims`` (those a kernel is built for); tensors
    already at Dk come back as they are (no copy)."""
    D = tensors[0].shape[-1]
    Dk = next(d for d in head_dims if D <= d)
    if D == Dk:
        return Dk, tensors
    return Dk, tuple(torch.nn.functional.pad(t, (0, Dk - D))
                     for t in tensors)


def _batch_chunks(B: int, H: int):
    """[b0, b1) batch ranges whose b * H fits gridDim.y."""
    step = _MAX_GRID_Y // H
    return [(b0, min(B, b0 + step)) for b0 in range(0, B, step)]


def _check_aligned(**tensors):
    """The kernels copy (B, H, L, D) rows 16 bytes at a time
    (``cp.async``), so each such tensor must start on a 16-byte boundary;
    a view that starts inside an allocation may not."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned "
                             f"address, got {t.data_ptr():#x}")


def _check_row_stats(q: torch.Tensor, **stats):
    B, Hq, L, _ = q.shape
    for name, t in stats.items():
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, Hq, L) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous (B, Hq, L) = {(B, Hq, L)} "
                f"float32 tensor on {q.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")


_lib_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: tensors and the stream as pointers, shapes as ints, scale
_SIGNATURES = {
    "flash_fwd": {
        "metisfl_flash_fwd": [_PTR] * 5 + [_INT] * 7 + [_FLOAT, _PTR],
    },
    "flash_bwd": {
        "metisfl_flash_bwd_dq": [_PTR] * 7 + [_INT] * 7 + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dkv": [_PTR] * 8 + [_INT] * 7 + [_FLOAT, _PTR],
    },
}
_ERROR_STRINGS = {"flash_fwd": "metisfl_cuda_error_string",
                  "flash_bwd": "metisfl_bwd_error_string"}


def _library(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with its C signatures declared (built
    on first use)."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            from metisfl_tpu_torch.ops.build import load

            lib = load(name)
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err_fn = getattr(lib, _ERROR_STRINGS[name])
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _launch(lib_name: str, fn_name: str, counter, device, *args) -> None:
    """Call one kernel's C entry on ``device``'s current stream; raise on a
    refused launch, count a launched one on ``counter``."""
    lib = _library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = getattr(lib, _ERROR_STRINGS[lib_name])(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg}")
    with _launch_lock:
        counter.launches += 1


def _on_cuda(q: torch.Tensor) -> bool:
    """False for a CPU tensor (the caller runs the twin); raises for any
    device other than the CPU or CUDA."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on cuda tensors, got "
                         f"{q.device}")
    return True


def _shape_args(q, k, causal, scale):
    """The C entries' trailing arguments: shapes, dtype code, causal and
    the softmax scale."""
    B, Hq, Hkv, L, D = _gqa_shapes(q, k)
    return (B, Hq, Hkv, L, D, _DTYPE_CODES[q.dtype], int(bool(causal)),
            float(scale))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(o, lse)`` for (B, Hq, L, D) q and (B, Hkv, L, D) k/v.

    CPU tensors run :func:`flash_attention_fwd_reference`. CUDA tensors
    launch ``csrc/flash_fwd.cu`` on the current stream (tensor cores for
    bf16/fp16, SIMT for fp32; D <= 256, padded to 64, 128 or 256;
    contiguous; q, k and v 16-byte aligned at D = 64, 128 and 256) and
    raise on anything else. ``flash_attention_fwd.launches`` counts kernel
    launches (one per batch chunk)."""
    if not _on_cuda(q):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check_cuda_inputs(q, k, v, _FWD_HEAD_DIMS)
    B, Hq, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v) = pad_head_dim(q, k, v, head_dims=_FWD_HEAD_DIMS)
    _check_aligned(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    for b0, b1 in _batch_chunks(B, Hq):
        _launch("flash_fwd", "metisfl_flash_fwd", flash_attention_fwd,
                q.device, q[b0:b1].data_ptr(), k[b0:b1].data_ptr(),
                v[b0:b1].data_ptr(), o[b0:b1].data_ptr(),
                lse[b0:b1].data_ptr(),
                *_shape_args(q[b0:b1], k, causal, scale))
    if Dk != D:
        o = o[..., :D].contiguous()
    return o, lse


flash_attention_fwd.launches = 0


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = False) -> torch.Tensor:
    """K2 on CUDA tensors: dQ (B, Hq, L, D) in q.dtype from the forward's
    lse and δ = rowsum(dO∘O), both (B, Hq, L) fp32. Launches
    ``csrc/flash_bwd.cu``'s dQ kernel (tensor cores for bf16/fp16, SIMT for
    fp32) or raises; D <= 128 is padded to 64 or 128 as in the forward,
    and at D = 64 and 128 q, k, v and do must be 16-byte aligned.
    ``flash_bwd_dq.launches`` counts launches (one per batch chunk)."""
    if not _on_cuda(q):
        raise ValueError("flash_bwd_dq launches the CUDA kernel; on the CPU "
                         "call flash_attention_bwd (the plain twin)")
    _check_cuda_inputs(q, k, v, _BWD_HEAD_DIMS, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    B, Hq, _, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do)
    _check_aligned(q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    for b0, b1 in _batch_chunks(B, Hq):
        _launch("flash_bwd", "metisfl_flash_bwd_dq", flash_bwd_dq, q.device,
                q[b0:b1].data_ptr(), k[b0:b1].data_ptr(),
                v[b0:b1].data_ptr(), do[b0:b1].data_ptr(),
                lse[b0:b1].data_ptr(), delta[b0:b1].data_ptr(),
                dq[b0:b1].data_ptr(),
                *_shape_args(q[b0:b1], k, causal, scale))
    return dq if Dk == D else dq[..., :D].contiguous()


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: ``(dk, dv)`` (B, Hkv, L, D), each summed over
    the query heads of its KV group, without atomics (the same bits on
    every run). Launches ``csrc/flash_bwd.cu``'s dK/dV kernel (tensor cores
    for bf16/fp16, SIMT for fp32) or raises; D <= 128 is padded to 64 or
    128 as in the forward, and at D = 64 and 128 q, k, v and do must be
    16-byte aligned. ``flash_bwd_dkv.launches`` counts launches (one per
    batch chunk)."""
    if not _on_cuda(q):
        raise ValueError("flash_bwd_dkv launches the CUDA kernel; on the "
                         "CPU call flash_attention_bwd (the plain twin)")
    _check_cuda_inputs(q, k, v, _BWD_HEAD_DIMS, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    B, Hq, _, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do)
    _check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for b0, b1 in _batch_chunks(B, Hq):
        _launch("flash_bwd", "metisfl_flash_bwd_dkv", flash_bwd_dkv,
                q.device, q[b0:b1].data_ptr(), k[b0:b1].data_ptr(),
                v[b0:b1].data_ptr(), do[b0:b1].data_ptr(),
                lse[b0:b1].data_ptr(), delta[b0:b1].data_ptr(),
                dk[b0:b1].data_ptr(), dv[b0:b1].data_ptr(),
                *_shape_args(q[b0:b1], k, causal, scale))
    if Dk != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False,
                        delta: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention, the API ring attention needs:
    lse and the optional δ in logical (B, Hq, L) fp32 layout.

    CPU tensors run :func:`flash_attention_bwd_reference`. CUDA tensors
    compute δ = rowsum(dO∘O) in fp32 where it is not given, then launch K2
    (:func:`flash_bwd_dq`) and K3 (:func:`flash_bwd_dkv`), and raise on
    anything the kernels do not take."""
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             delta)
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} does not match q "
                         f"{tuple(q.shape)}")
    delta = _delta(o, do) if delta is None else delta.float()
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward: the JAX package's custom VJP
    (``flash_attention.defvjp``) as an autograd Function."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, o, lse = ctx.saved_tensors
        # the model hands over the gradient of a transposed view; the
        # kernels take contiguous rows
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         grad_out.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention output over (B, H, L, D), GQA-native and
    differentiable (K1 forward; K2 and K3 backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
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
