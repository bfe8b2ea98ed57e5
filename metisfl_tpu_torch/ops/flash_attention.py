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

The Pallas kernels take any D, since their blocks span the whole head, and
so do the wrappers. Which kernel takes which (dtype, D) is
:func:`kernel_route`'s answer, a pure function of both:

- the tuned kernels, built for 16, 32, 64, 128 and 256 in bf16/fp16
  (at D = 256 each runs two warpgroups a block: K1 over a 128-row q tile,
  64 rows each, so that a K/V tile is read once for 128 rows; K2 with
  dQ's columns split between them; K3 one per output, since both outputs
  of its 64-row tile would take 256 fp32 registers a thread. At D = 16,
  32 and 256 K3 cuts its walk over each
  KV group into slabs where the grid would not fill the card,
  :func:`dkv_mma_split`, and sums them in a second launch). The D = 16
  and 32 builds read a D that is a multiple of 8 in place (8, 24: their
  loads zero-fill the rest of the build's columns in shared memory, and
  only D columns are stored).
  Otherwise, up to the largest build, the wrappers zero-pad q, k, v (and
  dO) along D to the next built head dim, launch with the true D's scale,
  and slice O, dQ, dK and dV back to D (:func:`zero_pads`). That is
  exact: padded columns add 0 to Q·Kᵀ and to dO·Vᵀ, and padded V, dO, Q
  and K columns only give output columns that are sliced off. A built
  head dim makes no copy.
- beyond the builds in bf16/fp16, K1, K2 and K3 run on the general
  tensor-core kernels (:func:`flash_fwd_general_mma`,
  :func:`flash_bwd_dq_general_mma`, :func:`flash_bwd_dkv_general_mma`),
  which stream Q, K, V and dO through shared memory 64 columns at a time
  and give the grid an axis over 256-column chunks of the output (K3 also
  one over its two outputs); the wrappers zero-pad D to a multiple of 64
  the same way.
- in fp32, K1, K2 and K3 run at every D on register-tiled SIMT kernels
  (:func:`flash_fwd_general`, :func:`flash_bwd_dq_general`,
  :func:`flash_bwd_dkv_general`; D zero-padded to a multiple of 32, at
  least 64), with a 256-column chunk axis (K3 also one over its two
  outputs), which cut long tiles into slabs across blocks
  (:func:`fwd_split`, :func:`dq_split`, :func:`dkv_split`) and merge or
  sum their fp32 partials in a second launch
  (:func:`flash_fwd_split_combine`, :func:`flash_bwd_dq_split_sum`,
  :func:`flash_bwd_dkv_split_sum`).

Each wrapper counts its own launches. Every kernel runs on a 1-D grid
that carries b * H, so any head count launches at once.
:func:`flash_attention` is differentiable: its autograd Function runs K1
forward and K2/K3 backward, as the JAX package's custom VJP does.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the head dims each tuned kernel is instantiated for (bf16/fp16 only); a D
# between builds runs on the next one (read in place at the 16 and 32 builds
# where D is a multiple of 8, else padded), a larger one goes to the
# general kernels
_FWD_HEAD_DIMS = (16, 32, 64, 128, 256)
_DQ_HEAD_DIMS = (16, 32, 64, 128, 256)
_DKV_HEAD_DIMS = (16, 32, 64, 128, 256)
# the builds that read the caller's rows at their own length (a multiple of
# 8 values, 16 bytes), zero-filling the rest of the build's columns
_IN_PLACE_HEAD_DIMS = (16, 32)
# output columns of one block of the general kernels: the tensor-core
# kernels' and the fp32 kernels' 256 (their fp32 accumulator)
_MMA_CHUNK = 256
# rows of a q or k tile (and of a q step) of the register-tiled fp32
# kernels
_KV_TILE = 64
# blocks per SM that the fp32 kernels' splits aim their grids at (one
# block fits an SM at a time: several per SM let the longest-first order
# even them out; on the H100, 8 beat 2 and 4 and matched 16 for K3,
# PERF.md)
_SPLIT_BLOCKS_PER_SM = 8
# the same for the tensor-core K3 at the builds whose walks it splits (q
# steps of 64 rows), by build: at D <= 32 small blocks (one warpgroup, 13-26
# KB of shared memory) share an SM several at a time; at D = 256 one block
# (two warpgroups, 209 KB) takes a whole SM
_MMA_SPLIT_BLOCKS_PER_SM = {16: 4, 32: 4, 256: 1}
# the fewest q steps a slab of that K3 walks: each slab writes its fp32
# partials and the sum reads them back, which shorter slabs do not repay
# (on the H100 slabs of 1-3 steps lost to the unsplit walk of 8 at
# B4·H4·L512·D16, slabs of 5 lost to 9 at B2·Hq16·Hkv4·L1024, PERF.md)
_MMA_MIN_SLAB_STEPS = 8
# the time of a k step of K1's D = 256 build over a 128-row q tile (two
# warpgroups' products on one K/V tile) against one over a 64-row tile
# (warpgroup 1 idle), each block alone on its SM: 1.16 where the 128-row
# grid leaves SMs idle, 1.43 on a full card (H100, PERF.md); all 26
# measured choices of :func:`fwd_rows` hold for any value in 1.07-1.37
_FWD_256_STEP_COST = 1.2

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


def bwd_head_dims(dtype: torch.dtype, kernel: str) -> Tuple[int, ...]:
    """The head dims K2 (``kernel`` "dq") or K3 ("dkv") is built for in
    ``dtype``: none in fp32, whose register-tiled kernels take every D."""
    if dtype == torch.float32:
        return ()
    return _DQ_HEAD_DIMS if kernel == "dq" else _DKV_HEAD_DIMS


def kernel_head_dim(D: int, head_dims) -> Optional[int]:
    """The built head dim that D is padded to, or None where D is beyond
    every one of ``head_dims`` and the general kernel takes it."""
    return next((d for d in head_dims if D <= d), None)


def mma_head_dim(D: int) -> int:
    """The head dim the general tensor-core kernels run D at: the next
    multiple of 64 (the width of a streamed block), and at least 128 (two
    blocks, which their two-step-ahead loads need)."""
    return max(128, -(-D // 64) * 64)


def f32_head_dim(D: int) -> int:
    """The head dim the register-tiled fp32 kernels (K1, K2 and K3, at
    every D) run D at: the next multiple of 32 (the width of their streamed
    block), and at least 64 (two blocks, as :func:`mma_head_dim`)."""
    return max(64, -(-D // 32) * 32)


def _slab_steps(L: int, group: int, causal: bool):
    """The q steps (64-row q tiles of the group's query heads) of each
    64-row k tile of the fp32 K3: every q tile, or from the diagonal on."""
    nk = -(-L // _KV_TILE)
    return [group * (nk - (t if causal else 0)) for t in range(nk)]


def _slab_rows(counts, L: int, device) -> torch.Tensor:
    """The slabs each of L rows has, from its 64-row tile's count."""
    return torch.tensor(counts, device=device).repeat_interleave(
        _KV_TILE)[:L]


def _slabs(steps, blocks: int, sms: int, per_sm: int,
           least: int = 1) -> Tuple[int, int]:
    """``(per_slab, slabs)``: each tile's steps (``steps``, the longest
    first) cut into slabs of ``per_slab`` (at least ``least``), one block
    each of ``blocks`` per tile and slab, so that the grid holds about
    ``per_sm`` blocks' work per SM; ``slabs`` is the longest tile's count,
    1 where one slab already takes a whole tile."""
    per_slab = max(least, -(-blocks * sum(steps) // (per_sm * sms)))
    if per_slab >= steps[0]:
        return steps[0], 1
    return per_slab, -(-steps[0] // per_slab)


def dkv_mma_split(B: int, Hq: int, Hkv: int, L: int, D: int, causal: bool,
                  sms: int) -> Tuple[int, int]:
    """``(per_slab, slabs)`` of the tensor-core K3 at its D = 16, 32 and
    256 builds (``D``, a key of ``_MMA_SPLIT_BLOCKS_PER_SM``) at these
    shapes on a card of ``sms`` SMs. One block per (64-row k tile, KV
    head) walks the group's query heads and their 64-row q tiles
    (:func:`_slab_steps`), which leaves the card under one wave at GQA
    shapes, the first k tile's walk the longest when causal; so each walk
    is cut into slabs of ``per_slab`` steps, one block each, aiming at
    ``_MMA_SPLIT_BLOCKS_PER_SM[D]`` blocks' work per SM with slabs of at
    least ``_MMA_MIN_SLAB_STEPS`` steps, whose fp32 partials
    :func:`flash_bwd_dkv_split_sum` adds up and rounds. ``slabs == 1``
    writes dK and dV directly. A pure function of its arguments."""
    return _slabs(_slab_steps(L, Hq // Hkv, causal), B * Hkv, sms,
                  _MMA_SPLIT_BLOCKS_PER_SM[D], _MMA_MIN_SLAB_STEPS)


def dkv_split(B: int, Hq: int, Hkv: int, L: int, D: int, causal: bool,
              sms: int) -> Tuple[int, int]:
    """``(per_slab, slabs)`` of the fp32 K3 beyond its builds at these
    shapes on a card of ``sms`` SMs: each k tile's q steps are cut into
    slabs of ``per_slab`` steps, one block each, so that the grid holds
    about ``_SPLIT_BLOCKS_PER_SM`` blocks' work per SM; ``slabs`` is the
    longest tile's count. ``slabs == 1`` (a grid already that full) writes
    dK and dV directly; more writes partials that
    :func:`flash_bwd_dkv_split_sum` adds up. A pure function of its
    arguments."""
    blocks = B * Hkv * 2 * -(-D // _MMA_CHUNK)  # per k tile and slab
    return _slabs(_slab_steps(L, Hq // Hkv, causal), blocks, sms,
                  _SPLIT_BLOCKS_PER_SM)


def _fwd_slab_steps(L: int, causal: bool):
    """The k tiles of each 64-row q tile of the fp32 K1: every k tile, or
    up to the diagonal."""
    nq = -(-L // _KV_TILE)
    return [t + 1 if causal else nq for t in range(nq)]


def fwd_split(B: int, Hq: int, L: int, D: int, causal: bool,
              sms: int) -> Tuple[int, int]:
    """``(per_slab, slabs)`` of the fp32 K1 at these shapes (D its padded
    head dim) on a card of ``sms`` SMs. Where one block per q tile (and
    head and chunk) fills the card, the grid is not split: ``(longest
    tile's k tiles, 1)``, and each block writes O and the lse directly.
    Else, as :func:`dkv_split`, each q tile's k tiles are cut into slabs of
    ``per_slab``, one block each, so that the grid holds about
    ``_SPLIT_BLOCKS_PER_SM`` blocks' work per SM; ``slabs`` is the longest
    tile's count, and the blocks write partials that
    :func:`flash_fwd_split_combine` merges. (On the H100 a grid that
    fills the card ran 7-16% faster unsplit than split, PERF.md.) A pure
    function of its arguments."""
    steps = _fwd_slab_steps(L, causal)
    blocks = B * Hq * -(-D // _MMA_CHUNK)  # per q tile and slab
    longest = max(steps)
    per_slab = max(1, -(-blocks * sum(steps)
                        // (_SPLIT_BLOCKS_PER_SM * sms)))
    if blocks * len(steps) >= sms or per_slab >= longest:
        return longest, 1
    return per_slab, -(-longest // per_slab)


def _makespan(walks, sms: int) -> int:
    """The steps until a grid's last block ends when the card hands out its
    blocks (their ``walks``, in grid order) each to the SM that frees
    first, one block an SM at a time."""
    free = [0] * min(sms, len(walks))
    for walk in walks:
        heapq.heapreplace(free, free[0] + walk)
    return max(free)


@functools.lru_cache(maxsize=256)
def fwd_rows(B: int, Hq: int, L: int, D: int, causal: bool,
             sms: int) -> int:
    """The q rows of a block of the tensor-core K1 at build ``D`` on a
    card of ``sms`` SMs: 64, but at the D = 256 build 128 (two warpgroups
    over one 128-row tile, each K/V tile read once for both) where that
    grid ends first. One block fills an SM in either mode, so each grid
    ends when its busiest SM does (:func:`_makespan`, longest tiles first as
    the kernel orders them), a 128-row block's k step taking
    ``_FWD_256_STEP_COST`` times a 64-row one's. 64-row blocks win where
    they spread the walks over SMs that 128-row ones leave idle (B2·Hq4·L256
    and, causal, up to about one longest walk of work per SM); a grid with
    more than two longest walks of work per SM takes 128 rows without the
    count. A pure function of its arguments."""
    if D != 256:
        return _KV_TILE
    heads = B * Hq
    steps = _fwd_slab_steps(L, causal)  # the k tiles of each 64-row tile
    if heads * sum(steps) > 2 * sms * max(steps):
        return 2 * _KV_TILE
    # a 128-row tile walks the k tiles of its second 64-row tile
    tall = [steps[min(t + 1, len(steps) - 1)]
            for t in range(0, len(steps), 2)]
    spans = [_makespan([s for s in sorted(walks, reverse=True)
                        for _ in range(heads)], sms)
             for walks in (steps, tall)]
    return 2 * _KV_TILE if spans[0] > _FWD_256_STEP_COST * spans[1] \
        else _KV_TILE


def dq_split(B: int, Hq: int, L: int, D: int, causal: bool,
             sms: int) -> Tuple[int, int]:
    """``(per_slab, slabs)`` of the fp32 K2 at these shapes (D its padded
    head dim) on a card of ``sms`` SMs. Its q tiles walk the k tiles that
    the fp32 K1's do, one block per (q tile, 256-column chunk, head), so it
    takes :func:`fwd_split`'s rule: unsplit where those blocks fill the
    card, else slabs of ``per_slab`` k tiles whose partials
    :func:`flash_bwd_dq_split_sum` adds up. A pure function of its
    arguments."""
    return fwd_split(B, Hq, L, D, causal, sms)


class Route(NamedTuple):
    """The kernel that a CUDA tensor's call launches."""

    wrapper: str  # the wrapper that launches it and counts the launch
    head_dim: int  # the D it runs at (zero-padded from the caller's)
    chunks: int  # blocks along the output's head dim, for each tile
    passes: int  # outputs made one at a time (the fp32 K3: dV, then dK)


# the wrappers of each kernel: (tuned builds, general fp32, general
# tensor-core)
_WRAPPERS = {
    "fwd": ("flash_attention_fwd", "flash_fwd_general",
            "flash_fwd_general_mma"),
    "dq": ("flash_bwd_dq", "flash_bwd_dq_general",
           "flash_bwd_dq_general_mma"),
    "dkv": ("flash_bwd_dkv", "flash_bwd_dkv_general",
            "flash_bwd_dkv_general_mma"),
}


def kernel_route(kernel: str, dtype: torch.dtype, D: int) -> Route:
    """Which kernel ``kernel`` ("fwd" for K1, "dq" for K2, "dkv" for K3)
    launches on a CUDA tensor of ``dtype`` at head dim ``D``: a pure
    function of the two, and the one the wrappers route by. In fp32, at
    every D, each kernel's register-tiled kernel (padded to
    :func:`f32_head_dim`, 256-column chunks; K3 in two passes, dV and dK).
    In bf16/fp16 a tuned build where D fits one (16, 32, 64, 128, 256;
    each makes its outputs in one pass), beyond them the general
    tensor-core kernels (padded to :func:`mma_head_dim`; K3 in two
    passes). :func:`zero_pads` says whether the wrapper copies the inputs
    padded to the route's head dim."""
    tuned, general, mma = _WRAPPERS[kernel]
    passes = 2 if kernel == "dkv" else 1
    if dtype == torch.float32:
        Dp = f32_head_dim(D)
        return Route(general, Dp, -(-Dp // _MMA_CHUNK), passes)
    builds = (_FWD_HEAD_DIMS if kernel == "fwd"
              else bwd_head_dims(dtype, kernel))
    built = kernel_head_dim(D, builds)
    if built is not None:
        return Route(tuned, built, 1, 1)
    Dp = mma_head_dim(D)
    return Route(mma, Dp, -(-Dp // _MMA_CHUNK), passes)


def zero_pads(kernel: str, dtype: torch.dtype, D: int) -> bool:
    """Whether the wrapper of ``kernel``'s route copies q, k, v (and dO)
    zero-padded along D to the route's head dim (and slices the outputs
    back): not at the route's own head dim, and not at the D = 16 and 32
    builds (K1, K2 and K3) where D is a multiple of 8, which read the
    caller's rows at their own length and zero-fill the rest in shared
    memory. A pure function of its arguments, as :func:`kernel_route`
    is."""
    head_dim = kernel_route(kernel, dtype, D).head_dim
    return D != head_dim and not (head_dim in _IN_PLACE_HEAD_DIMS
                                  and D % 8 == 0)


def _check_cuda_inputs(q, k, v, **same_as_q):
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
    if D < 1:
        raise ValueError(f"flash kernel takes head_dim >= 1, got {D}")
    if L < 1 or B < 1:
        raise ValueError(f"shape {tuple(q.shape)} is outside the kernel's "
                         "grid")


def pad_head_dim(*tensors: torch.Tensor, head_dims: Tuple[int, ...]):
    """``(Dk, padded)``: each (B, H, L, D) tensor zero-padded along D to
    Dk, the next of ``head_dims`` (those one kernel is built for, such as
    ``bwd_head_dims(dtype, kernel)``; D must not exceed the last); tensors
    already at Dk come back as they are (no copy)."""
    D = tensors[0].shape[-1]
    Dk = kernel_head_dim(D, head_dims)
    if Dk is None:
        raise ValueError(f"head_dim {D} is beyond the built {head_dims}")
    if D == Dk:
        return Dk, tensors
    return Dk, tuple(torch.nn.functional.pad(t, (0, Dk - D))
                     for t in tensors)


# the dtypes of the tensor-core kernels
_MMA_DTYPES = (torch.float16, torch.bfloat16)


def _check_dtype(name: str, q: torch.Tensor, dtypes) -> None:
    if q.dtype not in dtypes:
        raise ValueError(f"{name} takes {', '.join(map(str, dtypes))}, got "
                         f"{q.dtype}")


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
        "metisfl_flash_fwd": [_PTR] * 5 + [_INT] * 9 + [_FLOAT, _PTR],
        "metisfl_flash_fwd_general": [_PTR] * 8 + [_INT] * 9
        + [_FLOAT, _PTR],
        "metisfl_flash_fwd_split_combine": [_PTR] * 5 + [_INT] * 6
        + [_PTR],
        "metisfl_flash_fwd_general_mma": [_PTR] * 5 + [_INT] * 7
        + [_FLOAT, _PTR],
    },
    "flash_bwd": {
        "metisfl_flash_bwd_dq": [_PTR] * 7 + [_INT] * 8 + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dkv": [_PTR] * 9 + [_INT] * 10 + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dq_general": [_PTR] * 8 + [_INT] * 9
        + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dq_split_sum": [_PTR] * 2 + [_INT] * 6
        + [_PTR],
        "metisfl_flash_bwd_dkv_general": [_PTR] * 9 + [_INT] * 9
        + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dkv_split_sum": [_PTR] * 3 + [_INT] * 8
        + [_PTR],
        "metisfl_flash_bwd_dkv_general_mma": [_PTR] * 8 + [_INT] * 7
        + [_FLOAT, _PTR],
        "metisfl_flash_bwd_dq_general_mma": [_PTR] * 7 + [_INT] * 7
        + [_FLOAT, _PTR],
    },
}
# the tuned K3's slab arguments where it does not split: one slab as long
# as any walk
_UNSPLIT = (2 ** 31 - 1, 1)
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
    in bf16/fp16 launch ``csrc/flash_fwd.cu``'s tensor-core kernel on the
    current stream at D <= 256, built for 16, 32, 64, 128 and 256 (the 16
    and 32 builds read a D that is a multiple of 8 in place; any other D
    is zero-padded to the next build, :func:`zero_pads`; D = 256 on two
    warpgroups over 128-row q tiles, :func:`fwd_rows`), with q, k and v
    16-byte aligned there and contiguous, and raise on anything else; D >
    256 goes to :func:`flash_fwd_general_mma`. fp32 goes, at every D, to
    the register-tiled :func:`flash_fwd_general` (:func:`kernel_route`).
    ``flash_attention_fwd.launches`` counts this kernel's launches (one per
    call)."""
    if not _on_cuda(q):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check_cuda_inputs(q, k, v)
    B, Hq, L, D = q.shape
    route = kernel_route("fwd", q.dtype, D)
    if route.wrapper == "flash_fwd_general_mma":
        return flash_fwd_general_mma(q, k, v, causal)
    if route.wrapper == "flash_fwd_general":
        return flash_fwd_general(q, k, v, causal)
    scale = 1.0 / math.sqrt(D)
    if zero_pads("fwd", q.dtype, D):
        _, (q, k, v) = pad_head_dim(q, k, v, head_dims=(route.head_dim,))
    _check_aligned(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    # the build's head dim, the length of the rows it reads and writes, and
    # the q rows of a block
    B, Hq, Hkv, L, ld, *flags = _shape_args(q, k, causal, scale)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows = fwd_rows(B, Hq, L, route.head_dim, bool(causal), sms)
    _launch("flash_fwd", "metisfl_flash_fwd", flash_attention_fwd, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, L, route.head_dim, ld, rows, *flags)
    if ld != D:
        o = o[..., :D].contiguous()
    return o, lse


flash_attention_fwd.launches = 0


def flash_fwd_general(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 in fp32 at any head dim: ``(o, lse)`` as
    :func:`flash_attention_fwd`.

    CPU tensors run :func:`flash_attention_fwd_reference`. CUDA tensors
    are zero-padded along D to :func:`f32_head_dim` (exact, as for the
    builds) and launch ``csrc/flash_fwd.cu``'s register-tiled SIMT kernel,
    blocks of one (64-row q tile, slab of its k tiles, 256-column chunk of
    O, head), with q, k and v 16-byte aligned and contiguous; or raise.
    Where :func:`fwd_split` cuts the q tiles' k tiles into more than one
    slab, the blocks write fp32 partials into scratch tensors and
    :func:`flash_fwd_split_combine` merges them in a fixed order: no
    atomics, the same bits on every run. :func:`flash_attention_fwd`
    routes every fp32 D here. ``flash_fwd_general.launches`` counts this
    kernel's launches (one per call)."""
    if not _on_cuda(q):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check_cuda_inputs(q, k, v)
    _check_dtype("flash_fwd_general", q, (torch.float32,))
    B, Hq, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v) = pad_head_dim(q, k, v, head_dims=(f32_head_dim(D),))
    _check_aligned(q=q, k=k, v=v)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_slab, slabs = fwd_split(B, Hq, L, Dk, causal, sms)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    # the slabs' partials: O unnormalised, each row's max and sum
    parts = (None, None, None)
    if slabs > 1:
        parts = (torch.empty((slabs,) + tuple(q.shape), dtype=torch.float32,
                             device=q.device),
                 *(torch.empty((slabs, B, Hq, L), dtype=torch.float32,
                               device=q.device) for _ in range(2)))
    *shapes, scale_arg = _shape_args(q, k, causal, scale)
    _launch("flash_fwd", "metisfl_flash_fwd_general", flash_fwd_general,
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *(None if t is None else t.data_ptr()
                              for t in parts),
            *shapes, per_slab, slabs, scale_arg)
    if slabs > 1:
        flash_fwd_split_combine(*parts, causal, per_slab, out=(o, lse))
    if Dk != D:
        o = o[..., :D].contiguous()
    return o, lse


flash_fwd_general.launches = 0


def fwd_split_combine_reference(o_part: torch.Tensor, m_part: torch.Tensor,
                                l_part: torch.Tensor, causal: bool,
                                per_slab: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the split fp32 K1's second launch: ``(o,
    lse)`` from partials ``o_part`` (slabs, B, Hq, L, D), unnormalised, and
    each row's max ``m_part`` and sum ``l_part`` (slabs, B, Hq, L). Each row
    merges, in slab order, the slabs its 64-row q tile has
    (``ceil(k tiles / per_slab)`` of :func:`_fwd_slab_steps`): m = max m_s,
    l = Σ l_s·e^(m_s − m), o = Σ o_s·e^(m_s − m) / l (0 where l = 0), lse =
    m + log l. The rest of the partials is never read."""
    L = o_part.shape[3]
    rows = _slab_rows([-(-n // per_slab) for n in _fwd_slab_steps(
        L, causal)], L, o_part.device)
    m = m_part[0]
    for slab in range(1, o_part.shape[0]):
        m = torch.where(rows > slab, torch.maximum(m, m_part[slab]), m)
    l = torch.zeros_like(m)
    o = torch.zeros_like(o_part[0])
    for slab in range(o_part.shape[0]):
        has = rows > slab
        w = torch.where(has, torch.exp(m_part[slab] - m), torch.zeros_like(m))
        l = l + torch.where(has, l_part[slab] * w, torch.zeros_like(m))
        o = o + torch.where(has[:, None], o_part[slab] * w[..., None],
                            torch.zeros_like(o))
    inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    return o * inv[..., None], m + torch.log(l.clamp_min(1e-30))


def flash_fwd_split_combine(o_part: torch.Tensor, m_part: torch.Tensor,
                            l_part: torch.Tensor, causal: bool,
                            per_slab: int,
                            out: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split fp32 K1's second launch: ``(o, lse)``, (B, Hq, L, D) and
    (B, Hq, L) fp32, from the partials that :func:`flash_fwd_general` wrote
    with ``per_slab`` k tiles a slab; written into ``out`` where given. CPU
    tensors run :func:`fwd_split_combine_reference`; CUDA tensors launch
    ``csrc/flash_fwd.cu``'s combine kernel (each row's slabs merged in slab
    order) or raise. ``flash_fwd_split_combine.launches`` counts
    launches."""
    if not _on_cuda(o_part):
        return fwd_split_combine_reference(o_part, m_part, l_part, causal,
                                           per_slab)
    if (o_part.dtype != torch.float32 or o_part.dim() != 5
            or not o_part.is_contiguous() or o_part.shape[-1] % 4):
        raise ValueError(f"o_part must be a contiguous (slabs, B, Hq, L, D) "
                         f"float32 tensor with D a multiple of 4, got "
                         f"{tuple(o_part.shape)} {o_part.dtype}")
    _, B, Hq, L, D = o_part.shape
    for name, t in (("m_part", m_part), ("l_part", l_part)):
        if (t.device != o_part.device or t.dtype != torch.float32
                or t.shape != o_part.shape[:4] or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous "
                             f"{tuple(o_part.shape[:4])} float32 tensor on "
                             f"{o_part.device}")
    if out is None:
        out = (torch.empty_like(o_part[0]), torch.empty_like(m_part[0]))
    o, lse = out
    for name, t, shape in (("o", o, o_part.shape[1:]),
                           ("lse", lse, m_part.shape[1:])):
        if (t.device != o_part.device or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"float32 tensor on {o_part.device}")
    _check_aligned(o_part=o_part, o=o)
    _launch("flash_fwd", "metisfl_flash_fwd_split_combine",
            flash_fwd_split_combine, o_part.device, o_part.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, L, D, int(bool(causal)), per_slab)
    return o, lse


flash_fwd_split_combine.launches = 0


def flash_fwd_general_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on tensor cores at any head dim, bf16/fp16: ``(o, lse)`` as
    :func:`flash_attention_fwd`.

    CPU tensors run :func:`flash_attention_fwd_reference`. CUDA tensors
    are zero-padded along D to :func:`mma_head_dim` (exact, as for the
    builds) and launch ``csrc/flash_fwd.cu``'s general tensor-core kernel,
    one block per (64-row q tile, 256-column chunk of O, head), with q, k
    and v 16-byte aligned and contiguous, or raise.
    :func:`flash_attention_fwd` routes bf16/fp16 at D > 256 here.
    ``flash_fwd_general_mma.launches`` counts launches (one per call)."""
    if not _on_cuda(q):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check_cuda_inputs(q, k, v)
    _check_dtype("flash_fwd_general_mma", q, _MMA_DTYPES)
    B, Hq, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v) = pad_head_dim(q, k, v, head_dims=(mma_head_dim(D),))
    _check_aligned(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "metisfl_flash_fwd_general_mma",
            flash_fwd_general_mma, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_shape_args(q, k, causal, scale))
    if Dk != D:
        o = o[..., :D].contiguous()
    return o, lse


flash_fwd_general_mma.launches = 0


def _bwd_inputs_on_cuda(name, q, k, v, do, lse, delta):
    """Check the backward kernels' inputs; raise for CPU tensors."""
    if not _on_cuda(q):
        raise ValueError(f"{name} launches the CUDA kernel; on the CPU call "
                         "flash_attention_bwd (the plain twin)")
    _check_cuda_inputs(q, k, v, do=do)
    _check_row_stats(q, lse=lse, delta=delta)


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = False) -> torch.Tensor:
    """K2 on CUDA tensors: dQ (B, Hq, L, D) in q.dtype from the forward's
    lse and δ = rowsum(dO∘O), both (B, Hq, L) fp32. Launches
    ``csrc/flash_bwd.cu``'s tensor-core dQ kernel for bf16/fp16 at D <= 256,
    built for 16, 32, 64, 128 and 256 (read in place or padded as K1,
    :func:`zero_pads`, with q, k, v and do 16-byte aligned there; D = 256
    on two warpgroups that split dQ's columns) or
    raises; a larger D goes to :func:`flash_bwd_dq_general_mma`, and fp32
    at every D to :func:`flash_bwd_dq_general` (:func:`kernel_route`).
    ``flash_bwd_dq.launches`` counts this kernel's launches (one per
    call)."""
    _bwd_inputs_on_cuda("flash_bwd_dq", q, k, v, do, lse, delta)
    D = q.shape[-1]
    route = kernel_route("dq", q.dtype, D)
    if route.wrapper == "flash_bwd_dq_general_mma":
        return flash_bwd_dq_general_mma(q, k, v, do, lse, delta, causal)
    if route.wrapper == "flash_bwd_dq_general":
        return flash_bwd_dq_general(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(D)
    if zero_pads("dq", q.dtype, D):
        _, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                        head_dims=(route.head_dim,))
    _check_aligned(q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    # the build's head dim, then the length of the rows it reads and writes
    B, Hq, Hkv, L, ld, *flags = _shape_args(q, k, causal, scale)
    _launch("flash_bwd", "metisfl_flash_bwd_dq", flash_bwd_dq, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Hq, Hkv, L,
            route.head_dim, ld, *flags)
    return dq if ld == D else dq[..., :D].contiguous()


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: ``(dk, dv)`` (B, Hkv, L, D), each summed over
    the query heads of its KV group, without atomics (the same bits on
    every run). Launches ``csrc/flash_bwd.cu``'s tensor-core dK/dV kernel
    for bf16/fp16 at D <= 256, built for 16, 32, 64, 128 and 256 (read in
    place or padded as K1, :func:`zero_pads`; D = 256 on two warpgroups,
    one per output) or raises. At the D = 16, 32 and 256 builds, where
    :func:`dkv_mma_split` cuts the k tiles' walks into slabs, the blocks
    write fp32 partials into a scratch tensor and
    :func:`flash_bwd_dkv_split_sum` adds them up in a fixed order and rounds
    them to the input dtype. A larger D goes to
    :func:`flash_bwd_dkv_general_mma`, and fp32 at every D to
    :func:`flash_bwd_dkv_general` (:func:`kernel_route`).
    ``flash_bwd_dkv.launches`` counts this kernel's launches (one per
    call)."""
    _bwd_inputs_on_cuda("flash_bwd_dkv", q, k, v, do, lse, delta)
    D = q.shape[-1]
    route = kernel_route("dkv", q.dtype, D)
    if route.wrapper == "flash_bwd_dkv_general_mma":
        return flash_bwd_dkv_general_mma(q, k, v, do, lse, delta, causal)
    if route.wrapper == "flash_bwd_dkv_general":
        return flash_bwd_dkv_general(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(D)
    if zero_pads("dkv", q.dtype, D):
        _, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                        head_dims=(route.head_dim,))
    _check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    B, Hq, Hkv, L, ld, dtype, causal_arg, scale_arg = _shape_args(
        q, k, causal, scale)
    per_slab, slabs = _UNSPLIT
    if route.head_dim in _MMA_SPLIT_BLOCKS_PER_SM:
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        per_slab, slabs = dkv_mma_split(B, Hq, Hkv, L, route.head_dim,
                                        causal, sms)
    # the slabs' partials: dV at [:, 0], dK at [:, 1]
    part = (torch.empty((slabs, 2) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if slabs > 1 else None)
    _launch("flash_bwd", "metisfl_flash_bwd_dkv", flash_bwd_dkv, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), B, Hq, Hkv, L,
            route.head_dim, ld, dtype, causal_arg, per_slab, slabs,
            scale_arg)
    if part is not None:
        flash_bwd_dkv_split_sum(part, Hq // Hkv, causal, per_slab,
                                out=(dk, dv))
    if ld != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq_general(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, causal: bool = False
                         ) -> torch.Tensor:
    """K2 in fp32 at any head dim on CUDA tensors, as :func:`flash_bwd_dq`:
    q, k, v and dO zero-padded along D to :func:`f32_head_dim` (exact),
    then ``csrc/flash_bwd.cu``'s register-tiled SIMT kernel, blocks of one
    (64-row q tile, slab of its k tiles, 256-column chunk of dQ, head), with
    the (B, H, L, D) tensors 16-byte aligned; or raises. Where
    :func:`dq_split` cuts the q tiles' k tiles into more than one slab, the
    blocks write fp32 partials into a scratch tensor and
    :func:`flash_bwd_dq_split_sum` adds them up in a fixed order: no
    atomics, the same bits on every run. :func:`flash_bwd_dq` routes every
    fp32 D here. ``flash_bwd_dq_general.launches`` counts this kernel's
    launches (one per call)."""
    _bwd_inputs_on_cuda("flash_bwd_dq_general", q, k, v, do, lse, delta)
    _check_dtype("flash_bwd_dq_general", q, (torch.float32,))
    B, Hq, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                     head_dims=(f32_head_dim(D),))
    _check_aligned(q=q, k=k, v=v, do=do)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_slab, slabs = dq_split(B, Hq, L, Dk, causal, sms)
    dq = torch.empty_like(q)
    part = (torch.empty((slabs,) + tuple(q.shape), dtype=torch.float32,
                        device=q.device) if slabs > 1 else None)
    *shapes, scale_arg = _shape_args(q, k, causal, scale)
    _launch("flash_bwd", "metisfl_flash_bwd_dq_general",
            flash_bwd_dq_general, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), None if part is None else part.data_ptr(),
            *shapes, per_slab, slabs, scale_arg)
    if part is not None:
        flash_bwd_dq_split_sum(part, causal, per_slab, out=dq)
    return dq if Dk == D else dq[..., :D].contiguous()


flash_bwd_dq_general.launches = 0


def dq_split_sum_reference(part: torch.Tensor, causal: bool,
                           per_slab: int) -> torch.Tensor:
    """Plain PyTorch twin of the split fp32 K2's second launch: dQ from
    partials ``(slabs, B, Hq, L, D)``, each row the sum, in slab order, of
    the slabs its 64-row q tile has (``ceil(k tiles / per_slab)`` of
    :func:`_fwd_slab_steps`); the rest of ``part`` is never read."""
    L = part.shape[3]
    rows = _slab_rows([-(-n // per_slab) for n in _fwd_slab_steps(
        L, causal)], L, part.device)
    out = part[0].clone()
    for slab in range(1, part.shape[0]):
        has = (rows > slab)[:, None]
        out = out + torch.where(has, part[slab], torch.zeros_like(out))
    return out


def flash_bwd_dq_split_sum(part: torch.Tensor, causal: bool, per_slab: int,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The split fp32 K2's second launch: dQ (B, Hq, L, D) fp32 from the
    partials ``(slabs, B, Hq, L, D)`` that :func:`flash_bwd_dq_general`
    wrote with ``per_slab`` k tiles a slab; written into ``out`` where
    given. CPU tensors run :func:`dq_split_sum_reference`; CUDA tensors
    launch ``csrc/flash_bwd.cu``'s split sum (each row's slabs added in
    slab order, the kernel the fp32 K3's sum launches too) or raise.
    ``flash_bwd_dq_split_sum.launches`` counts launches."""
    if not _on_cuda(part):
        return dq_split_sum_reference(part, causal, per_slab)
    if (part.dtype != torch.float32 or part.dim() != 5
            or not part.is_contiguous() or part.shape[-1] % 4):
        raise ValueError(f"part must be a contiguous (slabs, B, Hq, L, D) "
                         f"float32 tensor with D a multiple of 4, got "
                         f"{tuple(part.shape)} {part.dtype}")
    _, B, Hq, L, D = part.shape
    if out is None:
        out = torch.empty_like(part[0])
    if (out.device != part.device or out.dtype != torch.float32
            or out.shape != part.shape[1:] or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(part.shape[1:])} "
                         f"float32 tensor on {part.device}")
    _check_aligned(part=part, out=out)
    _launch("flash_bwd", "metisfl_flash_bwd_dq_split_sum",
            flash_bwd_dq_split_sum, part.device, part.data_ptr(),
            out.data_ptr(), B, Hq, L, D, int(bool(causal)), per_slab)
    return out


flash_bwd_dq_split_sum.launches = 0


def flash_bwd_dkv_general(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in fp32 at any head dim on CUDA tensors, as
    :func:`flash_bwd_dkv`: q, k, v and dO zero-padded along D to
    :func:`f32_head_dim` (exact), then ``csrc/flash_bwd.cu``'s
    register-tiled SIMT kernel, blocks of one (64-row k tile, slab of its
    q steps, output, 256-column chunk, KV head), with the (B, H, L, D)
    tensors 16-byte aligned; or raises. Where :func:`dkv_split` cuts the k
    tiles into more than one slab, the blocks write fp32 partials into a
    scratch tensor and :func:`flash_bwd_dkv_split_sum` adds them up in a
    fixed order: no atomics, the same bits on every run.
    :func:`flash_bwd_dkv` routes every fp32 D here.
    ``flash_bwd_dkv_general.launches`` counts this kernel's launches (one
    per call)."""
    _bwd_inputs_on_cuda("flash_bwd_dkv_general", q, k, v, do, lse, delta)
    _check_dtype("flash_bwd_dkv_general", q, (torch.float32,))
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                     head_dims=(f32_head_dim(D),))
    _check_aligned(q=q, k=k, v=v, do=do)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_slab, slabs = dkv_split(B, Hq, Hkv, L, Dk, causal, sms)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # the slabs' partials: dV at [:, 0], dK at [:, 1]
    part = (torch.empty((slabs, 2) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if slabs > 1 else None)
    *shapes, scale_arg = _shape_args(q, k, causal, scale)
    _launch("flash_bwd", "metisfl_flash_bwd_dkv_general",
            flash_bwd_dkv_general, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), *shapes, per_slab,
            slabs, scale_arg)
    if part is not None:
        flash_bwd_dkv_split_sum(part, Hq // Hkv, causal, per_slab,
                                out=(dk, dv))
    if Dk != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


flash_bwd_dkv_general.launches = 0


def dkv_split_sum_reference(part: torch.Tensor, group: int, causal: bool,
                            per_slab: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the split fp32 K3's second launch: ``(dk,
    dv)`` from partials ``(slabs, 2, B, Hkv, L, D)`` (dV at index 0, dK
    at 1), each row the sum, in slab order, of the slabs its 64-row k tile
    has (``ceil(steps / per_slab)`` of :func:`_slab_steps`); the rest of
    ``part`` is never read."""
    L = part.shape[4]
    rows = _slab_rows([-(-n // per_slab) for n in _slab_steps(
        L, group, causal)], L, part.device)
    out = part[0].clone()
    for slab in range(1, part.shape[0]):
        has = (rows > slab)[:, None]
        out = out + torch.where(has, part[slab], torch.zeros_like(out))
    return out[1], out[0]


def flash_bwd_dkv_split_sum(part: torch.Tensor, group: int, causal: bool,
                            per_slab: int,
                            out: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split K3's second launch: ``(dk, dv)`` (B, Hkv, L, D) from the
    fp32 partials ``(slabs, 2, B, Hkv, L, D)`` that
    :func:`flash_bwd_dkv_general` (fp32) or :func:`flash_bwd_dkv` (its
    bf16/fp16 D = 16, 32 and 256 builds) wrote with ``per_slab`` q steps a
    slab, for ``group`` query heads per KV head; written into ``out`` where
    given, whose dtype (fp32, bf16 or fp16, default fp32) the sums are
    rounded to once. CPU tensors run :func:`dkv_split_sum_reference`; CUDA
    tensors launch ``csrc/flash_bwd.cu``'s split sum (each row's slabs
    added in slab order) or raise. ``flash_bwd_dkv_split_sum.launches``
    counts launches."""
    if not _on_cuda(part):
        dk, dv = dkv_split_sum_reference(part, group, causal, per_slab)
        if out is None:
            return dk, dv
        out[0].copy_(dk)
        out[1].copy_(dv)
        return out
    if (part.dtype != torch.float32 or part.dim() != 6
            or part.shape[1] != 2 or not part.is_contiguous()
            or part.shape[-1] % 4):
        raise ValueError(f"part must be a contiguous (slabs, 2, B, Hkv, L, "
                         f"D) float32 tensor with D a multiple of 4, got "
                         f"{tuple(part.shape)} {part.dtype}")
    _, _, B, Hkv, L, D = part.shape
    if out is None:
        out = (torch.empty_like(part[0, 1]), torch.empty_like(part[0, 0]))
    dk, dv = out
    for name, t in (("dk", dk), ("dv", dv)):
        if (t.device != part.device or t.dtype not in _DTYPE_CODES
                or t.dtype != dk.dtype or t.shape != part.shape[2:]
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous "
                             f"{tuple(part.shape[2:])} float32, float16 or "
                             f"bfloat16 tensor on {part.device}, as dk")
    _check_aligned(part=part, dk=dk, dv=dv)
    _launch("flash_bwd", "metisfl_flash_bwd_dkv_split_sum",
            flash_bwd_dkv_split_sum, part.device, part.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hkv * group, Hkv, L, D,
            int(bool(causal)), per_slab, _DTYPE_CODES[dk.dtype])
    return dk, dv


flash_bwd_dkv_split_sum.launches = 0


def flash_bwd_dkv_general_mma(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on tensor cores at any head dim, bf16/fp16, on CUDA tensors, as
    :func:`flash_bwd_dkv`: q, k, v and dO zero-padded along D to
    :func:`mma_head_dim` (exact), then one launch of ``csrc/flash_bwd.cu``'s
    general tensor-core kernel, which makes dV and dK in blocks of one
    (64-row k tile, output, 256-column chunk, KV head), without atomics,
    with the (B, H, L, D) tensors 16-byte aligned; or raises.
    :func:`flash_bwd_dkv` routes bf16/fp16 at D > 256 here.
    ``flash_bwd_dkv_general_mma.launches`` counts launches (one per
    call)."""
    _bwd_inputs_on_cuda("flash_bwd_dkv_general_mma", q, k, v, do, lse,
                        delta)
    _check_dtype("flash_bwd_dkv_general_mma", q, _MMA_DTYPES)
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                     head_dims=(mma_head_dim(D),))
    _check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd", "metisfl_flash_bwd_dkv_general_mma",
            flash_bwd_dkv_general_mma, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_shape_args(q, k, causal, scale))
    if Dk != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


flash_bwd_dkv_general_mma.launches = 0


def flash_bwd_dq_general_mma(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             causal: bool = False) -> torch.Tensor:
    """K2 on tensor cores at any head dim, bf16/fp16, on CUDA tensors, as
    :func:`flash_bwd_dq`: q, k, v and dO zero-padded along D to
    :func:`mma_head_dim` (exact), then ``csrc/flash_bwd.cu``'s general
    tensor-core kernel, one block per (64-row q tile, 256-column chunk of
    dQ, head), without atomics, with the (B, H, L, D) tensors 16-byte
    aligned; or raises. :func:`flash_bwd_dq` routes bf16/fp16 at D > 256
    here. ``flash_bwd_dq_general_mma.launches`` counts launches (one per
    call)."""
    _bwd_inputs_on_cuda("flash_bwd_dq_general_mma", q, k, v, do, lse,
                        delta)
    _check_dtype("flash_bwd_dq_general_mma", q, _MMA_DTYPES)
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    Dk, (q, k, v, do) = pad_head_dim(q, k, v, do,
                                     head_dims=(mma_head_dim(D),))
    _check_aligned(q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    _launch("flash_bwd", "metisfl_flash_bwd_dq_general_mma",
            flash_bwd_dq_general_mma, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *_shape_args(q, k, causal, scale))
    return dq if Dk == D else dq[..., :D].contiguous()


flash_bwd_dq_general_mma.launches = 0


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
