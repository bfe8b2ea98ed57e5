"""Llama-lite causal LM (+LoRA) as torch modules, the serving slice of the
JAX package's ``models/zoo/transformer.py``.

Every module keeps the Flax parameter names and layouts as its own
attribute names, so ``state_dict`` keys are the Flax path with '.' for '/'
(``block_0.attn.wq.base.kernel`` is ``params/block_0/attn/wq/base/kernel``)
and dense kernels stay ``(in, out)``: the port computes ``x @ kernel``, and
carrying weights across (models/convert.py) is a renaming, never a
transpose.

Numerics follow Flax: ``dtype`` is the compute dtype over fp32 params
(inputs and kernels are cast to it before each product); RMSNorm reduces in
fp32 with eps 1e-6; the dense attention runs its softmax in fp32 and casts
the weights back; the LM head runs in fp32.

Constructors allocate zeroed parameters on ``device``; fill them with
:func:`init_params` (an explicit ``torch.Generator``) or with
``models.convert.load_flax_variables``. ``remat=True`` recomputes each
block's activations in the backward pass (``torch.utils.checkpoint``, as
``nn.remat`` does). MoE FFNs and sequence parallelism (``sp_mesh``) are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from metisfl_tpu_torch.ops.flash_attention import attention, flash_attention

DType = Optional[torch.dtype]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to metisfl_tpu_torch "
                               "yet (see ROADMAP.md)")


def _param(*shape, device=None, fill=0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32,
                                   device=device))


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``kernel`` (in, out), optional ``bias``; inputs
    and params are cast to ``dtype`` (default: their promoted type)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, dtype: DType = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, features, device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in training each element is zeroed with
    probability ``rate`` and the rest are scaled by ``1 / (1 - rate)``.
    The masks are drawn from ``generator``, a ``torch.Generator`` on the
    input's device that ``TorchModelOps.train`` installs for the length of
    its call, so engines training in parallel threads never share a random
    stream (``None`` draws from torch's default generator)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class LoRADense(nn.Module):
    """Dense with an optional low-rank adapter: y = xW + scale·(xA)B.

    ``lora_a``/``lora_b`` match the ``lora_`` trainable-mask regex; the
    base kernel lives under ``base`` as in Flax."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, use_bias: bool = True,
                 dtype: DType = None, device=None):
        super().__init__()
        self.rank = rank
        self.alpha = alpha
        self.dtype = dtype
        self.base = Dense(in_features, features, use_bias=use_bias,
                          dtype=dtype, device=device)
        if rank > 0:
            self.lora_a = _param(in_features, rank, device=device)
            self.lora_b = _param(rank, features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.rank > 0:
            a, b = self.lora_a, self.lora_b
            if self.dtype is not None:
                a, b = a.to(self.dtype), b.to(self.dtype)
            y = y + (x @ a) @ b * (self.alpha / self.rank)
        return y


class RMSNorm(nn.Module):
    """Flax ``nn.RMSNorm``: mean square in fp32, eps 1e-6, ``scale``."""

    def __init__(self, dim: int, dtype: DType = None, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = _param(dim, device=device, fill=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * (torch.rsqrt(var + self.eps) * self.scale)
        return y.to(self.dtype or torch.promote_types(x.dtype,
                                                      self.scale.dtype))


class Embed(nn.Module):
    """Flax ``nn.Embed``: ``embedding`` (vocab, dim), looked up in
    ``dtype`` (gathering then casting equals Flax's cast-then-take)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: DType = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param(num_embeddings, features, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        out = F.embedding(tokens.long(), self.embedding)
        return out if self.dtype is None else out.to(self.dtype)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the last (head) dimension, in the
    rotate-half layout. ``positions`` broadcasts against ``x.shape[:-1]``;
    the angles are fp32 and the result is fp32 (callers cast back)."""
    half = x.shape[-1] // 2
    freqs = torch.from_numpy(
        1.0 / (10000 ** (np.arange(0, half) / half))).to(
            dtype=torch.float32, device=x.device)
    angles = positions.float()[..., None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Attention(nn.Module):
    """Multi-head attention with 2D projection kernels and native GQA.

    ``use_flash=True`` runs the flash kernel (ops/flash_attention.py),
    ``"auto"`` routes on sequence length, ``False`` is the dense path. A
    ``cache`` switches to incremental decode (:meth:`_cached_attention`).
    """

    def __init__(self, dim: int, heads: int, causal: bool = False,
                 rotary: bool = False, dropout: float = 0.0,
                 lora_rank: int = 0, sp_mesh=None, sp_axis: str = "sp",
                 sp_strategy: str = "ring", sp_block_kernels: bool = False,
                 use_flash: Union[bool, str] = False, dtype: DType = None,
                 kv_heads: int = 0, device=None):
        super().__init__()
        if sp_mesh is not None or sp_block_kernels:
            raise _not_ported("sequence-parallel attention (sp_mesh)")
        kv_heads = kv_heads or heads
        if kv_heads <= 0 or heads % kv_heads:
            raise ValueError(f"heads ({heads}) must be a multiple of "
                             f"kv_heads ({kv_heads})")
        if dropout > 0.0 and use_flash:
            raise ValueError(
                "attention dropout > 0 is only supported on the dense "
                "attention path; set dropout=0 or disable use_flash")
        self.dim, self.heads, self.kv_heads = dim, heads, kv_heads
        self.head_dim = dim // heads
        self.causal, self.rotary = causal, rotary
        self.dropout = Dropout(dropout)
        self.use_flash = use_flash
        kv_dim = kv_heads * self.head_dim
        # LoRA on q/v only (standard practice)
        self.wq = LoRADense(dim, dim, rank=lora_rank, use_bias=False,
                            dtype=dtype, device=device)
        self.wk = LoRADense(dim, kv_dim, use_bias=False, dtype=dtype,
                            device=device)
        self.wv = LoRADense(dim, kv_dim, rank=lora_rank, use_bias=False,
                            dtype=dtype, device=device)
        self.wo = Dense(dim, dim, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, cache=None,
                position=None):
        B, L, _ = x.shape
        hd = self.head_dim
        q = self.wq(x).reshape(B, L, self.heads, hd).transpose(1, 2)
        k = self.wk(x).reshape(B, L, self.kv_heads, hd).transpose(1, 2)
        v = self.wv(x).reshape(B, L, self.kv_heads, hd).transpose(1, 2)
        if cache is not None:
            out, cache = self._cached_attention(q, k, v, cache, position)
            out = out.transpose(1, 2).reshape(B, L, self.dim)
            return self.wo(out), cache
        if self.rotary:
            positions = torch.arange(L, dtype=torch.float32, device=x.device)
            dt = q.dtype
            q = _rotary(q, positions).to(dt)
            k = _rotary(k, positions).to(dt)
        if self.use_flash:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if self.use_flash == "auto":
                out = attention(q, k, v, self.causal)
            else:
                out = flash_attention(q, k, v, self.causal)
        else:
            group = self.heads // self.kv_heads
            if group > 1:
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            # softmax in fp32 whatever the compute dtype, then back to it
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * float(
                1.0 / np.sqrt(hd))
            if self.causal:
                mask = torch.ones(L, L, dtype=torch.bool,
                                  device=x.device).tril()
                scores = scores.masked_fill(~mask,
                                            torch.finfo(torch.float32).min)
            weights = torch.softmax(scores, dim=-1).to(v.dtype)
            weights = self.dropout(weights, train)
            out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        out = out.transpose(1, 2).reshape(B, L, self.dim)
        return self.wo(out)

    def _cached_attention(self, q, k, v, cache, position):
        """Incremental attention against a KV cache (autoregressive decode).

        ``cache`` is ``(ck, cv)`` of shape (B, kv_heads, L_max, head_dim)
        and is written IN PLACE (the JAX package returns new buffers; here
        the update saves a cache-sized copy per step). ``position`` is the
        first query position: an int for the whole batch, or a (B,) tensor
        with one position per row (the continuous batcher's slots). q
        attends over the whole cache under ``key_pos <= position + q_idx``,
        which also hides the cache's unwritten tail. Dense math: at L = 1
        there is no (L, L) matrix for flash to save."""
        ck, cv = cache
        B, _, L, hd = q.shape
        L_max = ck.shape[2]
        ar = torch.arange(L, device=q.device)
        per_row = isinstance(position, torch.Tensor) and position.dim() == 1
        if per_row:
            pos = position.to(device=q.device, dtype=torch.long)
            q_pos = pos[:, None] + ar                        # (B, L)
        else:
            p0 = int(position)
            q_pos = p0 + ar                                  # (L,)
        if self.rotary:
            rot_pos = q_pos[:, None, :] if per_row else q_pos
            dt = q.dtype
            q = _rotary(q, rot_pos).to(dt)
            k = _rotary(k, rot_pos).to(dt)
        if per_row:
            rows = torch.arange(B, device=q.device)[:, None]
            ck[rows, :, q_pos] = k.transpose(1, 2).to(ck.dtype)
            cv[rows, :, q_pos] = v.transpose(1, 2).to(cv.dtype)
        else:
            ck[:, :, p0:p0 + L] = k.to(ck.dtype)
            cv[:, :, p0:p0 + L] = v.to(cv.dtype)
        # grouped einsums read the cache at kv-head size; query heads group
        # contiguously per kv head (the layout repeat_interleave gives)
        group = self.heads // self.kv_heads
        qg = q.reshape(B, self.kv_heads, group, L, hd)
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, ck).float() * float(
            1.0 / np.sqrt(hd))
        key_pos = torch.arange(L_max, device=q.device)
        mask = key_pos <= q_pos[..., None]       # (L, L_max) or (B, L, L_max)
        mask = mask[:, None, None] if per_row else mask[None, None, None]
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = torch.einsum("bhgqk,bhkd->bhgqd", weights, cv)
        return out.reshape(B, self.heads, L, hd), (ck, cv)


class SwiGLU(nn.Module):
    """Llama-style gated MLP."""

    def __init__(self, dim: int, hidden: int, dtype: DType = None,
                 device=None):
        super().__init__()
        self.gate = Dense(dim, hidden, use_bias=False, dtype=dtype,
                          device=device)
        self.up = Dense(dim, hidden, use_bias=False, dtype=dtype,
                        device=device)
        self.down = Dense(hidden, dim, use_bias=False, dtype=dtype,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class DecoderBlock(nn.Module):
    """Pre-RMSNorm causal block (Llama style) with rotary + SwiGLU."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 lora_rank: int = 0, sp_mesh=None, sp_strategy: str = "ring",
                 sp_block_kernels: bool = False,
                 use_flash: Union[bool, str] = False, moe_experts: int = 0,
                 moe_top_k: int = 1, dtype: DType = None, kv_heads: int = 0,
                 device=None):
        super().__init__()
        if moe_experts > 0:
            raise _not_ported("the MoE FFN (moe_experts > 0)")
        self.attn = Attention(dim, heads, causal=True, rotary=True,
                              lora_rank=lora_rank, sp_mesh=sp_mesh,
                              sp_strategy=sp_strategy,
                              sp_block_kernels=sp_block_kernels,
                              use_flash=use_flash, dtype=dtype,
                              kv_heads=kv_heads, device=device)
        self.RMSNorm_0 = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = SwiGLU(dim, mlp_ratio * dim, dtype=dtype, device=device)
        self.RMSNorm_1 = RMSNorm(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, cache=None,
                position=None):
        normed = self.RMSNorm_0(x)
        if cache is not None:
            a, cache = self.attn(normed, train=train, cache=cache,
                                 position=position)
        else:
            a = self.attn(normed, train=train)
        x = x + a
        x = x + self.mlp(self.RMSNorm_1(x))
        return x if cache is None else (x, cache)


class LlamaLite(nn.Module):
    """Decoder-only causal LM (RMSNorm + rotary + SwiGLU). ``lora_rank > 0``
    adds adapters on q/v; ``kv_heads`` gives grouped-query attention;
    ``dtype=torch.bfloat16`` computes in bf16 over fp32 params with fp32
    logits; ``remat=True`` checkpoints every block when gradients are on."""

    def __init__(self, vocab_size: int = 8192, dim: int = 64, depth: int = 4,
                 heads: int = 4, lora_rank: int = 0, sp_mesh=None,
                 sp_strategy: str = "ring", sp_block_kernels: bool = False,
                 use_flash: Union[bool, str] = False, moe_experts: int = 0,
                 moe_top_k: int = 1, remat: bool = False, dtype: DType = None,
                 kv_heads: int = 0, device=None):
        super().__init__()
        self.vocab_size, self.dim, self.depth = vocab_size, dim, depth
        self.heads, self.kv_heads = heads, kv_heads
        self.dtype = dtype
        self.use_flash = use_flash
        # rematerialize each block's activations in the backward pass:
        # ~1/3 more FLOPs for O(depth) less activation memory
        self.remat = remat
        self.embed = Embed(vocab_size, dim, dtype=dtype, device=device)
        for i in range(depth):
            self.add_module(f"block_{i}", DecoderBlock(
                dim, heads, lora_rank=lora_rank, sp_mesh=sp_mesh,
                sp_strategy=sp_strategy, sp_block_kernels=sp_block_kernels,
                use_flash=use_flash, moe_experts=moe_experts,
                moe_top_k=moe_top_k, dtype=dtype, kv_heads=kv_heads,
                device=device))
        self.RMSNorm_0 = RMSNorm(dim, dtype=dtype, device=device)
        self.lm_head = Dense(dim, vocab_size, use_bias=False, device=device)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, tokens: torch.Tensor, train: bool = False,
                caches=None, position=None):
        x = self.embed(tokens)
        new_caches = []
        for i, block in enumerate(self.blocks()):
            if caches is not None:
                x, c = block(x, train, cache=caches[i], position=position)
                new_caches.append(c)
            elif self.remat and torch.is_grad_enabled():
                # decode (the cache branch) never rematerializes: it has
                # no backward pass
                x = checkpoint(block, x, train, use_reentrant=False)
            else:
                x = block(x, train)
        x = self.RMSNorm_0(x)
        # logits in fp32: softmax-cross-entropy over a large vocab is
        # precision-sensitive, and this final cast is cheap
        logits = self.lm_head(x.float())
        return logits if caches is None else (logits, tuple(new_caches))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator`` (a CPU generator; draws are
    copied to the parameter's device): dense and conv kernels and
    embeddings N(0, 1/fan_in) (fan_in: every kernel axis but the last) and
    N(0, 1/dim), ``lora_a`` N(0, 0.02²), ``lora_b``, biases zero, norm
    scales one. These are not Flax's draws; weights from the JAX package
    come across through models/convert.py."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel" or leaf == "embedding":
            fan = math.prod(p.shape[:-1]) if leaf == "kernel" else p.shape[1]
            std = 1.0 / math.sqrt(fan)
        elif leaf == "lora_a":
            std = 0.02
        elif leaf == "scale":
            p.fill_(1.0)
            continue
        else:  # lora_b, bias
            p.zero_()
            continue
        p.copy_(torch.randn(p.shape, generator=generator) * std)
