"""Autoregressive greedy decoding with a fixed-shape KV cache.

The torch side of the JAX package's ``models/generate.py``. PyTorch runs
eagerly, so the token loop is a Python loop and there is no compiled
program to cache. The KV cache is a fixed (B, kv_heads, max_len, head_dim)
buffer per block, written in place at each step's position; GQA caches
stay at kv-head size.

Decoding is greedy (argmax, first index on ties, as ``jnp.argmax``).
Sampling with ``temperature > 0`` draws from ``jax.random`` in the JAX
package and waits for a later slice: it raises here.

``model`` is a zoo ``LlamaLite`` holding its weights (the JAX package's
``module`` plus ``variables``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def init_cache(model, batch: int, max_len: int, device=None):
    """Zeroed per-block KV caches for ``model`` (a zoo ``LlamaLite``)."""
    kv_heads = model.kv_heads or model.heads
    head_dim = model.dim // model.heads
    dtype = model.dtype or torch.float32
    device = _device_of(model) if device is None else device
    shape = (batch, kv_heads, max_len, head_dim)
    return tuple(
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(model.depth))


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             pad_id: int = 0, max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy continuation of ``prompt`` (B, L_p): (B, max_new_tokens)
    int32 tokens on the model's device; after a row emits ``eos_id`` the
    rest of that row is ``pad_id``. Sampling is not ported:
    ``temperature > 0`` raises."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet; "
            "metisfl_tpu_torch decodes greedily")
    device = _device_of(model)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                             device=device)
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be (batch, length), got "
                         f"{tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    B, Lp = prompt.shape
    total = Lp + max_new_tokens
    if max_len is not None and max_len < total:
        raise ValueError(f"max_len {max_len} < prompt+new = {total}")
    max_len = max_len or total
    caches = init_cache(model, B, max_len, device)
    # prefill: one full-width pass writes the prompt's K/V and yields the
    # first next-token distribution
    logits, caches = model(prompt, caches=caches, position=0)
    tok = logits[:, -1].argmax(dim=-1)
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    for pos in range(Lp, Lp + max_new_tokens - 1):
        logits, caches = model(tok[:, None], caches=caches, position=pos)
        nxt = logits[:, -1].argmax(dim=-1)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)


class SlotDecoder:
    """Fixed-slot KV-cache decode for continuous batching (Orca, Yu et al.
    OSDI 2022).

    - ``prefill(model, slot, prompt)`` writes one prompt's K/V into slot
      ``slot`` of the shared cache and returns its first greedy token. The
      prompt runs at its exact length on a batch-1 view of the slot, the
      same computation a solo :func:`generate` prefill makes.
    - ``step(model, tokens, positions)`` advances every slot one token in
      one batched forward, each row at its own cache position (the JAX
      package's ``vmap`` over slots, written out as a batch dimension with
      per-row positions).

    The caches are allocated once at ``(slots, kv_heads, max_len,
    head_dim)`` per block. A retiring slot needs no cleanup: attention
    masks every position beyond the occupant's frontier to exactly zero
    weight, and a new occupant's prefill and decode overwrite each position
    before it becomes attendable.

    Greedy only: serving-plane generation is deterministic by contract.
    """

    def __init__(self, model, slots: int, max_len: int, device=None):
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.caches = init_cache(model, self.slots, self.max_len, device)

    @torch.no_grad()
    def prefill(self, model, slot: int, prompt) -> int:
        """Admit a prompt into ``slot``; returns the first greedy token."""
        device = self.caches[0][0].device
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=device).reshape(1, -1)
        L = int(prompt.shape[1])
        if L < 1 or L >= self.max_len:
            raise ValueError(
                f"prompt length {L} must be in [1, max_len={self.max_len})")
        sub = tuple((ck[slot:slot + 1], cv[slot:slot + 1])
                    for ck, cv in self.caches)
        logits, _ = model(prompt, caches=sub, position=0)
        return int(logits[0, -1].argmax())

    @torch.no_grad()
    def step(self, model, tokens, positions) -> np.ndarray:
        """Advance EVERY slot one decode token. ``tokens``/``positions`` are
        (slots,) ints; free slots pass any value (their rows compute
        garbage that is never read, and their cache writes land where a
        future prefill overwrites). Returns the (slots,) next tokens."""
        device = self.caches[0][0].device
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=device).reshape(self.slots, 1)
        poss = torch.as_tensor(np.asarray(positions), dtype=torch.long,
                               device=device).reshape(self.slots)
        logits, _ = model(toks, caches=self.caches, position=poss)
        return logits[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()
