"""Serving configuration: copies of the JAX package's ``ServingConfig`` and
``ServingDecodeConfig`` (config/federation.py), with the fields the port's
gateway reads."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ServingDecodeConfig:
    """Continuous-batching decode (serving/decode.py)."""

    # concurrent sequences per channel's in-flight batch
    slots: int = 4
    # KV-cache length: every request's prompt + max_new_tokens must fit
    max_len: int = 512


@dataclass
class ServingConfig:
    """Serving gateway (serving/gateway.py)."""

    # micro-batching: coalesce concurrent requests until the batch holds
    # max_batch rows or max_wait_ms elapsed since the first queued row.
    # Every forward pass pads to exactly max_batch rows, so per-row results
    # stay bit-identical to unbatched ones.
    max_batch: int = 8
    max_wait_ms: float = 5.0
    # deterministic canary: requests whose key hashes into the lowest
    # canary_percent slots route to the candidate channel (0 = all stable)
    canary_percent: float = 0.0
    decode: ServingDecodeConfig = field(default_factory=ServingDecodeConfig)
