"""Identity (plaintext) backend: validates the secure-agg plumbing without
cryptography — payloads are raw float64 little-endian bytes."""

from __future__ import annotations

from typing import Sequence

import numpy as np


class IdentityBackend:
    name = "identity"

    def encrypt(self, values: np.ndarray) -> bytes:
        return np.asarray(values, np.float64).tobytes()

    def decrypt(self, payload: bytes, num_values: int) -> np.ndarray:
        out = np.frombuffer(payload, np.float64)
        if len(out) < num_values:
            raise ValueError(f"payload has {len(out)} values, need {num_values}")
        return out[:num_values].copy()

    def weighted_sum(self, payloads: Sequence[bytes],
                     scales: Sequence[float]) -> bytes:
        acc = None
        for payload, scale in zip(payloads, scales):
            vec = np.frombuffer(payload, np.float64) * scale
            acc = vec if acc is None else acc + vec
        return acc.tobytes()
