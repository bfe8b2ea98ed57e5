"""Secure aggregation: weighted average over encrypted payloads (the
port's copy of the JAX package's ``aggregation/secure.py``).

Equivalent of the reference's ``PWA`` (private weighted average) over CKKS
ciphertexts (reference metisfl/controller/aggregation/private_weighted_average.cc:9-111,
metisfl/encryption/palisade/ckks_scheme.cc:110-252): the controller combines
learner models homomorphically and **never decrypts** — only learners hold
the secret key.

The HE scheme is pluggable via :class:`HEBackend`; concrete backends live in
:mod:`metisfl_tpu_torch.secure` (CKKS via the native library, pairwise additive
masking as the lightweight alternative, and an identity backend
for tests/examples).
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.tensor.spec import TensorKind, TensorSpec

# An encrypted model: name -> (opaque payload, plaintext-shaped spec).
OpaqueModel = Dict[str, Tuple[bytes, TensorSpec]]


class HEBackend(Protocol):
    """Homomorphic-ish backend contract (mirrors the reference's ``HEScheme``
    ABC, he_scheme.h:20-42, minus keygen which lives driver-side)."""

    name: str

    def encrypt(self, values: np.ndarray) -> bytes:
        """Encrypt a flat float array into an opaque payload."""
        ...

    def decrypt(self, payload: bytes, num_values: int) -> np.ndarray:
        """Decrypt back to a flat float array of ``num_values`` items."""
        ...

    def weighted_sum(self, payloads: Sequence[bytes], scales: Sequence[float]) -> bytes:
        """Σ scaleᵢ·payloadᵢ computed without decryption."""
        ...


class SecureAgg:
    """Aggregate encrypted models via an :class:`HEBackend`.

    Scales are normalized host-side before the homomorphic combine (the
    reference does the same: scaling factors are plaintext scalars in
    ``EvalMult``, ckks_scheme.cc:185-200).
    """

    name = "secure_agg"
    required_lineage = 1

    def __init__(self, backend: HEBackend):
        self.backend = backend

    def aggregate(
        self,
        models: Sequence[Tuple[Sequence[OpaqueModel], float]],
        state=None,
        correction: Optional[Dict[str, bytes]] = None,
    ) -> OpaqueModel:
        """``correction`` (masking dropout recovery, secure/masking.py):
        per-tensor residual-mask bytes a surviving learner computed for the
        round's dropped parties — forwarded to the backend so a partial
        cohort still unmasks to the surviving sum."""
        if not models:
            raise ValueError("SecureAgg.aggregate called with no models")
        total = sum(float(scale) for _, scale in models)
        if total <= 0:
            raise ValueError("secure aggregation needs positive total scale")
        scales = [float(scale) / total for _, scale in models]
        first = models[0][0][0]
        out: OpaqueModel = {}
        for name, (_, spec) in first.items():
            payloads = []
            for (lineage, _), _s in zip(models, scales):
                model = lineage[0]
                if name not in model:
                    raise KeyError(f"encrypted model missing tensor {name!r}")
                payloads.append(model[name][0])
            if correction is not None:
                combined = self.backend.weighted_sum(
                    payloads, scales, correction=correction[name])
            else:
                combined = self.backend.weighted_sum(payloads, scales)
            out[name] = (combined, TensorSpec(spec.shape, spec.dtype, TensorKind.CIPHERTEXT))
        return out

    def reset(self) -> None:
        pass
