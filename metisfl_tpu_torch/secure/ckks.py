"""CKKS backend: ctypes bridge over the native RLWE library.

The port's copy of the JAX package's ``secure/ckks.py`` over the port's own
build of ``native/ckks.cc`` (``build/metisfl_tpu_torch/``, made by g++ at
first use). Where g++ cannot build it, every entry point here raises.

API-equivalent of the reference's ``fhe.CKKS`` pybind module
(reference metisfl/encryption/pybind/ckks_pybind.cc:16-92, backed by
ckks_scheme.cc:110-252): keygen to a directory, encrypt float vectors,
homomorphic weighted average, decrypt. Key custody mirrors the reference's
driver flow (driver_session.py:110-140): learners hold pk+sk; the controller
needs NO key material at all here — coefficient-packed weighted sums are
keyless (the reference's controller still needed the crypto context).
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from metisfl_tpu_torch.native import load_ckks


def generate_keys(key_dir: str) -> str:
    """Driver-side keygen (reference GenCryptoContextAndKeys,
    ckks_scheme.cc:13-75): writes pk.bin/sk.bin under ``key_dir``."""
    os.makedirs(key_dir, exist_ok=True)
    lib = load_ckks()
    rc = lib.ckks_keygen(key_dir.encode())
    if rc != 0:
        raise RuntimeError(f"CKKS keygen failed (rc={rc}) in {key_dir!r}")
    os.chmod(os.path.join(key_dir, "sk.bin"), 0o600)
    return key_dir


class CKKSBackend:
    """HEBackend over the native library.

    ``role='learner'`` loads pk+sk from ``key_dir``; ``role='controller'``
    is keyless — it can only combine ciphertexts, never read them.
    """

    name = "ckks"

    def __init__(self, key_dir: str = "", role: str = "learner"):
        # the native ring packs 8192 values per ciphertext at a fixed 2^32
        # value scale
        self._lib = load_ckks()
        self.role = role
        self.key_dir = key_dir
        self._ctx = None
        if role == "learner":
            if not key_dir:
                raise ValueError("CKKS learner backend requires key_dir")
            ctx = self._lib.ckks_open(key_dir.encode(), 1)
            if not ctx:
                raise RuntimeError(f"no CKKS keys found under {key_dir!r}")
            self._ctx = ctypes.c_void_p(ctx)
            if not self._lib.ckks_has_secret(self._ctx):
                raise RuntimeError(f"missing sk.bin under {key_dir!r}")

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.ckks_close(ctx)

    # -- HEBackend contract ----------------------------------------------

    def encrypt(self, values: np.ndarray) -> bytes:
        if self._ctx is None:
            raise RuntimeError("controller-role CKKS backend cannot encrypt")
        vals = np.ascontiguousarray(values, np.float64).ravel()
        n = len(vals)
        cap = self._lib.ckks_ciphertext_size(n)
        out = (ctypes.c_ubyte * cap)()
        written = self._lib.ckks_encrypt(
            self._ctx, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, out, cap)
        if written < 0:
            raise RuntimeError(f"CKKS encrypt failed (rc={written}); values "
                               "must satisfy |v| <= 63")
        return ctypes.string_at(out, written)

    def decrypt(self, payload: bytes, num_values: int) -> np.ndarray:
        if self._ctx is None:
            raise RuntimeError("controller-role CKKS backend cannot decrypt")
        # read-only cast straight over the bytes object (the C side never
        # writes the payload) — skips a full ciphertext copy
        buf = ctypes.cast(ctypes.c_char_p(payload),
                          ctypes.POINTER(ctypes.c_ubyte))
        out = np.empty(num_values, np.float64)
        rc = self._lib.ckks_decrypt(
            self._ctx, buf, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), num_values)
        if rc < 0:
            raise RuntimeError(f"CKKS decrypt failed (rc={rc})")
        return out

    def weighted_sum(self, payloads: Sequence[bytes],
                     scales: Sequence[float]) -> bytes:
        """Homomorphic Σ scaleᵢ·ctᵢ (the reference's ComputeWeightedAverage,
        ckks_scheme.cc:165-207) — keyless."""
        k = len(payloads)
        if k == 0:
            raise ValueError("weighted_sum needs at least one payload")
        arr_t = ctypes.c_char_p * k
        ptrs = arr_t(*[ctypes.c_char_p(p) for p in payloads])
        sizes = (ctypes.c_long * k)(*[len(p) for p in payloads])
        sc = (ctypes.c_double * k)(*[float(s) for s in scales])
        cap = len(payloads[0])
        out = (ctypes.c_ubyte * cap)()
        written = self._lib.ckks_weighted_sum(
            ptrs, sizes, sc, k, out, cap)
        if written < 0:
            raise RuntimeError(f"CKKS weighted_sum failed (rc={written}); "
                               "payloads must be same-shape fresh ciphertexts")
        return ctypes.string_at(out, written)
