"""Paillier additively-homomorphic encryption (demo-grade).

The reference carries a Paillier walkthrough next to its CKKS scheme
(reference test/fhe/demo/paillier_example.py); this is the rebuild's
counterpart — a from-scratch textbook Paillier (keygen / encrypt /
decrypt / ciphertext addition / plaintext scaling) with fixed-point
vector packing (the port's copy of the JAX package's ``secure/paillier.py``:
keys and ciphertexts are plain integers that either package reads).

Demo-grade means exactly that: pure-Python bignum modexp costs
milliseconds PER COORDINATE, so federating a 1.4M-param model through it
would take hours — production secure aggregation in this framework is the
CKKS scheme (native/ckks.cc: RLWE packing amortizes one ring operation
over 4096 coefficients) or pairwise masking (secure/masking.py). The
module exists so the capability surface matches the reference's demo
material and so the additive-HE math has an executable specification.

Scheme (Paillier 1999), with the standard g = n + 1 simplification:

- keygen: n = p·q (distinct primes), λ = lcm(p−1, q−1),
  μ = λ⁻¹ mod n
- encrypt(m): c = (1 + m·n) · rⁿ mod n²  with random r ∈ Z*_n
- decrypt(c): L(c^λ mod n²) · μ mod n,  L(x) = (x−1)/n
- Enc(a) ⊕ Enc(b) = Enc(a+b): multiply ciphertexts mod n²
- k ⊙ Enc(a) = Enc(k·a): ciphertext exponentiation
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from math import gcd
from typing import List, Sequence

import numpy as np

# 64 first odd primes for fast trial division before Miller-Rabin
_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109,
                 113, 127, 131, 137, 139, 149, 151, 157, 163, 167, 173,
                 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
                 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293,
                 307, 311, 313]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    """Miller-Rabin with random bases (error ≤ 4^-rounds)."""
    if n < 2:
        return False
    if n == 2:
        return True
    if n % 2 == 0:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        # top TWO bits set: p·q of two such primes always reaches the full
        # 2·bits length (single-top-bit primes can lose a bit in n = p·q)
        cand = (secrets.randbits(bits)
                | (1 << (bits - 1)) | (1 << (bits - 2)) | 1)
        if _is_probable_prime(cand):
            return cand


@dataclass(frozen=True)
class PaillierPublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def encrypt_int(self, m: int) -> int:
        """Encrypt m ∈ [0, n). Negative plaintexts are represented mod n
        (decrypt_int recenters)."""
        n, n_sq = self.n, self.n_sq
        m %= n
        while True:
            r = secrets.randbelow(n - 1) + 1
            if gcd(r, n) == 1:
                break
        # g = n+1 ⇒ g^m = 1 + m·n (mod n²): one bigint mul beats a modexp
        return ((1 + m * n) % n_sq) * pow(r, n, n_sq) % n_sq

    def add(self, c1: int, c2: int) -> int:
        """Enc(a) ⊕ Enc(b) → Enc(a + b)."""
        return (c1 * c2) % self.n_sq

    def scale(self, c: int, k: int) -> int:
        """k ⊙ Enc(a) → Enc(k·a) (k a non-negative integer)."""
        if k < 0:
            raise ValueError("scale factor must be non-negative "
                             "(encode signed weights in fixed point)")
        return pow(c, k, self.n_sq)


@dataclass(frozen=True)
class PaillierPrivateKey:
    public: PaillierPublicKey
    lam: int
    mu: int

    def decrypt_int(self, c: int) -> int:
        n, n_sq = self.public.n, self.public.n_sq
        x = pow(c, self.lam, n_sq)
        m = ((x - 1) // n) * self.mu % n
        # recenter: values above n/2 are negatives
        return m - n if m > n // 2 else m


def generate_keypair(bits: int = 1024):
    """(public, private) with an n of ``bits`` bits. 1024 keeps the demo
    fast; real deployments of Paillier use ≥ 3072-bit n (and this
    framework's production path is CKKS/masking regardless)."""
    half = bits // 2
    p = _random_prime(half)
    while True:
        q = _random_prime(half)
        if q != p:
            break
    n = p * q
    lam = (p - 1) * (q - 1) // gcd(p - 1, q - 1)   # lcm
    mu = pow(lam, -1, n)
    return PaillierPublicKey(n), PaillierPrivateKey(PaillierPublicKey(n),
                                                    lam, mu)


# ---------------------------------------------------------------------- #
# fixed-point vector API (the demo's federated-average shape)
# ---------------------------------------------------------------------- #

_SCALE_BITS = 40  # plaintext fixed point; weights use a second 32-bit scale
_W_SCALE_BITS = 32


def encrypt_vector(pub: PaillierPublicKey, values: Sequence[float]
                   ) -> List[int]:
    scale = 1 << _SCALE_BITS
    return [pub.encrypt_int(int(round(float(v) * scale))) for v in values]


def weighted_sum(pub: PaillierPublicKey,
                 ciphervecs: Sequence[Sequence[int]],
                 weights: Sequence[float]) -> List[int]:
    """Σᵢ wᵢ ⊙ Enc(vᵢ) computed entirely on ciphertexts — the aggregator
    never decrypts (the PWA shape, reference
    private_weighted_average.cc:22-111, on Paillier instead of CKKS)."""
    if len(ciphervecs) != len(weights):
        raise ValueError("one weight per ciphertext vector")
    if not ciphervecs:
        raise ValueError("nothing to aggregate")
    length = len(ciphervecs[0])
    if any(len(cv) != length for cv in ciphervecs):
        raise ValueError("ciphertext vectors must share a length")
    wscale = 1 << _W_SCALE_BITS
    int_weights = [int(round(float(w) * wscale)) for w in weights]
    out: List[int] = []
    for j in range(length):
        # 1 is the multiplicative identity = an (unrandomized) Enc(0);
        # seeding with encrypt_int(0) would cost a full n-bit modexp per
        # coordinate — ~10x the three 32-bit-weight scalings combined.
        # Each term carries its own encryption randomness, so the product
        # is a properly randomized ciphertext.
        acc = 1
        for cv, iw in zip(ciphervecs, int_weights):
            acc = pub.add(acc, pub.scale(cv[j], iw))
        out.append(acc)
    return out


def decrypt_vector(priv: PaillierPrivateKey, cipher: Sequence[int],
                   weighted: bool = False) -> np.ndarray:
    """Decrypt a vector; ``weighted=True`` removes the extra weight scale
    applied by :func:`weighted_sum`."""
    scale = float(1 << _SCALE_BITS)
    if weighted:
        scale *= float(1 << _W_SCALE_BITS)
    return np.asarray([priv.decrypt_int(c) / scale for c in cipher],
                      np.float64)
