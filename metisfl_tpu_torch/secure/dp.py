"""Client-level differential privacy for shipped model updates: the
port's copy of the JAX package's ``secure/dp.py``, host numpy, bit for
bit.

The Gaussian mechanism on the federated delta: before a learner ships its
trained model, the update ``delta = trained - received_community`` is
L2-clipped to ``clip_norm`` (one global norm over every float leaf) and
spherical Gaussian noise of per-coordinate std ``noise_multiplier *
clip_norm`` is added; the learner ships ``community + clipped_delta +
noise``. With ``noise_multiplier = 0`` this is plain update clipping.
Integer and bool leaves ship as trained.

Accounting: :func:`rdp_epsilon` turns ``(noise_multiplier, rounds,
delta)`` into ε by Rényi-DP composition of the full-participation
Gaussian mechanism (order α costs ``α / (2 σ²)`` a round; ε minimized
over an α grid). No subsampling amplification is claimed.

The noise comes from a ``numpy.random.Generator`` (OS entropy unless the
caller passes one), so a test can hand the same generator state to both
packages and compare bits. Privatization happens before any encryption
or masking.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from metisfl_tpu_torch.tensor.pytree import tree_leaves, tree_unflatten

Pytree = Any


def privatize_update(trained: Pytree, community: Pytree, clip_norm: float,
                     noise_multiplier: float = 0.0,
                     rng: Optional[np.random.Generator] = None) -> Pytree:
    """community + clip(trained - community) + noise, float leaves only.

    ``rng`` defaults to OS entropy — DP noise must not be a reproducible
    stream; inject a generator only in tests.
    """
    if clip_norm <= 0.0:
        raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
    if noise_multiplier < 0.0:
        raise ValueError(
            f"noise_multiplier must be >= 0, got {noise_multiplier}")
    if rng is None:
        rng = np.random.default_rng()

    t_leaves = tree_leaves(trained)
    c_leaves = tree_leaves(community)
    if len(t_leaves) != len(c_leaves):
        raise ValueError("trained/community tree mismatch")

    deltas = []
    sq_sum = 0.0
    for t, c in zip(t_leaves, c_leaves):
        t = np.asarray(t)
        if np.issubdtype(t.dtype, np.integer) or t.dtype == np.bool_:
            deltas.append(None)
            continue
        d = np.asarray(t, np.float32) - np.asarray(c, np.float32)
        sq_sum += float(np.sum(np.square(d, dtype=np.float64)))
        deltas.append(d)
    norm = math.sqrt(sq_sum)
    factor = min(1.0, clip_norm / max(norm, 1e-12))
    sigma = noise_multiplier * clip_norm

    out = []
    for t, c, d in zip(t_leaves, c_leaves, deltas):
        t = np.asarray(t)
        if d is None:
            out.append(t)  # discrete state: ship as trained
            continue
        shipped = np.asarray(c, np.float32) + d * factor
        if sigma > 0.0:
            shipped = shipped + rng.normal(
                0.0, sigma, size=shipped.shape).astype(np.float32)
        out.append(shipped.astype(t.dtype))
    return tree_unflatten(trained, out)


def rdp_epsilon(noise_multiplier: float, rounds: int,
                delta: float = 1e-5) -> float:
    """(ε) at the given δ for ``rounds`` compositions of the Gaussian
    mechanism with this ``noise_multiplier`` (full participation).

    RDP(α) per round = α / (2 σ²); T rounds sum; ε(δ) minimized over an
    α grid. Returns ``inf`` when σ == 0 (no noise, no guarantee).
    """
    if noise_multiplier <= 0.0:
        return math.inf
    if rounds <= 0:
        return 0.0
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    sigma2 = noise_multiplier ** 2
    log_inv_delta = math.log(1.0 / delta)
    best = math.inf
    for alpha in [1 + x / 10.0 for x in range(1, 1000)]:
        rdp = rounds * alpha / (2.0 * sigma2)
        best = min(best, rdp + log_inv_delta / (alpha - 1.0))
    return best
