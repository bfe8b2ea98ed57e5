"""Byzantine-robust aggregation rules: coordinate median, trimmed mean,
(Multi-)Krum, on the controller's device.

The port's copy of the JAX package's ``aggregation/robust.py``. These
rules bound the influence of up to ``f`` byzantine learners:

- ``median``: the coordinate-wise median across the cohort's models;
- ``trimmed_mean``: the coordinate-wise mean after dropping ``trim`` models
  from each tail (Yin et al.);
- ``krum`` / ``multikrum``: the model(s) whose summed squared distance to
  their n−f−2 nearest neighbours is smallest (Blanchard et al.);
  MultiKrum averages the best ``n − f``.

They need the whole cohort in one call, so they set
``requires_full_cohort`` and the controller collects every selected model
first. Scales are ignored by design: no learner may claim more weight.

Where they run: on ``device`` (``cuda`` unless the caller asks for the
CPU; a ``cuda`` rule with no GPU raises, it never combines on the CPU
instead). Each leaf of every model is copied to the device and stacked
there in fp32 (H2D), combined (a sort along the cohort axis, or Krum's one
``(n, d) @ (d, n)`` Gram product), cast back to its storage dtype and
copied to the host (D2H); ``last_timing`` holds the three times of the
last call. The JAX package computes the same with one XLA program and no
Pallas kernel, so these are torch ops, not hand-written kernels. A cohort
with a 64-bit leaf reduces on the host in float64, as the JAX package does
under its default x32 mode (``_combine_np``).

Bits against the JAX package:

- the median is ``jnp.median``'s: a sort, then ``(low + high) * 0.5``
  (``torch.median`` returns the lower middle value, and
  ``torch.quantile`` refuses more than 2**24 elements); a NaN in a column
  makes its median NaN;
- ``_trim`` trims at least one model from each tail at n ≥ 3, as the JAX
  rule does (at n = 3 the trimmed mean is the median);
- Krum's scores are translated by the first model (distances do not
  change; the vectors shrink to the updates, so ``|a|² + |b|² - 2 a·b``
  cancels far less), then the Gram product runs in float64, column
  chunk by chunk, and its upper triangle is mirrored so equal distances
  score equal; the selection is ``np.argsort`` of the n scores on the
  host, as in the JAX package. The JAX package's Gram product is fp32: at
  LlamaLite size (1e8 coordinates, three learners' near-equal updates)
  its rounding is larger than the gaps between the distances, so the
  card's and the CPU's fp32 products picked different models; in
  float64 both pick by the distances. MultiKrum's mean runs in float64
  in the order of the selection and is cast on the host
  (``np_finalize``).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from metisfl_tpu_torch.aggregation.base import (
    Pytree,
    finalize,
    host_array,
    is_wide_tree,
    np_finalize,
)
from metisfl_tpu_torch.tensor.pytree import (
    as_tensor,
    to_numpy,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

logger = logging.getLogger("metisfl_tpu_torch.aggregation.robust")


def median_leaf(s: torch.Tensor) -> torch.Tensor:
    """Coordinate median over the leading cohort axis, as ``jnp.median``
    computes it (its ``midpoint`` quantile)."""
    n = s.shape[0]
    s = torch.sort(s, dim=0).values  # NaN sorts last
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(s[-1]), s[-1], mid)


def trimmed_mean_leaf(s: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate mean over the leading cohort axis of what is left after
    dropping ``trim`` values from each tail: the sum over the count, a
    true division (a tensor divisor: a Python one becomes a multiply by
    its reciprocal on the GPU)."""
    s = torch.sort(s, dim=0).values
    kept = s[trim: s.shape[0] - trim] if trim else s
    count = torch.tensor(float(kept.shape[0]), dtype=s.dtype,
                         device=s.device)
    return kept.sum(dim=0) / count


# columns of Krum's float64 Gram product per matmul (bounds the float64
# copy of the cohort to n x this)
_KRUM_CHUNK = 1 << 22


def krum_scores(flat: torch.Tensor, f: int) -> np.ndarray:
    """``flat``: (n, d) fp32 model vectors, on any device; overwritten
    (translated by its first row). Returns the (n,) Krum scores on the
    host (lower = more central): each model's summed squared distance to
    its n − f − 2 nearest others, all distances from one float64 Gram
    product."""
    n = flat.shape[0]
    flat.sub_(flat[0].clone())
    gram = torch.zeros((n, n), dtype=torch.float64, device=flat.device)
    for start in range(0, flat.shape[1], _KRUM_CHUNK):
        x = flat[:, start:start + _KRUM_CHUNK].double()
        gram += x @ x.T
    gram = torch.triu(gram) + torch.triu(gram, 1).T
    sq = torch.diagonal(gram)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2.fill_diagonal_(float("inf"))
    k = max(1, n - f - 2)
    nearest = torch.sort(d2, dim=1).values[:, :k]
    return nearest.sum(dim=1).cpu().numpy()


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return as_tensor(np.empty((0,), np.asarray(leaf).dtype)).dtype


class _RobustBase:
    """The whole-cohort shell: advisory scores, the 64-bit host path, the
    device check and the timing of the three stages.

    ``advisory_scores`` (the health plane's divergence scores, ROADMAP.md
    Queue 1 item 4) are recorded on ``last_advisory`` and logged; the
    combine is the same with or without them."""

    required_lineage = 1
    requires_full_cohort = True
    last_advisory: Optional[Dict[str, float]] = None

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        # the last aggregate's stages: {"device", "h2d_ms", "combine_ms",
        # "d2h_ms"}
        self.last_timing: Dict[str, object] = {}

    def reset(self) -> None:
        pass

    def _note_advisory(self, learner_ids,
                       advisory_scores: Optional[Dict[str, float]]) -> None:
        if advisory_scores is None:
            return
        self.last_advisory = dict(advisory_scores)
        flagged = [lid for lid in learner_ids or ()
                   if advisory_scores.get(lid, 0.0) >= 1.0]
        if flagged:
            logger.info("%s aggregating a cohort containing divergence-"
                        "flagged learner(s) %s (advisory; combine "
                        "unchanged)", self.name, flagged)

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"the {self.name} rule runs on {self.device}, and no CUDA "
                "device is available; build it with device='cpu' to "
                "combine on the CPU")

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _to_device(self, leaf) -> torch.Tensor:
        if isinstance(leaf, torch.Tensor):
            return leaf.to(self.device)
        # the wire's read-only arrays go to the GPU without a host copy
        return as_tensor(leaf, read_only=self.device.type == "cuda").to(
            self.device)

    def _cohort(self, models, learner_ids, advisory_scores) -> List[Pytree]:
        self._note_advisory(learner_ids, advisory_scores)
        cohort = [lineage[0] for lineage, _scale in models]
        if not cohort:
            raise ValueError(f"{self.name} called with no models")
        return cohort

    def _host_timing(self, t0: float) -> None:
        self.last_timing = {"device": "host", "h2d_ms": 0.0,
                            "combine_ms": (time.perf_counter() - t0) * 1e3,
                            "d2h_ms": 0.0}

    def aggregate(self, models, state=None, learner_ids=None,
                  advisory_scores=None) -> Pytree:
        cohort = self._cohort(models, learner_ids, advisory_scores)
        template = cohort[0]
        if any(is_wide_tree(m) for m in cohort):
            t0 = time.perf_counter()
            result = self._combine_np([tree_map(host_array, m)
                                       for m in cohort])
            out = np_finalize(result, 1.0, like=template)
            self._host_timing(t0)
            return out
        self._check_device()
        dtypes = tuple(_torch_dtype(x) for x in tree_leaves(template))
        t0 = self._sync()
        stacked = tree_map(lambda *xs: torch.stack(
            [self._to_device(x).to(torch.float32) for x in xs]), *cohort)
        t1 = self._sync()
        combined = self._combine(stacked, len(cohort))
        del stacked
        t2 = self._sync()
        out = tree_map(to_numpy, finalize(combined, 1.0, dtypes))
        t3 = time.perf_counter()
        self.last_timing = {"device": str(self.device),
                            "h2d_ms": (t1 - t0) * 1e3,
                            "combine_ms": (t2 - t1) * 1e3,
                            "d2h_ms": (t3 - t2) * 1e3}
        return out

    # the device (torch) and the 64-bit host (numpy) implementations
    def _combine(self, stacked: Pytree, n: int) -> Pytree:
        raise NotImplementedError

    def _combine_np(self, cohort: Sequence[Pytree]) -> Pytree:
        raise NotImplementedError


def _stack_np(cohort):
    return tree_map(
        lambda *xs: np.stack([np.asarray(x, np.float64) for x in xs]),
        *cohort)


class CoordinateMedian(_RobustBase):
    name = "median"

    def _combine(self, stacked, n):
        return tree_map(median_leaf, stacked)

    def _combine_np(self, cohort):
        return tree_map(lambda s: np.median(s, axis=0), _stack_np(cohort))


class TrimmedMean(_RobustBase):
    """Coordinate-wise trimmed mean. At ``n >= 3`` at least one model is
    trimmed from each tail even when ``floor(n * trim_ratio) == 0``: a
    robust rule that turned into the plain mean at small cohorts would
    leave a single poisoner unbounded."""

    name = "trimmed_mean"

    def __init__(self, trim_ratio: float = 0.1, device="cuda"):
        if not 0.0 <= trim_ratio < 0.5:
            raise ValueError("trim_ratio must be in [0, 0.5)")
        super().__init__(device)
        self.trim_ratio = float(trim_ratio)

    def _trim(self, n: int) -> int:
        trim = int(np.floor(n * self.trim_ratio))
        if n >= 3:
            trim = max(1, trim)
        if n - 2 * trim < 1:
            trim = (n - 1) // 2
        return trim

    def _combine(self, stacked, n):
        trim = self._trim(n)
        return tree_map(lambda s: trimmed_mean_leaf(s, trim), stacked)

    def _combine_np(self, cohort):
        trim = self._trim(len(cohort))

        def leaf(s):
            s = np.sort(s, axis=0)
            kept = s[trim: s.shape[0] - trim] if trim else s
            return kept.mean(axis=0)

        return tree_map(leaf, _stack_np(cohort))


class Krum(_RobustBase):
    """``multi=0``: classic Krum (adopt the single most central model).
    ``multi=m``: MultiKrum, the mean of the ``m`` best-scored models
    (``m=0`` with ``name='multikrum'`` takes ``n − f``)."""

    def __init__(self, byzantine_f: int = 0, multi: int = 0,
                 name: str = "krum", device="cuda"):
        super().__init__(device)
        self.byzantine_f = int(byzantine_f)
        self.multi = int(multi)
        self.name = name

    def _effective_f(self, n: int) -> int:
        f = self.byzantine_f if self.byzantine_f > 0 else max(0, (n - 3) // 2)
        return min(f, max(0, n - 3))  # scores need n - f - 2 >= 1

    def _select_count(self, n: int) -> int:
        """How many best-scored models the rule adopts."""
        if self.name == "multikrum" or self.multi > 0:
            m = self.multi if self.multi > 0 else max(
                1, n - self._effective_f(n))
            return min(m, n)
        return 1

    def _order(self, scores: np.ndarray, n: int) -> List[int]:
        return [int(i) for i in np.argsort(scores)[:self._select_count(n)]]

    def aggregate(self, models, state=None, learner_ids=None,
                  advisory_scores=None) -> Pytree:
        cohort = self._cohort(models, learner_ids, advisory_scores)
        if any(is_wide_tree(m) for m in cohort):
            t0 = time.perf_counter()
            out = self._aggregate_np(cohort)
            self._host_timing(t0)
            return out
        self._check_device()
        n = len(cohort)
        multi = self._select_count(n) > 1
        t0 = self._sync()
        leaves: List[List[torch.Tensor]] = []
        flat = None
        for i, model in enumerate(cohort):
            row = [self._to_device(x) for x in tree_leaves(model)]
            if flat is None:
                flat = torch.empty((n, sum(x.numel() for x in row)),
                                   dtype=torch.float32, device=self.device)
            off = 0
            for x in row:
                flat[i, off: off + x.numel()].copy_(x.reshape(-1))
                off += x.numel()
            # MultiKrum averages the picked models' own leaves
            leaves.append(row if multi else [])
        t1 = self._sync()
        order = self._order(krum_scores(flat, self._effective_f(n)), n)
        del flat
        if not multi:
            t2 = time.perf_counter()
            out = tree_map(host_array, cohort[order[0]])
            d2h = (time.perf_counter() - t2) * 1e3
        else:
            count = torch.tensor(float(len(order)), dtype=torch.float64,
                                 device=self.device)
            means = []
            for j in range(len(leaves[0])):
                acc = leaves[order[0]][j].to(torch.float64)
                for i in order[1:]:
                    acc = acc + leaves[i][j].to(torch.float64)
                means.append(acc / count)
            del leaves
            t2 = self._sync()
            template = cohort[0]
            out = np_finalize(tree_unflatten(template, [to_numpy(m)
                                                   for m in means]),
                              1.0, like=template)
            d2h = (time.perf_counter() - t2) * 1e3
        self.last_timing = {"device": str(self.device),
                            "h2d_ms": (t1 - t0) * 1e3,
                            "combine_ms": (t2 - t1) * 1e3, "d2h_ms": d2h}
        return out

    def _aggregate_np(self, cohort) -> Pytree:
        """The 64-bit host path: float64 scores, the JAX package's
        numpy code."""
        n = len(cohort)
        flat = np.stack([
            np.concatenate([np.asarray(host_array(leaf), np.float64).ravel()
                            for leaf in tree_leaves(m)]) for m in cohort])
        d2 = (np.sum(flat**2, 1)[:, None] + np.sum(flat**2, 1)[None, :]
              - 2.0 * flat @ flat.T)
        np.fill_diagonal(d2, np.inf)
        k = max(1, n - self._effective_f(n) - 2)
        scores = np.sort(d2, axis=1)[:, :k].sum(axis=1)
        picked = [cohort[i] for i in self._order(scores, n)]
        if len(picked) == 1:
            return tree_map(host_array, picked[0])
        mean = tree_map(lambda s: s.mean(axis=0),
                        _stack_np([tree_map(host_array, m) for m in picked]))
        return np_finalize(mean, 1.0, like=cohort[0])
