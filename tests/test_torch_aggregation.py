"""FedAvg fold parity: the port's ``aggregation`` against the JAX
package's.

Host numpy trees (what every wire-arrived model is) must fold to the same
bits as the JAX package's numpy fold, so its native host fold is switched
off here (``_hostfold_lib = False``, restored after each test, as
tests/test_aggregation.py does); against the native fold the port holds
within 2 f32 ulps of max|acc|. The port's tensor fold (trees of torch
tensors, folded where they live; CPU here) holds to its host fold within
1e-6 relative. Inputs come from numpy seeds.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.aggregation.fedavg import FedAvg as JaxFedAvg
from metisfl_tpu_torch.aggregation import FedAvg, make_aggregation_rule
from metisfl_tpu_torch.aggregation.base import is_host_tree
from metisfl_tpu_torch.config import AggregationConfig, FederationConfig
from metisfl_tpu_torch.tensor.pytree import as_tensor, tree_map, to_numpy

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture
def numpy_fold():
    """The JAX package's fold without its native library."""
    saved = jax_base._hostfold_lib
    jax_base._hostfold_lib = False
    try:
        yield
    finally:
        jax_base._hostfold_lib = saved


def _models(dtype, k=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        if np.dtype(dtype).kind in "iu":
            tree = {"w": rng.integers(-1000, 1000, (17, 9)).astype(dtype),
                    "b": rng.integers(0, 50, (9,)).astype(dtype)}
        else:
            tree = {"w": rng.standard_normal((17, 9)).astype(dtype),
                    "nested": {"b": rng.standard_normal((9,)).astype(dtype),
                               "s": np.asarray(rng.standard_normal(),
                                               dtype)}}
        out.append(tree)
    return out


def _scales(k, normalized, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.random(k) + 0.1
    return list(w / w.sum() if normalized else w * 7.0)


def _fold(rule, models, scales, stride):
    """Accumulate in blocks of ``stride`` (0: one block), as the
    controller does, then finalize."""
    pairs = [([m], s) for m, s in zip(models, scales)]
    step = stride or len(pairs)
    rule.reset()
    for i in range(0, len(pairs), step):
        rule.accumulate(pairs[i:i + step])
    out = rule.result()
    rule.reset()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32, np.float64],
                         ids=["f32", "bf16", "i32", "f64"])
@pytest.mark.parametrize("normalized", [True, False],
                         ids=["normalized", "unnormalized"])
@pytest.mark.parametrize("stride", [0, 2])
def test_host_fold_is_bit_identical_to_jax(numpy_fold, dtype, normalized,
                                           stride):
    models = _models(dtype)
    scales = _scales(len(models), normalized)
    got = _fold(FedAvg(), models, scales, stride)
    want = _fold(JaxFedAvg(), models, scales, stride)
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.dtype(dtype)
        assert g.shape == w.shape
        # bit for bit, bf16 included (compare the raw bits)
        assert g.tobytes() == w.tobytes()


def test_integer_leaves_round_half_to_even(numpy_fold):
    """Means that land on .5 round to the even neighbour (np.rint), and
    the JAX package agrees."""
    a = {"c": np.array([1, 2, -1, -2, 7], np.int32)}
    b = {"c": np.array([2, 3, -2, -3, 8], np.int32)}
    pairs = [([a], 0.5), ([b], 0.5)]
    got = FedAvg().aggregate(pairs)["c"]
    want = np.asarray(JaxFedAvg().aggregate(pairs)["c"])
    np.testing.assert_array_equal(got, [2, 2, -2, -2, 8])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_host_fold_within_two_ulps_of_the_native_fold():
    """The JAX package's native host fold (when its toolchain builds it)
    sums in another order; the port's numpy fold stays within 2 f32 ulps
    of max|acc| of it."""
    models = _models(np.float32, k=7, seed=3)
    scales = _scales(7, normalized=False, seed=4)
    saved = jax_base._hostfold_lib
    try:
        jax_base._hostfold_lib = None  # (re)load the native library
        want = _fold(JaxFedAvg(), models, scales, 3)
    finally:
        jax_base._hostfold_lib = saved
    got = _fold(FedAvg(), models, scales, 3)
    for g, w in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        ulp = np.spacing(np.float32(np.abs(w).max()))
        assert np.abs(g - w).max() <= 2 * ulp


@pytest.mark.parametrize("dtype", [np.float32, np.float64, BF16, np.int32],
                         ids=["f32", "f64", "bf16", "i32"])
@pytest.mark.parametrize("stride", [0, 2])
def test_tensor_fold_agrees_with_host_fold(dtype, stride):
    """Trees of torch tensors fold with torch ops in the same accumulator
    dtypes and come back as tensors of the storage dtypes."""
    models = _models(dtype, seed=5)
    scales = _scales(len(models), normalized=False, seed=6)
    host = _fold(FedAvg(), models, scales, stride)
    tensors = [tree_map(as_tensor, m) for m in models]
    assert not is_host_tree(tensors[0]) and is_host_tree(models[0])
    dev = _fold(FedAvg(), tensors, scales, stride)
    for h, d in zip(_leaves(host), _leaves(dev)):
        assert isinstance(d, torch.Tensor)
        d = to_numpy(d)
        assert d.dtype == h.dtype
        if h.dtype.kind in "iu":
            # integer means round; a 1e-6 difference can flip a .5 tie
            assert np.abs(d.astype(np.int64) - h.astype(np.int64)).max() <= 1
        else:
            h64, d64 = h.astype(np.float64), d.astype(np.float64)
            tol = 1e-6 if h.dtype != BF16 else 2.0 ** -8
            assert np.abs(d64 - h64).max() <= tol * max(1.0,
                                                        np.abs(h64).max())


def test_aggregate_rejects_empty_and_result_before_accumulate():
    with pytest.raises(ValueError):
        FedAvg().aggregate([])
    with pytest.raises(ValueError):
        FedAvg().result()


@pytest.mark.parametrize("name", ["fedstride", "fedrec", "scaffold",
                                  "fedadam", "median", "krum", "secure_agg"])
def test_other_rules_are_not_ported(name):
    """FederationConfig refuses the JAX package's other rules by name; the
    factory knows only what it builds."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederationConfig(aggregation=AggregationConfig(rule=name))
    with pytest.raises(ValueError, match="unknown aggregation rule"):
        make_aggregation_rule(name)


def test_unknown_rule_is_a_value_error():
    assert make_aggregation_rule("FedAvg").name == "fedavg"
    with pytest.raises(ValueError):
        make_aggregation_rule("no-such-rule")
