"""FedAvg fold parity: the port's ``aggregation`` against the JAX
package's.

Host numpy trees (what every wire-arrived model is) fold natively in both
packages (``native/hostfold.cc``, the same source and g++ flags), and the
port's native fold is bit-identical to the JAX package's on this host.
The numpy folds (what serves where g++ cannot build the library) are
bit-identical too: the ``numpy_fold`` tests switch both packages' native
folds off (``_hostfold_lib = False``, restored after each test, as
tests/test_aggregation.py does), their ``native_fold`` twins load both.
Between the two folds the port holds within the JAX test's tolerance
(atol 1e-4, rtol 1e-5) and 2 f32 ulps of max|acc|. The port's tensor fold
(trees of torch tensors, folded where they live; CPU here) holds to its
host fold within 1e-6 relative. Inputs come from numpy seeds.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.aggregation.fedavg import FedAvg as JaxFedAvg
from metisfl_tpu_torch.aggregation import FedAvg, make_aggregation_rule
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.aggregation.base import is_host_tree
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.config import AggregationConfig, FederationConfig
from metisfl_tpu_torch.tensor.pytree import as_tensor, tree_map, to_numpy

BF16 = np.dtype(ml_dtypes.bfloat16)


def _pin_folds(value):
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = value
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


@pytest.fixture
def numpy_fold():
    """Both packages' folds without their native libraries."""
    yield from _pin_folds(False)


@pytest.fixture
def native_fold():
    """Both packages' native folds (built with g++ on first use)."""
    for _ in _pin_folds(None):
        if (jax_base._get_hostfold() is None
                or port_base._get_hostfold() is None):
            pytest.skip("g++ cannot build native/hostfold.cc here")
        yield


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
    _assert_folds_bit_identical(dtype, normalized, stride)
    assert port_base.fold_backend() == "numpy"


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32, np.float64],
                         ids=["f32", "bf16", "i32", "f64"])
@pytest.mark.parametrize("normalized", [True, False],
                         ids=["normalized", "unnormalized"])
@pytest.mark.parametrize("stride", [0, 2])
def test_native_host_fold_is_bit_identical_to_jax(native_fold, dtype,
                                                  normalized, stride):
    """The twin on both native folds: f32 and f64 leaves fold in
    hostfold.cc on both sides, bf16 and int32 leaves in numpy."""
    _assert_folds_bit_identical(dtype, normalized, stride)
    native = np.dtype(dtype) in (np.float32, np.float64)
    assert port_base.fold_backend() == ("native" if native else "numpy")


def _assert_folds_bit_identical(dtype, normalized, stride):
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
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    try:
        jax_base._hostfold_lib = None  # (re)load the native library
        port_base._hostfold_lib = False  # the port's numpy fold
        want = _fold(JaxFedAvg(), models, scales, 3)
        got = _fold(FedAvg(), models, scales, 3)
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved
    for g, w in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        ulp = np.spacing(np.float32(np.abs(w).max()))
        assert np.abs(g - w).max() <= 2 * ulp


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_native_fold_is_bit_identical_to_the_jax_native_fold(native_fold,
                                                             dtype, k):
    """``_native_fold`` of both packages on the same models: starting the
    accumulator and adding into it, over a length that is not a multiple
    of either OpenMP block (8192 f32, 4096 f64) and a 2-D leaf."""
    rng = np.random.default_rng(20 + k)
    n = 2 * 8192 + 37
    for shape in ((n,), (37, 29)):
        arrs = [rng.standard_normal(shape).astype(dtype) for _ in range(k)]
        scales = rng.random(k) * 3.0
        got = port_base._native_fold(None, arrs, scales)
        want = jax_base._native_fold(None, arrs, scales)
        assert got.dtype == want.dtype == np.dtype(dtype)
        assert got.tobytes() == want.tobytes()
        got2 = port_base._native_fold(got, arrs, scales[::-1].copy())
        want2 = jax_base._native_fold(want, arrs, scales[::-1].copy())
        assert got2 is got and want2 is want  # accumulated in place
        assert got2.tobytes() == want2.tobytes()


def test_native_fold_matches_the_numpy_fold(native_fold):
    """tests/test_aggregation.py's check on the port: the native fold
    against the numpy fold (init, then accumulate) at its tolerance, and
    ``fold_backend`` names the fold that ran."""
    rng = np.random.default_rng(13)
    block = [{"w": rng.standard_normal((64, 32)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float64)}
             for _ in range(5)]
    scales = rng.random(5)
    native_init = port_base.np_stacked_scaled_add(None, block, scales)
    native_acc = port_base.np_stacked_scaled_add(native_init, block, scales)
    assert port_base.fold_backend() == "native"
    port_base._hostfold_lib = False
    np_init = port_base.np_stacked_scaled_add(None, block, scales)
    np_acc = port_base.np_stacked_scaled_add(np_init, block, scales)
    assert port_base.fold_backend() == "numpy"
    for key in ("w", "b"):
        assert native_acc[key].dtype == np_acc[key].dtype
        np.testing.assert_allclose(native_acc[key], np_acc[key],
                                   atol=1e-4, rtol=1e-5)


def test_fold_backend_reports_mixed_leaves(native_fold):
    """A tree with f32 and int leaves folds each leaf where it can: the
    report names both folds."""
    block = [{"w": np.ones(3, np.float32), "c": np.ones(3, np.int32)}] * 2
    port_base.np_stacked_scaled_add(None, block, np.ones(2))
    assert port_base.fold_backend() == "native+numpy"


def test_unbuildable_native_fold_falls_back_to_numpy_and_says_so(
        monkeypatch, caplog):
    """Where g++ cannot build the library, the numpy fold serves, the
    first attempt logs it, and ``fold_backend`` reports it."""
    import metisfl_tpu_torch.native as native

    def refuse():
        raise RuntimeError("native build of hostfold.cc failed")

    monkeypatch.setattr(native, "load_hostfold", refuse)
    monkeypatch.setattr(port_base, "_hostfold_lib", None)
    with caplog.at_level("WARNING", logger="metisfl_tpu_torch.aggregation"):
        out = port_base.np_stacked_scaled_add(
            None, [{"w": np.ones(4, np.float32)}] * 3, np.full(3, 0.5))
    np.testing.assert_array_equal(out["w"], 1.5)
    assert port_base.fold_backend() == "numpy"
    assert port_base._hostfold_lib is False
    assert "host fold: numpy" in caplog.text


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
                                  "fedadam", "median", "krum"])
def test_other_rules_are_not_ported(name):
    """Every rule of the JAX package is ported: the config accepts it and
    the factory builds it (scaffold wants SGD local steps, as there)."""
    if name == "scaffold":
        with pytest.raises(ValueError, match="optimizer='sgd'"):
            FederationConfig(aggregation=AggregationConfig(rule=name),
                             train=TrainParams(optimizer="adam"))
    cfg = FederationConfig(aggregation=AggregationConfig(rule=name))
    assert cfg.aggregation.rule == name
    kwargs = {"device": "cpu"} if name in ("median", "krum") else {}
    assert make_aggregation_rule(name, **kwargs).name == name


def test_unknown_rule_is_a_value_error():
    assert make_aggregation_rule("FedAvg").name == "fedavg"
    with pytest.raises(ValueError):
        make_aggregation_rule("no-such-rule")
