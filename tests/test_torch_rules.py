"""The port's aggregation rules against the JAX package's.

The same numpy inputs, made from fixed seeds, go through each JAX rule
and its port (FedStride, FedRec, FedNova, FedAvgM/FedAdam/FedYogi,
median, trimmed mean, Krum, MultiKrum). The port's robust rules run with
``device="cpu"`` here (the card runs them in ``chip_smoke.py``).

Tolerances: bit for bit unless a test says otherwise. The fold rules'
host folds run numpy in both packages (``_hostfold_lib = False`` on both
sides, restored after each test, as tests/test_torch_aggregation.py
pins them). tests/conftest.py turns JAX's x64 mode on, where its robust
rules would reduce 64-bit trees in float32; the ``x32_hosts`` fixture
restores their default x32 choice (64-bit trees on the host, in float64,
``use_numpy_fold``), which is the port's. The trimmed mean over more than
one kept model holds within 2 f32 ulps of max|x| (the two packages' sums
may add in another order). Krum's scores hold within 1e-5 relative of
float64 distances (the port translates the cohort by its first model
before the Gram product; the JAX package's untranslated scores within
1e-3), and its selection and result are the JAX package's exactly.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.aggregation import make_aggregation_rule as jax_rule
from metisfl_tpu.aggregation import robust as jax_robust
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.aggregation import make_aggregation_rule as port_rule
from metisfl_tpu_torch.aggregation import robust as port_robust
from metisfl_tpu_torch.tensor.pytree import as_tensor, to_numpy, tree_map

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.float32, BF16, np.int32, np.float64]
DTYPE_IDS = ["f32", "bf16", "i32", "f64"]
ROBUST = ("median", "trimmed_mean", "krum", "multikrum")
RULES = ("fedstride", "fedrec", "fednova", "fedavgm", "fedadam", "fedyogi",
         *ROBUST)
# the JAX controller's hyperparameters for a small, well-conditioned step
SERVER = dict(learning_rate=0.1, beta1=0.9, beta2=0.99, tau=1e-3)


@pytest.fixture(autouse=True)
def numpy_fold():
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


@pytest.fixture(autouse=True)
def x32_hosts(monkeypatch):
    """The JAX robust rules' x32-mode locale: 64-bit trees on the host."""
    def use_numpy_fold(tree):
        return any(np.dtype(leaf.dtype) in jax_base._WIDE
                   for leaf in jax.tree.leaves(tree))

    monkeypatch.setattr(jax_robust, "use_numpy_fold", use_numpy_fold)


def _tree(rng, dtype, center=0.0, spread=1.0):
    if np.dtype(dtype).kind in "iu":
        return {"w": rng.integers(-1000, 1000, (17, 9)).astype(dtype),
                "nested": {"b": rng.integers(0, 50, (9,)).astype(dtype),
                           "s": np.asarray(rng.integers(0, 9), dtype)}}
    return {"w": (center + spread * rng.standard_normal((17, 9))).astype(
                dtype),
            "nested": {"b": (center + spread * rng.standard_normal(9))
                       .astype(dtype),
                       "s": np.asarray(center + spread
                                       * rng.standard_normal(), dtype)}}


def _models(dtype, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return [_tree(rng, dtype) for _ in range(k)]


def _scales(k, seed=1):
    w = np.random.default_rng(seed).random(k) + 0.1
    return list(w / w.sum())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def _assert_bits(got, want):
    got_l, want_l = list(_leaves(got)), list(_leaves(want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _assert_close(got, want, ulps=2):
    """Within ``ulps`` f32 ulps of max|want| (integers: equal)."""
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w)
            continue
        w64, g64 = w.astype(np.float64), g.astype(np.float64)
        tol = ulps * 2.0 ** -23 * max(1.0, float(np.abs(w64).max()))
        if w.dtype == BF16:
            # one bf16 ulp: a last-bit sum difference can flip a rounding
            tol = 2.0 ** -7 * max(1.0, float(np.abs(w64).max()))
        assert float(np.abs(g64 - w64).max()) <= tol


def _build(name, **extra):
    jax_kw, port_kw = {}, {}
    if name in ("fedavgm", "fedadam", "fedyogi"):
        jax_kw = port_kw = dict(SERVER)
    if name in ROBUST:
        port_kw = {"device": "cpu"}
    jax_kw, port_kw = {**jax_kw, **extra}, {**port_kw, **extra}
    return jax_rule(name, **jax_kw), port_rule(name, **port_kw)


def _aggregate(rule, models, scales, name, ids=None, steps=None):
    pairs = [([m], s) for m, s in zip(models, scales)]
    if name == "fednova":
        return rule.aggregate(pairs, steps=steps)
    if name in ("fedstride", "fedrec"):
        return rule.aggregate(pairs, learner_ids=ids)
    return rule.aggregate(pairs)


# -- every rule, every dtype --------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", RULES)
def test_rule_matches_the_jax_package(name, dtype):
    """One aggregation of 5 models (the stateful rules from a seeded
    community model, FedNova with uneven steps): bit for bit, but the
    trimmed mean of 3 kept models (within 2 f32 ulps of max|x|)."""
    models = _models(dtype)
    scales = _scales(len(models))
    ids = [f"L{i}" for i in range(len(models))]
    steps = [1, 3, 8, 0, 5]
    jax_r, port_r = _build(name)
    if hasattr(jax_r, "seed_community"):
        seed = _tree(np.random.default_rng(9), dtype)
        jax_r.seed_community(seed)
        port_r.seed_community(seed)
    want = _aggregate(jax_r, models, scales, name, ids, steps)
    got = _aggregate(port_r, models, scales, name, ids, steps)
    if name == "trimmed_mean" and np.dtype(dtype) != np.float64:
        _assert_close(got, want)
    else:
        _assert_bits(got, want)
    if name in ROBUST:
        assert port_r.last_timing["device"] == (
            "host" if dtype == np.float64 else "cpu")


@pytest.mark.parametrize("name", ROBUST)
def test_robust_rules_take_tensor_trees_where_they_live(name):
    """A cohort of torch tensor trees combines like its numpy twin."""
    models = _models(np.float32, k=4, seed=3)
    _, port_r = _build(name)
    want = _aggregate(port_r, models, _scales(4), name)
    tensors = [tree_map(as_tensor, m) for m in models]
    got = _aggregate(port_r, tensors, _scales(4), name)
    _assert_bits(tree_map(lambda x: to_numpy(x) if torch.is_tensor(x)
                          else x, got), want)


# -- the median's midpoint, the trim rule -------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_median_is_jnp_median_at_odd_and_even_n(n):
    """jnp.median takes (low + high) * 0.5 at even n; torch.median would
    take the lower middle value."""
    models = _models(np.float32, k=n, seed=n)
    jax_r, port_r = _build("median")
    got = _aggregate(port_r, models, [1.0] * n, "median")
    want = _aggregate(jax_r, models, [1.0] * n, "median")
    _assert_bits(got, want)
    stack = np.stack([m["w"] for m in models])
    np.testing.assert_array_equal(got["w"], np.median(stack, axis=0))
    if n % 2 == 0:
        lower = torch.median(torch.from_numpy(stack), dim=0).values.numpy()
        assert not np.array_equal(got["w"], lower)


def test_median_of_a_column_with_nan_is_nan():
    stack = torch.tensor([[1.0, 2.0], [float("nan"), 3.0], [0.5, 4.0]])
    out = port_robust.median_leaf(stack)
    want = np.asarray(jax_robust.median_leaf(jnp.asarray(stack.numpy())))
    assert bool(torch.isnan(out[0])) and np.isnan(want[0])
    assert float(out[1]) == float(want[1]) == 3.0


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.25, 0.45])
@pytest.mark.parametrize("n", range(1, 8))
def test_trim_counts_match(n, ratio):
    jax_r, port_r = _build("trimmed_mean", trim_ratio=ratio)
    assert port_r._trim(n) == jax_r._trim(n)
    if n >= 3:
        assert port_r._trim(n) >= 1


def test_trimmed_mean_of_three_is_the_median():
    models = _models(np.float32, k=3, seed=4)
    _, port_r = _build("trimmed_mean")
    _, median = _build("median")
    _assert_bits(_aggregate(port_r, models, [1.0] * 3, "trimmed_mean"),
                 _aggregate(median, models, [1.0] * 3, "median"))


def test_trim_ratio_out_of_range_is_refused():
    with pytest.raises(ValueError, match="trim_ratio"):
        port_rule("trimmed_mean", trim_ratio=0.5, device="cpu")


# -- Krum ---------------------------------------------------------------------

def _separated(n_honest=5, n_bad=2, seed=0):
    """Honest models near 1.0 and byzantine ones far away, each at its own
    distance, so no two scores tie."""
    rng = np.random.default_rng(seed)
    honest = [_tree(rng, np.float32, 1.0, 0.01 * (i + 1))
              for i in range(n_honest)]
    bad = [_tree(rng, np.float32, -50.0 * (i + 1), 1.0)
           for i in range(n_bad)]
    return honest + bad


@pytest.mark.parametrize("f", [0, 1, 2])
@pytest.mark.parametrize("name", ["krum", "multikrum"])
def test_krum_selects_as_the_jax_package(name, f):
    """The same selection, in the same order; Krum's result is that model
    bit for bit, MultiKrum's float64 mean of the picks bit for bit."""
    models = _separated()
    n = len(models)
    jax_r, port_r = _build(name, byzantine_f=f)
    flat = np.stack([np.concatenate([np.asarray(x, np.float32).ravel()
                                     for x in _leaves(m)]) for m in models])
    want_scores = np.asarray(jax_robust._krum_scores(
        jnp.asarray(flat), jax_r._effective_f(n)))
    got_scores = port_robust.krum_scores(torch.from_numpy(flat.copy()),
                                         port_r._effective_f(n))
    # both against the scores of float64 distances: the port's within
    # 1e-5, the JAX package's (|a|² + |b|² - 2 a·b untranslated, which
    # cancels) within 1e-3
    exact = np.array([[np.sum((flat[i].astype(np.float64) - flat[j]) ** 2)
                       for j in range(n)] for i in range(n)])
    np.fill_diagonal(exact, np.inf)
    k = max(1, n - port_r._effective_f(n) - 2)
    exact = np.sort(exact, axis=1)[:, :k].sum(axis=1)
    np.testing.assert_allclose(got_scores, exact, rtol=1e-5)
    np.testing.assert_allclose(want_scores, exact, rtol=1e-3)
    m = jax_r._select_count(n)
    assert port_r._select_count(n) == m
    assert port_r._order(got_scores, n) == [
        int(i) for i in np.argsort(want_scores)[:m]]
    got = _aggregate(port_r, models, [1.0] * n, name)
    want = _aggregate(jax_r, models, [1.0] * n, name)
    _assert_bits(got, want)
    if port_r._effective_f(n) >= 2:
        # told of (at least) the 2 byzantine models, none enters
        assert float(np.abs(got["w"] - 1.0).max()) < 0.5


def test_krum_scores_are_translation_invariant():
    """Scores of models far from the origin (a trained network's weights
    and its small updates) do not drown in |a|² + |b|² - 2 a·b."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal(200_000).astype(np.float32)
    flat = np.stack([base + 1e-3 * (i + 1)
                     * rng.standard_normal(base.size).astype(np.float32)
                     for i in range(4)])
    exact = np.array([[np.sum((flat[i].astype(np.float64) - flat[j]) ** 2)
                       for j in range(4)] for i in range(4)])
    np.fill_diagonal(exact, np.inf)
    want = np.sort(exact, axis=1)[:, :1].sum(axis=1)
    got = port_robust.krum_scores(torch.from_numpy(flat.copy()), 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_krum_scores_hold_float64_distances_at_a_near_tie():
    """Three learners' near-equal updates over 2e6 coordinates: the
    distances differ by ~1e-3 relative, about what an fp32 Gram product
    of this length gets wrong. The float64 product (over several column
    chunks) holds the float64 distances to 1e-12, so its pick is the
    distances' pick on any device."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal(2_000_000).astype(np.float32)
    flat = np.stack([base + np.float32(1e-3) * rng.standard_normal(
        base.size).astype(np.float32) for _ in range(3)])
    # the rule translates by the first model in fp32 (the same rounding
    # on every device), then measures in float64
    moved = (flat - flat[0]).astype(np.float64)
    exact = np.array([[np.sum((moved[i] - moved[j]) ** 2)
                       for j in range(3)] for i in range(3)])
    np.fill_diagonal(exact, np.inf)
    want = np.sort(exact, axis=1)[:, :1].sum(axis=1)
    saved = port_robust._KRUM_CHUNK
    port_robust._KRUM_CHUNK = 300_000
    try:
        got = port_robust.krum_scores(torch.from_numpy(flat.copy()), 0)
    finally:
        port_robust._KRUM_CHUNK = saved
    np.testing.assert_allclose(got, want, rtol=1e-12)
    _, port_r = _build("krum")
    assert port_r._order(got, 3) == [int(np.argsort(want)[0])]


def test_equal_distances_score_equal():
    """The Gram product's mirrored triangle: a tie is a tie, and argsort
    picks the lower index, as the JAX package's does."""
    flat = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 3.0]])
    scores = port_robust.krum_scores(flat.clone(), 0)
    assert scores[0] == scores[1]
    _, port_r = _build("krum")
    assert port_r._order(scores, 3) == [0]


# -- 64-bit trees and the device ----------------------------------------------

def test_robust_rules_keep_float64_exactly():
    """A value f32 cannot hold survives every robust rule (the host
    float64 path), as in tests/test_robust.py."""
    exact = np.float64(16_777_217.0)
    models = [{"w": np.full((4,), exact + i, np.float64),
               "c": np.asarray(2**53 - 1, np.int64)} for i in range(3)]
    for name in ROBUST:
        jax_r, port_r = _build(name)
        got = _aggregate(port_r, models, [1.0] * 3, name)
        _assert_bits(got, _aggregate(jax_r, models, [1.0] * 3, name))
        assert float(got["w"][0]) >= exact
        assert port_r.last_timing["device"] == "host"


@pytest.mark.parametrize("name", ROBUST)
def test_a_cuda_rule_without_a_gpu_raises(name):
    """No fallback: a rule asked for cuda never combines on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    rule = port_rule(name)
    assert rule.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _aggregate(rule, _models(np.float32, k=3), [1.0] * 3, name)


# -- the stateful rules over rounds -------------------------------------------

@pytest.mark.parametrize("opt", ["fedavgm", "fedadam", "fedyogi"])
def test_server_opt_three_rounds_with_a_retried_round(opt):
    """Round 2's result() is not committed (an aggregation-failure retry)
    and the round runs again: every result, the retried one included,
    equals the JAX package's numpy step bit for bit, and the retry does
    not step twice."""
    jax_r, port_r = _build(opt)
    seed = _tree(np.random.default_rng(11), np.float32)
    jax_r.seed_community(seed)
    port_r.seed_community(seed)
    for r in range(3):
        models = _models(np.float32, k=4, seed=20 + r)
        pairs = [([m], s) for m, s in zip(models, _scales(4, seed=r))]
        tries = 2 if r == 1 else 1
        for t in range(tries):
            outs = []
            for rule in (jax_r, port_r):
                rule.reset()
                rule.accumulate(pairs)
                outs.append(rule.result())
                rule.reset()
                if t == tries - 1:
                    rule.commit()
            _assert_bits(outs[1], outs[0])
        assert port_r._step == jax_r._step == r + 1


def test_server_opt_cold_start_adopts_the_average():
    jax_r, port_r = _build("fedadam")
    models = _models(np.float32, k=3)
    got = _aggregate(port_r, models, _scales(3), "fedadam")
    _assert_bits(got, _aggregate(jax_r, models, _scales(3), "fedadam"))
    assert port_r._step == 0 and port_r._prev is not None


def test_server_opt_integer_leaves_adopt_the_average():
    jax_r, port_r = _build("fedyogi")
    seed = _tree(np.random.default_rng(2), np.int32)
    for rule in (jax_r, port_r):
        rule.seed_community(seed)
    models = _models(np.int32, k=3)
    got = _aggregate(port_r, models, _scales(3), "fedyogi")
    _assert_bits(got, _aggregate(jax_r, models, _scales(3), "fedyogi"))
    plain = port_rule("fedavg").aggregate(
        [([m], s) for m, s in zip(models, _scales(3))])
    _assert_bits(got, plain)


def test_fednova_uneven_steps_over_two_rounds():
    """Uneven τ (0 counts as 1), a dropped learner's missing weight
    renormalized, two committed rounds: bit for bit."""
    jax_r, port_r = _build("fednova")
    seed = _tree(np.random.default_rng(12), np.float32)
    for rule in (jax_r, port_r):
        rule.seed_community(seed)
    for r, steps in enumerate(([1, 4, 16, 0], [2, 2, 9])):
        models = _models(np.float32, k=len(steps), seed=30 + r)
        scales = _scales(4, seed=r)[:len(steps)]
        got = _aggregate(port_r, models, scales, "fednova", steps=steps)
        want = _aggregate(jax_r, models, scales, "fednova", steps=steps)
        _assert_bits(got, want)
    with pytest.raises(ValueError, match="local-step count"):
        port_r.accumulate([([models[0]], 1.0)])


def test_fednova_with_uniform_steps_is_fedavg():
    models = _models(np.float32, k=3, seed=6)
    scales = _scales(3)
    _, port_r = _build("fednova")
    port_r.seed_community(_tree(np.random.default_rng(1), np.float32))
    got = _aggregate(port_r, models, scales, "fednova", steps=[5, 5, 5])
    plain = port_rule("fedavg").aggregate(
        [([m], s) for m, s in zip(models, scales)])
    _assert_close(got, plain, ulps=8)


def test_stateful_rules_refuse_another_tree():
    for name in ("fedadam", "fednova"):
        _, port_r = _build(name)
        port_r.seed_community({"a": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="does not match"):
            _aggregate(port_r, [{"b": np.ones(3, np.float32)}], [1.0], name,
                       steps=[1])


# -- the rolling rules --------------------------------------------------------

@pytest.mark.parametrize("name", ["fedstride", "fedrec"])
def test_rolling_rules_with_resubmission_and_partial_participation(name):
    """Three calls: learners 0-3 in two stride blocks; then learner 1
    re-submits beside newcomer 4 (learners 0, 2, 3 sit out); then learner
    4 alone. FedStride is reset between rounds, FedRec keeps every
    learner's newest model: bit for bit after every call."""
    rng = np.random.default_rng(8)
    models = {lid: _tree(rng, np.float32) for lid in
              ("L0", "L1", "L2", "L3", "L4", "L1b", "L4b")}
    calls = [(("L0", "L1"), (0.3, 0.2)), (("L2", "L3"), (0.4, 0.1)),
             None,  # a round boundary
             (("L1b", "L4"), (0.5, 0.5)), None, (("L4b",), (1.0,))]
    jax_r, port_r = _build(name)
    for call in calls:
        if call is None:
            if name == "fedstride":
                jax_r.reset()
                port_r.reset()
            continue
        keys, scales = call
        ids = [k[:2] for k in keys]
        got = _aggregate(port_r, [models[k] for k in keys], scales, name,
                         ids)
        want = _aggregate(jax_r, [models[k] for k in keys], scales, name,
                          ids)
        _assert_bits(got, want)
        assert port_r.contributors() == jax_r.contributors()
    _assert_bits(port_r.fold_result(), jax_r.fold_result())
    for rule in (jax_r, port_r):
        rule.forget("L4")
    assert port_r.contributors() == jax_r.contributors()
    if port_r.contributors():  # fedrec: L0-L3 still count
        _assert_bits(port_r.fold_result(), jax_r.fold_result())
    else:
        for rule in (jax_r, port_r):
            with pytest.raises(ValueError, match="no contributions"):
                rule.fold_result()
    assert port_r.required_lineage == jax_r.required_lineage


def test_rolling_tensor_trees_fold_where_they_live():
    """FedRec over torch tensor trees against its host numpy fold."""
    models = _models(np.float32, k=4, seed=2)
    ids = [f"L{i}" for i in range(4)]
    _, host = _build("fedrec")
    _, dev = _build("fedrec")
    want = _aggregate(host, models, _scales(4), "fedrec", ids)
    got = _aggregate(dev, [tree_map(as_tensor, m) for m in models],
                     _scales(4), "fedrec", ids)
    assert all(torch.is_tensor(x) for x in _leaves_raw(got))
    _assert_close(tree_map(to_numpy, got), want)


def _leaves_raw(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_raw(tree[k])
    else:
        yield tree


# -- config and controller ----------------------------------------------------

def test_load_config_reads_the_rule_fields_as_the_jax_loader(tmp_path):
    from metisfl_tpu.config import load_config as jax_load_config
    from metisfl_tpu_torch.config import load_config

    path = tmp_path / "federation.yaml"
    path.write_text(
        "aggregation:\n"
        "  rule: trimmed_mean\n"
        "  server_learning_rate: 0.05\n"
        "  server_beta1: 0.8\n"
        "  server_beta2: 0.95\n"
        "  server_tau: 0.01\n"
        "  trim_ratio: 0.2\n"
        "  byzantine_f: 3\n")
    port, ref = load_config(str(path)), jax_load_config(str(path))
    for name in ("rule", "server_learning_rate", "server_beta1",
                 "server_beta2", "server_tau", "trim_ratio", "byzantine_f",
                 "scaler", "stride_length"):
        got, want = (getattr(port.aggregation, name),
                     getattr(ref.aggregation, name))
        assert got == want and type(got) is type(want), name


def test_the_controller_builds_each_rule_with_its_hyperparameters():
    from metisfl_tpu_torch.config import AggregationConfig, FederationConfig
    from metisfl_tpu_torch.controller.core import Controller

    cases = {
        "fedyogi": ({"server_learning_rate": 0.2, "server_tau": 0.01},
                    {"learning_rate": 0.2, "tau": 0.01}),
        "trimmed_mean": ({"trim_ratio": 0.3}, {"trim_ratio": 0.3}),
        "multikrum": ({"byzantine_f": 2}, {"byzantine_f": 2}),
        "fedrec": ({}, {}),
    }
    for rule, (fields, attrs) in cases.items():
        cfg = FederationConfig(aggregation=AggregationConfig(rule=rule,
                                                             **fields))
        ctrl = Controller(cfg, lambda record: None, device="cpu")
        try:
            agg = ctrl._aggregator
            assert agg.name == rule
            for key, value in attrs.items():
                assert getattr(agg, key) == value
            if rule in ROBUST:
                assert agg.device == torch.device("cpu")
            # FedRec's lineage of 2 reaches the store
            assert ctrl._store.lineage_length >= agg.required_lineage
        finally:
            ctrl.shutdown()


def test_a_cuda_controller_without_a_gpu_refuses_the_robust_rules():
    from metisfl_tpu_torch.config import AggregationConfig, FederationConfig
    from metisfl_tpu_torch.controller.core import Controller

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Controller(FederationConfig(aggregation=AggregationConfig(
            rule="median")), lambda record: None)
    # the other rules do no device work: the default device is fine
    Controller(FederationConfig(aggregation=AggregationConfig(
        rule="fedadam")), lambda record: None).shutdown()


def test_a_failed_install_does_not_step_the_server_optimizer_twice():
    """The controller commits the server step only once the community
    model is installed: a round whose blob encode fails is re-run from
    the same state, and the optimizer counts one step per installed
    round."""
    from metisfl_tpu_torch.config import AggregationConfig
    from tests.test_torch_federation import (
        _arrays,
        _jax_template,
        _port_config,
        _port_federation,
    )

    shards, test = _arrays(3)
    template = _jax_template(shards[0][0])
    cfg = _port_config()
    cfg.aggregation = AggregationConfig(rule="fedadam",
                                        scaler="participants",
                                        server_learning_rate=0.1)
    cfg.termination.federation_rounds = 2
    fed = _port_federation(shards, test, template, cfg)
    ctrl = fed.controller
    encode, failed = ctrl._community_to_blob, []

    def flaky(community):
        if not failed:
            failed.append(True)
            raise RuntimeError("encode failed")
        return encode(community)

    ctrl._community_to_blob = flaky
    try:
        fed.start()
        assert fed.wait_for_rounds(2, timeout_s=120)
    finally:
        fed.shutdown()
    assert failed and ctrl.global_iteration == 2
    assert ctrl._aggregator._step == 2
    assert any("encode failed" in e
               for m in ctrl.round_metadata for e in m.errors)
