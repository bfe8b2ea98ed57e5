"""The controller's streaming and tree tiers of the port against the JAX
package's, and the port's tiers against its own store path.

- ``streaming_supported`` equals the JAX function over the whole matrix
  of its arguments.
- ``StreamingAggregator`` over fedavg, fedstride and fedrec: the same
  uplinks in the same order give the JAX aggregator's bits, forgets and
  a cohort that drops a contributor included.
- The port's controller on the streaming path gives its store path's
  bits under matching order (the cases of tests/test_scale.py: two
  rounds, a malformed uplink, a mid-round leave).
- ``TreeReducer`` equals the flat fold bit for bit on integer-valued
  payloads at branch 2, 8 and 32, and on real-valued ones gives the JAX
  reducer's bits; through the controller it folds the store path's
  cohort.

Both packages fold with numpy here (``_hostfold_lib = False``, as in
tests/test_torch_aggregation.py), so bits compare across packages; the
tolerance is 0 ulp wherever bits are said to match.
"""

import itertools
import time

import numpy as np
import pytest

from metisfl_tpu.aggregation import base as jax_base
from metisfl_tpu.aggregation.fedavg import FedAvg as JaxFedAvg
from metisfl_tpu.aggregation.rolling import FedRec as JaxFedRec
from metisfl_tpu.aggregation.rolling import FedStride as JaxFedStride
from metisfl_tpu.aggregation.streaming import (
    StreamingAggregator as JaxStreamingAggregator,
)
from metisfl_tpu.aggregation.streaming import (
    streaming_supported as jax_streaming_supported,
)
from metisfl_tpu.aggregation.tree import TreeReducer as JaxTreeReducer
from metisfl_tpu_torch.aggregation import FedAvg, FedRec, FedStride
from metisfl_tpu_torch.aggregation import base as port_base
from metisfl_tpu_torch.aggregation.streaming import (
    StreamingAggregator,
    streaming_supported,
)
from metisfl_tpu_torch.aggregation.tree import _DEFAULT_SUBBLOCK, TreeReducer
from metisfl_tpu_torch.comm import JoinRequest, TaskResult, TrainParams
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
)
from metisfl_tpu_torch.config.federation import TreeAggregationConfig
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.pytree import to_numpy

PORT_RULES = {"fedavg": FedAvg, "fedstride": FedStride, "fedrec": FedRec}
JAX_RULES = {"fedavg": JaxFedAvg, "fedstride": JaxFedStride,
             "fedrec": JaxFedRec}


@pytest.fixture
def numpy_fold():
    """Both packages' host folds without their native libraries."""
    saved = jax_base._hostfold_lib, port_base._hostfold_lib
    jax_base._hostfold_lib = port_base._hostfold_lib = False
    try:
        yield
    finally:
        jax_base._hostfold_lib, port_base._hostfold_lib = saved


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], name))
        else:
            out[name] = tree[key]
    return out


def _same_bits(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _model(rng, integer=False):
    if integer:
        return {"enc/w": rng.integers(-8, 8, (6, 4)).astype(np.float32),
                "head": {"b": rng.integers(-8, 8, 4).astype(np.float32)}}
    return {"enc/w": rng.standard_normal((6, 4)).astype(np.float32),
            "head": {"b": rng.standard_normal(4).astype(np.float32)}}


# -- the eligibility matrix ---------------------------------------------------

MATRIX_RULES = ("fedavg", "fedstride", "fedrec", "FedAvg", "fednova",
                "fedadam", "median", "krum", "scaffold", "secure_agg")


@pytest.mark.parametrize("rule", MATRIX_RULES)
def test_streaming_supported_matches_the_jax_package(rule):
    protocols = ("synchronous", "semi_synchronous", "asynchronous",
                 "asynchronous_buffered")
    cases = itertools.product(protocols, (False, True),
                              ((1, 1), (2, 1), (2, 2), (3, 2), (0, 1)),
                              (False, True), (0, 1, 2, 4))
    seen = set()
    for protocol, secure, (lineage, required), ckpt, buf in cases:
        got = streaming_supported(rule, protocol, secure, lineage, required,
                                  checkpointed=ckpt, buffer_size=buf)
        want = jax_streaming_supported(rule, protocol, secure, lineage,
                                       required, checkpointed=ckpt,
                                       buffer_size=buf)
        assert got == want, (protocol, secure, lineage, required, ckpt, buf)
        seen.add(got)
    # the weighted-sum rules stream somewhere and fall back somewhere
    assert seen == ({True, False} if rule.lower() in PORT_RULES
                    else {False})


# -- StreamingAggregator against the JAX package's -----------------------------

def _stream_rounds(make_rule, make_agg, rounds, stride, rng_seed):
    """Two packages' aggregators driven by the same script: per round,
    folds from A-E in a shuffled order, B forgotten mid-round in round 1,
    then a finish over a cohort that leaves out D (a fold from outside the
    released cohort)."""
    agg = make_agg(make_rule(), stride=stride)
    rng = np.random.default_rng(rng_seed)
    out = []
    for r in range(rounds):
        order = list(rng.permutation(["A", "B", "C", "D", "E"]))
        for lid in order:
            agg.fold(lid, _model(rng), float(rng.integers(1, 5)))
            if r == 1 and lid == "B":
                agg.forget("B")
        community = agg.finish(["A", "B", "C", "E"])
        out.append(community)
        out.append(dict(agg.stats()))
    agg.abandon()
    return out


@pytest.mark.parametrize("rule", sorted(PORT_RULES))
@pytest.mark.parametrize("stride", [0, 2])
def test_streaming_aggregator_gives_the_jax_bits(numpy_fold, rule, stride):
    got = _stream_rounds(PORT_RULES[rule], StreamingAggregator, 3, stride, 5)
    want = _stream_rounds(JAX_RULES[rule], JaxStreamingAggregator, 3,
                          stride, 5)
    for g, w in zip(got, want):
        if "rule" in w:
            assert g == w
        else:
            _same_bits(g, w)


def test_streaming_fedavg_keeps_a_departed_fold_and_completes():
    """fedavg's stacked fold cannot subtract a learner that uplinked and
    left; the round keeps it and completes, then starts clean."""
    agg = StreamingAggregator(FedAvg(), stride=0)
    agg.fold("A", {"w": np.full(2, 1.0, np.float32)}, 1.0)
    agg.fold("B", {"w": np.full(2, 3.0, np.float32)}, 1.0)
    agg.fold("B", {"w": np.full(2, 9.0, np.float32)}, 1.0)  # duplicate
    np.testing.assert_array_equal(agg.finish(["A"])["w"], np.full(2, 2.0))
    agg.fold("A", {"w": np.full(2, 5.0, np.float32)}, 1.0)
    np.testing.assert_array_equal(agg.finish(["A"])["w"], np.full(2, 5.0))
    assert agg.finish(["A"]) is None
    assert agg.stats() == {"rule": "fedavg", "folded": 0, "fold_count": 3}


# -- the port's controller: streaming against its own store path --------------

class _NullProxy:
    def __init__(self, record):
        self.learner_id = record.learner_id

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        pass


def _config(rule="fedavg", streaming=False, tree_branch=0,
            scaler="participants", stride=0):
    cfg = FederationConfig(
        aggregation=AggregationConfig(rule=rule, scaler=scaler,
                                      streaming=streaming,
                                      stride_length=stride),
        train=TrainParams(batch_size=4, local_steps=1),
        eval=EvalConfig(every_n_rounds=0))
    if tree_branch:
        cfg.aggregation.tree = TreeAggregationConfig(enabled=True,
                                                     branch=tree_branch)
    return cfg


def _controller(**kwargs):
    return Controller(_config(**kwargs), proxy_factory=_NullProxy,
                      device="cpu")


def _seed():
    return {"enc/w": np.zeros((6, 4), np.float32),
            "head/w": np.zeros((4,), np.float32)}


def _update(i, r, integer=True):
    rng = np.random.default_rng(1000 * r + i)
    if integer:
        return {"enc/w": rng.integers(-8, 8, (6, 4)).astype(np.float32),
                "head/w": rng.integers(-8, 8, 4).astype(np.float32)}
    return {"enc/w": rng.standard_normal((6, 4)).astype(np.float32),
            "head/w": rng.standard_normal(4).astype(np.float32)}


def _join(ctrl, n, sizes=None):
    for i in range(n):
        ctrl.join(JoinRequest(hostname="h", port=7400 + i,
                              num_train_examples=(sizes or [10] * n)[i]))
    lids = sorted(ctrl.active_learners())
    with ctrl._lock:
        tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
    return lids, tokens


def _submit(ctrl, lid, token, model_bytes, r):
    assert ctrl.task_completed(TaskResult(
        task_id=f"t{r}_{lid}", learner_id=lid, auth_token=token,
        model=model_bytes, round_id=r, completed_batches=1))


def _wait_round(ctrl, r, timeout=30.0):
    deadline = time.time() + timeout
    while ctrl.global_iteration <= r:
        assert time.time() < deadline, f"round {r} never completed"
        time.sleep(0.01)


def _community(ctrl):
    return {n: to_numpy(t).copy() for n, t in ModelBlob.from_bytes(
        ctrl.community_model_bytes()).tensors}


def _run_rounds(ctrl, rounds=2, n=4, integer=True, mutate_round=None,
                sizes=None):
    """``rounds`` rounds of direct submissions in learner-id order;
    ``mutate_round(ctrl, r, lids, tokens)`` may make a round's own
    submissions and returns True when it did."""
    ctrl.set_community_model(pack_model(_seed()))
    lids, tokens = _join(ctrl, n, sizes)
    for r in range(rounds):
        if mutate_round is None or not mutate_round(ctrl, r, lids, tokens):
            for i, lid in enumerate(lids):
                _submit(ctrl, lid, tokens[lid],
                        pack_model(_update(i, r, integer)), r)
        _wait_round(ctrl, r)
    return _community(ctrl)


def _store_and_stream(rule, mutate_round=None, sizes=None, **kwargs):
    base = _controller(rule=rule, **kwargs)
    try:
        want = _run_rounds(base, mutate_round=mutate_round, sizes=sizes)
        assert base._streaming is None
    finally:
        base.shutdown()
    stream = _controller(rule=rule, streaming=True, **kwargs)
    try:
        got = _run_rounds(stream, mutate_round=mutate_round, sizes=sizes)
        assert stream._streaming is not None
        stats = stream.get_statistics()
        # the stream engaged: no store read, and one block of its folds
        assert stream._store.learner_ids() == []
        assert all(m["store_select_duration_ms"] == 0.0
                   for m in stats["round_metadata"])
    finally:
        stream.shutdown()
    return want, got, stats


@pytest.mark.parametrize("rule", sorted(PORT_RULES))
@pytest.mark.parametrize("stride", [0, 3])
def test_streaming_path_gives_the_store_paths_bits(numpy_fold, rule, stride):
    want, got, stats = _store_and_stream(rule, stride=stride)
    _same_bits(got, want)
    assert [m["aggregation_block_sizes"] for m in stats["round_metadata"]
            ] == [[4], [4]]


@pytest.mark.parametrize("rule", sorted(PORT_RULES))
def test_malformed_uplink_is_dropped_on_both_paths(numpy_fold, rule):
    """One learner ships codec garbage in round 0: both paths drop only
    that contribution and stay bit-identical through a clean round 1."""
    def mutate(ctrl, r, lids, tokens):
        if r != 0:
            return False
        for i, lid in enumerate(lids):
            payload = (b"\xde\xad\xbe\xef-not-a-blob" if i == 1
                       else pack_model(_update(i, r)))
            _submit(ctrl, lid, tokens[lid], payload, r)
        return True

    want, got, stats = _store_and_stream(rule, mutate_round=mutate)
    _same_bits(got, want)
    assert any("malformed" in e for e in stats["round_metadata"][0]["errors"])


@pytest.mark.parametrize("stride", [0, 2])
def test_mid_round_leave_gives_the_store_paths_bits(numpy_fold, stride):
    """fedstride, round 1: learner 0 uplinks and leaves before the others
    report. The store path erases its lineage; the rolling stream
    subtracts its contribution. Integer-valued payloads and dataset sizes
    (4, 2, 1, 1) whose normalized scales are dyadic in both cohorts keep
    every sum exact, so the raw-weight stream and the normalized store
    path give the same bits."""
    def mutate(ctrl, r, lids, tokens):
        if r != 1:
            return False
        _submit(ctrl, lids[0], tokens[lids[0]], pack_model(_update(0, r)),
                r)
        # the single scheduling worker has handled it before the leave
        ctrl._pool.submit(lambda: None).result(timeout=10)
        assert ctrl.leave(lids[0], tokens[lids[0]])
        for i, lid in enumerate(lids[1:], start=1):
            _submit(ctrl, lid, tokens[lid], pack_model(_update(i, r)), r)
        return True

    want, got, stats = _store_and_stream(
        "fedstride", mutate_round=mutate, sizes=[4, 2, 1, 1],
        scaler="train_dataset_size", stride=stride)
    _same_bits(got, want)
    assert len(stats["round_metadata"][1]["selected_learners"]) == 3


def test_streaming_fedavg_round_survives_a_mid_round_leave(numpy_fold):
    """fedavg: a learner that uplinks and leaves keeps its fold (a stacked
    sum cannot subtract it), and the round completes with no failure."""
    ctrl = _controller(rule="fedavg", streaming=True)
    try:
        ctrl.set_community_model(pack_model(_seed()))
        lids, tokens = _join(ctrl, 4)
        _submit(ctrl, lids[0], tokens[lids[0]], pack_model(_update(0, 0)), 0)
        ctrl._pool.submit(lambda: None).result(timeout=10)
        assert ctrl.leave(lids[0], tokens[lids[0]])
        for i, lid in enumerate(lids[1:], start=1):
            _submit(ctrl, lid, tokens[lid], pack_model(_update(i, 0)), 0)
        _wait_round(ctrl, 0)
        got = _community(ctrl)
        assert ctrl._agg_failures == 0
        meta = ctrl.get_statistics()["round_metadata"][0]
        assert not meta["errors"]
        folded = [_update(i, 0) for i in range(4)]
        mean = {k: np.mean([m[k] for m in folded], axis=0).astype(np.float32)
                for k in folded[0]}
        want = {n: to_numpy(t) for n, t in ModelBlob.from_bytes(
            pack_model(mean)).tensors}
        _same_bits(got, want)
    finally:
        ctrl.shutdown()


def test_streaming_weighted_real_valued_is_the_store_path_to_fp(numpy_fold):
    """Real-valued uplinks under train_dataset_size weights over 5
    learners: the raw-weight stream and the normalized store path agree
    to fp rounding (rtol 1e-5, atol 1e-6, as tests/test_scale.py)."""
    def run(streaming):
        ctrl = _controller(rule="fedavg", streaming=streaming,
                           scaler="train_dataset_size")
        try:
            ctrl.set_community_model(pack_model(_seed()))
            lids, tokens = _join(ctrl, 5, sizes=[10, 20, 30, 40, 50])
            for i, lid in enumerate(lids):
                _submit(ctrl, lid, tokens[lid],
                        pack_model(_update(i, 0, integer=False)), 0)
            _wait_round(ctrl, 0)
            return _community(ctrl)
        finally:
            ctrl.shutdown()

    want, got = run(False), run(True)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6)


def test_unsupported_rule_falls_back_to_the_store_path():
    ctrl = _controller(rule="median", streaming=True)
    try:
        assert ctrl._streaming is None
        assert "streaming" not in ctrl.describe()
    finally:
        ctrl.shutdown()


def test_default_config_builds_no_tier():
    ctrl = _controller()
    try:
        assert ctrl._streaming is None and ctrl._tree is None
        assert ctrl._masked_stream is None
    finally:
        ctrl.shutdown()


def test_tree_config_checks_match_the_jax_package():
    from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
    from metisfl_tpu.config import FederationConfig as JaxFederationConfig
    from metisfl_tpu.config import (
        TreeAggregationConfig as JaxTreeAggregationConfig,
    )

    for branch, workers in ((1, 0), (2, -1)):
        with pytest.raises(ValueError):
            FederationConfig(aggregation=AggregationConfig(
                tree=TreeAggregationConfig(enabled=True, branch=branch,
                                           workers=workers)))
        with pytest.raises(ValueError):
            JaxFederationConfig(aggregation=JaxAggregationConfig(
                tree=JaxTreeAggregationConfig(enabled=True, branch=branch,
                                              workers=workers)))
    cfg = FederationConfig(aggregation=AggregationConfig(
        streaming=True, tree=TreeAggregationConfig(enabled=True, branch=4)))
    assert FederationConfig.from_wire(cfg.to_wire()) == cfg
    with pytest.raises(ValueError):
        TreeReducer(branch=1)


# -- the tree tier ------------------------------------------------------------

def _flat_fold(models, weights, stride=16):
    agg = FedAvg()
    ids = sorted(models)
    for i in range(0, len(ids), stride):
        block = ids[i:i + stride]
        agg.accumulate([([models[lid]], weights[lid]) for lid in block])
    return agg.result()


@pytest.mark.parametrize("branch", [2, 8, 32])
def test_tree_equals_the_flat_fold_on_integer_payloads(numpy_fold, branch):
    rng = np.random.default_rng(branch)
    ids = [f"L{i:03d}" for i in range(64)]
    models = {lid: {"enc/w": rng.integers(-16, 16, (8, 4)
                                          ).astype(np.float32),
                    "head/b": rng.integers(-16, 16, 4).astype(np.float32)}
              for lid in ids}
    weights = {lid: 1.0 for lid in ids}
    want = _flat_fold(models, weights)
    tree = TreeReducer(branch=branch)
    fetched = []
    try:
        def fetch(block):
            fetched.append(len(block))
            return {lid: [models[lid]] for lid in block}

        community, partials = tree.reduce(ids, weights, fetch, stride=16)
    finally:
        tree.shutdown()
    assert sum(p.count for p in partials) == 64
    assert len(partials) == min(branch, 64)
    assert max(fetched) <= 16
    _same_bits(community, want)


@pytest.mark.parametrize("branch", [2, 8, 32])
@pytest.mark.parametrize("stride", [0, 5])
def test_tree_gives_the_jax_reducers_bits(numpy_fold, branch, stride):
    """Real-valued f32 and f64 payloads, uneven weights, a learner with
    nothing stored: the port's reducer and the JAX one, the same bits
    (community and every partial's count and weight)."""
    rng = np.random.default_rng(100 + branch)
    ids = [f"L{i:02d}" for i in range(45)]
    models = {lid: {"a": rng.standard_normal((7, 3)).astype(np.float32),
                    "b": {"c": rng.standard_normal(5)}}
              for lid in ids if lid != "L07"}
    weights = {lid: float(rng.integers(1, 9)) for lid in ids}

    def fetch(block):
        return {lid: [models[lid]] for lid in block if lid in models}

    port, ref = TreeReducer(branch=branch), JaxTreeReducer(branch=branch)
    try:
        got, got_parts = port.reduce(ids, weights, fetch, stride=stride)
        want, want_parts = ref.reduce(ids, weights, fetch, stride=stride)
    finally:
        port.shutdown()
        ref.shutdown()
    _same_bits(got, want)
    assert [(p.count, p.z, p.dtypes) for p in got_parts] == [
        (p.count, p.z, p.dtypes) for p in want_parts]


def test_tree_skips_absent_learners_and_bounds_its_sub_block():
    tree = TreeReducer(branch=4)
    try:
        assert tree.reduce([], {}, lambda b: {}) is None
        assert tree.reduce(["A", "B"], {"A": 1.0, "B": 1.0},
                           lambda b: {}) is None
        only_a = {"A": [{"w": np.full(2, 5.0, np.float32)}]}
        community, partials = tree.reduce(
            ["A", "B"], {"A": 1.0, "B": 1.0},
            lambda b: {lid: only_a[lid] for lid in b if lid in only_a})
        np.testing.assert_array_equal(community["w"], np.full(2, 5.0))
        assert sum(p.count for p in partials) == 1
        sizes = []
        ids = [f"L{i}" for i in range(3 * _DEFAULT_SUBBLOCK)]
        tree.reduce(ids, {lid: 1.0 for lid in ids},
                    lambda b: sizes.append(len(b)) or {
                        lid: [{"w": np.ones(2, np.float32)}] for lid in b},
                    stride=0)
        assert max(sizes) <= _DEFAULT_SUBBLOCK
    finally:
        tree.shutdown()


def test_tree_propagates_a_workers_error_after_every_slice_settles():
    tree = TreeReducer(branch=3)
    calls = []

    def fetch(block):
        calls.append(block[0])
        if block[0] == "L3":
            raise RuntimeError("store select failed")
        time.sleep(0.05)
        return {lid: [{"w": np.ones(2, np.float32)}] for lid in block}

    try:
        with pytest.raises(RuntimeError, match="select failed"):
            tree.reduce([f"L{i}" for i in range(9)],
                        {f"L{i}": 1.0 for i in range(9)}, fetch)
    finally:
        tree.shutdown()
    assert sorted(calls) == ["L0", "L3", "L6"]


@pytest.mark.parametrize("rule", ["fedavg", "fedstride"])
@pytest.mark.parametrize("branch", [2, 3])
def test_controller_tree_tier_folds_the_store_paths_bits(numpy_fold, rule,
                                                          branch):
    """Through the controller on integer-valued payloads: the tree tier's
    community equals the flat store path's bit for bit, and the round
    records one block per slice."""
    base = _controller(rule=rule)
    try:
        want = _run_rounds(base)
    finally:
        base.shutdown()
    ctrl = _controller(rule=rule, tree_branch=branch)
    try:
        got = _run_rounds(ctrl)
        assert ctrl._tree is not None and ctrl._tree.branch == branch
        metas = ctrl.get_statistics()["round_metadata"]
    finally:
        ctrl.shutdown()
    _same_bits(got, want)
    per = -(-4 // branch)
    assert [m["aggregation_block_sizes"] for m in metas] == [
        [min(per, 4 - i) for i in range(0, 4, per)]] * 2
    assert all(m["store_select_duration_ms"] > 0.0 for m in metas)


def test_the_robust_example_runs_on_the_cpu():
    """examples/torch_robust_federation.py: six learners, learner 0
    poisoned; the median and Krum keep the community model above the
    mean's, which follows the poisoned learner. ``--pod`` is refused."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "examples", "torch_robust_federation.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script, "--device", "cpu",
                          "--rounds", "3"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    acc = json.loads(out.stdout.strip().splitlines()[-1])["accuracy"]
    assert sorted(acc) == ["fedavg", "krum", "median"]
    assert acc["median"] > acc["fedavg"] + 0.2
    assert acc["krum"] > acc["fedavg"] + 0.2
    pod = subprocess.run([sys.executable, script, "--device", "cpu",
                          "--pod"], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert pod.returncode != 0 and "item 9" in pod.stderr
