"""The port's learning-health plane against the JAX package's.

``telemetry/health.py`` bit for bit: the same seeded updates (cohorts
below and above the 16384-coordinate sketch width, a non-finite update)
through both packages' ``HealthMonitor`` give equal snapshots, anomalies,
scores, last-uplink summaries and exported state. Then the controllers:
under the default configuration both packages' controllers, fed the same
joins and uplinks (one learner an outlier in round 1), record equal
``RoundMetadata.health``, an equal registry lineage and the same gate
reasons: round 1's version stays a candidate, refused for the anomaly,
and stable stays round 0's. The port registered every round with ``{}``
before its health plane existed, which promoted the outlier's round.
Counterpart of ``tests/test_learning_health.py`` (its status CLI test
aside).
"""

import json
import threading
import time

import numpy as np
import pytest

from metisfl_tpu.telemetry import events as jevents
from metisfl_tpu.telemetry import health as jhealth
from metisfl_tpu_torch import telemetry
from metisfl_tpu_torch.comm import (
    EvalResult,
    JoinRequest,
    TaskResult,
    TrainParams,
)
from metisfl_tpu_torch.config import (
    AggregationConfig,
    CheckpointConfig,
    EvalConfig,
    FederationConfig,
    HealthConfig,
    RegistryConfig,
    TelemetryConfig,
)
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.telemetry import events as tevents
from metisfl_tpu_torch.telemetry import health as thealth
from metisfl_tpu_torch.telemetry.health import (
    HealthMonitor,
    cosine,
    layer_key,
    participation_entropy,
    robust_z,
)
from metisfl_tpu_torch.tensor import pack_model


@pytest.fixture()
def clean_telemetry():
    telemetry.reset()
    jevents.configure(enabled=True, service="test", dir="", ring_size=512)
    jevents.journal().reset()
    yield
    telemetry.reset()
    jevents.journal().reset()


def _strict(obj):
    """A JSON rendering that tells 0.1 from 0.1000000001 and keeps dict
    order out of it (NaN never appears: the plane keeps values finite)."""
    return json.dumps(obj, sort_keys=True, allow_nan=False)


# --------------------------------------------------------------------- #
# statistics units, bit for bit against the JAX module
# --------------------------------------------------------------------- #


def test_update_statistics_norms_layers_and_cosines():
    monitor = HealthMonitor()
    reference = {"enc/w": np.zeros((2, 2), np.float32),
                 "enc/b": np.zeros((2,), np.float32),
                 "head/w": np.zeros((2,), np.float32)}
    model = {"enc/w": np.full((2, 2), 2.0, np.float32),
             "enc/b": np.zeros((2,), np.float32),
             "head/w": np.full((2,), 3.0, np.float32)}
    summary = monitor.observe_update("L0", model, reference,
                                     train_metrics={"loss": 0.7})
    assert summary["update_norm"] == pytest.approx(np.sqrt(34), rel=1e-5)
    assert summary["layer_norms"]["enc/w"] == pytest.approx(4.0, rel=1e-5)
    assert "enc/b" in summary["layer_norms"]
    assert summary["cos_prev_delta"] == 0.0
    assert summary["train_metrics"] == {"loss": 0.7}
    jax_summary = jhealth.HealthMonitor().observe_update(
        "L0", model, reference, train_metrics={"loss": 0.7})
    assert _strict(summary) == _strict(jax_summary)
    assert layer_key("params/Dense_0/kernel") == "params/Dense_0"
    assert cosine(np.ones(3, np.float32), np.ones(3, np.float32)) == \
        pytest.approx(1.0)
    assert cosine(np.ones(3, np.float32), np.ones(4, np.float32)) == 0.0


@pytest.mark.parametrize("devs", [
    {"a": 1.0, "b": 1.1, "c": 50.0}, {"solo": 9.0},
    {"a": 1.0, "b": 500.0}, {}, {"a": 2.0, "b": 2.0, "c": 2.0},
    {f"L{i}": float(v) for i, v in enumerate(
        np.random.default_rng(4).gamma(2.0, size=17))}])
def test_robust_z_and_entropy_equal_the_jax_modules(devs):
    assert robust_z(devs) == jhealth.robust_z(devs)
    total = sum(devs.values()) or 1.0
    scales = {k: v / total for k, v in devs.items()}
    assert participation_entropy(scales) == \
        jhealth.participation_entropy(scales)


def _cohort_rounds(width, n, rounds, seed, nonfinite=False):
    """Seeded (community, uplinks, train metrics, next community) per
    round: ``n`` learners over a two-tensor model of ``width`` floats,
    learner n-1 an outlier in every round after the first, and with
    ``nonfinite`` learner 0's round-1 update NaN/Inf."""
    rng = np.random.default_rng(seed)
    split = width // 3
    community = {"enc/w": rng.standard_normal(split).astype(np.float32),
                 "head/w": rng.standard_normal(width - split).astype(
                     np.float32)}
    out = []
    for r in range(rounds):
        ups, metrics = {}, {}
        for i in range(n):
            scale = 8.0 if (i == n - 1 and r > 0) else 0.05
            up = {k: (v + scale * rng.standard_normal(v.shape)).astype(
                np.float32) for k, v in community.items()}
            if nonfinite and r == 1 and i == 0:
                up["enc/w"][:3] = [np.nan, np.inf, -np.inf]
            ups[f"L{i}"] = up
            metrics[f"L{i}"] = {"loss": float(rng.uniform(0.1, 2.0)),
                                "accuracy": float("nan") if i == 1
                                else float(rng.uniform())}
        nxt = {k: np.mean([u[k] for u in ups.values()], axis=0).astype(
            np.float32) for k in community}
        out.append((community, ups, metrics, nxt))
        community = nxt
    return out


@pytest.mark.parametrize("width,n,nonfinite", [
    (4000, 5, False),       # below the sketch width: exact vectors
    (40000, 6, False),      # above: the seeded coordinate sketch
    (40000, 4, True),       # above, with a NaN/Inf update
    (9000, 3, True)])
def test_health_monitor_is_bit_for_bit_the_jax_modules(width, n, nonfinite):
    """Snapshots, anomalies, scores, last-uplink summaries and exported
    state, round by round, from the same seeded cohort."""
    monitors = [HealthMonitor(alpha=0.3, anomaly_threshold=3.0),
                jhealth.HealthMonitor(alpha=0.3, anomaly_threshold=3.0)]
    rounds = _cohort_rounds(width, n, 3, seed=width + n, nonfinite=nonfinite)
    flagged = []
    for r, (community, ups, metrics, nxt) in enumerate(rounds):
        results = []
        for monitor in monitors:
            if r == 0:
                monitor.note_community(community)
            summaries = [monitor.observe_update(lid, up, community,
                                                train_metrics=metrics[lid])
                         for lid, up in ups.items()]
            scales = {lid: 1.0 / n for lid in ups}
            health, anomalies = monitor.complete_round(r, nxt, scales)
            results.append(_strict({
                "summaries": summaries, "health": health,
                "anomalies": anomalies, "scores": monitor.scores(),
                "last": monitor.last_stats(),
                "state": monitor.export_state()}))
        assert results[0] == results[1], f"round {r}"
        flagged.append(json.loads(results[0])["health"]["anomalous"])
    assert flagged[0] == []
    # the non-finite update is flagged by its sentinel; otherwise the
    # outlier by its robust z
    assert ("L0" if nonfinite else f"L{n - 1}") in flagged[1]
    # a state restored from the other package continues identically
    ours, theirs = HealthMonitor(), jhealth.HealthMonitor()
    ours.restore_state(monitors[1].export_state())
    theirs.restore_state(monitors[0].export_state())
    assert _strict(ours.export_state()) == _strict(theirs.export_state())
    assert ours.scores() == theirs.scores()


def test_the_sketch_width_and_seed_are_the_jax_modules():
    assert thealth._SKETCH_DIM == jhealth._SKETCH_DIM == 16384
    assert thealth._SKETCH_SEED == jhealth._SKETCH_SEED
    vec = np.random.default_rng(1).standard_normal(50000).astype(
        np.float32)
    ours, theirs = HealthMonitor(), jhealth.HealthMonitor()
    assert ours._sketch(vec).tobytes() == theirs._sketch(vec).tobytes()


def test_monitor_drop_forgets_the_learner():
    monitor = HealthMonitor()
    ref = {"w": np.zeros((4,), np.float32)}
    monitor.observe_update("L0", {"w": np.ones((4,), np.float32)}, ref)
    monitor.drop("L0")
    assert monitor.scores() == {}
    assert monitor.last_stats() == {}


# --------------------------------------------------------------------- #
# both controllers under the same events
# --------------------------------------------------------------------- #


class _EvalProxy:
    """Dispatches go nowhere; an evaluation answers at once, on a thread,
    with the same accuracy for every learner."""

    def __init__(self, record, result_cls):
        self.learner_id = record.learner_id
        self._result_cls = result_cls

    def run_task(self, task):
        pass

    def evaluate(self, task, callback):
        result = self._result_cls(task_id=task.task_id,
                                  learner_id=self.learner_id,
                                  round_id=task.round_id,
                                  evaluations={"test": {"accuracy": 0.5}})
        threading.Thread(target=callback, args=(result,),
                         daemon=True).start()

    def shutdown(self):
        pass


def _controller(kind, registry=True, health=None, tmp_path=None, tag="",
                budget=0):
    """A bare controller of ``kind`` at the default telemetry (health on),
    the registry on with its default gate, an evaluation every round."""
    ckpt = {}
    if kind == "torch":
        if tmp_path is not None:
            ckpt["checkpoint"] = CheckpointConfig(dir=str(tmp_path / tag))
        tel = {"telemetry": TelemetryConfig(
            health=HealthConfig(**(health or {})),
            cardinality_budget=budget)}
        config = FederationConfig(
            protocol="synchronous",
            aggregation=AggregationConfig(rule="fedavg",
                                          scaler="participants"),
            train=TrainParams(batch_size=4, local_steps=1),
            eval=EvalConfig(every_n_rounds=1, datasets=["test"],
                            metrics=["accuracy"]),
            registry=RegistryConfig(enabled=registry), **tel, **ckpt)
        return Controller(config, lambda r: _EvalProxy(r, EvalResult),
                          device="cpu")
    from metisfl_tpu.comm.messages import EvalResult as JEvalResult
    from metisfl_tpu.comm.messages import TrainParams as JTrainParams
    from metisfl_tpu.config import (AggregationConfig as JAgg,
                                    CheckpointConfig as JCkpt,
                                    EvalConfig as JEval,
                                    FederationConfig as JFed,
                                    HealthConfig as JHealth,
                                    RegistryConfig as JRegistry,
                                    TelemetryConfig as JTel)
    from metisfl_tpu.controller.core import Controller as JController
    if tmp_path is not None:
        ckpt["checkpoint"] = JCkpt(dir=str(tmp_path / tag))
    tel = {"telemetry": JTel(health=JHealth(**(health or {})),
                             cardinality_budget=budget)}
    config = JFed(
        protocol="synchronous",
        aggregation=JAgg(rule="fedavg", scaler="participants"),
        train=JTrainParams(batch_size=4, local_steps=1),
        eval=JEval(every_n_rounds=1, datasets=["test"],
                   metrics=["accuracy"]),
        registry=JRegistry(enabled=registry), **tel, **ckpt)
    return JController(config, lambda r: _EvalProxy(r, JEvalResult))


def _msgs(ctrl):
    if type(ctrl).__module__.startswith("metisfl_tpu_torch"):
        return JoinRequest, TaskResult
    from metisfl_tpu.comm.messages import JoinRequest as JJoin
    from metisfl_tpu.comm.messages import TaskResult as JResult
    return JJoin, JResult


def _seed():
    rng = np.random.default_rng(21)
    return {"enc/w": rng.standard_normal((6, 4)).astype(np.float32),
            "head/w": rng.standard_normal((4,)).astype(np.float32)}


def _uplink(round_no, i, outlier):
    """Round 0: the same benign update from everyone (no learner deviates
    from the cohort); later rounds: learners 0 and 1 the same benign
    update, learner ``outlier`` ``8x`` larger."""
    base = _seed()
    rng = np.random.default_rng(100 + round_no)
    step = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in base.items()}
    scale = 8.0 if (round_no > 0 and i == outlier) else 1.0
    return {k: (base[k] + np.float32(scale) * step[k]).astype(np.float32)
            for k in base}


def _wait(predicate, what, timeout_s=30.0):
    deadline = time.time() + timeout_s
    while not predicate():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _drive(ctrl, rounds=2, outlier=2, n=3, port0=7300):
    """The same joins and uplinks through ``ctrl``; waits for each
    version's gate. Returns the learner ids in join order."""
    join_cls, result_cls = _msgs(ctrl)
    ctrl.set_community_model(pack_model(_seed()))
    lids = [ctrl.join(join_cls(hostname="h", port=port0 + i,
                               num_train_examples=10)).learner_id
            for i in range(n)]
    with ctrl._lock:
        tokens = {lid: ctrl._learners[lid].auth_token for lid in lids}
    for r in range(rounds):
        for i, lid in enumerate(lids):
            assert ctrl.task_completed(result_cls(
                task_id=f"t{r}_{lid}", learner_id=lid,
                auth_token=tokens[lid],
                model=pack_model(_uplink(r, i, outlier)), round_id=r,
                completed_batches=1,
                train_metrics={"loss": 2.0 if i == outlier else 0.5}))
        _wait(lambda: ctrl.global_iteration > r, f"round {r + 1}")
        if getattr(ctrl, "_registry", None) is not None:
            _wait(lambda: all(v["gate"] for v in ctrl.describe_registry()[
                "versions"] if v["round"] <= r), f"version {r + 1}'s gate")
    return lids


def _lineage(ctrl):
    desc = ctrl.describe_registry()
    return {"stable": desc["stable"], "candidate": desc["candidate"],
            "versions": [(v["version"], v["round"], v["parent"],
                          v["channel"], v["gate"].get("passed"),
                          v["gate"].get("reasons"), v["health"])
                         for v in desc["versions"]]}


def test_under_defaults_an_outlier_round_is_refused_in_both_packages(
        clean_telemetry):
    """The fault this plane repairs: at the default configuration the JAX
    registry's gate refuses to promote a round whose cohort had an
    outlier; the port's must too (and did not while it registered every
    round with an empty health snapshot)."""
    results = {}
    for kind in ("torch", "jax"):
        ctrl = _controller(kind)
        try:
            lids = _drive(ctrl)
            results[kind] = (lids, _lineage(ctrl),
                             [m.to_dict()["health"]
                              for m in ctrl.round_metadata[:2]])
        finally:
            ctrl.shutdown()
    lids, lineage, health = results["torch"]
    outlier = lids[2]
    assert lineage["stable"] == 1, lineage
    assert lineage["candidate"] == 2
    refused = lineage["versions"][1]
    assert refused[:4] == (2, 1, 1, "candidate") and refused[4] is False
    assert any("anomalous" in reason and outlier in reason
               for reason in refused[5])
    assert [h["anomalous"] for h in health] == [[], [outlier]]
    # and both packages agree on every bit of it
    assert results["torch"][0] == results["jax"][0]
    assert _strict(results["torch"][1]) == _strict(results["jax"][1])
    assert _strict(results["torch"][2]) == _strict(results["jax"][2])


@pytest.mark.parametrize("rule", ["fedavg", "median"])
def test_both_controllers_record_the_same_health(clean_telemetry, rule):
    """Round metadata, divergence scores, the gauges' values and the
    ``UpdateAnomalous``/``RoundHealth`` events: the same under the same
    events (the registry off, a robust rule too)."""
    from metisfl_tpu import telemetry as jtel

    got = {}
    for kind in ("torch", "jax"):
        ctrl = _controller(kind, registry=False)
        if rule != "fedavg":
            from metisfl_tpu.aggregation import make_aggregation_rule
            from metisfl_tpu_torch.aggregation import (
                make_aggregation_rule as port_rule)
            ctrl._aggregator = (port_rule(rule, device="cpu")
                                if kind == "torch"
                                else make_aggregation_rule(rule))
        try:
            lids = _drive(ctrl, rounds=3)
            events = (tevents if kind == "torch" else jevents).tail()
            text = (telemetry if kind == "torch" else jtel).render_metrics()
            parsed = telemetry.parse_exposition(text)
            got[kind] = {
                "health": [m.to_dict()["health"]
                           for m in ctrl.round_metadata[:3]],
                "scores": ctrl._health.scores(),
                "gauge": {dict(k)["learner"]: v for k, v in parsed.get(
                    "learner_divergence_score", {}).items()
                    if dict(k)["learner"] in lids},
                "events": [{k: v for k, v in e.items()
                            if k not in ("ts", "seq")} for e in events
                           if e["kind"] in ("update_anomalous",
                                            "round_health")],
                "snapshot": ctrl.describe()["health"]}
        finally:
            ctrl.shutdown()
    assert _strict(got["torch"]) == _strict(got["jax"])
    assert got["torch"]["health"][1]["anomalous"] == [lids[2]]


def test_health_off_registers_an_empty_snapshot_and_promotes(
        clean_telemetry):
    """``telemetry.health.enabled=false`` in both packages: no statistics
    work, the empty snapshot registered, the outlier round promoted."""
    lineages = []
    for kind in ("torch", "jax"):
        ctrl = _controller(kind, health={"enabled": False})
        try:
            assert ctrl._health is None
            _drive(ctrl)
            lineages.append(_lineage(ctrl))
        finally:
            ctrl.shutdown()
    assert lineages[0]["stable"] == 2
    assert _strict(lineages[0]) == _strict(lineages[1])


def test_advisory_scores_reach_the_selector_and_the_robust_rules(
        clean_telemetry):
    """``telemetry.health.advisory``: the selector and a robust rule
    record the divergence scores, and the community is the same bits as
    without them."""
    from metisfl_tpu_torch.aggregation import make_aggregation_rule

    blobs = []
    for advisory in (True, False):
        ctrl = _controller("torch", registry=False,
                           health={"advisory": advisory})
        ctrl._aggregator = make_aggregation_rule("median", device="cpu")
        try:
            lids = _drive(ctrl, rounds=3)
            blobs.append(ctrl.community_model_bytes())
            if advisory:
                assert ctrl._selector.last_advisory_scores is not None
                last = ctrl._aggregator.last_advisory
                assert last is not None and last[lids[2]] >= 3.0
            else:
                assert ctrl._selector.last_advisory_scores is None
                assert ctrl._aggregator.last_advisory is None
        finally:
            ctrl.shutdown()
    assert blobs[0] == blobs[1]


def test_leave_prunes_the_divergence_and_straggler_series(clean_telemetry):
    ctrl = _controller("torch", registry=False)
    try:
        lids = _drive(ctrl, rounds=2)
        text = telemetry.render_metrics()
        assert f'learner_divergence_score{{learner="{lids[2]}"}}' in text
        with ctrl._lock:
            token = ctrl._learners[lids[2]].auth_token
        assert ctrl.leave(lids[2], token)
        text = telemetry.render_metrics()
        assert f'learner="{lids[2]}"' not in text
        assert lids[2] not in ctrl._health.scores()
    finally:
        ctrl.shutdown()


def test_divergence_scores_survive_a_checkpoint_failover(clean_telemetry,
                                                         tmp_path):
    ctrl = _controller("torch", registry=False, tmp_path=tmp_path,
                       tag="ckpt")
    try:
        lids = _drive(ctrl, rounds=2)
        scores = ctrl._health.scores()
        path = ctrl.save_checkpoint()
    finally:
        ctrl.shutdown()
    restored = _controller("torch", registry=False, tmp_path=tmp_path,
                           tag="ckpt2")
    try:
        assert restored.restore_checkpoint(path)
        assert restored._health.scores() == scores
        parsed = telemetry.parse_exposition(telemetry.render_metrics())
        assert parsed["learner_divergence_score"][
            (("learner", lids[2]),)] == round(scores[lids[2]], 4)
    finally:
        restored.shutdown()


def test_secure_aggregation_turns_the_plane_off():
    from metisfl_tpu_torch.config import SecureAggConfig
    from metisfl_tpu_torch.secure import make_backend

    config = FederationConfig(
        aggregation=AggregationConfig(rule="secure_agg",
                                      scaler="participants"),
        secure=SecureAggConfig(enabled=True, scheme="identity"),
        eval=EvalConfig(every_n_rounds=0))
    ctrl = Controller(config, lambda r: _EvalProxy(r, EvalResult),
                      device="cpu",
                      secure_backend=make_backend(config.secure,
                                                  role="controller"))
    try:
        assert ctrl._health is None
    finally:
        ctrl.shutdown()


def test_inprocess_federation_flags_a_diverging_learner(clean_telemetry):
    """A real in-process federation whose third learner ships its update
    scaled 8x from round 1 on: its divergence score crosses the
    threshold, the round's metadata names it, the journal has the
    anomaly."""
    from metisfl_tpu_torch.config import TerminationConfig
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    config = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=3))
    fed = InProcessFederation(config, device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32, 6)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    template = None
    for i in range(3):
        ops = TorchModelOps(MLP(6, (8,), 2), rng_seed=0, device="cpu")
        template = template or ops.get_variables()
        if i == 2:
            train, calls = ops.train, []

            def diverging(dataset, params, *a, _train=train, _calls=calls,
                          _ops=ops, **k):
                import copy
                import dataclasses

                base = copy.deepcopy(_ops.get_variables())
                out = _train(dataset, params, *a, **k)
                _calls.append(1)
                if len(_calls) == 1:
                    return out

                def scale(t, b):
                    if isinstance(t, dict):
                        return {n: scale(t[n], b[n]) for n in t}
                    return (b + np.float32(8.0) * (np.asarray(t) - b)
                            ).astype(np.float32)

                return dataclasses.replace(
                    out, variables=scale(out.variables, base))

            ops.train = diverging
        # the same batches everywhere: round 0's updates are equal, so no
        # learner deviates from the cohort until the scaling starts
        fed.add_learner(ops, ArrayDataset(x, y, seed=0))
    fed.seed_model(template)
    try:
        fed.start()
        assert fed.wait_for_rounds(3, timeout_s=120)
        metas = fed.controller.get_runtime_metadata()
        outlier = fed.learners[2].learner_id
    finally:
        fed.shutdown()
    assert metas[0]["health"]["anomalous"] == []
    assert outlier in metas[1]["health"]["anomalous"]
    assert [e["learner_id"] for e in tevents.tail()
            if e["kind"] == "update_anomalous"][:1] == [outlier]


def test_both_controllers_collapse_the_same_families_past_a_budget(
        clean_telemetry):
    """Six learners under a cardinality budget of 2: the per-learner
    families with deterministic values (uplink bytes, divergence scores)
    collapse to the same sketches in both packages, and the round's
    ``metrics_digest`` names the same families."""
    from metisfl_tpu import telemetry as jtel

    families = ("uplink_bytes_total", "learner_divergence_score")
    got = {}
    for kind in ("torch", "jax"):
        telemetry.reset()
        jtel.registry().reset()
        ctrl = _controller(kind, registry=False, budget=2)
        try:
            _drive(ctrl, rounds=2, outlier=5, n=6)
            registry = (telemetry.registry() if kind == "torch"
                        else jtel.registry())
            state = registry.budget_state()
            got[kind] = {
                "state": {f: state.get(f) for f in families},
                "digest": sorted(ctrl.round_metadata[1].to_dict()[
                    "metrics_digest"])}
        finally:
            ctrl.shutdown()
    jtel.registry().reset()
    telemetry.reset()
    assert all(got["torch"]["state"][f] for f in families)
    assert _strict(got["torch"]) == _strict(got["jax"])
