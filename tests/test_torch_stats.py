"""The port's experiment summary CLI (``metisfl_tpu_torch/stats.py``)
against the JAX package's: the same ``experiment.json`` renders the same
round table, metric summaries, learning-health table and epoch series in
both packages (the text apart from the one line that names the JAX
package's ``perf`` CLI, which the port does not have yet), either
package's CLI reads it, and a port federation's own statistics (health,
profiles, train and epoch metrics) render in both. Counterpart of
``tests/test_stats.py``.
"""

import copy
import json
import subprocess
import sys

import pytest

from metisfl_tpu import stats as jstats
from metisfl_tpu_torch import stats


def _stats():
    return {
        "global_iteration": 2,
        "learners": ["a", "b"],
        "round_metadata": [
            {"global_iteration": 1, "started_at": 10.0, "completed_at": 11.5,
             "selected_learners": ["a", "b"],
             "aggregation_duration_ms": 40.0,
             "model_size": {"values": 1000}, "errors": []},
            {"global_iteration": 2, "started_at": 11.5, "completed_at": 12.0,
             "selected_learners": ["a"],
             "aggregation_duration_ms": 60.0,
             "model_size": {"values": 1000},
             "errors": ["masking needs all parties"]},
        ],
        "community_evaluations": [
            {"evaluations": {
                "a": {"test": {"accuracy": 0.5, "loss": 1.2}},
                "b": {"test": {"accuracy": 0.7, "loss": 1.0}}}},
            {"evaluations": {
                "a": {"test": {"accuracy": 0.8, "loss": 0.6}}}},
        ],
    }


def _with_health(payload):
    payload = copy.deepcopy(payload)
    payload["round_metadata"][0].update({
        "dispatch_duration_ms": 12.5, "wait_duration_ms": 900.0,
        "uplink_bytes": {"a": 4096, "b": 4096},
        "train_metrics": {"a": {"loss": 0.9}, "b": {"loss": 0.8}},
        "epoch_metrics": {"a": [{"loss": 1.1}, {"loss": 0.9}]},
        "health": {"round": 1, "round_update_norm": 2.5,
                   "effective_step": 0.1, "participation_entropy": 1.0,
                   "update_norms": {"a": 1.0, "b": 20.0},
                   "divergence_score": {"a": 0.0, "b": 6.2},
                   "anomalous": ["b"]},
        "profile": {"round": 1, "wall_ms": 1500.0, "coverage": 1.0,
                    "phases": {"dispatch": 12.5, "wait_uplinks": 900.0,
                               "select": 1.0, "aggregate": 40.0,
                               "close": 546.5},
                    "learners": {}, "totals": {}}})
    payload["round_metadata"][1].update({
        "train_metrics": {"a": {"loss": 0.4}},
        "epoch_metrics": {"a": [{"loss": 0.5}, {"loss": 0.4}]}})
    return payload


def _same_text(ours, theirs):
    """Equal line for line, but the line naming the JAX ``perf`` CLI."""
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if "per-round cost profile" in y:
            assert x.startswith("per-round cost profile")
        else:
            assert x == y


@pytest.mark.parametrize("payload", [_stats(), _with_health(_stats())],
                         ids=["classic", "telemetry"])
def test_summaries_equal_the_jax_packages(payload):
    _same_text(stats.summarize(payload), jstats.summarize(payload))
    for name in ("learning_health_summary", "epoch_loss_series",
                 "metric_series", "profile_summary"):
        assert getattr(stats, name)(payload) == getattr(jstats, name)(
            payload), name


def test_summarize_rounds_and_metrics():
    text = stats.summarize(_stats())
    assert "2 rounds, 2 learners" in text
    assert "1.50s" in text
    assert "test/accuracy: first=0.6000 best=0.8000 last=0.8000" in text
    assert "masking needs all parties" in text
    assert "aggregation median 50.0ms" in text


def test_learning_health_reader():
    rows = stats.learning_health_summary(_with_health(_stats()))
    assert rows[0]["learner"] == "b"
    assert rows[0]["last_div"] == pytest.approx(6.2)
    assert rows[0]["anomalous_rounds"] == 1
    by_id = {r["learner"]: r for r in rows}
    assert by_id["a"]["first_loss"] == pytest.approx(1.1)
    assert by_id["a"]["last_loss"] == pytest.approx(0.4)
    text = stats.summarize(_with_health(_stats()))
    assert "per-learner learning health" in text
    assert "anomalous in 1 round(s)" in text


@pytest.mark.parametrize("package", ["metisfl_tpu_torch", "metisfl_tpu"])
def test_either_cli_reads_experiment_json(tmp_path, package):
    path = tmp_path / "experiment.json"
    path.write_text(json.dumps(_with_health(_stats())))
    out = subprocess.run([sys.executable, "-m", f"{package}.stats",
                          str(path)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "test/accuracy" in out.stdout
    assert "per-learner learning health" in out.stdout


def test_cli_usage_error():
    out = subprocess.run([sys.executable, "-m", "metisfl_tpu_torch.stats"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2


def test_a_port_federation_renders_in_both_packages(tmp_path):
    """A port federation's statistics, with their health snapshots, cost
    profiles and train metrics, through both packages' summaries."""
    import numpy as np

    from metisfl_tpu_torch import telemetry
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (AggregationConfig, EvalConfig,
                                          FederationConfig,
                                          TerminationConfig)
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    telemetry.reset()
    config = FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(batch_size=32, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=2))
    fed = InProcessFederation(config, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 6)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    test = ArrayDataset(x[:16], y[:16])
    for i in range(3):
        fed.add_learner(TorchModelOps(MLP(6, (8,), 2), rng_seed=0,
                                      device="cpu"),
                        ArrayDataset(x, y, seed=i), test_dataset=test)
    fed.seed_model(TorchModelOps(MLP(6, (8,), 2), rng_seed=0,
                                 device="cpu").get_variables())
    try:
        fed.start()
        assert fed.wait_for_rounds(2, timeout_s=120)
        payload = json.loads(json.dumps(fed.statistics(), default=str))
    finally:
        fed.shutdown()
    metas = payload["round_metadata"]
    assert metas[0]["health"]["round"] == 0
    assert metas[0]["profile"]["phases"]
    assert metas[0]["wait_duration_ms"] > 0
    _same_text(stats.summarize(payload), jstats.summarize(payload))
    assert stats.learning_health_summary(payload)
    assert stats.profile_summary(payload) == jstats.profile_summary(payload)
