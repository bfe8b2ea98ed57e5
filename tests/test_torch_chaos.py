"""The port's chaos injector against the JAX package's, and its hooks in
the port's transport and learner.

- The same spec and seed give the same decisions over 1000 intercepts
  (drop, delay, corrupt and hang at a zero delay, over several sides,
  methods and probabilities) and over ``slow``'s train hook, and the same
  corrupted bytes; ``flap`` and ``partition`` windows agree under one
  fake clock; a misspelt fault or key is refused when the config is
  built.
- Over the port's ``RpcClient``/``RpcServer`` (the JAX package's
  tests/test_chaos.py cases): client drops are absorbed by the
  UNAVAILABLE retry ladder, a server drop aborts before the handler and
  heals on the retry, a corrupted ModelBlob is rejected as
  INVALID_ARGUMENT, an async call's drop raises on the caller's thread.
- The env var arms a process (a ``kill`` rule exits it with 137), and the
  ``slow`` fault stretches an in-process learner's train.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from metisfl_tpu import chaos as jax_chaos
from metisfl_tpu_torch import chaos
from metisfl_tpu_torch.config import ChaosConfig, FederationConfig
from metisfl_tpu_torch.tensor import pack_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_injectors():
    chaos.reset()
    jax_chaos.reset()
    yield
    chaos.reset()
    jax_chaos.reset()


def _outcome(inj, module, side, method, payload):
    try:
        return inj.intercept(side, "svc", method, payload)
    except module.FaultInjected as exc:
        return ("raised", exc.status, exc.rule.fault)


SPEC = {"seed": 1234, "rules": [
    {"fault": "drop", "side": "client", "prob": 0.3},
    {"fault": "corrupt", "method": "RunTask", "prob": 0.5,
     "after_calls": 3, "max_fires": 40},
    {"fault": "delay", "side": "server", "delay_s": 0.0, "prob": 0.2},
    {"fault": "hang", "method": "Join", "delay_s": 1e-6, "max_fires": 5},
    {"fault": "drop", "side": "server", "method": "MarkTaskCompleted",
     "prob": 0.7, "max_fires": 100},
    {"fault": "slow", "factor": 1.5, "prob": 0.5},
]}


def test_same_spec_and_seed_give_the_jax_package_decisions():
    port = chaos.ChaosInjector.from_spec(SPEC)
    jax = jax_chaos.ChaosInjector.from_spec(SPEC)
    rng = np.random.default_rng(0)
    methods = ("RunTask", "Join", "MarkTaskCompleted", "Evaluate")
    seen = set()
    for i in range(1000):
        side = ("client", "server")[int(rng.integers(0, 2))]
        method = methods[int(rng.integers(0, len(methods)))]
        payload = rng.integers(0, 256, int(rng.integers(0, 40)),
                               dtype=np.uint8).tobytes()
        got = _outcome(port, chaos, side, method, payload)
        want = _outcome(jax, jax_chaos, side, method, payload)
        assert got == want, (i, side, method)
        seen.add(got[0] if isinstance(got, tuple) else
                 ("same" if got == payload else "corrupt"))
        if i % 10 == 0:
            assert port.train_slowdown() == jax.train_slowdown()
    assert seen == {"raised", "same", "corrupt"}
    for fault in ("", "drop", "corrupt", "delay", "hang", "slow"):
        assert port.fired_total(fault) == jax.fired_total(fault)
    assert [(r.matched, r.fired) for r in port.rules] == [
        (r.matched, r.fired) for r in jax.rules]


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 64, 1001])
def test_corrupt_gives_the_jax_package_bytes(size):
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    got = chaos.ChaosInjector._corrupt(payload)
    assert got == jax_chaos.ChaosInjector._corrupt(payload)
    assert len(got) == size and (got != payload or size == 0)


@pytest.mark.parametrize("fault,times", [
    ("flap", (100.0, 103.9, 104.0, 109.9, 110.5, 115.0)),
    ("partition", (50.0, 54.9, 55.0, 57.9, 58.0))])
def test_windowed_faults_match_the_jax_package(monkeypatch, fault, times):
    rule = ({"fault": "flap", "period_s": 10.0, "down_s": 4.0}
            if fault == "flap" else
            {"fault": "partition", "after_s": 5.0, "window_s": 3.0})
    clock = {"t": 0.0}
    for module in ("metisfl_tpu.chaos.injector",
                   "metisfl_tpu_torch.chaos.injector"):
        monkeypatch.setattr(f"{module}.time.monotonic", lambda: clock["t"])
    port = chaos.ChaosInjector.from_spec({"rules": [rule]})
    jax = jax_chaos.ChaosInjector.from_spec({"rules": [rule]})
    got, want = [], []
    for t in times:
        clock["t"] = t
        got.append(_outcome(port, chaos, "client", "M", b"x"))
        want.append(_outcome(jax, jax_chaos, "client", "M", b"x"))
    assert got == want
    downs = sum(isinstance(o, tuple) for o in got)
    assert downs == (3 if fault == "flap" else 2)
    assert port.fired_total(fault) == downs


def test_rule_counting_is_exact():
    inj = chaos.ChaosInjector.from_spec({"rules": [
        {"fault": "drop", "method": "M", "after_calls": 2, "max_fires": 1}]})
    outcomes = [_outcome(inj, chaos, "client", "M", b"x") for _ in range(5)]
    assert [o if o == b"x" else "drop" for o in outcomes] == [
        b"x", b"x", "drop", b"x", b"x"]
    assert inj.fired_total() == 1


def test_slow_is_rpc_inert_and_scales_train():
    inj = chaos.ChaosInjector.from_spec({"rules": [
        {"fault": "slow", "factor": 3.0, "max_fires": 2}]})
    assert inj.intercept("client", "s", "Train", b"x") == b"x"
    assert inj.fired_total("slow") == 0
    assert [inj.train_slowdown() for _ in range(3)] == [3.0, 3.0, 1.0]
    assert chaos.ChaosInjector.from_spec(
        {"rules": [{"fault": "slow"}]}).train_slowdown() == 2.0


@pytest.mark.parametrize("rule", [{"fault": "explode"},
                                  {"fault": "drop", "typo_key": 1}])
def test_unknown_fault_or_key_refused_when_the_config_is_built(rule):
    with pytest.raises(ValueError, match="chaos"):
        FederationConfig(chaos=ChaosConfig(enabled=True, rules=[rule]))
    # a disabled section is not validated, as in the JAX package
    FederationConfig(chaos=ChaosConfig(enabled=False, rules=[rule]))


def test_env_var_arms_the_injector(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, json.dumps(
        {"seed": 3, "rules": [{"fault": "delay", "delay_s": 0.01}]}))
    inj = chaos.install_from_env()
    assert inj is not None and inj.seed == 3 and chaos.get() is inj
    monkeypatch.delenv(chaos.ENV_VAR)
    assert chaos.install_from_env() is None
    assert chaos.ENV_VAR == jax_chaos.ENV_VAR


def test_kill_fault_exits_the_process_with_137(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"rules": [
        {"fault": "kill", "side": "client", "method": "M"}]}))
    env = {**os.environ, chaos.ENV_VAR: f"@{spec}", "PYTHONPATH": REPO}
    code = ("from metisfl_tpu_torch import chaos\n"
            "chaos.get().intercept('client', 's', 'Other', b'x')\n"
            "print('alive', flush=True)\n"
            "chaos.get().intercept('client', 's', 'M', b'x')\n"
            "print('not reached')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 137
    assert proc.stdout.strip() == "alive"


# -- the transport -----------------------------------------------------------

@pytest.fixture()
def echo_server():
    from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
    from metisfl_tpu_torch.tensor import ModelBlob

    state = {"count": 0}

    def echo(payload: bytes) -> bytes:
        state["count"] += 1
        return payload

    def parse_blob(payload: bytes) -> bytes:
        ModelBlob.from_bytes(payload)
        return b"ok"

    server = RpcServer("127.0.0.1", 0)
    server.add_service(BytesService(
        "chaos.Echo", {"Echo": echo, "ParseBlob": parse_blob}))
    port = server.start()
    yield port, state
    server.stop()


def _client(port, **kwargs):
    from metisfl_tpu_torch.comm.rpc import RpcClient

    return RpcClient("127.0.0.1", port, "chaos.Echo", **kwargs)


def test_client_drops_are_absorbed_by_the_retry_ladder(echo_server):
    chaos.configure({"rules": [
        {"fault": "drop", "side": "client", "method": "Echo",
         "max_fires": 2}]})
    port, state = echo_server
    client = _client(port, retry_sleep_s=0.05)
    try:
        assert client.call("Echo", b"payload", timeout=30) == b"payload"
        assert state["count"] == 1
        assert chaos.get().fired_total("drop") == 2
    finally:
        client.close()


def test_server_drop_aborts_before_the_handler_and_heals(echo_server):
    chaos.configure({"rules": [
        {"fault": "drop", "side": "server", "method": "Echo",
         "max_fires": 1}]})
    port, state = echo_server
    client = _client(port, retry_sleep_s=0.05)
    try:
        assert client.call("Echo", b"x", timeout=30) == b"x"
        assert state["count"] == 1
        assert chaos.get().fired_total("drop") == 1
    finally:
        client.close()


def test_delay_fault_delays_the_call(echo_server):
    import time

    chaos.configure({"rules": [
        {"fault": "delay", "side": "server", "delay_s": 0.3}]})
    port, _ = echo_server
    client = _client(port)
    try:
        t0 = time.perf_counter()
        assert client.call("Echo", b"x", timeout=30) == b"x"
        assert time.perf_counter() - t0 >= 0.3
    finally:
        client.close()


def test_corrupted_blob_is_rejected_as_invalid_argument(echo_server):
    import grpc

    chaos.configure({"rules": [
        {"fault": "corrupt", "side": "client", "method": "ParseBlob"}]})
    port, _ = echo_server
    client = _client(port, retries=0)
    blob = pack_model({"w": np.arange(64, dtype=np.float32)})
    try:
        with pytest.raises(grpc.RpcError) as err:
            client.call("ParseBlob", blob, timeout=30)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "checksum" in err.value.details()
        chaos.reset()
        assert client.call("ParseBlob", blob, timeout=30) == b"ok"
    finally:
        client.close()


def test_async_drop_raises_on_the_callers_thread(echo_server):
    chaos.configure({"rules": [
        {"fault": "drop", "side": "client", "method": "Echo",
         "max_fires": 1}]})
    port, state = echo_server
    client = _client(port)
    try:
        with pytest.raises(chaos.FaultInjected):
            client.call_async("Echo", b"x")
        assert client.call_async("Echo", b"y").result(timeout=30) == b"y"
        assert state["count"] == 1
    finally:
        client.close()


def test_slow_fault_stretches_an_in_process_learners_train():
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    chaos.configure({"rules": [{"fault": "slow", "factor": 1.5,
                                "max_fires": 2}]})
    rng = np.random.default_rng(0)
    fed = InProcessFederation(FederationConfig(
        aggregation=AggregationConfig(scaler="participants"),
        train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=1)), device="cpu")
    template = None
    for i in range(2):
        ops = TorchModelOps(MLP(6, (8,), 3), rng_seed=0, variables=template,
                            device="cpu")
        template = template or ops.get_variables()
        x = rng.standard_normal((16, 6)).astype(np.float32)
        fed.add_learner(ops, ArrayDataset(x, np.zeros(16, np.int32),
                                          seed=i))
    fed.seed_model(template)
    try:
        fed.start()
        assert fed.wait_for_rounds(1, timeout_s=120)
        assert chaos.get().fired_total("slow") == 2
    finally:
        fed.shutdown()
