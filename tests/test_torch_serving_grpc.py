"""gRPC serving in the port, held against the JAX package: the serving and
inference messages byte for byte, the ``serving:`` configuration section
and its checks, Predict and Generate over the wire against the in-process
gateway, clients and servers of the two packages crossed, the learner's
inference task, and the replica-kill smoke as a process.

Tolerances: fp32 logits of the port against the JAX package within 1e-5
(the parity tests' ATOL, tests/test_torch_serving.py); what travels the
wire is compared bit for bit; greedy tokens are exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metisfl_tpu import comm as jax_comm
from metisfl_tpu.config import FederationConfig as JaxFederationConfig
from metisfl_tpu.config import RegistryConfig as JaxRegistryConfig
from metisfl_tpu.config import ServingConfig as JaxServingConfig
from metisfl_tpu.config import ServingDecodeConfig as JaxDecodeConfig
from metisfl_tpu.config import ServingFleetConfig as JaxFleetConfig
from metisfl_tpu.config import load_config as jax_load_config
from metisfl_tpu.models import ArrayDataset as JaxArrayDataset
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.zoo import MLP as JaxMLP
from metisfl_tpu.models.zoo.transformer import LlamaLite as JaxLlama
from metisfl_tpu.tensor.pytree import pack_model as jax_pack
from metisfl_tpu_torch import comm
from metisfl_tpu_torch.config import (
    FederationConfig,
    RegistryConfig,
    ServingConfig,
    ServingDecodeConfig,
    ServingFleetConfig,
    load_config,
)
from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP, LlamaLite
from metisfl_tpu_torch.serving import (
    ServingClient,
    ServingGateway,
    ServingServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=97, dim=64, depth=2, heads=4, kv_heads=2)
ATOL = 1e-5


# ---------------------------------------------------------------------- #
# the six messages
# ---------------------------------------------------------------------- #

_MESSAGES = {
    "InferTask": dict(task_id="t1", learner_id="L0", round_id=3,
                      model=b"\x00blob", batch_size=7, dataset="valid",
                      inputs=b"xs", max_examples=5, generate_tokens=4,
                      local_tensor_regex="bn", ship_tensor_regex="lora_",
                      temperature=0.0, top_k=2, top_p=0.5, eos_id=9),
    "InferResult": dict(task_id="t1", learner_id="L0", round_id=3,
                        predictions=b"\x01\x02", num_examples=5,
                        duration_ms=1.25),
    "ServeRequest": dict(request_id="r1", key="user-7", inputs=b"\x03"),
    "ServeReply": dict(request_id="r1", predictions=b"\x04",
                       model_version=2, channel="candidate",
                       duration_ms=0.5),
    "GenerateRequest": dict(request_id="g1", key="k", prompt=b"\x05",
                            max_new_tokens=11, eos_id=3),
    "GenerateReply": dict(request_id="g1", tokens=b"\x06", model_version=1,
                          channel="stable", duration_ms=2.0),
}


@pytest.mark.parametrize("name", sorted(_MESSAGES))
def test_messages_match_the_jax_wire_bytes_and_parse_crosswise(name):
    port_cls, jax_cls = getattr(comm, name), getattr(jax_comm.messages, name)
    assert ([f.name for f in port_cls.__dataclass_fields__.values()]
            == [f.name for f in jax_cls.__dataclass_fields__.values()])
    assert port_cls().to_wire() == jax_cls().to_wire()
    values = _MESSAGES[name]
    port_msg, jax_msg = port_cls(**values), jax_cls(**values)
    assert port_msg.to_wire() == jax_msg.to_wire()
    assert vars(jax_cls.from_wire(port_msg.to_wire())) == values
    assert vars(port_cls.from_wire(jax_msg.to_wire())) == values


# ---------------------------------------------------------------------- #
# the serving: section (dropped by the port before this slice)
# ---------------------------------------------------------------------- #

_SERVING_YAML = """
registry:
  enabled: true
serving:
  enabled: true
  host: 127.0.0.1
  port: 7001
  max_batch: 4
  max_wait_ms: 2.5
  canary_percent: 12.5
  poll_every_s: 0.5
  recipe_index: 1
  decode: {slots: 3, max_len: 64}
  fleet:
    enabled: true
    replicas: 2
    min_replicas: 1
    max_replicas: 3
    router_port: 7002
    vnodes: 32
    retry_hops: 1
    probe_every_s: 0.5
    scale_up: {metric: serving_requests_total, kind: rate, window_s: 3,
               op: ">", threshold: 5, for_s: 1}
    scale_down: {metric: serving_requests_total, kind: rate, window_s: 3,
                 op: "<", threshold: 0.5, for_s: 2}
    scale_cooldown_s: 4.0
    gateways:
      - {name: serving_0, host: localhost, port: 7003}
      - {name: serving_1, host: localhost, port: 7004}
"""


def _serving_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg.serving)


def test_serving_section_survives_yaml_and_wire_in_both_packages(tmp_path):
    path = tmp_path / "fed.yaml"
    path.write_text(_SERVING_YAML)
    port, jax_cfg = load_config(str(path)), jax_load_config(str(path))
    want = _serving_dict(jax_cfg)
    assert want["fleet"]["gateways"][1]["port"] == 7004
    assert want["fleet"]["scale_up"]["threshold"] == 5
    assert _serving_dict(port) == want
    assert port.registry.enabled
    # through the wire, each package's bytes read by the other
    for raw in (port.to_wire(), jax_cfg.to_wire()):
        assert _serving_dict(FederationConfig.from_wire(raw)) == want
        assert _serving_dict(JaxFederationConfig.from_wire(raw)) == want
    # the same defaults as the JAX package's sections
    assert (_serving_dict(FederationConfig())
            == _serving_dict(JaxFederationConfig()))


# (fields of FederationConfig, the start of the message both raise)
_BAD_SERVING = [
    (dict(serving=dict(enabled=True)),
     "serving.enabled requires registry.enabled"),
    (dict(registry=True, serving=dict(enabled=True, max_batch=0)),
     "serving.max_batch must be >= 1"),
    (dict(registry=True, serving=dict(enabled=True, max_wait_ms=-1.0)),
     "serving.max_wait_ms must be >= 0"),
    (dict(registry=True, serving=dict(enabled=True, canary_percent=101.0)),
     "serving.canary_percent must be in [0, 100]"),
    (dict(registry=True, serving=dict(enabled=True, recipe_index=-1)),
     "serving.recipe_index must be >= 0"),
    (dict(registry=True, serving=dict(enabled=True, decode=dict(slots=0))),
     "serving.decode.slots must be >= 1"),
    (dict(registry=True, serving=dict(enabled=True,
                                      decode=dict(max_len=1))),
     "serving.decode.max_len must be >= 2"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, min_replicas=0))),
     "serving.fleet.min_replicas must be >= 1"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, min_replicas=3, max_replicas=2, replicas=3))),
     "serving.fleet.max_replicas must be >= min_replicas"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, replicas=9))),
     "serving.fleet.replicas must lie within"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, vnodes=0))),
     "serving.fleet.vnodes must be >= 1"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, retry_hops=-1))),
     "serving.fleet.retry_hops must be >= 0"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, probe_every_s=0.0))),
     "serving.fleet.probe_every_s must be > 0"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, scale_cooldown_s=-1.0))),
     "serving.fleet.scale_cooldown_s must be >= 0"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, scale_up={"metric": "serving_requests_total",
                                "kind": "nope", "threshold": 1}))),
     "invalid serving.fleet scale rule"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=True, scale_up={"metric": "serving_requests_total",
                                "kind": "quantile", "threshold": 1}))),
     "invalid serving.fleet scale rule"),
    (dict(registry=True, serving=dict(enabled=False, fleet=dict(
        enabled=True))),
     "serving.fleet.enabled requires serving.enabled"),
    (dict(registry=True, serving=dict(enabled=True, fleet=dict(
        enabled=False, scale_down={"metric": "serving_requests_total",
                                   "threshold": 1}))),
     "serving.fleet.scale_up/scale_down require"),
]


def _build(pkg, spec):
    fed, reg, srv, fleet_cls, dec = pkg
    serving = dict(spec.get("serving", {}))
    if "fleet" in serving:
        serving["fleet"] = fleet_cls(**serving["fleet"])
    if "decode" in serving:
        serving["decode"] = dec(**serving["decode"])
    return fed(registry=reg(enabled=bool(spec.get("registry"))),
               serving=srv(**serving))


@pytest.mark.parametrize("spec,message", _BAD_SERVING,
                         ids=[m.split(" ")[0] + f"-{i}"
                              for i, (_, m) in enumerate(_BAD_SERVING)])
def test_each_serving_check_raises_the_jax_error(spec, message):
    errors = []
    for pkg in ((FederationConfig, RegistryConfig, ServingConfig,
                 ServingFleetConfig, ServingDecodeConfig),
                (JaxFederationConfig, JaxRegistryConfig, JaxServingConfig,
                 JaxFleetConfig, JaxDecodeConfig)):
        with pytest.raises(ValueError) as exc:
            _build(pkg, spec)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith(message), errors[0]


# ---------------------------------------------------------------------- #
# Predict and Generate over gRPC
# ---------------------------------------------------------------------- #

def _jax_lm_variables(seed=0):
    return jax.device_get(JaxLlama(**LM).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))


@pytest.fixture(scope="module")
def lm_blob():
    return jax_pack(_jax_lm_variables())


def _tokens(n, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (n, L)).astype(np.int32)


def test_grpc_predict_and_generate_equal_the_in_process_gateway(lm_blob):
    """A gRPC Predict is bit for bit the in-process ``gateway.predict`` of
    the same gateway; a gRPC Generate is its in-process ``generate``."""
    ops = TorchModelOps(LlamaLite(use_flash=True, **LM), device="cpu")
    gateway = ServingGateway(ops, ServingConfig(
        max_batch=2, max_wait_ms=1.0,
        decode=ServingDecodeConfig(slots=2, max_len=32)), device="cpu")
    gateway.install("stable", 1, lm_blob)
    server = ServingServer(gateway, host="127.0.0.1", port=0)
    port = server.start()
    client = ServingClient("127.0.0.1", port)
    rows = _tokens(2, 16)
    try:
        want, v, ch = gateway.predict(rows, key="user-3")
        reply = client.predict(rows, key="user-3", timeout=60.0)
        got = client.predictions(reply)
        assert (reply.model_version, reply.channel) == (v, ch) == (1,
                                                                  "stable")
        assert got.dtype == want.dtype and got.shape == (2, 16, 97)
        np.testing.assert_array_equal(got, want)
        prompt = _tokens(1, 6, seed=1)[0]
        local, _, _ = gateway.generate(prompt, 5, key="g")
        remote = client.tokens(client.generate(prompt, 5, key="g"))
        np.testing.assert_array_equal(remote, local)
        assert client.list_methods()["role"] == "serving"
        assert client.health()["installed"] == {"stable": 1}
        assert client.status()["installed"] == {"stable": 1}
        assert "serving_requests_total" in client.get_metrics()
    finally:
        client.close()
        server.stop()


def _mlp_rows(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (3, 4)).astype(np.float32)


def _port_mlp_server(blob):
    ops = TorchModelOps(MLP(4, (8,), 3), rng_seed=0, device="cpu")
    gateway = ServingGateway(ops, ServingConfig(max_batch=4,
                                                max_wait_ms=1.0),
                             device="cpu")
    gateway.install("stable", 5, blob)
    return ServingServer(gateway, host="127.0.0.1", port=0), gateway


def _jax_mlp_server(blob):
    from metisfl_tpu.serving import ServingGateway as JaxGateway
    from metisfl_tpu.serving import ServingServer as JaxServer
    ops = FlaxModelOps(JaxMLP(features=(8,), num_outputs=3),
                       np.zeros((2, 4), np.float32), rng_seed=0)
    gateway = JaxGateway(ops, JaxServingConfig(max_batch=4,
                                               max_wait_ms=1.0))
    gateway.install("stable", 5, blob)
    return JaxServer(gateway, host="127.0.0.1", port=0), gateway


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_clients_and_servers_of_the_two_packages_cross(server_side):
    """The JAX package's client against the port's server and the port's
    client against the JAX package's server: the same predictions (fp32,
    within 1e-5), version and channel either way."""
    from metisfl_tpu.serving import ServingClient as JaxClient
    jax_ops = FlaxModelOps(JaxMLP(features=(8,), num_outputs=3),
                           np.zeros((2, 4), np.float32), rng_seed=0)
    blob = jax_pack(jax_ops.get_variables())
    rows = _mlp_rows()
    want = np.asarray(jax_ops.infer(rows, 4))
    make = _port_mlp_server if server_side == "port" else _jax_mlp_server
    server, _ = make(blob)
    port = server.start()
    client = (JaxClient if server_side == "port" else ServingClient)(
        "127.0.0.1", port)
    try:
        reply = client.predict(rows, key="k", timeout=60.0)
        got = np.asarray(client.predictions(reply))
        assert (reply.model_version, reply.channel) == (5, "stable")
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert client.list_methods()["role"] == "serving"
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------- #
# the learner's inference task
# ---------------------------------------------------------------------- #

class _NoController:
    """Inference needs no controller."""


def _learners(test_rows):
    from metisfl_tpu.learner.learner import Learner as JaxLearner
    from metisfl_tpu_torch.learner.learner import Learner

    x, y = test_rows[:, :-1], test_rows[:, 1:]
    jax_ops = FlaxModelOps(JaxLlama(**LM), x[:1], rng_seed=3)
    port_ops = TorchModelOps(LlamaLite(use_flash=True, **LM), rng_seed=3,
                             device="cpu")
    return (Learner(port_ops, ArrayDataset(x, y), _NoController(),
                    test_dataset=ArrayDataset(x, y)),
            JaxLearner(jax_ops, JaxArrayDataset(x, y), _NoController(),
                       test_dataset=JaxArrayDataset(x, y)))


@pytest.mark.parametrize("mode", ["inputs_logits", "split_logits",
                                  "generate"])
def test_learner_infer_matches_the_jax_learner(lm_blob, mode):
    """``Learner.infer`` on one community blob: fp32 logits within 1e-5 of
    the JAX learner's, greedy tokens bit-exact (generation in batch_size
    chunks), and the port's LearnerServer answers RunInference with it."""
    from metisfl_tpu.comm.messages import InferTask as JaxInferTask
    from metisfl_tpu.tensor.pytree import ModelBlob as JaxModelBlob
    from metisfl_tpu_torch.learner.service import LearnerServer
    from metisfl_tpu_torch.tensor.pytree import ModelBlob, to_numpy

    test_rows = _tokens(5, 13, seed=4)
    port, jax_learner = _learners(test_rows)
    fields = dict(task_id="t", model=lm_blob, batch_size=2)
    if mode == "inputs_logits":
        fields["inputs"] = JaxModelBlob(
            tensors=[("x", test_rows[:3, :8])]).to_bytes()
    elif mode == "split_logits":
        fields.update(dataset="test", max_examples=4)
    else:
        fields.update(inputs=JaxModelBlob(
            tensors=[("x", test_rows[:, :5])]).to_bytes(),
            generate_tokens=4)
    task = JaxInferTask(**fields)
    want = np.asarray(dict(JaxModelBlob.from_bytes(
        jax_learner.infer(task).predictions).tensors)["predictions"])
    server = LearnerServer(port, host="127.0.0.1", port=0)
    raw = server._infer(task.to_wire())
    result = comm.InferResult.from_wire(raw)
    got = to_numpy(dict(ModelBlob.from_bytes(
        result.predictions).tensors)["predictions"])
    assert result.task_id == "t" and result.num_examples == len(want)
    assert got.shape == want.shape
    if mode == "generate":
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_sampled_generation_is_refused_on_the_learner(lm_blob):
    from metisfl_tpu_torch.tensor.pytree import ModelBlob

    port, _ = _learners(_tokens(2, 9))
    with pytest.raises(NotImplementedError, match="temperature > 0"):
        port.infer(comm.InferTask(
            model=lm_blob, generate_tokens=2, temperature=0.7,
            inputs=ModelBlob(tensors=[("x", _tokens(1, 4))]).to_bytes()))


# ---------------------------------------------------------------------- #
# the replica-kill smoke as a process
# ---------------------------------------------------------------------- #

def test_fleet_smoke_process_exits_zero(tmp_path):
    """``python -m metisfl_tpu_torch.serving --fleet-smoke`` on the CPU:
    three replica processes, one SIGKILLed mid-canary, no request
    dropped, the promotion rolled and the relaunch re-pinned."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "metisfl_tpu_torch.serving", "--fleet-smoke",
         "--device", "cpu", "--smoke-replicas", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert '"requests_dropped": 0' in out.stdout
    assert '"failures": []' in out.stdout


@pytest.mark.parametrize("role", [["--router"],
                                  ["--recipe", "missing_recipe.pkl"]],
                         ids=["router", "gateway"])
def test_serving_processes_refuse_cuda_without_a_gpu(tmp_path, role):
    """No quiet move to the CPU: a router or gateway asked for ``cuda``
    (the default) on a host without a GPU exits non-zero before it
    serves."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    cfg = tmp_path / "fed.bin"
    cfg.write_bytes(FederationConfig().to_wire())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "metisfl_tpu_torch.serving", "--config",
         str(cfg), *role],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "torch sees no CUDA device" in out.stderr
    assert "READY" not in out.stdout
