"""Serving parity: the port's in-process gateway fed a JAX-packed blob
answers Predict like the JAX gateway, keeps batched == unbatched bit for
bit, routes canaries like the reference, reports the true version across
a hot-swap, and decodes Generate requests to the same greedy tokens."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metisfl_tpu.config import ServingConfig as JaxServingConfig
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.generate import generate as jax_generate
from metisfl_tpu.models.zoo.transformer import LlamaLite as JaxLlama
from metisfl_tpu.serving import ServingGateway as JaxGateway
from metisfl_tpu.serving import canary_channel as jax_canary
from metisfl_tpu.tensor.pytree import ModelBlob as JaxModelBlob
from metisfl_tpu.tensor.pytree import pack_model as jax_pack
from metisfl_tpu.tensor.pytree import pytree_to_named_tensors as jax_named
from metisfl_tpu_torch.config import ServingConfig, ServingDecodeConfig
from metisfl_tpu_torch.models import TorchModelOps, generate
from metisfl_tpu_torch.models.zoo import LlamaLite
from metisfl_tpu_torch.serving import (
    CHANNEL_CANDIDATE,
    ContinuousBatcher,
    ServingGateway,
    canary_channel,
)
from metisfl_tpu_torch.tensor.pytree import ModelBlob

CFG = dict(vocab_size=97, dim=32, depth=2, heads=4, kv_heads=2)
ATOL = 1e-5  # fp32 logits on both sides (see test_torch_llama.py)


def _jax_variables(seed):
    module = JaxLlama(**CFG)
    return jax.device_get(module.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 8), jnp.int32)))


@pytest.fixture(scope="module")
def blobs():
    return {v: jax_pack(_jax_variables(seed))
            for v, seed in ((1, 0), (2, 1))}


def _rows(n=6, L=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n, L)).astype(np.int32)


def _port_gateway(cfg=None, use_flash=True):
    ops = TorchModelOps(LlamaLite(use_flash=use_flash, **CFG), device="cpu")
    return ServingGateway(ops, cfg or ServingConfig(max_batch=4,
                                                    max_wait_ms=20.0),
                          device="cpu")


def test_predict_matches_jax_gateway(blobs):
    rows = _rows()
    jgw = JaxGateway(FlaxModelOps(JaxLlama(**CFG), rows[:1]),
                     JaxServingConfig(max_batch=4, max_wait_ms=1.0))
    gw = _port_gateway()
    try:
        for g in (jgw, gw):
            g.install("stable", 1, blobs[1])
        want, jv, jch = jgw.predict(rows, key="user-1")
        got, v, ch = gw.predict(rows, key="user-1")
    finally:
        jgw.shutdown()
        gw.shutdown()
    assert (v, ch) == (jv, jch) == (1, "stable")
    assert got.shape == want.shape == (6, 12, CFG["vocab_size"])
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_batched_results_bit_identical_to_unbatched(blobs):
    rows = _rows(n=7)
    gw = _port_gateway()
    try:
        gw.install("stable", 1, blobs[1])
        alone = [gw.predict(rows[i:i + 1])[0] for i in range(len(rows))]
        results = [None] * len(rows)

        def call(i):
            results[i] = gw.predict(rows[i:i + 1])[0]

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        gw.shutdown()
    for a, b in zip(alone, results):
        np.testing.assert_array_equal(a, b)


def test_canary_routing_equals_reference():
    keys = [f"user-{i}" for i in range(500)] + ["", "é-ключ"]
    for pct in (0.0, 0.01, 12.5, 50.0, 100.0):
        assert [canary_channel(k, pct) for k in keys] == [
            jax_canary(k, pct) for k in keys]


def test_hot_swap_reports_true_version_and_canary_falls_back(blobs):
    rows = _rows(n=2)
    gw = _port_gateway(ServingConfig(max_batch=2, max_wait_ms=1.0,
                                     canary_percent=100.0))
    try:
        gw.install("stable", 1, blobs[1])
        # no candidate installed: a canary-keyed request serves stable
        out1, v1, ch1 = gw.predict(rows, key="canary-user")
        assert (v1, ch1) == (1, "stable")
        gw.install(CHANNEL_CANDIDATE, 2, blobs[2])
        out2, v2, ch2 = gw.predict(rows, key="canary-user")
        assert (v2, ch2) == (2, CHANNEL_CANDIDATE)
        assert not np.array_equal(out1, out2)
        assert gw.installed() == {"stable": 1, CHANNEL_CANDIDATE: 2}
        gw.uninstall(CHANNEL_CANDIDATE)
        assert gw.predict(rows, key="canary-user")[1:] == (1, "stable")
    finally:
        gw.shutdown()


def test_sync_installs_registry_heads(blobs):
    class Source:
        def describe(self):
            return {"enabled": True, "stable": 2, "candidate": 0}

        def blob(self, version):
            return blobs[version]

    gw = _port_gateway()
    try:
        assert gw.sync(Source()) == {"stable": 2}
    finally:
        gw.shutdown()


def test_ship_regex_blob_backfills_frozen_base():
    """Under ship_tensor_regex a blob carries only the federated subset
    (LoRA adapters); the gateway fills the frozen base from the engine."""
    variables = jax.device_get(JaxLlama(lora_rank=2, **CFG).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32)))
    named = jax_named(variables)
    rng = np.random.default_rng(4)
    adapters = [(n, rng.standard_normal(a.shape).astype(np.float32) * 0.1)
                for n, a in named if "lora_" in n]
    base = [(n, a) for n, a in named if "lora_" not in n]
    ops = TorchModelOps(LlamaLite(lora_rank=2, **CFG), variables=variables,
                        device="cpu")
    gw = ServingGateway(ops, ServingConfig(max_batch=2, max_wait_ms=1.0),
                        ship_tensor_regex="lora_", device="cpu")
    rows = _rows(n=2)
    try:
        gw.install("stable", 1, JaxModelBlob(tensors=adapters).to_bytes())
        got = gw.predict(rows)[0]
    finally:
        gw.shutdown()
    want = ops.infer(rows, batch_size=2, model=ops.bind(adapters + base))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, ops.infer(rows, batch_size=2))


def test_generate_equals_solo_and_jax_tokens(blobs):
    """Four concurrent Generate requests through the continuous batcher
    (2 slots, so admission happens mid-flight) equal a solo port generate
    per request bit for bit, and the JAX package's greedy tokens."""
    max_len = 32
    cfg = ServingConfig(max_batch=2, decode=ServingDecodeConfig(
        slots=2, max_len=max_len))
    gw = _port_gateway(cfg)
    prompts = [_rows(n=1, L=n, seed=s)[0]
               for n, s in ((5, 1), (9, 2), (3, 3), (12, 4))]
    news = [8, 5, 11, 6]
    replies = [None] * 4
    try:
        gw.install("stable", 1, blobs[1])

        def call(i):
            replies[i] = gw.generate(prompts[i], news[i], key=f"k{i}")

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        decode = gw.describe()["decode"]["stable"]
        snapshot = gw.queue_snapshot()
        model = gw._models["stable"][1]
    finally:
        gw.shutdown()
    assert decode["tokens_emitted"] == sum(news)
    assert (snapshot["decode_queue_depth"], snapshot["decode_active_slots"]) \
        == (0, 0)
    jvars = _jax_variables(0)
    for prompt, n, (tokens, version, channel) in zip(prompts, news, replies):
        assert (version, channel) == (1, "stable")
        solo = generate(model, prompt[None], n, max_len=max_len)[0]
        np.testing.assert_array_equal(tokens, solo.numpy())
        want = jax_generate(JaxLlama(**CFG), jvars, prompt[None], n,
                            max_len=max_len)[0]
        np.testing.assert_array_equal(tokens, np.asarray(want))


def test_continuous_batcher_swap_drains_onto_new_version(blobs):
    """A swap lands while a generation is in flight: that one finishes on
    the version it started with, the queued one decodes on the new one."""
    ops = TorchModelOps(LlamaLite(**CFG), device="cpu")
    m1 = ops.bind(ModelBlob.from_bytes(blobs[1]).tensors)
    cb = ContinuousBatcher(ops, 1, m1, slots=1, max_len=24)
    try:
        first = cb.submit(_rows(n=1, L=4)[0], 6)
        deadline = time.monotonic() + 30
        while not (cb.active() or first.done()):
            assert time.monotonic() < deadline, "first request never admitted"
            time.sleep(0.001)
        cb.swap(2, ops.module)
        second = cb.submit(_rows(n=1, L=4)[0], 3)
        (_, v_first), (_, v_second) = (first.result(timeout=60),
                                       second.result(timeout=60))
    finally:
        cb.close()
    assert (v_first, v_second) == (1, 2)


def test_gateway_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    ops = TorchModelOps(LlamaLite(**CFG), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingGateway(ops, ServingConfig())
