"""LlamaLite parity: a JAX-initialised model carried into the port through
``load_flax_variables`` gives the same logits, cached-decode logits and
greedy tokens as the JAX package."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metisfl_tpu.models.generate import generate as jax_generate
from metisfl_tpu.models.generate import init_cache as jax_init_cache
from metisfl_tpu.models.zoo.transformer import LlamaLite as JaxLlama
from metisfl_tpu.tensor.pytree import pytree_to_named_tensors
from metisfl_tpu_torch.models import (
    TorchModelOps,
    export_flax_variables,
    generate,
    init_cache,
    load_flax_variables,
)
from metisfl_tpu_torch.models.zoo import LlamaLite

CFG = dict(vocab_size=97, dim=32, depth=2, heads=4, kv_heads=2)
# fp32 on both sides; the JAX side runs with x64 on (tests/conftest.py),
# which widens its rotary angles to f64 — a ~1e-7 relative difference
ATOL = 1e-5
# bf16 compute over fp32 params: both sides round every product and
# activation to 8 mantissa bits, at different places (e.g. torch's silu
# and matmul accumulate in fp32 before rounding); logits here are O(4)
BF16_ATOL = 6e-2


@pytest.fixture
def jax_flash_ops():
    """Make the reference's flash ops importable for one test (jax 0.9
    renamed ``pltpu.TPUCompilerParams`` to ``CompilerParams``, so
    ``metisfl_tpu.ops`` fails to import), then undo the alias and drop the
    modules imported under it so no later test in the worker sees them."""
    from jax.experimental.pallas import tpu as pltpu

    import metisfl_tpu

    aliased = not hasattr(pltpu, "TPUCompilerParams")
    if aliased:
        pltpu.TPUCompilerParams = pltpu.CompilerParams
    try:
        yield importlib.import_module("metisfl_tpu.ops")
    finally:
        if aliased:
            del pltpu.TPUCompilerParams
            for name in ("metisfl_tpu.ops.flash_attention", "metisfl_tpu.ops"):
                sys.modules.pop(name, None)
            if hasattr(metisfl_tpu, "ops"):
                delattr(metisfl_tpu, "ops")


def _tokens(B=2, L=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (B, L)).astype(np.int32)


@pytest.fixture(scope="module")
def variables():
    """JAX-initialised variables with a nonzero LoRA delta (Flax starts
    lora_b at zero, which would leave the adapter path untested)."""
    module = JaxLlama(lora_rank=2, **CFG)
    v = jax.device_get(module.init(jax.random.PRNGKey(0),
                                   jnp.asarray(_tokens(1, 8))))
    rng = np.random.default_rng(9)
    for i in range(CFG["depth"]):
        for proj in ("wq", "wv"):
            node = v["params"][f"block_{i}"]["attn"][proj]
            node["lora_b"] = rng.standard_normal(
                node["lora_b"].shape).astype(np.float32) * 0.1
    return v


def _port(variables, **kw):
    return load_flax_variables(LlamaLite(lora_rank=2, **CFG, **kw),
                               variables).eval()


@pytest.mark.parametrize("use_flash", [False, True, "auto"])
def test_logits_match(jax_flash_ops, variables, use_flash):
    tokens = _tokens()
    want = JaxLlama(lora_rank=2, use_flash=use_flash, **CFG).apply(
        variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = _port(variables, use_flash=use_flash)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_compute_matches_at_bf16_tolerance(variables):
    tokens = _tokens()
    want = np.asarray(JaxLlama(lora_rank=2, dtype=jnp.bfloat16, **CFG).apply(
        variables, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port(variables, dtype=torch.bfloat16)(
            torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32  # the LM head runs in fp32
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_exported_names_and_values_round_trip(variables):
    port = _port(variables)
    exported = export_flax_variables(port)
    want = pytree_to_named_tensors(variables)
    got = pytree_to_named_tensors(exported)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        # the port's params are fp32; under the harness's x64 mode Flax
        # draws lora_a in f64, so compare at fp32
        assert a.dtype == np.float32, name
        np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                      err_msg=name)
    assert "params/block_1/attn/wo/kernel" in dict(got)
    assert "params/block_0/attn/wq/base/kernel" in dict(got)


def test_load_rejects_mismatched_variables(variables):
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(LlamaLite(**CFG), variables)  # no LoRA params
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["lm_head"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(LlamaLite(lora_rank=2, **CFG), bad)


def test_cached_prefill_and_decode_match(variables):
    """Teacher-forced: prefill 10 tokens, then feed the rest one by one;
    each step's logits equal the JAX module's cached apply."""
    tokens = _tokens(L=16)
    jmod = JaxLlama(lora_rank=2, **CFG)
    port = _port(variables)
    max_len = 20
    jc = jax_init_cache(jmod, 2, max_len)
    pc = init_cache(port, 2, max_len)
    chunks = [(0, 10)] + [(p, p + 1) for p in range(10, 16)]
    for start, end in chunks:
        want, jc = jmod.apply(variables, jnp.asarray(tokens[:, start:end]),
                              caches=jc, position=start)
        with torch.no_grad():
            got, pc = port(torch.from_numpy(tokens[:, start:end]),
                           caches=pc, position=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for (ck, cv), (jk, jv) in zip(pc, jc):
        np.testing.assert_allclose(ck.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jv), atol=ATOL)


def test_per_row_positions_equal_scalar_position(variables):
    """The slot step's per-row positions give each row exactly what a
    scalar-position step gives it alone."""
    port = _port(variables)
    tokens = _tokens(B=3, L=12)
    lens = [5, 9, 12]
    caches = init_cache(port, 3, 16)
    solo = []
    with torch.no_grad():
        for b, n in enumerate(lens):
            sub = tuple((k[b:b + 1], v[b:b + 1]) for k, v in caches)
            port(torch.from_numpy(tokens[b:b + 1, :n - 1]), caches=sub,
                 position=0)
            solo.append(port(torch.from_numpy(tokens[b:b + 1, n - 1:n]),
                             caches=tuple((k.clone(), v.clone())
                                          for k, v in sub),
                             position=n - 1)[0])
        batched, _ = port(
            torch.from_numpy(np.array([[tokens[b, n - 1]]
                                       for b, n in enumerate(lens)])),
            caches=caches, position=torch.tensor([n - 1 for n in lens]))
    for b in range(3):
        np.testing.assert_allclose(batched[b].numpy(), solo[b][0].numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("eos_id", [None, 5])
def test_greedy_tokens_equal_jax(variables, eos_id):
    prompt = _tokens(L=7, seed=3)
    jmod = JaxLlama(lora_rank=2, **CFG)
    want = np.asarray(jax_generate(jmod, variables, prompt, 10, max_len=24,
                                   eos_id=eos_id))
    got = generate(_port(variables), prompt, 10, max_len=24, eos_id=eos_id)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_and_unported_fields_raise(variables):
    with pytest.raises(NotImplementedError, match="temperature"):
        generate(_port(variables), _tokens(L=4), 2, temperature=0.7)
    for field in (dict(moe_experts=4), dict(sp_mesh=object())):
        with pytest.raises(NotImplementedError):
            LlamaLite(**CFG, **field)


def test_model_ops_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModelOps(LlamaLite(**CFG))


def test_model_ops_round_trips_variables(variables):
    ops = TorchModelOps(LlamaLite(lora_rank=2, **CFG), variables=variables,
                        device="cpu")
    tokens = _tokens()
    want = JaxLlama(lora_rank=2, **CFG).apply(variables, jnp.asarray(tokens))
    np.testing.assert_allclose(ops.infer(tokens, batch_size=1),
                               np.asarray(want), atol=ATOL)
    assert ops.forward_calls == 2
    fresh = TorchModelOps(LlamaLite(lora_rank=2, **CFG), rng_seed=1,
                          device="cpu")
    fresh.set_variables(ops.get_variables())
    np.testing.assert_array_equal(fresh.infer(tokens), ops.infer(tokens))
    np.testing.assert_array_equal(
        ops.generate(tokens[:, :5], 4, max_len=12),
        np.asarray(jax_generate(JaxLlama(lora_rank=2, **CFG), variables,
                                tokens[:, :5], 4, max_len=12)))
