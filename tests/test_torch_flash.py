"""The port's flash-attention forward (metisfl_tpu_torch/ops) against the
JAX package's: the Pallas kernel in interpret mode and its dense oracle.

On the CPU the wrapper runs its plain twin, so these tests hold that twin
(and the dense/auto router) to the reference. The CUDA kernel itself is
held to the twin by the ``cuda``-marked test, which runs only on a GPU
(and by chip_smoke.py at the serving shape). jax is imported only by the
fixture that needs it, so on a machine with the card (which has no jax)
``python -m pytest --noconftest -m cuda tests/test_torch_flash.py`` runs
the kernel tests alone.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from metisfl_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    _dense_attention as port_dense,
    attention as port_attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

# fp32 on both sides: one softmax over the same scores, summed in another
# order (blockwise online vs dense), stays within a few ulp of 1
ATOL = 1e-5


@pytest.fixture
def jax_flash():
    """The reference's flash module, importable on this jax.

    jax 0.9 renamed ``pltpu.TPUCompilerParams`` to ``CompilerParams``, so
    ``metisfl_tpu.ops`` fails to import (a fault of the reference, not of
    the port). Alias the old name for this test only, and undo everything
    at teardown so no later test in the worker sees the alias or the
    modules imported under it."""
    from jax.experimental.pallas import tpu as pltpu

    import metisfl_tpu

    aliased = not hasattr(pltpu, "TPUCompilerParams")
    if aliased:
        pltpu.TPUCompilerParams = pltpu.CompilerParams
    try:
        # import_module: ``import ... as`` would resolve the ops package's
        # flash_attention FUNCTION, which shadows the module's name; the
        # tests reach jax.numpy as the module's ``jnp``
        yield importlib.import_module("metisfl_tpu.ops.flash_attention")
    finally:
        if aliased:
            del pltpu.TPUCompilerParams
            for name in ("metisfl_tpu.ops.flash_attention", "metisfl_tpu.ops"):
                sys.modules.pop(name, None)
            if hasattr(metisfl_tpu, "ops"):
                delattr(metisfl_tpu, "ops")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(B=1, Hq=4, Hkv=2, L=200, D=64, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_path_matches_pallas_kernel(jax_flash, causal):
    """o and lse of the port's CPU path equal the Pallas forward's (run in
    interpret mode) at B1·Hq4·Hkv2·L200·D64; L=200 pads the kernel's
    blocks, so the ragged tail is covered too."""
    jnp = jax_flash.jnp
    q, k, v = _qkv()
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        True)
    B, H, L, _ = q.shape
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, H, L)
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal)
    assert o.dtype == torch.float32 and lse.shape == (B, H, L)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_path_matches_dense_oracle(jax_flash, causal):
    jnp = jax_flash.jnp
    q, k, v = _qkv()
    rep = q.shape[1] // k.shape[1]
    want = jax_flash._dense_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1), causal)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("L", [40, 200])
def test_router_matches_reference_router(jax_flash, L):
    """``attention`` routes on length in both packages (dense below the
    threshold, flash at or above it) and both routes agree."""
    jnp = jax_flash.jnp
    q, k, v = _qkv(L=L)
    for threshold in (64, 4096):
        want = jax_flash.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True,
                                   min_flash_seq=threshold)
        got = port_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), True,
                             min_flash_seq=threshold)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert FLASH_MIN_SEQ == jax_flash.FLASH_MIN_SEQ


def test_dense_path_matches_reference(jax_flash):
    jnp = jax_flash.jnp
    q, k, v = _qkv(Hkv=4, L=48)
    want = jax_flash._dense_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True)
    got = port_dense(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_tensor_runs_plain_version_not_kernel():
    """A CPU tensor never reaches the kernel: the count stays put and the
    result is the plain twin's, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(L=32))
    flash_attention_fwd.launches = 0
    o, lse = flash_attention_fwd(q, k, v, True)
    o2, lse2 = flash_attention_fwd_reference(q, k, v, True)
    assert flash_attention_fwd.launches == 0
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_reference_keeps_input_dtype_and_groups_heads():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(Hq=4, Hkv=1, L=16, D=64))
    o, lse = flash_attention_fwd_reference(q, k, v, False)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # with one kv head, every query head attends over the same keys
    o_mha, _ = flash_attention_fwd_reference(
        q, k.expand(-1, 4, -1, -1), v.expand(-1, 4, -1, -1), False)
    assert torch.equal(o, o_mha)


def test_refuses_inputs_that_need_a_gradient():
    q, k, v = (torch.from_numpy(a) for a in _qkv(L=8))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q, k, v, True)
    with torch.no_grad():
        assert flash_attention(q, k, v, True).shape == q.shape


def test_rejects_gqa_mismatch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(Hq=3, Hkv=2, L=8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, k, v, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,Hkv,L,D,atol", [
    (torch.bfloat16, True, 4, 1024, 64, 2e-2),
    (torch.float16, True, 4, 333, 64, 2e-3),
    (torch.float32, False, 16, 1000, 128, 1e-4),
])
def test_kernel_matches_plain_version_on_gpu(cuda_device, dtype, causal, Hkv,
                                             L, D, atol):
    """The CUDA kernel against its plain twin on the card: o within the
    dtype's tolerance, lse within 1e-3 (1e-4 in fp32)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 16, L, D)).astype(
        np.float32)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, Hkv, L, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    lse_atol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_atol, rtol=0)
