"""The port's flash attention, forward and backward (metisfl_tpu_torch/ops),
against the JAX package's: the Pallas kernels in interpret mode and their
dense oracle.

On the CPU each wrapper runs its plain twin, so these tests hold the twins
(and the dense/auto router) to the reference. The CUDA kernels themselves
are held to the twins by the ``cuda``-marked tests, which run only on a GPU
(and by chip_smoke.py at the serving and training shapes). jax is imported
only by the fixture that needs it, so on a machine with the card (which has
no jax) ``python -m pytest --noconftest -m cuda tests/test_torch_flash.py``
runs the kernel tests alone.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from metisfl_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    _dense_attention as port_dense,
    _repeat_kv,
    attention as port_attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)

# fp32 on both sides: one softmax over the same scores, summed in another
# order (blockwise online vs dense), stays within a few ulp of 1
ATOL = 1e-5
# bf16 forward: the Pallas kernel rounds P to bf16 against the running max
# of each 128-key block, the twin against the row's final max; the two
# roundings of one P can differ by an ulp, which moves o by at most one
# bf16 ulp in [0.5, 1)
BF16_FWD_ATOL = 2.0 ** -8


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
    """Inputs that need a gradient are no longer refused: the gradient
    flows through ``flash_attention`` (K1 forward, K2/K3 backward; their
    twins here) and equals the dense path's, GQA groups summed."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(L=40))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape).astype(np.float32))
    grads = torch.autograd.grad((flash_attention(q, k, v, True) * g).sum(),
                                (q, k, v))
    group = q.shape[1] // k.shape[1]
    dense = port_dense(q, _repeat_kv(k, group), _repeat_kv(v, group), True)
    want = torch.autograd.grad((dense * g).sum(), (q, k, v))
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    with torch.no_grad():
        assert flash_attention(q, k, v, True).shape == q.shape


def _bwd_inputs(seed=5, **shape):
    q, k, v = _qkv(seed=seed, **shape)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_twin_matches_pallas_backward(jax_flash, causal):
    """dq, dk, dv of the port's CPU path equal the Pallas backward's (K2
    and K3 in interpret mode) at B1·Hq4·Hkv2·L200·D64 fp32: L=200 pads the
    kernels' blocks (the ragged tail) and Hkv2 makes dK/dV sum over a
    group. fp32 on both sides, summed in another order: 1e-5."""
    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs()
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        True)
    B, H, L, _ = q.shape
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, H, L)
    want = jax_flash._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_ref, lse_ref,
        jnp.asarray(do), causal, None, None, True)
    o, lse = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal)
    got = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)), o,
                              lse, torch.from_numpy(do), causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_twin_matches_jax_grad_of_dense_oracle(jax_flash, causal):
    """The same gradients against ``jax.grad`` of ``_dense_attention``
    (KV repeated to the query heads, so the group sum comes from the
    repeat's transpose)."""
    import jax

    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs()
    group = q.shape[1] // k.shape[1]

    def loss(q, k, v):
        out = jax_flash._dense_attention(
            q, jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1),
            causal)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal)
    got = flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do),
                              causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_passes_gradcheck(causal):
    """The autograd Function in float64 at B1·Hq4·Hkv2·L7·D4: the backward
    twin is the derivative of the forward twin (finite differences)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((1, 4, 7, 4), (1, 2, 7, 4), (1, 2, 7, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal), (q, k, v))


def test_bwd_twin_takes_delta_and_keeps_dtypes():
    """A given δ is used as is (ring attention passes its own); bf16 inputs
    give bf16 gradients at kv-head size."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(L=24))
    o, lse = flash_attention_fwd(q, k, v, True)
    delta = (do * o).sum(-1)
    base = flash_attention_bwd(q, k, v, o, lse, do, True)
    given = flash_attention_bwd(q, k, v, o, lse, do, True, delta=delta)
    for a, b in zip(base, given):
        assert torch.equal(a, b)
    shifted = flash_attention_bwd(q, k, v, o, lse, do, True,
                                  delta=delta + 1.0)
    assert not torch.equal(shifted[0], base[0])
    bq, bk, bv, bdo = (t.bfloat16() for t in (q, k, v, do))
    bo, blse = flash_attention_fwd(bq, bk, bv, True)
    dq, dk, dv = flash_attention_bwd_reference(bq, bk, bv, bo, blse, bdo,
                                               True)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dk.shape == k.shape and dv.shape == v.shape


def test_bwd_kernel_wrappers_refuse_cpu_tensors():
    """K2 and K3 are kernels only: on the CPU the twin is reached through
    ``flash_attention_bwd``, never by the kernels' wrappers."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(L=8))
    lse = torch.zeros(q.shape[:3])
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_bwd_dq(q, k, v, do, lse, lse, True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_bwd_dkv(q, k, v, do, lse, lse, True)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("L,group", [(200, 2)] + [
    (L, group) for L in (1, 65, 129) for group in (1, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_twin_matches_pallas_forward(jax_flash, causal, L,
                                                  group):
    """The twin rounds P to the input dtype before P·V and divides by l
    afterwards, as ``_fwd_kernel`` does; B1·Hq4·D64 in bf16, at L=200 with
    Hkv2 and at the tensor-core kernel's edges (one key, one row past a
    64-row tile, two tiles and one) for one KV head per query head and for
    groups of 4."""
    jnp = jax_flash.jnp
    q, k, v = _qkv(Hkv=4 // group, L=L)
    o_ref, _ = jax_flash._flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal, None,
        None, True)
    o, _ = flash_attention_fwd(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    np.testing.assert_allclose(
        o.float().numpy(), np.asarray(o_ref.astype(jnp.float32)),
        atol=BF16_FWD_ATOL, rtol=0)


def test_rejects_gqa_mismatch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(Hq=3, Hkv=2, L=8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, k, v, False)


# K1's tolerance against its twin on the card, on o (lse: 1e-3, fp32 1e-4)
_FWD_ATOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# (dtype, causal, B, Hq, Hkv, L, D): the shapes held since the SIMT kernel,
# then the tensor-core kernel across its fragment (16 rows) and tile (64
# rows) edges, for every group size
_FWD_GPU_CASES = [
    (torch.bfloat16, True, 2, 16, 4, 1024, 64),
    (torch.float16, True, 2, 16, 4, 333, 64),
    (torch.float32, False, 2, 16, 16, 1000, 128),
] + [(dtype, causal, 1, 8, 8 // group, L, D)
     for dtype in (torch.bfloat16, torch.float16)
     for causal in (False, True)
     for D in (64, 128)
     for group in (1, 4, 8)
     for L in (1, 63, 64, 65, 129, 517)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _FWD_GPU_CASES)
def test_kernel_matches_plain_version_on_gpu(cuda_device, dtype, causal, B,
                                             Hq, Hkv, L, D):
    """The CUDA kernel against its plain twin on the card: o within the
    dtype's ``_FWD_ATOL``, lse within 1e-3 (1e-4 in fp32). One launch."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, Hq, L, D)).astype(
        np.float32)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, L, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    lse_atol = 1e-4 if dtype == torch.float32 else 1e-3
    assert o.dtype == dtype and lse.shape == (B, Hq, L)
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_atol, rtol=0)


@pytest.mark.cuda
def test_fwd_kernel_is_deterministic_on_gpu(cuda_device):
    """K1 writes each O tile and its lse once from one block: two runs
    give the same bits."""
    q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 2, 16,
                                        4, 517, 64, True, seed=3)
    first = flash_attention_fwd(q, k, v, True)
    second = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _cuda_bwd_inputs(device, dtype, B, Hq, Hkv, L, D, causal, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)

    q, do = draw((B, Hq, L, D)), draw((B, Hq, L, D))
    k, v = draw((B, Hkv, L, D)), draw((B, Hkv, L, D))
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    return q, k, v, o.contiguous(), lse.contiguous(), do


# the dtype's tolerance for K2/K3 against their twin, × max|twin|: the
# rounding of dS and P to bf16/fp16 can flip where kernel and twin sum the
# scores in another order
_BWD_REL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# (dtype, causal, B, Hq, Hkv, L, D, given_delta): the shapes held since the
# SIMT kernels, with δ = rowsum(dO∘O); then the tensor-core kernels across
# their fragment (16 rows), tile (64 rows) and streamed-tile (32 q rows at
# D=128) edges, for every group size, with a δ drawn apart from O, as ring
# attention's hops pass the δ of the whole output. With δ from O, dP − δ
# cancels to fp32 noise wherever a row sees one key (L=1: all of dq), and
# no relative tolerance can hold noise against noise.
_BWD_GPU_CASES = [
    (torch.bfloat16, True, 2, 16, 4, 1024, 64, False),
    (torch.float16, True, 2, 16, 4, 333, 128, False),
    (torch.float16, False, 1, 16, 16, 200, 64, False),
    (torch.float32, False, 2, 16, 8, 1000, 128, False),
] + [(dtype, causal, 1, 8, 8 // group, L, D, True)
     for dtype in (torch.bfloat16, torch.float16)
     for causal in (False, True)
     for D in (64, 128)
     for group in (1, 4, 8)
     for L in (1, 63, 64, 65, 129, 517)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D,given_delta",
                         _BWD_GPU_CASES)
def test_bwd_kernels_match_plain_version_on_gpu(cuda_device, dtype, causal,
                                                B, Hq, Hkv, L, D,
                                                given_delta):
    """K2 and K3 against their twin on the card (GQA where Hkv < Hq, ragged
    L where L is not a multiple of 64): each of dq, dk, dv within the
    dtype's ``_BWD_REL`` × max|twin|. Each launches once."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, B, Hq, Hkv,
                                           L, D, causal)
    delta = None
    if given_delta:
        delta = torch.from_numpy(np.random.default_rng(L).standard_normal(
            lse.shape).astype(np.float32)).to(cuda_device)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, delta=delta)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                         delta=delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _BWD_REL[dtype] * scale, (name, err, scale)


@pytest.mark.cuda
def test_dkv_kernel_is_deterministic_on_gpu(cuda_device):
    """K3 sums each KV group in a fixed order, without atomics: two runs
    give the same bits."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 2,
                                           16, 4, 517, 64, True, seed=3)
    delta = (do.float() * o.float()).sum(-1)
    first = flash_bwd_dkv(q, k, v, do, lse, delta, True)
    second = flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dq_kernel_is_deterministic_on_gpu(cuda_device):
    """K2 writes each dQ tile once from one block: two runs give the same
    bits."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 2,
                                           16, 4, 517, 64, True, seed=3)
    delta = (do.float() * o.float()).sum(-1)
    first = flash_bwd_dq(q, k, v, do, lse, delta, True)
    second = flash_bwd_dq(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` as a view that starts one element into its
    allocation, so off any 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def test_alignment_check_refuses_views_off_16_bytes():
    """The kernels copy rows 16 bytes at a time; the wrappers' check
    refuses a view that starts inside its allocation and passes a
    fresh tensor."""
    from metisfl_tpu_torch.ops.flash_attention import _check_aligned

    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    _check_aligned(q=q)
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned(q=q, do=_misaligned(q))


@pytest.mark.cuda
def test_bwd_kernels_refuse_misaligned_views_on_gpu(cuda_device):
    """A misaligned q or do never reaches K2 or K3: both wrappers raise
    before a launch."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 1,
                                           4, 2, 65, 64, True)
    delta = (do.float() * o.float()).sum(-1)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dq(_misaligned(q), k, v, do, lse, delta, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv(q, k, v, _misaligned(do), lse, delta, True)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before


@pytest.mark.cuda
def test_fwd_kernel_refuses_misaligned_views_on_gpu(cuda_device):
    """A misaligned q, k or v never reaches K1: the wrapper raises before a
    launch."""
    q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 1, 4,
                                        2, 65, 64, True)
    before = flash_attention_fwd.launches
    for args in ((_misaligned(q), k, v), (q, _misaligned(k), v),
                 (q, k, _misaligned(v))):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd(*args, True)
    assert flash_attention_fwd.launches == before


@pytest.mark.cuda
def test_autograd_runs_all_three_kernels_on_gpu(cuda_device):
    """One backward through ``flash_attention`` launches K1 once and K2, K3
    once each, with a strided upstream gradient made contiguous."""
    q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 1, 16,
                                        4, 256, 64, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (flash_attention_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out = flash_attention(q, k, v, True)
    out.transpose(1, 2).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


# -- head dims the kernels are not built for, and every grid ----------------

@pytest.mark.parametrize("D", [8, 16, 32, 256, 320, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_twins_at_padded_head_dims_match_pallas(jax_flash, causal, D):
    """The Pallas kernels take any D (their blocks span the head); the
    twins, which the CPU path runs and the padded and general kernels are
    held to, give the Pallas forward's o and lse and its backward's dq, dk,
    dv (interpret mode) at D = 8, 16, 32, 256 (K2/K3's largest build), 320
    and 512 (the general kernels), B1·Hq4·Hkv2·L40 fp32."""
    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs(L=40, D=D)
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        True)
    B, H, L, _ = q.shape
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, H, L)
    want = jax_flash._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_ref, lse_ref,
        jnp.asarray(do), causal, None, None, True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)
    got = flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do),
                              causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 8, 16, 32, 65, 100, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_padding_is_exact(causal, D, dtype):
    """The wrappers' padding path, with the twins in the kernels' place:
    q, k, v and dO zero-padded to the next head dim a kernel is built for
    (``pad_head_dim``: 64, 128 or 256 for K1 and for K2 and K3 in bf16, 64
    or 128 for K2 and K3 in fp32), run with the true D's scale and sliced
    back, give the unpadded twins' o, lse, dq, dk and dv to 0 ulp, and 0 in
    every padded column."""
    import math

    from metisfl_tpu_torch.ops.flash_attention import (
        _FWD_HEAD_DIMS,
        _delta,
        bwd_head_dims,
        flash_bwd_dkv_reference,
        flash_bwd_dq_reference,
        kernel_head_dim,
        pad_head_dim,
    )

    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _bwd_inputs(B=2, L=37, D=D))
    scale = 1.0 / math.sqrt(D)
    Dk, (qp, kp, vp) = pad_head_dim(q, k, v, head_dims=_FWD_HEAD_DIMS)
    assert Dk == next(d for d in (64, 128, 256) if D <= d)
    assert qp.shape[-1] == Dk
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    op, lsep = flash_attention_fwd_reference(qp, kp, vp, causal, scale)
    assert torch.equal(op[..., :D], o) and torch.equal(lsep, lse)
    assert not op[..., D:].any()
    if kernel_head_dim(D, bwd_head_dims(dtype)) is None:
        return  # the general kernel takes this D unpadded
    Dk, (qp, kp, vp, dop) = pad_head_dim(q, k, v, do,
                                         head_dims=bwd_head_dims(dtype))
    delta = _delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dqp = flash_bwd_dq_reference(qp, kp, vp, dop, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    dkp, dvp = flash_bwd_dkv_reference(qp, kp, vp, dop, lse, delta, causal,
                                       scale)
    for got, want in ((dqp, dq), (dkp, dk), (dvp, dv)):
        assert torch.equal(got[..., :D], want)
        assert not got[..., D:].any()


def test_kernel_head_dims_need_no_copy():
    from metisfl_tpu_torch.ops.flash_attention import (
        _FWD_HEAD_DIMS,
        pad_head_dim,
    )

    for D in (64, 128, 256):
        q = torch.zeros(1, 2, 8, D)
        Dk, (same,) = pad_head_dim(q, head_dims=_FWD_HEAD_DIMS)
        assert Dk == D and same is q


def test_head_dims_beyond_the_kernels_are_refused_with_their_reason():
    """No head dim that the Pallas kernels take is refused on the card any
    more: each D goes to a tuned kernel (padded to its next built head dim:
    K1 64/128/256, K2 and K3 64/128/256 in bf16/fp16 and 64/128 in fp32)
    or, beyond the largest, to the general kernel. The input check runs
    before any launch, so it is reachable on the CPU; it still refuses a
    head dim of 0 and a grid it cannot launch."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _FWD_HEAD_DIMS,
        _check_cuda_inputs,
        bwd_head_dims,
        kernel_head_dim,
    )

    for D, fwd, bwd16, bwd32 in ((1, 64, 64, 64), (129, 256, 256, None),
                                 (256, 256, 256, None),
                                 (257, None, None, None),
                                 (512, None, None, None)):
        q = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
        _check_cuda_inputs(q, q, q)
        _check_cuda_inputs(q, q, q, do=q)
        assert kernel_head_dim(D, _FWD_HEAD_DIMS) == fwd
        assert kernel_head_dim(D, bwd_head_dims(torch.bfloat16)) == bwd16
        assert kernel_head_dim(D, bwd_head_dims(torch.float16)) == bwd16
        assert kernel_head_dim(D, bwd_head_dims(torch.float32)) == bwd32
    q = torch.zeros(1, 2, 8, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        _check_cuda_inputs(q, q, q)
    q = torch.zeros(1, 65536, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        _check_cuda_inputs(q, q, q)


@pytest.mark.parametrize("B,H", [(1, 16), (4096, 16), (4097, 16),
                                 (70000, 1), (3, 65535), (10, 40000)])
def test_batch_chunks_fit_the_grid_and_cover_the_batch(B, H):
    from metisfl_tpu_torch.ops.flash_attention import _batch_chunks

    chunks = _batch_chunks(B, H)
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < (b1 - b0) * H <= 65535 for b0, b1 in chunks)
    assert len(chunks) == -(-B // (65535 // H))


# (dtype, causal, B, Hq, Hkv, L, D, launches): padded head dims, the
# examples/long_context.py shape (D = 16), and B·Hq above gridDim.y's 65535
# (two batch chunks)
_PADDED_GPU_CASES = [
    (dtype, causal, 2, 8, 2, L, D, 1)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for causal in (False, True)
    for D in (8, 16, 32)
    for L in (65, 200)
] + [
    (torch.bfloat16, True, 4, 4, 4, 512, 16, 1),
    (torch.bfloat16, True, 4100, 16, 4, 16, 64, 2),
    (torch.float32, False, 4100, 16, 4, 16, 32, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D,launches",
                         _PADDED_GPU_CASES)
def test_kernels_at_padded_head_dims_and_large_grids_on_gpu(
        cuda_device, dtype, causal, B, Hq, Hkv, L, D, launches):
    """K1, K2 and K3 at head dims the kernels are not built for (padded to
    64) and at B·Hq > 65535 (launched in batch chunks) against their twins
    on the card, at the tolerances of the unpadded cases."""
    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(cuda_device, dtype, B,
                                                   Hq, Hkv, L, D, causal)
    before = (flash_attention_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + launches for n in before)
    lse_atol = 1e-4 if dtype == torch.float32 else 1e-3
    assert o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_atol, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _BWD_REL[dtype] * scale, (name, err, scale)


# (dtype, causal, B, Hq, Hkv, L, D): K1 at the head dim 256 instantiation
# and at D = 200, padded to it
_FWD_256_GPU_CASES = [
    (dtype, causal, 1, 8, 2, L, D)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for causal in (False, True)
    for D in (200, 256)
    for L in (65, 300)
]


def _launch_counts():
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_general,
        flash_bwd_dq_general,
        flash_fwd_general,
    )

    return {fn.__name__: fn.launches for fn in (
        flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_general,
        flash_bwd_dq_general, flash_bwd_dkv_general)}


def _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D, device):
    """K1, then K2 and K3 through flash_attention_bwd, against their twins
    at the unpadded cases' tolerances; returns the launches each wrapper
    counted."""
    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(device, dtype, B, Hq,
                                                   Hkv, L, D, causal)
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    after = _launch_counts()
    lse_atol = 1e-4 if dtype == torch.float32 else 1e-3
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_atol, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _BWD_REL[dtype] * scale, (name, err, scale)
    return {name: after[name] - before[name] for name in after}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _FWD_256_GPU_CASES)
def test_forward_kernel_at_head_dims_up_to_256_on_gpu(cuda_device, dtype,
                                                      causal, B, Hq, Hkv, L,
                                                      D):
    """K1 against its twin at D = 256 (its own instantiation) and D = 200
    (padded to it), one launch; the backward runs too: in bf16/fp16 on
    K2's D = 256 build and K3's, once for dV and once for dK; in fp32 on
    the general kernels."""
    launched = _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D,
                                     cuda_device)
    general = dtype == torch.float32
    assert launched == {
        "flash_attention_fwd": 1, "flash_fwd_general": 0,
        "flash_bwd_dq": 0 if general else 1,
        "flash_bwd_dkv": 0 if general else 2,
        "flash_bwd_dq_general": int(general),
        "flash_bwd_dkv_general": int(general)}


# (dtype, causal, B, Hq, Hkv, L, D): head dims beyond every build, on the
# general kernels: ragged chunks (D = 320 is five, 300 and 600 end inside
# a chunk), tiles and groups
_GENERAL_GPU_CASES = [
    (dtype, causal, 1, 4, Hkv, L, D)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for causal in (False, True)
    for D, Hkv, L in ((300, 2, 65), (320, 4, 130), (512, 1, 200),
                      (600, 2, 64))
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _GENERAL_GPU_CASES)
def test_general_kernels_beyond_every_build_on_gpu(cuda_device, dtype,
                                                    causal, B, Hq, Hkv, L,
                                                    D):
    """K1, K2 and K3 at D > 256 go to the general kernels, one launch each,
    and hold their twins at the tuned kernels' tolerances."""
    launched = _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D,
                                     cuda_device)
    assert launched == {
        "flash_attention_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_general": 1, "flash_bwd_dq_general": 1,
        "flash_bwd_dkv_general": 1}


@pytest.mark.cuda
def test_general_and_d256_kernels_are_deterministic_on_gpu(cuda_device):
    """The general kernels and K3's two-pass D = 256 build write each
    output once from one block: two runs give the same bits."""
    for dtype, D in ((torch.bfloat16, 256), (torch.bfloat16, 320),
                     (torch.float32, 256)):
        q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, 1, 4, 2,
                                               130, D, True, seed=3)
        first = (flash_attention_fwd(q, k, v, True)
                 + flash_attention_bwd(q, k, v, o, lse, do, True))
        second = (flash_attention_fwd(q, k, v, True)
                  + flash_attention_bwd(q, k, v, o, lse, do, True))
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), (dtype, D)
