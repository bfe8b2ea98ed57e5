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
    dtype's ``_FWD_ATOL``, lse within 1e-3 (1e-4 in fp32). One launch of
    the kernel the dtype routes to (fp32: the register-tiled kernel, with
    its combine where it splits)."""
    from metisfl_tpu_torch.ops.flash_attention import kernel_route

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, Hq, L, D)).astype(
        np.float32)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, L, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    after = _launch_counts()
    combine = _combine_launches(cuda_device, dtype, B, Hq, L, D, causal)
    assert {n: after[n] - before[n] for n in after
            if after[n] - before[n]} == {
        kernel_route("fwd", dtype, D).wrapper: 1,
        **({"flash_fwd_split_combine": 1} if combine else {})}
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
    dtype's ``_BWD_REL`` × max|twin|. Each launches once, on the kernel
    its route names (fp32: the register-tiled kernels, with their split
    sums where they split)."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, B, Hq, Hkv,
                                           L, D, causal)
    delta = None
    if given_delta:
        delta = torch.from_numpy(np.random.default_rng(L).standard_normal(
            lse.shape).astype(np.float32)).to(cuda_device)
    before = _launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, delta=delta)
    torch.cuda.synchronize()
    assert _launched(before) == _expected_launches(
        cuda_device, dtype, B, Hq, Hkv, L, D, causal, fwd=False)
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

# bf16 backward, twin against the Pallas kernels: both round dS and P to
# bf16 before their products but sum in other orders (and from o's that
# differ by up to an ulp, through δ), so one rounding can flip; each of dq,
# dk, dv within one bf16 ulp of its largest magnitude, 2⁻⁷ × max|ref|
BF16_BWD_REL = 2.0 ** -7


# fp16 against the Pallas kernels, as bf16 above with fp16's 10 mantissa
# bits: o within one fp16 ulp in [0.5, 1), dq, dk, dv within one ulp of
# their largest magnitude
FP16_FWD_ATOL = 2.0 ** -11
FP16_BWD_REL = 2.0 ** -10


@pytest.mark.parametrize("D,dtype,L", [
    pytest.param(D, torch.float32, 40, id=str(D))
    for D in (8, 16, 32, 256, 320, 512)] + [
    pytest.param(D, torch.bfloat16, 40, id=f"{D}-bf16")
    for D in (8, 16, 32, 256, 320, 384)] + [
    pytest.param(D, torch.float16, 40, id=f"{D}-fp16")
    for D in (8, 16, 32, 256)] + [
    pytest.param(256, dtype, 130, id=f"256-{name}-L130")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16"))])
@pytest.mark.parametrize("causal", [False, True])
def test_twins_at_padded_head_dims_match_pallas(jax_flash, causal, D, dtype,
                                                L):
    """The Pallas kernels take any D (their blocks span the head); the
    twins, which the CPU path runs and the small-D, padded and general
    kernels are held to, give the Pallas forward's o and lse and its
    backward's dq, dk, dv (interpret mode) at D = 8, 16, 32, 256 (the
    largest build of K1, K2 and K3), 320 and 512 (the general kernels),
    B1·Hq4·Hkv2·L40 fp32 (to ``ATOL``); in bf16 at D = 8, 16 and 32, where
    K1 and K3 run their D = 16 and 32 builds, at 256, where all three run
    their two-warpgroup builds, and at 320 and 384, where the general
    tensor-core kernels take K1 and K3: o within ``BF16_FWD_ATOL`` (the
    bf16 forward test's), lse (fp32 from exact bf16 inputs) within
    ``ATOL``, dq, dk, dv within ``BF16_BWD_REL`` × max|ref|; and in fp16
    at D = 8, 16, 32 and 256 within ``FP16_FWD_ATOL`` and
    ``FP16_BWD_REL``. At D = 256 in bf16 and fp16 also at L = 130, past a
    128-row q tile of K1's build (and the Pallas kernels' 128-key
    blocks)."""
    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs(L=L, D=D)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_ref, lse_ref = jax_flash._flash_forward(jq, jk, jv, causal, None,
                                              None, True)
    B, H, L, _ = q.shape
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, H, L)
    want = jax_flash._flash_backward(jq, jk, jv, o_ref, lse_ref, jdo, causal,
                                     None, None, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, lse = flash_attention_fwd(tq, tk, tv, causal)
    assert o.dtype == dtype
    o_atol, bwd_rel = {torch.float32: (ATOL, None),
                       torch.bfloat16: (BF16_FWD_ATOL, BF16_BWD_REL),
                       torch.float16: (FP16_FWD_ATOL, FP16_BWD_REL)}[dtype]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref.astype(jnp.float32)),
                               atol=o_atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        b = np.asarray(b.astype(jnp.float32))
        atol = ATOL if dtype == torch.float32 else (
            bwd_rel * float(np.abs(b).max()))
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [1, 8, 16, 32, 65, 100, 200, 257, 300, 400])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_padding_is_exact(causal, D, dtype):
    """The wrappers' padding path, with the twins in the kernels' place:
    q, k, v and dO zero-padded to the head dim of the kernel each call
    routes to (``kernel_route``: in bf16/fp16 the next build, 16, 32, 64,
    128 or 256 for K1, K2 and K3, and beyond the builds the
    next multiple of 64 of the tensor-core general kernels; in fp32, for
    K1, K2 and K3 at every D, the next multiple of 32, at least 64, of the
    register-tiled kernels), run with the true D's scale and sliced back,
    give the unpadded twins' o, lse, dq, dk and dv to 0 ulp, and 0 in every
    padded column. (The D = 16 and 32 builds of K1, K2 and K3 zero-fill
    those columns in shared memory instead of a padded copy, where D is a
    multiple of 8: the same arithmetic.)

    The inputs are multiples of 1/8 in [-1, 1], exact in every dtype, so
    that every product and every sum over D (Q·Kᵀ, dO·Vᵀ) is exact in fp32
    in any order: the CPU's GEMM sums over D in an order that depends on
    D's length (with N(0, 1) inputs the padded and unpadded Q·Kᵀ differ by
    an ulp at D = 400 → 448 and 500 → 512, and by none at D <= 320), and
    that order, not the padding, is what a 0-ulp comparison would see."""
    import math

    from metisfl_tpu_torch.ops.flash_attention import (
        _delta,
        flash_bwd_dkv_reference,
        flash_bwd_dq_reference,
        kernel_route,
        pad_head_dim,
    )

    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(rng.integers(-8, 9, (2, 4, 37, D)) / 8).to(
        dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.integers(-8, 9, (2, 2, 37, D)) / 8).to(
        dtype) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    fwd = kernel_route("fwd", dtype, D)
    if dtype == torch.float32:
        assert fwd.head_dim == max(64, -(-D // 32) * 32)
    elif D <= 256:
        assert fwd.head_dim == next(d for d in (16, 32, 64, 128, 256)
                                    if D <= d)
        assert kernel_route("dkv", dtype, D).head_dim == fwd.head_dim
        assert kernel_route("dq", dtype, D).head_dim == fwd.head_dim
    else:
        assert fwd.head_dim == -(-D // 64) * 64
    Dk, (qp, kp, vp) = pad_head_dim(q, k, v, head_dims=(fwd.head_dim,))
    assert qp.shape[-1] == Dk == fwd.head_dim
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    op, lsep = flash_attention_fwd_reference(qp, kp, vp, causal, scale)
    assert torch.equal(op[..., :D], o) and torch.equal(lsep, lse)
    assert not op[..., D:].any()
    delta = _delta(o, do)
    for kernel in ("dq", "dkv"):
        Dk = kernel_route(kernel, dtype, D).head_dim
        if Dk == D:
            continue  # the kernel's own head dim: no copy
        _, (qp, kp, vp, dop) = pad_head_dim(q, k, v, do, head_dims=(Dk,))
        if kernel == "dq":
            pairs = ((flash_bwd_dq_reference(qp, kp, vp, dop, lse, delta,
                                             causal, scale),
                      flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                             causal)),)
        else:
            pairs = zip(flash_bwd_dkv_reference(qp, kp, vp, dop, lse, delta,
                                                causal, scale),
                        flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal))
        for got, want in pairs:
            assert torch.equal(got[..., :D], want)
            assert not got[..., D:].any()


# (dtype, D) -> the wrapper each of K1, K2, K3 routes to on the card, with
# the head dim it runs at, its chunks along D and its passes
_ROUTES = {
    (torch.float32, 64): (("flash_fwd_general", 64, 1, 1),
                          ("flash_bwd_dq_general", 64, 1, 1),
                          ("flash_bwd_dkv_general", 64, 1, 2)),
    (torch.float32, 128): (("flash_fwd_general", 128, 1, 1),
                           ("flash_bwd_dq_general", 128, 1, 1),
                           ("flash_bwd_dkv_general", 128, 1, 2)),
    (torch.float32, 200): (("flash_fwd_general", 224, 1, 1),
                           ("flash_bwd_dq_general", 224, 1, 1),
                           ("flash_bwd_dkv_general", 224, 1, 2)),
    (torch.float32, 256): (("flash_fwd_general", 256, 1, 1),
                           ("flash_bwd_dq_general", 256, 1, 1),
                           ("flash_bwd_dkv_general", 256, 1, 2)),
    (torch.float32, 257): (("flash_fwd_general", 288, 2, 1),
                           ("flash_bwd_dq_general", 288, 2, 1),
                           ("flash_bwd_dkv_general", 288, 2, 2)),
    (torch.float32, 320): (("flash_fwd_general", 320, 2, 1),
                           ("flash_bwd_dq_general", 320, 2, 1),
                           ("flash_bwd_dkv_general", 320, 2, 2)),
    (torch.float32, 512): (("flash_fwd_general", 512, 2, 1),
                           ("flash_bwd_dq_general", 512, 2, 1),
                           ("flash_bwd_dkv_general", 512, 2, 2)),
    (torch.float32, 1024): (("flash_fwd_general", 1024, 4, 1),
                            ("flash_bwd_dq_general", 1024, 4, 1),
                            ("flash_bwd_dkv_general", 1024, 4, 2)),
}
for _dtype in (torch.bfloat16, torch.float16):
    _ROUTES.update({
        (_dtype, 8): (("flash_attention_fwd", 16, 1, 1),
                      ("flash_bwd_dq", 16, 1, 1),
                      ("flash_bwd_dkv", 16, 1, 1)),
        (_dtype, 16): (("flash_attention_fwd", 16, 1, 1),
                       ("flash_bwd_dq", 16, 1, 1),
                       ("flash_bwd_dkv", 16, 1, 1)),
        (_dtype, 24): (("flash_attention_fwd", 32, 1, 1),
                       ("flash_bwd_dq", 32, 1, 1),
                       ("flash_bwd_dkv", 32, 1, 1)),
        (_dtype, 32): (("flash_attention_fwd", 32, 1, 1),
                       ("flash_bwd_dq", 32, 1, 1),
                       ("flash_bwd_dkv", 32, 1, 1)),
        (_dtype, 40): (("flash_attention_fwd", 64, 1, 1),
                       ("flash_bwd_dq", 64, 1, 1),
                       ("flash_bwd_dkv", 64, 1, 1)),
        (_dtype, 64): (("flash_attention_fwd", 64, 1, 1),
                       ("flash_bwd_dq", 64, 1, 1),
                       ("flash_bwd_dkv", 64, 1, 1)),
        (_dtype, 200): (("flash_attention_fwd", 256, 1, 1),
                        ("flash_bwd_dq", 256, 1, 1),
                        ("flash_bwd_dkv", 256, 1, 1)),
        (_dtype, 256): (("flash_attention_fwd", 256, 1, 1),
                        ("flash_bwd_dq", 256, 1, 1),
                        ("flash_bwd_dkv", 256, 1, 1)),
        (_dtype, 257): (("flash_fwd_general_mma", 320, 2, 1),
                        ("flash_bwd_dq_general_mma", 320, 2, 1),
                        ("flash_bwd_dkv_general_mma", 320, 2, 2)),
        (_dtype, 320): (("flash_fwd_general_mma", 320, 2, 1),
                        ("flash_bwd_dq_general_mma", 320, 2, 1),
                        ("flash_bwd_dkv_general_mma", 320, 2, 2)),
        (_dtype, 512): (("flash_fwd_general_mma", 512, 2, 1),
                        ("flash_bwd_dq_general_mma", 512, 2, 1),
                        ("flash_bwd_dkv_general_mma", 512, 2, 2)),
        (_dtype, 1024): (("flash_fwd_general_mma", 1024, 4, 1),
                         ("flash_bwd_dq_general_mma", 1024, 4, 1),
                         ("flash_bwd_dkv_general_mma", 1024, 4, 2)),
    })


@pytest.mark.parametrize("dtype,D", list(_ROUTES), ids=[
    f"{str(dtype).split('.')[-1]}-{D}" for dtype, D in _ROUTES])
def test_kernel_route_names_the_kernel_for_each_dtype_and_head_dim(dtype,
                                                                   D):
    """``kernel_route`` is a pure function of (dtype, D), the one the
    wrappers route by, and needs no GPU: in fp32 K1, K2 and K3 go at every
    D to their register-tiled kernels (padded to a multiple of 32 and at
    least 64, 256-column chunks; K3 in two passes, dV and dK); bf16/fp16
    goes to the builds up to 256 (16, 32, 64, 128 and 256 for K1, K2 and
    K3; K3's D = 256 build in one pass) and above to the tensor-core
    general kernels for K1, K2 and K3 (padded to a
    multiple of 64, 256-column chunks; K3 in two passes); each route names
    a wrapper of the module."""
    import importlib

    from metisfl_tpu_torch.ops.flash_attention import kernel_route

    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    for kernel, want in zip(("fwd", "dq", "dkv"), _ROUTES[(dtype, D)]):
        route = kernel_route(kernel, dtype, D)
        assert tuple(route) == want, (kernel, route)
        assert hasattr(getattr(fa, route.wrapper), "launches")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [257, 300, 320, 384, 400, 512, 640, 1024,
                               4096])
def test_dq_route_beyond_the_builds_is_the_tensor_core_kernel(dtype, D):
    """In bf16/fp16 every head dim above 256 sends K2 to the general
    tensor-core kernel, padded to a multiple of 64, one pass, a block per
    256-column chunk; never to the register-tiled kernel, which is fp32
    only."""
    from metisfl_tpu_torch.ops.flash_attention import kernel_route

    route = kernel_route("dq", dtype, D)
    assert route.wrapper == "flash_bwd_dq_general_mma"
    assert route.wrapper != "flash_bwd_dq_general"
    assert route.head_dim == -(-D // 64) * 64 and route.passes == 1
    assert route.chunks == -(-route.head_dim // 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [257, 300, 400])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_padding_at_the_tensor_core_route_is_exact(causal, D, dtype):
    """K2's twin at the head dim the tensor-core route pads D to (320, 320,
    448) equals the twin at the true D to 0 ulp, with 0 in every padded
    column: padded K and V columns add 0 to Q·Kᵀ and dO·Vᵀ, and padded K
    columns only give dQ columns that are sliced off. Inputs are multiples
    of 1/8, exact in every dtype, as in the padding test above; GQA (4
    query heads on 2 KV heads) and a ragged L = 37."""
    import math

    from metisfl_tpu_torch.ops.flash_attention import (
        _delta,
        flash_bwd_dq_reference,
        kernel_route,
        pad_head_dim,
    )

    rng = np.random.default_rng(D)
    q, do = (torch.from_numpy(rng.integers(-8, 9, (1, 4, 37, D)) / 8).to(
        dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.integers(-8, 9, (1, 2, 37, D)) / 8).to(
        dtype) for _ in range(2))
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    delta = _delta(o, do)
    Dk = kernel_route("dq", dtype, D).head_dim
    assert Dk == -(-D // 64) * 64 > D
    _, (qp, kp, vp, dop) = pad_head_dim(q, k, v, do, head_dims=(Dk,))
    got = flash_bwd_dq_reference(qp, kp, vp, dop, lse, delta, causal,
                                 1.0 / math.sqrt(D))
    want = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    assert got.shape[-1] == Dk and got.dtype == dtype
    assert torch.equal(got[..., :D], want)
    assert not got[..., D:].any()


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal", [
    (2, 8, 2, 1024, 256, True), (2, 8, 2, 1024, 256, False),
    (2, 4, 4, 256, 256, True), (2, 2, 2, 256, 512, True),
    (1, 4, 4, 512, 512, True), (8, 16, 4, 1024, 256, True),
    (1, 8, 2, 65, 224, True), (1, 4, 1, 517, 608, False),
    (64, 32, 8, 4096, 1024, True)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dkv_split_cuts_the_longest_tile_into_slabs(B, Hq, Hkv, L, D,
                                                    causal, sms):
    """``dkv_split`` is a pure function of the shapes and the card's SM
    count: ``slabs`` slabs of ``per_slab`` q steps cover the longest k
    tile (the first, when causal) and one slab fewer would not; no slab
    is longer than the work of about ``_SPLIT_BLOCKS_PER_SM`` blocks per
    SM needs; a grid that is full already is not split."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _SPLIT_BLOCKS_PER_SM,
        _slab_steps,
        dkv_split,
    )

    steps = _slab_steps(L, Hq // Hkv, causal)
    assert len(steps) == -(-L // 64) and steps[0] == max(steps)
    per_slab, slabs = dkv_split(B, Hq, Hkv, L, D, causal, sms)
    assert (per_slab, slabs) == dkv_split(B, Hq, Hkv, L, D, causal, sms)
    assert per_slab >= 1 and slabs >= 1
    assert per_slab * slabs >= steps[0] > per_slab * (slabs - 1)
    blocks = B * Hkv * 2 * -(-D // 256)
    target = -(-blocks * sum(steps) // (_SPLIT_BLOCKS_PER_SM * sms))
    if slabs == 1:
        assert per_slab == steps[0] <= max(1, target)
    else:
        assert per_slab == max(1, target)


def _split_partials(q, k, v, do, lse, delta, causal, per_slab, slabs):
    """The split fp32 K3's partials, computed the way its blocks cut the
    work (each 64-row k tile's q steps, member-major over the group's query
    heads, then the 64-row q tiles from the diagonal on, in slabs of
    ``per_slab``), with the twin's dense P and dS: (slabs, 2, B, Hkv, L, D),
    dV at 0 and dK at 1, NaN where a tile has no such slab (never read)."""
    from metisfl_tpu_torch.ops.flash_attention import _bwd_probs

    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    part = torch.full((slabs, 2, B, Hkv, L, D), float("nan"))
    nk = -(-L // 64)
    for t in range(nk):
        keys = slice(64 * t, min(L, 64 * t + 64))
        first = t if causal else 0
        per_head = nk - first
        for slab in range(slabs):
            steps = range(slab * per_slab,
                          min(G * per_head, (slab + 1) * per_slab))
            if not steps:
                continue
            dv = torch.zeros(B, Hkv, keys.stop - keys.start, D)
            dk = torch.zeros_like(dv)
            for gi in steps:
                g, qt = divmod(gi, per_head)
                h = torch.arange(Hkv) * G + g  # the q head of each group
                rows = slice(64 * (first + qt), min(L, 64 * (first + qt + 1)))
                pt = p[:, h, rows, keys]
                dst = ds[:, h, rows, keys]
                dv += torch.einsum("bhqk,bhqd->bhkd", pt, do[:, h, rows])
                dk += torch.einsum("bhqk,bhqd->bhkd", dst, q[:, h, rows])
            part[slab, 0, :, :, keys] = dv
            part[slab, 1, :, :, keys] = dk
    return part


@pytest.mark.parametrize("B,Hq,Hkv,L,causal,per_slab", [
    (1, 4, 2, 130, True, 1), (1, 4, 2, 130, False, 2),
    (2, 4, 1, 200, True, 3), (1, 2, 2, 65, True, 1),
    (1, 8, 2, 129, False, 5)])
def test_split_partials_sum_to_the_dkv_twin(B, Hq, Hkv, L, causal,
                                            per_slab):
    """The fp32 K3's split, emulated on the CPU: each slab's partial (the
    blocks' cut of every k tile's q steps) summed by the second launch's
    twin, which reads only the slabs each tile has (the rest hold NaN),
    gives the dK/dV twin: every (query head, q tile) pair of a k tile lies
    in exactly one slab, GQA, ragged L and both masks included."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _delta,
        _slab_steps,
        dkv_split_sum_reference,
        flash_bwd_dkv_reference,
        flash_bwd_dkv_split_sum,
    )

    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(
        B=B, Hq=Hq, Hkv=Hkv, L=L, D=32))
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    delta = _delta(o, do)
    slabs = -(-_slab_steps(L, Hq // Hkv, causal)[0] // per_slab)
    part = _split_partials(q, k, v, do, lse, delta, causal, per_slab, slabs)
    dk, dv = dkv_split_sum_reference(part, Hq // Hkv, causal, per_slab)
    want_dk, want_dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal)
    np.testing.assert_allclose(dk.numpy(), want_dk.numpy(), atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), want_dv.numpy(), atol=ATOL)
    # on CPU tensors the wrapper runs the twin, no launch
    before = flash_bwd_dkv_split_sum.launches
    got = flash_bwd_dkv_split_sum(part, Hq // Hkv, causal, per_slab)
    assert flash_bwd_dkv_split_sum.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (dk, dv)))


@pytest.mark.parametrize("D", [1, 8, 65, 100, 200, 257, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_fp32_forward_padding_is_exact(causal, D):
    """The fp32 K1 runs every D zero-padded to its route's head dim (the
    next multiple of 32, at least 64: 64, 64, 96, 128, 224, 288, 320): the
    padded twin, run with the true D's scale, gives the unpadded twin's o
    and lse to 0 ulp, and 0 in every padded column of o. GQA (4 query heads
    on 2 KV heads), ragged L = 37; inputs are multiples of 1/8, exact in
    fp32, as in the padding test above."""
    import math

    from metisfl_tpu_torch.ops.flash_attention import (
        kernel_route,
        pad_head_dim,
    )

    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.integers(-8, 9, (2, 4, 37, D)) / 8).float()
    k, v = (torch.from_numpy(rng.integers(-8, 9, (2, 2, 37, D)) / 8).float()
            for _ in range(2))
    route = kernel_route("fwd", torch.float32, D)
    assert route.wrapper == "flash_fwd_general"
    assert route.head_dim == max(64, -(-D // 32) * 32) > D
    Dk, (qp, kp, vp) = pad_head_dim(q, k, v, head_dims=(route.head_dim,))
    assert qp.shape[-1] == Dk == route.head_dim
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    op, lsep = flash_attention_fwd_reference(qp, kp, vp, causal,
                                             1.0 / math.sqrt(D))
    assert torch.equal(op[..., :D], o) and torch.equal(lsep, lse)
    assert not op[..., D:].any()


@pytest.mark.parametrize("B,Hq,L,D,causal", [
    (2, 8, 1024, 256, True), (2, 8, 1024, 256, False),
    (2, 4, 256, 256, True), (2, 2, 256, 512, True),
    (1, 4, 512, 512, True), (2, 8, 1000, 128, False),
    (1, 8, 65, 224, True), (1, 4, 517, 608, False),
    (64, 32, 4096, 1024, True)])
@pytest.mark.parametrize("sms", [1, 132])
def test_fwd_split_cuts_the_longest_tile_into_slabs(B, Hq, L, D, causal,
                                                    sms):
    """``fwd_split`` is a pure function of the shapes and the card's SM
    count: ``slabs`` slabs of ``per_slab`` k tiles cover the longest q
    tile (the last, when causal) and one slab fewer would not; a grid
    whose blocks (one per q tile, head and 256-column chunk) fill the card
    is not split; else no slab is longer than the work of about
    ``_SPLIT_BLOCKS_PER_SM`` blocks per SM needs."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _SPLIT_BLOCKS_PER_SM,
        _fwd_slab_steps,
        fwd_split,
    )

    steps = _fwd_slab_steps(L, causal)
    assert len(steps) == -(-L // 64) and steps[-1] == max(steps)
    assert steps == ([t + 1 for t in range(len(steps))] if causal
                     else [len(steps)] * len(steps))
    per_slab, slabs = fwd_split(B, Hq, L, D, causal, sms)
    assert (per_slab, slabs) == fwd_split(B, Hq, L, D, causal, sms)
    assert per_slab >= 1 and slabs >= 1
    assert per_slab * slabs >= steps[-1] > per_slab * (slabs - 1)
    blocks = B * Hq * -(-D // 256)
    target = -(-blocks * sum(steps) // (_SPLIT_BLOCKS_PER_SM * sms))
    fills = blocks * len(steps) >= sms
    if slabs == 1:
        assert per_slab == steps[-1]
        assert fills or per_slab <= max(1, target)
    else:
        assert not fills and per_slab == max(1, target)


# (B, Hq, L, causal) of K1's D = 256 build timed with 64- and 128-row q
# tiles on an H100 (132 SMs; scripts/torch_fwd_rows.py, PERF.md), and the
# rows of the faster: 64-row tiles while they spread the walks over SMs
# that 128-row ones leave idle
_FWD_ROWS_TIMED = [
    (2, 4, 256, True, 64), (2, 4, 256, False, 64),
    (1, 2, 1024, True, 64), (1, 2, 1024, False, 64),
    (1, 4, 1024, True, 64), (1, 4, 1024, False, 64),
    (1, 6, 1024, True, 64), (1, 6, 1024, False, 64),
    (1, 8, 1024, True, 64), (1, 8, 1024, False, 64),
    (1, 9, 1024, True, 64), (1, 9, 1024, False, 128),
    (1, 10, 1024, True, 64), (1, 10, 1024, False, 128),
    (1, 12, 1024, True, 64), (1, 12, 1024, False, 128),
    (2, 8, 1000, True, 64), (2, 8, 1000, False, 128),
    (1, 16, 1024, True, 64), (1, 16, 1024, False, 128),
    (1, 20, 1024, True, 128), (1, 20, 1024, False, 128),
    (2, 16, 1024, True, 128), (2, 16, 1024, False, 128)]


@pytest.mark.parametrize("B,Hq,L,causal,rows", _FWD_ROWS_TIMED)
def test_fwd_rows_picks_the_faster_tile_of_the_d256_build(B, Hq, L, causal,
                                                          rows):
    """``fwd_rows`` on a 132-SM card picks, at each timed shape, the q rows
    that ran faster there; a pure function of its arguments, 64 at every
    other build."""
    from metisfl_tpu_torch.ops.flash_attention import fwd_rows

    assert fwd_rows(B, Hq, L, 256, causal, 132) == rows
    assert fwd_rows.__wrapped__(B, Hq, L, 256, causal, 132) == rows
    for D in (16, 32, 64, 128):
        assert fwd_rows(B, Hq, L, D, causal, 132) == 64


@pytest.mark.parametrize("walks,sms,span", [
    ([3, 3, 3], 2, 6), ([4, 1, 1, 1, 1], 2, 4), ([5, 4, 3, 2, 1], 1, 15),
    ([16] * 132, 132, 16), ([16] * 133, 132, 32), ([2, 2], 8, 2)])
def test_makespan_hands_each_block_to_the_sm_that_frees_first(walks, sms,
                                                              span):
    """``_makespan``: blocks in grid order, each to the SM that frees
    first, one at a time an SM; the grid ends with its busiest SM."""
    from metisfl_tpu_torch.ops.flash_attention import _makespan

    assert _makespan(walks, sms) == span


@pytest.mark.parametrize("B,Hq,L,causal", [
    (4100, 16, 16, True), (1, 65536, 16, False), (64, 32, 4096, True),
    (1, 1, 1, True), (1, 1, 65536, True), (3, 5, 777, False)])
@pytest.mark.parametrize("sms", [1, 132])
def test_fwd_rows_takes_128_rows_where_the_card_is_full(B, Hq, L, causal,
                                                       sms):
    """Past two longest walks of work per SM the 128-row tiles' two
    warpgroups always pay (each K/V tile read once for 128 rows): 128
    without a count; else 64 or 128 by the two grids' makespans."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        fwd_rows,
    )

    steps = _fwd_slab_steps(L, causal)
    rows = fwd_rows(B, Hq, L, 256, causal, sms)
    if B * Hq * sum(steps) > 2 * sms * max(steps):
        assert rows == 128
    else:
        assert rows in (64, 128)


def _fwd_split_partials(q, k, v, causal, per_slab):
    """The split fp32 K1's partials, computed the way its blocks cut the
    work (each 64-row q tile's k tiles, in slabs of ``per_slab``), from the
    twin's dense scores: o_part (slabs, B, Hq, L, D) unnormalised, m_part
    and l_part (slabs, B, Hq, L) each slab's own row max and sum; NaN
    where a q tile has no such slab (never read)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        _repeat_kv,
        _scores,
    )

    B, Hq, L, D = q.shape
    steps = _fwd_slab_steps(L, causal)
    slabs = -(-max(steps) // per_slab)
    s, _ = _scores(q, k, causal)
    vf = _repeat_kv(v, Hq // k.shape[1])
    o_part = torch.full((slabs, B, Hq, L, D), float("nan"))
    m_part = torch.full((slabs, B, Hq, L), float("nan"))
    l_part = torch.full((slabs, B, Hq, L), float("nan"))
    for t, n in enumerate(steps):
        rows = slice(64 * t, min(L, 64 * t + 64))
        for slab in range(-(-n // per_slab)):
            keys = slice(64 * slab * per_slab,
                         min(L, 64 * min(n, (slab + 1) * per_slab)))
            st = s[:, :, rows, keys]
            m = st.amax(dim=-1)
            p = torch.exp(st - m[..., None])  # masked: exp(-1e30 - m) = 0
            m_part[slab, :, :, rows] = m
            l_part[slab, :, :, rows] = p.sum(dim=-1)
            o_part[slab, :, :, rows] = torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vf[:, :, keys])
    return o_part, m_part, l_part


@pytest.mark.parametrize("B,Hq,Hkv,L,causal,per_slab", [
    (1, 4, 2, 130, True, 1), (1, 4, 2, 130, False, 2),
    (2, 4, 1, 200, True, 3), (1, 2, 2, 65, True, 1),
    (1, 8, 2, 129, False, 1)])
def test_fwd_split_partials_combine_to_the_twin(jax_flash, B, Hq, Hkv, L,
                                                causal, per_slab):
    """The fp32 K1's split, emulated on the CPU: each slab's partial (the
    blocks' cut of every q tile's k tiles, each with its own row max)
    merged by the second launch's twin, which reads only the slabs each
    tile has (the rest hold NaN), gives the unsplit twin's o and lse within
    1e-6 × max|o| and max|lse|, and the Pallas forward's (interpret mode)
    within ``ATOL``: GQA, ragged L and both masks included."""
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_fwd_split_combine,
        fwd_split_combine_reference,
    )

    jnp = jax_flash.jnp
    q, k, v = _qkv(B=B, Hq=Hq, Hkv=Hkv, L=L, D=32, seed=L)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    parts = _fwd_split_partials(tq, tk, tv, causal, per_slab)
    o, lse = fwd_split_combine_reference(*parts, causal, per_slab)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    want_o, want_lse = flash_attention_fwd_reference(tq, tk, tv, causal)
    assert float((o - want_o).abs().max()) <= 1e-6 * float(
        want_o.abs().max())
    assert float((lse - want_lse).abs().max()) <= 1e-6 * float(
        want_lse.abs().max())
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        True)
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, Hq, L)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)
    # on CPU tensors the wrapper runs the twin, no launch
    before = flash_fwd_split_combine.launches
    got = flash_fwd_split_combine(*parts, causal, per_slab)
    assert flash_fwd_split_combine.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (o, lse)))


def test_combine_twin_takes_a_slab_with_no_unmasked_key():
    """A slab in which a row has no unmasked key (m = -1e30, l = 0, o = 0)
    adds nothing to that row, and a row with no unmasked key in any slab
    comes out as o = 0 (not nan) with lse = -1e30 + log(1e-30), as in the
    unsplit kernel."""
    from metisfl_tpu_torch.ops.flash_attention import (
        fwd_split_combine_reference,
    )

    rng = np.random.default_rng(3)
    o_part = torch.from_numpy(rng.standard_normal((2, 1, 1, 70, 8)).astype(
        np.float32))
    m_part = torch.from_numpy(rng.standard_normal((2, 1, 1, 70)).astype(
        np.float32))
    l_part = torch.from_numpy(rng.uniform(1, 64, (2, 1, 1, 70)).astype(
        np.float32))
    # rows 0 and 1: slab 1 sees no key; row 1: slab 0 neither
    o_part[1, ..., :2, :] = 0.0
    m_part[1, ..., :2] = -1e30
    l_part[1, ..., :2] = 0.0
    o_part[0, ..., 1, :] = 0.0
    m_part[0, ..., 1] = -1e30
    l_part[0, ..., 1] = 0.0
    o, lse = fwd_split_combine_reference(o_part, m_part, l_part, False, 1)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(o[..., 0, :], o_part[0, ..., 0, :]
                               / l_part[0, ..., 0, None], rtol=1e-6, atol=0)
    torch.testing.assert_close(
        lse[..., 0], m_part[0, ..., 0] + torch.log(l_part[0, ..., 0]),
        rtol=1e-6, atol=0)
    assert not o[..., 1, :].any()
    assert float(lse[..., 1]) == float(torch.tensor(-1e30) + torch.log(
        torch.tensor(1e-30)))


@pytest.mark.parametrize("B,Hq,L,D,causal", [
    (2, 8, 1024, 256, True), (2, 8, 1024, 256, False),
    (2, 4, 256, 256, True), (2, 2, 256, 512, True),
    (1, 4, 512, 512, True), (2, 8, 1000, 128, False),
    (1, 8, 65, 224, True), (1, 4, 517, 608, False),
    (64, 32, 4096, 1024, True)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dq_split_cuts_the_longest_tile_into_slabs(B, Hq, L, D, causal,
                                                   sms):
    """``dq_split`` is a pure function of the shapes and the card's SM
    count: ``slabs`` slabs of ``per_slab`` k tiles cover the longest q
    tile (the last, when causal) and one slab fewer would not; a grid
    whose blocks (one per q tile, head and 256-column chunk) fill the card
    is not split; else no slab is longer than the work of about
    ``_SPLIT_BLOCKS_PER_SM`` blocks per SM needs. K2's q tiles walk the k
    tiles of K1's, so the two splits agree."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _SPLIT_BLOCKS_PER_SM,
        _fwd_slab_steps,
        dq_split,
        fwd_split,
    )

    steps = _fwd_slab_steps(L, causal)
    per_slab, slabs = dq_split(B, Hq, L, D, causal, sms)
    assert (per_slab, slabs) == dq_split(B, Hq, L, D, causal, sms)
    assert (per_slab, slabs) == fwd_split(B, Hq, L, D, causal, sms)
    assert per_slab >= 1 and slabs >= 1
    assert per_slab * slabs >= steps[-1] > per_slab * (slabs - 1)
    blocks = B * Hq * -(-D // 256)
    target = -(-blocks * sum(steps) // (_SPLIT_BLOCKS_PER_SM * sms))
    fills = blocks * len(steps) >= sms
    if slabs == 1:
        assert per_slab == steps[-1]
        assert fills or per_slab <= max(1, target)
    else:
        assert not fills and per_slab == max(1, target)


def _dq_split_partials(q, k, v, do, lse, delta, causal, per_slab):
    """The split fp32 K2's partials, computed the way its blocks cut the
    work (each 64-row q tile's k tiles, in slabs of ``per_slab``), with the
    twin's dense dS: (slabs, B, Hq, L, D), NaN where a q tile has no such
    slab (never read)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _bwd_probs,
        _fwd_slab_steps,
        _repeat_kv,
    )

    B, Hq, L, D = q.shape
    steps = _fwd_slab_steps(L, causal)
    slabs = -(-max(steps) // per_slab)
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    kf = _repeat_kv(k, Hq // k.shape[1])
    part = torch.full((slabs, B, Hq, L, D), float("nan"))
    for t, n in enumerate(steps):
        rows = slice(64 * t, min(L, 64 * t + 64))
        for slab in range(-(-n // per_slab)):
            keys = slice(64 * slab * per_slab,
                         min(L, 64 * min(n, (slab + 1) * per_slab)))
            part[slab, :, :, rows] = torch.einsum(
                "bhqk,bhkd->bhqd", ds[:, :, rows, keys], kf[:, :, keys])
    return part


@pytest.mark.parametrize("B,Hq,Hkv,L,causal,per_slab", [
    (1, 4, 2, 130, True, 1), (1, 4, 2, 130, False, 2),
    (2, 4, 1, 200, True, 3), (1, 2, 2, 65, True, 1),
    (1, 8, 2, 129, False, 1)])
def test_dq_split_partials_sum_to_the_twin(jax_flash, B, Hq, Hkv, L, causal,
                                           per_slab):
    """The fp32 K2's split, emulated on the CPU: each slab's partial (the
    blocks' cut of every q tile's k tiles) summed by the second launch's
    twin, which reads only the slabs each tile has (the rest hold NaN),
    gives the unsplit twin's dQ within 1e-6 × max|dQ| and the Pallas
    ``_dq_kernel``'s (interpret mode) within ``ATOL``: GQA, ragged L and
    both masks included."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _delta,
        dq_split_sum_reference,
        flash_bwd_dq_reference,
        flash_bwd_dq_split_sum,
    )

    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs(seed=L, B=B, Hq=Hq, Hkv=Hkv, L=L, D=32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_reference(tq, tk, tv, causal)
    delta = _delta(o, tdo)
    part = _dq_split_partials(tq, tk, tv, tdo, lse, delta, causal, per_slab)
    dq = dq_split_sum_reference(part, causal, per_slab)
    assert bool(torch.isfinite(dq).all())
    want = flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, causal)
    assert float((dq - want).abs().max()) <= 1e-6 * float(want.abs().max())
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        True)
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, Hq, L)
    dq_ref = jax_flash._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_ref, lse_ref,
        jnp.asarray(do), causal, None, None, True)[0]
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=ATOL)
    # on CPU tensors the wrapper runs the twin, no launch
    before = flash_bwd_dq_split_sum.launches
    got = flash_bwd_dq_split_sum(part, causal, per_slab)
    assert flash_bwd_dq_split_sum.launches == before
    assert torch.equal(got, dq)


def test_dq_sum_twin_reads_no_slab_a_causal_tile_lacks():
    """With causal masking the first q tile has one k tile, so one slab:
    its rows are the first slab's, whatever the others hold (NaN here);
    the last tile's rows add every slab in slab order."""
    from metisfl_tpu_torch.ops.flash_attention import dq_split_sum_reference

    rng = np.random.default_rng(4)
    part = torch.from_numpy(rng.standard_normal((3, 1, 2, 150, 8)).astype(
        np.float32))
    part[1:, :, :, :64] = float("nan")  # tile 0: one k tile, one slab
    part[2:, :, :, 64:128] = float("nan")  # tile 1: two k tiles, two slabs
    dq = dq_split_sum_reference(part, True, 1)
    assert bool(torch.isfinite(dq).all())
    assert torch.equal(dq[..., :64, :], part[0, ..., :64, :])
    assert torch.equal(dq[..., 64:128, :],
                       part[0, ..., 64:128, :] + part[1, ..., 64:128, :])
    assert torch.equal(dq[..., 128:, :], part[0, ..., 128:, :]
                       + part[1, ..., 128:, :] + part[2, ..., 128:, :])


def test_kernel_head_dims_need_no_copy():
    from metisfl_tpu_torch.ops.flash_attention import (
        _FWD_HEAD_DIMS,
        pad_head_dim,
    )

    for D in (16, 32, 64, 128, 256):
        q = torch.zeros(1, 2, 8, D)
        Dk, (same,) = pad_head_dim(q, head_dims=_FWD_HEAD_DIMS)
        assert Dk == D and same is q


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_small_head_dims_read_in_place_while_k2_pads(dtype):
    """``zero_pads`` is a pure function of (kernel, dtype, D), as
    ``kernel_route`` is: K1, K2 and K3 run a D <= 32 that is a multiple of
    8 on their D = 16 and 32 builds without a padded copy (the builds
    zero-fill the rest of their columns in shared memory); a D that is not
    a multiple of 8 (rows that are not 16-byte multiples) pads for all
    three, fp32 pads to its register-tiled kernels' 64, and a built head
    dim makes no copy."""
    from metisfl_tpu_torch.ops.flash_attention import (
        kernel_route,
        zero_pads,
    )

    for D in (8, 16, 24, 32):
        for kernel in ("fwd", "dq", "dkv"):
            assert not zero_pads(kernel, dtype, D)
            assert kernel_route(kernel, dtype, D).head_dim == (
                16 if D <= 16 else 32)
    for D in (1, 4, 12, 20, 31, 40, 100):
        assert all(zero_pads(kernel, dtype, D)
                   for kernel in ("fwd", "dq", "dkv"))
    for D in (64, 128, 256):
        assert not any(zero_pads(kernel, dtype, D)
                       for kernel in ("fwd", "dq", "dkv"))
    for D in (8, 16, 32):
        assert all(zero_pads(kernel, torch.float32, D)
                   for kernel in ("fwd", "dq", "dkv"))


@pytest.mark.parametrize("B,Hq,Hkv,L,causal", [
    (4, 4, 4, 512, True), (2, 16, 4, 1024, True), (2, 16, 4, 1024, False),
    (2, 8, 2, 1000, False), (64, 4, 4, 128, True), (1, 8, 2, 1000, True)])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("D", [16, 32, 256])
def test_dkv_mma_split_cuts_the_longest_walk_into_slabs(D, B, Hq, Hkv, L,
                                                        causal, sms):
    """The tensor-core K3's split at its D = 16, 32 and 256 builds, a pure
    function of the shape, the build and the SM count: ``per_slab`` q
    steps a slab (a 64-row q tile of one query head of the group),
    ``slabs`` the longest k tile's count, so that every k tile's walk
    (``_slab_steps``) is covered and no slab is empty at the longest tile,
    and no slab shorter than ``_MMA_MIN_SLAB_STEPS``; one slab, as long as
    that walk, where the grid already holds the work (one SM, or many
    heads at a short L) or the walk is no longer than the shortest slab.
    The build sets the blocks' work per SM it aims at
    (``_MMA_SPLIT_BLOCKS_PER_SM``: several small blocks share an SM at D
    <= 32, one takes it at 256)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _MMA_MIN_SLAB_STEPS,
        _MMA_SPLIT_BLOCKS_PER_SM,
        _slab_steps,
        dkv_mma_split,
    )

    steps = _slab_steps(L, Hq // Hkv, causal)
    per_slab, slabs = dkv_mma_split(B, Hq, Hkv, L, D, causal, sms)
    assert per_slab * slabs >= steps[0] > per_slab * (slabs - 1)
    assert max(steps) == steps[0]
    work, target = B * Hkv * sum(steps), _MMA_SPLIT_BLOCKS_PER_SM[D] * sms
    if slabs == 1:
        assert per_slab == steps[0]
        assert (work > target * (steps[0] - 1)
                or steps[0] <= _MMA_MIN_SLAB_STEPS)
    else:
        # the least per_slab, down to the shortest slab, that keeps to the
        # target's blocks of work per SM
        assert per_slab >= _MMA_MIN_SLAB_STEPS
        assert per_slab * target >= work
        assert (work > (per_slab - 1) * target
                or per_slab == _MMA_MIN_SLAB_STEPS)
    assert dkv_mma_split(B, Hq, Hkv, L, D, causal, sms) == (per_slab,
                                                            slabs)


def test_head_dims_beyond_the_kernels_are_refused_with_their_reason():
    """No head dim that the Pallas kernels take is refused on the card any
    more: each D goes to a tuned kernel (padded to its next built head dim:
    K1, K2 and K3 16/32/64/128/256 in bf16/fp16; none in fp32, whose
    register-tiled kernels take every D) or, beyond the largest, to the
    general kernel. The input check runs before any launch, so it is
    reachable on the CPU; it still refuses a head dim of 0, and takes
    65536 query heads, past the 65535 of a grid's y axis, since every
    kernel runs on a 1-D grid."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _FWD_HEAD_DIMS,
        _check_cuda_inputs,
        bwd_head_dims,
        kernel_head_dim,
    )

    for D, fwd, dq16, dkv16 in ((1, 16, 16, 16), (129, 256, 256, 256),
                                (256, 256, 256, 256),
                                (257, None, None, None),
                                (512, None, None, None)):
        q = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
        _check_cuda_inputs(q, q, q)
        _check_cuda_inputs(q, q, q, do=q)
        assert kernel_head_dim(D, _FWD_HEAD_DIMS) == fwd
        for dtype in (torch.bfloat16, torch.float16):
            assert kernel_head_dim(D, bwd_head_dims(dtype, "dq")) == dq16
            assert kernel_head_dim(D, bwd_head_dims(dtype, "dkv")) == dkv16
        for kernel in ("dq", "dkv"):
            assert kernel_head_dim(D, bwd_head_dims(torch.float32,
                                                    kernel)) is None
    q = torch.zeros(1, 2, 8, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        _check_cuda_inputs(q, q, q)
    q = torch.zeros(1, 65536, 1, 64, dtype=torch.bfloat16)
    _check_cuda_inputs(q, q, q)
    q = torch.zeros(0, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        _check_cuda_inputs(q, q, q)


@pytest.mark.parametrize("B,H", [(1, 16), (4096, 16), (4097, 16),
                                 (70000, 1), (3, 65535), (10, 40000)])
def test_cuda_input_check_takes_any_batch_and_head_count(B, H):
    """Every kernel carries b * H on its 1-D grid, so the input check takes
    any (B, H), those past gridDim.y's 65535 included, for K1's and K2/K3's
    inputs, with GQA; the tensors lie on ``meta`` (no memory)."""
    from metisfl_tpu_torch.ops.flash_attention import _check_cuda_inputs

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.empty(B, H, 1, 1, dtype=dtype, device="meta")
        kv = torch.empty(B, 1, 1, 1, dtype=dtype, device="meta")
        _check_cuda_inputs(q, q, q)
        _check_cuda_inputs(q, kv, kv, do=q)


# (dtype, causal, B, Hq, Hkv, L, D): padded head dims, the
# examples/long_context.py shape (D = 16), and B·Hq above gridDim.y's 65535
_PADDED_GPU_CASES = [
    (dtype, causal, 2, 8, 2, L, D)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for causal in (False, True)
    for D in (8, 16, 32)
    for L in (65, 200)
] + [
    (torch.bfloat16, True, 4, 4, 4, 512, 16),
    (torch.bfloat16, True, 4100, 16, 4, 16, 64),
    (torch.float32, False, 4100, 16, 4, 16, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _PADDED_GPU_CASES)
def test_kernels_at_padded_head_dims_and_large_grids_on_gpu(
        cuda_device, dtype, causal, B, Hq, Hkv, L, D):
    """K1, K2 and K3 at small head dims (in bf16/fp16 on their D = 16 and
    32 builds, K3 with its split sum where it splits; all padded to 64 in
    fp32) and at B·Hq > 65535 (every kernel on a
    1-D grid: one launch each, the fp32 kernels with their combine or sum
    where they split) against their twins on the card, at the tolerances
    of the unpadded cases."""
    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(cuda_device, dtype, B,
                                                   Hq, Hkv, L, D, causal)
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    assert _launched(before) == _expected_launches(cuda_device, dtype, B,
                                                   Hq, Hkv, L, D, causal)
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


# (dtype, causal, B, Hq, Hkv, L, D): K1's, K2's and K3's D = 16 and 32
# builds in bf16/fp16, D a multiple of 8 read in place (8, 16, 24, 32) and
# D = 12 padded to 16, GQA Hq8·Hkv2 at a ragged L = 77 and L = 1000 (K3's walks
# split into slabs), and many heads at a short L (B64·Hq4·L128: one slab)
_SMALL_D_GPU_CASES = [
    (dtype, causal, 2, 8, 2, L, D)
    for dtype in (torch.bfloat16, torch.float16)
    for causal in (False, True)
    for D in (8, 12, 16, 24, 32)
    for L in (77, 1000)
] + [(torch.bfloat16, True, 64, 4, 4, 128, 16),
     (torch.float16, False, 64, 4, 4, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _SMALL_D_GPU_CASES)
def test_small_head_dim_builds_match_twins_on_gpu(cuda_device, dtype, causal,
                                                  B, Hq, Hkv, L, D):
    """K1, K2 and K3 on their D = 16 and 32 builds against their twins on
    the card, at the tolerances of the built head
    dims: o within ``_FWD_ATOL``, lse within 1e-3, dq, dk, dv within
    ``_BWD_REL`` × max|twin|. Each call launches what its route names (K3
    its split sum where ``dkv_mma_split`` splits), and two runs give the
    same bits: the split's slabs are summed in a fixed order."""
    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(cuda_device, dtype, B,
                                                   Hq, Hkv, L, D, causal)
    before = _launch_counts()
    runs = [(flash_attention_fwd(q, k, v, causal),
             flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    once = _expected_launches(cuda_device, dtype, B, Hq, Hkv, L, D, causal)
    assert once.get("flash_bwd_dkv") == 1 and "flash_attention_fwd" in once
    assert _launched(before) == {n: 2 * c for n, c in once.items()}
    (o, lse), got = runs[0]
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert a.is_contiguous(), name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _BWD_REL[dtype] * scale, (name, err, scale)
    (o2, lse2), got2 = runs[1]
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(got, got2):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [8, 16, 24, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_k2_small_head_dim_builds_match_twin_on_gpu(cuda_device, causal, D,
                                                    dtype):
    """K2 on its D = 16 and 32 builds, reading D = 8, 16, 24 and 32 in
    place, against its twin on the card at GQA B2·Hq8·Hkv2 and a ragged
    L = 1000: one launch of ``flash_bwd_dq`` and nothing else (no pad, no
    copy, no second launch), dq within ``_BWD_REL`` × max|twin|, and two
    runs give the same bits."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dq_reference

    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, 2, 8, 2, 1000,
                                           D, causal)
    delta = (do.float() * o.float()).sum(-1)
    before = _launch_counts()
    first = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    second = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_bwd_dq": 2}
    assert first.shape == q.shape and first.is_contiguous()
    want = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    scale = float(want.float().abs().max())
    err = float((first.float() - want.float()).abs().max())
    assert err <= _BWD_REL[dtype] * scale, (err, scale)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", [77, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_k3_d256_build_matches_twin_on_gpu(cuda_device, causal, L, dtype):
    """K3's D = 256 build (two warpgroups: dV and dK of a k tile in one
    pass) against its twin on the card at GQA B2·Hq8·Hkv2 and a ragged L:
    one launch of ``flash_bwd_dkv`` a call, and its split sum where
    ``dkv_mma_split`` cuts the walks; dk and dv within ``_BWD_REL`` ×
    max|twin|, and two runs give the same bits."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dkv_reference

    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, 2, 8, 2, L,
                                           256, causal)
    delta = (do.float() * o.float()).sum(-1)
    before = _launch_counts()
    first = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    second = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    once = _expected_launches(cuda_device, dtype, 2, 8, 2, L, 256, causal,
                              fwd=False)
    once.pop("flash_bwd_dq")
    assert once.get("flash_bwd_dkv") == 1
    assert _launched(before) == {n: 2 * c for n, c in once.items()}
    want = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    for name, a, b in zip(("dk", "dv"), first, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _BWD_REL[dtype] * scale, (name, err, scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (Hq, Hkv) and L of the D = 256 builds of K1 and K2 on the card: a group
# of 4 and none; one row, the edges of a 64-row warpgroup's rows and of
# K1's 128-row q tile (warpgroup 1 of the last tile with no row, one, or
# all), and a ragged many
_D256_GPU_HEADS = [(8, 2), (4, 4)]
_D256_GPU_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", _D256_GPU_LENGTHS)
@pytest.mark.parametrize("Hq,Hkv", _D256_GPU_HEADS)
@pytest.mark.parametrize("B", [2, 40])
@pytest.mark.parametrize("causal", [False, True])
def test_k1_d256_build_matches_twin_on_gpu(cuda_device, monkeypatch, causal,
                                           B, Hq, Hkv, L, dtype, rows):
    """K1's D = 256 build against its twin on the card, in each of its
    modes: 128-row q tiles (two warpgroups) and 64-row ones (warpgroup 1
    idle), set through ``fwd_rows``, which the wrapper asks with the shape
    and the card's SM count. One launch of ``flash_attention_fwd`` a call
    and nothing else, o within ``_FWD_ATOL``, lse within 1e-3, and two runs
    give the same bits."""
    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    asked = []

    def forced(*args):
        asked.append(args)
        return rows

    monkeypatch.setattr(fa, "fwd_rows", forced)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    q, k, v, o_ref, lse_ref, _ = _cuda_bwd_inputs(cuda_device, dtype, B, Hq,
                                                  Hkv, L, 256, causal)
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    o2, lse2 = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert asked == [(B, Hq, L, 256, causal, sms)] * 2
    assert _launched(before) == {"flash_attention_fwd": 2}
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", _D256_GPU_LENGTHS)
@pytest.mark.parametrize("Hq,Hkv", _D256_GPU_HEADS)
@pytest.mark.parametrize("causal", [False, True])
def test_k2_d256_build_matches_twin_on_gpu(cuda_device, causal, Hq, Hkv, L,
                                           dtype):
    """K2's D = 256 build (two warpgroups, dQ split by columns, P and dS
    handed between them in fp32) against its twin on the card at B2: one
    launch of ``flash_bwd_dq`` a call and nothing else, dq within
    ``_BWD_REL`` × max|twin|, and two runs give the same bits. δ is drawn
    apart from O (as in ``_BWD_GPU_CASES``), so that dP − δ is no
    cancellation noise where a row sees one key."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dq_reference

    q, k, v, _, lse, do = _cuda_bwd_inputs(cuda_device, dtype, 2, Hq, Hkv,
                                           L, 256, causal)
    delta = torch.from_numpy(np.random.default_rng(9).standard_normal(
        lse.shape).astype(np.float32)).to(cuda_device)
    before = _launch_counts()
    first = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    second = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_bwd_dq": 2}
    assert first.dtype == dtype and first.shape == q.shape
    want = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    scale = float(want.float().abs().max())
    err = float((first.float() - want.float()).abs().max())
    assert err <= _BWD_REL[dtype] * scale, (err, scale)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_d256_builds_at_65536_query_heads_on_gpu(cuda_device, dtype):
    """K1 and K2 on their D = 256 builds at B1·Hq65536·Hkv16384·L16, past
    gridDim.y's 65535 on their 1-D grids: one launch each, within their
    twins' tolerances."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dq_reference

    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(
        cuda_device, dtype, 1, 65536, 16384, 16, 256, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, True)
    dq = flash_bwd_dq(q, k, v, do, lse_ref, delta, True)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_attention_fwd": 1, "flash_bwd_dq": 1}
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    want = flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, True)
    scale = float(want.float().abs().max())
    err = float((dq.float() - want.float()).abs().max())
    assert err <= _BWD_REL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24])
def test_k2_small_head_dim_builds_refuse_misaligned_views_on_gpu(
        cuda_device, D):
    """A misaligned q or do never reaches K2's D = 16 and 32 builds, which
    read the caller's rows in place: the wrapper raises before a launch."""
    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 1,
                                           4, 2, 65, D, True)
    delta = (do.float() * o.float()).sum(-1)
    before = flash_bwd_dq.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dq(_misaligned(q), k, v, do, lse, delta, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dq(q, k, v, _misaligned(do), lse, delta, True)
    assert flash_bwd_dq.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("D,ld", [(32, 0), (32, 4), (32, 12), (32, 40),
                                  (16, 24), (64, 72), (64, 32), (128, 64)])
def test_dq_entry_refuses_a_bad_row_length_on_gpu(cuda_device, D, ld):
    """``metisfl_flash_bwd_dq`` takes the caller's row length ld beside the
    build D and returns -1, launching nothing, for an ld outside 8..D or
    not a multiple of 8 (as ``metisfl_flash_bwd_dkv`` does), and for an ld
    other than D at the builds from 64, which read rows of D; its pointers
    are never read."""
    from metisfl_tpu_torch.ops.flash_attention import _DTYPE_CODES, _library

    lib = _library("flash_bwd")
    err = lib.metisfl_flash_bwd_dq(
        None, None, None, None, None, None, None, 1, 4, 2, 64, D, ld,
        _DTYPE_CODES[torch.bfloat16], 1, 0.25, None)
    assert err == -1
    if 8 <= ld <= D and ld % 8 == 0:
        return  # K3's builds take rows shorter than D at every D
    err = lib.metisfl_flash_bwd_dkv(
        None, None, None, None, None, None, None, None, None, 1, 4, 2, 64,
        D, ld, _DTYPE_CODES[torch.bfloat16], 1, 1, 1, 0.25, None)
    assert err == -1


@pytest.mark.cuda
@pytest.mark.parametrize("D,rows", [(256, 0), (256, 32), (256, 96),
                                    (256, 256), (128, 128), (64, 128),
                                    (16, 128)])
def test_fwd_entry_refuses_rows_a_build_lacks_on_gpu(cuda_device, D, rows):
    """``metisfl_flash_fwd`` takes the q rows of a block: 64 at every
    build, 128 at the D = 256 build alone; any other returns -1, launching
    nothing (its pointers are never read)."""
    from metisfl_tpu_torch.ops.flash_attention import _DTYPE_CODES, _library

    err = _library("flash_fwd").metisfl_flash_fwd(
        None, None, None, None, None, 1, 4, 2, 64, D, D, rows,
        _DTYPE_CODES[torch.bfloat16], 1, 0.25, None)
    assert err == -1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,group,per_slab", [
    (True, 4, 9), (False, 4, 5), (True, 1, 2)])
def test_split_sum_kernel_rounds_to_16_bits_on_gpu(cuda_device, dtype,
                                                   causal, group, per_slab):
    """The split sum into bf16/fp16 outputs (the tensor-core K3's second
    launch at D <= 32) against its twin rounded to the same dtype, on
    random partials (B2·Hkv2·L1000·D24): the same fp32 sums in the same
    slab order, rounded to nearest once, so bit for bit, reading no slab a
    tile lacks (those hold NaN)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _slab_steps,
        dkv_split_sum_reference,
        flash_bwd_dkv_split_sum,
    )

    L = 1000
    counts = [-(-n // per_slab) for n in _slab_steps(L, group, causal)]
    part = torch.from_numpy(np.random.default_rng(per_slab).standard_normal(
        (counts[0], 2, 2, 2, L, 24)).astype(np.float32))
    for t, n in enumerate(counts):
        part[n:, :, :, :, 64 * t:64 * t + 64] = float("nan")
    part = part.to(cuda_device)
    out = tuple(torch.empty(part.shape[2:], dtype=dtype, device=cuda_device)
                for _ in range(2))
    before = flash_bwd_dkv_split_sum.launches
    got = flash_bwd_dkv_split_sum(part, group, causal, per_slab, out=out)
    torch.cuda.synchronize()
    assert flash_bwd_dkv_split_sum.launches == before + 1
    want = dkv_split_sum_reference(part, group, causal, per_slab)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b.to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,pads", [(D, True) for D in range(1, 8)] + [
    (8, False), (12, True), (16, False), (24, False), (32, False),
    (40, True)])
def test_k2_reads_small_head_dims_in_place(dtype, D, pads):
    """K2's D = 16 and 32 builds read a D that is a multiple of 8 (16-byte
    rows) in place, as K1's and K3's do: ``zero_pads("dq", ...)`` is False
    at D = 8, 16, 24 and 32, and True at 1-7 and 12 (rows that are not
    16-byte multiples, padded to the 16 build) and 40 (padded to 64)."""
    from metisfl_tpu_torch.ops.flash_attention import kernel_route, zero_pads

    assert zero_pads("dq", dtype, D) is pads
    assert kernel_route("dq", dtype, D).head_dim == next(
        d for d in (16, 32, 64) if D <= d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [8, 16, 24, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_k2_twin_at_small_head_dims_matches_pallas_dq(jax_flash, causal, D,
                                                      dtype):
    """The K2 twin, which the card's D = 16 and 32 builds are held to,
    gives the Pallas backward's dq (``_dq_kernel`` in interpret mode) at
    D = 8, 16, 24 and 32, GQA B1·Hq4·Hkv2 at a ragged L = 1000, from the
    Pallas forward's o and lse: within ``BF16_BWD_REL`` (fp16
    ``FP16_BWD_REL``) × max|ref|, the bf16 and fp16 twin tests'
    tolerances (both round dS before dS·K, summed in other orders)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _delta,
        flash_bwd_dq_reference,
    )

    jnp = jax_flash.jnp
    q, k, v, do = _bwd_inputs(L=1000, D=D)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_ref, lse_ref = jax_flash._flash_forward(jq, jk, jv, causal, None,
                                              None, True)
    B, H, L, _ = q.shape
    lse_ref = np.asarray(lse_ref)[:, :L, 0].reshape(B, H, L)
    want = np.asarray(jax_flash._flash_backward(
        jq, jk, jv, o_ref, lse_ref, jdo, causal, None, None,
        True)[0].astype(jnp.float32))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o = torch.from_numpy(np.array(o_ref.astype(jnp.float32))).to(dtype)
    got = flash_bwd_dq_reference(tq, tk, tv, tdo,
                                 torch.from_numpy(np.array(lse_ref)),
                                 _delta(o, tdo), causal)
    assert got.shape == tq.shape and got.dtype == dtype
    rel = BF16_BWD_REL if dtype == torch.bfloat16 else FP16_BWD_REL
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=rel * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("B,Hq,Hkv,L,causal", [
    (2, 16, 4, 1024, True), (2, 16, 4, 1024, False), (1, 8, 2, 1000, True),
    (2, 8, 2, 300, True), (1, 4, 1, 517, False), (2, 4, 4, 256, True)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dkv_mma_split_at_256_covers_every_step_once(B, Hq, Hkv, L, causal,
                                                     sms):
    """K3's D = 256 build cut as its blocks cut the work: block (k tile t,
    slab s) walks steps [s·per_slab, min(steps_t, (s + 1)·per_slab)) of
    the tile's walk over the group's query heads and 64-row q tiles
    (``_slab_steps``), and exits at once where that is empty. Every step of
    every tile lies in exactly one block, each tile has at least one
    non-empty slab, ``slabs`` >= 1, and the split sum reads exactly the
    slabs each tile has (``ceil(steps_t / per_slab)``)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _slab_steps,
        dkv_mma_split,
    )

    per_slab, slabs = dkv_mma_split(B, Hq, Hkv, L, 256, causal, sms)
    assert per_slab >= 1 and slabs >= 1
    for steps in _slab_steps(L, Hq // Hkv, causal):
        seen = []
        for slab in range(slabs):
            seen += range(slab * per_slab, min(steps, (slab + 1) * per_slab))
        assert sorted(seen) == list(range(steps))
        nonempty = sum(slab * per_slab < steps for slab in range(slabs))
        assert nonempty == -(-steps // per_slab) >= 1


def test_split_sum_twin_rounds_into_a_16_bit_out():
    """On the CPU the split sum runs its twin and, given bf16 outputs,
    rounds the fp32 sums into them, as the kernel does."""
    from metisfl_tpu_torch.ops.flash_attention import (
        dkv_split_sum_reference,
        flash_bwd_dkv_split_sum,
    )

    part = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 2, 1, 2, 130, 16)).astype(np.float32))
    out = tuple(torch.empty(part.shape[2:], dtype=torch.bfloat16)
                for _ in range(2))
    got = flash_bwd_dkv_split_sum(part, 2, True, 2, out=out)
    want = dkv_split_sum_reference(part, 2, True, 2)
    assert got[0] is out[0] and got[1] is out[1]
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(torch.bfloat16))


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
        flash_bwd_dkv_general_mma,
        flash_bwd_dkv_split_sum,
        flash_bwd_dq_general,
        flash_bwd_dq_general_mma,
        flash_bwd_dq_split_sum,
        flash_fwd_general,
        flash_fwd_general_mma,
        flash_fwd_split_combine,
    )

    return {fn.__name__: fn.launches for fn in (
        flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_general,
        flash_bwd_dq_general, flash_bwd_dkv_general, flash_fwd_general_mma,
        flash_bwd_dkv_general_mma, flash_bwd_dq_general_mma,
        flash_bwd_dkv_split_sum, flash_fwd_split_combine,
        flash_bwd_dq_split_sum)}


def _launched(before):
    """The launches each wrapper counted since ``before``, where any."""
    after = _launch_counts()
    return {n: after[n] - before[n] for n in after if after[n] - before[n]}


def _expected_launches(device, dtype, B, Hq, Hkv, L, D, causal, fwd=True,
                       bwd=True):
    """The launches one K1 call (``fwd``) and one K2 and K3 call (``bwd``)
    make at these shapes on ``device``, by ``kernel_route``: one each, and
    the fp32 kernels' combine and split sums where they split, and K3's at
    its D = 16, 32 and 256 builds."""
    from metisfl_tpu_torch.ops.flash_attention import kernel_route

    want = {}
    for kernel in ("fwd",) * fwd + ("dq", "dkv") * bwd:
        want[kernel_route(kernel, dtype, D).wrapper] = 1
    if dtype == torch.float32:
        if fwd and _combine_launches(device, dtype, B, Hq, L, D, causal):
            want["flash_fwd_split_combine"] = 1
        if bwd and _dq_split_launches(device, B, Hq, L, D, causal):
            want["flash_bwd_dq_split_sum"] = 1
        if bwd and _split_launches(device, B, Hq, Hkv, L, D, causal):
            want["flash_bwd_dkv_split_sum"] = 1
    elif bwd and _mma_split_launches(device, dtype, B, Hq, Hkv, L, D, causal):
        want["flash_bwd_dkv_split_sum"] = 1
    return want


def _mma_split_launches(device, dtype, B, Hq, Hkv, L, D, causal):
    """1 where the tensor-core K3 runs a D = 16, 32 or 256 build and splits
    its walks at these shapes on ``device`` (and so launches its sum),
    else 0."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _MMA_SPLIT_BLOCKS_PER_SM,
        dkv_mma_split,
        kernel_route,
    )

    route = kernel_route("dkv", dtype, D)
    if (route.wrapper != "flash_bwd_dkv"
            or route.head_dim not in _MMA_SPLIT_BLOCKS_PER_SM):
        return 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return int(dkv_mma_split(B, Hq, Hkv, L, route.head_dim, causal,
                             sms)[1] > 1)


def _fwd_split_at(device, B, Hq, L, D, causal):
    """``(per_slab, slabs)`` of the fp32 K1 at these shapes on
    ``device``."""
    from metisfl_tpu_torch.ops.flash_attention import f32_head_dim, fwd_split

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return fwd_split(B, Hq, L, f32_head_dim(D), causal, sms)


def _combine_launches(device, dtype, B, Hq, L, D, causal):
    """1 where the fp32 K1 splits its q tiles at these shapes on
    ``device`` (and so launches its combine), else 0."""
    return int(dtype == torch.float32 and _fwd_split_at(
        device, B, Hq, L, D, causal)[1] > 1)


def _dq_split_launches(device, B, Hq, L, D, causal):
    """1 where the fp32 K2 splits its q tiles at these shapes on
    ``device`` (and so launches its sum), else 0."""
    from metisfl_tpu_torch.ops.flash_attention import dq_split, f32_head_dim

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return int(dq_split(B, Hq, L, f32_head_dim(D), causal, sms)[1] > 1)


def _split_launches(device, B, Hq, Hkv, L, D, causal):
    """1 where the fp32 K3 splits its k tiles at these shapes on
    ``device`` (and so launches its sum), else 0."""
    from metisfl_tpu_torch.ops.flash_attention import (
        f32_head_dim,
        dkv_split,
    )

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return int(dkv_split(B, Hq, Hkv, L, f32_head_dim(D), causal,
                         sms)[1] > 1)


def _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D, device,
                          delta=None):
    """K1, then K2 and K3 through flash_attention_bwd (with ``delta`` where
    given, else δ from O), against their twins at the unpadded cases'
    tolerances; returns the launches each wrapper counted."""
    q, k, v, o_ref, lse_ref, do = _cuda_bwd_inputs(device, dtype, B, Hq,
                                                   Hkv, L, D, causal)
    before = _launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal,
                              delta=delta)
    torch.cuda.synchronize()
    after = _launch_counts()
    lse_atol = 1e-4 if dtype == torch.float32 else 1e-3
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=_FWD_ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_atol, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal,
                                         delta=delta)
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
    """K1 against its twin at D = 256 and D = 200 (padded to 256 in
    bf16/fp16, to 224 in fp32), one launch; the backward runs too: in
    bf16/fp16 on K2's D = 256 build and K3's, one launch that makes dK and
    dV (with its split sum where it splits); in fp32 on the register-tiled
    kernels (K1's combine and K2's and K3's split sums where they
    split)."""
    launched = _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D,
                                     cuda_device)
    general = dtype == torch.float32
    assert launched == {
        "flash_attention_fwd": int(not general),
        "flash_fwd_general": int(general),
        "flash_fwd_split_combine": _combine_launches(
            cuda_device, dtype, B, Hq, L, D, causal),
        "flash_bwd_dq": 0 if general else 1,
        "flash_bwd_dkv": int(not general),
        "flash_bwd_dq_general": int(general),
        "flash_bwd_dkv_general": int(general),
        "flash_fwd_general_mma": 0, "flash_bwd_dkv_general_mma": 0,
        "flash_bwd_dq_general_mma": 0,
        "flash_bwd_dkv_split_sum": _split_launches(
            cuda_device, B, Hq, Hkv, L, D, causal) if general
        else _mma_split_launches(cuda_device, dtype, B, Hq, Hkv, L, D,
                                 causal),
        "flash_bwd_dq_split_sum": general and _dq_split_launches(
            cuda_device, B, Hq, L, D, causal)}


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
    """K1, K2 and K3 at D > 256 go to the general kernels, one launch each
    (on tensor cores in bf16/fp16; register-tiled in fp32, K1 with its
    combine and K2 and K3 with their split sums where they split), and
    hold their twins at the tuned kernels' tolerances."""
    launched = _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D,
                                     cuda_device)
    mma = dtype != torch.float32
    assert launched == {
        "flash_attention_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_general": int(not mma),
        "flash_fwd_split_combine": _combine_launches(
            cuda_device, dtype, B, Hq, L, D, causal),
        "flash_bwd_dq_general": int(not mma),
        "flash_bwd_dkv_general": int(not mma),
        "flash_fwd_general_mma": int(mma),
        "flash_bwd_dkv_general_mma": int(mma),
        "flash_bwd_dq_general_mma": int(mma),
        "flash_bwd_dkv_split_sum": 0 if mma else _split_launches(
            cuda_device, B, Hq, Hkv, L, D, causal),
        "flash_bwd_dq_split_sum": 0 if mma else _dq_split_launches(
            cuda_device, B, Hq, L, D, causal)}


@pytest.mark.cuda
def test_general_and_d256_kernels_are_deterministic_on_gpu(cuda_device):
    """The general kernels (bf16 D = 320: K1 and K3 on tensor cores; fp32
    D = 256: register-tiled) and K3's D = 256 build (two warpgroups, its
    slabs summed in a fixed order) write each output once: two runs give
    the same bits."""
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


# (dtype, causal, B, Hq, Hkv, L, D): the general tensor-core kernels (K1
# and K3 in bf16/fp16 beyond the builds) across padded head dims (320, 384,
# 640 end inside a 256-column chunk), group sizes 1 and 4, and q/k tiles
# (one row, one short of a tile, one past, a ragged many)
_MMA_GENERAL_GPU_CASES = [
    (dtype, causal, 1, 4, 4 // group, L, D)
    for dtype in (torch.bfloat16, torch.float16)
    for causal in (False, True)
    for D in (320, 384, 512, 640, 1024)
    for group in (1, 4)
    for L in (1, 63, 65, 517)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,Hq,Hkv,L,D", _MMA_GENERAL_GPU_CASES)
def test_tensor_core_general_kernels_match_twins_on_gpu(cuda_device, dtype,
                                                        causal, B, Hq, Hkv,
                                                        L, D):
    """K1, K2 and K3 beyond the builds in bf16/fp16 run on the general
    tensor-core kernels, one launch each, and hold their twins at the
    tuned kernels' tolerances: o within ``_FWD_ATOL``,
    lse 1e-3, dq, dk, dv within ``_BWD_REL`` × max|twin|, with a δ drawn
    apart from O (as in the tuned kernels' cases, so that rows that see one
    key compare values, not fp32 noise)."""
    delta = torch.from_numpy(np.random.default_rng(L + D).standard_normal(
        (B, Hq, L)).astype(np.float32)).to(cuda_device)
    launched = _check_fwd_bwd_on_gpu(dtype, causal, B, Hq, Hkv, L, D,
                                     cuda_device, delta=delta)
    assert launched == {
        "flash_attention_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_general": 0, "flash_bwd_dq_general": 0,
        "flash_bwd_dkv_general": 0, "flash_fwd_general_mma": 1,
        "flash_bwd_dkv_general_mma": 1, "flash_bwd_dq_general_mma": 1,
        "flash_bwd_dkv_split_sum": 0, "flash_fwd_split_combine": 0,
        "flash_bwd_dq_split_sum": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [320, 640])
def test_tensor_core_general_kernels_are_deterministic_on_gpu(cuda_device,
                                                              dtype, D):
    """Each chunk of O, dQ, dK and dV is written once, by one block, summed
    in a fixed order (no atomics): two runs give the same bits, GQA and
    ragged L included."""
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_general_mma,
        flash_bwd_dq_general_mma,
        flash_fwd_general_mma,
    )

    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, dtype, 2, 8, 2, 517,
                                           D, True, seed=3)
    delta = (do.float() * o.float()).sum(-1)
    for run in (lambda: flash_fwd_general_mma(q, k, v, True),
                lambda: flash_bwd_dkv_general_mma(q, k, v, do, lse, delta,
                                                  True),
                lambda: (flash_bwd_dq_general_mma(q, k, v, do, lse, delta,
                                                  True),)):
        first, second = run(), run()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_tensor_core_general_kernels_refuse_misaligned_views_on_gpu(
        cuda_device):
    """At a head dim that needs no padding (512), a misaligned q, k, v or
    dO never reaches the general tensor-core kernels, nor the fp32 K3:
    every wrapper raises before a launch."""
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_general,
        flash_bwd_dkv_general_mma,
        flash_bwd_dq_general_mma,
        flash_fwd_general_mma,
    )

    q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.bfloat16, 1,
                                           4, 2, 65, 512, True)
    delta = (do.float() * o.float()).sum(-1)
    before = _launch_counts()
    for args in ((_misaligned(q), k, v), (q, _misaligned(k), v),
                 (q, k, _misaligned(v))):
        with pytest.raises(ValueError, match="16-byte"):
            flash_fwd_general_mma(*args, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv_general_mma(q, k, v, _misaligned(do), lse, delta, True)
    for args in ((_misaligned(q), k, v, do), (q, _misaligned(k), v, do),
                 (q, k, _misaligned(v), do), (q, k, v, _misaligned(do))):
        with pytest.raises(ValueError, match="16-byte"):
            flash_bwd_dq_general_mma(*args, lse, delta, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv_general(q.float(), k.float(), v.float(),
                              _misaligned(do.float()), lse, delta, True)
    with pytest.raises(ValueError, match="float16"):
        flash_fwd_general_mma(q.float(), k.float(), v.float(), True)
    with pytest.raises(ValueError, match="float16"):
        flash_bwd_dq_general_mma(q.float(), k.float(), v.float(), do.float(),
                                 lse, delta, True)
    assert _launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_autograd_takes_the_tensor_core_route_beyond_the_builds_on_gpu(
        cuda_device, dtype):
    """One backward through ``flash_attention`` at D = 512 launches K1, K2
    and K3 on the general tensor-core kernels, once each; the SIMT general
    kernels and the tuned builds stay at 0."""
    q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, dtype, 1, 8, 2, 256,
                                        512, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = _launch_counts()
    out = flash_attention(q, k, v, True)
    out.transpose(1, 2).sum().backward()
    torch.cuda.synchronize()
    after = _launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_general": 0, "flash_bwd_dq_general": 0,
        "flash_bwd_dkv_general": 0, "flash_fwd_general_mma": 1,
        "flash_bwd_dkv_general_mma": 1, "flash_bwd_dq_general_mma": 1,
        "flash_bwd_dkv_split_sum": 0, "flash_fwd_split_combine": 0,
        "flash_bwd_dq_split_sum": 0}
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


# (causal, B, Hq, Hkv, L, D): the fp32 K3 across padded head dims (1 and 16
# pad to 64, 100 to 128, 129, 200 and 300 to 160, 224 and 320; 600 to 608,
# a 96-column last chunk), group sizes 1 and 4 (B2·Hq8·Hkv2: B·Hkv = 4, the
# split path), one row, ragged and many tiles
_FP32_DKV_GPU_CASES = [
    (causal, B, Hq, Hkv, L, D)
    for causal in (False, True)
    for D in (1, 16, 64, 100, 128, 129, 200, 256, 300, 512, 600)
    for B, Hq, Hkv in ((1, 4, 4), (2, 8, 2))
    for L in (1, 65, 517)
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,Hq,Hkv,L,D", _FP32_DKV_GPU_CASES)
def test_fp32_dkv_general_kernel_matches_twin_on_gpu(cuda_device, causal, B,
                                                      Hq, Hkv, L, D):
    """The register-tiled fp32 K3 holds its twin within 1e-4 × max|twin|
    (δ drawn apart from O, as the tensor-core cases), one launch, plus the
    split sum where ``dkv_split`` cuts its k tiles; D comes back
    unpadded."""
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_general,
        flash_bwd_dkv_reference,
    )

    q, k, v, _, lse, do = _cuda_bwd_inputs(cuda_device, torch.float32, B,
                                           Hq, Hkv, L, D, causal)
    delta = torch.from_numpy(np.random.default_rng(L + D).standard_normal(
        (B, Hq, L)).astype(np.float32)).to(cuda_device)
    before = _launch_counts()
    got = flash_bwd_dkv_general(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = _launch_counts()
    split = _split_launches(cuda_device, B, Hq, Hkv, L, D, causal)
    assert {n: after[n] - before[n] for n in after if after[n] - before[n]} \
        == {"flash_bwd_dkv_general": 1,
            **({"flash_bwd_dkv_split_sum": 1} if split else {})}
    want = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    for name, a, b in zip(("dk", "dv"), got, want):
        assert a.shape == b.shape == k.shape and a.is_contiguous(), name
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= _BWD_REL[torch.float32] * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [256, 600])
def test_fp32_dkv_general_kernel_is_deterministic_on_gpu(cuda_device,
                                                         causal, D):
    """The fp32 K3 writes each partial once, from one block, and its sum
    adds a row's slabs in slab order (no atomics): two runs give the same
    bits, at B2·Hq8·Hkv2 (split) and B8·Hq8·Hkv8 (a grid that needs none
    on the H100)."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dkv_general

    for B, Hq, Hkv in ((2, 8, 2), (8, 8, 8)):
        q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.float32,
                                               B, Hq, Hkv, 517, D, causal,
                                               seed=3)
        delta = (do * o).sum(-1)
        first = flash_bwd_dkv_general(q, k, v, do, lse, delta, causal)
        second = flash_bwd_dkv_general(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,group,per_slab", [
    (True, 4, 9), (False, 4, 5), (True, 1, 1)])
def test_split_sum_kernel_matches_twin_on_gpu(cuda_device, causal, group,
                                              per_slab):
    """The split fp32 K3's second launch against its twin on random
    partials (B2·Hkv2·L1000·D96): the same sums in the same slab order,
    bit for bit, reading no slab a tile lacks (those hold NaN)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _slab_steps,
        dkv_split_sum_reference,
        flash_bwd_dkv_split_sum,
    )

    L = 1000
    counts = [-(-n // per_slab) for n in _slab_steps(L, group, causal)]
    part = torch.from_numpy(np.random.default_rng(per_slab).standard_normal(
        (counts[0], 2, 2, 2, L, 96)).astype(np.float32))
    for t, n in enumerate(counts):
        part[n:, :, :, :, 64 * t:64 * t + 64] = float("nan")
    part = part.to(cuda_device)
    before = flash_bwd_dkv_split_sum.launches
    got = flash_bwd_dkv_split_sum(part, group, causal, per_slab)
    torch.cuda.synchronize()
    assert flash_bwd_dkv_split_sum.launches == before + 1
    want = dkv_split_sum_reference(part, group, causal, per_slab)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


# (causal, B, Hq, Hkv, L, D, split): the register-tiled fp32 K1 across
# padded head dims (1, 16, 100, 200 and 300 pad to 64, 64, 128, 224 and
# 320; 600 to 608, a 96-column last chunk), one row, ragged L, GQA, on a
# grid that the H100's 132 SMs split (B1·Hq4·Hkv2·L517: nine slabs of one
# k tile) and on ones that fill it whole (B33·Hq16·Hkv4·L65 not causal,
# B44·Hq16·Hkv4·L65 causal, the ragged B2·Hq8·Hkv2·L1000)
_FP32_FWD_GPU_CASES = [
    (causal, *shape, split)
    for causal in (False, True)
    for D in (1, 16, 64, 100, 128, 200, 256, 300, 512, 600)
    for shape, split in (((1, 4, 2, 517, D), True),
                         (((44 if causal else 33), 16, 4, 65, D), False))
] + [(True, 1, 4, 4, 1, 64, False), (False, 2, 8, 2, 1000, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,Hq,Hkv,L,D,split", _FP32_FWD_GPU_CASES)
def test_fp32_forward_kernel_matches_twin_on_gpu(cuda_device, causal, B, Hq,
                                                 Hkv, L, D, split):
    """The register-tiled fp32 K1 holds its twin, o and lse within 1e-4:
    one launch, plus the combine where ``fwd_split`` cuts the q tiles'
    k tiles (``split``, on the H100); D comes back unpadded."""
    from metisfl_tpu_torch.ops.flash_attention import flash_fwd_general

    assert (_fwd_split_at(cuda_device, B, Hq, L, D, causal)[1] > 1) == split
    q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.float32, B, Hq,
                                        Hkv, L, D, causal, seed=D)
    before = _launch_counts()
    o, lse = flash_fwd_general(q, k, v, causal)
    torch.cuda.synchronize()
    after = _launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] - before[n]} \
        == {"flash_fwd_general": 1,
            **({"flash_fwd_split_combine": 1} if split else {})}
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    assert o.shape == q.shape and o.is_contiguous() and lse.shape == (B, Hq,
                                                                       L)
    torch.testing.assert_close(o, o_ref, atol=_FWD_ATOL[torch.float32],
                               rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [128, 600])
def test_fp32_forward_kernel_is_deterministic_on_gpu(cuda_device, causal, D):
    """The fp32 K1 writes each partial once, from one block, and its
    combine merges a row's slabs in slab order (no atomics): two runs give
    the same bits, split (B1·Hq4·Hkv2·L517) and whole (B44·Hq16·Hkv4·L65,
    B2·Hq8·Hkv2·L517)."""
    from metisfl_tpu_torch.ops.flash_attention import flash_fwd_general

    for B, Hq, Hkv, L in ((1, 4, 2, 517), (44, 16, 4, 65), (2, 8, 2, 517)):
        q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.float32, B,
                                            Hq, Hkv, L, D, causal, seed=3)
        first = flash_fwd_general(q, k, v, causal)
        second = flash_fwd_general(q, k, v, causal)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,per_slab", [(True, 3), (False, 5),
                                             (True, 1)])
def test_fwd_combine_kernel_matches_twin_on_gpu(cuda_device, causal,
                                                per_slab):
    """The split fp32 K1's second launch against its twin on random
    partials (B2·Hq4·L1000·D96; each row's m and l drawn, row 5 with no
    unmasked key in its first slab): o within 1e-6 × max|twin|, lse within
    a relative 1e-6 (the two round e^(m_s - m) and the products apart),
    finite, reading no slab a q tile lacks (those hold NaN)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        flash_fwd_split_combine,
        fwd_split_combine_reference,
    )

    L, D = 1000, 96
    counts = [-(-n // per_slab) for n in _fwd_slab_steps(L, causal)]
    rng = np.random.default_rng(per_slab)
    o_part = torch.from_numpy(rng.standard_normal(
        (max(counts), 2, 4, L, D)).astype(np.float32))
    m_part = torch.from_numpy(rng.standard_normal(
        (max(counts), 2, 4, L)).astype(np.float32) * 4)
    l_part = torch.from_numpy(rng.uniform(
        1, 64, (max(counts), 2, 4, L)).astype(np.float32))
    o_part[0, :, :, 5], m_part[0, :, :, 5], l_part[0, :, :, 5] = 0, -1e30, 0
    for t, n in enumerate(counts):
        for part in (o_part, m_part, l_part):
            part[n:, :, :, 64 * t:64 * t + 64] = float("nan")
    o_part, m_part, l_part = (t.to(cuda_device)
                              for t in (o_part, m_part, l_part))
    before = flash_fwd_split_combine.launches
    got = flash_fwd_split_combine(o_part, m_part, l_part, causal, per_slab)
    torch.cuda.synchronize()
    assert flash_fwd_split_combine.launches == before + 1
    want = fwd_split_combine_reference(o_part, m_part, l_part, causal,
                                       per_slab)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert float((got[0] - want[0]).abs().max()) <= 1e-6 * float(
        want[0].abs().max())
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fp32_forward_kernel_refuses_misaligned_views_on_gpu(cuda_device):
    """At head dims that need no padding (64, 512), a misaligned q, k or v
    never reaches the fp32 K1: the wrapper raises before a launch, and it
    takes fp32 only."""
    from metisfl_tpu_torch.ops.flash_attention import flash_fwd_general

    before = _launch_counts()
    for D in (64, 512):
        q, k, v, _, _, _ = _cuda_bwd_inputs(cuda_device, torch.float32, 1, 4,
                                            2, 65, D, True)
        for args in ((_misaligned(q), k, v), (q, _misaligned(k), v),
                     (q, k, _misaligned(v))):
            with pytest.raises(ValueError, match="16-byte"):
                flash_fwd_general(*args, True)
            with pytest.raises(ValueError, match="16-byte"):
                flash_attention_fwd(*args, True)
    with pytest.raises(ValueError, match="float32"):
        flash_fwd_general(q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    assert _launch_counts() == before


# (causal, B, Hq, Hkv, L, D, split): the register-tiled fp32 K2 across
# padded head dims (1, 16, 100, 200 and 300 pad to 64, 64, 128, 224 and 320;
# 600 to 608, a 96-column last chunk), one row, ragged L, GQA, on a grid
# that the H100's 132 SMs split (B1·Hq4·Hkv2·L517: nine slabs of one k
# tile) and on ones that fill it whole (B33·Hq16·Hkv4·L65 not causal,
# B44·Hq16·Hkv4·L65 causal, the ragged B2·Hq8·Hkv2·L1000)
_FP32_DQ_GPU_CASES = [
    (causal, *shape, split)
    for causal in (False, True)
    for D in (1, 16, 64, 100, 128, 200, 256, 300, 512, 600)
    for shape, split in (((1, 4, 2, 517, D), True),
                         (((44 if causal else 33), 16, 4, 65, D), False))
] + [(True, 1, 4, 4, 1, 64, False), (False, 2, 8, 2, 1000, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,Hq,Hkv,L,D,split", _FP32_DQ_GPU_CASES)
def test_fp32_dq_general_kernel_matches_twin_on_gpu(cuda_device, causal, B,
                                                     Hq, Hkv, L, D, split):
    """The register-tiled fp32 K2 holds its twin within 1e-4 × max|twin|
    (δ drawn apart from O, as the K3 cases): one launch, plus the split sum
    where ``dq_split`` cuts the q tiles' k tiles (``split``, on the H100);
    D comes back unpadded."""
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_bwd_dq_general,
        flash_bwd_dq_reference,
    )

    assert bool(_dq_split_launches(cuda_device, B, Hq, L, D, causal)) \
        == split
    q, k, v, _, lse, do = _cuda_bwd_inputs(cuda_device, torch.float32, B,
                                           Hq, Hkv, L, D, causal, seed=D)
    delta = torch.from_numpy(np.random.default_rng(L + D).standard_normal(
        (B, Hq, L)).astype(np.float32)).to(cuda_device)
    before = _launch_counts()
    got = flash_bwd_dq_general(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _launched(before) == {
        "flash_bwd_dq_general": 1,
        **({"flash_bwd_dq_split_sum": 1} if split else {})}
    want = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    assert got.shape == want.shape == q.shape and got.is_contiguous()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= _BWD_REL[torch.float32] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [128, 600])
def test_fp32_dq_general_kernel_is_deterministic_on_gpu(cuda_device, causal,
                                                        D):
    """The fp32 K2 writes each dQ chunk or partial once, from one block,
    and its sum adds a row's slabs in slab order (no atomics): two runs
    give the same bits, split (B1·Hq4·Hkv2·L517) and whole
    (B44·Hq16·Hkv4·L65, B2·Hq8·Hkv2·L517)."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dq_general

    for B, Hq, Hkv, L in ((1, 4, 2, 517), (44, 16, 4, 65), (2, 8, 2, 517)):
        q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.float32,
                                               B, Hq, Hkv, L, D, causal,
                                               seed=3)
        delta = (do * o).sum(-1)
        first = flash_bwd_dq_general(q, k, v, do, lse, delta, causal)
        second = flash_bwd_dq_general(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,per_slab", [(True, 3), (False, 5),
                                             (True, 1)])
def test_dq_split_sum_kernel_matches_twin_on_gpu(cuda_device, causal,
                                                 per_slab):
    """The split fp32 K2's second launch against its twin on random
    partials (B2·Hq4·L1000·D96): the same sums in the same slab order, bit
    for bit, reading no slab a q tile lacks (those hold NaN)."""
    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        dq_split_sum_reference,
        flash_bwd_dq_split_sum,
    )

    L = 1000
    counts = [-(-n // per_slab) for n in _fwd_slab_steps(L, causal)]
    part = torch.from_numpy(np.random.default_rng(per_slab).standard_normal(
        (max(counts), 2, 4, L, 96)).astype(np.float32))
    for t, n in enumerate(counts):
        part[n:, :, :, 64 * t:64 * t + 64] = float("nan")
    part = part.to(cuda_device)
    before = flash_bwd_dq_split_sum.launches
    got = flash_bwd_dq_split_sum(part, causal, per_slab)
    torch.cuda.synchronize()
    assert flash_bwd_dq_split_sum.launches == before + 1
    want = dq_split_sum_reference(part, causal, per_slab)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.cuda
def test_fp32_dq_general_kernel_refuses_misaligned_views_on_gpu(
        cuda_device):
    """At head dims that need no padding (64, 512), a misaligned q, k, v or
    dO never reaches the fp32 K2: the wrapper (and flash_bwd_dq, which
    routes fp32 to it) raises before a launch, and it takes fp32 only."""
    from metisfl_tpu_torch.ops.flash_attention import flash_bwd_dq_general

    before = _launch_counts()
    for D in (64, 512):
        q, k, v, o, lse, do = _cuda_bwd_inputs(cuda_device, torch.float32,
                                               1, 4, 2, 65, D, True)
        delta = (do * o).sum(-1)
        for args in ((_misaligned(q), k, v, do), (q, _misaligned(k), v, do),
                     (q, k, _misaligned(v), do), (q, k, v, _misaligned(do))):
            with pytest.raises(ValueError, match="16-byte"):
                flash_bwd_dq_general(*args, lse, delta, True)
            with pytest.raises(ValueError, match="16-byte"):
                flash_bwd_dq(*args, lse, delta, True)
    with pytest.raises(ValueError, match="float32"):
        flash_bwd_dq_general(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             do.bfloat16(), lse, delta, True)
    assert _launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_65536_query_heads_on_gpu(cuda_device, dtype):
    """K1, K2 and K3 at Hq = 65536 (past gridDim.y's 65535; GQA on 16384 KV
    heads, L16·D64) launch once each, on the 1-D grids that carry b * H,
    and hold their twins at the unpadded cases' tolerances."""
    launched = _check_fwd_bwd_on_gpu(dtype, True, 1, 65536, 16384, 16, 64,
                                     cuda_device)
    assert {n: c for n, c in launched.items() if c} == _expected_launches(
        cuda_device, dtype, 1, 65536, 16384, 16, 64, True)
    assert set(launched[n] for n in _expected_launches(
        cuda_device, dtype, 1, 65536, 16384, 16, 64, True)) == {1}
