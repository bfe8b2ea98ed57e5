"""Training parity: the port's ``TorchModelOps.train``/``evaluate`` against
the JAX package's ``FlaxModelOps`` from one variables tree, its optimizers
against optax itself, and its copies of ``ArrayDataset`` and
``TrainParams`` against the originals.

Every input comes from numpy seeds and goes to both packages. The model is
a small fp32 LlamaLite (vocab 256, dim 64, depth 2, heads 4, kv_heads 2,
L 32, batch 4). The JAX side runs under the harness's x64 mode, which
widens Flax's rotary angles and optax's bias corrections to f64; the
port's stay fp32.
"""

import dataclasses
import importlib
import math
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
from metisfl_tpu.models.optimizers import make_optimizer as jax_optimizer
from metisfl_tpu.models.zoo.transformer import LlamaLite as JaxLlama
from metisfl_tpu.tensor.pytree import pytree_to_named_tensors as jax_named
from metisfl_tpu.tensor.pytree import unpack_model as jax_unpack
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.models import (
    METRICS,
    ArrayDataset,
    TorchModelOps,
    make_optimizer,
)
from metisfl_tpu_torch.models.optimizers import apply_updates
from metisfl_tpu_torch.models.zoo import LlamaLite
from metisfl_tpu_torch.tensor import pack_model

CFG = dict(vocab_size=256, dim=64, depth=2, heads=4, kv_heads=2)
ROWS, SEQ = 12, 32
# Per-step losses: one fp32 forward on each side, summed in other orders,
# over at most 5 steps (measured gaps ≤ 1e-5 relative).
LOSS_RTOL = 2e-5
# SGD is linear in the gradient: fp32 gradients that agree to ~1e-7
# relative keep the weights within a few ulp (measured ≤ 2.4e-7).
SGD_ATOL = 2e-6
# Adam (and AdamW) divide by sqrt(v) + eps, which turns a coordinate whose
# gradient is near 0 into a step of ±lr either way: fp32 rounding noise
# there flips a whole step. So the weights' change from the start is
# compared in relative L2 per tensor (measured ≤ 1e-2 on the embedding,
# ~1e-3 elsewhere), and the losses of later steps, which see those weights,
# part by up to ~5e-5 relative.
ADAM_DELTA_RTOL = 3e-2
ADAM_LOSS_RTOL = 2e-4


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


def _data(seed=0, rows=ROWS):
    tokens = np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (rows, SEQ + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _variables(lora_rank=0):
    """JAX-initialised fp32 variables (x64 mode would draw lora_a in f64),
    with a nonzero LoRA delta where there is one."""
    x, _ = _data()
    v = jax.device_get(JaxLlama(lora_rank=lora_rank, **CFG).init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    rng = np.random.default_rng(9)
    for i in range(CFG["depth"]) if lora_rank else ():
        for proj in ("wq", "wv"):
            node = v["params"][f"block_{i}"]["attn"][proj]
            node["lora_b"] = (rng.standard_normal(node["lora_b"].shape)
                              * 0.1).astype(np.float32)
    return v


def _offset(variables, seed=4):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32),
        variables["params"])


def _named(tree):
    return [(n, np.asarray(a)) for n, a in jax_named(tree)]


def _train_both(variables, cfg, *, use_flash=False, lora_rank=0,
                trainable_regex="", grad_offset=None):
    x, y = _data()
    jops = FlaxModelOps(JaxLlama(lora_rank=lora_rank, use_flash=use_flash,
                                 **CFG), x[:1], variables=variables,
                        trainable_regex=trainable_regex)
    jout = jops.train(JaxDataset(x, y, seed=3), JaxTrainParams(**cfg),
                      grad_offset=grad_offset)
    pops = TorchModelOps(LlamaLite(lora_rank=lora_rank, use_flash=use_flash,
                                   **CFG), variables=variables, device="cpu",
                         trainable_regex=trainable_regex)
    pout = pops.train(ArrayDataset(x, y, seed=3), TrainParams(**cfg),
                      grad_offset=grad_offset)
    return jops, jout, pops, pout


def _assert_same_run(jout, pout, start, adaptive):
    assert pout.completed_steps == jout.completed_steps
    assert pout.completed_epochs == jout.completed_epochs
    assert len(pout.epoch_metrics) == len(jout.epoch_metrics)
    rtol = ADAM_LOSS_RTOL if adaptive else LOSS_RTOL
    for pe, je in zip(pout.epoch_metrics, jout.epoch_metrics):
        np.testing.assert_allclose(pe["loss"], je["loss"], rtol=rtol)
        assert pe["accuracy"] == pytest.approx(je["accuracy"], abs=1e-9)
    np.testing.assert_allclose(pout.train_metrics["loss"],
                               jout.train_metrics["loss"], rtol=rtol)
    got, want, init = (_named(t) for t in (pout.variables, jout.variables,
                                           start))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b), (_, a0) in zip(got, want, init):
        if adaptive:
            moved = np.linalg.norm(b - a0)
            assert np.linalg.norm(a - b) <= ADAM_DELTA_RTOL * moved + 1e-7, \
                name
        else:
            np.testing.assert_allclose(a, b, atol=SGD_ATOL, err_msg=name)


# -- optimizers against optax ---------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adam", {}),
    ("adamw", {}),
    ("rmsprop", {}),
    ("adagrad", {}),
])
@pytest.mark.parametrize("mu", [0.0, 0.1])
def test_optimizer_matches_optax(name, kw, mu):
    """The same numpy gradients for 5 steps through optax (via the JAX
    package's ``make_optimizer``) and the port's rules: the weights agree
    to 1e-6 (optax in x64 mode computes its bias corrections in f64, the
    port in Python floats; everything else is the same fp32 arithmetic).
    ``mu > 0`` chains FedProx in front, as the JAX package does."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jp = [jnp.asarray(a) for a in start]
    jtx = jax_optimizer(name, 0.05, kw, proximal_mu=mu,
                        global_params=[jnp.asarray(a) for a in start])
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in start]
    ttx = make_optimizer(name, 0.05, kw, proximal_mu=mu,
                         global_params=[t.clone() for t in tp])
    tstate = ttx.init(tp)
    for g in grads:
        updates, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        updates, tstate = ttx.update([torch.from_numpy(a) for a in g],
                                     tstate, tp)
        apply_updates(tp, updates)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_unknown_optimizer_raises_the_reference_error():
    with pytest.raises(ValueError) as want:
        jax_optimizer("lamb", 0.1)
    with pytest.raises(ValueError) as got:
        make_optimizer("lamb", 0.1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="global_params"):
        make_optimizer("sgd", 0.1, proximal_mu=0.5)


# -- the copied dataclass and dataset --------------------------------------

def test_train_params_fields_and_defaults_equal_the_reference():
    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            out.append((f.name, default))
        return out

    assert spec(TrainParams) == spec(JaxTrainParams)


@pytest.mark.parametrize("rows,batch", [(12, 4), (10, 4), (3, 8)])
def test_dataset_batch_order_is_bit_equal(rows, batch):
    """Epoch batches (shuffled and not, with and without the remainder)
    and the endless stream, including a dataset smaller than one batch."""
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    y = np.arange(rows, dtype=np.int32)
    ours, theirs = ArrayDataset(x, y, seed=7), JaxDataset(x, y, seed=7)
    assert len(ours) == len(theirs) and ours.size == theirs.size
    for kw in (dict(shuffle=True, epoch=2), dict(shuffle=False),
               dict(shuffle=True, epoch=0, drop_remainder=True)):
        for (a, b), (c, d) in zip(ours.batches(batch, **kw),
                                  theirs.batches(batch, **kw), strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    s1, s2 = ours.infinite_batches(batch), theirs.infinite_batches(batch)
    for _ in range(7):
        (a, b), (c, d) = next(s1), next(s2)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="mismatch"):
        ArrayDataset(x, y[:-1])


# -- N steps of training against FlaxModelOps -----------------------------

def test_train_adam_with_epoch_derived_steps_matches_flax():
    """``local_steps=0``: ceil(1.5 epochs × 3 steps per epoch) = 5 Adam
    steps on the dense path; per-epoch metrics close on the same steps."""
    v = _variables()
    cfg = dict(batch_size=4, local_steps=0, local_epochs=1.5,
               optimizer="adam", learning_rate=1e-2)
    _, jout, _, pout = _train_both(v, cfg)
    assert pout.completed_steps == 5 == math.ceil(1.5 * (ROWS // 4))
    assert len(pout.epoch_metrics) == 2
    _assert_same_run(jout, pout, v, adaptive=True)


def test_train_flash_path_matches_flax_pallas(jax_flash_ops):
    """``use_flash=True`` on both sides: the JAX engine differentiates the
    Pallas kernels (interpret mode) through their custom VJP, the port
    runs its autograd Function (the K1/K2/K3 twins on the CPU)."""
    v = _variables()
    cfg = dict(batch_size=4, local_steps=4, optimizer="adam",
               learning_rate=1e-2)
    _, jout, _, pout = _train_both(v, cfg, use_flash=True)
    _assert_same_run(jout, pout, v, adaptive=True)


def test_train_fedprox_and_grad_offset_match_flax():
    """FedProx's 0.5·μ·Σ‖p − p0‖² loss term (it enters the reported loss
    too) and a SCAFFOLD grad_offset added to every gradient, under Nesterov
    SGD."""
    v = _variables()
    cfg = dict(batch_size=4, local_steps=5, optimizer="sgd",
               learning_rate=0.5, proximal_mu=0.3,
               optimizer_kwargs={"momentum": 0.9, "nesterov": True})
    _, jout, _, pout = _train_both(v, cfg, grad_offset=_offset(v))
    _assert_same_run(jout, pout, v, adaptive=False)


def test_train_lora_freezes_by_name_like_flax():
    """``trainable_regex="lora_"``: only the adapters move (frozen tensors
    keep their bits, with no optimizer state and no decay), as optax's
    multi_transform with set_to_zero does."""
    v = _variables(lora_rank=2)
    cfg = dict(batch_size=4, local_steps=4, optimizer="sgd",
               learning_rate=0.5, optimizer_kwargs={"momentum": 0.5})
    _, jout, pops, pout = _train_both(v, cfg, lora_rank=2,
                                      trainable_regex="lora_")
    _assert_same_run(jout, pout, v, adaptive=False)
    for (name, a), (_, a0) in zip(_named(pout.variables), _named(v)):
        if "lora_" in name:
            assert not np.array_equal(a, a0), name
        else:
            np.testing.assert_array_equal(a, a0, err_msg=name)


def test_regex_matching_nothing_raises_the_reference_error():
    x, y = _data()
    ops = TorchModelOps(LlamaLite(**CFG), variables=_variables(),
                        device="cpu", trainable_regex="lora_")
    with pytest.raises(ValueError, match="matches no params"):
        ops.train(ArrayDataset(x, y), TrainParams(batch_size=4,
                                                  local_steps=1))


def test_scan_chunk_changes_only_the_sync_cadence():
    """``scan_chunk`` 1 and 4 (5 steps: a chunk of 4 and a rest of 1) give
    the same weights and metrics, bit for bit."""
    x, y = _data()
    v = _variables()
    outs = []
    for chunk in (1, 4):
        ops = TorchModelOps(LlamaLite(**CFG), variables=v, device="cpu")
        outs.append(ops.train(ArrayDataset(x, y, seed=3), TrainParams(
            batch_size=4, local_steps=5, optimizer="adam",
            learning_rate=1e-2, scan_chunk=chunk)))
    assert outs[0].epoch_metrics == outs[1].epoch_metrics
    for (n, a), (_, b) in zip(_named(outs[0].variables),
                              _named(outs[1].variables)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert outs[1].completed_steps == 5 and outs[1].ms_per_step > 0


def test_evaluate_matches_flax_and_skips_unknown_metrics(caplog):
    """Loss, accuracy and top-5 accuracy over unshuffled batches with a
    ragged last batch (12 rows by 5), weighted by rows as the JAX engine
    weights them; an unregistered metric is skipped with a warning."""
    v = _variables()
    x, y = _data(seed=1)
    jops = FlaxModelOps(JaxLlama(**CFG), x[:1], variables=v)
    want = jops.evaluate(JaxDataset(x, y), batch_size=5,
                         metrics=["accuracy", "top5_accuracy"])
    ops = TorchModelOps(LlamaLite(**CFG), variables=v, device="cpu")
    with caplog.at_level("WARNING", logger="metisfl_tpu_torch.models"):
        got = ops.evaluate(ArrayDataset(x, y), batch_size=5,
                           metrics=["accuracy", "top5_accuracy", "bleu"])
    assert "bleu" in caplog.text
    assert set(got) == set(want) == {"loss", "accuracy", "top5_accuracy"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)
    assert set(METRICS) == {"accuracy", "top5_accuracy", "mse", "mae"}
    # explicit variables are evaluated on a copy; the engine's stay put
    other = jax.tree.map(lambda a: a * 0.5, v)
    assert ops.evaluate(ArrayDataset(x, y), 5, variables=other)["loss"] \
        != pytest.approx(got["loss"])
    assert ops.evaluate(ArrayDataset(x, y), 5)["loss"] == got["loss"]


def test_train_leaves_eval_mode_and_counts_like_flax():
    """After training the module is back in eval mode (infer and generate
    work as before); the cost accounting is the JAX engine's; a set
    cancel event stops before the first step."""
    v = _variables()
    x, y = _data()
    ops = TorchModelOps(LlamaLite(**CFG), variables=v, device="cpu")
    jops = FlaxModelOps(JaxLlama(**CFG), x[:1], variables=v)
    assert ops.param_count() == jops.param_count()
    assert ops.step_flops(8) == jops.step_flops(8)
    ops.train(ArrayDataset(x, y), TrainParams(batch_size=4, local_steps=2))
    assert not ops.module.training
    assert ops.infer(x[:2]).shape == (2, SEQ, CFG["vocab_size"])
    assert ops.generate(x[:1, :4], 3, max_len=8).shape == (1, 3)
    cancel = threading.Event()
    cancel.set()
    out = ops.train(ArrayDataset(x, y), TrainParams(batch_size=4,
                                                    local_steps=3),
                    cancel_event=cancel)
    assert out.completed_steps == 0 and out.epoch_metrics == []


# -- remat and the wire ---------------------------------------------------

def test_remat_gives_the_same_gradients():
    """Checkpointed blocks recompute their activations in the backward
    pass; the gradients are the same bits as without."""
    v = _variables(lora_rank=2)
    x, y = _data()
    grads = []
    for remat in (False, True):
        ops = TorchModelOps(LlamaLite(lora_rank=2, remat=remat, **CFG),
                            variables=v, device="cpu")
        logits = ops.module(torch.from_numpy(x[:4]), train=True)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, CFG["vocab_size"]),
            torch.from_numpy(y[:4]).reshape(-1).long())
        grads.append(torch.autograd.grad(loss, list(ops.module.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_trained_weights_unpack_in_jax():
    """Weights the port trained, packed with the port's ``pack_model``,
    unpack in the JAX package to the same arrays."""
    v = _variables()
    x, y = _data()
    ops = TorchModelOps(LlamaLite(**CFG), variables=v, device="cpu")
    out = ops.train(ArrayDataset(x, y), TrainParams(
        batch_size=4, local_steps=2, optimizer="adamw", learning_rate=1e-2))
    back = jax_unpack(pack_model(out.variables), v)
    for (n, a), (_, b) in zip(_named(back), _named(out.variables)):
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert not np.array_equal(back["params"]["lm_head"]["kernel"],
                              v["params"]["lm_head"]["kernel"])
