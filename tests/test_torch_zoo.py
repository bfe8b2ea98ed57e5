"""Zoo parity: the port's MLPs and CNNs against the JAX package's Flax
modules, with Flax variables carried across by ``load_flax_variables``.

Forward outputs at ``train=False`` agree within 1e-5 abs; the loss
gradients at ``train=False`` agree per tensor within a relative L2 of
1e-5. Flattening the feature map channels-first instead of Flax's
channels-last order breaks the forward parity (so the order is tested,
not assumed). N-step SGD training of the FashionMNIST CNN through both
engines agrees with dropout off on both sides (its masks cannot match);
dropout engines training in parallel threads keep their own mask streams.
Inputs come from numpy seeds; shapes are small.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
from metisfl_tpu.models import FlaxModelOps
from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
from metisfl_tpu.models.zoo import cnn as jax_cnn
from metisfl_tpu.models.zoo import mlp as jax_mlp
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.models import (
    ArrayDataset,
    TorchModelOps,
    load_flax_variables,
)
from metisfl_tpu_torch.models.convert import flax_name
from metisfl_tpu_torch.models.zoo import cnn as torch_cnn
from metisfl_tpu_torch.models.zoo import mlp as torch_mlp

FWD_ATOL = 1e-5
GRAD_REL_L2 = 1e-5


def _case(name):
    """(flax module, port module, input batch, labels, loss name)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "mlp":
        x = rng.standard_normal((8, 6)).astype(np.float32)
        y = rng.integers(0, 3, 8).astype(np.int32)
        return (jax_mlp.MLP(features=(16, 8), num_outputs=3),
                torch_mlp.MLP(6, (16, 8), 3), x, y, "softmax_cross_entropy")
    if name == "housing_mlp":
        x = rng.standard_normal((8, 5)).astype(np.float32)
        y = rng.standard_normal(8).astype(np.float32)
        return (jax_mlp.HousingMLP(), torch_mlp.HousingMLP(5), x, y, "mse")
    if name == "fashion_mnist_cnn":
        x = rng.standard_normal((4, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        return (jax_cnn.FashionMnistCNN(), torch_cnn.FashionMnistCNN(), x, y,
                "softmax_cross_entropy")
    if name == "fashion_mnist_cnn_hw":  # (B, H, W) inputs gain a channel
        x = rng.standard_normal((4, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        return (jax_cnn.FashionMnistCNN(), torch_cnn.FashionMnistCNN(), x, y,
                "softmax_cross_entropy")
    if name == "cifar10_cnn":
        x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 2).astype(np.int32)
        return (jax_cnn.Cifar10CNN(), torch_cnn.Cifar10CNN(), x, y,
                "softmax_cross_entropy")
    if name == "brainage_regression":
        x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
        y = rng.standard_normal(2).astype(np.float32)
        return (jax_cnn.BrainAge3DCNN(widths=(4, 8)),
                torch_cnn.BrainAge3DCNN(widths=(4, 8),
                                        input_shape=(16, 16, 16, 1)),
                x, y, "mse")
    if name == "brainage_classifier":
        x = rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32)
        y = rng.integers(0, 2, 2).astype(np.int32)
        return (jax_cnn.BrainAge3DCNN(widths=(4, 8), num_outputs=2),
                torch_cnn.BrainAge3DCNN(widths=(4, 8), num_outputs=2,
                                        input_shape=(8, 8, 8, 1)),
                x, y, "softmax_cross_entropy")
    raise KeyError(name)


CASES = ["mlp", "housing_mlp", "fashion_mnist_cnn", "fashion_mnist_cnn_hw",
         "cifar10_cnn", "brainage_regression", "brainage_classifier"]


def _carried(name):
    fmod, tmod, x, y, loss = _case(name)
    variables = jax.device_get(fmod.init(jax.random.PRNGKey(3), x))
    load_flax_variables(tmod, variables)
    return fmod, tmod, variables, x, y, loss


def _jax_loss(loss, out, y):
    if loss == "mse":
        return jnp.mean(jnp.square(out - y))
    return optax.softmax_cross_entropy_with_integer_labels(out, y).mean()


def _torch_loss(loss, out, y):
    if loss == "mse":
        return torch.mean(torch.square(out - y))
    return torch.nn.functional.cross_entropy(out, y.long())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("name", CASES)
def test_forward_parity(name):
    fmod, tmod, variables, x, _, _ = _carried(name)
    want = np.asarray(fmod.apply(variables, x, train=False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), train=False).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_ATOL


@pytest.mark.parametrize("name", CASES)
def test_loss_gradient_parity(name):
    fmod, tmod, variables, x, y, loss = _carried(name)

    def jax_loss(params):
        return _jax_loss(loss, fmod.apply({"params": params}, x,
                                          train=False), y)

    want = dict(_flat(jax.grad(jax_loss)(variables["params"]), "params"))
    params = list(tmod.parameters())
    out = tmod(torch.from_numpy(x), train=False)
    grads = torch.autograd.grad(_torch_loss(loss, out, torch.from_numpy(y)),
                                params)
    names = [flax_name(n) for n, _ in tmod.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        w = want[n].astype(np.float64)
        err = np.linalg.norm(g.numpy().astype(np.float64) - w)
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(w), 1e-12), n


@pytest.mark.parametrize("name", ["fashion_mnist_cnn", "cifar10_cnn",
                                  "brainage_regression"])
def test_channels_first_flatten_breaks_parity(name, monkeypatch):
    """The dense head's kernel rows are in Flax's (H, W, C) order: a
    channels-first flatten computes something else."""
    fmod, tmod, variables, x, _, _ = _carried(name)
    want = np.asarray(fmod.apply(variables, x, train=False))
    monkeypatch.setattr(torch_cnn, "_flatten_channels_last",
                        lambda t: t.reshape(t.shape[0], -1))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), train=False).numpy()
    assert np.abs(got - want).max() > 100 * FWD_ATOL


class _FlaxFashionMnistNoDropout(fnn.Module):
    """The JAX package's FashionMnistCNN with Dropout(0.0): the same
    layers and names, so training is deterministic on both sides."""

    num_classes: int = 10

    @fnn.compact
    def __call__(self, x, train: bool = False):
        if x.ndim == 3:
            x = x[..., None]
        x = fnn.relu(fnn.Conv(32, (3, 3))(x))
        x = fnn.max_pool(x, (2, 2), strides=(2, 2))
        x = fnn.relu(fnn.Conv(64, (3, 3))(x))
        x = fnn.max_pool(x, (2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        x = fnn.relu(fnn.Dense(128)(x))
        x = fnn.Dropout(0.0, deterministic=not train)(x)
        return fnn.Dense(self.num_classes)(x)


# 6 SGD steps at lr 0.05 through two engines whose convolutions sum in
# different orders (XLA vs oneDNN/ATen): measured <= 9e-8 max abs on
# the weights; 2e-6 leaves room for the f32 reassociation to grow per step
TRAIN_ATOL = 2e-6


def test_cnn_sgd_training_parity():
    rng = np.random.default_rng(11)
    templates = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 48).astype(np.int32)
    x = templates[y] + 0.35 * rng.standard_normal(
        (48, 28, 28, 1)).astype(np.float32)
    jax_ops = FlaxModelOps(_FlaxFashionMnistNoDropout(), x[:2])
    variables = jax_ops.get_variables()
    ops = TorchModelOps(torch_cnn.FashionMnistCNN(dropout_rate=0.0),
                        variables=variables, device="cpu")
    kwargs = dict(batch_size=8, local_steps=6, optimizer="sgd",
                  learning_rate=0.05)
    want = jax_ops.train(JaxDataset(x, y, seed=2), JaxTrainParams(**kwargs))
    got = ops.train(ArrayDataset(x, y, seed=2), TrainParams(**kwargs))
    assert got.completed_steps == want.completed_steps == 6
    assert abs(got.train_metrics["loss"] - want.train_metrics["loss"]) < 1e-5
    got_w, want_w = dict(_flat(got.variables)), dict(_flat(want.variables))
    assert sorted(got_w) == sorted(want_w)
    moved = 0.0
    for n in want_w:
        assert np.abs(got_w[n] - want_w[n]).max() <= TRAIN_ATOL, n
        moved = max(moved, np.abs(want_w[n] - _flat_get(variables, n)).max())
    assert moved > 1e-3  # the weights really moved


def _flat_get(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return np.asarray(tree)


class _LockstepDataset(ArrayDataset):
    """Each batch waits on a barrier shared with the other engine's
    dataset, so two engines training in two threads interleave step by
    step."""

    def __init__(self, x, y, barrier, seed=0):
        super().__init__(x, y, seed=seed)
        self._barrier = barrier

    def infinite_batches(self, batch_size):
        for batch in super().infinite_batches(batch_size):
            self._barrier.wait(30)
            yield batch


def _dropout_run(seeds, x, y, barrier=None):
    """Train one dropout CNN engine per seed, in parallel threads when a
    barrier is given, else one after another; returns their weights."""
    kwargs = dict(batch_size=8, local_steps=4, optimizer="sgd",
                  learning_rate=0.1)
    template = TorchModelOps(torch_cnn.FashionMnistCNN(
        input_shape=(8, 8, 1), dropout_rate=0.5), rng_seed=0,
        device="cpu").get_variables()
    out = {}

    def train(seed):
        ops = TorchModelOps(torch_cnn.FashionMnistCNN(
            input_shape=(8, 8, 1), dropout_rate=0.5), rng_seed=seed,
            variables=template, device="cpu")
        data = (ArrayDataset(x, y, seed=1) if barrier is None
                else _LockstepDataset(x, y, barrier, seed=1))
        out[seed] = dict(_flat(ops.train(data, TrainParams(
            **kwargs)).variables))

    if barrier is None:
        for seed in seeds:
            train(seed)
    else:
        threads = [threading.Thread(target=train, args=(s,)) for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    return out


def test_concurrent_dropout_training_is_reproducible_from_seeds():
    """Dropout masks come from each engine's own generator: two engines
    training in lockstep in two threads end with the weights each gets
    alone, and the masks do depend on the seed."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((32, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    alone = _dropout_run((1, 2), x, y)
    together = _dropout_run((1, 2), x, y, threading.Barrier(2))
    for seed in (1, 2):
        assert sorted(together[seed]) == sorted(alone[seed])
        for n in alone[seed]:
            assert together[seed][n].tobytes() == alone[seed][n].tobytes(), (
                seed, n)
    assert any(alone[1][n].tobytes() != alone[2][n].tobytes()
               for n in alone[1])


def test_dropout_keeps_and_rescales_like_flax():
    """Flax's inverted dropout: kept elements are x / (1 - rate), the rest
    zero; the same generator state gives the same mask; eval is the
    identity."""
    drop = torch_cnn.Dropout(0.25)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        1.0, 2.0, (64, 32)).astype(np.float32))
    drop.generator = torch.Generator().manual_seed(5)
    a = drop(x, train=True)
    drop.generator = torch.Generator().manual_seed(5)
    b = drop(x, train=True)
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], x[kept] / 0.75)
    assert 0.65 < kept.float().mean().item() < 0.85
    assert torch.equal(drop(x, train=False), x)
