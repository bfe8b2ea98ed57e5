"""Wire parity: ModelBlob v2 packed by either package unpacks in the other
to the same names, dtypes and bytes (bit-exact, bf16 included)."""

import ml_dtypes
import numpy as np
import pytest
import torch

from metisfl_tpu.tensor import pytree as jax_pytree
from metisfl_tpu.tensor import spec as jax_spec
from metisfl_tpu_torch.tensor import pytree as port_pytree
from metisfl_tpu_torch.tensor.spec import DType


def _numpy_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": np.zeros((4,), np.float32)},
            "embed": {"embedding": rng.standard_normal((5, 2)).astype(
                ml_dtypes.bfloat16)},
            "half": rng.standard_normal((2, 2)).astype(np.float16),
            "slash/name": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scalar": np.asarray(7.5, np.float64),
            "flags": np.array([True, False, True]),
            "layers": [np.ones((2,), np.int64), np.full((1,), 3, np.uint8)],
        },
        "empty": np.zeros((0, 3), np.float32),
    }


def _raw(t):
    arr = t.reshape(-1).view(torch.uint8).numpy() if isinstance(
        t, torch.Tensor) else np.ascontiguousarray(t).reshape(-1).view(
            np.uint8)
    return arr.tobytes()


def test_same_tree_packs_to_identical_bytes():
    tree = _numpy_tree()
    assert port_pytree.pack_model(tree) == jax_pytree.pack_model(tree)


def test_jax_blob_unpacks_in_port():
    tree = _numpy_tree()
    want = jax_pytree.pytree_to_named_tensors(tree)
    blob = port_pytree.ModelBlob.from_bytes(jax_pytree.pack_model(tree))
    assert [n for n, _ in blob.tensors] == [n for n, _ in want]
    for (_, got), (name, arr) in zip(blob.tensors, want):
        assert tuple(got.shape) == arr.shape, name
        assert port_pytree.wire_dtype_of(got) == DType(
            jax_spec.wire_dtype_of(arr.dtype)), name
        assert _raw(got) == _raw(arr), name
    assert dict(blob.tensors)["params/embed/embedding"].dtype == torch.bfloat16


def test_port_blob_unpacks_in_jax():
    rng = np.random.default_rng(1)
    tree = {"params": {
        "w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
        "b16": torch.from_numpy(rng.standard_normal((6,)).astype(
            np.float32)).to(torch.bfloat16),
        "i": torch.arange(5, dtype=torch.int32),
    }}
    blob = jax_pytree.ModelBlob.from_bytes(port_pytree.pack_model(tree))
    got = dict(blob.tensors)
    assert [n for n, _ in blob.tensors] == [
        "params/b16", "params/i", "params/w"]
    assert got["params/b16"].dtype == np.dtype(ml_dtypes.bfloat16)
    for name, t in port_pytree.pytree_to_named_tensors(tree):
        assert got[name].shape == tuple(t.shape)
        assert _raw(got[name]) == _raw(t), name


def test_names_escape_like_reference():
    tree = {"a": {"b": np.zeros(1, np.float32)},
            "a/b": np.ones(1, np.float32), "p%": [np.zeros(1, np.float32)]}
    assert ([n for n, _ in port_pytree.pytree_to_named_tensors(tree)]
            == [n for n, _ in jax_pytree.pytree_to_named_tensors(tree)]
            == ["a/b", "a%2Fb", "p%25/0"])


def test_unpack_model_restores_structure():
    tree = _numpy_tree()
    back = port_pytree.unpack_model(jax_pytree.pack_model(tree), tree)
    assert isinstance(back["params"]["layers"], list)
    assert torch.equal(back["params"]["dense"]["kernel"],
                       torch.from_numpy(tree["params"]["dense"]["kernel"]))
    with pytest.raises(KeyError, match="missing"):
        port_pytree.named_tensors_to_pytree([], tree)


@pytest.mark.parametrize("corrupt", ["flip", "truncate", "v3"])
def test_integrity_framing_rejects_like_reference(corrupt):
    good = bytearray(jax_pytree.pack_model(_numpy_tree()))
    if corrupt == "flip":
        good[-1] ^= 0xFF
    elif corrupt == "truncate":
        good = good[:-3]
    else:
        good[4] = 3
    for parse in (jax_pytree.ModelBlob.from_bytes,
                  port_pytree.ModelBlob.from_bytes):
        with pytest.raises(ValueError):
            parse(bytes(good))
