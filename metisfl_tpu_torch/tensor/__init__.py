"""Wire contract: dtype-preserving tensor (de)serialization, the same
bytes as the JAX package's ``tensor`` package."""

from metisfl_tpu_torch.tensor.spec import (
    DType,
    TensorKind,
    TensorSpec,
    quantify,
)
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    NamedTensors,
    named_tensors_to_pytree,
    narrow_tensors,
    pack_model,
    pytree_to_named_tensors,
    tensor_from_payload,
    tensor_to_bytes,
    tree_leaves,
    tree_map,
    unpack_model,
)

__all__ = [
    "DType",
    "TensorKind",
    "TensorSpec",
    "quantify",
    "NamedTensors",
    "ModelBlob",
    "pytree_to_named_tensors",
    "named_tensors_to_pytree",
    "narrow_tensors",
    "pack_model",
    "unpack_model",
    "tensor_to_bytes",
    "tensor_from_payload",
    "tree_leaves",
    "tree_map",
]
