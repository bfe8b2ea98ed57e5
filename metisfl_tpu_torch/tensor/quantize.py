"""int8 absmax quantization of the federation uplink: the port's copy of
the JAX package's ``tensor/quantize.py``, numpy, bit for bit.

``TrainParams.ship_dtype="int8q"`` ships each float tensor as int8 plus a
per-tensor fp32 scale (absmax/127): 4x less uplink than f32. The payload
stays inside the ordinary named-tensor blob: each quantized tensor
``name`` is followed by a companion scalar ``name#qscale``, so stores,
codecs and transports are untouched; the controller dequantizes right
after parsing (``dequantize_named``) and aggregation runs on f32.
Integer and bool tensors pass through unquantized.

The division by the scale stays in numpy on the host: on the GPU torch
would turn ``x / scale`` into ``x * (1 / scale)``, which rounds
differently.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

QSCALE_SUFFIX = "#qscale"
SHIP_INT8Q = "int8q"


def quantize_named(named: List[Tuple[str, np.ndarray]]):
    """[(name, arr)] → same list with float tensors replaced by
    (name, int8) + (name#qscale, f32 scalar)."""
    out: List[Tuple[str, np.ndarray]] = []
    for name, arr in named:
        arr = np.asarray(arr)
        if name.endswith(QSCALE_SUFFIX):
            raise ValueError(f"tensor name {name!r} collides with the "
                             "quantization-scale suffix")
        if not np.issubdtype(arr.dtype, np.floating):
            out.append((name, arr))
            continue
        absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
        scale = absmax / 127.0 if absmax > 0 else 1.0
        q = np.clip(np.round(np.asarray(arr, np.float32) / scale),
                    -127, 127).astype(np.int8)
        out.append((name, q))
        out.append((name + QSCALE_SUFFIX,
                    np.asarray([scale], np.float32)))
    return out


def is_quantized(names) -> bool:
    return any(str(n).endswith(QSCALE_SUFFIX) for n in names)


def dequantize_named(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{name: arr} (as parsed from a blob) → floats restored to f32;
    companion scale entries consumed. Non-quantized dicts pass through."""
    if not is_quantized(tensors):
        return tensors
    out: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if name.endswith(QSCALE_SUFFIX):
            continue
        scale_key = name + QSCALE_SUFFIX
        if scale_key in tensors:
            scale = float(np.asarray(tensors[scale_key]).ravel()[0])
            out[name] = (np.asarray(arr, np.float32) * scale)
        else:
            out[name] = arr
    return out
