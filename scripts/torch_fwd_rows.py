#!/usr/bin/env python3
"""Time K1's D = 256 build with 64- and 128-row q tiles over a range of
grid sizes, on one NVIDIA GPU.

    python3 scripts/torch_fwd_rows.py
    python3 scripts/torch_fwd_rows.py --shapes 2,4,4,256 2,8,2,1000 \
        --dtype float16

For each shape B,Hq,Hkv,L (D = 256; bf16 unless ``--dtype``), causal and
not, it runs ``flash_attention_fwd`` with :func:`fwd_rows` forced to 64
and to 128 in turns (64, 128, 128, 64), each turn the profiler's device
time per call over 20 calls, and prints one JSON line per shape and mask:
the blocks of each grid (64-row tiles: one warpgroup a block; 128-row
tiles: two), the card's SM count, the rows the rule itself picks, and the
readings. Then the GPU's name and power limit. It runs the checkout it
lies in and imports no jax.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# B, Hq, Hkv, L: 128-row grids of 16 to 256 blocks (the 64-row grids
# twice that); 2,4,4,256 is chip_smoke's wide-heads shape, 2,8,2,1000 its
# ragged D = 256 case and 2,16,4,1024 the d256 case
SHAPES = ("2,4,4,256", "1,2,2,1024", "1,4,1,1024", "1,6,2,1024",
          "1,8,2,1024", "1,9,3,1024", "1,10,2,1024", "1,12,4,1024",
          "2,8,2,1000", "1,16,4,1024", "1,20,4,1024", "2,16,4,1024")
SEED = 7


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES),
                        help="B,Hq,Hkv,L each (default: %(default)s)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16"))
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fwd_rows: no CUDA device", file=sys.stderr)
        return 2
    from torch_kernel_turns import _device_ms

    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    rule = fa.fwd_rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtype = getattr(torch, args.dtype)
    rng = np.random.default_rng(SEED)
    for text in args.shapes:
        B, Hq, Hkv, L = (int(x) for x in text.split(","))
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to("cuda", dtype)
            for s in ((B, Hq, L, 256), (B, Hkv, L, 256), (B, Hkv, L, 256)))
        for causal in (True, False):
            readings = {64: [], 128: []}
            for rows in (64, 128, 128, 64):
                fa.fwd_rows = lambda *_, rows=rows: rows
                try:
                    readings[rows].append(_device_ms(
                        torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                              causal)))
                finally:
                    fa.fwd_rows = rule
            print(json.dumps({
                "shape": [B, Hq, Hkv, L, 256], "dtype": args.dtype,
                "causal": causal, "sms": sms,
                "blocks": {r: -(-L // r) * B * Hq for r in (64, 128)},
                "rule_rows": rule(B, Hq, L, 256, sms),
                "device_ms": readings}), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip()
          else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
