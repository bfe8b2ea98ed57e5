#!/usr/bin/env python3
"""Time the port's K1-K3 wrappers of one or more checkouts, in turns, on
one NVIDIA GPU.

    python3 scripts/torch_kernel_turns.py --root build/turns/parent --root .

Each checkout's ``metisfl_tpu_torch`` runs in a process of its own (its
kernels built from its own ``csrc/`` into its own ``build/``), in the
order A, B, B, A for two roots (``--turns 2``), so that two versions are
compared on the same card within one call. Each run times
``flash_attention_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the
training shape of ``chip_smoke.py`` (B8·Hq16·Hkv4·L1024·D64, bf16,
causal) three ways: CUDA events around 20 back-to-back calls (``ms``, as
chip_smoke's kernel rows), the profiler's device time per call
(``device_ms``) and the host's time per call with no sync between calls
(``host_ms``). Where ``ms`` is near ``host_ms`` and above ``device_ms``,
the host paces the calls. It prints one ``{"turn": ...}`` JSON line per
run and the GPU's name and power limit; it imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPE = (8, 16, 4, 1024, 64)  # B, Hq, Hkv, L, D
SEED, ITERS, REPEATS = 7, 20, 3


def _time_ms(torch, fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _device_ms(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = sum(float(evt.self_device_time_total)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA)
    return total / 1e3 / ITERS if total else None


def _host_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / ITERS


def child(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import importlib

    import numpy as np
    import torch

    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    B, Hq, Hkv, L, D = SHAPE
    rng = np.random.default_rng(SEED)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to("cuda", torch.bfloat16)
        for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D),
                  (B, Hq, L, D)))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    calls = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v, True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  True),
    }
    out = {}
    for name, fn in calls.items():
        out[name] = [{"ms": _time_ms(torch, fn),
                      "device_ms": _device_ms(torch, fn),
                      "host_ms": _host_ms(torch, fn)}
                     for _ in range(REPEATS)]
    print(json.dumps({"turn": {"root": root, "shape": SHAPE,
                               "dtype": "bfloat16", "kernels": out}}),
          flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", action="append", default=[],
                        help="a checkout holding metisfl_tpu_torch "
                             "(repeat for each version)")
    parser.add_argument("--turns", type=int, default=2,
                        help="passes over the roots, every other one "
                             "reversed (2: A, B, B, A)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    roots = args.root or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    order = [r for t in range(args.turns)
             for r in (roots if t % 2 == 0 else roots[::-1])]
    for root in order:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", root]).returncode
        if rc:
            print(f"torch_kernel_turns: {root} exited {rc}", file=sys.stderr)
            return rc
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip()
          else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
