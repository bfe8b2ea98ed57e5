#!/usr/bin/env python3
"""Time the port's K1-K3 wrappers of one or more checkouts, in turns, on
one NVIDIA GPU.

    python3 scripts/torch_kernel_turns.py --root build/turns/parent --root .
    python3 scripts/torch_kernel_turns.py --shape 2,16,4,1024,512 \
        --root build/turns/parent --root .
    python3 scripts/torch_kernel_turns.py --shape 2,8,2,1024,256 \
        --dtype float32 --root build/turns/parent --root .
    python3 scripts/torch_kernel_turns.py --shape 2,8,8,1000,128 \
        --dtype float32 --not-causal --kernels fwd --root a --root b
    python3 scripts/torch_kernel_turns.py --shape 2,8,8,1000,64 \
        --dtype float32 --not-causal --kernels dq,dkv --root a --root b
    python3 scripts/torch_kernel_turns.py --shape 4,4,4,512,16 \
        --kernels fwd,dkv --breakdown --sdpa --turns 1 --root .

Each checkout's ``metisfl_tpu_torch`` runs in a process of its own (its
kernels built from its own ``csrc/`` into its own ``build/``), in the
order A, B, B, A for two roots (``--turns 2``), so that two versions are
compared on the same card within one call. Each run times
``flash_attention_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` (or those
``--kernels`` names: fwd, dq, dkv) at one shape and dtype, causal unless
``--not-causal``: ``--shape B,Hq,Hkv,L,D`` (default the training shape of
``chip_smoke.py``, B8·Hq16·Hkv4·L1024·D64) and ``--dtype`` (bfloat16,
float16 or float32; default bfloat16). It times them three
ways: CUDA events around 20 back-to-back calls (``ms``, as chip_smoke's
kernel rows), the profiler's device time per call (``device_ms``) and the
host's time per call with no sync between calls (``host_ms``). Where
``ms`` is near ``host_ms`` and above ``device_ms``, the host paces the
calls. Each call's ``launched`` names the wrappers that launched under it
(each checkout may route a dtype and head dim to other kernels: in fp32
the three route to the register-tiled kernels and their second launches,
beyond the builds in bf16/fp16 to the general tensor-core kernels).
Each call also records the sha256 of its outputs' bytes (``sha256``), so
that the turns of two versions show whether they give the same bits on
the same inputs (K2 and K3 take the lse and δ of the plain twin of K1,
the same in every checkout); ``--dump DIR`` saves each checkout's
outputs there on its first turn and, for two roots, prints per output
how many elements differ and by how much (a ``{"bits": ...}`` line).
``--layouts N`` times each call on N copies of the inputs, each
allocated after a spacer of another size (so in other device memory),
one profiler reading a copy (``by_layout``): a time that depends on where
the inputs lie shows there. ``--breakdown`` adds each call's device
kernels by the profiler (name,
device ms and launches per call: the flash kernel beside any pad or copy
around it), and ``--sdpa`` times ``scaled_dot_product_attention`` on the
same inputs, its forward and one call of its backward (the yardstick,
which the port never calls), with its kernels' names. It prints one
``{"turn": ...}`` JSON line per run and the GPU's name and power limit; it
imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

TRAINING_SHAPE = (8, 16, 4, 1024, 64)  # B, Hq, Hkv, L, D
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
    """The profiler's device time of one call of ``fn`` over ITERS calls:
    each kernel's mean time times its launches a call, so that a record
    the profiler drops (it sometimes loses one of the 20) does not read as
    a faster call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = sum(float(evt.self_device_time_total) / evt.count
                * max(1, round(evt.count / ITERS))
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA and evt.count)
    return total / 1e3 if total else None


def _breakdown(torch, fn):
    """Device kernels of one call of ``fn``, by the profiler over ITERS
    calls: name, device ms per call and launches per call, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    rows = [{"kernel": evt.key[:100],
             "device_ms": float(evt.self_device_time_total) / 1e3 / ITERS,
             "per_call": int(evt.count) / ITERS}
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r["device_ms"])


def _sdpa(torch, q, k, v, do, causal, kernels):
    """SDPA's forward and one call of its backward on the same inputs:
    events, the profiler's device time and its kernels, per call."""
    import torch.nn.functional as F

    gqa = q.shape[1] != k.shape[1]
    calls = {}
    if "fwd" in kernels:
        calls["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa)
    if kernels & {"dq", "dkv"}:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                           enable_gqa=gqa)
        calls["sdpa_bwd"] = lambda: torch.autograd.grad(
            o, (qg, kg, vg), do, retain_graph=True)
    timed = {}
    for name, fn in calls.items():
        try:
            timed[name] = {"ms": _time_ms(torch, fn),
                           "device_ms": _device_ms(torch, fn),
                           "kernels": _breakdown(torch, fn)}
        except RuntimeError as exc:  # a backend that refuses the shape
            timed[name] = {"error": str(exc)[:300]}
    return timed


def _host_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / ITERS


def _launches(fa):
    """Every wrapper of the module with a launch counter, by name."""
    return {name: fn.launches for name, fn in vars(fa).items()
            if callable(fn) and hasattr(fn, "launches")}


def _calls(fa, inputs, causal):
    """The three wrappers on one copy of the inputs, by name."""
    q, k, v, do, lse, delta = inputs
    return {
        "flash_attention_fwd": ("fwd", lambda: fa.flash_attention_fwd(
            q, k, v, causal)),
        "flash_bwd_dq": ("dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse,
                                                       delta, causal)),
        "flash_bwd_dkv": ("dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                          delta, causal)),
    }


def child(root: str, shape, dtype_name: str, causal: bool,
          kernels, breakdown: bool = False, sdpa: bool = False,
          layouts: int = 1, dump: str = "", index: int = 0) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import importlib

    import numpy as np
    import torch

    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    B, Hq, Hkv, L, D = shape
    rng = np.random.default_rng(SEED)
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        getattr(torch, dtype_name))
        for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D),
                  (B, Hq, L, D))]
    q, k, v, do = (t.to("cuda") for t in host)
    # K2's and K3's row statistics from the plain twin of K1, the same bits
    # in every checkout
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    copies, spacers = [(q, k, v, do, lse, delta)], []
    for i in range(1, layouts):
        spacers.append(torch.empty((1 + 5 * i) << 20, dtype=torch.uint8,
                                   device="cuda"))
        copies.append(tuple(t.clone() for t in copies[0]))
    out = {}
    for name, (short, fn) in _calls(fa, copies[0], causal).items():
        if short not in kernels:
            continue
        before = _launches(fa)
        result = fn()
        torch.cuda.synchronize()
        launched = {n: c - before.get(n, 0) for n, c in _launches(fa).items()
                    if c - before.get(n, 0)}
        result = result if isinstance(result, tuple) else (result,)
        digest = hashlib.sha256()
        for t in result:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        if dump:
            torch.save([t.cpu() for t in result],
                       os.path.join(dump, f"{index}_{name}.pt"))
        out[name] = {"launched": launched, "sha256": digest.hexdigest(),
                     "readings": [
            {"ms": _time_ms(torch, fn), "device_ms": _device_ms(torch, fn),
             "host_ms": _host_ms(torch, fn)} for _ in range(REPEATS)]}
        if layouts > 1:
            out[name]["by_layout"] = [
                _device_ms(torch, _calls(fa, c, causal)[name][1])
                for c in copies]
        if breakdown:
            out[name]["device_kernels"] = _breakdown(torch, fn)
    turn = {"root": root, "shape": list(shape), "dtype": dtype_name,
            "causal": causal, "kernels": out}
    if sdpa:
        turn["library"] = _sdpa(torch, q, k, v, do, causal, kernels)
    print(json.dumps({"turn": turn}), flush=True)
    return 0


def _compare_dumps(dump: str, kernels):
    """Per call and output, the two roots' outputs set side by side: how
    many elements differ in bits, of how many, and the largest difference."""
    import torch

    names = {"fwd": "flash_attention_fwd", "dq": "flash_bwd_dq",
             "dkv": "flash_bwd_dkv"}
    bits = {}
    for short in sorted(kernels):
        a, b = (torch.load(os.path.join(dump, f"{i}_{names[short]}.pt"))
                for i in (0, 1))
        rows = []
        for x, y in zip(a, b):
            ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
            rows.append({
                "differ": int((x.reshape(-1).view(ints)
                               != y.reshape(-1).view(ints)).sum()),
                "of": x.numel(),
                "max_abs": float((x.float() - y.float()).abs().max())})
        bits[names[short]] = rows
    return bits


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", action="append", default=[],
                        help="a checkout holding metisfl_tpu_torch "
                             "(repeat for each version)")
    parser.add_argument("--turns", type=int, default=2,
                        help="passes over the roots, every other one "
                             "reversed (2: A, B, B, A)")
    parser.add_argument("--shape", default=",".join(map(str, TRAINING_SHAPE)),
                        help="B,Hq,Hkv,L,D (default: the training shape, "
                             "%(default)s)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16", "float32"),
                        help="the inputs' dtype (default: %(default)s)")
    parser.add_argument("--not-causal", action="store_true",
                        help="time the kernels without the causal mask")
    parser.add_argument("--kernels", default="fwd,dq,dkv",
                        help="which of fwd, dq and dkv to time (default: "
                             "%(default)s)")
    parser.add_argument("--breakdown", action="store_true",
                        help="add each call's device kernels (profiler)")
    parser.add_argument("--sdpa", action="store_true",
                        help="time scaled_dot_product_attention's forward "
                             "and backward on the same inputs")
    parser.add_argument("--layouts", type=int, default=1,
                        help="time each call on this many copies of the "
                             "inputs, each in other device memory")
    parser.add_argument("--dump", default="",
                        help="a directory for each root's outputs; with "
                             "two roots, compare their bits")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--index", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    shape = tuple(int(x) for x in args.shape.split(","))
    if len(shape) != 5:
        parser.error(f"--shape takes B,Hq,Hkv,L,D, got {args.shape!r}")
    kernels = set(args.kernels.split(","))
    if not kernels or not kernels <= {"fwd", "dq", "dkv"}:
        parser.error(f"--kernels takes fwd, dq and dkv, got {args.kernels!r}")
    if args.child:
        return child(args.child, shape, args.dtype, not args.not_causal,
                     kernels, args.breakdown, args.sdpa, args.layouts,
                     args.dump, args.index)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    roots = args.root or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    order = [i for t in range(args.turns)
             for i in (range(len(roots)) if t % 2 == 0
                       else range(len(roots) - 1, -1, -1))]
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    dumped = set()
    for i in order:
        dump = args.dump if args.dump and i not in dumped else ""
        dumped.add(i)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--shape", args.shape, "--dtype", args.dtype,
                             "--kernels", args.kernels, "--child", roots[i],
                             "--layouts", str(args.layouts),
                             "--dump", dump, "--index", str(i)]
                            + ["--not-causal"] * args.not_causal
                            + ["--breakdown"] * args.breakdown
                            + ["--sdpa"] * args.sdpa).returncode
        if rc:
            print(f"torch_kernel_turns: {roots[i]} exited {rc}",
                  file=sys.stderr)
            return rc
    if args.dump and len(roots) == 2:
        print(json.dumps({"bits": _compare_dumps(args.dump, kernels)}))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip()
          else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
