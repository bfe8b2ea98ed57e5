#!/usr/bin/env python3
"""Time the port's FedAvg federation rounds of one or more checkouts, in
turns, on one NVIDIA GPU.

    python3 scripts/torch_round_turns.py --root build/turns/parent --root .
    python3 scripts/torch_round_turns.py --phases federation --turns 1 \
        --root .

Each checkout runs ``chip_smoke.py``'s federation phases (``--phases``:
``federation``, the CNN and LlamaLite rounds in process, and
``multiprocess``, the same with a process per learner over gRPC; default
both) in a process of its own, its kernels built from its own ``csrc/``
into its own ``build/``, in the order A, B, B, A for two roots
(``--turns 2``), so that two versions are compared on the same card
within one call. Each run prints one ``{"turn": ...}`` JSON line: the
checkout, each phase's round walls and their split (the phases' own JSON
lines), and whether every check of the phases passed. It prints the
GPU's name and power limit; it imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {"federation": "federation_phase",
          "multiprocess": "multiprocess_phase"}

# one run in the checkout's own process: build its kernels, run the phases
RUN = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from metisfl_tpu_torch.ops import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
smoke = cs.Smoke()
gpu = cs.gpu_line()
out = {}
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    out[name] = smoke.phase(name, getattr(cs, name), smoke, gpu)
    out[name + "_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
print("ROUND_TURN " + json.dumps({"phases": out,
                                  "failures": smoke.failures}))
"""


def walls(phase):
    """(CNN, LlamaLite) round walls and the LlamaLite split of a phase's
    result."""
    phase = phase or {}
    llama = phase.get("llama") or {}
    return {"cnn_round_wall_s": (phase.get("cnn") or {}).get(
        "round_wall_s"), "llama_round_wall_s": llama.get("round_wall_s"),
        "llama_split": llama.get("split")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("torch_round_turns")
    parser.add_argument("--root", action="append", required=True,
                        help="a checkout (repeat; timed in turns)")
    parser.add_argument("--phases", default="federation,multiprocess")
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args(argv)
    names = [PHASES[p] for p in args.phases.split(",")]
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"gpu: {gpu.strip()}", flush=True)
    order = []
    for t in range(args.turns):
        order += args.root if t % 2 == 0 else args.root[::-1]
    ok = True
    for i, root in enumerate(order):
        proc = subprocess.run(
            [sys.executable, "-c", RUN, ",".join(names)],
            cwd=os.path.abspath(root), capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("ROUND_TURN ")), None)
        if proc.returncode or line is None:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
            print(json.dumps({"turn": i, "root": root,
                              "rc": proc.returncode}), flush=True)
            ok = False
            continue
        result = json.loads(line[len("ROUND_TURN "):])
        ok = ok and not result["failures"]
        print(json.dumps({"turn": i, "root": root,
                          "failures": result["failures"],
                          **{f"{name}_s": result["phases"][f"{name}_s"]
                             for name in names},
                          **{name: walls(result["phases"][name])
                             for name in names}}), flush=True)
    print(gpu.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
