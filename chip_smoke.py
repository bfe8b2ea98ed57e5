#!/usr/bin/env python3
"""Chip smoke for metisfl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile-round   # + one profiled federation round

It drives the port only (it imports no jax and nothing of the JAX package):

1. device: the GPU's name and power limit, torch and CUDA versions; TF32
   off for matmuls and cuDNN, so fp32 stays fp32;
2. build: every CUDA kernel of the port from ``metisfl_tpu_torch/csrc``
   with nvcc, one process per source, all at once, timed;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at its path's shape and at a ragged fp32 shape, with the
   tolerance stated, timed beside its bound and one PyTorch library call
   that computes the same function (a yardstick the port never calls;
   SDPA's forward for K1, one call of SDPA's backward for K2+K3), each
   also as device time under the profiler and as host time per call:
   K1 (flash_fwd; tensor cores in bf16, SIMT in fp32) at the serving and
   the training shapes, K2 and K3 (flash_bwd_dq, flash_bwd_dkv; tensor
   cores in bf16) at the training shape, each run twice for bit-identity,
   with the achieved TFLOP/s; then K1-K3 at head dims the kernels are not
   built for (the wrapper zero-pads them to 64: the
   ``examples/long_context.py`` shape B4·Hq4·L512·D16, D = 8 and D = 32)
   and at B·Hq above the grid's 65535 (launched in batch chunks), K1-K3
   at their head dim 256 builds (K3 in two passes), and the general SIMT
   kernels (any head dim) at D = 512 in bf16 and fp32 and, for K2/K3, at
   fp32 D = 256; then every wrapper the wide-heads path (5.) launches, at
   that path's own B2·H·L256·D (D = 256 in bf16 and fp32, 512 in bf16);
   each case checks which wrapper launched;
4. serving slice: a full-width LlamaLite (vocab 32768, dim 1024, depth 8,
   heads 16, kv_heads 4, bf16 compute, flash attention) with seeded random
   weights, packed into a ModelBlob and installed in a ``ServingGateway``;
   8 concurrent Predict requests of 1024 tokens go through the flash kernel
   (the launch count is checked per forward) and one reply is held against
   the same module on the dense path; 4 concurrent Generate requests
   decode 64 tokens each through the continuous batcher and are compared
   with a solo ``generate`` per request;
5. training slice: the same model installed from a blob into
   ``TorchModelOps``, trained 6 Adam steps on 16 random-token rows of 1024
   (batch 8) through K1 forward and K2/K3 backward (every launch counted),
   then evaluated; the trained weights go back out as a blob, and one
   batch's gradients through the flash path are held against the dense
   path's; then the wide-heads path: LlamaLite at depth 2 trained 2 steps
   at head dims 256 (bf16 and fp32) and 512 (bf16), each launch checked
   against the kernel that head dim routes to, gradients against the
   dense path's;
6. federation slice: synchronous FedAvg rounds through the port's
   ``InProcessFederation`` (controller, learners, in-memory store, host
   fold), every learner's engine on the card: (a) 3 FashionMNIST CNN
   learners x 3 rounds of 20 SGD steps on synthetic 28x28 images, whose
   community test accuracy must rise; (b) 3 full-width LlamaLite learners
   x 1 round of 2 Adam steps, whose K1/K2/K3 launches must equal learners
   x rounds x steps x depth (K1 also once per block per evaluation batch).
   Each round's community model is held, bit for bit, against a FedAvg
   re-fold of the blobs its learners shipped (and, for LlamaLite, against
   a float64 weighted mean), and each round's wall time is split into
   its stages (learner train, weights copy-out, blob pack, controller
   ingest, fold, downlink unpack, load_flax_variables). The federations
   stop at their ``termination.federation_rounds``. With
   ``--profile-round`` one more LlamaLite round runs under the profiler;
7. multiprocess: the same two federations through ``DriverSession``, a
   controller process and one process per learner on the card, over
   localhost gRPC (the LlamaLite blobs, 755 MB, on the chunked path both
   ways). The learner recipes record each round's uplinks, the community
   model each learner received, stage times, peak device memory and
   K1-K3 launches, and write them at process exit; each community model
   is held bit for bit against a re-fold of its round's uplinks, K1-K3
   must launch 72/48/48 times per LlamaLite round across the learner
   processes, the CNN's accuracy must rise, and every process must exit 0
   after ``shutdown_federation``. Where grpc or cloudpickle is not
   installed it prints ``multiprocess: not run: ...`` and runs the rounds
   through the port's gRPC services' handlers, called directly, instead;
8. store: (a) the LlamaLite round in process on ``model_store.store:
   cached_disk`` (a 256 MB cache, below one 755 MB model, so select reads
   the mmapped file) with 3 ingest writers and a root in a temporary
   directory: the host fold must be the native one (``fold_backend()``),
   the community bit-identical to a re-fold of the uplinks and within
   1e-6 x max|w| of a float64 mean, each stored ``.blob`` a v3 blob of its
   uplink's tensors, and the drain fence must return before the select;
   it prints each insert's, the drain's and the select's times and the
   native against the numpy fold of the same three models, in turns;
   (b) the CNN with a process per learner for 2 rounds on ``store:
   remote``, served by a ``python -m metisfl_tpu_torch.store.server``
   process on a disk store, which must exit 0 on SIGTERM.

It prints a ``{"federation": {...}}`` line (round walls and their split,
ms per step, blob bytes, launches), a ``{"multiprocess": {...}}`` line
(the same with a process per learner, and each process's peak device
memory), ``{"wide_heads": ...}`` and ``{"store": ...}`` lines, a
``{"kernels": [...]}`` line (each kernel's launches by path: K1-K3 at
D = 64 on the main paths, and a row per wide-heads case and wrapper with
its launches there, each measured at its path's shape),
the GPU's name and power limit,
and, when every phase passed, ``{"ok": true, "device": {...}}`` as its last
line. It exits non-zero without a GPU, or outside a checkout.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
DEVICE = "cuda"
# --profile-round: one more LlamaLite federation round under torch.profiler
# (about 25-40 s more on the H100)
PROFILE_ROUND = "--profile-round" in sys.argv[1:]

# the serving slice's model (the JAX package's bench_decode/bench_mfu shape)
VOCAB, DIM, DEPTH, HEADS, KV_HEADS = 32768, 1024, 8, 16, 4
PREDICT_REQUESTS, PREDICT_LEN = 8, 1024
GEN_REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 64
MAX_BATCH, SLOTS, MAX_LEN = 4, 4, 512
# training slice: bench_mfu's traffic (random tokens, y = the next token)
TRAIN_ROWS, TRAIN_LEN, TRAIN_BATCH, TRAIN_STEPS = 16, 1024, 8, 6
# federation phase: 3 learners; (a) FashionMNIST-shaped CNN, 3 rounds of
# 20 SGD steps over 600 synthetic examples each, a 600-example test split;
# (b) the LlamaLite above at full width, 1 round of 2 Adam steps over 16
# random-token rows each (batch TRAIN_BATCH, length TRAIN_LEN), evaluated
# on 8 held-out rows
FED_LEARNERS = 3
CNN_ROUNDS, CNN_EXAMPLES, CNN_TEST, CNN_BATCH, CNN_STEPS = 3, 600, 600, 32, 20
# pixel noise over the class templates: at the examples' 0.35 one round of
# 20 steps already classifies the whole test split (1.0, 1.0, 1.0 on a
# CPU rehearsal), so a rise across rounds could not show; at 1.0 it reads
# 0.49, 1.0, 1.0 there
CNN_NOISE = 1.0
FED_ROUNDS, FED_STEPS, FED_ROWS, FED_EVAL_ROWS = 1, 2, 16, 8
# multiprocess phase: the LlamaLite federation above with a process per
# learner, 2 rounds (in process it runs 1, for the script's time)
MP_ROUNDS = 2
# the community model against a float64 weighted mean of the uplinks,
# relative to max|w| per tensor (an f32 accumulator over 3 models)
FED_F64_REL = 1e-6
# flash vs dense gradients of one batch, per tensor, relative L2: both
# paths round every bf16 activation, in other places (the dense path
# rounds the scores to bf16 before its softmax), through 8 blocks
GRAD_REL_L2 = 5e-2
# flash vs dense logits at bf16 compute: both round every activation to
# 8 mantissa bits, in other places (the kernel keeps fp32 scores, the dense
# path rounds them to bf16 first), through 8 residual blocks
LOGITS_ATOL = 0.1

# peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi unavailable: " + out.stderr.strip())


# back-to-back calls under the profiler for one device-time figure
PROFILED_CALLS = 20


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one call of ``fn``: ``iters`` calls queued with no sync
    between them (the device runs behind), over ``iters``. Where it is
    near ``time_ms``, the host paces the calls, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / iters


def device_ms(fn):
    """Mean device time of one call of ``fn`` by the profiler, over
    ``PROFILED_CALLS`` back-to-back calls. Where a call's host work is as
    long as its kernels (K1 and SDPA's forward take tens of µs), CUDA
    events around eager calls also count the host's pace; this does not."""
    profiled = profile_call(lambda: [fn() for _ in range(PROFILED_CALLS)],
                            top=2)
    if not isinstance(profiled, dict):
        return None
    return profiled["device_ms"] / PROFILED_CALLS


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 - recorded, the run goes on
            traceback.print_exc()
            self.failures.append(f"{name}: raised")
            return None
        finally:
            print(f"-- {name}: {time.perf_counter() - t0:.3f} s", flush=True)


# the six kernel wrappers, by name: K1-K3 and their general-D kernels
KERNEL_WRAPPERS = ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_fwd_general", "flash_bwd_dq_general",
                   "flash_bwd_dkv_general")
# a wrapper's name in the kernels line, where it differs
ROW_NAMES = {"flash_attention_fwd": "flash_fwd"}


def kernel_wrappers():
    import importlib

    # the module (``ops.flash_attention`` also names a function)
    fa = importlib.import_module("metisfl_tpu_torch.ops.flash_attention")
    return [getattr(fa, name) for name in KERNEL_WRAPPERS]


def launch_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def reset_launches():
    for fn in kernel_wrappers():
        fn.launches = 0


def attention_case(smoke, name, B, Hq, Hkv, L, D, dtype_name, causal,
                   o_atol, lse_atol, kernel="flash_attention_fwd"):
    """One kernel-vs-plain comparison, timed; returns its record.
    ``kernel`` names the wrapper that must have launched."""
    import torch
    import torch.nn.functional as F

    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)
        for shape in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    before = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    o2, lse2 = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in launch_counts().items() if
                c - before[n]}
    smoke.check(set(launched) == {kernel},
                f"{name}: the forward ran on {kernel}: launches {launched}")
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    o_err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    smoke.check(bool(torch.isfinite(o).all()) and o_err <= o_atol
                and lse_err <= lse_atol,
                f"{name}: o err {o_err:.3g} <= {o_atol}, lse err "
                f"{lse_err:.3g} <= {lse_atol}")
    smoke.check(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"{name}: two runs of K1 give bit-identical o and lse")

    def kernel():
        return flash_attention_fwd(q, k, v, causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=Hq != Hkv)

    kernel_ms = time_ms(kernel)
    kernel_device_ms = device_ms(kernel)
    kernel_host_ms = host_ms(kernel)
    plain_ms = time_ms(lambda: flash_attention_fwd_reference(q, k, v,
                                                             causal),
                       iters=5)
    try:
        library_ms = time_ms(library)
        library_device_ms = device_ms(library)
    except (TypeError, RuntimeError) as exc:
        print(f"library call unavailable: {exc}")
        library_ms = library_device_ms = None

    # the work these inputs need: causal keeps L(L+1)/2 (q, k) pairs per
    # head; QK^T and PV are 2·D operations per pair each
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4.0 * D * B * Hq * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * q.element_size() \
        + lse.numel() * 4
    flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    record = {
        "name": name, "shape": [B, Hq, Hkv, L, D], "dtype": dtype_name,
        "causal": causal, "max_abs_err": o_err, "max_abs_err_lse": lse_err,
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "kernel_host_ms": kernel_host_ms, "plain_ms": plain_ms, "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "tflops_device": flops / (kernel_device_ms * 1e-3) / 1e12
        if kernel_device_ms else None,
    }
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


def backward_case(smoke, name, B, Hq, Hkv, L, D, dtype_name, causal,
                  rel_tol, kernels=("flash_bwd_dq", "flash_bwd_dkv")):
    """K2 and K3 against their plain versions on the card, each twice for
    bit-identity, all timed; returns one record per kernel, named by
    ``kernels`` (the wrappers that must have launched)."""
    import torch
    import torch.nn.functional as F

    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(SEED + 3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)
        for shape in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D),
                      (B, Hq, L, D)))
    o, lse = flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    before = launch_counts()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dq2 = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in launch_counts().items() if
                c - before[n]}
    smoke.check(set(launched) == set(kernels),
                f"{name}: the backward ran on {sorted(kernels)}: launches "
                f"{launched}")
    want_dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    want_dk, want_dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal)
    errs = {}
    for label, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                             ("dv", dv, want_dv)):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        errs[label] = err
        smoke.check(bool(torch.isfinite(got).all()) and err <= rel_tol * scale,
                    f"{name}: {label} err {err:.3g} <= {rel_tol} x max|ref| "
                    f"{scale:.3g}")
    smoke.check(torch.equal(dq, dq2),
                f"{name}: two runs of K2 give bit-identical dQ")
    smoke.check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                f"{name}: two runs of K3 give bit-identical dK and dV")

    def run_dq():
        return flash_bwd_dq(q, k, v, do, lse, delta, causal)

    def run_dkv():
        return flash_bwd_dkv(q, k, v, do, lse, delta, causal)

    # by CUDA events, by the profiler's device time and on the host's
    # clock: a kernel that is slower tells from a host that paces it
    dq_ms, dkv_ms = time_ms(run_dq), time_ms(run_dkv)
    dq_device, dkv_device = device_ms(run_dq), device_ms(run_dkv)
    dq_host, dkv_host = host_ms(run_dq), host_ms(run_dkv)
    dq_plain = time_ms(lambda: flash_bwd_dq_reference(
        q, k, v, do, lse, delta, causal), iters=5)
    dkv_plain = time_ms(lambda: flash_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal), iters=5)

    # the library yardstick for the pair: one call of SDPA's backward
    # (autograd.grad on a saved SDPA forward of the same q, k, v, with the
    # same dO), timed by CUDA events, and the device time of its kernels
    # under the profiler (the call's own host work between them aside);
    # the port never calls it
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    library_ms = library_device_ms = None
    try:
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=Hq != Hkv)

        def sdpa_backward():
            return torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)

        library_ms = time_ms(sdpa_backward)
        profiled = profile_call(sdpa_backward, top=8)
        if isinstance(profiled, dict):
            library_device_ms = profiled["device_ms"]
    except (TypeError, RuntimeError) as exc:
        print(f"library call unavailable: {exc}")

    # the work these inputs need: per (q, k) pair and head, K2 does QK^T,
    # dO V^T and dS K (6 D operations), K3 adds P^T dO and dS^T Q (8 D)
    pairs = B * Hq * (L * (L + 1) // 2 if causal else L * L)
    size = q.element_size()
    ins = (q.numel() * 2 + k.numel() * 2) * size + lse.numel() * 4 * 2
    records = []
    for kernel, ms, dev, host, plain, per_pair, outs, err in (
            (kernels[0], dq_ms, dq_device, dq_host, dq_plain, 6, q.numel(),
             errs["dq"]),
            (kernels[1], dkv_ms, dkv_device, dkv_host, dkv_plain, 8,
             2 * k.numel(), max(errs["dk"], errs["dv"]))):
        flops = float(per_pair * D * pairs)
        nbytes = ins + outs * size
        flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        records.append({
            "name": kernel, "case": name, "shape": [B, Hq, Hkv, L, D],
            "dtype": dtype_name, "causal": causal, "max_abs_err": err,
            "kernel_ms": ms, "kernel_device_ms": dev,
            "kernel_host_ms": host, "plain_ms": plain,
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        })
    print(json.dumps({"kernel_case": records}), flush=True)
    return records


def random_variables(module, seed: int):
    """Flax-named numpy weights for ``module``'s parameter shapes: dense
    kernels N(0, 1/fan_in), embeddings N(0, 1), norm scales one."""
    from metisfl_tpu_torch.models.convert import flax_name

    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            arr = np.ones(shape, np.float32)
        else:
            std = 1.0 if leaf == "embedding" else 1.0 / np.sqrt(shape[0])
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= np.float32(std)
        node = tree
        *parents, last = flax_name(name).split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = arr
    return tree


def run_concurrently(fn, n):
    results, errors = [None] * n, []

    def call(i):
        try:
            results[i] = fn(i)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent requests failed: {errors[:3]}")
    return results, wall


def slice_phase(smoke, gpu):
    import torch

    from metisfl_tpu_torch.config import ServingConfig, ServingDecodeConfig
    from metisfl_tpu_torch.models import TorchModelOps, load_flax_variables
    from metisfl_tpu_torch.models.zoo import LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import flash_attention_fwd
    from metisfl_tpu_torch.serving import ServingGateway
    from metisfl_tpu_torch.tensor import pack_model

    cfg = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
               kv_heads=KV_HEADS, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    variables = random_variables(LlamaLite(**cfg, device="meta"), SEED)
    n_params = sum(a.size for a in _leaves(variables))
    blob = pack_model(variables)
    ops = TorchModelOps(LlamaLite(**cfg, use_flash=True),
                        variables=variables, device=DEVICE)
    gateway = ServingGateway(
        ops, ServingConfig(max_batch=MAX_BATCH, max_wait_ms=50.0,
                           decode=ServingDecodeConfig(slots=SLOTS,
                                                      max_len=MAX_LEN)),
        device=DEVICE)
    gateway.install("stable", 1, blob)
    print(f"model: {n_params} params, blob {len(blob)} bytes, built and "
          f"installed in {time.perf_counter() - t0:.3f} s", flush=True)
    out = {"params": n_params}
    try:
        rng = np.random.default_rng(SEED + 1)
        rows = rng.integers(0, VOCAB, (PREDICT_REQUESTS, 1, PREDICT_LEN)
                            ).astype(np.int32)
        # warm-up request (cuBLAS handles, allocator), outside the counts
        t1 = time.perf_counter()
        gateway.predict(rows[0], key="warmup")
        out["predict_first_s"] = time.perf_counter() - t1

        flash_attention_fwd.launches = 0
        ops.forward_calls = 0
        replies, wall = run_concurrently(
            lambda i: gateway.predict(rows[i], key=f"user-{i}"),
            PREDICT_REQUESTS)
        launches = flash_attention_fwd.launches
        forwards = ops.forward_calls
        out.update(predict_wall_s=wall, predict_forwards=forwards,
                   predict_tokens_per_s=PREDICT_REQUESTS * PREDICT_LEN / wall,
                   flash_launches=launches)
        smoke.check(all(r[0].shape == (1, PREDICT_LEN, VOCAB)
                        and r[1] == 1 and r[2] == "stable" for r in replies),
                    f"predict: logits (1, {PREDICT_LEN}, {VOCAB}) from "
                    "version 1")
        smoke.check(all(np.isfinite(r[0]).all() for r in replies),
                    "predict: logits finite")
        smoke.check(forwards >= PREDICT_REQUESTS // MAX_BATCH
                    and launches == DEPTH * forwards,
                    f"predict: {launches} flash launches = {DEPTH} per "
                    f"forward x {forwards} forwards")

        dense = load_flax_variables(LlamaLite(**cfg, use_flash=False,
                                              device=DEVICE),
                                    variables).eval()
        with torch.no_grad():
            want = dense(torch.as_tensor(rows[0], device=DEVICE)).cpu().numpy()
        err = float(np.abs(replies[0][0] - want).max())
        agree = float((replies[0][0].argmax(-1) == want.argmax(-1)).mean())
        out.update(flash_vs_dense_max_abs_err=err,
                   flash_vs_dense_argmax_agreement=agree,
                   logits_max_abs=float(np.abs(want).max()))
        smoke.check(err <= LOGITS_ATOL,
                    f"predict vs dense path: max abs err {err:.4g} <= "
                    f"{LOGITS_ATOL} (argmax agreement {agree:.4f})")
        del dense, want
        if DEVICE == "cuda":  # a device-time breakdown; none on the CPU
            out["predict_profile"] = profile_call(lambda: ops.infer(
                np.repeat(rows[0], MAX_BATCH, axis=0), batch_size=MAX_BATCH))

        prompts = np.random.default_rng(SEED + 2).integers(
            0, VOCAB, (GEN_REQUESTS, PROMPT_LEN)).astype(np.int32)
        gens, gen_wall = run_concurrently(
            lambda i: gateway.generate(prompts[i], NEW_TOKENS,
                                       key=f"gen-{i}"), GEN_REQUESTS)
        out.update(generate_wall_s=gen_wall,
                   generate_tokens_per_s=GEN_REQUESTS * NEW_TOKENS / gen_wall)
        smoke.check(all(t.shape == (NEW_TOKENS,) and v == 1
                        and ((0 <= t) & (t < VOCAB)).all()
                        for t, v, _ in gens),
                    f"generate: {NEW_TOKENS} in-vocab tokens per request "
                    "from version 1")
        t2 = time.perf_counter()
        solos = [ops.generate(p[None], NEW_TOKENS, max_len=MAX_LEN)[0]
                 for p in prompts]
        out["generate_solo_s"] = time.perf_counter() - t2
        same = [bool(np.array_equal(g[0], s)) for g, s in zip(gens, solos)]
        token_agree = float(np.mean([np.mean(g[0] == s)
                                     for g, s in zip(gens, solos)]))
        if DEVICE == "cuda":
            out["generate_solo_profile"] = profile_call(
                lambda: ops.generate(prompts[0][None], NEW_TOKENS,
                                     max_len=MAX_LEN))
        out.update(generate_requests_equal_solo=sum(same),
                   generate_token_agreement=token_agree,
                   decode=gateway.describe()["decode"]["stable"])
        print(f"generate: {sum(same)}/{GEN_REQUESTS} requests equal a solo "
              f"generate; token agreement {token_agree:.4f}", flush=True)
    finally:
        gateway.shutdown()
    out["gpu"] = gpu
    print(json.dumps({"slice": out}), flush=True)
    return out


def training_phase(smoke, gpu):
    import torch
    import torch.nn.functional as F

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.models import (
        ArrayDataset,
        TorchModelOps,
        load_flax_variables,
    )
    from metisfl_tpu_torch.models.zoo import LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from metisfl_tpu_torch.tensor import ModelBlob, pack_model, unpack_model

    cfg = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
               kv_heads=KV_HEADS, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    variables = random_variables(LlamaLite(**cfg, device="meta"), SEED)
    blob = pack_model(variables)
    ops = TorchModelOps(LlamaLite(**cfg, use_flash=True),
                        variables=ModelBlob.from_bytes(blob).tensors,
                        device=DEVICE)
    del variables
    print(f"training model: {ops.param_count()} params, installed from a "
          f"{len(blob)}-byte blob in {time.perf_counter() - t0:.3f} s",
          flush=True)
    tokens = np.random.default_rng(SEED + 4).integers(
        0, VOCAB, (TRAIN_ROWS, TRAIN_LEN + 1)).astype(np.int32)
    data = ArrayDataset(tokens[:, :-1], tokens[:, 1:], seed=SEED)
    params = TrainParams(batch_size=TRAIN_BATCH, local_steps=TRAIN_STEPS,
                         optimizer="adam", learning_rate=1e-4)
    out = {"params": ops.param_count()}

    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    result = ops.train(data, params)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    k1, k2, k3 = (fn.launches for fn in counters)
    losses = [e["loss"] for e in result.epoch_metrics]
    out.update(train_wall_s=wall, ms_per_step=result.ms_per_step,
               tokens_per_s=TRAIN_BATCH * TRAIN_LEN
               / (result.ms_per_step / 1e3) if result.ms_per_step else None,
               epoch_losses=losses, train_metrics=result.train_metrics,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9
               if DEVICE == "cuda" else None,
               launches={"flash_fwd": k1, "flash_bwd_dq": k2,
                         "flash_bwd_dkv": k3})
    want = DEPTH * TRAIN_STEPS
    smoke.check(result.completed_steps == TRAIN_STEPS
                and all(np.isfinite(losses)),
                f"train: {result.completed_steps} steps, epoch losses "
                f"{[round(x, 4) for x in losses]} finite")
    # 2 steps per epoch: the first and last epochs are the first and last
    # 2 steps
    smoke.check(len(losses) == 3 and losses[-1] < losses[0],
                f"train: mean loss of the last 2 steps {losses[-1]:.4f} < "
                f"the first 2 {losses[0]:.4f}")
    smoke.check(k2 == k3 == want and k1 >= want,
                f"train: K2 {k2} and K3 {k3} launches = depth x steps = "
                f"{want}, K1 {k1} >= {want}")
    print(f"train: {result.ms_per_step:.2f} ms per step, "
          f"{out['tokens_per_s']:.0f} tokens/s, wall {wall:.3f} s",
          flush=True)

    scores = ops.evaluate(data, batch_size=TRAIN_BATCH,
                          metrics=["accuracy"])
    out["evaluate"] = scores
    smoke.check(set(scores) == {"loss", "accuracy"}
                and all(np.isfinite(list(scores.values()))),
                f"evaluate: {scores}")

    trained = result.variables
    back = unpack_model(pack_model(trained), trained)
    same = all(np.array_equal(a, b)
               for a, b in zip(_leaves(back), _leaves(trained)))
    smoke.check(same, "trained weights pack into a blob and unpack equal")

    # one batch's gradients, flash path vs dense path, same weights
    x = torch.as_tensor(tokens[:TRAIN_BATCH, :-1], device=DEVICE)
    y = torch.as_tensor(tokens[:TRAIN_BATCH, 1:], device=DEVICE).long()
    dense = load_flax_variables(LlamaLite(**cfg, use_flash=False,
                                          device=DEVICE), trained)

    def grads(model):
        logits = model(x, train=True)
        loss = F.cross_entropy(logits.reshape(-1, VOCAB), y.reshape(-1))
        return torch.autograd.grad(loss, list(model.parameters()))

    rel = [float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))
           for a, b in zip(grads(ops.module), grads(dense))]
    names = [n for n, _ in ops.module.named_parameters()]
    worst = int(np.argmax(rel))
    out.update(grad_rel_l2_max=rel[worst], grad_rel_l2_worst=names[worst],
               grad_rel_l2_median=float(np.median(rel)))
    smoke.check(rel[worst] <= GRAD_REL_L2,
                f"flash vs dense gradients: largest relative L2 error "
                f"{rel[worst]:.4g} ({names[worst]}) <= {GRAD_REL_L2}")
    del dense
    if DEVICE == "cuda":  # a device-time breakdown of one training step
        # train() ends by copying the weights to the host (TrainOutput's
        # numpy tree); the breakdown lists enough rows to see past it
        out["train_step_profile"] = profile_call(lambda: ops.train(
            data, TrainParams(batch_size=TRAIN_BATCH, local_steps=1,
                              optimizer="adam", learning_rate=1e-4)),
            top=16)
    out["gpu"] = gpu
    print(json.dumps({"train": out}), flush=True)
    return out


# -- federation phase: the synchronous FedAvg round through InProcessFederation

def synthetic_image_classification(n, height=28, width=28, channels=1,
                                   num_classes=10, noise=0.35, seed=SEED):
    """Class-template images plus Gaussian noise: learnable, offline, and
    Fashion-MNIST's shapes and dtypes (the JAX package's examples make
    their stand-in the same way)."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal(
        (num_classes, height, width, channels)).astype(np.float32)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = templates[y] + noise * rng.standard_normal(
        (n, height, width, channels)).astype(np.float32)
    return x.astype(np.float32), y


class RoundProbe:
    """Watches one in-process federation by wrapping instance methods (the
    port itself is left as it is): each round's community blob, every
    uplink, and the time each learner spends per round in each stage."""

    def __init__(self, fed):
        self.fed = fed
        self.rounds = fed.config.termination.federation_rounds
        self.communities = []    # per round: the community blob
        self.uplinks = {}        # round -> {learner_id: blob}
        self.times = {}          # (learner index, stage) -> [s, per round]
        self.pack_s = []         # controller: community blob encode
        self.ms_per_step = {}    # round -> {learner_id: ms}
        self._lock = threading.Lock()
        for i, learner in enumerate(fed.learners):
            self._wrap_learner(i, learner)
        pack = fed.controller._community_to_blob

        def community_to_blob(community):
            t0 = time.perf_counter()
            blob = pack(community)
            with self._lock:
                self.pack_s.append(time.perf_counter() - t0)
                self.communities.append(blob)
            return blob

        fed.controller._community_to_blob = community_to_blob
        done = fed.controller.task_completed

        def task_completed(result):
            with self._lock:
                self.uplinks.setdefault(result.round_id, {})[
                    result.learner_id] = result.model
                self.ms_per_step.setdefault(result.round_id, {})[
                    result.learner_id] = result.processing_ms_per_step
            return done(result)

        fed.controller.task_completed = task_completed

    def _record(self, i, stage):
        def note(dt):
            on_train = threading.current_thread().name.startswith(
                "learner-train")
            key = (i, stage if on_train else "eval_" + stage)
            with self._lock:
                self.times.setdefault(key, []).append(dt)
        return note

    @staticmethod
    def _wrap(obj, name, note):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                note(time.perf_counter() - t0)

        setattr(obj, name, timed)

    def _wrap_learner(self, i, learner):
        ops = learner.model_ops
        for obj, name, stage in (
                (learner, "_load_model", "downlink_unpack"),
                (ops, "set_variables", "load_flax_variables"),
                (ops, "train", "train_call"),
                (ops, "get_variables", "weights_copy_out"),
                (learner, "_dump_model", "blob_pack")):
            self._wrap(obj, name, self._record(i, stage))

    def split(self, stats):
        """Per round: the wall time and its split into stages (learner
        stages are means over the learners), from the probe and the
        controller's round metadata."""
        out = []
        n = len(self.fed.learners)
        for r in range(self.rounds):
            meta = stats["round_metadata"][r]

            def mean(stage):
                return float(np.mean([self.times[(i, stage)][r]
                                      for i in range(n)]))

            copy_out = mean("weights_copy_out")
            pack = self.pack_s[r] if r < len(self.pack_s) else 0.0
            out.append({
                "round": r,
                "wall_s": meta["completed_at"] - meta["started_at"],
                "learner_s": {
                    "downlink_unpack": mean("downlink_unpack"),
                    "load_flax_variables": mean("load_flax_variables"),
                    "train": mean("train_call") - copy_out,
                    "weights_copy_out": copy_out,
                    "blob_pack": mean("blob_pack"),
                },
                "controller_s": {
                    "ingest_per_uplink": float(np.mean(list(
                        meta["model_insertion_duration_ms"].values())))
                    / 1e3,
                    "fold": meta["aggregation_duration_ms"] / 1e3 - pack,
                    "community_pack": pack,
                },
                "uplink_bytes": meta["uplink_bytes"],
                "ms_per_step": self.ms_per_step.get(r, {}),
            })
        return out


def run_federation(fed, timeout_s=600.0):
    """Start ``fed``, wait for its ``termination.federation_rounds`` rounds
    and every learner's evaluation of each, shut it down; returns (probe,
    statistics)."""
    probe = RoundProbe(fed)
    rounds = probe.rounds
    n = len(fed.learners)

    def evaluated():
        entries = fed.statistics()["community_evaluations"]
        return sum(len(e["evaluations"]) == n for e in entries) >= rounds

    try:
        t0 = time.perf_counter()
        fed.start()
        ok = (fed.wait_for_rounds(rounds, timeout_s)
              and fed.wait_until(evaluated, timeout_s))
        wall = time.perf_counter() - t0
        stats = fed.statistics()
    finally:
        fed.shutdown()
    if not ok:
        raise RuntimeError(f"federation did not complete {rounds} rounds "
                           f"with evaluations in {timeout_s} s")
    stats["wall_s"] = wall
    return probe, stats


def check_folds(smoke, label, probe, stats, rounds, f64_rel=None):
    """Each round's community model against an independent FedAvg of the
    uplinks its cohort shipped (re-read from the wire bytes, scaled as the
    controller's scaler scales them): bit for bit, and, with ``f64_rel``,
    within ``f64_rel`` x max|w| of a float64 numpy weighted mean."""
    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import to_numpy

    def parse(blob):
        return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(blob).tensors}

    sizes = {learner.learner_id: len(learner.datasets["train"])
             for learner in probe.fed.learners}
    scaler = make_scaler(probe.fed.config.aggregation.scaler)
    worst_f64 = 0.0
    for r in range(rounds):
        selected = stats["round_metadata"][r]["selected_learners"]
        scales = scaler({lid: {"num_train_examples": sizes[lid]}
                         for lid in selected})
        ups = [parse(probe.uplinks[r][lid]) for lid in selected]
        want = FedAvg().aggregate([([m], scales[lid])
                                   for lid, m in zip(selected, ups)])
        got = parse(probe.communities[r])
        same = sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype
            and got[k].tobytes() == want[k].tobytes() for k in want)
        smoke.check(same, f"{label} round {r}: community model equals a "
                    f"FedAvg re-fold of the {len(ups)} shipped blobs, bit "
                    "for bit")
        if f64_rel is not None:
            for k in want:
                mean = sum(scales[lid] * m[k].astype(np.float64)
                           for lid, m in zip(selected, ups))
                mean /= sum(scales.values())
                scale = max(float(np.abs(mean).max()), 1e-30)
                worst_f64 = max(worst_f64, float(np.abs(
                    got[k].astype(np.float64) - mean).max()) / scale)
    if f64_rel is not None:
        smoke.check(worst_f64 <= f64_rel,
                    f"{label}: community within {worst_f64:.3g} x max|w| of "
                    f"the float64 weighted mean (<= {f64_rel})")
    return worst_f64


def _accuracies(stats, key="accuracy"):
    out = []
    for entry in sorted(stats["community_evaluations"],
                        key=lambda e: e["global_iteration"]):
        vals = [v["test"][key] for v in entry["evaluations"].values()]
        out.append(float(np.mean(vals)))
    return out


def federation_phase(smoke, gpu, label="federation", make_federation=None):
    """(a) a FashionMNIST CNN round and (b) a full-width LlamaLite round,
    each through the port's InProcessFederation (or ``make_federation``)
    with its learners on ``DEVICE``."""
    import torch

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.driver import InProcessFederation

    make_federation = make_federation or InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    out = {"learners": FED_LEARNERS}

    # (a) FashionMNIST: 3 learners x 3 rounds of 20 SGD steps
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    test = ArrayDataset(x[-CNN_TEST:], y[-CNN_TEST:])
    cfg = FederationConfig(
        aggregation=AggregationConfig(scaler="train_dataset_size"),
        train=TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                          optimizer="sgd", learning_rate=0.05),
        eval=EvalConfig(batch_size=256, datasets=["test"],
                        metrics=["loss", "accuracy"]),
        termination=TerminationConfig(federation_rounds=CNN_ROUNDS))
    fed = make_federation(cfg)
    template = None
    for i in range(FED_LEARNERS):
        ops = TorchModelOps(FashionMnistCNN(), rng_seed=SEED, device=DEVICE,
                            variables=template)
        template = template or ops.get_variables()
        part = slice(i * CNN_EXAMPLES, (i + 1) * CNN_EXAMPLES)
        fed.add_learner(ops, ArrayDataset(x[part], y[part], seed=SEED + i),
                        test_dataset=test)
    fed.seed_model(template)
    probe, stats = run_federation(fed)
    smoke.check(stats["global_iteration"] >= CNN_ROUNDS,
                f"cnn {label}: {stats['global_iteration']} of "
                f"{CNN_ROUNDS} rounds complete")
    on_device = all(p.device.type == torch.device(DEVICE).type
                    for learner in fed.learners
                    for p in learner.model_ops.module.parameters())
    smoke.check(on_device, f"cnn {label}: every learner's parameters "
                f"are on {DEVICE}")
    acc = _accuracies(stats)
    smoke.check(len(acc) >= CNN_ROUNDS and acc[CNN_ROUNDS - 1] > acc[0]
                and acc[CNN_ROUNDS - 1] > 0.1,
                f"cnn {label}: community test accuracy by round "
                f"{[round(a, 4) for a in acc]} rises above the first "
                "round's and above chance (0.1)")
    check_folds(smoke, f"cnn {label}", probe, stats, CNN_ROUNDS)
    walls = [m["completed_at"] - m["started_at"]
             for m in stats["round_metadata"][:CNN_ROUNDS]]
    print(f"cnn {label}: round walls {[round(w, 3) for w in walls]} s",
          flush=True)
    out["cnn"] = {"rounds": CNN_ROUNDS, "round_wall_s": walls,
                  "test_accuracy": acc, "wall_s": stats["wall_s"],
                  "split": probe.split(stats)}
    del fed, probe, ops, template
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # (b) full-width LlamaLite: 3 learners x FED_ROUNDS of 2 Adam steps
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables = random_variables(LlamaLite(**llama, device="meta"), SEED)

    def llama_config(rounds):
        return FederationConfig(
            aggregation=AggregationConfig(scaler="train_dataset_size"),
            train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                              optimizer="adam", learning_rate=1e-4),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=rounds))

    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])

    def llama_federation(rounds):
        fed = make_federation(llama_config(rounds))
        for i in range(FED_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            ops = TorchModelOps(LlamaLite(**llama, use_flash=True),
                                variables=variables, device=DEVICE)
            fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                              seed=SEED + i),
                            test_dataset=test)
        fed.seed_model(variables)
        return fed

    t0 = time.perf_counter()
    fed = llama_federation(FED_ROUNDS)
    n_params = fed.learners[0].model_ops.param_count()
    print(f"llama {label}: {FED_LEARNERS} learners of {n_params} params "
          f"built in {time.perf_counter() - t0:.3f} s", flush=True)
    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    probe, stats = run_federation(fed)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    k1, k2, k3 = (fn.launches for fn in counters)
    smoke.check(stats["global_iteration"] >= FED_ROUNDS,
                f"llama {label}: {stats['global_iteration']} of "
                f"{FED_ROUNDS} rounds complete")
    train_launches = FED_LEARNERS * FED_ROUNDS * FED_STEPS * DEPTH
    eval_batches = -(-FED_EVAL_ROWS // TRAIN_BATCH)
    eval_launches = FED_LEARNERS * FED_ROUNDS * eval_batches * DEPTH
    smoke.check(k2 == k3 == train_launches
                and k1 == train_launches + eval_launches,
                f"llama {label}: K2 {k2} and K3 {k3} launches = learners "
                f"x rounds x steps x depth = {train_launches}; K1 {k1} = "
                f"{train_launches} + {eval_launches} (evaluation)")
    losses = [v["loss"] for m in stats["round_metadata"][:FED_ROUNDS]
              for v in m["train_metrics"].values()]
    eval_losses = _accuracies(stats, "loss")
    smoke.check(len(losses) == FED_LEARNERS * FED_ROUNDS
                and all(np.isfinite(losses + eval_losses)),
                f"llama {label}: train losses "
                f"{[round(v, 4) for v in losses]} and community eval losses "
                f"{[round(v, 4) for v in eval_losses]} finite")
    worst = check_folds(smoke, f"llama {label}", probe, stats, FED_ROUNDS,
                        f64_rel=FED_F64_REL)
    split = probe.split(stats)
    out["llama"] = {
        "params": n_params, "rounds": FED_ROUNDS, "steps": FED_STEPS,
        "round_wall_s": [s["wall_s"] for s in split], "split": split,
        "wall_s": stats["wall_s"],
        "blob_bytes": len(fed.controller.community_model_bytes()),
        "launches": {"flash_fwd": k1, "flash_bwd_dq": k2,
                     "flash_bwd_dkv": k3},
        "expected_launches": {"flash_fwd": train_launches + eval_launches,
                              "flash_bwd_dq": train_launches,
                              "flash_bwd_dkv": train_launches},
        "train_losses": losses, "eval_losses": eval_losses,
        "f64_rel_err": worst,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
        if DEVICE == "cuda" else None,
    }
    print(f"llama {label}: round walls "
          f"{[round(s['wall_s'], 3) for s in split]} s", flush=True)
    del fed, probe
    if PROFILE_ROUND and DEVICE == "cuda":
        # with --profile-round: one more round, on a fresh federation,
        # under the profiler: the device's share of a round and its
        # kernels (the timed rounds above ran without it; this round's
        # launches are not counted)
        torch.cuda.empty_cache()
        fed = llama_federation(1)
        out["llama"]["round_profile"] = profile_call(
            lambda: run_federation(fed), top=12)
        del fed
    del variables
    out["gpu"] = gpu
    print(json.dumps({label: out}), flush=True)
    return out


class DirectClient:
    """A stand-in for ``RpcClient`` where grpc is not installed: it calls a
    service's handler in this process, with the same bytes a gRPC call
    would carry (asynchronous calls on a thread of their own)."""

    def __init__(self, service):
        self.handlers = service.handlers
        self.threads = []

    def call(self, method, payload, **kwargs):
        return self.handlers[method](payload)

    def call_async(self, method, payload, callback=None,
                   error_callback=None, **kwargs):
        def run():
            try:
                result = self.handlers[method](payload)
            except Exception as exc:  # noqa: BLE001 - as a failed RPC
                if error_callback is None:
                    raise
                error_callback(exc)
                return
            if callback is not None:
                callback(result)

        thread = threading.Thread(target=run, daemon=True)
        self.threads.append(thread)
        thread.start()

    def close(self):
        for thread in self.threads:
            thread.join(timeout=60)


def _service(server, name):
    return next(s for s in server.services if s.service_name == name)


def wire_federation_class():
    """``WireFederation``: the in-process federation's interface over the
    port's ``ControllerServer`` and ``LearnerServer`` handlers, wired by
    :class:`DirectClient`s, so every message crosses the codec, the
    messages and the services as over gRPC."""
    from metisfl_tpu_torch.controller.service import (
        CONTROLLER_SERVICE,
        LEARNER_SERVICE,
        ControllerClient,
        ControllerServer,
        RpcLearnerProxy,
    )
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.learner import Learner
    from metisfl_tpu_torch.learner.service import LearnerServer
    from metisfl_tpu_torch.tensor import pack_model

    class DirectLearnerProxy(RpcLearnerProxy):
        def __init__(self, record, client):
            self._learner_id = record.learner_id
            self._client = client

    class DirectControllerClient(ControllerClient):
        def __init__(self, client):
            self._client = client

        def _call(self, method, payload, **kwargs):
            return self._client.call(method, payload)

    class WireFederation(InProcessFederation):
        def __init__(self, config):
            self._servers = {}
            self._clients = []
            super().__init__(config)
            self.server = ControllerServer(self.controller)

        def _direct(self, service):
            client = DirectClient(service)
            self._clients.append(client)
            return client

        def _make_proxy(self, record):
            server = self._servers[record.port]
            return DirectLearnerProxy(record, self._direct(
                _service(server, LEARNER_SERVICE)))

        def _controller_client(self):
            return DirectControllerClient(self._direct(
                _service(self.server, CONTROLLER_SERVICE)))

        def add_learner(self, model_ops, train_dataset, val_dataset=None,
                        test_dataset=None):
            port = 50100 + len(self.learners)
            learner = Learner(model_ops=model_ops,
                              train_dataset=train_dataset,
                              val_dataset=val_dataset,
                              test_dataset=test_dataset, port=port,
                              controller=self._controller_client())
            self._servers[port] = LearnerServer(learner)
            self.learners.append(learner)
            return learner

        def seed_model(self, variables):
            self._controller_client().replace_community_model(
                pack_model(variables))

        def shutdown(self):
            for server in self._servers.values():
                server.stop(leave=False)
            self.server.stop()
            for client in self._clients:
                client.close()

    return WireFederation


def wire_phase(smoke, gpu):
    """The federation phase's CNN and LlamaLite rounds through the port's
    services, wired by direct calls in place of gRPC."""
    return federation_phase(smoke, gpu, label="wire",
                            make_federation=wire_federation_class())


# -- multiprocess phase: the same rounds with one process per learner, over
# localhost gRPC, through DriverSession

MP_DIR = os.path.join(REPO, "build", "chip_smoke_multiprocess")
# a bound on every wait of the phase (process boot, rounds, shutdown)
MP_TIMEOUT_S = 600.0


def mp_recipe(kind, x, y, test_x, test_y, seed, device, out_dir, gate):
    """A learner recipe for ``DriverSession``: the engine on ``device``,
    wrapped to record what the phase checks without work on the timed
    path. It keeps a reference to each community model a train task
    starts from and to the weights each task ships (the learner ships
    exactly ``TrainOutput.variables``), notes each stage's start and end,
    and at process exit writes them, the process's peak device memory and
    its K1-K3 launches into ``out_dir``. Training waits for ``gate``, so
    that round 0's cohort is every learner."""

    def recipe():
        import atexit
        import copy
        import json
        import os
        import time

        import numpy as np
        import torch

        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
        from metisfl_tpu_torch.ops.flash_attention import (
            flash_attention_fwd,
            flash_bwd_dkv,
            flash_bwd_dq,
        )
        from metisfl_tpu_torch.tensor.pytree import ModelBlob

        on_cuda = device == "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if kind == "cnn":
            module = FashionMnistCNN()
        else:
            module = LlamaLite(vocab_size=VOCAB, dim=DIM, depth=DEPTH,
                               heads=HEADS, kv_heads=KV_HEADS,
                               dtype=torch.bfloat16, use_flash=True)
        ops = TorchModelOps(module, rng_seed=seed, device=device)
        rec = {"set_variables": [], "train": [], "evaluate": [],
               "blob_parse": [], "blob_pack": []}
        downs, ups = [], []
        # the learner parses every community blob it receives and packs
        # every uplink with these (this process's class, timed in place)
        from_bytes, to_bytes = ModelBlob.from_bytes, ModelBlob.to_bytes

        def timed_from_bytes(cls, data):
            t0 = time.time()
            blob = from_bytes(data)
            rec["blob_parse"].append([t0, time.time()])
            return blob

        def timed_to_bytes(self):
            t0 = time.time()
            out = to_bytes(self)
            rec["blob_pack"].append([t0, time.time()])
            return out

        ModelBlob.from_bytes = classmethod(timed_from_bytes)
        ModelBlob.to_bytes = timed_to_bytes
        set_variables, train, evaluate = (ops.set_variables, ops.train,
                                          ops.evaluate)

        def timed_set_variables(variables):
            t0 = time.time()
            set_variables(variables)
            if on_cuda:
                torch.cuda.synchronize()
            rec["set_variables"].append([t0, time.time()])
            downs.append(variables)

        def timed_train(dataset, params, *args, **kwargs):
            deadline = time.time() + MP_TIMEOUT_S
            while not os.path.exists(gate) and time.time() < deadline:
                time.sleep(0.05)
            t0 = time.time()
            out = train(dataset, params, *args, **kwargs)
            rec["train"].append([t0, time.time(), out.ms_per_step])
            # on the card TrainOutput.variables is a fresh host copy; on
            # the CPU its arrays share the parameters' memory, which the
            # next task trains in place
            ups.append(out.variables if on_cuda else copy.deepcopy(
                out.variables))
            return out

        def timed_evaluate(*args, **kwargs):
            t0 = time.time()
            out = evaluate(*args, **kwargs)
            rec["evaluate"].append([t0, time.time()])
            return out

        def flat(tree, prefix=""):
            out = {}
            for key in sorted(tree):
                name = f"{prefix}/{key}" if prefix else key
                leaf = tree[key]
                if isinstance(leaf, dict):
                    out.update(flat(leaf, name))
                else:
                    out[name] = (leaf.numpy() if torch.is_tensor(leaf)
                                 else np.asarray(leaf))
            return out

        def dump():
            rec["device"] = str(next(module.parameters()).device)
            rec["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                     if on_cuda else None)
            rec["launches"] = {fn.__name__: fn.launches for fn in (
                flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)}
            for r, tree in enumerate(ups):
                np.savez(os.path.join(out_dir, f"up_{r}.npz"), **flat(tree))
            # round r's community model is what round r + 1 starts from
            for r, tree in enumerate(downs[1:]):
                np.savez(os.path.join(out_dir, f"community_{r}.npz"),
                         **flat(tree))
            with open(os.path.join(out_dir, "record.json"), "w") as f:
                json.dump(rec, f)

        ops.set_variables = timed_set_variables
        ops.train = timed_train
        ops.evaluate = timed_evaluate
        atexit.register(dump)
        return (ops, ArrayDataset(x, y, seed=seed), None,
                ArrayDataset(test_x, test_y))

    return recipe


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def run_multiprocess(smoke, label, kind, shards, test, train, eval_cfg,
                     rounds, template, model_store=None, before_shutdown=None):
    """One DriverSession federation of ``len(shards)`` learner processes
    and a controller process (on ``model_store``, default in memory;
    ``before_shutdown()`` runs after the last round); returns (statistics,
    per-learner records, learner ids by index, workdir, the final
    community blob, walls)."""
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        FederationConfig,
        LearnerEndpoint,
        ModelStoreConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.driver import DriverSession

    workdir = os.path.join(MP_DIR, label)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gate = os.path.join(workdir, "gate")
    recipes = []
    for i, (x, y) in enumerate(shards):
        out_dir = os.path.join(workdir, f"record_{i}")
        os.makedirs(out_dir)
        recipes.append(mp_recipe(kind, x, y, test[0], test[1], SEED + i,
                                 DEVICE, out_dir, gate))
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="train_dataset_size"),
        train=train, eval=eval_cfg,
        termination=TerminationConfig(federation_rounds=rounds),
        model_store=model_store or ModelStoreConfig(),
        learners=[LearnerEndpoint() for _ in shards])
    session = DriverSession(config, template, recipes, workdir=workdir,
                            device=DEVICE)
    client = None
    t0 = time.perf_counter()
    try:
        session.initialize_federation(
            health_retries=int(MP_TIMEOUT_S / 0.5), health_sleep_s=0.5)
        client = ControllerClient("localhost", config.controller_port)
        deadline = time.time() + MP_TIMEOUT_S
        while len(client.list_learners()) < len(shards):
            session._check_procs_alive()
            if time.time() > deadline:
                raise RuntimeError(f"{label}: learners never all joined")
            time.sleep(0.1)
        ports = {}
        for i in range(len(shards)):
            with open(os.path.join(workdir, f"learner_{i}.log")) as f:
                ports[int(re.search(r"LEARNER_READY port=(\d+)",
                                    f.read()).group(1))] = i
        ids = {ports[ep["port"]]: ep["learner_id"]
               for ep in client.list_learners()}
        boot_s = time.perf_counter() - t0
        with open(gate, "w"):
            pass
        t1 = time.perf_counter()
        stats = session.monitor_federation(poll_every_s=0.25)
        run_s = time.perf_counter() - t1
        final = client.get_community_model()
        if before_shutdown is not None:
            before_shutdown()
    finally:
        if client is not None:
            client.close()
        t2 = time.perf_counter()
        session.shutdown_federation(timeout_s=MP_TIMEOUT_S)
        shutdown_s = time.perf_counter() - t2
    codes = session.process_exit_codes()
    smoke.check(len(codes) == len(shards) + 1
                and all(c == 0 for c in codes.values()),
                f"{label}: every process exits 0 after shutdown_federation "
                f"{codes}")
    records = []
    for i in range(len(shards)):
        with open(os.path.join(workdir, f"record_{i}", "record.json")) as f:
            records.append(json.load(f))
    smoke.check(all(r["device"].startswith(DEVICE) for r in records),
                f"{label}: every learner's engine ran on {DEVICE}: "
                f"{[r['device'] for r in records]}")
    walls = {"boot_s": boot_s, "rounds_s": run_s, "shutdown_s": shutdown_s}
    return stats, records, ids, workdir, final, walls


def check_mp_folds(smoke, label, stats, ids, workdir, sizes, final, rounds):
    """Each round's community model, as every learner received it (the
    last round's from the controller), bit for bit against a FedAvg
    re-fold of that round's uplinks in the order the controller folded
    them, scaled as its scaler scales them."""
    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import to_numpy

    index = {lid: i for i, lid in ids.items()}
    scaler = make_scaler("train_dataset_size")
    last = {n: to_numpy(t) for n, t in ModelBlob.from_bytes(final).tensors}
    for r in range(rounds):
        selected = stats["round_metadata"][r]["selected_learners"]
        smoke.check(sorted(index[lid] for lid in selected)
                    == list(range(len(ids))),
                    f"{label} round {r}: the cohort is every learner")
        scales = scaler({lid: {"num_train_examples": sizes[index[lid]]}
                         for lid in selected})
        want = FedAvg().aggregate([
            ([_npz(os.path.join(workdir, f"record_{index[lid]}",
                                f"up_{r}.npz"))], scales[lid])
            for lid in selected])
        gots = ([last] if r == rounds - 1 else
                [_npz(os.path.join(workdir, f"record_{i}",
                                   f"community_{r}.npz"))
                 for i in range(len(ids))])
        same = all(sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype
            and got[k].tobytes() == want[k].tobytes() for k in want)
            for got in gots)
        holder = ("the controller holds" if r == rounds - 1
                  else "every learner received")
        smoke.check(same, f"{label} round {r}: the community model {holder} "
                    f"equals a FedAvg re-fold of the {len(selected)} "
                    "uplinks, bit for bit")
        del want, gots


def mp_split(stats, records, ids, rounds):
    """Per round: the wall and its stages. Learner stages come from the
    learner's own clock and the controller's round metadata (one host, one
    clock): downlink = dispatch to the start of the blob's parse
    (community envelope encode, send, receive, envelope decode), unpack
    (blob parse into tensors), load_flax_variables, train (its weights
    copy-out included), blob pack, and uplink = the end of the pack to
    the controller's ingest (result envelope encode, send, decode).
    Controller stages: ingest (blob parse and store insert) per uplink,
    fold, and the community blob pack."""
    out = []
    for r in range(rounds):
        meta = stats["round_metadata"][r]
        learners = {}
        for i, lid in sorted(ids.items()):
            rec = records[i]
            sv0, sv1 = rec["set_variables"][r]
            tr0, tr1, ms = rec["train"][r]
            # the train task's parse is the last one before its load
            # (evaluation tasks parse community blobs too)
            parse0 = max(t0 for t0, t1 in rec["blob_parse"] if t1 <= sv0)
            pack0, pack1 = rec["blob_pack"][r]
            learners[lid] = {
                "downlink_s": parse0 - meta["train_submitted_at"][lid],
                "unpack_s": sv0 - parse0,
                "load_flax_variables_s": sv1 - sv0,
                "train_s": tr1 - tr0,
                "blob_pack_s": pack1 - pack0,
                "uplink_s": meta["train_received_at"][lid] - pack1,
                "ms_per_step": ms,
            }
        pack = meta["community_pack_duration_ms"] / 1e3
        out.append({
            "round": r,
            "wall_s": meta["completed_at"] - meta["started_at"],
            "learners": learners,
            "controller_s": {
                "ingest_per_uplink": float(np.mean(list(
                    meta["model_insertion_duration_ms"].values()))) / 1e3,
                "fold": meta["aggregation_duration_ms"] / 1e3 - pack,
                "community_pack": pack,
            },
            "uplink_bytes": meta["uplink_bytes"],
        })
    return out


def multiprocess_phase(smoke, gpu):
    """(a) the CNN and (b) the full-width LlamaLite federation of the
    federation phase, each with one controller process and one process per
    learner on ``DEVICE``, over localhost gRPC through DriverSession. The
    blobs of (b) (755 MB) travel the chunked path both ways. Without grpc
    or cloudpickle the phase cannot run; the wire phase takes its place."""
    for name in ("grpc", "cloudpickle"):
        try:
            __import__(name)
        except ImportError:
            print(f"multiprocess: not run: {name} is not installed on this "
                  "machine", flush=True)
            return wire_phase(smoke, gpu)
    import torch

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import EvalConfig
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite

    out = {"learners": FED_LEARNERS}
    # (a) FashionMNIST CNN, the federation phase's data and settings
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    shards = [(x[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES],
               y[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES])
              for i in range(FED_LEARNERS)]
    test = (x[-CNN_TEST:], y[-CNN_TEST:])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    stats, records, ids, workdir, final, walls = run_multiprocess(
        smoke, "mp cnn", "cnn", shards, test,
        TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                    optimizer="sgd", learning_rate=0.05),
        EvalConfig(batch_size=256, datasets=["test"],
                   metrics=["loss", "accuracy"]),
        CNN_ROUNDS, template)
    check_mp_folds(smoke, "mp cnn", stats, ids, workdir,
                   [len(s[0]) for s in shards], final, CNN_ROUNDS)
    acc = _accuracies(stats)
    smoke.check(len(acc) >= CNN_ROUNDS and acc[CNN_ROUNDS - 1] > acc[0]
                and acc[CNN_ROUNDS - 1] > 0.1,
                f"mp cnn: community test accuracy by round "
                f"{[round(a, 4) for a in acc]} rises above the first "
                "round's and above chance (0.1)")
    split = mp_split(stats, records, ids, CNN_ROUNDS)
    out["cnn"] = {"rounds": CNN_ROUNDS, "test_accuracy": acc,
                  "round_wall_s": [s["wall_s"] for s in split],
                  "split": split, **walls,
                  "peak_memory_gb": [r["peak_memory_gb"] for r in records]}
    print(f"mp cnn: round walls "
          f"{[round(s['wall_s'], 3) for s in split]} s", flush=True)

    # (b) full-width LlamaLite, the federation phase's data and settings
    variables = random_variables(LlamaLite(
        vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
        kv_heads=KV_HEADS, dtype=torch.bfloat16, device="meta"), SEED)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    shards = [(tokens[i * FED_ROWS:(i + 1) * FED_ROWS, :-1],
               tokens[i * FED_ROWS:(i + 1) * FED_ROWS, 1:])
              for i in range(FED_LEARNERS)]
    test = (tokens[-FED_EVAL_ROWS:, :-1], tokens[-FED_EVAL_ROWS:, 1:])
    stats, records, ids, workdir, final, walls = run_multiprocess(
        smoke, "mp llama", "llama", shards, test,
        TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                    optimizer="adam", learning_rate=1e-4),
        EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                   metrics=["loss", "accuracy"]),
        MP_ROUNDS, variables)
    del variables
    check_mp_folds(smoke, "mp llama", stats, ids, workdir,
                   [len(s[0]) for s in shards], final, MP_ROUNDS)
    launches = {name: sum(r["launches"][name] for r in records)
                for name in ("flash_attention_fwd", "flash_bwd_dq",
                             "flash_bwd_dkv")}
    train_launches = FED_LEARNERS * FED_STEPS * DEPTH
    eval_launches = FED_LEARNERS * -(-FED_EVAL_ROWS // TRAIN_BATCH) * DEPTH
    k1, k2, k3 = (launches[n] / MP_ROUNDS for n in launches)
    smoke.check(k2 == k3 == train_launches
                and k1 == train_launches + eval_launches,
                f"mp llama: per round across the learner processes K2 {k2} "
                f"and K3 {k3} launches = learners x steps x depth = "
                f"{train_launches}; K1 {k1} = {train_launches} + "
                f"{eval_launches} (evaluation)")
    losses = [v["loss"] for m in stats["round_metadata"][:MP_ROUNDS]
              for v in m["train_metrics"].values()]
    smoke.check(len(losses) == FED_LEARNERS * MP_ROUNDS
                and all(np.isfinite(losses)),
                f"mp llama: train losses {[round(v, 4) for v in losses]} "
                "finite")
    split = mp_split(stats, records, ids, MP_ROUNDS)
    out["llama"] = {
        "rounds": MP_ROUNDS, "steps": FED_STEPS,
        "round_wall_s": [s["wall_s"] for s in split], "split": split,
        **walls, "blob_bytes": len(final),
        "launches": {"flash_fwd": launches["flash_attention_fwd"],
                     "flash_bwd_dq": launches["flash_bwd_dq"],
                     "flash_bwd_dkv": launches["flash_bwd_dkv"]},
        "launches_per_round": {"flash_fwd": k1, "flash_bwd_dq": k2,
                               "flash_bwd_dkv": k3},
        "train_losses": losses,
        "peak_memory_gb": [r["peak_memory_gb"] for r in records],
    }
    print(f"mp llama: round walls "
          f"{[round(s['wall_s'], 3) for s in split]} s", flush=True)
    shutil.rmtree(MP_DIR, ignore_errors=True)
    out["gpu"] = gpu
    print(json.dumps({"multiprocess": out}), flush=True)
    return out


# -- wide-heads path: LlamaLite training at head dims beyond the main path's

# dim 1024 with 4 heads (D = 256) in bf16 (K1-K3's D = 256 builds, K3 in
# two passes) and in fp32 (K1's SIMT build, the general K2/K3), and with 2
# heads (D = 512, the general K1-K3) in bf16; depth 2, 2 Adam steps at
# batch 2 of 256 tokens
WIDE_DEPTH, WIDE_STEPS, WIDE_BATCH, WIDE_LEN = 2, 2, 2, 256
# (label, heads, compute dtype, K1's wrapper, K2's and K3's wrappers): the
# wrappers each head dim routes to; each also runs as a kernel case at the
# path's own B·H·L·D
WIDE_CASES = (
    ("d256_bf16", 4, "bfloat16", "flash_attention_fwd",
     ("flash_bwd_dq", "flash_bwd_dkv")),
    ("d256_fp32", 4, "float32", "flash_attention_fwd",
     ("flash_bwd_dq_general", "flash_bwd_dkv_general")),
    ("d512_bf16", 2, "bfloat16", "flash_fwd_general",
     ("flash_bwd_dq_general", "flash_bwd_dkv_general")),
)


def wide_heads_phase(smoke, gpu):
    """LlamaLite training through ``TorchModelOps.train`` at D = 256 and
    512: each launch lands on the kernel the head dim routes to, the loss
    stays finite and one batch's gradients hold to the dense path's."""
    import torch
    import torch.nn.functional as F

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.models import (
        ArrayDataset,
        TorchModelOps,
        load_flax_variables,
    )
    from metisfl_tpu_torch.models.zoo import LlamaLite

    steps = WIDE_DEPTH * WIDE_STEPS
    tokens = np.random.default_rng(SEED + 6).integers(
        0, VOCAB, (WIDE_BATCH, WIDE_LEN + 1)).astype(np.int32)
    data = ArrayDataset(tokens[:, :-1], tokens[:, 1:], seed=SEED)
    out = {"depth": WIDE_DEPTH, "steps": WIDE_STEPS, "cases": {}}
    total = {name: 0 for name in KERNEL_WRAPPERS}
    for label, heads, dtype_name, fwd, (dq, dkv) in WIDE_CASES:
        # K3's D = 256 build launches twice a step (dV, then dK)
        want = {fwd: steps, dq: steps,
                dkv: 2 * steps if dkv == "flash_bwd_dkv" else steps}
        # fp32 is the model's own compute dtype (None)
        dtype = None if dtype_name == "float32" else getattr(torch,
                                                             dtype_name)
        cfg = dict(vocab_size=VOCAB, dim=DIM, depth=WIDE_DEPTH, heads=heads,
                   kv_heads=heads, dtype=dtype)
        variables = random_variables(LlamaLite(**cfg, device="meta"), SEED)
        ops = TorchModelOps(LlamaLite(**cfg, use_flash=True),
                            variables=variables, device=DEVICE)
        reset_launches()
        result = ops.train(data, TrainParams(
            batch_size=WIDE_BATCH, local_steps=WIDE_STEPS, optimizer="adam",
            learning_rate=1e-4))
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        for name, n in counts.items():
            total[name] += n
        launched = {n: c for n, c in counts.items() if c}
        # K1 also runs where a block recomputes its forward
        ok = (set(launched) == set(want) and all(
            launched[n] >= c if n in ("flash_attention_fwd",
                                      "flash_fwd_general")
            else launched[n] == c for n, c in want.items()))
        smoke.check(ok, f"wide heads {label} (D = {DIM // heads}): "
                    f"launches {launched}, expected {want}")
        losses = [e["loss"] for e in result.epoch_metrics]
        smoke.check(result.completed_steps == WIDE_STEPS
                    and all(np.isfinite(losses)),
                    f"wide heads {label}: {result.completed_steps} steps, "
                    f"losses {[round(x, 4) for x in losses]} finite")
        x = torch.as_tensor(tokens[:, :-1], device=DEVICE)
        y = torch.as_tensor(tokens[:, 1:], device=DEVICE).long()
        dense = load_flax_variables(LlamaLite(**cfg, use_flash=False,
                                              device=DEVICE),
                                    result.variables)

        def grads(model):
            logits = model(x, train=True)
            loss = F.cross_entropy(logits.reshape(-1, VOCAB).float(),
                                   y.reshape(-1))
            return torch.autograd.grad(loss, list(model.parameters()))

        rel = max(float(torch.linalg.vector_norm(a - b)
                        / torch.linalg.vector_norm(b).clamp_min(1e-30))
                  for a, b in zip(grads(ops.module), grads(dense)))
        smoke.check(rel <= GRAD_REL_L2,
                    f"wide heads {label}: flash vs dense gradients, largest "
                    f"relative L2 error {rel:.4g} <= {GRAD_REL_L2}")
        out["cases"][label] = {"head_dim": DIM // heads, "launches": launched,
                               "ms_per_step": result.ms_per_step,
                               "losses": losses, "grad_rel_l2_max": rel}
        del ops, dense, variables
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = total
    out["gpu"] = gpu
    print(json.dumps({"wide_heads": out}), flush=True)
    return out


# -- store phase: the model-store layer and the native host fold

# (a) the LlamaLite federation on a cached_disk store (a 256 MB cache,
# below one 755 MB model) with 3 ingest writers; (b) the CNN with a
# process per learner on a remote store served by a store-server process
STORE_CACHE_MB, STORE_INGEST_WORKERS, STORE_CNN_ROUNDS = 256, 3, 2
# native vs numpy fold of the 3 uplinks: repetitions each, in turns
FOLD_REPS = 3


class FenceProbe:
    """Records, on one controller, when each ingest drain returns and
    each store select starts (wrapping the instances' methods)."""

    def __init__(self, controller):
        self.events = []
        self._lock = threading.Lock()
        ingest, store = controller._ingest, controller._store
        drain, select = ingest.drain, store.select

        def timed_drain(learner_id=None, timeout=None):
            ok = drain(learner_id, timeout)
            self._note("drain_all" if learner_id is None else "drain_one")
            return ok

        def timed_select(ids, k=1):
            self._note("select")
            return select(ids, k)

        ingest.drain = timed_drain
        store.select = timed_select

    def _note(self, what):
        with self._lock:
            self.events.append((what, time.perf_counter()))

    def fenced(self):
        """True when an all-learner drain returned before the first select
        (the phase runs one round)."""
        seen_drain = False
        for what, _ in self.events:
            if what == "drain_all":
                seen_drain = True
            elif what == "select" and not seen_drain:
                return False
        return seen_drain


def time_folds(uplinks, scales):
    """The native and the numpy host fold of the same models, timed in
    turns (native, numpy, numpy, native, ...), ``FOLD_REPS`` each; returns
    the seconds of each and the largest difference between the results,
    relative to max|w|."""
    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.aggregation import base as agg_base

    pairs = [([m], s) for m, s in zip(uplinks, scales)]
    times = {"native": [], "numpy": []}
    results = {}
    saved = agg_base._hostfold_lib
    order = ["native", "numpy", "numpy", "native"] * FOLD_REPS
    try:
        for which in order[:2 * FOLD_REPS]:
            agg_base._hostfold_lib = None if which == "native" else False
            t0 = time.perf_counter()
            results[which] = FedAvg().aggregate(pairs)
            times[which].append(time.perf_counter() - t0)
            if agg_base.fold_backend() != which:
                raise RuntimeError(f"the {which} fold ran as "
                                   f"{agg_base.fold_backend()}")
    finally:
        agg_base._hostfold_lib = saved
    rel = max(float(np.abs(results["native"][k].astype(np.float64)
                           - results["numpy"][k]).max())
              / max(float(np.abs(results["numpy"][k]).max()), 1e-30)
              for k in results["numpy"])
    return times, rel


def store_phase(smoke, gpu):
    """(a) the full-width LlamaLite federation in process on a cached disk
    store with parallel ingest, and the native fold; (b) the CNN with a
    process per learner on a remote store."""
    import tempfile

    import torch

    from metisfl_tpu_torch.aggregation import base as agg_base
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        ModelStoreConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import read_named_arrays, to_numpy

    out = {}
    # (a) LlamaLite, 3 learners x 1 round of 2 Adam steps
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables = random_variables(LlamaLite(**llama, device="meta"), SEED)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        fed = InProcessFederation(FederationConfig(
            aggregation=AggregationConfig(scaler="train_dataset_size"),
            train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                              optimizer="adam", learning_rate=1e-4),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=1),
            model_store=ModelStoreConfig(
                store="cached_disk", root=root, cache_mb=STORE_CACHE_MB,
                ingest_workers=STORE_INGEST_WORKERS)))
        for i in range(FED_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            fed.add_learner(
                TorchModelOps(LlamaLite(**llama, use_flash=True),
                              variables=variables, device=DEVICE),
                ArrayDataset(rows[:, :-1], rows[:, 1:], seed=SEED + i),
                test_dataset=test)
        fed.seed_model(variables)
        del variables
        fences = FenceProbe(fed.controller)
        store = fed.controller._store
        reset_launches()
        # the check reads this round's own fold, not an earlier phase's
        agg_base._last_backends = ()
        probe, stats = run_federation(fed)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        launches = launch_counts()
        backend = agg_base.fold_backend()
        smoke.check(backend == "native",
                    f"store llama: the controller's host fold ran "
                    f"{backend!r} (native hostfold.cc expected)")
        smoke.check(fences.fenced(),
                    "store llama: the ingest drain fence returned before "
                    f"every select ({[e for e, _ in fences.events]})")
        meta = stats["round_metadata"][0]
        writes = meta["ingest_write_duration_ms"]
        smoke.check(sorted(writes) == sorted(meta["selected_learners"])
                    and fed.controller._ingest.errors()[0] == 0,
                    f"store llama: each of the {len(writes)} uplinks was "
                    "written by the ingest pool, with no error")
        smoke.check(store.cache_misses >= FED_LEARNERS
                    and store._cached_total == 0,
                    f"store llama: select read every 755 MB model from "
                    f"its mmapped file ({store.cache_misses} cache misses; "
                    f"{store._cached_total} bytes cached of a "
                    f"{STORE_CACHE_MB} MB budget)")
        worst = check_folds(smoke, "store llama", probe, stats, 1,
                            f64_rel=FED_F64_REL)

        def parse(blob):
            return {n: to_numpy(t)
                    for n, t in ModelBlob.from_bytes(blob).tensors}

        uplinks = {lid: parse(blob) for lid, blob in probe.uplinks[0].items()}
        files_ok = True
        for lid, want in uplinks.items():
            path = os.path.join(root, lid, "0.blob")
            with open(path, "rb") as f:
                data = f.read()
            got, _ = read_named_arrays(data, allow_nocrc=True)
            files_ok &= data[4] == 3 and sorted(got) == sorted(want) and all(
                got[k].dtype == want[k].dtype
                and got[k].tobytes() == want[k].tobytes() for k in want)
            del data, got
        smoke.check(files_ok, f"store llama: each stored .blob is a v3 blob "
                    f"that parses to its uplink's tensors ({root}/<id>/0.blob)")
        sizes = {learner.learner_id: len(learner.datasets["train"])
                 for learner in fed.learners}
        selected = meta["selected_learners"]
        scales = make_scaler("train_dataset_size")(
            {lid: {"num_train_examples": sizes[lid]} for lid in selected})
        fold_s, fold_rel = time_folds([uplinks[lid] for lid in selected],
                                      [scales[lid] for lid in selected])
        del uplinks
        smoke.check(fold_rel <= FED_F64_REL,
                    f"store llama: native and numpy folds agree within "
                    f"{fold_rel:.3g} x max|w| (<= {FED_F64_REL})")
        pack = meta["community_pack_duration_ms"]
        out["llama"] = {
            "round_wall_s": meta["completed_at"] - meta["started_at"],
            "ingest_write_ms": writes,
            "ingest_enqueue_ms": meta["model_insertion_duration_ms"],
            "drain_ms": meta["ingest_drain_duration_ms"],
            "select_s": meta["store_select_duration_ms"] / 1e3,
            "fold_in_round_s": (meta["aggregation_duration_ms"] - pack
                                - meta["ingest_drain_duration_ms"]
                                - meta["store_select_duration_ms"]) / 1e3,
            "community_pack_s": pack / 1e3,
            "fold_native_s": fold_s["native"],
            "fold_numpy_s": fold_s["numpy"],
            "native_vs_numpy_rel": fold_rel, "f64_rel_err": worst,
            "cache_misses": store.cache_misses, "fold_backend": backend,
            "launches": launches, "split": probe.split(stats),
        }
        print(f"store llama: insert ms per uplink "
              f"{[round(v, 1) for v in writes.values()]}, drain "
              f"{meta['ingest_drain_duration_ms']:.1f} ms, select "
              f"{meta['store_select_duration_ms'] / 1e3:.3f} s; fold native "
              f"{[round(v, 3) for v in fold_s['native']]} s vs numpy "
              f"{[round(v, 3) for v in fold_s['numpy']]} s", flush=True)
        del fed, probe, store, fences
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out["cnn"] = store_cnn_remote(smoke)
    out["gpu"] = gpu
    print(json.dumps({"store": out}), flush=True)
    return out


def remote_learner_ids(port):
    """The learner ids a store server on ``port`` holds a lineage for."""
    from metisfl_tpu_torch.store.remote import RemoteModelStore

    client = RemoteModelStore("localhost", port)
    try:
        return client.learner_ids()
    finally:
        client.shutdown()


def store_cnn_remote(smoke):
    """(b) the CNN federation with a process per learner, its model store
    a ``python -m metisfl_tpu_torch.store.server`` process on a disk
    store."""
    for name in ("grpc", "cloudpickle"):
        try:
            __import__(name)
        except ImportError:
            print(f"store cnn: not run: {name} is not installed on this "
                  "machine", flush=True)
            smoke.failures.append(f"store cnn: {name} missing")
            return None
    import signal

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import EvalConfig, ModelStoreConfig
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN

    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    shards = [(x[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES],
               y[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES])
              for i in range(FED_LEARNERS)]
    test = (x[-CNN_TEST:], y[-CNN_TEST:])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    root = os.path.join(MP_DIR, "store_server")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(MP_DIR, exist_ok=True)
    log_path = os.path.join(MP_DIR, "store_server.log")
    env = dict(os.environ, PYTHONPATH=REPO)
    log = open(log_path, "w")
    server = subprocess.Popen(
        [sys.executable, "-m", "metisfl_tpu_torch.store.server",
         "--host", "localhost", "--port", "0", "--store", "disk",
         "--root", root], stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        env=env)
    out, held = {}, []
    try:
        port, deadline = None, time.time() + MP_TIMEOUT_S
        while port is None:
            if server.poll() is not None or time.time() > deadline:
                raise RuntimeError("the store server did not start")
            with open(log_path) as f:
                found = re.search(r"METISFL_TPU_STORE_READY port=(\d+)",
                                  f.read())
            port = int(found.group(1)) if found else None
            time.sleep(0.1)
        stats, records, ids, workdir, final, walls = run_multiprocess(
            smoke, "store cnn", "cnn", shards, test,
            TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                        optimizer="sgd", learning_rate=0.05),
            EvalConfig(batch_size=256, datasets=["test"],
                       metrics=["loss", "accuracy"]),
            STORE_CNN_ROUNDS, template,
            model_store=ModelStoreConfig(store="remote", host="localhost",
                                         port=port),
            before_shutdown=lambda: held.extend(remote_learner_ids(port)))
        check_mp_folds(smoke, "store cnn", stats, ids, workdir,
                       [len(s[0]) for s in shards], final, STORE_CNN_ROUNDS)
        acc = _accuracies(stats)
        smoke.check(len(acc) >= STORE_CNN_ROUNDS
                    and acc[STORE_CNN_ROUNDS - 1] > acc[0],
                    f"store cnn: community test accuracy by round "
                    f"{[round(a, 4) for a in acc]} rises")
        smoke.check(len(held) == FED_LEARNERS,
                    f"store cnn: the store server held each learner's "
                    f"lineage after the last round ({sorted(held)})")
        split = mp_split(stats, records, ids, STORE_CNN_ROUNDS)
        out = {"rounds": STORE_CNN_ROUNDS, "test_accuracy": acc,
               "round_wall_s": [s["wall_s"] for s in split],
               "select_s": [m["store_select_duration_ms"] / 1e3
                            for m in stats["round_metadata"]
                            [:STORE_CNN_ROUNDS]], **walls}
        print(f"store cnn: round walls "
              f"{[round(w, 3) for w in out['round_wall_s']]} s", flush=True)
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            code = server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            code = server.wait(timeout=30)
        log.close()
        smoke.check(code == 0, f"store cnn: the store server exits {code} "
                    "on SIGTERM (0 expected)")
        shutil.rmtree(MP_DIR, ignore_errors=True)
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def profile_call(fn, top: int = 8):
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``, beside the call's wall time. Only device events
    (kernels, copies) are summed; ``idle_share`` is the part of the wall
    time with no device work (the profiler's own host cost included, so
    it reads high). A profiler that records no device time reports "not
    measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        return f"not measured ({exc})"
    rows = [(float(evt.self_device_time_total) / 1e3, evt.key,
             int(evt.count))
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    if not rows:
        return "not measured (no device time recorded)"
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "top": [{"kernel": k[:80], "ms": ms, "calls": c,
                     "share": ms / device_ms} for ms, k, c in rows[:top]]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from metisfl_tpu_torch.ops import build
        from metisfl_tpu_torch.ops.flash_attention import flash_attention_fwd
    except ImportError as exc:
        print(f"chip_smoke: metisfl_tpu_torch not importable ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    started = time.perf_counter()
    smoke = Smoke()
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    def build_kernels():
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.3f} s")
        for name, seconds in sorted(build.build_seconds.items()):
            print(f"  {name}: nvcc done after {seconds:.3f} s")
        for name, log in build.build_logs.items():
            for line in log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"  {name}: {line.strip()}")
        return libs

    if smoke.phase("build", build_kernels) is None:
        print("\n".join(smoke.failures), file=sys.stderr)
        return 1

    main_case = smoke.phase(
        "kernel vs plain: flash_fwd at the serving shape", attention_case,
        smoke, "flash_fwd", 4, 16, 4, 1024, 64, "bfloat16", True, 2e-2, 1e-3)
    train_case = smoke.phase(
        "kernel vs plain: flash_fwd at the training shape", attention_case,
        smoke, "flash_fwd_train", TRAIN_BATCH, HEADS, KV_HEADS, TRAIN_LEN,
        DIM // HEADS, "bfloat16", True, 2e-2, 1e-3)
    smoke.phase("kernel vs plain: flash_fwd ragged fp32 D=128",
                attention_case, smoke, "flash_fwd_ragged_fp32", 2, 8, 8,
                1000, 128, "float32", False, 1e-4, 1e-4)
    bwd_cases = smoke.phase(
        "kernel vs plain: flash_bwd_dq and flash_bwd_dkv at the training "
        "shape", backward_case, smoke, "flash_bwd", 8, 16, 4, TRAIN_LEN, 64,
        "bfloat16", True, 2e-2)
    smoke.phase("kernel vs plain: flash_bwd ragged fp32 D=128",
                backward_case, smoke, "flash_bwd_ragged_fp32", 2, 8, 8, 1000,
                128, "float32", False, 1e-4)
    # head dims the kernels are not built for (zero-padded to 64 in the
    # wrapper), and B·Hq above gridDim.y's 65535 (launched in batch chunks)
    for name, shape in (
            # examples/long_context.py's shape
            ("long_context_d16", (4, 4, 4, 512, 16)),
            ("d8", (2, 16, 4, 1024, 8)),
            ("d32", (2, 16, 4, 1024, 32)),
            ("grid_b4100", (4100, 16, 4, 16, 64))):
        smoke.phase(f"kernel vs plain: flash_fwd {name}", attention_case,
                    smoke, f"flash_fwd_{name}", *shape, "bfloat16", True,
                    2e-2, 1e-3)
        smoke.phase(f"kernel vs plain: flash_bwd {name}", backward_case,
                    smoke, f"flash_bwd_{name}", *shape, "bfloat16", True,
                    2e-2)
    # the head dim 256 builds (K3 in two passes: dV, then dK)
    smoke.phase("kernel vs plain: flash_fwd d256", attention_case, smoke,
                "flash_fwd_d256", 2, 16, 4, 1024, 256, "bfloat16", True,
                2e-2, 1e-3)
    smoke.phase("kernel vs plain: flash_bwd d256", backward_case, smoke,
                "flash_bwd_d256", 2, 16, 4, 1024, 256, "bfloat16", True,
                2e-2)
    # beyond every build: the general kernels (any D, any dtype)
    general = ("flash_bwd_dq_general", "flash_bwd_dkv_general")
    for dtype_name, o_atol, lse_atol, rel in (
            ("bfloat16", 2e-2, 1e-3, 2e-2), ("float32", 1e-4, 1e-4, 1e-4)):
        tag = "bf16" if dtype_name == "bfloat16" else "fp32"
        smoke.phase(
            f"kernel vs plain: flash_fwd d512 {tag}", attention_case, smoke,
            f"flash_fwd_general_d512_{tag}", 1, 4, 4, 512, 512, dtype_name,
            True, o_atol, lse_atol, "flash_fwd_general")
        smoke.phase(
            f"kernel vs plain: flash_bwd d512 {tag}", backward_case, smoke,
            f"flash_bwd_general_d512_{tag}", 1, 4, 4, 512, 512, dtype_name,
            True, rel, general)
    smoke.phase("kernel vs plain: flash_bwd d256 fp32", backward_case, smoke,
                "flash_bwd_general_d256_fp32", 2, 8, 2, 1024, 256, "float32",
                True, 1e-4, general)
    # the wide-heads path's own shapes: every wrapper it launches, held to
    # its twin where the path launches it (its rows in the kernels line)
    wide_cases = {}
    for label, heads, dtype_name, fwd, bwd in WIDE_CASES:
        o_atol, lse_atol, rel = ((2e-2, 1e-3, 2e-2)
                                 if dtype_name == "bfloat16"
                                 else (1e-4, 1e-4, 1e-4))
        shape = (WIDE_BATCH, heads, heads, WIDE_LEN, DIM // heads)
        wide_cases[label] = (
            smoke.phase(f"kernel vs plain: flash_fwd wide heads {label}",
                        attention_case, smoke, f"flash_fwd_wide_{label}",
                        *shape, dtype_name, True, o_atol, lse_atol, fwd),
            smoke.phase(f"kernel vs plain: flash_bwd wide heads {label}",
                        backward_case, smoke, f"flash_bwd_wide_{label}",
                        *shape, dtype_name, True, rel, bwd))
    sliced = smoke.phase("slice: Predict and Generate through the gateway",
                         slice_phase, smoke, gpu)
    torch.cuda.empty_cache()
    trained = smoke.phase("slice: LlamaLite training through TorchModelOps",
                          training_phase, smoke, gpu)
    torch.cuda.empty_cache()
    wide = smoke.phase("slice: LlamaLite training at head dims 256 and 512",
                       wide_heads_phase, smoke, gpu)
    torch.cuda.empty_cache()
    federated = smoke.phase("slice: synchronous FedAvg rounds through "
                            "InProcessFederation", federation_phase, smoke,
                            gpu)
    # the phase's processes need the card's memory: this process keeps only
    # its CUDA context
    torch.cuda.empty_cache()
    multiprocess = smoke.phase(
        "slice: FedAvg rounds with a process per learner through "
        "DriverSession over gRPC", multiprocess_phase, smoke, gpu)
    torch.cuda.empty_cache()
    stored = smoke.phase(
        "slice: the model-store layer (cached disk with parallel ingest, "
        "remote) and the native host fold", store_phase, smoke, gpu)

    # launches on each path that runs a kernel (each path's counts set to
    # 0 just before it and read just after): K1 on every path
    train_launches = (trained or {}).get("launches", {})
    fed_launches = ((federated or {}).get("llama") or {}).get("launches", {})
    # the learner processes' launches (or the wire phase's, in its place)
    mp_launches = ((multiprocess or {}).get("llama") or {}).get(
        "launches", {})
    serve_k1 = (sliced or {}).get("flash_launches", 0)
    # the store phase's counts, by wrapper name
    store_launches = ((stored or {}).get("llama") or {}).get("launches", {})
    rows = []
    if main_case is not None:
        by_path = {"serve": serve_k1,
                   "train": train_launches.get("flash_fwd", 0),
                   "federation": fed_launches.get("flash_fwd", 0),
                   "multiprocess": mp_launches.get("flash_fwd", 0),
                   "store": store_launches.get("flash_attention_fwd", 0)}
        rows.append(("flash_fwd", "flash_fwd.cu", 76, main_case,
                     sum(by_path.values()), by_path))
    for record, line in zip(bwd_cases or [], (126, 162)):
        by_path = {"train": train_launches.get(record["name"], 0),
                   "federation": fed_launches.get(record["name"], 0),
                   "multiprocess": mp_launches.get(record["name"], 0),
                   "store": store_launches.get(record["name"], 0)}
        rows.append((record["name"], "flash_bwd.cu", line, record,
                     sum(by_path.values()), by_path))
    # the wide-heads path, a row per head dim and wrapper: its launches in
    # that case's run beside the case measured at the same B·H·L·D
    wide_by_case = (wide or {}).get("cases", {})
    for label, _, _, fwd, bwd in WIDE_CASES:
        fwd_record, bwd_records = wide_cases[label]
        launched = wide_by_case.get(label, {}).get("launches", {})
        for wrapper, record, source, line in (
                (fwd, fwd_record, "flash_fwd.cu", 76),
                (bwd[0], (bwd_records or [None])[0], "flash_bwd.cu", 126),
                (bwd[1], (bwd_records or [None, None])[1], "flash_bwd.cu",
                 162)):
            if record is None:
                continue
            by_path = {"wide_heads": launched.get(wrapper, 0)}
            name = ROW_NAMES.get(wrapper, wrapper) + "_" + label
            rows.append((name, source, line, dict(record, wrapper=wrapper),
                         sum(by_path.values()), by_path))
    kernels = []
    for name, source, line, record, launches, by_path in rows:
        entry = {
            "name": name, "route": "cuda",
            "source": f"metisfl_tpu_torch/csrc/{source}",
            "replaces": f"metisfl_tpu/ops/flash_attention.py:{line}",
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": record["max_abs_err"],
            "ms": record["kernel_ms"], "plain_ms": record["plain_ms"],
            "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
            "library_ms": record["library_ms"], "tflops": record["tflops"],
            "device_ms": record["kernel_device_ms"],
            "host_ms": record["kernel_host_ms"],
            "library_device_ms": record["library_device_ms"],
            "shape": record["shape"], "dtype": record["dtype"],
        }
        if "wrapper" in record:
            entry["wrapper"] = record["wrapper"]
        if "case" in record:  # K2/K3: SDPA's one backward call covers both
            entry["library_covers"] = "flash_bwd_dq+flash_bwd_dkv"
        if name == "flash_fwd" and train_case is None:
            smoke.failures.append("flash_fwd has no training-shape row")
        elif name == "flash_fwd":
            entry["at_training_shape"] = {
                key: train_case[key] for key in (
                    "shape", "max_abs_err", "kernel_ms", "kernel_device_ms",
                    "kernel_host_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "tflops",
                    "tflops_device")}
        kernels.append(entry)
        for path, count in by_path.items():
            if not count:
                smoke.failures.append(f"{name} was not launched on the "
                                      f"{path} path")
    if len(kernels) < 3 + 3 * len(WIDE_CASES):
        smoke.failures.append("a kernel of the path has no measured row")
    print(f"phases done in {time.perf_counter() - started:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu, flush=True)
    if smoke.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(smoke.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
