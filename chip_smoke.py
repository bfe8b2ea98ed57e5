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
   K1 (flash_fwd; tensor cores in bf16) at the serving and the training
   shapes, K2 and K3 (flash_bwd_dq, flash_bwd_dkv; tensor
   cores in bf16) at the training shape, each run twice for bit-identity,
   with the achieved TFLOP/s; then K1-K3 at small head dims (the
   ``examples/long_context.py`` shape B4·Hq4·L512·D16, D = 8 and D = 32
   at B2·Hq16·Hkv4·L1024: K1, K2 and K3 on their D = 16 and 32 builds,
   which read D in place, K3 with its split sum where ``dkv_mma_split``
   cuts its walks (D = 8 and 32; its bf16 sum also alone, bit for bit),
   and the profiler must list no pad or copy kernel in a K1, K2 or K3
   call; and, for correctness only, fp16 D = 24, L = 1000, Hq8·Hkv2, not
   causal)
   and at B·Hq and at Hq above a grid's y axis of 65535 (B4100·Hq16 and
   B1·Hq65536, one launch a call: every grid is 1-D), K1-K3 at their head
   dim 256 builds (each on two warpgroups a block; K3 with its split sum
   where ``dkv_mma_split`` cuts its walks; no pad or copy in a K1, K2 or
   K3 call; and, for correctness only, L = 1000 fp16 not causal and L =
   65 bf16 causal at Hq8·Hkv2), the general kernels beyond the
   builds in bf16/fp16 (K1-K3 on tensor cores) and the register-tiled
   fp32 K1-K3 at every D (each with the second launch that merges or sums
   its split, held to its own twin) at D = 512 in bf16 and fp32, at fp32
   D = 256 (B2·Hq8·Hkv2·L1024) and at the ragged fp32
   B2·Hq8·L1000·D128; every case counts each wrapper's launches against
   its route (``kernel_route``); the tensor-core general kernels
   at the card-filling B2·Hq16·Hkv4·L1024·D512 bf16 causal (the D = 256
   case at twice the head dim) and, for correctness only, at D = 320
   fp16, not causal, L = 1000, Hq8·Hkv2; then every wrapper the
   wide-heads path (5.) launches, at that path's own B2·H·L256·D (D = 16
   and 32 in bf16, 256 in bf16 and fp32, 512 in bf16 and fp32); each case
   checks which wrapper launched and records which SDPA kernels ran (the
   profiler's names: SDPA's backend);
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
   at head dims 16 and 32 in bf16 (64 and 32 heads) and 256 and 512, each
   in bf16 and fp32, each launch checked
   against the kernel that head dim and dtype route to, gradients against
   the dense path's;
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
   localhost gRPC; the LlamaLite one at depth ``CUT_DEPTH`` with 2
   learners, the hot standby and the registry armed (its 390 MB blobs on
   the chunked path both ways; it is the failover phase's control, and
   stays failover-silent). The learner recipes record each round's
   uplinks, the community model each learner received, stage times, peak
   device memory and K1-K3 launches, and write them at process exit; each
   community model is held bit for bit against a re-fold of its round's
   uplinks, K1-K3 must launch 12/8/8 times per LlamaLite round across the
   learner processes, the CNN's accuracy must rise, and every process
   must exit 0 after ``shutdown_federation``. Where grpc or cloudpickle is not
   installed it prints ``multiprocess: not run: ...`` and runs the rounds
   through the port's gRPC services' handlers, called directly, instead;
8. store: (a) the LlamaLite round (depth ``CUT_DEPTH``) in process on
   ``model_store.store: cached_disk`` (a 256 MB cache, below one 390 MB
   model, so select reads the mmapped file) with 3 ingest writers and a
   root in a temporary
   directory: the host fold must be the native one (``fold_backend()``),
   the community bit-identical to a re-fold of the uplinks and within
   1e-6 x max|w| of a float64 mean, each stored ``.blob`` a v3 blob of its
   uplink's tensors, and the drain fence must return before the select;
   it prints each insert's, the drain's and the select's times and the
   native against the numpy fold of the same three models, in turns;
   (b) the CNN with a process per learner for 2 rounds on ``store:
   remote``, served by a ``python -m metisfl_tpu_torch.store.server``
   process on a disk store, which must exit 0 on SIGTERM;
9. rules (run after 6): (a) the LlamaLite round of 6 in process under
   ``aggregation.rule: median`` with the controller on the card, whose
   K1-K3 launches are counted as in 6 and whose community model must
   equal the median re-applied to its 3 uplinks bit for bit, its
   controller's H2D, combine and D2H printed; (b) each of the eleven
   rules' ``aggregate`` on those 3 full-width uplinks, on the card (the
   robust rules from the host uplinks, the others from trees of tensors
   on the card) against the CPU path: bit for bit for the median, the
   trimmed mean of 3 and Krum, the others within ``RULES_REL_TOL``, each
   timed in H2D, combine and D2H beside the CPU path's time; (c) the CNN
   of 6 in process, 2 rounds under each of fedrec, fednova, fedadam and
   multikrum, each round's community model bit for bit the rule replayed
   over the recorded uplinks; (d) the CNN with a process per learner, 1
   round, learner 1's endpoint ``127.0.0.2``: shipped its recipe and
   launched through ``ssh``/``scp`` stand-ins on ``PATH`` that run here
   (the machine has no second host, and the phase's lines say so), every
   process exiting 0 and the ShutDown RPC reaching it at that hostname;
10. tiers (after 8): the in-process LlamaLite round on the store path,
   under streaming, under the tree tier at branch 2 and under masking with
   streaming; the CNN with processes under masking (a learner leaving
   mid-round, its masks recovered) and, at the same time, under CKKS. The
   LlamaLite rounds
   of 9 and 10 run at full width and depth ``CUT_DEPTH`` (2), for the
   script's time;
11. uplinks: in-process LlamaLite rounds at full width (3 learners,
   equal shards), every round at depth ``CUT_DEPTH`` (one 755 MB uplink
   at full depth is submitted to a slice alone): (a) two slice aggregator processes (``python -m
   metisfl_tpu_torch.aggregation.slice``, booted by
   ``DriverSession.start_slices``) under ``tree: {branch 2,
   distributed}``, 2 rounds: the root store sees no insert and no select,
   each slice's spool holds its learners' round-1 uplinks, each community
   is a ``TreeReducer`` fold of its recorded uplinks in sorted-id order,
   a slice acks one 755 MB uplink submitted alone (timed), and the
   round-1 uplinks replayed through a fresh reducer, undisturbed and with
   slice 1 SIGKILLed after its first ack, give the same bits (the kill
   run re-homes); (b) SCAFFOLD over SGD steps, 2 rounds: ``c`` against a
   numpy replay of its fold, ``c - c_i`` reaching each engine in round 1,
   the weights a FedAvg re-fold; (c) an int8q uplink under a bf16
   downlink and a topk16 uplink: the controller's dequantized or
   densified tensors against a numpy replay of the wire blobs, the
   community their re-fold; (d) client-level DP without noise (each
   update's norm <= the clip) and with it (the noise's norm against sigma
   x sqrt(n)); (e) a LoRA round under ``ship_tensor_regex``: only the
   adapters travel, each frozen base bit-identical. It prints the
   submit, spool, fold and round seconds and the bytes of every variant;
12. rounds (round control): in-process LlamaLite rounds at full width and
   depth ``CUT_DEPTH`` through K1-K3 (every launch counted against the
   steps trained and the evaluations run): (a) ``asynchronous_buffered``
   (buffer 2, staleness decay 0.5, a learner held until two fills
   closed), 3 fills, each a numpy replay of the damped fold bit for bit,
   the held learner's uplink at least one round stale; (b) quorum 2 of an
   over-provisioned dispatch on the streaming tier, the straggler's late
   uplink dropped unfolded; (c) ``semi_synchronous``, round 1's step
   budgets ``recompute_steps`` on round 0's ms per step, each run whole;
   (d) a round deadline under masking with streaming (the CNN in
   process), the two survivors settled through ``RecoverMasks`` within
   1e-9 of their float64 mean; (e) ``DriverSession`` with a process per
   CNN learner and chaos armed by ``process`` (the controller's fifth
   RunTask dropped, learner 2 slowed): the retry's replacement, the
   failed learner's churn score and quarantine, every process exiting 0;
   (f) ``driver/crossdevice.py``: 512 virtual clients under churn at
   quorum 12 against the no-churn control, and ``run_slice_smoke`` with a
   slice aggregator killed mid-round;
13. failover (controller checkpoints and ``--resume``, the hot standby,
   the driver's supervision, the registry): one LlamaLite Adam step
   (full width, depth ``CUT_DEPTH``) trained twice from one blob ships
   the same uplink bytes; (a) in process, 2 LlamaLite learners, 3 rounds
   with checkpoints and the registry on, each evaluated: the controller
   shut down after round 1 and replaced from ``restore_checkpoint()``,
   the learners re-attaching on its new epoch, ``resume_round()``;
   rounds 2-3's versions bit for bit the undisturbed control's, the
   lineage the control's, ids and tokens kept; a ``ServingGateway``
   syncs the stable version from the restored controller and answers 8
   Predicts through K1 within 0.1 of the dense path; (b) the multiprocess
   phase's LlamaLite federation with the controller killed by the chaos
   injector at its first uplink: the standby promotes once, the
   round-pinned versions are the multiprocess phase's (the control's)
   bits; (c) the CNN (no dropout) with a process per learner, the same
   kill without a standby: the driver relaunches the controller with
   ``--resume`` once, the versions are a control run's bits.

It prints a ``{"federation": {...}}`` line (round walls and their split,
ms per step, blob bytes, launches), a ``{"multiprocess": {...}}`` line
(the same with a process per learner, and each process's peak device
memory), ``{"wide_heads": ...}``, ``{"store": ...}``, ``{"rules": ...}``,
``{"tiers_secure": ...}``, ``{"uplinks": ...}``, ``{"rounds": ...}`` and
``{"failover": ...}`` lines, a ``{"setup": ...}`` line (the script's seconds outside the
rounds: set-up per in-process federation, the seeds, the fold checks,
each process federation's boot from its logs, the profiles), a
``{"kernels": [...]}`` line (each kernel's launches by path: K1-K3 at
D = 64 on the main paths, and a row per wide-heads case and wrapper with
its launches there, each measured at its path's shape: the tensor-core
and the fp32 routes of K1-K3 each have rows, the split fp32 K1's combine
and K3's sum too, the D = 512 bf16 ones also their card-filling case's
numbers, the fp32 K1 its B2·Hq8·Hkv2·L1024·D256 case's),
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
# the profiled solo decode's tokens (each decode step is the same work)
PROFILE_TOKENS = 8
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
# learner, 2 rounds (in process it runs 1, for the script's time), at depth
# CUT_DEPTH with 2 learners and the hot standby and the registry armed: it
# is the control the failover phase's kill run (b) is held to, bit for bit
# (two learners keep the fold's bits free of the join order)
MP_ROUNDS = 2
MP_LLAMA_LEARNERS = 2
# the rules and tiers phases and parts of the uplinks phase run their
# LlamaLite rounds at full width but this depth (a 390 MB blob against the 755 MB
# one), for the script's time
CUT_DEPTH = 2
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
                            top=2, calls=PROFILED_CALLS)
    if not isinstance(profiled, dict):
        return None
    return profiled["per_call_ms"]


def kernel_names(fn, top: int = 3):
    """The names of the device kernels that take most of one call of
    ``fn`` (the profiler's), e.g. which SDPA backend ran."""
    profiled = profile_call(fn, top=top)
    if not isinstance(profiled, dict):
        return None
    return [row["kernel"] for row in profiled["top"]]


# the script's own seconds outside the federations' rounds: per
# in-process federation, construction to its first dispatch, the rounds
# (first dispatch to the last round's close), the wait for evaluations,
# and its shutdown; and each random_variables call and re-fold check
SETUP = {"federations": [], "random_variables": [], "pack_seed": [],
         "check_folds": [], "process_boots": [], "profiles": []}
CURRENT_PHASE = [""]


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        CURRENT_PHASE[0] = name.split(":")[0] if name.startswith(
            "kernel") else name[:40]
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 - recorded, the run goes on
            traceback.print_exc()
            self.failures.append(f"{name}: raised")
            return None
        finally:
            print(f"-- {name}: {time.perf_counter() - t0:.3f} s", flush=True)


# the twelve kernel wrappers, by name: K1-K3, their register-tiled fp32
# kernels (every D), the general-D tensor-core kernels of K1-K3, and the
# second launches of a split fp32 K3, K1 and K2
KERNEL_WRAPPERS = ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_fwd_general", "flash_bwd_dq_general",
                   "flash_bwd_dkv_general", "flash_fwd_general_mma",
                   "flash_bwd_dkv_general_mma", "flash_bwd_dq_general_mma",
                   "flash_bwd_dkv_split_sum", "flash_fwd_split_combine",
                   "flash_bwd_dq_split_sum")
SPLIT_SUM = "flash_bwd_dkv_split_sum"
COMBINE = "flash_fwd_split_combine"
DQ_SUM = "flash_bwd_dq_split_sum"
# the second launches: rows of their own, with no SDPA yardstick
SECOND_LAUNCHES = (SPLIT_SUM, COMBINE, DQ_SUM)
# K1's wrappers: they also run where a block recomputes its forward
FWD_WRAPPERS = ("flash_attention_fwd", "flash_fwd_general",
                "flash_fwd_general_mma", COMBINE)
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


def dkv_split_at(B, Hq, Hkv, L, D, causal):
    """``(per_slab, slabs, Dp)`` of the fp32 K3 beyond its builds at these
    shapes on this card (slabs > 1: it launches ``SPLIT_SUM`` too)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        f32_head_dim,
        dkv_split,
    )

    Dp = f32_head_dim(D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (*dkv_split(B, Hq, Hkv, L, Dp, causal, sms), Dp)


def fwd_split_at(B, Hq, L, D, causal):
    """``(per_slab, slabs, Dp)`` of the fp32 K1 at these shapes on this
    card (slabs > 1: it launches ``COMBINE`` too)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        f32_head_dim,
        fwd_split,
    )

    Dp = f32_head_dim(D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (*fwd_split(B, Hq, L, Dp, causal, sms), Dp)


def dq_split_at(B, Hq, L, D, causal):
    """``(per_slab, slabs, Dp)`` of the fp32 K2 at these shapes on this
    card (slabs > 1: it launches ``DQ_SUM`` too)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import dq_split, f32_head_dim

    Dp = f32_head_dim(D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (*dq_split(B, Hq, L, Dp, causal, sms), Dp)


def dkv_mma_split_at(B, Hq, Hkv, L, D, causal):
    """``(per_slab, slabs)`` of the tensor-core K3 at its D = 16, 32 or 256
    build ``D`` at these shapes on this card (slabs > 1: it launches
    ``SPLIT_SUM`` too, into bf16/fp16)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import dkv_mma_split

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dkv_mma_split(B, Hq, Hkv, L, D, causal, sms)


def mma_split_build(dtype_name, D):
    """The build (16, 32 or 256) that K3 runs head dim D on in
    ``dtype_name`` where that build splits its walks (``dkv_mma_split``),
    else None."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        _MMA_SPLIT_BLOCKS_PER_SM,
        kernel_route,
    )

    route = kernel_route("dkv", getattr(torch, dtype_name), D)
    if (route.wrapper == "flash_bwd_dkv"
            and route.head_dim in _MMA_SPLIT_BLOCKS_PER_SM):
        return route.head_dim
    return None


def per_call_launches(kernel, dtype_name, B, Hq, Hkv, L, D, causal):
    """The launches one call of ``kernel`` ("fwd", "dq" or "dkv") makes at
    these shapes on this card, by wrapper: its route's kernel once, and the
    fp32 kernels' second launch where they split, and K3's at its D = 16,
    32 and 256 builds."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import kernel_route

    route = kernel_route(kernel, getattr(torch, dtype_name), D)
    want = {route.wrapper: 1}
    build = mma_split_build(dtype_name, D) if kernel == "dkv" else None
    if build and dkv_mma_split_at(B, Hq, Hkv, L, build, causal)[1] > 1:
        want[SPLIT_SUM] = 1
    if dtype_name == "float32":
        second, split = {
            "fwd": (COMBINE, fwd_split_at(B, Hq, L, D, causal)),
            "dq": (DQ_SUM, dq_split_at(B, Hq, L, D, causal)),
            "dkv": (SPLIT_SUM, dkv_split_at(B, Hq, Hkv, L, D, causal)),
        }[kernel]
        if split[1] > 1:
            want[second] = 1
    return want


def dq_sum_case(smoke, name, B, Hq, L, D, causal):
    """The split fp32 K2's second launch against its twin on the card, on
    random partials of the shape the split gives at (B, Hq, L, D), NaN in
    every slab a q tile lacks (read by neither): the same sums in the same
    slab order, so bit for bit (tolerance 0), twice; timed beside its
    bound (the bytes of the slabs it reads and the output it writes) and
    its twin. No single PyTorch call computes it (library_ms null)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        dq_split_sum_reference,
        flash_bwd_dq_split_sum,
    )

    per_slab, slabs, Dp = dq_split_at(B, Hq, L, D, causal)
    counts = [-(-n // per_slab) for n in _fwd_slab_steps(L, causal)]
    rng = np.random.default_rng(SEED + 11)
    part = torch.from_numpy(rng.standard_normal(
        (slabs, B, Hq, L, Dp)).astype(np.float32))
    for t, n in enumerate(counts):
        part[n:, :, :, 64 * t:64 * t + 64] = float("nan")
    part = part.to("cuda")
    before = flash_bwd_dq_split_sum.launches
    got = flash_bwd_dq_split_sum(part, causal, per_slab)
    got2 = flash_bwd_dq_split_sum(part, causal, per_slab)
    torch.cuda.synchronize()
    want = dq_split_sum_reference(part, causal, per_slab)
    err = float((got - want).abs().max())
    smoke.check(flash_bwd_dq_split_sum.launches == before + 2
                and bool(torch.isfinite(got).all()) and err == 0.0,
                f"{name}: {DQ_SUM} err {err:.3g} == 0 ({slabs} slabs of "
                f"{per_slab} k tiles)")
    smoke.check(torch.equal(got, got2),
                f"{name}: two runs of {DQ_SUM} give bit-identical dQ")

    def run():
        return flash_bwd_dq_split_sum(part, causal, per_slab)

    ms = time_ms(run)
    rows = B * Hq * sum(min(64, L - 64 * t) * n for t, n in
                        enumerate(counts))
    nbytes = float(rows * Dp * 4 + B * Hq * L * Dp * 4)
    record = {
        "name": DQ_SUM, "case": name, "shape": [B, Hq, Hq, L, D],
        "dtype": "float32", "causal": causal, "max_abs_err": err,
        "per_slab": per_slab, "slabs": slabs,
        "scratch_bytes": part.numel() * 4,
        "kernel_ms": ms, "kernel_device_ms": device_ms(run),
        "kernel_host_ms": host_ms(run),
        "plain_ms": time_ms(lambda: dq_split_sum_reference(
            part, causal, per_slab), iters=5),
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_device_ms": None,
        "library_kernels": None, "flops": 0.0, "bytes": nbytes,
        "tflops": 0.0,
    }
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


def combine_case(smoke, name, B, Hq, L, D, causal):
    """The split fp32 K1's second launch against its twin on the card, on
    random partials of the shape the split gives at (B, Hq, L, D) (each
    row's m and l drawn, one row with no unmasked key in its first slab),
    NaN in every slab a q tile lacks (read by neither): o within 1e-6 x
    max|twin| and lse within a relative 1e-6 (the two round e^(m_s - m)
    and the products apart), twice for bit-identity; timed beside its
    bound (the bytes of the slabs it reads and the outputs it writes) and
    its twin. No single PyTorch call computes it (library_ms null)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        _fwd_slab_steps,
        flash_fwd_split_combine,
        fwd_split_combine_reference,
    )

    per_slab, slabs, Dp = fwd_split_at(B, Hq, L, D, causal)
    counts = [-(-n // per_slab) for n in _fwd_slab_steps(L, causal)]
    rng = np.random.default_rng(SEED + 10)
    o_part = torch.from_numpy(rng.standard_normal(
        (slabs, B, Hq, L, Dp)).astype(np.float32))
    m_part = torch.from_numpy(4 * rng.standard_normal(
        (slabs, B, Hq, L)).astype(np.float32))
    l_part = torch.from_numpy(rng.uniform(1, 64, (slabs, B, Hq, L)).astype(
        np.float32))
    o_part[0, :, :, 0], m_part[0, :, :, 0], l_part[0, :, :, 0] = 0, -1e30, 0
    for t, n in enumerate(counts):
        for part in (o_part, m_part, l_part):
            part[n:, :, :, 64 * t:64 * t + 64] = float("nan")
    o_part, m_part, l_part = (t.to("cuda") for t in (o_part, m_part, l_part))
    before = flash_fwd_split_combine.launches
    got = flash_fwd_split_combine(o_part, m_part, l_part, causal, per_slab)
    got2 = flash_fwd_split_combine(o_part, m_part, l_part, causal, per_slab)
    torch.cuda.synchronize()
    want = fwd_split_combine_reference(o_part, m_part, l_part, causal,
                                       per_slab)
    err = float((got[0] - want[0]).abs().max())
    o_tol = 1e-6 * float(want[0].abs().max())
    lse_rel = float(((got[1] - want[1]).abs()
                     / want[1].abs().clamp_min(1.0)).max())
    smoke.check(flash_fwd_split_combine.launches == before + 2
                and all(bool(torch.isfinite(a).all()) for a in got)
                and err <= o_tol and lse_rel <= 1e-6,
                f"{name}: {COMBINE} o err {err:.3g} <= {o_tol:.3g}, lse "
                f"relative err {lse_rel:.3g} <= 1e-6 ({slabs} slabs of "
                f"{per_slab} k tiles)")
    smoke.check(all(torch.equal(a, b) for a, b in zip(got, got2)),
                f"{name}: two runs of {COMBINE} give bit-identical o and lse")

    def run():
        return flash_fwd_split_combine(o_part, m_part, l_part, causal,
                                       per_slab)

    ms = time_ms(run)
    rows = B * Hq * sum(min(64, L - 64 * t) * n for t, n in
                        enumerate(counts))
    # each owned slab's o, m and l read once, o and lse written once
    nbytes = float(rows * (Dp + 2) * 4 + B * Hq * L * (Dp + 1) * 4)
    record = {
        "name": COMBINE, "case": name, "shape": [B, Hq, Hq, L, D],
        "dtype": "float32", "causal": causal, "max_abs_err": err,
        "lse_rel_err": lse_rel, "per_slab": per_slab, "slabs": slabs,
        "scratch_bytes": (o_part.numel() + 2 * m_part.numel()) * 4,
        "kernel_ms": ms, "kernel_device_ms": device_ms(run),
        "kernel_host_ms": host_ms(run),
        "plain_ms": time_ms(lambda: fwd_split_combine_reference(
            o_part, m_part, l_part, causal, per_slab), iters=5),
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_device_ms": None,
        "library_kernels": None, "flops": 0.0, "bytes": nbytes,
        "tflops": 0.0,
    }
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


def split_sum_case(smoke, name, B, Hq, Hkv, L, D, causal,
                   dtype_name="float32"):
    """The split K3's second launch against its twin on the card, on
    random partials of the shape the split gives at (B, Hq, Hkv, L, D) in
    ``dtype_name`` (fp32: the register-tiled K3's, fp32 outputs;
    bf16/fp16: the D = 16, 32 and 256 builds', the sums rounded to that
    dtype once), NaN in every slab a k tile lacks (read by neither): the same
    sums in the same slab order, so bit for bit (tolerance 0) against the
    twin rounded alike, twice; timed beside its bound (the bytes of the
    slabs it reads and the outputs it writes) and its twin. No single
    PyTorch call computes it (library_ms null)."""
    import torch

    from metisfl_tpu_torch.ops.flash_attention import (
        _slab_steps,
        dkv_split_sum_reference,
        flash_bwd_dkv_split_sum,
    )

    if dtype_name == "float32":
        per_slab, slabs, Dp = dkv_split_at(B, Hq, Hkv, L, D, causal)
    else:  # the builds read D in place: partials D wide
        per_slab, slabs = dkv_mma_split_at(
            B, Hq, Hkv, L, mma_split_build(dtype_name, D), causal)
        Dp = D
    dtype = getattr(torch, dtype_name)
    group = Hq // Hkv
    counts = [-(-n // per_slab) for n in _slab_steps(L, group, causal)]
    rng = np.random.default_rng(SEED + 9)
    part = torch.from_numpy(rng.standard_normal(
        (slabs, 2, B, Hkv, L, Dp)).astype(np.float32))
    for t, n in enumerate(counts):
        part[n:, :, :, :, 64 * t:64 * t + 64] = float("nan")
    part = part.to("cuda")

    def outputs():
        return tuple(torch.empty((B, Hkv, L, Dp), dtype=dtype, device="cuda")
                     for _ in range(2))

    before = flash_bwd_dkv_split_sum.launches
    got = flash_bwd_dkv_split_sum(part, group, causal, per_slab,
                                  out=outputs())
    got2 = flash_bwd_dkv_split_sum(part, group, causal, per_slab,
                                   out=outputs())
    torch.cuda.synchronize()
    want = [t.to(dtype) for t in dkv_split_sum_reference(part, group, causal,
                                                         per_slab)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    smoke.check(flash_bwd_dkv_split_sum.launches == before + 2
                and all(bool(torch.isfinite(a).all()) for a in got)
                and err == 0.0,
                f"{name}: {SPLIT_SUM} err {err:.3g} == 0 ({slabs} slabs of "
                f"{per_slab} q steps)")
    smoke.check(all(torch.equal(a, b) for a, b in zip(got, got2)),
                f"{name}: two runs of {SPLIT_SUM} give bit-identical dK "
                "and dV")

    out = outputs()

    def run():
        return flash_bwd_dkv_split_sum(part, group, causal, per_slab,
                                       out=out)

    ms = time_ms(run)
    rows = B * Hkv * sum(min(64, L - 64 * t) * n for t, n in
                         enumerate(counts))
    nbytes = float(rows * Dp * 4 * 2
                   + 2 * B * Hkv * L * Dp * out[0].element_size())
    record = {
        "name": SPLIT_SUM, "case": name, "shape": [B, Hq, Hkv, L, D],
        "dtype": dtype_name, "causal": causal, "max_abs_err": err,
        "per_slab": per_slab, "slabs": slabs,
        "scratch_bytes": part.numel() * 4,
        "kernel_ms": ms, "kernel_device_ms": device_ms(run),
        "kernel_host_ms": host_ms(run),
        "plain_ms": time_ms(lambda: dkv_split_sum_reference(
            part, group, causal, per_slab), iters=5),
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_device_ms": None,
        "library_kernels": None, "flops": 0.0, "bytes": nbytes,
        "tflops": 0.0,
    }
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


def own_kernels_check(smoke, name, label, fn, tries: int = 3):
    """``PROFILED_CALLS`` calls of ``fn`` under the profiler: the device
    kernels they run, which must all be the port's flash kernels (no pad,
    copy or fill of PyTorch's around them); returns their names. A
    profile that recorded no device work (a few µs of kernels can go
    unrecorded) is taken again, up to ``tries`` times; none at all
    fails."""
    for _ in range(tries):
        profiled = profile_call(
            lambda: [fn() for _ in range(PROFILED_CALLS)], top=16)
        names = ([row["kernel"] for row in profiled["top"]]
                 if isinstance(profiled, dict) else [])
        if names:
            break
    smoke.check(bool(names) and all("flash_" in n for n in names),
                f"{name}: one {label} call runs only the port's kernels, no "
                f"pad or copy: {names}")
    return names


def attention_case(smoke, name, B, Hq, Hkv, L, D, dtype_name, causal,
                   o_atol, lse_atol, kernel="flash_attention_fwd",
                   timed=True, own_kernels=False):
    """One kernel-vs-plain comparison, timed unless ``timed`` is false;
    returns its record. ``kernel`` names the wrapper that must have
    launched; ``own_kernels`` also checks that a call runs no kernel but
    the port's (``own_kernels_check``)."""
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
    # two calls, each on the route's kernel once (and the combine once
    # where the fp32 K1 splits)
    per_call = per_call_launches("fwd", dtype_name, B, Hq, Hkv, L, D,
                                 causal)
    split = COMBINE in per_call
    expected = {n: 2 * c for n, c in per_call.items()}
    smoke.check(kernel in per_call and launched == expected,
                f"{name}: two forwards ran on {kernel}: launches "
                f"{launched}, expected {expected}")
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    o_err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    smoke.check(bool(torch.isfinite(o).all()) and o_err <= o_atol
                and lse_err <= lse_atol,
                f"{name}: o err {o_err:.3g} <= {o_atol}, lse err "
                f"{lse_err:.3g} <= {lse_atol}")
    smoke.check(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"{name}: two runs of K1 give bit-identical o and lse")
    call_kernels = (own_kernels_check(
        smoke, name, "K1", lambda: flash_attention_fwd(q, k, v, causal))
        if own_kernels else None)
    if not timed:
        return {"name": name, "shape": [B, Hq, Hkv, L, D],
                "dtype": dtype_name, "causal": causal, "wrapper": kernel,
                "max_abs_err": o_err, "max_abs_err_lse": lse_err}

    def kernel():
        return flash_attention_fwd(q, k, v, causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=Hq != Hkv)

    # a split call's time covers both launches; the profiler's device time
    # by kernel beside the events' (the profiler has dropped kernels)
    kernel_ms = time_ms(kernel)
    kernel_device_ms = device_ms(kernel)
    kernel_host_ms = host_ms(kernel)
    device_kernels = None
    if split:
        profiled = profile_call(kernel, top=4)
        if isinstance(profiled, dict):
            device_kernels = profiled["top"]
    plain_ms = time_ms(lambda: flash_attention_fwd_reference(q, k, v,
                                                             causal),
                       iters=5)
    library_kernels = None
    try:
        library_ms = time_ms(library)
        library_device_ms = device_ms(library)
        library_kernels = kernel_names(library)
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
        "library_kernels": library_kernels,
        "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "tflops_device": flops / (kernel_device_ms * 1e-3) / 1e12
        if kernel_device_ms else None,
    }
    if device_kernels is not None:
        record["device_kernels"] = device_kernels
    if call_kernels is not None:
        record["call_kernels"] = call_kernels
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


def backward_case(smoke, name, B, Hq, Hkv, L, D, dtype_name, causal,
                  rel_tol, kernels=("flash_bwd_dq", "flash_bwd_dkv"),
                  timed=True, own_kernels=False):
    """K2 and K3 against their plain versions on the card, each twice for
    bit-identity, timed unless ``timed`` is false; returns one record per
    kernel, named by ``kernels`` (the wrappers that must have launched,
    with the split K3's sum where it splits at this shape).
    ``own_kernels`` also checks that a K2 call and a K3 call each run no
    kernel but the port's (``own_kernels_check``)."""
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
    # two calls of each, on the routes' kernels (K3's D = 256 build once
    # per pass) and the split sums where the fp32 kernels split
    per_call = {**per_call_launches("dq", dtype_name, B, Hq, Hkv, L, D,
                                    causal),
                **per_call_launches("dkv", dtype_name, B, Hq, Hkv, L, D,
                                    causal)}
    split = SPLIT_SUM in per_call
    dq_split = DQ_SUM in per_call
    expected = {n: 2 * c for n, c in per_call.items()}
    smoke.check(set(kernels) <= set(per_call) and launched == expected,
                f"{name}: two backwards ran on {list(kernels)}: launches "
                f"{launched}, expected {expected}")
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
    dq_call_kernels = dkv_call_kernels = None
    if own_kernels:
        dq_call_kernels = own_kernels_check(
            smoke, name, "K2", lambda: flash_bwd_dq(q, k, v, do, lse, delta,
                                                    causal))
        dkv_call_kernels = own_kernels_check(
            smoke, name, "K3", lambda: flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     causal))
    if not timed:
        return [{"name": kernel, "case": name, "shape": [B, Hq, Hkv, L, D],
                 "dtype": dtype_name, "causal": causal, "max_abs_err": err}
                for kernel, err in zip(kernels, (
                    errs["dq"], max(errs["dk"], errs["dv"])))]

    def run_dq():
        return flash_bwd_dq(q, k, v, do, lse, delta, causal)

    def run_dkv():
        return flash_bwd_dkv(q, k, v, do, lse, delta, causal)

    # by CUDA events, by the profiler's device time and on the host's
    # clock: a kernel that is slower tells from a host that paces it
    dq_ms, dkv_ms = time_ms(run_dq), time_ms(run_dkv)
    dq_device, dkv_device = device_ms(run_dq), device_ms(run_dkv)
    dq_host, dkv_host = host_ms(run_dq), host_ms(run_dkv)
    # a split K2's or K3's device time by kernel: the tiles' and the sum's
    dq_kernels = dkv_kernels = None
    if dq_split:
        profiled = profile_call(run_dq, top=4)
        if isinstance(profiled, dict):
            dq_kernels = profiled["top"]
    if split:
        profiled = profile_call(run_dkv, top=4)
        if isinstance(profiled, dict):
            dkv_kernels = profiled["top"]
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
    library_ms = library_device_ms = library_kernels = None
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
            library_kernels = [row["kernel"] for row in profiled["top"]]
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
            "library_kernels": library_kernels,
            "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        })
    if dq_kernels is not None:
        records[0]["device_kernels"] = dq_kernels
    if dkv_kernels is not None:
        records[1]["device_kernels"] = dkv_kernels
    for record, names in zip(records, (dq_call_kernels, dkv_call_kernels)):
        if names is not None:
            record["call_kernels"] = names
    print(json.dumps({"kernel_case": records}), flush=True)
    return records


# random_variables' trees by (parameter names and shapes, seed): a model
# of the same shapes seeded the same is made once per script (no phase
# writes into the arrays)
_VARIABLES = {}


def random_variables(module, seed: int):
    """Flax-named numpy weights for ``module``'s parameter shapes: dense
    kernels N(0, 1/fan_in), embeddings N(0, 1), norm scales one."""
    from metisfl_tpu_torch.models.convert import flax_name

    key = (seed, tuple((name, tuple(p.shape))
                       for name, p in module.named_parameters()))
    if key in _VARIABLES:
        return _VARIABLES[key]
    t0 = time.perf_counter()
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
    SETUP["random_variables"].append(
        (CURRENT_PHASE[0], round(time.perf_counter() - t0, 3)))
    _VARIABLES[key] = tree
    return tree


# the full-width LlamaLite's seeded variables and their packed blob, per
# depth, made once per script and shared by every phase that seeds that
# model (no phase writes into them)
_SEEDS = {}


def llama_seed(depth):
    """(variables, blob) of the full-width LlamaLite at ``depth`` from
    ``SEED``; the first call makes them, later calls share them."""
    if depth not in _SEEDS:
        from metisfl_tpu_torch.models.zoo import LlamaLite
        from metisfl_tpu_torch.tensor import pack_model

        variables = random_variables(LlamaLite(
            vocab_size=VOCAB, dim=DIM, depth=depth, heads=HEADS,
            kv_heads=KV_HEADS, device="meta"), SEED)
        t0 = time.perf_counter()
        blob = pack_model(variables)
        SETUP["pack_seed"].append((depth, round(time.perf_counter() - t0,
                                                3)))
        _SEEDS[depth] = (variables, blob)
    return _SEEDS[depth]


def seed_federation(fed, blob):
    """Seed an in-process federation's controller with a packed blob (what
    ``seed_model`` does after packing the variables)."""
    fed.controller.set_community_model(blob)


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
    variables, blob = llama_seed(DEPTH)
    n_params = sum(a.size for a in _leaves(variables))
    ops = TorchModelOps(LlamaLite(**cfg, use_flash=True, device=DEVICE),
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
            # a solo decode of PROFILE_TOKENS (the profiler's trace of all
            # NEW_TOKENS took 31 s to read back on an H100)
            out["generate_solo_profile"] = profile_call(
                lambda: ops.generate(prompts[0][None], PROFILE_TOKENS,
                                     max_len=MAX_LEN))
            if isinstance(out["generate_solo_profile"], dict):
                out["generate_solo_profile"]["tokens"] = PROFILE_TOKENS
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
    variables, blob = llama_seed(DEPTH)
    ops = TorchModelOps(LlamaLite(**cfg, use_flash=True, device=DEVICE),
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
                (learner, "_dump_model", "blob_pack"),
                # a top-k uplink packs here instead
                (learner, "_dump_sparse", "blob_pack")):
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


def run_federation(fed, timeout_s=600.0, settle=None):
    """Start ``fed``, wait for its ``termination.federation_rounds`` rounds
    and every learner's evaluation of each (and ``settle()``, when given),
    shut it down; returns (probe, statistics)."""
    probe = RoundProbe(fed)
    rounds = probe.rounds
    n = len(fed.learners)
    first = []
    dispatch = fed.controller._dispatch_train

    def first_dispatch(*args, **kwargs):
        if not first:
            first.append(time.perf_counter())
        return dispatch(*args, **kwargs)

    fed.controller._dispatch_train = first_dispatch
    clock = {"phase": CURRENT_PHASE[0]}

    def evaluated():
        entries = fed.statistics()["community_evaluations"]
        return sum(len(e["evaluations"]) == n for e in entries) >= rounds

    try:
        t0 = time.perf_counter()
        born = getattr(fed, "_smoke_born", t0)
        fed.start()
        ok = fed.wait_for_rounds(rounds, timeout_s)
        t_rounds = time.perf_counter()
        ok = ok and fed.wait_until(evaluated, timeout_s)
        if ok and settle is not None:
            settle()
        t_evals = time.perf_counter()
        wall = t_evals - t0
        stats = fed.statistics()
    finally:
        t_down = time.perf_counter()
        fed.shutdown()
        clock["shutdown_s"] = round(time.perf_counter() - t_down, 3)
    t_first = first[0] if first else t0
    clock.update(construct_to_first_dispatch_s=round(t_first - born, 3),
                 rounds_s=round(t_rounds - t_first, 3),
                 eval_wait_s=round(t_evals - t_rounds, 3))
    SETUP["federations"].append(clock)
    if not ok:
        raise RuntimeError(f"federation did not complete {rounds} rounds "
                           f"with evaluations in {timeout_s} s")
    stats["wall_s"] = wall
    return probe, stats


def f64_mean_rel_err(got, models, weights):
    """The largest, over tensors, of max|got - mean| / max|mean|, where
    mean = Σ wᵢ·modelᵢ / Σ w in float64: the same operations in the same
    order as numpy's, on ``DEVICE`` (the division by a 0-d tensor, so the
    card divides as the host does)."""
    import warnings

    import torch

    worst = 0.0
    total = torch.tensor(float(sum(weights)), dtype=torch.float64,
                         device=DEVICE)

    def dev(arr):
        with warnings.catch_warnings():
            # blob views are read-only; the copy to the card leaves them so
            warnings.simplefilter("ignore")
            return torch.from_numpy(np.asarray(arr)).to(DEVICE).to(
                torch.float64)

    for k in got:
        mean = sum(w * dev(m[k]) for w, m in zip(weights, models))
        mean = mean / total
        scale = max(float(mean.abs().max()), 1e-30)
        worst = max(worst, float((dev(got[k]) - mean).abs().max()) / scale)
    return worst


def check_folds(smoke, label, probe, stats, rounds, f64_rel=None):
    """Each round's community model against an independent FedAvg of the
    uplinks its cohort shipped (re-read from the wire bytes, scaled as the
    controller's scaler scales them): bit for bit, and, with ``f64_rel``,
    within ``f64_rel`` x max|w| of a float64 weighted mean (computed on
    ``DEVICE``, by :func:`f64_mean_rel_err`)."""
    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import to_numpy

    def parse(blob):
        return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(blob).tensors}

    t0 = time.perf_counter()
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
        same = same_bits(got, want)
        smoke.check(same, f"{label} round {r}: community model equals a "
                    f"FedAvg re-fold of the {len(ups)} shipped blobs, bit "
                    "for bit")
        if f64_rel is not None:
            worst_f64 = max(worst_f64, f64_mean_rel_err(
                got, ups, [scales[lid] for lid in selected]))
    if f64_rel is not None:
        smoke.check(worst_f64 <= f64_rel,
                    f"{label}: community within {worst_f64:.3g} x max|w| of "
                    f"the float64 weighted mean (<= {f64_rel})")
    SETUP["check_folds"].append((label, round(time.perf_counter() - t0, 3)))
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
    variables, seed_blob = llama_seed(DEPTH)

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
            ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                          device=DEVICE),
                                variables=variables, device=DEVICE)
            fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                              seed=SEED + i),
                            test_dataset=test)
        if hasattr(fed, "controller"):
            seed_federation(fed, seed_blob)
        else:
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


def mp_recipe(kind, x, y, test_x, test_y, seed, device, out_dir, gate,
              hold="", depth=DEPTH):
    """A learner recipe for ``DriverSession``: the engine on ``device``,
    wrapped to record what the phase checks without work on the timed
    path. It keeps a reference to each community model a train task
    starts from and to the weights each task ships (the learner ships
    exactly ``TrainOutput.variables``), notes each stage's start and end,
    and at process exit writes them, the process's peak device memory and
    its K1-K3 launches into ``out_dir``. Training waits for ``gate``, so
    that round 0's cohort is every learner, and with ``hold`` every task
    after the first waits for that file too. ``kind``: ``cnn``, ``cnn0``
    (the CNN without dropout: a round re-run after a failover draws the
    engine's next dropout stream) or ``llama`` (at ``depth``)."""

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
        elif kind == "cnn0":
            module = FashionMnistCNN(dropout_rate=0.0)
        else:
            module = LlamaLite(vocab_size=VOCAB, dim=DIM, depth=depth,
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
            files = [gate] + ([hold] if hold and rec["train"] else [])
            while (not all(os.path.exists(f) for f in files)
                   and time.time() < deadline):
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


def note_boot(label, workdir, started):
    """A process federation's boot timeline, from its logs: each process's
    first logged line and the controller's join lines, in seconds after
    ``started`` (``time.time()`` before ``initialize_federation``)."""
    import datetime

    stamp = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ")

    def seconds(line):
        found = stamp.match(line)
        if not found:
            return None
        t = datetime.datetime.strptime(found.group(1),
                                       "%Y-%m-%d %H:%M:%S,%f").timestamp()
        return round(t - started, 3)

    boot = {"label": label}
    for name in sorted(os.listdir(workdir)):
        if not name.endswith(".log"):
            continue
        with open(os.path.join(workdir, name)) as f:
            lines = f.read().splitlines()
        first = next((t for t in map(seconds, lines) if t is not None), None)
        boot[name[:-4]] = first
        if name == "controller.log":
            boot["joined"] = [seconds(line) for line in lines
                              if " joined (" in line]
    SETUP["process_boots"].append(boot)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class Background:
    """``fn(*args, **kwargs)`` on a thread of its own: ``result()`` joins
    it and returns what it returned (or raises what it raised); ``wall_s``
    is its seconds."""

    def __init__(self, fn, *args, **kwargs):
        self._box = {}
        self.wall_s = None

        def run():
            t = time.perf_counter()
            try:
                self._box["result"] = fn(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - raised by result()
                self._box["error"] = exc
            self.wall_s = time.perf_counter() - t

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["result"]


def run_multiprocess(smoke, label, kind, shards, test, train, eval_cfg,
                     rounds, template, model_store=None, before_shutdown=None,
                     hosts=None, depth=DEPTH, config_extra=None,
                     release=None):
    """One DriverSession federation of ``len(shards)`` learner processes
    and a controller process (on ``model_store``, default in memory;
    ``before_shutdown()`` runs after the last round; ``hosts``, one per
    learner, its endpoint's hostname, default local; ``config_extra``,
    more FederationConfig fields); returns (statistics, per-learner
    records, learner ids by index, workdir, the final community blob,
    walls). With ``release`` (a ``threading.Event``) the federation boots
    and its learners join, and the rounds start once it is set: a
    federation booted beside other work. With ``hosts`` the walls also
    hold the endpoints the learners registered; with the registry on, the sha256 of each round's pinned
    version (``version_sha256``); under a hot standby whether it promoted
    (the driver's handoff and the promoted process's own log line) and
    its promotion seconds; the controller's supervised relaunches."""
    import hashlib

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
                                 DEVICE, out_dir, gate, depth=depth))
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="train_dataset_size"),
        train=train, eval=eval_cfg,
        termination=TerminationConfig(federation_rounds=rounds),
        model_store=model_store or ModelStoreConfig(),
        learners=[LearnerEndpoint(hostname=h)
                  for h in hosts or ["localhost"] * len(shards)],
        **(config_extra or {}))
    standby = config.controller.standby.enabled
    session = DriverSession(config, template, recipes, workdir=workdir,
                            device=DEVICE)
    client = None
    t0 = time.perf_counter()
    started = time.time()
    versions = {}
    try:
        session.initialize_federation(
            health_retries=int(MP_TIMEOUT_S / 0.5), health_sleep_s=0.5)
        # the driver's own client (it redials a promoted standby)
        client = session._client
        deadline = time.time() + MP_TIMEOUT_S
        while len(client.list_learners()) < len(shards):
            session._check_procs_alive()
            if time.time() > deadline:
                raise RuntimeError(f"{label}: learners never all joined")
            time.sleep(0.1)
        note_boot(label, workdir, started)
        ports = {}
        for i in range(len(shards)):
            with open(os.path.join(workdir, f"learner_{i}.log")) as f:
                ports[int(re.search(r"LEARNER_READY port=(\d+)",
                                    f.read()).group(1))] = i
        ids = {ports[ep["port"]]: ep["learner_id"]
               for ep in client.list_learners()}
        boot_s = time.perf_counter() - t0
        if release is not None:
            release.wait(MP_TIMEOUT_S)
        with open(gate, "w"):
            pass
        gate_at = time.time()
        t1 = time.perf_counter()
        stats = session.monitor_federation(poll_every_s=0.25)
        run_s = time.perf_counter() - t1
        final = client.get_community_model()
        endpoints = client.list_learners()
        if config.registry.enabled:
            # round-pinned versions: version k is round k-1's aggregate
            for version in range(1, rounds + 1):
                raw = client.get_registered_model(version=version,
                                                  timeout=60.0)
                versions[version] = hashlib.sha256(raw or b"").hexdigest()
                smoke.check(bool(raw), f"{label}: version {version} is "
                            "registered")
        promoted = session._standby_promoted
        promoted_logged = session.standby_promoted_in_log()
        if before_shutdown is not None:
            before_shutdown()
    finally:
        t2 = time.perf_counter()
        session.shutdown_federation(timeout_s=MP_TIMEOUT_S)
        shutdown_s = time.perf_counter() - t2
    codes = session.process_exit_codes()
    # the warm standby is a process of its own until it takes over, and
    # then the controller (the killed primary is no longer tracked)
    expected = len(shards) + 1 + (1 if standby and not promoted else 0)
    smoke.check(len(codes) == expected
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
    walls = {"boot_s": boot_s, "rounds_s": run_s, "shutdown_s": shutdown_s,
             "restarts": session._controller_restarts, "gate_at": gate_at}
    if hosts:
        walls["endpoints"] = endpoints
    if versions:
        walls["version_sha256"] = versions
    if standby:
        walls.update(promoted=promoted, promoted_logged=promoted_logged)
        log = os.path.join(workdir, "standby.log")
        if os.path.exists(log):
            with open(log) as f:
                text = f.read()
            found = re.search(r"promoted in ([0-9.]+)s", text)
            walls["promote_s"] = float(found.group(1)) if found else None
            walls["standby_promotions"] = text.count(
                "METISFL_TPU_CONTROLLER_PROMOTED")
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


def mp_split(stats, records, ids, rounds, gate_at=0.0):
    """Per round: the wall and its stages. Learner stages come from the
    learner's own clock and the controller's round metadata (one host, one
    clock): downlink = dispatch to the start of the blob's parse
    (community envelope encode, send, receive, envelope decode), unpack
    (blob parse into tensors), load_flax_variables, train (its weights
    copy-out included), blob pack, and uplink = the end of the pack to
    the controller's ingest (result envelope encode, send, decode).
    Controller stages: ingest (blob parse and store insert) per uplink,
    fold, and the community blob pack. A round's wall starts no earlier
    than ``gate_at``, when training was let go (round 0's tasks go out as
    the learners join)."""
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
            "wall_s": meta["completed_at"] - max(meta["started_at"],
                                                 gate_at),
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


def mp_llama_run(smoke, label, kill, release=None):
    """The multiprocess phase's LlamaLite federation: ``MP_LLAMA_LEARNERS``
    learner processes at full width and depth ``CUT_DEPTH``, ``MP_ROUNDS``
    rounds, the hot standby and the registry armed; with ``kill`` the
    chaos injector kills the controller at its first MarkTaskCompleted
    (mid-round, uplinks in the air). Returns ``run_multiprocess``'s."""
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        ChaosConfig,
        CommConfig,
        ControllerConfig,
        ControllerStandbyConfig,
        EvalConfig,
        FailoverConfig,
        RegistryConfig,
    )

    variables, _ = llama_seed(CUT_DEPTH)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    shards = [(tokens[i * FED_ROWS:(i + 1) * FED_ROWS, :-1],
               tokens[i * FED_ROWS:(i + 1) * FED_ROWS, 1:])
              for i in range(MP_LLAMA_LEARNERS)]
    test = (tokens[-FED_EVAL_ROWS:, :-1], tokens[-FED_EVAL_ROWS:, 1:])
    return run_multiprocess(
        smoke, label, "llama", shards, test,
        TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                    optimizer="adam", learning_rate=1e-4),
        EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                   metrics=["loss", "accuracy"]),
        MP_ROUNDS, variables, depth=CUT_DEPTH, config_extra=dict(
            comm=CommConfig(**FO_COMM),
            # the standby takes over a dead controller; no relaunch, so no
            # per-round checkpoint (each holds the 390 MB community model
            # and the registry's heads): the WAL's snapshots suffice
            failover=FailoverConfig(supervise_controller=False),
            registry=RegistryConfig(enabled=True, retention=16),
            controller=ControllerConfig(standby=ControllerStandbyConfig(
                enabled=True, **STANDBY)),
            chaos=ChaosConfig(enabled=kill, seed=SEED,
                              rules=[KILL_RULE] if kill else [])),
        release=release)


def multiprocess_phase(smoke, gpu):
    """(a) the CNN and (b) the full-width LlamaLite federation of the
    federation phase (at depth ``CUT_DEPTH`` with 2 learners, the hot
    standby and the registry armed: the failover phase's control), each
    with one controller process and one process per learner on
    ``DEVICE``, over localhost gRPC through DriverSession. The blobs of (b)
    (390 MB) travel the chunked path both ways. Without grpc or
    cloudpickle the phase cannot run; the wire phase takes its place."""
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
    # (b) boots while (a) runs: its processes import, reach the card and
    # join, and its rounds start once (a) is done
    release = threading.Event()
    llama_run = Background(mp_llama_run, smoke, "mp llama", False, release)
    # (a) FashionMNIST CNN, the federation phase's data and settings
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    shards = [(x[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES],
               y[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES])
              for i in range(FED_LEARNERS)]
    test = (x[-CNN_TEST:], y[-CNN_TEST:])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    try:
        stats, records, ids, workdir, final, walls = run_multiprocess(
            smoke, "mp cnn", "cnn", shards, test,
            TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                        optimizer="sgd", learning_rate=0.05),
            EvalConfig(batch_size=256, datasets=["test"],
                       metrics=["loss", "accuracy"]),
            CNN_ROUNDS, template)
    finally:
        release.set()
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

    # (b) full-width LlamaLite at depth CUT_DEPTH, the federation phase's
    # data and settings, with the hot standby and the registry armed
    stats, records, ids, workdir, final, walls = llama_run.result()
    smoke.check(not walls["promoted"] and not walls["standby_promotions"],
                "mp llama: failover-silent (the standby never promoted, and "
                "exits 0 at shutdown)")
    check_mp_folds(smoke, "mp llama", stats, ids, workdir,
                   [FED_ROWS] * MP_LLAMA_LEARNERS, final, MP_ROUNDS)
    launches = {name: sum(r["launches"][name] for r in records)
                for name in ("flash_attention_fwd", "flash_bwd_dq",
                             "flash_bwd_dkv")}
    train_launches = MP_LLAMA_LEARNERS * FED_STEPS * CUT_DEPTH
    eval_launches = (MP_LLAMA_LEARNERS * -(-FED_EVAL_ROWS // TRAIN_BATCH)
                     * CUT_DEPTH)
    k1, k2, k3 = (launches[n] / MP_ROUNDS for n in launches)
    smoke.check(k2 == k3 == train_launches
                and k1 == train_launches + eval_launches,
                f"mp llama: per round across the learner processes K2 {k2} "
                f"and K3 {k3} launches = learners x steps x depth = "
                f"{train_launches}; K1 {k1} = {train_launches} + "
                f"{eval_launches} (evaluation)")
    losses = [v["loss"] for m in stats["round_metadata"][:MP_ROUNDS]
              for v in m["train_metrics"].values()]
    smoke.check(len(losses) == MP_LLAMA_LEARNERS * MP_ROUNDS
                and all(np.isfinite(losses)),
                f"mp llama: train losses {[round(v, 4) for v in losses]} "
                "finite")
    # it was released after the CNN's federation: its round 0 starts then
    split = mp_split(stats, records, ids, MP_ROUNDS, walls["gate_at"])
    out["llama"] = {
        "rounds": MP_ROUNDS, "steps": FED_STEPS, "depth": CUT_DEPTH,
        "learners": MP_LLAMA_LEARNERS,
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


# -- wide-heads path: LlamaLite training at head dims beside the main path's

# dim 1024 with 64 and 32 heads (D = 16 and 32) in bf16 (K1's, K2's and
# K3's D = 16 and 32 builds, K3 unsplit at this shape), with 4 heads (D =
# 256) in bf16 (K1-K3's D = 256 builds, K3 in one launch of two
# warpgroups), and with 2 heads (D = 512) in bf16 (the general tensor-core
# K1-K3); D = 256 and 512 also in fp32 (the register-tiled K1, K2 and K3
# with the combine and the split sums); depth 2, 2 Adam steps at batch 2 of
# 256 tokens
WIDE_DEPTH, WIDE_STEPS, WIDE_BATCH, WIDE_LEN = 2, 2, 2, 256
# B, Hq, Hkv, L, D of the bf16 kernel cases at the D = 256 builds, and of
# the case that fills the card at D = 512: the D = 256 case's shape at
# twice the head dim
FULL_D256 = (2, 16, 4, 1024, 256)
FULL_D512 = (2, 16, 4, 1024, 512)
# B, Hq, Hkv, L, D of the fp32 K1 case that fills the card at D = 256: the
# fp32 K2/K3 case's shape
FULL_D256_FP32 = (2, 8, 2, 1024, 256)
# (label, heads, compute dtype, K1's wrapper, K2's and K3's wrappers): the
# wrappers each head dim routes to (the fp32 K1's combine and K2's and K3's
# split sums too, where they split: fwd_split_at, dq_split_at,
# dkv_split_at); each also runs as a kernel case at the path's own
# B·H·L·D
WIDE_CASES = (
    ("d16_bf16", 64, "bfloat16", "flash_attention_fwd",
     ("flash_bwd_dq", "flash_bwd_dkv")),
    ("d32_bf16", 32, "bfloat16", "flash_attention_fwd",
     ("flash_bwd_dq", "flash_bwd_dkv")),
    ("d256_bf16", 4, "bfloat16", "flash_attention_fwd",
     ("flash_bwd_dq", "flash_bwd_dkv")),
    ("d256_fp32", 4, "float32", "flash_fwd_general",
     ("flash_bwd_dq_general", "flash_bwd_dkv_general")),
    ("d512_bf16", 2, "bfloat16", "flash_fwd_general_mma",
     ("flash_bwd_dq_general_mma", "flash_bwd_dkv_general_mma")),
    ("d512_fp32", 2, "float32", "flash_fwd_general",
     ("flash_bwd_dq_general", "flash_bwd_dkv_general")),
)


def wide_heads_phase(smoke, gpu):
    """LlamaLite training through ``TorchModelOps.train`` at D = 16, 32,
    256 and 512: each launch lands on the kernel the head dim routes to,
    the loss stays finite and one batch's gradients hold to the dense
    path's."""
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
        # each step's K1, K2 and K3 calls, with their routes' second
        # launches
        shape = (WIDE_BATCH, heads, heads, WIDE_LEN, DIM // heads, True)
        want = {}
        for kernel in ("fwd", "dq", "dkv"):
            for n, c in per_call_launches(kernel, dtype_name,
                                          *shape).items():
                want[n] = want.get(n, 0) + c * steps
        smoke.check({fwd, dq, dkv} <= set(want),
                    f"wide heads {label}: the routes name {sorted(want)}, "
                    f"the path expects {fwd}, {dq} and {dkv}")
        # fp32 is the model's own compute dtype (None)
        dtype = None if dtype_name == "float32" else getattr(torch,
                                                             dtype_name)
        cfg = dict(vocab_size=VOCAB, dim=DIM, depth=WIDE_DEPTH, heads=heads,
                   kv_heads=heads, dtype=dtype)
        variables = random_variables(LlamaLite(**cfg, device="meta"), SEED)
        ops = TorchModelOps(LlamaLite(**cfg, use_flash=True, device=DEVICE),
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
            launched[n] >= c if n in FWD_WRAPPERS else launched[n] == c
            for n, c in want.items()))
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
    """(a) the full-width LlamaLite federation (depth ``CUT_DEPTH``) in
    process on a cached disk store with parallel ingest, and the native
    fold; (b) the CNN with a process per learner on a remote store."""
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

    out = {"depth": CUT_DEPTH}
    # (a) LlamaLite, 3 learners x 1 round of 2 Adam steps
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=CUT_DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables, seed_blob = llama_seed(CUT_DEPTH)
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
                TorchModelOps(LlamaLite(**llama, use_flash=True,
                                        device=DEVICE),
                              variables=variables, device=DEVICE),
                ArrayDataset(rows[:, :-1], rows[:, 1:], seed=SEED + i),
                test_dataset=test)
        seed_federation(fed, seed_blob)
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
        smoke.check(len(seed_blob) > STORE_CACHE_MB << 20
                    and store.cache_misses >= FED_LEARNERS
                    and store._cached_total == 0,
                    f"store llama: select read every {len(seed_blob)}-byte "
                    f"model from its mmapped file ({store.cache_misses} "
                    f"cache misses; "
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


# -- rules phase: the controller's other aggregation rules, the robust ones
# combining on the card, and learners launched over ssh

RULE_NAMES = ("fedavg", "fedstride", "fedrec", "fednova", "fedavgm",
              "fedadam", "fedyogi", "median", "trimmed_mean", "krum",
              "multikrum")
ROBUST_RULES = ("median", "trimmed_mean", "krum", "multikrum")
# the server optimizers' learning rate in this phase (the default 1.0
# moves every weight by about 1 on a cold Adam step)
RULES_SERVER_LR = 0.1
# the card's combine against the CPU path on the same LlamaLite uplinks,
# max |card - cpu| over max|w| per tensor: bit for bit for the median,
# the trimmed mean of 3 (the median) and Krum (a picked uplink); the folds
# (an f32 accumulator over 3 models, summed in another order on the card)
# within 1e-6; the server optimizers within 1e-4 (their step divides the
# pseudo-gradient by sqrt(v) + tau, which multiplies an accumulator's last
# bit by up to 1/tau = 1e3 at the learning rate above); MultiKrum's float64
# mean within 1e-7 (its cast back to f32 is the only rounding)
RULES_REL_TOL = {"fedavg": 1e-6, "fedstride": 1e-6, "fedrec": 1e-6,
                 "fednova": 1e-6, "fedavgm": 1e-4, "fedadam": 1e-4,
                 "fedyogi": 1e-4, "median": 0.0, "trimmed_mean": 0.0,
                 "krum": 0.0, "multikrum": 1e-7}
# CNN federations of the phase: 2 rounds under each of these rules
RULES_CNN = ("fedrec", "fednova", "fedadam", "multikrum")
RULES_CNN_ROUNDS = 2
# the non-local hostname of the ssh launch: this machine, by another name
SSH_HOST = "127.0.0.2"


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def empty_cache():
    import torch

    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def build_rule(name, device):
    """The port's rule as the controller builds it (hyperparameters of
    this phase; the robust rules on ``device``)."""
    from metisfl_tpu_torch.aggregation import make_aggregation_rule

    kwargs = {}
    if name in ("fedavgm", "fedadam", "fedyogi"):
        kwargs["learning_rate"] = RULES_SERVER_LR
    if name in ROBUST_RULES:
        kwargs["device"] = device
    return make_aggregation_rule(name, **kwargs)


def rule_aggregate(rule, name, models, scales, steps, seed=None):
    """One aggregation as the controller runs it (the stateful rules
    seeded with ``seed``; FedNova with ``steps``)."""
    if seed is not None and hasattr(rule, "seed_community"):
        rule.seed_community(seed)
    pairs = [([m], s) for m, s in zip(models, scales)]
    if name == "fednova":
        return rule.aggregate(pairs, steps=steps)
    if name in ("fedstride", "fedrec"):
        return rule.aggregate(pairs, learner_ids=[f"L{i}" for i in
                                                  range(len(pairs))])
    return rule.aggregate(pairs)


def rel_diff(got, want):
    """max over tensors of max|got - want| / max|want|."""
    worst = 0.0
    for k in want:
        w = np.asarray(want[k]).astype(np.float64)
        g = np.asarray(got[k]).astype(np.float64)
        worst = max(worst, float(np.abs(g - w).max())
                    / max(float(np.abs(w).max()), 1e-30))
    return worst


def same_bits(got, want):
    """The same names, dtypes, shapes and bytes (compared in place)."""
    def raw(arr):
        return np.ascontiguousarray(np.asarray(arr)).view(np.uint8)

    return sorted(got) == sorted(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.shape(got[k]) == np.shape(want[k])
        and np.array_equal(raw(got[k]), raw(want[k])) for k in want)


def rules_on_uplinks(smoke, uplinks, scales, steps, seed):
    """Each rule's ``aggregate`` on the full-width LlamaLite uplinks, on
    the card and on the CPU path, timed in H2D, combine and D2H. The
    robust rules take the host uplinks as the controller hands them over
    and report their own stages; the folds take the uplinks as trees of
    tensors on the card (the H2D here), fold there, and come back (the
    server optimizers' and FedNova's step runs on the host inside the
    combine)."""
    import torch

    from metisfl_tpu_torch.tensor.pytree import as_tensor, to_numpy

    out = {}
    for name in RULE_NAMES:
        rule = build_rule(name, DEVICE)
        if name in ROBUST_RULES:
            got = rule_aggregate(rule, name, uplinks, scales, steps, seed)
            timing = dict(rule.last_timing)
        else:
            sync()
            t0 = time.perf_counter()
            on_card = [{k: as_tensor(v).to(DEVICE) for k, v in m.items()}
                       for m in uplinks]
            sync()
            t1 = time.perf_counter()
            result = rule_aggregate(rule, name, on_card, scales, steps,
                                    seed)
            sync()
            t2 = time.perf_counter()
            got = {k: to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
                   for k, v in result.items()}
            t3 = time.perf_counter()
            del on_card, result
            timing = {"device": DEVICE, "h2d_ms": (t1 - t0) * 1e3,
                      "combine_ms": (t2 - t1) * 1e3,
                      "d2h_ms": (t3 - t2) * 1e3}
        t0 = time.perf_counter()
        want = rule_aggregate(build_rule(name, "cpu"), name, uplinks, scales,
                              steps, seed)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        empty_cache()
        rel = rel_diff(got, want)
        exact = same_bits(got, want)
        tol = RULES_REL_TOL[name]
        smoke.check(exact if tol == 0.0 else (rel <= tol and sorted(got)
                                              == sorted(want)),
                    f"rules: {name} on the card against its CPU path: "
                    f"{'bit for bit' if exact else f'max rel {rel:.3g}'} "
                    f"(<= {tol if tol else 'bit for bit'}); "
                    f"{timing['device']} H2D {timing['h2d_ms']:.1f} ms, "
                    f"combine {timing['combine_ms']:.1f} ms, D2H "
                    f"{timing['d2h_ms']:.1f} ms; CPU path {cpu_ms:.1f} ms")
        if name in ROBUST_RULES:
            smoke.check(timing["device"].startswith(DEVICE),
                        f"rules: {name} combined on {timing['device']}")
        out[name] = {**timing, "cpu_path_ms": cpu_ms, "max_rel": rel,
                     "bit_exact": exact}
        del got, want
    return out


def replay_rule(name, seed, rounds_of_uplinks, scales_of_rounds,
                steps_of_rounds):
    """A fresh rule of ``name`` (the robust ones on the card) driven
    through the recorded rounds as the controller drove it; returns each
    round's community."""
    rule = build_rule(name, DEVICE)
    if hasattr(rule, "seed_community"):
        rule.seed_community(seed)
    outs = []
    for ups, scales, steps in zip(rounds_of_uplinks, scales_of_rounds,
                                  steps_of_rounds):
        ids = list(ups)
        pairs = [([ups[lid]], scales[lid]) for lid in ids]
        if name == "fednova":
            outs.append(rule.aggregate(pairs, steps=[steps[lid]
                                                     for lid in ids]))
        elif name in ("fedstride", "fedrec"):
            outs.append(rule.aggregate(pairs, learner_ids=ids))
        else:
            outs.append(rule.aggregate(pairs))
    return outs


def recorded_rounds(probe, stats, rounds, scaler_name, steps_per_task):
    """The uplinks of each round in the order the controller folded them,
    their scales as its scaler weighs them, and their local steps."""
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import to_numpy

    sizes = {learner.learner_id: len(learner.datasets["train"])
             for learner in probe.fed.learners}
    scaler = make_scaler(scaler_name)
    ups, scales, steps = [], [], []
    for r in range(rounds):
        selected = stats["round_metadata"][r]["selected_learners"]
        ups.append({lid: {n: to_numpy(t) for n, t in ModelBlob.from_bytes(
            probe.uplinks[r][lid]).tensors} for lid in selected})
        scales.append(scaler({lid: {"num_train_examples": sizes[lid],
                                    "completed_batches": steps_per_task}
                              for lid in selected}))
        steps.append({lid: float(steps_per_task) for lid in selected})
    return ups, scales, steps


def parse_blob(blob):
    from metisfl_tpu_torch.tensor import ModelBlob
    from metisfl_tpu_torch.tensor.pytree import to_numpy

    return {n: to_numpy(t) for n, t in ModelBlob.from_bytes(blob).tensors}


def ssh_shims(bindir):
    """``ssh`` and ``scp`` stand-ins that run here: the card's machine has
    no second host. ssh drops its options and runs the remote command
    with ``sh -c``; scp copies to the same path (one filesystem). Each
    call is appended to ``<bindir>/calls``."""
    os.makedirs(bindir, exist_ok=True)
    calls = os.path.join(bindir, "calls")
    with open(os.path.join(bindir, "ssh"), "w") as f:
        f.write("#!/bin/sh\n"
                f'echo "ssh $*" >> "{calls}"\n'
                'while [ "$1" != "${1#-}" ]; do case "$1" in -p) shift 2;; '
                '*) shift;; esac; done\n'
                'shift\n'
                'exec sh -c "$1"\n')
    with open(os.path.join(bindir, "scp"), "w") as f:
        f.write("#!/bin/sh\n"
                f'echo "scp $*" >> "{calls}"\n'
                'while [ "$1" != "${1#-}" ]; do case "$1" in -P) shift 2;; '
                '*) shift;; esac; done\n'
                'src="$1"; dst="${2#*:}"\n'
                'mkdir -p "$(dirname "$dst")"\n'
                'if [ "$src" -ef "$dst" ]; then exit 0; fi\n'
                'exec cp "$src" "$dst"\n')
    for name in ("ssh", "scp"):
        path = os.path.join(bindir, name)
        os.chmod(path, 0o755)
    return calls


def rules_phase(smoke, gpu, fedavg_llama_walls):
    """(a) one in-process LlamaLite round (full width, depth
    ``CUT_DEPTH``) under ``median`` with the controller on the card: its
    community against the rule re-applied to the round's uplinks, K1-K3
    counted in the learners' training; (b) each of the eleven rules on
    those three full-width uplinks, on the card
    against the CPU path; (c) the CNN federation in process, 2 rounds
    under each of fedrec, fednova, fedadam and multikrum, each round's
    community against the rule replayed over the recorded uplinks; (d) the
    multi-process CNN round with one learner endpoint on a non-local
    hostname, launched through ssh/scp shims."""
    import torch

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from metisfl_tpu_torch.tensor import pack_model

    out = {"learners": FED_LEARNERS}
    # (a) full-width LlamaLite, 1 round under median, the controller on
    # the card
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=CUT_DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables, seed_blob = llama_seed(CUT_DEPTH)
    seed = parse_blob(seed_blob)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    cfg = FederationConfig(
        aggregation=AggregationConfig(rule="median",
                                      scaler="train_dataset_size"),
        train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                          optimizer="adam", learning_rate=1e-4),
        eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                        metrics=["loss", "accuracy"]),
        termination=TerminationConfig(federation_rounds=1))
    fed = InProcessFederation(cfg, device=DEVICE)
    for i in range(FED_LEARNERS):
        rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
        ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                      device=DEVICE),
                            variables=variables, device=DEVICE)
        fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                          seed=SEED + i),
                        test_dataset=test)
    seed_federation(fed, seed_blob)
    del variables
    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    probe, stats = run_federation(fed)
    sync()
    k1, k2, k3 = (fn.launches for fn in counters)
    train_launches = FED_LEARNERS * FED_STEPS * CUT_DEPTH
    eval_launches = (FED_LEARNERS * -(-FED_EVAL_ROWS // TRAIN_BATCH)
                     * CUT_DEPTH)
    smoke.check(k2 == k3 == train_launches
                and k1 == train_launches + eval_launches,
                f"rules median round: K2 {k2} and K3 {k3} launches = "
                f"learners x steps x depth = {train_launches}; K1 {k1} = "
                f"{train_launches} + {eval_launches} (evaluation)")
    meta = stats["round_metadata"][0]
    device_ms = meta["aggregation_device_ms"]
    smoke.check(str(device_ms.get("device", "")).startswith(DEVICE)
                and fed.controller._aggregator.device.type == DEVICE,
                f"rules median round: the controller combined on "
                f"{device_ms.get('device')}: H2D "
                f"{device_ms.get('h2d_ms', 0):.1f} ms, combine "
                f"{device_ms.get('combine_ms', 0):.1f} ms, D2H "
                f"{device_ms.get('d2h_ms', 0):.1f} ms")
    ups, scales_r, steps_r = recorded_rounds(probe, stats, 1,
                                             "train_dataset_size", FED_STEPS)
    community = parse_blob(probe.communities[0])
    again = replay_rule("median", seed, ups, scales_r, steps_r)[0]
    smoke.check(same_bits(community, again),
                "rules median round: the community model equals the median "
                "re-applied on the card to the 3 stored uplinks, bit for "
                "bit")
    split = probe.split(stats)[0]
    out["median_llama"] = {
        "round_wall_s": split["wall_s"], "split": split,
        "aggregation_device_ms": device_ms,
        "fedavg_round_wall_s": fedavg_llama_walls,
        "launches": {"flash_fwd": k1, "flash_bwd_dq": k2,
                     "flash_bwd_dkv": k3}}
    print(f"rules median round (depth {CUT_DEPTH}): wall "
          f"{split['wall_s']:.3f} s (fedavg in the federation phase, depth "
          f"{DEPTH}: {fedavg_llama_walls} s); fold stage "
          f"{split['controller_s']['fold']:.3f} s", flush=True)
    del fed, probe, community, again
    empty_cache()

    # (b) every rule on those uplinks, the card against the CPU path
    models = [ups[0][lid] for lid in ups[0]]
    scales = [scales_r[0][lid] for lid in ups[0]]
    steps = [steps_r[0][lid] for lid in ups[0]]
    out["uplinks"] = {
        "models": len(models),
        "params": int(sum(np.asarray(v).size for v in models[0].values())),
        "bytes": int(sum(np.asarray(v).nbytes for v in models[0].values()))}
    out["rules"] = rules_on_uplinks(smoke, models, scales, steps, seed)
    del models, ups, seed
    empty_cache()

    # (c) the CNN federation under four more rules, the controller on the
    # card
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    test = ArrayDataset(x[-CNN_TEST:], y[-CNN_TEST:])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    cnn_seed = parse_blob(pack_model(template))
    out["cnn"] = {}
    for rule in RULES_CNN:
        extra = ({"server_learning_rate": RULES_SERVER_LR}
                 if rule == "fedadam" else {})
        cfg = FederationConfig(
            aggregation=AggregationConfig(rule=rule,
                                          scaler="train_dataset_size",
                                          **extra),
            train=TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                              optimizer="sgd", learning_rate=0.05),
            eval=EvalConfig(batch_size=256, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(
                federation_rounds=RULES_CNN_ROUNDS))
        fed = InProcessFederation(cfg, device=DEVICE)
        for i in range(FED_LEARNERS):
            ops = TorchModelOps(FashionMnistCNN(), device=DEVICE,
                                variables=template)
            part = slice(i * CNN_EXAMPLES, (i + 1) * CNN_EXAMPLES)
            fed.add_learner(ops, ArrayDataset(x[part], y[part],
                                              seed=SEED + i),
                            test_dataset=test)
        fed.seed_model(template)
        probe, stats = run_federation(fed)
        ups, scales_r, steps_r = recorded_rounds(
            probe, stats, RULES_CNN_ROUNDS, "train_dataset_size", CNN_STEPS)
        replayed = replay_rule(rule, cnn_seed, ups, scales_r, steps_r)
        same = all(same_bits(parse_blob(probe.communities[r]), replayed[r])
                   for r in range(RULES_CNN_ROUNDS))
        acc = _accuracies(stats)
        smoke.check(stats["global_iteration"] >= RULES_CNN_ROUNDS and same
                    and all(np.isfinite(acc)),
                    f"rules cnn {rule}: {RULES_CNN_ROUNDS} rounds, each "
                    "community equal bit for bit to the rule replayed over "
                    f"the recorded uplinks; accuracy {acc}")
        out["cnn"][rule] = {
            "test_accuracy": acc,
            "round_wall_s": [m["completed_at"] - m["started_at"]
                             for m in stats["round_metadata"]
                             [:RULES_CNN_ROUNDS]],
            "aggregation_ms": [m["aggregation_duration_ms"]
                               for m in stats["round_metadata"]
                               [:RULES_CNN_ROUNDS]],
            "aggregation_device_ms": [m["aggregation_device_ms"]
                                      for m in stats["round_metadata"]
                                      [:RULES_CNN_ROUNDS]]}
        del fed, probe
        empty_cache()

    # (d) the multi-process CNN round, learner 1 on a non-local hostname
    # through the ssh/scp shims
    out["ssh"] = ssh_round(smoke)
    out["gpu"] = gpu
    print(json.dumps({"rules": out}), flush=True)
    return out


def ssh_round(smoke):
    """One CNN round with a process per learner through DriverSession,
    learner 1's endpoint ``SSH_HOST``: it is shipped its recipe and
    launched through the ``ssh``/``scp`` shims (this machine has no second
    host), and the shutdown must reach it at that hostname."""
    for name in ("grpc", "cloudpickle"):
        try:
            __import__(name)
        except ImportError:
            smoke.failures.append(f"rules ssh: {name} missing")
            return None
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import EvalConfig
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
    hosts = ["localhost"] * FED_LEARNERS
    hosts[1] = SSH_HOST
    bindir = os.path.join(MP_DIR, "ssh_shims")
    calls = ssh_shims(bindir)
    saved_path = os.environ["PATH"]
    os.environ["PATH"] = bindir + os.pathsep + saved_path
    print(f"rules ssh: learner 1 at {SSH_HOST} through ssh/scp shims in "
          f"{bindir} that run here (no second host)", flush=True)
    try:
        stats, records, ids, workdir, final, walls = run_multiprocess(
            smoke, "rules ssh cnn", "cnn", shards, test,
            TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                        optimizer="sgd", learning_rate=0.05),
            EvalConfig(batch_size=256, datasets=["test"],
                       metrics=["loss", "accuracy"]),
            1, template, hosts=hosts)
        check_mp_folds(smoke, "rules ssh cnn", stats, ids, workdir,
                       [len(s[0]) for s in shards], final, 1)
        with open(calls) as f:
            lines = f.read().splitlines()
        with open(os.path.join(workdir, "learner_1.log")) as f:
            shut = "learner ShutDown RPC received" in f.read()
        remote = [ep for ep in walls["endpoints"]
                  if ep["hostname"] == SSH_HOST]
        launched = [line for line in lines if line.startswith(
            f"ssh {SSH_HOST}") and "metisfl_tpu_torch.learner" in line]
        shipped = [line for line in lines if line.startswith("scp")
                   and "learner_1_recipe.pkl" in line]
        smoke.check(len(remote) == 1 and len(launched) == 1
                    and len(shipped) == 1 and shut,
                    f"rules ssh: learner 1 registered at "
                    f"{[ep['hostname'] for ep in remote]}, was shipped its "
                    f"recipe ({len(shipped)} scp) and launched over ssh "
                    f"({len(launched)}), and the ShutDown RPC reached it "
                    f"({shut}); ran ssh/scp shims, not a remote host")
        return {"shims": True, "host": SSH_HOST,
                "endpoints": walls["endpoints"], "ssh_calls": len(lines),
                "boot_s": walls["boot_s"], "rounds_s": walls["rounds_s"],
                "shutdown_s": walls["shutdown_s"]}
    finally:
        os.environ["PATH"] = saved_path
        shutil.rmtree(MP_DIR, ignore_errors=True)


# -- the controller's tiers and secure aggregation --------------------------

# the tree tier's branch on the LlamaLite round
TIERS_BRANCH = 2
# the masked community against the float64 mean of the plaintext uplinks:
# the fixed point rounds each value to 2^-41 (the JAX package's
# tests/test_secure_agg.py tolerance)
MASK_ATOL = 1e-9
# the CKKS community against the plain weighted mean (its tests/test_ckks.py)
CKKS_ATOL = 1e-5
# the tree tier against the flat fold on real-valued uplinks: f32 sums
# reassociated, relative to max|w| per tensor
TREE_REL = 1e-6
# the CNN rounds with processes of (d) (learner 0 leaves in round 1) and (e)
SECURE_MP_ROUNDS, CKKS_MP_ROUNDS = 2, 1


class PlainSums:
    """Probes the learners' secure backends: each ``encrypt`` call's wall
    and thread CPU seconds, by learner and round (mask generation with the
    fixed-point encode; the learners of one process share its
    interpreter, so the wall counts the others' turns too), and the
    float64 sum over learners of the plaintext each call receives, by
    round and tensor index."""

    def __init__(self, backends):
        self.seconds = {}        # (learner index, round) -> wall s
        self.cpu_seconds = {}    # (learner index, round) -> thread CPU s
        self.sums = {}           # round -> {tensor index: float64 sum}
        self._lock = threading.Lock()
        for i, backend in enumerate(backends):
            self._wrap(i, backend)

    def _wrap(self, i, backend):
        encrypt = backend.encrypt
        counter = {}

        def probed(values):
            rid = getattr(backend, "_round_id", 0)
            t = counter.get(rid, 0)
            counter[rid] = t + 1
            t0, c0 = time.perf_counter(), time.thread_time()
            out = encrypt(values)
            dt, dc = time.perf_counter() - t0, time.thread_time() - c0
            plain = np.asarray(values, np.float64)
            with self._lock:
                key = (i, rid)
                self.seconds[key] = self.seconds.get(key, 0.0) + dt
                self.cpu_seconds[key] = self.cpu_seconds.get(key, 0.0) + dc
                sums = self.sums.setdefault(rid, {})
                sums[t] = plain.copy() if t not in sums else sums[t] + plain
            return out

        backend.encrypt = probed


def opaque_payloads(blob):
    """A secure community blob's float64 payloads in wire order."""
    from metisfl_tpu_torch.tensor import ModelBlob

    return [np.frombuffer(payload, np.float64)
            for _, (payload, _) in ModelBlob.from_bytes(blob).opaque.items()]


def tiers_secure_phase(smoke, gpu):
    """(a) the in-process full-width LlamaLite round (depth ``CUT_DEPTH``)
    on the store path and under ``aggregation.streaming`` (fedavg), the
    same seeds; (b) the same
    round under the tree tier at branch 2; (c) under ``scheme: masking``
    with streaming (masked uplinks fold on arrival, the barrier settles);
    (d) the FashionMNIST CNN with a process per learner under masking and
    streaming, learner 0 leaving mid-round 1, its masks recovered from a
    survivor; (e) the CNN with processes under ``scheme: ckks`` with the
    driver's keygen. CKKS runs on the CNN, not LlamaLite: its ciphertexts
    take 2 uint64 words a value, about 3 GB an uplink at 189 M parameters
    (four times the plain blob), through the learners, the controller and
    the gRPC transport of every round."""
    import torch

    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.aggregation.streaming import StreamingAggregator
    from metisfl_tpu_torch.aggregation.tree import TreeReducer
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.config.federation import (
        SecureAggConfig,
        TreeAggregationConfig,
    )
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from metisfl_tpu_torch.scaling import make_scaler, raw_weight
    from metisfl_tpu_torch.secure import MaskingBackend

    out = {"learners": FED_LEARNERS}
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=CUT_DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables, seed_blob = llama_seed(CUT_DEPTH)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    sizes = {}

    def llama_round(aggregation, secure=None, backends=None,
                    controller_backend=None):
        """One LlamaLite round in process (equal shards of FED_ROWS rows,
        so masking's uniform scales hold)."""
        cfg = FederationConfig(
            aggregation=aggregation,
            secure=secure or SecureAggConfig(),
            train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                              optimizer="adam", learning_rate=1e-4),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=1))
        fed = InProcessFederation(cfg, device=DEVICE,
                                  secure_backend=controller_backend)
        for i in range(FED_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                          device=DEVICE),
                                variables=variables, device=DEVICE)
            learner = fed.add_learner(
                ops, ArrayDataset(rows[:, :-1], rows[:, 1:], seed=SEED + i),
                test_dataset=test,
                secure_backend=None if backends is None else backends[i])
            sizes[learner.port] = len(rows)
        seed_federation(fed, seed_blob)
        return fed

    def finish(label, fed, probe, stats):
        sync()
        meta = stats["round_metadata"][0]
        losses = [v["loss"] for v in meta["train_metrics"].values()]
        eval_losses = _accuracies(stats, "loss")
        smoke.check(stats["global_iteration"] >= 1 and len(losses) ==
                    FED_LEARNERS and all(np.isfinite(losses + eval_losses)),
                    f"{label}: the round completed; train losses "
                    f"{[round(v, 4) for v in losses]} and community eval "
                    f"losses {[round(v, 4) for v in eval_losses]} finite")
        split = probe.split(stats)[0]
        print(f"{label}: round wall {split['wall_s']:.3f} s, fold stage "
              f"{split['controller_s']['fold']:.3f} s", flush=True)
        return split

    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0

    # (a) the store path, then streaming, the same seeds
    fed = llama_round(AggregationConfig(scaler="train_dataset_size"))
    probe, stats = run_federation(fed)
    check_folds(smoke, "tiers store", probe, stats, 1, f64_rel=FED_F64_REL)
    out["store"] = finish("tiers store", fed, probe, stats)
    del fed, probe
    empty_cache()

    fed = llama_round(AggregationConfig(scaler="train_dataset_size",
                                        streaming=True))
    ctrl = fed.controller
    stream = ctrl._streaming
    folds, finished, selects = [], [], []
    fold, finish_stream, select = stream.fold, stream.finish, \
        ctrl._store.select

    def recorded_fold(learner_id, model, weight):
        folds.append((learner_id, weight))
        return fold(learner_id, model, weight)

    def recorded_finish(selected):
        finished.append(stream.stats())
        return finish_stream(selected)

    def recorded_select(*args, **kwargs):
        selects.append(args)
        return select(*args, **kwargs)

    stream.fold, stream.finish = recorded_fold, recorded_finish
    ctrl._store.select = recorded_select
    probe, stats = run_federation(fed)
    selected = stats["round_metadata"][0]["selected_learners"]
    smoke.check(len(finished) == 1 and finished[0]["folded"] ==
                FED_LEARNERS == len(selected) and not selects
                and not ctrl._store.learner_ids(),
                f"tiers streaming: the stream engaged: {finished[:1]} "
                f"folded at the barrier for a cohort of {len(selected)}, "
                f"{len(selects)} store selects, "
                f"{len(ctrl._store.learner_ids())} stored models")
    again = StreamingAggregator(FedAvg(), stride=0)
    for lid, weight in folds:
        again.fold(lid, parse_blob(probe.uplinks[0][lid]), weight)
    by_id = {lid: sizes[int(lid.rsplit("_", 1)[1])] for lid, _ in folds}
    smoke.check(
        same_bits(parse_blob(probe.communities[0]), again.finish(selected))
        and [w for _, w in folds] == [
            raw_weight("train_dataset_size", {"num_train_examples":
                                              by_id[lid]})
            for lid, _ in folds],
        f"tiers streaming: the community model equals a re-fold of the "
        f"{len(folds)} recorded uplinks in the order the round folded "
        f"them ({[lid for lid, _ in folds]}), bit for bit")
    out["streaming"] = finish("tiers streaming", fed, probe, stats)
    out["streaming"]["fold_order"] = [lid for lid, _ in folds]
    del fed, ctrl, stream, probe, again
    empty_cache()

    # (b) the tree tier at branch TIERS_BRANCH
    fed = llama_round(AggregationConfig(
        scaler="train_dataset_size",
        tree=TreeAggregationConfig(enabled=True, branch=TIERS_BRANCH)))
    probe, stats = run_federation(fed)
    meta = stats["round_metadata"][0]
    selected = meta["selected_learners"]
    scales = make_scaler("train_dataset_size")(
        {lid: {"num_train_examples": sizes[int(lid.rsplit("_", 1)[1])]}
         for lid in selected})
    ups = {lid: parse_blob(probe.uplinks[0][lid]) for lid in selected}
    replay = TreeReducer(branch=TIERS_BRANCH)
    try:
        want, parts = replay.reduce(
            selected, scales,
            lambda block: {lid: [ups[lid]] for lid in block})
    finally:
        replay.shutdown()
    got = parse_blob(probe.communities[0])
    flat = FedAvg().aggregate([([ups[lid]], scales[lid])
                               for lid in selected])
    tree_rel = rel_diff(got, flat)
    smoke.check(same_bits(got, want) and meta["aggregation_block_sizes"]
                == [p.count for p in parts],
                f"tiers tree: the community model equals TreeReducer "
                f"(branch {TIERS_BRANCH}) replayed over the {len(ups)} "
                f"recorded uplinks, bit for bit; slices "
                f"{meta['aggregation_block_sizes']}")
    smoke.check(tree_rel <= TREE_REL,
                f"tiers tree: within {tree_rel:.3g} x max|w| of the flat "
                f"FedAvg fold (<= {TREE_REL})")
    out["tree"] = finish("tiers tree", fed, probe, stats)
    out["tree"]["rel_to_flat"] = tree_rel
    del fed, probe, ups, want, got, flat
    empty_cache()

    # (c) masking with streaming: masked uplinks fold on arrival
    secret = "chip-smoke-" + str(SEED)
    backends = [MaskingBackend(secret, i, FED_LEARNERS)
                for i in range(FED_LEARNERS)]
    plain = PlainSums(backends)
    fed = llama_round(
        AggregationConfig(rule="secure_agg", scaler="participants",
                          streaming=True),
        SecureAggConfig(enabled=True, scheme="masking",
                        num_parties=FED_LEARNERS),
        backends, MaskingBackend(num_parties=FED_LEARNERS))
    settle = fed.controller._settle_masked
    settled = []

    def timed_settle(*args):
        t0 = time.perf_counter()
        try:
            return settle(*args)
        finally:
            settled.append(time.perf_counter() - t0)

    fed.controller._settle_masked = timed_settle
    probe, stats = run_federation(fed)
    k1, k2, k3 = (fn.launches for fn in counters)
    payloads = opaque_payloads(probe.communities[0])
    sums = plain.sums[0]
    worst = max(float(np.abs(p - sums[t] / FED_LEARNERS).max())
                for t, p in enumerate(payloads))
    smoke.check(len(payloads) == len(sums) and worst <= MASK_ATOL
                and len(settled) == 1,
                f"tiers masking: the settled community is within "
                f"{worst:.3g} of the float64 mean of the {FED_LEARNERS} "
                f"learners' plaintext uplinks (<= {MASK_ATOL}), over "
                f"{len(payloads)} tensors")
    gen = [plain.seconds[(i, 0)] for i in range(FED_LEARNERS)]
    gen_cpu = [plain.cpu_seconds[(i, 0)] for i in range(FED_LEARNERS)]
    out["masking"] = finish("tiers masking", fed, probe, stats)
    out["masking"].update({
        "mask_generation_s": gen, "mask_generation_cpu_s": gen_cpu,
        "settlement_s": settled,
        "max_abs_to_f64_mean": worst,
        "uplink_bytes": stats["round_metadata"][0]["uplink_bytes"]})
    print(f"tiers masking: mask generation {[round(g, 3) for g in gen]} s "
          f"a learner ({[round(g, 3) for g in gen_cpu]} s of its thread's "
          f"CPU), settlement {[round(s, 3) for s in settled]} s, "
          f"round wall {out['masking']['wall_s']:.3f} s against streaming "
          f"{out['streaming']['wall_s']:.3f} s", flush=True)
    del fed, probe, backends, plain, payloads, sums
    empty_cache()

    per_round = FED_LEARNERS * FED_STEPS * CUT_DEPTH
    eval_per_round = (FED_LEARNERS * -(-FED_EVAL_ROWS // TRAIN_BATCH)
                      * CUT_DEPTH)
    rounds = 4
    smoke.check(k2 == k3 == rounds * per_round
                and k1 == rounds * (per_round + eval_per_round),
                f"tiers llama: K2 {k2} and K3 {k3} launches = {rounds} "
                f"rounds x learners x steps x depth = {rounds * per_round}; "
                f"K1 {k1} = {rounds * per_round} + "
                f"{rounds * eval_per_round} (evaluation)")
    out["launches"] = {"flash_fwd": k1, "flash_bwd_dq": k2,
                       "flash_bwd_dkv": k3}
    del variables

    # (d), (e): the CNN with a process per learner
    for name in ("grpc", "cloudpickle"):
        try:
            __import__(name)
        except ImportError:
            smoke.failures.append(f"tiers processes: {name} missing")
            out["gpu"] = gpu
            return out
    # the two federations at once: each holds its own gate and hold files,
    # and their processes boot side by side
    ckks = Background(secure_processes, smoke, "ckks")
    out["masking_processes"] = secure_processes(smoke, "masking")
    out["ckks_processes"] = ckks.result()
    out["gpu"] = gpu
    print(json.dumps({"tiers_secure": out}), flush=True)
    return out


def secure_processes(smoke, scheme):
    """The CNN with a controller process and a process per learner through
    DriverSession. ``masking``: with streaming, SECURE_MP_ROUNDS rounds;
    learner 0 leaves the federation (through the controller, with its
    saved credentials) while its round-1 task waits, the round settles
    with the two survivors, and one of them discloses learner 0's
    residual masks (``RecoverMasks``). ``ckks``: CKKS_MP_ROUNDS rounds,
    the driver's keygen; the community decrypts to the plain FedAvg."""
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.config.federation import SecureAggConfig
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.driver import DriverSession
    from metisfl_tpu_torch.learner.__main__ import load_credentials
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN
    from metisfl_tpu_torch.secure.ckks import CKKSBackend
    from metisfl_tpu_torch.tensor import ModelBlob

    label = f"tiers {scheme} cnn"
    masking = scheme == "masking"
    rounds = SECURE_MP_ROUNDS if masking else CKKS_MP_ROUNDS
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    sizes = [CNN_EXAMPLES] * FED_LEARNERS if masking else [
        CNN_EXAMPLES // 2, CNN_EXAMPLES, CNN_EXAMPLES]
    workdir = os.path.join(MP_DIR, f"tiers_{scheme}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gate, hold = (os.path.join(workdir, "gate"),
                  os.path.join(workdir, "hold"))
    recipes = []
    for i in range(FED_LEARNERS):
        lo = i * CNN_EXAMPLES
        out_dir = os.path.join(workdir, f"record_{i}")
        os.makedirs(out_dir)
        recipes.append(mp_recipe(
            "cnn", x[lo:lo + sizes[i]], y[lo:lo + sizes[i]], x[-CNN_TEST:],
            y[-CNN_TEST:], SEED + i, DEVICE, out_dir, gate,
            hold=hold if masking and i == 0 else ""))
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(
            rule="secure_agg",
            scaler="participants" if masking else "train_dataset_size",
            streaming=masking),
        secure=SecureAggConfig(enabled=True, scheme=scheme),
        train=TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                          optimizer="sgd", learning_rate=0.05),
        eval=EvalConfig(batch_size=256, datasets=["test"],
                        metrics=["loss", "accuracy"]),
        termination=TerminationConfig(federation_rounds=rounds))
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    session = DriverSession(config, template, recipes, workdir=workdir,
                            device=DEVICE)
    client = None
    t0 = time.perf_counter()
    started = time.time()
    left = None
    try:
        session.initialize_federation(
            health_retries=int(MP_TIMEOUT_S / 0.5), health_sleep_s=0.5)
        client = ControllerClient("localhost", config.controller_port)
        deadline = time.time() + MP_TIMEOUT_S
        while len(client.list_learners()) < FED_LEARNERS:
            session._check_procs_alive()
            if time.time() > deadline:
                raise RuntimeError(f"{label}: learners never all joined")
            time.sleep(0.1)
        note_boot(label, workdir, started)
        ports = {}
        for i in range(FED_LEARNERS):
            with open(os.path.join(workdir, f"learner_{i}.log")) as f:
                ports[int(re.search(r"LEARNER_READY port=(\d+)",
                                    f.read()).group(1))] = i
        index = {ep["learner_id"]: ports[ep["port"]]
                 for ep in client.list_learners()}
        boot_s = time.perf_counter() - t0
        open(gate, "w").close()
        t1 = time.perf_counter()
        if masking:
            while client.get_runtime_metadata(tail=1)[
                    "global_iteration"] < 1:
                session._check_procs_alive()
                if time.time() > deadline:
                    raise RuntimeError(f"{label}: round 0 never completed")
                time.sleep(0.1)
            # learner 0 leaves while its round-1 task waits on ``hold``
            learner_id, token = load_credentials(
                os.path.join(workdir, "learner_0_creds"))
            left = client.leave(learner_id, token)
            open(hold, "w").close()
        stats = session.monitor_federation(poll_every_s=0.25)
        run_s = time.perf_counter() - t1
        final = client.get_community_model()
    finally:
        open(hold, "w").close()
        if client is not None:
            client.close()
        t2 = time.perf_counter()
        session.shutdown_federation(timeout_s=MP_TIMEOUT_S)
        shutdown_s = time.perf_counter() - t2
    codes = session.process_exit_codes()
    smoke.check(len(codes) == FED_LEARNERS + 1
                and all(c == 0 for c in codes.values()),
                f"{label}: every process exits 0 after shutdown_federation "
                f"{codes}")
    with open(os.path.join(workdir, "controller.log")) as f:
        recovered = f.read().count("masking dropout recovery")
    metas = stats["round_metadata"][:rounds]
    cohorts = [sorted(index[lid] for lid in m["selected_learners"])
               for m in metas]
    last = cohorts[-1]
    ups = [_npz(os.path.join(workdir, f"record_{i}", f"up_{rounds - 1}.npz"))
           for i in last]
    entries = ModelBlob.from_bytes(final).opaque
    if masking:
        want = [np.mean([u[n].astype(np.float64).ravel() for u in ups],
                        axis=0) for n in entries]
        got = [np.frombuffer(p, np.float64) for p, _ in entries.values()]
        tol = MASK_ATOL
        smoke.check(left and cohorts == [[0, 1, 2], [1, 2]]
                    and recovered >= 1,
                    f"{label}: learner 0 left mid-round 1 ({left}); cohorts "
                    f"{cohorts}; a survivor disclosed its masks "
                    f"({recovered} recoveries in the controller's log)")
    else:
        w = [sizes[i] for i in last]
        want = [sum(wi * u[n].astype(np.float64).ravel()
                    for wi, u in zip(w, ups)) / sum(w) for n in entries]
        learner = CKKSBackend(key_dir=config.secure.key_dir, role="learner")
        got = [learner.decrypt(p, spec.size) for p, spec in entries.values()]
        tol = CKKS_ATOL
        smoke.check(cohorts == [[0, 1, 2]] and os.path.exists(
                        os.path.join(config.secure.key_dir, "sk.bin")),
                    f"{label}: the driver made the keys in "
                    f"{config.secure.key_dir}; cohort {cohorts}")
    worst = max(float(np.abs(g - wv).max()) for g, wv in zip(got, want))
    smoke.check(len(got) == len(want) and worst <= tol,
                f"{label}: the community of round {rounds - 1} is within "
                f"{worst:.3g} of the plain float64 "
                f"{'mean' if masking else 'weighted mean'} of its "
                f"{len(ups)} recorded uplinks (<= {tol})")
    out = {"rounds": rounds, "cohorts": cohorts, "recoveries": recovered,
           "max_abs": worst, "boot_s": boot_s, "rounds_s": run_s,
           "shutdown_s": shutdown_s, "community_bytes": len(final),
           "round_wall_s": [m["completed_at"] - m["started_at"]
                            for m in metas],
           "uplink_bytes": [m["uplink_bytes"] for m in metas]}
    print(f"{label}: round walls {[round(w, 3) for w in out['round_wall_s']]}"
          f" s", flush=True)
    # its own directory only: the other scheme's federation may still run
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# uplinks phase: the distributed slice tier and the uplink variants on
# in-process LlamaLite rounds (3 learners, equal FED_ROWS-row shards)
UPLINKS_DIR = os.path.join(REPO, "build", "chip_smoke_uplinks")
UPLINKS_BRANCH = 2
# client-level DP: the clip bound, and the noise multiplier of the noised
# round. A shipped update is the clipped delta (norm <= clip) plus the
# noise, so its norm brackets the noise's within +-clip: at sigma =
# DP_NOISE x DP_CLIP and n ~ 1.9e8 coordinates that bracket is 0.07% of
# sigma x sqrt(n), and the chi distribution's own spread ~5e-5
DP_CLIP, DP_NOISE = 1.0, 0.1
DP_NORM_REL = 0.01
LORA_RANK = 8


def float_norm(tree, base=None):
    """sqrt(sum of squares) over the floating leaves of a flat tree (minus
    ``base``), in float64."""
    total = 0.0
    for k, v in tree.items():
        v = np.asarray(v)
        if not np.issubdtype(v.dtype, np.floating):
            continue
        v = v.astype(np.float64)
        if base is not None:
            v = v - np.asarray(base[k]).astype(np.float64)
        total += float(np.dot(v.ravel(), v.ravel()))
    return float(np.sqrt(total))


def wrap(obj, name, after=None, before=None):
    """Replace ``obj.name`` by a call that runs ``before(*args)`` first and
    ``after(result, seconds, *args)`` once it returns; returns the
    original."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if after is not None:
            after(out, time.perf_counter() - t0, *args, **kwargs)
        return out

    setattr(obj, name, wrapped)
    return fn


def uplinks_phase(smoke, gpu, tree_wall_s=None):
    """The distributed slice tier and the uplink variants, on in-process
    LlamaLite rounds at full width (3 learners, equal shards): (a) two
    slice aggregator processes, booted by ``DriverSession.start_slices``,
    under ``tree: {branch 2, distributed}``, 2 rounds (round 0's tasks go
    out as the learners join, before any assignment, and fold at the
    root's residual buffer; round 1's cohort goes through the slices), one
    full-depth 755 MB uplink submitted to a slice as the controller
    submits, then the recorded round-1 uplinks replayed through a fresh
    reducer, undisturbed and with slice 1 SIGKILLed after its first ack;
    (b) SCAFFOLD, 2 rounds of SGD steps; (c) an int8q uplink under a bf16
    downlink, then a topk16 uplink; (d) client-level DP without noise,
    then with it; (e) a LoRA round under ``ship_tensor_regex``. Every
    round runs at depth ``CUT_DEPTH``; one full-depth uplink is submitted
    to a slice alone.
    ``tree_wall_s`` is the tiers phase's in-process tree round (depth
    ``CUT_DEPTH``), the distributed round's comparison. Every check holds
    the port to a numpy replay of what it recorded."""
    import gc
    import resource

    import torch

    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.aggregation.base import np_finalize
    from metisfl_tpu_torch.aggregation.distributed import (
        DistributedSliceReducer,
    )
    from metisfl_tpu_torch.aggregation.slice import read_spool
    from metisfl_tpu_torch.aggregation.tree import (
        _DEFAULT_SUBBLOCK,
        TreeReducer,
    )
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.comm.codec import dumps
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.config.federation import TreeAggregationConfig
    from metisfl_tpu_torch.controller import core as controller_core
    from metisfl_tpu_torch.driver import DriverSession, InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from metisfl_tpu_torch.scaling import make_scaler
    from metisfl_tpu_torch.store.durable import atomic_write
    from metisfl_tpu_torch.tensor import pack_model
    from metisfl_tpu_torch.tensor.quantize import dequantize_named
    from metisfl_tpu_torch.tensor.sparse import densify_named

    out = {"learners": FED_LEARNERS}
    llama = dict(vocab_size=VOCAB, dim=DIM, heads=HEADS, kv_heads=KV_HEADS,
                 dtype=torch.bfloat16)
    # full depth for the timed 755 MB hop to a slice; every round at
    # CUT_DEPTH, for the script's time
    seeds, blobs = {}, {}
    for depth in (DEPTH, CUT_DEPTH):
        seeds[depth], blobs[depth] = llama_seed(depth)
    flats = {depth: parse_blob(blob) for depth, blob in blobs.items()}
    sizes = {depth: len(blob) for depth, blob in blobs.items()}
    blob_bytes = sizes[DEPTH]
    out["blob_bytes"] = sizes
    # the seconds of each part, (a) to (e)
    part_s, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now
        print(f"uplinks {name}: {part_s[name]:.3f} s", flush=True)

    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    scaler = make_scaler("train_dataset_size")
    shutil.rmtree(UPLINKS_DIR, ignore_errors=True)
    os.makedirs(UPLINKS_DIR)

    def llama_round(train, aggregation=None, rounds=1, lora=0, seed=None,
                    depth=DEPTH):
        """A LlamaLite federation of ``rounds`` rounds in process; ``train``
        overrides the round's TrainParams (2 Adam steps at 1e-4)."""
        seed = seed or seeds[depth]
        depths_run.extend([depth] * rounds)
        cfg = FederationConfig(
            aggregation=aggregation or AggregationConfig(
                scaler="train_dataset_size"),
            train=TrainParams(**{
                "batch_size": TRAIN_BATCH, "local_steps": FED_STEPS,
                "optimizer": "adam", "learning_rate": 1e-4, **train}),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=rounds))
        fed = InProcessFederation(cfg, device=DEVICE)
        for i in range(FED_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            ops = TorchModelOps(
                LlamaLite(**llama, depth=depth, lora_rank=lora,
                          use_flash=True, device=DEVICE),
                variables=seed, device=DEVICE,
                trainable_regex="lora_" if lora else "")
            fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                              seed=SEED + i),
                            test_dataset=test)
        if seed is seeds[depth]:
            seed_federation(fed, llama_seed(depth)[1])
        else:
            fed.seed_model(seed)
        return fed

    def scales_of(selected):
        return scaler({lid: {"num_train_examples": FED_ROWS}
                       for lid in selected})

    def task_bytes(fed):
        """Each learner's downlink bytes per task: (model, control)."""
        seen = {}
        for learner in fed.learners:
            wrap(learner, "run_task", before=lambda task, ln=learner:
                 seen.setdefault(ln.port, []).append(
                     (len(task.model), len(task.control))))
        return seen

    def summary(label, probe, stats, r=0):
        split = probe.split(stats)[r]
        meta = stats["round_metadata"][r]
        losses = [v["loss"] for v in meta["train_metrics"].values()]
        smoke.check(len(losses) == FED_LEARNERS
                    and all(np.isfinite(losses)),
                    f"{label}: round {r} completed, train losses "
                    f"{[round(v, 4) for v in losses]} finite")
        print(f"{label}: round {r} wall {split['wall_s']:.3f} s, fold "
              f"stage {split['controller_s']['fold']:.3f} s, uplinks "
              f"{sorted(meta['uplink_bytes'].values())} bytes", flush=True)
        return split

    def release():
        gc.collect()
        empty_cache()

    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    depths_run = []   # the depth of every round the phase runs

    # (a) the distributed slice tier: the fleet booted as DriverSession
    # boots it, the controller in this process
    fleet = DriverSession(FederationConfig(aggregation=AggregationConfig(
        scaler="train_dataset_size", tree=TreeAggregationConfig(
            enabled=True, branch=UPLINKS_BRANCH, distributed=True))),
        {}, [], workdir=UPLINKS_DIR, device=DEVICE)
    try:
        specs = fleet.start_slices()
        fed = llama_round({}, fleet.config.aggregation, rounds=2,
                          depth=CUT_DEPTH)
        ctrl = fed.controller
        touched, submits, reduces = [], [], []
        for name in ("insert", "select"):
            wrap(ctrl._store, name, before=lambda *a, _n=name, **k:
                 touched.append(_n))
        wrap(ctrl._slices, "submit", after=lambda res, dt, *a, **k:
             submits.append((dt, res)))
        wrap(ctrl._slices, "reduce", after=lambda res, dt, *a, **k:
             reduces.append(dt))
        probe, stats = run_federation(fed)
        selected = stats["round_metadata"][1]["selected_learners"]
        ids = sorted(selected)
        scales = scales_of(ids)
        smoke.check(not touched and not ctrl._store.learner_ids(),
                    f"uplinks distributed: the root store saw no insert and "
                    f"no select ({touched[:3]}), holds "
                    f"{len(ctrl._store.learner_ids())} models")
        # round 0 folded at the root (its tasks had no slice yet), round
        # 1 through the slices: each a TreeReducer fold of the recorded
        # uplinks in sorted-id order
        ups = [{lid: parse_blob(probe.uplinks[r][lid]) for lid in
                stats["round_metadata"][r]["selected_learners"]}
               for r in range(2)]
        root = TreeReducer._fold_slice(
            sorted(ups[0]), scales_of(ups[0]),
            lambda block: {lid: [ups[0][lid]] for lid in block},
            _DEFAULT_SUBBLOCK)
        replay = TreeReducer(branch=UPLINKS_BRANCH)
        try:
            want, parts = replay.reduce(
                ids, scales, lambda block: {lid: [ups[1][lid]]
                                            for lid in block})
        finally:
            replay.shutdown()
        round1 = parse_blob(probe.communities[1])
        smoke.check(
            same_bits(parse_blob(probe.communities[0]),
                      np_finalize(root.acc, root.z, dtypes=root.dtypes))
            and same_bits(round1, want),
            f"uplinks distributed: round 0 equals the root's fold of its "
            f"{len(ups[0])} uplinks, round 1 TreeReducer (branch "
            f"{UPLINKS_BRANCH}) over its {len(ids)} recorded uplinks in "
            f"sorted-id order (slices {[p.count for p in parts]}), bit for "
            "bit")
        per = -(-len(ids) // UPLINKS_BRANCH)
        spooled_ok = True
        for i, spec in enumerate(specs):
            spool = read_spool(spec["spool_dir"])
            group = ids[i * per:(i + 1) * per]
            spooled_ok &= sorted(spool) == group and all(
                spool[lid] == probe.uplinks[1][lid] for lid in group)
        groups = [ids[i * per:(i + 1) * per] for i in range(UPLINKS_BRANCH)]
        smoke.check(spooled_ok,
                    f"uplinks distributed: each slice's spool holds its "
                    f"learners' round-1 uplinks byte for byte ({groups})")
        # the hop at full depth: the 755 MB seed submitted to a slice as
        # the controller submits an uplink (encode, chunked gRPC, the
        # slice's parse and spool write before the ack), then forgotten
        hop = DistributedSliceReducer(TreeAggregationConfig(
            enabled=True, branch=UPLINKS_BRANCH, distributed=True,
            slices=specs))
        try:
            hop.assign(["hop"])
            t0 = time.perf_counter()
            hop_held = hop.submit("hop", flats[DEPTH], 2)
            hop_s = time.perf_counter() - t0
            hop.forget("hop")
        finally:
            hop.shutdown()
        smoke.check(hop_held, f"uplinks distributed: a slice acked the "
                    f"{blob_bytes}-byte uplink")
        # one full-depth spool record written as a slice writes it (warm)
        record = dumps({"learner_id": ids[0], "round": 1,
                        "model": blobs.pop(DEPTH)})
        t0 = time.perf_counter()
        atomic_write(os.path.join(UPLINKS_DIR, "spool_probe.bin"), record,
                     prefix=".up_")
        spool_s = time.perf_counter() - t0
        os.unlink(os.path.join(UPLINKS_DIR, "spool_probe.bin"))
        del record
        # what the replays below need is parsed: free the round's blobs
        probe.uplinks.clear()
        ups[0] = None
        split = summary("uplinks distributed", probe, stats, 1)
        meta = stats["round_metadata"][1]
        slice_submits = [dt for dt, held in submits[-len(ids):]]
        out["distributed"] = {
            "round0": probe.split(stats)[0], "round1": split,
            "submit_s": [dt for dt, _ in submits],
            "submit_to_slice": [held for _, held in submits],
            "hop_submit_s": hop_s, "spool_write_s": spool_s,
            "slice_fold_ms": meta["aggregation_block_duration_ms"],
            "reduce_s": reduces, "tree_round_s": tree_wall_s}
        print(f"uplinks distributed: controller -> slice submit {hop_s:.3f} "
              f"s a {blob_bytes}-byte uplink, spool write {spool_s:.3f} s "
              f"(warm); at depth {CUT_DEPTH}: submit "
              f"{[round(dt, 3) for dt in slice_submits]} s a "
              f"{sizes[CUT_DEPTH]}-byte uplink, slice folds "
              f"{meta['aggregation_block_duration_ms']} ms, root fan-in "
              f"(reduce) {[round(r, 3) for r in reduces]} s, round 1 wall "
              f"{split['wall_s']:.3f} s against the tiers phase's tree round "
              f"{tree_wall_s} s", flush=True)

        def replay_round(kill):
            red = DistributedSliceReducer(TreeAggregationConfig(
                enabled=True, branch=UPLINKS_BRANCH, distributed=True,
                slices=specs))
            try:
                red.assign(ids)

                def submit(i):
                    lid = ids[i]
                    red.submit(lid, ups[1][lid], 1)
                    if kill and red._base_owner(lid) == 1:
                        # SIGKILL after its first ack
                        doomed = next(p.process for p in fleet._procs
                                      if p.name == "slice_1")
                        doomed.kill()
                        doomed.wait(timeout=30)

                # the uplinks land together, as a round's do
                run_concurrently(submit, len(ids))
                t0 = time.perf_counter()
                community, _, errors = red.reduce(ids, scales, round_id=1)
                return (community, red.describe(), errors,
                        time.perf_counter() - t0)
            finally:
                red.shutdown()

        calm, calm_desc, _, calm_s = replay_round(False)
        killed, kill_desc, kill_errors, kill_s = replay_round(True)
        smoke.check(
            same_bits(calm, killed) and same_bits(calm, round1)
            and kill_desc["rehomed_total"] >= 1
            and calm_desc["rehomed_total"] == 0,
            f"uplinks distributed: the replay with slice 1 SIGKILLed after "
            f"its first ack re-homed ({kill_desc['rehomed_total']} re-home, "
            f"{kill_errors}) and equals the undisturbed replay "
            f"({calm_desc['rehomed_total']} re-homes) and the round, bit "
            "for bit")
        out["distributed"].update({"replay_reduce_s": calm_s,
                                   "kill_reduce_s": kill_s})
        print(f"uplinks distributed: replay reduce {calm_s:.3f} s, with "
              f"the kill and re-home {kill_s:.3f} s", flush=True)
    finally:
        fleet.stop_slices()
    del fed, ctrl, probe, ups, want, round1, calm, killed, blobs
    release()

    part_done("(a) distributed")

    # (b) SCAFFOLD over SGD steps: round 1 is the first with a nonzero c
    fed = llama_round({"optimizer": "sgd", "learning_rate": 1e-3},
                      AggregationConfig(rule="scaffold",
                                        scaler="train_dataset_size"),
                      rounds=2, depth=CUT_DEPTH)
    ctrl = fed.controller
    deltas, cs, cohorts, offsets = {}, [], [], {}
    wrap(ctrl, "task_completed", before=lambda result: deltas.setdefault(
        result.round_id, {}).__setitem__(result.learner_id,
                                         result.control_delta))

    def after_fold(_, dt, cohort):
        with ctrl._lock:
            cs.append({k: v.copy() for k, v in ctrl._scaffold_c.items()})
        cohorts.append(list(cohort))

    wrap(ctrl, "_fold_scaffold_controls", after=after_fold)
    for learner in fed.learners:
        wrap(learner.model_ops, "train", before=lambda *a, ln=learner,
             grad_offset=None, **k: offsets.setdefault(ln.port, []).append(
                 max(float(np.abs(x).max()) for x in
                     _leaves(grad_offset))))
    downs = task_bytes(fed)
    probe, stats = run_federation(fed)
    n_active = FED_LEARNERS
    c = None
    replay_ok = len(cs) == 2
    for r in range(min(2, len(cs))):
        total = {}
        for lid in cohorts[r]:
            if lid not in deltas.get(r, {}):
                continue
            for name, arr in parse_blob(deltas[r][lid]).items():
                total[name] = total.get(name, 0.0) + np.asarray(
                    arr, np.float32)
        if c is None:
            c = {n: np.zeros_like(a) for n, a in total.items()}
        c = {n: c[n] + total[n] / n_active for n in c}
        replay_ok &= same_bits(cs[r], c)
    smoke.check(replay_ok,
                f"uplinks scaffold: c after each of {len(cs)} rounds equals "
                "a numpy replay of the fold over the recorded control "
                "deltas, bit for bit")
    first = [offs[0] for offs in offsets.values()]
    second = [offs[1] for offs in offsets.values() if len(offs) > 1]
    smoke.check(len(second) == FED_LEARNERS and max(first) == 0.0
                and min(second) > 0.0,
                f"uplinks scaffold: grad_offset c - c_i reached each "
                f"engine: max|offset| round 0 {first}, round 1 {second}")
    check_folds(smoke, "uplinks scaffold", probe, stats, 2)
    ups_bytes = {r: {lid: len(probe.uplinks[r][lid]) + len(deltas[r][lid])
                     for lid in deltas.get(r, {})} for r in range(2)}
    out["scaffold"] = {
        "rounds": [summary("uplinks scaffold", probe, stats, r)
                   for r in range(2)],
        "downlink_bytes": {str(p): v for p, v in downs.items()},
        "uplink_bytes_with_control": ups_bytes,
        "max_offset": {"round0": first, "round1": second}}
    print(f"uplinks scaffold: downlink (model, control) bytes "
          f"{list(downs.values())}, uplink + control delta "
          f"{[sorted(v.values()) for v in ups_bytes.values()]}", flush=True)
    del fed, ctrl, probe, deltas, cs, c
    release()

    part_done("(b) scaffold")

    # (c) the uplink ladder: int8q under a bf16 downlink, then topk16
    for label, train, depth in (("int8q", {"ship_dtype": "int8q",
                                           "downlink_dtype": "bf16"},
                                 CUT_DEPTH),
                                ("topk16", {"ship_dtype": "topk16"},
                                 CUT_DEPTH)):
        fed = llama_round(train, depth=depth)
        ctrl = fed.controller
        parsed, host_s = {}, {"decode": []}
        wrap(ctrl, "_parse_result_model", after=lambda res, dt, result,
             blob: parsed.__setitem__(result.learner_id, res))
        decode_name = ("dequantize_named" if label == "int8q"
                       else "densify_named")
        saved = getattr(controller_core, decode_name)
        wrap(controller_core, decode_name,
             after=lambda res, dt, *a: host_s["decode"].append(dt))
        encode_s = []
        for learner in fed.learners:
            wrap(learner, "_dump_sparse" if label == "topk16"
                 else "_dump_model",
                 after=lambda res, dt, *a, **k: encode_s.append(dt))
        downs = task_bytes(fed)
        try:
            probe, stats = run_federation(fed)
        finally:
            setattr(controller_core, decode_name, saved)
        selected = stats["round_metadata"][0]["selected_learners"]

        def replay_decode(i):
            wire = parse_blob(probe.uplinks[0][selected[i]])
            return same_bits(parsed[selected[i]], dequantize_named(wire)
                             if label == "int8q" else
                             densify_named(wire, flats[depth]))

        decoded_ok = all(run_concurrently(replay_decode, len(selected))[0])
        scales = scales_of(selected)
        refold = FedAvg().aggregate([([parsed[lid]], scales[lid])
                                     for lid in selected])
        smoke.check(decoded_ok and same_bits(
            parse_blob(probe.communities[0]), refold),
            f"uplinks {label}: the controller's "
            f"{'dequantized' if label == 'int8q' else 'densified'} tensors "
            f"equal a numpy replay over the {len(selected)} recorded wire "
            "blobs, and the community is their FedAvg re-fold, bit for bit")
        meta = stats["round_metadata"][0]
        out[label] = {
            "depth": depth,
            "round": summary(f"uplinks {label}", probe, stats),
            "uplink_bytes": meta["uplink_bytes"],
            "downlink_bytes": [v[0][0] for v in downs.values()],
            "learner_encode_s": encode_s,
            "controller_decode_s": host_s["decode"]}
        print(f"uplinks {label}: uplink "
              f"{sorted(meta['uplink_bytes'].values())} and downlink "
              f"{out[label]['downlink_bytes']} bytes against the "
              f"{sizes[depth]}-byte blob (depth {depth}); learner "
              f"{'quantize' if label == 'int8q' else 'sparsify'} "
              f"{[round(v, 3) for v in encode_s]} s, controller "
              f"{'dequantize' if label == 'int8q' else 'densify'} "
              f"{[round(v, 3) for v in host_s['decode']]} s", flush=True)
        del fed, ctrl, probe, parsed, refold
        release()

    part_done("(c) int8q and topk16")

    # (d) client-level DP, without noise, then with it. A shipped update
    # is the clipped delta (norm <= clip) plus the noise, so the noise's
    # norm lies within clip of the shipped update's
    cut_flat = flats[CUT_DEPTH]
    coords = sum(int(a.size) for a in cut_flat.values()
                 if np.issubdtype(a.dtype, np.floating))
    for noise in (0.0, DP_NOISE):
        fed = llama_round({"dp_clip_norm": DP_CLIP,
                           "dp_noise_multiplier": noise}, depth=CUT_DEPTH)
        probe, stats = run_federation(fed)
        label = f"uplinks dp noise {noise}"
        norms = [float_norm(parse_blob(blob), cut_flat)
                 for blob in probe.uplinks[0].values()]
        if noise == 0.0:
            smoke.check(len(norms) == FED_LEARNERS
                        and all(n <= DP_CLIP * (1 + 1e-6) for n in norms),
                        f"{label}: each shipped update's norm "
                        f"{[round(n, 6) for n in norms]} <= clip "
                        f"{DP_CLIP} x (1 + 1e-6)")
        else:
            expect = noise * DP_CLIP * np.sqrt(coords)
            rel = [max(abs((n - DP_CLIP) / expect - 1.0),
                       abs((n + DP_CLIP) / expect - 1.0)) for n in norms]
            smoke.check(len(rel) == FED_LEARNERS
                        and max(rel) <= DP_NORM_REL,
                        f"{label}: each learner's noise norm is within "
                        f"{[f'{v:.2e}' for v in rel]} of sigma x sqrt(n) = "
                        f"{expect:.4f} (<= {DP_NORM_REL}; n = {coords})")
        out[f"dp_{noise}"] = {"round": summary(label, probe, stats),
                              "update_norms": norms}
        del fed, probe
        release()

    part_done("(d) dp")

    # (e) ship-only LoRA: only the adapters federate
    def named(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: np.asarray(tree)}
        out_named = {}
        for key, sub in tree.items():
            out_named.update(named(sub, f"{prefix}/{key}" if prefix
                                   else key))
        return out_named

    lora_vars = random_variables(
        LlamaLite(**llama, depth=CUT_DEPTH, lora_rank=LORA_RANK,
                  device="meta"), SEED + 1)
    fed = llama_round({"ship_tensor_regex": "lora_"}, lora=LORA_RANK,
                      seed=lora_vars, depth=CUT_DEPTH)
    ctrl = fed.controller
    lora_names = sorted(n for n in named(lora_vars) if "lora_" in n)
    base = {n: a for n, a in named(lora_vars).items() if "lora_" not in n}
    seeded_subset = sorted(parse_blob(ctrl.community_model_bytes()))
    probe, stats = run_federation(fed)
    up_names = [sorted(parse_blob(b)) for b in probe.uplinks[0].values()]
    smoke.check(seeded_subset == lora_names
                and all(names == lora_names for names in up_names)
                and sorted(parse_blob(probe.communities[0])) == lora_names,
                f"uplinks ship-only: the seed, the {len(up_names)} uplinks "
                f"and the community hold only the {len(lora_names)} LoRA "
                "tensors")
    frozen_ok = all(
        same_bits({n: a for n, a in named(
            learner.model_ops.get_variables()).items()
            if "lora_" not in n}, base)
        for learner in fed.learners)
    smoke.check(frozen_ok, "uplinks ship-only: each learner's frozen base "
                f"({len(base)} tensors) is bit-identical to the seed's")
    meta = stats["round_metadata"][0]
    out["ship_only"] = {"round": summary("uplinks ship-only", probe, stats),
                        "uplink_bytes": meta["uplink_bytes"]}
    print(f"uplinks ship-only: uplink "
          f"{sorted(meta['uplink_bytes'].values())} bytes (depth "
          f"{CUT_DEPTH}; the full-depth blob is {blob_bytes} bytes)",
          flush=True)
    del fed, ctrl, probe, lora_vars, base
    release()

    part_done("(e) ship-only")
    out["part_s"] = part_s
    k1, k2, k3 = (fn.launches for fn in counters)
    train_k = FED_LEARNERS * FED_STEPS * sum(depths_run)
    eval_k = FED_LEARNERS * -(-FED_EVAL_ROWS // TRAIN_BATCH) * sum(depths_run)
    smoke.check(k2 == k3 == train_k and k1 == train_k + eval_k,
                f"uplinks llama: K2 {k2} and K3 {k3} launches = learners x "
                f"steps x the depths of the {len(depths_run)} rounds "
                f"{depths_run} = {train_k}; K1 {k1} = {train_k} + {eval_k} "
                "(evaluation)")
    out["launches"] = {"flash_fwd": k1, "flash_bwd_dq": k2,
                       "flash_bwd_dkv": k3}
    out["peak_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"uplinks: peak RSS {out['peak_rss_kb']} kB", flush=True)
    shutil.rmtree(UPLINKS_DIR, ignore_errors=True)
    out["gpu"] = gpu
    print(json.dumps({"uplinks": out}, default=str), flush=True)
    return out


# -- the rounds phase: round control (protocols, quorum, deadlines, retries,
# churn, chaos) on the card

ROUNDS_DIR = os.path.join(REPO, "build", "chip_smoke_rounds")
# (a) the buffered protocol's buffer and damping, and its fills
BUFFER_SIZE, STALENESS_DECAY, BUFFER_FILLS = 2, 0.5, 3
# (b) the quorum and the over-provisioned dispatch: ceil(2 x 1.5) = all 3
QUORUM, OVERPROVISION = 2, 0.5
# (d) the deadline of the masked round, past the survivors' CNN round
MASK_DEADLINE_S = 3.0
# (e) learner processes, two dispatched a round after the joins' round 0
CHAOS_LEARNERS, CHAOS_ROUNDS, CHAOS_STEPS = 4, 3, 5
# (f) the cross-device harness and the slice-kill gate
XD_CLIENTS, XD_ROUNDS, XD_QUORUM = 512, 5, 12
XD_TOLERANCE = 0.2


def wait_for(predicate, timeout_s, what):
    deadline = time.time() + timeout_s
    while not predicate():
        if time.time() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.02)


def rounds_recipe(x, y, test_x, test_y, seed, device, gate):
    """A CNN learner for the chaos part: training waits for ``gate`` (so
    round 0's cohort is every learner) and then 0.3 s more, so a failed
    dispatch's retry (0.05 s backoff) lands before its round's uplinks."""

    def recipe():
        import os
        import time

        from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
        from metisfl_tpu_torch.models.zoo import FashionMnistCNN

        ops = TorchModelOps(FashionMnistCNN(), rng_seed=seed, device=device)
        train = ops.train

        def gated(*args, **kwargs):
            deadline = time.time() + MP_TIMEOUT_S
            while not os.path.exists(gate) and time.time() < deadline:
                time.sleep(0.05)
            time.sleep(0.3)
            return train(*args, **kwargs)

        ops.train = gated
        return (ops, ArrayDataset(x, y, seed=seed), None,
                ArrayDataset(test_x, test_y))

    return recipe


def rounds_phase(smoke, gpu):
    """Round control on the card. In-process LlamaLite rounds at full width
    and depth ``CUT_DEPTH`` (3 learners of ``FED_ROWS`` rows, 2 Adam steps
    of batch 8 x 1024 through K1-K3): (a) ``asynchronous_buffered``,
    buffer 2, staleness decay 0.5, learner 2 held until two fills closed,
    3 fills, each community a numpy replay of the damped fold bit for bit;
    (b) ``synchronous`` at quorum 2 with over-provisioning 0.5 on the
    streaming tier, learner 2 held past the quorum, its late uplink
    dropped unfolded; (c) ``semi_synchronous`` (lambda 1.0), 2 rounds,
    round 1's step budgets ``recompute_steps`` on round 0's ms per step.
    Then (d) the CNN in process under masking with streaming and a round
    deadline, learner 2 held past it: the two survivors settle through
    ``RecoverMasks``; (e) ``DriverSession`` with a process per CNN
    learner and chaos by ``process``: the controller's fifth RunTask
    dropped (dispatch retries 1, max_dispatch_failures 1, quarantine
    score 0.25) and learner 2 slowed 3x; (f) the cross-device harness
    (512 virtual clients, 5 rounds, 30% dropout, a flapper and a
    partition at quorum 12) against its no-churn control, and
    ``run_slice_smoke`` with a slice aggregator killed mid-round."""
    import gc

    import torch

    from metisfl_tpu_torch.aggregation import FedAvg
    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        ChaosConfig,
        EvalConfig,
        FederationConfig,
        LearnerEndpoint,
        SchedulingConfig,
        SecureAggConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.driver import DriverSession, InProcessFederation
    from metisfl_tpu_torch.driver.crossdevice import (
        ChurnScenario,
        run_scenario,
        run_slice_smoke,
    )
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
    from metisfl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from metisfl_tpu_torch.scheduling import SemiSynchronousScheduler
    from metisfl_tpu_torch.secure import MaskingBackend

    out = {"learners": FED_LEARNERS, "depth": CUT_DEPTH}
    part_s, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now
        print(f"rounds {name}: {part_s[name]:.3f} s", flush=True)

    llama = dict(vocab_size=VOCAB, dim=DIM, depth=CUT_DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables, seed_blob = llama_seed(CUT_DEPTH)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    eval_batches = -(-FED_EVAL_ROWS // TRAIN_BATCH)
    counters = (flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    # every train call's completed steps and every evaluation, over the
    # LlamaLite rounds: their K1-K3 launches follow
    steps_run, evals_run = [], []

    def llama_federation(protocol, rounds, aggregation=None, **top):
        cfg = FederationConfig(
            protocol=protocol,
            aggregation=aggregation or AggregationConfig(
                scaler="train_dataset_size"),
            train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                              optimizer="adam", learning_rate=1e-4),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=rounds), **top)
        fed = InProcessFederation(cfg, device=DEVICE)
        for i in range(FED_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                          device=DEVICE),
                                variables=variables, device=DEVICE)
            wrap(ops, "train", after=lambda res, dt, *a, **k:
                 steps_run.append(res.completed_steps))
            wrap(ops, "evaluate", after=lambda res, dt, *a, **k:
                 evals_run.append(1))
            fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                              seed=SEED + i),
                            test_dataset=test)
        seed_federation(fed, seed_blob)
        return fed

    def idle(fed):
        """Every learner's training done (nothing left to launch)."""
        return all(ln._current_future is None or ln._current_future.done()
                   for ln in fed.learners)

    def hold(fed, i, until, timeout_s=300.0):
        """Learner ``i``'s training waits until ``until()``."""
        ops = fed.learners[i].model_ops
        train = ops.train

        def held(*args, **kwargs):
            wait_for(until, timeout_s, f"learner {i}'s release")
            return train(*args, **kwargs)

        ops.train = held

    def record_uplinks(ctrl):
        """(blob, task round) of each learner's latest uplink, as the
        scheduling worker handles it, and a snapshot per aggregation: the
        cohort, the round, and the uplinks the store path folds."""
        latest, folds = {}, []

        def before_handle(result):
            latest[result.learner_id] = (result.model, result.round_id)

        def before_compute(selected):
            folds.append((list(selected), ctrl.global_iteration,
                          {lid: latest[lid] for lid in selected}))

        wrap(ctrl, "_handle_completed", before=before_handle)
        wrap(ctrl, "_compute_community_model", before=before_compute)
        return folds

    # (a) FedBuff: buffer 2 over 3 learners, learner 2 held until two
    # fills closed, so its round-0 uplink lands two rounds stale; the
    # others' tasks after fill 2 wait for it, so fill 3 holds it
    fed = llama_federation(
        "asynchronous_buffered", BUFFER_FILLS,
        AggregationConfig(scaler="train_dataset_size",
                          staleness_decay=STALENESS_DECAY),
        scheduling=SchedulingConfig(buffer_size=BUFFER_SIZE))
    ctrl = fed.controller
    late = fed.learners[2]
    late_landed = threading.Event()
    wrap(ctrl, "_handle_completed", after=lambda res, dt, result:
         late_landed.set() if result.learner_id == late.learner_id else None)
    hold(fed, 2, lambda: ctrl.global_iteration >= 2)
    for i in (0, 1):
        ops = fed.learners[i].model_ops
        train = ops.train

        def after_two(*args, _train=train, **kwargs):
            if ctrl.global_iteration >= 2:
                wait_for(late_landed.is_set, 300.0, "learner 2's uplink")
            return _train(*args, **kwargs)

        ops.train = after_two
    folds = record_uplinks(ctrl)
    probe, stats = run_federation(
        fed, settle=lambda: wait_for(lambda: idle(fed), 300.0,
                                     "the learners' last tasks"))
    metas = stats["round_metadata"]
    replay_ok = len(folds) == len(probe.communities) == BUFFER_FILLS
    replayed = []
    for (selected, gi, ups), blob in zip(folds, probe.communities):
        # the scaler's weights (equal shards), damped by (1 + s)^-decay and
        # renormalized, then the FedAvg host fold
        n = {lid: float(FED_ROWS) for lid in selected}
        total = sum(n.values())
        scales = {lid: n[lid] / total for lid in selected}
        stale = {lid: float(max(0, gi - ups[lid][1])) for lid in selected}
        damped = {lid: w * ((1.0 + stale[lid]) ** -STALENESS_DECAY
                            if stale[lid] > 0 else 1.0)
                  for lid, w in scales.items()}
        z = sum(damped.values())
        damped = {lid: w / z for lid, w in damped.items()}
        want = FedAvg().aggregate([([parse_blob(ups[lid][0])], damped[lid])
                                   for lid in selected])
        replay_ok = replay_ok and same_bits(parse_blob(blob), want)
        replayed.append({"selected": selected, "staleness": stale,
                         "scales": damped})
    staleness = [m["staleness"] for m in metas[:BUFFER_FILLS]]
    late_stale = max((s.get(late.learner_id, 0.0) for s in staleness),
                     default=0.0)
    smoke.check(replay_ok and stats["global_iteration"] == BUFFER_FILLS,
                f"rounds buffered: {stats['global_iteration']} buffer fills "
                f"of {BUFFER_SIZE}, each community a numpy replay of the "
                "staleness-damped fold of its recorded uplinks, bit for bit "
                f"(cohorts {[r['selected'] for r in replayed]})")
    smoke.check(late_stale >= 1 and all(
        s == {k: v for k, v in r["staleness"].items() if v}
        for s, r in zip(staleness, replayed)),
        f"rounds buffered: the held learner's uplink landed {late_stale} "
        f"round(s) stale; the staleness recorded per fill {staleness} "
        "matches the replay")
    out["buffered"] = {"fills": stats["global_iteration"],
                       "staleness": staleness,
                       "scales": [m["scales"] for m in metas],
                       "cohorts": [m["selected_learners"] for m in metas],
                       "wall_s": stats["wall_s"]}
    del fed, ctrl, probe, folds
    gc.collect()
    empty_cache()
    part_done("(a) buffered")

    # (b) quorum 2 of an over-provisioned dispatch (all 3) on the
    # streaming tier; learner 2 trains only after the round closed
    fed = llama_federation(
        "synchronous", 1,
        AggregationConfig(scaler="train_dataset_size", streaming=True),
        scheduling=SchedulingConfig(quorum=QUORUM,
                                    overprovision=OVERPROVISION))
    ctrl = fed.controller
    late = fed.learners[2]
    late_done = threading.Event()
    wrap(ctrl, "_handle_completed", after=lambda res, dt, result:
         late_done.set() if result.learner_id == late.learner_id else None)
    hold(fed, 2, lambda: ctrl.global_iteration >= 1)
    folded = []
    wrap(ctrl._streaming, "fold",
         before=lambda lid, model, weight: folded.append(lid))
    probe, stats = run_federation(
        fed, settle=lambda: wait_for(late_done.is_set, 300.0,
                                     "the straggler's late uplink"))
    meta = stats["round_metadata"][0]
    cohort = meta["selected_learners"]
    dispatched = sorted(meta["train_submitted_at"])
    smoke.check(len(dispatched) == FED_LEARNERS and len(cohort) == QUORUM
                and late.learner_id not in cohort,
                f"rounds quorum: {len(dispatched)} dispatched "
                f"(ceil({QUORUM} x {1 + OVERPROVISION})), the cohort is the "
                f"first {QUORUM} reporters {cohort}")
    ups = [parse_blob(probe.uplinks[0][lid]) for lid in cohort]
    want = FedAvg().aggregate([([m], 1.0 / len(ups)) for m in ups])
    smoke.check(same_bits(parse_blob(probe.communities[0]), want),
                "rounds quorum: the streamed community is the re-fold of "
                "the 2 reporters' uplinks, bit for bit")
    smoke.check(late.learner_id in probe.uplinks[0]
                and late.learner_id not in folded
                and sorted(folded) == sorted(cohort),
                f"rounds quorum: the straggler's late uplink arrived and was "
                f"dropped as stale, never folded (folded {sorted(folded)})")
    out["quorum"] = {"dispatched": dispatched, "cohort": cohort,
                     "dropped": [late.learner_id],
                     "wall_s": meta["completed_at"] - meta["started_at"]}
    del fed, ctrl, probe, ups, want
    gc.collect()
    empty_cache()
    part_done("(b) quorum")

    # (c) semi-synchronous, lambda 1.0, 2 rounds
    fed = llama_federation("semi_synchronous", 2, semi_sync_lambda=1.0)
    ctrl = fed.controller
    steps_by = {}
    for learner in fed.learners:
        wrap(learner.model_ops, "train", after=lambda res, dt, *a,
             lid=learner, **k: steps_by.setdefault(lid.learner_id, []).append(
                 res.completed_steps))
    tasks = {}
    for learner in fed.learners:
        wrap(learner, "run_task", before=lambda task: tasks.setdefault(
            task.learner_id, []).append(task.params.local_steps))
    probe, stats = run_federation(fed)
    ms0 = probe.ms_per_step[0]
    timings = {lid: {"ms_per_step": ms,
                     "steps_per_epoch": max(1.0, FED_ROWS / TRAIN_BATCH)}
               for lid, ms in ms0.items()}
    budgets = SemiSynchronousScheduler(lambda_=1.0).recompute_steps(timings)
    ran = {lid: steps[1] for lid, steps in steps_by.items()}
    budgeted = {lid: steps[1] for lid, steps in tasks.items()}
    smoke.check(len(budgets) == FED_LEARNERS and budgeted == budgets,
                f"rounds semi-sync: round 1's step budgets {budgeted} are "
                f"recompute_steps on round 0's ms per step "
                f"{ {k: round(v, 3) for k, v in ms0.items()} }")
    smoke.check(ran == budgets,
                f"rounds semi-sync: each learner ran its budget {ran}")
    out["semi_sync"] = {"ms_per_step": ms0, "budgets": budgets, "ran": ran,
                        "round_wall_s": [m["completed_at"] - m["started_at"]
                                         for m in stats["round_metadata"]]}
    del fed, ctrl, probe
    gc.collect()
    empty_cache()
    sync()
    k1, k2, k3 = (fn.launches for fn in counters)
    train_k = sum(steps_run) * CUT_DEPTH
    eval_k = len(evals_run) * eval_batches * CUT_DEPTH
    smoke.check(k2 == k3 == train_k and k1 == train_k + eval_k,
                f"rounds llama: K2 {k2} and K3 {k3} launches = the "
                f"{sum(steps_run)} steps trained x depth = {train_k}; K1 "
                f"{k1} = {train_k} + {eval_k} ({len(evals_run)} "
                "evaluations)")
    out["launches"] = {"flash_fwd": k1, "flash_bwd_dq": k2,
                       "flash_bwd_dkv": k3}
    out["expected_launches"] = {"flash_fwd": train_k + eval_k,
                                "flash_bwd_dq": train_k,
                                "flash_bwd_dkv": train_k}
    part_done("(c) semi-sync")

    # (d) a round deadline under masking with streaming, the CNN in process:
    # learner 2 trains only after the deadline settled the round
    x, y = synthetic_image_classification(
        FED_LEARNERS * CNN_EXAMPLES + CNN_TEST, noise=CNN_NOISE, seed=SEED)
    cnn_test = ArrayDataset(x[-CNN_TEST:], y[-CNN_TEST:])
    backends = [MaskingBackend("chip-smoke-rounds", i, FED_LEARNERS)
                for i in range(FED_LEARNERS)]
    plain = {}

    def probe_plain(i, backend):
        encrypt = backend.encrypt

        def probed(values):
            plain.setdefault((i, getattr(backend, "_round_id", 0)),
                             []).append(
                np.asarray(values, np.float64).copy())
            return encrypt(values)

        backend.encrypt = probed

    for i, backend in enumerate(backends):
        probe_plain(i, backend)
    fed = InProcessFederation(FederationConfig(
        aggregation=AggregationConfig(rule="secure_agg",
                                      scaler="participants", streaming=True),
        secure=SecureAggConfig(enabled=True, scheme="masking",
                               num_parties=FED_LEARNERS),
        round_deadline_secs=MASK_DEADLINE_S,
        train=TrainParams(batch_size=CNN_BATCH, local_steps=CNN_STEPS,
                          optimizer="sgd", learning_rate=0.05),
        eval=EvalConfig(batch_size=256, datasets=["test"],
                        metrics=["loss", "accuracy"]),
        termination=TerminationConfig(federation_rounds=1)), device=DEVICE,
        secure_backend=MaskingBackend(num_parties=FED_LEARNERS))
    template = None
    for i in range(FED_LEARNERS):
        ops = TorchModelOps(FashionMnistCNN(), rng_seed=SEED, device=DEVICE,
                            variables=template)
        template = template or ops.get_variables()
        part = slice(i * CNN_EXAMPLES, (i + 1) * CNN_EXAMPLES)
        fed.add_learner(ops, ArrayDataset(x[part], y[part], seed=SEED + i),
                        test_dataset=cnn_test, secure_backend=backends[i])
    fed.seed_model(template)
    ctrl = fed.controller
    late = fed.learners[2]
    late_done = threading.Event()
    wrap(ctrl, "_handle_completed", after=lambda res, dt, result:
         late_done.set() if result.learner_id == late.learner_id else None)
    joined = lambda: len(ctrl.active_learners()) == FED_LEARNERS  # noqa
    for i in (0, 1):
        hold(fed, i, joined)
    hold(fed, 2, lambda: ctrl.global_iteration >= 1)
    recovered = []
    for learner in fed.learners:
        wrap(learner, "recover_masks", after=lambda res, dt, rid, surviving,
             dropped, lengths, ln=learner: recovered.append(
                 (ln.learner_id, list(surviving), list(dropped))))
    t0 = time.perf_counter()
    probe, stats = run_federation(
        fed, settle=lambda: wait_for(late_done.is_set, 120.0,
                                     "the held learner's late uplink"))
    meta = stats["round_metadata"][0]
    survivors = sorted(meta["selected_learners"])
    index = {ln.learner_id: i for i, ln in enumerate(fed.learners)}
    payloads = opaque_payloads(probe.communities[0])
    mean = [(plain[(index[survivors[0]], 0)][t]
             + plain[(index[survivors[1]], 0)][t]) / 2.0
            for t in range(len(payloads))] if len(survivors) == 2 else []
    worst = max((float(np.abs(p - m).max())
                 for p, m in zip(payloads, mean)), default=float("inf"))
    smoke.check(survivors == sorted(ln.learner_id for ln in fed.learners[:2])
                and len(recovered) == 1
                and list(recovered[0][1:]) == [[0, 1], [2]],
                f"rounds deadline: the {MASK_DEADLINE_S} s deadline released "
                f"the 2 survivors {survivors}; RecoverMasks answered "
                f"{recovered}")
    smoke.check(len(mean) == len(payloads) and worst <= MASK_ATOL,
                f"rounds deadline: the settled community is within "
                f"{worst:.3g} of the survivors' float64 mean (<= {MASK_ATOL})")
    out["deadline"] = {"survivors": survivors, "dropped": [late.learner_id],
                       "recovered": recovered, "max_abs_err": worst,
                       "wall_s": time.perf_counter() - t0}
    del fed, ctrl, probe, backends, plain
    gc.collect()
    empty_cache()
    part_done("(d) deadline")

    # (e) DriverSession: chaos armed by process, the retry ladder, churn
    workdir = os.path.join(ROUNDS_DIR, "chaos")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gate = os.path.join(workdir, "gate")
    shards = [(x[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES],
               y[i * CNN_EXAMPLES:(i + 1) * CNN_EXAMPLES])
              for i in range(CHAOS_LEARNERS)]
    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="participants",
                                      participation_ratio=0.5),
        scheduling=SchedulingConfig(dispatch_retries=1, retry_backoff_s=0.05,
                                    quarantine_score=0.25,
                                    quarantine_s=600.0),
        max_dispatch_failures=1,
        chaos=ChaosConfig(enabled=True, seed=SEED, rules=[
            {"fault": "drop", "side": "client", "method": "RunTask",
             "process": "controller", "after_calls": CHAOS_LEARNERS,
             "max_fires": 1},
            {"fault": "slow", "factor": 3.0, "process": "learner_2"}]),
        train=TrainParams(batch_size=CNN_BATCH, local_steps=CHAOS_STEPS,
                          optimizer="sgd", learning_rate=0.05),
        eval=EvalConfig(batch_size=256, datasets=["test"],
                        metrics=["loss", "accuracy"]),
        termination=TerminationConfig(federation_rounds=CHAOS_ROUNDS),
        learners=[LearnerEndpoint() for _ in shards])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=SEED,
                             device="cpu").get_variables()
    session = DriverSession(
        config, template,
        [rounds_recipe(sx, sy, x[-CNN_TEST:], y[-CNN_TEST:], SEED + i,
                       DEVICE, gate) for i, (sx, sy) in enumerate(shards)],
        workdir=workdir, device=DEVICE)
    client = described = None
    started = time.time()
    try:
        session.initialize_federation(
            health_retries=int(MP_TIMEOUT_S / 0.5), health_sleep_s=0.5)
        client = ControllerClient("localhost", config.controller_port)
        wait_for(lambda: len(client.list_learners()) == CHAOS_LEARNERS,
                 MP_TIMEOUT_S, "the chaos learners' joins")
        note_boot("rounds chaos", workdir, started)
        with open(gate, "w"):
            pass
        stats = session.monitor_federation(poll_every_s=0.25)
        described = client.describe_federation()
    finally:
        if client is not None:
            client.close()
        session.shutdown_federation(timeout_s=MP_TIMEOUT_S)
    codes = session.process_exit_codes()
    with open(os.path.join(workdir, "controller.log")) as f:
        ctrl_log = f.read()
    retries = re.findall(r"dispatch retry 1: replacing unreachable (\S+) "
                         r"with (\S+)", ctrl_log)
    metas = stats["round_metadata"]
    failed, replacement = retries[0] if len(retries) == 1 else ("", "")
    later = [sorted(m["train_submitted_at"]) for m in metas[2:CHAOS_ROUNDS]]
    smoke.check(len(retries) == 1 and len(metas) >= CHAOS_ROUNDS
                and sorted(metas[1]["train_submitted_at"]) == sorted(
                    {failed, replacement, *metas[1]["selected_learners"]})
                and replacement in metas[1]["selected_learners"]
                and failed not in metas[1]["selected_learners"],
                f"rounds chaos: the controller's dropped RunTask to "
                f"{failed} was retried, {replacement} dispatched in its place "
                f"(round 1 dispatched {sorted(metas[1]['train_submitted_at'])}"
                f", cohort {metas[1]['selected_learners']})")
    rows = {r["learner_id"]: r for r in (described or {}).get("learners", [])}
    quarantined = (described or {}).get("scheduling", {}).get(
        "quarantined", [])
    smoke.check(rows.get(failed, {}).get("churn_score", 0.0) > 0.0
                and quarantined == [failed]
                and all(failed not in ids for ids in later),
                f"rounds chaos: {failed}'s churn score rose to "
                f"{rows.get(failed, {}).get('churn_score')} and it sits out "
                f"quarantined {quarantined}: rounds 2-{CHAOS_ROUNDS - 1} "
                f"dispatched {later}")
    with open(os.path.join(workdir, "learner_2.log")) as f:
        slowed = "slowing train task by 3.0x" in f.read()
    smoke.check(slowed and len(codes) == CHAOS_LEARNERS + 1
                and all(c == 0 for c in codes.values()),
                f"rounds chaos: learner_2 ran its slow fault ({slowed}); "
                f"every process exits 0 {codes}")
    out["chaos"] = {"failed": failed, "replacement": replacement,
                    "retries": len(retries), "quarantined": quarantined,
                    "churn": {k: r.get("churn_score") for k, r in
                              rows.items()},
                    "dispatched": [sorted(m["train_submitted_at"])
                                   for m in metas],
                    "exit_codes": codes}
    part_done("(e) chaos")

    # (f) the cross-device harness, and the slice-kill gate
    scenario = ChurnScenario(seed=SEED, clients=XD_CLIENTS, rounds=XD_ROUNDS,
                             quorum=XD_QUORUM, overprovision=1.0,
                             dropout=0.3, flappers=1, partitioned=1)
    churn = run_scenario(scenario)
    control = run_scenario(ChurnScenario(
        seed=SEED, clients=XD_CLIENTS, rounds=XD_ROUNDS, quorum=XD_QUORUM,
        overprovision=1.0, dropout=0.0, flappers=0, partitioned=0))
    gap = abs(churn["accuracy"] - control["accuracy"])
    smoke.check(churn["ok"] and control["ok"] and gap <= XD_TOLERANCE
                and all(r >= XD_QUORUM
                        for r in churn["reporters_per_round"])
                and churn["faults"]["dropped"] > 0
                and churn["faults"]["flapped"] >= 1
                and churn["faults"]["partitioned"] >= 1,
                f"rounds crossdevice: {XD_CLIENTS} virtual clients, "
                f"{churn['rounds_completed']} rounds at quorum "
                f"{churn['reporters_per_round']}, faults {churn['faults']}; "
                f"accuracy {churn['accuracy']} against the control's "
                f"{control['accuracy']} (gap {gap:.4f} <= {XD_TOLERANCE})")
    slices = run_slice_smoke(clients=12, rounds=2, slices=2, seed=SEED)
    kill = slices["kill"].get("slices") or {}
    smoke.check(slices["ok"],
                f"rounds crossdevice: run_slice_smoke killed a slice "
                f"aggregator mid-round ({kill.get('killed')}), it re-homed "
                f"({kill.get('rehomed_total')}), and the community equals "
                f"the undisturbed control's bits ({slices['bit_identical']})")
    out["crossdevice"] = {
        "churn": {k: churn[k] for k in ("rounds_completed", "accuracy",
                                        "reporters_per_round", "faults",
                                        "wall_s")},
        "control": {k: control[k] for k in ("accuracy", "wall_s")},
        "slice_smoke": {"ok": slices["ok"], "killed": kill.get("killed"),
                        "rehomed_total": kill.get("rehomed_total"),
                        "bit_identical": slices["bit_identical"],
                        "kill_wall_s": slices["kill"]["wall_s"],
                        "control_wall_s": slices["control"]["wall_s"]}}
    part_done("(f) crossdevice")
    shutil.rmtree(ROUNDS_DIR, ignore_errors=True)
    out["part_s"] = part_s
    out["gpu"] = gpu
    print(json.dumps({"rounds": out}), flush=True)
    return out



# -- failover: checkpoints and --resume, the hot standby, the driver's
# supervised relaunch, and the registry's stable version served

FAILOVER_DIR = os.path.join(REPO, "build", "chip_smoke_failover")
# (a) in process: 2 LlamaLite learners, 3 rounds, the controller replaced
# from its checkpoint after round 1
FO_LEARNERS, FO_ROUNDS = 2, 3
# (c) the CNN (without dropout) with a process per learner
FO_CNN_LEARNERS, FO_CNN_ROUNDS, FO_CNN_EXAMPLES, FO_CNN_STEPS = 2, 2, 300, 10
# the hot standby's escalation (the JAX package's controller-kill gate's):
# 1.5 s of WAL stall, then 2 failed health probes 0.25 s apart
STANDBY = dict(stale_after_s=1.5, probe_interval_s=0.25, probe_failures=2)
# the controller killed at its first uplink: mid-round, with the uplinks
# in the air
KILL_RULE = {"process": "controller", "side": "server", "fault": "kill",
             "method": "MarkTaskCompleted", "max_fires": 1}
# the failover federations' transport: a call to a dead controller gives
# up after 3 UNAVAILABLE retries 0.5 s apart (the default is 10, 1 s
# apart) and redials (the standby) or re-attaches (a relaunch)
FO_COMM = dict(retries=3, retry_sleep_s=0.5)


def failover_phase(smoke, gpu, mp_llama):
    """Failover and the registry on the card. First one LlamaLite Adam
    step (full width, depth ``CUT_DEPTH``) trained twice from one blob,
    its uplink bytes compared: every bit compare below rests on it. (a) In
    process, 2 LlamaLite learners at full width and depth ``CUT_DEPTH``,
    ``fedavg``, checkpoints and the registry on, each round evaluated: a
    control of 3 rounds, and a run whose controller is shut down once
    round 1 closed and its evaluations were folded, replaced by a fresh
    ``Controller`` from ``restore_checkpoint()``; the learners re-attach
    on the new epoch and ``resume_round()`` goes on. Rounds 2-3's versions
    must be the control's bits, the lineage (ids, rounds, parents,
    channels, the stable head) the control's, the learners' ids and tokens
    unchanged; then a ``ServingGateway`` syncs the stable version from the
    restored controller (``DirectRegistrySource``) and answers a Predict
    burst through K1 within ``LOGITS_ATOL`` of the dense path. (b) The
    multiprocess phase's LlamaLite federation again, with the controller
    killed at its first uplink: the standby promotes exactly once, every
    round completes, each round-pinned version is the multiprocess phase's
    (the control's) bits, every tracked process exits 0. (c) The CNN
    with a process per learner, no standby, the same kill under the
    driver's supervision: one relaunch with ``--resume``, the learners
    keep their ids, the versions equal a control run's."""
    import hashlib

    import torch

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        ChaosConfig,
        CheckpointConfig,
        CommConfig,
        EvalConfig,
        FailoverConfig,
        FederationConfig,
        RegistryConfig,
        ServingConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.controller import Controller
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import (
        ArrayDataset,
        TorchModelOps,
        load_flax_variables,
    )
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN, LlamaLite
    from metisfl_tpu_torch.serving import (
        DirectRegistrySource,
        ServingGateway,
    )
    from metisfl_tpu_torch.tensor import ModelBlob, pack_model, unpack_model

    out = {"depth": CUT_DEPTH}
    part_s, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now
        print(f"failover {name}: {part_s[name]:.3f} s", flush=True)

    shutil.rmtree(FAILOVER_DIR, ignore_errors=True)
    os.makedirs(FAILOVER_DIR)
    llama = dict(vocab_size=VOCAB, dim=DIM, depth=CUT_DEPTH, heads=HEADS,
                 kv_heads=KV_HEADS, dtype=torch.bfloat16)
    variables, seed_blob = llama_seed(CUT_DEPTH)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, VOCAB, (FED_LEARNERS * FED_ROWS + FED_EVAL_ROWS, TRAIN_LEN + 1)
    ).astype(np.int32)
    test = ArrayDataset(tokens[-FED_EVAL_ROWS:, :-1],
                        tokens[-FED_EVAL_ROWS:, 1:])
    sha = lambda raw: hashlib.sha256(raw or b"").hexdigest()  # noqa: E731
    # the process federations of (b) and (c) run beside the in-process
    # parts: their processes boot, and wait on each other, while the card
    # runs the rest. (b) first, the longest; (c) after the determinism
    # check, so the boots of the two do not all share the host at once
    # (b) the hot standby: the multiprocess phase's federation, its
    # controller killed at the first uplink
    part_b = Background(mp_llama_run, smoke, "failover llama", True)
    # (c) the driver's supervised relaunch: the CNN, no standby; the kill
    # run and its control at once
    x, y = synthetic_image_classification(
        FO_CNN_LEARNERS * FO_CNN_EXAMPLES, noise=CNN_NOISE, seed=SEED + 9)
    shards = [(x[i * FO_CNN_EXAMPLES:(i + 1) * FO_CNN_EXAMPLES],
               y[i * FO_CNN_EXAMPLES:(i + 1) * FO_CNN_EXAMPLES])
              for i in range(FO_CNN_LEARNERS)]
    template = TorchModelOps(FashionMnistCNN(dropout_rate=0.0),
                             rng_seed=SEED, device="cpu").get_variables()

    def cnn_run(kill):
        return Background(
            run_multiprocess, smoke,
            "failover cnn " + ("kill" if kill else "control"), "cnn0",
            shards, shards[0],
            TrainParams(batch_size=CNN_BATCH, local_steps=FO_CNN_STEPS,
                        optimizer="sgd", learning_rate=0.05),
            EvalConfig(every_n_rounds=0), FO_CNN_ROUNDS, template,
            config_extra=dict(
                comm=CommConfig(**FO_COMM),
                registry=RegistryConfig(enabled=True, retention=16),
                failover=FailoverConfig(restart_backoff_s=0.5),
                chaos=ChaosConfig(enabled=kill, seed=SEED,
                                  rules=[KILL_RULE] if kill else [])))

    # one Adam step, twice, from one blob: the uplink's bytes
    ops = TorchModelOps(LlamaLite(**llama, use_flash=True, device=DEVICE),
                        variables=variables, device=DEVICE)
    rows = tokens[:FED_ROWS]
    data = ArrayDataset(rows[:, :-1], rows[:, 1:], seed=SEED)
    step = TrainParams(batch_size=TRAIN_BATCH, local_steps=1,
                       optimizer="adam", learning_rate=1e-4)
    uplinks = []
    for _ in range(2):
        ops.set_variables(unpack_model(seed_blob, ops.get_variables()))
        uplinks.append(pack_model(ops.train(data, step).variables))
    smoke.check(uplinks[0] == uplinks[1],
                f"failover: one LlamaLite Adam step from one blob ships the "
                f"same {len(uplinks[0])} uplink bytes twice (sha256 "
                f"{sha(uplinks[0])[:16]})")
    out["step_uplink_sha256"] = [sha(u) for u in uplinks]
    del ops, uplinks
    empty_cache()
    part_done("determinism")
    parts_c = {kill: cnn_run(kill) for kill in (True, False)}

    # (a) checkpoint and --resume, in process
    reset_launches()

    def fo_config(rounds, ckpt_dir=""):
        return FederationConfig(
            aggregation=AggregationConfig(scaler="train_dataset_size"),
            train=TrainParams(batch_size=TRAIN_BATCH, local_steps=FED_STEPS,
                              optimizer="adam", learning_rate=1e-4),
            eval=EvalConfig(batch_size=TRAIN_BATCH, datasets=["test"],
                            metrics=["loss", "accuracy"]),
            termination=TerminationConfig(federation_rounds=rounds),
            checkpoint=CheckpointConfig(dir=ckpt_dir),
            registry=RegistryConfig(enabled=True, retention=8))

    def gated(fed, version):
        """Version ``version``'s gate ran (its evaluations all folded)."""
        infos = [v for v in fed.controller.describe_registry().get(
            "versions", []) if v["version"] == version]
        return bool(infos and infos[0]["gate"])

    def fo_federation(rounds, ckpt_dir=""):
        """A learner trains round r + 1 once version r's gate ran (r, the
        rounds its controller completed): a version's parent is then the
        stable head its evaluation decided, in every run."""
        fed = InProcessFederation(fo_config(rounds, ckpt_dir),
                                  device=DEVICE)

        def before(*args, **kwargs):
            done = fed.controller.global_iteration
            if done:
                wait_for(lambda: gated(fed, done), 300.0,
                         f"version {done}'s gate")

        for i in range(FO_LEARNERS):
            rows = tokens[i * FED_ROWS:(i + 1) * FED_ROWS]
            ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                          device=DEVICE),
                                variables=variables, device=DEVICE)
            wrap(ops, "train", before=before)
            fed.add_learner(ops, ArrayDataset(rows[:, :-1], rows[:, 1:],
                                              seed=SEED + i),
                            test_dataset=test)
        seed_federation(fed, seed_blob)
        return fed

    def lineage(ctrl):
        desc = ctrl.describe_registry()
        return {"stable": desc["stable"], "candidate": desc["candidate"],
                "versions": [(v["version"], v["round"], v["parent"],
                              v["channel"]) for v in desc["versions"]]}

    def capture(fed, into):
        wait_for(lambda: gated(fed, FO_ROUNDS), 300.0, "the last gate")
        ctrl = fed.controller
        into.update(lineage=lineage(ctrl), sha={
            v: sha(ctrl.registered_model(v)) for v in range(1, FO_ROUNDS + 1)})

    # the control (it keeps no checkpoint; the kill run's does) beside the
    # kill run, on the card at once: each round's bits are the same in any
    # process, whatever else runs
    control = {}
    control_fed = fo_federation(FO_ROUNDS)
    control_run = Background(run_federation, control_fed,
                             settle=lambda: capture(control_fed, control))

    t0 = time.perf_counter()
    ckpt = os.path.join(FAILOVER_DIR, "ckpt_kill")
    fed = fo_federation(1, ckpt)
    gateway = None
    try:
        fed.start()
        wait_for(lambda: fed.controller.global_iteration >= 1, 600.0,
                 "round 1")
        wait_for(lambda: gated(fed, 1), 300.0, "version 1's gate")
        ctrl1 = fed.controller
        identities = sorted((ln.learner_id, ln.auth_token)
                            for ln in fed.learners)
        epoch1 = ctrl1.controller_epoch
        # the crash: only the checkpoint survives it (written after the
        # executor drained, so the folded evaluation is in it)
        ctrl1.shutdown()
        ctrl1.save_checkpoint()
        t1 = time.perf_counter()
        # the new incarnation needs no checkpoint of its own here
        ctrl2 = Controller(fo_config(FO_ROUNDS), fed._make_proxy,
                           device=DEVICE)
        restored = ctrl2.restore_checkpoint(ckpt)
        restore_s = time.perf_counter() - t1
        fed.controller = ctrl2
        for learner in fed.learners:
            learner.controller = ctrl2
        smoke.check(restored and ctrl2.global_iteration == 1
                    and ctrl2.controller_epoch != epoch1,
                    f"failover (a): a fresh controller restored the "
                    f"checkpoint at round {ctrl2.global_iteration} in "
                    f"{restore_s:.3f} s, under a new epoch")
        smoke.check(ctrl2.resume_round(), "failover (a): resume_round() "
                    "re-dispatched the round")
        wait_for(lambda: ctrl2.global_iteration >= FO_ROUNDS, 600.0,
                 f"round {FO_ROUNDS}")
        resumed_wall = time.perf_counter() - t1
        resumed = {}
        capture(fed, resumed)
        control_run.result()
        del control_fed
        with ctrl2._lock:
            registry = sorted((lid, r.auth_token)
                              for lid, r in ctrl2._learners.items())
        kept = sorted((ln.learner_id, ln.auth_token) for ln in fed.learners)
        smoke.check(registry == identities == kept
                    and all(ln.controller_epoch == ctrl2.controller_epoch
                            for ln in fed.learners),
                    "failover (a): the learners re-attached on the new "
                    "epoch with their ids and tokens unchanged "
                    f"{[lid for lid, _ in identities]}")
        same = [resumed["sha"][v] == control["sha"][v]
                for v in range(2, FO_ROUNDS + 1)]
        smoke.check(all(same),
                    f"failover (a): versions 2-{FO_ROUNDS} (rounds 2-"
                    f"{FO_ROUNDS}) are the control's bits {same}")
        smoke.check(resumed["lineage"] == control["lineage"],
                    f"failover (a): the lineage (ids, rounds, parents, "
                    f"channels, stable head) is the control's "
                    f"{resumed['lineage']}")
        # the gateway serves the restored controller's stable version
        stable = ctrl2.describe_registry()["stable"]
        serve_ops = TorchModelOps(LlamaLite(**llama, use_flash=True,
                                            device=DEVICE),
                                  variables=variables, device=DEVICE)
        gateway = ServingGateway(serve_ops, ServingConfig(
            max_batch=MAX_BATCH, max_wait_ms=50.0), device=DEVICE)
        installed = gateway.sync(DirectRegistrySource(ctrl2))
        smoke.check(stable > 0 and installed.get("stable") == stable,
                    f"failover (a): the gateway installed the stable "
                    f"version v{stable} ({installed})")
        rows = np.random.default_rng(SEED + 1).integers(
            0, VOCAB, (PREDICT_REQUESTS, 1, PREDICT_LEN)).astype(np.int32)
        gateway.predict(rows[0], key="warmup")
        import importlib
        fa = importlib.import_module(
            "metisfl_tpu_torch.ops.flash_attention")
        before_k1 = fa.flash_attention_fwd.launches
        serve_ops.forward_calls = 0
        replies, predict_wall = run_concurrently(
            lambda i: gateway.predict(rows[i], key=f"user-{i}"),
            PREDICT_REQUESTS)
        k1 = fa.flash_attention_fwd.launches - before_k1
        forwards = serve_ops.forward_calls
        smoke.check(all(r[1] == stable and r[2] == "stable"
                        and r[0].shape == (1, PREDICT_LEN, VOCAB)
                        and np.isfinite(r[0]).all() for r in replies)
                    and k1 == CUT_DEPTH * forwards and forwards > 0,
                    f"failover (a): {PREDICT_REQUESTS} Predicts from v"
                    f"{stable}, finite, {k1} K1 launches = {CUT_DEPTH} per "
                    f"forward x {forwards} forwards")
        dense = load_flax_variables(
            LlamaLite(**llama, use_flash=False, device=DEVICE),
            ModelBlob.from_bytes(ctrl2.registered_model(stable)).tensors
        ).eval()
        with torch.no_grad():
            want = dense(torch.as_tensor(rows[0], device=DEVICE)
                         ).cpu().numpy()
        err = float(np.abs(replies[0][0] - want).max())
        smoke.check(err <= LOGITS_ATOL,
                    f"failover (a): the stable version's Predict vs the "
                    f"dense path: max abs err {err:.4g} <= {LOGITS_ATOL}")
        del dense, want
        out["a"] = {"restore_s": restore_s,
                    "resumed_rounds_s": resumed_wall,
                    "wall_s": time.perf_counter() - t0,
                    "stable_version": stable, "lineage": resumed["lineage"],
                    "version_sha256": resumed["sha"],
                    "predict_wall_s": predict_wall,
                    "predict_k1_launches": k1,
                    "predict_vs_dense_max_abs_err": err}
    finally:
        if gateway is not None:
            gateway.shutdown()
        fed.shutdown()
    launches_a = launch_counts()
    del fed
    empty_cache()
    part_done("a (the control beside the resumed run)")

    control_sha = (mp_llama or {}).get("version_sha256") or {}
    stats, records, ids, workdir, _, walls = part_b.result()
    wall_b = part_b.wall_s
    smoke.check(walls["promoted"] and walls["promoted_logged"]
                and walls["standby_promotions"] == 1,
                f"failover (b): the standby promoted exactly once "
                f"({walls['promote_s']} s from the decision to serving) and "
                "the driver handed the controller endpoint over")
    smoke.check(stats["global_iteration"] >= MP_ROUNDS
                and sorted(stats["learners"]) == sorted(ids.values()),
                f"failover (b): all {MP_ROUNDS} rounds completed, the "
                "learners kept their ids")
    got = {int(k): v for k, v in walls.get("version_sha256", {}).items()}
    want = {int(k): v for k, v in control_sha.items()}
    smoke.check(bool(want) and got == want,
                f"failover (b): each round-pinned version is the control's "
                f"bits (the multiprocess phase's run) {sorted(got)}")
    launches_b = {name: sum(r["launches"][name] for r in records)
                  for name in ("flash_attention_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")}
    out["b"] = {**walls, "rounds": stats["global_iteration"],
                "wall_s": wall_b}
    part_done("b standby (joined)")

    runs = {}
    for kill in (True, False):
        stats, _, ids, _, _, walls = parts_c[kill].result()
        wall = parts_c[kill].wall_s
        runs[kill] = (stats, ids, dict(walls, wall_s=wall))
    stats, ids, walls = runs[True]
    with open(os.path.join(MP_DIR, "failover cnn kill",
                           "controller.log")) as f:
        relaunched = "restored checkpoint" in f.read()
    smoke.check(walls["restarts"] == 1 and relaunched
                and runs[False][2]["restarts"] == 0,
                "failover (c): the driver relaunched the killed controller "
                "once with --resume (it restored its checkpoint); the "
                "control never")
    smoke.check(stats["global_iteration"] >= FO_CNN_ROUNDS
                and sorted(stats["learners"]) == sorted(ids.values()),
                f"failover (c): all {FO_CNN_ROUNDS} rounds completed, the "
                "learners kept their ids")
    got, want = walls.get("version_sha256"), runs[False][2].get(
        "version_sha256")
    smoke.check(bool(want) and got == want,
                "failover (c): each round-pinned version is the control "
                "run's bits")
    out["c"] = {"kill": walls, "control": runs[False][2]}
    shutil.rmtree(MP_DIR, ignore_errors=True)
    shutil.rmtree(FAILOVER_DIR, ignore_errors=True)
    part_done("c relaunch (joined)")

    out["launches"] = {"flash_fwd": launches_a["flash_attention_fwd"]
                       + launches_b["flash_attention_fwd"],
                       "flash_bwd_dq": launches_a["flash_bwd_dq"]
                       + launches_b["flash_bwd_dq"],
                       "flash_bwd_dkv": launches_a["flash_bwd_dkv"]
                       + launches_b["flash_bwd_dkv"]}
    out["part_s"] = part_s
    out["gpu"] = gpu
    print(json.dumps({"failover": out}), flush=True)
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def profile_call(fn, top: int = 8, calls: int = 1):
    """:func:`profile_one` of ``fn``, its seconds in ``SETUP``."""
    t0 = time.perf_counter()
    try:
        return profile_one(fn, top, calls)
    finally:
        SETUP["profiles"].append((CURRENT_PHASE[0],
                                  round(time.perf_counter() - t0, 3)))


def profile_one(fn, top: int = 8, calls: int = 1):
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``, beside the call's wall time. Only device events
    (kernels, copies) are summed; ``idle_share`` is the part of the wall
    time with no device work (the profiler's own host cost included, so
    it reads high). ``per_call_ms`` is the device time of one of the
    ``calls`` that ``fn`` makes: each kernel's mean time times its
    launches a call, so that a record the profiler drops (it sometimes
    loses one of 20) does not read as a faster call. A profiler that
    records no device time reports "not measured"."""
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
    per_call_ms = sum(ms / c * max(1, round(c / calls))
                      for ms, _, c in rows if c)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "per_call_ms": per_call_ms,
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

    from metisfl_tpu_torch.driver import InProcessFederation
    construct = InProcessFederation.__init__

    def stamped(fed, *args, **kwargs):
        fed._smoke_born = time.perf_counter()
        construct(fed, *args, **kwargs)

    InProcessFederation.__init__ = stamped

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
    ragged_fp32 = smoke.phase(
        "kernel vs plain: flash_fwd ragged fp32 D=128", attention_case,
        smoke, "flash_fwd_ragged_fp32", 2, 8, 8, 1000, 128, "float32", False,
        1e-4, 1e-4, "flash_fwd_general")
    bwd_cases = smoke.phase(
        "kernel vs plain: flash_bwd_dq and flash_bwd_dkv at the training "
        "shape", backward_case, smoke, "flash_bwd", 8, 16, 4, TRAIN_LEN, 64,
        "bfloat16", True, 2e-2)
    # fp32 K2 and K3 at D <= 128 on their register-tiled kernels
    general = ("flash_bwd_dq_general", "flash_bwd_dkv_general")
    ragged_bwd = smoke.phase(
        "kernel vs plain: flash_bwd ragged fp32 D=128", backward_case, smoke,
        "flash_bwd_ragged_fp32", 2, 8, 8, 1000, 128, "float32", False, 1e-4,
        general)
    # small head dims (K1, K2 and K3 on their D = 16 and 32 builds, reading
    # D in place: a call runs no pad or copy), and B·Hq and Hq above
    # gridDim.y's 65535 (one launch a call: every grid is 1-D)
    small_d = {}
    for name, shape in (
            # examples/long_context.py's shape
            ("long_context_d16", (4, 4, 4, 512, 16)),
            ("d8", (2, 16, 4, 1024, 8)),
            ("d32", (2, 16, 4, 1024, 32)),
            ("grid_b4100", (4100, 16, 4, 16, 64)),
            ("grid_hq65536", (1, 65536, 16384, 16, 64))):
        own = shape[-1] <= 32
        small_d[name] = (
            smoke.phase(f"kernel vs plain: flash_fwd {name}", attention_case,
                        smoke, f"flash_fwd_{name}", *shape, "bfloat16", True,
                        2e-2, 1e-3, "flash_attention_fwd", True, own),
            smoke.phase(f"kernel vs plain: flash_bwd {name}", backward_case,
                        smoke, f"flash_bwd_{name}", *shape, "bfloat16", True,
                        2e-2, ("flash_bwd_dq", "flash_bwd_dkv"), True, own))
    # K3's split sum into bf16 at the d8 and d32 cases' split, bit for bit
    smoke.phase("kernel vs plain: the split sum at d32 bf16", split_sum_case,
                smoke, "flash_bwd_split_sum_d32_bf16", 2, 16, 4, 1024, 32,
                True, "bfloat16")
    # correctness only: the D = 32 build reading D = 24 in place, ragged L,
    # GQA, fp16, not causal
    smoke.phase("kernel vs plain: flash_fwd d24 fp16", attention_case,
                smoke, "flash_fwd_d24_fp16", 2, 8, 2, 1000, 24, "float16",
                False, 2e-3, 1e-3, "flash_attention_fwd", False, True)
    smoke.phase("kernel vs plain: flash_bwd d24 fp16", backward_case,
                smoke, "flash_bwd_d24_fp16", 2, 8, 2, 1000, 24, "float16",
                False, 2e-3, ("flash_bwd_dq", "flash_bwd_dkv"), False, True)
    # the head dim 256 builds (K1 on two warpgroups over 128-row q tiles,
    # K2 on two with dQ split by columns, K3 in one launch of two, with its
    # split sum where dkv_mma_split cuts its walks: a K1, K2 or K3 call runs
    # no pad or copy)
    d256_fwd = smoke.phase(
        "kernel vs plain: flash_fwd d256", attention_case, smoke,
        "flash_fwd_d256", *FULL_D256, "bfloat16", True, 2e-2, 1e-3,
        "flash_attention_fwd", True, True)
    # correctness only, at the edges of those blocks: a ragged L past a
    # 128-row tile, not causal, in fp16; L = 65 causal in bf16, where
    # warpgroup 1 of K1's one q tile holds one row
    for name, L, dtype_name, causal, o_atol, rel in (
            ("d256_l1000_fp16", 1000, "float16", False, 2e-3, 2e-3),
            ("d256_l65_bf16", 65, "bfloat16", True, 2e-2, 2e-2)):
        smoke.phase(f"kernel vs plain: flash_fwd {name}", attention_case,
                    smoke, f"flash_fwd_{name}", 2, 8, 2, L, 256, dtype_name,
                    causal, o_atol, 1e-3, "flash_attention_fwd", False)
        smoke.phase(f"kernel vs plain: flash_bwd {name}", backward_case,
                    smoke, f"flash_bwd_{name}", 2, 8, 2, L, 256, dtype_name,
                    causal, rel, ("flash_bwd_dq", "flash_bwd_dkv"), False)
    d256_bwd = smoke.phase(
        "kernel vs plain: flash_bwd d256", backward_case, smoke,
        "flash_bwd_d256", *FULL_D256, "bfloat16", True, 2e-2,
        ("flash_bwd_dq", "flash_bwd_dkv"), True, True)
    if dkv_mma_split_at(*FULL_D256[:4], 256, True)[1] > 1:
        smoke.phase(
            "kernel vs plain: the split sum at d256 bf16", split_sum_case,
            smoke, "flash_bwd_split_sum_d256_bf16", *FULL_D256, True,
            "bfloat16")
    # beyond every build: the general kernels, K1-K3 on tensor cores in
    # bf16/fp16; in fp32 K1-K3 register-tiled (and the combine and the
    # split sums, where they split)
    general_mma = ("flash_bwd_dq_general_mma", "flash_bwd_dkv_general_mma")
    d512_fwd, d512_bwd = {}, {}
    for dtype_name, o_atol, lse_atol, rel, fwd, bwd in (
            ("bfloat16", 2e-2, 1e-3, 2e-2, "flash_fwd_general_mma",
             general_mma),
            ("float32", 1e-4, 1e-4, 1e-4, "flash_fwd_general", general)):
        tag = "bf16" if dtype_name == "bfloat16" else "fp32"
        d512_fwd[tag] = smoke.phase(
            f"kernel vs plain: flash_fwd d512 {tag}", attention_case, smoke,
            f"flash_fwd_general_d512_{tag}", 1, 4, 4, 512, 512, dtype_name,
            True, o_atol, lse_atol, fwd)
        d512_bwd[tag] = smoke.phase(
            f"kernel vs plain: flash_bwd d512 {tag}", backward_case, smoke,
            f"flash_bwd_general_d512_{tag}", 1, 4, 4, 512, 512, dtype_name,
            True, rel, bwd)
    full_bwd_fp32 = smoke.phase(
        "kernel vs plain: flash_bwd d256 fp32", backward_case, smoke,
        "flash_bwd_general_d256_fp32", *FULL_D256_FP32, "float32", True,
        1e-4, general)
    smoke.phase("kernel vs plain: the split sum at d256 fp32",
                split_sum_case, smoke, "flash_bwd_split_sum_d256_fp32", 2,
                8, 2, 1024, 256, True)
    # the fp32 K1 at that shape, which fills the card (unsplit), and its
    # combine at the B1·Hq4·L512·D512 case's split
    full_fp32 = smoke.phase(
        "kernel vs plain: flash_fwd d256 fp32 full", attention_case, smoke,
        "flash_fwd_general_d256_fp32", *FULL_D256_FP32, "float32", True,
        1e-4, 1e-4, "flash_fwd_general")
    d512_combine = smoke.phase(
        "kernel vs plain: the combine at d512 fp32", combine_case, smoke,
        "flash_fwd_combine_d512_fp32", 1, 4, 512, 512, True)
    d512_dq_sum = smoke.phase(
        "kernel vs plain: the dQ split sum at d512 fp32", dq_sum_case, smoke,
        "flash_bwd_dq_sum_d512_fp32", 1, 4, 512, 512, True)
    # the D = 256 case's shape at twice the head dim, which fills the card:
    # the tensor-core general kernels beside the D = 256 builds
    full_cases = (
        smoke.phase("kernel vs plain: flash_fwd d512 full", attention_case,
                    smoke, "flash_fwd_d512", *FULL_D512, "bfloat16", True,
                    2e-2, 1e-3, "flash_fwd_general_mma"),
        smoke.phase("kernel vs plain: flash_bwd d512 full", backward_case,
                    smoke, "flash_bwd_d512", *FULL_D512, "bfloat16", True,
                    2e-2, general_mma))
    # correctness only, at an awkward shape: a narrower last chunk (D = 320
    # pads to 320: chunks of 256 and 64), ragged L, GQA, fp16, not causal
    smoke.phase("kernel vs plain: flash_fwd d320 fp16", attention_case,
                smoke, "flash_fwd_d320_fp16", 2, 8, 2, 1000, 320, "float16",
                False, 2e-3, 1e-3, "flash_fwd_general_mma", False)
    smoke.phase("kernel vs plain: flash_bwd d320 fp16", backward_case,
                smoke, "flash_bwd_d320_fp16", 2, 8, 2, 1000, 320, "float16",
                False, 2e-3, general_mma, False)
    # the wide-heads path's own shapes: every wrapper it launches, held to
    # its twin where the path launches it (its rows in the kernels line)
    wide_cases = {}
    for label, heads, dtype_name, fwd, bwd in WIDE_CASES:
        o_atol, lse_atol, rel = ((2e-2, 1e-3, 2e-2)
                                 if dtype_name == "bfloat16"
                                 else (1e-4, 1e-4, 1e-4))
        shape = (WIDE_BATCH, heads, heads, WIDE_LEN, DIM // heads)
        sum_case = combine = dq_sum = None
        if bwd[1] == "flash_bwd_dkv_general" and dkv_split_at(
                *shape, True)[1] > 1:
            sum_case = smoke.phase(
                f"kernel vs plain: the split sum wide heads {label}",
                split_sum_case, smoke, f"flash_bwd_split_sum_wide_{label}",
                *shape, True)
        elif mma_split_build(dtype_name, shape[-1]) and dkv_mma_split_at(
                *shape[:4], mma_split_build(dtype_name, shape[-1]),
                True)[1] > 1:
            sum_case = smoke.phase(
                f"kernel vs plain: the split sum wide heads {label}",
                split_sum_case, smoke, f"flash_bwd_split_sum_wide_{label}",
                *shape, True, dtype_name)
        if bwd[0] == "flash_bwd_dq_general" and dq_split_at(
                *shape[:2], *shape[3:], True)[1] > 1:
            dq_sum = smoke.phase(
                f"kernel vs plain: the dQ split sum wide heads {label}",
                dq_sum_case, smoke, f"flash_bwd_dq_sum_wide_{label}",
                *shape[:2], *shape[3:], True)
        if fwd == "flash_fwd_general" and fwd_split_at(
                *shape[:2], *shape[3:], True)[1] > 1:
            combine = smoke.phase(
                f"kernel vs plain: the combine wide heads {label}",
                combine_case, smoke, f"flash_fwd_combine_wide_{label}",
                *shape[:2], *shape[3:], True)
        wide_cases[label] = (
            smoke.phase(f"kernel vs plain: flash_fwd wide heads {label}",
                        attention_case, smoke, f"flash_fwd_wide_{label}",
                        *shape, dtype_name, True, o_atol, lse_atol, fwd),
            smoke.phase(f"kernel vs plain: flash_bwd wide heads {label}",
                        backward_case, smoke, f"flash_bwd_wide_{label}",
                        *shape, dtype_name, True, rel, bwd),
            sum_case, combine, dq_sum)
    sliced = smoke.phase("slice: Predict and Generate through the gateway",
                         slice_phase, smoke, gpu)
    torch.cuda.empty_cache()
    trained = smoke.phase("slice: LlamaLite training through TorchModelOps",
                          training_phase, smoke, gpu)
    torch.cuda.empty_cache()
    wide = smoke.phase("slice: LlamaLite training at head dims 16, 32, 256 "
                       "and 512",
                       wide_heads_phase, smoke, gpu)
    torch.cuda.empty_cache()
    federated = smoke.phase("slice: synchronous FedAvg rounds through "
                            "InProcessFederation", federation_phase, smoke,
                            gpu)
    torch.cuda.empty_cache()
    ruled = smoke.phase(
        "slice: the other aggregation rules (the robust ones on the card) "
        "and a learner launched over ssh", rules_phase, smoke, gpu,
        ((federated or {}).get("llama") or {}).get("round_wall_s"))
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
    torch.cuda.empty_cache()
    tiered = smoke.phase(
        "slice: the controller's streaming and tree tiers, and secure "
        "aggregation (masking with dropout recovery, CKKS)",
        tiers_secure_phase, smoke, gpu)
    empty_cache()
    uplinked = smoke.phase(
        "slice: the distributed slice tier (slice aggregator processes, "
        "spool, re-homing) and the uplink variants (SCAFFOLD, int8q, "
        "top-k, bf16 downlink, DP, ship-only)", uplinks_phase, smoke, gpu,
        ((tiered or {}).get("tree") or {}).get("wall_s"))
    empty_cache()
    rounded = smoke.phase(
        "slice: round control (buffered, quorum, semi-synchronous, a "
        "deadline under masking, chaos through DriverSession, the "
        "cross-device harness)", rounds_phase, smoke, gpu)
    empty_cache()
    failed_over = smoke.phase(
        "slice: failover and the registry (checkpoint and --resume, the "
        "hot standby, the supervised relaunch, the stable version served)",
        failover_phase, smoke, gpu, (multiprocess or {}).get("llama"))

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
    # the rules phase's median round
    rules_launches = ((ruled or {}).get("median_llama") or {}).get(
        "launches", {})
    # the tiers phase's four LlamaLite rounds
    tiers_launches = (tiered or {}).get("launches", {})
    # the uplinks phase's nine
    uplinks_launches = (uplinked or {}).get("launches", {})
    # the rounds phase's buffered, quorum and semi-synchronous rounds
    rounds_launches = (rounded or {}).get("launches", {})
    # the failover phase's in-process rounds, its gateway's Predicts and
    # its killed federation's learner processes
    failover_launches = (failed_over or {}).get("launches", {})
    rows = []
    if main_case is not None:
        by_path = {"serve": serve_k1,
                   "train": train_launches.get("flash_fwd", 0),
                   "federation": fed_launches.get("flash_fwd", 0),
                   "multiprocess": mp_launches.get("flash_fwd", 0),
                   "store": store_launches.get("flash_attention_fwd", 0),
                   "rules": rules_launches.get("flash_fwd", 0),
                   "tiers": tiers_launches.get("flash_fwd", 0),
                   "uplinks": uplinks_launches.get("flash_fwd", 0),
                   "rounds": rounds_launches.get("flash_fwd", 0),
                   "failover": failover_launches.get("flash_fwd", 0)}
        rows.append(("flash_fwd", "flash_fwd.cu", 76, main_case,
                     sum(by_path.values()), by_path))
    for record, line in zip(bwd_cases or [], (126, 162)):
        by_path = {"train": train_launches.get(record["name"], 0),
                   "federation": fed_launches.get(record["name"], 0),
                   "multiprocess": mp_launches.get(record["name"], 0),
                   "store": store_launches.get(record["name"], 0),
                   "rules": rules_launches.get(record["name"], 0),
                   "tiers": tiers_launches.get(record["name"], 0),
                   "uplinks": uplinks_launches.get(record["name"], 0),
                   "rounds": rounds_launches.get(record["name"], 0),
                   "failover": failover_launches.get(record["name"], 0)}
        rows.append((record["name"], "flash_bwd.cu", line, record,
                     sum(by_path.values()), by_path))
    # the wide-heads path, a row per head dim and wrapper: its launches in
    # that case's run beside the case measured at the same B·H·L·D
    wide_by_case = (wide or {}).get("cases", {})
    # other shapes' cases of a wide-heads row's wrapper, by (label,
    # wrapper): (key, record): the card-filling D = 512 bf16 cases and
    # D = 256 fp32 K1, the ragged fp32 K1, and the fp32 K1 and its combine
    # at B1·Hq4·L512·D512
    other_shapes = {("d512_bf16", r["name"]): [("at_card_filling_shape", r)]
                    for r in full_cases[1] or []}
    for label, wrapper, key, record in (
            ("d512_bf16", "flash_fwd_general_mma", "at_card_filling_shape",
             full_cases[0]),
            ("d256_fp32", "flash_fwd_general", "at_card_filling_shape",
             full_fp32),
            ("d256_fp32", "flash_fwd_general", "at_ragged_shape",
             ragged_fp32),
            ("d512_fp32", "flash_fwd_general", "at_b1_hq4_l512_shape",
             d512_fwd.get("fp32")),
            ("d512_fp32", COMBINE, "at_b1_hq4_l512_shape", d512_combine),
            ("d512_fp32", DQ_SUM, "at_b1_hq4_l512_shape", d512_dq_sum)):
        if record is not None:
            other_shapes.setdefault((label, wrapper), []).append(
                (key, record))
    # K1, K2 and K3 on their D = 16 and 32 builds at the small-D cases'
    # shapes
    for label, key, case in (
            ("d16_bf16", "at_long_context_d16_shape", "long_context_d16"),
            ("d16_bf16", "at_d8_shape", "d8"),
            ("d32_bf16", "at_d32_shape", "d32")):
        fwd_record, bwd_records = small_d.get(case, (None, None))
        for wrapper, record in (
                ("flash_attention_fwd", fwd_record),
                ("flash_bwd_dq", (bwd_records or [None, None])[0]),
                ("flash_bwd_dkv", (bwd_records or [None, None])[1])):
            if record is not None:
                other_shapes.setdefault((label, wrapper), []).append(
                    (key, record))
    # K1, K2 and K3 on their D = 256 builds at the B2·Hq16·Hkv4·L1024 case
    for wrapper, record in ([("flash_attention_fwd", d256_fwd)] + [
            (r["name"], r) for r in d256_bwd or []]):
        if record is not None:
            other_shapes.setdefault(("d256_bf16", wrapper), []).append(
                ("at_d256_shape", record))
    # the fp32 K2 and K3 at the card-filling D = 256, ragged D = 128 and
    # B1·Hq4·L512·D512 shapes
    for label, key, records in (
            ("d256_fp32", "at_card_filling_shape", full_bwd_fp32),
            ("d256_fp32", "at_ragged_shape", ragged_bwd),
            ("d512_fp32", "at_b1_hq4_l512_shape", d512_bwd.get("fp32"))):
        for record in records or []:
            other_shapes.setdefault((label, record["name"]), []).append(
                (key, record))
    expected_rows = 3
    for label, _, _, fwd, bwd in WIDE_CASES:
        fwd_record, bwd_records, sum_record, combine_record, dq_sum_record = (
            wide_cases[label])
        launched = wide_by_case.get(label, {}).get("launches", {})
        expected_rows += 3 + sum(r is not None for r in (
            sum_record, combine_record, dq_sum_record))
        for wrapper, record, source, line in (
                (fwd, fwd_record, "flash_fwd.cu", 76),
                (COMBINE, combine_record, "flash_fwd.cu", 76),
                (bwd[0], (bwd_records or [None])[0], "flash_bwd.cu", 126),
                (DQ_SUM, dq_sum_record, "flash_bwd.cu", 126),
                (bwd[1], (bwd_records or [None, None])[1], "flash_bwd.cu",
                 162),
                (SPLIT_SUM, sum_record, "flash_bwd.cu", 162)):
            if record is None:
                continue
            by_path = {"wide_heads": launched.get(wrapper, 0)}
            name = ROW_NAMES.get(wrapper, wrapper) + "_" + label
            record = dict(record, wrapper=wrapper)
            for key, other in other_shapes.get((label, wrapper), []):
                record[key] = {
                    k: other[k] for k in (
                        "shape", "causal", "max_abs_err", "kernel_ms",
                        "kernel_device_ms", "kernel_host_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "library_device_ms", "library_kernels", "tflops",
                        "device_kernels", "call_kernels", "per_slab",
                        "slabs")
                    if k in other}
            rows.append((name, source, line, record,
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
            "library_kernels": record["library_kernels"],
            "shape": record["shape"], "dtype": record["dtype"],
        }
        if "wrapper" in record:
            entry["wrapper"] = record["wrapper"]
        for key in ("at_card_filling_shape", "at_ragged_shape",
                    "at_b1_hq4_l512_shape", "at_long_context_d16_shape",
                    "at_d8_shape", "at_d32_shape", "at_d256_shape"):
            if key in record:
                entry[key] = record[key]
        if "case" in record and record["name"] not in SECOND_LAUNCHES:
            # K2/K3: SDPA's one backward call covers both
            entry["library_covers"] = "flash_bwd_dq+flash_bwd_dkv"
        for key in ("device_kernels", "per_slab", "slabs", "scratch_bytes"):
            if key in record:
                entry[key] = record[key]
        if name == "flash_fwd" and train_case is None:
            smoke.failures.append("flash_fwd has no training-shape row")
        elif name == "flash_fwd":
            entry["at_training_shape"] = {
                key: train_case[key] for key in (
                    "shape", "max_abs_err", "kernel_ms", "kernel_device_ms",
                    "kernel_host_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "library_kernels",
                    "tflops", "tflops_device")}
        kernels.append(entry)
        for path, count in by_path.items():
            if not count:
                smoke.failures.append(f"{name} was not launched on the "
                                      f"{path} path")
    if len(kernels) < expected_rows:
        smoke.failures.append("a kernel of the path has no measured row")
    print(f"phases done in {time.perf_counter() - started:.3f} s")
    print(json.dumps({"setup": SETUP}))
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
