#!/usr/bin/env python3
"""Chip smoke for metisfl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It drives the port only (it imports no jax and nothing of the JAX package):

1. device: the GPU's name and power limit, torch and CUDA versions; TF32
   off for matmuls and cuDNN, so fp32 stays fp32;
2. build: every CUDA kernel of the port from ``metisfl_tpu_torch/csrc``
   with nvcc, one process per source, timed;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the serving path's shape and at a ragged fp32 shape, with the
   tolerance stated, timed beside its bound and one PyTorch library call
   that computes the same function (a yardstick the port never calls);
4. slice: a full-width LlamaLite (vocab 32768, dim 1024, depth 8, heads 16,
   kv_heads 4, bf16 compute, flash attention) with seeded random weights,
   packed into a ModelBlob and installed in a ``ServingGateway``; 8
   concurrent Predict requests of 1024 tokens go through the flash kernel
   (the launch count is checked per forward) and one reply is held against
   the same module on the dense path; 4 concurrent Generate requests
   decode 64 tokens each through the continuous batcher and are compared
   with a solo ``generate`` per request.

It prints a ``{"kernels": [...]}`` line, the GPU's name and power limit,
and, when every phase passed, ``{"ok": true, "device": {...}}`` as its last
line. It exits non-zero without a GPU, or outside a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
DEVICE = "cuda"

# the serving slice's model (the JAX package's bench_decode/bench_mfu shape)
VOCAB, DIM, DEPTH, HEADS, KV_HEADS = 32768, 1024, 8, 16, 4
PREDICT_REQUESTS, PREDICT_LEN = 8, 1024
GEN_REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 64
MAX_BATCH, SLOTS, MAX_LEN = 4, 4, 512
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


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 - recorded, the run goes on
            traceback.print_exc()
            self.failures.append(f"{name}: raised")
            return None


def attention_case(smoke, name, B, Hq, Hkv, L, D, dtype_name, causal,
                   o_atol, lse_atol):
    """One kernel-vs-plain comparison, timed; returns its record."""
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
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    o_err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    smoke.check(bool(torch.isfinite(o).all()) and o_err <= o_atol
                and lse_err <= lse_atol,
                f"{name}: o err {o_err:.3g} <= {o_atol}, lse err "
                f"{lse_err:.3g} <= {lse_atol}")

    kernel_ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal))
    plain_ms = time_ms(lambda: flash_attention_fwd_reference(q, k, v,
                                                             causal),
                       iters=5)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=Hq != Hkv)

    try:
        library_ms = time_ms(library)
    except (TypeError, RuntimeError) as exc:
        print(f"library call unavailable: {exc}")
        library_ms = None

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
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms, "flops": flops, "bytes": nbytes,
    }
    print(json.dumps({"kernel_case": record}), flush=True)
    return record


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


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def profile_call(fn):
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
                     "share": ms / device_ms} for ms, k, c in rows[:8]]}


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
        for name, log in build.build_logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        return libs

    if smoke.phase("build", build_kernels) is None:
        print("\n".join(smoke.failures), file=sys.stderr)
        return 1

    main_case = smoke.phase(
        "kernel vs plain: flash_fwd at the serving shape", attention_case,
        smoke, "flash_fwd", 4, 16, 4, 1024, 64, "bfloat16", True, 2e-2, 1e-3)
    smoke.phase("kernel vs plain: flash_fwd ragged fp32 D=128",
                attention_case, smoke, "flash_fwd_ragged_fp32", 2, 8, 8,
                1000, 128, "float32", False, 1e-4, 1e-4)
    sliced = smoke.phase("slice: Predict and Generate through the gateway",
                         slice_phase, smoke, gpu)

    kernels = []
    if main_case is not None:
        kernels.append({
            "name": "flash_fwd", "route": "cuda",
            "source": "metisfl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "metisfl_tpu/ops/flash_attention.py:76",
            "launches": (sliced or {}).get("flash_launches", 0),
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
    if kernels and sliced is not None and not kernels[0]["launches"]:
        smoke.failures.append("flash_fwd was not launched on the main path")
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
