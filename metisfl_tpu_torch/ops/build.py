"""Build the port's CUDA kernels (``metisfl_tpu_torch/csrc/*.cu``) with
``nvcc`` into shared libraries with a plain C interface, loaded with
``ctypes``.

Each source compiles on its own (``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``) into
``build/metisfl_tpu_torch/lib<name>.so`` beside the package, at first use.
A library is rebuilt when its source, a header in ``csrc/`` or the flags
change (a sha256 stamp sits next to it). :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "metisfl_tpu_torch"
SOURCES = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per built source (ptxas register / shared-memory report)
build_logs: Dict[str, str] = {}
# wall seconds from the start of the parallel build to each nvcc's exit
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of metisfl_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def source_digest(src: Path) -> str:
    """sha256 over the source, every header (``*.cuh``) beside it and the
    flags: a library is stale when any of them changes."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    return src, lib, Path(str(lib) + ".srchash"), source_digest(src)


def _fresh(name: str) -> bool:
    _, lib, stamp, digest = _paths(name)
    return lib.exists() and stamp.exists() and stamp.read_text() == digest


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every stale source in parallel; returns name → library."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if _fresh(name):
            continue
        src, lib, _, _ = _paths(name)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = {}

    def wait(name, proc):
        results[name] = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (_, proc) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failures = []
    for name, (tmp, proc) in procs.items():
        out, err = results[name]
        build_logs[name] = out + err
        _, lib, stamp, digest = _paths(name)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        stamp.write_text(digest)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: _paths(name)[1] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first where needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
