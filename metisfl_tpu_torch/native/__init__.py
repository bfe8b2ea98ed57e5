"""Native (C++) host components, built with ``g++`` at first use (the
port's copy of the JAX package's ``native/__init__.py``).

- ``hostfold.cc``: the streaming weighted fold of host-path aggregation
  (``aggregation/base.py``);
- ``ckks.cc``: the coefficient-packed RLWE scheme of CKKS secure
  aggregation (``secure/ckks.py``). The port never loads the JAX
  package's prebuilt copy: it builds its own.

Each library builds into ``build/metisfl_tpu_torch/`` beside the package
with the JAX package's flags (``-O3 -std=c++17 -march=native -shared
-fPIC -fopenmp``) and is loaded with ``ctypes``. A library is rebuilt when
its source, the flags or the host CPU's feature flags change (a sha256
stamp sits next to it): ``-march=native`` code built on another CPU may
use instructions this one lacks. The compile goes to a unique temp file
that ``os.replace`` moves into place, so concurrent builds (learner
processes) race safely. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

from metisfl_tpu_torch.ops.build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs: dict = {}

BUILD_FLAGS = ("-O3", "-std=c++17", "-march=native", "-shared", "-fPIC",
               "-fopenmp")


def _host_cpu_id() -> str:
    """The host CPU's feature flags, hashed (the machine's name where
    /proc/cpuinfo has none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha256(line.encode()).hexdigest()[:16]
    except OSError:
        pass
    return platform.machine()


def _cache_key(src: str) -> str:
    """Source + build flags + host CPU identity."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(BUILD_FLAGS).encode())
    h.update(_host_cpu_id().encode())
    return h.hexdigest()


def _build(src: str, so: str, key: str) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        cmd = ["g++", *BUILD_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            # as the JAX package does: once more without -march=native,
            # for a toolchain that rejects it
            cmd.remove("-march=native")
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build of {os.path.basename(src)} "
                               f"failed:\n{proc.stderr}")
        os.replace(tmp, so)
        fd, tmp_key = tempfile.mkstemp(dir=os.path.dirname(so))
        with os.fdopen(fd, "w") as f:
            f.write(key)
        os.replace(tmp_key, so + ".srchash")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library_path(name: str) -> str:
    return os.path.join(str(BUILD_DIR), f"libmetisfl_{name}.so")


def _load(name: str) -> ctypes.CDLL:
    """Build ``<name>.cc`` where its stamp is stale, then dlopen it. Call
    with ``_lock`` held. Raises ``RuntimeError`` (or ``OSError``) where
    g++ is missing or the build fails."""
    src = os.path.join(_DIR, f"{name}.cc")
    so = library_path(name)
    key = _cache_key(src)
    try:
        with open(so + ".srchash") as f:
            fresh = os.path.exists(so) and f.read().strip() == key
    except OSError:
        fresh = False
    if not fresh:
        _build(src, so, key)
    return ctypes.CDLL(so)


def load_hostfold() -> ctypes.CDLL:
    """The host-aggregation fold library with typed signatures."""
    with _lock:
        if "hostfold" in _libs:
            return _libs["hostfold"]
        lib = _load("hostfold")
        for fn, ctype in ((lib.hostfold_f32, ctypes.c_float),
                          (lib.hostfold_f64, ctypes.c_double)):
            fn.restype = None
            fn.argtypes = [ctypes.POINTER(ctype),
                           ctypes.POINTER(ctypes.POINTER(ctype)),
                           ctypes.POINTER(ctypes.c_double),
                           ctypes.c_long, ctypes.c_long, ctypes.c_int]
        lib.hostfold_selftest.restype = ctypes.c_int
        _libs["hostfold"] = lib
        return lib


def load_ckks() -> ctypes.CDLL:
    """The CKKS library with typed signatures."""
    with _lock:
        if "ckks" in _libs:
            return _libs["ckks"]
        lib = _load("ckks")
        lib.ckks_n.restype = ctypes.c_long
        lib.ckks_ciphertext_size.restype = ctypes.c_long
        lib.ckks_ciphertext_size.argtypes = [ctypes.c_long]
        lib.ckks_keygen.restype = ctypes.c_int
        lib.ckks_keygen.argtypes = [ctypes.c_char_p]
        lib.ckks_open.restype = ctypes.c_void_p
        lib.ckks_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ckks_close.argtypes = [ctypes.c_void_p]
        lib.ckks_has_secret.restype = ctypes.c_int
        lib.ckks_has_secret.argtypes = [ctypes.c_void_p]
        lib.ckks_encrypt.restype = ctypes.c_long
        lib.ckks_encrypt.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
        lib.ckks_weighted_sum.restype = ctypes.c_long
        lib.ckks_weighted_sum.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
        lib.ckks_decrypt.restype = ctypes.c_long
        lib.ckks_decrypt.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.ckks_selftest.restype = ctypes.c_int
        _libs["ckks"] = lib
        return lib
