"""The port stands alone: importing every metisfl_tpu_torch module pulls in
neither jax nor any module of the JAX package, and no source file names
them (the gRPC service names the two packages share on the wire aside)."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import metisfl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "metisfl_tpu_torch")


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(
        metisfl_tpu_torch.__path__, "metisfl_tpu_torch."))


def test_every_module_imports_without_jax():
    names = _module_names()
    assert {"metisfl_tpu_torch.ops.flash_attention",
            "metisfl_tpu_torch.serving.gateway",
            "metisfl_tpu_torch.models.convert",
            "metisfl_tpu_torch.models.zoo.mlp",
            "metisfl_tpu_torch.models.zoo.cnn",
            "metisfl_tpu_torch.config.federation",
            "metisfl_tpu_torch.aggregation.base",
            "metisfl_tpu_torch.aggregation.fedavg",
            "metisfl_tpu_torch.scaling",
            "metisfl_tpu_torch.selection",
            "metisfl_tpu_torch.scheduling",
            "metisfl_tpu_torch.store.base",
            "metisfl_tpu_torch.store.memory",
            "metisfl_tpu_torch.learner.learner",
            "metisfl_tpu_torch.controller.core",
            "metisfl_tpu_torch.driver.inprocess",
            "metisfl_tpu_torch.comm.codec",
            "metisfl_tpu_torch.comm.messages",
            "metisfl_tpu_torch.comm.health",
            "metisfl_tpu_torch.comm.ssl",
            "metisfl_tpu_torch.comm.rpc",
            "metisfl_tpu_torch.controller.service",
            "metisfl_tpu_torch.controller.__main__",
            "metisfl_tpu_torch.learner.service",
            "metisfl_tpu_torch.learner.__main__",
            "metisfl_tpu_torch.driver.session",
            "metisfl_tpu_torch.native",
            "metisfl_tpu_torch.store.durable",
            "metisfl_tpu_torch.store.disk",
            "metisfl_tpu_torch.store.cached",
            "metisfl_tpu_torch.store.ingest",
            "metisfl_tpu_torch.store.remote",
            "metisfl_tpu_torch.store.server",
            "metisfl_tpu_torch.telemetry.sketch",
            "metisfl_tpu_torch.aggregation.slice",
            "metisfl_tpu_torch.aggregation.distributed",
            "metisfl_tpu_torch.tensor.quantize",
            "metisfl_tpu_torch.tensor.sparse",
            "metisfl_tpu_torch.secure.dp",
            "metisfl_tpu_torch.chaos",
            "metisfl_tpu_torch.chaos.injector",
            "metisfl_tpu_torch.driver.crossdevice",
            "metisfl_tpu_torch.controller.wal",
            "metisfl_tpu_torch.registry",
            "metisfl_tpu_torch.registry.registry",
            "metisfl_tpu_torch.driver.ha_smoke",
            "metisfl_tpu_torch.telemetry",
            "metisfl_tpu_torch.telemetry.__main__",
            "metisfl_tpu_torch.telemetry.metrics",
            "metisfl_tpu_torch.telemetry.trace",
            "metisfl_tpu_torch.telemetry.events",
            "metisfl_tpu_torch.telemetry.health",
            "metisfl_tpu_torch.telemetry.postmortem",
            "metisfl_tpu_torch.telemetry.httpd",
            "metisfl_tpu_torch.telemetry.profile",
            "metisfl_tpu_torch.telemetry.timeseries",
            "metisfl_tpu_torch.telemetry.alerts",
            "metisfl_tpu_torch.serving",
            "metisfl_tpu_torch.serving.service",
            "metisfl_tpu_torch.serving.fleet",
            "metisfl_tpu_torch.serving.smoke",
            "metisfl_tpu_torch.serving.__main__",
            "metisfl_tpu_torch.stats"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                           'metisfl_tpu'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_reference_neither_jax_nor_the_jax_package():
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b",
                            re.M)
    # the gRPC service names ("metisfl_tpu.Controller", "metisfl_tpu.Learner",
    # "metisfl_tpu.SliceAggregator", "metisfl_tpu.Serving") are wire names
    # the two packages share, not references to the package
    jax_package = re.compile(
        r"\bmetisfl_tpu\.(?!(Controller|Learner|SliceAggregator|Serving)"
        r"\b\")")
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(root, fname)
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                if jax_import.search(text) or jax_package.search(text):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "scripts/torch_kernel_turns.py",
                                    "scripts/torch_fwd_rows.py",
                                    "scripts/torch_round_turns.py"])
def test_card_scripts_reference_neither_jax_nor_the_jax_package(script):
    """The scripts that run on the card, where jax is not installed."""
    with open(os.path.join(REPO, script), encoding="utf-8") as fh:
        text = fh.read()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", text, re.M)
    assert not re.search(r"\bmetisfl_tpu\.", text)


def test_kernel_sources_ship_with_the_package():
    for name in ("flash_fwd", "flash_bwd"):
        assert os.path.exists(os.path.join(PKG_DIR, "csrc", f"{name}.cu"))
    assert os.path.exists(os.path.join(PKG_DIR, "native", "hostfold.cc"))
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as fh:
        text = fh.read()
    assert '"metisfl_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in text
    assert '"metisfl_tpu_torch.native" = ["*.cc"]' in text
