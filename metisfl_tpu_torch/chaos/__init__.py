"""Deterministic fault injection for the federation RPC stack.

The port's copy of the JAX package's ``chaos`` package: seeded,
reproducible fault profiles (drop → UNAVAILABLE, delay, hang, payload
corruption, process kill, periodic flap windows, a slow learner's
stretched train, timed partitions) hooked into :mod:`metisfl_tpu_torch.
comm.rpc` on the client and the server side of every bytes method (``slow``
is read by the learner's train loop instead).

Activation, as in the JAX package (one spec arms either package's
processes):

- the env var ``METISFL_TPU_CHAOS`` holding a JSON spec (or ``@/path`` to
  a JSON file), read once at process start: the driver arms controller,
  learner and slice processes this way;
- in process through :func:`configure`;
- the federation config's ``chaos`` section (config/federation.py
  ``ChaosConfig``), whose rules the driver filters per process.

When off, :func:`get` returns ``None`` and the rpc call sites do one
attribute read and an ``is None`` check.
"""

from metisfl_tpu_torch.chaos.injector import (
    ENV_VAR,
    ChaosInjector,
    FaultInjected,
    FaultRule,
    configure,
    get,
    install_from_env,
    reset,
)

__all__ = [
    "ENV_VAR",
    "ChaosInjector",
    "FaultInjected",
    "FaultRule",
    "configure",
    "get",
    "install_from_env",
    "reset",
]
