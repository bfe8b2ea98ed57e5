"""Serving processes: ``python -m metisfl_tpu_torch.serving``.

The port's copy of the JAX package's ``serving/__main__.py``. Three roles
share this entry point:

- **Gateway replica** (default): booted by the driver like a learner. The
  model architecture arrives as a cloudpickled recipe (only its
  ``model_ops`` is used), the configuration as the federation config file.
  The engine runs where the recipe put it (``TorchModelOps`` defaults to
  ``cuda``); ``--device`` (default ``cuda``) names the device the caller
  expects, and a recipe whose engine is elsewhere is refused rather than
  served from there, as is a ``cuda`` request on a host without a GPU.
  The gateway polls the controller's registry (``DescribeRegistry``, over
  a ``ControllerClient`` that redials a promoted hot standby), installs
  the stable and candidate channel heads and serves ``Predict`` and
  ``Generate``. It prints ``METISFL_TPU_SERVING_READY port=<port>
  at=<unix time>`` once it serves. In a fleet, ``--replica-index`` and
  ``--replicas`` phase the registry polls (serving/fleet.py
  ``poll_stagger``), so a promotion rolls through the fleet one replica
  at a time. A relaunch after a crash needs no state of its own: its first
  poll pins it back to the promoted versions.
- **Router** (``--router``): the consistent-hash front of the fleet
  (serving/fleet.py); no model and no recipe. It forwards traffic to the
  replicas of ``serving.fleet.gateways``, health-probes them and prints
  ``METISFL_TPU_ROUTER_READY port=<port> at=<unix time>``. ``--device
  cuda`` (the default) refuses a host without a GPU, as the replicas do.
- **Fleet smoke** (``--fleet-smoke``): the replica-kill gate
  (serving/smoke.py) on ``--device`` (default ``cuda``); exit 0 = pass.

SIGTERM, SIGINT and the ``ShutDown`` RPC stop a gateway or router cleanly
(exit 0).
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import signal
import sys
import time

from metisfl_tpu_torch.config import FederationConfig, load_config


def _load_cfg(path: str) -> FederationConfig:
    if path.endswith((".yaml", ".yml")):
        return load_config(path)
    with open(path, "rb") as f:
        return FederationConfig.from_wire(f.read())


def _apply_telemetry(config, service: str) -> None:
    from metisfl_tpu_torch import telemetry
    telemetry.apply_config(
        config.telemetry, service=service,
        config_hash=hashlib.sha256(config.to_wire()).hexdigest()[:16])


def _flush_telemetry() -> None:
    from metisfl_tpu_torch import telemetry
    telemetry.trace.flush()
    telemetry.events.flush()


def run_router(config, host: str = "", port: int = -1) -> int:
    """The router process's main loop (``--router``)."""
    from metisfl_tpu_torch.serving.fleet import RouterServer, ServingRouter

    _apply_telemetry(config, service="router")
    router = ServingRouter(config.serving, ssl=config.ssl,
                           comm=config.comm)
    router.set_replicas(config.serving.fleet.gateways)
    server = RouterServer(
        router, host=host or config.serving.host,
        port=(config.serving.fleet.router_port if port < 0 else port),
        ssl=config.ssl)
    bound = server.start()
    print(f"METISFL_TPU_ROUTER_READY port={bound} at={time.time():.3f}",
          flush=True)

    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    server.wait_for_shutdown()
    _flush_telemetry()
    return 0


def run_gateway(config, recipe_path: str, device: str, host: str = "",
                port: int = -1, replica_index: int = 0,
                replicas: int = 1) -> int:
    """The gateway replica's main loop (the default role)."""
    import cloudpickle
    import torch

    from metisfl_tpu_torch.controller.service import ControllerClient
    from metisfl_tpu_torch.serving.fleet import poll_stagger
    from metisfl_tpu_torch.serving.gateway import (ControllerRegistrySource,
                                                   ServingGateway)
    from metisfl_tpu_torch.serving.service import ServingServer

    _apply_telemetry(config, service="serving")
    with open(recipe_path, "rb") as f:
        recipe = cloudpickle.load(f)
    model_ops = recipe()[0]
    if model_ops.device.type != torch.device(device).type:
        raise SystemExit(f"the recipe's engine is on {model_ops.device}, "
                         f"but --device is {device}")

    standby = config.controller.standby
    controller = ControllerClient(
        config.controller_host or "localhost", config.controller_port,
        ssl=config.ssl, comm=config.comm,
        # a controller failover must not strand the registry poller on the
        # dead primary's endpoint
        standby=((standby.host or "localhost", standby.port)
                 if standby.enabled else None))
    gateway = ServingGateway(
        model_ops, config.serving,
        ship_tensor_regex=config.train.ship_tensor_regex,
        device=model_ops.device)
    server = ServingServer(gateway, host=host or config.serving.host,
                           port=(config.serving.port if port < 0 else port),
                           ssl=config.ssl)
    bound = server.start()
    print(f"METISFL_TPU_SERVING_READY port={bound} at={time.time():.3f}",
          flush=True)
    gateway.start_sync(
        ControllerRegistrySource(controller),
        initial_delay_s=poll_stagger(replica_index, replicas,
                                     config.serving.poll_every_s))

    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    server.wait_for_shutdown()
    controller.close()
    _flush_telemetry()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch.serving")
    parser.add_argument("--config", default="",
                        help="path to FederationConfig (.bin codec or .yaml)")
    parser.add_argument("--recipe", default="",
                        help="cloudpickled callable -> (model_ops, ...); "
                             "only the engine is used (gateway role)")
    parser.add_argument("--device", default="cuda",
                        help="device the recipe's engine must be on (and "
                             "that a router or the fleet smoke needs)")
    parser.add_argument("--host", default="")
    parser.add_argument("--port", type=int, default=-1,
                        help="override config serving.port (-1: use config)")
    parser.add_argument("--router", action="store_true",
                        help="run the fleet router instead of a gateway "
                             "replica (no recipe needed)")
    parser.add_argument("--replica-index", type=int, default=0,
                        help="this replica's index in the fleet (registry-"
                             "poll stagger phase)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="fleet size for the poll stagger")
    parser.add_argument("--fleet-smoke", action="store_true",
                        help="run the replica-kill smoke (serving/smoke.py) "
                             "and exit 0/1")
    parser.add_argument("--smoke-replicas", type=int, default=3,
                        help="--fleet-smoke: replica count")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    # no quiet move to the CPU: a cuda request without a GPU exits non-zero
    from metisfl_tpu_torch.models.ops import resolve_device
    resolve_device(args.device)

    if args.fleet_smoke:
        from metisfl_tpu_torch.serving.smoke import run_fleet_smoke
        return run_fleet_smoke(replicas=args.smoke_replicas,
                               device=args.device)

    if not args.config:
        parser.error("--config is required")
    config = _load_cfg(args.config)
    if args.router:
        return run_router(config, host=args.host, port=args.port)
    if not args.recipe:
        parser.error("--recipe is required for the gateway role")
    return run_gateway(config, args.recipe, args.device, host=args.host,
                       port=args.port, replica_index=args.replica_index,
                       replicas=args.replicas)


if __name__ == "__main__":
    sys.exit(main())
