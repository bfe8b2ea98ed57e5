"""Controller process: ``python -m metisfl_tpu_torch.controller``.

The port's copy of the JAX package's ``controller/__main__.py``. The
configuration arrives as one file, a codec-serialized ``FederationConfig``
(``.bin``, what ``DriverSession`` writes) or YAML. The controller serves on
``--port`` (else the config's ``controller_port``; 0 binds an ephemeral
port) and prints ``METISFL_TPU_CONTROLLER_READY port=<port>`` once it
serves. ``--device`` (default ``cuda``) is where the robust rules
combine the cohort; a robust rule on ``cuda`` with no GPU refuses to
start. Under ``secure.enabled`` it builds the controller's keyless
secure backend (masking: the party count, from ``secure.num_parties`` or
the configured learners). SIGTERM, SIGINT or the ShutDown RPC stop it. The whole config
reaches the controller, its ``model_store`` block included: the store
(in memory, disk, cached disk, or a ``python -m
metisfl_tpu_torch.store.server`` at ``host``:``port``) and the ingest
writers are built in this process.

A ``METISFL_TPU_CHAOS`` spec in the environment arms the chaos injector
(metisfl_tpu_torch/chaos) at start.

Not ported: ``--standby`` (the hot standby) and ``--resume`` (restore from
a checkpoint), ROADMAP.md Queue 1 item 3f.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from metisfl_tpu_torch import chaos
from metisfl_tpu_torch.config import FederationConfig, load_config
from metisfl_tpu_torch.config.federation import not_ported
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.controller.service import (
    ControllerServer,
    RpcLearnerProxy,
)
from metisfl_tpu_torch.secure import make_backend


def secure_backend_of(config, parser):
    """The controller's secure backend (None without secure aggregation):
    it can combine payloads and never decrypt them."""
    if not config.secure.enabled:
        return None
    kwargs = {}
    if config.secure.scheme == "masking":
        num_parties = config.secure.num_parties or len(config.learners)
        if num_parties <= 0:
            parser.error("masking secure aggregation needs "
                         "secure.num_parties (the driver fills it in) or a "
                         "configured learner list")
        kwargs["num_parties"] = num_parties
    return make_backend(config.secure, role="controller", **kwargs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch.controller")
    parser.add_argument("--config", required=True,
                        help="FederationConfig file (.bin codec or .yaml)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=None,
                        help="overrides the config's controller_port "
                             "(0 = an ephemeral port)")
    parser.add_argument("--device", default="cuda",
                        help="where the robust rules combine the cohort "
                             "(cuda or cpu)")
    parser.add_argument("--resume", action="store_true",
                        help="not ported (ROADMAP.md Queue 1 item 3f)")
    parser.add_argument("--standby", action="store_true",
                        help="not ported (ROADMAP.md Queue 1 item 3f)")
    args = parser.parse_args(argv)
    if args.standby:
        raise not_ported("the controller hot standby (--standby)", "3f")
    if args.resume:
        raise not_ported("restoring a checkpoint (--resume)", "3f")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    chaos.install_from_env()
    if args.config.endswith((".yaml", ".yml")):
        config = load_config(args.config)
    else:
        with open(args.config, "rb") as f:
            config = FederationConfig.from_wire(f.read())
    controller = Controller(config, lambda record: RpcLearnerProxy(
        record, ssl=config.ssl, comm=config.comm), device=args.device,
        secure_backend=secure_backend_of(config, parser))
    server = ControllerServer(
        controller, host=args.host,
        port=config.controller_port if args.port is None else args.port,
        ssl=config.ssl)
    port = server.start()
    print(f"METISFL_TPU_CONTROLLER_READY port={port}", flush=True)
    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    server.wait_for_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
