"""Learner process: ``python -m metisfl_tpu_torch.learner``.

The port's copy of the JAX package's ``learner/__main__.py``. The model
and the data arrive as a cloudpickled recipe: a zero-argument callable
returning ``(model_ops, train_ds, val_ds, test_ds[, secure_backend])``,
run in this process. Without a backend in the recipe, ``--secure-config``
names the secure-aggregation material the driver wrote for this learner
(a codec file: the scheme, the CKKS key directory, or the masking
secret and party index).
The engine runs where the recipe put it (``TorchModelOps`` defaults to
``cuda``); ``--device`` (default ``cuda``) names the device the caller
expects, and a recipe whose engine is elsewhere is refused rather than
run there.

The learner binds ``--port`` (0 = ephemeral), prints
``METISFL_TPU_LEARNER_READY port=<port>``, (with ``--wait-for-model``,
once the controller holds a community model) joins the controller and
prints ``METISFL_TPU_LEARNER_JOINED id=<id> rejoined=<bool>``; it serves
until a ShutDown RPC, SIGTERM or SIGINT, and leaves the federation on
the way out. Its identity (learner id and token) persists in
``--credentials-dir``, so a restarted learner rejoins as itself; it is
saved again after every re-attach (a controller that lost its registry
hands out a new id, which the next restart must present).
``--standby-host``/``--standby-port`` name the controller's hot standby:
a call that spends its UNAVAILABLE retries on the primary is re-issued
against whichever endpoint answers SERVING.

A ``METISFL_TPU_CHAOS`` spec in the environment arms the chaos injector
(metisfl_tpu_torch/chaos) at start; its ``slow`` rules stretch each train
task.

Telemetry: ``--telemetry-dir`` is the span and event sink (the driver
points it at ``<workdir>/telemetry``), ``--postmortem-dir`` arms the
flight recorder (a chaos kill or a crash leaves a bundle there),
``--telemetry-off`` and ``--events-off`` forward the config's switches,
and ``--metrics-port`` > 0 serves ``/metrics`` over plain HTTP beside the
``GetMetrics`` RPC.

Not ported: multi-host learners (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import sys
import time

import cloudpickle
import torch

from metisfl_tpu_torch import chaos, telemetry
from metisfl_tpu_torch.comm.codec import loads as codec_loads
from metisfl_tpu_torch.comm.ssl import SSLConfig
from metisfl_tpu_torch.config import CommConfig, SecureAggConfig
from metisfl_tpu_torch.config.federation import EventsConfig, TelemetryConfig
from metisfl_tpu_torch.controller.service import ControllerClient
from metisfl_tpu_torch.learner.learner import Learner
from metisfl_tpu_torch.learner.service import LearnerServer
from metisfl_tpu_torch.secure import make_backend

_CREDS_NAME = "credentials.json"
logger = logging.getLogger("metisfl_tpu_torch.learner")


def load_credentials(creds_dir: str) -> tuple[str, str]:
    """(learner_id, auth_token) of a previous run, or ("", "")."""
    try:
        with open(os.path.join(creds_dir, _CREDS_NAME)) as f:
            data = json.load(f)
        return str(data.get("learner_id", "")), str(data.get("auth_token",
                                                             ""))
    except (OSError, ValueError):
        return "", ""


def save_credentials(creds_dir: str, learner_id: str,
                     auth_token: str) -> None:
    os.makedirs(creds_dir, exist_ok=True)
    path = os.path.join(creds_dir, _CREDS_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"learner_id": learner_id, "auth_token": auth_token}, f)
    os.chmod(tmp, 0o600)
    os.replace(tmp, path)


def wait_for_model(controller, timeout_s: float = 600.0,
                   poll_s: float = 0.2) -> None:
    """Block until the controller answers with a community model (a join
    before the seed model would get no task), at most ``timeout_s``."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            if controller.describe_federation(timeout=10.0).get(
                    "community_model_bytes"):
                return
        except Exception:  # noqa: BLE001 - not serving yet: poll again
            pass
        time.sleep(poll_s)
    logger.warning("no community model after %.0f s; joining anyway",
                   timeout_s)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch.learner")
    parser.add_argument("--controller-host", default="localhost")
    parser.add_argument("--controller-port", type=int, required=True)
    parser.add_argument("--standby-host", default="",
                        help="the controller's hot standby: a call that "
                             "spends its UNAVAILABLE retries re-resolves to "
                             "whichever endpoint answers SERVING")
    parser.add_argument("--standby-port", type=int, default=0)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--advertise-host", default="",
                        help="hostname the controller dials back")
    parser.add_argument("--port", type=int, default=0,
                        help="0 binds an ephemeral port (reported to the "
                             "controller on join)")
    parser.add_argument("--recipe", required=True,
                        help="cloudpickled callable -> (ops, train, val, "
                             "test)")
    parser.add_argument("--device", default="cuda",
                        help="device the recipe's engine must be on")
    parser.add_argument("--credentials-dir", default="",
                        help="persist learner_id/auth_token here for "
                             "restarts")
    parser.add_argument("--secure-config", default="",
                        help="this learner's secure-aggregation material "
                             "(written by the driver)")
    parser.add_argument("--ssl-cert", default="",
                        help="federation TLS cert (enables TLS)")
    parser.add_argument("--ssl-key", default="")
    parser.add_argument("--wait-for-model", action="store_true",
                        help="join only once the controller holds a "
                             "community model (a learner booted beside "
                             "its controller)")
    parser.add_argument("--rpc-deadline-s", type=float, default=None,
                        help="default RPC deadline toward the controller "
                             "(<= 0 = unbounded; omitted = the transport's "
                             "default)")
    parser.add_argument("--rpc-retries", type=int, default=None,
                        help="UNAVAILABLE retries of a call toward the "
                             "controller, and probe rounds of a redial "
                             "(omitted = the transport's default)")
    parser.add_argument("--rpc-retry-sleep-s", type=float, default=None,
                        help="seconds between those retries")
    parser.add_argument("--telemetry-dir", default="",
                        help="span and event sink directory (the driver "
                             "points this at <workdir>/telemetry)")
    parser.add_argument("--telemetry-off", action="store_true",
                        help="no spans, metrics or events (the config's "
                             "telemetry.enabled=false, forwarded by the "
                             "driver)")
    parser.add_argument("--events-off", action="store_true",
                        help="no event journal (telemetry.events.enabled="
                             "false)")
    parser.add_argument("--postmortem-dir", default="",
                        help="post-mortem bundle directory (the driver "
                             "points this at <workdir>/postmortem)")
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="plain-HTTP /metrics port (0 = off; GetMetrics "
                             "answers either way)")
    args = parser.parse_args(argv)
    # stopped before it serves (loading the recipe takes seconds), the
    # learner has nothing to leave or drain: exit at once, cleanly
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))

    telemetry.apply_config(
        TelemetryConfig(enabled=not args.telemetry_off,
                        dir=args.telemetry_dir,
                        events=EventsConfig(enabled=not args.events_off),
                        postmortem_dir=args.postmortem_dir),
        service=f"learner-{args.port or os.getpid()}")
    metrics_http = None
    if not args.telemetry_off and args.metrics_port > 0:
        from metisfl_tpu_torch.telemetry.httpd import start_metrics_http
        metrics_http = start_metrics_http(args.metrics_port, host=args.host)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    chaos.install_from_env()
    unported = telemetry.unported_planes(TelemetryConfig(
        enabled=not args.telemetry_off))
    if unported:
        logger.info("telemetry planes %s are not ported to metisfl_tpu_torch "
                    "yet (ROADMAP.md Queue 1 item 4b); nothing depends on "
                    "them", ", ".join(unported))

    with open(args.recipe, "rb") as f:
        recipe = cloudpickle.load(f)
    built = recipe()
    model_ops, train_ds = built[0], built[1]
    val_ds = built[2] if len(built) > 2 else None
    test_ds = built[3] if len(built) > 3 else None
    secure_backend = built[4] if len(built) > 4 else None
    if secure_backend is None and args.secure_config:
        with open(args.secure_config, "rb") as f:
            sc = codec_loads(f.read())
        secure_backend = make_backend(
            SecureAggConfig(enabled=True, scheme=sc["scheme"],
                            key_dir=sc.get("key_dir", "")),
            role="learner", **sc.get("kwargs", {}))
    want = torch.device(args.device)
    if model_ops.device.type != want.type:
        parser.error(f"the recipe's engine is on {model_ops.device}, but "
                     f"--device is {args.device}")

    ssl = None
    if args.ssl_cert:
        ssl = SSLConfig(enabled=True, cert_path=args.ssl_cert,
                        key_path=args.ssl_key)
    previous_id, auth_token = "", ""
    if args.credentials_dir:
        previous_id, auth_token = load_credentials(args.credentials_dir)
        if previous_id:
            logger.info("found persisted credentials for %s; rejoining",
                        previous_id)
    comm = None
    if (args.rpc_deadline_s, args.rpc_retries,
            args.rpc_retry_sleep_s) != (None, None, None):
        # the config's comm section, as the driver forwards it
        defaults = CommConfig()
        comm = CommConfig(
            default_deadline_s=(defaults.default_deadline_s
                                if args.rpc_deadline_s is None
                                else args.rpc_deadline_s),
            retries=(defaults.retries if args.rpc_retries is None
                     else args.rpc_retries),
            retry_sleep_s=(defaults.retry_sleep_s
                           if args.rpc_retry_sleep_s is None
                           else args.rpc_retry_sleep_s))
    controller = ControllerClient(
        args.controller_host, args.controller_port, ssl=ssl, comm=comm,
        standby=((args.standby_host or "localhost", args.standby_port)
                 if args.standby_port else None))
    learner = Learner(
        model_ops=model_ops,
        train_dataset=train_ds,
        val_dataset=val_ds,
        test_dataset=test_ds,
        hostname=args.advertise_host or socket.gethostname(),
        controller=controller,
        secure_backend=secure_backend,
    )
    server = LearnerServer(learner, host=args.host, port=args.port, ssl=ssl)
    port = server.start()
    print(f"METISFL_TPU_LEARNER_READY port={port}", flush=True)
    if args.credentials_dir:
        learner.on_join = lambda reply: save_credentials(
            args.credentials_dir, reply.learner_id, reply.auth_token)
    try:
        if args.wait_for_model:
            wait_for_model(controller)
        reply = learner.join_federation(previous_id=previous_id,
                                        auth_token=auth_token)
        if args.credentials_dir:
            save_credentials(args.credentials_dir, reply.learner_id,
                             reply.auth_token)
        print(f"METISFL_TPU_LEARNER_JOINED id={reply.learner_id} "
              f"rejoined={reply.rejoined}", flush=True)

        def _on_signal(signum, _frame):
            logger.info("received signal %d; shutting down", signum)
            server.stop()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        server.wait_for_shutdown()
    except BaseException:
        server.stop(leave=False)
        raise
    finally:
        controller.close()
        if metrics_http is not None:
            metrics_http.close()
        telemetry.trace.flush()
        telemetry.events.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
