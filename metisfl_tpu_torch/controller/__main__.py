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

``--resume`` restores the controller from ``checkpoint.dir`` before it
serves (the community model, the round counter, the learner registry with
its tokens, the rules' state, the model registry) and, once it serves,
re-dispatches the abandoned round; with no checkpoint there it starts
fresh at round 0. The driver relaunches a dead controller so.

``--standby`` runs the warm hot standby instead: it tails the primary's
round-state WAL (controller/wal.py) under ``controller.standby.wal_dir``,
answers grpc.health.v1 SERVING for the server and NOT_SERVING for the
controller service (alive, not promoted), and promotes once the WAL tail
is stale for ``stale_after_s`` and ``probe_failures`` health probes of the
primary in a row come back non-SERVING: it restores the WAL state into a
controller built as the primary's (the same rule, secure backend and
registry), serves it on its own pinned port (every peer knows both
endpoints), prints ``METISFL_TPU_CONTROLLER_PROMOTED port=<port>`` and
re-dispatches the abandoned round. It prints
``METISFL_TPU_CONTROLLER_STANDBY_READY port=<port>`` once it tails, and
exits 0 on SIGTERM while warm. The standby keeps the WAL-lag gauge, and a
promotion counts ``controller_failover_total{role="standby"}``, observes
the promote seconds and emits ``ControllerFailover``.

Telemetry: the config's ``telemetry`` section is applied at start
(``telemetry.apply_config``: metrics, spans and events into
``telemetry.dir``, post-mortems into ``telemetry.postmortem_dir``), and
``telemetry.http_port`` > 0 serves ``/metrics`` over plain HTTP. The
planes the port does not run yet (the fleet fabric, the stack sampler,
the runtime plane; ROADMAP.md Queue 1 item 4b) are named once in the log
when the config turns them on.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import signal
import sys
import threading
import time

from metisfl_tpu_torch import chaos
from metisfl_tpu_torch import telemetry
from metisfl_tpu_torch.config import FederationConfig, load_config
from metisfl_tpu_torch.controller.core import Controller
from metisfl_tpu_torch.controller.service import (
    CONTROLLER_SERVICE,
    ControllerServer,
    RpcLearnerProxy,
)
from metisfl_tpu_torch.secure import make_backend
from metisfl_tpu_torch.telemetry import events as tevents
from metisfl_tpu_torch.telemetry import metrics as tmetrics


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


def build_controller(config, parser, device: str) -> Controller:
    """The controller as the primary builds it: a promoted standby must
    run the same rule, secure and registry stack, or its re-run round
    could not give the same bits."""
    return Controller(config, lambda record: RpcLearnerProxy(
        record, ssl=config.ssl, comm=config.comm), device=device,
        secure_backend=secure_backend_of(config, parser))


def _serve(server: ControllerServer) -> None:
    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    server.wait_for_shutdown()


def start_telemetry(config, service: str, host: str):
    """Apply the config's telemetry section to this process; returns the
    ``/metrics`` listener (None without ``telemetry.http_port``)."""
    telemetry.apply_config(
        config.telemetry, service=service,
        config_hash=hashlib.sha256(config.to_wire()).hexdigest()[:16])
    unported = telemetry.unported_planes(config.telemetry)
    if unported:
        logging.getLogger("metisfl_tpu_torch.telemetry").info(
            "telemetry planes %s are on in the config and not ported to "
            "metisfl_tpu_torch yet (ROADMAP.md Queue 1 item 4b); nothing "
            "depends on them", ", ".join(unported))
    if config.telemetry.enabled and config.telemetry.http_port > 0:
        from metisfl_tpu_torch.telemetry.httpd import start_metrics_http
        return start_metrics_http(config.telemetry.http_port, host=host)
    return None


def stop_telemetry(metrics_http) -> None:
    if metrics_http is not None:
        metrics_http.close()
    telemetry.trace.flush()
    telemetry.events.flush()


def standby_main(args, config, parser, metrics_http=None) -> int:
    """The warm standby: tail, escalate, promote (module docstring)."""
    from metisfl_tpu_torch.comm.health import (
        NOT_SERVING,
        HealthServicer,
        probe_health,
    )
    from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
    from metisfl_tpu_torch.controller.wal import RoundStateLog

    standby = config.controller.standby
    if not (standby.enabled and standby.wal_dir):
        parser.error("--standby requires controller.standby.enabled and "
                     "controller.standby.wal_dir (the driver pins both)")
    log = logging.getLogger("metisfl_tpu_torch.controller.standby")
    wal = RoundStateLog(standby.wal_dir)
    # warm: a health-only server on the pinned port, the controller
    # service NOT_SERVING until promotion so nobody redials here early; a
    # role-tagged service without methods answers ListMethods
    health = HealthServicer()
    health.set_status(CONTROLLER_SERVICE, NOT_SERVING)
    idle = RpcServer(args.host, args.port or standby.port, ssl=config.ssl)
    idle.add_service(health.service())
    idle.add_service(BytesService(CONTROLLER_SERVICE, {}, role="standby"))
    port = idle.start()
    print(f"METISFL_TPU_CONTROLLER_STANDBY_READY port={port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    # WAL progress is the cheap liveness signal; only a stale tail
    # escalates to health probes, so a healthy primary costs one listdir a
    # tick and no RPC
    last_seq = wal.poll()
    last_progress = time.monotonic()
    failures = 0
    promoted = False
    # the records that landed in the primary's WAL inside one probe tick
    # (0 = caught up)
    lag_gauge = tmetrics.registry().gauge(
        telemetry.M_CONTROLLER_WAL_LAG_RECORDS,
        "Standby tail position behind the primary's WAL head (records "
        "observed landing per probe tick; 0 = caught up)")
    lag_gauge.set(0.0)
    while not stop.is_set():
        stop.wait(standby.probe_interval_s)
        if stop.is_set():
            break
        seq = wal.poll()
        lag_gauge.set(float(max(0, seq - last_seq)))
        if seq != last_seq:
            last_seq, last_progress, failures = seq, time.monotonic(), 0
            continue
        if time.monotonic() - last_progress < standby.stale_after_s:
            continue
        verdict = probe_health(config.controller_host,
                               config.controller_port, CONTROLLER_SERVICE,
                               ssl=config.ssl, comm=config.comm)
        if verdict == "SERVING":
            # healthy but quiet (a long round): keep tailing
            failures, last_progress = 0, time.monotonic()
            continue
        failures += 1
        log.warning("primary %s:%d %s after %.1fs of WAL stall (%d/%d "
                    "probe failures in a row)", config.controller_host,
                    config.controller_port, verdict,
                    time.monotonic() - last_progress, failures,
                    standby.probe_failures)
        if failures >= standby.probe_failures:
            promoted = True
            break
    if not promoted:  # a clean stop while warm
        idle.stop()
        stop_telemetry(metrics_http)
        return 0
    # promote: the full controller on the same pinned port (peers redial a
    # known endpoint); every client's bounded UNAVAILABLE retry covers the
    # gap between the two servers
    t0 = time.monotonic()
    idle.stop()
    log.warning("promoting: restoring the WAL round state from %s",
                standby.wal_dir)
    controller = build_controller(config, parser, args.device)
    restored = controller.restore_from_wal()
    server = ControllerServer(controller, host=args.host, port=port,
                              ssl=config.ssl)
    port = server.start()
    promote_s = time.monotonic() - t0
    n_learners = len(controller.active_learners())
    reg = tmetrics.registry()
    reg.counter(telemetry.M_CONTROLLER_FAILOVER_TOTAL,
                "Standby promotions to controller, by role of the "
                "emitting process", ("role",)).inc(role="standby")
    reg.histogram(telemetry.M_CONTROLLER_FAILOVER_PROMOTE_SECONDS,
                  "Wall-clock from promotion decision to the promoted "
                  "controller serving").observe(promote_s)
    tevents.emit(tevents.ControllerFailover, role="standby",
                 host=standby.host, port=port,
                 round=controller.global_iteration, learners=n_learners,
                 wal_records=last_seq, promote_s=round(promote_s, 4),
                 reason="wal_stale_probe_failed")
    print(f"METISFL_TPU_CONTROLLER_PROMOTED port={port}", flush=True)
    log.warning("promoted in %.3fs at round %d (%d learner(s) restored, "
                "%d WAL records)", promote_s, controller.global_iteration,
                n_learners, last_seq)
    if restored:
        # the new controller_epoch makes the surviving learners re-attach
        controller.resume_round()
    _serve(server)
    stop_telemetry(metrics_http)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch.controller")
    parser.add_argument("--config", required=True,
                        help="FederationConfig file (.bin codec or .yaml)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=None,
                        help="overrides the config's controller_port (or "
                             "controller.standby.port under --standby; 0 = "
                             "an ephemeral port)")
    parser.add_argument("--device", default="cuda",
                        help="where the robust rules combine the cohort "
                             "(cuda or cpu)")
    parser.add_argument("--resume", action="store_true",
                        help="restore from config.checkpoint.dir before "
                             "serving and re-dispatch the abandoned round")
    parser.add_argument("--standby", action="store_true",
                        help="run the warm hot standby: tail the WAL, "
                             "promote when the primary dies")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    chaos.install_from_env()
    if args.config.endswith((".yaml", ".yml")):
        config = load_config(args.config)
    else:
        with open(args.config, "rb") as f:
            config = FederationConfig.from_wire(f.read())
    metrics_http = start_telemetry(
        config, "standby" if args.standby else "controller", args.host)
    if args.standby:
        return standby_main(args, config, parser, metrics_http)
    if args.resume and not config.checkpoint.dir:
        parser.error("--resume requires config.checkpoint.dir")
    controller = build_controller(config, parser, args.device)
    restored = False
    if args.resume:
        restored = controller.restore_checkpoint()
        if not restored:
            logging.getLogger("metisfl_tpu_torch.controller").warning(
                "--resume: no checkpoint under %r; starting fresh at round "
                "0", config.checkpoint.dir)
    server = ControllerServer(
        controller, host=args.host,
        port=config.controller_port if args.port is None else args.port,
        ssl=config.ssl)
    port = server.start()
    print(f"METISFL_TPU_CONTROLLER_READY port={port}", flush=True)
    if restored:
        # after start(): the dispatches dial out and the completions dial
        # back in through the live server
        controller.resume_round()
    _serve(server)
    stop_telemetry(metrics_http)
    return 0


if __name__ == "__main__":
    sys.exit(main())
