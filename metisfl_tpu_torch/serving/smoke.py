"""Serving-fleet chaos smoke: the replica-kill gate.

The port's copy of the JAX package's ``serving/smoke.py``: ``python -m
metisfl_tpu_torch.serving --fleet-smoke [--device cpu]`` boots N gateway
replica processes over gRPC behind an in-process consistent-hash router,
drives live canary traffic, SIGKILLs one replica mid-canary, and fails
unless

- no client-visible request drops (the router drains around the dead
  replica with bounded retry to the next hash owner),
- the router marks the killed replica dead,
- every key's replies stay on ONE canary channel however they were routed,
- a promotion mid-run rolls through the surviving replicas (staggered
  registry polls), and
- the relaunched replica re-pins to the promoted version through its first
  registry poll and rejoins the ring.

The registry is a stub controller server (``DescribeRegistry`` and
``GetRegisteredModel`` only), so the smoke measures the serving plane, not
training. The replicas serve the port's MLP on the caller's ``device``.
Exit codes: 0 pass, 1 a gate failed, 2 the harness could not run.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np


def _smoke_recipe(device: str):
    """Gateway engine for the smoke replicas (module-level, so cloudpickle
    ships it by reference into the subprocesses)."""
    from metisfl_tpu_torch.models import TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP
    return (TorchModelOps(MLP(4, (8,), 3, device=device), rng_seed=0,
                          device=device),)


class _StubRegistry:
    """A controller that serves ONLY the registry surface the gateway
    polls — channel heads + blobs, mutable from the harness thread."""

    def __init__(self):
        import threading as _threading
        self._lock = _threading.Lock()
        self.state = {"enabled": True, "stable": 0, "candidate": 0}
        self.blobs: Dict[int, bytes] = {}
        self._server = None
        self.port = 0

    def set(self, stable: int = None, candidate: int = None) -> None:
        with self._lock:
            if stable is not None:
                self.state["stable"] = int(stable)
            if candidate is not None:
                self.state["candidate"] = int(candidate)

    def start(self) -> int:
        from metisfl_tpu_torch.comm.codec import dumps, loads
        from metisfl_tpu_torch.comm.health import SERVING, HealthServicer
        from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
        from metisfl_tpu_torch.controller.service import CONTROLLER_SERVICE

        def describe(raw: bytes) -> bytes:
            with self._lock:
                return dumps(dict(self.state))

        def blob(raw: bytes) -> bytes:
            req = loads(raw) if raw else {}
            version = int(req.get("version", 0) or 0)
            if not version and req.get("channel"):
                with self._lock:
                    version = int(self.state.get(req["channel"], 0))
            return self.blobs.get(version, b"")

        self._server = RpcServer("127.0.0.1", 0)
        health = HealthServicer()
        health.set_status(CONTROLLER_SERVICE, SERVING)
        self._server.add_service(health.service())
        self._server.add_service(BytesService(CONTROLLER_SERVICE, {
            "DescribeRegistry": describe,
            "GetRegisteredModel": blob,
        }))
        self.port = self._server.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()


def _launch_replica(config_path: str, recipe_path: str, idx: int,
                    port: int, replicas: int, workdir: str, device: str):
    import metisfl_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(metisfl_tpu_torch.__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (pkg_root,
                           os.environ.get("PYTHONPATH", "")) if p)}
    with open(os.path.join(workdir, f"replica_{idx}.log"), "a") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "metisfl_tpu_torch.serving",
             "--config", config_path, "--recipe", recipe_path,
             "--device", device, "--port", str(port),
             "--replica-index", str(idx), "--replicas", str(replicas)],
            stdout=log, stderr=subprocess.STDOUT, env=env)


def run_fleet_smoke(replicas: int = 3, traffic_threads: int = 4,
                    keys: int = 24, workdir: Optional[str] = None,
                    device: str = "cuda") -> int:
    """The replica-kill gate (module docstring) with replicas serving on
    ``device``. Returns 0, 1 or 2."""
    import functools

    import cloudpickle

    from metisfl_tpu_torch.comm.health import probe_health
    from metisfl_tpu_torch.config import (FederationConfig, RegistryConfig,
                                          ServingConfig, ServingFleetConfig)
    from metisfl_tpu_torch.serving.fleet import RouterServer, ServingRouter
    from metisfl_tpu_torch.serving.gateway import canary_channel
    from metisfl_tpu_torch.serving.service import (SERVING_SERVICE,
                                                   ServingClient)
    from metisfl_tpu_torch.tensor.pytree import pack_model, tree_map

    workdir = workdir or tempfile.mkdtemp(prefix="metisfl_fleet_smoke_")
    result: Dict[str, object] = {"replicas": replicas, "workdir": workdir}
    failures: List[str] = []

    registry = _StubRegistry()
    registry_port = registry.start()

    import socket as _socket

    def free_port() -> int:
        with _socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    gateways = [{"name": f"serving_{i}", "host": "127.0.0.1",
                 "port": free_port()} for i in range(replicas)]
    config = FederationConfig(
        registry=RegistryConfig(enabled=True),
        serving=ServingConfig(
            enabled=True, max_batch=4, max_wait_ms=1.0,
            canary_percent=25.0, poll_every_s=0.2,
            fleet=ServingFleetConfig(enabled=True, replicas=replicas,
                                     max_replicas=max(4, replicas),
                                     probe_every_s=0.2,
                                     gateways=gateways)),
        controller_host="127.0.0.1", controller_port=registry_port)
    config_path = os.path.join(workdir, "config.bin")
    with open(config_path, "wb") as f:
        f.write(config.to_wire())
    recipe = functools.partial(_smoke_recipe, device)
    recipe_path = os.path.join(workdir, "recipe.pkl")
    with open(recipe_path, "wb") as f:
        cloudpickle.dump(recipe, f)

    # registry state: v1 promoted stable, v2 the mid-canary candidate
    ops = _smoke_recipe("cpu")[0]
    v1 = ops.get_variables()
    v2 = tree_map(lambda a: np.asarray(a) * 2.0, v1)
    registry.blobs[1] = pack_model(v1)
    registry.blobs[2] = pack_model(v2)
    registry.set(stable=1, candidate=2)

    procs = {}
    router_server = None
    client = None
    try:
        for i, spec in enumerate(gateways):
            procs[i] = _launch_replica(config_path, recipe_path, i,
                                       spec["port"], replicas, workdir,
                                       device)
        deadline = time.time() + 60.0
        pending = dict(enumerate(gateways))
        while pending and time.time() < deadline:
            for i in list(pending):
                if probe_health("127.0.0.1", pending[i]["port"],
                                SERVING_SERVICE) == "SERVING":
                    del pending[i]
            time.sleep(0.25)
        if pending:
            print(json.dumps({"error": "replicas never became healthy",
                              "pending": sorted(pending)}))
            return 2

        router = ServingRouter(config.serving)
        router.set_replicas(gateways)
        router_server = RouterServer(router, host="127.0.0.1", port=0)
        router_port = router_server.start()
        client = ServingClient("127.0.0.1", router_port)

        # wait until every replica pinned stable v1 (staggered polls)
        deadline = time.time() + 30.0
        while time.time() < deadline:
            router.probe_once()
            if all(r.installed.get("stable") == 1
                   for r in router._replicas.values()):
                break
            time.sleep(0.2)

        x = np.random.default_rng(0).standard_normal(
            (2, 4)).astype(np.float32)
        all_keys = [f"user{i}" for i in range(keys)]
        stop = threading.Event()
        errors: List[str] = []
        served = {"n": 0}
        # per-key channel record for the coherence check (pre-promotion)
        channels: Dict[str, set] = {k: set() for k in all_keys}
        promoted = threading.Event()

        def hammer(worker: int):
            cl = ServingClient("127.0.0.1", router_port)
            i = worker
            try:
                while not stop.is_set():
                    key = all_keys[i % len(all_keys)]
                    i += traffic_threads
                    try:
                        reply = cl.predict(x, key=key, timeout=30.0)
                        served["n"] += 1
                        if not promoted.is_set():
                            channels[key].add(reply.channel)
                    except Exception as exc:  # noqa: BLE001 - the gate
                        errors.append(f"{key}: {exc}")
                    time.sleep(0.005)
            finally:
                cl.close()

        threads = [threading.Thread(target=hammer, args=(w,))
                   for w in range(traffic_threads)]
        for t in threads:
            t.start()
        # let the canary serve demonstrably before the kill
        deadline = time.time() + 30.0
        while served["n"] < 50 and not errors and time.time() < deadline:
            time.sleep(0.1)

        # ---- SIGKILL one replica mid-canary under live traffic ------- #
        victim = 1 % replicas
        procs[victim].send_signal(signal.SIGKILL)
        result["killed"] = gateways[victim]["name"]
        deadline = time.time() + 20.0
        dead_marked = False
        while time.time() < deadline:
            desc = router.describe()
            row = next(r for r in desc["replicas"]
                       if r["replica"] == gateways[victim]["name"])
            if row["state"] == "dead":
                dead_marked = True
                break
            time.sleep(0.1)
        if not dead_marked:
            failures.append("router never marked the killed replica dead")
        result["dead_marked"] = dead_marked

        before_kill = served["n"]
        time.sleep(1.0)  # traffic must keep flowing around the corpse
        if served["n"] <= before_kill:
            failures.append("traffic stalled after the replica kill")

        # ---- promotion mid-run: v2 candidate -> stable --------------- #
        promoted.set()
        registry.set(stable=2, candidate=0)
        survivors = [i for i in range(replicas) if i != victim]
        deadline = time.time() + 20.0
        while time.time() < deadline:
            router.probe_once()
            pins = {i: router._replicas[gateways[i]["name"]].installed
                    for i in survivors}
            if all(p.get("stable") == 2 and "candidate" not in p
                   for p in pins.values()):
                break
            time.sleep(0.2)
        else:
            failures.append(
                f"survivors never swapped to the promoted v2: {pins}")

        # ---- relaunch the victim: must re-pin to v2 + rejoin --------- #
        procs[victim].wait(timeout=10.0)
        procs[victim] = _launch_replica(
            config_path, recipe_path, victim, gateways[victim]["port"],
            replicas, workdir, device)
        deadline = time.time() + 60.0
        repinned = {}
        while time.time() < deadline:
            router.probe_once()
            row = router._replicas[gateways[victim]["name"]]
            repinned = dict(row.installed)
            if row.state == "up" and repinned.get("stable") == 2:
                break
            time.sleep(0.25)
        else:
            failures.append(
                f"relaunched replica did not re-pin to v2 / rejoin the "
                f"ring: {repinned}")
        result["relaunched_installed"] = repinned

        stop.set()
        for t in threads:
            t.join(timeout=30.0)

        # ---- the gate ------------------------------------------------ #
        if errors:
            failures.append(
                f"{len(errors)} request(s) dropped (first: {errors[0]})")
        mixed = {k: sorted(v) for k, v in channels.items() if len(v) > 1}
        if mixed:
            failures.append(f"canary channels mixed per key: {mixed}")
        expected = {k: canary_channel(k, 25.0) for k in all_keys}
        wrong = {k: sorted(v) for k, v in channels.items()
                 if v and v != {expected[k]}}
        if wrong:
            failures.append(
                f"replies disagreed with the crc32 split: {wrong}")
        result.update({
            "requests_served": served["n"],
            "requests_dropped": len(errors),
            "keys_mixed": len(mixed),
            "failures": failures,
        })
        print(json.dumps(result, indent=2, default=str))
        return 1 if failures else 0
    finally:
        if client is not None:
            client.close()
        if router_server is not None:
            router_server.stop()
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
        registry.stop()
