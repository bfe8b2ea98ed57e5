"""Serving fleet: a consistent-hash router over gateway replicas, and the
alert-rule-driven autoscaler the driver closes the loop with.

The port's copy of the JAX package's ``serving/fleet.py``; it runs no
model and imports no torch. What it puts behind one endpoint:

- **Consistent-hash routing.** Every ``Predict``/``Generate`` carries a
  routing key (the canary key); the router hashes it onto a ring of
  ``vnodes`` crc32 points per replica and forwards to the owning replica.
  One key always lands on one replica, and every replica runs the same
  ``canary_channel(key, percent)``, so a key resolves to one channel
  whichever replica serves it, mid rolling swap included.
- **Drain.** A replica that stops answering is probed (grpc.health.v1:
  consecutive failures escalate to a probe, and only a probe-dead replica
  is declared dead); its arcs fall to the next clockwise owners and an
  in-flight forward retries to the next hash owner (at most
  ``retry_hops``), so no client sees a failure while one replica serves. A
  recovered or relaunched replica probes SERVING and rejoins the ring; an
  operator or autoscaler ``drain`` removes a replica from the ring before
  it is shut down.
- **Rolling hot-swap.** Promotion reaches the replicas through their own
  registry polls; :func:`poll_stagger` phases replica ``i`` of ``N`` at
  ``i * period / N``, so the fleet swaps one replica at a time.
- **Autoscaling.** :class:`FleetAutoscaler` judges the alert-rule schema's
  ``value``/``rate`` rules (with ``for_s`` holds) over the fleet's scraped
  ``serving_*`` families; the driver boots or drains replicas on its
  decisions within ``serving.fleet.min/max_replicas``.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.telemetry import events as _tevents
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import trace as _ttrace
from metisfl_tpu_torch.telemetry.alerts import AlertRule
from metisfl_tpu_torch.telemetry.timeseries import TimeSeriesRing

logger = logging.getLogger("metisfl_tpu_torch.serving.fleet")

_REG = _tmetrics.registry()
_M_ROUTER_REQUESTS = _REG.counter(
    _tel.M_ROUTER_REQUESTS_TOTAL,
    "Requests forwarded by the serving router, by replica and outcome",
    ("replica", "outcome"))
_M_ROUTER_RETRIES = _REG.counter(
    _tel.M_ROUTER_RETRIES_TOTAL,
    "Forwards retried to the next consistent-hash owner after the "
    "owning replica failed")
_M_ROUTER_LATENCY = _REG.histogram(
    _tel.M_ROUTER_REQUEST_LATENCY_SECONDS,
    "Router-side end-to-end forward latency (route -> replica reply)")
_M_REPLICA_UP = _REG.gauge(
    _tel.M_SERVING_REPLICA_UP,
    "Replica routability as the router sees it (1 up, 0 dead/draining; "
    "series removed when the replica is removed from the fleet)",
    ("replica",))

# gateway-replica liveness posture: consecutive forward/probe failures
# before the health probe's verdict declares the replica dead (the
# fabric collector's STALE_AFTER)
FAILURES_BEFORE_DEAD = 2


def poll_stagger(index: int, replicas: int, period_s: float) -> float:
    """Deterministic per-replica registry-poll phase offset: replica
    ``index`` of ``replicas`` first polls after ``index * period / N``.
    A promotion therefore reaches (and swaps) the fleet one replica at a
    time instead of every replica hammering ``DescribeRegistry`` — and
    paying blob decode — in the same instant (the thundering-herd fix;
    test-pinned). Pure function of (index, replicas, period): the
    schedule is reproducible, not random jitter."""
    n = max(1, int(replicas))
    if n == 1:
        return 0.0
    return (int(index) % n) * (float(period_s) / n)


class HashRing:
    """crc32 consistent-hash ring with virtual nodes.

    ``vnodes`` points per member smooth the keyspace split (~64 gives a
    few-percent imbalance at small fleets); removing a member moves ONLY
    its own arcs to the next clockwise owners, so a drain re-routes the
    dead replica's keys and nobody else's (minimal-disruption pin in
    tests/test_torch_fleet.py)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._points: List[int] = []
        self._owners: List[str] = []
        self._members: set = set()

    def _rebuild(self) -> None:
        pairs = sorted(
            (zlib.crc32(f"{name}#{i}".encode("utf-8")), name)
            for name in self._members for i in range(self.vnodes))
        self._points = [p for p, _ in pairs]
        self._owners = [n for _, n in pairs]

    def add(self, name: str) -> None:
        if name not in self._members:
            self._members.add(name)
            self._rebuild()

    def remove(self, name: str) -> None:
        if name in self._members:
            self._members.discard(name)
            self._rebuild()

    def members(self) -> List[str]:
        return sorted(self._members)

    def owners(self, key: str) -> List[str]:
        """Distinct members in ring order from the key's hash point —
        ``owners(key)[0]`` is the owner, the rest are the bounded-retry
        fallback chain."""
        if not self._points:
            return []
        h = zlib.crc32(key.encode("utf-8"))
        start = bisect.bisect_right(self._points, h) % len(self._points)
        out: List[str] = []
        seen: set = set()
        for i in range(len(self._points)):
            name = self._owners[(start + i) % len(self._points)]
            if name not in seen:
                seen.add(name)
                out.append(name)
                if len(out) == len(self._members):
                    break
        return out


class ReplicaHandle:
    """One gateway replica as the router tracks it."""

    STATE_UP = "up"
    STATE_DRAINING = "draining"
    STATE_DEAD = "dead"

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = int(port)
        self.state = self.STATE_UP
        self.failures = 0
        self.health = ""
        self.last_error = ""
        self.requests = 0
        # last GetServingStatus snapshot the probe loop cached (installed
        # versions per channel — the status CLI's per-replica line and
        # the chaos smoke's re-pin assertion read this)
        self.installed: Dict[str, int] = {}
        self._client = None

    def target(self) -> str:
        return f"{self.host}:{self.port}"

    def row(self) -> Dict[str, Any]:
        return {"replica": self.name, "target": self.target(),
                "state": self.state, "health": self.health,
                "failures": self.failures, "requests": self.requests,
                "installed": dict(self.installed),
                "last_error": self.last_error}


class ServingRouter:
    """Route serving traffic across gateway replicas (in-process core;
    :class:`RouterServer` is its gRPC shell). ``config`` is a
    :class:`metisfl_tpu_torch.config.ServingConfig` (the ``fleet`` block
    supplies vnodes / retry_hops / probe cadence)."""

    def __init__(self, config, ssl=None, comm=None):
        self.config = config
        fleet = config.fleet
        self.retry_hops = max(0, int(fleet.retry_hops))
        self.probe_every_s = float(fleet.probe_every_s)
        self.ssl = ssl
        self.comm = comm
        self._ring = HashRing(vnodes=fleet.vnodes)
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._requests = 0
        self._started_at = time.time()
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # -- fleet membership ----------------------------------------------- #

    def set_replicas(self, specs: List[Dict[str, Any]]) -> None:
        for idx, spec in enumerate(specs):
            # name optional, the driver's convention (a bare
            # {host, port} operator spec must not crash-loop the router)
            self.add_replica(str(spec.get("name") or f"serving_{idx}"),
                             str(spec.get("host", "localhost")),
                             int(spec["port"]))

    def add_replica(self, name: str, host: str, port: int,
                    wait_serving: bool = False) -> None:
        """Add (or re-point) a replica; idempotent so the driver can
        re-sync the fleet after a router relaunch. ``wait_serving``
        registers the replica OUT of the ring (state dead) until the
        probe loop sees it SERVING — a scale-up hands over a cold-booting
        replica without its keys failing forwards in the meantime."""
        with self._lock:
            replica = self._replicas.get(name)
            if replica is None:
                replica = self._replicas[name] = ReplicaHandle(name, host,
                                                               port)
                if wait_serving:
                    replica.state = ReplicaHandle.STATE_DEAD
            elif (replica.host, replica.port) != (host, int(port)):
                replica.host, replica.port = host, int(port)
                self._close_client(replica)
            if replica.state == ReplicaHandle.STATE_DRAINING:
                # an explicit re-add un-drains (scale-up reusing a name)
                replica.state = ReplicaHandle.STATE_UP
            if replica.state == ReplicaHandle.STATE_UP:
                self._ring.add(name)
            _M_REPLICA_UP.set(
                1 if replica.state == ReplicaHandle.STATE_UP else 0,
                replica=name)
        logger.info("router: replica %s @ %s:%d %s", name, host, port,
                    "registered (joins the ring on its first SERVING "
                    "probe)" if wait_serving else "joined the ring")

    def drain_replica(self, name: str) -> bool:
        """Stop routing NEW requests to ``name`` (ring removal). The
        replica itself keeps serving whatever is already in its queues —
        the caller shuts it down once its in-flight work finished."""
        with self._lock:
            replica = self._replicas.get(name)
            if replica is None:
                return False
            replica.state = ReplicaHandle.STATE_DRAINING
            self._ring.remove(name)
            _M_REPLICA_UP.set(0, replica=name)
        logger.info("router: replica %s draining (out of the ring)", name)
        return True

    def remove_replica(self, name: str) -> bool:
        with self._lock:
            replica = self._replicas.pop(name, None)
            if replica is None:
                return False
            self._ring.remove(name)
            self._close_client(replica)
            _M_REPLICA_UP.remove(replica=name)
        return True

    @staticmethod
    def _close_client(replica: ReplicaHandle) -> None:
        if replica._client is not None:
            try:
                replica._client.close()
            except Exception:  # noqa: BLE001
                pass
            replica._client = None

    def _client_for(self, replica: ReplicaHandle):
        if replica._client is None:
            from metisfl_tpu_torch.comm.rpc import RpcClient
            from metisfl_tpu_torch.serving.service import SERVING_SERVICE
            kwargs = {}
            if self.comm is not None:
                kwargs = {"default_deadline_s":
                          self.comm.default_deadline_s}
            replica._client = RpcClient(replica.host, replica.port,
                                        SERVING_SERVICE, retries=0,
                                        ssl=self.ssl, **kwargs)
        return replica._client

    # -- liveness ------------------------------------------------------- #

    def _mark_dead(self, replica: ReplicaHandle, reason: str) -> None:
        if replica.state == ReplicaHandle.STATE_DEAD:
            return
        was_draining = replica.state == ReplicaHandle.STATE_DRAINING
        replica.state = ReplicaHandle.STATE_DEAD
        self._ring.remove(replica.name)
        self._close_client(replica)
        _M_REPLICA_UP.set(0, replica=replica.name)
        if not was_draining:
            _tevents.emit(_tevents.ServingReplicaDead,
                          replica=replica.name, reason=reason,
                          failures=replica.failures)
            logger.warning("router: replica %s DEAD (%s); its keys fell "
                           "to the next hash owners", replica.name, reason)

    def _note_failure(self, replica: ReplicaHandle, exc: Exception) -> None:
        """Forward-failure accounting (the staleness posture): failures
        escalate to a grpc.health.v1 probe, and only a probe-dead
        replica leaves the ring — a transiently slow replica keeps its
        keys."""
        with self._lock:
            replica.failures += 1
            replica.last_error = str(exc)
            failures = replica.failures
        if failures < FAILURES_BEFORE_DEAD:
            return
        status = self._probe(replica)
        with self._lock:
            replica.health = status
            if status != "SERVING":
                self._mark_dead(replica, f"probe {status} after "
                                         f"{failures} forward failures")

    def _probe(self, replica: ReplicaHandle) -> str:
        from metisfl_tpu_torch.comm.health import probe_health
        from metisfl_tpu_torch.serving.service import SERVING_SERVICE
        return probe_health(replica.host, replica.port, SERVING_SERVICE,
                            ssl=self.ssl)

    def _poll_replica_status(self, replica: ReplicaHandle) -> None:
        """Cache the replica's installed channel heads (best-effort)."""
        try:
            from metisfl_tpu_torch.comm.codec import loads
            raw = self._client_for(replica).call(
                "GetServingStatus", b"", timeout=5.0, wait_ready=False,
                idempotent=True)
            desc = loads(raw)
            replica.installed = {
                str(ch): int(v)
                for ch, v in (desc.get("installed") or {}).items()}
        except Exception:  # noqa: BLE001 - probe loop stays best-effort
            pass

    def probe_once(self) -> None:
        """One probe sweep: dead replicas revive on SERVING (a relaunch
        re-pins via its first registry poll and rejoins the ring here);
        up replicas that probe dead leave it."""
        for replica in list(self._replicas.values()):
            status = self._probe(replica)
            with self._lock:
                replica.health = status
                if replica.state == ReplicaHandle.STATE_DEAD:
                    if status == "SERVING":
                        replica.state = ReplicaHandle.STATE_UP
                        replica.failures = 0
                        replica.last_error = ""
                        self._ring.add(replica.name)
                        _M_REPLICA_UP.set(1, replica=replica.name)
                        _tevents.emit(_tevents.ServingReplicaRecovered,
                                      replica=replica.name)
                        logger.info("router: replica %s recovered and "
                                    "rejoined the ring", replica.name)
                elif replica.state == ReplicaHandle.STATE_UP:
                    if status != "SERVING":
                        replica.failures += 1
                        if replica.failures >= FAILURES_BEFORE_DEAD:
                            self._mark_dead(replica,
                                            f"health probe {status}")
                    else:
                        replica.failures = 0
            if status == "SERVING":
                self._poll_replica_status(replica)

    def start_probes(self) -> None:
        if self._probe_thread is not None:
            return

        def _loop():
            while not self._probe_stop.wait(max(0.05, self.probe_every_s)):
                try:
                    self.probe_once()
                except Exception:  # noqa: BLE001 - probing never dies
                    logger.exception("router probe sweep failed")

        self._probe_thread = threading.Thread(target=_loop, daemon=True,
                                              name="router-probes")
        self._probe_thread.start()

    # -- forward path --------------------------------------------------- #

    def owners(self, key: str) -> List[str]:
        with self._lock:
            return self._ring.owners(key)

    def forward(self, method: str, raw: bytes, key: str,
                timeout: Optional[float] = 30.0) -> bytes:
        """Forward one request to its consistent-hash owner, retrying to
        the next distinct owner (bounded at ``retry_hops``) around a
        replica that fails at call time."""
        t0 = time.perf_counter()
        candidates = self.owners(key)[: 1 + self.retry_hops]
        if not candidates:
            raise RuntimeError("no live serving replicas in the ring")
        last: Optional[Exception] = None
        # activated: the replica hop's outbound metadata then carries
        # this span as parent, so the request trace reads router.forward
        # → rpc.server/<method> on the replica that ACTUALLY served it
        fwd_sp = _ttrace.span("router.forward", attrs={"method": method})
        with fwd_sp, fwd_sp.activate():
            for hop, name in enumerate(candidates):
                with self._lock:
                    replica = self._replicas.get(name)
                    if (replica is None
                            or replica.state != ReplicaHandle.STATE_UP):
                        continue
                    client = self._client_for(replica)
                if hop:
                    _M_ROUTER_RETRIES.inc()
                try:
                    reply = client.call(method, raw, timeout=timeout,
                                        wait_ready=False)
                except Exception as exc:  # noqa: BLE001 - retry next owner
                    last = exc
                    _M_ROUTER_REQUESTS.inc(replica=name, outcome="error")
                    self._note_failure(replica, exc)
                    continue
                with self._lock:
                    replica.failures = 0
                    replica.requests += 1
                    self._requests += 1
                fwd_sp.set_attr("replica", name)
                fwd_sp.set_attr("hops", hop + 1)
                _M_ROUTER_REQUESTS.inc(replica=name, outcome="ok")
                _M_ROUTER_LATENCY.observe(time.perf_counter() - t0)
                return reply
            raise RuntimeError(
                f"no serving replica could serve the request "
                f"(tried {candidates}): {last}")

    # -- status --------------------------------------------------------- #

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            rows = [r.row() for r in self._replicas.values()]
            requests = self._requests
        rows.sort(key=lambda r: r["replica"])
        return {
            "router": True,
            "replicas": rows,
            "live": sum(1 for r in rows if r["state"] == "up"),
            "requests": requests,
            "retry_hops": self.retry_hops,
            "vnodes": self._ring.vnodes,
            "canary_percent": float(self.config.canary_percent),
            "uptime_s": round(time.time() - self._started_at, 3),
        }

    def shutdown(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10.0)
        with self._lock:
            for replica in self._replicas.values():
                self._close_client(replica)


class RouterServer:
    """Host a :class:`ServingRouter` behind gRPC. Same service name as a
    gateway (``metisfl_tpu_torch.Serving`` — a :class:`ServingClient` dials a
    router transparently) but ``role="router"`` on the reflection
    surface, and fleet-admin methods next to the traffic ones."""

    def __init__(self, router: ServingRouter, host: str = "0.0.0.0",
                 port: int = 0, ssl=None):
        from metisfl_tpu_torch.comm.health import SERVING, HealthServicer
        from metisfl_tpu_torch.comm.rpc import BytesService, RpcServer
        from metisfl_tpu_torch.serving.service import SERVING_SERVICE

        self.router = router
        self._server = RpcServer(host, port, ssl=ssl)
        self._health_servicer = HealthServicer()
        self._health_servicer.set_status(SERVING_SERVICE, SERVING)
        self._server.add_service(self._health_servicer.service())
        self._server.add_service(BytesService(SERVING_SERVICE, {
            "Predict": self._predict,
            "Generate": self._generate,
            "GetServingStatus": self._status,
            "GetHealthStatus": self._health,
            "GetMetrics": self._get_metrics,
            "AddReplica": self._add_replica,
            "DrainReplica": self._drain_replica,
            "RemoveReplica": self._remove_replica,
            "ShutDown": self._shutdown_rpc,
        }, role="router"))
        self._shutdown_event = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopping = False
        self.port: Optional[int] = None

    # -- handlers (RPC threads) ----------------------------------------- #

    def _predict(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.messages import ServeRequest
        req = ServeRequest.from_wire(raw)
        return self.router.forward("Predict", raw,
                                   req.key or req.request_id)

    def _generate(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.messages import GenerateRequest
        req = GenerateRequest.from_wire(raw)
        # generation outlasts a classifier forward by orders of
        # magnitude: give the replica hop the transport default instead
        # of the router's short predict timeout
        return self.router.forward("Generate", raw,
                                   req.key or req.request_id,
                                   timeout=120.0)

    def _status(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps
        return dumps(self.router.describe())

    def _health(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps
        desc = self.router.describe()
        return dumps({"status": "SERVING", "replicas": desc["live"]})

    def _get_metrics(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.telemetry import render_metrics
        return render_metrics().encode("utf-8")

    def _add_replica(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps, loads
        spec = loads(raw)
        self.router.add_replica(
            str(spec.get("name") or f"{spec.get('host', 'localhost')}:"
                                    f"{spec['port']}"),
            str(spec.get("host", "localhost")), int(spec["port"]),
            wait_serving=bool(spec.get("wait_serving", False)))
        return dumps({"ok": True})

    def _drain_replica(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps, loads
        return dumps({"ok": self.router.drain_replica(
            str(loads(raw)["name"]))})

    def _remove_replica(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps, loads
        return dumps({"ok": self.router.remove_replica(
            str(loads(raw)["name"]))})

    def _shutdown_rpc(self, raw: bytes) -> bytes:
        from metisfl_tpu_torch.comm.codec import dumps
        threading.Thread(target=self.stop, daemon=True).start()
        return dumps({"ok": True})

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> int:
        self.port = self._server.start()
        self.router.start_probes()
        return self.port

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopping:
                return
            self._stopping = True
        from metisfl_tpu_torch.comm.health import NOT_SERVING
        try:
            self._health_servicer.set_all(NOT_SERVING)
            self._server.stop()
            self.router.shutdown()
        finally:
            # set last: the process exits when it is (ServingServer.stop)
            self._shutdown_event.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)


class FleetAutoscaler:
    """Scale decisions from the alert-rule schema over scraped
    ``serving_*`` family sums.

    The driver feeds :meth:`observe` the fleet's merged family values
    each monitor poll; a ``scale_up`` rule that breaches and HOLDS
    ``for_s`` returns ``"up"`` (bounded by ``max_replicas`` and the
    cooldown), ``scale_down`` likewise returns ``"down"`` (bounded by
    ``min_replicas``). ``value`` and ``rate`` kinds only — there is no
    per-series digest on a scraped sum for a quantile rule to read
    (rejected at config load)."""

    def __init__(self, up_rule: Optional[Dict[str, Any]],
                 down_rule: Optional[Dict[str, Any]],
                 min_replicas: int, max_replicas: int,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.time):
        self.up_rule = self._parse(up_rule, "serving_scale_up")
        self.down_rule = self._parse(down_rule, "serving_scale_down")
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._clock = clock
        self._ring = TimeSeriesRing()
        self._since = {"up": 0.0, "down": 0.0}   # breach-hold start
        self._cooldown_until = 0.0
        self.last_values: Dict[str, float] = {}

    @staticmethod
    def _parse(spec: Optional[Dict[str, Any]],
               default_name: str) -> Optional[AlertRule]:
        if not spec:
            return None
        spec = dict(spec)
        spec.setdefault("name", default_name)
        rule = AlertRule.from_spec(spec)
        if rule.kind not in ("value", "rate"):
            raise ValueError(
                f"serving scale rule {rule.name!r}: kind must be "
                "'value' or 'rate' (a scraped family sum has no "
                "quantile digest)")
        return rule

    def _sample(self, rule: AlertRule, families: Dict[str, float],
                now: float) -> float:
        raw = float(families.get(rule.metric, 0.0))
        if rule.kind == "value":
            return raw
        key = f"scale/{rule.name}/{rule.metric}"
        self._ring.record(key, raw, ts=now)
        return self._ring.rate(key, rule.window_s, now=now)

    def observe(self, families: Dict[str, float], replicas: int,
                now: Optional[float] = None) -> Optional[str]:
        """One evaluation; returns ``"up"``, ``"down"``, or None. The
        caller performs the action (and only a returned decision starts
        the cooldown, so a bounds-blocked breach keeps holding)."""
        now = self._clock() if now is None else float(now)
        decisions = []
        for direction, rule in (("up", self.up_rule),
                                ("down", self.down_rule)):
            if rule is None:
                continue
            value = self._sample(rule, families, now)
            self.last_values[direction] = value
            if not rule.breaches(value):
                self._since[direction] = 0.0
                continue
            if self._since[direction] == 0.0:
                self._since[direction] = now
            if now - self._since[direction] >= rule.for_s:
                decisions.append(direction)
        if now < self._cooldown_until:
            return None
        # scale-up wins a tie: under-capacity costs users, over-capacity
        # costs a replica
        for direction in ("up", "down"):
            if direction not in decisions:
                continue
            if direction == "up" and replicas >= self.max_replicas:
                continue
            if direction == "down" and replicas <= self.min_replicas:
                continue
            self._cooldown_until = now + self.cooldown_s
            self._since[direction] = 0.0
            return direction
        return None

    def describe(self) -> Dict[str, Any]:
        return {
            "up": self.up_rule.describe_expr() if self.up_rule else "",
            "down": (self.down_rule.describe_expr()
                     if self.down_rule else ""),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_s": self.cooldown_s,
            "last_values": dict(self.last_values),
        }
