"""Federation-wide telemetry: trace spans + metrics registry + events,
the port's copy of the JAX package's ``telemetry/`` with the same metric
families, label sets, event types and trace metadata key, so mixed fleets
of both packages stitch into one trace and one scraper reads both
(``docs/OBSERVABILITY.md`` is the catalog):

- :mod:`metisfl_tpu_torch.telemetry.trace` — context-manager spans with
  federation-wide trace/span ids, a process-local JSONL sink, and
  propagation over gRPC metadata (controller dispatch → learner train →
  aggregation stitch into one tree per round, rooted at the controller's
  round span; the driver collects every process's sink files).
- :mod:`metisfl_tpu_torch.telemetry.metrics` — thread-safe counters /
  gauges / histograms with Prometheus text exposition, served via the
  ``GetMetrics`` RPC on controller, learner and slice aggregator and the
  optional plain-HTTP ``/metrics`` listener
  (:mod:`metisfl_tpu_torch.telemetry.httpd`), with the cardinality
  budget over :mod:`metisfl_tpu_torch.telemetry.sketch`.
- :mod:`metisfl_tpu_torch.telemetry.events` — the typed event journal in
  a bounded ring + JSONL sink.
- :mod:`metisfl_tpu_torch.telemetry.postmortem` — the flight recorder.
- :mod:`metisfl_tpu_torch.telemetry.health` — the learning-health plane
  (controller-local; the registry's promotion gate reads its snapshots).
- :mod:`metisfl_tpu_torch.telemetry.profile` — per-round cost profiles
  and the learners' device stats (``torch.cuda``), with ``torch.profiler``
  captures.
- :mod:`metisfl_tpu_torch.telemetry.timeseries` — bounded time-series
  rings and sparklines, and :mod:`metisfl_tpu_torch.telemetry.alerts` —
  the alert-rule schema; the serving fleet's autoscaler judges its scale
  rules with both.
- ``python -m metisfl_tpu_torch.telemetry <trace dir or .jsonl>`` renders
  a round's span tree; ``--postmortem`` renders post-mortem bundles.

Not ported yet (ROADMAP.md Queue 1 item 4b): the fleet fabric
(``CollectTelemetry``'s real answer; every server answers the JAX
package's ``{"enabled": false}`` stub), the critical path, the stack
sampler and instrumented locks, the compile and memory plane, and the
alert engine. Their config sections load and are ignored (a non-empty
``telemetry.alerts`` is refused).

Everything is opt-out via federation config ``telemetry.enabled=false``
(:func:`apply_config`), and the event journal separately via
``telemetry.events.enabled=false``; the disabled paths are
attribute-check cheap.
"""

from __future__ import annotations

from metisfl_tpu_torch.telemetry import (
    events,
    health,
    metrics,
    postmortem,
    sketch,
    trace,
)
from metisfl_tpu_torch.telemetry.metrics import parse_exposition, registry
from metisfl_tpu_torch.telemetry.trace import (
    METADATA_KEY,
    SpanContext,
    current_context,
    extract,
    outbound_metadata,
    span,
)

# --------------------------------------------------------------------- #
# Canonical metric series names, the JAX package's (the same strings, so
# one scraper reads both packages): every registration site and every
# scrape-side consumer imports these, so a typo fails at import time
# instead of silently minting a new series. The full catalog (types, labels, semantics) lives in
# docs/OBSERVABILITY.md "Metric names and labels".
# --------------------------------------------------------------------- #

# controller round lifecycle (controller/core.py)
M_ROUND_DURATION_SECONDS = "round_duration_seconds"
M_ROUNDS_TOTAL = "rounds_total"
M_ROUND_PHASE_DURATION_SECONDS = "round_phase_duration_seconds"
M_UPLINK_BYTES_TOTAL = "uplink_bytes_total"
M_CONTROLLER_ACTIVE_LEARNERS = "controller_active_learners"
M_AGGREGATION_FAILURES_TOTAL = "aggregation_failures_total"
M_LEARNER_STRAGGLER_SCORE = "learner_straggler_score"
# churn-tolerant scheduling (controller/core.py + selection.py)
M_LEARNER_DROPPED_TOTAL = "learner_dropped_total"
M_DISPATCH_RETRIES_TOTAL = "dispatch_retries_total"
M_ROUNDS_REDISPATCHED_TOTAL = "rounds_redispatched_total"
M_LEARNER_CHURN_SCORE = "learner_churn_score"
# learning-health plane (controller/core.py + telemetry/health.py)
M_LEARNER_DIVERGENCE_SCORE = "learner_divergence_score"
M_ROUND_UPDATE_NORM = "round_update_norm"
# causal tracing plane (telemetry/causal.py + telemetry/fabric.py)
M_ROUND_CRITICAL_PATH_SECONDS = "round_critical_path_seconds"
# performance observatory (telemetry/profile.py + controller/core.py)
M_DOWNLINK_BYTES_TOTAL = "downlink_bytes_total"
M_CODEC_LEARNER_SECONDS = "codec_learner_seconds_total"
M_LEARNER_ACHIEVED_MFU = "learner_achieved_mfu"
M_LEARNER_STEP_MS_EWMA = "learner_step_ms_ewma"
M_LEARNER_HBM_PEAK_BYTES = "learner_hbm_peak_bytes"
# learner runtime (learner/learner.py)
M_LEARNER_TRAIN_DURATION_SECONDS = "learner_train_duration_seconds"
M_LEARNER_STEP_MILLISECONDS = "learner_step_milliseconds"
M_LEARNER_JIT_COMPILE_SECONDS = "learner_jit_compile_seconds"
M_LEARNER_TASKS_TOTAL = "learner_tasks_total"
M_LEARNER_EVAL_DURATION_SECONDS = "learner_eval_duration_seconds"
M_LEARNER_REATTACH_TOTAL = "learner_reattach_total"
# RPC transport (comm/rpc.py)
M_RPC_PEER_BYTES_TOTAL = "rpc_peer_bytes_total"
M_RPC_CLIENT_CALLS_TOTAL = "rpc_client_calls_total"
M_RPC_CLIENT_LATENCY_SECONDS = "rpc_client_latency_seconds"
M_RPC_CLIENT_BYTES_TOTAL = "rpc_client_bytes_total"
M_RPC_CLIENT_ERRORS_TOTAL = "rpc_client_errors_total"
M_RPC_SERVER_CALLS_TOTAL = "rpc_server_calls_total"
M_RPC_SERVER_LATENCY_SECONDS = "rpc_server_latency_seconds"
M_RPC_SERVER_BYTES_TOTAL = "rpc_server_bytes_total"
M_RPC_SERVER_ERRORS_TOTAL = "rpc_server_errors_total"
# wire codec (comm/codec.py)
M_CODEC_DURATION_SECONDS = "codec_duration_seconds"
M_CODEC_BYTES_TOTAL = "codec_bytes_total"
# model store cache (store/cached.py)
M_STORE_CACHE_HITS_TOTAL = "store_cache_hits_total"
M_STORE_CACHE_MISSES_TOTAL = "store_cache_misses_total"
M_STORE_CACHE_RESIDENT_BYTES = "store_cache_resident_bytes"
M_STORE_CACHE_ENTRIES = "store_cache_entries"
# integrity framing (tensor/pytree.py)
M_CORRUPT_PAYLOADS_TOTAL = "corrupt_payloads_total"
# chaos injector (chaos/injector.py)
M_CHAOS_FAULTS_INJECTED_TOTAL = "chaos_faults_injected_total"
# driver failover supervision (driver/session.py)
M_CONTROLLER_RESTARTS_TOTAL = "controller_restarts_total"
M_GATEWAY_RESTARTS_TOTAL = "gateway_restarts_total"
# controller hot-standby (controller/wal.py + __main__.py --standby)
M_CONTROLLER_WAL_RECORDS_TOTAL = "controller_wal_records_total"
M_CONTROLLER_WAL_LAG_RECORDS = "controller_wal_lag_records"
M_CONTROLLER_FAILOVER_TOTAL = "controller_failover_total"
M_CONTROLLER_FAILOVER_PROMOTE_SECONDS = "controller_failover_promote_seconds"
# model registry (registry/registry.py)
M_REGISTRY_VERSIONS_TOTAL = "registry_versions_total"
M_REGISTRY_VERSION_STATE = "registry_version_state"
M_REGISTRY_PROMOTIONS_TOTAL = "registry_promotions_total"
M_REGISTRY_ROLLBACKS_TOTAL = "registry_rollbacks_total"
# telemetry-at-scale plane (telemetry/metrics.py cardinality budgets +
# telemetry/alerts.py; docs/OBSERVABILITY.md "Telemetry at scale")
M_METRICS_SERIES_OVERFLOW_TOTAL = metrics.SERIES_OVERFLOW_TOTAL
M_METRICS_FAMILY_SERIES = metrics.FAMILY_SERIES
M_ALERTS_ACTIVE = "alerts_active"
M_ALERTS_FIRED_TOTAL = "alerts_fired_total"
# continuous profiling plane (telemetry/prof.py sampler + lock wrappers)
M_PROF_SAMPLES_TOTAL = "prof_samples_total"
M_LOCK_WAIT_SECONDS = "lock_wait_seconds"
M_LOCK_CONTENTION_TOTAL = "lock_contention_total"
# accelerator runtime observability (telemetry/runtime.py)
M_JAX_COMPILES_TOTAL = "jax_compiles_total"
M_JAX_COMPILE_SECONDS = "jax_compile_seconds"
M_JAX_DEVICE_MEMORY_BYTES = "jax_device_memory_bytes"
# fleet telemetry fabric (telemetry/fabric.py FleetCollector)
M_FABRIC_COLLECTIONS_TOTAL = "fabric_collections_total"
M_FABRIC_PEER_OFFSET_MS = "fabric_peer_clock_offset_ms"
M_FABRIC_COLLECT_SECONDS = "fabric_collect_duration_seconds"
# distributed slice aggregators (aggregation/slice.py + distributed.py)
M_SLICE_UPLINKS_TOTAL = "slice_uplinks_total"
M_SLICE_HELD_MODELS = "slice_held_models"
M_SLICE_FAILURES_TOTAL = "slice_failures_total"
M_SLICE_REHOMING_SECONDS = "slice_rehoming_seconds"
# masked partial-fold plane (secure/distributed.py + recovery.py)
M_SECURE_MASKED_UPLINKS_TOTAL = "secure_masked_uplinks_total"
M_SECURE_MASKED_FOLDS_TOTAL = "secure_masked_folds_total"
M_SECURE_SETTLEMENT_SECONDS = "secure_settlement_seconds"
M_SECURE_RECOVERED_PARTIES_TOTAL = "secure_recovered_parties_total"
M_SECURE_MASK_GEN_SECONDS = "secure_mask_gen_seconds"
# serving gateway (serving/gateway.py)
M_SERVING_REQUESTS_TOTAL = "serving_requests_total"
M_SERVING_REQUEST_LATENCY_SECONDS = "serving_request_latency_seconds"
M_SERVING_BATCH_ROWS = "serving_batch_rows"
M_SERVING_MODEL_VERSION = "serving_model_version"
M_SERVING_SWAPS_TOTAL = "serving_swaps_total"
M_SERVING_QUEUE_DEPTH = "serving_queue_depth"
# continuous-batching decode (serving/decode.py)
M_SERVING_DECODE_QUEUE_DEPTH = "serving_decode_queue_depth"
M_SERVING_DECODE_ACTIVE_SLOTS = "serving_decode_active_slots"
M_SERVING_DECODE_TOKENS_TOTAL = "serving_decode_tokens_total"
M_SERVING_DECODE_TOKENS_PER_SEC = "serving_decode_tokens_per_sec"
# serving fleet: router + autoscaler (serving/fleet.py + driver/session.py)
M_ROUTER_REQUESTS_TOTAL = "serving_router_requests_total"
M_ROUTER_RETRIES_TOTAL = "serving_router_retries_total"
M_ROUTER_REQUEST_LATENCY_SECONDS = "serving_router_request_latency_seconds"
M_SERVING_REPLICA_UP = "serving_replica_up"
M_SERVING_FLEET_REPLICAS = "serving_fleet_replicas"
M_SERVING_SCALE_TOTAL = "serving_scale_total"

__all__ = [
    "metrics",
    "trace",
    "events",
    "health",
    "postmortem",
    "sketch",
    "registry",
    "prune_learner",
    "parse_exposition",
    "span",
    "current_context",
    "extract",
    "outbound_metadata",
    "SpanContext",
    "METADATA_KEY",
    "apply_config",
    "render_metrics",
] + [name for name in dir() if name.startswith("M_")]


def render_metrics() -> str:
    """The process registry's Prometheus exposition (GetMetrics RPC body)."""
    return registry().render()


def prune_learner(learner_id: str) -> None:
    """Drop every per-learner metric series for a departed learner, in
    ONE place: all registry families registered with a cardinality
    label (``budget_label`` — the "learner"/"peer" families) plus the
    codec/RPC attribution state that backs them."""
    registry().prune_label_value(learner_id)
    from metisfl_tpu_torch.telemetry import profile as _profile

    _profile.prune_attribution_series(learner_id)


def unported_planes(telemetry_config) -> list:
    """The enabled sections of ``telemetry_config`` that the port accepts
    and ignores (ROADMAP.md Queue 1 item 4b): the process entry points
    log them once at start."""
    enabled = bool(getattr(telemetry_config, "enabled", True))
    return [name for name in ("fabric", "prof", "runtime")
            if enabled and bool(getattr(
                getattr(telemetry_config, name, None), "enabled", False))]


def apply_config(telemetry_config, service: str = "",
                 config_hash: str = "") -> None:
    """Configure process-wide telemetry from a federation config's
    ``telemetry`` section (config/federation.py TelemetryConfig): one call
    in each process entry point (controller/learner ``__main__``,
    in-process federation, tests). ``config_hash`` stamps post-mortem
    bundles so incidents from different configs are tellable apart. The
    fabric, profiler and runtime sections are not ported (4b) and arm
    nothing."""
    enabled = bool(getattr(telemetry_config, "enabled", True))
    metrics.set_enabled(enabled)
    # cardinality budget: 0 (default) keeps every per-learner family exact
    registry().set_cardinality_budget(
        int(getattr(telemetry_config, "cardinality_budget", 0) or 0))
    sink_dir = getattr(telemetry_config, "dir", "")
    ev_cfg = getattr(telemetry_config, "events", None)
    ev_enabled = enabled and bool(getattr(ev_cfg, "enabled", True))
    events.configure(enabled=ev_enabled, service=service,
                     dir=sink_dir if ev_enabled else "",
                     ring_size=int(getattr(ev_cfg, "ring_size", 0) or 0))
    if enabled:
        trace.configure(enabled=True, service=service, dir=sink_dir)
    else:
        # disable without forgetting any previously configured sink dir
        trace.set_enabled(False)
    pm_dir = getattr(telemetry_config, "postmortem_dir", "")
    if enabled and pm_dir:
        postmortem.configure(pm_dir, service=service,
                             config_hash=config_hash)


def reset() -> None:
    """Return the process-global planes to their import-time state: an
    empty enabled registry, an empty journal, an enabled tracer with no
    sink, the flight recorder disarmed. Tests that run many in-process
    federations in one process call it between them."""
    registry().reset()
    metrics.set_enabled(True)
    registry().set_cardinality_budget(0)
    events.configure(enabled=True, service="", dir="", ring_size=0)
    events.journal().reset()
    trace.configure(enabled=True, service="", dir="")
    postmortem.configure("", install_hooks=False)


# Imported at the BOTTOM so profile.py (which reads the M_* constants at
# its own import time) sees a fully-initialized package.
from metisfl_tpu_torch.telemetry import profile  # noqa: E402

__all__ += ["profile", "reset", "unported_planes"]
