"""Experiment summary CLI: ``python -m metisfl_tpu_torch.stats experiment.json``
(the port's copy of the JAX package's ``stats.py``; both read either
package's ``experiment.json``).

The reference ships convergence-plot helpers with its examples
(reference examples/utils/convergence_plots.py — hardcoded paper
figures; driver_session.py:408-418 dumps the raw lineage); this is the
rebuild's generic equivalent — a round-by-round table (wall-clock,
cohort, aggregation time, model size) and per-metric convergence
summaries from the ``experiment.json`` a driver writes, plus an optional
``--plot out.png`` convergence figure (metric curves over evaluated
rounds + per-round wall-clock/aggregation bars) when matplotlib is
available. Payloads from a health-enabled controller additionally carry
per-round ``health`` snapshots and per-learner ``train_metrics``/
``epoch_metrics``, rendered as a per-learner learning-health table
(:func:`learning_health_summary`, :func:`epoch_loss_series`); older
payloads render exactly as before. Usable as a library via
:func:`summarize` / :func:`metric_series` / :func:`plot_convergence`.
"""

from __future__ import annotations

import json
import sys
from statistics import median
from typing import Any, Dict, List


def _fmt_ms(ms: float) -> str:
    return f"{ms / 1e3:.2f}s" if ms >= 1e3 else f"{ms:.1f}ms"


def summarize(stats: Dict[str, Any]) -> str:
    """Human-readable summary of a ``get_statistics()`` / experiment.json
    payload; returns the text (the CLI prints it)."""
    lines: List[str] = []
    rounds = stats.get("round_metadata", [])
    lines.append(
        f"federation: {stats.get('global_iteration', len(rounds))} rounds, "
        f"{len(stats.get('learners', []))} learners registered")

    if rounds:
        lines.append("")
        # telemetry-era payloads carry a span-sourced phase breakdown
        # (dispatch / wait-for-uplinks; aggregate was always present);
        # pre-telemetry experiment.json renders byte-identically because
        # the extra columns only appear when some round has the keys
        has_phases = any("dispatch_duration_ms" in m
                         or "wait_duration_ms" in m for m in rounds)
        phase_header = f"{'disp':>8} {'wait':>8} " if has_phases else ""
        # model-lifecycle lineage (registry era): the version each round
        # registered and the stable head at round close. Pre-registry
        # payloads lack the keys (or carry zeros) and render unchanged.
        has_versions = any(m.get("registered_version") for m in rounds)
        ver_header = f"{'ver':>6} {'stable':>6} " if has_versions else ""
        lines.append(f"{'round':>5} {'wall':>8} {phase_header}"
                     f"{'cohort':>6} {'agg':>8} "
                     f"{'params':>10} {'uplink':>9} {ver_header}"
                     f"{'errors':>6}")
        for meta in rounds:
            wall_ms = 1e3 * max(
                0.0, meta.get("completed_at", 0) - meta.get("started_at", 0))
            up = sum(meta.get("uplink_bytes", {}).values())
            up_s = (f"{up / 1e6:.1f}MB" if up >= 1e6
                    else f"{up / 1e3:.0f}KB" if up >= 1e3
                    else f"{up}B" if up else "-")
            phase_cells = ""
            if has_phases:
                phase_cells = (
                    f"{_fmt_ms(meta.get('dispatch_duration_ms', 0.0)):>8} "
                    f"{_fmt_ms(meta.get('wait_duration_ms', 0.0)):>8} ")
            ver_cells = ""
            if has_versions:
                reg = meta.get("registered_version", 0)
                stable = meta.get("stable_version", 0)
                ver_cells = (
                    f"{(f'v{reg}' if reg else '-'):>6} "
                    f"{(f'v{stable}' if stable else '-'):>6} ")
            lines.append(
                f"{meta.get('global_iteration', '?'):>5} "
                f"{_fmt_ms(wall_ms):>8} "
                f"{phase_cells}"
                f"{len(meta.get('selected_learners', [])):>6} "
                f"{_fmt_ms(meta.get('aggregation_duration_ms', 0.0)):>8} "
                f"{meta.get('model_size', {}).get('values', 0):>10} "
                f"{up_s:>9} "
                f"{ver_cells}"
                f"{len(meta.get('errors', [])):>6}")
        # clamped like the table rows, so both views agree on skewed clocks
        walls = [1e3 * max(0.0, m.get("completed_at", 0)
                           - m.get("started_at", 0))
                 for m in rounds if m.get("completed_at")]
        aggs = [m.get("aggregation_duration_ms", 0.0) for m in rounds]
        if walls:
            lines.append(
                f"round wall-clock: median {_fmt_ms(median(walls))}, "
                f"max {_fmt_ms(max(walls))}; aggregation median "
                f"{_fmt_ms(median(aggs))}")
        errors = [e for m in rounds for e in m.get("errors", [])]
        if errors:
            lines.append(f"round errors ({len(errors)}):")
            lines.extend(f"  - {e}" for e in errors[:10])

        straggler = straggler_summary(stats)
        if straggler:
            lines.append("")
            lines.append("per-learner train durations (dispatch → uplink; "
                         "rel = mean over cohort median):")
            for row in straggler:
                lines.append(
                    f"  {row['learner']:<28} mean={row['mean_s']:.2f}s "
                    f"max={row['max_s']:.2f}s rel={row['rel']:.2f}x "
                    f"over {row['rounds']} round(s)")

        profiles = profile_summary(stats)
        if profiles:
            lines.append("")
            lines.append("per-round cost profile (phase share of "
                         "wall-clock):")
            for row in profiles:
                shares = " ".join(
                    f"{name}={share * 100:.0f}%"
                    for name, share in row["shares"])
                lines.append(
                    f"  round {row['round']:>3}: {shares} "
                    f"coverage={row['coverage'] * 100:.0f}% "
                    f"up={row['uplink_bytes'] / 1e6:.2f}MB "
                    f"down={row['downlink_bytes'] / 1e6:.2f}MB")

        health = learning_health_summary(stats)
        if health:
            lines.append("")
            lines.append("per-learner learning health (divergence score = "
                         "EWMA cohort-relative robust z; telemetry/health):")
            for row in health:
                loss = ""
                if row["first_loss"] is not None:
                    loss = (f" loss {row['first_loss']:.4f}"
                            f"→{row['last_loss']:.4f}")
                anom = (f" anomalous in {row['anomalous_rounds']} round(s)"
                        if row["anomalous_rounds"] else "")
                lines.append(
                    f"  {row['learner']:<28} div last={row['last_div']:.2f} "
                    f"max={row['max_div']:.2f} "
                    f"upd_norm mean={row['mean_update_norm']:.3g}"
                    f"{loss}{anom}")

    series = metric_series(stats)
    if series:
        lines.append("")
        lines.append("community-model evaluations (mean across learners):")
        for key in sorted(series):
            vals = series[key]
            # "best" follows the metric's direction: loss/error-like
            # metrics improve downward, everything else upward
            lower_better = any(tag in key.lower()
                               for tag in ("loss", "error", "mse", "mae"))
            best = min(vals) if lower_better else max(vals)
            lines.append(
                f"  {key}: first={vals[0]:.4f} best={best:.4f} "
                f"last={vals[-1]:.4f} over {len(vals)} evaluated rounds")
    return "\n".join(lines)


def straggler_summary(stats: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Post-hoc straggler analytics from round metadata: per-learner
    dispatch→uplink durations (``train_submitted_at`` vs
    ``train_received_at``), slowest first, with the mean normalized by
    the cohort median (the same round-relative score the live
    ``DescribeFederation`` snapshot reports as ``straggler_score``).
    Empty when the lineage has no paired timestamps."""
    per_learner: Dict[str, List[float]] = {}
    for meta in stats.get("round_metadata", []):
        submitted = meta.get("train_submitted_at", {}) or {}
        received = meta.get("train_received_at", {}) or {}
        for lid, t_in in received.items():
            t_out = submitted.get(lid)
            if t_out is None:
                continue
            dur = float(t_in) - float(t_out)
            if dur >= 0:
                per_learner.setdefault(lid, []).append(dur)
    if not per_learner:
        return []
    means = {lid: sum(v) / len(v) for lid, v in per_learner.items()}
    med = median(means.values())
    rows = [
        {"learner": lid, "mean_s": means[lid],
         "max_s": max(per_learner[lid]),
         "rel": (means[lid] / med) if med > 0 else 0.0,
         "rounds": len(per_learner[lid])}
        for lid in per_learner
    ]
    rows.sort(key=lambda r: -r["mean_s"])
    return rows


def learning_health_summary(stats: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Post-hoc per-learner convergence/health table from round metadata:
    divergence scores and update norms (``health`` snapshots written by
    telemetry/health.py) joined with the per-learner train-loss
    trajectory (``train_metrics``/``epoch_metrics`` — the fields
    TaskResult always shipped and the controller now records). Sorted by
    last divergence score, highest first. Backward compatible: payloads
    written before the health plane (no ``health``/``train_metrics``
    keys) return []."""
    per: Dict[str, Dict[str, Any]] = {}

    def row(lid: str) -> Dict[str, Any]:
        return per.setdefault(lid, {
            "learner": lid, "last_div": 0.0, "max_div": 0.0,
            "update_norms": [], "anomalous_rounds": 0,
            "first_loss": None, "last_loss": None})

    for meta in stats.get("round_metadata", []):
        health = meta.get("health") or {}
        for lid, score in (health.get("divergence_score") or {}).items():
            r = row(lid)
            r["last_div"] = float(score)
            r["max_div"] = max(r["max_div"], float(score))
        for lid, norm in (health.get("update_norms") or {}).items():
            row(lid)["update_norms"].append(float(norm))
        for lid in health.get("anomalous") or []:
            row(lid)["anomalous_rounds"] += 1
        # train-loss trajectory: prefer the per-epoch records (finest
        # resolution); the task-level train_metrics (a MEAN over the
        # whole task) only fills in for learners with no epoch data
        # this round — it must not overwrite the final-epoch loss
        had_epochs = set()
        for lid, epochs in (meta.get("epoch_metrics") or {}).items():
            losses = [e["loss"] for e in epochs if "loss" in e]
            if losses:
                had_epochs.add(lid)
                r = row(lid)
                if r["first_loss"] is None:
                    r["first_loss"] = float(losses[0])
                r["last_loss"] = float(losses[-1])
        for lid, tm in (meta.get("train_metrics") or {}).items():
            if "loss" in tm and lid not in had_epochs:
                r = row(lid)
                if r["first_loss"] is None:
                    r["first_loss"] = float(tm["loss"])
                r["last_loss"] = float(tm["loss"])
    if not per:
        return []
    rows = []
    for r in per.values():
        norms = r.pop("update_norms")
        r["mean_update_norm"] = (sum(norms) / len(norms)) if norms else 0.0
        rows.append(r)
    rows.sort(key=lambda r: -r["last_div"])
    return rows


def profile_summary(stats: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Post-hoc per-round cost-profile rows from round metadata (the
    ``profile`` dicts the performance observatory records): phase shares
    of round wall-clock (largest first), waterfall coverage, and the
    round's wire-byte totals. Empty for pre-profile payloads (backward
    compatible)."""
    rows: List[Dict[str, Any]] = []
    for meta in stats.get("round_metadata", []):
        prof = meta.get("profile") or {}
        if not prof:
            continue
        wall = float(prof.get("wall_ms", 0.0))
        phases = prof.get("phases") or {}
        shares = sorted(
            ((name, (float(ms) / wall) if wall > 0 else 0.0)
             for name, ms in phases.items()),
            key=lambda kv: -kv[1])
        totals = prof.get("totals") or {}
        rows.append({
            "round": int(prof.get("round",
                                  meta.get("global_iteration", 0))),
            "wall_ms": wall,
            "shares": shares,
            "coverage": float(prof.get("coverage", 0.0)),
            "uplink_bytes": float(totals.get("uplink_bytes", 0.0)),
            "downlink_bytes": float(totals.get("downlink_bytes", 0.0)),
        })
    return rows


def version_lineage(stats: Dict[str, Any]) -> List[Dict[str, int]]:
    """Model-lifecycle lineage from round metadata: one row per round
    that registered a version (``{"round", "registered", "stable"}``).
    Empty for pre-registry payloads (backward compatible)."""
    rows = []
    for meta in stats.get("round_metadata", []):
        reg = int(meta.get("registered_version", 0) or 0)
        if not reg:
            continue
        rows.append({"round": int(meta.get("global_iteration", 0)),
                     "registered": reg,
                     "stable": int(meta.get("stable_version", 0) or 0)})
    return rows


def epoch_loss_series(stats: Dict[str, Any]) -> Dict[str, List[float]]:
    """``{learner: [per-epoch train losses across all rounds, in round
    order]}`` from the ``epoch_metrics`` now recorded in round metadata.
    Empty for pre-health payloads (backward compatible)."""
    series: Dict[str, List[float]] = {}
    for meta in stats.get("round_metadata", []):
        for lid, epochs in (meta.get("epoch_metrics") or {}).items():
            series.setdefault(lid, []).extend(
                float(e["loss"]) for e in epochs if "loss" in e)
    return series


def metric_series(stats: Dict[str, Any]) -> Dict[str, List[float]]:
    """``{"dataset/metric": [per-evaluated-round mean across learners]}``
    from a statistics payload — the series both the text summary and the
    plot draw."""
    series: Dict[str, List[float]] = {}
    for entry in stats.get("community_evaluations", []):
        if not entry.get("evaluations"):
            continue
        per_metric: Dict[str, List[float]] = {}
        for learner_metrics in entry["evaluations"].values():
            for dataset, metrics in learner_metrics.items():
                for name, value in metrics.items():
                    try:
                        per_metric.setdefault(
                            f"{dataset}/{name}", []).append(float(value))
                    except (TypeError, ValueError):
                        continue
        for key, values in per_metric.items():
            series.setdefault(key, []).append(sum(values) / len(values))
    return series


def plot_convergence(stats: Dict[str, Any], path: str) -> str:
    """Write a convergence figure (the reference convergence_plots.py
    role, generalized): one panel of community-metric curves over
    evaluated rounds, one of per-round wall-clock with the aggregation
    share. Requires matplotlib; raises ImportError where unavailable."""
    import matplotlib

    # force=False: a library caller's interactive backend (Jupyter, Qt)
    # must not be clobbered; headless processes resolve to Agg anyway
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    # align every metric to the evaluated-round ordinal it was OBSERVED
    # at (a metric first reported in a later round must not shift left)
    aligned: Dict[str, List[tuple]] = {}
    eval_idx = 0
    for entry in stats.get("community_evaluations", []):
        if not entry.get("evaluations"):
            continue
        eval_idx += 1
        per_metric: Dict[str, List[float]] = {}
        for learner_metrics in entry["evaluations"].values():
            for dataset, metrics in learner_metrics.items():
                for name, value in metrics.items():
                    try:
                        per_metric.setdefault(
                            f"{dataset}/{name}", []).append(float(value))
                    except (TypeError, ValueError):
                        continue
        for key, values in per_metric.items():
            aligned.setdefault(key, []).append(
                (eval_idx, sum(values) / len(values)))
    rounds = stats.get("round_metadata", [])
    fig, axes = plt.subplots(1, 2 if rounds else 1,
                             figsize=(12 if rounds else 7, 4.5))
    ax0 = axes[0] if rounds else axes
    if aligned:
        for key in sorted(aligned):
            xs, ys = zip(*aligned[key])
            ax0.plot(xs, ys, marker="o", label=key)
        ax0.legend(fontsize=8)
    ax0.set_xlabel("evaluated round")
    ax0.set_ylabel("mean across learners")
    ax0.set_title("community-model convergence")
    ax0.grid(alpha=0.3)
    if rounds:
        idx = [m.get("global_iteration", i) for i, m in enumerate(rounds)]
        walls = [max(0.0, m.get("completed_at", 0) - m.get("started_at", 0))
                 for m in rounds]
        aggs = [m.get("aggregation_duration_ms", 0.0) / 1e3 for m in rounds]
        axes[1].bar(idx, walls, label="round wall-clock (s)", alpha=0.7)
        axes[1].bar(idx, aggs, label="aggregation (s)", alpha=0.9)
        axes[1].set_xlabel("round")
        axes[1].set_ylabel("seconds")
        axes[1].set_title("round timing")
        axes[1].legend(fontsize=8)
        axes[1].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv: List[str]) -> int:
    plot_path = None
    if "--plot" in argv:
        i = argv.index("--plot")
        try:
            plot_path = argv[i + 1]
        except IndexError:
            print("--plot requires an output path", file=sys.stderr)
            return 2
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("usage: python -m metisfl_tpu_torch.stats <experiment.json> "
              "[--plot out.png]", file=sys.stderr)
        return 2
    try:
        with open(argv[0]) as fh:
            stats = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"cannot read {argv[0]}: {exc}", file=sys.stderr)
        return 1
    print(summarize(stats))
    if plot_path:
        try:
            print(f"plot written: {plot_convergence(stats, plot_path)}")
        except ImportError:
            print("matplotlib unavailable; no plot written",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
