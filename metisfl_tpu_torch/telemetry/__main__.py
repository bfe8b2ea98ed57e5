"""Trace-viewer CLI: ``python -m metisfl_tpu_torch.telemetry <dir-or-jsonl>...``.

Renders the span trees recorded in one or more JSONL trace sinks
(:mod:`metisfl_tpu_torch.telemetry.trace`) — typically the ``telemetry/``
directory a driver run leaves in its workdir, where controller and
learner files stitch into one tree per federation round via the
wire-propagated trace ids.

    python -m metisfl_tpu_torch.telemetry /tmp/metisfl_tpu_x/telemetry
    python -m metisfl_tpu_torch.telemetry traces.jsonl --round 3
    python -m metisfl_tpu_torch.telemetry traces.jsonl --trace 01ab... --attrs

``--postmortem`` switches to flight-recorder mode: the arguments are
post-mortem bundle files (or directories of them — typically the
``postmortem/`` dir a driver run leaves in its workdir) and the output
is each crashed process's pre-crash timeline — its event-journal tail,
the spans that were still open when it died, and its last metrics
snapshot:

    python -m metisfl_tpu_torch.telemetry --postmortem <workdir>/postmortem
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional


def load_spans(paths: Iterable[str]) -> List[dict]:
    """All span records from JSONL files / directories of them. Unreadable
    lines are skipped (a crashed process can leave a torn tail line)."""
    spans: List[dict] = []
    for path in paths:
        files = (sorted(glob.glob(os.path.join(path, "*.jsonl")))
                 if os.path.isdir(path) else [path])
        for name in files:
            with open(name) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(record, dict) and record.get("span"):
                        spans.append(record)
    return spans


def _fmt_dur(ms: float) -> str:
    return f"{ms / 1e3:.2f}s" if ms >= 1e3 else f"{ms:.1f}ms"


def render_trace(spans: List[dict], show_attrs: bool = False) -> str:
    """One trace's spans (same trace id) as an indented tree, children
    ordered by start time. Spans whose parent never landed in the sink
    (e.g. a process killed mid-round) render as roots."""
    by_id: Dict[str, dict] = {s["span"]: s for s in spans}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent", "")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("start", 0.0))
    roots.sort(key=lambda s: s.get("start", 0.0))

    lines: List[str] = []

    def _walk(span: dict, prefix: str, tail: bool,
              root: bool = False) -> None:
        connector = "" if root else ("└─ " if tail else "├─ ")
        label = (f"{span.get('name', '?')} "
                 f"({_fmt_dur(float(span.get('dur_ms', 0.0)))}) "
                 f"[{span.get('service', '?')}]")
        if show_attrs and span.get("attrs"):
            attrs = " ".join(f"{k}={v}" for k, v in span["attrs"].items())
            label += f"  {{{attrs}}}"
        lines.append(prefix + connector + label)
        kids = children.get(span["span"], [])
        child_prefix = prefix if root else (
            prefix + ("   " if tail else "│  "))
        for i, kid in enumerate(kids):
            _walk(kid, child_prefix, i == len(kids) - 1)

    for root in roots:
        _walk(root, "", True, root=True)
    return "\n".join(lines)


def _root_round(spans: List[dict]) -> Optional[int]:
    for s in spans:
        if not s.get("parent") and "round" in (s.get("attrs") or {}):
            try:
                return int(s["attrs"]["round"])
            except (TypeError, ValueError):
                return None
    return None


def render_postmortem(bundle: dict, show_metrics: bool = False) -> str:
    """One flight-recorder bundle (telemetry/postmortem.py) as text: the
    incident header, the pre-crash event timeline, and the spans that
    never closed."""
    from metisfl_tpu_torch.telemetry import events as _events

    lines: List[str] = []
    when = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(float(bundle.get("time", 0.0))))
    lines.append(
        f"bundle {os.path.basename(bundle.get('_path', '?'))}  "
        f"service={bundle.get('service', '?')} pid={bundle.get('pid', '?')} "
        f"reason={bundle.get('reason', '?')} time={when}"
        + (f" config={bundle['config_hash']}"
           if bundle.get("config_hash") else ""))
    extra = bundle.get("extra") or {}
    if extra:
        lines.append("  " + " ".join(f"{k}={v}" for k, v in extra.items()))
    records = bundle.get("events", [])
    if records:
        t0 = float(records[0].get("ts", 0.0))
        lines.append(f"  events ({len(records)}, "
                     f"seq {records[0].get('seq', '?')}"
                     f"..{records[-1].get('seq', '?')}):")
        for record in records:
            lines.append("    " + _events.format_record(record, t0=t0))
    else:
        lines.append("  events: (journal empty or disabled)")
    open_spans = bundle.get("open_spans", [])
    if open_spans:
        lines.append(f"  open spans at death ({len(open_spans)}):")
        for sp in open_spans:
            attrs = sp.get("attrs") or {}
            attr_s = ("  {" + " ".join(f"{k}={v}" for k, v in attrs.items())
                      + "}") if attrs else ""
            lines.append(
                f"    {sp.get('name', '?')} "
                f"(open {_fmt_dur(float(sp.get('open_ms', 0.0)))}) "
                f"trace={str(sp.get('trace', ''))[:8]}{attr_s}")
    profiles = bundle.get("profiles", [])
    if profiles:
        lines.append(f"  round cost profiles at death ({len(profiles)}):")
        for prof in profiles:
            phases = prof.get("phases") or {}
            top = max(phases, key=phases.get) if phases else "-"
            totals = prof.get("totals") or {}
            lines.append(
                f"    round {prof.get('round', '?')}: "
                f"wall {_fmt_dur(float(prof.get('wall_ms', 0.0)))} "
                f"coverage {float(prof.get('coverage', 0.0)) * 100:.0f}% "
                f"top={top} {_fmt_dur(float(phases.get(top, 0.0)))} "
                f"uplink {int(totals.get('uplink_bytes', 0))}B "
                f"downlink {int(totals.get('downlink_bytes', 0))}B")
    prof = bundle.get("prof") or {}
    if prof:
        top = prof.get("top") or []
        lines.append(
            f"  profiler at death ({prof.get('samples', 0)} stacks @ "
            f"{prof.get('hz', 0.0):g}Hz, top {len(top)} frames):")
        for row in top[:5]:
            lines.append(
                f"    {row.get('frame', '?'):<44} "
                f"self {row.get('self_pct', 0.0):5.1f}%  "
                f"total {row.get('total_pct', 0.0):5.1f}%")
        locks = prof.get("locks") or {}
        contended = [(site, row) for site, row in locks.items()
                     if row.get("contentions")]
        contended.sort(key=lambda kv: -kv[1].get("wait_s_total", 0.0))
        if contended:
            lines.append(f"  lock contention at death "
                         f"({len(contended)} site(s)):")
            for site, row in contended[:5]:
                lines.append(
                    f"    {site:<28} waits={row.get('contentions', 0)} "
                    f"total={row.get('wait_s_total', 0.0) * 1e3:.1f}ms "
                    f"max={row.get('wait_s_max', 0.0) * 1e3:.1f}ms "
                    f"acquires={row.get('acquisitions', 0)}")
    alerts = bundle.get("alerts") or {}
    if alerts:
        active = alerts.get("active") or []
        if active:
            lines.append(f"  alerts at death ({len(active)} firing, "
                         f"{alerts.get('fired_total', 0)} fired / "
                         f"{alerts.get('resolved_total', 0)} resolved "
                         "this run):")
            for alert in active:
                lines.append(
                    f"    FIRING {alert.get('name', '?')} "
                    f"[{alert.get('severity', '?')}] "
                    f"{alert.get('expr', '')} value="
                    f"{alert.get('value', 0.0):g} for "
                    f"{alert.get('active_s', 0.0):.1f}s")
        else:
            lines.append(
                f"  alerts at death: none firing "
                f"({alerts.get('rules', 0)} rule(s), "
                f"{alerts.get('fired_total', 0)} fired / "
                f"{alerts.get('resolved_total', 0)} resolved this run)")
    metrics_text = bundle.get("metrics", "")
    n_series = sum(1 for line in metrics_text.splitlines()
                   if line and not line.startswith("#"))
    lines.append(f"  metrics snapshot: {n_series} series"
                 + ("" if show_metrics else
                    " (re-run with --metrics to print)"))
    if show_metrics and metrics_text:
        lines.extend("    " + line for line in metrics_text.splitlines())
    return "\n".join(lines)


def _postmortem_main(argv: List[str]) -> int:
    from metisfl_tpu_torch.telemetry import postmortem as _postmortem

    show_metrics = "--metrics" in argv
    argv = [a for a in argv if a != "--metrics"]
    if not argv:
        print("usage: python -m metisfl_tpu_torch.telemetry --postmortem "
              "<bundle.json | postmortem-dir>... [--metrics]",
              file=sys.stderr)
        return 2
    bundles = _postmortem.load_bundles(argv)
    if not bundles:
        print("no post-mortem bundles found", file=sys.stderr)
        return 1
    for bundle in bundles:
        print(render_postmortem(bundle, show_metrics=show_metrics))
        print()
    return 0


def main(argv: List[str]) -> int:
    if "--postmortem" in argv:
        return _postmortem_main([a for a in argv if a != "--postmortem"])
    show_attrs = "--attrs" in argv
    argv = [a for a in argv if a != "--attrs"]
    want_trace = want_round = None
    for flag in ("--trace", "--round"):
        if flag in argv:
            i = argv.index(flag)
            try:
                value = argv[i + 1]
            except IndexError:
                print(f"{flag} requires a value", file=sys.stderr)
                return 2
            if flag == "--trace":
                want_trace = value
            else:
                try:
                    want_round = int(value)
                except ValueError:
                    print("--round requires an integer", file=sys.stderr)
                    return 2
            argv = argv[:i] + argv[i + 2:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m metisfl_tpu_torch.telemetry <dir-or-jsonl>... "
              "[--trace ID] [--round N] [--attrs]", file=sys.stderr)
        return 2

    try:
        spans = load_spans(argv)
    except OSError as exc:
        print(f"cannot read traces: {exc}", file=sys.stderr)
        return 1
    if not spans:
        print("no spans found", file=sys.stderr)
        return 1

    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s.get("trace", "?"), []).append(s)
    # stable order: by each trace's earliest span
    ordered = sorted(by_trace.items(),
                     key=lambda kv: min(s.get("start", 0.0)
                                        for s in kv[1]))
    shown = 0
    for trace_id, group in ordered:
        if want_trace and not trace_id.startswith(want_trace):
            continue
        if want_round is not None and _root_round(group) != want_round:
            continue
        round_no = _root_round(group)
        tag = f" round={round_no}" if round_no is not None else ""
        print(f"trace {trace_id}{tag} ({len(group)} spans)")
        print(render_trace(group, show_attrs=show_attrs))
        print()
        shown += 1
    if not shown:
        print("no matching traces", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
