"""Render a run's JSONL event log into a per-phase timing +
curvature-health report.

Counterpart of ``src/repro/obs/summary.py`` (plain Python, kept as a
copy; the log format is shared, so either package's tool reads either
package's logs).

    PYTHONPATH=src python -m repro_torch.obs.summary run/telemetry.jsonl
    PYTHONPATH=src python -m repro_torch.obs.summary run/telemetry.jsonl --json

``--validate`` exits non-zero on any schema violation without printing
the report (the CI telemetry-smoke gate).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence

from repro_torch.obs import events as ev_lib


def _pct(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[i]


def summarize(path: str) -> dict:
    """Aggregate one event log into a JSON-able report dict."""
    events = list(ev_lib.read_events(path))
    out: Dict = {"path": path, "n_events": len(events)}

    steps = [e for e in events if e["type"] == "step"]
    phases: Dict[str, List[float]] = {}
    for e in steps:
        phases.setdefault(e["phase"], []).append(e["dt_s"])
    out["steps"] = {
        "count": len(steps),
        "phases": {ph: {"count": len(ts),
                        "p50_ms": 1e3 * _pct(ts, 0.5),
                        "p99_ms": 1e3 * _pct(ts, 0.99),
                        "total_s": sum(ts)}
                   for ph, ts in sorted(phases.items())},
    }
    if steps:
        out["loss"] = {"first": steps[0]["loss"], "last": steps[-1]["loss"]}

    # metrics windows: counters sum across windows, gauges take the last
    metrics = [e for e in events if e["type"] == "metrics"]
    if metrics:
        agg: Dict[str, float] = {}
        kinds: Dict[str, str] = {}
        for e in metrics:
            kinds.update(e["kinds"])
            for name, v in e["values"].items():
                if e["kinds"].get(name) == "counter":
                    agg[name] = agg.get(name, 0.0) + v
                else:
                    agg[name] = v
        out["metrics"] = {"windows": len(metrics),
                          "last_step": metrics[-1]["step"],
                          "values": agg, "kinds": kinds}

    launches = [e for e in events if e["type"] == "async_launch"]
    lands = [e for e in events if e["type"] == "async_land"]
    misses = [e for e in events if e["type"] == "async_miss"]
    if launches or lands or misses:
        by_reason: Dict[str, int] = {}
        for e in misses:
            r = e.get("reason", "resume")
            by_reason[r] = by_reason.get(r, 0) + 1
        out["async"] = {
            "launches": len(launches),
            "lands": len(lands),
            "overlapped_lands": sum(bool(e["overlapped"]) for e in lands),
            "misses": len(misses),
            "miss_reasons": by_reason,
        }

    # resilience: remediation ladder actions + elastic repartitions
    remedies = [e for e in events if e["type"] == "remediation"]
    reparts = [e for e in events if e["type"] == "repartition"]
    if remedies or reparts:
        by_action: Dict[str, int] = {}
        for e in remedies:
            by_action[e["action"]] = by_action.get(e["action"], 0) + 1
        out["resilience"] = {
            "remediations": len(remedies),
            "actions": by_action,
            "repartitions": len(reparts),
            "last": remedies[-1]["detail"] if remedies else None,
        }

    saves = [e for e in events if e["type"] == "ckpt_save"]
    restores = [e for e in events if e["type"] == "ckpt_restore"]
    if saves or restores:
        out["checkpoint"] = {"saves": len(saves), "restores": len(restores)}

    serve = [e for e in events if e["type"] == "serve_request"]
    tenant_updates = [e for e in events if e["type"] == "tenant_update"]
    if serve:
        tot = [e["total_s"] for e in serve]
        out["serve"] = {"requests": len(serve),
                        "p50_ms": 1e3 * _pct(tot, 0.5),
                        "p99_ms": 1e3 * _pct(tot, 0.99)}
        # per-tenant breakdown (multi-tenant service; events without a
        # tenant field are the single-model engine and stay aggregate)
        by_tenant: Dict[str, List[dict]] = {}
        for e in serve:
            if "tenant" in e:
                by_tenant.setdefault(str(e["tenant"]), []).append(e)
        if by_tenant:
            out["serve"]["tenants"] = {
                t: {"requests": len(es),
                    "finetunes": sum(e.get("kind") == "finetune"
                                     for e in es),
                    "p50_ms": 1e3 * _pct([e["total_s"] for e in es], 0.5),
                    "p99_ms": 1e3 * _pct([e["total_s"] for e in es], 0.99)}
                for t, es in sorted(by_tenant.items(), key=lambda kv:
                                    int(kv[0]))}
    if tenant_updates:
        by_t: Dict[str, List[dict]] = {}
        for e in tenant_updates:
            by_t.setdefault(str(e["tenant"]), []).append(e)
        out["tenant_updates"] = {
            t: {"steps": len(es), "last_step": es[-1]["step"],
                "loss_first": es[0]["loss"], "loss_last": es[-1]["loss"]}
            for t, es in sorted(by_t.items(), key=lambda kv: int(kv[0]))}
    return out


def render(s: dict) -> str:
    lines = [f"== telemetry summary: {s['path']} ({s['n_events']} events) =="]
    st = s.get("steps", {})
    if st.get("count"):
        lines.append(f"steps: {st['count']}")
        lines.append(f"  {'phase':8s} {'count':>6s} {'p50':>9s} "
                     f"{'p99':>9s} {'total':>8s}")
        for ph, row in st["phases"].items():
            lines.append(f"  {ph:8s} {row['count']:6d} "
                         f"{row['p50_ms']:7.1f}ms {row['p99_ms']:7.1f}ms "
                         f"{row['total_s']:7.2f}s")
    if "loss" in s:
        lines.append(f"loss: {s['loss']['first']:.4f} -> "
                     f"{s['loss']['last']:.4f}")
    m = s.get("metrics")
    if m:
        lines.append(f"metrics: {m['windows']} windows "
                     f"(last @ step {m['last_step']})")
        for name in sorted(m["values"]):
            kind = m["kinds"].get(name, "?")
            lines.append(f"  {name:28s} {m['values'][name]:12.6g}  "
                         f"[{kind}]")
    a = s.get("async")
    if a:
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted(a.get("miss_reasons", {}).items()))
        lines.append(f"async pipeline: {a['launches']} launches, "
                     f"{a['lands']} lands "
                     f"({a['overlapped_lands']} overlapped), "
                     f"{a['misses']} misses"
                     + (f" [{reasons}]" if reasons else ""))
    r = s.get("resilience")
    if r:
        acts = ", ".join(f"{k}={v}" for k, v in sorted(r["actions"].items()))
        lines.append(f"resilience: {r['remediations']} remediations"
                     + (f" ({acts})" if acts else "")
                     + f", {r['repartitions']} repartitions")
    c = s.get("checkpoint")
    if c:
        lines.append(f"checkpoints: {c['saves']} saved, "
                     f"{c['restores']} restored")
    sv = s.get("serve")
    if sv:
        lines.append(f"serving: {sv['requests']} requests, "
                     f"p50 {sv['p50_ms']:.1f}ms p99 {sv['p99_ms']:.1f}ms")
        for t, row in sv.get("tenants", {}).items():
            lines.append(f"  tenant {t}: {row['requests']} requests "
                         f"({row['finetunes']} finetune), "
                         f"p50 {row['p50_ms']:.1f}ms "
                         f"p99 {row['p99_ms']:.1f}ms")
    tu = s.get("tenant_updates")
    if tu:
        lines.append(f"tenant fine-tuning: {len(tu)} tenants")
        for t, row in tu.items():
            lines.append(f"  tenant {t}: {row['steps']} steps "
                         f"(-> step {row['last_step']}), loss "
                         f"{row['loss_first']:.4f} -> "
                         f"{row['loss_last']:.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a repro_torch.obs telemetry JSONL log")
    ap.add_argument("path", help="path to telemetry.jsonl")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report dict as JSON")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate only; exit 1 on violation")
    args = ap.parse_args(argv)
    if args.validate:
        try:
            n = sum(1 for _ in ev_lib.read_events(args.path))
        except ev_lib.EventSchemaError as e:
            print(f"schema violation: {e}", file=sys.stderr)
            return 1
        print(f"ok: {n} events valid against schema "
              f"v{ev_lib.SCHEMA_VERSION}")
        return 0
    report = summarize(args.path)
    print(json.dumps(report, indent=2) if args.json else render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
