"""Summarize a telemetry JSONL sink on the terminal or as HTML (a copy of
src/repro/telemetry/metrics_report.py).

    python -m repro_torch.telemetry.metrics_report run.jsonl [--html report.html]

Reads the records a training/serving run emitted (train_step / event /
serve_request / serve_summary / run_meta), dedups replayed train steps
(rollback re-emits deterministic duplicates — last record wins), and prints:

* step-time p50/p99 (post-warmup), final loss/ppl
* per-layer AvgMaxVio / SupMaxVio and the per-expert load observatory
  (total counts per expert per layer, imbalance = max/mean)
* BIP dual health (q magnitude, forecaster error / window-hit rate)
* guard/fault events
* serving TTFT / ITL / queue-wait quantiles and shed/deadline counters

The HTML report is self-contained (inline SVG bars, no external assets).
"""
from __future__ import annotations

import argparse
import html
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np


def load_records(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line of a crashed run
    return records


def dedup_steps(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Keep the LAST record per step (rollback replays re-emit steps)."""
    by_step: Dict[int, Dict[str, Any]] = {}
    for r in records:
        if r.get("kind") == "train_step":
            by_step[int(r["step"])] = r
    return [by_step[s] for s in sorted(by_step)]


def _col(steps: List[Dict[str, Any]], key: str) -> List[Any]:
    return [r[key] for r in steps if key in r and r[key] is not None]


def _q(vals, p):
    return float(np.percentile(vals, p)) if len(vals) else None


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    steps = dedup_steps(records)
    events = [r for r in records if r.get("kind") == "event"]
    serve = [r for r in records if r.get("kind") == "serve_summary"]
    out: Dict[str, Any] = {"n_steps": len(steps), "n_events": len(events)}

    times = _col(steps, "step_time")
    if len(times) > 2:
        times = times[2:]  # drop compile steps
    if times:
        out["step_time_p50"] = _q(times, 50)
        out["step_time_p99"] = _q(times, 99)

    losses = _col(steps, "ce_loss") or _col(steps, "loss")
    if losses:
        out["final_loss"] = float(losses[-1])
    ppl = _col(steps, "perplexity")
    if ppl:
        out["final_ppl"] = float(ppl[-1])

    vios = _col(steps, "max_vio_per_layer")
    if vios:
        v = np.asarray(vios, np.float64)  # (T, L)
        if v.ndim == 2 and v.shape[1]:
            out["AvgMaxVio_per_layer"] = v.mean(axis=0).tolist()
            out["SupMaxVio_per_layer"] = v.max(axis=0).tolist()
            out["AvgMaxVio"] = float(v.max(axis=1).mean())
            out["SupMaxVio"] = float(v.max())

    loads = _col(steps, "load_per_layer")
    if loads:
        ld = np.asarray(loads, np.int64)  # (T, L, m)
        if ld.ndim == 3 and ld.size:
            total = ld.sum(axis=0)  # (L, m)
            out["load_total_per_layer"] = total.tolist()
            mean = np.maximum(total.mean(axis=1, keepdims=True), 1e-9)
            out["load_imbalance_per_layer"] = (
                total.max(axis=1) / mean[:, 0]
            ).tolist()

    for key in ("q_abs_max_per_layer", "forecast_err_per_layer"):
        col = _col(steps, key)
        if col:
            out[key.replace("_per_layer", "_final")] = np.asarray(
                col[-1], np.float64
            ).tolist()
    hits = _col(steps, "forecast_hit_per_layer")
    if hits:
        out["forecast_hit_rate"] = float(np.mean(np.asarray(hits, np.float64)))

    dropped = _col(steps, "dropped_frac_cap1_per_layer")
    if dropped:
        out["dropped_frac_cap1_mean"] = float(
            np.mean(np.asarray(dropped, np.float64))
        )

    if events:
        out["events"] = [dict(e) for e in events]
    if serve:
        out["serve"] = serve[-1]
    return out


def print_summary(s: Dict[str, Any], file=sys.stdout) -> None:
    p = lambda *a: print(*a, file=file)
    p(f"telemetry: {s['n_steps']} train steps, {s['n_events']} events")
    if "step_time_p50" in s:
        p(
            f"  step time  p50 {s['step_time_p50'] * 1e3:8.2f} ms   "
            f"p99 {s['step_time_p99'] * 1e3:8.2f} ms"
        )
    if "final_loss" in s:
        line = f"  final loss {s['final_loss']:.4f}"
        if "final_ppl" in s:
            line += f"   ppl {s['final_ppl']:.2f}"
        p(line)
    if "AvgMaxVio" in s:
        p(f"  AvgMaxVio {s['AvgMaxVio']:.4f}   SupMaxVio {s['SupMaxVio']:.4f}")
        per = s.get("AvgMaxVio_per_layer", [])
        for i, (a, m) in enumerate(zip(per, s.get("SupMaxVio_per_layer", per))):
            p(f"    layer {i:2d}  avg {a:7.4f}  sup {m:7.4f}")
    if "load_imbalance_per_layer" in s:
        p("  per-expert load (total counts; imbalance = max/mean):")
        for i, imb in enumerate(s["load_imbalance_per_layer"]):
            p(f"    layer {i:2d}  imbalance {imb:6.3f}")
    if "q_abs_max_final" in s:
        q = s["q_abs_max_final"]
        p(f"  dual |q| max (final): {max(q):.4f}")
    if "forecast_hit_rate" in s:
        p(f"  forecaster window-hit rate: {s['forecast_hit_rate']:.3f}")
    for e in s.get("events", []):
        p(f"  event: {e}")
    if "serve" in s:
        sv = s["serve"]
        p(
            f"  serving: {sv.get('n_finished', 0)} finished / "
            f"{sv.get('n_shed', 0)} shed / "
            f"{sv.get('n_deadline_missed', 0)} deadline-missed"
        )
        for name in ("ttft", "itl", "queue_wait"):
            h = sv.get(name)
            if h and h.get("n"):
                p(
                    f"    {name:10s} p50 {h['p50'] * 1e3:8.2f} ms  "
                    f"p99 {h['p99'] * 1e3:8.2f} ms  (n={h['n']})"
                )
        p(f"    live MaxVio {sv.get('live_max_vio', 0.0):.4f}")


def _svg_bars(values, width=640, height=60, color="#4a7") -> str:
    if not values:
        return ""
    vmax = max(max(values), 1e-9)
    n = len(values)
    bw = width / n
    bars = []
    for i, v in enumerate(values):
        h = (v / vmax) * (height - 2)
        bars.append(
            f'<rect x="{i * bw:.1f}" y="{height - h:.1f}" '
            f'width="{max(bw - 1, 1):.1f}" height="{h:.1f}" fill="{color}"/>'
        )
    return (
        f'<svg width="{width}" height="{height}" '
        f'xmlns="http://www.w3.org/2000/svg">' + "".join(bars) + "</svg>"
    )


def write_html(s: Dict[str, Any], path: str) -> None:
    parts = [
        "<!doctype html><meta charset='utf-8'><title>telemetry report</title>",
        "<style>body{font-family:monospace;margin:2em}td,th{padding:2px 8px;"
        "text-align:right}table{border-collapse:collapse}th{border-bottom:"
        "1px solid #999}</style>",
        "<h1>telemetry report</h1>",
    ]
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in s.items()
        if not isinstance(v, (list, dict))
    )
    parts.append(f"<table><tr><th>metric</th><th>value</th></tr>{rows}</table>")
    for i, layer in enumerate(s.get("load_total_per_layer", [])):
        parts.append(f"<h3>layer {i} per-expert load</h3>{_svg_bars(layer)}")
    if "serve" in s:
        parts.append("<h2>serving</h2>")
        for name in ("ttft", "itl", "queue_wait"):
            h = s["serve"].get(name)
            if h and h.get("n"):
                parts.append(
                    f"<h3>{name}: p50 {h['p50'] * 1e3:.2f} ms / "
                    f"p99 {h['p99'] * 1e3:.2f} ms</h3>"
                    + _svg_bars(h.get("bucket_count", []))
                )
    with open(path, "w") as f:
        f.write("\n".join(parts))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="telemetry JSONL file")
    ap.add_argument("--html", default=None, help="also write an HTML report")
    args = ap.parse_args(argv)
    s = summarize(load_records(args.path))
    print_summary(s)
    if args.html:
        write_html(s, args.html)
        print(f"wrote {args.html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
