"""Trace-file reporter: ``python -m repro_torch.obs.report trace.json``.

Reads a Chrome trace-event file written by `repro_torch.obs.trace.export`,
rebuilds the span tree (events nest by containment per thread — the same
rule Perfetto renders by), and prints:

* an indented per-span table — call count, total wall, self wall (total
  minus child spans), and host->device bytes attributed to the subtree;
* the span *coverage*: how much of the trace's wall clock the root spans
  account for (the acceptance bar is >= 90% on a traced sweep — anything
  lower means an uninstrumented stage is hiding);
* the meters snapshot embedded in ``otherData``.

Exit status: 0 on a non-empty span tree, 2 on an empty or unreadable trace
— CI's smoke step runs this against the traced-sweep artifact.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["load_events", "build_tree", "aggregate", "format_report", "main"]


def load_events(path: str) -> Tuple[List[Dict], Dict]:
    """(complete-span events, otherData) from a trace file."""
    with open(path) as fh:
        doc = json.load(fh)
    events = [ev for ev in doc.get("traceEvents", [])
              if ev.get("ph") == "X" and "ts" in ev and "dur" in ev]
    return events, doc.get("otherData", {})


def build_tree(events: Sequence[Dict]) -> List[Dict]:
    """Nest spans by per-thread interval containment.

    Returns root nodes ``{"event", "children": [...]}``; within one thread
    a span whose [ts, ts+dur] sits inside another's is its child (ties
    resolved by start order, which is also stack order).
    """
    roots: List[Dict] = []
    by_tid: Dict[object, List[Dict]] = {}
    for ev in events:
        by_tid.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for group in by_tid.values():
        group.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict] = []
        for ev in group:
            node = {"event": ev, "children": []}
            end = ev["ts"] + ev["dur"]
            while stack:
                top = stack[-1]["event"]
                if ev["ts"] >= top["ts"] + top["dur"] - 1e-9:
                    stack.pop()
                    continue
                if end <= top["ts"] + top["dur"] + 1e-9:
                    break
                stack.pop()
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
    return roots


def aggregate(roots: Sequence[Dict]) -> List[Dict]:
    """Collapse the tree into per-path rows (depth-first order).

    Each row: name, depth, count, total_ms, self_ms, h2d_mb — spans with
    the same name at the same tree path merge, so loops (MWU rounds, sweep
    tiles) read as one line with a count.
    """
    rows: List[Dict] = []

    def visit(nodes: Sequence[Dict], depth: int) -> None:
        merged: Dict[str, Dict] = {}
        order: List[str] = []
        for node in nodes:
            ev = node["event"]
            name = ev["name"]
            if name not in merged:
                merged[name] = {"name": name, "depth": depth, "count": 0,
                                "total_ms": 0.0, "child_ms": 0.0,
                                "h2d_bytes": 0, "children": []}
                order.append(name)
            row = merged[name]
            row["count"] += 1
            row["total_ms"] += ev["dur"] / 1e3
            row["child_ms"] += sum(c["event"]["dur"] for c in
                                   node["children"]) / 1e3
            row["h2d_bytes"] += int(ev.get("args", {}).get("h2d_bytes", 0))
            row["children"].extend(node["children"])
        for name in order:
            row = merged[name]
            row["self_ms"] = max(0.0, row["total_ms"] - row["child_ms"])
            children = row.pop("children")
            row.pop("child_ms")
            rows.append(row)
            visit(children, depth + 1)

    visit(roots, 0)
    return rows


def coverage(events: Sequence[Dict], roots: Sequence[Dict]) -> float:
    """Fraction of the trace's wall clock covered by root spans."""
    if not events:
        return 0.0
    t0 = min(ev["ts"] for ev in events)
    t1 = max(ev["ts"] + ev["dur"] for ev in events)
    wall = t1 - t0
    if wall <= 0:
        return 1.0
    covered = sum(node["event"]["dur"] for node in roots)
    return min(1.0, covered / wall)


def format_report(events: Sequence[Dict], other: Optional[Dict] = None
                  ) -> str:
    roots = build_tree(events)
    rows = aggregate(roots)
    width = max([24] + [2 * r["depth"] + len(r["name"]) for r in rows]) + 2
    lines = [f"{'span':<{width}}{'count':>6}{'total-ms':>11}"
             f"{'self-ms':>10}{'h2d-MB':>9}"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        mb = r["h2d_bytes"] / 2**20
        lines.append(
            f"{'  ' * r['depth'] + r['name']:<{width}}{r['count']:>6d}"
            f"{r['total_ms']:>11.1f}{r['self_ms']:>10.1f}"
            f"{mb:>9.2f}" if mb else
            f"{'  ' * r['depth'] + r['name']:<{width}}{r['count']:>6d}"
            f"{r['total_ms']:>11.1f}{r['self_ms']:>10.1f}{'':>9}")
    lines.append("")
    lines.append(f"spans: {sum(r['count'] for r in rows)} "
                 f"({len(rows)} distinct paths)   "
                 f"root coverage: {coverage(events, roots):.1%} of wall")
    meters = (other or {}).get("meters") or {}
    if meters:
        lines.append("")
        lines.append("meters:")
        for name, desc in meters.items():
            vals = ", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                             else f"{k}={v}"
                             for k, v in desc.items() if k != "type")
            lines.append(f"  {name:<32} {desc.get('type', '?'):<10} {vals}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace-event JSON written by "
                                  "--trace / repro_torch.obs.export")
    args = ap.parse_args(argv)
    try:
        events, other = load_events(args.trace)
    except (OSError, ValueError) as exc:
        print(f"[report] unreadable trace {args.trace}: {exc}",
              file=sys.stderr)
        return 2
    if not events:
        print(f"[report] {args.trace} holds no spans — was tracing enabled?",
              file=sys.stderr)
        return 2
    try:
        print(format_report(events, other))
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
