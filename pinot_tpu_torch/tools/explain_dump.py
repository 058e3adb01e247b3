"""Pretty-print an EXPLAIN / EXPLAIN ANALYZE plan tree as ASCII (copy of
``pinot_tpu.tools.explain_dump``, jax-free).

Input is the ``explain`` object a broker returns for an EXPLAIN query
(``BrokerResponse.to_json()["explain"]`` — see ``engine/explain.py``
for the node schema), either from a saved response JSON / bare explain
JSON on disk or stdin, or fetched live with ``--broker ... --pql``
(the EXPLAIN prefix is added automatically unless already present;
``--analyze`` upgrades it to EXPLAIN ANALYZE).

Usage:
  python -m pinot_tpu_torch.tools.explain_dump response.json
  python -m pinot_tpu_torch.tools.explain_dump --broker http://127.0.0.1:8099 \\
      --pql "SELECT count(*) FROM myTable" [--analyze]

EXPLAIN ANALYZE renders estimated-vs-actual side by side with the
delta highlighted (``!`` marks a >2x miss) — the estimate-quality
feedback loop for the plan-stats registry.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _fmt_cost(cost: Dict[str, Any]) -> str:
    # nested dicts (perQuery, roofline) render on their own lines
    return "  ".join(
        f"{k}={round(v, 3) if isinstance(v, float) else v}"
        for k, v in sorted(cost.items())
        if not isinstance(v, dict)
    )


def _fmt_qty(v: float) -> str:
    """1.23e9 -> '1.23G' (flops / bytes-scale quantities)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return str(v)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.0f}"


def render_cost_analysis(dev: Dict[str, Any]) -> str:
    """The compile/cost-analysis block of a device plan node: static
    flops / bytes-accessed estimates when the analysis landed, the
    explicit 'unavailable'/'pending' states otherwise."""
    comp = dev.get("compile") or {}
    ca = comp.get("costAnalysis")
    if isinstance(ca, dict):
        parts = []
        if "flops" in ca:
            parts.append(f"est flops={_fmt_qty(ca['flops'])}")
        if "bytesAccessed" in ca:
            parts.append(f"est bytes={_fmt_qty(ca['bytesAccessed'])}")
        if "peakMemoryBytes" in ca:
            parts.append(f"peak mem={_fmt_qty(ca['peakMemoryBytes'])}")
        src = ca.get("source")
        return (
            "  cost-analysis: " + "  ".join(parts)
            + (f"  ({src})" if src else "") + "\n"
        )
    if ca in ("unavailable", "pending"):
        return f"  cost-analysis: {ca}\n"
    return ""


def render_roofline(est: Dict[str, Any], indent: str = "  ") -> str:
    """Achieved-utilization footer for a shape that has executed on
    device (the plan-stats roofline riding EXPLAIN's history
    estimate): measured achieved bytes/s + FLOP/s against the declared
    platform peaks."""
    roof = (est or {}).get("roofline")
    if not isinstance(roof, dict):
        return ""
    parts = [f"achieved={_fmt_qty(roof.get('achievedBytesPerSec', 0))}B/s"]
    if roof.get("achievedFlopsPerSec"):
        parts.append(f"{_fmt_qty(roof['achievedFlopsPerSec'])}FLOP/s")
    frac = roof.get("rooflineFraction")
    parts.append(
        "roofline=n/a (no peak declared)"
        if frac is None
        else f"roofline={float(frac) * 100.0:.2f}%"
    )
    return indent + "utilization: " + "  ".join(parts) + "\n"


def _delta_line(est: float, act: float, label: str) -> str:
    """estimated vs actual with the ratio highlighted."""
    if est <= 0 and act <= 0:
        return ""
    ratio = act / est if est > 0 else float("inf")
    flag = " !" if (ratio > 2.0 or ratio < 0.5) else ""
    shown = f"{ratio:.2f}x" if est > 0 else "n/a"
    return f"    {label}: est={int(est)}  actual={int(act)}  ({shown}){flag}\n"


def render_join_node(join: Dict[str, Any]) -> str:
    """Join-plan block (broker/joinplan.py node): the chosen strategy,
    the colocation verdict, per-side estimates vs actuals, and the
    heavy-hitter split decision.  Pure; unit-testable."""
    lines: List[str] = []
    forced = "  (forced)" if join.get("forced") else ""
    lines.append(f"join: {join.get('strategy')}{forced}  on {join.get('on')}")
    colo = join.get("colocated") or {}
    lines.append(
        f"  colocated: {'eligible' if colo.get('eligible') else 'ineligible'}"
        f" — {colo.get('reason', '')}"
    )
    build = join.get("build") or {}
    if build:
        est_rows = build.get("estRows")
        est_b = build.get("estBytes")
        lines.append(
            f"  build side {build.get('table')}: est "
            f"{est_rows if est_rows is not None else '?'} rows / "
            f"{_fmt_qty(est_b) if est_b is not None else '?'}B "
            f"(source={build.get('estSource') or 'none'})"
        )
    budget = join.get("budget") or {}
    if budget:
        lines.append(
            f"  broadcast budget: {budget.get('broadcastRows')} rows / "
            f"{_fmt_qty(budget.get('broadcastBytes', 0))}B"
        )
    skew = join.get("skew") or {}
    if skew:
        lines.append(
            f"  skew: split={'on' if skew.get('splitEnabled') else 'OFF'}  "
            f"heavyFactor={skew.get('heavyFactor')}"
        )
    actual = join.get("actual") or {}
    if actual:
        parts = [f"strategy={actual.get('strategy')}"]
        for k in ("buildRows", "probeRows", "broadcastBytes", "shuffleBytes",
                  "heavyHitterSplits", "owners"):
            if actual.get(k) is not None:
                parts.append(f"{k}={actual[k]}")
        lines.append("  actual: " + "  ".join(parts))
        per = actual.get("shuffleBytesPerServer") or {}
        if per:
            mean = sum(per.values()) / max(1, len(per))
            worst = max(per.values()) / mean if mean else 0.0
            lines.append(
                "  shuffle bytes/server: "
                + "  ".join(f"{s}={_fmt_qty(v)}B" for s, v in sorted(per.items()))
                + f"  (max/mean={worst:.2f}x)"
            )
    return "\n".join(lines) + "\n"


def render_explain(obj: Dict[str, Any]) -> str:
    """Full response JSON or bare explain object -> ASCII tree.  Pure;
    unit-testable."""
    explain = obj.get("explain") if isinstance(obj, dict) and "explain" in obj else obj
    if not isinstance(explain, dict) or "servers" not in explain:
        return "(no explain tree in input — was the query EXPLAIN-prefixed?)\n"
    mode = explain.get("mode", "plan")
    lines: List[str] = []
    lines.append(
        f"EXPLAIN{' ANALYZE' if mode == 'analyze' else ''}  "
        f"digest={explain.get('planDigest')}  {explain.get('summary', '')}"
    )
    tiers = explain.get("tierCounts") or {}
    if tiers:
        lines.append(
            "tiers: "
            + "  ".join(f"{k}={v}" for k, v in sorted(tiers.items()))
        )
    est = explain.get("estimatedCost") or {}
    if est:
        lines.append(f"estimated: {_fmt_cost(est)}")
    join = explain.get("join")
    if join:
        lines.extend(render_join_node(join).rstrip("\n").split("\n"))
    out = "\n".join(lines) + "\n"

    for node in explain.get("servers") or []:
        out += (
            f"server {node.get('server')}  table={node.get('table')}  "
            f"segments={node.get('numSegments')}  docs={node.get('totalDocs')}\n"
        )
        dev = node.get("device")
        if dev:
            comp = dev.get("compile") or {}
            comp_str = comp.get("state", "?")
            if comp.get("firstCallMs") is not None:
                comp_str += f" (firstCallMs={comp['firstCallMs']})"
            quarantined = "  QUARANTINED" if dev.get("quarantined") else ""
            out += (
                f"  device plan {dev.get('planDigest')}  "
                f"compile={comp_str}{quarantined}\n"
            )
            mesh = dev.get("mesh")
            if mesh:
                # mesh execution decision (engine/mesh.py): which lane
                # serves the shape and what the merge lowers to
                coll = mesh.get("collective")
                out += (
                    f"  mesh {mesh.get('shape')}  lane={mesh.get('laneIndex')}"
                    f"/{mesh.get('lanes')}  "
                    + (
                        f"shard={mesh.get('shardAxis')}  "
                        f"collective={','.join(coll)}\n"
                        if mesh.get("shardAxis")
                        else "single-chip (no sharding)\n"
                    )
                )
            out += render_cost_analysis(dev)
        staged = node.get("staged") or {}
        if staged.get("hbmBytes"):
            out += (
                f"  staged: {staged['hbmBytes']} bytes in HBM "
                f"({len(staged.get('columns') or [])} columns)\n"
            )
        by_tier: Dict[str, List[Dict[str, Any]]] = {}
        for seg in node.get("segments") or []:
            by_tier.setdefault(seg.get("tier", "?"), []).append(seg)
        for tier, segs in sorted(by_tier.items()):
            out += f"  {tier} x{len(segs)}: {segs[0].get('reason', '')}\n"
            for seg in segs:
                extra = ""
                if "candidateFraction" in seg:
                    extra = f"  candidateFraction={seg['candidateFraction']}"
                if "drivingColumn" in seg and seg["drivingColumn"]:
                    extra += f"  drivingColumn={seg['drivingColumn']}"
                out += f"    - {seg.get('segment')}{extra}\n"
        node_est = node.get("estimatedCost") or {}
        if mode == "analyze":
            actual = node.get("actualCost") or {}
            out += f"  actual: {_fmt_cost(actual)}\n"
            est_bytes = float(
                node_est.get("bytesScanned")
                or (node_est.get("perQuery") or {}).get("bytesScanned", 0)
                or 0
            )
            out += _delta_line(
                est_bytes, float(actual.get("bytesScanned", 0)), "bytesScanned"
            )
            out += render_roofline(node_est)
        elif node_est:
            out += f"  estimated: {_fmt_cost(node_est)}\n"
            out += render_roofline(node_est)

    if mode == "analyze":
        actual = explain.get("actualCost") or {}
        if actual:
            out += f"actual (merged): {_fmt_cost(actual)}\n"
        est_bytes = float((explain.get("estimatedCost") or {}).get("bytesScanned", 0))
        out += _delta_line(
            est_bytes, float(actual.get("bytesScanned", 0)), "bytesScanned (total)"
        )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pinot_tpu_torch-explain-dump", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("file", nargs="?", help="broker response / explain JSON (default stdin)")
    p.add_argument("--broker", help="broker base URL: run --pql live")
    p.add_argument("--pql", help="query to explain against --broker")
    p.add_argument(
        "--analyze", action="store_true",
        help="use EXPLAIN ANALYZE (executes the query)",
    )
    args = p.parse_args(argv)
    if bool(args.broker) != bool(args.pql):
        p.error("--broker and --pql must be given together")

    if args.broker and args.pql:
        import urllib.request

        pql = args.pql.strip()
        if not pql.upper().startswith("EXPLAIN"):
            pql = ("EXPLAIN ANALYZE " if args.analyze else "EXPLAIN ") + pql
        req = urllib.request.Request(
            args.broker.rstrip("/") + "/query",
            data=json.dumps({"pql": pql}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            obj = json.loads(r.read())
    elif args.file:
        with open(args.file) as f:
            obj = json.load(f)
    else:
        obj = json.load(sys.stdin)

    text = render_explain(obj)
    sys.stdout.write(text)
    return 1 if text.startswith("(no explain tree") else 0


if __name__ == "__main__":
    raise SystemExit(main())
