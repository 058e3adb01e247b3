"""Controller ops UI (the pinot-dashboard Flask app analog; a copy of
``pinot_tpu.controller.dashboard``).

The reference ships a separate Python Flask dashboard
(``pinot-dashboard/pinotui/__init__.py`` — routes for fabric/cluster
lists, per-table info, and a query console ``send_pql``) plus a
controller-side query proxy (``PqlQueryResource.java``). Here the same
surface is served by the controller's own HTTP front: stdlib-rendered
HTML pages over the live ResourceManager state, and a ``/pql`` proxy
that forwards to an alive broker.
"""
from __future__ import annotations

import html as _html
from typing import List
from urllib.parse import quote

_STYLE = """
<style>
  body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 2em;
         color: #1a1a1a; }
  h1, h2 { font-weight: 600; }
  a { color: #0b57d0; text-decoration: none; }
  a:hover { text-decoration: underline; }
  table { border-collapse: collapse; margin: 0.6em 0 1.4em; }
  th, td { border: 1px solid #ccc; padding: 4px 10px; text-align: left;
           font-size: 14px; }
  th { background: #f2f2f2; }
  tr.mismatch { background: #fdd; }
  .ok { color: #188038; } .bad { color: #c5221f; }
  .warn { color: #b06000; }
  nav { margin-bottom: 1.4em; }
  nav a { margin-right: 1.2em; }
  textarea { width: 100%; max-width: 56em; font-family: monospace; }
  pre { background: #f6f8fa; padding: 1em; max-width: 56em;
        overflow-x: auto; font-size: 13px; }
</style>
"""

_NAV = (
    "<nav><a href='/dashboard'>Cluster</a>"
    "<a href='/dashboard/query'>Query console</a>"
    "<a href='/dashboard/metrics'>Metrics</a>"
    "<a href='/dashboard/capacity'>Capacity</a>"
    "<a href='/dashboard/workload'>Workload</a>"
    "<a href='/dashboard/utilization'>Utilization</a>"
    "<a href='/dashboard/slo'>SLOs</a>"
    "<a href='/clusterstate'>Raw state (JSON)</a></nav>"
)


def _esc(v) -> str:
    return _html.escape(str(v))


def _page(title: str, body: List[str]) -> str:
    return (
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title>{_STYLE}</head><body>"
        + _NAV
        + "\n".join(body)
        + "</body></html>"
    )


def render_home(ctrl) -> str:
    """Cluster overview: instances, tenants, tables (cluster_profile.html
    + fabric home of the reference dashboard)."""
    body = ["<h1>pinot_tpu cluster</h1>"]

    body.append("<h2>Instances</h2>")
    body.append(
        "<table><tr><th>name</th><th>role</th><th>status</th>"
        "<th>tags</th><th>url</th></tr>"
    )
    for inst in ctrl.resources.instances_snapshot():
        if not inst.alive:
            status = "<span class='bad'>down</span>"
        elif getattr(inst, "draining", False):
            status = "<span class='warn'>draining</span>"
        else:
            status = "<span class='ok'>alive</span>"
        tags = ", ".join(sorted(getattr(inst, "tags", []) or []))
        body.append(
            f"<tr><td>{_esc(inst.name)}</td><td>{_esc(inst.role)}</td>"
            f"<td>{status}</td><td>{_esc(tags)}</td>"
            f"<td>{_esc(inst.url or '')}</td></tr>"
        )
    body.append("</table>")

    tenants = ctrl.resources.list_tenants()
    if tenants:
        body.append("<h2>Tenants</h2>")
        body.append("<table><tr><th>tenant</th><th>servers</th><th>brokers</th></tr>")
        for t in sorted(tenants):
            body.append(
                f"<tr><td>{_esc(t)}</td>"
                f"<td>{_esc(', '.join(ctrl.resources.tenant_instances(t, 'server')))}</td>"
                f"<td>{_esc(', '.join(ctrl.resources.tenant_instances(t, 'broker')))}</td></tr>"
            )
        body.append("</table>")

    stabilizer = getattr(ctrl, "stabilizer", None)
    if stabilizer is not None:
        events = stabilizer.events()
        if events:
            body.append("<h2>Self-stabilization (recent heal events)</h2>")
            body.append(
                "<table><tr><th>event</th><th>server</th><th>table</th>"
                "<th>segment</th></tr>"
            )
            for ev in list(events)[-12:][::-1]:
                body.append(
                    f"<tr><td>{_esc(ev.get('event'))}</td>"
                    f"<td>{_esc(ev.get('server', ev.get('servers', '')))}</td>"
                    f"<td>{_esc(ev.get('table', ''))}</td>"
                    f"<td>{_esc(ev.get('segment', ''))}</td></tr>"
                )
            body.append("</table>")
            body.append(
                "<p>Full event ring + metrics: "
                "<a href='/debug/stabilizer'>/debug/stabilizer</a></p>"
            )

    body.append("<h2>Tables</h2>")
    body.append(
        "<table><tr><th>table</th><th>segments</th><th>docs</th>"
        "<th>size (bytes)</th><th>converged</th></tr>"
    )
    for table in ctrl.resources.tables():
        ideal = ctrl.resources.get_ideal_state(table)
        view = ctrl.resources.get_external_view(table)
        docs = 0
        for seg in ideal:
            info = ctrl.resources.get_segment_metadata(table, seg) or {}
            meta = info.get("metadata")
            docs += meta.num_docs if meta is not None else 0
        converged = all(ideal[s] == view.get(s, {}) for s in ideal)
        cv = (
            "<span class='ok'>yes</span>"
            if converged
            else "<span class='bad'>no</span>"
        )
        body.append(
            f"<tr><td><a href='/dashboard/table/{quote(table, safe='')}'>{_esc(table)}</a></td>"
            f"<td>{len(ideal)}</td><td>{docs}</td>"
            f"<td>{ctrl.store.table_size_bytes(table)}</td><td>{cv}</td></tr>"
        )
    body.append("</table>")
    return _page("pinot_tpu cluster", body)


def render_table(ctrl, table: str) -> str:
    """Per-table page: schema + per-segment ideal vs external state
    (table_info.html analog; highlights unconverged segments like the
    controller TableViews resource)."""
    body = [f"<h1>{_esc(table)}</h1>"]

    raw = table.rsplit("_", 1)[0]
    schema = ctrl.resources.get_schema(raw) or ctrl.resources.get_schema(table)
    if schema is not None:
        body.append("<h2>Schema</h2>")
        body.append("<table><tr><th>column</th><th>type</th><th>field</th></tr>")
        for spec in schema.all_fields():
            body.append(
                f"<tr><td>{_esc(spec.name)}</td><td>{_esc(spec.data_type.name)}</td>"
                f"<td>{_esc(spec.field_type.name)}</td></tr>"
            )
        body.append("</table>")

    ideal = ctrl.resources.get_ideal_state(table)
    view = ctrl.resources.get_external_view(table)
    body.append("<h2>Segments</h2>")
    body.append(
        "<table><tr><th>segment</th><th>ideal</th><th>external</th>"
        "<th>docs</th></tr>"
    )
    for seg in sorted(ideal):
        info = ctrl.resources.get_segment_metadata(table, seg) or {}
        meta = info.get("metadata")
        docs = meta.num_docs if meta is not None else ""
        cls = " class='mismatch'" if ideal[seg] != view.get(seg, {}) else ""
        body.append(
            f"<tr{cls}><td>{_esc(seg)}</td><td>{_esc(ideal[seg])}</td>"
            f"<td>{_esc(view.get(seg, {}))}</td><td>{docs}</td></tr>"
        )
    body.append("</table>")
    return _page(table, body)


def _metrics_rows(body: List[str], snap: dict) -> None:
    """One registry snapshot -> meter/timer/gauge rows."""
    meters = snap.get("meters") or {}
    timers = snap.get("timers") or {}
    gauges = snap.get("gauges") or {}
    if not (meters or timers or gauges):
        return
    body.append(
        "<table><tr><th>metric</th><th>kind</th><th>count</th>"
        "<th>rate 1m</th><th>mean ms</th><th>p95 ms</th><th>value</th></tr>"
    )
    for name in sorted(meters):
        m = meters[name]
        body.append(
            f"<tr><td>{_esc(name)}</td><td>meter</td><td>{m.get('count')}</td>"
            f"<td>{m.get('rate1m', m.get('rate'))}</td><td></td><td></td><td></td></tr>"
        )
    for name in sorted(timers):
        t = timers[name]
        body.append(
            f"<tr><td>{_esc(name)}</td><td>timer</td><td>{t.get('count')}</td>"
            f"<td></td><td>{t.get('meanMs')}</td><td>{t.get('p95Ms')}</td><td></td></tr>"
        )
    for name in sorted(gauges):
        body.append(
            f"<tr><td>{_esc(name)}</td><td>gauge</td><td></td><td></td>"
            f"<td></td><td></td><td>{_esc(gauges[name])}</td></tr>"
        )
    body.append("</table>")


def render_metrics(ctrl, cluster_metrics: dict) -> str:
    """Cluster-wide metrics page: the controller's own registries plus
    the ``/debug/metrics`` snapshot of every alive instance that
    advertises an HTTP surface (``collect_cluster_metrics``)."""
    body = ["<h1>Cluster metrics</h1>"]
    body.append(
        "<p>Prometheus exposition: controller <a href='/metrics'>/metrics</a>; "
        "every broker and server serves its own <code>/metrics</code> and "
        "<code>/debug/metrics</code>. Raw aggregate: "
        "<a href='/debug/clustermetrics'>/debug/clustermetrics</a>.</p>"
    )
    for scope, snap in (cluster_metrics.get("controller") or {}).items():
        body.append(f"<h2>controller · {_esc(scope)}</h2>")
        _metrics_rows(body, snap or {})
    for name, entry in sorted((cluster_metrics.get("instances") or {}).items()):
        body.append(
            f"<h2>{_esc(entry.get('role', '?'))} · {_esc(name)}</h2>"
        )
        if entry.get("error"):
            body.append(f"<p class='bad'>unreachable: {_esc(entry['error'])}</p>")
            continue
        payload = entry.get("metrics") or {}
        # broker /debug/metrics is a bare registry snapshot; the server
        # one nests it under "metrics" next to scheduler/lane state
        snap = payload.get("metrics") if isinstance(payload.get("metrics"), dict) else payload
        _metrics_rows(body, snap or {})
        heal = payload.get("selfHealing")
        if heal:
            body.append("<table><tr><th>selfHealing</th><th>count</th></tr>")
            for k in sorted(heal):
                body.append(f"<tr><td>{_esc(k)}</td><td>{_esc(heal[k])}</td></tr>")
            body.append("</table>")
    return _page("Cluster metrics", body)


def _fmt_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return str(n)


def render_capacity(ctrl, capacity: dict) -> str:
    """Cluster capacity & cost page (``collect_capacity`` rollup): HBM
    staging ledgers and ingest lag per server, per-table cost rates —
    the one page that shows who is burning the cluster."""
    totals = capacity.get("totals") or {}
    body = ["<h1>Capacity &amp; cost</h1>"]
    body.append(
        f"<p>Staged HBM (all servers): <b>{_fmt_bytes(totals.get('stagedBytes', 0))}</b>"
        f" &middot; ingest lag: <b>{totals.get('ingestLagRows', 0)}</b> rows"
        f" &middot; raw JSON: <a href='/debug/capacity'>/debug/capacity</a></p>"
    )
    unreachable = capacity.get("unreachable") or {}
    if unreachable:
        names = ", ".join(
            f"{_esc(n)} ({_esc(e.get('role', '?'))})"
            for n, e in sorted(unreachable.items())
        )
        body.append(
            f"<p class='bad'>Partial rollup — unreachable: {names}</p>"
        )

    body.append("<h2>Servers — HBM staging ledger &amp; ingest</h2>")
    body.append(
        "<table><tr><th>server</th><th>staged</th><th>high-water</th>"
        "<th>tables</th><th>evicted</th><th>qinput cache</th>"
        "<th>ingest lag (rows)</th><th>ingest rows/s (1m)</th></tr>"
    )
    for name, entry in sorted((capacity.get("servers") or {}).items()):
        if entry.get("error"):
            body.append(
                f"<tr><td>{_esc(name)}</td><td colspan='7' class='bad'>"
                f"unreachable: {_esc(entry['error'])}</td></tr>"
            )
            continue
        hbm = entry.get("hbm") or {}
        lag = entry.get("ingestLag") or {}
        lag_str = (
            ", ".join(f"{_esc(k)}={v}" for k, v in sorted(lag.items())) or "0"
        )
        rows = entry.get("ingestRows") or {}
        body.append(
            f"<tr><td>{_esc(name)}</td>"
            f"<td>{_fmt_bytes(hbm.get('stagedBytes', 0))}</td>"
            f"<td>{_fmt_bytes(hbm.get('highWatermarkBytes', 0))}</td>"
            f"<td>{hbm.get('stagedTables', 0)}</td>"
            f"<td>{_fmt_bytes(hbm.get('evictedBytes', 0))}</td>"
            f"<td>{_fmt_bytes(hbm.get('qinputCacheBytes', 0))}</td>"
            f"<td>{_esc(lag_str)}</td>"
            f"<td>{rows.get('rate1m', 0)}</td></tr>"
        )
    body.append("</table>")

    body.append("<h2>Per-table cost (broker-attributed)</h2>")
    tables = capacity.get("tables") or {}
    if not tables:
        body.append("<p>No per-table cost recorded yet (no queries).</p>")
    else:
        body.append(
            "<table><tr><th>table</th><th>docs scanned</th>"
            "<th>docs/s (1m)</th><th>bytes scanned</th><th>bytes/s (1m)</th></tr>"
        )
        ordered = sorted(
            tables.items(),
            key=lambda kv: -float(kv[1].get("bytesScanned", 0) or 0),
        )
        for tname, t in ordered:
            body.append(
                f"<tr><td>{_esc(tname)}</td>"
                f"<td>{t.get('docsScanned', 0)}</td>"
                f"<td>{t.get('docsScannedRate1m', 0)}</td>"
                f"<td>{_fmt_bytes(t.get('bytesScanned', 0))}</td>"
                f"<td>{_fmt_bytes(t.get('bytesScannedRate1m', 0))}/s</td></tr>"
            )
        body.append("</table>")
    return _page("Capacity & cost", body)


def _workload_table(body: List[str], plans: List[dict], title: str) -> None:
    body.append(f"<h2>{_esc(title)}</h2>")
    if not plans:
        body.append("<p>No plans recorded yet (no queries).</p>")
        return
    body.append(
        "<table><tr><th>digest</th><th>shape</th><th>table</th>"
        "<th>execs</th><th>shed</th><th>failed</th><th>docs</th>"
        "<th>bytes</th><th>device ms</th><th>host ms</th><th>tier mix</th></tr>"
    )
    for p in plans:
        cost = p.get("cost") or {}
        tiers = ", ".join(
            f"{k[len('segments'):]}={int(v)}"
            for k, v in sorted(cost.items())
            if k.startswith("segments")
        )
        body.append(
            f"<tr><td><code>{_esc(p.get('digest'))}</code></td>"
            f"<td>{_esc(p.get('summary', ''))}</td>"
            f"<td>{_esc(p.get('table', ''))}</td>"
            f"<td>{p.get('count', 0)}</td>"
            f"<td>{p.get('shedCount', 0)}</td>"
            f"<td>{p.get('failedCount', 0)}</td>"
            f"<td>{p.get('docsScanned', 0)}</td>"
            f"<td>{_fmt_bytes(cost.get('bytesScanned', 0))}</td>"
            f"<td>{round(float(cost.get('deviceMs', 0)), 1)}</td>"
            f"<td>{round(float(cost.get('hostMs', 0)), 1)}</td>"
            f"<td>{_esc(tiers)}</td></tr>"
        )
    body.append("</table>")


def render_workload(ctrl, workload: dict) -> str:
    """Cluster workload page (``collect_workload`` roll-up): the plan
    shapes dominating the fleet by frequency and by cost — the direct
    input to "which plan shapes should batched serving target?"."""
    body = ["<h1>Workload — plan shapes</h1>"]
    body.append(
        f"<p>Brokers polled: <b>{workload.get('brokers', 0)}</b>"
        f" &middot; distinct shapes: <b>{workload.get('digests', 0)}</b>"
        f" &middot; responses recorded: <b>{workload.get('totalRecorded', 0)}</b>"
        f" &middot; raw JSON: <a href='/debug/workload'>/debug/workload</a></p>"
    )
    unreachable = workload.get("unreachable") or {}
    if unreachable:
        names = ", ".join(_esc(n) for n in sorted(unreachable))
        body.append(f"<p class='bad'>Partial roll-up — unreachable: {names}</p>")
    _workload_table(body, workload.get("topByCount") or [], "Top by frequency")
    _workload_table(body, workload.get("topByCost") or [], "Top by cost")
    return _page("Workload", body)


def _fmt_frac(v) -> str:
    if v is None:
        return "n/a (no peak declared)"
    try:
        return f"{float(v) * 100.0:.2f}%"
    except (TypeError, ValueError):
        return str(v)


def render_utilization(ctrl, util: dict) -> str:
    """Fleet device-utilization page (``collect_utilization`` rollup):
    per-server lane occupancy, transfer totals, achieved-vs-peak
    roofline rates, profiler state, and the top-K underutilized plan
    shapes — the page the throughput arc (multichip, batched serving,
    bit-sliced kernels) is gated on."""
    totals = util.get("totals") or {}
    occ = util.get("occupancy") or {}
    body = ["<h1>Device utilization</h1>"]
    body.append(
        f"<p>Fleet achieved: <b>{_fmt_bytes(totals.get('achievedBytesPerSec', 0))}/s</b>"
        f" over {totals.get('queries', 0)} recent device queries"
        f" &middot; roofline: <b>{_fmt_frac(util.get('rooflineFraction'))}</b>"
        f" &middot; mean busy: <b>{_fmt_frac(occ.get('meanBusyFraction', 0))}</b>"
        f" &middot; active profiles: <b>{util.get('profilesActive', 0)}</b>"
        f" &middot; raw JSON: <a href='/debug/utilization'>/debug/utilization</a></p>"
    )
    unreachable = util.get("unreachable") or {}
    if unreachable:
        names = ", ".join(_esc(n) for n in sorted(unreachable))
        body.append(f"<p class='bad'>Partial rollup — unreachable: {names}</p>")

    body.append("<h2>Servers</h2>")
    servers = util.get("servers") or {}
    if not servers:
        body.append("<p>No servers with an admin HTTP surface registered.</p>")
    else:
        body.append(
            "<table><tr><th>server</th><th>platform</th><th>busy</th>"
            "<th>avg queue</th><th>H2D</th><th>D2H</th>"
            "<th>achieved B/s</th><th>roofline</th><th>profiler</th></tr>"
        )
        for name, entry in sorted(servers.items()):
            dev = entry.get("device") or {}
            plat = dev.get("platform") or {}
            o = dev.get("occupancy") or {}
            tr = dev.get("transfers") or {}
            recent = dev.get("recent") or {}
            prof = dev.get("profiler") or {}
            prof_str = (
                "<span class='warn'>capturing</span>"
                if prof.get("active")
                else "idle"
            )
            body.append(
                f"<tr><td>{_esc(name)}</td>"
                f"<td>{_esc(plat.get('deviceKind') or plat.get('platform') or '?')}</td>"
                f"<td>{_fmt_frac(o.get('busyFraction', 0))}</td>"
                f"<td>{o.get('avgQueueDepth', 0)}</td>"
                f"<td>{_fmt_bytes(tr.get('h2dBytes', 0))}</td>"
                f"<td>{_fmt_bytes(tr.get('d2hBytes', 0))}</td>"
                f"<td>{_fmt_bytes(recent.get('achievedBytesPerSec', 0))}/s</td>"
                f"<td>{_fmt_frac(recent.get('rooflineFraction'))}</td>"
                f"<td>{prof_str}</td></tr>"
            )
        body.append("</table>")

    body.append("<h2>Most underutilized plan shapes (device-executed)</h2>")
    plans = util.get("underutilizedPlans") or []
    if not plans:
        body.append("<p>No device-executed plan shapes recorded yet.</p>")
    else:
        body.append(
            "<table><tr><th>server</th><th>digest</th><th>shape</th>"
            "<th>table</th><th>execs</th><th>device ms</th>"
            "<th>achieved B/s</th><th>roofline</th></tr>"
        )
        for p in plans:
            body.append(
                f"<tr><td>{_esc(p.get('server'))}</td>"
                f"<td><code>{_esc(p.get('digest'))}</code></td>"
                f"<td>{_esc(p.get('summary', ''))}</td>"
                f"<td>{_esc(p.get('table', ''))}</td>"
                f"<td>{p.get('count', 0)}</td>"
                f"<td>{round(float(p.get('deviceMs', 0)), 1)}</td>"
                f"<td>{_fmt_bytes(p.get('achievedBytesPerSec', 0))}/s</td>"
                f"<td>{_fmt_frac(p.get('rooflineFraction'))}</td></tr>"
            )
        body.append("</table>")
    return _page("Device utilization", body)


def _fmt_burn(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    cls = "bad" if f >= 1.0 else ("warn" if f >= 0.5 else "ok")
    return f"<span class='{cls}'>{f:.2f}</span>"


def render_slo(ctrl, slo: dict) -> str:
    """Fleet SLO page (``collect_slo`` rollup): per-table error-budget
    burn rates over the fast/slow windows, worst-burning tables first —
    the page that names the table an operator should look at when the
    ``slo.burning`` gauge fires."""
    tables = slo.get("tables") or {}
    burning = slo.get("burningTables") or []
    cfg = slo.get("config") or {}
    body = ["<h1>SLO burn rates</h1>"]
    head = (
        f"<span class='bad'>{len(burning)} table(s) burning: "
        f"{_esc(', '.join(burning))}</span>"
        if burning
        else "<span class='ok'>no table burning</span>"
    )
    body.append(
        f"<p>{head} &middot; brokers polled: <b>{slo.get('brokers', 0)}</b>"
        f" &middot; windows: {cfg.get('fastWindowS', '?')}s /"
        f" {cfg.get('slowWindowS', '?')}s, threshold"
        f" {cfg.get('burnThreshold', '?')}"
        f" &middot; raw JSON: <a href='/debug/slo'>/debug/slo</a></p>"
    )
    unreachable = slo.get("unreachable") or {}
    if unreachable:
        names = ", ".join(_esc(n) for n in sorted(unreachable))
        body.append(f"<p class='bad'>Partial rollup — unreachable: {names}</p>")
    if not tables:
        body.append("<p>No per-table SLO traffic observed yet.</p>")
        return _page("SLOs", body)
    body.append(
        "<table><tr><th>table</th><th>burn (fast)</th><th>burn (slow)</th>"
        "<th>burning</th><th>objective</th><th>brokers</th></tr>"
    )
    for name in slo.get("worstBurning") or sorted(tables):
        t = tables.get(name) or {}
        obj = t.get("objective") or {}
        burn = (
            "<span class='bad'>YES</span>"
            if t.get("burning")
            else "<span class='ok'>no</span>"
        )
        obj_str = (
            f"p{100 * float(obj.get('latencyTarget', 0) or 0):g} &lt; "
            f"{obj.get('latencyMs', '?')}ms, avail "
            f"{100 * float(obj.get('availabilityTarget', 0) or 0):g}%"
            if obj
            else "?"
        )
        body.append(
            f"<tr><td>{_esc(name)}</td>"
            f"<td>{_fmt_burn(t.get('burnRate5m', 0))}</td>"
            f"<td>{_fmt_burn(t.get('burnRate1h', 0))}</td>"
            f"<td>{burn}</td><td>{obj_str}</td>"
            f"<td>{_esc(', '.join(sorted(t.get('byBroker') or {})))}</td></tr>"
        )
    body.append("</table>")
    body.append(
        "<p>burn = bad-fraction / error-budget per window; a table is "
        "burning only when BOTH windows exceed the threshold. History: "
        "<a href='/debug/history?series=slo.'>/debug/history?series=slo.</a>"
        " &middot; tails: on each broker at <code>/debug/tails</code></p>"
    )
    return _page("SLOs", body)


def render_query_console() -> str:
    """Query console page (query_console.html analog): posts PQL to the
    controller's /pql proxy, renders the broker JSON response."""
    body = [
        "<h1>Query console</h1>",
        "<form id='f'>",
        "<textarea id='pql' rows='4' placeholder='SELECT count(*) FROM myTable'>"
        "</textarea><br>",
        "<label><input type='checkbox' id='trace'> trace</label> ",
        "<button type='submit'>Run</button>",
        "</form>",
        "<pre id='out'></pre>",
        """<script>
document.getElementById('f').addEventListener('submit', async (e) => {
  e.preventDefault();
  const out = document.getElementById('out');
  out.textContent = 'running...';
  try {
    const r = await fetch('/pql', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({
        pql: document.getElementById('pql').value,
        trace: document.getElementById('trace').checked,
      }),
    });
    out.textContent = JSON.stringify(await r.json(), null, 2);
  } catch (err) { out.textContent = String(err); }
});
</script>""",
    ]
    return _page("Query console", body)
