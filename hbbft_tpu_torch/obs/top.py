"""``python -m hbbft_tpu_torch.obs.top`` — curses-free live cluster view.

Polls every node's obs endpoint (``/status`` + ``/metrics``), and renders a
refreshing plain-ANSI table: per-node era/epoch/batches, live epoch rate
(batches delta over the poll interval), mempool depth, connected peers,
fault and decode counters, the performance plane's ``util%`` (worst
per-layer utilization, i.e. ``100·(1 − headroom)``) and the
bidirectional controller's ``ctrl`` state (``+N`` degraded N levels,
``-N`` raised N boosts, ``0`` at exact bases) — plus the
cluster-aggregated per-phase p50/p99 (from the
``hbbft_phase_duration_seconds`` histograms, buckets summed across
nodes), which is the "where does the epoch latency go" line.

    python -m hbbft_tpu_torch.obs.top --targets 127.0.0.1:26000,127.0.0.1:26001
    python -m hbbft_tpu_torch.obs.top --base-port 26000 --nodes 4

``--gateways host:port,…`` additionally polls client-gateway obs
endpoints (a gateway started with ``--metrics-port`` serves the same
``/status`` + ``/metrics`` shape) and renders a second table — clients,
pending pool, forward queue, live node links, forwarded/relayed/shed
totals — so the ingest tier shows up next to the nodes it feeds.

``--iterations N`` renders N frames then exits (``1`` = one plain snapshot,
used by scripts/tests); the default runs until interrupted.  ``--json``
polls ONCE and emits the whole snapshot — per-node status, mesh-collective
and loadgen (``hbbft_load_*``) totals, gateway tier, cluster phase
quantiles — as one JSON document for scripts to consume.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

from hbbft_tpu_torch.obs.http import http_get
from hbbft_tpu_torch.obs.metrics import histogram_quantile, parse_prometheus_text

Target = Tuple[str, int]

#: phase rows shown in the breakdown, in protocol order
TOP_PHASES = (
    "rbc_value", "rbc_echo", "rbc_ready", "aba_bval", "aba_aux",
    "aba_conf", "aba_coin", "decrypt_share", "decrypt_combine",
    "dkg_rotation",
)


def poll_target(host: str, port: int, timeout_s: float = 2.0
                ) -> Optional[dict]:
    """One node's ``{"status":…, "metrics":…, "health":…}`` snapshot,
    None if down.  ``health`` is None (not a failure) on endpoints that
    predate the ``/health`` route or serve an empty document."""
    try:
        status = http_get(host, port, "/status", timeout_s)
        metrics = http_get(host, port, "/metrics", timeout_s)
    # hblint: disable=fault-swallowed-drop (poller client side: a down
    # node renders as the DOWN row — that IS the accounting)
    except (OSError, ValueError):
        return None
    import json

    health = None
    try:
        health = json.loads(http_get(host, port, "/health", timeout_s))
    # hblint: disable=fault-swallowed-drop (benign: /health is optional
    # — old endpoints and gateways render a "-" health cell, nothing
    # is dropped)
    except (OSError, ValueError):
        health = None
    try:
        return {
            "status": json.loads(status),
            "metrics": parse_prometheus_text(metrics),
            "health": health or None,
        }
    # hblint: disable=fault-swallowed-drop (same: unparseable responses
    # render the node as DOWN)
    except ValueError:
        return None


def metric_total(snap: dict, name: str) -> Optional[float]:
    """Sum of one counter family across its label sets, None if the
    node doesn't export it (e.g. ``hbbft_load_*`` without an embedded
    load generator)."""
    series = snap["metrics"].get(name)
    if not series:
        return None
    return sum(v for _labels, v in series)


def phase_quantiles(snaps: List[Optional[dict]],
                    qs=(0.5, 0.99)) -> Dict[str, List[float]]:
    """Cluster-wide per-phase quantiles: histogram buckets summed over
    nodes, then interpolated."""
    acc: Dict[str, Dict[float, float]] = {}
    for snap in snaps:
        if snap is None:
            continue
        series = snap["metrics"].get(
            "hbbft_phase_duration_seconds_bucket", []
        )
        for labels, value in series:
            phase = labels.get("phase", "?")
            le = float("inf") if labels.get("le") == "+Inf" else float(
                labels.get("le", "inf")
            )
            by_le = acc.setdefault(phase, {})
            by_le[le] = by_le.get(le, 0.0) + value
    out: Dict[str, List[float]] = {}
    for phase, by_le in acc.items():
        cum = sorted(by_le.items())
        out[phase] = [histogram_quantile(cum, q) for q in qs]
    return out


def util_cell(status: dict) -> Tuple[str, Optional[float]]:
    """(table cell, percent) for the perf plane's utilization: the
    worst per-layer busy fraction as ``100·(1 − headroom)`` — "-" until
    the node's sampler has completed its first window."""
    headroom = (status.get("perf") or {}).get("headroom")
    if headroom is None:
        headroom = status.get("headroom")
    if headroom is None:
        return "-", None
    pct = max(0.0, min(100.0, (1.0 - float(headroom)) * 100.0))
    return f"{pct:.0f}", pct


def ctrl_summary(status: dict) -> Tuple[str, Optional[dict]]:
    """(table cell, JSON doc) for the bidirectional controller:
    effective level (``+N`` = degraded N levels, ``-N`` = raised N
    boosts, ``0`` = exact bases) plus current/base proposer batch
    size.  "-" on nodes without a controller."""
    dg = status.get("degraded") or {}
    if "level" not in dg:
        return "-", None
    level = int(dg.get("level") or 0)
    boost = int(dg.get("boost") or 0)
    effective = level - boost
    doc = {
        "level": level,
        "boost": boost,
        "effective": effective,
        "batch_size": dg.get("batch_size"),
        "base_batch_size": dg.get("base_batch_size"),
    }
    return (f"{effective:+d}" if effective else "0"), doc


def render_gateways(gw_targets: List[Target],
                    gw_cur: List[Optional[dict]]) -> List[str]:
    """The gateway-tier table (empty list when no gateways polled)."""
    if not gw_targets:
        return []
    lines = [
        "",
        f"{'gateway':<22} {'id':>4} {'clients':>7} {'pending':>7} "
        f"{'fwdq':>5} {'links':>5} {'fwd':>8} {'commits':>8} "
        f"{'sheds':>6} {'failover':>8} {'drops':>6}",
    ]
    for i, (host, port) in enumerate(gw_targets):
        snap = gw_cur[i]
        name = f"{host}:{port}"
        if snap is None:
            lines.append(f"{name:<22} DOWN")
            continue
        d = snap["status"]
        links = d.get("links") or []
        live = sum(1 for li in links if li.get("connected"))
        drops = metric_total(snap, "hbbft_gw_client_drops_total")
        lines.append(
            f"{name:<22} {d.get('gateway', '?'):>4} "
            f"{d.get('clients', 0):>7} {d.get('pending', 0):>7} "
            f"{d.get('forward_queue', 0):>5} "
            f"{f'{live}/{len(links)}':>5} {d.get('forwarded', 0):>8} "
            f"{d.get('commits_relayed', 0):>8} {d.get('sheds', 0):>6} "
            f"{d.get('link_failovers', 0):>8} "
            f"{'-' if drops is None else int(drops):>6}"
        )
    return lines


def render(targets: List[Target], prev: List[Optional[dict]],
           cur: List[Optional[dict]], dt: float,
           gw_targets: List[Target] = (),
           gw_cur: List[Optional[dict]] = ()) -> str:
    lines: List[str] = []
    lines.append(
        f"hbbft-tpu obs.top — {len(targets)} nodes — "
        f"{time.strftime('%H:%M:%S')}  (poll {dt:.1f}s)"
    )
    lines.append(
        f"{'node':<22} {'era':>4} {'epoch':>6} {'batch':>6} "
        f"{'ep/s':>6} {'mempool':>8} {'peers':>5} {'txs':>8} "
        f"{'faults':>6} {'decode!':>7} {'gaps':>5} {'guard!':>6} "
        f"{'degr':>4} {'util%':>5} {'ctrl':>4} {'vidp':>5} "
        f"{'health':>8} "
        f"{'jrnl':>7} {'jseg':>4} {'jwf':>4} {'mesh':>6} "
        f"{'load':>8} {'shed':>5}"
    )
    for i, (host, port) in enumerate(targets):
        snap = cur[i]
        name = f"{host}:{port}"
        if snap is None:
            lines.append(f"{name:<22} DOWN")
            continue
        d = snap["status"]
        rate = ""
        if prev[i] is not None and dt > 0:
            rate = "%.2f" % (
                (d["batches"] - prev[i]["status"]["batches"]) / dt
            )
        # journal health: flight-recorder records/segments/write-failures
        # (the black box an operator audits after an incident — a nonzero
        # jwf means the journal is losing events to disk errors)
        fl = d.get("flight") or {}
        jrnl = fl.get("records", "-")
        jseg = fl.get("segments", "-")
        jwf = fl.get("write_failures", "-")
        # overload-defense engagements: throttles + disconnects +
        # backlog evictions + mempool sheds — nonzero means some peer
        # or client is being actively budgeted (see /status "guard")
        gd = d.get("guard") or {}
        gi = gd.get("ingress") or {}
        guard = (gi.get("throttles", 0) + gi.get("disconnects", 0)
                 + gd.get("senderq_evictions", 0)
                 + sum((gd.get("mempool_sheds") or {}).values()))
        # adaptive-degradation level, lazy-retrieval backlog, and the
        # node's own /health verdict — the live-health-plane columns
        degr = (d.get("degraded") or {}).get("level", "-")
        # perf-plane utilization and bidirectional-controller columns:
        # util% is the worst layer's busy fraction, ctrl the signed
        # effective level (+degrade / -raise / 0 at bases)
        util, _ = util_cell(d)
        ctrl, _ = ctrl_summary(d)
        vidp = (d.get("vid") or {}).get("pending_retrievals", "-")
        health = (snap.get("health") or {}).get("status", "-")
        # mesh-sharded epoch collectives (zero on single-device nodes)
        # and embedded-loadgen counters ("-" when no generator runs in
        # this process — hbbft_load_* lives in whichever registry hosts
        # the OpenLoopGenerator)
        mesh = metric_total(snap, "hbbft_mesh_collectives_total")
        load = metric_total(snap, "hbbft_load_submitted_txs_total")
        shed = metric_total(snap, "hbbft_load_shed_txs_total")

        def _i(v: Optional[float]) -> str:
            return "-" if v is None else str(int(v))

        lines.append(
            f"{name:<22} {d['era']:>4} {d['epoch']:>6} "
            f"{d['batches']:>6} {rate:>6} {d['mempool']:>8} "
            f"{d['peers_connected']:>5} {d['committed_txs']:>8} "
            f"{d['faults_observed']:>6} {d['decode_failures']:>7} "
            f"{d['replay_gaps']:>5} {guard:>6} "
            f"{degr:>4} {util:>5} {ctrl:>4} {vidp:>5} {health:>8} "
            f"{jrnl:>7} {jseg:>4} {jwf:>4} {_i(mesh):>6} "
            f"{_i(load):>8} {_i(shed):>5}"
        )
    lines.extend(render_gateways(list(gw_targets), list(gw_cur)))
    pq = phase_quantiles(cur)
    lines.append("")
    lines.append(f"{'phase':<18} {'p50 ms':>9} {'p99 ms':>9}")
    for phase in TOP_PHASES:
        if phase not in pq:
            continue
        p50, p99 = pq[phase]
        lines.append(f"{phase:<18} {p50 * 1e3:>9.2f} {p99 * 1e3:>9.2f}")
    if not pq:
        lines.append("(no finished epochs yet)")
    return "\n".join(lines)


def snapshot_doc(targets: List[Target],
                 cur: List[Optional[dict]],
                 gw_targets: List[Target] = (),
                 gw_cur: List[Optional[dict]] = ()) -> dict:
    """One-shot machine-readable snapshot (``--json``)."""
    nodes = []
    for i, (host, port) in enumerate(targets):
        snap = cur[i]
        if snap is None:
            nodes.append({"target": f"{host}:{port}", "up": False})
            continue
        d = snap["status"]
        gd = d.get("guard") or {}
        gi = gd.get("ingress") or {}
        hd = snap.get("health") or {}
        nodes.append({
            "target": f"{host}:{port}",
            "up": True,
            "status": snap["status"],
            # the explicit live-health-plane fields, same numbers the
            # text view renders (guard!, degr, vidp, health columns) —
            # scripts must not have to re-derive them from "status"
            "guard": {
                "throttles": gi.get("throttles", 0),
                "disconnects": gi.get("disconnects", 0),
                "senderq_evictions": gd.get("senderq_evictions", 0),
                "mempool_sheds": sum(
                    (gd.get("mempool_sheds") or {}).values()),
            },
            "degrade": d.get("degraded"),
            # the performance-plane / controller fields the text view
            # renders as util% and ctrl
            "perf": d.get("perf"),
            "util_pct": util_cell(d)[1],
            "ctrl": ctrl_summary(d)[1],
            "vid": d.get("vid"),
            "health": hd.get("status"),
            "headroom": hd.get("headroom"),
            "mesh_collectives": metric_total(
                snap, "hbbft_mesh_collectives_total"),
            "mesh_gather_bytes": metric_total(
                snap, "hbbft_mesh_gather_bytes_total"),
            "load": {
                k: metric_total(snap, f"hbbft_load_{k}_total")
                for k in ("offered_txs", "submitted_txs", "acks",
                          "shed_txs", "committed_txs")
            },
        })
    gateways = []
    for i, (host, port) in enumerate(gw_targets):
        snap = gw_cur[i]
        if snap is None:
            gateways.append({"target": f"{host}:{port}", "up": False})
            continue
        drops = metric_total(snap, "hbbft_gw_client_drops_total")
        s = snap["status"]
        links = s.get("links") or []
        gateways.append({
            "target": f"{host}:{port}",
            "up": True,
            "status": snap["status"],
            "client_drops": None if drops is None else int(drops),
            # the explicit gateway-tier fields the text table renders
            "clients": s.get("clients", 0),
            "pending": s.get("pending", 0),
            "forward_queue": s.get("forward_queue", 0),
            "links_up": sum(1 for li in links if li.get("connected")),
            "links": len(links),
            "sheds": s.get("sheds", 0),
            "link_failovers": s.get("link_failovers", 0),
            "health": (snap.get("health") or {}).get("status"),
        })
    pq = phase_quantiles(cur)
    doc = {
        "nodes": nodes,
        "phase_quantiles_ms": {
            ph: {"p50": v[0] * 1e3, "p99": v[1] * 1e3}
            for ph, v in sorted(pq.items())
        },
    }
    if gateways:
        doc["gateways"] = gateways
    return doc


def parse_targets(args) -> List[Target]:
    if args.targets:
        out = []
        for part in args.targets.split(","):
            host, _, port = part.strip().rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        return out
    if args.base_port:
        return [("127.0.0.1", args.base_port + i)
                for i in range(args.nodes)]
    raise SystemExit("need --targets or --base-port/--nodes")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--targets", default="",
                    help="comma-separated host:port obs endpoints")
    ap.add_argument("--base-port", type=int, default=0,
                    help="metrics base port (node i at base+i)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--gateways", default="",
                    help="comma-separated host:port gateway obs "
                         "endpoints (gateway --metrics-port)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--iterations", type=int, default=0,
                    help="0 = run until interrupted; 1 = one snapshot")
    ap.add_argument("--json", action="store_true",
                    help="poll once, print a JSON snapshot, exit")
    args = ap.parse_args(argv)
    targets = parse_targets(args)
    gw_targets: List[Target] = []
    for part in args.gateways.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        gw_targets.append((host or "127.0.0.1", int(port)))

    if args.json:
        import json

        cur = [poll_target(h, p) for h, p in targets]
        gw_cur = [poll_target(h, p) for h, p in gw_targets]
        print(json.dumps(
            snapshot_doc(targets, cur, gw_targets, gw_cur),
            sort_keys=True))
        return 0 if any(s is not None for s in cur) else 1

    clear = (sys.stdout.isatty() and args.iterations != 1)
    prev: List[Optional[dict]] = [None] * len(targets)
    t_prev = time.monotonic()
    i = 0
    try:
        while True:
            cur = [poll_target(h, p) for h, p in targets]
            gw_cur = [poll_target(h, p) for h, p in gw_targets]
            now = time.monotonic()
            frame = render(targets, prev, cur, now - t_prev,
                           gw_targets, gw_cur)
            if clear:
                sys.stdout.write("\x1b[H\x1b[2J")
            print(frame, flush=True)
            prev, t_prev = cur, now
            i += 1
            if args.iterations and i >= args.iterations:
                break
            time.sleep(args.interval)
    # hblint: disable=fault-swallowed-drop (interactive exit, not a
    # dropped input: ^C ends the watch loop cleanly)
    except KeyboardInterrupt:
        pass
    return 0 if any(s is not None for s in prev) else 1


if __name__ == "__main__":
    sys.exit(main())
