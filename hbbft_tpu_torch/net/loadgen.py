"""Open-loop load generator: MB-scale ingestion against a live cluster.

Closed-loop drivers (submit → wait → repeat; ``bench._net_run_once``)
measure a cluster at equilibrium: offered load equals capacity by
construction, so admission control is never exercised and throughput
numbers silently describe the DRIVER's pacing.  The open-loop generator
decouples offer from service: ``clients`` concurrent
:class:`~hbbft_tpu_torch.net.client.ClusterClient` connections submit
transaction waves on a clock (or ack-paced, as fast as the sockets
accept) regardless of commit progress.  When offered > capacity the
sharded mempool's fair admission engages — ``ACK_FULL``/``ACK_SHED``
outcomes are *counted as shed*, never retried — and the report separates
what was offered, admitted, shed, and actually committed.

Every counter lives in an :mod:`hbbft_tpu_torch.obs.metrics` registry
(``hbbft_load_*``) so a generator embedded in a longer campaign is
scrapeable like any node.

CLI (against an already-running cluster, e.g. one that
``python -m hbbft_tpu_torch.cluster_launch`` started)::

    python -m hbbft_tpu_torch.net.loadgen --n 4 --seed 9 --base-port 23000 \
        --tx-bytes 65536 --clients 64 --rate 200 --duration 10

``--spawn`` boots a throwaway localhost cluster first, its nodes' device
work on ``--device`` (default ``cuda``, raising without a card), and tears
it down after the run (the zero-setup smoke path).

``--schedule S`` runs a deterministic seeded up/down offered-load
schedule instead of one flat shape: S burst-mode stages ramp the client
count from ``--schedule-base`` up to ``--schedule-peak`` and back down
(stage jitter drawn from ``random.Random(--schedule-seed)``, so the
same seed always produces the same stages), each stage salted so
dedup windows never collide across stages.  Shed transactions are
never retried in any stage — the schedule measures admission under a
moving offer, not retry amplification.  This is the closed-loop
driver for the bidirectional degradation controller: the up-ramp
exercises raise-then-degrade, the down-ramp exercises recovery and
exact-base restore.

``--gateways N`` interposes N client-gateway processes
(:mod:`hbbft_tpu_torch.net.gateway`, ``--gateway-links`` node links each) and
spreads the clients across them instead of dialing nodes directly —
the node side then holds a few authenticated links rather than one
socket per client.  ``--client-sweep 64,1024,10000`` reruns the shape
at each client count (``--sweep-waves`` waves per point) and emits a
``gateway_curve`` array — the tx/s-vs-clients capacity curve.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.net.client import ClusterClient, latency_percentiles

Addr = Tuple[str, int]

_ACK_NAMES = {
    framing.ACK_ACCEPTED: "accepted",
    framing.ACK_DUPLICATE: "duplicate",
    framing.ACK_FULL: "full",
    framing.ACK_REJECTED: "rejected",
}


@dataclass
class LoadShape:
    """One open-loop offered-load configuration."""

    tx_bytes: int = 64
    clients: int = 8
    wave_txs: int = 16          # txs per submit_many call
    rate_tx_s: float = 0.0      # aggregate offered tx/s; 0 → ack-paced
    duration_s: float = 10.0    # submit window
    drain_s: float = 8.0        # post-window wait for in-flight commits
    ack_timeout_s: float = 30.0
    # open-loop memory bound: waves in flight per client before further
    # offers are dropped LOCALLY (counted, never silent) — without it a
    # wedged cluster would grow the generator's pending set unboundedly
    max_inflight_waves: int = 64
    # burst mode (the client-sweep workload): every client submits
    # exactly this many waves ack-paced and stops — each of N clients is
    # guaranteed to exercise the tier, unlike a rate-paced window where
    # large N makes per-client intervals exceed the duration.  0 keeps
    # the duration-window behavior
    burst_waves: int = 0
    # digest-uniqueness salt folded into every generated tx: successive
    # sweep points against one long-lived gateway tier must not collide
    # with digests the gateway's dedup window has already seen
    salt: str = ""


class LoadGenerator:
    """Drive one :class:`LoadShape` against a cluster and report."""

    def __init__(self, addrs: Sequence[Addr], cluster_id: bytes,
                 shape: LoadShape, registry=None):
        from hbbft_tpu_torch.obs.metrics import Registry

        if not addrs:
            raise ValueError("need at least one node address")
        self.addrs = list(addrs)
        self.cluster_id = bytes(cluster_id)
        self.shape = shape
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self._c_offered = r.counter(
            "hbbft_load_offered_txs_total",
            "transactions generated by the open-loop schedule")
        self._c_offered_b = r.counter(
            "hbbft_load_offered_bytes_total",
            "payload bytes of generated transactions")
        self._c_submitted = r.counter(
            "hbbft_load_submitted_txs_total",
            "transactions written to a node socket")
        self._c_acks = r.counter(
            "hbbft_load_acks_total",
            "node admission replies by status",
            labelnames=("status",),
            max_label_sets=len(_ACK_NAMES) + 1)
        for name in _ACK_NAMES.values():
            self._c_acks.labels(status=name)
        self._c_shed = r.counter(
            "hbbft_load_shed_txs_total",
            "transactions refused by mempool admission (FULL/REJECTED "
            "acks and ack timeouts) — open loop never retries them")
        self._c_local_drops = r.counter(
            "hbbft_load_local_drops_total",
            "offered transactions dropped by the generator's own "
            "in-flight bound before reaching a socket")
        self._c_committed = r.counter(
            "hbbft_load_committed_txs_total",
            "submitted transactions reported committed by the cluster")
        self._c_committed_b = r.counter(
            "hbbft_load_committed_bytes_total",
            "payload bytes of committed transactions")
        self._g_inflight = r.gauge(
            "hbbft_load_inflight_txs",
            "transactions submitted (or queued to submit) whose ack has "
            "not resolved yet")
        self._inflight = 0
        self._ack_timeouts = 0

    # -- internals -----------------------------------------------------------

    def _make_wave(self, client_idx: int, wave: int) -> List[bytes]:
        """``wave_txs`` unique transactions of ``tx_bytes`` each.  A
        16-byte (client, wave, i) header keeps digests distinct; the body
        is constant — the pipeline hashes and erasure-codes raw bytes,
        so content entropy buys nothing but generator CPU."""
        s = self.shape
        prefix = s.salt.encode()
        body = b"\xa5" * max(0, s.tx_bytes - 16 - len(prefix))
        return [
            prefix + b"%05d%06d%04d:" % (client_idx, wave, i) + body
            for i in range(s.wave_txs)
        ]

    async def _submit_wave(self, client: ClusterClient,
                           txs: List[bytes]) -> None:
        s = self.shape
        n = len(txs)
        self._inflight += n
        self._g_inflight.set(self._inflight)
        statuses: List[int] = []
        try:
            self._c_submitted.inc(n)
            statuses = await client.submit_many(
                txs, ack_timeout_s=s.ack_timeout_s)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            # every un-acked tx of the wave counts as shed: the open
            # loop moves on either way
            self._ack_timeouts += n
            self._c_shed.inc(n)
        finally:
            self._inflight -= n
            self._g_inflight.set(self._inflight)
        for st in statuses:
            self._c_acks.labels(
                status=_ACK_NAMES.get(st, "rejected")).inc()
            if st in (framing.ACK_FULL, framing.ACK_REJECTED):
                self._c_shed.inc()

    async def _client_loop(self, idx: int, client: ClusterClient,
                           stop_t: float) -> None:
        s = self.shape
        loop = asyncio.get_running_loop()
        pending: set = set()
        wave = 0
        if s.burst_waves > 0:
            # burst mode: a fixed per-client submission count, ack-paced
            # — the sweep's "N clients each actually pushed traffic"
            # guarantee
            for wave in range(s.burst_waves):
                txs = self._make_wave(idx, wave)
                self._c_offered.inc(len(txs))
                self._c_offered_b.inc(sum(len(t) for t in txs))
                await self._submit_wave(client, txs)
            return
        interval = 0.0
        if s.rate_tx_s > 0:
            # each client fires every (wave_txs · clients / rate) s,
            # phase-staggered so the aggregate offer is smooth
            interval = s.wave_txs * s.clients / s.rate_tx_s
            next_t = time.monotonic() + interval * idx / s.clients
        while time.monotonic() < stop_t:
            if s.rate_tx_s > 0:
                now = time.monotonic()
                if now < next_t:
                    await asyncio.sleep(next_t - now)
                next_t += interval
                if time.monotonic() >= stop_t:
                    break
                txs = self._make_wave(idx, wave)
                wave += 1
                self._c_offered.inc(len(txs))
                self._c_offered_b.inc(sum(len(t) for t in txs))
                if len(pending) >= s.max_inflight_waves:
                    # the OPEN loop's memory bound: offers beyond the
                    # in-flight window are dropped here, counted
                    self._c_local_drops.inc(len(txs))
                    continue
                task = loop.create_task(self._submit_wave(client, txs))
                pending.add(task)
                task.add_done_callback(pending.discard)
            else:
                # ack-paced: as fast as this connection round-trips
                # admission — sustained FULL pressure when the mempool
                # saturates
                txs = self._make_wave(idx, wave)
                wave += 1
                self._c_offered.inc(len(txs))
                self._c_offered_b.inc(sum(len(t) for t in txs))
                await self._submit_wave(client, txs)
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    async def run(self) -> Dict:
        """Execute the shape; returns the report dict."""
        s = self.shape
        sem = asyncio.Semaphore(128)  # bound concurrent dials

        async def connect(i: int) -> ClusterClient:
            # hblint: disable=async-lock-across-await (the semaphore
            # exists to bound concurrent dials: holding it across the
            # connect IS the backpressure, and connect has a timeout)
            async with sem:
                c = ClusterClient(
                    self.addrs[i % len(self.addrs)], self.cluster_id,
                    client_id=f"load-{i}")
                await c.connect()
                return c

        clients = list(await asyncio.gather(
            *(connect(i) for i in range(s.clients))))
        t0 = time.monotonic()
        stop_t = t0 + s.duration_s
        try:
            await asyncio.gather(*(
                self._client_loop(i, c, stop_t)
                for i, c in enumerate(clients)
            ))
            submit_wall = time.monotonic() - t0
            # drain: commits keep arriving after the submit window; stop
            # once the committed count plateaus (or drain_s expires)
            deadline = time.monotonic() + s.drain_s
            last = -1
            while time.monotonic() < deadline:
                cur = sum(len(c.latencies) for c in clients)
                if cur == last and cur > 0:
                    break
                last = cur
                await asyncio.sleep(0.5)
            wall = time.monotonic() - t0
        finally:
            for c in clients:
                await c.close()
        committed = sum(len(c.latencies) for c in clients)
        self._c_committed.inc(committed)
        self._c_committed_b.inc(committed * s.tx_bytes)
        lat = latency_percentiles(
            l for c in clients for _d, l in c.latencies)
        offered = int(self._c_offered.total())
        shed = int(self._c_shed.total())
        report = {
            "shape": asdict(s),
            "offered_txs": offered,
            "submitted_txs": int(self._c_submitted.total()),
            "shed_txs": shed,
            "local_drops": int(self._c_local_drops.total()),
            "ack_timeouts": self._ack_timeouts,
            "committed_txs": committed,
            "committed_mb": round(committed * s.tx_bytes / 2**20, 3),
            "submit_wall_s": round(submit_wall, 3),
            "wall_s": round(wall, 3),
            "tx_per_s": round(committed / wall, 2) if wall else 0.0,
            "mb_per_s": round(
                committed * s.tx_bytes / 2**20 / wall, 3
            ) if wall else 0.0,
            "p50_ms": round(lat["p50_s"] * 1e3, 2),
            "p99_ms": round(lat["p99_s"] * 1e3, 2),
        }
        return report


def run_load(addrs: Sequence[Addr], cluster_id: bytes,
             shape: LoadShape, registry=None) -> Dict:
    """Synchronous wrapper: one generator run on a fresh event loop."""
    gen = LoadGenerator(addrs, cluster_id, shape, registry=registry)
    return asyncio.run(gen.run())


def run_client_sweep(addrs: Sequence[Addr], cluster_id: bytes,
                     base_shape: LoadShape, counts: Sequence[int],
                     waves_per_client: int = 1) -> List[Dict]:
    """The tx/s-versus-clients curve: one burst-mode generator run per
    client count against the SAME tier (gateway or nodes), each point
    salted so the tier's dedup window never collides across points.
    Returns the curve as a list of per-point summaries."""
    from dataclasses import replace

    curve: List[Dict] = []
    for pi, n in enumerate(counts):
        shape = replace(base_shape, clients=n,
                        burst_waves=waves_per_client, salt=f"p{pi}.")
        rep = run_load(addrs, cluster_id, shape)
        point = {
            "clients": n,
            "offered_txs": rep["offered_txs"],
            "committed_txs": rep["committed_txs"],
            "shed_txs": rep["shed_txs"],
            "tx_per_s": rep["tx_per_s"],
            "wall_s": rep["wall_s"],
            "p50_ms": rep["p50_ms"],
            "p99_ms": rep["p99_ms"],
        }
        curve.append(point)
        print(f"# sweep point {n} clients: {point['tx_per_s']} tx/s, "
              f"{point['committed_txs']} committed, "
              f"{point['shed_txs']} shed", file=sys.stderr, flush=True)
    return curve


def build_schedule(seed: int, stages: int = 6, base_clients: int = 4,
                   peak_clients: int = 32,
                   waves_per_client: int = 2) -> List[Dict]:
    """Deterministic up/down offered-load schedule: a triangular ramp
    ``base → peak → base`` over ``stages`` burst-mode stages, with
    per-stage jitter drawn from ``random.Random(seed)`` — the same
    seed ALWAYS yields the same stages (the determinism the
    closed-loop controller bench and its test rely on)."""
    import random

    if stages < 1:
        raise ValueError("stages must be >= 1")
    if peak_clients < base_clients:
        raise ValueError("peak_clients must be >= base_clients")
    rng = random.Random(seed)
    up = (stages + 1) // 2
    span = peak_clients - base_clients
    out: List[Dict] = []
    for i in range(stages):
        if i < up:
            frac = i / (up - 1) if up > 1 else 1.0
            direction = "up"
        else:
            frac = (stages - 1 - i) / max(1, stages - up)
            direction = "down"
        n = base_clients + int(round(frac * span))
        # seeded jitter (±12.5% of the span) keeps consecutive runs of
        # DIFFERENT seeds from hitting identical points, clamped so the
        # ramp never leaves [base, peak]
        jitter = int(round(rng.uniform(-0.125, 0.125) * span))
        n = max(base_clients, min(peak_clients, n + jitter))
        out.append({"stage": i, "direction": direction, "clients": n,
                    "waves": waves_per_client})
    return out


def run_schedule(addrs: Sequence[Addr], cluster_id: bytes,
                 base_shape: LoadShape,
                 schedule: Sequence[Dict], probe=None) -> List[Dict]:
    """Drive each schedule stage as one burst-mode generator run
    against the same tier (per-stage salt keeps dedup windows
    disjoint).  Shed transactions are never retried — a stage's shed
    count is the admission verdict for that offered level.  ``probe``
    (optional zero-arg callable, e.g. ``lambda: ctrl_state(cfg)``) is
    called after each stage and its result attached as the stage's
    ``ctrl`` — the closed-loop record of where the controller ladder
    sat while that load level was offered.  Returns per-stage
    summaries (stage, direction, clients, tx/s, p99, …)."""
    from dataclasses import replace

    results: List[Dict] = []
    for st in schedule:
        shape = replace(base_shape, clients=int(st["clients"]),
                        burst_waves=int(st["waves"]),
                        salt=f"s{st['stage']}.")
        rep = run_load(addrs, cluster_id, shape)
        point = {
            "stage": st["stage"],
            "direction": st["direction"],
            "clients": st["clients"],
            "offered_txs": rep["offered_txs"],
            "committed_txs": rep["committed_txs"],
            "shed_txs": rep["shed_txs"],
            "tx_per_s": rep["tx_per_s"],
            "wall_s": rep["wall_s"],
            "p50_ms": rep["p50_ms"],
            "p99_ms": rep["p99_ms"],
        }
        if probe is not None:
            point["ctrl"] = probe()
        results.append(point)
        boosts = ""
        if probe is not None:
            boosts = " boosts=" + ",".join(
                str((c or {}).get("boost", "?")) for c in point["ctrl"])
        print(f"# schedule stage {st['stage']} ({st['direction']}, "
              f"{st['clients']} clients): {point['tx_per_s']} tx/s, "
              f"{point['shed_txs']} shed, p99 {point['p99_ms']} ms"
              f"{boosts}",
              file=sys.stderr, flush=True)
    return results


def ctrl_state(cfg) -> List[Optional[Dict]]:
    """Every node's control-ladder state scraped from ``/status``
    (``None`` rows for unreachable nodes): degrade level, boost level,
    effective batch size vs base, and the perf plane's live headroom —
    the per-stage evidence a ``--schedule`` sweep records when the
    raise arm is enabled (``--max-boost``)."""
    from hbbft_tpu_torch.obs.http import http_get

    out: List[Optional[Dict]] = []
    for nid in range(cfg.n):
        host, mport = cfg.metrics_addr(nid)
        try:
            doc = json.loads(
                http_get(host, mport, "/status", timeout_s=3.0))
        # hblint: disable=fault-swallowed-drop (client-side poller: the
        # None row IS the accounting — the schedule report shows the
        # unreachable node explicitly)
        except (OSError, ValueError):
            out.append(None)
            continue
        deg = doc.get("degraded") or {}
        out.append({
            "node": nid,
            "level": deg.get("level"),
            "boost": deg.get("boost"),
            "batch_size": deg.get("batch_size"),
            "base_batch_size": deg.get("base_batch_size"),
            "max_boost": deg.get("max_boost"),
            "headroom": doc.get("headroom"),
        })
    return out


def spawn_gateways(cfg, count: int, node_links: int = 2,
                   gw_base_port: int = 0, metrics_base_port: int = 0):
    """Boot ``count`` gateway processes fronting ``cfg``'s cluster;
    returns ``(procs, addrs)`` once every gateway prints its listen
    address (each dials its node links lazily, so this does not wait
    for the cluster).  ``metrics_base_port`` serves gateway ``g``'s
    ``/metrics`` and ``/status`` on ``metrics_base_port + g`` (0 = off)."""
    import os
    import subprocess

    procs, addrs = [], []
    for gid in range(count):
        cmd = [sys.executable, "-m", "hbbft_tpu_torch.net.gateway",
               "--nodes", str(cfg.n), "--seed", str(cfg.seed),
               "--base-port", str(cfg.base_port),
               "--host", cfg.host,
               "--port", str(gw_base_port + gid if gw_base_port else 0),
               "--gateway-id", f"gw{gid}",
               "--node-links", str(node_links)]
        if cfg.encrypt:
            cmd.append("--encrypt")
        if not cfg.auth:
            cmd.append("--no-auth")
        if metrics_base_port:
            cmd += ["--metrics-port", str(metrics_base_port + gid)]
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True,
                                cwd=root)
        procs.append(proc)
    for proc in procs:
        line = proc.stdout.readline()
        doc = json.loads(line)
        addrs.append(tuple(doc["addr"]))
    return procs, addrs


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4, help="cluster size")
    p.add_argument("--seed", type=int, default=9, help="cluster seed")
    p.add_argument("--base-port", type=int, default=23000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--encrypt", action="store_true",
                   help="cluster runs TPKE-encrypted contributions "
                        "(cluster-id input)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="(--spawn only) node batch size")
    p.add_argument("--max-tx-bytes", type=int, default=0,
                   help="(--spawn only) per-tx admission ceiling "
                        "(0 = sized to --tx-bytes; batch × ceiling must "
                        "fit in half the wire blob cap)")
    p.add_argument("--spawn", action="store_true",
                   help="spawn a throwaway localhost cluster first")
    p.add_argument("--device", default="cuda",
                   help="(--spawn only) torch device of the nodes' device "
                        "work (default cuda; raises without a card — pass "
                        "cpu to run the plain PyTorch versions)")
    p.add_argument("--tx-bytes", type=int, default=64)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--wave-txs", type=int, default=16)
    p.add_argument("--rate", type=float, default=0.0,
                   help="aggregate offered tx/s (0 = ack-paced)")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--drain", type=float, default=8.0)
    p.add_argument("--gateways", type=int, default=0,
                   help="front the cluster with this many gateway "
                        "processes and drive THEM instead of the nodes")
    p.add_argument("--gateway-links", type=int, default=2,
                   help="authenticated node links per gateway")
    p.add_argument("--client-sweep", default="",
                   help="comma-separated client counts: run one "
                        "burst-mode point per count and emit the "
                        "tx/s-vs-clients curve (overrides --clients/"
                        "--duration)")
    p.add_argument("--sweep-waves", type=int, default=1,
                   help="waves each sweep client submits")
    p.add_argument("--schedule", type=int, default=0,
                   help="run a deterministic up/down offered-load "
                        "schedule of this many burst-mode stages "
                        "(0 = off; overrides --clients/--duration)")
    p.add_argument("--schedule-seed", type=int, default=7,
                   help="seed for the schedule's stage jitter (same "
                        "seed → same stages)")
    p.add_argument("--schedule-base", type=int, default=4,
                   help="schedule ramp floor (clients)")
    p.add_argument("--schedule-peak", type=int, default=32,
                   help="schedule ramp peak (clients)")
    p.add_argument("--schedule-waves", type=int, default=2,
                   help="waves each schedule-stage client submits")
    p.add_argument("--max-boost", type=int, default=0,
                   help="arm the spawned cluster's raise side (up to "
                        "this many batch/mempool doublings under "
                        "measured slack) and record per-stage "
                        "controller state in the schedule report")
    p.add_argument("--raise-windows", type=int, default=10,
                   help="clean windows per boost step (with "
                        "--max-boost)")
    p.add_argument("--raise-headroom", type=float, default=0.6,
                   help="headroom floor that counts as slack (with "
                        "--max-boost)")
    p.add_argument("--ctrl-quiet", type=float, default=6.0,
                   help="seconds of post-sweep quiet before the final "
                        "controller scrape (with --max-boost: long "
                        "enough for clear_windows quiet windows to "
                        "restore the exact bases)")
    args = p.parse_args(argv)

    from hbbft_tpu_torch.net.cluster import ClusterConfig

    mtx = args.max_tx_bytes or max(4096, args.tx_bytes + 64)
    cfg = ClusterConfig(n=args.n, seed=args.seed, host=args.host,
                        base_port=args.base_port,
                        metrics_base_port=args.base_port + args.n,
                        batch_size=args.batch_size, max_tx_bytes=mtx,
                        encrypt=args.encrypt,
                        max_boost=args.max_boost,
                        raise_windows=args.raise_windows,
                        raise_headroom=args.raise_headroom,
                        device=args.device)
    shape = LoadShape(tx_bytes=args.tx_bytes, clients=args.clients,
                      wave_txs=args.wave_txs, rate_tx_s=args.rate,
                      duration_s=args.duration, drain_s=args.drain)
    procs = None
    if args.spawn:
        import subprocess

        from hbbft_tpu_torch.net.cluster import (
            find_free_base_port, spawn_cluster,
        )

        base = find_free_base_port(2 * cfg.n)
        cfg = ClusterConfig(n=cfg.n, seed=cfg.seed, batch_size=cfg.batch_size,
                            max_tx_bytes=cfg.max_tx_bytes,
                            base_port=base, metrics_base_port=base + cfg.n,
                            encrypt=cfg.encrypt,
                            max_boost=cfg.max_boost,
                            raise_windows=cfg.raise_windows,
                            raise_headroom=cfg.raise_headroom,
                            device=cfg.device)
        procs = list(spawn_cluster(cfg, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.STDOUT).values())

    gw_procs = None
    try:
        if procs is not None:
            # wait for boot via a probe connection
            from hbbft_tpu_torch.net.cluster import connect_when_up

            async def probe():
                c = await connect_when_up(cfg, 0, client_id="load-probe")
                await c.close()

            # hblint: disable=async-unawaited-coroutine (asyncio.run is
            # the sync entrypoint, not this module's LoadGenerator.run)
            asyncio.run(probe())
        addrs = [cfg.addr(nid) for nid in range(cfg.n)]
        if args.gateways > 0:
            # the gateway tier under test: clients terminate there, the
            # nodes only ever see args.gateways × gateway-links peers
            gw_procs, addrs = spawn_gateways(
                cfg, args.gateways, node_links=args.gateway_links)
        if args.schedule > 0:
            schedule = build_schedule(
                args.schedule_seed, stages=args.schedule,
                base_clients=args.schedule_base,
                peak_clients=args.schedule_peak,
                waves_per_client=args.schedule_waves)
            probe = ((lambda: ctrl_state(cfg))
                     if args.max_boost > 0 else None)
            stages = run_schedule(addrs, cfg.cluster_id, shape,
                                  schedule, probe=probe)
            report = {
                "shape": asdict(shape),
                "gateways": args.gateways,
                "schedule_seed": args.schedule_seed,
                "schedule": schedule,
                "stages": stages,
            }
            if probe is not None:
                # quiet epilogue: no offered load for long enough that
                # clear_windows quiet windows elapse, then the restore
                # verdict — every node back at its exact bases
                time.sleep(max(0.0, args.ctrl_quiet))
                report["max_boost"] = args.max_boost
                report["raise_windows"] = args.raise_windows
                report["raise_headroom"] = args.raise_headroom
                report["ctrl_quiet_s"] = args.ctrl_quiet
                report["ctrl_final"] = ctrl_state(cfg)
        elif args.client_sweep:
            counts = [int(x) for x in args.client_sweep.split(",") if x]
            curve = run_client_sweep(addrs, cfg.cluster_id, shape,
                                     counts, args.sweep_waves)
            report = {
                "shape": asdict(shape),
                "gateways": args.gateways,
                "gateway_links": args.gateway_links,
                "sweep_waves": args.sweep_waves,
                "gateway_curve": curve,
            }
        else:
            report = run_load(addrs, cfg.cluster_id, shape)
            report["gateways"] = args.gateways
    finally:
        from hbbft_tpu_torch.net.cluster import shutdown_procs

        if gw_procs is not None:
            shutdown_procs(gw_procs)
        if procs is not None:
            shutdown_procs(procs)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
