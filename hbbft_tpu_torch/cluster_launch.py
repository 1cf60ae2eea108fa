#!/usr/bin/env python
"""Run a real multi-process localhost QHB cluster and pump load at it.

The networked sibling of ``python -m hbbft_tpu_torch.simulation``: instead
of the in-process simulator crank loop, this spawns ``--nodes`` OS
processes (``python -m hbbft_tpu_torch.net.cluster``), each listening on
``base_port + node_id`` with its device work on ``--device`` (default
``cuda``, raising without a card; ``cpu`` runs the kernels' plain PyTorch
versions), then drives ``--txs`` client transactions through ``--clients``
concurrent frontends and reports epochs/sec and end-to-end submit→commit
latency percentiles.  On the card the kernels are built once, here, before
any node starts.

    python -m hbbft_tpu_torch.cluster_launch --nodes 4 --txs 200 --batch-size 8

Single-node mode (what the launcher spawns, also usable by hand across
machines sharing the same --seed):

    python -m hbbft_tpu_torch.net.cluster --nodes 4 --node-id 0 \\
        --seed 0 --base-port 24000
"""

from __future__ import annotations

import argparse
import asyncio
import os
import time

from hbbft_tpu_torch.net.client import ClusterClient, latency_percentiles
from hbbft_tpu_torch.net.cluster import (
    ClusterConfig,
    connect_when_up,
    find_free_base_port,
    shutdown_procs,
    spawn_cluster,
)


async def run_load(cfg: ClusterConfig, txs: int, tx_size: int,
                   n_clients: int):
    clients = [
        await connect_when_up(cfg, c % cfg.n, client_id=f"load-{c}")
        for c in range(n_clients)
    ]
    t0 = time.monotonic()

    async def drive(ci: int, client: ClusterClient):
        for i in range(ci, txs, n_clients):
            tx = b"%08d:" % i + os.urandom(max(0, tx_size - 9))
            await client.submit(tx)
            await client.wait_committed(tx, timeout_s=120)

    await asyncio.gather(*(drive(ci, c) for ci, c in enumerate(clients)))
    wall = time.monotonic() - t0

    status = await clients[0].status()
    lat = latency_percentiles(l for c in clients for _d, l in c.latencies)
    print(f"\ncommitted {lat['count']} txs "
          f"in {status['batches']} epochs; wall {wall:.2f}s "
          f"({status['batches'] / wall:.1f} epochs/s, "
          f"{lat['count'] / wall:.0f} tx/s)")
    print(f"latency p50 {lat['p50_s'] * 1e3:.1f} ms | "
          f"p90 {lat['p90_s'] * 1e3:.1f} ms | "
          f"p99 {lat['p99_s'] * 1e3:.1f} ms")
    print(f"node 0 transport: {status['stats']}")
    for c in clients:
        await c.close()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.cluster_launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txs", type=int, default=200)
    ap.add_argument("--tx-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-tx-bytes", type=int, default=0,
                    help="per-tx admission ceiling (0 = the mempool's "
                         "default); batch × ceiling must fit in half the "
                         "wire blob cap")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-port", type=int, default=0,
                    help="0 → pick a free range automatically")
    ap.add_argument("--metrics-base-port", type=int, default=0,
                    help="obs endpoints (/metrics /status /spans "
                         "/flight) at base+i; 0 → auto (node ports + n); "
                         "-1 → off")
    ap.add_argument("--flight-dir", default="",
                    help="flight-recorder journal root (node i journals "
                         "to <dir>/node-i); empty → auto temp dir; "
                         "'off' → disable the recorder")
    ap.add_argument("--encrypt", action="store_true",
                    help="TPKE-encrypt contributions (EncryptionSchedule "
                         "always instead of never)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="epochs kept in flight per node (1 = sequential; "
                         "> 1 engages the epoch-pipelined scheduler)")
    ap.add_argument("--heartbeat-s", type=float, default=0.5,
                    help="seconds between pings on an idle peer link")
    ap.add_argument("--dead-after-s", type=float, default=3.0,
                    help="silence after which a peer link is declared dead "
                         "and redialed (also the handshake's wait)")
    ap.add_argument("--chaos", default="", metavar="SPEC",
                    help="apply a named link-shaping preset to every "
                         "node's egress (wan-100ms, lossy-1pct, "
                         "dup-reorder, partition-10s, bandwidth-64k) — "
                         "reproduce a campaign cell interactively")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="seed for the chaos fault RNGs (-1 = --seed); "
                         "pass a campaign cell's reported seed to replay "
                         "its fault schedule")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every node's device work "
                         "(default cuda; raises without a card — pass cpu "
                         "to run the plain PyTorch versions)")
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace) -> ClusterConfig:
    """The cluster the flags describe: free ports picked when none are
    given, a temporary flight-journal root unless ``--flight-dir`` names
    one (or ``off``)."""
    if args.chaos:
        # validate the preset name before spawning anything
        from hbbft_tpu_torch.chaos.link import preset_shape

        preset_shape(args.chaos, args.nodes)

    if args.base_port:
        base = args.base_port
        metrics_base = args.metrics_base_port or base + args.nodes
    else:
        # one contiguous free range covers both: node ports in the first
        # half, obs endpoints in the second
        base = find_free_base_port(2 * args.nodes)
        metrics_base = args.metrics_base_port or base + args.nodes
    if args.metrics_base_port == -1:
        metrics_base = 0
    # flight recorder on by default: every run leaves an auditable
    # black-box journal behind
    if args.flight_dir == "off":
        flight_dir = ""
    elif args.flight_dir:
        flight_dir = args.flight_dir
    else:
        import tempfile

        flight_dir = tempfile.mkdtemp(prefix="hbbft-flight-")
    return ClusterConfig(
        n=args.nodes, seed=args.seed, base_port=base,
        metrics_base_port=metrics_base,
        batch_size=args.batch_size, max_tx_bytes=args.max_tx_bytes,
        encrypt=args.encrypt,
        flight_dir=flight_dir, pipeline_depth=args.pipeline_depth,
        heartbeat_s=args.heartbeat_s, dead_after_s=args.dead_after_s,
        chaos=args.chaos, chaos_seed=args.chaos_seed,
        device=args.device,
    )


def launch(cfg: ClusterConfig, **popen_kwargs):
    """Print where the cluster serves and how to watch and audit it, then
    start every node (:func:`~hbbft_tpu_torch.net.cluster.spawn_cluster`);
    returns ``{node id: Popen}``."""
    print(f"spawning {cfg.n} node processes on "
          f"{cfg.host}:{cfg.base_port}..{cfg.base_port + cfg.n - 1} "
          f"(device {cfg.device})…")
    if cfg.chaos:
        seed = cfg.seed if cfg.chaos_seed < 0 else cfg.chaos_seed
        print(f"chaos preset {cfg.chaos!r} active on every link "
              f"(fault seed {seed}) — expect shaped latency/faults; "
              f"shaping counters are on each node's /metrics "
              f"(hbbft_chaos_*)")
    if cfg.metrics_base_port:
        print(f"obs endpoints: http://{cfg.host}:{cfg.metrics_base_port}.."
              f"{cfg.metrics_base_port + cfg.n - 1}/metrics — watch live with\n"
              f"    python -m hbbft_tpu_torch.obs.top "
              f"--base-port {cfg.metrics_base_port} --nodes {cfg.n}")
    if cfg.flight_dir:
        print(f"flight journals: {cfg.flight_dir} — audit offline with\n"
              f"    python -m hbbft_tpu_torch.obs.audit {cfg.flight_dir}")
    return spawn_cluster(cfg, **popen_kwargs)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = build_config(args)
    procs = launch(cfg)

    async def session():
        # connect_when_up retries per node, so the load clients double as
        # the cluster-is-up barrier
        print("cluster spawning; pumping load once nodes accept…")
        await run_load(cfg, args.txs, args.tx_size, args.clients)

    try:
        asyncio.run(session())
    finally:
        shutdown_procs(procs.values())


if __name__ == "__main__":
    main()
