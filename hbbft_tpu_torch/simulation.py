#!/usr/bin/env python
"""QueueingHoneyBadger over a simulated network — the reference's benchmark.

The port's counterpart of the JAX package's ``examples/simulation.py``
(upstream: ``examples/simulation.rs``): N nodes run QHB over DHB on the
deterministic in-process simulator with a synthetic hardware model
(per-message CPU lag + bandwidth charge driving a virtual clock),
committing ``--txs`` random transactions in ``--batch-size`` proposals, and
print a per-epoch timing / throughput table.  Same flags and table, plus
``--device`` (default ``cuda``; raises without a card): where the
protocols' crypto batches (``crypto/batch.py``) and the ``device`` erasure
backend (``HBBFT_ERASURE_BACKEND=device``) run.

    python -m hbbft_tpu_torch.simulation --nodes 4 --txs 200 --batch-size 50 \\
        --tx-size 64 --bandwidth-gbps 1.0 --cpu-lag-us 10 --device cpu

``--batched`` runs the epochs on the array-mode driver
(``parallel/qhb.py``) instead; ``--batched --remove-node ID`` drains the
ledger across a validator removal.
"""

from __future__ import annotations

import argparse
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
from hbbft_tpu_torch.protocols.queueing_honey_badger import (
    QhbBatch,
    QueueingHoneyBadger,
    TxInput,
)
from hbbft_tpu_torch.sim import CostModel, EventLog, NetBuilder, NullAdversary


@dataclass
class ObjectRun:
    """What an object-mode run leaves behind: the network (each node's
    outputs and fault log), its event log, the transactions, node 0's
    per-epoch rows and the wall seconds of the crank loop."""

    net: object
    trace: EventLog
    txs: List[bytes]
    committed: set
    epoch_rows: List[tuple] = field(default_factory=list)
    wall_s: float = 0.0


def make_cost_model(args) -> CostModel:
    return CostModel(
        bandwidth_bps=args.bandwidth_gbps * 1e9,
        cpu_lag_s=args.cpu_lag_us * 1e-6,
    )


def gen_txs(args, rng):
    return [
        bytes(rng.randrange(256) for _ in range(args.tx_size))
        for _ in range(args.txs)
    ]


def print_virtual_time(committed: int, virtual_time: float) -> None:
    print(f"virtual time {virtual_time * 1e3:.3f} ms "
          f"({committed / max(virtual_time, 1e-12):.0f} tx/s simulated)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txs", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--tx-size", type=int, default=64)
    ap.add_argument("--bandwidth-gbps", type=float, default=1.0)
    ap.add_argument("--cpu-lag-us", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--batched", action="store_true",
        help="run epochs on the batched array-mode driver (one batched "
             "HoneyBadger epoch per round) instead of the object-mode "
             "message pump",
    )
    ap.add_argument(
        "--remove-node", type=int, metavar="ID", default=None,
        help="with --batched: vote node ID out mid-run — the ledger drains "
             "across the DKG + era rotation (the composed "
             "queueing-over-dynamic-membership stack)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the crypto batches and the device erasure backend run "
             "(default cuda; cpu runs the kernels' plain versions)",
    )
    return ap


def simulate(argv: Optional[List[str]] = None) -> Optional[ObjectRun]:
    """Parse ``argv``, run, print the table; returns the object-mode run
    (None for ``--batched``)."""
    ap = parser()
    args = ap.parse_args(argv)

    n = args.nodes
    # arg validation BEFORE the expensive BLS keygen
    if args.remove_node is not None:
        if not args.batched:
            ap.error("--remove-node requires --batched")
        if not 0 <= args.remove_node < n:
            ap.error(f"--remove-node {args.remove_node} is not a validator "
                     f"id (0..{n - 1})")
        if n < 2:
            ap.error("--remove-node needs at least 2 nodes (someone must "
                     "remain to carry the ledger)")
    device = resolve_device(args.device)
    rng = random.Random(args.seed)
    print(f"generating BLS keys for {n} nodes…")
    infos = NetworkInfo.generate_map(list(range(n)), rng)

    if args.remove_node is not None:
        run_batched_dynamic(args, infos, rng, device)
        return None
    if args.batched:
        run_batched(args, infos, rng, device)
        return None
    return run_object(args, infos, rng, device)


def run_object(args, infos, rng, device) -> ObjectRun:
    """QHB over DHB over ``VirtualNet``, one message per crank, until every
    transaction is in node 0's ledger."""
    n = args.nodes
    trace = EventLog()
    cost = make_cost_model(args)
    net = (
        NetBuilder(list(range(n)))
        .adversary(NullAdversary())
        .trace(trace)
        .cost_model(cost)
        .using_step(
            lambda nid: QueueingHoneyBadger.builder(
                DynamicHoneyBadger.builder(infos[nid], infos[nid].secret_key())
                .rng(random.Random(1000 + nid))
                .device(device)
                .build()
            )
            .batch_size(args.batch_size)
            .rng(random.Random(2000 + nid))
            .build()
        )
    )

    txs = gen_txs(args, rng)
    for i, tx in enumerate(txs):
        net.send_input(i % n, TxInput(tx))

    committed: set = set()
    epoch_rows = []
    seen_keys: set = set()
    scanned = 0  # index into node 0's outputs — O(1) bookkeeping per crank
    t0 = time.perf_counter()
    last_vt = 0.0
    while len(committed) < len(txs):
        if net.crank() is None:
            break
        outputs = net.nodes[0].outputs
        while scanned < len(outputs):
            out = outputs[scanned]
            scanned += 1
            if not isinstance(out, QhbBatch):
                continue
            key = (out.era, out.epoch)
            if key in seen_keys:
                continue
            seen_keys.add(key)
            batch_txs = out.all_txs()
            new_txs = [t for t in batch_txs if t not in committed]
            committed.update(batch_txs)
            epoch_rows.append(
                (
                    key,
                    len(new_txs),
                    len(committed),
                    net.virtual_time - last_vt,
                    net.virtual_time,
                )
            )
            last_vt = net.virtual_time

    wall = time.perf_counter() - t0
    print(f"\n{'era.ep':>7} {'txs':>6} {'total':>6} {'Δvt(ms)':>9} {'vt(ms)':>9}")
    for (era, ep), ntx, tot, dvt, vt in epoch_rows:
        print(f"{era:>4}.{ep:<2} {ntx:>6} {tot:>6} "
              f"{dvt * 1e3:>9.3f} {vt * 1e3:>9.3f}")
    msgs = trace.messages_by_type()
    print(f"\ncommitted {len(committed)}/{len(txs)} txs in "
          f"{len(epoch_rows)} epochs")
    print(f"virtual time {net.virtual_time * 1e3:.3f} ms "
          f"({len(committed) / max(net.virtual_time, 1e-12):.0f} tx/s simulated); "
          f"wall {wall:.2f}s")
    print("messages:", ", ".join(f"{k}×{v}" for k, v in sorted(msgs.items())),
          f"| {trace.total_bytes()} wire bytes")
    return ObjectRun(net, trace, txs, committed, epoch_rows, wall)


def run_batched(args, infos, rng, device) -> None:
    """The same QHB scenario with each epoch executed as one batched
    array-mode HoneyBadger epoch on ``device``."""
    from hbbft_tpu_torch.parallel.qhb import BatchedQueueingHoneyBadger

    n = args.nodes
    qhb = BatchedQueueingHoneyBadger(
        infos, batch_size=args.batch_size, cost_model=make_cost_model(args),
        device=device,
    )
    txs = gen_txs(args, rng)
    for i, tx in enumerate(txs):
        qhb.push(i % n, tx)

    print(f"\n{'epoch':>6} {'txs':>6} {'total':>6} {'wall(s)':>9}")
    t0 = time.perf_counter()
    last = [t0]

    def on_epoch(epoch, new):
        now = time.perf_counter()
        print(f"{epoch:>6} {len(new):>6} {len(qhb.committed):>6} "
              f"{now - last[0]:>9.2f}")
        last[0] = now

    # enough epochs for the workload even with worst-case sampling overlap
    max_epochs = max(64, 4 * -(-args.txs // max(n * args.batch_size, 1)))
    qhb.run_to_empty(rng, max_epochs=max_epochs, on_epoch=on_epoch)
    wall = time.perf_counter() - t0
    assert set(qhb.committed) == set(txs)
    print(f"\ncommitted {len(qhb.committed)}/{len(txs)} txs in "
          f"{qhb.epoch} batched epochs; wall {wall:.2f}s "
          f"({len(qhb.committed) / max(wall, 1e-9):.0f} tx/s incl. compile)")
    print_virtual_time(len(qhb.committed), qhb.virtual_time)


def run_batched_dynamic(args, infos, rng, device) -> None:
    """The composed stack: transaction queueing over dynamic membership —
    vote ``--remove-node`` out after the first epoch and drain the ledger
    across the DKG + era rotation."""
    from hbbft_tpu_torch.parallel.qhb import BatchedQueueingDynamicHoneyBadger

    n = args.nodes
    victim = args.remove_node  # validated against 0..n-1 at arg parsing
    q = BatchedQueueingDynamicHoneyBadger(
        infos, batch_size=args.batch_size, rng=random.Random(args.seed + 1),
        cost_model=make_cost_model(args), device=device,
    )
    txs = gen_txs(args, rng)
    keepers = [nid for nid in range(n) if nid != victim]
    for i, tx in enumerate(txs):
        q.push(keepers[i % len(keepers)], tx)

    print(f"\n{'era.ep':>7} {'txs':>6} {'total':>6} {'validators':>11} "
          f"{'change':>12} {'wall(s)':>9}")
    t0 = time.perf_counter()
    last = t0
    epochs = 0
    max_epochs = max(
        64, 4 * -(-args.txs // max(n * args.batch_size, 1)) + 8
    )
    while q.pending() > 0 or q.dhb.era == 0:
        if epochs >= max_epochs:
            raise SystemExit("did not drain")
        if epochs == 1:
            for voter in list(q.dhb.validators):
                q.vote_to_remove(voter, victim)
            print(f"# epoch 1: all validators vote to remove {victim}")
        new = q.run_epoch(random.Random(3000 + epochs))
        b = q.dhb.batches[-1]
        now = time.perf_counter()
        print(f"{b.era:>4}.{b.epoch:<2} {len(new):>6} {len(q.committed):>6} "
              f"{len(q.dhb.validators):>11} {b.change.state:>12} "
              f"{now - last:>9.2f}")
        last = now
        epochs += 1
    wall = time.perf_counter() - t0
    assert set(q.committed) == set(txs)
    assert q.dhb.era >= 1 and victim not in q.dhb.validators
    print(f"\ncommitted {len(q.committed)}/{len(txs)} txs across the era "
          f"rotation in {epochs} epochs; era {q.dhb.era}, validators "
          f"{sorted(q.dhb.validators)}; wall {wall:.2f}s")
    print_virtual_time(len(q.committed), q.virtual_time)


def main(argv: Optional[List[str]] = None) -> int:
    simulate(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
