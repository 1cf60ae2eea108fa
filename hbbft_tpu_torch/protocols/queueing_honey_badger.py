"""The transaction queue of Queueing HoneyBadger.

The port's copy of ``TransactionQueue`` and the transaction-list codec of
the JAX package's ``protocols/queueing_honey_badger.py`` (reference:
``src/transaction_queue.rs``): user transactions are buffered, each epoch a
node proposes a random sample of ``batch_size`` of them, committed ones are
removed everywhere and leftovers are re-proposed.  The object-mode
``QueueingHoneyBadger`` is not ported; ``parallel/qhb.py`` drives the queue.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.protocols import wire


class TransactionQueue:
    """Reference: ``src/transaction_queue.rs :: trait TransactionQueue``.

    Random sampling (``choose``) keeps different nodes' batch proposals
    mostly disjoint, which is what makes N proposals per epoch add up to
    N× throughput instead of N× duplication.
    """

    def __init__(self):
        self._txs: List[bytes] = []
        self._set: Dict[bytes, int] = {}

    def extend(self, txs: Sequence[bytes]) -> None:
        for tx in txs:
            tx = bytes(tx)
            if tx not in self._set:
                self._set[tx] = 1
                self._txs.append(tx)

    def remove_multiple(self, txs) -> int:
        """Drop ``txs`` from the queue; returns how many were present
        (the overload guard's shed path needs to know whether a tx was
        actually still queued)."""
        # accept a pre-built set: the QHB commit prunes N queues with the
        # same epoch batch, and rebuilding the drop set per queue is O(N²)
        # across the network (16.7M hashes per epoch at N=4096)
        drop = txs if isinstance(txs, (set, frozenset)) else {
            bytes(t) for t in txs
        }
        if not drop:
            return 0
        before = len(self._txs)
        self._txs = [t for t in self._txs if t not in drop]
        # iterate the smaller side: a node's queue is usually far smaller
        # than the network-wide epoch batch
        if len(self._set) < len(drop):
            for t in [t for t in self._set if t in drop]:
                del self._set[t]
        else:
            for t in drop:
                self._set.pop(t, None)
        return before - len(self._txs)

    def choose(self, rng: random.Random, amount: int,
               exclude: Optional[set] = None) -> List[bytes]:
        """Sample ``amount`` txs; with ``exclude`` (the pipelined
        proposer's in-flight set), sample only txs not already riding an
        open epoch — a duplicate commit wastes a slot in BOTH epochs and
        holds the client's latency to the later one."""
        if exclude:
            fresh = [t for t in self._txs if t not in exclude]
            if amount >= len(fresh):
                return fresh
            return rng.sample(fresh, amount)
        if amount >= len(self._txs):
            return list(self._txs)
        return rng.sample(self._txs, amount)

    def __len__(self) -> int:
        return len(self._txs)


def _ser_txs(txs: Sequence[bytes]) -> bytes:
    out = wire.u32(len(txs))
    for tx in txs:
        out += wire.blob(tx)
    return out


def _de_txs(data: bytes) -> Tuple[bytes, ...]:
    r = wire.Reader(data)
    n = r.u32()
    if n > 1_000_000:
        raise ValueError("absurd tx count")
    return tuple(r.blob() for _ in range(n))
