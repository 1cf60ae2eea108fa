"""Per-transaction causal trace context: follow ONE tx across nodes.

The spans (:mod:`~hbbft_tpu_torch.obs.spans`) answer "where did this
*epoch's* latency go" per node; neither they nor a journal audit say
where a single transaction's latency went across processes.  This module
is the trace-context half of that instrument (the JAX package's
``obs/critpath.py``, the offline merge/analysis half, is not ported
yet).

**Trace context = 16-byte trace id + hop counter.**  The trace id is
*content-derived*: the first 16 bytes of ``sha3_256(tx)`` — the same
digest the mempool dedups on, the client keys its latency map on, and
``TX_ACK``/``TX_COMMIT`` frames already carry.  Deriving the id from the
tx bytes means the context **piggybacks on every existing surface** (the
client's SUBMIT frame carries the tx, the contribution carries the tx,
the committed batch carries the tx) with zero wire-format changes to
consensus traffic; only the journal grows a record type.  The hop
counter is the stage depth along the tx's causal path:

====== ============ ======================================================
hop    stage        journaled by
====== ============ ======================================================
0      ``submit``   client, when the TX frame is written
1      ``ack``      client, when the node's ``ACK_ACCEPTED`` arrives
1      ``ingress``  node, when the event loop admits the tx (mempool add)
2      ``queued``   node, when the pump's worker thread dequeues the input
3      ``commit``   every node, when the batch containing the tx commits
4      ``commit_seen`` client, when the ``TX_COMMIT`` digest arrives
4      ``commit_retrieved`` node (VID mode), when the lazily-retrieved
       payload of a committed commitment resolves
====== ============ ======================================================

A :class:`FlightTrace` record (wire tag ``0x95``, registered like every
journal record) carries one stage crossing.  ``tids`` holds the CONCATENATED 16-byte
trace ids of every tx crossing the stage together — a committed batch of
4096 txs is ONE record with a 64 KiB id vector, not 4096 records, so
MB-scale ingestion stays journal-affordable.

Determinism: trace ids are pure functions of tx bytes (no wall clock,
no ``os.urandom``), and
under the simulator the record timestamps are the deterministic virtual
clock, so two identical-seed runs produce byte-identical journals *and*
byte-identical critical-path reports.  Under sockets the timestamps are
each process's real clock.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

import hashlib

#: width of one trace id (a sha3-256 prefix: 2^-64 collision odds at
#: a billion in-flight txs — fine for attribution, not for consensus)
TRACE_ID_BYTES = 16

#: stage name → hop counter (causal depth along the tx's path)
STAGE_HOPS = {
    "submit": 0,
    "ack": 1,
    "ingress": 1,
    "queued": 2,
    "commit": 3,
    # VID mode: "commit" is the ordering instant (the epoch committed
    # the (root, cert) commitment); "commit_retrieved" is when the
    # payload itself became readable on the node — the gap between the
    # two is the lazy-retrieval latency, off the ordering critical path
    "commit_retrieved": 4,
    "commit_seen": 4,
}


def trace_id(tx: bytes) -> bytes:
    """The tx's 16-byte trace id (``sha3_256(tx)[:16]`` — the mempool /
    ack / commit digest's prefix, so every existing surface that carries
    the tx or its digest already carries the trace context)."""
    return hashlib.sha3_256(tx).digest()[:TRACE_ID_BYTES]


def tid_of_digest(digest: bytes) -> bytes:
    """Trace id from a full 32-byte tx digest (client side: ``TX_ACK``
    and ``TX_COMMIT`` frames carry the digest, not the tx)."""
    return bytes(digest[:TRACE_ID_BYTES])


def pack_tids(tids: Iterable[bytes]) -> bytes:
    """Concatenate trace ids into one ``FlightTrace.tids`` vector."""
    return b"".join(tids)


def iter_tids(tids: bytes) -> List[bytes]:
    """Split a ``FlightTrace.tids`` vector back into 16-byte ids (a
    trailing partial id — torn write — is dropped; the reader's CRC
    makes that unreachable in practice)."""
    n = len(tids) // TRACE_ID_BYTES
    return [tids[i * TRACE_ID_BYTES:(i + 1) * TRACE_ID_BYTES]
            for i in range(n)]


@dataclass(frozen=True)
class TraceContext:
    """One tx's trace context at one hop (the compact token a stage
    passes forward: 16-byte id + hop counter)."""

    tid: bytes
    hop: int

    def next(self) -> "TraceContext":
        return TraceContext(self.tid, self.hop + 1)


@dataclass(frozen=True)
class FlightTrace:
    """One causal stage crossing of one-or-many txs (journal record,
    wire tag ``0x95``; see module docstring for the stage table).

    ``detail`` is a free-form attribution string (the admitting client
    id at ``ingress``, empty elsewhere); ``(era, epoch)`` is the
    committing epoch for ``commit``/``commit_seen`` stages and the
    node's current key (best effort) for earlier stages."""

    seq: int
    t: float
    stage: str
    era: int
    epoch: int
    hop: int
    detail: str
    tids: bytes
