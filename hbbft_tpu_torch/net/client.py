"""Client-facing pieces: the node-side mempool and the contribute frontend.

:class:`Mempool` is the node's admission gate — bounded and dedup'd, so a
client flood turns into ``ACK_FULL`` backpressure instead of unbounded
QueueingHoneyBadger queues, and a replayed transaction (pending *or*
recently committed) is acknowledged without being re-proposed.

:class:`ClusterClient` is the load-generator side: it dials a node, submits
raw transaction bytes, honours backpressure (FULL acks retry with capped
exponential delay), and records submit→commit latency per transaction — the
end-to-end number "The Latency Price of Threshold Cryptosystems" says is
the one that matters.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import struct
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.net import framing, transport
from hbbft_tpu_torch.net.framing import (
    DEFAULT_MAX_FRAME,
    FrameDecoder,
    Hello,
)


class TxShedError(Exception):
    """A previously-ACCEPTED transaction was shed by the node's
    fair-admission guard and will never commit.  Raised promptly from
    ``wait_committed`` (instead of a blind timeout) when the node
    pushes the ``ACK_SHED`` notification; re-submission is the
    caller's policy (the dedup window makes it cheap)."""

    def __init__(self, digest: bytes):
        super().__init__(f"tx {digest.hex()[:16]} shed by the mempool "
                         f"fair-admission guard; re-submit if wanted")
        self.digest = digest


def tx_digest(tx: bytes) -> bytes:
    return hashlib.sha3_256(tx).digest()


def percentile(vals: List[float], p: float) -> float:
    """Nearest-rank percentile of a pre-sorted sequence — the one
    definition every latency summary in the repo shares (client
    submit→commit, bench phase breakdowns)."""
    return vals[min(len(vals) - 1, int(p * (len(vals) - 1) + 0.5))]


def latency_percentiles(latencies) -> Dict[str, float]:
    """p50/p90/p99/max summary of a sequence of latency seconds."""
    vals = sorted(latencies)
    if not vals:
        return {}
    return {
        "p50_s": percentile(vals, 0.50), "p90_s": percentile(vals, 0.90),
        "p99_s": percentile(vals, 0.99),
        "max_s": vals[-1], "count": len(vals),
    }


class Mempool:
    """Bounded, dedup'd FIFO of not-yet-committed transactions.

    ``max_tx_bytes`` bounds a single transaction at admission: a proposed
    contribution is roughly ``batch_size · max_tx_bytes`` and must stay
    well under ``wire.MAX_BLOB_BYTES`` (8 MiB) or its RBC shard messages
    would be undeliverable — reject at the door, not mid-broadcast.  The
    256 KiB default leaves a 4× margin at the default batch size of 8.

    **Fair admission under FULL pressure** (overload defense): admission
    is tracked per client id.  When the pool is full and the submitting
    client holds LESS than its fair share (``capacity // active
    clients``), the pool *sheds* the oldest pending transaction of the
    most-over-share client — counted per shed client
    (``hbbft_guard_mempool_sheds_total``) — and admits the newcomer,
    instead of letting whichever client filled the pool first starve
    everyone else.  At most ONE victim is shed per admission, and only
    when that single shed actually makes the newcomer fit.  A shed
    transaction was already acked ``ACCEPTED``; the runtime's
    ``on_shed`` hook pulls it back out of the protocol queue and
    pushes ``ACK_SHED`` to the clients, so a pending
    ``wait_committed`` fails fast with :class:`TxShedError` instead of
    riding out its timeout — re-submission is the caller's policy (the
    dedup window makes it cheap).  Clients that stay under their share
    are never shed, and the share divisor is clamped
    (``fair_clients_max``) so a swarm of self-declared sybil client
    ids cannot grind an honest bulk client's allocation toward zero.
    """

    ACCEPTED = framing.ACK_ACCEPTED
    DUPLICATE = framing.ACK_DUPLICATE
    FULL = framing.ACK_FULL
    REJECTED = framing.ACK_REJECTED

    _ACK_NAMES = {
        framing.ACK_ACCEPTED: "accepted",
        framing.ACK_DUPLICATE: "duplicate",
        framing.ACK_FULL: "full",
        framing.ACK_REJECTED: "rejected",
    }

    def __init__(self, capacity: int = 10_000, seen_cap: int = 100_000,
                 max_tx_bytes: int = 256 * 1024,
                 max_pending_bytes: int = 64 * 2**20,
                 registry=None):
        self.capacity = capacity
        self.seen_cap = seen_cap
        self.max_tx_bytes = max_tx_bytes
        # byte budget alongside the entry count: 10k max-size txs would
        # otherwise admit ~2.5 GiB before FULL fires
        self.max_pending_bytes = max_pending_bytes
        self.pending_bytes = 0
        self._pending: "OrderedDict[bytes, bytes]" = OrderedDict()  # digest→tx
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()  # recent commits
        # fair-admission bookkeeping: who owns each pending digest, how
        # many each client holds, and each client's digests in FIFO
        # order (the shed victim is the hog's OLDEST pending tx)
        self._owners: Dict[bytes, str] = {}
        self._client_counts: Dict[str, int] = {}
        self._client_bytes: Dict[str, int] = {}
        self._client_fifo: Dict[str, List[bytes]] = {}
        self._fifo_stale: Dict[str, int] = {}
        # per-victim shed tallies, key-capped like the metric registry
        # (attacker-minted client ids must not grow this dict or the
        # /status payload without bound)
        self.sheds: Dict[str, int] = {}
        self._sheds_key_cap = 32
        # fair-share floor against sybil client ids: client identities
        # are self-declared, so the share divisor is clamped — a swarm
        # of minted ids can displace an honest bulk client down to
        # capacity/fair_clients_max pending txs, never to zero
        self.fair_clients_max = 32
        # a shed tx was already handed to the consensus layer at
        # admission; the owner (NodeRuntime) hooks this to pull it back
        # out of the protocol queue so shedding really sheds —
        # otherwise every shed would grow the protocol queue past the
        # mempool's ceiling
        self.on_shed: Optional[Callable[[bytes], None]] = None
        # admission (event loop) and commit pruning (the runtime's pump
        # worker) run on different threads since the pipelined scheduler;
        # the compound size/byte-budget invariants need this lock
        self._lock = threading.Lock()
        self._acks = None
        self._sheds = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        """Attach admission metrics to a node's registry (the runtime does
        this, so a caller-supplied mempool is counted too); gauges for
        depth and byte budget are registered via the collect callback."""
        self._acks = registry.counter(
            "hbbft_node_mempool_acks_total",
            "client/local tx admissions by outcome",
            labelnames=("status",), max_label_sets=len(self._ACK_NAMES) + 1,
        )
        for name in self._ACK_NAMES.values():
            self._acks.labels(status=name)
        self._sheds = registry.counter(
            "hbbft_guard_mempool_sheds_total",
            "pending transactions shed under FULL pressure to admit an "
            "under-share client's tx, labeled by the SHED client",
            labelnames=("client",), max_label_sets=33)
        g_pending = registry.gauge(
            "hbbft_node_mempool_pending", "not-yet-committed transactions")
        g_bytes = registry.gauge(
            "hbbft_node_mempool_pending_bytes",
            "bytes held by pending transactions")
        g_clients = registry.gauge(
            "hbbft_guard_mempool_clients",
            "distinct clients with pending transactions")
        registry.register_callback(lambda: (
            g_pending.set(len(self._pending)),
            g_bytes.set(self.pending_bytes),
            g_clients.set(len(self._client_counts)),
        ))

    def _count(self, status: int) -> int:
        if self._acks is not None:
            self._acks.labels(status=self._ACK_NAMES[status]).inc()
        return status

    def add(self, tx: bytes, client_id: str = "_anon") -> int:
        if len(tx) > self.max_tx_bytes:
            return self._count(self.REJECTED)
        digest = tx_digest(tx)
        shed_tx: Optional[bytes] = None
        try:
            with self._lock:
                if digest in self._pending or digest in self._seen:
                    return self._count(self.DUPLICATE)
                if (len(self._pending) >= self.capacity
                        or self.pending_bytes + len(tx)
                        > self.max_pending_bytes):
                    # at most ONE victim per admission, and only when
                    # that single shed actually makes the newcomer fit
                    # — never destroy acked state for a FULL anyway
                    shed_tx = self._shed_for(client_id, len(tx))
                    if shed_tx is None:
                        return self._count(self.FULL)
                self._admit(digest, tx, client_id)
            return self._count(self.ACCEPTED)
        finally:
            # outside the lock: the hook re-enters the runtime (pump
            # enqueue)
            if shed_tx is not None and self.on_shed is not None:
                self.on_shed(shed_tx)

    def _admit(self, digest: bytes, tx: bytes, client_id: str) -> None:
        self._pending[digest] = tx
        self.pending_bytes += len(tx)
        self._owners[digest] = client_id
        self._client_counts[client_id] = (
            self._client_counts.get(client_id, 0) + 1
        )
        self._client_bytes[client_id] = (
            self._client_bytes.get(client_id, 0) + len(tx)
        )
        self._client_fifo.setdefault(client_id, []).append(digest)

    def _shed_for(self, client_id: str,
                  need_bytes: int) -> Optional[bytes]:
        """Shed ONE pending tx to make room for ``client_id`` — only if
        the submitter is UNDER its fair share, some other client is
        over it, and removing that single victim actually admits a
        ``need_bytes`` newcomer (feasibility first: acked state is
        never destroyed for a FULL anyway).  Returns the shed tx bytes
        (for the ``on_shed`` hook) or None.  Caller holds the lock."""
        # the submitter counts as active even before its first
        # admission — that is exactly the starvation case.  The divisor
        # is clamped (`fair_clients_max`): client ids are self-declared,
        # and an unclamped share would let a sybil swarm grind an
        # honest bulk client's allocation toward zero.  Pressure is the
        # worse of the COUNT share and the BYTE share — a client that
        # filled max_pending_bytes with a few huge txs is just as much
        # over its share as one that filled the entry count.
        active = len(self._client_counts) + (
            0 if client_id in self._client_counts else 1)
        denom = max(1, min(active, self.fair_clients_max))
        count_share = max(1, self.capacity // denom)
        byte_share = max(1, self.max_pending_bytes // denom)

        def pressure(c: str) -> float:
            return max(
                self._client_counts.get(c, 0) / count_share,
                self._client_bytes.get(c, 0) / byte_share,
            )

        if pressure(client_id) >= 1.0:
            return None
        victim = max(self._client_counts,
                     key=lambda c: (pressure(c), c), default=None)
        if (victim is None or victim == client_id
                or pressure(victim) <= 1.0):
            return None
        fifo = self._client_fifo.get(victim, [])
        while fifo:
            digest = fifo[0]
            dropped = self._pending.get(digest)
            if dropped is None:
                fifo.pop(0)
                continue  # already committed; stale fifo entry
            if (len(self._pending) - 1 >= self.capacity
                    or self.pending_bytes - len(dropped) + need_bytes
                    > self.max_pending_bytes):
                return None  # one shed would not admit the newcomer
            fifo.pop(0)
            del self._pending[digest]
            self.pending_bytes -= len(dropped)
            self._forget_owner(digest, len(dropped))
            key = victim
            if (key not in self.sheds
                    and len(self.sheds) >= self._sheds_key_cap):
                key = "_overflow_"        # bounded like the registry
            self.sheds[key] = self.sheds.get(key, 0) + 1
            if self._sheds is not None:
                self._sheds.labels(client=victim).inc()
            return dropped
        return None

    def _forget_owner(self, digest: bytes, nbytes: int) -> None:
        owner = self._owners.pop(digest, None)
        if owner is None:
            return
        left = self._client_counts.get(owner, 0) - 1
        if left > 0:
            self._client_counts[owner] = left
            self._client_bytes[owner] = max(
                0, self._client_bytes.get(owner, 0) - nbytes)
            # committed digests go stale in the owner's FIFO (removing
            # them eagerly would be O(n) per commit); compact once the
            # stale fraction dominates so the list itself stays bounded
            stale = self._fifo_stale.get(owner, 0) + 1
            fifo = self._client_fifo.get(owner)
            if fifo is not None and stale * 2 > len(fifo):
                fifo[:] = [d for d in fifo if d in self._pending]
                stale = 0
            self._fifo_stale[owner] = stale
        else:
            self._client_counts.pop(owner, None)
            self._client_bytes.pop(owner, None)
            self._client_fifo.pop(owner, None)
            self._fifo_stale.pop(owner, None)

    def mark_committed_digests(self, digests) -> int:
        """Complete pending txs by DIGEST — a relay tier (the gateway)
        forwarding a node's ``TX_COMMIT`` only sees digests, never the
        tx bytes.  Drops matching pending entries, records every digest
        in the dedup window (a re-submission of a committed tx answers
        DUPLICATE, same as :meth:`mark_committed`), and returns how many
        pending entries were actually dropped."""
        n = 0
        with self._lock:
            for digest in digests:
                dropped = self._pending.pop(digest, None)
                if dropped is not None:
                    self.pending_bytes -= len(dropped)
                    self._forget_owner(digest, len(dropped))
                    n += 1
                self._seen[digest] = None
            while len(self._seen) > self.seen_cap:
                self._seen.popitem(last=False)
        return n

    def has_pending(self, digest: bytes) -> bool:
        """Is this digest still awaiting commit here?  (Relay tiers use
        this to skip forwarding entries that were shed or completed
        between enqueue and flush.)"""
        with self._lock:
            return digest in self._pending

    def mark_committed(self, txs) -> List[bytes]:
        """Drop committed txs from pending; returns their digests."""
        digests = []
        with self._lock:
            for tx in txs:
                digest = tx_digest(tx)
                digests.append(digest)
                dropped = self._pending.pop(digest, None)
                if dropped is not None:
                    self.pending_bytes -= len(dropped)
                    self._forget_owner(digest, len(dropped))
                self._seen[digest] = None
            while len(self._seen) > self.seen_cap:
                self._seen.popitem(last=False)
        return digests

    def __len__(self) -> int:
        return len(self._pending)


class ClusterClient:
    """Asyncio frontend for submitting transactions to one node."""

    def __init__(self, addr: Tuple[str, int], cluster_id: bytes,
                 client_id: str = "client",
                 max_frame: int = DEFAULT_MAX_FRAME,
                 connect_timeout_s: float = 5.0,
                 keepalive_s: float = 10.0,
                 trace_dir: Optional[str] = None):
        self.addr = addr
        self.cluster_id = bytes(cluster_id)
        self.client_id = client_id
        self.max_frame = max_frame
        self.connect_timeout_s = connect_timeout_s
        # periodic PINGs keep an idle client (e.g. one parked in
        # wait_committed) from tripping the node's inbound read deadline
        self.keepalive_s = keepalive_s
        self.node_hello: Optional[Hello] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        # concurrent submit()/status() coroutines must not await
        # writer.drain() simultaneously (asyncio's _drain_helper assert)
        self._wlock = asyncio.Lock()
        self._reader_task: Optional[asyncio.Task] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        # per-digest FIFO waiter lists, like _commits: a duplicate digest
        # in one batch (or a submit racing submit_many) must not clobber
        # an earlier future — each TX frame written earns one ack, and
        # acks resolve waiters in submission order
        self._acks: Dict[bytes, List[asyncio.Future]] = {}
        # one future PER WAITER (asyncio.wait_for cancels the future it
        # wraps, so sharing one would let a timed-out waiter break the
        # others and leave a dead future pinned under the digest)
        self._commits: Dict[bytes, List[asyncio.Future]] = {}
        self._status_waiters: List[asyncio.Future] = []
        self._submit_times: Dict[bytes, float] = {}
        # commits already seen for OUR txs (bounded), so a wait_committed
        # issued after the TX_COMMIT frame still resolves; foreign digests
        # (other clients' txs, which nodes broadcast to everyone) are not
        # retained at all
        self._committed: "OrderedDict[bytes, float]" = OrderedDict()
        self._committed_cap = 65_536
        self._dead: Optional[Exception] = None
        # (digest_hex, submit→commit seconds), in commit order
        self.latencies: List[Tuple[str, float]] = []
        # per-tx causal tracing (obs.trace / obs.critpath): journal the
        # client-side stages — submit (TX frame written), ack (the
        # node's admission reply) and commit_seen (TX_COMMIT arrived) —
        # with wall-clock timestamps; obs.critpath pairs them with the
        # node journals to bound the client↔node clock offset
        self._trace_rec = None
        if trace_dir:
            from hbbft_tpu_torch.obs.flight import FlightRecorder

            self._trace_rec = FlightRecorder(
                trace_dir, node=client_id, flavor="client",
                clock=time.time)

    # -- lifecycle -----------------------------------------------------------

    async def connect(self) -> Hello:
        reader, writer, node_hello = await framing.client_hello_handshake(
            self.addr, self.cluster_id, self.client_id,
            timeout_s=self.connect_timeout_s, max_frame=self.max_frame,
        )
        transport.set_nodelay(writer)
        self._reader, self._writer = reader, writer
        self.node_hello = node_hello
        loop = asyncio.get_running_loop()
        self._reader_task = loop.create_task(
            self._recv_loop(), name=f"client-{self.client_id}"
        )
        self._keepalive_task = loop.create_task(
            self._keepalive_loop(), name=f"client-ka-{self.client_id}"
        )
        return self.node_hello

    async def close(self) -> None:
        for task in (self._reader_task, self._keepalive_task):
            if task is not None:
                task.cancel()
                # suppress: awaiting our own cancelled tasks; a late recv
                # error already failed all waiters via _fail_waiters
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task
        if self._writer is not None:
            self._writer.close()
        if self._trace_rec is not None:
            self._trace_rec.close()

    def _trace(self, stage: str, tids: bytes, era: int = 0,
               epoch: int = (1 << 64) - 1) -> None:
        """Journal one client-side trace stage (no-op without
        ``trace_dir``); default (era, epoch) is the unknown-epoch
        sentinel — the client learns the committing epoch only from
        the TX_COMMIT frame."""
        if self._trace_rec is not None and tids:
            self._trace_rec.record_trace(stage, era, epoch, tids,
                                         detail=self.client_id)

    # -- submitting ----------------------------------------------------------

    async def submit(self, tx: bytes, *, retry_full: bool = True,
                     max_retries: int = 50,
                     ack_timeout_s: float = 10.0) -> int:
        """Submit ``tx``; waits for the node's ack.  ``ACK_FULL`` retries
        with capped exponential delay (backpressure) unless ``retry_full``
        is off.  Returns the final ack status."""
        digest = tx_digest(tx)
        delay = 0.02
        status = framing.ACK_FULL
        try:
            for _attempt in range(max_retries):
                self._check_alive()
                fut = asyncio.get_running_loop().create_future()
                self._acks.setdefault(digest, []).append(fut)
                self._submit_times.setdefault(digest, time.monotonic())
                self._trace("submit", digest[:16])
                async with self._wlock:
                    self._writer.write(framing.encode_frame(
                        framing.TX, tx, self.max_frame
                    ))
                    await self._writer.drain()
                try:
                    status = await asyncio.wait_for(fut, ack_timeout_s)
                finally:
                    self._drop_ack_waiter(digest, fut)
                if status != framing.ACK_FULL or not retry_full:
                    return status
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)
            return status
        finally:
            # a tx that will never commit must not pin a submit-time entry
            # forever: rejected/full outcomes are final, and a duplicate of
            # an already-seen commit resolves from the bounded record
            if status in (framing.ACK_REJECTED, framing.ACK_FULL) or (
                status == framing.ACK_DUPLICATE and digest in self._committed
            ):
                self._submit_times.pop(digest, None)

    async def submit_many(self, txs, *, ack_timeout_s: float = 30.0) -> list:
        """Submit a batch of transactions with ONE socket write and one
        shared ack wait — the load-generator fast path (a per-tx
        ``submit()`` loop costs a lock round + drain + timer per
        transaction, which on a small host is a measurable share of the
        cluster's CPU).  No FULL-retry logic: callers that batch are
        expected to size waves under the mempool bound.  Returns the ack
        status list, index-aligned with ``txs``."""
        self._check_alive()
        loop = asyncio.get_running_loop()
        futs = []
        buf = bytearray()
        for tx in txs:
            digest = tx_digest(tx)
            fut = loop.create_future()
            self._acks.setdefault(digest, []).append(fut)
            futs.append((digest, fut))
            self._submit_times.setdefault(digest, time.monotonic())
            buf += framing.encode_frame(framing.TX, tx, self.max_frame)
        # one packed trace record for the whole wave (one record per
        # batch, not per tx — same shape as the node's commit records)
        self._trace("submit", b"".join(d[:16] for d, _f in futs))
        async with self._wlock:
            self._writer.write(bytes(buf))
            await self._writer.drain()
        try:
            return list(await asyncio.wait_for(
                asyncio.gather(*(f for _d, f in futs)), ack_timeout_s
            ))
        finally:
            for digest, fut in futs:
                self._drop_ack_waiter(digest, fut)

    async def wait_committed(self, tx: bytes, timeout_s: float = 60.0) -> float:
        """Block until the node reports ``tx`` committed; returns the
        submit→commit latency in seconds."""
        digest = tx_digest(tx)
        done = self._committed.get(digest)
        if done is not None:
            return done
        self._check_alive()
        fut = asyncio.get_running_loop().create_future()
        waiters = self._commits.setdefault(digest, [])
        waiters.append(fut)
        try:
            return await asyncio.wait_for(fut, timeout_s)
        finally:
            # a timed-out waiter must not pin its (cancelled) future
            if fut in waiters:
                waiters.remove(fut)
            if not waiters:
                self._commits.pop(digest, None)

    async def wait_committed_many(self, txs, timeout_s: float = 60.0) -> list:
        """Latencies for a batch of transactions with one shared timeout
        (a ``wait_committed`` per tx costs a timer handle + future wrap
        each).  Returns latency seconds, index-aligned with ``txs``."""
        loop = asyncio.get_running_loop()
        futs = []
        waiter_refs = []
        for tx in txs:
            digest = tx_digest(tx)
            done = self._committed.get(digest)
            if done is not None:
                fut = loop.create_future()
                fut.set_result(done)
                futs.append(fut)
                continue
            self._check_alive()
            fut = loop.create_future()
            waiters = self._commits.setdefault(digest, [])
            waiters.append(fut)
            waiter_refs.append((digest, waiters, fut))
            futs.append(fut)
        try:
            return list(await asyncio.wait_for(
                asyncio.gather(*futs), timeout_s
            ))
        finally:
            for digest, waiters, fut in waiter_refs:
                if fut in waiters:
                    waiters.remove(fut)
                if not waiters:
                    self._commits.pop(digest, None)

    async def status(self, timeout_s: float = 10.0,
                     chain_tail: Optional[int] = None) -> dict:
        """Fetch the node's status document.  ``chain_tail`` limits the
        digest-chain tail in the reply (0 = head/length only — the cheap
        form for poll loops; None = the node's full default)."""
        self._check_alive()
        fut = asyncio.get_running_loop().create_future()
        self._status_waiters.append(fut)
        payload = b"" if chain_tail is None else struct.pack(
            ">I", chain_tail)
        async with self._wlock:
            self._writer.write(framing.encode_frame(
                framing.STATUS_REQ, payload, self.max_frame
            ))
            await self._writer.drain()
        return await asyncio.wait_for(fut, timeout_s)

    # -- stats ---------------------------------------------------------------

    def latency_percentiles(self) -> Dict[str, float]:
        return latency_percentiles(lat for _d, lat in self.latencies)

    # -- internals -----------------------------------------------------------

    async def _keepalive_loop(self) -> None:
        nonce = 0
        while self._dead is None:
            await asyncio.sleep(self.keepalive_s)
            nonce += 1
            try:
                async with self._wlock:
                    self._writer.write(framing.encode_frame(
                        framing.PING, struct.pack(">Q", nonce),
                        self.max_frame,
                    ))
                    await self._writer.drain()
            # hblint: disable=fault-swallowed-drop (nothing to account
            # client-side: the recv loop fails every pending waiter with
            # the connection error; this loop just stops pinging)
            except (ConnectionError, OSError):
                return

    async def _recv_loop(self) -> None:
        decoder = FrameDecoder(self.max_frame)
        try:
            while True:
                data = await self._reader.read(65536)
                if not data:
                    raise ConnectionError("node closed connection")
                for kind, payload in decoder.feed(data):
                    self._on_frame(kind, payload)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            # a dead reader must surface NOW on every pending future —
            # not as N× full submit/commit timeouts later
            self._fail_waiters(
                exc if isinstance(exc, ConnectionError)
                else ConnectionError(f"client receive loop died: {exc!r}")
            )

    def _drop_ack_waiter(self, digest: bytes, fut: asyncio.Future) -> None:
        waiters = self._acks.get(digest)
        if waiters is not None:
            with contextlib.suppress(ValueError):
                waiters.remove(fut)
            if not waiters:
                del self._acks[digest]

    def _on_frame(self, kind: int, payload: bytes) -> None:
        if kind == framing.TX_ACK:
            status, digest = payload[0], payload[1:33]
            if status == framing.ACK_SHED:
                # push notification, not a reply to a written TX frame:
                # fail the commit waiters NOW instead of letting them
                # ride out the full timeout on a tx that can never land
                self._submit_times.pop(digest, None)
                for fut in self._commits.pop(digest, ()) or ():
                    if not fut.done():
                        fut.set_exception(TxShedError(digest))
                return
            waiters = self._acks.get(digest)
            if waiters:
                fut = waiters.pop(0)  # one ack per written TX frame: FIFO
                if not waiters:
                    del self._acks[digest]
                if not fut.done():
                    fut.set_result(status)
                if status == framing.ACK_ACCEPTED:
                    self._trace("ack", digest[:16])
        elif kind == framing.TX_COMMIT:
            # u64 era + u64 epoch + u32 count + count × 32-byte digests;
            # nodes broadcast every committed digest to every client, so
            # only digests we submitted or are awaiting are retained
            era, epoch, count = struct.unpack_from(">QQI", payload, 0)
            now = time.monotonic()
            seen_tids = []
            for i in range(count):
                digest = payload[20 + 32 * i : 52 + 32 * i]
                t0 = self._submit_times.pop(digest, None)
                waiters = self._commits.pop(digest, None)
                if t0 is None and waiters is None:
                    continue  # someone else's transaction
                seen_tids.append(digest[:16])
                lat = now - t0 if t0 is not None else 0.0
                if t0 is not None:
                    # hblint: disable=bounded-ingress (one entry per tx
                    # THIS client submitted — caller-controlled load-
                    # generator measurement data, not peer-driven growth)
                    self.latencies.append((digest.hex(), lat))
                self._committed[digest] = lat
                while len(self._committed) > self._committed_cap:
                    self._committed.popitem(last=False)
                for fut in waiters or ():
                    if not fut.done():
                        fut.set_result(lat)
            self._trace("commit_seen", b"".join(seen_tids), era, epoch)
        elif kind == framing.STATUS:
            doc = json.loads(payload.decode())
            waiters, self._status_waiters = self._status_waiters, []
            for fut in waiters:
                if not fut.done():
                    fut.set_result(doc)

    def _check_alive(self) -> None:
        if self._dead is not None:
            raise ConnectionError(
                f"connection to {self.addr} is dead: {self._dead}"
            )

    def _fail_waiters(self, exc: Exception) -> None:
        self._dead = exc
        commit_futs = [
            fut for waiters in self._commits.values() for fut in waiters
        ]
        ack_futs = [
            fut for waiters in self._acks.values() for fut in waiters
        ]
        for fut in (ack_futs + commit_futs + self._status_waiters):
            if not fut.done():
                fut.set_exception(exc)
