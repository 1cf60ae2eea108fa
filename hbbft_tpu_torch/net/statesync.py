"""Chunked, resumable snapshot state-sync over the framed transport.

The production join path: a node with **zero history** —
a brand-new validator, or a restarted one whose outage exceeded its
peers' replay retention — fetches a
:class:`~hbbft_tpu_torch.snapshot.JoinSnapshot` from the live cluster instead
of replaying epochs.  The protocol is deliberately dumb-donor /
smart-joiner:

- every node keeps the latest era-boundary snapshot image published by
  its runtime (:class:`SnapshotStore`) and answers two request types on
  ordinary client-role connections: *manifest* (era, image digest,
  ledger-chain position, chunk geometry) and *chunk n of image X*;
- the joiner (:class:`StateSyncClient`) first collects manifests from
  every reachable donor and requires ``min_manifest_confirm`` of them to
  agree on ``(era, image digest, chain head, chain length)`` before
  fetching a single byte — a lone lying donor cannot pick the image;
- chunks are **content-addressed** by the image digest, so the transfer
  resumes on any other donor serving the same image: a donor that
  stalls, dies mid-chunk, or answers garbage costs one retry and a
  failover, never a restart from byte zero.  Full donor cycles back off
  exponentially (seeded — deterministic schedules in tests);
- every chunk carries a CRC32 and the assembled image must hash to the
  manifest's digest; the decoded snapshot must agree with the manifest's
  chain head/length — only then is it handed to activation
  (:func:`hbbft_tpu_torch.snapshot.build_joiner` replays the DKG transcript
  and verifies the regenerated public key set).

Wire records (``SyncManifestReq``/``SyncManifest``/``SyncChunkReq``/
``SyncChunk``/``SyncNack``) are registered with the canonical codec at
tags 0x90-0x94 and travel in :data:`hbbft_tpu_torch.net.framing.SYNC` frames.

Concurrency: the client is a plain sequential request/response loop —
no shared state, no locks, nothing held across awaits.  Abandoning a
transfer is always counted (``hbbft_sync_transfers_abandoned_total``).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.obs.metrics import Registry
from hbbft_tpu_torch.snapshot import (
    JoinSnapshot,
    decode_join_snapshot,
    encode_join_snapshot,
)

Addr = Tuple[str, int]

logger = logging.getLogger("hbbft_tpu_torch.net")

#: default transfer chunk size — small enough that a stalled donor costs
#: little progress, large enough that a realistic image is a few chunks
DEFAULT_CHUNK_BYTES = 32 * 1024


class StateSyncError(RuntimeError):
    """The transfer could not complete (no donors / no quorum / all
    donor cycles exhausted / image verification failed)."""


class _ImageRotated(Exception):
    """Every donor now NACKs the image being fetched ("unknown image"):
    the cluster rotated to a newer snapshot mid-transfer — refresh the
    manifests and restart on the new image."""


# ===========================================================================
# Wire records (registered at 0x90-0x94 in protocols.wire)
# ===========================================================================


@dataclass(frozen=True)
class SyncManifestReq:
    """Joiner → donor: describe your latest join snapshot."""


@dataclass(frozen=True)
class SyncManifest:
    """Donor → joiner: snapshot advertisement.

    ``image_sha3`` content-addresses the image: chunk requests quote it,
    and any donor advertising the same digest is interchangeable."""

    era: int
    chain_len: int
    chain_head: bytes        # 32-byte ledger digest at the era boundary
    image_sha3: bytes        # 32-byte digest of the full image
    image_len: int
    chunk_bytes: int
    n_chunks: int


@dataclass(frozen=True)
class SyncChunkReq:
    """Joiner → donor: chunk ``index`` of image ``image_sha3``."""

    image_sha3: bytes
    index: int


@dataclass(frozen=True)
class SyncChunk:
    """Donor → joiner: one CRC'd transfer chunk."""

    image_sha3: bytes
    index: int
    crc: int                 # zlib.crc32(data)
    data: bytes


@dataclass(frozen=True)
class SyncNack:
    """Donor → joiner: the request cannot be served (no snapshot yet,
    unknown image, out-of-range chunk)."""

    reason: str


def manifest_key(m: SyncManifest) -> Tuple:
    """What donors must agree on before the joiner trusts an image."""
    return (m.era, m.image_sha3, m.chain_head, m.chain_len,
            m.image_len, m.chunk_bytes, m.n_chunks)


# ===========================================================================
# Donor side
# ===========================================================================


class SnapshotStore:
    """The latest published era-boundary snapshot of ONE node, plus the
    request handler the runtime routes ``SYNC`` client frames into.

    ``publish`` runs on the pump's worker thread, ``handle`` on the
    event loop: the (manifest, image) pair is swapped as ONE reference
    so a chunk is always sliced from the image its manifest describes.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.chunk_bytes = max(1024, int(chunk_bytes))
        self._published: Optional[Tuple[SyncManifest, bytes]] = None
        r = registry if registry is not None else Registry()
        self._c_published = r.counter(
            "hbbft_sync_snapshots_published_total",
            "era-boundary join snapshots captured and made fetchable")
        self._c_manifests = r.counter(
            "hbbft_sync_manifests_served_total",
            "snapshot manifests served to joiners")
        self._c_chunks = r.counter(
            "hbbft_sync_chunks_served_total",
            "snapshot transfer chunks served to joiners")
        self._c_nacks = r.counter(
            "hbbft_sync_nacks_total",
            "sync requests refused (no snapshot, unknown image, bad "
            "index, undecodable request)")
        self._c_capture_misses = r.counter(
            "hbbft_sync_capture_misses_total",
            "era boundaries that passed before a join snapshot could "
            "be captured (joiners must wait for the next rotation)")

    @property
    def manifest(self) -> Optional[SyncManifest]:
        pub = self._published
        return pub[0] if pub is not None else None

    @property
    def image(self) -> Optional[bytes]:
        pub = self._published
        return pub[1] if pub is not None else None

    def publish(self, snap: JoinSnapshot) -> None:
        """Make ``snap`` the served snapshot (replacing any older era's;
        in-flight transfers of the old image get ``unknown image`` NACKs
        and the joiner restarts on the new manifest)."""
        image = encode_join_snapshot(snap)
        n_chunks = max(1, -(-len(image) // self.chunk_bytes))
        manifest = SyncManifest(
            era=snap.era,
            chain_len=snap.chain_len,
            chain_head=snap.chain_head,
            image_sha3=hashlib.sha3_256(image).digest(),
            image_len=len(image),
            chunk_bytes=self.chunk_bytes,
            n_chunks=n_chunks,
        )
        self._published = (manifest, image)
        self._c_published.inc()

    def handle(self, msg: Any) -> Any:
        """One request → one reply record."""
        pub = self._published
        if isinstance(msg, SyncManifestReq):
            if pub is None:
                self._c_nacks.inc()
                return SyncNack("no snapshot published yet")
            self._c_manifests.inc()
            return pub[0]
        if isinstance(msg, SyncChunkReq):
            if pub is None or msg.image_sha3 != pub[0].image_sha3:
                self._c_nacks.inc()
                return SyncNack("unknown image")
            m, image = pub
            if not 0 <= msg.index < m.n_chunks:
                self._c_nacks.inc()
                return SyncNack(f"chunk index {msg.index} out of range")
            lo = msg.index * m.chunk_bytes
            data = image[lo: lo + m.chunk_bytes]
            self._c_chunks.inc()
            return SyncChunk(m.image_sha3, msg.index, zlib.crc32(data),
                             data)
        self._c_nacks.inc()
        return SyncNack(f"unexpected sync record {type(msg).__name__}")


# ===========================================================================
# Joiner side
# ===========================================================================


class _DonorConn:
    """One client-role connection to a donor, used sequentially."""

    def __init__(self, addr: Addr, cluster_id: bytes, client_id: str,
                 max_frame: int, verify_node=None, challenge_rng=None):
        self.addr = addr
        self.cluster_id = cluster_id
        self.client_id = client_id
        self.max_frame = max_frame
        self.verify_node = verify_node
        self.challenge_rng = challenge_rng
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None

    async def connect(self, timeout_s: float) -> None:
        # with verify_node set, the handshake CHALLENGEs the donor to
        # sign with its era key — a snapshot source must prove it IS the
        # validator its address claims (framing.client_hello_handshake);
        # refusal surfaces as FrameError -> counted retry/failover
        self.reader, self.writer, _hello = \
            await framing.client_hello_handshake(
                self.addr, self.cluster_id, self.client_id,
                timeout_s=timeout_s, max_frame=self.max_frame,
                verify_node=self.verify_node,
                challenge_rng=self.challenge_rng)

    async def request(self, msg: Any, timeout_s: float) -> Any:
        """Send one sync record, await the next SYNC reply (skipping
        unrelated node→client pushes like TX_COMMIT)."""
        from hbbft_tpu_torch.protocols import wire

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        self.writer.write(framing.encode_frame(
            framing.SYNC, wire.encode_message(msg), self.max_frame))
        await self.writer.drain()
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise asyncio.TimeoutError("sync request timed out")
            kind, payload = await asyncio.wait_for(
                framing.read_one_frame(self.reader, self.max_frame),
                remaining)
            if kind == framing.SYNC:
                return wire.decode_message(payload)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.reader = self.writer = None


class StateSyncClient:
    """Fetch a verified :class:`~hbbft_tpu_torch.snapshot.JoinSnapshot` from a
    set of donor nodes, with donor failover and resumable chunking."""

    def __init__(
        self,
        donors: List[Addr],
        cluster_id: bytes,
        *,
        client_id: str = "statesync",
        request_timeout_s: float = 4.0,
        connect_timeout_s: float = 3.0,
        min_manifest_confirm: int = 1,
        max_donor_cycles: int = 3,
        max_image_refreshes: int = 2,
        backoff_base_s: float = 0.2,
        seed: int = 0,
        max_frame: int = framing.DEFAULT_MAX_FRAME,
        registry: Optional[Registry] = None,
        donor_key: Optional[Callable[[Any], Any]] = None,
    ):
        if not donors:
            raise ValueError("statesync needs at least one donor address")
        self.donors = list(donors)
        # donor authentication: node_id -> plain public key (None =
        # unknown donor).  With the callable set, every donor connection
        # is challenge–response verified before any snapshot byte is
        # trusted; without it the legacy identification-only handshake
        # applies (the snapshot is still multi-donor cross-checked).
        self.donor_key = donor_key
        self.cluster_id = bytes(cluster_id)
        self.client_id = client_id
        self.request_timeout_s = request_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.min_manifest_confirm = max(1, min_manifest_confirm)
        self.max_donor_cycles = max(1, max_donor_cycles)
        self.max_image_refreshes = max(0, max_image_refreshes)
        self.backoff_base_s = backoff_base_s
        self.rng = random.Random(seed)
        self.max_frame = max_frame
        r = registry if registry is not None else Registry()
        self._c_manifests = r.counter(
            "hbbft_sync_manifests_fetched_total",
            "donor manifests fetched during joins")
        self._c_chunks = r.counter(
            "hbbft_sync_chunks_fetched_total",
            "verified transfer chunks received")
        self._c_bytes = r.counter(
            "hbbft_sync_bytes_fetched_total",
            "verified snapshot image bytes received")
        self._c_retries = r.counter(
            "hbbft_sync_chunk_retries_total",
            "chunk requests that failed (timeout, CRC mismatch, nack, "
            "dead donor) and were retried elsewhere")
        self._c_failovers = r.counter(
            "hbbft_sync_donor_failovers_total",
            "switches to another donor mid-transfer")
        self._c_abandoned = r.counter(
            "hbbft_sync_transfers_abandoned_total",
            "transfers abandoned after exhausting every donor cycle")
        self._c_auth_fail = r.counter(
            "hbbft_sync_donor_auth_failures_total",
            "donor connections refused because the donor failed the "
            "identity challenge (unknown id or bad era-key signature)")

    def _verify_donor(self, node_id, era, sig_bytes, transcript) -> bool:
        """client_hello_handshake verify_node hook: judge a donor's
        challenge answer against the configured key map; every refusal
        is counted before it surfaces as a connect failure."""
        from hbbft_tpu_torch.crypto import tc

        ok = False
        key = self.donor_key(node_id) if self.donor_key else None
        if key is not None:
            try:
                ok = bool(key.verify(
                    tc.Signature.from_bytes(bytes(sig_bytes)),
                    transcript))
            # hblint: disable=fault-swallowed-drop (accounted just
            # below: every refusal path funnels into the shared
            # hbbft_sync_donor_auth_failures_total increment)
            except ValueError:
                ok = False
        if not ok:
            self._c_auth_fail.inc()
            logger.warning("statesync: donor claiming %r failed the "
                           "identity challenge", node_id)
        return ok

    def _donor_conn(self, addr: Addr) -> _DonorConn:
        return _DonorConn(
            addr, self.cluster_id, self.client_id, self.max_frame,
            verify_node=(self._verify_donor if self.donor_key else None),
            challenge_rng=self.rng)

    # -- manifests -----------------------------------------------------------

    async def collect_manifests(self) -> List[Tuple[Addr, SyncManifest]]:
        """Best-effort manifest from every donor, queried CONCURRENTLY
        (dead donors cost one shared timeout, not a serialized one each;
        result order follows the donor list).  Unreachable donors and
        NACKs are skipped; each skip is a counted retry."""

        async def one(addr: Addr) -> Optional[SyncManifest]:
            conn = self._donor_conn(addr)
            try:
                await conn.connect(self.connect_timeout_s)
                reply = await conn.request(SyncManifestReq(),
                                           self.request_timeout_s)
                if isinstance(reply, SyncManifest):
                    self._c_manifests.inc()
                    return reply
                self._c_retries.inc()
                logger.info("statesync: donor %r answered %s",
                            addr, type(reply).__name__)
            except (OSError, asyncio.TimeoutError, ValueError,
                    asyncio.IncompleteReadError) as exc:
                self._c_retries.inc()
                logger.info("statesync: donor %r manifest failed: %r",
                            addr, exc)
            finally:
                conn.close()
            return None

        replies = await asyncio.gather(*(one(a) for a in self.donors))
        return [(addr, m) for addr, m in zip(self.donors, replies)
                if m is not None]

    def _choose_image(
        self, manifests: List[Tuple[Addr, SyncManifest]]
    ) -> Tuple[SyncManifest, List[Addr]]:
        """The manifest enough donors agree on (largest agreeing donor
        set; highest era breaks ties)."""
        groups: Dict[Tuple, List[Addr]] = {}
        by_key: Dict[Tuple, SyncManifest] = {}
        for addr, m in manifests:
            key = manifest_key(m)
            groups.setdefault(key, []).append(addr)
            by_key[key] = m
        if not groups:
            raise StateSyncError("no donor served a snapshot manifest")
        best = max(groups.items(),
                   key=lambda kv: (len(kv[1]), kv[0][0]))
        key, addrs = best
        if len(addrs) < self.min_manifest_confirm:
            raise StateSyncError(
                f"only {len(addrs)} donor(s) agree on a snapshot "
                f"(need {self.min_manifest_confirm}); manifests: "
                f"{sorted(groups, key=repr)!r}")
        return by_key[key], addrs

    # -- the transfer --------------------------------------------------------

    async def fetch(self) -> JoinSnapshot:
        """Collect manifests, fetch + verify every chunk with failover,
        decode and cross-check the image.  A cluster that rotates to a
        NEWER snapshot mid-transfer (every donor starts NACKing the old
        image) triggers a manifest refresh and a restart on the new
        image, up to ``max_image_refreshes`` times.  Raises
        :class:`StateSyncError` after exhausting every donor cycle."""
        for _refresh in range(self.max_image_refreshes + 1):
            manifests = await self.collect_manifests()
            try:
                manifest, addrs = self._choose_image(manifests)
            except StateSyncError:
                # giving up before the first chunk is still an abandoned
                # transfer — the joiner must never fail silently
                self._c_abandoned.inc()
                raise
            try:
                return await self._transfer(manifest, addrs)
            except _ImageRotated:
                self._c_retries.inc()
                logger.info("statesync: donors rotated to a newer "
                            "snapshot mid-transfer; refreshing "
                            "manifests and restarting")
            except StateSyncError:
                # the single abandon accounting point for a transfer
                # that ran out of road (donor cycles, bad image)
                self._c_abandoned.inc()
                raise
        self._c_abandoned.inc()
        raise StateSyncError(
            f"snapshot rotated out from under the transfer "
            f"{self.max_image_refreshes + 1} times; abandoned")

    async def _transfer(self, manifest: SyncManifest,
                        addrs: List[Addr]) -> JoinSnapshot:
        chunks: List[bytes] = []
        conn: Optional[_DonorConn] = None
        donor_i = 0
        failures_this_cycle = 0
        cycles = 0
        # donors that answered "unknown image": once every donor has (or
        # the cycles run dry with any such evidence), the cluster rotated
        # to a newer snapshot — restart on fresh manifests, don't abandon
        unknown_image: set = set()
        while len(chunks) < manifest.n_chunks:
            if conn is None:
                addr = addrs[donor_i % len(addrs)]
                conn = self._donor_conn(addr)
                try:
                    await conn.connect(self.connect_timeout_s)
                except (OSError, asyncio.TimeoutError,
                        ValueError) as exc:
                    logger.info("statesync: donor %r connect failed: %r",
                                conn.addr, exc)
                    conn = None
                    donor_i, failures_this_cycle, cycles = (
                        await self._failover(addrs, donor_i,
                                             failures_this_cycle, cycles))
                    continue
            index = len(chunks)
            try:
                reply = await conn.request(
                    SyncChunkReq(manifest.image_sha3, index),
                    self.request_timeout_s)
                if (isinstance(reply, SyncNack)
                        and reply.reason.startswith("unknown image")):
                    unknown_image.add(conn.addr)
                    raise StateSyncError(
                        "donor no longer serves this image")
                if not isinstance(reply, SyncChunk):
                    raise StateSyncError(
                        f"donor answered {type(reply).__name__}")
                if (reply.image_sha3 != manifest.image_sha3
                        or reply.index != index
                        or zlib.crc32(reply.data) != reply.crc
                        or not reply.data):
                    raise StateSyncError("corrupt chunk")
            except (OSError, asyncio.TimeoutError, ValueError,
                    asyncio.IncompleteReadError, StateSyncError) as exc:
                self._c_retries.inc()
                logger.info("statesync: chunk %d from %r failed: %r",
                            index, conn.addr, exc)
                conn.close()
                conn = None
                if len(unknown_image) >= len(addrs):
                    raise _ImageRotated()
                try:
                    donor_i, failures_this_cycle, cycles = (
                        await self._failover(addrs, donor_i,
                                             failures_this_cycle,
                                             cycles))
                except StateSyncError:
                    if unknown_image:
                        # dead donors + rotated donors: the image is
                        # gone either way — refresh, don't abandon yet
                        raise _ImageRotated() from None
                    raise
                continue
            failures_this_cycle = 0
            self._c_chunks.inc()
            self._c_bytes.inc(len(reply.data))
            chunks.append(reply.data)
        if conn is not None:
            conn.close()
        image = b"".join(chunks)
        if (len(image) != manifest.image_len
                or hashlib.sha3_256(image).digest()
                != manifest.image_sha3):
            raise StateSyncError(
                "assembled image fails digest verification")
        snap = decode_join_snapshot(image)
        if (snap.chain_head != manifest.chain_head
                or snap.chain_len != manifest.chain_len
                or snap.era != manifest.era):
            raise StateSyncError(
                "decoded snapshot disagrees with the confirmed manifest")
        return snap

    async def _failover(self, addrs: List[Addr], donor_i: int,
                        failures_this_cycle: int, cycles: int
                        ) -> Tuple[int, int, int]:
        """Advance to the next donor; after a full cycle of failures,
        back off (seeded exponential + jitter) and start another cycle —
        up to ``max_donor_cycles``, then raise (``fetch`` counts the
        abandon)."""
        self._c_failovers.inc()
        donor_i += 1
        failures_this_cycle += 1
        if failures_this_cycle >= len(addrs):
            cycles += 1
            if cycles >= self.max_donor_cycles:
                raise StateSyncError(
                    f"every donor failed {cycles} full cycle(s); "
                    f"transfer abandoned")
            delay = (self.backoff_base_s * (2 ** (cycles - 1))
                     * (0.5 + 0.5 * self.rng.random()))
            await asyncio.sleep(delay)
            failures_this_cycle = 0
        return donor_i, failures_this_cycle, cycles


async def fetch_join_snapshot(donors: List[Addr], cluster_id: bytes,
                              **kwargs) -> JoinSnapshot:
    """One-call joiner bootstrap (see :class:`StateSyncClient`)."""
    return await StateSyncClient(donors, cluster_id, **kwargs).fetch()
