"""Client gateway tier: terminate client connections off the consensus path.

Thetacrypt-style service split (arxiv 2502.03247): the per-client
connection work — socket churn, dedup, admission fairness, ack/commit
fan-out — is lifted OUT of the consensus node's event loop into a
dedicated gateway process, so the node spends its single precious core
on consensus and talks to a handful of gateways instead of thousands of
clients.

Wire protocol: the gateway speaks the node's exact client protocol on
BOTH sides —

- **south (clients)**: it serves ``HELLO``/``TX``/``TX_ACK``/
  ``TX_COMMIT``/``STATUS_REQ``/``PING`` exactly like a node, so an
  unmodified :class:`~hbbft_tpu_torch.net.client.ClusterClient` connects to a
  gateway address with no code change;
- **north (nodes)**: it multiplexes accepted transactions into node
  mempools over a few long-lived **authenticated node links** — plain
  client-role connections upgraded with the statesync donor challenge
  (:func:`~hbbft_tpu_torch.net.framing.client_hello_handshake` with
  ``verify_node``), so a gateway never trusts an impersonated node with
  client traffic.

Dedup + aggregation + fairness: submissions land in a standard
:class:`~hbbft_tpu_torch.net.client.Mempool` — the SAME admission engine the
node runs, so the dedup window, the FULL backpressure, the fair
per-client shares under pressure, and the single-victim shed policy
(pushed to clients as ``ACK_SHED``, matching the node's semantics
exactly) need no reimplementation.  Accepted txs are forwarded
at-least-once: each link tracks its in-flight window; a link that dies
re-queues its window and fails over to the next node (round-robin
redial), and node-side ``DUPLICATE`` acks make redelivery harmless.
``FULL`` from a node parks the tx in the gateway pool for the next
flush — the gateway is the elastic buffer between client bursts and
node admission.

Commit relay: each node pushes every committed digest to its clients;
the gateway dedups the per-epoch pushes across its links (they connect
to different nodes) and relays ONE encoded ``TX_COMMIT`` frame to all
clients, write-buffer bounded per client (slow consumers are dropped,
not buffered unboundedly — same :class:`ClientConn` policy as the
node).

Trust model: clients are identification-only, exactly as at the node —
the gateway adds no client authentication, it just moves the same
boundary out one tier.  Node links are authenticated northbound (the
gateway verifies the NODE); the node sees the gateway as an ordinary
client.  A malicious gateway can therefore drop or delay its clients'
traffic — clients that need the stronger guarantee connect to a node
directly; Byzantine safety of the ledger itself is untouched either
way.

Metrics: the ``hbbft_gw_*`` family (see README) plus the standard
mempool families from the embedded pool.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import struct
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.net.client import Mempool, tx_digest
from hbbft_tpu_torch.net.framing import (
    DEFAULT_MAX_FRAME,
    FrameDecoder,
    FrameError,
    Hello,
    ROLE_CLIENT,
    ROLE_NODE,
    client_hello_handshake,
)
from hbbft_tpu_torch.net.transport import ClientConn, set_nodelay

NodeId = Hashable
Addr = Tuple[str, int]

logger = logging.getLogger("hbbft_tpu_torch.net")

#: per-link in-flight window: TX frames written but not yet acked by the
#: node; the flush loop stops feeding a link at this depth (the node's
#: own mempool FULL responses are the deeper backpressure)
LINK_INFLIGHT_MAX = 1024

#: (era, epoch) commit pushes already relayed — bounded dedup across the
#: redundant node links
COMMIT_SEEN_CAP = 4096

HANDSHAKE_TIMEOUT_S = 10.0


def node_verifier(key_fn) -> Callable[..., bool]:
    """Wrap a ``node_id -> public key | None`` resolver (e.g.
    :func:`~hbbft_tpu_torch.net.cluster.donor_key_fn`) into the
    ``client_hello_handshake`` ``verify_node`` signature used for
    authenticating gateway node links."""
    from hbbft_tpu_torch.crypto import tc

    def verify(node_id, era, sig_bytes, transcript) -> bool:
        key = key_fn(node_id)
        if key is None:
            return False
        try:
            return bool(key.verify(
                tc.Signature.from_bytes(bytes(sig_bytes)), transcript))
        # hblint: disable=fault-swallowed-drop (a malformed signature IS
        # the refusal: verify() returning False surfaces as a counted
        # link failover at the call site)
        except ValueError:
            return False

    return verify


class _NodeLink:
    """One authenticated north-side connection to a consensus node."""

    def __init__(self, gw: "Gateway", link_id: int):
        self.gw = gw
        self.link_id = link_id
        self.addr: Optional[Addr] = None
        self.node_id: Optional[NodeId] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.connected = asyncio.Event()
        # digest -> tx written on THIS link, awaiting the node's ack;
        # bounded by LINK_INFLIGHT_MAX (the flush loop checks), re-queued
        # wholesale if the link dies (at-least-once; DUPLICATE is a no-op)
        self.inflight: Dict[bytes, bytes] = {}
        self.task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self.task = asyncio.get_running_loop().create_task(self._serve())

    async def stop(self) -> None:
        if self.task is not None:
            self.task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self.task
        if self.writer is not None:
            self.writer.close()

    async def _serve(self) -> None:
        gw = self.gw
        attempt = self.link_id  # stagger links across the node set
        while not gw._stopping:
            addr = gw.node_addrs[attempt % len(gw.node_addrs)]
            attempt += 1
            try:
                reader, writer, node_hello = await client_hello_handshake(
                    addr, gw.cluster_id,
                    f"{gw.gateway_id}-link{self.link_id}",
                    timeout_s=gw.connect_timeout_s,
                    max_frame=gw.max_frame,
                    verify_node=gw.verify_node,
                )
            except (OSError, FrameError, asyncio.TimeoutError) as exc:
                gw._c_link_failovers.inc()
                logger.info("gateway %s link %d: dial %r failed (%s), "
                            "rotating", gw.gateway_id, self.link_id,
                            addr, exc)
                await asyncio.sleep(gw.redial_backoff_s)
                continue
            set_nodelay(writer)
            self.addr = addr
            self.node_id = node_hello.node_id
            self.writer = writer
            self.connected.set()
            gw._g_links.set(gw._live_links())
            logger.info("gateway %s link %d: connected to node %r at %r",
                        gw.gateway_id, self.link_id,
                        node_hello.node_id, addr)
            try:
                await self._recv(reader)
            except (ConnectionError, OSError, FrameError,
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError) as exc:
                gw._c_link_failovers.inc()
                logger.warning("gateway %s link %d to node %r died: %s",
                               gw.gateway_id, self.link_id,
                               self.node_id, exc)
            finally:
                self.connected.clear()
                self.writer = None
                writer.close()
                gw._g_links.set(gw._live_links())
                # at-least-once: everything this link had in flight goes
                # back to the forward queue for the successor link/node
                requeue, self.inflight = self.inflight, {}
                for digest, tx in requeue.items():
                    gw._forward_q.append((digest, tx))
                gw._flush_wake.set()
            await asyncio.sleep(gw.redial_backoff_s)

    async def _recv(self, reader: asyncio.StreamReader) -> None:
        gw = self.gw
        decoder = FrameDecoder(gw.max_frame)
        ping_nonce = 0
        last_ping = time.monotonic()
        while True:
            try:
                data = await asyncio.wait_for(reader.read(65536),
                                              gw.keepalive_s)
            except asyncio.TimeoutError:
                # idle: keep the node's client-idle watchdog fed
                ping_nonce += 1
                self.writer.write(framing.encode_frame(
                    framing.PING, struct.pack(">Q", ping_nonce),
                    gw.max_frame))
                continue
            if not data:
                raise ConnectionError("node closed the link")
            now = time.monotonic()
            if now - last_ping > gw.keepalive_s:
                last_ping = now
                ping_nonce += 1
                self.writer.write(framing.encode_frame(
                    framing.PING, struct.pack(">Q", ping_nonce),
                    gw.max_frame))
            for kind, payload in decoder.feed(data):
                if kind == framing.TX_ACK:
                    gw._on_node_ack(self, payload)
                elif kind == framing.TX_COMMIT:
                    gw._on_node_commit(payload)
                elif kind in (framing.PONG, framing.STATUS):
                    pass  # keepalive echo / unsolicited status
                else:
                    raise FrameError(
                        f"unexpected frame kind {kind} from node "
                        f"{self.node_id!r}"
                    )


class Gateway:
    """Client-terminating gateway in front of a consensus cluster.

    ``node_addrs`` is the dial list; ``node_links`` connections are held
    live at once, each to a different node (round-robin with failover).
    ``verify_node`` is the northbound authentication callable
    ``(node_id, era, sig, transcript) -> bool`` — None only on trusted
    fabrics (mirrors the transport's legacy mode).
    """

    def __init__(self, node_addrs: List[Addr], cluster_id: bytes, *,
                 gateway_id: str = "gw0",
                 node_links: int = 2,
                 verify_node: Optional[Callable[..., bool]] = None,
                 mempool: Optional[Mempool] = None,
                 registry=None,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 connect_timeout_s: float = 5.0,
                 redial_backoff_s: float = 0.2,
                 keepalive_s: float = 5.0,
                 client_idle_timeout_s: float = 60.0):
        from hbbft_tpu_torch.obs.metrics import Registry

        if not node_addrs:
            raise ValueError("gateway needs at least one node address")
        self.node_addrs = list(node_addrs)
        self.cluster_id = bytes(cluster_id)
        self.gateway_id = gateway_id
        self.verify_node = verify_node
        self.max_frame = max_frame
        self.connect_timeout_s = connect_timeout_s
        self.redial_backoff_s = redial_backoff_s
        self.keepalive_s = keepalive_s
        self.client_idle_timeout_s = client_idle_timeout_s
        self.registry = registry or Registry()
        # the node's admission engine, reused verbatim: dedup window,
        # FULL backpressure, fair per-client shares, single-victim shed
        # (identity check, not truthiness: an EMPTY caller-supplied pool
        # is len()==0 and must not be silently replaced)
        self.mempool = mempool if mempool is not None else Mempool()
        self.mempool.bind_registry(self.registry)
        self.mempool.on_shed = self._on_pool_shed
        self._clients: "set[ClientConn]" = set()
        self._client_tasks: "set[asyncio.Task]" = set()
        self._links = [_NodeLink(self, i)
                       for i in range(max(1, node_links))]
        self._next_link = 0
        self._forward_q: Deque[Tuple[bytes, bytes]] = deque()
        self._flush_wake = asyncio.Event()
        self._flush_task: Optional[asyncio.Task] = None
        self._commit_seen: "OrderedDict[Tuple[int, int], None]" = (
            OrderedDict())
        self._server: Optional[asyncio.base_events.Server] = None
        self._obs_server: Optional[Any] = None
        self.obs_addr: Optional[Addr] = None
        self._stopping = False
        self.addr: Optional[Addr] = None
        r = self.registry
        self._c_submissions = r.counter(
            "hbbft_gw_submissions_total",
            "client tx submissions at the gateway by admission outcome",
            labelnames=("status",), max_label_sets=5)
        self._c_forwarded = r.counter(
            "hbbft_gw_forwarded_total",
            "tx frames forwarded over node links (re-sends after "
            "failover/FULL included)")
        self._c_node_acks = r.counter(
            "hbbft_gw_node_acks_total",
            "node responses to forwarded txs by status",
            labelnames=("status",), max_label_sets=6)
        self._c_sheds = r.counter(
            "hbbft_gw_sheds_total",
            "ACK_SHED pushes to clients (gateway-pool fair-share sheds "
            "+ relayed node sheds)")
        self._c_commits = r.counter(
            "hbbft_gw_commits_relayed_total",
            "committed tx digests relayed to clients")
        self._c_link_failovers = r.counter(
            "hbbft_gw_link_failovers_total",
            "node-link dial failures and mid-session deaths (each "
            "rotates to the next node)")
        self._c_client_drops = r.counter(
            "hbbft_gw_client_drops_total",
            "client connections dropped mid-session (disconnect, idle "
            "timeout, torn/garbage frames)")
        self._g_clients = r.gauge(
            "hbbft_gw_clients", "connected client sockets")
        self._g_links = r.gauge(
            "hbbft_gw_node_links", "live authenticated node links")
        self._g_forward_q = r.gauge(
            "hbbft_gw_forward_queue", "txs waiting for a node link slot")
        r.register_callback(lambda: (
            self._g_clients.set(len(self._clients)),
            self._g_forward_q.set(len(self._forward_q)),
        ))

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> Addr:
        self._server = await asyncio.start_server(
            self._serve_client, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        for link in self._links:
            link.start()
        self._flush_task = asyncio.get_running_loop().create_task(
            self._flush_loop())
        return self.addr

    async def start_obs(self, host: str = "127.0.0.1",
                        port: int = 0) -> Addr:
        """Serve ``/metrics`` + ``/status`` for this gateway (obs.http),
        so ``obs.top --gateways`` and scrapers see the tier like any
        node."""
        from hbbft_tpu_torch.obs.http import ObsServer

        self._obs_server = ObsServer(self.registry,
                                     status_fn=self.status_doc)
        self.obs_addr = await self._obs_server.start(host, port)
        return self.obs_addr

    async def stop(self) -> None:
        self._stopping = True
        if self._obs_server is not None:
            await self._obs_server.stop()
            self._obs_server = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._flush_task is not None:
            self._flush_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._flush_task
        for link in self._links:
            await link.stop()
        for task in list(self._client_tasks):
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    def _live_links(self) -> int:
        return sum(1 for li in self._links if li.connected.is_set())

    async def wait_links(self, n: int = 1,
                         timeout_s: float = 30.0) -> None:
        """Until ≥ ``n`` node links are live (test/CLI startup gate)."""

        async def _wait():
            while self._live_links() < n:
                await asyncio.sleep(0.02)

        await asyncio.wait_for(_wait(), timeout_s)

    # -- south side: client serving ------------------------------------------

    async def _serve_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._client_tasks.add(task)
        conn: Optional[ClientConn] = None
        try:
            kind, payload = await asyncio.wait_for(
                framing.read_one_frame(reader,
                                       framing.MAX_HANDSHAKE_FRAME),
                HANDSHAKE_TIMEOUT_S)
            if kind != framing.HELLO:
                raise FrameError("client did not open with HELLO")
            hello = framing.decode_hello(payload)
            if hello.role != ROLE_CLIENT:
                raise FrameError("gateway accepts client-role "
                                 "connections only")
            if hello.cluster_id != self.cluster_id:
                raise FrameError("cluster id mismatch")
            set_nodelay(writer)
            reply = Hello(node_id=self.gateway_id, role=ROLE_NODE,
                          cluster_id=self.cluster_id, era=0, epoch=0)
            writer.write(framing.encode_frame(
                framing.HELLO, framing.encode_hello(reply),
                self.max_frame))
            conn = ClientConn(hello, writer, self.max_frame)
            self._clients.add(conn)
            decoder = FrameDecoder(self.max_frame)
            while True:
                data = await asyncio.wait_for(
                    reader.read(65536), self.client_idle_timeout_s)
                if not data:
                    return
                frames = decoder.feed(data)
                if len(frames) > 1:
                    # one ack syscall per chunk (same coalescing as the
                    # node's client loop)
                    conn.begin_batch()
                for kind, payload in frames:
                    self._on_client_frame(conn, kind, payload)
                conn.flush_batch()
        except (OSError, FrameError, ValueError, ConnectionError,
                asyncio.TimeoutError, asyncio.IncompleteReadError):
            # client-side disconnects/garbage are routine churn — counted,
            # never fatal to the tier (the client's pending txs stay in
            # the pool and its commits resume on reconnect)
            self._c_client_drops.inc()
            return
        finally:
            self._client_tasks.discard(task)
            if conn is not None:
                self._clients.discard(conn)
            writer.close()

    def _on_client_frame(self, conn: ClientConn, kind: int,
                         payload: bytes) -> None:
        if kind == framing.TX:
            status = self.mempool.add(payload,
                                      client_id=str(conn.client_id))
            self._c_submissions.labels(
                status=Mempool._ACK_NAMES[status]).inc()
            conn.send(framing.TX_ACK,
                      bytes([status]) + tx_digest(payload))
            if status == Mempool.ACCEPTED:
                self._forward_q.append((tx_digest(payload), payload))
                self._flush_wake.set()
        elif kind == framing.PING:
            conn.send(framing.PONG, payload)
        elif kind == framing.STATUS_REQ:
            conn.send(framing.STATUS,
                      json.dumps(self.status_doc()).encode())
        else:
            logger.warning("gateway %s: unknown client frame kind %d",
                           self.gateway_id, kind)

    def _broadcast(self, kind: int, payload: bytes) -> None:
        """One encode, every client; dead/overflowing conns drop."""
        if not self._clients:
            return
        for conn in list(self._clients):
            conn.send(kind, payload)
            if conn.closed:
                self._clients.discard(conn)

    def _on_pool_shed(self, tx: bytes) -> None:
        """Gateway-pool fair-share shed: same client-visible semantics
        as the node's — an ACK_SHED push so pending commit waits fail
        fast (re-submission is the client's policy)."""
        self._c_sheds.inc()
        self._broadcast(framing.TX_ACK,
                        bytes([framing.ACK_SHED]) + tx_digest(tx))

    # -- north side: forwarding + relaying -----------------------------------

    async def _flush_loop(self) -> None:
        """Drain the forward queue into link in-flight windows.  One
        writer.write per flush round per link (TX frames coalesced into
        a single buffer — the aggregation step), round-robin across
        live links."""
        while True:
            await self._flush_wake.wait()
            self._flush_wake.clear()
            while self._forward_q:
                link = self._pick_link()
                if link is None:
                    # no live link with window room: wait for a
                    # (re)connect or an ack to open one up
                    await asyncio.sleep(0.05)
                    continue
                room = LINK_INFLIGHT_MAX - len(link.inflight)
                chunk: List[bytes] = []
                while self._forward_q and room > 0:
                    digest, tx = self._forward_q.popleft()
                    if (digest in link.inflight
                            or not self.mempool.has_pending(digest)):
                        continue  # committed/shed meanwhile, or dup
                    link.inflight[digest] = tx
                    chunk.append(framing.encode_frame(
                        framing.TX, tx, self.max_frame))
                    room -= 1
                if chunk:
                    link.writer.write(b"".join(chunk))
                    self._c_forwarded.inc(len(chunk))
                await asyncio.sleep(0)  # yield between rounds

    def _pick_link(self) -> Optional[_NodeLink]:
        n = len(self._links)
        for i in range(n):
            link = self._links[(self._next_link + i) % n]
            if (link.connected.is_set() and link.writer is not None
                    and len(link.inflight) < LINK_INFLIGHT_MAX):
                self._next_link = (self._next_link + i + 1) % n
                return link
        return None

    def _on_node_ack(self, link: _NodeLink, payload: bytes) -> None:
        status, digest = payload[0], payload[1:33]
        name = Mempool._ACK_NAMES.get(status, "shed")
        self._c_node_acks.labels(status=name).inc()
        tx = link.inflight.pop(digest, None)
        if status in (framing.ACK_ACCEPTED, framing.ACK_DUPLICATE):
            # the node owns it now; commit relay closes the loop.
            # Recorded in the dedup window so gateway-level re-submits
            # keep answering DUPLICATE
            self.mempool.mark_committed_digests([digest])
        elif status == framing.ACK_FULL:
            # node backpressure: park it for a later flush (possibly on
            # another link) — the gateway is the elastic buffer
            if tx is not None and self.mempool.has_pending(digest):
                self._forward_q.append((digest, tx))
                self._flush_wake.set()
        elif status == framing.ACK_REJECTED:
            self.mempool.mark_committed_digests([digest])
            self._broadcast(framing.TX_ACK, payload)
        elif status == framing.ACK_SHED:
            # push notification: a tx the node accepted earlier was shed
            # there — relay so client commit waits fail fast
            self._c_sheds.inc()
            self._broadcast(framing.TX_ACK, payload)

    def _on_node_commit(self, payload: bytes) -> None:
        era, epoch, count = struct.unpack_from(">QQI", payload, 0)
        if (era, epoch) in self._commit_seen:
            return  # the other links' nodes push the same epoch
        self._commit_seen[(era, epoch)] = None
        while len(self._commit_seen) > COMMIT_SEEN_CAP:
            self._commit_seen.popitem(last=False)
        digests = [payload[20 + 32 * i: 52 + 32 * i]
                   for i in range(count)]
        self.mempool.mark_committed_digests(digests)
        self._c_commits.inc(count)
        self._broadcast(framing.TX_COMMIT, payload)

    # -- introspection -------------------------------------------------------

    def status_doc(self) -> dict:
        return {
            "gateway": self.gateway_id,
            "clients": len(self._clients),
            "pending": len(self.mempool),
            "forward_queue": len(self._forward_q),
            "links": [
                {
                    "link": li.link_id,
                    "node": repr(li.node_id),
                    "connected": li.connected.is_set(),
                    "inflight": len(li.inflight),
                }
                for li in self._links
            ],
            "submissions": {
                name: int(self._c_submissions.value(status=name))
                for name in Mempool._ACK_NAMES.values()
            },
            "forwarded": int(self._c_forwarded.total()),
            "commits_relayed": int(self._c_commits.total()),
            "sheds": int(self._c_sheds.total()),
            "link_failovers": int(self._c_link_failovers.total()),
        }


def main(argv=None) -> None:
    """Standalone gateway process: ``python -m hbbft_tpu_torch.net.gateway
    --nodes N --seed S --base-port P [--port GW_PORT]`` — derives the
    cluster id and node addresses the same way the cluster CLI does and
    authenticates node links with the config-derived keys."""
    import argparse

    from hbbft_tpu_torch.net.cluster import (
        ClusterConfig,
        donor_key_fn,
    )

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-port", type=int, required=True)
    ap.add_argument("--encrypt", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="gateway listen port (0 = ephemeral)")
    ap.add_argument("--gateway-id", default="gw0")
    ap.add_argument("--node-links", type=int, default=2)
    ap.add_argument("--no-auth", action="store_true",
                    help="skip node-link authentication (trusted "
                         "fabrics only)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics + /status on this port "
                         "(0 = off); obs.top --gateways polls it")
    args = ap.parse_args(argv)
    cfg = ClusterConfig(n=args.nodes, seed=args.seed, host=args.host,
                        base_port=args.base_port, encrypt=args.encrypt)
    verify = (None if args.no_auth
              else node_verifier(donor_key_fn(cfg)))

    async def serve():
        gw = Gateway(
            [(cfg.host, cfg.base_port + i) for i in range(cfg.n)],
            cfg.cluster_id, gateway_id=args.gateway_id,
            node_links=args.node_links,
            verify_node=verify,
        )
        addr = await gw.start(args.host, args.port)
        doc = {"gateway": args.gateway_id, "addr": list(addr)}
        if args.metrics_port:
            obs = await gw.start_obs(args.host, args.metrics_port)
            doc["obs"] = list(obs)
        print(json.dumps(doc), flush=True)
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await gw.stop()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
