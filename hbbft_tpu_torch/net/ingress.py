"""Per-peer ingress worker threads: framing + decode off the event loop.

The transport's steady-state receive path (:class:`_NodeRecvProtocol` in
:mod:`hbbft_tpu_torch.net.transport`) normally decodes frames inline on the
event loop.  With ``ingress_workers`` enabled, each authenticated node
connection instead hands its raw socket chunks to a dedicated
:class:`PeerIngressWorker` thread which runs the CPU-bearing slice —
frame parsing (:class:`~hbbft_tpu_torch.net.framing.FrameDecoder`), MSG_BATCH
splitting, and the ``wire.decode_message`` memo — and delivers whole
decoded batches back to the loop as ``(payload, msg_or_None)`` pairs via
``call_soon_threadsafe``.

Serialization contract: ONE worker thread per peer, feeding the loop
through ``call_soon_threadsafe`` (FIFO from a single thread), so a
peer's batches arrive at the pump strictly in socket order — ledgers
stay byte-identical with the inline path.  IngressBudget semantics are
intact: byte-rate charging and flow control stay on the event loop (the
protocol still charges per chunk and pauses reading); the worker calls
the lock-protected ``frame_admitted`` itself before delivery, and
decode failures are delivered as ``(payload, None)`` so the runtime
re-decodes and attributes the strike to THIS peer, exactly as inline.

Bounded queue: the hand-off deque is bounded in BYTES — once the
backlog passes :data:`WORKER_BACKLOG_BYTES`, the protocol pauses the
socket (real TCP backpressure) until the worker drains, so a slow
worker can never buffer unboundedly.

Faults: a framing error, an unknown frame kind, or a bad heartbeat
session id discovered on the worker thread is marshalled back to the
loop and fails the connection through the protocol's ``_fail`` — the
same counted drop path the inline decoder takes.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.net.framing import FrameDecoder, FrameError
from hbbft_tpu_torch.protocols import wire

NodeId = Hashable

#: pause the socket once the worker's undecoded backlog passes this many
#: bytes (resume is polled by the protocol's throttle timer)
WORKER_BACKLOG_BYTES = 1 << 20

#: decode-memo bound, mirroring NodeRuntime._decode_cache: identical
#: payloads (echoed broadcasts) decode once; cleared wholesale at cap
DECODE_MEMO_CAP = 4096


class PeerIngressWorker:
    """One ingress worker thread for one authenticated peer connection.

    Lifecycle: constructed by the transport when the connection upgrades
    to the protocol path, ``bind()``-ed to the protocol (for the failure
    back-channel), started lazily on the first ``feed``, and ``stop``-ed
    from ``connection_lost``.  The thread drains any queued chunks after
    stop is signalled, then exits (daemon — a hung delivery cannot block
    interpreter shutdown).
    """

    def __init__(self, t: Any, peer_id: NodeId, writer: Any,
                 session: Optional[bytes]):
        self.t = t
        self.peer_id = peer_id
        self.writer = writer
        self.session = session
        self.loop = None  # set by bind() (the protocol's loop)
        self.proto = None
        self.decoder = FrameDecoder(t.max_frame)
        self._memo: Dict[bytes, Any] = {}
        self._chunks: Deque[bytes] = deque()
        self._lock = threading.Lock()
        self._queued_bytes = 0
        self._wake = threading.Event()
        self._stopped = False
        self._failed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hbbft-ingress-{peer_id!r}")
        self._started = False

    # -- event-loop surface --------------------------------------------------

    def bind(self, proto: Any) -> None:
        self.proto = proto
        self.loop = proto.loop

    def feed(self, data: bytes) -> None:
        """Queue one raw socket chunk (event-loop side; the caller
        checks :meth:`backlog_over` and pauses the socket — that check
        is what bounds this queue)."""
        with self._lock:
            self._chunks.append(data)
            self._queued_bytes += len(data)
        if not self._started:
            self._started = True
            self._thread.start()
        self._wake.set()

    def backlog_over(self) -> bool:
        with self._lock:
            return self._queued_bytes > WORKER_BACKLOG_BYTES

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()

    # -- worker thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._chunks:
                        break
                    data = self._chunks.popleft()
                    self._queued_bytes -= len(data)
                if self._failed:
                    continue  # drain and discard after a failure
                try:
                    self._process(data)
                # nothing swallowed: the failure is marshalled to the
                # loop, where proto._fail kills the connection through
                # the same counted drop path the inline decoder takes
                # (chunks queued behind the poison frame die with the
                # socket exactly as on the inline path)
                # hblint: disable=fault-swallowed-drop
                except (FrameError, ValueError) as exc:
                    self._failed = True
                    self.loop.call_soon_threadsafe(self.proto._fail, exc)
            if self._stopped:
                return

    def _decode(self, payload: bytes) -> Tuple[bytes, Any]:
        memo = self._memo
        msg = memo.get(payload)
        if msg is None:
            try:
                msg = wire.decode_message(payload)
            # nothing dropped here: the raw payload is handed through as
            # (payload, None) and the runtime re-decodes, fails
            # identically, and charges the strike to this peer —
            # attribution preserved
            # hblint: disable=fault-swallowed-drop
            except ValueError:
                return (payload, None)
            if len(memo) >= DECODE_MEMO_CAP:
                memo.clear()
            memo[payload] = msg
        return (payload, msg)

    def _process(self, data: bytes) -> None:
        t = self.t
        batch: List[Tuple[bytes, Any]] = []
        nbytes = 0
        frames = self.decoder.feed(data)
        for kind, payload in frames:
            nbytes += len(payload) + 5
            if kind == framing.MSG:
                batch.append(self._decode(payload))
            elif kind == framing.MSG_BATCH:
                for sub in framing.split_msgs(payload):
                    batch.append(self._decode(sub))
            elif kind == framing.PING:
                if self.session is not None and (
                        len(payload) != framing.SESSION_LEN + 8
                        or payload[:framing.SESSION_LEN] != self.session):
                    raise FrameError(
                        f"heartbeat with wrong session id on "
                        f"authenticated stream from {self.peer_id!r}"
                    )
                self.loop.call_soon_threadsafe(self._pong, payload)
            else:
                raise FrameError(
                    f"unexpected frame kind {kind} from node "
                    f"{self.peer_id!r}"
                )
        if batch:
            # admitted BEFORE delivery so the in-flight window the
            # event loop polls already covers these frames
            t.ingress.frame_admitted(self.peer_id, len(batch))
        if frames:
            self.loop.call_soon_threadsafe(
                self._deliver, batch, len(frames), nbytes)

    # -- loop-side delivery callbacks ----------------------------------------

    def _pong(self, payload: bytes) -> None:
        if self.writer.is_closing():
            return
        pong = framing.encode_frame(framing.PONG, payload,
                                    self.t.max_frame)
        self.writer.write(pong)
        self.t._record_send(self.peer_id, pong)

    def _deliver(self, batch: List[Tuple[bytes, Any]], nframes: int,
                 nbytes: int) -> None:
        """Runs on the event loop, in feed order (single scheduling
        thread): stats stay single-threaded and batches reach the pump
        strictly serialized per peer."""
        t = self.t
        if t.trace is not None or t.cost_model is not None:
            # per-frame granularity is lost off-loop; charge the chunk
            # as one aggregate recv event for the cost model
            t.stats.frame_recv_batch(nframes, nbytes)
            if t.cost_model is not None:
                t.stats.virtual_cost_s += t.cost_model.charge(nbytes)
        else:
            t.stats.frame_recv_batch(nframes, nbytes)
        if batch and t.on_peer_batch is not None:
            t.on_peer_batch(self.peer_id, batch)
