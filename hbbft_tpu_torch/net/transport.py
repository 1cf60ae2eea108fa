"""Asyncio TCP transport: peer connections, backoff, heartbeats.

Connection topology: every node keeps ONE outbound connection per peer used
exclusively for sending (consensus ``MSG`` frames + ``PING`` heartbeats;
the acceptor answers ``PONG`` on the same socket), and accepts inbound
connections for receiving.  Send/receive asymmetry means there is no
connection-dedup race: a (dialer, acceptor) pair owns each socket.

Reliability model:

- per-peer outbound queues are *persistent across reconnects*: frames
  enqueued while a peer is down are delivered, in order, once it is back
  (at-least-once — a frame written into a socket that dies mid-flight is
  re-sent, and the consensus protocols treat duplicates as no-ops/logged
  faults);
- reconnects use seeded exponential backoff with jitter: with a fixed
  ``seed`` the drawn delay sequence is identical run to run (the
  same-seed-same-trace property the simulator guarantees extends to the
  transport's schedule), and every drawn delay is recorded in
  ``stats.backoff_delays`` so tests can assert it;
- a dialer that misses heartbeat ``PONG``\\ s for ``dead_after_s`` declares
  the peer dead, tears the socket down, and re-enters backoff.

Inbound connections announce themselves with the versioned hello
(:mod:`hbbft_tpu_torch.net.framing`); node-role hellos from ids outside the
configured peer set, cluster-id mismatches, and version mismatches are
rejected before any payload frame is parsed.  Client-role connections are
handed to the runtime via ``on_client_frame``.

SECURITY MODEL — node-role hellos are AUTHENTICATED (protocol v3): a
node hello is identification only until the acceptor's challenge is
answered.  The acceptor issues a random nonce + session id; the dialer
must sign the transcript (cluster id, nonce, session, claimed id, role,
era — :func:`hbbft_tpu_torch.net.framing.auth_transcript`) with the node's
per-era secret key, and the acceptor verifies against the era key map
(:class:`EraKeyRing`; the same ``NetworkInfo`` map the dynamic-peer
resolver consults for WHERE, used here for WHO).  Until that signature
verifies, the connection allocates NO per-peer guard state, every
handshake frame is capped at ``framing.MAX_HANDSHAKE_FRAME`` bytes and
timed out (the half-open handshake has its own byte/time budget plus a
concurrent-connection cap, so the auth step cannot become the flood
target), and refusals are counted (``hbbft_guard_auth_failures_total``)
and journaled attributed to the attacker's SOCKET ENDPOINT — never to
the impersonated validator.  The session id is bound into every
subsequent heartbeat PING, so a hijacked TCP stream cannot ride an
authenticated session.  A transport built without ``auth_verify`` (raw
tests, sim harnesses) keeps the legacy identification-only behavior;
``NodeRuntime`` always wires authentication when its protocol stack
carries an era key map.  Residual gaps: client-role and obs ports stay
identification-only — bind them to localhost or a private fabric — and
transport auth is a floor under the per-node Ed/BLS signatures INSIDE
the protocol (DHB votes, key-gen messages, threshold shares), which
remain verified regardless.

All callbacks but the handshake's ``auth_sign`` / ``auth_verify`` run on
the event loop; they may call :meth:`Transport.send` re-entrantly (it only
enqueues).

The port's copy of the JAX package's module, with two changes.
:meth:`Transport.stop` ends the inbound handlers (aborting their sockets)
before it waits for the listening server, and bounds that wait: since
Python 3.12.1 ``Server.wait_closed()`` returns only once every accepted
connection has dropped, so the reference's order (wait, then cancel)
never returns while a peer or client is still connected.  And the
handshake's signing and verification (a hash to G2 and a pairing check)
run on the event loop's executor, not on the loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import logging
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.obs.metrics import MetricAttr
from hbbft_tpu_torch.net.framing import (
    DEFAULT_MAX_FRAME,
    FrameDecoder,
    FrameError,
    Hello,
    ROLE_CLIENT,
    ROLE_NODE,
)

NodeId = Hashable
Addr = Tuple[str, int]

#: seconds :meth:`Transport.stop` waits for the listening server to close
STOP_WAIT_S = 2.0

logger = logging.getLogger("hbbft_tpu_torch.net")


def set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on a stream's socket.  Consensus frames are tiny
    (~70 B) and latency-critical; Nagle + delayed-ACK otherwise holds
    them back up to 40 ms waiting to coalesce with traffic that never
    comes."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        with contextlib.suppress(OSError):  # non-TCP / already-closed socket
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class BackoffPolicy:
    """Seeded exponential backoff with jitter — deterministic per seed.

    ``delays(peer_key)`` yields ``min(cap, base·factor^i) · u`` where ``u``
    is drawn uniformly from ``[1−jitter, 1)`` by a per-(seed, peer) RNG.
    The RNG stream is owned by the caller via :meth:`rng_for` so that
    successive outages continue one deterministic sequence.
    """

    def __init__(self, seed: int = 0, base: float = 0.05,
                 factor: float = 2.0, cap: float = 2.0,
                 jitter: float = 0.5):
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.seed = seed
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter

    def rng_for(self, peer_key: str) -> random.Random:
        digest = hashlib.sha3_256(
            b"hbbft-net-backoff:%d:%s" % (self.seed, peer_key.encode())
        ).digest()
        return random.Random(int.from_bytes(digest[:8], "big"))

    def delay(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.cap, self.base * self.factor ** attempt)
        return raw * (1.0 - self.jitter + self.jitter * rng.random())

    def preview(self, peer_key: str, n: int) -> List[float]:
        """First ``n`` delays of a fresh stream (for tests/debugging)."""
        rng = self.rng_for(peer_key)
        return [self.delay(i, rng) for i in range(n)]


class _PeerBudget:
    """Per-peer ingress bookkeeping (see :class:`IngressBudget`)."""

    __slots__ = ("tokens", "t_last", "inflight", "strikes", "decode_fails",
                 "disconnects", "backoff_until", "kill")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.t_last = now
        self.inflight = 0
        self.strikes = 0
        self.decode_fails = 0
        self.disconnects = 0
        self.backoff_until = 0.0
        self.kill = False


class IngressBudget:
    """Per-peer ingress budgets: the transport's overload defense.

    Every node-role connection is metered three ways, each violation
    counted (``hbbft_guard_*``), never silent:

    - a **bytes/sec token bucket** (``bytes_per_s`` sustained,
      ``burst_bytes`` burst): a peer over budget is *throttled* — the
      recv loop stops reading its socket for the shortfall, so the
      kernel's TCP window closes and the flood backs up at the sender;
    - a **max in-flight frames** cap: frames admitted to the pump but
      not yet processed, per peer (enabled once a consumer calls
      :meth:`frame_done`; a raw transport with a synchronous callback
      has no in-flight window to track);
    - a **strike ladder**: sustained throttling (or a run of
      decode-invalid frames, reported by the runtime via
      :meth:`decode_strike`) escalates to a counted
      *disconnect-with-backoff* — the connection is torn down and the
      peer's node-role hellos are rejected until the (exponentially
      growing, capped) backoff expires.

    Budgets attribute to the VERIFIED peer identity: with transport
    authentication on (see the module security model) no per-peer state
    is allocated — and none of the meters above are chargeable — until
    the dialer proves the claimed identity with its era key, so a spoofer
    cannot spend validator X's budget or burn X's strike ladder.  Failed
    proofs are counted per refusal *reason* (``auth_failures`` below) and
    attributed to the attacker's socket endpoint.  On a transport built
    without ``auth_verify`` the ledger reverts to claimed identities;
    run that mode only on a trusted fabric.

    Defaults are sized far above honest consensus traffic (a 4-node
    pipelined cluster peaks well under 1 MiB/s per peer) so the guard
    only ever engages on floods.
    """

    #: every way a handshake can be refused — each refusal is counted
    #: under exactly one of these (pre-initialized so a zero shows up in
    #: scrapes before the first attack): signature did not verify
    #: (``bad_sig``), claimed id absent from every admissible era map
    #: (``unknown_key``), a non-AUTH frame where the proof was due
    #: (``no_auth``), an unparsable handshake frame (``malformed``), the
    #: proof never arrived in time (``timeout``), a heartbeat carrying
    #: the wrong session id on an authenticated stream (``session``),
    #: or the half-open connection cap was hit (``half_open``).
    AUTH_FAIL_REASONS = ("bad_sig", "unknown_key", "no_auth", "malformed",
                         "timeout", "session", "half_open")

    def __init__(self, registry=None, *,
                 bytes_per_s: float = 16 * 2**20,
                 burst_bytes: float = 4 * 2**20,
                 max_inflight_frames: int = 16384,
                 throttle_strikes: int = 64,
                 decode_strikes: int = 256,
                 backoff_s: float = 2.0,
                 backoff_cap_s: float = 30.0,
                 max_throttle_sleep_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        from hbbft_tpu_torch.obs.metrics import Registry

        self.bytes_per_s = float(bytes_per_s)
        self.burst_bytes = float(burst_bytes)
        self.max_inflight_frames = int(max_inflight_frames)
        self.throttle_strikes = int(throttle_strikes)
        self.decode_strikes = int(decode_strikes)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_throttle_sleep_s = float(max_throttle_sleep_s)
        self.clock = clock
        # inflight counts cross threads (event loop admits, the pump's
        # worker retires); one lock covers the whole peer table
        self._lock = threading.Lock()
        self._peers: Dict[NodeId, _PeerBudget] = {}
        # in-flight tracking is opt-in: only a consumer that retires
        # frames (NodeRuntime) can keep the window honest
        self.track_inflight = False
        # a guard event sink (the runtime journals disconnects/rejects
        # to the flight recorder through its pump, so the forensic
        # auditor can attribute an overload incident to the peer)
        self.on_event: Optional[Callable[[str, NodeId, str], None]] = None
        r = registry if registry is not None else Registry()
        self._c_throttles = r.counter(
            "hbbft_guard_ingress_throttles_total",
            "per-peer ingress budget violations that paused the recv "
            "loop (token-bucket shortfall or in-flight frame overflow)",
            labelnames=("peer",), max_label_sets=33)
        self._c_throttle_s = r.counter(
            "hbbft_guard_ingress_throttle_seconds_total",
            "seconds the recv loops spent paused on over-budget peers")
        self._c_disconnects = r.counter(
            "hbbft_guard_ingress_disconnects_total",
            "peers disconnected with backoff after sustained budget "
            "violations or decode-invalid streams",
            labelnames=("peer",), max_label_sets=33)
        self._c_hello_rejects = r.counter(
            "hbbft_guard_hello_rejects_total",
            "node-role hellos rejected while the peer's guard backoff "
            "window was still open")
        self._c_decode_strikes = r.counter(
            "hbbft_guard_decode_strikes_total",
            "decode-invalid frames charged against a peer's guard "
            "budget by the runtime", labelnames=("peer",),
            max_label_sets=33)
        self._g_inflight = r.gauge(
            "hbbft_guard_inflight_frames",
            "frames admitted from a peer but not yet processed by the "
            "pump", labelnames=("peer",), max_label_sets=33)
        self._c_auth_ok = r.counter(
            "hbbft_guard_auth_ok_total",
            "node-role handshakes that proved the claimed identity with "
            "a valid era-key signature")
        self._c_auth_stale = r.counter(
            "hbbft_guard_auth_stale_era_total",
            "handshakes accepted against the PREVIOUS era's key map "
            "within the rotation grace window (counted, not refused)")
        # reason cardinality is fixed by AUTH_FAIL_REASONS; the attacker
        # endpoint is deliberately NOT a label (unbounded cardinality) —
        # it travels through the guard-event journal instead
        self._c_auth_fail = r.counter(
            "hbbft_guard_auth_failures_total",
            "node-role handshakes refused before allocating any "
            "per-peer state, by refusal reason",
            labelnames=("reason",),
            max_label_sets=len(self.AUTH_FAIL_REASONS) + 1)
        for reason in self.AUTH_FAIL_REASONS:
            self._c_auth_fail.labels(reason=reason)
        r.register_callback(self._refresh_gauges)

    def _refresh_gauges(self) -> None:
        with self._lock:
            snap = [(p, b.inflight) for p, b in self._peers.items()]
        for peer, inflight in snap:
            self._g_inflight.labels(peer=repr(peer)).set(inflight)

    def _budget(self, peer: NodeId) -> _PeerBudget:
        b = self._peers.get(peer)
        if b is None:
            b = self._peers[peer] = _PeerBudget(
                self.burst_bytes, self.clock())
        return b

    def _emit(self, kind: str, peer: NodeId, detail: str) -> None:
        if self.on_event is not None:
            self.on_event(kind, peer, detail)

    def _trip(self, b: _PeerBudget, peer: NodeId, why: str) -> None:
        """Escalate to a counted disconnect-with-backoff."""
        b.kill = True
        b.strikes = 0
        if self.clock() < b.backoff_until:
            # aftershock: the pump is still draining frames admitted
            # before the disconnect (decode strikes keep arriving with
            # no live recv loop).  The window is already armed — do not
            # re-count the incident or double the backoff for it.
            return
        b.disconnects += 1
        backoff = min(self.backoff_cap_s,
                      self.backoff_s * 2 ** (b.disconnects - 1))
        b.backoff_until = self.clock() + backoff
        self._c_disconnects.labels(peer=repr(peer)).inc()
        self._emit("disconnect", peer,
                   f"why={why} backoff_s={backoff:.3f}")
        logger.warning("guard: disconnecting peer %r (%s), backoff "
                       "%.1fs", peer, why, backoff)

    def connection_accepted(self, peer: NodeId) -> None:
        """A fresh node-role connection for ``peer`` passed the backoff
        gate: clear any stale kill mark left by backlog drained after
        the OLD connection died, so the legitimate successor is not
        torn down on its first chunk for the predecessor's sins."""
        with self._lock:
            b = self._peers.get(peer)
            if b is not None:
                b.kill = False
                b.strikes = 0

    # -- recv-loop surface (event loop) --------------------------------------

    def charge(self, peer: NodeId, nbytes: int) -> float:
        """Account one received chunk; returns seconds the recv loop
        must pause before reading again (0.0 when within budget).  A
        peer that keeps earning pauses trips the strike ladder and is
        marked for disconnect (see :meth:`kill_pending`)."""
        now = self.clock()
        with self._lock:
            b = self._budget(peer)
            b.tokens = min(self.burst_bytes,
                           b.tokens + (now - b.t_last) * self.bytes_per_s)
            b.t_last = now
            b.tokens -= nbytes
            over_tokens = b.tokens < 0
            over_inflight = (self.track_inflight
                             and b.inflight > self.max_inflight_frames)
            if not over_tokens and not over_inflight:
                if b.strikes:
                    b.strikes -= 1  # calm traffic pays strikes down
                return 0.0
            b.strikes += 1
            if b.strikes > self.throttle_strikes:
                why = ("inflight" if over_inflight else "bytes_per_s")
                self._trip(b, peer, why)
                return 0.0
            if over_tokens:
                delay = min(self.max_throttle_sleep_s,
                            -b.tokens / self.bytes_per_s)
            else:
                delay = min(self.max_throttle_sleep_s, 0.05)
        self._c_throttles.labels(peer=repr(peer)).inc()
        self._c_throttle_s.inc(delay)
        return delay

    #: worst-case frames a single 64 KiB recv chunk can admit: a
    #: MSG_BATCH sub-message costs 4 bytes minimum (u32 length prefix,
    #: empty payload), so one chunk can carry up to 64 Ki/4 of them.
    #: The in-flight cap is enforced at chunk granularity, so the
    #: resident count is bounded by ``max_inflight_frames +
    #: CHUNK_FRAMES_MAX``, never by the cap alone mid-chunk
    CHUNK_FRAMES_MAX = 65536 // 4

    @property
    def inflight_hard_bound(self) -> int:
        """The enforced ceiling on any peer's in-flight frames: the cap
        plus one recv chunk's worst-case admissions (the chunk is the
        enforcement granularity — the loop stops READING once over the
        cap, but a chunk already read is admitted whole)."""
        return self.max_inflight_frames + self.CHUNK_FRAMES_MAX

    def inflight_over(self, peer: NodeId) -> bool:
        """Is the peer currently over its in-flight frame cap?  The
        recv loop polls this and stops READING until the pump drains
        the window — the cap is enforced, not just sampled (overshoot
        is bounded by one chunk's worth of frames)."""
        if not self.track_inflight:
            return False
        with self._lock:
            b = self._peers.get(peer)
            return (b is not None
                    and b.inflight > self.max_inflight_frames)

    def kill_pending(self, peer: NodeId) -> bool:
        """True once for a peer marked for disconnect (clears the mark;
        the backoff window stays armed)."""
        with self._lock:
            b = self._peers.get(peer)
            if b is None or not b.kill:
                return False
            b.kill = False
            return True

    def in_backoff(self, peer: NodeId) -> bool:
        with self._lock:
            b = self._peers.get(peer)
            backed_off = (b is not None
                          and self.clock() < b.backoff_until)
        if backed_off:
            self._c_hello_rejects.inc()
            self._emit("hello_reject", peer, "backoff window open")
        return backed_off

    def frame_admitted(self, peer: NodeId, n: int = 1) -> None:
        if not self.track_inflight:
            return
        with self._lock:
            self._budget(peer).inflight += n

    # -- handshake authentication surface (event loop) -----------------------

    def auth_ok(self) -> None:
        self._c_auth_ok.inc()

    def auth_stale(self, peer: NodeId) -> None:
        """A handshake that verified against the PREVIOUS era's key
        inside the rotation grace window: admitted, but counted — a
        burst of these outside a rotation is worth an operator's look."""
        self._c_auth_stale.inc()
        logger.info("guard: peer %r authenticated with previous-era key "
                    "(rotation grace window)", peer)

    def auth_fail(self, endpoint: str, claimed: Any, reason: str) -> None:
        """A refused handshake: counted by ``reason`` and journaled
        attributed to the attacker's socket ENDPOINT — never to the
        impersonated ``claimed`` identity, whose budgets and strike
        ladder stay untouched (no per-peer state exists yet)."""
        if reason not in self.AUTH_FAIL_REASONS:
            reason = "malformed"
        self._c_auth_fail.labels(reason=reason).inc()
        self._emit("auth_fail", endpoint,
                   f"claimed={claimed!r} reason={reason}")
        logger.warning("guard: refused handshake from %s claiming %r "
                       "(%s)", endpoint, claimed, reason)

    # -- consumer surface (pump worker thread) -------------------------------

    def frame_done(self, peer: NodeId, n: int = 1) -> None:
        with self._lock:
            b = self._peers.get(peer)
            if b is not None:
                b.inflight = max(0, b.inflight - n)

    def decode_strike(self, peer: NodeId) -> None:
        """A framing-valid but decode-invalid (or protocol-rejected)
        frame: charged by the runtime.  A sustained garbage stream —
        ``decode_strikes`` of them — trips the disconnect ladder; the
        recv loop notices via :meth:`kill_pending` on its next chunk."""
        self._c_decode_strikes.labels(peer=repr(peer)).inc()
        with self._lock:
            b = self._budget(peer)
            b.decode_fails += 1
            if b.decode_fails % self.decode_strikes == 0:
                self._trip(b, peer, "decode_garbage")

    # -- introspection -------------------------------------------------------

    def peer_doc(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                repr(p): {
                    "inflight": b.inflight,
                    "strikes": b.strikes,
                    "decode_fails": b.decode_fails,
                    "disconnects": b.disconnects,
                }
                for p, b in self._peers.items()
            }

    def as_dict(self) -> Dict[str, Any]:
        return {
            "throttles": int(self._c_throttles.total()),
            "throttle_seconds": round(float(self._c_throttle_s.total()),
                                      6),
            "disconnects": int(self._c_disconnects.total()),
            "hello_rejects": int(self._c_hello_rejects.total()),
            "decode_strikes": int(self._c_decode_strikes.total()),
            "auth_ok": int(self._c_auth_ok.total()),
            "auth_stale_era": int(self._c_auth_stale.total()),
            "auth_failures": {
                reason: int(self._c_auth_fail.value(reason=reason))
                for reason in self.AUTH_FAIL_REASONS
            },
            "peers": self.peer_doc(),
        }


class EraKeyRing:
    """Per-era public-key lookup for handshake verification, with a
    bounded previous-era grace window.

    ``provider()`` returns ``(era, {node_id: public_key})`` — the
    CURRENT era's key map (``NodeRuntime`` reads it off the live
    protocol's ``NetworkInfo``).  The ring polls the provider on every
    lookup; when the era advances it stashes the outgoing map so that a
    peer still dialing with the *previous* era's key during an in-flight
    DKG rotation verifies within ``grace_s`` seconds (counted
    ``hbbft_guard_auth_stale_era_total`` by the caller) instead of being
    refused into a strike-laddered retry storm.  Exactly one previous
    era is retained and it expires on the clock, so the admissible key
    set stays bounded.  The converse race — a dialer already rotated
    ahead of an acceptor that has not observed the new era yet — needs
    no stash: the plain keypairs rarely change across eras (re-adds keep
    keys), and a genuinely new key is refused ``unknown_key`` until the
    acceptor's own rotation lands, bounded by the dialer's backoff.
    """

    def __init__(self, provider: Callable[[], Tuple[int, Dict[NodeId, Any]]],
                 *, grace_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.provider = provider
        self.grace_s = float(grace_s)
        self.clock = clock
        self._era: Optional[int] = None
        self._keys: Dict[NodeId, Any] = {}
        self._prev_era: Optional[int] = None
        self._prev_keys: Dict[NodeId, Any] = {}
        self._prev_at = 0.0

    def _refresh(self) -> None:
        era, keys = self.provider()
        if self._era is not None and era != self._era:
            self._prev_era = self._era
            self._prev_keys = self._keys
            self._prev_at = self.clock()
        self._era = era
        self._keys = dict(keys)

    def lookup(self, node_id: NodeId) -> List[Tuple[int, Any, bool]]:
        """Admissible ``(era, public_key, stale)`` candidates for a
        claimed id, current era first.  Empty when the id is unknown to
        every admissible era."""
        self._refresh()
        out: List[Tuple[int, Any, bool]] = []
        key = self._keys.get(node_id)
        if key is not None:
            out.append((self._era, key, False))
        if (self._prev_era is not None
                and self.clock() - self._prev_at <= self.grace_s):
            prev = self._prev_keys.get(node_id)
            if prev is not None:
                out.append((self._prev_era, prev, True))
        return out


class _LabeledCounterView:
    """Dict-shaped view over one labeled counter, keyed by the original
    (hashable) id — the shim that lets ``stats.reconnects[peer] += 1``-style
    call sites keep working while the registry carries the series.

    The view keeps its own per-key values and applies *deltas* to the
    counter: past the metric's label-cardinality cap several keys share
    the ``_overflow_`` series, and a plain assignment there would clobber
    every other overflowed peer's aggregate — a delta only ever adds this
    key's change."""

    def __init__(self, counter):
        self._counter = counter
        self._values: Dict[NodeId, float] = {}

    def get(self, key: NodeId, default: int = 0) -> int:
        return int(self._values.get(key, default))

    def __getitem__(self, key: NodeId) -> int:
        return int(self._values[key])

    def __setitem__(self, key: NodeId, value: int) -> None:
        self._counter.labels(repr(key)).inc(
            value - self._values.get(key, 0)
        )
        self._values[key] = value

    def __contains__(self, key: NodeId) -> bool:
        return key in self._values

    def __len__(self) -> int:
        return len(self._values)

    def items(self):
        return [(k, int(v)) for k, v in self._values.items()]

    def keys(self):
        return list(self._values.keys())

    def __iter__(self):
        return iter(self.keys())


class TransportStats:
    """Socket-layer counters, backed by an :mod:`hbbft_tpu_torch.obs.metrics`
    registry (``hbbft_net_*``); the original dataclass attribute API is
    preserved as thin property views so no call site or test breaks.
    ``backoff_delays`` keeps the exact per-peer delay *lists* (the seeded
    determinism tests assert on the sequences, which a histogram cannot
    represent); :meth:`record_backoff` also feeds the registry histogram."""

    def __init__(self, registry=None):
        from hbbft_tpu_torch.obs.metrics import Registry

        self.registry = registry or Registry()
        r = self.registry
        self._frames_sent = r.counter(
            "hbbft_net_frames_sent_total",
            "frames written to peer/client sockets")
        self._bytes_sent = r.counter(
            "hbbft_net_bytes_sent_total",
            "framed bytes written, length prefix included")
        self._frames_recv = r.counter(
            "hbbft_net_frames_recv_total", "frames received")
        self._bytes_recv = r.counter(
            "hbbft_net_bytes_recv_total", "framed bytes received")
        self._reconnects = r.counter(
            "hbbft_net_reconnects_total",
            "outbound connection losses per peer", labelnames=("peer",))
        self._send_queue_peak = r.gauge(
            "hbbft_net_send_queue_peak",
            "high-water mark of any per-peer outbox")
        self._dead_peer_events = r.counter(
            "hbbft_net_dead_peer_events_total",
            "peers declared dead after missed heartbeats")
        # drop accounting: connection-level
        # losses must be scrapeable, not just debug-logged
        self._inbound_drops = r.counter(
            "hbbft_net_inbound_drops_total",
            "inbound connections dropped on error/timeout before or "
            "during frame processing")
        self._client_conn_drops = r.counter(
            "hbbft_net_client_conn_drops_total",
            "client connections dropped mid-send (write-buffer overflow "
            "or dead socket)")
        self._dynamic_peers = r.counter(
            "hbbft_net_dynamic_peers_total",
            "peers added live from a membership-resolved inbound hello "
            "(a validator voted in by a DHB rotation dialing us)")
        # virtual cost of received traffic under the attached CostModel —
        # the simulator's synthetic clock applied to real frames, so sim
        # and net runs report comparable virtual time
        self._virtual_cost = r.counter(
            "hbbft_net_virtual_cost_seconds_total",
            "CostModel virtual seconds charged to received frames")
        self._backoff_hist = r.histogram(
            "hbbft_net_backoff_delay_seconds",
            "reconnect backoff delays drawn",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0))
        # egress fairness (guard family: bounded-resource enforcement):
        # a drain round that hit its byte quantum with backlog remaining
        # — the sender yielded the event loop instead of writing on
        self._egress_stalls = r.counter(
            "hbbft_guard_egress_stalls_total",
            "per-peer egress drain rounds truncated at the byte quantum "
            "with frames still queued (round-robin yield points)",
            labelnames=("peer",), max_label_sets=33)
        self.reconnects = _LabeledCounterView(self._reconnects)
        self.backoff_delays: Dict[NodeId, List[float]] = {}
        # hot-path handles: _record_send/_record_recv run per frame, and
        # the MetricAttr `+= 1` shim costs a registry read + a set each —
        # these direct child references make the per-frame accounting two
        # plain ``inc`` calls (part of the r01→r02 obs-overhead fix)
        self._c_frames_sent = self._frames_sent._default()
        self._c_bytes_sent = self._bytes_sent._default()
        self._c_frames_recv = self._frames_recv._default()
        self._c_bytes_recv = self._bytes_recv._default()

    def frame_sent(self, nbytes: int) -> None:
        self._c_frames_sent.inc()
        self._c_bytes_sent.inc(nbytes)

    def frame_recv(self, nbytes: int) -> None:
        self._c_frames_recv.inc()
        self._c_bytes_recv.inc(nbytes)

    def frame_recv_batch(self, nframes: int, nbytes: int) -> None:
        """Batched receive accounting: one pair of counter bumps for a
        whole decoded chunk instead of two per frame (the batch-handle
        hot path; only the totals are observable either way)."""
        self._c_frames_recv.inc(nframes)
        self._c_bytes_recv.inc(nbytes)

    def egress_stall(self, peer_id: NodeId) -> None:
        self._egress_stalls.labels(peer=repr(peer_id)).inc()

    # -- attribute views (the pre-registry dataclass API) -------------------

    frames_sent = MetricAttr("_frames_sent")
    bytes_sent = MetricAttr("_bytes_sent")
    frames_recv = MetricAttr("_frames_recv")
    bytes_recv = MetricAttr("_bytes_recv")
    send_queue_peak = MetricAttr("_send_queue_peak")
    dead_peer_events = MetricAttr("_dead_peer_events")
    inbound_drops = MetricAttr("_inbound_drops")
    client_conn_drops = MetricAttr("_client_conn_drops")
    dynamic_peers = MetricAttr("_dynamic_peers")
    virtual_cost_s = MetricAttr("_virtual_cost", cast=float)

    def record_backoff(self, peer_id: NodeId, delay: float) -> None:
        delays = self.backoff_delays.setdefault(peer_id, [])
        delays.append(delay)
        if len(delays) > 512:
            # bounded-ingress: a peer that stays down draws a delay
            # every couple of seconds forever; the determinism tests
            # assert on short prefixes, so front-chopping the exact
            # list at depth keeps both properties
            del delays[: len(delays) - 512]
        self._backoff_hist.observe(delay)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "frames_sent": self.frames_sent,
            "bytes_sent": self.bytes_sent,
            "frames_recv": self.frames_recv,
            "bytes_recv": self.bytes_recv,
            "reconnects": {repr(k): v for k, v in self.reconnects.items()},
            "send_queue_peak": self.send_queue_peak,
            "dead_peer_events": self.dead_peer_events,
            "inbound_drops": self.inbound_drops,
            "client_conn_drops": self.client_conn_drops,
            "dynamic_peers": self.dynamic_peers,
            "virtual_cost_s": round(self.virtual_cost_s, 6),
        }


class ClientConn:
    """One inbound client-role connection.

    Writes are fire-and-forget but bounded: a client that stops reading
    its socket would otherwise make the node buffer commit notifications
    without limit, so once the transport's write buffer exceeds
    ``MAX_WRITE_BUFFER`` the connection is declared dead and dropped (the
    client can reconnect; commit state is queryable via STATUS_REQ)."""

    MAX_WRITE_BUFFER = 1 << 20

    _next = 0

    def __init__(self, hello: Hello, writer: asyncio.StreamWriter,
                 max_frame: int, record_send=None,
                 stats: Optional["TransportStats"] = None):
        ClientConn._next += 1
        self.conn_id = ClientConn._next
        self.hello = hello
        self.client_id = hello.node_id
        self._writer = writer
        self._max_frame = max_frame
        self._record_send = record_send
        self._stats = stats
        self.closed = False
        # chunk-scoped write coalescing: between begin_batch/flush_batch
        # frames accumulate and go out as ONE writer.write — a 16-tx
        # submit wave answers with one ack syscall, not 16 (socket send
        # is a measurable share of a small host's consensus budget)
        self._batching = False
        self._pending: List[bytes] = []

    def _drop(self) -> None:
        self.closed = True
        if self._stats is not None:
            self._stats.client_conn_drops += 1

    def begin_batch(self) -> None:
        self._batching = True

    def flush_batch(self) -> None:
        self._batching = False
        if not self._pending or self.closed:
            self._pending.clear()
            return
        buf = b"".join(self._pending)
        self._pending.clear()
        try:
            if (self._writer.transport.get_write_buffer_size()
                    > self.MAX_WRITE_BUFFER):
                self._drop()
                self._writer.close()
                return
            self._writer.write(buf)
        except (ConnectionError, RuntimeError):
            self._drop()

    def send(self, kind: int, payload: bytes) -> None:
        if self.closed:
            return
        try:
            frame = framing.encode_frame(kind, payload, self._max_frame)
            if self._record_send is not None:
                self._record_send(self.client_id, frame)
            if self._batching:
                self._pending.append(frame)
                return
            if (self._writer.transport.get_write_buffer_size()
                    > self.MAX_WRITE_BUFFER):
                self._drop()
                self._writer.close()
                return
            self._writer.write(frame)
        except (ConnectionError, RuntimeError):
            self._drop()


class _PeerSender:
    """Outbound half for one peer: queue + dial/backoff/heartbeat loop."""

    def __init__(self, transport: "Transport", peer_id: NodeId, addr: Addr):
        self.t = transport
        self.peer_id = peer_id
        self.addr = addr
        self.outbox: Deque[bytes] = deque()
        self.wake = asyncio.Event()
        self.connected = asyncio.Event()
        self.stopped = False
        self.rng = transport.backoff.rng_for(
            f"{transport.our_id!r}->{peer_id!r}"
        )
        self.task: Optional[asyncio.Task] = None
        # session id issued by the acceptor's CHALLENGE (None on a
        # legacy unauthenticated handshake); bound into every heartbeat
        # PING so a hijacked stream can't ride the authenticated session
        self.session: Optional[bytes] = None

    def start(self) -> None:
        self.task = asyncio.get_running_loop().create_task(
            self._run(), name=f"peer-sender-{self.peer_id!r}"
        )

    def send(self, frame: bytes) -> None:
        # the transport side of the shared shaping hook
        # (chaos.link.LinkShaper): per-edge latency/jitter/loss/dup/
        # bandwidth/partition decisions, seeded and accounted.  Shaped
        # copies are scheduled onto the event loop; a dropped frame was
        # already counted by the shaper (hbbft_chaos_frames_dropped_total)
        shaper = self.t.shaper
        if shaper is not None:
            delays = shaper.shape_frame(
                self.t.our_id, self.peer_id, self.t.chaos_now(),
                nbytes=len(frame))
            if delays is not None:
                loop = asyncio.get_running_loop()
                for d in delays:
                    if d > 0:
                        loop.call_later(d, self._enqueue, frame)
                    else:
                        self._enqueue(frame)
                return
        self._enqueue(frame)

    def _enqueue(self, frame: bytes) -> None:
        if self.stopped:
            return  # a shaped frame landing after shutdown
        self.outbox.append(frame)
        peak = len(self.outbox)
        if peak > self.t.stats.send_queue_peak:
            self.t.stats.send_queue_peak = peak
        self.wake.set()

    async def _run(self) -> None:
        attempt = 0
        while not self.stopped:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*self.addr),
                    self.t.connect_timeout_s,
                )
            except (OSError, asyncio.TimeoutError):
                attempt = await self._backoff(attempt)
                continue
            set_nodelay(writer)
            try:
                hello = await self._handshake(reader, writer)
            except (OSError, asyncio.TimeoutError, FrameError,
                    asyncio.IncompleteReadError) as exc:
                logger.debug("handshake with %r failed: %r",
                             self.peer_id, exc)
                writer.close()
                attempt = await self._backoff(attempt)
                continue
            self.connected.set()
            self.t._notify_hello(self.peer_id, hello, direction="dial")
            t_conn = time.monotonic()
            try:
                await self._serve(reader, writer)
            finally:
                self.connected.clear()
                writer.close()
                if not self.stopped:
                    self.t.stats.reconnects[self.peer_id] = (
                        self.t.stats.reconnects.get(self.peer_id, 0) + 1
                    )
            # a connection that survived a while earns an immediate redial
            # with reset growth; one that died right after the handshake
            # keeps climbing the backoff ladder — otherwise a peer that
            # kills every fresh connection induces a zero-delay dial spin
            if time.monotonic() - t_conn >= self.t.dead_after_s:
                attempt = 0
            else:
                attempt = await self._backoff(attempt)

    async def _backoff(self, attempt: int) -> int:
        delay = self.t.backoff.delay(attempt, self.rng)
        self.t.stats.record_backoff(self.peer_id, delay)
        await asyncio.sleep(delay)
        return attempt + 1

    async def _handshake(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> Hello:
        frame = framing.encode_frame(
            framing.HELLO, framing.encode_hello(self.t.local_hello()),
            self.t.max_frame,
        )
        writer.write(frame)
        await writer.drain()
        self.t._record_send(self.peer_id, frame)
        kind, payload = await asyncio.wait_for(
            framing.read_one_frame(reader, self.t.max_frame),
            self.t.dead_after_s,
        )
        self.session = None
        if kind == framing.CHALLENGE:
            # authenticated acceptor: prove our identity by signing the
            # challenge transcript with our current era key, then the
            # hello reply follows on success
            if self.t.auth_sign is None:
                raise FrameError(
                    "peer demands an authenticated handshake but this "
                    "transport has no signer (auth disabled?)"
                )
            nonce, session = framing.decode_challenge(payload)
            # off the event loop (see Transport._challenge)
            era, sig = await asyncio.get_running_loop().run_in_executor(
                None, self.t.auth_sign, self.t.cluster_id, nonce, session)
            auth = framing.encode_frame(
                framing.AUTH, framing.encode_auth(era, sig),
                self.t.max_frame,
            )
            writer.write(auth)
            await writer.drain()
            self.t._record_send(self.peer_id, auth)
            kind, payload = await asyncio.wait_for(
                framing.read_one_frame(reader, self.t.max_frame),
                self.t.dead_after_s,
            )
            self.session = session
        if kind != framing.HELLO:
            raise FrameError(f"expected HELLO reply, got kind {kind}")
        hello = framing.decode_hello(payload)
        if hello.cluster_id != self.t.cluster_id:
            raise FrameError("cluster id mismatch")
        if hello.role != ROLE_NODE or hello.node_id != self.peer_id:
            raise FrameError(
                f"dialed {self.peer_id!r}, got hello from "
                f"{hello.node_id!r}"
            )
        return hello

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Drain the outbox + heartbeat until the connection dies."""
        last_pong = time.monotonic()
        ping_nonce = 0
        # drainer and heartbeat share the StreamWriter; two tasks awaiting
        # writer.drain() concurrently trip asyncio's _drain_helper assert
        # under write backpressure, so every write+drain takes this lock
        wlock = asyncio.Lock()

        async def pong_reader():
            nonlocal last_pong
            decoder = FrameDecoder(self.t.max_frame)
            while True:
                data = await reader.read(65536)
                if not data:
                    return
                for kind, _payload in decoder.feed(data):
                    if kind == framing.PONG:
                        last_pong = time.monotonic()
                    else:
                        raise FrameError(
                            f"unexpected frame kind {kind} on send socket"
                        )

        async def drainer():
            quantum = self.t.egress_quantum_bytes
            while True:
                await self.wake.wait()
                self.wake.clear()
                while self.outbox:
                    # write queued frames up to the byte QUANTUM, then ONE
                    # drain for the lot — per-frame drains cost a writer
                    # round trip each and dominated the sequential-path
                    # profile, while an unbounded batch lets one peer's
                    # MB-scale shard backlog monopolize the event loop
                    # (every other peer's drainer and the recv loops wait
                    # behind the memcpy).  (Link shaping happens BEFORE
                    # the outbox — see send(): a queued frame is already
                    # due.)
                    batch = []
                    nbytes = 0
                    for f in self.outbox:
                        batch.append(f)
                        nbytes += len(f)
                        if nbytes >= quantum:
                            break
                    async with wlock:
                        for f in batch:
                            writer.write(f)
                        await writer.drain()
                    # popped only after a successful drain: frames in
                    # flight when the socket dies are re-sent
                    # (at-least-once)
                    for f in batch:
                        self.outbox.popleft()
                        self.t._record_send(self.peer_id, f)
                    if self.outbox:
                        # counted yield point: round-robin fairness across
                        # peers is observable, not assumed
                        self.t.stats.egress_stall(self.peer_id)
                        await asyncio.sleep(0)

        async def ping_once():
            # on an authenticated session the PING carries the session
            # id issued at the handshake — the acceptor refuses the
            # stream if it ever mismatches (hijack defense)
            prefix = self.session if self.session is not None else b""
            frame = framing.encode_frame(
                framing.PING, prefix + struct.pack(">Q", ping_nonce),
                self.t.max_frame,
            )
            async with wlock:
                writer.write(frame)
                await writer.drain()
            self.t._record_send(self.peer_id, frame)

        async def heartbeat():
            nonlocal ping_nonce
            while True:
                await asyncio.sleep(self.t.heartbeat_s)
                # deadline check runs UNLOCKED every cycle: when the peer
                # stops reading, the drainer wedges inside writer.drain()
                # holding wlock — the ping below must not be allowed to
                # park this task behind it, or dead-peer detection would
                # never fire and the connection would hang forever
                if time.monotonic() - last_pong > self.t.dead_after_s:
                    self.t.stats.dead_peer_events += 1
                    raise ConnectionError(
                        f"peer {self.peer_id!r} missed heartbeats for "
                        f"{self.t.dead_after_s}s"
                    )
                ping_nonce += 1
                try:
                    await asyncio.wait_for(ping_once(), self.t.heartbeat_s)
                # hblint: disable=fault-swallowed-drop (nothing is
                # dropped: a congested writer just skips this ping and
                # the pong deadline above decides peer death)
                except asyncio.TimeoutError:
                    pass

        self.wake.set()  # flush anything queued while disconnected
        tasks = [
            asyncio.get_running_loop().create_task(c())
            for c in (pong_reader, drainer, heartbeat)
        ]
        try:
            done, _pending = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for d in done:
                exc = d.exception()
                if exc is not None:
                    logger.debug("connection to %r dropped: %r",
                                 self.peer_id, exc)
        finally:
            # re-cancel until done: ping_once sits under a wait_for, and a
            # cancel landing as it completes is swallowed on CPython 3.10
            # (bpo-42130) — see Transport.stop
            live = {t for t in tasks if not t.done()}
            while live:
                for task in live:
                    task.cancel()
                _done, live = await asyncio.wait(live, timeout=1.0)

    async def stop(self) -> None:
        self.stopped = True
        if self.task is not None:
            self.task.cancel()
            # suppress: awaiting our own cancelled task; any late error
            # was already logged by _serve and the sender is going away
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self.task


class _NodeRecvProtocol(asyncio.Protocol):
    """Post-handshake node receive path as a raw asyncio protocol.

    Swapped onto the socket with ``set_protocol`` once the stream-based
    handshake completes: every chunk is then one synchronous
    ``data_received`` callback that decodes, admits, and delivers the
    whole chunk's consensus payloads as a single batch (or feeds a
    per-peer ingress worker thread when the transport runs with
    ``ingress_workers``).  The IngressBudget verdicts map onto transport
    flow control: a throttle delay or an in-flight-cap breach pauses
    reading (closing the TCP window — real backpressure) and a timer
    re-polls until the pump drains the window or the strike ladder
    trips.  ``done`` resolves when the connection ends, carrying the
    same exception shapes the old StreamReader loop raised so the
    caller's drop accounting is untouched.
    """

    __slots__ = ("t", "peer_id", "writer", "decoder", "state", "session",
                 "worker", "loop", "done", "transport", "timing",
                 "seg_recv", "_paused", "_resume_handle")

    def __init__(self, t: "Transport", peer_id: NodeId,
                 writer: asyncio.StreamWriter, decoder: FrameDecoder,
                 state: list, session: Optional[bytes],
                 worker: Optional[Any] = None):
        self.t = t
        self.peer_id = peer_id
        self.writer = writer
        self.decoder = decoder
        self.state = state  # shared with _idle_watchdog
        self.session = session
        self.worker = worker
        self.loop = asyncio.get_running_loop()
        self.done: asyncio.Future = self.loop.create_future()
        self.transport: Optional[asyncio.BaseTransport] = None
        # cached per-connection: the runtime wires these before serving
        self.timing = getattr(t, "timing", None)
        self.seg_recv = getattr(t, "seg_recv", None)
        self._paused = False
        self._resume_handle: Optional[asyncio.TimerHandle] = None

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self.transport = transport

    def data_received(self, data: bytes) -> None:
        if self.done.done():
            return
        self.state[0] = time.monotonic()
        t = self.t
        if self.worker is not None:
            # decode happens off-loop; only byte-rate accounting and
            # flow control stay here
            self.worker.feed(data)
            if self.worker.backlog_over():
                # bounded hand-off queue: a slow worker closes the TCP
                # window instead of buffering unboundedly
                self._pause(0.01)
        else:
            try:
                if self.timing is None and self.seg_recv is None:
                    t._recv_chunk(self.peer_id, self.writer,
                                  self.decoder, data,
                                  session=self.session)
                else:
                    w0 = time.perf_counter()
                    t0 = (time.thread_time()
                          if self.timing is not None else 0.0)
                    t._recv_chunk(self.peer_id, self.writer,
                                  self.decoder, data,
                                  session=self.session)
                    if self.timing is not None:
                        self.timing["recv"] = (
                            self.timing.get("recv", 0.0)
                            + (time.thread_time() - t0))
                        self.timing["n_recv"] = (
                            self.timing.get("n_recv", 0) + 1)
                    if self.seg_recv is not None:
                        self.seg_recv(time.perf_counter() - w0)
            except (FrameError, ValueError) as exc:
                # same exception set the stream loop let propagate to
                # the acceptor's drop accounting
                self._fail(exc)
                return
        guard = t.ingress
        delay = guard.charge(self.peer_id, len(data))
        if guard.kill_pending(self.peer_id):
            self._fail(FrameError(
                f"ingress budget exceeded by peer {self.peer_id!r}"
            ))
            return
        if delay > 0 or guard.inflight_over(self.peer_id):
            self._pause(delay if delay > 0 else 0.05)

    def _pause(self, delay: float) -> None:
        if self._paused or self.transport is None:
            return
        self._paused = True
        self.transport.pause_reading()
        self._resume_handle = self.loop.call_later(
            delay, self._maybe_resume)

    def _maybe_resume(self) -> None:
        """Timer path of the in-flight cap: re-poll the guard until the
        pump retires this peer's admitted frames.  Each wait cycle is a
        counted strike (``charge(peer, 0)``), so a wedged consumer or a
        flood the pump cannot keep up with escalates to the disconnect
        ladder instead of pausing forever — same ladder the old polling
        loop walked."""
        self._resume_handle = None
        if self.done.done() or self.transport is None:
            return
        self.state[0] = time.monotonic()  # a throttle is not idleness
        if self.worker is not None and self.worker.backlog_over():
            # our own worker is behind, not the peer misbehaving: wait
            # without charging the peer's strike ladder
            self._resume_handle = self.loop.call_later(
                0.01, self._maybe_resume)
            return
        guard = self.t.ingress
        if guard.inflight_over(self.peer_id):
            delay = guard.charge(self.peer_id, 0)
            if guard.kill_pending(self.peer_id):
                self._fail(FrameError(
                    f"in-flight frame cap exceeded by peer "
                    f"{self.peer_id!r}"
                ))
                return
            self._resume_handle = self.loop.call_later(
                delay if delay > 0 else 0.05, self._maybe_resume)
            return
        self._paused = False
        self.transport.resume_reading()

    def _fail(self, exc: BaseException) -> None:
        """Terminate the connection with ``exc`` as the recv outcome
        (thread-safe callers schedule this via call_soon_threadsafe)."""
        if not self.done.done():
            self.done.set_exception(exc)
        if self.transport is not None:
            self.transport.close()

    def eof_received(self) -> bool:
        return False  # close on EOF, like reader.read() returning b""

    def connection_lost(self, exc: Optional[Exception]) -> None:
        if self._resume_handle is not None:
            self._resume_handle.cancel()
            self._resume_handle = None
        if self.worker is not None:
            self.worker.stop()
        if self.done.done():
            return
        if self.state[1]:
            # the idle watchdog closed us: surface the same timeout the
            # stream loop raised so drop accounting is unchanged
            self.done.set_exception(asyncio.TimeoutError(
                f"peer {self.peer_id!r} recv idle timeout"))
        elif exc is not None:
            self.done.set_exception(exc)
        else:
            self.done.set_result(None)


class Transport:
    """The node's socket layer: one listener + one sender per peer."""

    def __init__(
        self,
        our_id: NodeId,
        cluster_id: bytes,
        *,
        seed: int = 0,
        hello_key: Callable[[], Tuple[int, int]] = lambda: (0, 0),
        on_peer_message: Optional[Callable[[NodeId, bytes], None]] = None,
        on_peer_batch: Optional[
            Callable[[NodeId, List[Any]], None]
        ] = None,
        ingress_workers: bool = False,
        on_peer_hello: Optional[
            Callable[[NodeId, Hello, str], None]
        ] = None,
        on_client_frame: Optional[
            Callable[[ClientConn, int, bytes], None]
        ] = None,
        on_client_gone: Optional[Callable[[ClientConn], None]] = None,
        heartbeat_s: float = 0.5,
        dead_after_s: float = 3.0,
        connect_timeout_s: float = 2.0,
        client_idle_timeout_s: float = 60.0,
        max_frame: int = DEFAULT_MAX_FRAME,
        egress_quantum_bytes: int = 256 * 1024,
        backoff: Optional[BackoffPolicy] = None,
        trace=None,
        cost_model=None,
        registry=None,
        link_delays: Optional[Dict[NodeId, float]] = None,
        shaper=None,
        peer_resolver: Optional[
            Callable[[NodeId], Optional[Addr]]
        ] = None,
        ingress: Optional[IngressBudget] = None,
        ingress_kwargs: Optional[Dict[str, Any]] = None,
        auth_sign: Optional[
            Callable[[bytes, bytes, bytes], Tuple[int, bytes]]
        ] = None,
        auth_verify: Optional[
            Callable[[NodeId, int, int, bytes, bytes, bytes], str]
        ] = None,
        max_half_open: int = 64,
    ):
        self.our_id = our_id
        self.cluster_id = bytes(cluster_id)
        self.hello_key = hello_key
        self.on_peer_message = on_peer_message
        # batch-handle fast path: when set, each network chunk delivers its
        # whole decoded MSG/MSG_BATCH content as ONE callback (a list of
        # payloads, or (payload, pre_decoded) pairs from ingress workers)
        # instead of N per-message callbacks — one pump enqueue per chunk
        self.on_peer_batch = on_peer_batch
        # move framing/CRC/decode work off the event loop onto per-peer
        # worker threads (net/ingress.py); requires on_peer_batch
        self.ingress_workers = bool(ingress_workers)
        self.on_peer_hello = on_peer_hello
        self.on_client_frame = on_client_frame
        self.on_client_gone = on_client_gone
        self.heartbeat_s = heartbeat_s
        self.dead_after_s = dead_after_s
        self.connect_timeout_s = connect_timeout_s
        self.client_idle_timeout_s = client_idle_timeout_s
        self.max_frame = max_frame
        # egress fairness: a drainer round writes at most this many bytes
        # before draining and yielding — bounds any single peer's hold on
        # the event loop (counted: hbbft_guard_egress_stalls_total)
        self.egress_quantum_bytes = int(egress_quantum_bytes)
        self.backoff = backoff or BackoffPolicy(seed=seed)
        self.trace = trace
        self.cost_model = cost_model
        # dynamic membership: an inbound node-role hello from an id
        # OUTSIDE the configured peer set is normally rejected; with a
        # resolver, the embedder (NodeRuntime) is asked whether the id is
        # a legitimate cluster member now (e.g. a validator voted in by a
        # DHB rotation) and at what address — if it answers, the peer is
        # added live and the connection proceeds
        self.peer_resolver = peer_resolver
        self.stats = TransportStats(registry)
        # per-peer ingress budgets (overload defense): every inbound
        # node connection is metered; violators are throttled, then
        # disconnected with backoff — counted, never silent growth
        self.ingress = ingress if ingress is not None else IngressBudget(
            self.stats.registry, **(ingress_kwargs or {}))
        # outbound link shaping — the real-socket side of the shared
        # chaos.link hook: per-directed-edge latency/jitter/loss/dup/
        # bandwidth/partition policies applied to this node's egress
        # queue (see _PeerSender.send).  The legacy per-peer constant
        # `link_delays` knob is now sugar for a constant-delay shaper.
        # A shaper instance belongs to ONE transport (bind_registry
        # re-homes its counters onto this node's registry).
        self.link_delays: Dict[NodeId, float] = dict(link_delays or {})
        if self.link_delays:
            if shaper is not None:
                # refusing beats silently dropping one of them: before
                # the shared hook, link_delays ALWAYS applied
                raise ValueError(
                    "link_delays and a chaos shaper are mutually "
                    "exclusive — express the constant delays as "
                    "ShapedLink edges in the shaper's NetShape instead")
            from hbbft_tpu_torch.chaos.link import (
                LinkShaper, NetShape, ShapedLink,
            )

            shaper = LinkShaper(NetShape(edges={
                (our_id, peer): ShapedLink(delay_s=delay)
                for peer, delay in self.link_delays.items()
            }), seed=seed)
        self.shaper = shaper
        if shaper is not None:
            shaper.bind_registry(self.stats.registry)
        # the shaping clock: seconds since this transport was built —
        # preset partition windows are relative to node start
        self._chaos_t0 = time.monotonic()
        self._senders: Dict[NodeId, _PeerSender] = {}
        self._peer_ids_cache: Optional[List[NodeId]] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._inbound_tasks: set = set()
        self._stopping = False
        self.addr: Optional[Addr] = None
        # handshake authentication (module security model).  auth_sign
        # answers an acceptor's CHALLENGE with (era, signature) over the
        # transcript; auth_verify judges an inbound proof -> verdict in
        # {"ok", "stale", "bad_sig", "unknown_key"}.  Both are embedder
        # callbacks so the transport stays crypto-free; None keeps the
        # legacy identification-only handshake on that side.
        self.auth_sign = auth_sign
        self.auth_verify = auth_verify
        # half-open budget: connections past accept() but not yet past
        # the handshake.  The cap (with the per-frame MAX_HANDSHAKE_FRAME
        # byte cap and dead_after_s time cap) bounds what a SYN-and-stall
        # flood can pin, so the auth step can't become the flood target.
        self.max_half_open = int(max_half_open)
        self._half_open = 0
        # challenge nonces/session ids: seeded for deterministic tests
        self._auth_rng = random.Random(
            int.from_bytes(hashlib.sha3_256(
                b"hbbft-net-auth:%d:%s" % (seed, repr(our_id).encode())
            ).digest()[:8], "big"))

    def chaos_now(self) -> float:
        """The link-shaping clock (seconds since transport creation)."""
        return time.monotonic() - self._chaos_t0

    # -- lifecycle -----------------------------------------------------------

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        self._server = await asyncio.start_server(
            self._accept, host=host, port=port
        )
        sock = self._server.sockets[0]
        self.addr = sock.getsockname()[:2]
        return self.addr

    def add_peer(self, peer_id: NodeId, addr: Addr) -> None:
        if peer_id in self._senders:
            raise ValueError(f"peer {peer_id!r} already added")
        sender = _PeerSender(self, peer_id, addr)
        self._senders[peer_id] = sender
        self._peer_ids_cache = None
        sender.start()

    async def stop(self) -> None:
        self._stopping = True
        for sender in self._senders.values():
            await sender.stop()
        if self._server is not None:
            self._server.close()  # accept nothing more
        # cancel inbound handlers and wait RE-CANCELLING: on CPython 3.10
        # a cancel that lands exactly as a wait_for's inner read completes
        # is swallowed (bpo-42130) and the recv loop keeps running — one
        # plain gather here could then hang forever at in-process cluster
        # shutdown.  The loops also check _stopping so
        # a swallowed cancel exits at its next iteration either way.  Each
        # handler aborts its connection on the way out (see _accept).
        pending = {t for t in self._inbound_tasks if not t.done()}
        while pending:
            for task in pending:
                task.cancel()
            _done, pending = await asyncio.wait(pending, timeout=1.0)
        # Only now wait for the server: since Python 3.12.1 wait_closed()
        # returns once every accepted connection has dropped, so awaiting
        # it before the handlers above are gone never returns.  Bounded
        # all the same: a peer's half-closed socket must not hold a stop.
        if self._server is not None:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._server.wait_closed(),
                                       STOP_WAIT_S)

    # -- sending -------------------------------------------------------------

    def peer_ids(self) -> List[NodeId]:
        # called once per dispatched Step — cache the sorted list (peers
        # are only ever added via add_peer, which invalidates)
        if self._peer_ids_cache is None:
            self._peer_ids_cache = sorted(self._senders.keys(), key=repr)
        return self._peer_ids_cache

    def connected(self, peer_id: NodeId) -> bool:
        sender = self._senders.get(peer_id)
        return sender is not None and sender.connected.is_set()

    def queued(self, peer_id: NodeId) -> int:
        sender = self._senders.get(peer_id)
        return 0 if sender is None else len(sender.outbox)

    def send_backlog_s(self, peer_id: NodeId) -> float:
        """Seconds of bulk already committed to the shaped link toward
        ``peer_id``.  Shaped frames are delayed *before* they reach the
        outbox (``_PeerSender.send`` defers them via ``call_later``), so
        ``queued()`` never sees that backlog — the shaper's bandwidth
        clock is the only honest congestion signal.  Returns 0.0 when no
        shaper is attached (real deployments would read the socket send
        buffer instead)."""
        if self.shaper is None:
            return 0.0
        return self.shaper.backlog_s(self.our_id, peer_id, self.chaos_now())

    def send(self, peer_id: NodeId, payload: bytes) -> None:
        """Queue one consensus MSG frame for ``peer_id``."""
        self.send_frame(peer_id, framing.MSG, payload)

    def send_frame(self, peer_id: NodeId, kind: int, payload: bytes) -> None:
        sender = self._senders.get(peer_id)
        if sender is None:
            raise KeyError(f"unknown peer {peer_id!r}")
        sender.send(framing.encode_frame(kind, payload, self.max_frame))

    def send_payloads(self, peer_id: NodeId, payloads) -> None:
        """Queue many consensus payloads for ``peer_id``, coalesced into
        as few MSG/MSG_BATCH frames as the cap allows — the pump's
        per-iteration write path (:func:`framing.pack_msgs`)."""
        sender = self._senders.get(peer_id)
        if sender is None:
            raise KeyError(f"unknown peer {peer_id!r}")
        for frame in framing.pack_msgs(payloads, self.max_frame):
            sender.send(frame)

    def local_hello(self) -> Hello:
        era, epoch = self.hello_key()
        return Hello(node_id=self.our_id, role=ROLE_NODE,
                     cluster_id=self.cluster_id, era=era, epoch=epoch)

    # -- receiving -----------------------------------------------------------

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._inbound_tasks.add(task)
        set_nodelay(writer)
        try:
            await self._serve_inbound(reader, writer)
        except (
            OSError, FrameError, ValueError,
            asyncio.IncompleteReadError, asyncio.TimeoutError,
        ) as exc:
            # an inbound peer/client dying here is counted, never just
            # logged
            self.stats.inbound_drops += 1
            logger.debug("inbound connection dropped: %r", exc)
        finally:
            self._inbound_tasks.discard(task)
            if self._stopping:
                # stop(): drop unflushed output so the connection goes
                # now and the server's wait_closed() can return
                writer.transport.abort()
            else:
                writer.close()

    @staticmethod
    def _endpoint(writer: asyncio.StreamWriter) -> str:
        """The remote socket address as ``host:port`` — the attribution
        handle for refused handshakes (a spoofer's CLAIMED id must never
        be the ledger key)."""
        peer = writer.get_extra_info("peername")
        try:
            return f"{peer[0]}:{peer[1]}"
        # hblint: disable=fault-swallowed-drop (address formatting
        # fallback, no input dropped — the refusal this string labels
        # is itself counted at every call site)
        except (TypeError, IndexError):
            return "<unknown>"

    def _rand_bytes(self, n: int) -> bytes:
        return self._auth_rng.getrandbits(8 * n).to_bytes(n, "big")

    async def _serve_inbound(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        # half-open budget: the handshake phase is the only window where
        # an unproven endpoint holds a task/fd, so it is capped (count +
        # refuse past the cap), byte-capped (MAX_HANDSHAKE_FRAME per
        # frame), and time-capped (dead_after_s per read)
        self._half_open += 1
        try:
            if self._half_open > self.max_half_open:
                self.ingress.auth_fail(self._endpoint(writer), None,
                                       "half_open")
                raise FrameError("half-open handshake budget exhausted")
            hello, session = await self._inbound_handshake(reader, writer)
        finally:
            self._half_open -= 1
        if hello.role == ROLE_NODE:
            self._notify_hello(hello.node_id, hello, direction="accept")
            await self._node_recv_loop(hello.node_id, reader, writer,
                                       session)
        else:
            await self._client_recv_loop(hello, reader, writer)

    async def _inbound_handshake(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
    ) -> Tuple[Hello, Optional[bytes]]:
        """Read + judge one inbound hello; returns the hello and the
        issued session id (None on the legacy unauthenticated path).
        ORDER MATTERS: a node-role claim is challenged and VERIFIED
        before ``in_backoff``/``connection_accepted``/peer resolution
        run — a spoofer must not clear the impersonated victim's strike
        ladder, consume its backoff gate, or allocate any per-peer state."""
        hs_frame = min(self.max_frame, framing.MAX_HANDSHAKE_FRAME)
        kind, payload = await asyncio.wait_for(
            framing.read_one_frame(reader, hs_frame), self.dead_after_s
        )
        if kind != framing.HELLO:
            raise FrameError(f"first frame must be HELLO, got kind {kind}")
        hello = framing.decode_hello(payload)
        if hello.cluster_id != self.cluster_id:
            raise FrameError("cluster id mismatch")
        session: Optional[bytes] = None
        if hello.role == ROLE_NODE:
            if self.auth_verify is not None:
                session = await self._challenge(reader, writer, hello)
            if self.ingress.in_backoff(hello.node_id):
                # the counted disconnect's backoff window: a flooding
                # peer redialing immediately is refused until it expires
                raise FrameError(
                    f"guard backoff open for peer {hello.node_id!r}"
                )
            self.ingress.connection_accepted(hello.node_id)
        if hello.role == ROLE_NODE and hello.node_id not in self._senders:
            addr = (self.peer_resolver(hello.node_id)
                    if self.peer_resolver is not None else None)
            if addr is None:
                raise FrameError(
                    f"node hello from unknown peer {hello.node_id!r}"
                )
            self.stats.dynamic_peers += 1
            logger.info("accepting new cluster member %r at %r "
                        "(membership-resolved)", hello.node_id, addr)
            self.add_peer(hello.node_id, addr)
        reply = framing.encode_frame(
            framing.HELLO, framing.encode_hello(self.local_hello()),
            self.max_frame,
        )
        writer.write(reply)
        await writer.drain()
        self._record_send(hello.node_id, reply)
        return hello, session

    async def _challenge(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         hello: Hello) -> bytes:
        """Issue CHALLENGE, await AUTH, verify — every refusal path is
        counted under exactly one ``hbbft_guard_auth_failures_total``
        reason and attributed to the socket endpoint."""
        endpoint = self._endpoint(writer)
        claimed = hello.node_id
        nonce = self._rand_bytes(framing.NONCE_LEN)
        session = self._rand_bytes(framing.SESSION_LEN)
        challenge = framing.encode_frame(
            framing.CHALLENGE, framing.encode_challenge(nonce, session),
            self.max_frame,
        )
        writer.write(challenge)
        await writer.drain()
        self._record_send(claimed, challenge)
        try:
            kind, payload = await asyncio.wait_for(
                framing.read_one_frame(reader, framing.MAX_HANDSHAKE_FRAME),
                self.dead_after_s,
            )
        except asyncio.TimeoutError:
            self.ingress.auth_fail(endpoint, claimed, "timeout")
            raise
        except (FrameError, asyncio.IncompleteReadError):
            self.ingress.auth_fail(endpoint, claimed, "malformed")
            raise
        if kind != framing.AUTH:
            self.ingress.auth_fail(endpoint, claimed, "no_auth")
            raise FrameError(
                f"expected AUTH from {endpoint} claiming {claimed!r}, "
                f"got kind {kind}"
            )
        self._record_recv(claimed, kind, payload)
        try:
            era, sig = framing.decode_auth(payload)
        except FrameError:
            self.ingress.auth_fail(endpoint, claimed, "malformed")
            raise
        # the pairing check runs on the loop's executor: the loop keeps
        # serving heartbeats and other handshakes meanwhile, and several
        # runtimes of one process (each hello costs ~a pairing) verify in
        # parallel — the native pairing releases the interpreter lock
        verdict = await asyncio.get_running_loop().run_in_executor(
            None, self.auth_verify, claimed, hello.role, era, sig, nonce,
            session)
        if verdict == "ok":
            self.ingress.auth_ok()
        elif verdict == "stale":
            self.ingress.auth_stale(claimed)
        else:
            reason = (verdict if verdict in ("bad_sig", "unknown_key")
                      else "bad_sig")
            self.ingress.auth_fail(endpoint, claimed, reason)
            raise FrameError(
                f"handshake auth failed for {endpoint} claiming "
                f"{claimed!r}: {verdict}"
            )
        return session

    async def _idle_watchdog(self, writer: asyncio.StreamWriter,
                             state: list, idle_timeout: float) -> None:
        """Close ``writer`` once ``state[0]`` (last-data time) goes stale.

        One long-lived task per connection instead of an
        ``asyncio.wait_for`` per read: wait_for creates and cancels a
        Task + timer handle around EVERY chunk, which was a measurable
        slice of the per-epoch event-loop CPU.  Closing the transport
        unblocks the pending read (EOF/reset), and ``state[1]`` tells
        the recv loop the EOF was an idle kill so the drop accounting
        is unchanged."""
        while True:
            deadline = state[0] + idle_timeout
            now = time.monotonic()
            if now >= deadline:
                state[1] = True
                writer.close()
                return
            await asyncio.sleep(deadline - now + 0.05)

    async def _node_recv_loop(self, peer_id: NodeId,
                              reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter,
                              session: Optional[bytes] = None) -> None:
        decoder = FrameDecoder(self.max_frame)
        # a live dialer pings every heartbeat_s, so silence beyond the
        # dead-peer window means a half-open socket (peer power-loss,
        # partition): time the read out or this task and its fd would
        # leak forever — the dialer side re-dials with a fresh connection
        idle_timeout = self.dead_after_s * 2 + 1.0
        state = [time.monotonic(), False]
        watchdog = asyncio.get_running_loop().create_task(
            self._idle_watchdog(writer, state, idle_timeout)
        )
        try:
            tr = writer.transport
            if hasattr(tr, "set_protocol"):
                await self._node_recv_proto(peer_id, reader, writer, tr,
                                            decoder, state, session)
            else:
                # non-socket transports (test doubles) keep the
                # stream-reader loop
                await self._node_recv_inner(peer_id, reader, writer,
                                            decoder, state, session)
        finally:
            watchdog.cancel()

    async def _node_recv_proto(self, peer_id: NodeId,
                               reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               tr: asyncio.BaseTransport,
                               decoder: FrameDecoder, state: list,
                               session: Optional[bytes]) -> None:
        """Steady-state node receive via a raw asyncio protocol.

        After the (stream-based, cold-path) handshake the connection is
        upgraded in place with ``set_protocol``: chunks then arrive as
        direct ``data_received`` callbacks — no StreamReader buffer
        append + task wakeup + 64 KiB ``read()`` future round-trip per
        chunk, which was a measurable slice of per-epoch loop CPU.
        Bytes the StreamReader already buffered are drained into the
        protocol first (no await between the buffer grab and the
        protocol swap, so no chunk can interleave)."""
        worker = None
        if self.ingress_workers and self.on_peer_batch is not None:
            from hbbft_tpu_torch.net.ingress import PeerIngressWorker

            worker = PeerIngressWorker(self, peer_id, writer, session)
        proto = _NodeRecvProtocol(self, peer_id, writer, decoder,
                                  state, session, worker)
        if worker is not None:
            worker.bind(proto)
        leftover = bytes(reader._buffer)
        del reader._buffer[:]
        tr.set_protocol(proto)
        proto.connection_made(tr)
        if hasattr(tr, "is_reading") and not tr.is_reading():
            # the StreamReader's flow control may have paused the socket
            # with its buffer full; the new protocol owns pausing now
            tr.resume_reading()
        if leftover:
            proto.data_received(leftover)
        try:
            await proto.done
        finally:
            if worker is not None:
                worker.stop()

    async def _node_recv_inner(self, peer_id: NodeId,
                               reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               decoder: FrameDecoder, state: list,
                               session: Optional[bytes] = None) -> None:
        timing = getattr(self, "timing", None)
        # always-on recv segment observer (the runtime wires the
        # hbbft_pump_segment_seconds "recv" child here); one observe per
        # socket chunk, a perf_counter pair of overhead
        seg_recv = getattr(self, "seg_recv", None)
        guard = self.ingress
        while not self._stopping:
            data = await reader.read(65536)
            if not data:
                if state[1]:
                    raise asyncio.TimeoutError(
                        f"peer {peer_id!r} recv idle timeout")
                return
            state[0] = time.monotonic()
            if timing is None and seg_recv is None:
                self._recv_chunk(peer_id, writer, decoder, data,
                                 session=session)
            else:
                w0 = time.perf_counter()
                t0 = time.thread_time() if timing is not None else 0.0
                self._recv_chunk(peer_id, writer, decoder, data,
                                 session=session)
                if timing is not None:
                    timing["recv"] = (
                        timing.get("recv", 0.0)
                        + (time.thread_time() - t0))
                    timing["n_recv"] = timing.get("n_recv", 0) + 1
                if seg_recv is not None:
                    seg_recv(time.perf_counter() - w0)
            # ingress budget: over-budget peers pause the read (the TCP
            # window closes → real backpressure); sustained violation or
            # a runtime-reported garbage stream tears the connection
            # down with a counted backoff
            delay = guard.charge(peer_id, len(data))
            if guard.kill_pending(peer_id):
                raise FrameError(
                    f"ingress budget exceeded by peer {peer_id!r}"
                )
            if delay > 0:
                await asyncio.sleep(delay)
                state[0] = time.monotonic()  # a throttle is not idleness
            # in-flight cap ENFORCEMENT: stop reading until the pump
            # retires this peer's admitted frames — each wait cycle is
            # a counted strike, so a wedged consumer (or a flood the
            # pump cannot keep up with) escalates to the disconnect
            # ladder instead of waiting forever
            while guard.inflight_over(peer_id):
                delay = guard.charge(peer_id, 0)
                if guard.kill_pending(peer_id):
                    raise FrameError(
                        f"in-flight frame cap exceeded by peer "
                        f"{peer_id!r}"
                    )
                await asyncio.sleep(delay if delay > 0 else 0.05)
                state[0] = time.monotonic()

    def _recv_chunk(self, peer_id: NodeId, writer: asyncio.StreamWriter,
                    decoder: FrameDecoder, data: bytes, *,
                    session: Optional[bytes] = None) -> None:
        """One chunk of the node recv path — synchronous on purpose: the
        PONG reply is written without an awaited drain (a 15-byte reply
        to a rare heartbeat; asyncio flushes it on the next loop pass),
        which keeps the whole per-chunk path free of coroutine hops.

        With ``on_peer_batch`` set, every consensus payload decoded from
        this chunk is admitted and delivered as ONE list (one ingress
        lock round, one runtime callback, one pump enqueue) — the
        batch-handle fast path.  Without it, the legacy per-message
        ``on_peer_message`` callback fires per payload (raw-transport
        tests and embedders rely on that shape)."""
        frames = decoder.feed(data)
        # per-frame recv accounting only when a trace or cost model is
        # attached (they need kind + per-frame granularity); the plain
        # path batches the two counter bumps for the whole chunk
        heavy = self.trace is not None or self.cost_model is not None
        batch: Optional[List[Any]] = (
            [] if self.on_peer_batch is not None else None)
        nbytes = 0
        for kind, payload in frames:
            if heavy:
                self._record_recv(peer_id, kind, payload)
            else:
                nbytes += len(payload) + 5
            if kind == framing.PING:
                if session is not None and (
                        len(payload) != framing.SESSION_LEN + 8
                        or payload[:framing.SESSION_LEN] != session):
                    # an authenticated stream's heartbeat must carry the
                    # session id issued at the handshake: a mismatch is
                    # a hijacked/confused stream — refuse it loudly
                    self.ingress.auth_fail(self._endpoint(writer),
                                           peer_id, "session")
                    raise FrameError(
                        f"heartbeat with wrong session id on "
                        f"authenticated stream from {peer_id!r}"
                    )
                pong = framing.encode_frame(
                    framing.PONG, payload, self.max_frame
                )
                writer.write(pong)
                self._record_send(peer_id, pong)
            elif kind == framing.MSG:
                if batch is not None:
                    batch.append(payload)
                elif self.on_peer_message is not None:
                    self.ingress.frame_admitted(peer_id)
                    self.on_peer_message(peer_id, payload)
            elif kind == framing.MSG_BATCH:
                if batch is not None:
                    batch.extend(framing.split_msgs(payload))
                elif self.on_peer_message is not None:
                    for sub in framing.split_msgs(payload):
                        self.ingress.frame_admitted(peer_id)
                        self.on_peer_message(peer_id, sub)
            else:
                raise FrameError(
                    f"unexpected frame kind {kind} from node "
                    f"{peer_id!r}"
                )
        if not heavy and frames:
            self.stats.frame_recv_batch(len(frames), nbytes)
        if batch:
            self.ingress.frame_admitted(peer_id, len(batch))
            self.on_peer_batch(peer_id, batch)

    async def _client_recv_loop(self, hello: Hello,
                                reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        conn = ClientConn(hello, writer, self.max_frame,
                          record_send=self._record_send, stats=self.stats)
        decoder = FrameDecoder(self.max_frame)
        # clients keep-alive every ~10 s (ClusterClient); longer silence
        # is a half-open socket — reclaim the task/fd (idle watchdog, not
        # a per-read wait_for: see _idle_watchdog)
        state = [time.monotonic(), False]
        watchdog = asyncio.get_running_loop().create_task(
            self._idle_watchdog(writer, state, self.client_idle_timeout_s)
        )
        try:
            while not self._stopping:
                data = await reader.read(65536)
                if not data:
                    if state[1]:
                        raise asyncio.TimeoutError(
                            f"client {hello.node_id!r} recv idle timeout")
                    return
                state[0] = time.monotonic()
                frames = decoder.feed(data)
                if len(frames) > 1:
                    # one reply syscall per CHUNK: a submit wave's acks
                    # coalesce instead of hitting the socket per tx
                    conn.begin_batch()
                for kind, payload in frames:
                    self._record_recv(hello.node_id, kind, payload)
                    if kind == framing.PING:
                        conn.send(framing.PONG, payload)
                    elif kind == framing.CHALLENGE:
                        # a state-sync fetcher verifying this DONOR: sign
                        # its challenge with our current era key (clients
                        # stay identification-only; this authenticates
                        # the NODE side of the client connection)
                        if self.auth_sign is None:
                            raise FrameError(
                                "client challenged this node but it has "
                                "no signer (auth disabled?)"
                            )
                        nonce, csession = framing.decode_challenge(payload)
                        era, sig = self.auth_sign(self.cluster_id,
                                                  nonce, csession)
                        conn.send(framing.AUTH,
                                  framing.encode_auth(era, sig))
                    elif self.on_client_frame is not None:
                        self.on_client_frame(conn, kind, payload)
                conn.flush_batch()
        finally:
            watchdog.cancel()
            conn.closed = True
            if self.on_client_gone is not None:
                self.on_client_gone(conn)

    # -- accounting ----------------------------------------------------------

    def _notify_hello(self, peer_id: NodeId, hello: Hello,
                      direction: str) -> None:
        if self.on_peer_hello is not None:
            self.on_peer_hello(peer_id, hello, direction)

    def _record_send(self, peer_id: NodeId, frame: bytes) -> None:
        self.stats.frame_sent(len(frame))
        if self.trace is not None:
            from hbbft_tpu_torch.sim.trace import NetEvent

            self.trace.record_net(NetEvent(
                direction="send", peer=peer_id,
                kind=framing.KIND_NAMES.get(frame[4], str(frame[4])),
                wire_bytes=len(frame), t_mono=time.monotonic(),
            ))

    def _record_recv(self, peer_id: NodeId, kind: int,
                     payload: bytes) -> None:
        nbytes = len(payload) + 5
        self.stats.frame_recv(nbytes)
        if self.cost_model is not None:
            self.stats.virtual_cost_s += self.cost_model.charge(nbytes)
        if self.trace is not None:
            from hbbft_tpu_torch.sim.trace import NetEvent

            self.trace.record_net(NetEvent(
                direction="recv", peer=peer_id,
                kind=framing.KIND_NAMES.get(kind, str(kind)),
                wire_bytes=nbytes, t_mono=time.monotonic(),
            ))
