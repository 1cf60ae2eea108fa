"""Length-prefixed frames over the wire codec, plus the versioned hello.

The sans-I/O stack speaks :mod:`hbbft_tpu_torch.protocols.wire` message bytes;
this module wraps those bytes (and the small set of runtime control
payloads) into self-delimiting TCP frames:

    u32 length | u8 kind | payload            (length = 1 + len(payload))

Every decode path is capped: a frame claiming more than ``max_frame`` bytes
is a loud :class:`FrameError` before any allocation happens, and a cut
stream simply stays pending — :class:`FrameDecoder` never yields a partial
frame.  The first frame on every connection must be a :data:`HELLO` whose
payload carries magic, protocol version, the sender's role and id, its
current (era, epoch), and the cluster id; any mismatch kills the
connection before a single protocol message is parsed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Hashable, List, Tuple

from hbbft_tpu_torch.protocols import wire

MAGIC = b"HBTN"
# v2: MSG_BATCH coalesced consensus frames (epoch-pipelined runtime).
# v3: authenticated node-role handshake (CHALLENGE/AUTH) — a node hello
# is now *proven* with a per-era key signature, not merely claimed.
# The hello's version check turns a mixed-version cluster into a clean
# handshake error instead of mid-stream frame-kind surprises.
PROTOCOL_VERSION = 3

# Frame cap: one frame carries at most one wire message (itself capped at
# wire.MAX_MESSAGE_BYTES) plus the kind byte; the hello/control frames are
# tiny.  Kept as a parameter everywhere so tests can shrink it.
DEFAULT_MAX_FRAME = wire.MAX_MESSAGE_BYTES + 1

# -- frame kinds -------------------------------------------------------------

HELLO = 0x01       # versioned handshake; first frame both ways
MSG = 0x02         # consensus payload: wire.encode_message bytes
PING = 0x03        # heartbeat, u64 nonce
PONG = 0x04        # heartbeat echo
TX = 0x05          # client → node: raw transaction bytes
TX_ACK = 0x06      # node → client: u8 status + 32-byte tx digest
TX_COMMIT = 0x07   # node → client: era/epoch + committed tx digests
STATUS_REQ = 0x08  # client → node: empty
STATUS = 0x09      # node → client: JSON status document
MSG_BATCH = 0x0A   # several MSG payloads coalesced into one frame
SYNC = 0x0B        # snapshot state-sync record (net/statesync.py), both
                   # directions on a client-role connection; payload is
                   # wire.encode_message bytes of a Sync* record
CHALLENGE = 0x0C   # verifier → prover: random nonce + session id the
                   # prover must sign (node-role handshake; also sent by
                   # a statesync joiner to authenticate its donor)
AUTH = 0x0D        # prover → verifier: u64 era + blob(signature) over
                   # auth_transcript(...) by the prover's per-era key

KIND_NAMES = {
    HELLO: "HELLO", MSG: "MSG", PING: "PING", PONG: "PONG", TX: "TX",
    TX_ACK: "TX_ACK", TX_COMMIT: "TX_COMMIT", STATUS_REQ: "STATUS_REQ",
    STATUS: "STATUS", MSG_BATCH: "MSG_BATCH", SYNC: "SYNC",
    CHALLENGE: "CHALLENGE", AUTH: "AUTH",
}

# TX_ACK status bytes
ACK_ACCEPTED = 0
ACK_DUPLICATE = 1
ACK_FULL = 2       # backpressure: retry later
ACK_REJECTED = 3   # oversized: never retry
ACK_SHED = 4       # push notification: a previously-ACCEPTED tx was
                   # shed under fair-admission pressure and will not
                   # commit — re-submit if still wanted

ROLE_NODE = 0x01
ROLE_CLIENT = 0x02

# -- authenticated handshake (v3) --------------------------------------------
#
# The node-role hello is identification; the CHALLENGE/AUTH exchange is
# authentication.  The verifier issues a random nonce + session id; the
# prover signs auth_transcript(...) — which binds the cluster id, the
# nonce, the session, and the hello header material (claimed id, role,
# era) — with its per-era secret key.  The session id is then bound into
# every subsequent heartbeat PING on the connection, so a hijacked TCP
# stream cannot ride an already-authenticated session.  All handshake
# frames fit under MAX_HANDSHAKE_FRAME: the half-open byte budget — a
# dialer cannot make the verifier buffer a large frame before it proves
# anything.

#: byte budget for any single pre-auth handshake frame (hello /
#: challenge / auth); generous for every legitimate encoding, tiny
#: against the transport's MiB-scale steady-state frame cap
MAX_HANDSHAKE_FRAME = 4096

NONCE_LEN = 32     # server-issued random challenge nonce
SESSION_LEN = 8    # per-connection session id, echoed in heartbeats


class FrameError(ValueError):
    """Malformed, oversized, or protocol-violating frame data."""


def encode_frame(kind: int, payload: bytes,
                 max_frame: int = DEFAULT_MAX_FRAME) -> bytes:
    body_len = 1 + len(payload)
    if body_len > max_frame:
        raise FrameError(
            f"frame of {body_len} bytes exceeds cap {max_frame}"
        )
    return struct.pack(">IB", body_len, kind) + payload


class FrameDecoder:
    """Incremental frame parser: ``feed`` bytes, get complete frames.

    Holds at most one partial frame; enforces the size cap on the *claimed*
    length, so a hostile 4 GiB prefix is rejected before buffering."""

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self.max_frame = max_frame
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        frames: List[Tuple[int, bytes]] = []
        while True:
            if len(self._buf) < 4:
                return frames
            (body_len,) = struct.unpack_from(">I", self._buf, 0)
            if body_len < 1:
                raise FrameError("zero-length frame body")
            if body_len > self.max_frame:
                raise FrameError(
                    f"frame of {body_len} bytes exceeds cap {self.max_frame}"
                )
            if len(self._buf) < 4 + body_len:
                return frames
            kind = self._buf[4]
            payload = bytes(self._buf[5 : 4 + body_len])
            del self._buf[: 4 + body_len]
            frames.append((kind, payload))

    def pending(self) -> int:
        """Bytes buffered awaiting a complete frame."""
        return len(self._buf)


def pack_msgs(payloads: List[bytes],
              max_frame: int = DEFAULT_MAX_FRAME) -> List[bytes]:
    """Coalesce consensus message payloads into as few frames as the cap
    allows: one plain :data:`MSG` frame for a lone payload, otherwise
    :data:`MSG_BATCH` frames whose body is ``(u32 len | payload)*``.

    This is the per-(pump-iteration, destination) write path of the
    epoch-pipelined runtime — it turns dozens of per-message socket
    writes into one or two — and it is order-preserving.  A payload that
    cannot fit even alone raises :class:`FrameError` (callers pre-check
    against the cap and drop loudly)."""
    frames: List[bytes] = []
    group: List[bytes] = []
    size = 1  # kind byte

    def flush() -> None:
        if not group:
            return
        if len(group) == 1:
            frames.append(encode_frame(MSG, group[0], max_frame))
        else:
            body = b"".join(
                struct.pack(">I", len(p)) + p for p in group
            )
            frames.append(encode_frame(MSG_BATCH, body, max_frame))
        group.clear()

    for p in payloads:
        if 1 + len(p) > max_frame:
            raise FrameError(
                f"message of {len(p)} bytes exceeds frame cap {max_frame}"
            )
        if group and size + 4 + len(p) > max_frame:
            flush()
            size = 1
        group.append(p)
        size += 4 + len(p)
    flush()
    return frames


def split_msgs(payload: bytes) -> List[bytes]:
    """Inverse of the :data:`MSG_BATCH` body encoding; truncation or
    trailing garbage is a loud :class:`FrameError` (the sender is
    malformed, not merely slow)."""
    out: List[bytes] = []
    off = 0
    n = len(payload)
    while off < n:
        if off + 4 > n:
            raise FrameError("truncated MSG_BATCH length prefix")
        (length,) = struct.unpack_from(">I", payload, off)
        off += 4
        if off + length > n:
            raise FrameError("truncated MSG_BATCH entry")
        out.append(payload[off : off + length])
        off += length
    if not out:
        raise FrameError("empty MSG_BATCH frame")
    return out


async def read_one_frame(reader, max_frame: int = DEFAULT_MAX_FRAME
                         ) -> Tuple[int, bytes]:
    """Read exactly one frame from an ``asyncio.StreamReader`` — the
    handshake-time sibling of :class:`FrameDecoder` (used before a
    connection's steady-state decode loop starts)."""
    header = await reader.readexactly(4)
    (body_len,) = struct.unpack(">I", header)
    if body_len < 1 or body_len > max_frame:
        raise FrameError(
            f"frame of {body_len} bytes outside (0, {max_frame}]"
        )
    body = await reader.readexactly(body_len)
    return body[0], body[1:]


def auth_transcript(cluster_id: bytes, nonce: bytes, session: bytes,
                    node_id, role: int, era: int) -> bytes:
    """The exact bytes an authenticating peer signs: domain tag, cluster
    id, the verifier's random nonce + session id, and the hello header
    material (claimed node id, role, the era whose key signs).  Both
    sides derive it independently — nothing signature-relevant ever
    travels only one way."""
    if len(nonce) != NONCE_LEN or len(session) != SESSION_LEN:
        raise FrameError("bad challenge nonce/session length")
    return (
        b"hbbft-auth/3"
        + wire.blob(cluster_id)
        + nonce
        + session
        + wire.node_id(node_id)
        + bytes([role])
        + wire.u64(era)
    )


def encode_challenge(nonce: bytes, session: bytes) -> bytes:
    if len(nonce) != NONCE_LEN or len(session) != SESSION_LEN:
        raise FrameError("bad challenge nonce/session length")
    return nonce + session


def decode_challenge(payload: bytes) -> Tuple[bytes, bytes]:
    if len(payload) != NONCE_LEN + SESSION_LEN:
        raise FrameError(
            f"challenge payload of {len(payload)} bytes "
            f"(want {NONCE_LEN + SESSION_LEN})"
        )
    return payload[:NONCE_LEN], payload[NONCE_LEN:]


def encode_auth(era: int, sig: bytes) -> bytes:
    return wire.u64(era) + wire.blob(sig)


def decode_auth(payload: bytes) -> Tuple[int, bytes]:
    r = wire.Reader(payload)
    try:
        era = r.u64()
        sig = r.blob()
        if not r.done():
            raise FrameError("trailing bytes after auth record")
    except ValueError as exc:
        if isinstance(exc, FrameError):
            raise
        raise FrameError(f"malformed auth record: {exc}") from exc
    return era, sig


async def client_hello_handshake(
    addr, cluster_id: bytes, client_id, *,
    timeout_s: float, max_frame: int = DEFAULT_MAX_FRAME,
    verify_node=None, challenge_rng=None,
):
    """Dial ``addr``, perform the client-role HELLO exchange, and return
    ``(reader, writer, node_hello)`` — the one handshake shared by every
    client-side connection (``ClusterClient``, the state-sync joiner).
    Raises :class:`FrameError` on a non-HELLO reply or cluster-id
    mismatch; timeouts/connection errors propagate.

    ``verify_node`` authenticates the NODE to the client (the statesync
    joiner's donor check): a callable ``(node_id, era, sig, transcript)
    -> bool``.  When given, the client issues a CHALLENGE after the hello
    exchange and the node must answer a valid AUTH signed by its per-era
    key — an impersonated donor fails loudly here, before a single sync
    byte is trusted.  ``challenge_rng`` (a ``random.Random``) seeds the
    nonce for deterministic tests; default is OS entropy."""
    import asyncio
    import os

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(*addr), timeout_s
    )
    try:
        hello = Hello(node_id=client_id, role=ROLE_CLIENT,
                      cluster_id=cluster_id, era=0, epoch=0)
        writer.write(encode_frame(HELLO, encode_hello(hello), max_frame))
        await writer.drain()
        kind, payload = await asyncio.wait_for(
            read_one_frame(reader, max_frame), timeout_s
        )
        if kind != HELLO:
            raise FrameError("node did not answer with HELLO")
        node_hello = decode_hello(payload)
        if node_hello.cluster_id != cluster_id:
            raise FrameError("cluster id mismatch")
        if verify_node is not None:
            if challenge_rng is not None:
                blob = challenge_rng.randbytes(NONCE_LEN + SESSION_LEN)
            else:
                blob = os.urandom(NONCE_LEN + SESSION_LEN)
            nonce, session = blob[:NONCE_LEN], blob[NONCE_LEN:]
            writer.write(encode_frame(
                CHALLENGE, encode_challenge(nonce, session), max_frame))
            await writer.drain()
            kind, payload = await asyncio.wait_for(
                read_one_frame(reader, MAX_HANDSHAKE_FRAME), timeout_s
            )
            if kind != AUTH:
                raise FrameError("node did not answer the challenge")
            era, sig = decode_auth(payload)
            transcript = auth_transcript(
                cluster_id, nonce, session,
                node_hello.node_id, ROLE_NODE, era)
            if not verify_node(node_hello.node_id, era, sig, transcript):
                raise FrameError(
                    f"node {node_hello.node_id!r} failed the donor "
                    f"authentication challenge"
                )
    except BaseException:
        writer.close()
        raise
    return reader, writer, node_hello


# -- hello -------------------------------------------------------------------


@dataclass(frozen=True)
class Hello:
    node_id: Hashable           # node id, or a client token string
    role: int                   # ROLE_NODE | ROLE_CLIENT
    cluster_id: bytes           # must match on both ends
    era: int                    # sender's current (era, epoch) — the
    epoch: int                  # SenderQueue resume key

    @property
    def key(self) -> Tuple[int, int]:
        return (self.era, self.epoch)


def encode_hello(h: Hello) -> bytes:
    if h.role not in (ROLE_NODE, ROLE_CLIENT):
        raise FrameError(f"bad hello role {h.role}")
    return (
        MAGIC
        + wire.u32(PROTOCOL_VERSION)
        + bytes([h.role])
        + wire.node_id(h.node_id)
        + wire.u64(h.era)
        + wire.u64(h.epoch)
        + wire.blob(h.cluster_id)
    )


def decode_hello(payload: bytes) -> Hello:
    r = wire.Reader(payload)
    try:
        if r.take(4) != MAGIC:
            raise FrameError("bad hello magic")
        version = r.u32()
        if version != PROTOCOL_VERSION:
            raise FrameError(
                f"hello version mismatch: peer speaks {version}, "
                f"we speak {PROTOCOL_VERSION}"
            )
        role = r.take(1)[0]
        if role not in (ROLE_NODE, ROLE_CLIENT):
            raise FrameError(f"bad hello role {role}")
        node_id = wire.read_node_id(r)
        era = r.u64()
        epoch = r.u64()
        cluster_id = r.blob()
        if not r.done():
            raise FrameError("trailing bytes after hello")
    except ValueError as exc:  # wire truncation/caps → FrameError
        if isinstance(exc, FrameError):
            raise
        raise FrameError(f"malformed hello: {exc}") from exc
    return Hello(node_id=node_id, role=role, cluster_id=cluster_id,
                 era=era, epoch=epoch)
