"""Canonical byte codec: contributions, committed batches, protocol messages.

The port's copy of the JAX package's ``protocols/wire.py`` (the reference
uses ``bincode``+serde at this boundary; this is an explicit deterministic
tag-length-value codec): the ``Reader``, the framing helpers, node ids, the
crypto objects that DKG and vote messages carry, ``batch_bytes`` (the
ledger digest's canonical batch bytes) and the message registry
(``encode_message`` / ``decode_message``) of every object-mode message:
broadcast, binary agreement, threshold sign and decrypt, subset, HoneyBadger,
DynamicHoneyBadger, the sender queue, VID, and the flight-recorder,
per-transaction trace, health, performance and state-sync records of
``obs/`` and ``net/statesync.py``.

Node ids are restricted to ints and strings on the wire.
"""

from __future__ import annotations

import struct
from typing import Hashable, Optional

from hbbft_tpu_torch.crypto import tc

NodeId = Hashable

# Decode-side size cap: a length prefix is attacker-controlled bytes, and
# without a cap one forged u32 makes the reader attempt a 4 GiB allocation.
# A DKG Part carries a 97·(t+1)²-byte bivariate commitment, which crosses
# 8 MiB around N ≈ 880; it is resolved at call time, so assigning
# ``wire.MAX_BLOB_BYTES`` raises it.
MAX_BLOB_BYTES = 8 * 2**20
MAX_MESSAGE_BYTES = MAX_BLOB_BYTES + 4096


class Reader:
    __slots__ = ("data", "pos", "max_blob", "_depth")

    def __init__(self, data: bytes, max_blob: Optional[int] = None):
        self.data = data
        self.pos = 0
        # resolved at call time so deployments can raise the module knob
        self.max_blob = MAX_BLOB_BYTES if max_blob is None else max_blob
        self._depth = 0

    def take(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(f"negative read of {n} bytes")
        if self.pos + n > len(self.data):
            raise ValueError(
                f"truncated: need {n} bytes at offset {self.pos}, "
                f"have {len(self.data) - self.pos}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        # unpack_from avoids the take() slice copy — u32/u64 run several
        # times per decoded message on the runtime's hot path
        pos = self.pos
        if pos + 4 > len(self.data):
            raise ValueError(
                f"truncated: need 4 bytes at offset {pos}, "
                f"have {len(self.data) - pos}"
            )
        self.pos = pos + 4
        return struct.unpack_from(">I", self.data, pos)[0]

    def u64(self) -> int:
        pos = self.pos
        if pos + 8 > len(self.data):
            raise ValueError(
                f"truncated: need 8 bytes at offset {pos}, "
                f"have {len(self.data) - pos}"
            )
        self.pos = pos + 8
        return struct.unpack_from(">Q", self.data, pos)[0]

    def blob(self) -> bytes:
        n = self.u32()
        if n > self.max_blob:
            raise ValueError(
                f"blob length {n} exceeds cap {self.max_blob}"
            )
        return self.take(n)

    def f64(self) -> float:
        return struct.unpack(">d", self.take(8))[0]

    def done(self) -> bool:
        return self.pos == len(self.data)


def blob(b) -> bytes:
    # join (not +) so memoryview values — the zero-copy RBC proof slices —
    # encode without a bytes() conversion at every call site
    return b"".join((struct.pack(">I", len(b)), b))


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def u64(v: int) -> bytes:
    return struct.pack(">Q", v)


def f64(v: float) -> bytes:
    """IEEE-754 big-endian double — byte-deterministic for a given float
    value."""
    return struct.pack(">d", v)


# -- node ids ---------------------------------------------------------------


def node_id(nid: NodeId) -> bytes:
    if isinstance(nid, bool) or not isinstance(nid, (int, str)):
        raise TypeError(f"wire node ids must be int or str, got {nid!r}")
    if isinstance(nid, int):
        return b"\x01" + struct.pack(">q", nid)
    enc = nid.encode()
    return b"\x02" + blob(enc)


def read_node_id(r: Reader) -> NodeId:
    tag = r.take(1)
    if tag == b"\x01":
        return struct.unpack(">q", r.take(8))[0]
    if tag == b"\x02":
        return r.blob().decode()
    raise ValueError("bad node id tag")


# -- crypto objects ---------------------------------------------------------


def ciphertext(ct: tc.Ciphertext) -> bytes:
    return blob(ct.to_bytes())


def read_ciphertext(r: Reader) -> tc.Ciphertext:
    return tc.Ciphertext.from_bytes(r.blob())


def signature(sig: tc.Signature) -> bytes:
    return blob(sig.to_bytes())


def read_signature(r: Reader) -> tc.Signature:
    return tc.Signature.from_bytes(r.blob())


def commitment_bivar(com: tc.BivarCommitment) -> bytes:
    from hbbft_tpu_torch.crypto import bls12_381 as bls

    out = u32(com.degree())
    for row in com.points:
        for p in row:
            out += bls.g1_to_bytes(p)
    return out


def read_commitment_bivar(r: Reader) -> tc.BivarCommitment:
    from hbbft_tpu_torch.crypto import bls12_381 as bls

    degree = r.u32()
    if degree > 1024:
        raise ValueError("absurd commitment degree")
    pts = [
        [bls.g1_from_bytes(r.take(97)) for _ in range(degree + 1)]
        for _ in range(degree + 1)
    ]
    return tc.BivarCommitment(degree, pts)


# -- committed batches -------------------------------------------------------
#
# The canonical bytes every ledger-digest chain folds over: two drivers
# that fold these produce the SAME chain for the same batch sequence.


def _change_state_bytes(cs) -> bytes:
    """The batch's validator-set change decision is consensus output too —
    a fork in DKG/membership state must show in the ledger digest."""
    out = blob(cs.state.encode())
    out += cs.change.to_bytes() if cs.change is not None else b"\x00"
    return out


def batch_bytes(b) -> bytes:
    """Canonical bytes of a committed batch for the ledger digest chain."""
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
    from hbbft_tpu_torch.protocols.honey_badger import Batch as HbBatch
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch
    from hbbft_tpu_torch.protocols.vid import VidQhbBatch

    if isinstance(b, QhbBatch):
        out = b"qhb" + u64(b.era) + u64(b.epoch)
        for proposer, txs in b.contributions:
            out += node_id(proposer) + u32(len(txs))
            for tx in txs:
                out += blob(tx)
        return out + _change_state_bytes(b.change)
    if isinstance(b, VidQhbBatch):
        # VID mode folds the ORDERED commitments, not the retrieved
        # transactions: the digest chain stays a pure ordering artifact,
        # so nodes at different retrieval depths still share a prefix
        out = b"vqhb" + u64(b.era) + u64(b.epoch)
        for proposer, payload in b.contributions:
            out += node_id(proposer) + blob(payload)
        return out + _change_state_bytes(b.change)
    if isinstance(b, DhbBatch):
        out = b"dhb" + u64(b.era) + u64(b.epoch)
        for proposer, payload in b.contributions:
            out += node_id(proposer) + blob(payload)
        return out + _change_state_bytes(b.change)
    if isinstance(b, HbBatch):
        out = b"hb" + u64(b.epoch)
        for proposer, payload in b.contributions:
            out += node_id(proposer) + blob(payload)
        return out
    raise TypeError(f"unknown batch type {type(b).__name__}")


# ===========================================================================
# Full protocol-message wire format
# ===========================================================================
#
# The reference serializes EVERY message with serde/bincode; this is the
# equivalent explicit codec: ``encode_message``/``decode_message`` cover the
# complete message surface of the stack (RBC, ABA, threshold sign/decrypt,
# subset and honey-badger wrappers, DHB era messages, sender-queue framing,
# VID).  Deterministic and self-delimiting.

_MSG_TAGS = {}
_MSG_DECODERS = {}


def _register(tag: int, cls, enc, dec):
    _MSG_TAGS[cls] = (tag, enc)
    _MSG_DECODERS[tag] = dec


def encode_message(msg) -> bytes:
    """Any protocol message object → canonical bytes."""
    _lazy_register()
    try:
        tag, enc = _MSG_TAGS[type(msg)]
    except KeyError:
        raise TypeError(f"no wire encoding for {type(msg).__name__}")
    return bytes([tag]) + enc(msg)


def decode_message(data: bytes, max_bytes: Optional[int] = None,
                   max_blob: Optional[int] = None):
    """Canonical bytes → message object.  ``max_blob`` overrides the
    Reader's per-blob cap (a caller whose payloads are already
    length-bounded may pass ``len(data)``)."""
    _lazy_register()
    if max_bytes is None:
        max_bytes = MAX_MESSAGE_BYTES
    if len(data) > max_bytes:
        raise ValueError(
            f"message of {len(data)} bytes exceeds cap {max_bytes}"
        )
    r = Reader(data, max_blob=max_blob)
    msg = _read_message(r)
    if not r.done():
        raise ValueError("trailing bytes after message")
    return msg


_MAX_NESTING = 8


def _read_message(r: Reader):
    # hand-inlined tag read + explicit depth bookkeeping (no try/finally,
    # no getattr): this function runs once per nesting level of every
    # message on the runtime's hot path.  On a decode error the Reader is
    # abandoned whole, so the depth only needs restoring on success.
    depth = r._depth
    if depth >= _MAX_NESTING:
        raise ValueError("message nesting too deep")
    pos = r.pos
    data = r.data
    if pos >= len(data):
        raise ValueError(f"truncated: need 1 byte at offset {pos}, have 0")
    tag = data[pos]
    r.pos = pos + 1
    dec = _MSG_DECODERS.get(tag)
    if dec is None:
        raise ValueError(f"unknown message tag 0x{tag:02x}")
    r._depth = depth + 1
    msg = dec(r)
    r._depth = depth
    return msg


def _lazy_register():
    """Message classes live across protocol modules that import this one —
    register on first use to avoid import cycles."""
    if _MSG_TAGS:
        return
    from hbbft_tpu_torch.ops.merkle import Proof
    from hbbft_tpu_torch.protocols.binary_agreement import (
        AuxMsg, BValMsg, ConfMsg, CoinMsg, TermMsg,
    )
    from hbbft_tpu_torch.protocols.broadcast import (
        CanDecodeMsg, EchoHashMsg, EchoMsg, ReadyMsg, ValueMsg,
    )
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
        HbWrap, KeyGenWrap, SignedKeyGenMsg,
    )
    from hbbft_tpu_torch.protocols.honey_badger import (
        DecryptionShareWrap, SubsetWrap,
    )
    from hbbft_tpu_torch.protocols.sender_queue import AlgoMessage, EpochStarted
    from hbbft_tpu_torch.protocols.subset import AgreementWrap, BroadcastWrap
    from hbbft_tpu_torch.protocols.threshold_decrypt import DecryptionMessage
    from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSignMessage

    def boolb(v: bool) -> bytes:
        return b"\x01" if v else b"\x00"

    def read_bool(r: Reader) -> bool:
        b = r.take(1)
        if b not in (b"\x00", b"\x01"):
            raise ValueError("bad bool")
        return b == b"\x01"

    def proof_bytes(p: Proof) -> bytes:
        out = blob(p.value) + u32(p.index) + p.root_hash + u32(len(p.path))
        for digest, on_left in p.path:
            out += digest + (b"\x01" if on_left else b"\x00")
        return out

    def read_proof(r: Reader) -> Proof:
        value = r.blob()
        index = r.u32()
        root = r.take(32)
        n = r.u32()
        if n > 64:
            raise ValueError("absurd proof depth")
        path = tuple((r.take(32), read_bool(r)) for _ in range(n))
        return Proof(value=value, index=index, root_hash=root, path=path)

    def boolset_byte(s) -> bytes:
        return bytes([(False in s) | ((True in s) << 1)])

    def read_boolset(r: Reader):
        b = r.take(1)[0]
        if b > 3:
            raise ValueError("bad boolset")
        out = set()
        if b & 1:
            out.add(False)
        if b & 2:
            out.add(True)
        return frozenset(out)

    # RBC ------------------------------------------------------------------
    _register(0x10, ValueMsg,
              lambda m: proof_bytes(m.proof),
              lambda r: ValueMsg(read_proof(r)))
    _register(0x11, EchoMsg,
              lambda m: proof_bytes(m.proof),
              lambda r: EchoMsg(read_proof(r)))
    _register(0x12, ReadyMsg,
              lambda m: m.root,
              lambda r: ReadyMsg(r.take(32)))
    _register(0x13, EchoHashMsg,
              lambda m: m.root,
              lambda r: EchoHashMsg(r.take(32)))
    _register(0x14, CanDecodeMsg,
              lambda m: m.root,
              lambda r: CanDecodeMsg(r.take(32)))
    # ABA ------------------------------------------------------------------
    _register(0x20, BValMsg,
              lambda m: u64(m.epoch) + boolb(m.value),
              lambda r: BValMsg(r.u64(), read_bool(r)))
    _register(0x21, AuxMsg,
              lambda m: u64(m.epoch) + boolb(m.value),
              lambda r: AuxMsg(r.u64(), read_bool(r)))
    _register(0x22, ConfMsg,
              lambda m: u64(m.epoch) + boolset_byte(m.values),
              lambda r: ConfMsg(r.u64(), read_boolset(r)))
    _register(0x23, TermMsg,
              lambda m: boolb(m.value),
              lambda r: TermMsg(read_bool(r)))
    _register(0x24, CoinMsg,
              lambda m: u64(m.epoch) + encode_message(m.msg),
              lambda r: CoinMsg(r.u64(), _read_message(r)))
    # threshold primitives --------------------------------------------------
    _register(0x30, ThresholdSignMessage,
              lambda m: blob(m.share.to_bytes()),
              lambda r: ThresholdSignMessage(
                  tc.SignatureShare.from_bytes(r.blob())))
    _register(0x31, DecryptionMessage,
              lambda m: blob(m.share.to_bytes()),
              lambda r: DecryptionMessage(
                  tc.DecryptionShare.from_bytes(r.blob())))
    # subset ----------------------------------------------------------------
    _register(0x40, BroadcastWrap,
              lambda m: node_id(m.proposer_id) + encode_message(m.msg),
              lambda r: BroadcastWrap(read_node_id(r), _read_message(r)))
    _register(0x41, AgreementWrap,
              lambda m: node_id(m.proposer_id) + encode_message(m.msg),
              lambda r: AgreementWrap(read_node_id(r), _read_message(r)))
    # honey badger ----------------------------------------------------------
    _register(0x50, SubsetWrap,
              lambda m: u64(m.epoch) + encode_message(m.msg),
              lambda r: SubsetWrap(r.u64(), _read_message(r)))
    _register(0x51, DecryptionShareWrap,
              lambda m: (u64(m.epoch) + node_id(m.proposer_id)
                         + encode_message(m.msg)),
              lambda r: DecryptionShareWrap(
                  r.u64(), read_node_id(r), _read_message(r)))
    # dynamic honey badger --------------------------------------------------
    def enc_skg(m: SignedKeyGenMsg) -> bytes:
        kind = b"\x01" if m.kind == "part" else b"\x02"
        return (u64(m.era) + node_id(m.sender) + kind + blob(m.payload)
                + signature(m.sig))

    def dec_skg(r: Reader) -> SignedKeyGenMsg:
        era = r.u64()
        sender = read_node_id(r)
        kb = r.take(1)
        if kb == b"\x01":
            kind = "part"
        elif kb == b"\x02":
            kind = "ack"
        else:
            raise ValueError("bad keygen kind")
        payload = r.blob()
        sig = read_signature(r)
        return SignedKeyGenMsg(era, sender, kind, payload, sig)

    _register(0x60, HbWrap,
              lambda m: u64(m.era) + encode_message(m.msg),
              lambda r: HbWrap(r.u64(), _read_message(r)))
    _register(0x61, KeyGenWrap,
              lambda m: u64(m.era) + enc_skg(m.msg),
              lambda r: KeyGenWrap(r.u64(), dec_skg(r)))
    # sender queue ----------------------------------------------------------
    _register(0x70, EpochStarted,
              lambda m: u64(m.key[0]) + u64(m.key[1]),
              lambda r: EpochStarted((r.u64(), r.u64())))
    _register(0x71, AlgoMessage,
              lambda m: encode_message(m.msg),
              lambda r: AlgoMessage(_read_message(r)))
    # flight-recorder journal records ---------------------------------------
    # Registered like any other message, so the journal format gets the
    # registry's tag uniqueness and codec round trip for free.
    from hbbft_tpu_torch.obs.flight import (
        FlightCommit, FlightFault, FlightHello, FlightMsg, FlightNote,
        FlightSpan,
    )

    def s(text: str) -> bytes:
        return blob(text.encode())

    def rs(r: Reader) -> str:
        return r.blob().decode()

    _register(0x80, FlightHello,
              lambda m: (s(m.node) + s(m.flavor) + u32(m.incarnation)
                         + u64(m.seq) + f64(m.t)),
              lambda r: FlightHello(rs(r), rs(r), r.u32(), r.u64(),
                                    r.f64()))
    _register(0x81, FlightMsg,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.direction)
                         + s(m.peer) + u64(m.era) + u64(m.epoch)
                         + s(m.mtype) + blob(m.payload)),
              lambda r: FlightMsg(r.u64(), r.f64(), rs(r), rs(r),
                                  r.u64(), r.u64(), rs(r), r.blob()))
    _register(0x82, FlightCommit,
              lambda m: (u64(m.seq) + f64(m.t) + u64(m.era)
                         + u64(m.epoch) + u64(m.index) + blob(m.digest)),
              lambda r: FlightCommit(r.u64(), r.f64(), r.u64(), r.u64(),
                                     r.u64(), r.blob()))
    _register(0x83, FlightFault,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.node) + s(m.kind)
                         + u64(m.era) + u64(m.epoch)),
              lambda r: FlightFault(r.u64(), r.f64(), rs(r), rs(r),
                                    r.u64(), r.u64()))
    _register(0x84, FlightSpan,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.name) + u64(m.era)
                         + u64(m.epoch)
                         + u64(0 if m.round is None else m.round + 1)
                         + f64(m.t_start) + f64(m.t_end) + u64(m.count)),
              lambda r: FlightSpan(r.u64(), r.f64(), rs(r), r.u64(),
                                   r.u64(), (lambda v: v - 1 if v else
                                             None)(r.u64()),
                                   r.f64(), r.f64(), r.u64()))
    _register(0x85, FlightNote,
              lambda m: u64(m.seq) + f64(m.t) + s(m.kind) + s(m.detail),
              lambda r: FlightNote(r.u64(), r.f64(), rs(r), rs(r)))
    # snapshot state-sync records (net/statesync.py) --------------------------
    # Carried in framing.SYNC frames on client-role connections.
    from hbbft_tpu_torch.net.statesync import (
        SyncChunk, SyncChunkReq, SyncManifest, SyncManifestReq, SyncNack,
    )

    def rd32(r: Reader) -> bytes:
        return r.take(32)

    _register(0x90, SyncManifestReq,
              lambda m: b"",
              lambda r: SyncManifestReq())
    _register(0x91, SyncManifest,
              lambda m: (u64(m.era) + u64(m.chain_len) + m.chain_head
                         + m.image_sha3 + u64(m.image_len)
                         + u32(m.chunk_bytes) + u32(m.n_chunks)),
              lambda r: SyncManifest(r.u64(), r.u64(), rd32(r), rd32(r),
                                     r.u64(), r.u32(), r.u32()))
    _register(0x92, SyncChunkReq,
              lambda m: m.image_sha3 + u32(m.index),
              lambda r: SyncChunkReq(rd32(r), r.u32()))
    _register(0x93, SyncChunk,
              lambda m: (m.image_sha3 + u32(m.index) + u32(m.crc)
                         + blob(m.data)),
              lambda r: SyncChunk(rd32(r), r.u32(), r.u32(), r.blob()))
    _register(0x94, SyncNack,
              lambda m: s(m.reason),
              lambda r: SyncNack(rs(r)))
    # verifiable information dispersal (protocols/vid.py) --------------------
    from hbbft_tpu_torch.protocols.vid import (
        VidCert, VidDisperse, VidRetrieve, VidShard, VidVote,
    )

    def rt32(r: Reader) -> bytes:
        return r.take(32)

    def enc_cert(m: VidCert) -> bytes:
        out = (u64(m.era) + m.root + u64(m.total_len)
               + u32(len(m.votes)))
        for nid, sig in m.votes:
            out += node_id(nid) + signature(sig)
        return out

    def dec_cert(r: Reader) -> VidCert:
        era = r.u64()
        root = rt32(r)
        total_len = r.u64()
        n = r.u32()
        if n > 4096:
            raise ValueError("absurd vote count")
        votes = tuple(
            (read_node_id(r), read_signature(r)) for _ in range(n)
        )
        return VidCert(era, root, total_len, votes)

    _register(0xA0, VidDisperse,
              lambda m: (u64(m.era) + m.root + u64(m.total_len)
                         + proof_bytes(m.proof)),
              lambda r: VidDisperse(r.u64(), rt32(r), r.u64(),
                                    read_proof(r)))
    _register(0xA1, VidVote,
              lambda m: u64(m.era) + m.root + signature(m.sig),
              lambda r: VidVote(r.u64(), rt32(r), read_signature(r)))
    _register(0xA2, VidCert, enc_cert, dec_cert)
    _register(0xA3, VidRetrieve,
              lambda m: m.root,
              lambda r: VidRetrieve(rt32(r)))
    _register(0xA4, VidShard,
              lambda m: (m.root + u64(m.total_len)
                         + proof_bytes(m.proof)),
              lambda r: VidShard(rt32(r), r.u64(), read_proof(r)))
    # per-tx causal trace record (obs/trace.py) ------------------------------
    from hbbft_tpu_torch.obs.trace import FlightTrace

    _register(0x95, FlightTrace,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.stage) + u64(m.era)
                         + u64(m.epoch) + u32(m.hop) + s(m.detail)
                         + blob(m.tids)),
              lambda r: FlightTrace(r.u64(), r.f64(), rs(r), r.u64(),
                                    r.u64(), r.u32(), rs(r), r.blob()))
    # live health plane incident record (obs/flight.py, emitted by
    # obs/watch.py and the runtime's local health hooks) ---------------------
    from hbbft_tpu_torch.obs.flight import HealthIncident

    _register(0x96, HealthIncident,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.source) + s(m.kind)
                         + s(m.severity) + s(m.subject) + s(m.key)
                         + s(m.detail)),
              lambda r: HealthIncident(r.u64(), r.f64(), rs(r), rs(r),
                                       rs(r), rs(r), rs(r), rs(r)))
    # performance-plane sampling window (obs/flight.py, emitted by
    # obs/perf.py through the flight recorder) -------------------------------
    from hbbft_tpu_torch.obs.flight import PerfSnapshot

    _register(0x97, PerfSnapshot,
              lambda m: (u64(m.seq) + f64(m.t) + s(m.source)
                         + f64(m.window_s) + f64(m.cpu_frac)
                         + f64(m.headroom) + s(m.doc)),
              lambda r: PerfSnapshot(r.u64(), r.f64(), rs(r), r.f64(),
                                     r.f64(), r.f64(), rs(r)))


def ensure_registered():
    _lazy_register()
