"""Canonical byte codec for what rides inside a contribution.

A copy of the first part of the JAX package's ``protocols/wire.py``: the
``Reader``, the framing helpers, node ids and the crypto objects that DKG
and vote messages carry, with imports re-pointed at the port's ``crypto``.
The full message registry (object-mode messages) is not ported.

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


class Reader:
    __slots__ = ("data", "pos", "max_blob")

    def __init__(self, data: bytes, max_blob: Optional[int] = None):
        self.data = data
        self.pos = 0
        # resolved at call time so deployments can raise the module knob
        self.max_blob = MAX_BLOB_BYTES if max_blob is None else max_blob

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
