"""Checkpoint / resume / state-sync snapshots.

The reference has no crash-restart persistence; its closest analogs are
``JoinPlan`` (era-boundary join state, mirrored in
``protocols/dynamic_honey_badger.py``) and the fact that every algorithm is
a serializable value.  This module makes that explicit in three forms:

- object mode: any ``ConsensusProtocol`` is a pure-Python state machine, so
  ``snapshot``/``restore`` pickle it whole (the sans-I/O design means no
  sockets/threads/fds can leak into the image).  Snapshots taken at the
  same crank are byte-identical — a determinism check in itself — and so
  is a restored machine's own snapshot.
- batched mode: the dense state dicts of :mod:`hbbft_tpu_torch.parallel` are
  tensors (on any device) or arrays; ``save_arrays``/``load_arrays``
  round-trip them through an ``.npz`` (snapshotting a whole network's
  epoch is one array dump).
- **state-sync mode** (the production join path): a :class:`JoinSnapshot`
  is everything a node with NO history needs to participate from an era
  boundary — the era's :class:`~hbbft_tpu_torch.protocols.dynamic_honey_badger.
  JoinPlan` (validator set, threshold public key set, encryption
  schedule), the consensus-committed **DKG transcript** of the rotation
  that created the era, and the ledger-digest-chain position at the
  boundary ``(chain_head, chain_len)``.  Replaying the transcript through
  the joiner's own :class:`~hbbft_tpu_torch.protocols.sync_key_gen.SyncKeyGen`
  decrypts the rows addressed to it and yields its **secret key share**
  (:func:`derive_secret_share`) — so a brand-new validator is
  share-complete from epoch 0 of the new era with zero epoch replay.
  The reference's ``net.statesync`` moves these images over the wire; the
  port has no transfer layer yet.

Trust model: the snapshot is only as good as its source.  The transfer
layer cross-checks the manifest (era, image digest, chain head/length)
across multiple donors before fetching, every transcript signature is
re-verified against the plan's own key map, and the replayed DKG must
regenerate the plan's exact public key set — a donor cannot hand a joiner
a key set the committed DKG did not produce without forging BLS
signatures or breaking the Pedersen commitments.

The port's copy of the JAX package's module.  A pickled port stack holds no
CUDA tensor (its coders pickle as their shape, ``torch.device`` as its
name), so a snapshot taken on the card restores on a host without one.
``derive_secret_share`` and ``build_joiner`` take the ``device`` the DKG's
commitment checks and the joiner's stack run on (default ``"cuda"``,
raising without a card).
"""

from __future__ import annotations

import io
import pickle
import random
from dataclasses import dataclass
from typing import Any, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.protocols import wire

NodeId = Hashable


def snapshot(algorithm: Any) -> bytes:
    """Serialize a protocol state machine (HoneyBadger, DHB, QHB, …).

    The image is canonical: a machine restored from it snapshots to the
    same bytes.  A plain pickle is not, in either package: restoring one
    can change which equal strings (a dataclass's field names) share one
    object, so the first restore's pickle differs by a few bytes and later
    ones do not.  The image is therefore the pickle of the machine's
    restored copy."""
    image = pickle.dumps(algorithm, protocol=pickle.HIGHEST_PROTOCOL)
    return pickle.dumps(pickle.loads(image), protocol=pickle.HIGHEST_PROTOCOL)


def restore(data: bytes) -> Any:
    """Inverse of :func:`snapshot` — returns a live state machine that
    continues exactly where the original stood."""
    return pickle.loads(data)


def _host_array(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_arrays(state: Dict[str, Any]) -> bytes:
    """Batched-mode state dict (str → tensor on any device / array /
    scalar) → npz bytes, the same bytes as the reference's for equal
    arrays."""
    buf = io.BytesIO()
    np.savez(buf, **{k: _host_array(v) for k, v in state.items()})
    return buf.getvalue()


def load_arrays(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


# ===========================================================================
# State-sync join snapshots
# ===========================================================================


@dataclass(frozen=True)
class JoinSnapshot:
    """Era-boundary state for a node joining with zero history.

    Captured by a running node the moment a DKG rotation completes (the
    only instant ``DynamicHoneyBadger.join_plan()`` is valid) and served
    over the reference's ``net.statesync``.  ``transcript`` is empty for
    encryption-schedule rotations — the era inherits the previous key
    material, so a rejoining config-derived validator falls back to its
    config share (see :func:`derive_secret_share`).
    """

    era: int
    pub_key_set_bytes: bytes
    pub_keys: Tuple[Tuple[NodeId, bytes], ...]
    encryption_schedule: Tuple[str, int, int]
    transcript: Tuple[Any, ...]          # SignedKeyGenMsg, committed order
    chain_head: bytes                    # ledger digest at the boundary
    chain_len: int                       # digest chain length at the boundary

    def plan(self):
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import JoinPlan

        return JoinPlan(
            era=self.era,
            pub_key_set_bytes=self.pub_key_set_bytes,
            pub_keys=self.pub_keys,
            encryption_schedule=self.encryption_schedule,
        )


def capture_join_snapshot(dhb, chain_head: bytes,
                          chain_len: int) -> JoinSnapshot:
    """Package a freshly-rotated DHB's boundary state.  Only valid while
    no epoch of the new era has completed (``join_plan()`` raises
    otherwise)."""
    plan = dhb.join_plan()
    return JoinSnapshot(
        era=plan.era,
        pub_key_set_bytes=plan.pub_key_set_bytes,
        pub_keys=plan.pub_keys,
        encryption_schedule=plan.encryption_schedule,
        transcript=tuple(dhb.last_join_transcript),
        chain_head=bytes(chain_head),
        chain_len=int(chain_len),
    )


def encode_join_snapshot(snap: JoinSnapshot) -> bytes:
    """Canonical image bytes (what the chunked transfer moves)."""
    out = b"HBSNAP1" + wire.u64(snap.era)
    out += wire.blob(snap.pub_key_set_bytes)
    out += wire.u32(len(snap.pub_keys))
    for nid, pk in snap.pub_keys:
        out += wire.node_id(nid) + wire.blob(pk)
    kind, a, b = snap.encryption_schedule
    out += wire.blob(kind.encode()) + wire.u32(a) + wire.u32(b)
    out += wire.u32(len(snap.transcript))
    for skg in snap.transcript:
        out += wire.blob(skg.to_bytes())
    out += wire.blob(snap.chain_head) + wire.u64(snap.chain_len)
    return out


def decode_join_snapshot(data: bytes) -> JoinSnapshot:
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import SignedKeyGenMsg

    r = wire.Reader(data, max_blob=len(data))
    if r.take(7) != b"HBSNAP1":
        raise ValueError("bad join-snapshot magic")
    era = r.u64()
    pks_bytes = r.blob()
    n = r.u32()
    if n > 100_000:
        raise ValueError("absurd validator count")
    pub_keys = tuple((wire.read_node_id(r), r.blob()) for _ in range(n))
    kind = r.blob().decode()
    a, b = r.u32(), r.u32()
    nt = r.u32()
    if nt > 1_000_000:
        raise ValueError("absurd transcript length")
    transcript = tuple(
        SignedKeyGenMsg.read(wire.Reader(r.blob())) for _ in range(nt)
    )
    head = r.blob()
    if len(head) != 32:
        raise ValueError("bad chain head length")
    chain_len = r.u64()
    if not r.done():
        raise ValueError("trailing bytes after join snapshot")
    return JoinSnapshot(era, pks_bytes, pub_keys, (kind, a, b),
                        transcript, head, chain_len)


def derive_secret_share(
    snap: JoinSnapshot,
    our_id: NodeId,
    secret_key: tc.SecretKey,
    config_netinfo: Any = None,
    device="cuda",
) -> Optional[tc.SecretKeyShare]:
    """This node's threshold secret key share for ``snap.era``.

    With a DKG transcript: replay every committed, signature-valid
    key-gen message through a fresh ``SyncKeyGen`` (decrypting the rows
    encrypted to ``secret_key``), demand the regenerated public key set
    match the plan byte-for-byte, and return the derived share.  Without
    one (encryption-schedule rotations inherit the old keys): fall back
    to ``config_netinfo``'s share when its public key set matches the
    plan.  Returns ``None`` when no share can be derived — the node
    joins as an observer, exactly the reference JoinPlan semantics.

    CPU-heavy (BLS decryption + commitment checks): call it from sync
    code, never from an event-loop coroutine.  ``device`` is where the
    ``SyncKeyGen``'s commitment checks run.
    """
    plan = snap.plan()
    if not snap.transcript:
        if config_netinfo is not None and (
            config_netinfo.public_key_set().commitment.to_bytes()
            == snap.pub_key_set_bytes
        ):
            return config_netinfo.secret_key_share()
        return None
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import de_ack, de_part
    from hbbft_tpu_torch.protocols.sync_key_gen import SyncKeyGen

    keys = plan.key_map()
    threshold = (len(keys) - 1) // 3
    kg = SyncKeyGen(our_id, secret_key, keys, threshold, random.Random(0),
                    device=device)
    dkg_era = snap.era - 1
    for skg in snap.transcript:
        if skg.era != dkg_era:
            continue
        pk = keys.get(skg.sender)
        if pk is None or not pk.verify(skg.sig, skg.signed_payload()):
            # a removed validator's committed message, or donor tampering:
            # the validators' SyncKeyGen rejected it without mutating, so
            # skipping reproduces their state
            continue
        try:
            if skg.kind == "part":
                kg.handle_part(skg.sender, de_part(skg.payload))
            elif skg.kind == "ack":
                kg.handle_ack(skg.sender, de_ack(skg.payload))
        except ValueError:
            continue
    if not kg.is_ready():
        raise ValueError(
            "join-snapshot DKG transcript does not complete — stale or "
            "tampered snapshot"
        )
    pub_key_set, share = kg.generate()
    if pub_key_set.commitment.to_bytes() != snap.pub_key_set_bytes:
        raise ValueError(
            "replayed DKG transcript yields a different public key set "
            "than the join plan claims — tampered snapshot"
        )
    return share


def build_joiner(
    snap: JoinSnapshot,
    our_id: NodeId,
    secret_key: tc.SecretKey,
    *,
    batch_size: int = 8,
    rng_seed: int = 0,
    config_netinfo: Any = None,
    device="cuda",
):
    """A ``SenderQueue(QHB(DHB))`` stack activated at ``snap``'s era
    boundary — the standard node stack, built from a snapshot instead of
    genesis config.  Returns the wrapped stack; the caller hosts it (a
    ``NodeRuntime`` with ``ledger_seed=(snap.chain_head, snap.chain_len)``
    continues the digest chain from the boundary).  The stack runs on
    ``device``."""
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.queueing_honey_badger import (
        QueueingHoneyBadger,
    )
    from hbbft_tpu_torch.protocols.sender_queue import SenderQueue

    share = derive_secret_share(snap, our_id, secret_key,
                                config_netinfo=config_netinfo, device=device)
    dhb = DynamicHoneyBadger.from_join_plan(
        our_id, secret_key, snap.plan(),
        rng=random.Random(rng_seed), secret_key_share=share, device=device,
    )
    qhb = QueueingHoneyBadger(
        dhb, batch_size=batch_size, rng=random.Random(rng_seed + 1)
    )
    return SenderQueue(qhb)
