"""Lazy retrieval for dispersed payloads: fetch k shards, reconstruct.

The second half of :mod:`hbbft_tpu_torch.protocols.vid`: once an epoch orders a
``(root, cert)`` commitment, the node runtime asks the holders of the
shards it is missing — targeted, one :class:`~hbbft_tpu_torch.protocols.vid.VidRetrieve`
per missing index, escalating to broadcast only on late retry rounds —
collects proof-valid :class:`~hbbft_tpu_torch.protocols.vid.VidShard` replies, and
reconstructs the payload through the RS coder's LRU'd Gauss–Jordan
pattern caches the moment ``k = n − 2f`` distinct shards are in hand.
The reconstruction is re-encoded and re-rooted against the committed
commitment before anything is surfaced — a Byzantine proposer's
non-codeword dispersal fails this check for EVERY shard subset, so all
correct retrievers agree the contribution is empty and fault the
proposer.

Everything here is clock-free (``now`` is an explicit parameter): the
runtime supplies its clock and drives :meth:`RetrieveService.tick` for
retries and timeouts.

Serving is budgeted per peer: a token bucket of shard bytes per second
(the retrieve-side sibling of the transport's ``IngressBudget``) bounds
how hard one peer can milk the shard store; over-budget requests are
dropped, counted, and reported through ``on_note`` so the guard/audit
pipeline sees the incident.  Retrieves for roots this node never stored
are *refused loudly* the same way — counted plus a ``vid_refusal`` note
— instead of faulting the requester, because a faster peer legitimately
retrieves an epoch the local node has not finished receiving dispersals
for (the requester simply retries).

The port's copy of the JAX package's module.  A ``RetrieveService``
reconstructs on the ``device`` its caller names (default ``"cuda"``,
raising without a card): under ``HBBFT_ERASURE_BACKEND=device`` the
decode's products run there.  ``ShardStore`` holds proofs only.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.ops import rs
from hbbft_tpu_torch.ops.merkle import MerkleTree, Proof
from hbbft_tpu_torch.protocols.broadcast import _unframe_value
from hbbft_tpu_torch.protocols.vid import VidRetrieve, VidShard
from hbbft_tpu_torch.traits import Step

NodeId = Hashable

#: default shard-store byte budget — a few epochs of MB-scale dispersals
DEFAULT_STORE_BYTES = 64 * 2**20

#: per-stored-root bookkeeping overhead charged on top of the shard bytes
#: (root key, proof path digests, dict slots) so a flood of tiny shards
#: cannot grow the store unbounded under a pure payload-byte cap
_ROOT_OVERHEAD = 128


class ShardStore:
    """Bounded LRU of (root → our shard + proof), byte-capped.

    One entry per root: a node holds exactly its OWN shard of each
    dispersal (the proposer included).  ``put`` refreshes recency and
    evicts the oldest roots once the byte budget is exceeded; eviction is
    whole-root, counted.  Memoryview proof values (the proposer's
    zero-copy slices of the full shard buffer) are materialized on entry
    — retaining the view would pin the entire n-shard allocation."""

    def __init__(self, max_bytes: int = DEFAULT_STORE_BYTES):
        self.max_bytes = int(max_bytes)
        self._roots: "OrderedDict[bytes, Tuple[int, Proof]]" = OrderedDict()
        self.bytes = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._roots)

    @staticmethod
    def _cost(proof: Proof) -> int:
        return len(proof.value) + 33 * len(proof.path) + _ROOT_OVERHEAD

    def put(self, root: bytes, total_len: int, proof: Proof) -> None:
        if root in self._roots:
            self._roots.move_to_end(root)
            return
        if isinstance(proof.value, memoryview):
            proof = Proof(value=bytes(proof.value), index=proof.index,
                          root_hash=proof.root_hash, path=proof.path)
        self._roots[root] = (total_len, proof)
        self.bytes += self._cost(proof)
        while self.bytes > self.max_bytes and len(self._roots) > 1:
            _, (_, old) = self._roots.popitem(last=False)
            self.bytes -= self._cost(old)
            self.evictions += 1

    def proof_for(self, root: bytes) -> Optional[Tuple[int, Proof]]:
        """(total_len, proof) for ``root``, refreshing recency."""
        entry = self._roots.get(root)
        if entry is not None:
            self._roots.move_to_end(root)
        return entry

    def known(self, root: bytes) -> bool:
        return root in self._roots


@dataclass(frozen=True)
class RetrievedPayload:
    """Step output of a finished retrieval.  ``payload is None`` means the
    retrieval failed — reconstruction mismatched the committed root
    (proposer fault, already logged) or every round timed out."""

    root: bytes
    proposer: Any
    payload: Optional[bytes]
    total_len: int
    shards_bad: int
    rounds: int
    t_ordered: float


@dataclass
class _Retrieval:
    n: int
    f: int
    total_len: int
    proposer: Any
    t_ordered: float
    deadline: float
    shards: Dict[int, bytes] = field(default_factory=dict)
    shard_len: int = -1
    bad: int = 0
    rounds: int = 0
    #: validator ids in shard-index order (holders[i] stores shard i);
    #: empty = unknown mapping, fall back to broadcast retrieves
    holders: Tuple[Any, ...] = ()
    cursor: int = 0
    #: False while queued behind the in-flight cap: no requests sent, no
    #: retry rounds burned — promoted FIFO as active retrievals finish
    active: bool = False


class RetrieveService:
    """Fetch/reconstruct driver state for one node.

    Methods return :class:`~hbbft_tpu_torch.traits.Step`\\ s (messages to peers,
    fault evidence, :class:`RetrievedPayload` outputs) that the runtime
    absorbs exactly like protocol steps.  All counters are plain ints,
    snapshotted into the ``hbbft_vid_*`` metric family by the runtime.
    ``device`` is where reconstruction runs under the ``device`` erasure
    backend.
    """

    def __init__(self, our_id: NodeId, store: ShardStore, *,
                 serve_bytes_per_s: float = 8 * 2**20,
                 serve_burst_bytes: float = 4 * 2**20,
                 retry_s: float = 0.5,
                 max_rounds: int = 8,
                 max_inflight: int = 2,
                 on_note: Optional[Callable[[str, str], None]] = None,
                 device="cuda"):
        self.our_id = our_id
        self.device = resolve_device(device)
        self.store = store
        self.serve_bytes_per_s = float(serve_bytes_per_s)
        self.serve_burst_bytes = float(serve_burst_bytes)
        self.retry_s = float(retry_s)
        self.max_rounds = int(max_rounds)
        # Retrieval is deliberately BACKGROUND work: payloads are fetched
        # with whatever capacity ordering leaves over.  Only this many
        # retrievals request shards concurrently; the rest queue FIFO.
        # Unbounded retrieval (0 = no cap) is exactly how a
        # bandwidth-starved node buries its own consensus traffic — every
        # committed root pulls k shards of bulk through the same links
        # that carry the tiny ordering frames.
        self.max_inflight = int(max_inflight)
        self.on_note = on_note
        self._pending: Dict[bytes, _Retrieval] = {}
        self._quota: Dict[NodeId, Tuple[float, float]] = {}
        # deterministic counters
        self.retrieves = 0          # retrievals started
        self.retrieved = 0          # payloads reconstructed + verified
        self.served = 0             # shards served to peers
        self.refusals = 0           # retrieves for roots we never stored
        self.quota_drops = 0        # retrieves dropped by the serve budget
        self.shards_bad = 0         # donor shards failing their proof
        self.mismatches = 0         # reconstructions not matching the root
        self.retries = 0            # retry rounds sent
        self.failures = 0           # retrievals exhausted without payload
        self.stray_shards = 0       # shards for nothing pending

    def _note(self, kind: str, detail: str) -> None:
        if self.on_note is not None:
            self.on_note(kind, detail)

    def pending_count(self) -> int:
        return len(self._pending)

    def next_deadline(self) -> Optional[float]:
        due = [p.deadline for p in self._pending.values() if p.active]
        return min(due) if due else None

    # -- requester side ------------------------------------------------------

    def start(self, root: bytes, total_len: int, n: int, f: int,
              proposer: Any, now: float, t_ordered: float,
              holders: Tuple[Any, ...] = ()) -> Step:
        """Open a retrieval for a committed commitment: seed it with our
        own stored shard and fetch the rest.

        With ``holders`` (validator ids in shard-index order — node ``i``
        stores shard ``i``) the request is TARGETED: only the
        ``k − already_held`` missing shards are asked for, one specific
        holder each, starting at a root-derived offset so the donor load
        spreads across the cluster.  A broadcast retrieve would make every
        peer ship its shard — ``n − 1`` responses where ``k − 1`` suffice
        — which is exactly the redundant bulk that buries a
        bandwidth-starved node's links (the ``bandwidth-asym`` shape).
        Un-answered rounds walk to the next holder via :meth:`tick`, and
        round ``≥ 2`` escalates to broadcast, so liveness never depends
        on the targeting.  Without ``holders`` every round broadcasts."""
        if root in self._pending:
            return Step()
        ret = _Retrieval(n=n, f=f, total_len=total_len, proposer=proposer,
                         t_ordered=t_ordered, deadline=float("inf"),
                         holders=tuple(holders),
                         cursor=root[0] if root else 0)
        self._pending[root] = ret
        self.retrieves += 1
        own = self.store.proof_for(root)
        if own is not None:
            _len, proof = own
            ret.shards[proof.index] = bytes(proof.value)
            ret.shard_len = len(proof.value)
        done = self._try_reconstruct(root, ret)
        if done is not None:
            done.extend(self._activate(now))
            return done
        return self._activate(now)

    def _activate(self, now: float) -> Step:
        """Promote queued retrievals into the in-flight window (FIFO,
        insertion order = commit order) and send their first request
        round.  With ``max_inflight <= 0`` everything activates."""
        step = Step()
        cap = self.max_inflight
        active = sum(1 for p in self._pending.values() if p.active)
        for root, ret in self._pending.items():
            if cap > 0 and active >= cap:
                break
            if ret.active:
                continue
            ret.active = True
            ret.deadline = now + self.retry_s
            active += 1
            step.extend(self._request_step(root, ret))
        return step

    def _request_step(self, root: bytes, ret: _Retrieval) -> Step:
        """One round of shard requests: targeted while the holder map is
        known and the round is young, broadcast otherwise."""
        step = Step()
        if ret.holders and ret.rounds < 2:
            k = rs.for_n_f(ret.n, ret.f).data_shards
            need = k - len(ret.shards)
            targets = self._pick_targets(ret, need)
            if len(targets) >= need:
                for h in targets:
                    step.send_to(h, VidRetrieve(root))
                return step
        return step.send_all(VidRetrieve(root))

    def _pick_targets(self, ret: _Retrieval, need: int) -> List[Any]:
        """The next ``need`` holders of shards we don't have, walking the
        index ring from the retrieval's cursor (deterministic)."""
        out: List[Any] = []
        if need <= 0 or not ret.holders:
            return out
        n = len(ret.holders)
        for _ in range(n):
            i = ret.cursor % n
            ret.cursor += 1
            if i in ret.shards or ret.holders[i] == self.our_id:
                continue
            out.append(ret.holders[i])
            if len(out) >= need:
                break
        return out

    def handle_shard(self, peer: NodeId, msg: VidShard, now: float) -> Step:
        ret = self._pending.get(msg.root)
        if ret is None:
            self.stray_shards += 1
            return Step()
        p = msg.proof
        if p.index in ret.shards:
            return Step()  # duplicate donor — benign
        ok = (
            0 <= p.index < ret.n
            and p.root_hash == msg.root
            and (ret.shard_len < 0 or len(p.value) == ret.shard_len)
            and p.validate(ret.n)
        )
        if not ok:
            ret.bad += 1
            self.shards_bad += 1
            self._note("vid_bad_shard",
                       f"peer={peer!r} root={msg.root.hex()[:24]}")
            return Step.from_fault(peer, FaultKind.VidShardProofInvalid)
        ret.shards[p.index] = bytes(p.value)
        if ret.shard_len < 0:
            ret.shard_len = len(p.value)
        done = self._try_reconstruct(msg.root, ret)
        if done is None:
            return Step()
        return done.extend(self._activate(now))

    def _try_reconstruct(self, root: bytes, ret: _Retrieval
                         ) -> Optional[Step]:
        coder = rs.for_n_f(ret.n, ret.f)
        k = coder.data_shards
        if len(ret.shards) < k:
            return None
        del self._pending[root]
        lst: List[Optional[bytes]] = [None] * coder.total_shards
        for idx, shard in ret.shards.items():
            lst[idx] = shard
        step = Step()
        payload: Optional[bytes] = None
        try:
            full = coder.reconstruct_np(lst, device=self.device)
        # hblint: disable=fault-swallowed-drop (accounted below: a None
        # reconstruction lands in the mismatches counter + the proposer's
        # VidReconstructMismatch fault, never silently)
        except ValueError:
            full = None
        if full is not None and MerkleTree.from_vec(
                full).root_hash() == root:
            payload = _unframe_value(b"".join(full[:k]))
            if payload is not None and len(payload) != ret.total_len:
                payload = None
        if payload is None:
            # every k-subset of proof-valid shards fails this identically:
            # the committed leaves were not an RS codeword — proposer fault
            self.mismatches += 1
            self._note("vid_mismatch",
                       f"proposer={ret.proposer!r} root={root.hex()[:24]}")
            step.fault(ret.proposer, FaultKind.VidReconstructMismatch)
        else:
            self.retrieved += 1
        step.output.append(RetrievedPayload(
            root=root, proposer=ret.proposer, payload=payload,
            total_len=ret.total_len, shards_bad=ret.bad,
            rounds=ret.rounds, t_ordered=ret.t_ordered))
        return step

    def tick(self, now: float) -> Step:
        """Retry overdue ACTIVE retrievals; exhaust after ``max_rounds``.
        Queued retrievals burn no rounds — they promote via
        :meth:`_activate` as slots free up."""
        step = Step()
        for root in [r for r, p in self._pending.items()
                     if p.active and p.deadline <= now]:
            ret = self._pending[root]
            ret.rounds += 1
            if ret.rounds >= self.max_rounds:
                del self._pending[root]
                self.failures += 1
                self._note("vid_exhausted",
                           f"root={root.hex()[:24]} "
                           f"shards={len(ret.shards)} bad={ret.bad}")
                step.output.append(RetrievedPayload(
                    root=root, proposer=ret.proposer, payload=None,
                    total_len=ret.total_len, shards_bad=ret.bad,
                    rounds=ret.rounds, t_ordered=ret.t_ordered))
                continue
            self.retries += 1
            ret.deadline = now + self.retry_s * (ret.rounds + 1)
            step.extend(self._request_step(root, ret))
        return step.extend(self._activate(now))

    # -- donor side ----------------------------------------------------------

    def handle_retrieve(self, peer: NodeId, msg: VidRetrieve, now: float
                        ) -> Step:
        entry = self.store.proof_for(msg.root)
        if entry is None:
            # never dispersed to us (or long evicted): refuse LOUDLY —
            # counted + noted, never a fault (a fast peer's early retrieve
            # is honest; it retries once our dispersal lands)
            self.refusals += 1
            self._note("vid_refusal",
                       f"peer={peer!r} root={msg.root.hex()[:24]}")
            return Step()
        total_len, proof = entry
        if not self._quota_ok(peer, len(proof.value), now):
            self.quota_drops += 1
            self._note("vid_quota",
                       f"peer={peer!r} root={msg.root.hex()[:24]} "
                       f"bytes={len(proof.value)}")
            return Step()
        self.served += 1
        return Step().send_to(
            peer, VidShard(msg.root, total_len, proof))

    def _quota_ok(self, peer: NodeId, nbytes: int, now: float) -> bool:
        if self.serve_bytes_per_s <= 0:
            return True
        tokens, last = self._quota.get(
            peer, (self.serve_burst_bytes, now))
        tokens = min(self.serve_burst_bytes,
                     tokens + (now - last) * self.serve_bytes_per_s)
        if nbytes > tokens:
            self._quota[peer] = (tokens, now)
            return False
        self._quota[peer] = (tokens - nbytes, now)
        return True
