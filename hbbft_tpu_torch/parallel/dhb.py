"""Array-mode DynamicHoneyBadger: validator-set changes over batched epochs.

Counterpart of ``hbbft_tpu/parallel/dhb.py`` (reference:
``src/dynamic_honey_badger/`` + ``src/sync_key_gen.rs``): every epoch runs
as one :class:`~hbbft_tpu_torch.parallel.acs.BatchedHoneyBadgerEpoch` (TPKE
encrypt → batched ACS → master-scalar decrypt) whose contributions are the
object-mode ``InternalContrib`` wire format — user payload + signed votes +
signed DKG Part/Ack messages.  Vote counting, the per-node ``SyncKeyGen``
instances, and era rotation then run on the god-view exactly once, the same
way the batched simulator combines threshold shares once per proposer: every
correct node processes the identical committed batch deterministically, so
one execution of the deterministic state transition IS every node's
execution (the per-node signature/commitment re-verification a deployment
performs N× is the cost model's business, mirroring
``CostModel.batched_epoch_estimate``'s accounting stance).

God-view divergences from the object-mode state machines, documented:

- Key-gen gossip (``KeyGenWrap`` broadcasts) is instant: a Part/Ack a node
  emits lands in the shared pending pool immediately and is proposed by
  validators in the next epoch's contributions.  Object mode's direct
  broadcast + per-node ``pending_kg`` converges to the same committed
  sequence; the committed sequence is the only thing that drives state.
- Votes/parts/acks are signature-checked once (god view); each node's
  ``SyncKeyGen`` still processes every committed Part/Ack itself, so the
  per-node key material (rows, acks, resulting ``SecretKeyShare``) is the
  real thing, node for node — era rotation produces a genuine new
  ``NetworkInfo`` map with working threshold keys (asserted by running the
  next era's epochs under them).

Eras mirror object mode: ``session_id + era`` namespaces each era's inner
epochs, the batch reports ``ChangeState`` exactly as
``dynamic_honey_badger.rs`` does (``InProgress`` while the DKG runs, and
the era-completing batch itself reports ``Complete``).

On the card: the epochs run on ``device``, and so do the DKG's commitment
ladders where ``crypto/batch.py``'s thresholds route them there.  The DKG
is host work of order N³ (each member checks N Parts and N² Acks and
encrypts N² values), so a membership change costs far more than an epoch.

With ``mesh=`` every era's epoch rides one ``DeviceMesh``; an era whose N
the mesh's size does not divide runs unsharded, as in the reference.

Snapshots: a driver pickles to host state only; the epoch is rebuilt at
first use on ``device``, a plain field, so a driver pickled on the card
restores on a host with no card once ``device`` is set to ``"cpu"`` (a
DKG in progress keeps each member's own ``device`` field).  A
mesh-attached driver refuses to pickle.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch
from hbbft_tpu_torch.parallel.mesh import runner_device
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    Change,
    ChangeState,
    DhbBatch,
    InternalContrib,
    JoinPlan,
    SignedKeyGenMsg,
    SignedVote,
    VoteCounter,
    _keygen_payload,
    _vote_payload,
    de_ack,
    de_part,
    ser_ack,
    ser_part,
)
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.sync_key_gen import SyncKeyGen


class BatchedDynamicHoneyBadger:
    """God-view epoch driver with on-line validator-set changes.

    ``secret_keys`` must hold the long-term secret key of every current
    validator AND any candidate a vote may add (the god-view simulator owns
    all key material, like ``NetworkInfo.generate_map`` does).  ``device``
    (default ``"cuda"``, raising without a card) and ``encrypt_backend`` go
    to every era's epoch; ``device`` also to the DKG's members.  ``mesh``
    (a ``DeviceMesh``, which fixes the device) goes to every era's epoch
    whose N its size divides.
    """

    def __init__(
        self,
        netinfo_map: Dict,
        secret_keys: Optional[Dict] = None,
        session_id: bytes = b"batched-dhb",
        rng: Optional[random.Random] = None,
        device="cuda",
        encrypt_backend: Optional[str] = None,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = runner_device(mesh, device)
        self.encrypt_backend = encrypt_backend
        self.netinfo_map = dict(netinfo_map)
        ids = sorted(self.netinfo_map.keys(), key=repr)
        self.secret_keys = dict(secret_keys) if secret_keys else {
            nid: self.netinfo_map[nid].secret_key() for nid in ids
        }
        self.session_id = session_id
        self.rng = rng or random.Random(0)
        self.encryption_schedule = EncryptionSchedule.always()
        self.era = 0
        self.epoch = 0  # epoch within the current era
        self.era_has_batches = False
        self.change_state: ChangeState = ChangeState.none()
        self.vote_counter = VoteCounter(0)
        self.vote_num: Dict = {}
        self.pending_votes: Dict[object, List[SignedVote]] = {}
        # shared pools (god-view instant gossip; see module docstring)
        self.pending_kg: List[SignedKeyGenMsg] = []
        self.kg_seen: Set[bytes] = set()
        self.key_gens: Optional[Dict[object, SyncKeyGen]] = None
        self.key_gen_change: Optional[Change] = None
        self.batches: List[DhbBatch] = []
        self._hb = None

    # -- pickling (snapshot/restore support) --------------------------------

    def __getstate__(self):
        """A mesh binds the process groups of this world and cannot travel:
        refuse, as the reference does (the era's epoch may run unsharded,
        so its own refusal need not fire)."""
        if self.mesh is not None:
            raise TypeError(
                "cannot snapshot a mesh-attached BatchedDynamicHoneyBadger; "
                "snapshot the mesh=None driver and re-attach the mesh after restore"
            )
        d = self.__dict__.copy()
        d["_hb"] = None  # rebuilt at first use, on ``device``
        return d

    # -- the per-era inner epoch runner -------------------------------------

    @property
    def hb(self) -> BatchedHoneyBadgerEpoch:
        """The current era's epoch runner on ``device`` (built at the era's
        first epoch, and again after a restore)."""
        if self._hb is None:
            # an era whose N the mesh does not divide runs unsharded
            mesh = self.mesh
            if mesh is not None and len(self.netinfo_map) % mesh.size():
                mesh = None
            self._hb = BatchedHoneyBadgerEpoch(
                self.netinfo_map,
                session_id=self.session_id + b"/era" + wire.u64(self.era),
                compact=True, device=self.device,
                encrypt_backend=self.encrypt_backend, mesh=mesh,
            )
        return self._hb

    @property
    def validators(self) -> List:
        return sorted(self.netinfo_map.keys(), key=repr)

    def is_validator(self, node_id) -> bool:
        return node_id in self.netinfo_map

    # -- votes (mirrors DynamicHoneyBadger.vote_for / vote_to_add/remove) ---

    def vote_for(self, voter, change: Change) -> None:
        if not self.is_validator(voter):
            return
        self.vote_num[voter] = self.vote_num.get(voter, 0) + 1
        payload = _vote_payload(voter, self.era, self.vote_num[voter], change)
        vote = SignedVote(
            voter, self.era, self.vote_num[voter], change,
            self.secret_keys[voter].sign(payload),
        )
        self.pending_votes.setdefault(voter, []).append(vote)

    def vote_to_add(self, voter, node_id, pub_key: tc.PublicKey,
                    secret_key: Optional[tc.SecretKey] = None) -> None:
        """``secret_key`` gives the god-view the candidate's long-term key
        so its DKG instance can decrypt its Part rows after the change wins
        (a real deployment's candidate owns it; the simulator must too)."""
        if secret_key is not None:
            self.secret_keys[node_id] = secret_key
        keys = dict(self.netinfo_map[self.validators[0]].public_key_map())
        keys[node_id] = pub_key
        self.vote_for(voter, Change.node_change(keys))

    def vote_to_remove(self, voter, node_id) -> None:
        keys = dict(self.netinfo_map[self.validators[0]].public_key_map())
        keys.pop(node_id, None)
        self.vote_for(voter, Change.node_change(keys))

    def vote_for_encryption_schedule(self, voter, schedule) -> None:
        self.vote_for(voter, Change.encryption_schedule(schedule))

    # -- the epoch loop ------------------------------------------------------

    def run_epoch(self, contributions: Dict, rng: Optional[random.Random] = None
                  ) -> DhbBatch:
        """One full DHB epoch: wrap per-validator user payloads with their
        pending votes and the shared key-gen pool, run the batched HB epoch,
        then apply votes/DKG/era-rotation to the god view.  Returns the
        :class:`DhbBatch` (identical at every correct node)."""
        rng = rng or random.Random(self.rng.getrandbits(48))
        kg_msgs = list(self.pending_kg)
        internal = {}
        for nid in self.validators:
            contrib = InternalContrib(
                contribution=bytes(contributions.get(nid, b"")),
                votes=list(self.pending_votes.get(nid, [])),
                key_gen_msgs=kg_msgs,
            )
            internal[nid] = contrib.to_bytes()
        batch_map, detail = self.hb.run(
            internal, rng, session_suffix=b"/e" + wire.u64(self.epoch),
            encrypt=self.encryption_schedule.encrypt_on_epoch(self.epoch),
        )
        # what wrappers need for cost accounting (the QDHB virtual clock):
        # n/f of the era that RAN this epoch — _process_batch may rotate
        # the era before control returns to the caller
        self.last_detail = {
            "payload_bytes": int(detail["payload_bytes"]),
            "epochs": int(detail["epochs"]),
            "n": self.hb.n,
            "f": self.hb.f,
        }
        return self._process_batch(batch_map)

    def run_until_change_completes(self, contribution_fn=None,
                                   max_epochs: int = 8) -> DhbBatch:
        """Drive epochs (empty or ``contribution_fn(nid)`` payloads) until
        a batch reports the change Complete — the DKG-pipeline loop the
        object mode keeps alive via ``contribution_provider``."""
        for _ in range(max_epochs):
            contribs = {
                nid: (contribution_fn(nid) if contribution_fn else b"")
                for nid in self.validators
            }
            batch = self.run_epoch(contribs)
            if batch.change.state == "complete":
                return batch
        raise RuntimeError("change did not complete")

    # -- committed-batch processing (the object-mode _process_batch, once) --

    def _process_batch(self, batch_map: Dict) -> DhbBatch:
        contributions: List[Tuple] = []
        all_kg: List[Tuple[object, SignedKeyGenMsg]] = []
        info0 = self.netinfo_map[self.validators[0]]
        for nid in self.validators:
            if nid not in batch_map:
                continue
            contrib = InternalContrib.from_bytes(batch_map[nid])
            contributions.append((nid, contrib.contribution))
            for vote in contrib.votes:
                self._commit_vote(vote, info0)
            for skg in contrib.key_gen_msgs:
                all_kg.append((nid, skg))
        # proposed votes are committed now; drop them from the proposers
        for nid in batch_map:
            self.pending_votes.pop(nid, None)
        # winner check before applying this batch's key-gen messages
        # (a fresh InProgress change means the DKG starts with this batch)
        if self.change_state.state == "none":
            winner = self.vote_counter.compute_winner(self.validators)
            if winner is not None:
                self._start_change(winner)
        # every proposer includes the shared pool, so the batch carries up
        # to N copies of each Part/Ack; the handlers are idempotent (object
        # mode applies the duplicates), so applying each committed message
        # once per batch is the same state, N× cheaper
        seen_in_batch: Set[bytes] = set()
        for _proposer, skg in all_kg:
            key = skg.to_bytes()
            if key in seen_in_batch:
                continue
            seen_in_batch.add(key)
            self._apply_committed_kg(skg)
        era_of_batch, epoch_of_batch = self.era, self.epoch
        self.era_has_batches = True
        self.epoch += 1
        completed = self._try_rotate_era()
        batch = DhbBatch(
            era=era_of_batch,
            epoch=epoch_of_batch,
            contributions=tuple(contributions),
            change=(
                ChangeState.complete(completed)
                if completed is not None
                else self.change_state
            ),
        )
        self.batches.append(batch)
        return batch

    def _commit_vote(self, vote: SignedVote, info0: NetworkInfo) -> None:
        if vote.era != self.era or vote.voter not in self.netinfo_map:
            return
        pk = info0.public_key(vote.voter)
        if pk is None or not pk.verify(vote.sig, vote.signed_payload()):
            return
        self.vote_counter.add_committed(vote)

    # -- DKG (one SyncKeyGen per member of the new set; real key material) --

    def _kg_key_map(self) -> Dict:
        keys = dict(self.netinfo_map[self.validators[0]].public_key_map())
        if self.key_gen_change is not None:
            keys.update(self.key_gen_change.key_map())
        return keys

    def _start_change(self, change: Change) -> None:
        if change.kind == "encryption_schedule":
            # no DKG: rotates at the next batch boundary
            self.change_state = ChangeState.in_progress(change)
            return
        new_keys = change.key_map()
        threshold = (len(new_keys) - 1) // 3
        # validate BEFORE mutating any state: raising with change_state
        # already InProgress (and key_gens still None) would wedge every
        # subsequent epoch on the rotation check
        missing = [n for n in new_keys if n not in self.secret_keys]
        if missing:
            raise ValueError(
                f"god-view needs the long-term secret keys of {missing} "
                "(pass them via vote_to_add(..., secret_key=...))"
            )
        self.change_state = ChangeState.in_progress(change)
        self.key_gen_change = change
        self.key_gens = {
            nid: SyncKeyGen(
                nid, self.secret_keys[nid], dict(new_keys), threshold,
                random.Random(self.rng.getrandbits(64)),
                device=self.device,
            )
            for nid in sorted(new_keys, key=repr)
        }
        for nid, kg in self.key_gens.items():
            part = kg.generate_part()
            self._queue_kg(nid, "part", ser_part(part))

    def _queue_kg(self, sender, kind: str, payload: bytes) -> None:
        skg = SignedKeyGenMsg(
            era=self.era, sender=sender, kind=kind, payload=payload,
            sig=self.secret_keys[sender].sign(
                _keygen_payload(self.era, sender, kind, payload)
            ),
        )
        key = skg.to_bytes()
        if key not in self.kg_seen:
            self.kg_seen.add(key)
            self.pending_kg.append(skg)

    def _apply_committed_kg(self, skg: SignedKeyGenMsg) -> None:
        if self.key_gens is None or skg.era != self.era:
            return
        key = skg.to_bytes()
        self.kg_seen.add(key)
        self.pending_kg = [m for m in self.pending_kg if m.to_bytes() != key]
        pk = self._kg_key_map().get(skg.sender)
        if pk is None or not pk.verify(skg.sig, skg.signed_payload()):
            return
        if skg.kind == "part":
            part = de_part(skg.payload)
            for nid, kg in self.key_gens.items():
                outcome = kg.handle_part(skg.sender, part)
                if outcome.ack is not None:
                    self._queue_kg(nid, "ack", ser_ack(outcome.ack))
        elif skg.kind == "ack":
            ack = de_ack(skg.payload)
            for kg in self.key_gens.values():
                kg.handle_ack(skg.sender, ack)

    # -- era rotation --------------------------------------------------------

    def _try_rotate_era(self) -> Optional[Change]:
        if self.change_state.state != "in_progress":
            return None
        change = self.change_state.change
        if change.kind == "encryption_schedule":
            k, a, b = change.schedule
            self.encryption_schedule = EncryptionSchedule(k, a, b)
            self._rotate(change, self.netinfo_map)
            return change
        assert self.key_gens is not None
        if not all(kg.is_ready() for kg in self.key_gens.values()):
            return None
        new_keys = change.key_map()
        new_map: Dict = {}
        pub_key_set = None
        for nid, kg in self.key_gens.items():
            pks, sk_share = kg.generate()
            if pub_key_set is None:
                pub_key_set = pks
            else:
                # deterministic from the committed Part sequence — every
                # node derives the identical public key set
                assert pks.public_key().to_bytes() == \
                    pub_key_set.public_key().to_bytes()
            new_map[nid] = NetworkInfo(
                our_id=nid,
                public_keys=dict(new_keys),
                public_key_set=pks,
                secret_key_share=sk_share,
                secret_key=self.secret_keys[nid],
            )
        self._rotate(change, new_map)
        return change

    def _rotate(self, change: Change, new_map: Dict) -> None:
        self.netinfo_map = dict(new_map)
        self.era += 1
        self.epoch = 0
        self.era_has_batches = False
        self.change_state = ChangeState.none()
        self.vote_counter = VoteCounter(self.era)
        self.key_gens = None
        self.key_gen_change = None
        self.pending_kg = []
        self.kg_seen = set()
        self.vote_num = {}
        self.pending_votes = {}
        self._hb = None  # the new era's epoch, at N of the new set

    # -- join plan (era boundary; mirrors DynamicHoneyBadger.join_plan) -----

    def join_plan(self) -> JoinPlan:
        if self.era_has_batches:
            raise ValueError(
                "join_plan() is only valid at an era boundary (epochs of "
                "this era already completed; rotate the era first)"
            )
        from hbbft_tpu_torch.crypto import bls12_381 as bls

        info0 = self.netinfo_map[self.validators[0]]
        pks = info0.public_key_set()
        sched = self.encryption_schedule
        return JoinPlan(
            era=self.era,
            pub_key_set_bytes=b"".join(
                bls.g1_to_bytes(p) for p in pks.commitment.points
            ),
            pub_keys=tuple(
                sorted(
                    (
                        (nid, pk.to_bytes())
                        for nid, pk in info0.public_key_map().items()
                    ),
                    key=lambda kv: repr(kv[0]),
                )
            ),
            encryption_schedule=(sched.kind, sched.a, sched.b),
        )
