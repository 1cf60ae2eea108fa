"""Multi-epoch transaction queueing over the batched HoneyBadger epoch.

Counterpart of ``hbbft_tpu/parallel/qhb.py`` (reference:
``src/queueing_honey_badger/`` + ``src/transaction_queue.rs``): per-node
transaction queues, a random ``batch_size`` sample proposed each epoch
(sampling keeps different nodes' proposals mostly disjoint), committed
transactions removed everywhere, leftovers re-proposed — with every epoch
executed as one :class:`~hbbft_tpu_torch.parallel.acs.BatchedHoneyBadgerEpoch`
(TPKE encrypt → batched ACS → master-scalar decrypt) on ``device``.

With ``mesh=`` every epoch rides one ``DeviceMesh`` (see
:class:`~hbbft_tpu_torch.parallel.acs.BatchedHoneyBadgerEpoch`), every rank
driving the same queues with the same seeds.

Snapshots: a driver pickles to host state only (queues, ledger, counters);
the epoch is rebuilt at first use on ``device``, a plain field, so a driver
pickled on the card restores on a host with no card once ``device`` is set
to ``"cpu"``.  A mesh-attached driver refuses to pickle.
"""

from __future__ import annotations

import contextlib
import random
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch
from hbbft_tpu_torch.parallel.mesh import runner_device
from hbbft_tpu_torch.protocols.queueing_honey_badger import (
    TransactionQueue,
    _de_txs,
    _ser_txs,
)


def _commit_txs(pairs, seen, committed, queues, lock=None):
    """Shared ledger-commit step of the queueing drivers: dedup one epoch's
    (proposer, serialized-txs) pairs in deterministic proposer order, prune
    every queue with ONE drop set, record the network commit order.
    Returns the newly committed transactions."""
    new: List[bytes] = []
    epoch_txs: List[bytes] = []
    for _nid, payload in sorted(pairs, key=lambda kv: repr(kv[0])):
        for tx in _de_txs(payload):
            epoch_txs.append(tx)
            if tx not in seen:
                seen.add(tx)
                new.append(tx)
    drop = frozenset(epoch_txs)
    with lock if lock is not None else contextlib.nullcontext():
        for q in queues.values():
            q.remove_multiple(drop)
    committed.extend(new)
    return new


class _Inline:
    """An executor that runs each task when it is submitted, in the
    caller's thread: on a mesh every rank must issue its collectives in one
    order, which a worker thread beside the main one would not keep."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as exc:  # raised again by fut.result()
            fut.set_exception(exc)
        return fut


class BatchedQueueingHoneyBadger:
    """Epoch driver: queues + batched epochs until the ledger drains.

    ``device`` (default ``"cuda"``, raising without a card) and
    ``encrypt_backend`` (``"native"``, ``"device"`` or ``"auto"``/None, as
    ``tc.tpke_encrypt_batch`` takes it) go to the epoch, and so does
    ``mesh`` (a ``DeviceMesh``, which fixes the device)."""

    def __init__(self, netinfo_map: Dict, batch_size: int = 100,
                 session_id: bytes = b"batched-qhb", encrypt: bool = True,
                 cost_model=None, device="cuda",
                 encrypt_backend: Optional[str] = None, mesh=None):
        self.netinfo_map = netinfo_map
        self.session_id = session_id
        self.mesh = mesh
        self.device = runner_device(mesh, device)
        self.encrypt_backend = encrypt_backend
        self._hb = None
        self.ids = self.hb.ids
        self.batch_size = batch_size
        self.encrypt = encrypt
        # optional cost model (duck-typed: ``batched_epoch_estimate(n, f,
        # payload_bytes, aba_epochs)``) → virtual clock
        self.cost_model = cost_model
        self.virtual_time = 0.0
        self.queues = {nid: TransactionQueue() for nid in self.ids}
        # guards queue state: the pipelined driver samples on a worker
        # thread while _commit prunes on the main thread
        self._queue_lock = threading.Lock()
        self.committed: List[bytes] = []  # network commit order, once each
        self._seen = set()
        self.epoch = 0

    # -- pickling (snapshot/restore support) --------------------------------

    def __getstate__(self):
        if self.mesh is not None:
            raise TypeError(
                "cannot snapshot a mesh-attached BatchedQueueingHoneyBadger; "
                "snapshot the mesh=None driver and re-attach the mesh after restore"
            )
        d = self.__dict__.copy()
        d["_queue_lock"] = None  # locks don't pickle; recreated on restore
        d["_hb"] = None  # rebuilt at first use, on ``device``
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._queue_lock = threading.Lock()

    @property
    def hb(self) -> BatchedHoneyBadgerEpoch:
        """The epoch runner on ``device`` (built again after a restore)."""
        if self._hb is None:
            self._hb = BatchedHoneyBadgerEpoch(
                self.netinfo_map, session_id=self.session_id, compact=True,
                device=self.device, encrypt_backend=self.encrypt_backend,
                mesh=self.mesh,
            )
        return self._hb

    def push(self, node_id, tx: bytes) -> None:
        """Inject a transaction at one node (``Input::User`` analog)."""
        with self._queue_lock:
            self.queues[node_id].extend([tx])

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def _account(self, detail) -> None:
        if self.cost_model is not None:
            self.virtual_time += self.cost_model.batched_epoch_estimate(
                self.hb.n, self.hb.f,
                int(detail["payload_bytes"]),  # ciphertext bytes on the wire
                int(detail["epochs"]),
            )

    def run_epoch(self, rng) -> List[bytes]:
        """One full epoch: sample proposals, run the batched HB epoch,
        commit new transactions exactly once, drop them from every queue.
        Returns the transactions newly committed this epoch."""
        contribs = {
            nid: _ser_txs(self.queues[nid].choose(rng, self.batch_size))
            for nid in self.ids
        }
        # per-epoch coin namespace: each epoch is a fresh ACS under
        # session_id + the epoch number
        batch, detail = self.hb.run(
            contribs, rng, encrypt=self.encrypt,
            session_suffix=struct.pack(">Q", self.epoch),
        )
        self._account(detail)
        return self._commit(batch)

    def run_to_empty(self, rng, max_epochs: int = 64,
                     on_epoch: Optional[Callable] = None) -> int:
        """Run epochs until every injected transaction committed; returns
        the epoch count.  ``on_epoch(epoch, new_txs)`` fires after each."""
        start = self.epoch
        while self.pending() > 0:
            if self.epoch - start >= max_epochs:
                raise RuntimeError("transactions not drained")
            new = self.run_epoch(rng)
            if on_epoch is not None:
                on_epoch(self.epoch, new)
        return self.epoch - start

    def _commit(self, batch) -> List[bytes]:
        """Dedup + queue-prune one epoch's agreed batch (host)."""
        new = _commit_txs(
            batch.items(), self._seen, self.committed, self.queues,
            lock=self._queue_lock,
        )
        self.epoch += 1
        return new

    def run_epochs_pipelined(self, rng, n_epochs: int,
                             on_epoch: Optional[Callable] = None) -> int:
        """Run ``n_epochs`` with epoch-axis overlap: epoch e+1's TPKE
        encryption runs on a worker thread while epoch e's ACS runs on the
        main thread.  On the card both threads launch onto PyTorch's
        current stream (the worker's ladders, the main thread's SHA3), so
        their kernels serialize there; the host work (the native encrypt,
        hash-to-G2, the KDF, the decrypt) is what overlaps.

        Pipelining divergence, as in the reference: epoch e+1's proposals
        are sampled BEFORE epoch e's commits prune the queues; a
        transaction committed in e and re-proposed in e+1 commits once
        (dedup at the ledger).  With a mesh, epoch e+1 is sampled and
        encrypted at the same point, but in the main thread, before epoch e
        runs: the ranks' collectives then keep one order.  Returns the
        number of transactions newly committed."""
        if n_epochs <= 0:
            return 0
        hb = self.hb

        def sample_and_encrypt(seed):
            with self._queue_lock:
                contribs = {
                    nid: _ser_txs(self.queues[nid].choose(
                        random.Random(seed ^ i), self.batch_size
                    ))
                    for i, nid in enumerate(self.ids)
                }
            return hb.encrypt_phase(
                contribs, random.Random(seed), encrypt=self.encrypt
            )

        total_new = 0
        pool = ThreadPoolExecutor(max_workers=1) if self.mesh is None else _Inline()
        with pool:
            fut = pool.submit(sample_and_encrypt, rng.getrandbits(48))
            for e in range(n_epochs):
                payloads = fut.result()
                if e + 1 < n_epochs:
                    fut = pool.submit(sample_and_encrypt, rng.getrandbits(48))
                batch, detail = hb.run_from_payloads(
                    payloads, encrypt=self.encrypt,
                    session_suffix=struct.pack(">Q", self.epoch),
                )
                self._account(detail)
                new = self._commit(batch)
                total_new += len(new)
                if on_epoch is not None:
                    on_epoch(self.epoch, new)
        return total_new


class BatchedQueueingDynamicHoneyBadger:
    """Queueing over :class:`~hbbft_tpu_torch.parallel.dhb.
    BatchedDynamicHoneyBadger` (reference: ``src/queueing_honey_badger/``
    over ``src/dynamic_honey_badger/``): transaction queueing and on-line
    membership changes together.  Each epoch samples ``batch_size``
    transactions per validator, runs them (plus pending votes and DKG
    messages) through one batched HoneyBadger epoch, commits new
    transactions exactly once, and prunes every queue.  Era rotations are
    transparent to the ledger: queues persist across eras, a removed
    validator stops proposing, an added one starts.

    ``device``, ``encrypt_backend``, ``secret_keys`` and ``mesh`` go to
    the dynamic driver, which owns the device (``self.dhb.device``).
    """

    def __init__(self, netinfo_map: Dict, batch_size: int = 100,
                 session_id: bytes = b"batched-qdhb", rng=None,
                 cost_model=None, device="cuda",
                 encrypt_backend: Optional[str] = None,
                 secret_keys: Optional[Dict] = None, mesh=None):
        from hbbft_tpu_torch.parallel.dhb import BatchedDynamicHoneyBadger

        self.dhb = BatchedDynamicHoneyBadger(
            netinfo_map, secret_keys=secret_keys, session_id=session_id,
            rng=rng, device=device, encrypt_backend=encrypt_backend, mesh=mesh,
        )
        self.batch_size = batch_size
        self.queues = {nid: TransactionQueue() for nid in self.dhb.validators}
        self.committed: List[bytes] = []
        self._seen = set()
        self.cost_model = cost_model
        self.virtual_time = 0.0

    # -- transaction + vote inputs ------------------------------------------

    def push(self, node_id, tx: bytes) -> None:
        self.queues.setdefault(node_id, TransactionQueue()).extend([tx])

    def pending(self) -> int:
        return sum(
            len(self.queues.get(nid, ())) for nid in self.dhb.validators
        )

    def vote_to_add(self, voter, node_id, pub_key, secret_key=None) -> None:
        self.dhb.vote_to_add(voter, node_id, pub_key, secret_key=secret_key)

    def vote_to_remove(self, voter, node_id) -> None:
        self.dhb.vote_to_remove(voter, node_id)

    def vote_for_encryption_schedule(self, voter, schedule) -> None:
        self.dhb.vote_for_encryption_schedule(voter, schedule)

    # -- the epoch loop ------------------------------------------------------

    def run_epoch(self, rng) -> List[bytes]:
        """Sample proposals from the CURRENT validator set's queues, run one
        dynamic epoch (votes/DKG ride along), commit + prune.  Returns the
        newly committed transactions (the epoch's ``DhbBatch`` is
        ``self.dhb.batches[-1]``)."""
        contribs = {}
        for nid in self.dhb.validators:
            q = self.queues.setdefault(nid, TransactionQueue())
            contribs[nid] = _ser_txs(q.choose(rng, self.batch_size))
        batch = self.dhb.run_epoch(contribs, rng)
        if self.cost_model is not None:
            d = self.dhb.last_detail  # n/f of the era that ran the epoch
            self.virtual_time += self.cost_model.batched_epoch_estimate(
                d["n"], d["f"], d["payload_bytes"], d["epochs"],
            )
        return _commit_txs(
            batch.contributions, self._seen, self.committed, self.queues,
        )

    def run_to_empty(self, rng, max_epochs: int = 64) -> int:
        """Epochs until every transaction in a CURRENT validator's queue
        committed (queues of non-validators don't count — a removed node
        cannot propose)."""
        epochs = 0
        while self.pending() > 0:
            if epochs >= max_epochs:
                raise RuntimeError("transactions not drained")
            self.run_epoch(rng)
            epochs += 1
        return epochs
