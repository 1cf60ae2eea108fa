"""Batched Asynchronous Common Subset and a full HoneyBadger epoch.

Counterpart of ``hbbft_tpu/parallel/acs.py``, on one device or sharded
over a ``DeviceMesh`` (``mesh=``; see :mod:`hbbft_tpu_torch.parallel.mesh`):

    RBC round (parallel.rbc)  →  N×N delivered mask + values
    ABA epochs (parallel.aba) →  accepted instance set
    threshold decrypt         →  contributions → the epoch Batch

The same bulk-synchronous semantics as the reference: ABA inputs are the
RBC outcome, and decryption is combined once per accepted proposer on the
host oracle.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.parallel.aba import BatchedAba, coin_for, coins_for_epoch
from hbbft_tpu_torch.parallel.mesh import (
    make_sharded_aba_step,
    make_sharded_coin_verify,
    make_sharded_decrypt,
    make_sharded_rbc_large_run,
    make_sharded_rbc_run,
    runner_device,
)
from hbbft_tpu_torch.parallel.rbc import BatchedRbc, frame_values, unframe_value


def _host(x) -> np.ndarray:
    """A tensor's values as a numpy array; host arrays pass through."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hash_coin(p: int, e: int) -> bool:
    return bool(hashlib.sha3_256(b"acs-coin%d-%d" % (p, e)).digest()[0] & 1)


class BatchedAcs:
    """One ACS instance over an (n, f) network on ``device``, or with its
    RBC and ABA rounds sharded over ``mesh`` (a ``DeviceMesh`` whose size
    divides n; it fixes the device: ``cuda:<local rank>``, or the CPU for a
    gloo mesh)."""

    def __init__(self, n: int, f: int, device="cuda", mesh=None):
        self.n = n
        self.f = f
        self.mesh = mesh
        self.device = runner_device(mesh, device)
        self.rbc = BatchedRbc(n, f)
        self.aba = BatchedAba(n, f)
        self._build_runners()

    # -- pickling (snapshot/restore support) --------------------------------

    def __getstate__(self):
        """The round runners are rebuilt from (n, f) on restore, as the
        reference rebuilds its jit handles; ``device`` stays a plain field.

        A mesh-sharded runner refuses, as the reference's does: its mesh
        binds the process groups of THIS world.  Snapshot a ``mesh=None``
        runner and build the sharded one again on the restoring world."""
        if self.mesh is not None:
            raise TypeError(
                "cannot snapshot a mesh-sharded BatchedAcs; snapshot the "
                "mesh=None runner and reconstruct the sharded one from it"
            )
        d = self.__dict__.copy()
        for key in ("rbc", "aba", "_rbc_run", "_aba_step"):
            d.pop(key, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.rbc = BatchedRbc(self.n, self.f)
        self.aba = BatchedAba(self.n, self.f)
        self._build_runners()

    def _build_runners(self):
        mesh = self.mesh
        if mesh is None:
            self._rbc_run = self.rbc.run
            self._aba_step = self.aba.epoch_step
            return
        # raises unless the mesh's size divides n
        self._aba_step = make_sharded_aba_step(self.aba, mesh)
        if not self.rbc.large:
            self._rbc_run = make_sharded_rbc_run(self.rbc, mesh)
            return
        # N > 256: the full-delivery scale path shards its proposer axis;
        # masked runs at this scale take the unsharded masked path, whose
        # O(N³) mask tensors callers bound, as in the reference
        large_run = make_sharded_rbc_large_run(self.rbc, mesh)

        def rbc_run(data, value_mask=None, echo_mask=None, ready_mask=None,
                    codeword_tamper=None, value_tamper=None, receivers=None):
            if any(m is not None for m in (value_mask, echo_mask, ready_mask, receivers)):
                return self.rbc.run(
                    data, value_mask=value_mask, echo_mask=echo_mask,
                    ready_mask=ready_mask, codeword_tamper=codeword_tamper,
                    value_tamper=value_tamper, receivers=receivers,
                )
            return large_run(data, codeword_tamper=codeword_tamper,
                             value_tamper=value_tamper)

        self._rbc_run = rbc_run

    def run(
        self,
        values: Sequence[bytes],
        coin_fn=None,
        max_epochs: int = 24,
        compact: bool = False,
        coin_batch_fn=None,
        **rbc_kwargs,
    ):
        """values[p] = proposer p's contribution.  Returns ``accepted``
        (N, P), ``data`` (N_recv, P, k, B), ``delivered`` (N, P),
        ``data_receivers``, ``rbc_fault`` and ``epochs`` as numpy arrays —
        or, with ``compact=True``, ``accepted_row``, ``accepted_agree``,
        ``delivered_ok`` and ``data_sel`` (P, k, B).  At N > 256 with full
        delivery the RBC round takes the scale path (one shared data row,
        ``data_receivers == [0]``).

        coin_fn(p, epoch) -> bool supplies the random-epoch coins (default:
        a deterministic hash); coin_batch_fn(epoch) -> N bools, when set,
        covers the whole instance axis in one call."""
        n = self.n
        dev = self.device
        if self.rbc.large and all(
            rbc_kwargs.get(m) is None
            for m in ("value_mask", "echo_mask", "ready_mask", "receivers")
        ):
            # the scale path: upload the framed bytes, pad on the device
            data = self.rbc.upload_framed(list(values), dev)
        else:
            data = torch.from_numpy(frame_values(list(values), self.rbc.k)).to(dev)
        out = self._rbc_run(data, **rbc_kwargs)
        delivered = out["delivered"]
        if coin_fn is None:
            coin_fn = _hash_coin

        if isinstance(delivered, np.ndarray):
            # the scale path's host verdicts are one row broadcast over N:
            # upload that row and broadcast it on the device
            est_in = torch.from_numpy(np.array(delivered[0])).to(dev)
            est_in = est_in[None].expand(delivered.shape)
        else:
            est_in = delivered
        st = self.aba.init_state(est_in)
        epochs = 0
        while not bool(st["decided"].all()):
            if epochs >= max_epochs:
                raise RuntimeError("ABA did not terminate")
            if epochs % 3 == 2:  # only the random epochs consult the coin
                if coin_batch_fn is not None:
                    bits = coin_batch_fn(epochs)
                else:
                    bits = [coin_fn(p, epochs) for p in range(n)]
                coins = torch.tensor(np.array(bits, dtype=bool), device=dev)
            else:
                coins = torch.zeros((n,), dtype=torch.bool, device=dev)
            st = self._aba_step(st, coins)
            epochs += 1

        if compact:
            if "receivers" in rbc_kwargs:
                raise ValueError(
                    "compact mode needs a data row per receiver; it cannot "
                    "be combined with a receivers=-bounded RBC call"
                )
            decision = st["decision"]
            row = decision[0].cpu().numpy()
            agree = bool((decision == decision[0][None, :]).all())
            delivered_np = _host(delivered)
            any_deliv = delivered_np.any(axis=0)
            delivered_ok = bool((~row | any_deliv).all())
            src = delivered_np.argmax(axis=0)  # first delivering node
            recv = _host(out["data_receivers"])
            inv = np.zeros(n, dtype=np.int64)
            inv[recv] = np.arange(len(recv))
            data = out["data"]
            if isinstance(data, torch.Tensor):
                sel = data[
                    torch.from_numpy(inv[src]).to(dev), torch.arange(len(src), device=dev)
                ].cpu().numpy()
            else:
                sel = data[inv[src], np.arange(len(src))]
            return {
                "accepted_row": row,
                "accepted_agree": agree,
                "delivered_ok": delivered_ok,
                "data_sel": sel,
                "epochs": epochs,
            }

        return {
            "accepted": st["decision"].cpu().numpy(),
            "delivered": _host(delivered),
            "data": _host(out["data"]),
            "data_receivers": _host(out["data_receivers"]),
            "rbc_fault": _host(out["fault"]),
            "epochs": epochs,
        }


class BatchedHoneyBadgerEpoch:
    """One full HoneyBadger epoch in array mode on ``device``.

    Encrypt (TPKE, all proposers in one batch; ``encrypt_backend`` picks
    native, device or auto exactly as ``tc.tpke_encrypt_batch``'s
    ``backend``) → batched ACS over the ciphertext bytes → decrypt the
    accepted contributions (master-scalar fold, one native call).

    ``mesh``: a ``DeviceMesh`` the whole epoch rides, every rank running
    it with the same inputs: the RBC and ABA rounds shard their node axis,
    the encrypt's ladders (inside ``crypto.batch.routed_mesh``), the coin
    verification and the decrypt their rows.  It fixes the device, and the
    result is the one-device result, on every rank.

    A pickled epoch holds host state only: the ACS runner (and through it
    the coder's device tensors) is dropped and rebuilt at first use on
    ``device``, a plain field — an epoch pickled on the card restores on a
    host with no card once its ``device`` is set to ``"cpu"``.  A
    mesh-attached epoch refuses to pickle."""

    def __init__(self, netinfo_map: Dict, session_id: bytes = b"batched-hb",
                 compact: bool = False, device="cuda",
                 encrypt_backend: Optional[str] = None, mesh=None):
        ids = sorted(netinfo_map.keys(), key=repr)
        self.ids = ids
        self.netinfo_map = netinfo_map
        info0 = netinfo_map[ids[0]]
        self.n = info0.num_nodes()
        self.f = info0.num_faulty()
        self.session_id = session_id
        self.compact = compact
        self.mesh = mesh
        self.device = runner_device(mesh, device)
        self.encrypt_backend = encrypt_backend
        self._acs = BatchedAcs(self.n, self.f, device=self.device, mesh=mesh)
        if mesh is not None:
            self._coin_verify = make_sharded_coin_verify(mesh, self.device)
            self._check_decrypt = make_sharded_decrypt(mesh, self.device)

    # -- pickling (snapshot/restore support) --------------------------------

    def __getstate__(self):
        if self.mesh is not None:
            raise TypeError(
                "cannot snapshot a mesh-attached BatchedHoneyBadgerEpoch; "
                "snapshot the mesh=None epoch and re-attach the mesh after restore"
            )
        d = self.__dict__.copy()
        d["_acs"] = None
        return d

    @property
    def acs(self) -> BatchedAcs:
        """The ACS runner on ``device``, built again after a restore."""
        if self._acs is None:
            self._acs = BatchedAcs(self.n, self.f, device=self.device)
        return self._acs

    def coin_verify(self, pairs, msg: bytes, rng) -> bool:
        """Share verification for callers that check coin shares around
        this epoch, on ``device`` (row-sharded over the mesh, when there is
        one); the god-view epoch derives its coins from the master
        scalar."""
        if self.mesh is not None:
            return self._coin_verify(pairs, msg, rng)
        from hbbft_tpu_torch.crypto.batch import batch_verify_sig_shares

        return batch_verify_sig_shares(pairs, msg, rng, device=self.device)

    def encrypt_phase(self, contributions: Dict, rng,
                      encrypt: bool = True) -> List[bytes]:
        """TPKE-encrypt every proposer's contribution in ONE
        ``tc.tpke_encrypt_batch`` call; returns the per-proposer payloads
        (ciphertext bytes when encrypting)."""
        from hbbft_tpu_torch.crypto import batch as _cb
        from hbbft_tpu_torch.crypto import tc

        contribs = [contributions.get(nid, b"") for nid in self.ids]
        if not encrypt:
            return contribs
        pk = self.netinfo_map[self.ids[0]].public_key_set().public_key()
        with _cb.routed_mesh(self.mesh):
            cts = tc.tpke_encrypt_batch(
                pk, contribs, rng, backend=self.encrypt_backend, device=self.device,
            )
        return [ct.to_bytes() for ct in cts]

    def run(self, contributions: Dict, rng, encrypt: bool = True,
            session_suffix: bytes = b"", timer=None, **rbc_kwargs):
        """contributions: {node_id: bytes}.  Returns (batch, detail): the
        agreed {node_id: contribution} map plus the ACS detail arrays.

        ``timer``: optional zero-arg clock; when set, ``detail["phase_s"]``
        holds the encrypt, acs and decrypt seconds."""
        t0 = timer() if timer is not None else None
        payloads = self.encrypt_phase(contributions, rng, encrypt)
        t_enc = timer() - t0 if timer is not None else None
        batch, out = self.run_from_payloads(
            payloads, encrypt=encrypt, session_suffix=session_suffix,
            timer=timer, **rbc_kwargs,
        )
        if timer is not None:
            out["phase_s"]["encrypt"] = t_enc
        return batch, out

    def run_from_payloads(self, payloads, encrypt: bool = True,
                          session_suffix: bytes = b"", timer=None,
                          **rbc_kwargs):
        """ACS + threshold decrypt over pre-encrypted payloads.  ``timer``
        as in :meth:`run` (``phase_s`` gains ``acs`` and ``decrypt``)."""
        from hbbft_tpu_torch.crypto.batch import batch_tpke_check_decrypt

        info0 = self.netinfo_map[self.ids[0]]
        pks = info0.public_key_set()
        session = self.session_id + session_suffix

        def coin_fn(p, e):
            return coin_for(self.netinfo_map, session, self.ids[p], e)

        def coin_batch_fn(e):
            return coins_for_epoch(self.netinfo_map, session, self.ids, e)

        t0 = timer() if timer is not None else None
        out = self.acs.run(
            payloads, coin_fn=coin_fn, coin_batch_fn=coin_batch_fn,
            compact=self.compact, **rbc_kwargs
        )
        if timer is not None:
            out["phase_s"] = {"acs": timer() - t0}
            t0 = timer()
        out["payload_bytes"] = max((len(p) for p in payloads), default=0)
        batch: Dict = {}
        t = pks.threshold()
        pending: List[Tuple] = []  # (nid, payload)
        if self.compact:
            row = out["accepted_row"]
            if not out["accepted_agree"]:
                raise RuntimeError("nodes disagree on the accepted set")
            if not out["delivered_ok"]:
                raise RuntimeError("an accepted instance has no delivering node")

            def framed(p):
                return out["data_sel"][p]

        else:
            row = out["accepted"][0]
            delivered = out["delivered"]
            row_of = {int(r): i for i, r in enumerate(out["data_receivers"])}

            def framed(p):
                deliverers = np.flatnonzero(delivered[:, p])
                if deliverers.size == 0:
                    raise RuntimeError(
                        f"instance {p} accepted but no node delivered its value"
                    )
                rows = [row_of[int(d)] for d in deliverers if int(d) in row_of]
                if not rows:
                    raise RuntimeError(
                        f"instance {p}: no delivering receiver has a data row"
                    )
                return out["data"][rows[0], p]

        for p, nid in enumerate(self.ids):
            if not row[p]:
                continue
            payload = unframe_value(framed(p))
            if payload is None:
                continue
            if encrypt:
                pending.append((nid, payload))
            else:
                batch[nid] = payload
        if encrypt and pending:
            shares = [
                (
                    self.netinfo_map[onid].node_index(onid),
                    self.netinfo_map[onid].secret_key_share(),
                )
                for onid in self.ids[: t + 1]
            ]
            if self.mesh is not None:
                plaintexts = self._check_decrypt(pks, [pl for _, pl in pending], shares)
            else:
                plaintexts = batch_tpke_check_decrypt(
                    pks, [pl for _, pl in pending], shares, device=self.device
                )
            for (nid, _), pt in zip(pending, plaintexts):
                batch[nid] = pt
        if timer is not None:
            out["phase_s"]["decrypt"] = timer() - t0
        return batch, out
