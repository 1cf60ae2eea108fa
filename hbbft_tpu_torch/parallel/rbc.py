"""Batched Bracha reliable broadcast as a dense tensor program.

Counterpart of ``hbbft_tpu/parallel/rbc.py``: one communication round of
the whole network — P proposers × N receivers — as tensor ops, with
adversarial schedules as delivery masks and tamper patterns.  Above 256
nodes the coder works over GF(2^16), and a full-delivery round takes the
scale path (:meth:`BatchedRbc._run_large`): proposers in chunks of up to
64, a root-only Merkle commit, and the re-check stage skipped when every
shard matches its commitment.

Axes: ``P`` proposers, ``N`` nodes, ``k = N−2f`` data shards, ``B`` bytes
per shard, ``D`` Merkle proof depth.  Phases: Value (RS encode + Merkle
commit), Echo (proof checks and counts), Ready (N−f echoes, f+1
amplification), Decode (first k surviving shards, survivor-matrix
inversion, re-encode, root check — the faulty-proposer test).

Byzantine proposer models:
- ``codeword_tamper``: XORed into shards before the Merkle commit — an
  inconsistent codeword with valid proofs, caught by the re-encode check;
- ``value_tamper``: XORed after the commit — invalid proofs, caught by the
  proof checks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hbbft_tpu_torch.ops import gf16, gf256
from hbbft_tpu_torch.ops import rs as rs_mod
from hbbft_tpu_torch.ops.merkle import merkle_build, merkle_root, merkle_verify


def _first_k_survivors(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k True entries along the last axis (present
    first, ascending index): a stable sort of the uint8 key ``~sel``."""
    key = (~sel).to(torch.uint8)
    return torch.argsort(key, dim=-1, stable=True)[..., :k]


def _frame_ok(data_rec: torch.Tensor, k: int, B: int) -> torch.Tensor:
    """The 4-byte big-endian length prefix of the row-major (k·B) stream
    must fit the payload: ``ln <= k·B − 4``, computed in int64 (the
    reference's uint32 form cannot overflow there either)."""
    flat = data_rec.reshape(*data_rec.shape[:-2], k * B)
    if k * B < 4:
        return torch.zeros(flat.shape[:-1], dtype=torch.bool, device=flat.device)
    return _length_prefix(flat) <= k * B - 4


def _length_prefix(flat: torch.Tensor) -> torch.Tensor:
    """The big-endian u32 in the first 4 bytes of each (..., L) row, int64."""
    f64 = flat[..., :4].to(torch.int64)
    return (f64[..., 0] << 24) | (f64[..., 1] << 16) | (f64[..., 2] << 8) | f64[..., 3]


class BatchedRbc:
    """Batched RBC rounds for an (n, f) network."""

    def __init__(self, n: int, f: int):
        self.n = n
        self.f = f
        self.coder = rs_mod.for_n_f(n, f)
        self.k = self.coder.data_shards
        # N > 256 exceeds GF(2^8): the coder and the masked path's decode
        # work over GF(2^16), and full delivery takes the scale path
        self.large = n > 256

    # -- pickling (snapshot/restore support) --------------------------------

    def __getstate__(self):
        """Drop the coder: it is the process's shared ``rs.for_n_f(n, f)``
        object, whose per-device tensors (the counterpart of the
        reference's ``_pbits_dev``) must not travel; restore takes the
        restoring process's coder, which rebuilds them at first use."""
        d = self.__dict__.copy()
        d.pop("coder", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.coder = rs_mod.for_n_f(self.n, self.f)

    # ---------------------------------------------------------------- phases

    def _decode_batch(self, surv: torch.Tensor, use: torch.Tensor):
        """Survivor-dependent decode in the coder's field: surv uint8
        (..., k, B) survivor shards, use int (..., k) their encode-matrix
        rows → (data (..., k, B), inv_ok)."""
        enc = self.coder.matrix_on(surv.device)  # (n, k)
        sub = enc[use]  # (..., k, k)
        if self.large:
            dec, inv_ok = gf16.gf_inv_matrix_torch(sub)
            dec_bits = gf16.gf_matrix_to_bits_torch(dec)
            return gf16.gf_apply_bitmatrix(surv, dec_bits), inv_ok
        dec, inv_ok = gf256.gf_inv_matrix_torch(sub)
        dec_bits = gf256.gf_matrix_to_bits_torch(dec)  # (..., k*8, k*8)
        out = gf256.gf_apply_bitmatrix(surv.transpose(-1, -2), dec_bits)
        return out.transpose(-1, -2), inv_ok

    def propose(self, data: torch.Tensor, codeword_tamper=None):
        """Encode + Merkle commit: data uint8 (P, k, B) → (shards (P, N, B),
        root (P, 32), proofs (P, N, D, 32), proof_mask (N, D))."""
        shards = self.coder.encode(data)
        if codeword_tamper is not None:
            shards = shards ^ codeword_tamper
        root, proofs, pmask = merkle_build(shards)
        return shards, root, proofs, pmask

    def run(
        self,
        data: torch.Tensor,
        value_mask=None,
        echo_mask=None,
        ready_mask=None,
        codeword_tamper=None,
        value_tamper=None,
        receivers=None,
    ):
        """One full batched RBC execution (Value→Echo→Ready→decode).

        data: uint8 (P, k, B) on the run's device.  value_mask bool (P, N);
        echo_mask / ready_mask bool (N, N, P); codeword_tamper /
        value_tamper uint8 (P, N, B); receivers: optional int indices
        restricting the masked path's per-receiver decode.  Masks and
        patterns may be numpy arrays or tensors.

        Returns ``delivered`` (N, P), ``fault`` (N, P), ``data``
        (N_recv, P, k, B), ``data_receivers``, ``root`` (P, 32),
        ``echo_count`` (N, P), ``ready_count`` (N, P) — all tensors, except
        on the scale path (N > 256, full delivery, no ``receivers``), whose
        result is host arrays (:meth:`finish_large`)."""
        dev = data.device

        def on(x, dtype):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

        if self.large and receivers is None and all(
            m is None for m in (value_mask, echo_mask, ready_mask)
        ):
            # the masked path below works at N > 256 too, but it holds
            # (receiver, sender, instance) tensors: callers bound its cost
            # with few proposers or ``receivers``
            return self._run_large(
                data, on(codeword_tamper, torch.uint8), on(value_tamper, torch.uint8)
            )
        shards, root, proofs, pmask = self.propose(
            data, on(codeword_tamper, torch.uint8)
        )
        sent = shards if value_tamper is None else shards ^ on(value_tamper, torch.uint8)
        return self.run_from_proposal(
            sent, root, proofs, pmask,
            on(value_mask, torch.bool), on(echo_mask, torch.bool),
            on(ready_mask, torch.bool), receivers=on(receivers, torch.int64),
        )

    def run_from_proposal(
        self,
        sent,
        root,
        proofs,
        pmask,
        value_mask=None,
        echo_mask=None,
        ready_mask=None,
        receivers=None,
    ):
        """Echo→Ready→decode given (possibly tampered) proposal tensors."""
        n, f, k = self.n, self.f, self.k
        P = sent.shape[0]
        dev = sent.device

        if (value_mask is None and echo_mask is None and ready_mask is None
                and receivers is None):
            return self._run_full_delivery(sent, root, proofs, pmask)

        if value_mask is None:
            value_mask = torch.ones((P, n), dtype=torch.bool, device=dev)
        if echo_mask is None:
            echo_mask = torch.ones((n, n, P), dtype=torch.bool, device=dev)
        if ready_mask is None:
            ready_mask = torch.ones((n, n, P), dtype=torch.bool, device=dev)
        # self-edges cannot be dropped (object mode handles them locally)
        ar_n = torch.arange(n, device=dev)
        eye_n = torch.eye(n, dtype=torch.bool, device=dev)
        value_mask = value_mask | (ar_n[None, :] == torch.arange(P, device=dev)[:, None])
        echo_mask = echo_mask | eye_n[:, :, None]
        ready_mask = ready_mask | eye_n[:, :, None]

        # -- Value: node i verifies its own proof -------------------------
        idx = ar_n[None, :].expand(P, n)
        vv = merkle_verify(sent, idx, root[:, None, :], proofs, pmask[None, :, :])
        vv = vv & value_mask

        # -- Echo: valid_echo[j, i, p] = vv[p, i] & echo_mask[i, j, p] ----
        valid_echo = vv.t()[None, :, :] & echo_mask.permute(1, 0, 2)
        echo_count = valid_echo.sum(dim=1)  # (j, P)

        # -- Ready: ≥ n−f echoes, f+1 amplification to fixpoint ----------
        rmask_t = ready_mask.permute(1, 0, 2)  # (l, j, P)
        ready_send = echo_count >= (n - f)
        for _ in range(n):
            counts = (ready_send[None, :, :] & rmask_t).sum(dim=1)
            ready_send = ready_send | (counts >= (f + 1))
        ready_count = (ready_send[None, :, :] & rmask_t).sum(dim=1)
        can_decode = (ready_count >= (2 * f + 1)) & (echo_count >= k)

        # -- restrict the per-receiver decode to `receivers` -------------
        if receivers is None:
            receivers = ar_n
        valid_echo = valid_echo.index_select(0, receivers)
        echo_count = echo_count.index_select(0, receivers)
        ready_count = ready_count.index_select(0, receivers)
        can_decode = can_decode.index_select(0, receivers)
        nl = receivers.shape[0]

        # -- Decode: first-k surviving shards ----------------------------
        sel = valid_echo.permute(0, 2, 1)  # (l, P, i)
        use = _first_k_survivors(sel, k)  # (l, P, k)
        surv_ok = torch.gather(sel, -1, use).all(dim=-1)
        B = sent.shape[-1]
        sent_b = sent[None].expand(nl, *sent.shape)  # (l, P, n, B)
        surv = torch.gather(sent_b, -2, use[..., None].expand(nl, P, k, B))
        data_rec, inv_ok = self._decode_batch(surv, use)

        # -- re-encode + root check: present shards as received, missing
        # ones from the re-encode (reed-solomon-erasure's reconstruct) ---
        full = self.coder.encode(data_rec)  # (l, P, n, B)
        full_obj = torch.where(sel[..., None], sent_b, full)
        root_chk, _, _ = merkle_build(full_obj)
        root_ok = (root_chk == root[None]).all(dim=-1)
        data_rec = full_obj[..., :k, :]
        frame_ok = _frame_ok(data_rec, k, B)

        ok = can_decode & surv_ok & inv_ok
        delivered = ok & root_ok & frame_ok
        fault = ok & ~(root_ok & frame_ok)
        return {
            "delivered": delivered,
            "fault": fault,
            "data": data_rec,
            "data_receivers": receivers,
            "root": root,
            "echo_count": echo_count,
            "ready_count": ready_count,
        }

    def _run_full_delivery(self, sent, root, proofs, pmask):
        """All messages delivered: every receiver's state is identical, so
        verdicts are computed once and broadcast; ``data`` has one shared
        row (``data_receivers == [0]``)."""
        n, f, k = self.n, self.f, self.k
        P = sent.shape[0]
        dev = sent.device

        idx = torch.arange(n, device=dev)[None, :].expand(P, n)
        vv = merkle_verify(sent, idx, root[:, None, :], proofs, pmask[None, :, :])
        ec = vv.sum(dim=1)  # (P,)
        ready = ec >= (n - f)
        rc = torch.where(ready, n, 0)
        can_decode = (rc >= (2 * f + 1)) & (ec >= k)

        use = _first_k_survivors(vv, k)  # (P, k)
        surv_ok = torch.gather(vv, -1, use).all(dim=-1)
        B = sent.shape[-1]
        surv = torch.gather(sent, -2, use[..., None].expand(P, k, B))
        data_rec, inv_ok = self._decode_batch(surv, use)

        full = self.coder.encode(data_rec)  # (P, n, B)
        full_obj = torch.where(vv[..., None], sent, full)
        root_chk, _, _ = merkle_build(full_obj)
        root_ok = (root_chk == root).all(dim=-1)
        data_rec = full_obj[..., :k, :]
        frame_ok = _frame_ok(data_rec, k, B)

        ok = can_decode & surv_ok & inv_ok
        delivered = ok & root_ok & frame_ok
        fault = ok & ~(root_ok & frame_ok)

        def bc(a):
            return a[None, :].expand(n, P)

        return {
            "delivered": bc(delivered),
            "fault": bc(fault),
            "data": data_rec[None],
            "data_receivers": torch.zeros((1,), dtype=torch.int64, device=dev),
            "root": root,
            "echo_count": bc(ec),
            "ready_count": bc(rc),
        }

    # ------------------------------------------------------------- large N

    @staticmethod
    def _large_chunk_size(P: int) -> int:
        """Proposers a chunk: the largest of 64, 32, …, 1 dividing P.  The
        chunk bounds the working set (P·n Merkle leaves at once is
        gigabytes at N = 4096)."""
        return next(c for c in (64, 32, 16, 8, 4, 2, 1) if P % c == 0)

    @staticmethod
    def _chunked_map(fn, args, P: int, cs: int):
        """``fn`` over proposer-axis chunks of ``args`` (None members pass
        through as None), outputs concatenated along the proposer axis."""
        outs = [
            fn(tuple(None if a is None else a[lo: lo + cs] for a in args))
            for lo in range(0, P, cs)
        ]
        return tuple(torch.cat(col) for col in zip(*outs))

    def large_stage_a(self, d, cw, vt, cs: int):
        """Scale-path stage 1, by proposer chunk: encode, root-only Merkle
        commit, and each shard's echo validity as a comparison with the
        committed shard.  Returns (sent (P, n, B), root (P, 32), vv (P, n),
        echo count (P,) int32, data-rows-intact (P,))."""
        k = self.k

        def one(args):
            dc, cwc, vtc = args
            shards = self.coder.encode(dc)
            if cwc is not None:
                shards = shards ^ cwc
            root = merkle_root(shards)
            sent = shards if vtc is None else shards ^ vtc
            vv = (sent == shards).all(dim=-1)
            ec = vv.sum(dim=-1, dtype=torch.int32)
            ident = vv[..., :k].all(dim=-1)
            return sent, root, vv, ec, ident

        return self._chunked_map(one, (d, cw, vt), d.shape[0], cs)

    def large_stage_b(self, dr, sent_, vv_, root_, cs: int):
        """Scale-path stage 2, by proposer chunk: re-encode, root re-check
        (received shards where valid, re-encoded ones elsewhere), framing
        check.  Returns (data rows (P, k, B), root_ok (P,), frame_ok (P,))."""
        k = self.k

        def one(args):
            drc, sc, vc, rc = args
            full = self.coder.encode(drc)
            full_obj = torch.where(vc[..., None], sc, full)
            root_ok = (merkle_root(full_obj) == rc).all(dim=-1)
            out_data = full_obj[..., :k, :]
            return out_data, root_ok, _frame_ok(out_data, k, out_data.shape[-1])

        return self._chunked_map(one, (dr, sent_, vv_, root_), dr.shape[0], cs)

    def upload_framed(self, values, device) -> torch.Tensor:
        """``frame_values(values, k)`` on ``device``, uploading only each
        value's framed bytes: a (P, L) buffer trimmed to the longest framed
        value (rounded up to 256 bytes), zero-padded to (P, k, B) on the
        device."""
        k = self.k
        shard_len = _frame_shard_len(values, k)
        L = min(-(-max(4 + len(v) for v in values) // 256) * 256, k * shard_len)
        P = len(values)
        buf = np.zeros((P, L), dtype=np.uint8)
        for i, v in enumerate(values):
            stream = _frame_stream(v)
            buf[i, : len(stream)] = np.frombuffer(stream, dtype=np.uint8)
        out = torch.zeros((P, k * shard_len), dtype=torch.uint8, device=device)
        out[:, :L] = torch.from_numpy(buf).to(device)
        return out.reshape(P, k, shard_len)

    def _fetch_data_compact(self, out_data: torch.Tensor, frame_ok=None):
        """Device→host fetch of the shared (P, k, B) data rows, bounded by
        the framed lengths: only the leading ``max(ln) + 4`` bytes of each
        row (rounded up to 256) cross.  Rows whose framing check failed
        count nothing to the bound and come back ALL-ZERO, since they are
        only partly inside the window.  ``frame_ok=None`` derives the
        framing verdict from the lengths.  Returns (host (P, k, B) uint8,
        frame_ok (P,) bool)."""
        P, k, B = out_data.shape
        kb = k * B
        flat = out_data.reshape(P, kb)
        ln = _length_prefix(flat).cpu().numpy()
        if frame_ok is None:
            frame_ok = ln <= kb - 4
        ok_ln = ln[frame_ok]
        maxb = int(min(kb, (int(ok_ln.max()) + 4) if ok_ln.size else 4))
        maxb = int(min(kb, -(-maxb // 256) * 256))
        host = np.zeros((P, kb), dtype=np.uint8)
        host[:, :maxb] = flat[:, :maxb].cpu().numpy()
        host[~frame_ok] = 0
        return host.reshape(P, k, B), frame_ok

    def finish_large(self, stage_a_out, stage_b_fn):
        """The scale path's host decisions between and after its stages:
        thresholds, the straggler decode, stage B (skipped when every
        shard matches its commitment), the ``run`` result.

        ``stage_a_out``: :meth:`large_stage_a`'s tensors (over every
        proposer); ``stage_b_fn(data_rec, sent, vv, root)`` runs stage B,
        on one device or sharded over a mesh.  Returns host arrays: ``delivered``, ``fault``, ``echo_count`` and
        ``ready_count`` as (N, P) broadcast views of one row, ``data``
        (1, P, k, B) (one shared row, ``data_receivers == [0]``), ``root``.
        """
        n, f, k = self.n, self.f, self.k
        sent, root, vv, ec_d, ident_d = stage_a_out
        ec = ec_d.cpu().numpy()
        ident = ident_d.cpu().numpy()
        ready = ec >= (n - f)
        can_decode = ready & (ec >= k)
        if ident.all():
            data_rec = sent[:, :k, :]
        else:
            data_rec = self.reconstruct_stragglers(sent, vv, can_decode, ident)
        if (ec == n).all():
            # every shard equals its commitment, so stage B would rebuild
            # the committed shards and their root: only framing has content
            out_data, frame_ok = self._fetch_data_compact(data_rec)
            root_ok = np.ones(ec.shape, dtype=bool)
        else:
            out_data, root_ok, frame_ok = stage_b_fn(data_rec, sent, vv, root)
            root_ok = root_ok.cpu().numpy()
            frame_ok = frame_ok.cpu().numpy()
            out_data, _ = self._fetch_data_compact(out_data, frame_ok)
        delivered = can_decode & root_ok & frame_ok
        fault = can_decode & ~(root_ok & frame_ok)
        P = ec.shape[0]

        def bc(a):
            return np.broadcast_to(a[None, :], (n, P))

        return {
            "delivered": bc(delivered),
            "fault": bc(fault),
            "data": out_data[None],
            "data_receivers": np.zeros((1,), dtype=np.int64),
            "root": root.cpu().numpy(),
            "echo_count": bc(ec),
            "ready_count": bc(np.where(ready, n, 0)),
        }

    def reconstruct_stragglers(self, sent, vv, can_decode, ident) -> torch.Tensor:
        """(P, k, B) data rows on ``sent``'s device: the first k valid
        shards decoded on the host (GF(2^16)) for the proposers whose data
        rows did not all survive and that can decode (rare); the received
        data rows elsewhere."""
        k = self.k
        data_rec = sent[:, :k, :].clone()
        for p in np.flatnonzero(~ident & can_decode).tolist():
            use = tuple(torch.nonzero(vv[p]).flatten()[:k].tolist())
            surv = sent[p, list(use)].cpu().numpy()
            rec = self.coder.reconstruct_data_np(surv, use)
            data_rec[p] = torch.from_numpy(rec).to(sent.device)
        return data_rec

    def _run_large(self, data, codeword_tamper=None, value_tamper=None):
        """Full-delivery round for N > 256 (GF(2^16) coder): stage A, the
        host decisions, stage B when a shard differs from its commitment.

        Echo validity is a comparison of the received shard with the
        committed one (a proof verifies iff they match), as in the
        reference's scale path."""
        cs = self._large_chunk_size(data.shape[0])
        return self.finish_large(
            self.large_stage_a(data, codeword_tamper, value_tamper, cs),
            lambda dr, sent, vv, root: self.large_stage_b(dr, sent, vv, root, cs),
        )


# -- host-side framing ---------------------------------------------------------


def _frame_shard_len(values, k: int) -> int:
    """The common shard length for a batch of values, rounded up to even
    (the same framing as the reference)."""
    shard_len = max(2, max(-(-(4 + len(v)) // k) for v in values))
    return shard_len + shard_len % 2


def _frame_stream(v: bytes) -> bytes:
    """One value's framed byte stream (4-byte length prefix + payload)."""
    return len(v).to_bytes(4, "big") + v


def frame_values(values, k: int) -> np.ndarray:
    """Frame P byte-strings (4-byte big-endian length prefix, zero-padded)
    at one common shard length: (P, k, B) uint8."""
    shard_len = _frame_shard_len(values, k)
    out = np.zeros((len(values), k, shard_len), dtype=np.uint8)
    for i, v in enumerate(values):
        stream = _frame_stream(v).ljust(k * shard_len, b"\0")
        out[i] = np.frombuffer(stream, dtype=np.uint8).reshape(k, shard_len)
    return out


def unframe_value(data_row) -> Optional[bytes]:
    """Inverse of :func:`frame_values` for one (k, B) reconstruction; None
    when the length prefix does not fit."""
    if isinstance(data_row, torch.Tensor):
        data_row = data_row.cpu().numpy()
    framed = np.asarray(data_row, dtype=np.uint8).tobytes()
    if len(framed) < 4:
        return None
    length = int.from_bytes(framed[:4], "big")
    if 4 + length > len(framed):
        return None
    return framed[4: 4 + length]
