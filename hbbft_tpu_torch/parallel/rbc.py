"""Batched Bracha reliable broadcast as a dense tensor program.

Counterpart of ``hbbft_tpu/parallel/rbc.py`` for networks of N ≤ 256
(the GF(2^8) coder): one communication round of the whole network — P
proposers × N receivers — as tensor ops, with adversarial schedules as
delivery masks and tamper patterns.

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

The large-N scale path of the reference (N > 256) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hbbft_tpu_torch.ops import gf256
from hbbft_tpu_torch.ops import rs as rs_mod
from hbbft_tpu_torch.ops.merkle import merkle_build, merkle_verify


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
    f64 = flat[..., :4].to(torch.int64)
    ln = (f64[..., 0] << 24) | (f64[..., 1] << 16) | (f64[..., 2] << 8) | f64[..., 3]
    return ln <= k * B - 4


class BatchedRbc:
    """Batched RBC rounds for an (n, f) network, n ≤ 256."""

    def __init__(self, n: int, f: int):
        self.n = n
        self.f = f
        self.coder = rs_mod.for_n_f(n, f)
        self.k = self.coder.data_shards

    # ---------------------------------------------------------------- phases

    def _decode_batch(self, surv: torch.Tensor, use: torch.Tensor):
        """Survivor-dependent decode: surv uint8 (..., k, B) survivor
        shards, use int (..., k) their encode-matrix rows → (data
        (..., k, B), inv_ok)."""
        enc = self.coder.matrix_on(surv.device)  # (n, k)
        sub = enc[use]  # (..., k, k)
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
        ``echo_count`` (N, P), ``ready_count`` (N, P) — all tensors."""
        dev = data.device

        def on(x, dtype):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

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


# -- host-side framing ---------------------------------------------------------


def _frame_shard_len(values, k: int) -> int:
    """The common shard length for a batch of values, rounded up to even
    (the same framing as the reference)."""
    shard_len = max(2, max(-(-(4 + len(v)) // k) for v in values))
    return shard_len + shard_len % 2


def frame_values(values, k: int) -> np.ndarray:
    """Frame P byte-strings (4-byte big-endian length prefix, zero-padded)
    at one common shard length: (P, k, B) uint8."""
    shard_len = _frame_shard_len(values, k)
    out = np.zeros((len(values), k, shard_len), dtype=np.uint8)
    for i, v in enumerate(values):
        stream = (len(v).to_bytes(4, "big") + v).ljust(k * shard_len, b"\0")
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
