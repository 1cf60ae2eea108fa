"""Batched scalar-mul ladders on the device and the batched TPKE calls.

Counterpart of the single-device parts of ``hbbft_tpu/crypto/batch.py``
that the HoneyBadger epoch runs: the GLV/GLS-split G1/G2 scalar-mul
ladders (``_MsmCache._mul_batch_dispatch``/``_mul_batch_collect``,
``g1_mul_batch``/``g2_mul_batch``), the split device TPKE encrypt, and the
master-scalar threshold decrypt.  The ladders run
:func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy` over the one lazy field
(on the card: one whole-ladder kernel launch per dispatch) at every batch
size (the reference's TPU-measured choice between two field
representations does not change residues, so it is not carried over).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import bls12_381 as c
from hbbft_tpu_torch.ops import gcurve as G

# ladder width: the 129 bits of a GLV/GLS half-scalar < 2^128, rounded up
# to the reference's 4-bit window so both ladders see the same bit rows
_WINDOW_BITS = 132

# The thresholds below are TPU-derived, not yet measured on the card: they
# keep the reference's routing until the port's own crossovers are measured.
# Device decrypt only at this many ciphertexts (host asm wins below).
DEVICE_DECRYPT_MIN_BATCH = 8192
# Device encrypt under AUTO routing only at this many items.
DEVICE_ENCRYPT_MIN_BATCH = 256
# Items per pipeline chunk of the split device encrypt.
DEVICE_ENCRYPT_CHUNK = 1024


class _MsmCache:
    """Batched endomorphism-split scalar-mul ladders on one device."""

    def __init__(self, device):
        self.device = resolve_device(device)

    @staticmethod
    def _pad(n: int) -> int:
        size = 1
        while size < n:
            size *= 2
        return size

    def _mul_batch_dispatch(self, group: str, points, scalars, endo, lam):
        """Start ONE ladder for full-range (mod r) scalars; returns a handle
        for :meth:`_mul_batch_collect`.

        The lazy ladder is sound only below 2^128, so each scalar splits
        against the endomorphism eigenvalue ``lam``: s = a + b·λ with
        a = s mod λ, b = s ÷ λ (both < 2^128), and s·P = a·P + b·endo(P).
        One 132-bit ladder over the doubled batch [P…, endo(P)…] replaces
        a 255-bit one; the final add runs on the host."""
        B = len(points)
        size = self._pad(B)
        pts = list(points) + [None] * (size - B)
        sc = [s % c.R for s in scalars] + [0] * (size - B)
        a = [s % lam for s in sc]
        b = [s // lam for s in sc]
        phi = [endo(p) for p in pts]
        dev = self.device
        if group == "g1":
            pt = G.g1_to_device(pts + phi, dev)
            ops = G.LAZY_FP_OPS
        else:
            pt = G.g2_to_device(pts + phi, dev)
            ops = G.LAZY_FP2_OPS
        bits = torch.from_numpy(G.scalars_to_bits(a + b, nbits=_WINDOW_BITS)).to(dev)
        base_inf = torch.tensor([p is None for p in pts] * 2, device=dev)
        out, inf = G.scalar_mul_lazy(ops, pt, bits, base_inf)
        return (group, B, size, out, inf)

    def _mul_batch_collect(self, handle):
        """Finish a :meth:`_mul_batch_dispatch` handle: host Jacobian points
        (None = infinity), index-aligned with the dispatched points."""
        group, B, size, out, inf = handle
        inf_h = inf.cpu().numpy()
        if group == "g1":
            host_pts = G.g1_from_device_batch(out)  # a·P rows, then b·endo(P)
            host_add = c.g1_add
        else:
            host_pts = G.g2_from_device_batch(out)
            host_add = c.g2_add
        res = []
        for i in range(B):
            lo = None if inf_h[i] else host_pts[i]
            hi = None if inf_h[size + i] else host_pts[size + i]
            res.append(host_add(lo, hi))
        return res

    def g1_mul_batch(self, points, scalars):
        """Batched G1 scalar-mul for full-range scalars via GLV."""
        return self._mul_batch_collect(
            self._mul_batch_dispatch(
                "g1", points, scalars, c.g1_endo, c.LAMBDA_G1
            )
        )

    def g2_mul_batch(self, points, scalars):
        """Batched G2 scalar-mul for full-range scalars via GLS ψ²."""
        return self._mul_batch_collect(
            self._mul_batch_dispatch(
                "g2", points, scalars, c.g2_psi2, c.LAMBDA_G2
            )
        )


_CACHES: Dict[torch.device, _MsmCache] = {}


def cache_for(device) -> _MsmCache:
    """The ladder launcher for ``device`` (created on first use)."""
    dev = resolve_device(device)
    if dev not in _CACHES:
        _CACHES[dev] = _MsmCache(dev)
    return _CACHES[dev]


# --------------------------------------------------------------------------
# Batched TPKE decryption
# --------------------------------------------------------------------------

_MASTER_CACHE: dict = {}
_MASTER_CACHE_MAX = 64


def _master_for(pks, items) -> int:
    """f(0) from the t+1 (index, share) items, cached per key set and
    share values."""
    from hbbft_tpu_torch.crypto import tc

    key_shares = tuple((i, sk.scalar) for i, sk in items)
    hit = _MASTER_CACHE.get(id(pks))
    if hit is not None and hit[0] is pks and hit[1] == key_shares:
        return hit[2]
    master = tc.master_secret_from_shares(key_shares)
    if len(_MASTER_CACHE) >= _MASTER_CACHE_MAX:
        _MASTER_CACHE.clear()
    _MASTER_CACHE[id(pks)] = (pks, key_shares, master)
    return master


def batch_tpke_decrypt(pks, cts, secret_shares, device="cuda"):
    """God-view batched TPKE decryption: every share of ciphertext p has
    base U_p, so the Lagrange combine collapses to ONE scalar-mul by the
    master secret per ciphertext — on the device ladder from
    ``DEVICE_DECRYPT_MIN_BATCH`` ciphertexts, else in the native oracle.
    Returns the plaintexts, aligned with ``cts``."""
    from hbbft_tpu_torch.crypto import tc

    t = pks.threshold()
    items = sorted(secret_shares)[: t + 1]
    if len(items) < t + 1:
        raise ValueError(f"need {t + 1} shares, got {len(items)}")
    if not cts:
        return []
    master = _master_for(pks, items)
    if len(cts) >= DEVICE_DECRYPT_MIN_BATCH:
        masks = cache_for(device).g1_mul_batch(
            [ct.u for ct in cts], [master] * len(cts)
        )
        mask_bytes = [c.g1_to_bytes(m) for m in masks]
    else:
        nat = c._native()
        if nat is not None:
            return nat.bls_tpke_decrypt_batch(
                master,
                [c.g1_to_bytes(ct.u) for ct in cts],
                [ct.v for ct in cts],
            )
        mask_bytes = [c.g1_to_bytes(c.g1_mul(ct.u, master)) for ct in cts]
    return [tc._xor_mask(ct.v, mb) for ct, mb in zip(cts, mask_bytes)]


def batch_tpke_check_decrypt(pks, payloads, secret_shares, device="cuda"):
    """Wire-validate + decrypt raw ciphertext payloads in one pass (one
    native call where the framing is exact); semantics of
    ``Ciphertext.from_bytes`` then :func:`batch_tpke_decrypt`."""
    from hbbft_tpu_torch.crypto import tc

    t = pks.threshold()
    items = sorted(secret_shares)[: t + 1]
    if len(items) < t + 1:
        raise ValueError(f"need {t + 1} shares, got {len(items)}")
    if not payloads:
        return []
    nat = c._native()
    exact_idx = [
        i for i, p in enumerate(payloads)
        if len(p) >= 294
        and int.from_bytes(p[290:294], "big") == len(p) - 294
    ]
    if nat is not None and exact_idx:
        res = nat.bls_tpke_check_decrypt_batch(
            _master_for(pks, items), [payloads[i] for i in exact_idx]
        )
        if res is not None:
            if len(exact_idx) == len(payloads):
                return res
            out = [None] * len(payloads)
            for i, pt in zip(exact_idx, res):
                out[i] = pt
            rest = [i for i in range(len(payloads)) if out[i] is None]
            cts = [tc.Ciphertext.from_bytes(payloads[i]) for i in rest]
            for i, pt in zip(
                rest, batch_tpke_decrypt(pks, cts, secret_shares, device=device)
            ):
                out[i] = pt
            return out
    cts = [tc.Ciphertext.from_bytes(p) for p in payloads]
    return batch_tpke_decrypt(pks, cts, secret_shares, device=device)


# --------------------------------------------------------------------------
# Split device TPKE encrypt
# --------------------------------------------------------------------------


def device_encrypt_worthwhile(n_items: int, device) -> bool:
    """AUTO routing for the split device encrypt: only on a CUDA device and
    only when the native host oracle is missing (the reference's rule for
    one accelerator; the port's own crossover is not measured yet)."""
    if n_items < DEVICE_ENCRYPT_MIN_BATCH:
        return False
    if resolve_device(device).type != "cuda":
        return False
    return c._native() is None


def _g1_to_bytes_batch(pts) -> list:
    """Affine-serialize host Jacobian G1 points with ONE shared field
    inversion (Montgomery batch inversion); byte-identical to per-point
    ``c.g1_to_bytes``."""
    p = c.P
    idx = [i for i, pt in enumerate(pts) if pt is not None]
    zs = [pts[i][2] % p for i in idx]
    out = [b"\x40" + bytes(96)] * len(pts)
    if not zs:
        return out
    pre = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        pre[i + 1] = pre[i] * z % p
    acc = pow(pre[-1], -1, p)
    for i in range(len(zs) - 1, -1, -1):
        zi = acc * pre[i] % p
        acc = acc * zs[i] % p
        x, y, _ = pts[idx[i]]
        zi2 = zi * zi % p
        out[idx[i]] = (
            b"\x00"
            + (x * zi2 % p).to_bytes(48, "big")
            + (y * zi2 % p * zi % p).to_bytes(48, "big")
        )
    return out


def batch_tpke_encrypt_device(pk_point, msgs: Sequence[bytes], rs,
                              device="cuda"):
    """Encrypt ``msgs`` to one threshold key with the ladders on ``device``.

    ``rs``: one nonzero scalar per message, drawn by the caller — the
    result is byte-identical to the native ``bls_tpke_encrypt_batch`` with
    the same scalars.  Per chunk: the G1 ladder (rows [g1…, pk…]) gives U
    and the mask, the host derives V and hashes U‖V to G2 (one native batch
    call), and the G2 ladder gives W.  Returns ``tc.Ciphertext`` objects.
    """
    from hbbft_tpu_torch.crypto import tc

    n = len(msgs)
    if n == 0:
        return []
    if len(rs) != n:
        raise ValueError("need one scalar per message")
    cache = cache_for(device)
    nat = c._native()
    chunk = DEVICE_ENCRYPT_CHUNK
    spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    g1_handles = [
        cache._mul_batch_dispatch(
            "g1",
            [c.G1_GEN] * (hi - lo) + [pk_point] * (hi - lo),
            list(rs[lo:hi]) * 2,
            c.g1_endo, c.LAMBDA_G1,
        )
        for lo, hi in spans
    ]
    w_handles = []
    us_all: list = []
    vs_all: list = []
    for (lo, hi), h in zip(spans, g1_handles):
        pts = cache._mul_batch_collect(h)
        m = hi - lo
        ser = _g1_to_bytes_batch(pts)
        u_bytes, mask_bytes = ser[:m], ser[m:]
        vs = [tc._xor_mask(msg, mb) for msg, mb in zip(msgs[lo:hi], mask_bytes)]
        hins = [b"HBBFT-TPKE" + ub + v for ub, v in zip(u_bytes, vs)]
        if nat is not None:
            hs = [
                c._g2_from_bytes_trusted(hb)
                for hb in nat.bls_hash_g2_batch(hins)
            ]
        else:
            hs = [c.hash_g2(hin) for hin in hins]
        w_handles.append(
            cache._mul_batch_dispatch(
                "g2", hs, list(rs[lo:hi]), c.g2_psi2, c.LAMBDA_G2
            )
        )
        us_all.extend(c._g1_from_bytes_trusted(ub) for ub in u_bytes)
        vs_all.extend(vs)
    ws_all: list = []
    for h in w_handles:
        ws_all.extend(cache._mul_batch_collect(h))
    return [tc.Ciphertext(u, v, w) for u, v, w in zip(us_all, vs_all, ws_all)]
