"""Batched scalar-mul ladders on the device and the threshold-crypto batch
calls above them.

Counterpart of ``hbbft_tpu/crypto/batch.py``:

- the ladder launcher ``_MsmCache``, on one device or row-sharded over a
  ``DeviceMesh`` (``cache_for``, ``use_mesh``, ``routed_mesh``): the randomized MSM
  (``_msm_dispatch``/``_msm_collect``, ``msm_g1``/``msm_g2``: one 132-bit
  ladder over 128-bit randomizers, folded on the host) and the GLV/GLS-split
  full-range scalar muls (``_mul_batch_dispatch``/``_mul_batch_collect``,
  ``g1_mul_batch``/``g2_mul_batch``).  Every dispatch runs the 4-bit
  windowed ladder (:mod:`hbbft_tpu_torch.ops.gcurve`; on the card one
  launch of a hand-written kernel) over one of the reference's two lazy
  fields, chosen by ``_field_rep``: the 13-bit one (``ops/fp381.py``,
  ``csrc/ladder_window.cu``) or the 8-bit one (``ops/fp381_mxu.py``,
  ``csrc/ladder_mxu.cu``).  The two give different lazy digits; the host
  points they canonicalize to are equal.  ``HBBFT_FIELD_BACKEND=lazy|mxu``
  forces one, as in the reference; by default the port runs the 13-bit
  field at every size (``MXU_MAX_BATCH`` is None; the reference's 2 048
  was measured on a TPU);
- the TPKE calls of the HoneyBadger epoch (split device encrypt,
  master-scalar threshold decrypt);
- the randomized-linear-combination share checks (SURVEY §3.5): N
  pairing checks become two MSMs and ONE two-pairing check,

      e(g1, Σ rᵢσᵢ) = e(Σ rᵢ pkᵢ, h)      (signature shares, the coin)
      e(Σ rᵢ dᵢ, h) = e(Σ rᵢ pkᵢ, W)      (decryption shares)

  for random 128-bit rᵢ (soundness 2⁻¹²⁸); the MSMs run on the device, the
  pairings on the host oracle; on False the caller verifies per share;
- the DKG's commitment evaluations and the cross-epoch batched share
  generation and verification, device ladder above a batch threshold.
"""

from __future__ import annotations

import hashlib
import os
import random
from typing import Dict, Optional, Sequence, Tuple

import torch

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import bls12_381 as c
from hbbft_tpu_torch.ops import fp381, fp381_mxu
from hbbft_tpu_torch.ops import gcurve as G

_RAND_BITS = 128
# ladder width: the 129 bits of an odd 128-bit randomizer or of a GLV/GLS
# half-scalar < 2^128, rounded up to the 4-bit window
_WINDOW_BITS = 132

# Routing thresholds: every route is exact, so these choose speed only.
# A call runs on the device ladder from its threshold's batch size on, and
# never where the threshold is None.  Each is set from the host-against-
# device sweeps of chip_smoke.py's ``dkg256`` phase on NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md §6 has every cell); beside each, the measured
# cells on either side of it.
#
# ``batch_tpke_decrypt``: None.  With the epochs' 64 000-byte messages the
# native oracle won at 64 ciphertexts (0.060 s, device 0.098 s) and at
# 1 024 (1.338 s, device 2.333 s): the device route computes the masks on
# the card but runs the KDF + XOR in Python, the oracle all of it in C.
DEVICE_DECRYPT_MIN_BATCH = None
# ``batch_decrypt_share_gen`` (x·U per ciphertext, no KDF): 4 ciphertexts
# host 0.00076 s, device 0.00127 (a near tie in a second run: 0.00150,
# 0.00141); 8: host 0.00207, device 0.00156.
DEVICE_SHARE_GEN_MIN_BATCH = 8
# AUTO encrypt on the device only without the native oracle (the native
# batch won at N = 64, 0.200 s against 0.237, and at N = 1 024, 3.60 s
# against 4.71), and then from this many items: without the oracle both
# routes hash to G2 in Python, and the per-item host route also runs its
# three scalar muls there; the device won at every count measured, from 1
# item (host 0.0365 s, device 0.0098) to 64 (1.549 s, 0.696).
DEVICE_ENCRYPT_MIN_BATCH = 1
# Items per pipeline chunk of the split device encrypt.
DEVICE_ENCRYPT_CHUNK = 1024

# Ladders of at most this many rows run over the 8-bit field
# (``ops/fp381_mxu.py``) unless ``HBBFT_FIELD_BACKEND`` forces one; None:
# none do.  The reference's 2 048 is a crossover measured on a TPU, where its
# 8-bit field's matmuls won the launch-bound small ladders.  On NVIDIA H100
# 80GB HBM3, 700.00 W the 13-bit kernel (``csrc/ladder_window.cu``) was the
# faster at every row count chip_smoke.py's ``kernel_ladder_mxu`` phase
# measured, 132 bits, one launch each: G1 16 rows 1.00 ms against the 8-bit
# kernel's 3.24, G1 256 1.08 / 3.11, G2 128 1.55 / 8.79, G2 256 1.64 / 8.85
# (PERF.md §7).  So the default stays the 13-bit field everywhere.
MXU_MAX_BATCH = None


def _field_rep(size: int):
    """The field of a ladder of ``size`` rows: (host converter module, Fp
    ops, Fp2 ops).  ``HBBFT_FIELD_BACKEND=lazy|mxu`` forces one, any other
    value raises; unset or empty, ``MXU_MAX_BATCH`` decides.  Both fields
    are exact; the choice is speed only."""
    forced = os.environ.get("HBBFT_FIELD_BACKEND")
    if forced not in (None, "", "mxu", "lazy"):
        raise ValueError(
            f"HBBFT_FIELD_BACKEND={forced!r}: expected 'mxu' or 'lazy'"
        )
    use_mxu = forced == "mxu" or (
        not forced and MXU_MAX_BATCH is not None and size <= MXU_MAX_BATCH
    )
    if use_mxu:
        return fp381_mxu, G.MXU_FP_OPS, G.MXU_FP2_OPS
    return fp381, G.LAZY_FP_OPS, G.LAZY_FP2_OPS


class _MsmCache:
    """Batched lazy-field ladders on one device: the randomized MSM and the
    endomorphism-split scalar muls, each a dispatch/collect pair so that
    independent ladders overlap on the card.

    With ``mesh`` set (a ``DeviceMesh`` whose ranks all make the same
    calls), a ladder whose row count the mesh's size divides runs
    row-sharded: each rank launches the ladder on its own block of rows,
    and the rows are gathered in the collect, before the one fetch.  Any
    other row count runs unsharded on every rank, as in the reference.
    ``device`` is then the mesh's device for this rank."""

    def __init__(self, device, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh

    @staticmethod
    def _pad(n: int) -> int:
        size = 1
        while size < n:
            size *= 2
        return size

    def _ladder(self, group: str, points, scalars):
        """Start ONE ladder of 132 bits over ``points`` (host Jacobian, None
        = infinity) and scalars < 2^128: the windowed kernel (its plain
        version on the CPU).  On NVIDIA H100 80GB HBM3, 700.00 W it took
        0.58–0.68 of the bitwise kernel's time at every row count from 256
        to 65 536, G1 and G2 (chip_smoke.py's ladder_crossover, PERF.md).
        The field is ``_field_rep``'s for the whole ladder's rows.  Returns
        the device result (coordinates, inf, sharded, the field's host
        converter module): this rank's rows alone when ``sharded``."""
        dev = self.device
        rep, fp_ops, fp2_ops = _field_rep(len(points))
        sharded = self.mesh is not None and len(points) % self.mesh.size() == 0
        if sharded:
            from hbbft_tpu_torch.parallel.mesh import flat_rank

            per = len(points) // self.mesh.size()
            lo = flat_rank(self.mesh) * per
            points, scalars = points[lo: lo + per], scalars[lo: lo + per]
        if group == "g1":
            pt, ops = G.g1_to_device(points, dev, rep=rep), fp_ops
        else:
            pt, ops = G.g2_to_device(points, dev, rep=rep), fp2_ops
        bits = torch.from_numpy(G.scalars_to_bits(scalars, nbits=_WINDOW_BITS)).to(dev)
        base_inf = torch.tensor([p is None for p in points], device=dev)
        return (*G.scalar_mul_lazy_window(ops, pt, bits, base_inf), sharded, rep)

    def _gather_rows(self, group: str, out, inf):
        """Every rank's ladder rows, in row order (the ranks hold contiguous
        blocks), in the ladder's own layout: G1 coordinates (NL, rows), G2
        [re | im] (NL, 2·rows)."""
        from hbbft_tpu_torch.parallel.mesh import gather_nodes

        if group == "g1":
            cols = list(out)
        else:
            cols = [half for co in out for half in co.chunk(2, dim=-1)]
        nl, per = cols[0].shape
        local = torch.cat([torch.stack(cols).reshape(-1, per),
                           inf.to(cols[0].dtype)[None]])
        full = gather_nodes(local.t(), self.mesh).t()  # (values, rows)
        cols = full[:-1].reshape(len(cols), nl, full.shape[1])
        inf = full[-1].bool()
        if group == "g1":
            return tuple(cols), inf
        return tuple(torch.cat([cols[2 * i], cols[2 * i + 1]], dim=-1) for i in range(3)), inf

    def _fetch(self, group: str, out, inf, sharded: bool, rep):
        """ONE device→host copy of a ladder's coordinates and inf flags →
        (host Jacobian points, canonicalized by ``rep``'s converters; inf
        flags), after the rows of a sharded ladder are gathered.  The flag
        is authoritative: a lazy ∞ row's coordinates are garbage."""
        if sharded:
            out, inf = self._gather_rows(group, out, inf)
        packed = torch.cat([co.reshape(-1) for co in out] + [inf.to(torch.int32)])
        packed = packed.cpu().numpy()
        n = out[0].numel()
        coords = tuple(packed[k * n:(k + 1) * n].reshape(out[0].shape) for k in range(3))
        from_dev = G.g1_from_device_batch if group == "g1" else G.g2_from_device_batch
        return from_dev(coords, rep=rep), packed[3 * n:].astype(bool)

    def _msm_dispatch(self, group: str, points, scalars):
        """Start the ladder of Σ scalars[i]·points[i] (scalars < 2^128, the
        RLC randomizers), padded to a power of two; returns a handle for
        :meth:`_msm_collect`."""
        size = self._pad(len(points))
        pts = list(points) + [None] * (size - len(points))
        sc = list(scalars) + [0] * (size - len(scalars))
        return (group, len(points), self._ladder(group, pts, sc))

    def _msm_collect(self, handle):
        """Finish a :meth:`_msm_dispatch` handle: the host point (None =
        infinity), folded on the host from one copy of the ladder rows."""
        group, n_pts, ladder = handle
        host_pts, inf_h = self._fetch(group, *ladder)
        host_add = c.g1_add if group == "g1" else c.g2_add
        acc = None
        for i in range(n_pts):
            if not inf_h[i]:
                acc = host_add(acc, host_pts[i])
        return acc

    def _msm(self, group: str, points, scalars):
        return self._msm_collect(self._msm_dispatch(group, points, scalars))

    def msm_g1(self, points, scalars):
        """points: host Jacobian G1 points; scalars: ints < 2^128. → host point."""
        return self._msm("g1", points, scalars)

    def msm_g2(self, points, scalars):
        return self._msm("g2", points, scalars)

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
        return (group, B, size, self._ladder(group, pts + phi, a + b))

    def _mul_batch_collect(self, handle):
        """Finish a :meth:`_mul_batch_dispatch` handle: host Jacobian points
        (None = infinity), index-aligned with the dispatched points."""
        group, B, size, ladder = handle
        host_pts, inf_h = self._fetch(group, *ladder)  # a·P rows, then b·endo(P)
        host_add = c.g1_add if group == "g1" else c.g2_add
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


_CACHES: Dict[tuple, _MsmCache] = {}
# the mesh the entry points route through when no cache is pinned
# (``use_mesh`` / ``routed_mesh``); None: one device
_ROUTED_MESH = None
# ``cache_for``'s default: the routed mesh
ROUTED = object()


def cache_for(device, mesh=ROUTED) -> _MsmCache:
    """The ladder launcher for ``(device, mesh)`` (created on first use;
    two threads that race here get the same one).

    ``mesh``: the ``DeviceMesh`` whose ranks share the ladder rows, None
    for this device alone; by default the mesh routed by :func:`use_mesh`
    or :class:`routed_mesh`.  A mesh fixes the device (``cuda:<local
    rank>``, or the CPU for a gloo mesh), and ``device`` must name its
    type."""
    if mesh is ROUTED:
        mesh = _ROUTED_MESH
    dev = resolve_device(device)
    if mesh is not None:
        from hbbft_tpu_torch.parallel.mesh import mesh_device

        mdev = mesh_device(mesh)
        if dev.type != mdev.type:
            raise ValueError(f"device {dev} on a {mesh.device_type} mesh")
        dev = mdev
    hit = _CACHES.get((dev, mesh))
    if hit is None:
        hit = _CACHES.setdefault((dev, mesh), _MsmCache(dev, mesh))
    return hit


def use_mesh(mesh) -> None:
    """Route the ladders of every call that pins no cache through ``mesh``
    (row-sharded; see :class:`_MsmCache`).  None returns to one device."""
    global _ROUTED_MESH
    _ROUTED_MESH = mesh


def current_mesh():
    """The mesh the entry points currently route through (None: one
    device)."""
    return _ROUTED_MESH


class routed_mesh:
    """Scope-bound :func:`use_mesh`: route through ``mesh`` inside the
    ``with`` block and restore the previous routing on exit.  The epoch
    wraps its encrypt in this, so the mesh given to
    ``BatchedHoneyBadgerEpoch(mesh=...)`` and the mesh its ladders shard
    over are one object.  Re-entrant."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = []

    def __enter__(self):
        self._prev.append(current_mesh())
        use_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        use_mesh(self._prev.pop())
        return False


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


def batch_tpke_decrypt(pks, cts, secret_shares, device="cuda", cache=None):
    """God-view batched TPKE decryption: every share of ciphertext p has
    base U_p, so the Lagrange combine collapses to ONE scalar-mul by the
    master secret per ciphertext — on the device ladder from
    ``DEVICE_DECRYPT_MIN_BATCH`` ciphertexts (never while it is None),
    else in the native oracle.  ``cache``: a pinned :func:`cache_for`
    launcher (a mesh's), else ``cache_for(device)``.
    Returns the plaintexts, aligned with ``cts``."""
    from hbbft_tpu_torch.crypto import tc

    t = pks.threshold()
    items = sorted(secret_shares)[: t + 1]
    if len(items) < t + 1:
        raise ValueError(f"need {t + 1} shares, got {len(items)}")
    if not cts:
        return []
    master = _master_for(pks, items)
    if _device_worthwhile(len(cts), DEVICE_DECRYPT_MIN_BATCH):
        cc = cache if cache is not None else cache_for(device)
        masks = cc.g1_mul_batch([ct.u for ct in cts], [master] * len(cts))
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


def batch_tpke_check_decrypt(pks, payloads, secret_shares, device="cuda",
                             cache=None):
    """Wire-validate + decrypt raw ciphertext payloads in one pass (one
    native call where the framing is exact); semantics of
    ``Ciphertext.from_bytes`` then :func:`batch_tpke_decrypt` (``cache``
    as there)."""
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
                rest, batch_tpke_decrypt(pks, cts, secret_shares, device=device,
                                         cache=cache)
            ):
                out[i] = pt
            return out
    cts = [tc.Ciphertext.from_bytes(p) for p in payloads]
    return batch_tpke_decrypt(pks, cts, secret_shares, device=device, cache=cache)


# --------------------------------------------------------------------------
# Split device TPKE encrypt
# --------------------------------------------------------------------------


def device_encrypt_worthwhile(n_items: int, device) -> bool:
    """AUTO routing for the split device encrypt: only on a CUDA device,
    only when the native host oracle is missing (it beat the device route
    at N = 64 and 1 024 on the card), and from ``DEVICE_ENCRYPT_MIN_BATCH``
    items."""
    if not _device_worthwhile(n_items, DEVICE_ENCRYPT_MIN_BATCH):
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


# --------------------------------------------------------------------------
# DKG commitment evaluation (SyncKeyGen hot loops)
# --------------------------------------------------------------------------
#
# ``BivarPoly.commitment`` costs (t+1)² full-width G1 muls per Part;
# ``BivarCommitment.row`` / ``.evaluate`` cost (t+1)² group operations by a
# small scalar (a node index) per Part and per Ack on the host, and (t+1)²
# full-width muls on the device.  Each call has its own threshold: the
# device ladder runs it from that many muls, the host below.  All routes
# are exact: the choice is speed only.

# Thresholds in (t+1)² muls, measured as those above (NVIDIA H100 80GB
# HBM3, 700.00 W).  ``bivar_commitment``: 4 muls host 0.00095 s, device
# 0.00141; 9 muls host 0.00218, device 0.00160.
DEVICE_BIVAR_MIN_BATCH = 9
# ``commitment_row``: None.  The host won at every size measured, 9 to
# 33 124 muls (t = 181: host 1.114 s, device 2.701), and by more as t grows.
DEVICE_ROW_MIN_BATCH = None
# ``commitment_eval``: None.  The host won at every size but 625 muls,
# where the device was 2–3 % faster (t = 24: host 0.0274 s, device
# 0.0266), and at t = 85 (0.284 s, 0.359), 127 and 181 (1.347 s, 3.126).
DEVICE_EVAL_MIN_BATCH = None
# ``rlc_fold_g1`` on the device from this many rows: 4 rows host 0.00072 s,
# device 0.00126; 8 rows host 0.00170, device 0.00137.
DEVICE_FOLD_MIN_BATCH = 8


def _device_worthwhile(batch_size: int, min_batch: Optional[int]) -> bool:
    """Route ``batch_size`` scalar-muls to the device ladder?  Never where
    the threshold is None."""
    return min_batch is not None and batch_size >= min_batch


def commitment_row(bivar_com, x: int, device="cuda"):
    """``BivarCommitment.row(x)``, on the device ladder from
    ``DEVICE_ROW_MIN_BATCH`` muls: row(x)[j] = Σ_i points[i][j]·x^i as one
    batched ladder over every (i, j), folded over i on the host."""
    from hbbft_tpu_torch.crypto.tc import Commitment, R

    t1 = bivar_com.degree() + 1
    if not _device_worthwhile(t1 * t1, DEVICE_ROW_MIN_BATCH):
        return bivar_com.row(x)
    xp = [pow(x, i, R) for i in range(t1)]
    flat_pts = [bivar_com.points[i][j] for i in range(t1) for j in range(t1)]
    flat_sc = [xp[i] for i in range(t1) for j in range(t1)]
    res = cache_for(device).g1_mul_batch(flat_pts, flat_sc)
    out = []
    for j in range(t1):
        acc = None
        for i in range(t1):
            acc = c.g1_add(acc, res[i * t1 + j])
        out.append(acc)
    return Commitment(out)


def commitment_eval(bivar_com, x: int, y: int, device="cuda"):
    """``BivarCommitment.evaluate(x, y)``, on the device ladder from
    ``DEVICE_EVAL_MIN_BATCH`` muls."""
    from hbbft_tpu_torch.crypto.tc import R

    t1 = bivar_com.degree() + 1
    if not _device_worthwhile(t1 * t1, DEVICE_EVAL_MIN_BATCH):
        return bivar_com.evaluate(x, y)
    xp = [pow(x, i, R) for i in range(t1)]
    yp = [pow(y, j, R) for j in range(t1)]
    flat_pts = [bivar_com.points[i][j] for i in range(t1) for j in range(t1)]
    flat_sc = [xp[i] * yp[j] % R for i in range(t1) for j in range(t1)]
    acc = None
    for p in cache_for(device).g1_mul_batch(flat_pts, flat_sc):
        acc = c.g1_add(acc, p)
    return acc


def poly_eval_range(coeffs, n: int):
    """``[f(1), …, f(n)]`` for the Fr polynomial with ``coeffs``: ``deg+1``
    Horner evaluations seed a forward-difference table, then every further
    share costs ``deg`` modular additions (the DKG's share loop)."""
    from hbbft_tpu_torch.crypto.tc import R

    def horner(x: int) -> int:
        acc = 0
        for coef in reversed(coeffs):
            acc = (acc * x + coef) % R
        return acc

    deg = len(coeffs) - 1
    if n <= deg + 1:
        return [horner(x) for x in range(1, n + 1)]
    seed = [horner(x) for x in range(1, deg + 2)]
    table = [list(seed)]  # forward differences; tail[k] = Δᵏf at the newest point
    for _ in range(deg):
        prev = table[-1]
        table.append([(prev[i + 1] - prev[i]) % R for i in range(len(prev) - 1)])
    tail = [row[-1] for row in table]
    out = seed
    for _ in range(n - (deg + 1)):
        for k in reversed(range(deg)):
            tail[k] = (tail[k] + tail[k + 1]) % R
        out.append(tail[0])
    return out


def bivar_rows_range(bivar_poly, n: int):
    """``[bivar_poly.row(1), …, bivar_poly.row(n)]`` by per-column finite
    differences (:func:`poly_eval_range`): the dealer's share loop."""
    from hbbft_tpu_torch.crypto.tc import Poly

    t1 = bivar_poly.degree() + 1
    cols = [poly_eval_range([bivar_poly.coeffs[i][j] for i in range(t1)], n)
            for j in range(t1)]
    return [Poly([cols[j][x] for j in range(t1)]) for x in range(n)]


def bivar_commitment(bivar_poly, device="cuda"):
    """``BivarPoly.commitment()``, on the device ladder from
    ``DEVICE_BIVAR_MIN_BATCH`` coefficients (g1·coeff for all (t+1)²)."""
    from hbbft_tpu_torch.crypto.tc import BivarCommitment

    t1 = bivar_poly.degree() + 1
    if not _device_worthwhile(t1 * t1, DEVICE_BIVAR_MIN_BATCH):
        return bivar_poly.commitment()
    flat_sc = [bivar_poly.coeffs[i][j] for i in range(t1) for j in range(t1)]
    res = cache_for(device).g1_mul_batch([c.G1_GEN] * (t1 * t1), flat_sc)
    return BivarCommitment(bivar_poly.degree(),
                           [[res[i * t1 + j] for j in range(t1)] for i in range(t1)])


# --------------------------------------------------------------------------
# Cross-epoch batched share generation / verification
# --------------------------------------------------------------------------
#
# One pump iteration of the pipelined node runtime can carry the threshold
# crypto of many (epoch, proposer) instances at once; these calls take the
# whole batch, merge the pairing products so it pays ONE final
# exponentiation, and derive every randomizer by Fiat–Shamir from the
# checked material, so the verdicts are deterministic.


def rlc_fold_g1(points, scalars, device="cuda"):
    """``Σ rᵢ·Pᵢ`` over host Jacobian G1 points: the device MSM from
    ``DEVICE_FOLD_MIN_BATCH`` rows, per-item host muls below.  Returns a
    host point, None for the infinity sum.

    The MSM ladder is sound below 2^128.  Scalars past that (object mode's
    ``ThresholdDecrypt`` folds with coefficients mod r) split against the
    GLV eigenvalue inside the same MSM, s·P = a·P + b·φ(P) with a, b <
    2^128, so the one launch runs 2·len(points) rows."""
    if _device_worthwhile(len(points), DEVICE_FOLD_MIN_BATCH):
        if all(0 <= s < 1 << _RAND_BITS for s in scalars):
            return cache_for(device).msm_g1(points, scalars)
        sc = [s % c.R for s in scalars]
        return cache_for(device).msm_g1(
            list(points) + [c.g1_endo(p) for p in points],
            [s % c.LAMBDA_G1 for s in sc] + [s // c.LAMBDA_G1 for s in sc],
        )
    acc = None
    for p, s in zip(points, scalars):
        acc = c.g1_add(acc, c.g1_mul(p, s))
    return acc


def _fs_scalars(seed: bytes, n: int, offset: int = 0):
    """``n`` Fiat–Shamir 128-bit coefficients (odd, nonzero) from ``seed``."""
    return [
        int.from_bytes(hashlib.sha3_256(seed + (offset + k).to_bytes(4, "big")).digest()[:16],
                       "big") | 1
        for k in range(n)
    ]


def batch_decrypt_share_gen(secret_scalar: int, cts, device="cuda"):
    """One node's decryption shares ``x_i·U_p`` for many ciphertexts in one
    call, value-identical to per-item ``decrypt_share(ct, check=False)``;
    the device ladder from ``DEVICE_SHARE_GEN_MIN_BATCH`` ciphertexts."""
    from hbbft_tpu_torch.crypto import tc

    if not cts:
        return []
    if _device_worthwhile(len(cts), DEVICE_SHARE_GEN_MIN_BATCH):
        pts = cache_for(device).g1_mul_batch([ct.u for ct in cts],
                                             [secret_scalar] * len(cts))
        return [tc.DecryptionShare(p) for p in pts]
    return [tc.DecryptionShare(c.g1_mul(ct.u, secret_scalar)) for ct in cts]


def verify_ciphertext_batch(cts) -> list:
    """Per-ciphertext CCA verdicts in ONE merged pairing-product check:
    ``e(g1, Σ r_j·W_j) · Π e(−r_j·U_j, H_j) == 1`` with FS randomizers; on
    a merged failure each ciphertext is checked alone, so the list equals
    per-item ``Ciphertext.verify()``.  Host work only."""
    from hbbft_tpu_torch.crypto import tc

    if not cts:
        return []
    if len(cts) == 1:
        return [cts[0].verify()]
    seed = hashlib.sha3_256(b"HBBFT-CT-BATCH" + b"".join(ct.to_bytes() for ct in cts)).digest()
    rs = _fs_scalars(seed, len(cts))
    w_acc = None
    pairs = []
    for ct, r in zip(cts, rs):
        w_acc = c.g2_add(w_acc, c.g2_mul(ct.w, r))
        pairs.append((c.g1_neg(c.g1_mul(ct.u, r)), tc._hash_ciphertext_point(ct.u, ct.v)))
    pairs.append((c.G1_GEN, w_acc))
    if c.pairing_check(pairs):
        return [True] * len(cts)
    return [ct.verify() for ct in cts]


def verify_dec_share_sets(jobs, device="cuda") -> list:
    """Merged verification of many t+1 decryption-share sets: ``jobs`` are
    ``(pks, items, ct)`` triples (``items`` the ``(index, DecryptionShare)``
    list of one instance).  Each job's FS-randomized check joins ONE
    pairing-product check; on a merged failure every job is checked alone,
    so the verdicts match the per-job ground truth."""
    from hbbft_tpu_torch.crypto import tc

    if not jobs:
        return []
    seed = hashlib.sha3_256(
        b"HBBFT-TD-MULTI"
        + b"".join(ct.to_bytes() + b"".join(s.to_bytes() for _, s in items)
                   for _pks, items, ct in jobs)
    ).digest()
    pairs = []
    per_job = []
    for j, (pks, items, ct) in enumerate(jobs):
        h = tc._hash_ciphertext_point(ct.u, ct.v)
        rhos = _fs_scalars(seed, len(items), offset=j * 4096)
        acc_share = rlc_fold_g1([s.point for _, s in items], rhos, device=device)
        acc_pk = rlc_fold_g1([pks.public_key_share(i).point for i, _ in items], rhos,
                             device=device)
        job_pairs = [(c.g1_neg(acc_share), h), (acc_pk, ct.w)]
        per_job.append(job_pairs)
        pairs.extend(job_pairs)
    if len(jobs) == 1:
        return [c.pairing_check(per_job[0])]
    if c.pairing_check(pairs):
        return [True] * len(jobs)
    return [c.pairing_check(jp) for jp in per_job]


def batch_verify_sig_shares(pairs: Sequence[Tuple[object, object]], msg: bytes,
                            rng: random.Random, device="cuda", cache=None) -> bool:
    """All-or-nothing check of (PublicKeyShare, SignatureShare) pairs: True
    ⟹ every share is valid; False ⟹ at least one is not (the caller
    verifies per share for blame).  Both MSMs are dispatched before either
    is collected, so the G1 and G2 ladders overlap on the card.
    ``cache``: a pinned :func:`cache_for` launcher (a mesh's), else
    ``cache_for(device)``."""
    if not pairs:
        return True
    cc = cache if cache is not None else cache_for(device)
    rs = [rng.getrandbits(_RAND_BITS) | 1 for _ in pairs]
    h_sig = cc._msm_dispatch("g2", [s.point for _, s in pairs], rs)
    h_pk = cc._msm_dispatch("g1", [p.point for p, _ in pairs], rs)
    sig_comb = cc._msm_collect(h_sig)
    pk_comb = cc._msm_collect(h_pk)
    if sig_comb is None or pk_comb is None:
        # Σ rᵢσᵢ = ∞ only if shares are invalid (or every input is ∞)
        return sig_comb is None and pk_comb is None
    return c.pairing_check([(c.g1_neg(c.G1_GEN), sig_comb), (pk_comb, c.hash_g2(msg))])


def batch_verify_dec_shares(pairs: Sequence[Tuple[object, object]], ct,
                            rng: random.Random, device="cuda", cache=None) -> bool:
    """All-or-nothing check of (PublicKeyShare, DecryptionShare) pairs
    against a TPKE ciphertext (U, V, W); ``cache`` as in
    :func:`batch_verify_sig_shares`."""
    from hbbft_tpu_torch.crypto.tc import _hash_ciphertext_point

    if not pairs:
        return True
    cc = cache if cache is not None else cache_for(device)
    rs = [rng.getrandbits(_RAND_BITS) | 1 for _ in pairs]
    h_d = cc._msm_dispatch("g1", [d.point for _, d in pairs], rs)
    h_pk = cc._msm_dispatch("g1", [p.point for p, _ in pairs], rs)
    d_comb = cc._msm_collect(h_d)
    pk_comb = cc._msm_collect(h_pk)
    if d_comb is None or pk_comb is None:
        return d_comb is None and pk_comb is None
    return c.pairing_check([(c.g1_neg(d_comb), _hash_ciphertext_point(ct.u, ct.v)),
                            (pk_comb, ct.w)])
