"""Batched G1/G2 Jacobian point arithmetic over the lazy field.

Counterpart of ``hbbft_tpu/ops/gcurve.py`` for the lazy ladder: the same
formulas (dbl-2009-l doubling, add-2007-bl addition) written once over a
field-ops bundle, and the MSB-first double-and-add ladder
:func:`scalar_mul_lazy` with infinity as an explicit flag.  On the card the
whole ladder is one launch of ``csrc/ladder_lazy.cu``
(:mod:`hbbft_tpu_torch.ops.ladder_lazy`); its plain version, on the CPU and
as the card's reference, is the stepwise :func:`scalar_mul_lazy_plain`.  A
coordinate of R points is one (NL, R) column tensor (G1) or one (NL, 2R)
tensor [re | im] (G2, see ``ops/fp381.py``).

The windowed ladder, ``msm`` and the canonical field are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls12_381 import R
from hbbft_tpu_torch.ops import fp381 as F
from hbbft_tpu_torch.ops import ladder_lazy


class _LazyFpOps:
    """The lazy field over Fp, in plain PyTorch (see ops/fp381.py for its
    soundness conditions — ladders must use scalars < 2^128)."""

    fp2 = False
    add = staticmethod(F.fp_add_lazy)
    sub = staticmethod(F.fp_sub_lazy)
    mul = staticmethod(F.fp_mul_lazy)
    sqr = staticmethod(lambda a: F.fp_mul_lazy(a, a))
    neg = staticmethod(F.fp_neg_lazy)
    is_zero = staticmethod(F.fp_is_zero_digits)
    select = staticmethod(F.fp_select)


class _LazyFp2Ops:
    fp2 = True
    add = staticmethod(F.fp2_add_lazy)
    sub = staticmethod(F.fp2_sub_lazy)
    mul = staticmethod(F.fp2_mul_lazy)
    sqr = staticmethod(F.fp2_sqr_lazy)
    neg = staticmethod(F.fp2_neg_lazy)
    is_zero = staticmethod(F.fp2_is_zero_digits)
    select = staticmethod(F.fp2_select)


LAZY_FP_OPS = _LazyFpOps()
LAZY_FP2_OPS = _LazyFp2Ops()


def _dbl_small(o, a, times: int):
    """a·2^times via repeated additions."""
    for _ in range(times):
        a = o.add(a, a)
    return a


def point_double(o, pt):
    x, y, z = pt
    a = o.sqr(x)
    b = o.sqr(y)
    c = o.sqr(b)
    d = o.sub(o.sqr(o.add(x, b)), o.add(a, c))
    d = o.add(d, d)
    e = o.add(o.add(a, a), a)
    f = o.sqr(e)
    x3 = o.sub(f, o.add(d, d))
    y3 = o.sub(o.mul(e, o.sub(d, x3)), _dbl_small(o, c, 3))
    z3 = o.mul(o.add(y, y), z)
    return (x3, y3, z3)


def point_add_raw(o, p1, p2):
    """add-2007-bl only — valid for FINITE operands with distinct x (the
    lazy ladder's scalar regime rules out P == ±Q)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = o.sqr(z1)
    z2z2 = o.sqr(z2)
    u1 = o.mul(x1, z2z2)
    u2 = o.mul(x2, z1z1)
    s1 = o.mul(o.mul(y1, z2), z2z2)
    s2 = o.mul(o.mul(y2, z1), z1z1)
    h = o.sub(u2, u1)
    r = o.sub(s2, s1)
    i = o.sqr(o.add(h, h))
    j = o.mul(h, i)
    r2 = o.add(r, r)
    v = o.mul(u1, i)
    x3 = o.sub(o.sub(o.sqr(r2), j), o.add(v, v))
    y3 = o.sub(o.mul(r2, o.sub(v, x3)), _dbl_small(o, o.mul(s1, j), 1))
    z3 = o.mul(_dbl_small(o, o.mul(z1, z2), 1), h)
    return (x3, y3, z3)


def point_select(o, mask, p, q):
    return (
        o.select(mask, p[0], q[0]),
        o.select(mask, p[1], q[1]),
        o.select(mask, p[2], q[2]),
    )


def scalar_mul_lazy(o, pt, bits: torch.Tensor, base_inf: torch.Tensor):
    """MSB-first double-and-add over the LAZY field, infinity as a flag.

    pt: (X, Y, Z) coordinates over R rows; bits: bool/int (R, nbits)
    little-endian; base_inf: bool (R,).  Sound for scalars < 2^128 (a
    P == ±Q collision needs a bit-prefix m ≥ (r−1)/2 ≥ 2^253).
    Returns ((X, Y, Z), inf).

    On CUDA tensors: ONE launch of the whole-ladder kernel, G1 or G2 as
    ``o.fp2`` says (it raises rather than fall back).  On CPU tensors:
    :func:`scalar_mul_lazy_plain` over ``o``.
    """
    if not pt[0].is_cuda:
        return scalar_mul_lazy_plain(o, pt, bits, base_inf)
    return ladder_lazy.ladder_lazy(pt, bits, base_inf, fp2=o.fp2)


@torch.inference_mode()  # no autograd bookkeeping on ~10^5 small ops
def scalar_mul_lazy_plain(o, pt, bits: torch.Tensor, base_inf: torch.Tensor):
    """:func:`scalar_mul_lazy` as a Python loop over the bits, one plain
    field op at a time over ``o``: on the card it is the whole-ladder
    kernel's reference and launches no kernel of the port."""
    nbits = bits.shape[-1]
    bits_t = bits.t().contiguous().bool()  # (nbits, R): one row per step
    acc = tuple(torch.zeros_like(c) for c in pt)
    inf = torch.ones(base_inf.shape, dtype=torch.bool, device=base_inf.device)
    for i in range(nbits):
        acc, inf = ladder_step(o, acc, inf, pt, base_inf, bits_t[nbits - 1 - i])
    return acc, inf


def ladder_step(o, acc, inf, pt, base_inf, bit):
    """One step of the ladder: acc ← 2·acc (+ pt where ``bit``)."""
    acc = point_double(o, acc)  # double keeps finiteness (odd order)
    added = point_add_raw(o, acc, pt)
    # acc = ∞: acc + base = base; base = ∞: stays acc
    res = point_select(o, inf, pt, point_select(o, base_inf, acc, added))
    res_inf = inf & base_inf
    acc = point_select(o, bit, res, acc)
    inf = torch.where(bit, res_inf, inf)
    return acc, inf


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------


def scalars_to_bits(scalars: Sequence[int], nbits: int = 255) -> np.ndarray:
    """ints (mod r) → (B, nbits) int32 little-endian bits."""
    sc = [s % R for s in scalars]
    assert all(s < (1 << nbits) for s in sc), "scalar exceeds ladder width"
    return F.bits_batch(sc, nbits)


def _cols(rows: np.ndarray, device) -> torch.Tensor:
    """(B, NL) host limbs → (NL, B) int32 column tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(rows.T)).to(device)


def g1_to_device(points: Sequence[Optional[tuple]], device) -> Tuple:
    """Host Jacobian G1 points (or None) → (X, Y, Z) column tensors."""
    coords = ([], [], [])
    for p in points:
        for ci in range(3):
            coords[ci].append(0 if p is None else p[ci] % F.P)
    return tuple(_cols(F.ints_to_limbs_batch(cs), device) for cs in coords)


def g2_to_device(points: Sequence[Optional[tuple]], device) -> Tuple:
    """Host Jacobian G2 points (Fp2 coords) → (X, Y, Z), each an (NL, 2B)
    [re | im] tensor."""
    coords = ([], []), ([], []), ([], [])
    for p in points:
        if p is None:
            p = ((0, 0), (0, 0), (0, 0))
        for ci, c in enumerate(p):
            coords[ci][0].append(c[0] % F.P)
            coords[ci][1].append(c[1] % F.P)
    return tuple(
        _cols(F.ints_to_limbs_batch(re + im), device) for (re, im) in coords
    )


def _host_ints(col) -> list:
    """(NL, B) column tensor or array → B python ints (not reduced)."""
    if isinstance(col, torch.Tensor):
        col = col.cpu().numpy()
    return F.limbs_to_ints_batch(np.asarray(col).T)


def g1_from_device_batch(pt) -> list:
    """(X, Y, Z) column tensors → host Jacobian points (None = infinity);
    canonicalizes on the host."""
    xs, ys, zs = (_host_ints(c) for c in pt)
    return [
        None if (z % F.P) == 0 else (x % F.P, y % F.P, z % F.P)
        for x, y, z in zip(xs, ys, zs)
    ]


def g2_from_device_batch(pt) -> list:
    """(X, Y, Z) [re | im] tensors → host Jacobian G2 points."""
    def halves(c):
        ints = _host_ints(c)
        return ints[: len(ints) // 2], ints[len(ints) // 2:]

    (xr, xi), (yr, yi), (zr, zi) = (halves(c) for c in pt)
    out = []
    for i in range(len(zr)):
        z = (zr[i] % F.P, zi[i] % F.P)
        if z == (0, 0):
            out.append(None)
            continue
        out.append(((xr[i] % F.P, xi[i] % F.P), (yr[i] % F.P, yi[i] % F.P), z))
    return out
