"""Batched G1/G2 Jacobian point arithmetic.

Counterpart of ``hbbft_tpu/ops/gcurve.py``: the same formulas (dbl-2009-l
doubling, add-2007-bl addition) written once over a field-ops bundle.  A
coordinate of R points is one (NL, R) column tensor (G1) or one (NL, 2R)
tensor [re | im] (G2, see ``ops/fp381.py``).

- Over the **canonical** field (``FP_OPS``/``FP2_OPS``): the complete
  addition :func:`point_add` (∞ operands, P = Q and P = −Q by masks), the
  general double-and-add ladder :func:`scalar_mul` (Z = 0 is infinity) and
  :func:`msm` (ladders, then a tree fold by halving).  Plain PyTorch on
  every device, as they are XLA functions in the reference.
- Over the **lazy** field (``LAZY_FP_OPS``/``LAZY_FP2_OPS``), infinity as
  an explicit flag, scalars < 2^128: the MSB-first bitwise ladder
  :func:`scalar_mul_lazy` and the 4-bit windowed ladder
  :func:`scalar_mul_lazy_window`.  On the card each is one launch of a
  hand-written kernel (``csrc/ladder_lazy.cu``, ``csrc/ladder_window.cu``
  through :mod:`hbbft_tpu_torch.ops.ladder_lazy`); their plain versions, on
  the CPU and as the kernels' reference on the card, are the stepwise
  :func:`scalar_mul_lazy_plain` and :func:`scalar_mul_lazy_window_plain`.
  Every ladder of :mod:`hbbft_tpu_torch.crypto.batch` runs the windowed
  one, the faster at every row count measured (PERF.md).
- Over the reference's second lazy field, 8-bit digits
  (``MXU_FP_OPS``/``MXU_FP2_OPS``, :mod:`hbbft_tpu_torch.ops.fp381_mxu`;
  the host converters with ``rep=fp381_mxu``): the same ladders' plain
  versions, and on the card the windowed ladder as one launch of
  ``csrc/ladder_mxu.cu`` (:mod:`hbbft_tpu_torch.ops.ladder_mxu`).  Each
  ops table carries its ``field`` (``"canonical"``, ``"lazy"``, ``"mxu"``),
  and a kernel is chosen by it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls12_381 import R
from hbbft_tpu_torch.ops import fp381 as F
from hbbft_tpu_torch.ops import fp381_mxu as M
from hbbft_tpu_torch.ops import ladder_lazy, ladder_mxu


class _FpOps:
    """The canonical field over Fp (exact [0, p) digits)."""

    field = "canonical"
    fp2 = False
    add = staticmethod(F.fp_add)
    sub = staticmethod(F.fp_sub)
    mul = staticmethod(F.fp_mul)
    sqr = staticmethod(F.fp_sqr)
    neg = staticmethod(F.fp_neg)
    is_zero = staticmethod(F.fp_is_zero)
    select = staticmethod(F.fp_select)


class _Fp2Ops:
    field = "canonical"
    fp2 = True
    add = staticmethod(F.fp2_add)
    sub = staticmethod(F.fp2_sub)
    mul = staticmethod(F.fp2_mul)
    sqr = staticmethod(F.fp2_sqr)
    neg = staticmethod(F.fp2_neg)
    is_zero = staticmethod(F.fp2_is_zero)
    select = staticmethod(F.fp2_select)


class _LazyFpOps:
    """The lazy field over Fp, in plain PyTorch (see ops/fp381.py for its
    soundness conditions — ladders must use scalars < 2^128)."""

    field = "lazy"
    fp2 = False
    add = staticmethod(F.fp_add_lazy)
    sub = staticmethod(F.fp_sub_lazy)
    mul = staticmethod(F.fp_mul_lazy)
    sqr = staticmethod(lambda a: F.fp_mul_lazy(a, a))
    neg = staticmethod(F.fp_neg_lazy)
    is_zero = staticmethod(F.fp_is_zero_digits)
    select = staticmethod(F.fp_select)


class _LazyFp2Ops:
    field = "lazy"
    fp2 = True
    add = staticmethod(F.fp2_add_lazy)
    sub = staticmethod(F.fp2_sub_lazy)
    mul = staticmethod(F.fp2_mul_lazy)
    sqr = staticmethod(F.fp2_sqr_lazy)
    neg = staticmethod(F.fp2_neg_lazy)
    is_zero = staticmethod(F.fp2_is_zero_digits)
    select = staticmethod(F.fp2_select)


class _MxuFpOps:
    """The 8-bit-digit lazy field over Fp (ops/fp381_mxu.py): the lazy
    field's soundness conditions; pair it with ``rep=fp381_mxu`` in the
    host converters."""

    field = "mxu"
    fp2 = False
    add = staticmethod(M.fp_add)
    sub = staticmethod(M.fp_sub)
    mul = staticmethod(M.fp_mul)
    sqr = staticmethod(M.fp_sqr)
    neg = staticmethod(M.fp_neg)
    is_zero = staticmethod(M.fp_is_zero_digits)
    select = staticmethod(M.fp_select)


class _MxuFp2Ops:
    field = "mxu"
    fp2 = True
    add = staticmethod(M.fp2_add)
    sub = staticmethod(M.fp2_sub)
    mul = staticmethod(M.fp2_mul)
    sqr = staticmethod(M.fp2_sqr)
    neg = staticmethod(M.fp2_neg)
    is_zero = staticmethod(M.fp2_is_zero_digits)
    select = staticmethod(M.fp2_select)


FP_OPS = _FpOps()
FP2_OPS = _Fp2Ops()
LAZY_FP_OPS = _LazyFpOps()
LAZY_FP2_OPS = _LazyFp2Ops()
MXU_FP_OPS = _MxuFpOps()
MXU_FP2_OPS = _MxuFp2Ops()


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


def point_add(o, p1, p2):
    """Complete addition over the canonical field: ∞ operands (Z = 0),
    P == Q (through the doubling) and P == −Q (Z3 = …·H = 0) by masks."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    inf1 = o.is_zero(z1)
    inf2 = o.is_zero(z2)

    z1z1 = o.sqr(z1)
    z2z2 = o.sqr(z2)
    u1 = o.mul(x1, z2z2)
    u2 = o.mul(x2, z1z1)
    s1 = o.mul(o.mul(y1, z2), z2z2)
    s2 = o.mul(o.mul(y2, z1), z1z1)
    h = o.sub(u2, u1)
    r = o.sub(s2, s1)
    is_dbl = o.is_zero(h) & o.is_zero(r) & ~inf1 & ~inf2

    i = o.sqr(o.add(h, h))
    j = o.mul(h, i)
    r2 = o.add(r, r)
    v = o.mul(u1, i)
    x3 = o.sub(o.sub(o.sqr(r2), j), o.add(v, v))
    y3 = o.sub(o.mul(r2, o.sub(v, x3)), _dbl_small(o, o.mul(s1, j), 1))
    z3 = o.mul(_dbl_small(o, o.mul(z1, z2), 1), h)

    out = point_select(o, is_dbl, point_double(o, p1), (x3, y3, z3))
    return point_select(o, inf2, p1, point_select(o, inf1, p2, out))


def point_select(o, mask, p, q):
    return (
        o.select(mask, p[0], q[0]),
        o.select(mask, p[1], q[1]),
        o.select(mask, p[2], q[2]),
    )


@torch.inference_mode()
def scalar_mul(o, pt, bits: torch.Tensor):
    """The general MSB-first double-and-add ladder over the canonical field
    with the complete addition (Z = 0 is infinity): pt (X, Y, Z) over R
    rows, bits (R, nbits) little-endian.  Any scalar width."""
    nbits = bits.shape[-1]
    bits_t = bits.t().contiguous().bool()
    acc = tuple(torch.zeros_like(c) for c in pt)
    for i in range(nbits):
        acc = point_double(o, acc)
        acc = point_select(o, bits_t[nbits - 1 - i], point_add(o, acc, pt), acc)
    return acc


def _rows(o, c, lo: int, hi: int):
    """Points lo … hi − 1 of one coordinate."""
    if not o.fp2:
        return c[:, lo:hi]
    R = c.shape[1] // 2
    return torch.cat([c[:, lo:hi], c[:, R + lo:R + hi]], dim=1)


def _pad_points(o, c, n: int):
    """n infinity (all-zero) points appended to one coordinate."""
    if not o.fp2:
        return torch.nn.functional.pad(c, (0, n))
    re, im = F.fp2_parts(c)
    return torch.cat([torch.nn.functional.pad(re, (0, n)),
                      torch.nn.functional.pad(im, (0, n))], dim=1)


@torch.inference_mode()
def msm(o, pt, bits: torch.Tensor):
    """Σ_r bits[r]·pt[r] over the canonical field: one batched ladder, then
    a tree of complete additions that halves the batch each level (padded
    with infinity to a power of two).  Returns one point (R = 1)."""
    pts = scalar_mul(o, pt, bits)
    B = bits.shape[0]
    size = 1
    while size < B:
        size *= 2
    pts = tuple(_pad_points(o, c, size - B) for c in pts)
    while size > 1:
        half = size // 2
        pts = point_add(o, tuple(_rows(o, c, 0, half) for c in pts),
                        tuple(_rows(o, c, half, size) for c in pts))
        size = half
    return pts


def scalar_mul_lazy(o, pt, bits: torch.Tensor, base_inf: torch.Tensor):
    """MSB-first double-and-add over the LAZY field, infinity as a flag.

    pt: (X, Y, Z) coordinates over R rows; bits: bool/int (R, nbits)
    little-endian; base_inf: bool (R,).  Sound for scalars < 2^128 (a
    P == ±Q collision needs a bit-prefix m ≥ (r−1)/2 ≥ 2^253).
    Returns ((X, Y, Z), inf).

    On CUDA tensors over the lazy field: ONE launch of the whole-ladder
    kernel, G1 or G2 as ``o.fp2`` says; over any other field it raises (no
    kernel runs this ladder there), as it does rather than fall back.  On
    CPU tensors: :func:`scalar_mul_lazy_plain` over ``o``.
    """
    if not pt[0].is_cuda:
        return scalar_mul_lazy_plain(o, pt, bits, base_inf)
    if o.field != "lazy":
        raise ValueError(f"scalar_mul_lazy has no kernel over the {o.field!r} field; on the "
                         "card it runs over LAZY_FP_OPS / LAZY_FP2_OPS")
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


WINDOW = 4  # bits a window of the windowed ladder


def scalar_mul_lazy_window(o, pt, bits: torch.Tensor, base_inf: torch.Tensor):
    """The 4-bit windowed variant of :func:`scalar_mul_lazy`: the same
    lazy-field and scalar regime, 139 doubles and 40 additions for 132 bits
    against 132 and 132.  ``bits.shape[-1]`` must be a multiple of 4.

    On CUDA tensors: ONE launch of the windowed kernel of ``o``'s field,
    ``csrc/ladder_window.cu`` (lazy) or ``csrc/ladder_mxu.cu`` (mxu); it
    raises on any other ops table, as it does rather than fall back.  On
    CPU tensors: :func:`scalar_mul_lazy_window_plain` over ``o``."""
    if not pt[0].is_cuda:
        return scalar_mul_lazy_window_plain(o, pt, bits, base_inf)
    if o.field == "lazy":
        return ladder_lazy.ladder_window(pt, bits, base_inf, fp2=o.fp2)
    if o.field == "mxu":
        return ladder_mxu.ladder_mxu(pt, bits, base_inf, fp2=o.fp2)
    raise ValueError(f"scalar_mul_lazy_window has no kernel over the {o.field!r} field; "
                     "on the card it runs over the lazy or the mxu ops tables")


def window_table(o, pt):
    """[P, 2P, …, 15P]: even entries by doubling, odd by a raw addition of
    P (always distinct x inside the scalar regime)."""
    table = [pt]
    for k in range(2, 1 << WINDOW):
        if k % 2 == 0:
            table.append(point_double(o, table[k // 2 - 1]))
        else:
            table.append(point_add_raw(o, table[k - 2], pt))
    return table


def window_indices(bits: torch.Tensor) -> torch.Tensor:
    """(R, nbits) little-endian bits → (nbits / 4, R) window values, the
    most significant window first."""
    R, nbits = bits.shape
    if nbits % WINDOW:
        raise ValueError(f"the windowed ladder takes a multiple of {WINDOW} bits, not {nbits}")
    w = bits.to(torch.int64).reshape(R, nbits // WINDOW, WINDOW)
    idx = (w << torch.arange(WINDOW, device=bits.device)).sum(-1)
    return idx.flip(1).t().contiguous()


@torch.inference_mode()
def scalar_mul_lazy_window_plain(o, pt, bits: torch.Tensor, base_inf: torch.Tensor):
    """:func:`scalar_mul_lazy_window` as a Python loop of plain field ops,
    digit- and inf-exact with the reference's ``scalar_mul_lazy_window``:
    the table, then per window (MSB first) 4 doubles and one addition of
    the entry the window selects, infinity as a flag.  The entry is chosen
    by index (the reference's one-hot contraction selects the same digits;
    a zero window leaves the accumulator as it is)."""
    table = window_table(o, pt)
    stacked = [torch.stack([t[c] for t in table]) for c in range(3)]  # (15, NL, W)
    cols = torch.arange(pt[0].shape[1], device=bits.device)
    acc = tuple(torch.zeros_like(c) for c in pt)
    inf = torch.ones(base_inf.shape, dtype=torch.bool, device=base_inf.device)
    for idx in window_indices(bits):
        for _ in range(WINDOW):
            acc = point_double(o, acc)
        entry = (idx - 1).clamp(min=0)
        if o.fp2:
            entry = torch.cat([entry, entry])
        sel = tuple(t[entry, :, cols].t() for t in stacked)
        added = point_add_raw(o, acc, sel)
        res = point_select(o, inf, sel, point_select(o, base_inf, acc, added))
        used = idx != 0
        acc = point_select(o, used, res, acc)
        inf = torch.where(used, inf & base_inf, inf)
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


def g1_to_device(points: Sequence[Optional[tuple]], device, rep=F) -> Tuple:
    """Host Jacobian G1 points (or None) → (X, Y, Z) column tensors.
    ``rep``: the field module of the digits, :mod:`fp381` (13-bit, the
    default) or :mod:`fp381_mxu` (8-bit)."""
    coords = ([], [], [])
    for p in points:
        for ci in range(3):
            coords[ci].append(0 if p is None else p[ci] % F.P)
    return tuple(_cols(rep.ints_to_limbs_batch(cs), device) for cs in coords)


def g2_to_device(points: Sequence[Optional[tuple]], device, rep=F) -> Tuple:
    """Host Jacobian G2 points (Fp2 coords) → (X, Y, Z), each an (NL, 2B)
    [re | im] tensor; ``rep`` as in :func:`g1_to_device`."""
    coords = ([], []), ([], []), ([], [])
    for p in points:
        if p is None:
            p = ((0, 0), (0, 0), (0, 0))
        for ci, c in enumerate(p):
            coords[ci][0].append(c[0] % F.P)
            coords[ci][1].append(c[1] % F.P)
    return tuple(
        _cols(rep.ints_to_limbs_batch(re + im), device) for (re, im) in coords
    )


def _host_ints(col, rep=F) -> list:
    """(NL, B) column tensor or array → B python ints (not reduced)."""
    if isinstance(col, torch.Tensor):
        col = col.cpu().numpy()
    return rep.limbs_to_ints_batch(np.asarray(col).T)


def g1_from_device_batch(pt, rep=F) -> list:
    """(X, Y, Z) column tensors → host Jacobian points (None = infinity);
    canonicalizes on the host.  ``rep`` as in :func:`g1_to_device`."""
    xs, ys, zs = (_host_ints(c, rep) for c in pt)
    return [
        None if (z % F.P) == 0 else (x % F.P, y % F.P, z % F.P)
        for x, y, z in zip(xs, ys, zs)
    ]


def g2_from_device_batch(pt, rep=F) -> list:
    """(X, Y, Z) [re | im] tensors → host Jacobian G2 points; ``rep`` as
    in :func:`g1_to_device`."""
    def halves(c):
        ints = _host_ints(c, rep)
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
