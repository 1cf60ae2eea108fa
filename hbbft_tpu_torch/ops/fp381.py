"""The BLS12-381 base field (Fp, Fp2) on 13-bit × 30-limb int32 digits.

Counterpart of ``hbbft_tpu/ops/fp381.py``, in the column layout of the
Pallas kernel: a batch of R field elements is an int32 tensor ``(NL=30,
R)`` — limb axis first, so a kernel thread per row reads its limbs
``a[i*R + r]`` coalesced across the warp.  The host converters take and
give the reference's ``(B, NL)`` rows.  Two variants, as in the reference:

- **lazy** (``*_lazy``): every digit in [0, 2^13] (2^13 itself allowed),
  the value an arbitrary residue < ~2^390.01.  Only rough carries and
  residue-row folds — no canonical form, so zero tests are digit-based and
  sound only in the ladder regime of scalars < 2^128 (see
  ``ops/gcurve.py``).  Canonicalize on the host (``limbs_to_int % P``).
  The multiply is :func:`hbbft_tpu_torch.ops.fp_lazy.mul_lazy_cols`, so a
  ladder over this field is the plain reference of the kernels.  Kernel 1
  (``fp_lazy.fp_mul_lazy``) and the ladder kernels (``csrc/ladder_lazy.cu``,
  ``csrc/ladder_window.cu``) run the same field, digit for digit, in CUDA
  (``csrc/fp_lazy.cuh``).
- **canonical** (``fp_add``/``fp_sub``/``fp_mul``/…): exact [0, p) digits
  through the reference's exact carry (three rough passes, then a
  Kogge–Stone scan of the ±1 chains) and its conditional-subtract chains;
  the complete point addition and the general ladder of ``ops/gcurve.py``
  run over it.  Plain PyTorch on any device: in the reference these are
  XLA functions with no Pallas inside.
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls12_381 import P

LIMB_BITS = 13
NL = 30  # 30 × 13 = 390 ≥ 381
MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n: int = NL) -> np.ndarray:
    """Host: python int → little-endian 13-bit limbs (int32)."""
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= LIMB_BITS
    assert x == 0, "value too large for limb count"
    return out


def limbs_to_int(limbs) -> int:
    """Host: limb array (little-endian) → python int."""
    x = 0
    for i, v in enumerate(np.asarray(limbs).tolist()):
        x += int(v) << (LIMB_BITS * i)
    return x


_LIMB_WEIGHTS = np.array([1 << (LIMB_BITS * i) for i in range(NL)], dtype=object)


def ints_to_limbs_batch(xs, n: int = NL) -> np.ndarray:
    """Host: ints in [0, 2^(13n)) → (B, n) int32 limbs, vectorized."""
    nbytes = (LIMB_BITS * n + 7) // 8
    buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), nbytes)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, : LIMB_BITS * n]
    w = (1 << np.arange(LIMB_BITS, dtype=np.int32)).astype(np.int32)
    return (bits.reshape(len(xs), n, LIMB_BITS) * w).sum(-1, dtype=np.int32)


def limbs_to_ints_batch(limbs) -> list:
    """Host: (B, NL) limbs (lazy digit magnitudes allowed) → python ints."""
    arr = np.asarray(limbs)
    return list(arr.astype(object) @ _LIMB_WEIGHTS[: arr.shape[-1]])


def bits_batch(xs, nbits: int) -> np.ndarray:
    """Host: ints → (B, nbits) int32 little-endian bits, vectorized."""
    nbytes = (nbits + 7) // 8
    buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), nbytes)
    return np.unpackbits(raw, axis=1, bitorder="little")[:, :nbits].astype(np.int32)


# fold rows: digit position j in [NL, 2·NL] contributes 2^(13 j) mod p
# (31 rows: the convolution carries one digit past 2·NL)
_FOLD_HI = np.stack(
    [int_to_limbs((1 << (LIMB_BITS * j)) % P) for j in range(NL, 2 * NL + 1)]
)

# constant ≡ −2·(2^390 − 1) (mod p), canonical — completes the digitwise
# complement in fp_sub_lazy
_SUBC_LIMBS = int_to_limbs((-2 * ((1 << (LIMB_BITS * NL)) - 1)) % P)


class FieldConsts:
    """The field's constant tensors on one device: the lazy field's fold
    rows and sub constant, the canonical field's p, 377-bit fold rows and
    2^390 − k·p complements (defined with the canonical section below)."""

    def __init__(self, device):
        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        self.fold = col(_FOLD_HI)
        self.row0 = self.fold[0].reshape(NL, 1).clone()
        self.subc = col(_SUBC_LIMBS).reshape(NL, 1)
        self.p = col(P_LIMBS).reshape(NL, 1)
        self.fold377 = col(_FOLD377_BITS).reshape(14, NL, 1)
        self.ck = {k: col(v).reshape(NL, 1) for k, v in _CK_LIMBS.items()}


_CONSTS: dict = {}


def consts(device) -> FieldConsts:
    hit = _CONSTS.get(device)
    if hit is None:
        hit = _CONSTS[device] = FieldConsts(device)
    return hit


# 0-dim CPU operands: PyTorch takes them as scalars on any device, without
# wrapping a Python int into a new tensor on every op of the carry loop
_SHIFT = torch.tensor(LIMB_BITS, dtype=torch.int32)
_MASK = torch.tensor(MASK, dtype=torch.int32)


def _carry_rough(t: torch.Tensor, carry: torch.Tensor | None = None) -> torch.Tensor:
    """3 rough passes along the limb axis (axis 0), IN PLACE: limbs < 2^31
    → digits ≤ 2^13; the carry out of the top limb is dropped, as in the
    reference.  ``carry`` is an optional scratch buffer shaped like ``t``.
    Returns ``t``."""
    if carry is None:
        carry = torch.empty_like(t)
    up, down = t[1:], carry[:-1]
    for _ in range(3):
        torch.bitwise_right_shift(t, _SHIFT, out=carry)
        t.bitwise_and_(_MASK)
        up.add_(down)
    return t


def _squeeze_lazy(acc: torch.Tensor) -> torch.Tensor:
    """(NL, R) limbs with values < 2^31 → lazy-invariant digits.

    Appends a carry limb, rough-carries, then folds the top digit back
    through 2^390 mod p four times (enough from any value < 2^399).  Works
    in place on one fresh (NL+1, R) buffer and one carry buffer."""
    row0 = consts(acc.device).row0
    t = torch.nn.functional.pad(acc, (0, 0, 0, 1))
    carry = torch.empty_like(t)
    _carry_rough(t, carry)
    lo, hi = t[:NL], t[NL:]
    for _ in range(4):
        lo.addcmul_(hi, row0)
        hi.zero_()
        _carry_rough(t, carry)
    return lo


def fp_mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy modular product of (NL, R) columns: Kernel 1's plain version."""
    from hbbft_tpu_torch.ops import fp_lazy

    return fp_lazy.mul_lazy_cols(a, b, consts(a.device).fold)


def fp_add_lazy(a, b):
    return _squeeze_lazy(a + b)


def fp_sub_lazy(a, b):
    """a − b (mod p), lazy: a + (2·MASK − b_digits) + const."""
    return _squeeze_lazy(a + (2 * MASK - b) + consts(a.device).subc)


def fp_neg_lazy(a):
    return fp_sub_lazy(torch.zeros_like(a), a)


def fp_is_zero_digits(a) -> torch.Tensor:
    """Digit-zero test per column → bool (R,)."""
    return (a == 0).all(dim=0)


def fp_select(mask, a, b):
    """mask bool (R,) → column r of a where mask[r] else of b."""
    return torch.where(mask[None, :], a, b)


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u²+1): one (NL, 2R) tensor [re | im]
# ---------------------------------------------------------------------------
#
# The reference holds an Fp2 batch as a (re, im) pair.  Here the two halves
# sit side by side on the row axis, so an Fp2 add or sub is ONE Fp op over
# 2R columns — the same per-column arithmetic, half the launches.


def fp2_parts(a):
    """(re, im) views of an (NL, 2R) Fp2 batch."""
    R = a.shape[1] // 2
    return a[:, :R], a[:, R:]


def fp2_pack(re, im):
    return torch.cat([re, im], dim=1)


fp2_add_lazy = fp_add_lazy
fp2_sub_lazy = fp_sub_lazy
fp2_neg_lazy = fp_neg_lazy


def _mul_stacked(xs, ys):
    """Several products as ONE multiply: the operands are stacked along
    the row axis and the product split back (widths of ``xs``)."""
    t = fp_mul_lazy(torch.cat(xs, dim=1), torch.cat(ys, dim=1))
    return torch.split(t, [x.shape[1] for x in xs], dim=1)


def fp2_mul_lazy(a, b):
    """Karatsuba, the reference's formula: t0 = a0·b0, t1 = a1·b1,
    t2 = (a0+a1)(b0+b1) in one 3R-row launch; re = t0 − t1,
    im = t2 − (t0 + t1) in one 2R-column sub."""
    a0, a1 = fp2_parts(a)
    b0, b1 = fp2_parts(b)
    t01, t2 = _mul_stacked([a, fp_add_lazy(a0, a1)], [b, fp_add_lazy(b0, b1)])
    t0, t1 = fp2_parts(t01)
    return fp_sub_lazy(fp2_pack(t0, t2), fp2_pack(t1, fp_add_lazy(t0, t1)))


def fp2_sqr_lazy(a):
    """(a0+a1)(a0−a1) and a0·a1 in one launch; im = 2·a0·a1."""
    a0, a1 = fp2_parts(a)
    t0, t1 = _mul_stacked(
        [fp_add_lazy(a0, a1), a0], [fp_sub_lazy(a0, a1), a1]
    )
    return fp2_pack(t0, fp_add_lazy(t1, t1))


def fp2_is_zero_digits(a):
    z = fp_is_zero_digits(a)
    R = z.shape[0] // 2
    return z[:R] & z[R:]


def fp2_select(mask, a, b):
    return fp_select(torch.cat([mask, mask]), a, b)


# ---------------------------------------------------------------------------
# canonical field: exact [0, p) digits
# ---------------------------------------------------------------------------
#
# The reference's algorithm op for op over (n, R) columns, so every digit
# matches (also for inputs outside [0, p), such as all-MASK limbs).  Every
# intermediate limb stays non-negative and below 2^31 (subtraction goes
# through complement constants), so the int32 shifts are the reference's.

P_LIMBS = int_to_limbs(P)
FOLD_AT = 29  # limbs below this (29·13 = 377 bits) stay; above get folded
# 2^(377 + t) mod p, t < 14: the bitwise fold of the 377-bit overhang
_FOLD377_BITS = np.stack(
    [int_to_limbs((1 << (LIMB_BITS * FOLD_AT + t)) % P) for t in range(14)]
)
# complements 2^390 − k·p for the binary conditional-subtract chain
_CK_LIMBS = {k: int_to_limbs((1 << (LIMB_BITS * NL)) - k * P) for k in (1, 2, 4, 8)}


def _down(x: torch.Tensor, k: int) -> torch.Tensor:
    """Limb i of the result is limb i − k of ``x``, 0 below k."""
    out = torch.zeros_like(x)
    out[k:] = x[:-k]
    return out


def _pad1(t: torch.Tensor) -> torch.Tensor:
    """One zero limb on top."""
    return torch.nn.functional.pad(t, (0, 0, 0, 1))


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Exact carry propagation along the limb axis; limbs in [0, 2^31).
    Three rough passes (the top carry dropped), then a Kogge–Stone scan of
    the (generate, propagate) pairs resolves the ±1 chains."""
    t = _carry_rough(t.clone())
    g = t >> LIMB_BITS
    p = (t == MASK).to(torch.int32)
    shift = 1
    while shift < t.shape[0]:
        gs, ps = _down(g, shift), _down(p, shift)
        g = gs * p | g
        p = p * ps
        shift *= 2
    return (t + _down(g, 1)) & MASK


def _cond_sub_kp(v: torch.Tensor, k: int) -> torch.Tensor:
    """v in [0, 2kp) → [0, kp): subtract k·p where v ≥ k·p."""
    s = _carry(_pad1(v + consts(v.device).ck[k]))  # bit 390 set ⟺ v ≥ kp
    return torch.where((s[NL] > 0)[None, :], s[:NL], v)


def _cond_sub_p(v):
    return _cond_sub_kp(v, 1)


def _reduce377(v: torch.Tensor) -> torch.Tensor:
    """(NL+1, R) 13-bit digits, value < 2^391 → canonical [0, p): the
    overhang h = v >> 377 < 2^14 folds in bitwise against the
    2^(377+t) mod p rows, then an 8p/4p/2p/p conditional-subtract chain."""
    rows = consts(v.device).fold377
    h = v[FOLD_AT] + (v[FOLD_AT + 1] << LIMB_BITS)
    t = v[:NL].clone()
    t[FOLD_AT:] = 0
    for tb in range(14):
        t = t + ((h >> tb) & 1)[None, :] * rows[tb]
    t = _carry(t)  # value < 2^377 + 14p < 16p
    for k in (8, 4, 2, 1):
        t = _cond_sub_kp(t, k)
    return t


def fp_add(a, b):
    return _reduce377(_carry(_pad1(a + b)))


def fp_sub(a, b):
    """a − b mod p via the complement: a + ~b + 1 + p − 2^390."""
    t = a + (MASK - b) + consts(a.device).p
    t[0] += 1  # value = a − b + p + 2^390
    t = _carry(_pad1(t))
    return _cond_sub_p(t[:NL])  # the 2^390 limb dropped


def fp_neg(a):
    return fp_sub(torch.zeros_like(a), a)


def fp_mul(a, b):
    """Canonical modular product of canonical (NL, R) columns: the
    convolution, an exact carry, the fold of digits ≥ NL, one more
    single-limb fold, the 377-bit reduction."""
    from hbbft_tpu_torch.ops import fp_lazy

    fold = consts(a.device).fold
    acc = fp_lazy._fold_hi(_carry(fp_lazy._conv(a, b)), fold)
    acc = _carry(_pad1(acc))  # 31 digits, value < 2^399
    acc = acc[:NL] + acc[NL][None, :] * fold[0][:, None]
    return _reduce377(_carry(_pad1(acc)))  # value < 2^391 before the reduction


def fp_sqr(a):
    return fp_mul(a, a)


def fp_is_zero(a) -> torch.Tensor:
    return (a == 0).all(dim=0)


def fp_eq(a, b) -> torch.Tensor:
    return (a == b).all(dim=0)


# Fp2, [re | im] on the row axis as in the lazy section: add, sub and neg
# are column-wise; the Karatsuba products run as one stacked product


def _fp_mul_stacked(xs, ys):
    t = fp_mul(torch.cat(xs, dim=1), torch.cat(ys, dim=1))
    return torch.split(t, [x.shape[1] for x in xs], dim=1)


fp2_add = fp_add
fp2_sub = fp_sub
fp2_neg = fp_neg


def fp2_mul(a, b):
    """Karatsuba, the reference's formula: re = a0·b0 − a1·b1,
    im = (a0+a1)(b0+b1) − (a0·b0 + a1·b1)."""
    a0, a1 = fp2_parts(a)
    b0, b1 = fp2_parts(b)
    t01, t2 = _fp_mul_stacked([a, fp_add(a0, a1)], [b, fp_add(b0, b1)])
    t0, t1 = fp2_parts(t01)
    return fp_sub(fp2_pack(t0, t2), fp2_pack(t1, fp_add(t0, t1)))


def fp2_sqr(a):
    a0, a1 = fp2_parts(a)
    t0, t1 = _fp_mul_stacked([fp_add(a0, a1), a0], [fp_sub(a0, a1), a1])
    return fp2_pack(t0, fp_add(t1, t1))


def fp2_is_zero(a):
    z = fp_is_zero(a)
    R = z.shape[0] // 2
    return z[:R] & z[R:]


def fp2_eq(a, b):
    z = fp_eq(a, b)
    R = z.shape[0] // 2
    return z[:R] & z[R:]


# host conversion helpers for Fp2 --------------------------------------------


def fp2_to_limbs(x) -> np.ndarray:
    """(re, im) python ints → (2, NL) int32."""
    return np.stack([int_to_limbs(x[0] % P), int_to_limbs(x[1] % P)])
