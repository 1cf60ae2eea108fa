"""The BLS12-381 base field (Fp, Fp2) on 8-bit × 49-digit int32 digits.

Counterpart of ``hbbft_tpu/ops/fp381_mxu.py``, the reference's second lazy
field, whose products it writes as two matrix products for the TPU's
matrix unit: the digit convolution as an outer product against a one-hot
tensor, ``(B, 2401) @ (2401, 97)``, and the fold of the high digits as
``(B, 51) @ (51, 49)``.  Radix 2^8 keeps both exact in float32: a digit
product is ≤ 2^16 and a sum ≤ 49·2^16 < 2^22.

Digit for digit the reference's field, in the column layout of
:mod:`hbbft_tpu_torch.ops.fp381`: a batch of R elements is an int32
``(NL=49, R)`` tensor, an Fp2 batch one ``(NL, 2R)`` tensor [re | im].
The host converters take and give the reference's ``(B, NL)`` rows.

- **Lazy invariant**: every digit in [0, 256], the value an arbitrary
  residue < 2^392.  Rough carries (three passes, the top carry dropped) and
  residue-row folds only, so zero tests are digit-based and sound only in
  the ladder regime of scalars < 2^128 (``ops/gcurve.py``); canonicalize on
  the host (``limbs_to_int % P``).
- **Product**: the 97-position convolution, three carry positions, a rough
  carry over the 100, the 51 digits from position 49 up folded through
  their 2^(8(49+m)) mod p rows, then the squeeze (three carry positions,
  three rounds folding them back).  Here the convolution is an integer
  outer product scattered onto its anti-diagonals and the fold an integer
  sum: the same integers as the reference's float32 products, with no
  float matmul to pin.
- **Fp2**: the reference's order of operations — ``fp2_mul`` stacks the
  three Karatsuba products into one ``fp_mul`` and takes re = t0 − t1,
  im = t2 − (t0 + t1); ``fp2_sqr`` multiplies (a0 + a1)·(a0 − a1) and
  a0·a1 and takes im = t1 + t1.

Plain PyTorch on any device: the plain version of the windowed ladder over
this field, whose kernel is ``csrc/ladder_mxu.cu``
(:mod:`hbbft_tpu_torch.ops.ladder_mxu`).
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls12_381 import P
from hbbft_tpu_torch.ops.fp381 import fp2_pack, fp2_parts

DIGIT_BITS = 8
NL = 49  # 49 × 8 = 392 ≥ 381 (11 bits of fold headroom)
MASK = (1 << DIGIT_BITS) - 1  # 255
_CONV_OUT = 2 * NL - 1  # 97 positions before carrying
_CARRY_PAD = 3  # carry room past the convolution's output
_N_HI = _CONV_OUT + _CARRY_PAD - NL  # 51 positions folded after carrying


def int_to_limbs(x: int, n: int = NL) -> np.ndarray:
    """Host: python int → little-endian 8-bit digits (int32)."""
    return np.frombuffer(int(x).to_bytes(n, "little"), dtype=np.uint8).astype(np.int32)


def limbs_to_int(limbs) -> int:
    """Host: digit array (little-endian, any magnitudes) → python int."""
    x = 0
    for i, v in enumerate(np.asarray(limbs).tolist()):
        x += int(v) << (DIGIT_BITS * i)
    return x


def ints_to_limbs_batch(xs, n: int = NL) -> np.ndarray:
    """Host: ints in [0, 2^(8n)) → (B, n) int32 digits (LE bytes)."""
    buf = b"".join(int(x).to_bytes(n, "little") for x in xs)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), n).astype(np.int32)


_DIGIT_WEIGHTS = np.array(
    [1 << (DIGIT_BITS * i) for i in range(NL + _CARRY_PAD)], dtype=object
)


def limbs_to_ints_batch(limbs) -> list:
    """Host: (B, NL) digits (lazy magnitudes allowed) → python ints."""
    arr = np.asarray(limbs)
    return list(arr.astype(object) @ _DIGIT_WEIGHTS[: arr.shape[-1]])


P_LIMBS = int_to_limbs(P)

# fold rows: 2^(8m) mod p for the digit positions m ≥ NL after carrying,
# the constant matrix of the reference's fold matmul
_FOLD_ROWS = np.stack(
    [int_to_limbs((1 << (DIGIT_BITS * (NL + m))) % P) for m in range(_N_HI)]
).astype(np.float32)  # (_N_HI, NL)

# squeeze fold rows: 2^(8(NL+m)) mod p for the _CARRY_PAD overflow digits
_SQUEEZE_ROWS = np.stack(
    [int_to_limbs((1 << (DIGIT_BITS * (NL + m))) % P) for m in range(_CARRY_PAD)]
)

# ≡ −2·(2^392 − 1) (mod p), canonical: completes the digitwise complement
# in fp_sub
_SUBC_LIMBS = int_to_limbs((-2 * ((1 << (DIGIT_BITS * NL)) - 1)) % P)


class FieldConsts:
    """The field's constant tensors on one device, int32: the fold rows
    (_N_HI, NL, 1), the squeeze rows (_CARRY_PAD, NL, 1), the sub constant
    (NL, 1) and the convolution's anti-diagonal index (NL·NL,)."""

    def __init__(self, device):
        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        self.fold_cols = col(_FOLD_ROWS)[:, :, None]
        self.squeeze = col(_SQUEEZE_ROWS)[:, :, None]
        self.subc = col(_SUBC_LIMBS).reshape(NL, 1)
        ij = torch.arange(NL, device=device)
        self.kidx = (ij[:, None] + ij[None, :]).reshape(-1)


_CONSTS: dict = {}


def consts(device) -> FieldConsts:
    hit = _CONSTS.get(device)
    if hit is None:
        hit = _CONSTS[device] = FieldConsts(device)
    return hit


# 0-dim CPU operands: scalars on any device, no new tensor a carry pass
_SHIFT = torch.tensor(DIGIT_BITS, dtype=torch.int32)
_MASK = torch.tensor(MASK, dtype=torch.int32)


def _carry_rough(t: torch.Tensor) -> torch.Tensor:
    """3 rough passes along the digit axis (axis 0), IN PLACE: digit k
    becomes (t_k & 255) + (t_{k−1} >> 8), the carry out of the top digit
    dropped, as the reference's ``_carry_rough``.  Returns ``t``."""
    carry = torch.empty_like(t)
    up, down = t[1:], carry[:-1]
    for _ in range(3):
        torch.bitwise_right_shift(t, _SHIFT, out=carry)
        t.bitwise_and_(_MASK)
        up.add_(down)
    return t


def _squeeze(acc: torch.Tensor) -> torch.Tensor:
    """(NL, R) digits with values < 2^31 → lazy-invariant digits: three
    carry positions appended, a rough carry, then three rounds that fold
    the three overflow digits back through their 2^(8(NL+m)) mod p rows
    and rough-carry again (the reference's ``_squeeze``)."""
    rows = consts(acc.device).squeeze
    t = torch.nn.functional.pad(acc, (0, 0, 0, _CARRY_PAD))
    _carry_rough(t)
    lo, top = t[:NL], t[NL:]
    for _ in range(3):
        lo.add_((top[:, None, :] * rows).sum(dim=0, dtype=torch.int32))
        top.zero_()
        _carry_rough(t)
    return lo


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The digit convolution t_k = Σ_{i+j=k} a_i·b_j over (_CONV_OUT +
    _CARRY_PAD, R), the carry positions zero: one outer product scattered
    onto its anti-diagonals (sums ≤ 49·256² < 2^22)."""
    outer = (a[:, None, :] * b[None, :, :]).reshape(NL * NL, a.shape[1])
    t = torch.zeros((_CONV_OUT + _CARRY_PAD, a.shape[1]), dtype=torch.int32, device=a.device)
    return t.index_add_(0, consts(a.device).kidx, outer)


def fp_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy modular product of (NL, R) columns: convolution, rough carry
    over 100 positions, the fold of the 51 from NL up, the squeeze."""
    t = _carry_rough(_conv(a, b))
    fold = (t[NL:, None, :] * consts(a.device).fold_cols).sum(dim=0, dtype=torch.int32)  # < 2^23
    return _squeeze(t[:NL] + fold)


def fp_sqr(a):
    return fp_mul(a, a)


def fp_add(a, b):
    return _squeeze(a + b)


def fp_sub(a, b):
    """a − b (mod p), lazy: a + (2·MASK − b_digits) + const (the digitwise
    complement represents 2·(2^392 − 1) − b; the constant is ≡ −2·(2^392 − 1))."""
    return _squeeze(a + (2 * MASK - b) + consts(a.device).subc)


def fp_neg(a):
    return fp_sub(torch.zeros_like(a), a)


def fp_is_zero_digits(a) -> torch.Tensor:
    """Digit-zero test per column → bool (R,)."""
    return (a == 0).all(dim=0)


def fp_select(mask, a, b):
    """mask bool (R,) → column r of a where mask[r] else of b."""
    return torch.where(mask[None, :], a, b)


# -- Fp2, one (NL, 2R) tensor [re | im]: add, sub and neg are column-wise --


fp2_add = fp_add
fp2_sub = fp_sub
fp2_neg = fp_neg


def _mul_stacked(xs, ys):
    """Several products as ONE fp_mul over the stacked columns."""
    t = fp_mul(torch.cat(xs, dim=1), torch.cat(ys, dim=1))
    return torch.split(t, [x.shape[1] for x in xs], dim=1)


def fp2_mul(a, b):
    """Karatsuba, the reference's order: t0 = a0·b0, t1 = a1·b1,
    t2 = (a0+a1)(b0+b1) in one stacked product; re = t0 − t1,
    im = t2 − (t0 + t1)."""
    a0, a1 = fp2_parts(a)
    b0, b1 = fp2_parts(b)
    t01, t2 = _mul_stacked([a, fp_add(a0, a1)], [b, fp_add(b0, b1)])
    t0, t1 = fp2_parts(t01)
    return fp_sub(fp2_pack(t0, t2), fp2_pack(t1, fp_add(t0, t1)))


def fp2_sqr(a):
    """(a0+a1)(a0−a1) and a0·a1 in one stacked product; im = t1 + t1."""
    a0, a1 = fp2_parts(a)
    t0, t1 = _mul_stacked([fp_add(a0, a1), a0], [fp_sub(a0, a1), a1])
    return fp2_pack(t0, fp_add(t1, t1))


def fp2_is_zero_digits(a):
    z = fp_is_zero_digits(a)
    R = z.shape[0] // 2
    return z[:R] & z[R:]


def fp2_select(mask, a, b):
    return fp_select(torch.cat([mask, mask]), a, b)
