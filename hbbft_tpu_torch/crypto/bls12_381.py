"""BLS12-381: fields, curves, pairing — pure-Python ground truth.

The reference's crypto lives in the external ``threshold_crypto`` crate over
``pairing``/``ff`` (BLS12-381); this module is our from-scratch equivalent of
that curve layer.  Design notes:

- Everything derives from the BLS parameter ``x = -0xd201000000010000``:
  p, r, and both cofactors are computed from the BLS12 family formulas at
  import and cross-checked, so a transcribed-constant error cannot survive.
- Field tower: Fp2 = Fp[u]/(u²+1); Fp12 is represented directly in the
  w-basis (coefficients c0..c5 ∈ Fp2, w⁶ = ξ = u+1), which makes the sparse
  Miller-loop line multiplication and Frobenius cheap and avoids a separate
  Fp6 layer.
- Pairing: optimal ate.  Affine Miller loop over Fp2 with sparse (c0,c2,c3)
  line evaluation; final exponentiation = easy part, then the BLS12 hard part
  via the (x−1)²·(x+p)·(x²+p²−1)+3 multiple (a fixed 3rd-power of the
  canonical pairing, which preserves bilinearity and non-degeneracy — all
  callers only compare pairing products).
- ``pairing_check([(P,Q),...])`` shares one Miller product and one final
  exponentiation across all pairs — the batch-verification trick a future
  on-device verifier can reuse.

Representation conventions: Fp = int; Fp2 = (int, int); Fp12 = 6-tuple of
Fp2; curve points are Jacobian triples; G1 over Fp, G2 over Fp2.  Infinity is
``None``.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Parameters (derived from the BLS parameter x)
# --------------------------------------------------------------------------

X = -0xD201000000010000  # BLS12-381 parameter (negative, low Hamming weight)

_x = X
R = _x**4 - _x**2 + 1  # subgroup order r (255 bits)
P = (_x - 1) ** 2 * R // 3 + _x  # base field prime (381 bits)
H1 = (_x - 1) ** 2 // 3  # G1 cofactor
H2 = (_x**8 - 4 * _x**7 + 5 * _x**6 - 4 * _x**4 + 6 * _x**3 - 4 * _x**2 - 4 * _x + 13) // 9  # G2 cofactor

assert P % 6 == 1 and P % 4 == 3
assert (P**4 - P**2 + 1) % R == 0  # r | Φ12(p): pairing lands in order-r group

B1 = 4  # E:  y² = x³ + 4
XI = (1, 1)  # ξ = u + 1;  E': y² = x³ + 4ξ (M-twist)

# Standard generators (checked on-curve and of order r in tests).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    (1, 0),
)

# GLV endomorphism on G1: φ(x, y) = (β·x, y) with β a primitive cube root
# of unity in Fp acts as multiplication by λ = x²−1 on the r-order subgroup
# (λ² + λ + 1 = x⁴ − x² + 1 ≡ 0 mod r).  Any full-range scalar splits as
# s = a + b·λ with a = s mod λ, b = s // λ, both POSITIVE and < 2^128 —
# the regime the device's lazy ladder is sound in (ops/fp381.py).  β is
# derived, not transcribed: the cube root (g^((p−1)/3)) whose φ matches
# λ·G1_GEN is selected at import.
LAMBDA_G1 = _x**2 - 1
assert (LAMBDA_G1**2 + LAMBDA_G1 + 1) % R == 0
assert 0 < LAMBDA_G1 < 1 << 128 and (R - 1) // LAMBDA_G1 < 1 << 128


def _derive_beta() -> int:
    for g in range(2, 100):
        b = pow(g, (P - 1) // 3, P)
        if b != 1:
            break
    x, y, _ = G1_GEN
    for cand in (b, b * b % P):
        # φ(G) = (βx, y) must equal λ·G
        lam = g1_mul(G1_GEN, LAMBDA_G1)
        if g1_eq((cand * x % P, y, 1), lam):
            return cand
    raise AssertionError("no cube root matches the G1 endomorphism")


BETA_G1: Optional[int] = None  # filled lazily (needs g1_mul below)


def glv_beta() -> int:
    global BETA_G1
    if BETA_G1 is None:
        BETA_G1 = _derive_beta()
    return BETA_G1


def g1_endo(pt):
    """φ(P) = λ·P via one field multiplication (Jacobian: scale X by β)."""
    if pt is None:
        return None
    b = glv_beta()
    return (pt[0] * b % P, pt[1], pt[2])


# --------------------------------------------------------------------------
# Fp
# --------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, -1, P)


def fp_sqrt(a: int) -> Optional[int]:
    """Square root in Fp (p ≡ 3 mod 4), or None."""
    r_ = pow(a, (P + 1) // 4, P)
    return r_ if r_ * r_ % P == a % P else None


# --------------------------------------------------------------------------
# Fp2 = Fp[u]/(u²+1), elements (a, b) = a + b·u
# --------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a, b):
    # Karatsuba: (a0+a1u)(b0+b1u) = a0b0 − a1b1 + ((a0+a1)(b0+b1) − a0b0 − a1b1)u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sqr(a):
    # (a0+a1u)² = (a0+a1)(a0−a1) + 2a0a1·u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def fp2_scal(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], -a[1] % P)


def fp2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, -1, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def fp2_pow(a, e: int):
    result = FP2_ONE
    base = a
    while e:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 via the complex method (p ≡ 3 mod 4), or None."""
    if a == FP2_ZERO:
        return FP2_ZERO
    a0, a1 = a
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue: sqrt = t·u with t² = −a0
        t = fp_sqrt(-a0 % P)
        return None if t is None else (0, t)
    n = (a0 * a0 + a1 * a1) % P
    s = fp_sqrt(n)
    if s is None:
        return None
    # α² = (a0 + s)/2 (try both roots of the norm)
    for sgn in (s, -s % P):
        half = (a0 + sgn) * pow(2, -1, P) % P
        alpha = fp_sqrt(half)
        if alpha is None or alpha == 0:
            continue
        beta = a1 * pow(2 * alpha, -1, P) % P
        cand = (alpha, beta)
        if fp2_sqr(cand) == a:
            return cand
    return None


# --------------------------------------------------------------------------
# Fp12 in the w-basis: (c0..c5), ci ∈ Fp2, w⁶ = ξ
# --------------------------------------------------------------------------

FP12_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO)


def fp12_mul(a, b):
    # Schoolbook polynomial mult mod (w⁶ − ξ): 36 Fp2 muls.
    acc = [FP2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == FP2_ZERO:
            continue
        for j in range(6):
            if b[j] == FP2_ZERO:
                continue
            acc[i + j] = fp2_add(acc[i + j], fp2_mul(ai, b[j]))
    out = list(acc[:6])
    for k in range(6, 11):
        if acc[k] != FP2_ZERO:
            out[k - 6] = fp2_add(out[k - 6], fp2_mul(acc[k], XI))
    return tuple(out)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation = f^(p⁶): negates odd-w coefficients."""
    return (a[0], fp2_neg(a[1]), a[2], fp2_neg(a[3]), a[4], fp2_neg(a[5]))


def fp12_inv(a):
    """Inverse via the tower: split into even/odd parts A + B·w over
    Fp6 = Fp2[v]/(v³−ξ) with v = w²: (A + Bw)⁻¹ = (A − Bw)/(A² − B²v)."""
    A = (a[0], a[2], a[4])  # Fp6 coeffs in v
    B = (a[1], a[3], a[5])
    A2 = _fp6_sqr(A)
    B2 = _fp6_sqr(B)
    # A² − v·B²  (v·(b0,b1,b2) = (ξ·b2, b0, b1))
    vB2 = (fp2_mul(B2[2], XI), B2[0], B2[1])
    denom = _fp6_sub(A2, vB2)
    dinv = _fp6_inv(denom)
    num_even = _fp6_mul(A, dinv)
    num_odd = _fp6_neg(_fp6_mul(B, dinv))
    return (
        num_even[0], num_odd[0], num_even[1], num_odd[1], num_even[2], num_odd[2],
    )


def _fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def _fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def _fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def _fp6_mul(a, b):
    t = [FP2_ZERO] * 5
    for i in range(3):
        if a[i] == FP2_ZERO:
            continue
        for j in range(3):
            t[i + j] = fp2_add(t[i + j], fp2_mul(a[i], b[j]))
    return (
        fp2_add(t[0], fp2_mul(t[3], XI)),
        fp2_add(t[1], fp2_mul(t[4], XI)),
        t[2],
    )


def _fp6_sqr(a):
    return _fp6_mul(a, a)


def _fp6_inv(a):
    """Itoh–Tsujii style via adjugate over Fp2."""
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul(XI, fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    # norm = a0c0 + ξ(a2c1 + a1c2)
    norm = fp2_add(
        fp2_mul(a0, c0),
        fp2_mul(XI, fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
    )
    ninv = fp2_inv(norm)
    return (fp2_mul(c0, ninv), fp2_mul(c1, ninv), fp2_mul(c2, ninv))


# Frobenius: (Σ ci wⁱ)^p = Σ conj(ci)·γi·wⁱ with γi = ξ^{i(p−1)/6}.
_FROB_GAMMA = tuple(fp2_pow(XI, i * (P - 1) // 6) for i in range(6))


def fp12_frobenius(a, power: int = 1):
    out = a
    for _ in range(power):
        out = tuple(
            fp2_mul(fp2_conj(out[i]), _FROB_GAMMA[i]) for i in range(6)
        )
    return out


def fp12_pow(a, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


def _cyc_pow_x(a):
    """a^|x| in the cyclotomic subgroup (conjugate = inverse there)."""
    return fp12_pow(a, -X)  # −X = |x| > 0


# --------------------------------------------------------------------------
# Curves (Jacobian coordinates; None = infinity)
# --------------------------------------------------------------------------
# G1: tuples of ints (X, Y, Z); G2: tuples of Fp2.


def _jac_double(pt, sqr, mul, add, sub, scal):
    if pt is None:
        return None
    x, y, z = pt
    a = sqr(x)
    b = sqr(y)
    c = sqr(b)
    d = sub(sqr(add(x, b)), add(a, c))
    d = add(d, d)
    e = add(add(a, a), a)
    f = sqr(e)
    x3 = sub(f, add(d, d))
    y3 = sub(mul(e, sub(d, x3)), scal(c, 8))
    z3 = mul(add(y, y), z)
    return (x3, y3, z3)


def _jac_add(p1, p2, sqr, mul, add, sub, scal, zero_check, double):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = sqr(z1)
    z2z2 = sqr(z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    if zero_check(sub(u1, u2)):
        if zero_check(sub(s1, s2)):
            return double(p1)
        return None  # inverses
    h = sub(u2, u1)
    i = sqr(add(h, h))
    j = mul(h, i)
    r = sub(s2, s1)
    r = add(r, r)
    v = mul(u1, i)
    x3 = sub(sub(sqr(r), j), add(v, v))
    y3 = sub(mul(r, sub(v, x3)), scal(mul(s1, j), 2))
    z3 = mul(scal(mul(z1, z2), 2), h)
    return (x3, y3, z3)


# --- G1 (ints) ---


def _isqr(a):
    return a * a % P


def _imul(a, b):
    return a * b % P


def _iadd(a, b):
    return (a + b) % P


def _isub(a, b):
    return (a - b) % P


def _iscal(a, k):
    return a * k % P


def g1_double(pt):
    return _jac_double(pt, _isqr, _imul, _iadd, _isub, _iscal)


def g1_add(p1, p2):
    return _jac_add(
        p1, p2, _isqr, _imul, _iadd, _isub, _iscal, lambda t: t % P == 0, g1_double
    )


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P, pt[2])


# Scalars at or below this bit length skip the native oracle: a native
# scalar-mul pays a fixed serialize/ladder/deserialize cost (~130 µs even
# for k=3), while a Python double-and-add costs ~5 µs per group op — so a
# 12-bit scalar (≤ 18 ops) is an order of magnitude cheaper in Python.
# DKG evaluation points are node indices (x = i+1 ≤ N), which is what
# makes Horner-form commitment evaluation fast (see tc.BivarCommitment).
SMALL_SCALAR_BITS = 12


def g1_mul(pt, k: int):
    k %= R
    nat = _native()
    if 0 < k < (1 << SMALL_SCALAR_BITS) or nat is None or pt is None:
        result = None
        add = pt
        while k:
            if k & 1:
                result = g1_add(result, add)
            add = g1_double(add)
            k >>= 1
        return result
    return _g1_from_bytes_trusted(nat.bls_g1_mul(g1_to_bytes(pt), k))


def g1_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = fp_inv(z)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P, 1)


def g1_eq(p1, p2) -> bool:
    if p1 is None or p2 is None:
        return p1 is p2 or (p1 is None and p2 is None)
    # cross-multiply to compare without inversion
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    if (x1 * z2z2 - x2 * z1z1) % P:
        return False
    return (y1 * z2z2 % P * z2 - y2 * z1z1 % P * z1) % P == 0


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y, z = g1_affine(pt)
    return (y * y - x * x * x - B1) % P == 0


# --- G2 (Fp2) ---


def _f2zero(t):
    return t == FP2_ZERO or (t[0] % P == 0 and t[1] % P == 0)


def g2_double(pt):
    return _jac_double(pt, fp2_sqr, fp2_mul, fp2_add, fp2_sub, fp2_scal)


def g2_add(p1, p2):
    return _jac_add(
        p1, p2, fp2_sqr, fp2_mul, fp2_add, fp2_sub, fp2_scal, _f2zero, g2_double
    )


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]), pt[2])


def g2_mul(pt, k: int, mod_r: bool = True):
    if mod_r:
        k %= R
        nat = _native()
        if nat is not None and pt is not None:
            return _g2_from_bytes_trusted(nat.bls_g2_mul(g2_to_bytes(pt), k))
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_double(add)
        k >>= 1
    return result


def g2_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = fp2_inv(z)
    zi2 = fp2_sqr(zi)
    return (fp2_mul(x, zi2), fp2_mul(fp2_mul(y, zi2), zi), FP2_ONE)


def g2_eq(p1, p2) -> bool:
    if p1 is None or p2 is None:
        return p1 is None and p2 is None
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = fp2_sqr(z1), fp2_sqr(z2)
    if not _f2zero(fp2_sub(fp2_mul(x1, z2z2), fp2_mul(x2, z1z1))):
        return False
    return _f2zero(
        fp2_sub(
            fp2_mul(fp2_mul(y1, z2z2), z2), fp2_mul(fp2_mul(y2, z1z1), z1)
        )
    )


_B2 = fp2_scal(XI, B1)  # 4(u+1)


# --- ψ endomorphism on E'(Fp2) (untwist–Frobenius–twist) -------------------
#
# For the M-twist E': y² = x³ + 4ξ (Φ: (x, y) ↦ (x/ξ^{1/3}, y/ξ^{1/2}) into
# E over Fp12), ψ = Φ⁻¹ ∘ π_p ∘ Φ is an endomorphism of E' defined over Fp2:
# ψ(x, y) = (c_x·x̄, c_y·ȳ) with c_x = ξ^{(1−p)/3}, c_y = ξ^{(1−p)/2} (bars =
# Fp2 conjugation).  On the r-order subgroup G2 it acts as multiplication by
# p ≡ X (mod r) — the basis of the fast cofactor clearing below and the GLS
# scalar decomposition the native oracle uses.  Constants are derived, not
# transcribed, and self-checked against the eigenvalue on the generator.

_PSI: Optional[tuple] = None


def _psi_consts() -> tuple:
    global _PSI
    if _PSI is None:
        cx = fp2_inv(fp2_pow(XI, (P - 1) // 3))
        cy = fp2_inv(fp2_pow(XI, (P - 1) // 2))
        # self-check: ψ(G2_GEN) = [X mod r]·G2_GEN (pure-Python ladder — the
        # native oracle derives its constants from this module, so the check
        # must not route through it)
        g = G2_GEN
        cand = (
            fp2_mul(cx, fp2_conj(g[0])),
            fp2_mul(cy, fp2_conj(g[1])),
            fp2_conj(g[2]),
        )
        k = X % R
        acc, add = None, g
        while k:
            if k & 1:
                acc = g2_add(acc, add)
            add = g2_double(add)
            k >>= 1
        assert g2_eq(cand, acc), "psi constants failed the eigenvalue check"
        _PSI = (cx, cy)
    return _PSI


def g2_psi(pt):
    """ψ(P) — one conjugation + two Fp2 muls (Jacobian coordinates)."""
    if pt is None:
        return None
    cx, cy = _psi_consts()
    return (
        fp2_mul(cx, fp2_conj(pt[0])),
        fp2_mul(cy, fp2_conj(pt[1])),
        fp2_conj(pt[2]),
    )


# --- ψ² — the GLS split the device G2 ladders use --------------------------
#
# The two conjugations in ψ∘ψ cancel, so ψ²(x, y, z) = (n_x·x, n_y·y, z)
# with n_x = c_x·c̄_x, n_y = c_y·c̄_y ∈ Fp — a pure coordinate scaling, the
# exact G2 analog of GLV's φ(x, y) = (β·x, y) on G1.  On the r-order
# subgroup ψ² acts as multiplication by p² ≡ X² (mod r); X² ≈ 2^127.7, so a
# full-range scalar splits as s = a + b·X² with a = s mod X², b = s ÷ X² —
# both POSITIVE and < 2^128, the regime the device's lazy ladder is sound
# in (ops/fp381.py), mirroring LAMBDA_G1.  Constants are derived, not
# transcribed, and self-checked against the eigenvalue on the generator.

LAMBDA_G2 = X * X  # ψ² eigenvalue on G2 (= LAMBDA_G1 + 1; no mod needed)
assert 0 < LAMBDA_G2 < 1 << 128 and (R - 1) // LAMBDA_G2 < 1 << 128

_PSI2: Optional[tuple] = None


def _psi2_consts() -> tuple:
    global _PSI2
    if _PSI2 is None:
        cx, cy = _psi_consts()
        nx = fp2_mul(cx, fp2_conj(cx))
        ny = fp2_mul(cy, fp2_conj(cy))
        assert nx[1] == 0 and ny[1] == 0, "ψ² scalings must lie in Fp"
        # eigenvalue self-check on the generator (pure-Python ladder, same
        # reasoning as _psi_consts: the native oracle derives its constants
        # from this module and must not be in the loop that validates them)
        g = G2_GEN
        cand = (fp2_scal(g[0], nx[0]), fp2_scal(g[1], ny[0]), g[2])
        k = LAMBDA_G2
        acc, add = None, g
        while k:
            if k & 1:
                acc = g2_add(acc, add)
            add = g2_double(add)
            k >>= 1
        assert g2_eq(cand, acc), "ψ² constants failed the eigenvalue check"
        _PSI2 = (nx[0], ny[0])
    return _PSI2


def g2_psi2(pt):
    """ψ²(P) = [X²]·P via two Fp2-by-Fp coordinate scalings (Jacobian)."""
    if pt is None:
        return None
    nx, ny = _psi2_consts()
    return (fp2_scal(pt[0], nx), fp2_scal(pt[1], ny), pt[2])


def g2_in_subgroup(pt) -> bool:
    """Eigenvalue subgroup test: ψ(P) == [x]P ⟺ P ∈ G2 (for on-curve P).

    Soundness: ψ's characteristic equation ψ²−[t]ψ+[p] = 0 (t = x+1) turns
    ψ(P) = [x]P into [p−x]P = ∞ with p−x = h₁·r, so ord(P) divides
    gcd(h₁·r, h₂·r) = r·gcd(h₁, h₂) = r (gcd asserted in tests).  One ψ +
    one 64-bit ladder replaces the [r−1] full-width check.
    """
    if pt is None:
        return True
    nat = _native()
    if nat is not None:
        return nat.bls_g2_in_subgroup(g2_to_bytes(pt))
    return g2_eq(g2_psi(pt), g2_neg(g2_mul(pt, -X, mod_r=False)))


def g2_clear_cofactor(pt):
    """Map any E'(Fp2) point into the r-order subgroup G2.

    Budroni–Pintore ψ-based clearing (the method RFC 9380 §8.8.2 uses for
    BLS12-381 G2): [x²−x−1]P + [x−1]ψ(P) + ψ²([2]P), computed with two
    64-bit ladders ([|x|]P, then [|x|] of that) instead of the naive
    512-bit multiplication by the full cofactor h₂ — ~8× fewer point
    operations.  The image is [h_eff]P for the effective cofactor
    h_eff ≡ 3·h₂·(…unit mod r), so it differs pointwise from [h₂]P but
    serves the same role; the scheme is self-consistent (tc.py docstring).
    """
    if pt is None:
        return None
    xa = -X
    a = g2_neg(g2_mul(pt, xa, mod_r=False))       # [x]P   (x < 0)
    b = g2_neg(g2_mul(a, xa, mod_r=False))        # [x²]P
    t1 = g2_add(g2_add(b, g2_neg(a)), g2_neg(pt))  # [x²−x−1]P
    t2 = g2_psi(g2_add(a, g2_neg(pt)))             # [x−1]ψ(P)
    t3 = g2_psi(g2_psi(g2_double(pt)))             # ψ²([2]P)
    return g2_add(g2_add(t1, t2), t3)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y, _ = g2_affine(pt)
    return fp2_sub(fp2_sqr(y), fp2_add(fp2_mul(fp2_sqr(x), x), _B2)) == FP2_ZERO


# --------------------------------------------------------------------------
# Pairing (optimal ate)
# --------------------------------------------------------------------------


def _line_sparse(c0, c2, c3):
    """Fp12 element c0 + c2·w² + c3·w³ (the sparse line)."""
    return (c0, FP2_ZERO, c2, c3, FP2_ZERO, FP2_ZERO)


def _miller_loop(pairs) -> tuple:
    """Π miller(P_i, Q_i) for affine G1 points P_i and affine G2 points Q_i.

    Affine Miller loop: R starts at Q; per bit of |x| (MSB-1 down): square f,
    multiply the doubling line, double R; on set bits also the addition line.
    The line through untwisted points, scaled by w³ (an Fp2-subfield constant
    that final exponentiation kills), is
    ``(λ·x_R − y_R) − λ·x_P·w² + y_P·w³`` with λ ∈ Fp2 the twist-curve slope.
    """
    work = []
    for (Pp, Qp) in pairs:
        pa = g1_affine(Pp)
        qa = g2_affine(Qp)
        if pa is None or qa is None:
            continue
        work.append((pa, qa))
    f = FP12_ONE
    if not work:
        return f
    xs = -X  # |x|
    bits = bin(xs)[3:]  # skip MSB
    Rs = [q for (_, q) in work]
    for b in bits:
        f = fp12_sqr(f)
        for i, ((xp, yp, _), (xq, yq, _)) in enumerate(work):
            Rx, Ry, _ = Rs[i]
            # doubling line at R
            lam = fp2_mul(
                fp2_scal(fp2_sqr(Rx), 3), fp2_inv(fp2_scal(Ry, 2))
            )
            c0 = fp2_sub(fp2_mul(lam, Rx), Ry)
            c2 = fp2_neg(fp2_scal(lam, xp))
            c3 = (yp % P, 0)
            f = fp12_mul(f, _line_sparse(c0, c2, c3))
            # R = 2R
            x3 = fp2_sub(fp2_sqr(lam), fp2_scal(Rx, 2))
            y3 = fp2_sub(fp2_mul(lam, fp2_sub(Rx, x3)), Ry)
            Rs[i] = (x3, y3, FP2_ONE)
        if b == "1":
            for i, ((xp, yp, _), (xq, yq, _)) in enumerate(work):
                Rx, Ry, _ = Rs[i]
                if _f2zero(fp2_sub(Rx, xq)):
                    # R == ±Q; adding Q to R=−Q gives vertical line (killed);
                    # R == Q would double — can't happen mid-loop for r-order Q.
                    Rs[i] = g2_affine(g2_add((Rx, Ry, FP2_ONE), (xq, yq, FP2_ONE)))
                    continue
                lam = fp2_mul(fp2_sub(Ry, yq), fp2_inv(fp2_sub(Rx, xq)))
                c0 = fp2_sub(fp2_mul(lam, xq), yq)
                c2 = fp2_neg(fp2_scal(lam, xp))
                c3 = (yp % P, 0)
                f = fp12_mul(f, _line_sparse(c0, c2, c3))
                x3 = fp2_sub(fp2_sub(fp2_sqr(lam), Rx), xq)
                y3 = fp2_sub(fp2_mul(lam, fp2_sub(Rx, x3)), Ry)
                Rs[i] = (x3, y3, FP2_ONE)
    # x < 0: conjugate (f ← f^(p⁶)) — standard sign fix for BLS12.
    return fp12_conj(f)


def _final_exponentiation(f):
    """f^(3·(p¹²−1)/r) — a fixed cube of the canonical pairing.

    Easy part: f ← f^((p⁶−1)(p²+1)).  Hard part uses
    3·(p⁴−p²+1)/r = (x−1)²·(x+p)·(x²+p²−1) + 3.
    """
    # easy
    f = fp12_mul(fp12_conj(f), fp12_inv(f))  # f^(p⁶−1)
    f = fp12_mul(fp12_frobenius(f, 2), f)  # ^(p²+1)
    # hard (in the cyclotomic subgroup now: inverse = conjugate)
    xm1 = -X + 1  # |x−1| = |x|+1 since x<0; m^(x−1) = conj(m^|x−1|)
    t = fp12_conj(fp12_pow(f, xm1))
    t = fp12_conj(fp12_pow(t, xm1))  # t = f^((x−1)²)  (positive exponent)
    s = fp12_mul(fp12_conj(fp12_pow(t, -X)), fp12_frobenius(t, 1))  # t^(x+p)
    u = fp12_mul(
        fp12_pow(s, X * X),  # positive: x² > 0
        fp12_mul(fp12_frobenius(s, 2), fp12_conj(s)),
    )  # s^(x²+p²−1)
    return fp12_mul(u, fp12_pow(f, 3))


def pairing(p1, q2):
    """e(P, Q)³ for P ∈ G1, Q ∈ G2 (fixed cube of the ate pairing)."""
    if p1 is None or q2 is None:
        return FP12_ONE
    return _final_exponentiation(_miller_loop([(p1, q2)]))


# --------------------------------------------------------------------------
# Native (C++) fast path — byte-parity-proven oracle for the hot operations
# --------------------------------------------------------------------------
# The C++ oracle (native/bls381.cpp) implements the same algorithms with
# constants generated from this module; tests/test_native_bls.py asserts
# byte-exact parity.  The pure-Python path remains the ground truth and is
# forced with HBBFT_PURE_PYTHON=1 (parity/unit tests do this).

_NATIVE = None
_NATIVE_TRIED = False


def _native():
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        import os

        if not os.environ.get("HBBFT_PURE_PYTHON"):
            try:
                from hbbft_tpu_torch.native import get_oracle

                _NATIVE = get_oracle()
            except Exception as exc:
                import warnings

                warnings.warn(
                    "native BLS oracle unavailable — falling back to the "
                    f"(much slower) pure-Python path: {exc!r}"
                )
                _NATIVE = None
    return _NATIVE


class pure_python:
    """Context manager forcing the pure-Python path (parity tests use this
    so both sides of a native-vs-host assertion are independent)."""

    def __enter__(self):
        global _NATIVE, _NATIVE_TRIED
        self._saved = (_NATIVE, _NATIVE_TRIED)
        _NATIVE, _NATIVE_TRIED = None, True
        return self

    def __exit__(self, *exc):
        global _NATIVE, _NATIVE_TRIED
        _NATIVE, _NATIVE_TRIED = self._saved
        return False


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """True iff Π e(P_i, Q_i) == 1 — one shared Miller product + final exp.

    This is how all signature/share verifications are phrased:
    ``e(g1, sig) == e(pk, H)`` ⟺ ``pairing_check([(−g1, sig), (pk, H)])``.
    """
    live = [(p, q) for (p, q) in pairs if p is not None and q is not None]
    nat = _native()
    if nat is not None:
        return nat.bls_pairing_check(
            [(g1_to_bytes(p), g2_to_bytes(q)) for p, q in live]
        )
    f = _miller_loop(live)
    return _final_exponentiation(f) == FP12_ONE


# --------------------------------------------------------------------------
# Hash to G2 (try-and-increment; random-oracle into the r-order subgroup)
# --------------------------------------------------------------------------


def _hash_fp2(data: bytes, ctr: int) -> tuple:
    h0 = hashlib.sha3_256(b"HBBFT-H2G-c0" + ctr.to_bytes(4, "big") + data).digest()
    h1 = hashlib.sha3_256(b"HBBFT-H2G-c1" + ctr.to_bytes(4, "big") + data).digest()
    h2 = hashlib.sha3_256(b"HBBFT-H2G-c2" + ctr.to_bytes(4, "big") + data).digest()
    h3 = hashlib.sha3_256(b"HBBFT-H2G-c3" + ctr.to_bytes(4, "big") + data).digest()
    a = int.from_bytes(h0 + h1, "big") % P
    b = int.from_bytes(h2 + h3, "big") % P
    return (a, b)


def hash_g2(data: bytes):
    """Hash arbitrary bytes to a point of order r in G2.

    Try-and-increment: hash to an x-candidate in Fp2, solve for y, clear the
    cofactor.  (The reference's ``threshold_crypto::hash_g2`` fills the same
    role; bit-compatibility with it is not required — only internal
    consistency, as with all our crypto.)
    """
    nat = _native()
    if nat is not None:
        return _g2_from_bytes_trusted(nat.bls_hash_g2(bytes(data)))
    ctr = 0
    while True:
        x = _hash_fp2(data, ctr)
        rhs = fp2_add(fp2_mul(fp2_sqr(x), x), _B2)
        y = fp2_sqrt(rhs)
        if y is not None and y != FP2_ZERO:
            # canonical sign from the hash, for determinism
            if int.from_bytes(
                hashlib.sha3_256(b"HBBFT-H2G-sign" + ctr.to_bytes(4, "big") + data).digest(),
                "big",
            ) & 1:
                y = fp2_neg(y)
            pt = (x, y, FP2_ONE)
            pt = g2_clear_cofactor(pt)  # ψ-based clearing → r-order subgroup
            if pt is not None:
                return pt
        ctr += 1


def hash_g1(data: bytes):
    """Hash to G1 (same approach; used for plain per-node signatures)."""
    nat = _native()
    if nat is not None:
        return _g1_from_bytes_trusted(nat.bls_hash_g1(bytes(data)))
    ctr = 0
    while True:
        h0 = hashlib.sha3_256(b"HBBFT-H1G-0" + ctr.to_bytes(4, "big") + data).digest()
        h1 = hashlib.sha3_256(b"HBBFT-H1G-1" + ctr.to_bytes(4, "big") + data).digest()
        x = int.from_bytes(h0 + h1, "big") % P
        rhs = (x * x % P * x + B1) % P
        y = fp_sqrt(rhs)
        if y is not None and y != 0:
            if int.from_bytes(
                hashlib.sha3_256(b"HBBFT-H1G-s" + ctr.to_bytes(4, "big") + data).digest(),
                "big",
            ) & 1:
                y = -y % P
            pt = (x, y, 1)
            # effective cofactor 1−x (64-bit) in place of the 125-bit h₁ —
            # the standard G1 clearing (RFC 9380 §8.8.1's h_eff); ~2× fewer
            # ladder steps, image still the r-order subgroup (tested)
            pt = _g1_mul_nat(pt, 1 - X)
            if pt is not None:
                return pt
        ctr += 1


def _g1_mul_nat(pt, k: int):
    """Scalar mult by a natural number (no mod-r reduction; cofactor use)."""
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_double(add)
        k >>= 1
    return result


# --------------------------------------------------------------------------
# Serialization (affine, uncompressed-with-flags; self-consistent format)
# --------------------------------------------------------------------------


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x40" + bytes(96)  # infinity flag
    x, y, _ = g1_affine(pt)
    return b"\x00" + x.to_bytes(48, "big") + y.to_bytes(48, "big")


def _g1_from_bytes_trusted(data: bytes):
    """Deserialize WITHOUT curve/subgroup checks — only for values produced
    by the byte-parity-proven native oracle."""
    if data[0] == 0x40:
        return None
    return (
        int.from_bytes(data[1:49], "big"),
        int.from_bytes(data[49:97], "big"),
        1,
    )


def _g2_from_bytes_trusted(data: bytes):
    if data[0] == 0x40:
        return None
    vals = [int.from_bytes(data[1 + i * 48 : 49 + i * 48], "big") for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]), FP2_ONE)


def g1_in_subgroup(pt) -> bool:
    """Eigenvalue subgroup test: φ(P) == [λ]P ⟺ P ∈ G1 (for on-curve P).

    Soundness: φ satisfies φ²+φ+1 = 0 in End(E), so φ(P) = [λ]P forces
    [λ²+λ+1]P = [r·k]P = ∞, and ord(P) | gcd(h₁·r, r·k) = r·gcd(h₁, k) = r
    (gcd asserted in tests).  A 127-bit ladder replaces the [r−1] check.
    """
    if pt is None:
        return True
    nat = _native()
    if nat is not None:
        return nat.bls_g1_in_subgroup(g1_to_bytes(pt))
    return g1_eq(g1_endo(pt), g1_mul(pt, LAMBDA_G1))


def g1_from_bytes(data: bytes):
    if data[0] == 0x40:
        # strict: the only valid infinity encoding is the flag followed by
        # 96 zero bytes — a consensus-validated wire format must not admit
        # malleable (or truncated) encodings of the identity (the native
        # g1_read_checked reads the same fixed 97-byte frame;
        # tests/test_crypto.py sweeps the accept sets)
        if len(data) < 97 or any(data[1:97]):
            raise ValueError("nonzero bytes after the G1 infinity flag")
        return None
    if data[0] != 0:
        # strict decode: the only defined flags are 0x00 and 0x40 (the
        # native g1_read enforces the same)
        raise ValueError("invalid G1 flag byte")
    x = int.from_bytes(data[1:49], "big")
    y = int.from_bytes(data[49:97], "big")
    if x >= P or y >= P:
        raise ValueError("non-canonical G1 coordinates")
    pt = (x, y, 1)
    if not g1_is_on_curve(pt):
        raise ValueError("invalid G1 point")
    # Subgroup check: on-curve is not enough — cofactor-torsion components
    # survive pairing-based verification (killed by the final exponentiation)
    # but corrupt Lagrange combination of "verified" shares.
    if not g1_in_subgroup(pt):
        raise ValueError("G1 point not in the r-order subgroup")
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x40" + bytes(192)
    (x0, x1), (y0, y1), _ = g2_affine(pt)
    return (
        b"\x00"
        + x0.to_bytes(48, "big")
        + x1.to_bytes(48, "big")
        + y0.to_bytes(48, "big")
        + y1.to_bytes(48, "big")
    )


def g2_from_bytes(data: bytes):
    if data[0] == 0x40:
        # strict infinity: the full 193-byte frame, flag + zeros only
        if len(data) < 193 or any(data[1:193]):
            raise ValueError("nonzero bytes after the G2 infinity flag")
        return None
    if data[0] != 0:
        raise ValueError("invalid G2 flag byte")
    vals = [int.from_bytes(data[1 + i * 48 : 49 + i * 48], "big") for i in range(4)]
    if any(v >= P for v in vals):
        raise ValueError("non-canonical G2 coordinates")
    pt = ((vals[0], vals[1]), (vals[2], vals[3]), FP2_ONE)
    if not g2_is_on_curve(pt):
        raise ValueError("invalid G2 point")
    if not g2_in_subgroup(pt):
        raise ValueError("G2 point not in the r-order subgroup")
    return pt
